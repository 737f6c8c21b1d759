"""processAXCTD-compatible command line interface of the PyTorch port.

The flags and defaults of ``axctdprocessor_tpu.cli`` (the reference CLI's,
processAXCTD.py:47-101).  ``--engine cuda`` (the default) decodes with this
package's fused engine on ``--device`` (default ``cuda``; asking for it
without a GPU fails): drops over 300 s take the segmented engine, shorter
ones the fused program, as with the JAX CLI's ``--engine tpu``.  ``--engine
parity`` is the host reference: the byte-parity engine, which needs no
device and is asked for by name (the JAX CLI has it as its default; here no
entry point leaves the card unasked).  ``--corpus DIR_OR_GLOB`` is the
archive mode: every WAV in batches of ``--batch-size`` on ``--device``,
``-o`` naming the output directory, resuming from its manifest unless
``--no-resume``.  The parser is this module's own because the JAX CLI module
loads jax.

    python -m axctdprocessor_tpu_torch.cli -i drop.wav -o output.txt
    python -m axctdprocessor_tpu_torch.cli -i drop.wav -o output.txt --engine parity
    python -m axctdprocessor_tpu_torch.cli --corpus wavs/ -o reports/ --batch-size 8
"""

from __future__ import annotations

import argparse
import os
import sys

from .utils.config import resolve_settings
from .utils.report import write_report
from .utils.timeparse import parse_time_string


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="processAXCTD", description="Demodulate an AXCTD audio file to text"
    )
    p.add_argument("-i", "--input", default="ERROR_NO_FILE_SPECIFIED",
                   help="Input WAV filename")
    p.add_argument("-o", "--output", default="output.txt", help="Output filename")
    p.add_argument("-s", "--starttime", default="0", help="AXCTD start time in WAV file")
    p.add_argument("-e", "--endtime", default="-1", help="AXCTD end time in WAV file")
    p.add_argument("-a", "--autodetect-start", default="30",
                   help="Earliest time to scan for profile transmission start")
    p.add_argument("-b", "--autodetect-end", default="-1",
                   help="Latest time to scan for profile transmission start")
    p.add_argument("-p", "--sig-threshold-400", default="2",
                   help="Normalized 400 Hz signal threshold for pulse detection")
    p.add_argument("-t", "--sig-threshold-7500", default="1.5",
                   help="Normalized 7500 Hz signal threshold for profile detection")
    p.add_argument("-d", "--dead-freq", default="3000",
                   help='"Dead" (quiet) frequency for signal-level normalization (Hz)')
    p.add_argument("-l", "--pointsperloop", default="100000",
                   help="PCM points processed per iteration")
    p.add_argument("-m", "--mark-freq", default="400", help="Mark (bit 1) frequency (Hz)")
    p.add_argument("-n", "--space-freq", default="800", help="Space (bit 0) frequency (Hz)")
    p.add_argument("-u", "--use-bandpass", action="store_true",
                   help="Use a 100-1200 Hz bandpass instead of the 1200 Hz lowpass")
    p.add_argument("--fixed-settings", action="store_true",
                   help="Honor all flags as documented instead of reproducing the "
                        "reference's effective (partially inert) flag semantics")
    p.add_argument("--engine", choices=["cuda", "parity"], default="cuda",
                   help="Decode engine: the fused engine on --device, or the "
                        "byte-parity host reference engine")
    p.add_argument("--corpus", metavar="DIR_OR_GLOB",
                   help="Archive mode: decode every WAV in a directory (or glob) "
                        "in batches on --device; -o names the output dir")
    p.add_argument("--batch-size", type=int, default=8,
                   help="Drops per device batch in archive mode")
    p.add_argument("--no-resume", action="store_true",
                   help="Archive mode: re-decode files already in the manifest")
    p.add_argument("--wire", choices=["auto", "int16", "int8", "int4"],
                   default="auto",
                   help="Upload format for integer PCM: int8 halves the "
                        "host->device bytes; int4 quarters them (lossy, with "
                        "an int8 retry of degenerate decodes); auto is int16")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="Device of --engine cuda and of --corpus (cuda fails when "
                        "no GPU is present)")
    p.add_argument("--quiet", action="store_true", help="Suppress progress output")
    p.add_argument("--diagnostics", action="store_true",
                   help="Append per-point R400/dR7500 signal columns to the "
                        "profile table (default output is byte-identical "
                        "to the upstream format)")
    return p


def _run_corpus(args) -> int:
    import glob as globmod

    from .parallel.archive import reprocess_corpus

    pattern = args.corpus
    if os.path.isdir(pattern):
        pattern = os.path.join(pattern, "*.wav")
    paths = sorted(globmod.glob(pattern))
    if not paths:
        print(f"[!] No WAV files match {args.corpus!r}")
        return 1
    out_dir = args.output if args.output != "output.txt" else "corpus_out"
    settings = {
        "deadfreq": float(args.dead_freq),
        "mark_space_freqs": [float(args.mark_freq), float(args.space_freq)],
        "minR400": float(args.sig_threshold_400),
        "mindR7500": float(args.sig_threshold_7500),
        "use_bandpass": args.use_bandpass,
    }
    compat = "fixed" if args.fixed_settings else "strict"
    manifest = reprocess_corpus(paths, out_dir, settings=settings, compat=compat,
                                device=args.device, batch_size=args.batch_size,
                                resume=not args.no_resume,
                                wire=args.wire, diagnostics=args.diagnostics)
    done = sum(1 for v in manifest["files"].values() if v["status"] == "done")
    if not args.quiet:
        print(f"[+] {done}/{len(paths)} drops decoded -> {out_dir}")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.corpus:
        return _run_corpus(args)

    if args.input == "ERROR_NO_FILE_SPECIFIED":
        print("[!] Error- no input WAV file specified! Terminating")
        return 1
    if not os.path.exists(args.input):
        print("[!] Specified input file does not exist! Terminating")
        return 1

    timerange = [parse_time_string(args.starttime), parse_time_string(args.endtime)]
    if timerange[1] <= 0:
        timerange[1] = -1
    triggerrange = [parse_time_string(args.autodetect_start),
                    parse_time_string(args.autodetect_end)]
    if triggerrange[1] <= 0:
        triggerrange[1] = -1

    settings = {
        "triggerrange": triggerrange,
        "minR400": float(args.sig_threshold_400),
        "mindR7500": float(args.sig_threshold_7500),
        "deadfreq": float(args.dead_freq),
        "pointsperloop": int(args.pointsperloop),
        "mark_space_freqs": [float(args.mark_freq), float(args.space_freq)],
        "use_bandpass": args.use_bandpass,
    }
    compat = "fixed" if args.fixed_settings else "strict"

    progress = None
    if not args.quiet:
        print("Processing profile")

        def progress(pct):
            print(f"[+] Processing status: {pct}%         ", end="\r")

    if args.engine == "cuda":
        from .models.engine import decode_wav

        result = decode_wav(args.input, timerange, settings, compat=compat,
                            wire=args.wire, device=args.device)
    else:
        from .models.parity_engine import decode_wav

        result = decode_wav(args.input, timerange, settings, compat=compat,
                            progress=progress)

    if not args.quiet:
        print("\nProfile processing complete- writing output files")
    cfg = resolve_settings(settings, compat=compat)
    write_report(args.output, result, args.input, timerange, settings, cfg,
                 diagnostics=args.diagnostics)
    return 0


if __name__ == "__main__":
    sys.exit(main())
