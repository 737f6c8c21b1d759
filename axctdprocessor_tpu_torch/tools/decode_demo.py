"""End-to-end demo on the port: synthesize an AXCTD drop, then decode it with
the host parity engine, the device engine, the host stream decoder and the
device stream decoder.

The counterpart of the JAX package's ``examples/decode_demo.py``, in the same
order of steps; the WAV goes into ``--dir`` (a temporary directory, removed
at the end, when none is given).  ``--device cpu`` runs the device engine
and its stream decoder on the host.  Run as a file from the repository root:

    python axctdprocessor_tpu_torch/tools/decode_demo.py [--device cuda] [--dir DIR]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile


def demo(out_dir: str, device: str) -> dict:
    """Runs the steps; returns what each decode gave."""
    from axctdprocessor_tpu_torch.models import engine, parity_engine, simulator
    from axctdprocessor_tpu_torch.models.stream import AXCTDStreamDecoder
    from axctdprocessor_tpu_torch.models.stream_device import DeviceStreamDecoder

    # 1. synthesize a 45 s drop and write it as a WAV file
    spec = simulator.SimSpec(duration=45.0, profile_start=33.0, seed=7)
    pcm, truth = simulator.synthesize(spec)
    wav = os.path.join(out_dir, "demo_drop.wav")
    simulator.write_wav(wav, pcm, spec.fs)
    print(f"synthesized {wav} (serial {truth['serial_no']})")

    # 2. the host parity engine (the upstream implementation's arithmetic)
    parity = parity_engine.decode_wav(wav)
    print(f"parity engine : {len(parity.time)} rows, serial {parity.metadata['serial_no']}, "
          f"T {parity.temperature[0]:.2f} -> {parity.temperature[-1]:.2f} C")

    # 3. the device engine
    dev = engine.decode_wav(wav, device=device)
    print(f"device engine : {len(dev.time)} rows on {device}, "
          f"S {dev.salinity[0]:.2f} -> {dev.salinity[-1]:.2f} PSU")

    # 4. the host stream decoder (0.5 s radio blocks)
    block = int(0.5 * spec.fs)
    host = AXCTDStreamDecoder(spec.fs)
    host_rows = 0
    for pos in range(0, len(pcm), block):
        host.feed(pcm[pos: pos + block])
        host_rows += len(host.latest_rows())
    host.finalize()
    host_rows += len(host.latest_rows())
    print(f"host stream   : {host_rows} rows emitted incrementally, status {host.status}")

    # 5. the device stream decoder (the same blocks, polled once a second)
    live = DeviceStreamDecoder(spec.fs, device=device)
    live_rows = 0
    for k, pos in enumerate(range(0, len(pcm), block)):
        live.feed(pcm[pos: pos + block])
        if k % 2:
            live_rows += len(live.latest_rows())
    final = live.finalize()
    live_rows += len(live.latest_rows())
    print(f"device stream : {live_rows} rows emitted incrementally on {device}, "
          f"status {final.status}")
    return dict(truth=truth, parity=parity, device=dev, host_rows=host_rows,
                host_status=host.status, live_rows=live_rows, live=final)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dir", default=None, help="where the WAV is written")
    args = ap.parse_args(argv)
    if args.dir is not None:
        os.makedirs(args.dir, exist_ok=True)
        demo(args.dir, args.device)
    else:
        with tempfile.TemporaryDirectory(prefix="axctd_demo_") as tmp:
            demo(tmp, args.device)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    sys.exit(main())
