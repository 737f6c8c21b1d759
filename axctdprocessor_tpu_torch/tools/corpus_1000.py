"""The archive configuration of BASELINE.md at its own scale ("1000-drop
corpus"), on the port: a corpus of mixed lengths and rates through
``parallel.archive.reprocess_corpus(batch_size=8)``.

The counterpart of the JAX package's ``scripts/corpus_1000.py``, with the
same corpus: 995 int16 WAVs drawn from ``SPECS`` (60 s at 44.1 kHz 0.55,
45 s 0.15, 90 s 0.15, 120 s 0.10, 60 s at 88.2 kHz 0.05), each a base drop
(simulator seed 5, profile at min(33, 0.4 x duration) s, scaled to a peak of
28,000) plus its own noise of +-300 from ``default_rng(1000)``, which also
draws the choice of base; and 5 corrupt files that the runner must
quarantine (manifest status ``failed``) without stopping the job:
``bad_empty``, ``bad_truncated``, ``bad_random``, ``bad_text`` and
``bad_cut_data``.  Given the same ``CORPUS_N`` the WAVs are byte for byte
the JAX script's.  The runner reads a WAV above 50 kHz through the host
reader, which decimates it by 2 (``utils/wavio.read_wav``), as the JAX
runner does: the 88.2 kHz drops decode as float rows at 44.1 kHz, in batches
of their own.

Controls, as the JAX script's: ``CORPUS_N`` files (1000 by default); a run
resumes from the output directory's manifest unless ``CORPUS_FRESH=1``.
Beside its accounting (done + failed == N, exactly the 5 corrupt files
failed) every ``done`` drop is held to its base's truth from its report:
decode status 2 (manifest), serial, probe code and maximum depth equal,
more than 0.97 of its hexframes in the truth.  Prints one JSON line (the
JAX script's fields, the card's name and power limit) and writes the whole
record to ``<out>/corpus_<N>.json``.  Run as a file from the repository
root; ``--device cpu`` runs on the host:

    CORPUS_N=1000 python axctdprocessor_tpu_torch/tools/corpus_1000.py [--device cuda]
        [--dir CORPUS_DIR] [--out OUT_DIR]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

N_CORRUPT = 5
CORRUPT = ("bad_empty.wav", "bad_truncated.wav", "bad_random.wav", "bad_text.wav",
           "bad_cut_data.wav")
SPECS = [  # (duration_s, fs, weight)
    (60.0, 44100, 0.55),
    (45.0, 44100, 0.15),
    (90.0, 44100, 0.15),
    (120.0, 44100, 0.10),
    (60.0, 88200, 0.05),
]
IN_TRUTH = 0.97  # the share of a drop's hexframes that must be in its truth


def synthesize_bases() -> dict:
    """{(duration, fs): (int16 base drop, truth)} for every spec."""
    from axctdprocessor_tpu_torch.models import simulator

    bases = {}
    for dur, fs, _ in SPECS:
        spec = simulator.SimSpec(duration=dur, fs=fs, profile_start=min(33.0, dur * 0.4), seed=5)
        pcm, truth = simulator.synthesize(spec)
        scale = 28000 / np.max(np.abs(pcm))
        bases[(dur, fs)] = (np.round(pcm * scale).astype(np.int16), truth)
    return bases


def build_corpus(corpus_dir: str, n_files: int, bases: dict | None = None) -> dict:
    """Writes the corpus of `n_files` files into `corpus_dir`, in the JAX
    script's order of random draws; returns the bases."""
    from scipy.io import wavfile

    bases = bases or synthesize_bases()
    os.makedirs(corpus_dir, exist_ok=True)
    rng = np.random.default_rng(1000)
    keys = [(d, f) for d, f, _ in SPECS]
    weights = np.asarray([w for _, _, w in SPECS])
    choice = rng.choice(len(keys), n_files - N_CORRUPT, p=weights / weights.sum())
    # the draws in order on this thread, the files written on another
    with ThreadPoolExecutor(max_workers=1) as writer:
        pending = []
        for i, ki in enumerate(choice):
            dur, fs = keys[ki]
            base = bases[(dur, fs)][0]
            noisy = rng.integers(-300, 300, len(base))
            noisy += base
            noisy = np.clip(noisy, -32768, 32767, out=noisy).astype(np.int16)
            pending.append(writer.submit(wavfile.write,
                                         os.path.join(corpus_dir, f"drop{i:04d}.wav"), fs, noisy))
            while len(pending) > 4:
                pending.pop(0).result()
        for job in pending:
            job.result()
    write_corrupt_files(corpus_dir, rng, bases[(60.0, 44100)][0])
    return bases


def write_corrupt_files(corpus_dir: str, rng, base: np.ndarray) -> None:
    """The five corrupt files (``CORRUPT``); `rng` draws the random one's
    bytes, `base` (int16 at 44.1 kHz, at least 2 s) gives the cut one's."""
    from scipy.io import wavfile

    open(os.path.join(corpus_dir, "bad_empty.wav"), "wb").close()
    with open(os.path.join(corpus_dir, "bad_truncated.wav"), "wb") as f:
        f.write(b"RIFF\x24\x00\x00\x00WAVE")  # a header alone, no fmt or data chunk
    with open(os.path.join(corpus_dir, "bad_random.wav"), "wb") as f:
        f.write(rng.integers(0, 256, 4096, np.uint8).tobytes())
    with open(os.path.join(corpus_dir, "bad_text.wav"), "w") as f:
        f.write("this is not audio\n" * 64)
    with open(os.path.join(corpus_dir, "bad_cut_data.wav"), "wb") as f:
        # a valid header that claims more data than the file holds
        wavfile.write(f, 44100, base[: 2 * 44100])
        f.truncate(44 + len(base[:44100].tobytes()) // 2)


def drop_seconds(paths: list[str]) -> dict:
    """{name: seconds} of every drop (not the corrupt files), from the size
    and the header's rate."""
    from scipy.io import wavfile

    return {os.path.basename(p): (os.path.getsize(p) - 44) / 2 / int(wavfile.read(p, mmap=True)[0])
            for p in paths if os.path.basename(p).startswith("drop")}


def read_report(path: str) -> dict:
    """The header fields and the hexframes of a profile report."""
    fields, hexframes, in_profile = {}, [], False
    with open(path) as f:
        for line in f:
            if in_profile:
                hexframes.append(line.split(",")[1].strip())
            elif line.startswith(("Probe Code: ", "Maximum Depth (m): ", "Probe Serial: ")):
                key, value = line.rstrip("\n").split(": ", 1)
                fields[key] = value
            elif line.startswith("Time (s), Hex Frame"):
                in_profile = True
    return dict(serial_no=fields.get("Probe Serial"), probe_code=fields.get("Probe Code"),
                max_depth=fields.get("Maximum Depth (m)"), hexframes=hexframes)


def truths_of(paths: list[str], seconds: dict, bases: dict) -> dict:
    """{name: the truth of its base} of every drop, by its length and rate."""
    from scipy.io import wavfile

    return {os.path.basename(p): bases[(round(seconds[os.path.basename(p)]),
                                        int(wavfile.read(p, mmap=True)[0]))][1]
            for p in paths if os.path.basename(p) in seconds}


def check_against_truth(manifest: dict, truths: dict) -> dict:
    """Holds every ``done`` drop to its truth (`truths`: {name: truth};
    raises on the first that fails): decode status 2, the serial, probe code
    and maximum depth of its report, more than ``IN_TRUTH`` of its
    hexframes in the truth.  Returns the lowest share and the drops held."""
    worst, held = 1.0, 0
    for name, entry in manifest["files"].items():
        if entry["status"] != "done":
            continue
        truth = truths[name]
        assert entry["decode_status"] == 2, (name, entry)
        rep = read_report(entry["output"])
        for key in ("serial_no", "probe_code", "max_depth"):
            assert rep[key] == str(truth[key]), (name, key, rep[key], truth[key])
        truth_set = set(truth["frame_hex"])
        share = sum(h in truth_set for h in rep["hexframes"]) / max(len(rep["hexframes"]), 1)
        assert share > IN_TRUTH, (name, share)
        worst = min(worst, share)
        held += 1
    return dict(lowest_in_truth=worst, held_to_truth=held)


def card() -> dict:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout
    return dict(nvidia_smi=smi.strip().splitlines()[0])


def run(n_files: int, corpus_dir: str, out_dir: str, *, device: str = "cuda",
        fresh: bool = False) -> dict:
    """Builds the corpus if `corpus_dir` does not hold `n_files` WAVs, runs
    it (resuming from `out_dir`'s manifest unless `fresh`), checks it and
    returns the record."""
    from axctdprocessor_tpu_torch.parallel.archive import reprocess_corpus
    from axctdprocessor_tpu_torch.utils.profiling import StageTimer

    bases = None
    if len(glob.glob(os.path.join(corpus_dir, "*.wav"))) != n_files:
        shutil.rmtree(corpus_dir, ignore_errors=True)
        t0 = time.perf_counter()
        bases = build_corpus(corpus_dir, n_files)
        print(f"built the {n_files}-file corpus in {time.perf_counter() - t0:.1f} s", flush=True)
    bases = bases or synthesize_bases()
    paths = sorted(glob.glob(os.path.join(corpus_dir, "*.wav")))
    assert len(paths) == n_files, (len(paths), n_files)
    seconds = drop_seconds(paths)

    prev_done = set()
    man_path = os.path.join(out_dir, "manifest.json")
    if fresh:
        shutil.rmtree(out_dir, ignore_errors=True)
    elif os.path.exists(man_path):
        with open(man_path) as f:
            prev = json.load(f)
        prev_done = {n for n, v in prev.get("files", {}).items() if v["status"] == "done"}
        print(f"resuming: {len(prev_done)} files already done", flush=True)

    timer = StageTimer()
    t0 = time.perf_counter()
    manifest = reprocess_corpus(paths, out_dir, batch_size=8, device=device,
                                resume=bool(prev_done), timer=timer)
    wall = time.perf_counter() - t0

    files = manifest["files"]
    failed = sorted(n for n, v in files.items() if v["status"] == "failed")
    done = sum(v["status"] == "done" for v in files.values())
    decoded_run = [n for n, v in files.items() if v["status"] == "done" and n not in prev_done]
    out = {
        "n_files": n_files,
        "done": done,
        "quarantined": len(failed),
        "accounted": done + len(failed),
        "reports_written": len(glob.glob(os.path.join(out_dir, "*.txt"))),
        "profile_rows": sum(v.get("rows", 0) for v in files.values() if v["status"] == "done"),
        "audio_s_total": sum(seconds.values()),
        "audio_s_decoded": sum(seconds[n] for n, v in files.items() if v["status"] == "done"),
        "audio_s_decoded_this_run": sum(seconds[n] for n in decoded_run),
        "resumed_from": len(prev_done),
        "decoded_this_run": len(decoded_run),
        "wall_s": wall,
        "drops_per_s": len(decoded_run) / max(wall, 1e-9),
        "corpus_rtf": sum(seconds[n] for n in decoded_run) / max(wall, 1e-9),
        "device": device,
        "stage_times": timer.as_dict(),
        "quarantine_entries": {n: files[n] for n in failed},
    }
    if device != "cpu":
        import torch

        out["card"] = dict(card(), kind=torch.cuda.get_device_name(0))
    assert out["accounted"] == n_files, "every file must be accounted for"
    assert failed == sorted(CORRUPT), f"expected exactly the corrupt files quarantined: {failed}"
    assert done == n_files - N_CORRUPT, done
    out.update(check_against_truth(manifest, truths_of(paths, seconds, bases)))
    return out


def main(argv=None) -> int:
    n_files = int(os.environ.get("CORPUS_N", "1000"))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(), f"axctd_corpus{n_files}"),
                    help="the corpus (built there if it does not hold CORPUS_N WAVs)")
    ap.add_argument("--out", default=None, help="reports, manifest and the record")
    args = ap.parse_args(argv)
    out_dir = args.out or args.dir + "_out"
    rec = run(n_files, args.dir, out_dir, device=args.device,
              fresh=os.environ.get("CORPUS_FRESH") == "1")
    with open(os.path.join(out_dir, f"corpus_{n_files}.json"), "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
        f.write("\n")
    print(json.dumps({k: v for k, v in rec.items()
                      if k not in ("stage_times", "quarantine_entries")}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    sys.exit(main())
