"""Archive corpus demonstration on the port: N synthetic 60 s drops as int16
WAVs through ``parallel.archive.reprocess_corpus`` (sorted by rate and
length bucket, two reader threads, the manifest), with the aggregate
throughput.

The counterpart of the JAX package's ``scripts/corpus_demo.py``: the same
drops (one 60 s base, simulator seed 21 with the profile at 40 s, plus
noise of +-300 from ``default_rng(1000 + k)`` for drop k), a warm pass over
the first batch, then the timed run over all of them and a spot check of
``drop0000``'s report.  The upload format is the port's default wire
(``wire="auto"``: int16 on every path, ``ops/wire.default_wire``), which the
script prints.  Run as a file from the repository root; ``--device cpu``
runs on the host:

    python axctdprocessor_tpu_torch/tools/corpus_demo.py [n_drops] [batch_size]
        [--device cuda] [--dir DIR]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

import numpy as np

DUR = 60.0


def build_corpus(corpus_dir: str, n_drops: int) -> list[str]:
    """The drops' WAVs in `corpus_dir` (those already there are kept)."""
    from axctdprocessor_tpu_torch.models import simulator

    os.makedirs(corpus_dir, exist_ok=True)
    paths, base = [], None
    for k in range(n_drops):
        path = os.path.join(corpus_dir, f"drop{k:04d}.wav")
        paths.append(path)
        if os.path.exists(path):
            continue
        if base is None:
            pcm, _ = simulator.synthesize(simulator.SimSpec(duration=DUR, profile_start=40.0,
                                                            seed=21))
            base = np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)
        rng = np.random.default_rng(1000 + k)
        row = np.clip(base.astype(np.int32) + rng.integers(-300, 300, len(base)),
                      -32768, 32767).astype(np.int16)
        simulator.write_wav(path, row / 32768.0, 44100)
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_drops", nargs="?", type=int, default=100)
    ap.add_argument("batch_size", nargs="?", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(), "axctd_corpus"),
                    help="the corpus; its reports go to DIR_out")
    args = ap.parse_args(argv)
    import torch

    from axctdprocessor_tpu_torch.models.engine import resolve_device
    from axctdprocessor_tpu_torch.ops.wire import default_wire
    from axctdprocessor_tpu_torch.parallel.archive import reprocess_corpus

    dev = resolve_device(args.device)
    print(f"device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
                              else "") + f"; wire: auto = {default_wire(dev)}")
    t0 = time.perf_counter()
    paths = build_corpus(args.dir, args.n_drops)
    print(f"corpus: {len(paths)} x {DUR:.0f}s drops ({time.perf_counter() - t0:.1f}s to generate)")

    out = args.dir + "_out"
    shutil.rmtree(out, ignore_errors=True)
    # a warm pass over the first batch: the kernels' build and first launches
    reprocess_corpus(paths[: args.batch_size], out, batch_size=args.batch_size, device=dev,
                     resume=False)
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    manifest = reprocess_corpus(paths, out, batch_size=args.batch_size, device=dev, resume=False)
    wall = time.perf_counter() - t0

    files = manifest["files"]
    done = sum(v.get("status") == "done" for v in files.values())
    failed = [k for k, v in files.items() if v.get("status") != "done"]
    wires = sorted({v["wire"] for v in files.values() if v.get("status") == "done"})
    print(f"decoded {done}/{len(paths)} drops in {wall:.1f} s -> {done * DUR / wall:.0f}x "
          f"realtime aggregate, {done / wall:.1f} drops/s; wire {', '.join(wires)}")
    if failed:
        print("failed:", failed[:5])
    rpt = os.path.join(out, "drop0000.txt")
    with open(rpt) as fh:
        head = fh.read().splitlines()
    assert any("Probe Serial: 00123456" in ln for ln in head), head[:12]
    print("report spot-check OK:", rpt)
    return 0 if not failed else 1


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    sys.exit(main())
