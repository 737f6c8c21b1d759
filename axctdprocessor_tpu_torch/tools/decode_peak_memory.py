"""Peak device memory of one ``decode_batch`` of the bench's 64 x 60 s archive
batch, or of one monolithic decode of the 600 s bench drop, for the port of
this checkout or of another one.

The batch is ``chip_smoke.archive_batch()`` of the tree under test (the
bench's rows: one simulated drop plus noise per row, seeded); ``--drop600``
decodes the 600 s bench drop instead (the tree's simulator, ``SimSpec(
duration=600, profile_start=33, seed=11)`` as int16, ``mode="monolithic"``).
After one warm-up decode the peak statistics are reset and the input is
decoded again; the script prints one JSON line with the card, the tree, the
peak of ``torch.cuda.max_memory_allocated`` in that decode and the wall.  ``--tree``
names the root of another checkout (for example an earlier commit's, unpacked
with ``git archive``); run one tree per process, as a file (not with ``-m``, which would
import this checkout's port first).  Needs one NVIDIA GPU:

    python axctdprocessor_tpu_torch/tools/decode_peak_memory.py [--tree DIR] [--rows 64]
        [--drop600]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--drop600", action="store_true",
                    help="the 600 s bench drop, monolithic, in place of the batch")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    if not torch.cuda.is_available():
        print("decode_peak_memory: no GPU", file=sys.stderr)
        return 1
    if args.drop600:
        import numpy as np

        from axctdprocessor_tpu_torch.models import engine, simulator

        pcm, _ = simulator.synthesize(simulator.SimSpec(duration=600.0, profile_start=33.0,
                                                        seed=11))
        raw = np.round(pcm * (28000 / np.max(np.abs(pcm)))).astype(np.int16)

        def decode():
            return [engine.decode_waveform(raw, 44100, device="cuda", mode="monolithic")]
        what = {"input": "600 s bench drop, monolithic"}
    else:
        import chip_smoke
        from axctdprocessor_tpu_torch.parallel import batch

        drops = chip_smoke.archive_batch()
        rows, fs = drops["batch"][: args.rows], drops["batch_fs"]

        def decode():
            return batch.decode_batch(rows, fs, device="cuda")
        what = {"rows": len(rows)}
    decode()  # warm-up: the kernels' build, the plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = decode()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert all(r.status == 2 for r in results)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "tree": os.path.relpath(tree, os.getcwd()), **what,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "wall_s": wall}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
