"""Sound runs of a cell on many seeds in one process, for the readings that
a cell's limits are set from: each seed's run as ``run.py`` makes it (set-up,
window, traced window where asked, every answer judged), its line printed
as it ends.  The set-up of the first seed builds or loads the kernels; the
later seeds' set-up is no ``setup_s``.

    python3 portbench/tools/readings.py --workload drop600.auto --seconds 5 \\
        --seeds 101 102 103 --traced 101
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import run as bench_run  # noqa: E402  (one math thread, as run.py)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--traced", type=int, nargs="*", default=[],
                    help="seeds run with --trace 1")
    args = ap.parse_args(argv)
    import torch

    from portbench.core import harness

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("[portbench] needs a CUDA card: nothing measured", file=sys.stderr)
        return 2
    for seed in args.seeds:
        line = harness.run(args.workload, seed, args.seconds, seed in args.traced,
                           device="cuda")
        line = {"workload": args.workload, "seed": seed, "trace": seed in args.traced, **line}
        bench_run.print_checks(line)
        print(json.dumps(line), flush=True)
    bad = bench_run.forbidden_modules()
    if bad:
        print(f"[portbench] loaded {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
