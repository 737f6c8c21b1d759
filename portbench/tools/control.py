"""The control of a cell's correctness check: the frozen reference put in the
port's place with one guarantee of the configuration broken (``--variant
rounded``: salinity from T and C already rounded to two decimals;
``reference/job.py``), judged by the cell's own comparison and limits against
the reference, on the cell's own inputs.  ``--variant truncated``,
``frames_cut``, ``late_start`` and ``made_up`` plant a fault in its answer
instead: the deepest quarter of the rows left out; the last tenth of the
frames, with their rows; the profile start reported 0.2 s late; every tenth
row beside a frame never synced.  Several variants run on
one reference decode of each input.

    python3 portbench/tools/control.py --workload drop600.auto --seeds 11 12 13

Prints, for each seed, every number compared beside its limit and whether
the control came out correct (it has to come out not correct).  It needs no
card: the control is numpy.  ``--variant float32`` runs the conversion in
float32; ``--variant float64`` the reference itself in the port's place
(every number reads its best).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variant", nargs="+", default=["rounded"],
                    choices=("rounded", "float32", "float64", "truncated", "frames_cut",
                             "late_start", "made_up"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench.core import harness, inputs, judge, registry

    wl = registry.workload(registry.benchmark(), args.workload)
    traffic = registry.traffic(wl["traffic"])
    limits = registry.cell(args.workload)["limits"]
    samples = "float32" if traffic["client"] == "live_stream" else None
    for seed in args.seeds:
        work = tempfile.mkdtemp(prefix="portbench-control-")
        try:
            drops = inputs.render_all(inputs.drop_specs(seed, inputs.drops_of(traffic)), work)
            jobs = {}
            for i, d in enumerate(drops):
                base = {"path": d["path"], "name": d["path"], "samples": samples}
                jobs[("ref", i)] = base
                for v in args.variant:
                    jobs[(v, i)] = dict(base, variant=v, keep_result=True)
            refs = harness.run_references(jobs)
            for v in args.variant:
                numbers = []
                for i, d in enumerate(drops):
                    rep = os.path.join(work, f"{v}{i:03d}.txt")
                    with open(rep, "w") as f:
                        f.write(refs[(v, i)]["text"])
                    with open(rep) as f:
                        numbers.append(judge.compare(f.read(), refs[(v, i)]["result"],
                                                     refs[("ref", i)], d["path"]))
                ok, checks, failed = judge.verdict(numbers, limits)
                line = {"workload": args.workload, "seed": seed, "variant": v, "correct": ok,
                        "failed": failed, "answers": len(numbers), "checks": checks}
                print(json.dumps(line), flush=True)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
