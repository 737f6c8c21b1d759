"""The program cache over an archive cell's passes: for each pass of the
cell's client, every batch's shape with what the cache holds after it is
dispatched, and the pass's time in the cache's spans (``program.build``,
``.eager``, ``.capture``, ``.evict``) with the number of each; then every
cached program's pool.  Works on a port with or without
``programs.cache_stats`` (printed where there is one).

    python3 portbench/tools/cache_passes.py --workload archive.batch64 --seed 7 --passes 5

One JSON object a pass on standard output, then one of the programs; the
first two passes are the cell's warm-up (``warmup_passes``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import run as bench_run  # noqa: E402,F401  (one math thread, as run.py)

CACHE_SPANS = ("program.build", "program.eager", "program.capture", "program.evict")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import shutil

    import torch

    from axctdprocessor_tpu_torch.models import programs
    from axctdprocessor_tpu_torch.parallel import archive
    from portbench.core import registry
    from portbench.core.spans import Recorder

    torch.set_num_threads(1)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
    bench = registry.benchmark()
    wl = registry.workload(bench, args.workload)
    recorder = Recorder()
    workdir = tempfile.mkdtemp(prefix="portbench-cache-")
    batches: list = []
    real = archive.dispatch_batch

    def dispatch_and_record(pcms, fs, *a, **kw):
        out = real(pcms, fs, *a, **kw)
        batches.append({"rows": int(pcms.shape[0]), "width_s": pcms.shape[1] / float(fs),
                        "dtype": str(pcms.dtype), "held_gib": programs.held_bytes(dev) / 2**30,
                        "programs": len(programs.programs())})
        return out

    archive.dispatch_batch = dispatch_and_record
    try:
        client = registry.client(registry.traffic(wl["traffic"])["client"]).Client(
            registry.config(wl["config"]), registry.traffic(wl["traffic"]), args.seed,
            args.device, workdir, recorder)
        client.make_inputs()
        for k in range(args.passes):
            first, n0 = recorder.mark(), len(batches)
            t0 = time.perf_counter()
            client._pass()
            wall = time.perf_counter() - t0
            spans = recorder.spans[first:]
            line = {"pass": k, "wall_s": wall, "batches": batches[n0:]}
            for name in CACHE_SPANS:
                mine = [t1 - t0 for n, t0, t1 in spans if n == name]
                line[name] = {"count": len(mine), "ms": 1e3 * sum(mine)}
            if hasattr(programs, "cache_stats"):
                line["cache_stats"] = programs.cache_stats(dev)
            print(json.dumps(line), flush=True)
        held = [{"kind": str(p.key[0] if isinstance(p.key, tuple) else p.key),
                 "inputs": [list(t.shape) for t in p.inputs], "pool_gib": p.pool_bytes / 2**30,
                 "input_gib": p.input_bytes / 2**30, "calls": p.calls}
                for p in programs.programs()]
        mem = {}
        if dev.type == "cuda":
            mem = {"budget_gib": programs.pool_budget(dev) / 2**30,
                   "max_allocated_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                   "max_reserved_gib": torch.cuda.max_memory_reserved(dev) / 2**30,
                   "card": bench_run.power_limit()}
        print(json.dumps({"programs": held, **mem}), flush=True)
        client.release()
    finally:
        archive.dispatch_batch = real
        shutil.rmtree(workdir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
