"""Run one cell of the port's benchmark on the card(s) of this machine.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up (imports, the kernels' build or load,
the inputs made from the seed, the warm-up) is timed from the start of this
process; then the cell's units run back to back for ``--seconds``; with
``--trace 1`` a few more units run under ``torch.profiler`` and the line
holds the per-layer metrics.  Every answer is then judged against the frozen
float64 reference (``portbench/reference``).  Progress and the numbers
compared go to standard error; the last line of standard output is the
result, one JSON object.  Without a CUDA card, or with fewer than the cell
asks for, nothing is measured and the exit code is 2.

The port's kernels build into ``axctdprocessor_tpu_torch/_build/`` inside the
checkout: the first run of a checkout builds them, later runs load them.
Scratch files go under ``TMPDIR`` and are deleted at the end.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# One thread for the math libraries: the port's host work is Python and numpy
# between launches, and idle OpenMP workers on a shared host made runs both
# slower and less steady (drop600: 8 threads 3,638-4,272 audio s/s, 1 thread
# 4,439-4,589, NVIDIA H100 80GB HBM3 at 700 W).  Set before numpy and torch load.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
FORBIDDEN = ("jax", "jaxlib", "flax", "axctdprocessor_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (the port's name begins with the JAX package's: no prefix test)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def print_checks(line: dict) -> None:
    for name, c in line.get("checks", {}).items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    os.environ.setdefault("USE_FLAX", "0")

    from portbench.core import harness, registry

    chips = int(registry.workload(registry.benchmark(), args.workload)["chips"])
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[portbench] needs {chips} CUDA card(s); torch.cuda.is_available() = "
              f"{torch.cuda.is_available()}, device_count() = {torch.cuda.device_count()}: "
              "nothing measured", file=sys.stderr)
        return 2

    partial = {}

    def on_term(signum, frame):
        line = dict(partial or {"correct": False, "attempted": 0, "failed": 0, "metrics": {}})
        line["correct"] = False
        line["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": chips, "memory_peak_bytes": harness.memory_peak_bytes("cuda")}
        print("[portbench] terminated: the run was cut", file=sys.stderr, flush=True)
        print(json.dumps(line), flush=True)
        os._exit(143)

    signal.signal(signal.SIGTERM, on_term)
    line = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                       device="cuda", t_start=T_START, chips=chips,
                       on_partial=lambda d: partial.update(d))
    bad = forbidden_modules()
    if bad:
        print(f"[portbench] refused: loaded {bad} in the measuring process", file=sys.stderr)
        return 3
    harness.log(f"card: {power_limit()}")
    print_checks(line)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
