"""What the port's spans cost a warm drop on one GPU: ``decode_wav`` of a 240 s
drop (the monolithic program) and a 600 s drop (the segmented engine) with the
benchmark's span recorder (``portbench/core/spans.Recorder``), with a
``StageTimer`` and with no timer, in turns.

The drops are int16 WAVs the port's simulator writes (``SimSpec(duration=240,
profile_start=38, seed=7)`` and ``(600, 33, 11)``), each decoded three times
to warm its programs up.  Then ``--rounds240`` rounds of the 240 s drop and
``--rounds600`` of the 600 s drop: each round decodes the drop once per timer,
the order turned round every round.  Printed, one JSON line: the card and its
power limit; per drop and timer the median wall in ms; the median of each
round's wall with the timer less its wall with none, in microseconds; the
spans a drop opens; and the host cost of one span on each timer alone, timed
in a loop (``with timer.stage(name): pass``), with that cost times the spans
a drop opens.  A round's difference carries the walls' own noise (a drop's
wall spreads by milliseconds on a shared host): the loop's figure is the
spans' cost, the rounds' median says that nothing larger hides beside it.

    python scripts/span_cost.py [--rounds240 60] [--rounds600 24]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"  # as the benchmark runs

from axctdprocessor_tpu_torch.models import engine, simulator  # noqa: E402
from axctdprocessor_tpu_torch.utils.profiling import StageTimer  # noqa: E402
from portbench.core.spans import Recorder  # noqa: E402

TIMERS = {"none": lambda: None, "stage_timer": StageTimer, "recorder": Recorder}


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _wav(directory: str, seconds: float, start: float, seed: int) -> str:
    spec = simulator.SimSpec(duration=seconds, profile_start=start, seed=seed)
    pcm, _ = simulator.synthesize(spec)
    path = os.path.join(directory, f"drop{int(seconds)}.wav")
    simulator.write_wav(path, pcm, spec.fs)
    return path


def _decode(path: str, timer) -> float:
    t0 = time.perf_counter()
    engine.decode_wav(path, device="cuda", timer=timer)
    return time.perf_counter() - t0


def _spans(path: str) -> int:
    rec = Recorder()
    engine.decode_wav(path, device="cuda", timer=rec)
    return len(rec.spans)


def _span_seconds(timer, n: int = 20000) -> float:
    """Seconds one empty span takes on `timer`, the median of 5 loops of `n`."""
    loops = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            with timer.stage("device_wait"):
                pass
        loops.append((time.perf_counter() - t0) / n)
    return statistics.median(loops)


def run(path: str, rounds: int) -> dict:
    for _ in range(3):
        _decode(path, None)
    walls = {k: [] for k in TIMERS}
    for r in range(rounds):
        order = list(TIMERS) if r % 2 == 0 else list(TIMERS)[::-1]
        for k in order:
            walls[k].append(_decode(path, TIMERS[k]()))
    spans = _spans(path)
    out = {"rounds": rounds, "spans_a_drop": spans,
           "median_ms": {k: 1e3 * statistics.median(v) for k, v in walls.items()}}
    for k in ("stage_timer", "recorder"):
        diffs = [a - b for a, b in zip(walls[k], walls["none"])]
        out[f"{k}_minus_none_us"] = {"median": 1e6 * statistics.median(diffs),
                                     "quartiles": [1e6 * q for q in
                                                   statistics.quantiles(diffs, n=4)]}
        per_span = _span_seconds(TIMERS[k]())
        out[f"{k}_span_us"] = 1e6 * per_span
        out[f"{k}_spans_us_a_drop"] = 1e6 * per_span * spans
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds240", type=int, default=60)
    ap.add_argument("--rounds600", type=int, default=24)
    args = ap.parse_args()
    line = {"card": _card()}
    with tempfile.TemporaryDirectory() as d:
        line["drop240"] = run(_wav(d, 240.0, 38.0, 7), args.rounds240)
        line["drop600"] = run(_wav(d, 600.0, 33.0, 11), args.rounds600)
    print(json.dumps(line))


if __name__ == "__main__":
    main()
