"""What the port's report writer costs for a 600 s drop: ``format_report`` with
its rows written as whole columns (``utils/report``) against the same function
with the per-row f-string loop it replaced, in turns in one process.

The result is synthetic, shaped as ``engine.attach_profile`` leaves a 600 s
drop: 15,000 frames at 25 a second from 33 s on, about 14,700 of them kept as
rows, every value ``np.round(., 2)`` as ``numpy.float64`` in a list, the hex
frames ``f"{w:08x}"`` of every frame.  Each of ``--rounds`` rounds formats
the report once each way, the order turned round every round.  Printed, one
JSON line: the card and its power limit where there is one (the writer runs
on the host alone), the rows and frames, the median and quartiles of each
way in ms, the reports that opened the span ``report_exact`` (0 expected),
and whether both ways wrote the same text.

    python scripts/report_cost.py [--rounds 200] [--seed 7]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from axctdprocessor_tpu_torch.models.result import DecodeResult  # noqa: E402
from axctdprocessor_tpu_torch.utils import profiling, report  # noqa: E402
from axctdprocessor_tpu_torch.utils.config import DecoderConfig  # noqa: E402

ECHO = {"triggerrange": [30, -1], "minR400": 2.0, "mindR7500": 1.5, "deadfreq": 3000.0,
        "pointsperloop": 100000}


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip() or "none"
    except (OSError, subprocess.SubprocessError):
        return "none"


def drop600(seed: int) -> DecodeResult:
    """A result with a 600 s drop's rows, as ``attach_profile`` lists them."""
    rng = np.random.default_rng(seed)
    frames = 15000
    t = 33.0 + np.arange(frames) / 25.0
    depth = 3.2 * (t - 33.0) + rng.normal(0, 0.01, frames)
    temp = 28.0 - 26.0 * (1 - np.exp(-depth / 300.0)) + rng.normal(0, 0.02, frames)
    cond = 30.0 + 0.9 * temp + rng.normal(0, 0.02, frames)
    psal = 34.5 + 0.001 * depth + rng.normal(0, 0.01, frames)
    good = rng.random(frames) < 0.98
    res = DecodeResult(fs=44100.0, numpoints=int(633 * 44100))
    for name, values in (("time", t), ("depth", depth), ("temperature", temp),
                         ("conductivity", cond), ("salinity", psal)):
        setattr(res, name, list(np.round(values, 2)[good]))
    res.hexframes = [f"{w:08x}" for w in rng.integers(0, 2**32, frames, dtype=np.uint64)]
    return res


def fstring_rows(result: DecodeResult, diagnostics: bool) -> str:
    """The per-row loop the column writer replaced."""
    lines = []
    for t, hf, z, temp, cond, psal in zip(
        result.time, result.hexframes, result.depth, result.temperature,
        result.conductivity, result.salinity,
    ):
        lines.append(f"{t:8.2f},  {hf},{z:10.2f},{temp:16.2f},{cond:21.2f},{psal:15.2f}\n")
    return "".join(lines)


def _format(res: DecodeResult) -> str:
    return report.format_report(res, "drop600.wav", [0, -1], ECHO, DecoderConfig())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    res = drop600(args.seed)
    writers = {"columns": report._format_rows, "fstring": fstring_rows}
    timer = profiling.StageTimer()
    with profiling.installed(timer):
        new_text = _format(res)
    with mock.patch.object(report, "_format_rows", fstring_rows):
        old_text = _format(res)
    ms = {way: [] for way in writers}
    for r in range(args.rounds):
        for way in (list(writers) if r % 2 == 0 else list(writers)[::-1]):
            with mock.patch.object(report, "_format_rows", writers[way]):
                t0 = time.perf_counter()
                _format(res)
                ms[way].append(1e3 * (time.perf_counter() - t0))
    line = {"card": _card(), "rows": len(res.time), "frames": len(res.hexframes),
            "rounds": args.rounds, "report_exact": timer.counts["report_exact"],
            "same_text": new_text == old_text}
    for way, v in ms.items():
        line[f"{way}_ms"] = {"median": statistics.median(v),
                             "quartiles": statistics.quantiles(v, n=4)}
    print(json.dumps(line))


if __name__ == "__main__":
    main()
