"""Per-stage wall-clock timing of the decode pipelines.

A copy of ``StageTimer`` from axctdprocessor_tpu.utils.profiling (the
module's ``device_trace`` wraps ``jax.profiler`` and is not copied; on the
card ``torch.profiler`` takes its place): the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class StageTimer:
    """Accumulates wall time per named stage across repeated calls."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f"{name:28s} {self.totals[name]*1e3:10.1f} ms"
                f"  x{self.counts[name]}"
            )
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {k: round(v, 6) for k, v in self.totals.items()}
