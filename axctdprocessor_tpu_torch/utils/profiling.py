"""Per-stage wall-clock timing and a profiler hook (port of
axctdprocessor_tpu.utils.profiling).

* :class:`StageTimer` — a copy of the JAX package's: wall-clock stage
  accounting of the decode pipelines;
* :func:`device_trace` — a context manager around ``torch.profiler`` that
  writes a Chrome trace into a directory when one is given (a no-op
  otherwise), where the JAX package's wraps ``jax.profiler.trace``.
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


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """Capture a ``torch.profiler`` trace (host activity, and the card's
    where there is one) of the enclosed work into
    `trace_dir`/``trace.json``, a Chrome trace (None = no-op).  A process
    that has run the profiler launches kernels more slowly afterwards:
    trace last, or in a process of its own."""
    if not trace_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
