"""A span recorder that the port's entry points accept as their ``timer=``.

The port's ``StageTimer`` keeps totals only; this recorder keeps every span
(name, start, end) on the host clock, so that a metric can read one drop's
or one batch's spans and the trace can label a device idle gap by the span
open during it.  While a trace is taken, each span is also a
``torch.profiler.record_function`` range named ``portbench/<name>``, in the
profiler's own time base.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

SPAN_PREFIX = "portbench/"


class Recorder:
    """Duck-typed ``StageTimer`` (``stage(name)`` and ``as_dict()``, what the
    port calls); thread-safe (the archive runner's readers record from their
    own threads)."""

    def __init__(self):
        self.spans: list[tuple[str, float, float]] = []
        self.totals: dict[str, float] = defaultdict(float)
        self.profiling = False
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        label = name.strip()  # the segmented engine indents nested stages
        if self.profiling:
            from torch.profiler import record_function

            ctx = record_function(SPAN_PREFIX + label)
        else:
            ctx = contextlib.nullcontext()
        t0 = time.perf_counter()
        try:
            with ctx:
                yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.spans.append((label, t0, t1))
                self.totals[label] += t1 - t0

    def mark(self) -> int:
        """The number of spans recorded so far (a unit's first span)."""
        with self._lock:
            return len(self.spans)

    def totals_since(self, first: int) -> dict[str, float]:
        """Seconds by span name over the spans recorded from `first` on."""
        out: dict[str, float] = defaultdict(float)
        with self._lock:
            for name, t0, t1 in self.spans[first:]:
                out[name] += t1 - t0
        return dict(out)

    def as_dict(self) -> dict:
        with self._lock:
            return {k: round(v, 6) for k, v in self.totals.items()}
