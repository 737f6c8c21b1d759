"""Per-stage wall-clock timing, the one route of the port's spans, and a
profiler hook (``StageTimer`` and ``device_trace`` after
axctdprocessor_tpu.utils.profiling).

* :class:`StageTimer` — wall-clock totals per named stage across repeated
  calls, with the stage each was first opened in (:meth:`StageTimer.report`
  indents a stage under it); while :func:`device_trace` records, each stage
  is also a ``torch.profiler.record_function`` range of the same name, on
  the kernels' timeline;
* :func:`span` — a stage on the timer that the nearest enclosing entry point
  installed (:func:`entry_point`, :func:`installed`), or one shared no-op
  where none is: code below the entry points opens its spans without a
  ``timer`` argument;
* :func:`device_trace` — a context manager around ``torch.profiler`` that
  writes a Chrome trace into a directory when one is given (a no-op
  otherwise), where the JAX package's wraps ``jax.profiler.trace``.

A timer is anything with ``stage(name)`` (a context manager) and
``as_dict()``.  Torch is imported only when a trace is taken.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import threading
import time
from collections import defaultdict

NO_SPAN = contextlib.nullcontext()  # reusable: what a span is with no timer installed
_timer: contextvars.ContextVar = contextvars.ContextVar("axctd_timer", default=None)
_tracing = False  # True while device_trace records


class StageTimer:
    """Accumulates wall time per named stage across repeated calls; a stage
    opened inside another (on the same thread) is reported under it.
    Threads may open stages at once (the archive runner's readers do)."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.parents: dict[str, str | None] = {}  # the stage open at a name's first opening
        self._open = threading.local()
        self._lock = threading.Lock()  # the totals' read-modify-write

    @contextlib.contextmanager
    def stage(self, name: str):
        stack = self._open.__dict__.setdefault("stack", [])
        self.parents.setdefault(name, stack[-1] if stack else None)
        stack.append(name)
        if _tracing:
            from torch.profiler import record_function

            ctx = record_function(name)
        else:
            ctx = NO_SPAN
        t0 = time.perf_counter()
        try:
            with ctx:
                yield
        finally:
            seconds = time.perf_counter() - t0
            with self._lock:
                self.totals[name] += seconds
                self.counts[name] += 1
            stack.pop()

    def report(self) -> str:
        """The totals, each stage under the one it was first opened in,
        siblings longest first."""
        children = defaultdict(list)
        for name in self.totals:
            parent = self.parents.get(name)
            children[parent if parent in self.totals else None].append(name)
        lines = []

        def walk(parent, depth):
            for name in sorted(children[parent], key=self.totals.get, reverse=True):
                lines.append(f"{'  ' * depth + name:28s} {self.totals[name]*1e3:10.1f} ms"
                             f"  x{self.counts[name]}")
                walk(name, depth + 1)

        walk(None, 0)
        return "\n".join(lines)

    def as_dict(self) -> dict:
        with self._lock:
            return {k: round(v, 6) for k, v in self.totals.items()}


class _NoTimer:
    """The timer of a call given none: records nothing, builds nothing."""

    def stage(self, name: str):
        return NO_SPAN

    def as_dict(self) -> dict:
        return {}


NO_TIMER = _NoTimer()


def current():
    """The timer the nearest enclosing entry point installed, else ``NO_TIMER``."""
    timer = _timer.get()
    return NO_TIMER if timer is None else timer


def span(name: str):
    """A stage `name` on the installed timer (a context manager); the shared
    ``NO_SPAN`` when none is installed."""
    timer = _timer.get()
    return NO_SPAN if timer is None else timer.stage(name)


@contextlib.contextmanager
def installed(timer):
    """`timer` as the sink of :func:`span` while the block runs, in this
    thread (threads started inside see none); yields the timer the caller
    records its own stages on: `timer`, or for None (and ``NO_TIMER``) the
    one already installed, else ``NO_TIMER``."""
    if timer is None or timer is NO_TIMER:
        yield current()
        return
    token = _timer.set(timer)
    try:
        yield timer
    finally:
        _timer.reset(token)


def entry_point(fn=None, *, default=None):
    """Decorator of an entry point with a keyword ``timer=``: the timer is
    :func:`installed` for the call's extent and handed to the function as
    ``timer`` (never None).  ``default()`` makes the timer of a call given
    none; without it such a call records into the enclosing entry point's
    timer, or nowhere."""
    if fn is None:
        return functools.partial(entry_point, default=default)

    @functools.wraps(fn)
    def call(*args, timer=None, **kwargs):
        if timer is None and default is not None:
            timer = default()
        with installed(timer) as timer:
            return fn(*args, timer=timer, **kwargs)

    return call


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """Capture a ``torch.profiler`` trace (host activity, and the card's
    where there is one) of the enclosed work into
    `trace_dir`/``trace.json``, a Chrome trace (None = no-op).  Every
    ``StageTimer`` stage opened meanwhile is a named range in it.  A process
    that has run the profiler launches kernels more slowly afterwards:
    trace last, or in a process of its own."""
    global _tracing
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
        _tracing = True
        try:
            yield
        finally:
            _tracing = False
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
