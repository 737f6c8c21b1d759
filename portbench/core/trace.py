"""The traced window: ``torch.profiler`` over a few units of the cell's own
work, and the reductions every metric reads from it.

The arithmetic follows ``chip_smoke.py`` (``profile_run``: device busy time
as the union of the card's activity, idle share = 1 - busy / window;
``launch_counts``: the host's launch calls by kind).  Times are seconds.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

from .spans import SPAN_PREFIX

WINDOW_SPAN = SPAN_PREFIX + "traced_window"


def launch_kind(name: str) -> str | None:
    """The kind of work a host-side CUDA runtime call of this
    name queues on the card (a graph launch queues the graph's kernels,
    copies and fills at once), or None."""
    if "GraphLaunch" in name:
        return "graph launches"
    if "Launch" in name and "Kernel" in name:
        return "kernel launches"
    if "Memcpy" in name:
        return "copies"
    if "Memset" in name:
        return "fills"
    return None


NAME_CHARS = 120


def short_name(name: str) -> str:
    """A kernel's name without ``void`` and its parameter list, at most
    NAME_CHARS long."""
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")") and not name.startswith(("Memcpy", "Memset")):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] or name
                break
    return name[:NAME_CHARS]


@dataclasses.dataclass
class Trace:
    """What the profiler saw in the traced window (times in seconds from
    the profiler's origin)."""

    window: tuple[float, float]
    device: list[tuple[str, float, float]]   # name, start, end
    host_calls: dict[str, int]               # launch calls by kind
    spans: list[tuple[str, float, float]]    # the recorder's spans
    units: int                               # units of work traced

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of device activity inside the window, as intervals."""
        lo, hi = self.window
        out: list[list[float]] = []
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    @property
    def host_launch_calls(self) -> int:
        return sum(self.host_calls.values())

    def device_seconds(self, substrings) -> float:
        """Device time of the operations whose name holds any of `substrings`."""
        return sum(b - a for name, a, b in self.device
                   if any(s in name for s in substrings))

    def top_device_ops(self, n: int = 10) -> list[list]:
        by: dict[str, float] = defaultdict(float)
        for name, a, b in self.device:
            by[short_name(name)] += b - a
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The card's idle time inside the window, summed by the innermost
        span open at each moment of it (the host's work while the card
        waited); a gap that spans several spans is cut at their edges."""
        lo, hi = self.window
        edges = [lo]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(hi)
        by: dict[str, float] = defaultdict(float)
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            cuts = sorted({a, b} | {t for _, s, e in self.spans for t in (s, e) if a < t < b})
            for x, y in zip(cuts, cuts[1:]):
                mid = 0.5 * (x + y)
                open_ = [(s, name) for name, s, e in self.spans if s <= mid <= e]
                by[max(open_)[1] if open_ else "(outside any span)"] += y - x
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def from_profile(prof, units: int) -> Trace | None:
    """A ``Trace`` from a finished ``torch.profiler.profile`` whose work ran
    inside ``record_function(WINDOW_SPAN)``; None if the window is missing."""
    from torch.autograd import DeviceType

    window = None
    device, spans = [], []
    calls = {k: 0 for k in ("kernel launches", "graph launches", "copies", "fills")}
    cpu_launches = []
    for e in prof.events():
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CUDA:
            # the profiler mirrors record_function ranges onto the device's
            # timeline as annotations: they are no device work
            if e.name and not e.name.startswith(SPAN_PREFIX):
                device.append((e.name, a, b))
        elif e.name == WINDOW_SPAN:
            window = (a, b)
        elif e.name.startswith(SPAN_PREFIX):
            spans.append((e.name[len(SPAN_PREFIX):], a, b))
        else:
            kind = launch_kind(e.name)
            if kind:
                cpu_launches.append((kind, a))
    if window is None:
        return None
    for kind, a in cpu_launches:
        if window[0] <= a <= window[1]:
            calls[kind] += 1
    return Trace(window=window, device=device, host_calls=calls, spans=spans, units=units)
