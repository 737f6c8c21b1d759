"""The arithmetic the metric readers share (``metrics/<name>.py`` binds one
of these to its name and inputs).  A reader that finds nothing to read
returns None; a share of a roofline is never reported as 0."""

from __future__ import annotations

from . import stats


def rate(reading) -> float | None:
    """Audio seconds completed in the window over the window's seconds."""
    if not reading.steps or reading.window_s <= 0:
        return None
    return sum(s.audio_s for s in reading.steps) / reading.window_s


def p95_ms(reading) -> float | None:
    """The 95th percentile of every unit's latency in the window."""
    p = stats.percentile([s.latency_s for s in reading.steps], 95)
    return None if p is None else 1e3 * p


def span_ms_per_unit(reading, names) -> float | None:
    """Milliseconds a unit spends in the spans `names`, the mean over the
    window's units; None if no unit has any of them."""
    if not any(n in s.spans for s in reading.steps for n in names):
        return None
    return 1e3 * sum(s.spans.get(n, 0.0) for s in reading.steps for n in names) \
        / len(reading.steps)


def span_ms_per_batch(reading, name) -> float | None:
    """Milliseconds per batch in the span `name` over the window."""
    batches = sum(s.batches for s in reading.steps)
    total = sum(s.spans.get(name, 0.0) for s in reading.steps)
    if not batches or name not in {k for s in reading.steps for k in s.spans}:
        return None
    return 1e3 * total / batches


def idle_share(reading) -> float | None:
    """Percent of the traced window in which the card ran nothing."""
    tr = reading.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def launches_per_unit(reading) -> float | None:
    """The host's launch calls (kernel and graph launches, copies, fills)
    per traced unit."""
    tr = reading.trace
    if tr is None or not tr.units:
        return None
    return tr.host_launch_calls / tr.units


def roofline(reading, least_seconds, kernels) -> float | None:
    """Percent: the least time the traced units' inputs need for the work
    (``least_seconds(samples, fs)`` of each unit) over the device time of
    the kernels whose names hold any of `kernels`."""
    tr = reading.trace
    if tr is None:
        return None
    device_s = tr.device_seconds(kernels)
    if device_s <= 0:
        return None
    return 100.0 * sum(least_seconds(s.samples, s.fs) for s in reading.traced) / device_s
