"""The comparison that decides ``correct``: each answer the port gave (a
report with the decode result it was written from, or for a live stream its
result, in the report's format) against the frozen float64 reference's
decode of the same input (``reference/job.py``).

Numbers per answer, each held to the cell's limit (``cells/<workload>.json``):

* ``header_wrong``: header lines of the report (rate, length, probe code,
  maximum depth, serial, the three conversion equations) that differ from
  the reference's;
* ``trigger_gap_s``: the larger distance, in seconds, between the port's and
  the reference's 400 Hz pulse start and 7500 Hz profile start;
* ``report_wrong``: 1 where the report is not, byte for byte, its result as
  the reference's writer formats it (every header line, every row's every
  column);
* ``rows_wrong``: profile rows of the result that are not the reference's
  own conversion of their frame at their time, at the report's two
  decimals (``job.rows_unlike``);
* ``frames_missing``: the share of the frames the reference synced, before
  quality control, that the port's frames do not hold in the same order
  (``hexframes``: the decoders sync the same frames);
* ``rows_missing``: the share of the reference's profile rows whose frame
  the result does not list near the same time: rows the reference keeps and
  the port lost;
* ``rows_unknown``: the share of the result's profile rows, up to the
  reference's last frame, whose frame is not among the frames the reference
  synced, before its quality control, near the same time: frames the port
  made up or altered;
* ``streamed_wrong``: rows a live display received from ``latest_rows()``
  that are not the finished result's rows in the same places;
* ``reports_unstable``: reports of an input that differ from the report of
  that input whose result was checked row by row (a drop decoded again
  gives the same report, byte for byte);
* ``reports_missing``: outputs that were due and did not come, or that
  cannot be read as a report.

The two decoders' frame times differ by design (the reference's chunked
grid drifts against the port's by up to some tenths of a second over a
drop), so rows are matched by their frames within ``TOL_S``, and a row's
depth and salinity are held to the reference's conversion at the port's own
time and trigger, the trigger to the reference's.
"""

from __future__ import annotations

import bisect

from ..reference import job

HEADER_KEYS = ("Sampling frequency (fs)", "Audio file length", "Probe Code",
               "Maximum Depth (m)", "Probe Serial", "Depth", "Temperature", "Conductivity")
TOL_S = 1.0  # the two decoders' times of one frame lie this far apart at most
REACH = 25   # frames looked past the last match for the next (one second)
ROW_KEYS = ("time", "depth", "temperature", "conductivity", "salinity")


def parse_report(text: str) -> dict:
    """Header fields by name and the profile rows of a report."""
    fields, rows, in_rows = {}, [], False
    for line in text.splitlines():
        if in_rows:
            parts = [p.strip() for p in line.split(",")]
            if len(parts) >= 6:
                rows.append(parts[:6])
            continue
        if line.startswith("Time (s), Hex Frame"):
            in_rows = True
            continue
        key, sep, val = line.partition(": ")
        if sep and key not in fields:
            fields[key] = val
    return {"fields": fields, "rows": rows}


def _seconds(fields: dict, key: str) -> float:
    return float(fields[key].split()[0])


def aligned_rows(result) -> list[tuple]:
    """A decode result's profile rows with the frame each row came from:
    (hex, time, depth, T, C, S), from its ``hexframes_qc`` and row lists."""
    return [(h, float(t), float(z), float(tc), float(c), float(sal)) for h, t, z, tc, c, sal in
            zip(result.hexframes_qc, result.time, result.depth, result.temperature,
                result.conductivity, result.salinity)]


def _near(times: list, t: float, tol: float) -> list:
    """Indexes of the sorted `times` within `tol` of `t`, nearest first."""
    lo, hi = bisect.bisect_left(times, t - tol), bisect.bisect_right(times, t + tol)
    return sorted(range(lo, hi), key=lambda i: abs(times[i] - t))


def _by_key(pairs) -> dict:
    out: dict = {}
    for key, t in pairs:
        out.setdefault(key, []).append(t)
    return {k: sorted(v) for k, v in out.items()}


def rows_missing(rows: list[tuple], ref_rows: list[tuple], tol: float = TOL_S) -> float:
    """The share of the reference's rows with no row of the port of the same
    frame (hex) within `tol` seconds, each row of the port standing for one
    (taken in time order, the earliest free one: as many as can be paired)."""
    if not ref_rows:
        return 0.0
    have = _by_key((r[0], r[1]) for r in rows)
    nxt: dict = {}  # hex -> the first of its port rows not yet paired or passed
    missing = 0
    for h, t, *_ in sorted(ref_rows, key=lambda r: r[1]):
        times = have.get(h, [])
        i = max(nxt.get(h, 0), bisect.bisect_left(times, t - tol))
        if i < len(times) and times[i] <= t + tol:
            nxt[h] = i + 1
        else:
            missing += 1
    return missing / len(ref_rows)


def frames_missing(frames: list[str], ref_frames: list[str], reach: int = REACH) -> float:
    """The share of the frames the reference synced, before its quality
    control, that the port's frames (``hexframes``, before its quality
    control) do not hold in the same order: the first equal frame at most
    `reach` frames past the last one matched."""
    if not ref_frames:
        return 0.0
    at, missing = 0, 0
    for h in ref_frames:
        try:
            at = frames.index(h, at, at + reach) + 1
        except ValueError:
            missing += 1
    return missing / len(ref_frames)


def rows_unknown(rows: list[tuple], ref: dict, tol: float = TOL_S) -> float:
    """The share of the port's rows, up to the reference's last synced frame,
    whose frame the reference never synced: no frame of the same T and C
    codes within `tol` seconds, or a hex that is none of the reference's
    frames."""
    if not ref["frames"]:
        return 0.0
    codes = _by_key(((tc, c), t) for tc, c, t in ref["frames"])
    hexes = set(ref["hexframes"])
    last = max(t for _, _, t in ref["frames"])
    seen = unknown = 0
    for h, t, *_ in rows:
        if t > last:
            continue
        word = int(h, 16)
        key = ((word >> 6) & 0xFFF, (word >> 18) & 0xFFF)
        seen += 1
        unknown += h not in hexes or not _near(codes.get(key, []), t, tol)
    return unknown / seen if seen else 0.0


def streamed_wrong(streamed: list[dict], result) -> int:
    """Rows received live that are not the finished result's rows in the
    same places (compared as the report prints them)."""
    final = [tuple(f"{v:.2f}" for v in vals) for vals in
             zip(*(getattr(result, k) for k in ROW_KEYS))]
    got = [tuple(f"{r[k]:.2f}" for k in ROW_KEYS) for r in streamed]
    return sum(i >= len(final) or g != final[i] for i, g in enumerate(got))


def compare(port_text: str | None, result, ref: dict, name: str | None = None,
            echo: dict | None = None) -> dict:
    """The numbers of one report, and of the decode result it was written
    from (None: no row check; `name` is the file name the report prints,
    `echo` the settings it echoes), against the reference's decode `ref`
    (``reference.job.decode``'s)."""
    if port_text is None:
        return {"reports_missing": 1}
    try:
        port = parse_report(port_text)
        tone = _seconds(port["fields"], "7500 Hz tone start")
        pulse = _seconds(port["fields"], "400 Hz pulse start")
    except (KeyError, ValueError, IndexError):
        return {"reports_missing": 1}
    rf = parse_report(ref["text"])["fields"]
    header = sum(port["fields"].get(k) != rf.get(k) for k in HEADER_KEYS)
    gap = max(abs(pulse - _seconds(rf, "400 Hz pulse start")),
              abs(tone - _seconds(rf, "7500 Hz tone start")))
    out = {"header_wrong": header, "trigger_gap_s": gap, "reports_missing": 0,
           "rows": len(port["rows"])}
    if result is not None:
        rows = aligned_rows(result)
        out["report_wrong"] = int(port_text != job.report_of(result, name, echo))
        out["rows_wrong"] = job.rows_unlike(rows, tone, ref["live"])
        out["frames_missing"] = frames_missing(list(result.hexframes), ref["hexframes"])
        out["rows_missing"] = rows_missing(rows, ref["rows"])
        out["rows_unknown"] = rows_unknown(rows, ref)
    return out


SUMMED = ("header_wrong", "report_wrong", "rows_wrong", "streamed_wrong", "reports_missing",
          "reports_unstable")


def verdict(numbers: list[dict], limits: dict) -> tuple[bool, dict, int]:
    """(correct, {name: {"value", "limit"}}, outputs failed): counts summed
    over the outputs, gaps and shares at their worst."""
    out = {}
    for name, limit in limits.items():
        vals = [n[name] for n in numbers if name in n]
        value = (sum(vals) if name in SUMMED else max(vals)) if vals else 0
        out[name] = {"value": value, "limit": limit}
    failed = sum(any(n.get(k, 0) > lim for k, lim in limits.items()) for n in numbers)
    ok = bool(numbers) and all(v["value"] <= v["limit"] for v in out.values())
    return ok, out, failed
