"""One reference decode: the frozen float64 parity engine over the same WAV
(or the same float32 samples) that the port was handed, and its report from
the frozen report writer.  Runs in a process of its own; imports nothing of
the port.

``variant="rounded"`` is the control: the same decode with one guarantee of
the configurations broken, that a row is its frame's conversion rounded
once, at the end: salinity is computed from the temperature and
conductivity already rounded to the report's two decimals.
``variant="float32"`` runs the science conversion (T, C, S, z) in float32:
it reads as the float64 decode at the report's precision.  Three faults are
planted in the decode's answer, in the port's place: ``"truncated"`` leaves
out the deepest quarter of the profile's rows, ``"frames_cut"`` the last
tenth of the synced frames with their rows, ``"late_start"`` reports the
7500 Hz profile start 0.2 s (five frames) late, ``"made_up"`` lists every
tenth row beside a frame that was never synced.

The result's rows come back with the frame each came from (``rows``), and
every frame the decode synced, before quality control: its T and C codes
and time (``frames``) and its hex (``hexframes``).  ``rows_unlike`` holds another decoder's rows against this
decoder's own conversion of their frames.
"""

from __future__ import annotations

import numpy as np

from . import convert, parity_engine, report
from .config import DecoderConfig
from .lut import load_temp_lut
from .seawater import sp_from_c_np
from .wavio import read_wav

LATE_START_S = 0.2
EPS = 1e-9


def echo_settings(cfg: DecoderConfig) -> dict:
    """The settings a report echoes (as the archive runner writes them)."""
    return {"minR400": cfg.min_r400, "mindR7500": cfg.min_dr7500,
            "deadfreq": cfg.dead_freq, "pointsperloop": 100000,
            "triggerrange": list(cfg.trigger_range)}


def _ints_to_observations_f32(tint, cint, times, temp_lut, tcoeff, ccoeff, zcoeff):
    """``convert.ints_to_observations`` with every array in float32."""
    f32 = np.float32

    def poly(x, coeffs):
        x = np.asarray(x, dtype=f32)
        out = np.zeros_like(x)
        for i, c in enumerate(coeffs):
            out = out + f32(c) * x ** i
        return out

    tint = np.asarray(tint, dtype=np.int64)
    cint = np.asarray(cint, dtype=np.int64)
    z = poly(times, zcoeff)
    lut = np.asarray(temp_lut, dtype=f32)
    in_range = (tint >= 0) & (tint <= len(lut) - 1)
    t_uncal = np.where(in_range, lut[np.clip(tint, 0, len(lut) - 1)], f32(np.nan))
    c_uncal = (cint * 60 / 4096).astype(f32)
    temp = poly(t_uncal, tcoeff)
    cond = poly(c_uncal, ccoeff)
    psal = sp_from_c_np(cond, temp, z).astype(f32)
    return (temp.astype(np.float64), cond.astype(np.float64), psal.astype(np.float64),
            z.astype(np.float64))


def _ints_to_observations_rounded(tint, cint, times, temp_lut, tcoeff, ccoeff, zcoeff):
    """``convert.ints_to_observations`` with salinity from T and C rounded to
    two decimals first."""
    temp, cond, _, z = convert.ints_to_observations(tint, cint, times, temp_lut, tcoeff,
                                                    ccoeff, zcoeff)
    return temp, cond, sp_from_c_np(np.round(cond, 2), np.round(temp, 2), z), z


def _conversion(observations, seen: list):
    """The conversion module as a decoder sees it, with `observations` as
    its conversion; every frame it converts, before quality control, is
    recorded in `seen` as (T code, C code, time after the profile start)."""

    def record(tint, cint, times, *args):
        seen.append((np.asarray(tint), np.asarray(cint), np.asarray(times)))
        return observations(tint, cint, times, *args)

    return type("Conversion", (), {
        "ints_to_observations": staticmethod(record),
        "frame_ints": staticmethod(convert.frame_ints),
        "qc_bounds_mask": staticmethod(convert.qc_bounds_mask),
        "qc_spike_mask": staticmethod(convert.qc_spike_mask)})


VARIANTS = {"float32": _ints_to_observations_f32, "rounded": _ints_to_observations_rounded}


def _plant(res, fault: str | None):
    """A fault planted in the decode's answer (the reference in the port's place)."""
    def cut(names, keep):
        for name in names:
            values = list(getattr(res, name))
            setattr(res, name, values[:int(len(values) * keep)])

    rows = ("time", "depth", "temperature", "conductivity", "salinity", "r400", "r7500",
            "hexframes_qc")
    if fault == "truncated":      # the deepest quarter of the profile's rows lost
        cut(rows, 0.75)
    elif fault == "frames_cut":   # the last tenth of the frames lost, with their rows
        cut(rows + ("hexframes",), 0.9)
    elif fault == "late_start":   # the profile start reported five frames late
        res.profstartind += int(round(LATE_START_S * res.fs))
    elif fault == "made_up":      # every tenth row beside a frame never synced (T code +-64)
        res.hexframes_qc = [f"{int(h, 16) ^ (64 << 6):08x}" if k % 10 == 0 else h
                            for k, h in enumerate(res.hexframes_qc)]
    return res


def decode(job: dict) -> dict:
    """``job``: ``path`` (an int16 WAV), ``name`` (the file name the report
    prints), ``samples`` (``"float32"``: decode the conditioned samples as
    the float32 blocks a live receiver feeds), ``n_samples`` (decode only
    the first n: what a live receiver had been fed), ``variant`` and
    ``keep_result`` (return the decode result too)."""
    pcm, fs = read_wav(job["path"])
    if job.get("samples") == "float32":
        pcm = pcm.astype(np.float32).astype(np.float64)
    if job.get("n_samples"):
        pcm = pcm[:int(job["n_samples"])]
    cfg = DecoderConfig()
    dec = parity_engine.ParityDecoder(pcm, fs, config=cfg)
    seen: list = []
    observations = VARIANTS.get(job.get("variant"), convert.ints_to_observations)
    saved, parity_engine.convert = parity_engine.convert, _conversion(observations, seen)
    try:
        res = _plant(dec.run(), job.get("variant"))
    finally:
        parity_engine.convert = saved
    text = report.format_report(res, job["name"], [0, -1], echo_settings(cfg), cfg)
    rows = [(h, float(t), float(z), float(tc), float(c), float(sal)) for h, t, z, tc, c, sal in
            zip(res.hexframes_qc, res.time, res.depth, res.temperature, res.conductivity,
                res.salinity)]
    frames = [(int(tc), int(c), float(t) + res.firstpointtime)
              for tints, cints, times in seen for tc, c, t in zip(tints, cints, times)]
    out = {"text": text, "rows": rows, "frames": frames, "hexframes": list(res.hexframes),
           "live": {k: list(map(float, v)) for k, v in dec.live_coeffs.items()}}
    if job.get("keep_result"):  # the reference in the port's place: its answer
        out["result"] = res
    return out


def report_of(result, name: str, echo: dict | None = None) -> str:
    """Another decoder's result as this package's writer formats it, with
    the settings `echo` (default: this package's) in its settings lines."""
    cfg = DecoderConfig()
    return report.format_report(result, name, [0, -1], echo or echo_settings(cfg), cfg)


def _f2(values) -> np.ndarray:
    return np.array([f"{v:.2f}" for v in values])


def rows_unlike(rows: list[tuple], tone_start_s: float, live: dict) -> int:
    """Rows ``(hex, time, depth, T, C, S)`` of another decoder that are not
    this decoder's conversion (``convert.ints_to_observations``, the decode's
    own) of their frame at their time after `tone_start_s`, with the
    coefficients `live`, at the report's two decimals.  A row's time is
    itself rounded to two decimals, so its depth may lie anywhere between
    the depths at the ends of that rounding, and its salinity anywhere
    between the salinities at the ends of its depth's rounding."""
    if not rows:
        return 0
    words = np.array([int(r[0], 16) for r in rows], dtype=np.int64)
    tint, cint = (words >> 6) & 0xFFF, (words >> 18) & 0xFFF
    t_row, z_row, temp_row, cond_row, sal_row = (np.array([r[i] for r in rows])
                                                 for i in range(1, 6))
    t0 = t_row - tone_start_s
    lut = load_temp_lut()
    obs = {dt: convert.ints_to_observations(tint, cint, t0 + dt, lut, live["tcoeff"],
                                            live["ccoeff"], live["zcoeff"])
           for dt in (-0.005, 0.005)}
    temp, cond = obs[-0.005][0], obs[-0.005][1]
    ok = (_f2(np.round(temp, 2)) == _f2(temp_row)) & (_f2(np.round(cond, 2)) == _f2(cond_row))
    z_lo, z_hi = (np.round(obs[dt][3], 2) for dt in (-0.005, 0.005))
    ok &= (np.minimum(z_lo, z_hi) - EPS <= z_row) & (z_row <= np.maximum(z_lo, z_hi) + EPS)
    with np.errstate(invalid="ignore"):
        s_a = np.round(sp_from_c_np(cond, temp, z_row - 0.005), 2)
        s_b = np.round(sp_from_c_np(cond, temp, z_row + 0.005), 2)
        in_range = (np.minimum(s_a, s_b) - EPS <= sal_row) & (sal_row <= np.maximum(s_a, s_b) + EPS)
    ok &= in_range | (np.isnan(sal_row) & np.isnan(s_a) & np.isnan(s_b))
    return int(np.count_nonzero(~ok))
