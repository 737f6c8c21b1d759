# Frozen copy of axctdprocessor_tpu_torch/models/convert.py at commit 05168f0, for the
# benchmark's plain reference: imports rewritten to this package.
"""Science conversion + quality control (host, float64).

A jax-free copy of axctdprocessor_tpu.models.convert: frame integers ->
temperature / conductivity / salinity / depth (reference parse.py:103-147,
297-301) and the two-stage QC filter (AXCTDprocessor.py:559-609).
Polynomials accumulate ``c[i] * x**i`` in ascending i (the reference's
order, not Horner).
"""

from __future__ import annotations

import numpy as np

from .seawater import sp_from_c_np


def polyval_ascending(x: np.ndarray, coeffs) -> np.ndarray:
    """sum_i coeffs[i] * x**i, accumulated in ascending order (parity)."""
    x = np.asarray(x, dtype=np.float64)
    out = np.zeros_like(x)
    for i, c in enumerate(coeffs):
        out = out + c * x**i
    return out


def frame_ints(frames_bits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(N, 32) frame bits -> (Tint, Cint): T bits 14-26, C bits 2-14."""
    w12 = 1 << np.arange(11, -1, -1, dtype=np.int64)
    tint = frames_bits[:, 14:26].astype(np.int64) @ w12
    cint = frames_bits[:, 2:14].astype(np.int64) @ w12
    return tint, cint


def ints_to_observations(tint, cint, times, temp_lut, tcoeff, ccoeff, zcoeff):
    """Integer fields + frame times -> (T, C, S, z) observations."""
    tint = np.asarray(tint, dtype=np.int64)
    cint = np.asarray(cint, dtype=np.int64)
    z = polyval_ascending(times, zcoeff)
    in_range = (tint >= 0) & (tint <= len(temp_lut) - 1)
    t_uncal = np.where(in_range, temp_lut[np.clip(tint, 0, len(temp_lut) - 1)], np.nan)
    c_uncal = cint * 60 / 4096
    temp = polyval_ascending(t_uncal, tcoeff)
    cond = polyval_ascending(c_uncal, ccoeff)
    psal = sp_from_c_np(cond, temp, z)
    return temp, cond, psal, z


def qc_bounds_mask(r400, r7500, temps, psals, cfg) -> np.ndarray:
    """In-profile bounds filter; NaN comparisons are False, so NaN T/S pass."""
    with np.errstate(invalid="ignore"):
        bad = (
            (r7500 < cfg.min_dr7500_inprof)
            | (r400 < cfg.min_r400_inprof)
            | (temps < cfg.tlims[0])
            | (temps > cfg.tlims[1])
            | (psals < cfg.slims[0])
            | (psals > cfg.slims[1])
        )
    return ~bad


def qc_spike_mask(temps, psals) -> np.ndarray:
    """Median/percentile spike filter: median +/- 10x the spread between the
    median and the 15th/85th percentile, for T and S independently."""
    thresh, pct_offset = 10, 35
    t_med = np.percentile(temps, 50)
    t_lo = t_med - thresh * (t_med - np.percentile(temps, 50 - pct_offset))
    t_hi = t_med + thresh * (np.percentile(temps, 50 + pct_offset) - t_med)
    s_med = np.percentile(psals, 50)
    s_lo = s_med - thresh * (s_med - np.percentile(psals, 50 - pct_offset))
    s_hi = s_med + thresh * (np.percentile(psals, 50 + pct_offset) - s_med)
    with np.errstate(invalid="ignore"):
        bad = (temps < t_lo) | (temps > t_hi) | (psals < s_lo) | (psals > s_hi)
    return ~bad
