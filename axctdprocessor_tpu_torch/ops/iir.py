"""Filter design and the causal box smoother (port of axctdprocessor_tpu.ops.iir).

The design functions are copies of the JAX module's scipy code: the
coefficients are designed on the host in float64 and cross to the device
as small tables.  The sequential and associative-scan ``sosfilt`` forms are
not ported: every decode path filters in the FFT domain
(``models.engine.sos_response_on_device``).
"""

from __future__ import annotations

import numpy as np
import torch


def design_sos(fs: float, use_bandpass: bool = False) -> np.ndarray:
    """Order-6 Butterworth SOS (100-1200 Hz bandpass or 1200 Hz lowpass)."""
    from scipy import signal

    if use_bandpass:
        return signal.butter(6, [100, 1200], btype="bandpass", fs=fs, output="sos")
    return signal.butter(6, 1200, btype="lowpass", fs=fs, output="sos")


def design_decim_sos(q: int = 2) -> np.ndarray:
    """Anti-alias filter of the reference's decimator, ``cheby1(8, 0.05,
    0.8/q)`` as SOS (scipy.signal.decimate's IIR default), applied
    zero-phase in the FFT domain by the device decimator."""
    from scipy import signal

    return signal.cheby1(8, 0.05, 0.8 / q, output="sos")


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def boxsmooth_lag(x: torch.Tensor, window: int) -> torch.Tensor:
    """Causal (lagging) box mean over the trailing ``window + 1`` samples of
    the last dimension, with the count shortened near the start.

    Summed tap by tap, oldest first, instead of the JAX version's prefix
    sum: a float32 prefix sum over the ~15,000 windows of a 600 s drop
    keeps only ~1e-4 relative precision in a difference of two of its
    entries, while six adds stay at float32 rounding.
    """
    n = x.shape[-1]
    total = torch.zeros_like(x)
    for t in range(window, -1, -1):
        if t < n:
            total[..., t:] += x[..., : n - t]
    count = torch.clamp(torch.arange(n, device=x.device) + 1, max=window + 1)
    return total / count.to(x.dtype)
