"""IIR filtering (SOS cascades) and the causal box smoother (port of
axctdprocessor_tpu.ops.iir).

The design functions are copies of the JAX module's scipy code: the
coefficients are designed on the host in float64 and cross to the device
as small tables.  Every decode path filters in the FFT domain
(``models.engine.sos_response_on_device`` / ``apply_response``), and
:func:`sosfilt_fft` is that same filter as a function of (sos, x).  Two
time-domain forms of the cascade stand beside it for cross-validation:

* :func:`sosfilt_scan` — sequential, scipy's update order, sample by sample;
* :func:`sosfilt` — parallel: each biquad's state recurrence
  ``s[n] = A s[n-1] + B x[n]`` (A is 2x2) as an inclusive scan over the
  composition of affine maps, evaluated in log2(N) Hillis-Steele steps of
  whole-tensor ops.

torch is imported inside the functions that use it: the host parity engine
imports this module for :func:`design_sos` alone.
"""

from __future__ import annotations

import numpy as np


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


def _affine_combine(left, right):
    """Compose 2x2 affine maps held as six flat tensors (right after
    left): entries 11, 12, 21, 22 of the matrix, then the offset's two."""
    l11, l12, l21, l22, lc1, lc2 = left
    r11, r12, r21, r22, rc1, rc2 = right
    return (
        r11 * l11 + r12 * l21,
        r11 * l12 + r12 * l22,
        r21 * l11 + r22 * l21,
        r21 * l12 + r22 * l22,
        r11 * lc1 + r12 * lc2 + rc1,
        r21 * lc1 + r22 * lc2 + rc2,
    )


def _biquad_parallel(x, coeffs):
    """One DFII-t biquad via an inclusive scan over its state recurrence.

    State s = (z1, z2):
      y[n]  = b0 x[n] + z1[n-1]
      z1[n] = (b1 - a1 b0) x[n] - a1 z1[n-1] + z2[n-1]
      z2[n] = (b2 - a2 b0) x[n] - a2 z1[n-1]
    i.e. s[n] = A s[n-1] + B x[n] with constant A = [[-a1, 1], [-a2, 0]].
    Step d of the scan composes element n with element n - d (elements
    before d stay), for d = 1, 2, 4, ...: log2(N) passes over six flat
    tensors, plain tensor ops throughout.
    """
    import torch

    b0, b1, b2, a1, a2 = coeffs
    n = x.shape[0]
    ones = torch.ones_like(x)
    elems = (-a1 * ones, ones, -a2 * ones, torch.zeros_like(x),
             (b1 - a1 * b0) * x, (b2 - a2 * b0) * x)
    d = 1
    while d < n:
        combined = _affine_combine(tuple(e[:-d] for e in elems),
                                   tuple(e[d:] for e in elems))
        elems = tuple(torch.cat([e[:d], c]) for e, c in zip(elems, combined))
        d *= 2
    z1 = elems[4]
    z1_prev = torch.cat([torch.zeros_like(z1[:1]), z1[:-1]])
    return b0 * x + z1_prev


def sosfilt(sos, x):
    """Parallel SOS cascade (zero initial state) of a 1-D tensor, in its
    dtype and on its device.  `sos` is host coefficients or an
    (n_sections, 6) tensor."""
    import torch

    sos = torch.as_tensor(sos).to(dtype=x.dtype, device=x.device)
    y = x
    for sec in range(sos.shape[0]):
        b0, b1, b2, _, a1, a2 = (sos[sec, j] for j in range(6))
        y = _biquad_parallel(y, (b0, b1, b2, a1, a2))
    return y


def sos_freq_response(sos, nfft: int) -> np.ndarray:
    """Exact frequency response of the SOS cascade at rfft bin frequencies.

    Computed host-side in float64: H[k] = prod_s (b0 + b1 z + b2 z^2) /
    (1 + a1 z + a2 z^2) with z = exp(-2i pi k / nfft).
    """
    sos = np.asarray(sos, dtype=np.float64)
    k = np.arange(nfft // 2 + 1)
    z = np.exp(-2j * np.pi * k / nfft)
    h = np.ones_like(z)
    for sec in range(sos.shape[0]):
        b0, b1, b2, _, a1, a2 = sos[sec]
        h *= (b0 + b1 * z + b2 * z * z) / (1.0 + a1 * z + a2 * z * z)
    return h


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def sosfilt_fft(sos, x, pad: int = 4096):
    """SOS cascade applied in the frequency domain (the long-waveform
    path): the decode's own FFT filter (``engine.fft_filter``: the response
    evaluated on the device at the rfft bins, one rfft, a pointwise
    multiply, one irfft) over ``next_pow2(n + pad)`` points, in the dtype
    and on the device of `x`.  Zero-padding by `pad` (longer than the
    filter's impulse response) gives linear-convolution semantics at the
    head; steady state matches the exact IIR to fp tolerance, and the
    start-up transient differs only within the first ~IR-length samples."""
    import torch

    from ..models.engine import fft_filter

    n = x.shape[0]
    sos = torch.as_tensor(sos).to(dtype=x.dtype, device=x.device)
    return fft_filter(x, sos, next_pow2(n + pad))[:n].to(x.dtype)


def sosfilt_scan(sos, x):
    """Sequential SOS cascade with scipy's exact update order (validation):
    a Python loop over the samples in the dtype of `x`, on the host."""
    import torch

    c = torch.as_tensor(sos).to(dtype=x.dtype, device="cpu").tolist()
    state = [[0.0, 0.0] for _ in c]
    out = []
    for val in x.detach().cpu().tolist():
        for (b0, b1, b2, _, a1, a2), st in zip(c, state):
            y = b0 * val + st[0]
            st[0] = b1 * val + st[1] - a1 * y
            st[1] = b2 * val - a2 * y
            val = y
        out.append(val)
    return torch.tensor(out, dtype=x.dtype, device=x.device)


def boxsmooth_lag(x, window: int):
    """Causal (lagging) box mean over the trailing ``window + 1`` samples of
    the last dimension, with the count shortened near the start.

    Summed tap by tap, oldest first, instead of the JAX version's prefix
    sum: a float32 prefix sum over the ~15,000 windows of a 600 s drop
    keeps only ~1e-4 relative precision in a difference of two of its
    entries, while six adds stay at float32 rounding.
    """
    import torch

    n = x.shape[-1]
    total = torch.zeros_like(x)
    for t in range(window, -1, -1):
        if t < n:
            total[..., t:] += x[..., : n - t]
    count = torch.clamp(torch.arange(n, device=x.device) + 1, max=window + 1)
    return total / count.to(x.dtype)
