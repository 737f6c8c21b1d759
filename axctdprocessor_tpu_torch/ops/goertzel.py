"""Windowed multi-tone DFT power probes (port of axctdprocessor_tpu.ops.goertzel).

* :func:`tone_matrix` — the (window, 2F) cos/sin table, built on the host
  in float64 (a copy of the JAX module's numpy function).
* :func:`framed_tone_power` — tone power of every strided window from the
  gathered (n_win, window) frame matrix: the straightforward form, kept to
  hold the tiled one against.
* :func:`framed_tone_power_tiled` — tone power of every strided window,
  as one small matmul per stride-aligned table segment plus shifted adds
  (no (n_win, window) frame matrix).
* :func:`tone_power_at` — tone power of short frames at arbitrary starts
  (the bit edges): a row gather of the frames, then one matmul.  The JAX
  version correlates at every sample and gathers the results, because TPU
  gathers pay per element; on the GPU the (n_starts, window) gather is
  small and the matmul stays out of cuDNN's TF32 convolutions.

Power is ``sqrt(re^2 + im^2)`` per tone.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def tone_matrix(window: int, freqs, fs: float, dtype=np.float64) -> np.ndarray:
    """(window, 2F) matrix of interleaved cos/sin columns per frequency."""
    k = 2 * np.pi * np.arange(window) / fs
    cols = []
    for f in freqs:
        cols.append(np.cos(k * f))
        cols.append(np.sin(k * f))
    return np.stack(cols, axis=1).astype(dtype)


def _magnitudes(proj: torch.Tensor) -> torch.Tensor:
    re, im = proj[..., 0::2], proj[..., 1::2]
    return torch.sqrt(re * re + im * im)


def framed_tone_power(x: torch.Tensor, window: int, stride: int,
                      trig: torch.Tensor) -> torch.Tensor:
    """Tone power of every length-`window` frame of a 1-D `x` at the given
    stride: (n_win, F), frames starting at 0 with start < len(x) - window
    (strict, reference AXCTDprocessor.py:357).  The frames are gathered
    into an (n_win, window) matrix and multiplied by the table once."""
    trig = torch.as_tensor(trig).to(dtype=x.dtype, device=x.device)
    n_win = max(math.ceil((x.shape[0] - window) / stride), 0)
    starts = torch.arange(n_win, device=x.device) * stride
    frames = x[starts[:, None] + torch.arange(window, device=x.device)[None, :]]
    return _magnitudes(frames @ trig)


def framed_tone_power_tiled(x: torch.Tensor, window: int, stride: int,
                            trig: torch.Tensor) -> torch.Tensor:
    """Tone power of every length-`window` frame at `stride`: (..., n_win, F).

    n_win = ceil((len(x) - window) / stride), over the last dimension of
    `x` (leading dimensions are rows of a batch).  The waveform is cut into
    stride-length tiles; window w is ``sum_j tiles[w + j] @ trig_j`` over
    the ceil(window/stride) zero-padded table segments.  The final 1-2
    windows may read the zero padding past the waveform.
    """
    trig = trig.to(x.dtype)
    *lead, n = x.shape
    n_win = max(math.ceil((n - window) / stride), 0)
    n_seg = math.ceil(window / stride)
    n_tiles = math.ceil(n / stride)
    tiles = torch.nn.functional.pad(x, (0, n_tiles * stride - n)).reshape(
        *lead, n_tiles, stride)
    proj = None
    for j in range(n_seg):
        seg = trig[j * stride: min((j + 1) * stride, window)]
        seg = torch.nn.functional.pad(seg, (0, 0, 0, stride - seg.shape[0]))
        p_j = tiles @ seg
        shifted = p_j[..., j: j + n_win, :]
        if shifted.shape[-2] < n_win:
            shifted = torch.nn.functional.pad(
                shifted, (0, 0, 0, n_win - shifted.shape[-2]))
        proj = shifted if proj is None else proj + shifted
    return _magnitudes(proj)


def tone_power_at(x: torch.Tensor, starts: torch.Tensor, window: int,
                  trig: torch.Tensor) -> torch.Tensor:
    """Tone power of frames beginning at arbitrary indices: (len(starts), F).

    Starts are clamped into the waveform (callers mask invalid entries).
    """
    trig = trig.to(x.dtype)
    starts = starts.to(torch.int64).clamp(0, x.shape[0] - window)
    offs = torch.arange(window, device=x.device)
    frames = x[starts[:, None] + offs[None, :]]
    return _magnitudes(frames @ trig)
