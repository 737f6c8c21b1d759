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
  (the bit edges), one row or a batch of rows: a row gather of the frames,
  then one matmul.  The JAX version correlates at every sample and gathers
  the results, because TPU gathers pay per element.  It is the plain
  version of :func:`probe_at`.
* :func:`probe_at` — the dispatcher of the per-bit probe: on a CPU tensor
  :func:`tone_power_at`; on a CUDA tensor the hand-written sm_90a kernel
  (``ops/kernels/probe.cu``: a block for each run of consecutive probes of
  a row, over the run's span staged in shared memory, the run and the span
  chosen from the window: ``extension().probe_geometry(window)``; no
  (n_starts, window) gather, no index tensor), adding one to
  ``probe_at.launches`` per launch.  A build or launch failure raises;
  nothing falls back.

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
    """Tone power of frames beginning at arbitrary indices: (K, F) for one
    row `x` (L,) and `starts` (K,), or (B, K, F) for rows (B, L) and starts
    (B, K), each row's starts into its own row.

    Starts are clamped into [0, L - window] (callers mask invalid entries).
    """
    trig = trig.to(x.dtype)
    rows = x.reshape(-1, x.shape[-1])
    st = starts.to(torch.int64).clamp(0, x.shape[-1] - window).reshape(rows.shape[0], -1)
    offs = torch.arange(window, device=x.device)
    frames = rows[torch.arange(rows.shape[0], device=x.device)[:, None, None],
                  st[..., None] + offs]
    return _magnitudes(frames @ trig).reshape(starts.shape + (trig.shape[1] // 2,))


def probe_at(x: torch.Tensor, starts: torch.Tensor, window: int,
             trig: torch.Tensor) -> torch.Tensor:
    """Mark and space magnitudes of the `window`-sample frames of `x` at
    `starts`: :func:`tone_power_at`'s function, (K, 2) or (B, K, 2), with
    the (window, 4) table.  The plain version for a CPU tensor; the CUDA
    kernel for a CUDA tensor (float32 `x` with its last dimension
    contiguous; raises on anything else).  A call with no start launches
    nothing."""
    if x.device.type == "cpu":
        return tone_power_at(x, starts, window, trig)
    if x.device.type != "cuda":
        raise ValueError(f"probe_at: unsupported device {x.device}")
    if trig.shape != (window, 4):
        raise ValueError(f"probe_at: the table must be ({window}, 4), got {tuple(trig.shape)}")
    from .kernels import extension

    out = extension().probe_at(x, starts.to(torch.int64).contiguous(),
                               trig.to(torch.float32).contiguous())
    if starts.numel():  # no start, no launch
        probe_at.launches += 1
    return out


probe_at.launches = 0
