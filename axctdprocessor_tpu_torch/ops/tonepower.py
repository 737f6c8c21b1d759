"""Smoothed tone-power ratios: the port of the Pallas kernel
axctdprocessor_tpu/ops/pallas/tonepower.py (``fused_tone_ratios``).

* :func:`tone_ratios_reference` — the plain PyTorch version: tiled tone
  powers, the causal 6-window box mean, then ``log10`` ratios.
* :func:`tone_ratios` — the dispatcher: on a CPU tensor it returns the plain
  version; on a CUDA tensor it launches the hand-written sm_90a kernel
  (``ops/kernels/tone_ratios.cu``) and adds one to ``tone_ratios.launches``
  (a call with no window launches nothing), and one to
  ``tone_ratios.streamed_launches`` when the instance it launched streamed
  the table through the copy ring (a window whose table does not fit in
  shared memory beside the ring: the batch and archive paths' 88.2 and 96
  kHz rows; the same bits).  On a grid under one wave of the card's SMs
  (one drop up to about 300 s, a few rows) it takes a smaller block shape
  (the same bits).  The extension chooses by size before the launch
  (``extension().tone_plan``) and names the instance it launched
  (``extension().tone_last_launch``).  A build or launch failure raises;
  nothing falls back.
* :func:`tone_powers` — the raw (..., n_win, 3) powers of the same windows,
  no box mean and no log: on a CPU tensor the plain tiled version
  (``goertzel.framed_tone_power_tiled``), on a CUDA tensor the same kernel's
  powers-only variant (``tone_powers.launches``; ``streamed_launches`` and
  the block shape as for the ratios).  The segmented and
  time-sharded paths take it and smooth the gathered series themselves
  (:func:`ratios_from_powers`).

Both take one signal ``x`` of shape (n,) or a batch (B, n), and the
(window, 6) ``tone_matrix`` for [400 Hz, 7500 Hz, dead] with interleaved
cos/sin columns, and return (r400, r7500), each of shape (n_win,) or
(B, n_win) with ``n_win = ceil((n - window) / stride)``.  A batch is one
kernel launch, as the Pallas kernel under ``vmap`` is one ``pallas_call``
with a batch grid axis.  A window whose dead-tone mean is 0 (the
zero-padded tail of a bucket) gives NaN or inf: no epsilon is added.
"""

from __future__ import annotations

import math

import torch

from . import goertzel, iir

SMOOTH = 5  # trailing windows in the box mean (SMOOTH + 1 taps)


def n_windows(n: int, window: int, stride: int) -> int:
    return max(math.ceil((n - window) / stride), 0)


def ratios_from_powers(powers: torch.Tensor):
    """(r400, r7500) from raw (..., n_win, 3) tone powers: the causal box
    mean of each tone over the windows, then the log10 ratios to the dead
    tone.  The segmented decode smooths its per-segment powers with it."""
    p400, p7500, pdead = (iir.boxsmooth_lag(powers[..., c], SMOOTH)
                          for c in range(3))
    return torch.log10(p400 / pdead), torch.log10(p7500 / pdead)


def tone_ratios_reference(x: torch.Tensor, tm: torch.Tensor, window: int,
                          stride: int):
    """Plain version: (r400, r7500) from tiled powers + box mean + log10."""
    return ratios_from_powers(goertzel.framed_tone_power_tiled(x, window, stride, tm))


def tone_ratios(x: torch.Tensor, tm: torch.Tensor, window: int, stride: int):
    """(r400, r7500): the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor.  The kernel takes contiguous float32 ``x`` and ``tm``
    on one device and raises on anything else."""
    if x.device.type == "cpu":
        return tone_ratios_reference(x, tm, window, stride)
    if x.device.type != "cuda":
        raise ValueError(f"tone_ratios: unsupported device {x.device}")
    from .kernels import extension

    n_win = n_windows(x.shape[-1], window, stride)
    r400, r7500, streamed = extension().tone_ratios(x, tm, window, stride, n_win)
    if r400.numel():  # no window, no launch
        tone_ratios.launches += 1
        tone_ratios.streamed_launches += streamed
    return r400, r7500


tone_ratios.launches = 0
tone_ratios.streamed_launches = 0


def tone_powers_reference(x: torch.Tensor, tm: torch.Tensor, window: int, stride: int):
    """Plain version of :func:`tone_powers`: the tiled tone powers."""
    return goertzel.framed_tone_power_tiled(x, window, stride, tm)


def tone_powers(x: torch.Tensor, tm: torch.Tensor, window: int, stride: int,
                shape: tuple = (0, 0)):
    """Raw powers (n_win, 3) of one signal (n,), or (B, n_win, 3) of rows
    (B, n): the CUDA kernel for a CUDA tensor (float32, last dimension
    contiguous; rows may be a view of a wider tensor), the plain version for
    a CPU tensor.  Each row's windows are the 1-D call's bit for bit.
    ``shape`` (0, 0) lets the launcher choose the kernel's block shape (the
    standard one, or a smaller one for a grid under one wave of the card's
    SMs); one of the extension's ``tone_powers_shapes()`` forces a shape, to
    compare with the launcher's choice: every shape gives the same bits."""
    if x.device.type == "cpu":
        return tone_powers_reference(x, tm, window, stride)
    if x.device.type != "cuda":
        raise ValueError(f"tone_powers: unsupported device {x.device}")
    from .kernels import extension

    n_win = n_windows(x.shape[-1], window, stride)
    out, streamed = extension().tone_powers(x, tm, window, stride, n_win, *shape)
    if out.numel():  # no window, no launch
        tone_powers.launches += 1
        tone_powers.streamed_launches += streamed
    return out


tone_powers.launches = 0
tone_powers.streamed_launches = 0
