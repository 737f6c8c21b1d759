"""Whole-waveform fused AXCTD decoder in PyTorch (port of
axctdprocessor_tpu.models.tpu_engine).

One decode is one forward pass of :class:`FusedDecoder` on one device and
one device-to-host transfer of a packed int32 vector:

* **stage 1** — tone-power ratios on the uniform whole-file window grid
  (the hand-written CUDA kernel on a GPU, ``ops.tonepower``), the order-6
  Butterworth applied in the FFT domain, zero crossings, the pointer-
  doubling bit-edge chain and per-bit mark/space powers;
* **trigger** — pulse detection, 7500 Hz baseline and the profile trigger,
  with integer window thresholds precomputed on the host;
* **stage 1.5** — bit-decision scale calibration from the header-1
  confidence histogram, bit calls, the two header capture windows;
* **headers** — trim + frame sync on the device (``ops.header_device``);
* **stage 2** — profile frame sync over every bit offset (frame words,
  CRC, accept mask, jump chain) and the lean per-frame outputs.

The host finishes: exact float64 metadata from the header frames, science
conversion and QC (``finish_result``).  The packed layout is the JAX
engine's, element for element, so the two are compared directly.

``decode_waveform`` runs the forward through the cached program of its
static shape (``fused_program``, ``models/programs.py``; the JAX engine's
``_fused`` under ``jax.jit`` with its host tables cached): the module and its
tables are made and uploaded once per shape, and on a GPU the forward is
captured as a CUDA graph at the shape's second decode and replayed after.

Inside the program nothing reads a device value on the host: the
dynamic indices of the JAX code (``argmax``, ``roll`` by a traced amount,
``dynamic_slice``) are gathers with index tensors here, and a scalar index
goes through ``torch.take`` (indexing with a 0-dim tensor calls
``.item()``).  Nothing copies a host value in either: constants are made on
the device (``torch.full``), because ``torch.tensor(..., device="cuda")``
is a blocking copy that waits for the device's queue, and host arrays go
up through pinned memory without blocking (``to_device``).

The demodulation front end (filter, crossings, per-bit probes) is written
once here and shared with the segmented engine (``models/segmented.py``).

Deliberate deviations from the reference's chunked semantics are the JAX
engine's (uniform power grid, whole-waveform filtering, true bit-edge
timing); see that module.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch import nn

from ..ops import chain as chain_ops
from ..ops import crc as crc_ops
from ..ops import goertzel, iir, tonepower
from ..ops import header_device as hdr_ops
from ..ops import wire as wire_ops
from ..utils import profiling
from ..utils.config import DecoderConfig, resolve_settings
from ..utils.lut import load_temp_lut
from . import frames as frames_host
from . import metadata as md
from . import programs
from .result import DecodeResult


# ---------------------------------------------------------------------------
# static sizing
# ---------------------------------------------------------------------------

def probe_window(cfg: DecoderConfig, fs: float) -> int:
    """Samples in the per-bit probe window (``npcm``) at decode rate `fs`."""
    return int(np.round(fs / cfg.bitrate * (1 - cfg.phase_error / 100))) - 2 * cfg.bit_inset


@dataclasses.dataclass(frozen=True)
class EngineDims:
    """Static shape parameters of one decode."""

    n: int              # waveform length
    n_power: int        # power window length (fs/10)
    d_pcm: int          # power window stride (fs/25)
    n_win: int
    npcm: int           # per-bit probe window
    max_crossings: int
    max_edges: int
    max_frames: int

    @classmethod
    def for_waveform(cls, n: int, fs: float, bitrate: float, npcm: int) -> "EngineDims":
        n_power = int(fs / 10)
        d_pcm = int(round(fs / 25))
        n_win = max(int(math.ceil((n - n_power) / d_pcm)), 1)
        max_edges = int(n * bitrate / fs * 1.25) + 64
        max_crossings = max(
            int(n / fs * chain_ops.CROSSINGS_PER_SECOND) + 1024, 4096)
        return cls(
            n=n, n_power=n_power, d_pcm=d_pcm, n_win=n_win, npcm=npcm,
            max_crossings=max_crossings,
            max_edges=max_edges,
            max_frames=max_edges // 32 + 8,
        )


def _f32_recip(d: float) -> float:
    """The float32 reciprocal of `d`: XLA turns ``x / const`` into
    ``x * (1/const)``, and the port rounds as the reference does."""
    return float(np.float32(1.0) / np.float32(d))


# ---------------------------------------------------------------------------
# stage 1: powers + filter + bit edges + bit tone powers
# ---------------------------------------------------------------------------

def sos_response_on_device(sos: torch.Tensor, nfft: int) -> torch.Tensor:
    """SOS cascade frequency response at the rfft bins, computed on the
    device from the raw coefficients, in their precision: complex64 from
    the float32 tables of every decode path (bin indices <= 2^24 stay exact
    in float32), complex128 from float64 coefficients (``iir.sosfilt_fft``
    of a float64 signal)."""
    k = torch.arange(nfft // 2 + 1, dtype=sos.dtype, device=sos.device)
    step = 2.0 * np.pi / nfft
    theta = k * (step if sos.dtype == torch.float64 else float(np.float32(step)))
    z = torch.complex(torch.cos(theta), -torch.sin(theta))
    h = torch.complex(torch.ones_like(theta), torch.zeros_like(theta))
    for sec in range(sos.shape[0]):
        b0, b1, b2, _, a1, a2 = (sos[sec, j] for j in range(6))
        num = b0 + z * (b1 + z * b2)
        den = 1.0 + z * (a1 + z * a2)
        h = h * num / den
    return h


def unpack_int4(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Unpack the 2-samples-per-byte int4 wire (even samples in the high
    nibble, level + 8) to int32 PCM, along the last dimension.  The nibbles
    are written straight into the interleaved int32 result: the only
    waveform-sized temporaries are the two uint8 nibble planes."""
    out = torch.empty(packed.shape + (2,), dtype=torch.int32, device=packed.device)
    out[..., 0] = packed >> 4
    out[..., 1] = packed & 15
    out -= 8
    return out.reshape(*packed.shape[:-1], -1)[..., :n]


EXACT_CHUNK = 256  # samples of at most 2^15 in magnitude: a chunk's sum stays below 2^23
SHORT_SAMPLES = (torch.int8, torch.uint8, torch.int16)  # dtypes of at most 16 bits


def _exact_chunk(n: int) -> int:
    """Samples a chunk of :func:`integer_row_sums`: a divisor of `n` from 128
    to ``EXACT_CHUNK`` where there is one (one reduction, no tail; 250 for
    the 60 s and 600 s rows at 44.1 kHz), else ``EXACT_CHUNK``."""
    return next((c for c in range(EXACT_CHUNK, EXACT_CHUNK // 2 - 1, -1) if n % c == 0),
                EXACT_CHUNK)


def integer_row_sums(pcm: torch.Tensor, xf: torch.Tensor) -> torch.Tensor:
    """The exact sums of integer PCM along its last dimension, as float64
    (integers below 2^53, so exact), given its float32 copy `xf`.  For
    samples of at most 16 bits (int8, uint8, int16; :func:`conditioned`
    hands the int4 wire's levels over as int8) no wider copy of the waveform
    is made: `xf` is summed in chunks (:func:`_exact_chunk`), whose float32
    partial sums are integers below 2^24 and so exact in any order, then the
    chunks' sums in float64.  A wider integer dtype is summed by ``torch.sum``
    in int64, which widens a copy of it.  An exact sum does not depend on the
    order of summation: a row's sum is the same in any batch and on any
    device."""
    if pcm.dtype not in SHORT_SAMPLES:
        return pcm.sum(-1, dtype=torch.int64).to(torch.float64)
    n = xf.shape[-1]
    c = _exact_chunk(n)
    m = n // c
    parts = [xf[..., : m * c].unfold(-1, c, c).sum(-1)] if m else []
    if m * c < n:
        parts.append(xf[..., m * c:].sum(-1, keepdim=True))
    chunks = parts[0] if len(parts) == 1 else torch.cat(parts, -1) if parts else xf
    return chunks.sum(-1, dtype=torch.float64)


def exact_mean(total: torch.Tensor, n_valid) -> torch.Tensor:
    """The float32 mean of rows from their exact sums (float64): the float64
    sum divided by the float64 count, rounded once to float32, in one
    operation (computed in float64, written to a float32 output)."""
    out = torch.empty(torch.broadcast_shapes(total.shape, n_valid.shape), dtype=torch.float32,
                      device=total.device)
    return torch.div(total, n_valid, out=out)


def condition_integer(pcm: torch.Tensor, n: int, n_valid) -> torch.Tensor:
    """DC removal + peak normalization of raw integer PCM (reference
    AXCTDprocessor.py:55-57) along the last dimension (a batch conditions
    row by row); ``n_valid`` (the true length of each zero-padded buffer)
    keeps the mean exact and zeroes the padded tail.  The mean is the exact
    sum over the true length, rounded once to float32 (:func:`exact_mean`),
    and the peak an exact max: a row conditioned in a batch is the row
    conditioned alone bit for bit, on the CPU and on the card, and the card
    equals the CPU."""
    xf = pcm.to(torch.float32)
    nv = n_valid.unsqueeze(-1)
    mean = exact_mean(integer_row_sums(pcm, xf), n_valid).unsqueeze(-1)
    peak = torch.linalg.vector_norm(xf, ord=math.inf, dim=-1, keepdim=True).clamp_(min=1.0)
    x = (xf - mean) / peak
    return torch.where(torch.arange(n, device=x.device) < nv, x, 0.0)


def zero_phase_decimate2(x: torch.Tensor, decim_sos: torch.Tensor,
                         nfft: int) -> torch.Tensor:
    """The order-8 Chebyshev-I anti-alias response applied as |H|^2 in the
    FFT domain (zero phase, scipy.signal.decimate for >50 kHz inputs), then
    a stride-2 slice, along the last dimension (rows as ``apply_response``
    takes them); unmasked."""
    h = sos_response_on_device(decim_sos, nfft)
    zero_phase = (h * torch.conj(h)).real
    return apply_response(x, zero_phase, nfft)[..., : x.shape[-1]][..., ::2]


def decimate2_on_device(x: torch.Tensor, n_valid, decim_sos: torch.Tensor):
    """Zero-phase decimation by 2 of the whole waveform.  Returns (half-rate
    PCM, half-rate n_valid)."""
    x2 = zero_phase_decimate2(x, decim_sos, iir.next_pow2(x.shape[0] + 4096))
    n_valid2 = (n_valid + 1) // 2
    x2 = torch.where(torch.arange(x2.shape[0], device=x2.device) < n_valid2, x2, 0.0)
    return x2, n_valid2


BIG = torch.iinfo(torch.int32).max // 2  # fill of empty crossing slots


# Rows of a batch per FFT call, by device type: a row of a batch must be the
# row alone bit for bit.  cuFFT filters every row of a (B, nfft) call bit
# for bit as the row alone (measured on an H100 at the decodes' sizes:
# chip_smoke.py phase 2c, PERF.md), so the card transforms up to 8 rows in
# one call and a larger batch in chunks of 8 (measured bit-equal to the whole
# batch in one call): a captured program keeps its forward's peak as its
# graph pool, and the 64 x 120 s batch program's pool fell from 15.60 to
# 12.12 GiB (PERF.md, PR 20).  Every batch of 8 rows or fewer (a segment
# group, a stream row, the batches of 8) is one call, as before.  pocketfft
# (the CPU) vectorises across the rows of a call and rounds a row of a batch
# otherwise: the CPU goes row by row.
FFT_ROWS_PER_CALL = {"cpu": 1, "cuda": 8}


def _response_rows(x: torch.Tensor, response: torch.Tensor, nfft: int) -> torch.Tensor:
    return torch.fft.irfft(torch.fft.rfft(x, nfft) * response, nfft)


def apply_response(x: torch.Tensor, response: torch.Tensor, nfft: int) -> torch.Tensor:
    """`x` filtered in the FFT domain over `nfft` points by a response at
    the rfft bins (``sos_response_on_device``), along the last dimension:
    (..., nfft) from (..., n).  Leading dimensions are rows of a batch,
    transformed ``FFT_ROWS_PER_CALL`` of the device at a time (1: each row
    as a 1-D call) into one output."""
    w = FFT_ROWS_PER_CALL.get(x.device.type)
    if x.dim() < 2 or w is None or (w > 1 and x.shape[:-1].numel() <= w):
        return _response_rows(x, response, nfft)
    rows = x.reshape(-1, x.shape[-1])
    out = rows.new_empty((rows.shape[0], nfft))
    for i in range(0, rows.shape[0], w):
        out[i: i + w] = _response_rows(rows[i] if w == 1 else rows[i: i + w], response, nfft)
    return out.reshape(x.shape[:-1] + (nfft,))


def fft_filter(x: torch.Tensor, sos: torch.Tensor, nfft: int) -> torch.Tensor:
    """The demod filter (the SOS cascade's response) applied in the FFT
    domain over `nfft` points."""
    return apply_response(x, sos_response_on_device(sos, nfft), nfft)


def find_crossings(filtered: torch.Tensor, length: int, g_off, n_valid,
                   edge_pad: int, size: int, fs: float):
    """Zero crossings of the filtered signal between local samples i and
    i + 1, i in [0, length), kept where the global position ``i + g_off``
    lies in [edge_pad, n_valid - 1) (no bit edges in a zero-padded tail),
    compacted with the per-row cap.  A crossing past the last sample of
    `filtered` does not exist.  `filtered` is one row (..., >= length) or
    rows along leading dimensions, with `g_off` and `n_valid` scalars or
    one per row.  Returns (local positions int64 (..., size), then ``BIG``;
    the exact counts; the row-overflow flags)."""
    nonneg = filtered >= 0
    nxt = nonneg[..., 1: length + 1]
    if nxt.shape[-1] < length:
        nxt = torch.cat([nxt, nonneg[..., length - 1: length]], -1)
    lead = filtered.dim() - 1

    def per_row(v):  # a scalar, or one value per row along the last axis
        return v[..., None] if isinstance(v, torch.Tensor) and v.dim() == lead > 0 else v

    gpos = torch.arange(length, device=filtered.device) + per_row(g_off)
    is_cross = ((nonneg[..., :length] != nxt) & (gpos >= edge_pad)
                & (gpos < per_row(n_valid) - 1))
    return chain_ops.compact_indices_rowcap(
        is_cross, size, BIG, row_cap=chain_ops.rowcap_for_fs(fs))


def probe_ratio(filtered: torch.Tensor, starts: torch.Tensor, npcm: int,
                bit_trig: torch.Tensor) -> torch.Tensor:
    """Per-bit confidence ratio ``space / max(mark, 1e-30)`` of the
    `npcm`-sample windows at `starts`: one stream carries both the bit
    decision and the calibration histogram (``stage15_core``); one row or a
    batch (``goertzel.probe_at``)."""
    probes = goertzel.probe_at(filtered, starts, npcm, bit_trig)
    return probes[..., 1] / torch.clamp(probes[..., 0], min=1e-30)


def demod_core(x: torch.Tensor, sos: torch.Tensor, bit_trig: torch.Tensor,
               dims: EngineDims, fs: float, bitrate: float, bit_inset: int,
               edge_pad: int, n_valid) -> dict:
    """Whole-waveform demod front end: FFT-domain filter, crossings, the
    bit-edge chain and per-bit mark (``s1``) and space (``s2``) powers over
    the inset window.

    `x` is one waveform (n,) or a batch (B, n) with (B,) ``n_valid``: the
    B = 1 case and the batch are one pass over (B, n) rows, with no loop
    over rows (the JAX package's ``jax.vmap`` of stage 1).  The filter goes
    through :func:`apply_response` (calls of up to 8 rows on the card,
    where cuFFT filters a row of a batch bit for bit as the row alone), the
    crossings' compaction is integer, and the probes are
    ``goertzel.probe_at`` (a fixed order of sums per probe): each row of a
    batch is the row alone bit for bit.  The bit-edge chain of all rows is
    one walk launch on the card."""
    nfft = iir.next_pow2(dims.n + 4096)
    response = sos_response_on_device(sos, nfft)
    rows, nv = x.reshape(-1, x.shape[-1]), n_valid.reshape(-1)
    filtered = apply_response(rows, response, nfft)[:, : dims.n].to(x.dtype)
    crossings, n_cross, rovf = find_crossings(filtered, dims.n, 0, nv, edge_pad,
                                              dims.max_crossings, fs)
    edge_idx, n_edges = chain_ops.enumerate_bit_edges(
        crossings, n_cross, fs, bitrate, dims.max_edges)
    edge_samples = torch.gather(crossings, -1,
                                torch.clamp(edge_idx, 0, dims.max_crossings - 1))
    probes = goertzel.probe_at(filtered, edge_samples + bit_inset, dims.npcm, bit_trig)
    overflow = (n_cross > dims.max_crossings).to(torch.int32) | rovf
    out = dict(edge_samples=edge_samples, n_edges=n_edges, s1=probes[..., 0],
               s2=probes[..., 1], overflow=overflow)
    return {k: v.reshape(x.shape[:-1] + v.shape[1:]) for k, v in out.items()}


# ---------------------------------------------------------------------------
# stage 1.5: bit decisions + scale calibration + header windows
# ---------------------------------------------------------------------------

HEADER_WINDOW_BITS = 6144  # capacity for one header capture window's bits


def stage15_core(c0: torch.Tensor, edge_samples: torch.Tensor, n_edges,
                 h_bounds: torch.Tensor, calib_cut, dims: EngineDims) -> dict:
    """Calibrate the space-power scale from the header-1 confidence
    histogram (reference demodulate.py:124-157), call every bit, and cut
    the header-2/3 capture windows into fixed-size buffers.

    ``c0`` is the per-bit ratio ``space / max(mark, 1e-30)``; the bit
    decision ``mark >= space * eff`` is ``c0 * eff <= 1``.  ``h_bounds``
    holds (h1_lo, h1_hi, h2_lo, h2_hi, h3_lo, h3_hi), inclusive sample
    bounds.  ``edge_samples`` is non-decreasing, so each window is a
    contiguous run of edges found by two binary searches.  One row, or a
    batch along a leading dimension (``h_bounds`` (B, 6), per-row scalars
    (B,)).
    """
    dev = c0.device
    me = dims.max_edges
    batch = c0.shape[:-1]
    idx = torch.arange(me, device=dev)
    bit_valid = idx < (n_edges - 1)[..., None]  # the final edge's bit is never emitted
    scale0 = torch.full((), 1.5, dtype=torch.float32, device=dev)
    edges = edge_samples.to(torch.int64).contiguous()
    last = torch.clamp(n_edges - 1, min=0)[..., None]
    # the three windows' first edges and edge counts, two binary searches for all
    hb = h_bounds.to(torch.int64)
    lo_i = torch.minimum(torch.searchsorted(edges, hb[..., 0::2].contiguous()), last)
    hi_i = torch.minimum(torch.searchsorted(edges, hb[..., 1::2].contiguous(), right=True), last)
    n_sel = torch.clamp(hi_i - lo_i, min=0)  # empty/inverted -> 0

    wloc = torch.arange(HEADER_WINDOW_BITS, device=dev)

    def cut(ext, lo_i):
        return torch.gather(ext, -1, torch.clamp(lo_i[..., None] + wloc,
                                                 max=ext.shape[-1] - 1))

    def pad(v):
        return torch.cat([v, torch.zeros(batch + (HEADER_WINDOW_BITS,),
                                         dtype=v.dtype, device=dev)], -1)

    # histogram of confidences on [0, 3) in 0.01 bins over the h1 window
    n_h1 = n_sel[..., 0]
    vals = torch.where(wloc < n_h1[..., None], cut(pad(c0 * scale0), lo_i[..., 0]), -1.0)
    bins = torch.floor(vals * 100.0)
    in_range = (bins >= 0) & (bins < 299)
    slot = torch.where(in_range, bins, 299.0).to(torch.int64)
    counts = torch.zeros(batch + (300,), dtype=torch.int64, device=dev).scatter_add_(
        -1, slot, torch.ones_like(slot))[..., :299]
    cum = (100.0 * torch.cumsum(counts, -1).to(torch.float32)
           / torch.clamp(n_h1, min=1)[..., None])
    centers = (torch.arange(299, dtype=torch.float32, device=dev) + 0.5) * 0.01
    # slopes: / 0.02 and / 0.01, rounded as XLA rounds them (x * 50, x * 100)
    slope = torch.cat([(cum[..., 1:2] - cum[..., 0:1]) * 100.0,
                       (cum[..., 2:] - cum[..., :-2]) * 50.0,
                       (cum[..., -1:] - cum[..., -2:-1]) * 100.0], -1)
    in_band = (cum >= 30.0) & (cum <= 65.0)
    min_slope = torch.where(in_band, slope, math.inf).amin(-1)
    is_min = in_band & (slope == min_slope[..., None])
    first_c = torch.take(centers, hdr_ops.first_true(is_min))
    last_c = torch.take(centers, 298 - hdr_ops.first_true(is_min.flip(-1)))
    threshold = 0.5 * (first_c + last_c)
    ok = (n_h1 > 50) & in_band.any(-1) & (threshold > 0)
    scale_new = torch.where(ok, scale0 / threshold, scale0)

    eff = torch.where(edges <= calib_cut[..., None], scale0, scale_new[..., None])
    bits = ((c0 * eff <= 1.0) & bit_valid).to(torch.int32)
    bits_ext = pad(bits)

    def window(j):
        n = n_sel[..., j]
        return torch.where(wloc < n[..., None], cut(bits_ext, lo_i[..., j]), 0), n

    h2_bits, h2_n = window(1)
    h3_bits, h3_n = window(2)
    return dict(bits=bits, scale=scale_new, h2_bits=h2_bits, h2_n=h2_n,
                h3_bits=h3_bits, h3_n=h3_n)


# ---------------------------------------------------------------------------
# stage 2: profile frame sync
# ---------------------------------------------------------------------------

def _round2(x: torch.Tensor) -> torch.Tensor:
    """Round to 2 decimals, half to even: round(x * 100) / 100 with the
    division rounded as XLA rounds it (times the f32 reciprocal 0.01)."""
    return torch.round(x * 100.0) * 0.01


def stage2_core(bits: torch.Tensor, n_bits, edge_samples: torch.Tensor,
                r400_win: torch.Tensor, r7500_win: torch.Tensor, mean7500,
                profstart, dims: EngineDims, fs: float) -> dict:
    """Profile frame sync; returns the lean per-frame outputs (frame words,
    exact frame-start samples, 2-decimal tone ratios).  Conversion and QC
    run on the host in float64 (``attach_profile``).

    Frame words need 32 bits and torch has no uint32 shifts on the CPU:
    the words are built in int64 and ship as their two's-complement int32.
    One row, or a batch along a leading dimension with per-row scalars.
    """
    dev = bits.device
    me = dims.max_edges
    idx = torch.arange(me, device=dev)

    def at(v, i):
        return torch.gather(v, -1, i)

    # 1. drop bits at/before the profile start; rotate them to the front
    in_prof = (idx < n_bits[..., None]) & (edge_samples > profstart[..., None])
    first = hdr_ops.first_true(in_prof)
    n_prof = in_prof.sum(-1)
    rot = (idx + first[..., None]) % me
    bits_p = at(bits, rot)
    edges_p = at(edge_samples, rot)

    # per-bit signal ratios: nearest power window on the uniform grid
    win = torch.round(edges_p.to(torch.float32) * _f32_recip(dims.d_pcm))
    win = torch.clamp(win, 0, dims.n_win - 1).to(torch.int64)
    bit_r400 = at(r400_win, win)
    bit_r7500 = at(r7500_win, win) - mean7500[..., None]

    # 2. the 32-bit frame word at every bit offset (Horner over shifts)
    bext = torch.cat([bits_p.to(torch.int64),
                      torch.zeros(bits_p.shape[:-1] + (32,), dtype=torch.int64,
                                  device=dev)], -1)
    word = torch.zeros(bits_p.shape, dtype=torch.int64, device=dev)
    for k in range(32):  # word[i] = sum_k bits_p[i+k] << (31-k)
        word = (word << 1) | bext[..., k: k + me]

    # 3. frame acceptance per offset: '10' + CRC + positive 7500 ratio
    crc_valid = crc_ops.check_crc_words(word)
    nxt = torch.roll(bits_p, -1, dims=-1)
    accept = (bits_p == 1) & (nxt == 0) & crc_valid & (bit_r7500 > 0)
    accept &= idx < (n_prof - 32)[..., None]
    starts, n_frames, consumed, sync_ovf = chain_ops.enumerate_frames(
        accept, n_prof, max_frames=dims.max_frames)

    hexpack = at(word, starts)
    hexpack = hexpack - ((hexpack >> 31) & 1) * (1 << 32)  # two's complement
    return dict(edges=at(edges_p, starts), r400=_round2(at(bit_r400, starts)),
                r7500=_round2(at(bit_r7500, starts)), hexpack=hexpack,
                n_frames=n_frames, consumed=consumed,
                overflow=sync_ovf << 2)  # bits 2-3: accept/frame tables


# ---------------------------------------------------------------------------
# trigger + fused back half
# ---------------------------------------------------------------------------

def trigger_tables(cfg: DecoderConfig, fs: float):
    """Integer trigger thresholds (exact, from float64 on the host) and the
    two float thresholds."""
    tr0, tr1 = cfg.trigger_range
    trig_i = np.asarray([
        int(math.ceil(4.5 * fs)),            # baseline lo:  rel >= .
        int(math.floor(5.5 * fs)),           # baseline hi:  rel <= .
        int(math.floor(tr0 * fs)) + 1,       # trigger:      rel >= . (== rel > tr0*fs)
        int(tr1 * fs) if tr1 > 0 else 0,     # timeout reach (truncates, as upstream)
        int(tr1 * fs) if tr1 > 0 else 0,     # timeout profstart offset
        1 if tr1 > 0 else 0,                 # timeout enabled
        1 if cfg.compat == "fixed" else 0,   # elif-quirk bypass (PARITY #16)
    ], np.int32)
    trig_f = np.asarray([cfg.min_r400, cfg.min_dr7500], np.float32)
    return trig_i, trig_f


def header_rel_offsets(fs: float) -> np.ndarray:
    """Sample offsets of the three header capture windows from the pulse
    start (reference windows +-0.5 s, AXCTDprocessor.py:447-456)."""
    rel = (2.3 - 0.5, 3.3 + 0.5, 10.5 - 0.5, 14.8 + 0.5, 20.0 - 0.5, 24.5 + 0.5)
    return np.asarray([int(fs * r) for r in rel], dtype=np.int32)


def trigger_core(r400: torch.Tensor, r7500: torch.Tensor, n_valid,
                 trig_i: torch.Tensor, trig_f: torch.Tensor,
                 dims: EngineDims, fs: float):
    """Pulse detection, 7500 Hz baseline and profile trigger over the real
    (non-padded) window grid.  Returns (firstpulse|-1, mean7500,
    profstart|-1) as device scalars, or as (B,) vectors for a batch of
    (B, n_win) ratios with (B,) ``n_valid``."""
    dev = r400.device
    n_win = r400.shape[-1]
    idx = torch.arange(n_win, device=dev)
    win = idx * dims.d_pcm
    n_power = int(fs / 10)
    n_win_true = torch.clamp((n_valid - n_power + dims.d_pcm - 1) // dims.d_pcm,
                             min=1, max=n_win)
    real = idx < n_win_true[..., None]

    hit = real & (r400 >= trig_f[0])
    any_hit = hit.any(-1)
    fp = torch.where(any_hit, torch.take(win, hdr_ops.first_true(hit)), -1)

    rel = win - fp[..., None]
    base = real & (rel >= trig_i[0]) & (rel <= trig_i[1]) & ~torch.isnan(r7500)
    cnt = base.sum(-1)
    # the baseline is one contiguous run of <= ~26 windows (4.5-5.5 s after
    # the pulse): summed left to right in float32, so the mean is the same
    # on every device and batch size (a parallel reduction's order is the
    # device's own)
    span = (math.floor(5.5 * fs) - math.ceil(4.5 * fs)) // dims.d_pcm + 2
    at = hdr_ops.first_true(base)[..., None] + torch.arange(span, device=dev)
    inside = at < n_win
    at = torch.clamp(at, max=n_win - 1)
    vals = torch.where(inside & torch.gather(base, -1, at),
                       torch.gather(r7500, -1, at), 0.0)
    total = vals[..., 0]
    for j in range(1, span):
        total = total + vals[..., j]
    mean7500 = torch.where(cnt > 0, total / cnt, math.nan)
    tone_path = ~torch.isnan(mean7500)

    trig = real & (rel >= trig_i[2]) & (r7500 - mean7500[..., None] >= trig_f[1])
    any_trig = tone_path & trig.any(-1)
    last_rel = torch.take(win, n_win_true - 1) - fp
    timeout = (trig_i[5] > 0) & ((trig_i[6] > 0) | ~tone_path) & \
        (last_rel >= trig_i[3])
    profstart = torch.where(any_trig, torch.take(win, hdr_ops.first_true(trig)),
                            torch.where(timeout, fp + trig_i[4], -1))
    profstart = torch.where(any_hit, profstart, -1)
    mean7500 = torch.where(any_hit, mean7500, math.nan)
    return fp, mean7500, profstart


def _fix16(x: torch.Tensor) -> torch.Tensor:
    """2-decimal value -> int16 centi-units, NaN -> -32768."""
    v = torch.clamp(torch.round(x * 100.0), -32000, 32000)
    return torch.where(torch.isnan(x), -32768,
                       torch.nan_to_num(v).to(torch.int32)).to(torch.int16)


def back_half_core(r400, r7500, edge_samples, n_edges, c0p, n_valid,
                   trig_i, trig_f, hdr_rel, calib_off, dims: EngineDims,
                   fs: float, overflow0: torch.Tensor) -> torch.Tensor:
    """Everything after the front end: trigger, bit decisions +
    calibration, header trim/sync, profile frame sync, and the packing into
    one int32 vector (layout of the JAX engine's ``back_half_core``).

    ``overflow0`` carries stage 1's truncation bit; the edge-table and
    frame-sync bits are added here (``DecodeResult.overflow``).

    One row, or a batch of rows along a leading dimension (per-row scalars
    (B,)) -> the (B, L) matrix: the batch dimension written out where the
    JAX package ``vmap``s this function, with no loop over rows.  Every op
    is integer, elementwise, a gather or a sum in a fixed order, so a row
    of a batch is bitwise the row decoded alone."""
    dev = r400.device
    batch = r400.shape[:-1]
    fp, mean7500, profstart = trigger_core(r400, r7500, n_valid, trig_i,
                                           trig_f, dims, fs)
    # empty header windows when no pulse was found
    big = 2 ** 30
    lo_mask = torch.arange(6, device=dev) % 2 == 0
    hb = torch.where((fp >= 0)[..., None], fp[..., None] + hdr_rel,
                     torch.where(lo_mask, big, -big))
    # calib_off is a (1,) buffer (to_device makes 0-d arrays 1-d)
    s15 = stage15_core(c0p, edge_samples, n_edges, hb, fp + calib_off.reshape(()), dims)

    h2_found, h2_frames, h2_usable = hdr_ops.parse_header_window(
        s15["h2_bits"], s15["h2_n"])
    h3_found, h3_frames, h3_usable = hdr_ops.parse_header_window(
        s15["h3_bits"], s15["h3_n"])

    out = stage2_core(s15["bits"], n_edges - 1, edge_samples, r400, r7500,
                      mean7500, profstart, dims, fs)
    gate = profstart >= 0

    ovf = overflow0.to(torch.int32)
    ovf = ovf | ((n_edges >= dims.max_edges).to(torch.int32) << 1)
    ovf = ovf | out["overflow"]

    # one int32 vector: scal_i[6], scal_f[2] (bitcast), header found flags
    # and nibbles, then per frame the word, the start sample and the two
    # ratios as int16 centi-units (two per int32)
    i32 = torch.int32
    hdr = torch.cat([h2_found.to(i32), h3_found.to(i32),
                     h2_frames.reshape(batch + (-1,)).to(i32),
                     h3_frames.reshape(batch + (-1,)).to(i32)], -1)
    scal_i = torch.stack([v.to(i32).expand(batch) for v in (
        fp, profstart, torch.where(gate, out["n_frames"], 0), h2_usable,
        h3_usable, ovf)], -1)
    scal_f = torch.stack([mean7500, s15["scale"].expand(batch)], -1).to(torch.float32)
    rat16 = torch.stack([_fix16(out["r400"]), _fix16(out["r7500"])], -2)
    parts = [scal_i, scal_f.view(i32), hdr, out["hexpack"].to(i32),
             out["edges"].to(i32), rat16.reshape(batch + (-1,)).view(i32)]
    return torch.cat(parts, -1)


def conditioned(pcm: torch.Tensor, n_valid) -> torch.Tensor:
    """Wire-format PCM as the float signal the decode runs on: packed int4
    unpacked, integers conditioned on the device, floats as they are."""
    if pcm.dtype == torch.uint8:  # packed int4 wire
        # levels -8..7: int8 keeps the conditioning's sums exact without a wider copy
        pcm = unpack_int4(pcm, 2 * pcm.shape[-1]).to(torch.int8)
    if not pcm.is_floating_point():
        pcm = condition_integer(pcm, pcm.shape[-1], n_valid)
    return pcm


def stage1_core(pcm, n_valid, power_trig, sos, bit_trig, dims: EngineDims,
                fs: float, bitrate: float, bit_inset: int, edge_pad: int) -> dict:
    """The front half of the decode at the decode rate: conditioning of
    integer PCM, smoothed tone ratios on the uniform whole-file grid (the
    CUDA kernel on a GPU, the plain version on a CPU tensor) and the demod
    front end.

    Returns ``r400``, ``r7500``, ``edge_samples``, ``n_edges``, the per-bit
    mark and space powers ``s1`` and ``s2``, and ``overflow``: what
    :func:`batched_back_half` takes.  A (B, N) batch with (B,) ``n_valid``
    is conditioned as one tensor, its tone ratios are ONE kernel launch, and
    the demod front end (:func:`demod_core`: filter, crossings, bit-edge
    chains, probes) one pass over the rows, with no host sync; every
    output gains a leading batch dimension."""
    x = conditioned(pcm, n_valid)
    r400, r7500 = tonepower.tone_ratios(x.to(torch.float32).contiguous(), power_trig,
                                        dims.n_power, dims.d_pcm)
    return dict(r400=r400, r7500=r7500, **demod_core(
        x, sos, bit_trig, dims, fs, bitrate, bit_inset, edge_pad, n_valid))


def batched_back_half(s1: dict, n_valid, trig_i, trig_f, hdr_rel, calib_off,
                      dims: EngineDims, fs: float) -> torch.Tensor:
    """The back half over a batch of stage-1 outputs (``stage1_core``, each
    with a leading batch dimension, and (B,) ``n_valid``): the (B, L) packed
    matrix, in one pass over the batch (:func:`back_half_core`) with no host
    sync."""
    ovf0 = s1.get("overflow")
    if ovf0 is None:
        ovf0 = torch.zeros_like(s1["n_edges"], dtype=torch.int32)
    c0 = s1["s2"] / torch.clamp(s1["s1"], min=1e-30)  # see stage15_core
    return back_half_core(s1["r400"], s1["r7500"], s1["edge_samples"],
                          s1["n_edges"], c0, n_valid, trig_i, trig_f, hdr_rel,
                          calib_off, dims, fs, overflow0=ovf0)


def back_half(s1: dict, n_valid, trig_i, trig_f, hdr_rel, calib_off,
              dims: EngineDims, fs: float) -> torch.Tensor:
    """The back half over one row of stage-1 outputs: the B = 1 case of
    :func:`batched_back_half`, the packed int32 vector."""
    return batched_back_half({k: v[None] for k, v in s1.items()}, n_valid[None],
                             trig_i, trig_f, hdr_rel, calib_off, dims, fs)[0]


def fused_core(pcm, n_valid, power_trig, sos, bit_trig, trig_i, trig_f,
               hdr_rel, calib_off, dims: EngineDims, fs: float,
               bitrate: float, bit_inset: int, edge_pad: int,
               decimate2: bool = False, decim_sos=None) -> torch.Tensor:
    """The whole decode: :func:`stage1_core` followed by the back half ->
    packed int32 vector, or the (B, L) matrix of a (B, N) batch with (B,)
    ``n_valid`` (the batch path; one tone-ratio launch for the batch).

    With ``decimate2`` (one waveform only) the input is at twice the
    decode rate (>50 kHz WAVs): conditioning and zero-phase decimation run
    first at the raw rate.  ``dims``/``fs`` describe the post-decimation
    stream."""
    if decimate2:
        pcm, n_valid = decimate2_on_device(conditioned(pcm, n_valid), n_valid,
                                           decim_sos)
    s1 = stage1_core(pcm, n_valid, power_trig, sos, bit_trig, dims, fs,
                     bitrate, bit_inset, edge_pad)
    finish = back_half if pcm.dim() == 1 else batched_back_half
    return finish(s1, n_valid, trig_i, trig_f, hdr_rel, calib_off, dims, fs)


TABLE_NAMES = ("power_trig", "bit_trig", "sos", "trig_i", "trig_f", "hdr_rel",
               "calib_off")


def to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array as a tensor on `dev`, without a host sync: on a GPU it
    goes through pinned memory with a non-blocking copy (a pageable copy
    waits for the device's queue to drain)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def register_tables(module: nn.Module, tables: dict, decimate2: bool,
                    dev: torch.device) -> None:
    """The constant tables (``engine_tables``) as the module's buffers."""
    names = TABLE_NAMES + (("decim_sos",) if decimate2 else ())
    for name in names:
        module.register_buffer(name, to_device(tables[name], dev))


class FusedDecoder(nn.Module):
    """The fused decode as a module: the constant tables are its buffers
    (its "weights"), ``forward(pcm, n_valid)`` returns the packed int32
    vector, or a (B, L) matrix for a (B, N) batch.  One module per static
    shape (``EngineDims``) and rate."""

    def __init__(self, dims: EngineDims, fs: float, bitrate: float,
                 bit_inset: int, edge_pad: int = 100, decimate2: bool = False):
        super().__init__()
        self.dims, self.fs, self.bitrate = dims, float(fs), float(bitrate)
        self.bit_inset, self.edge_pad = int(bit_inset), int(edge_pad)
        self.decimate2 = bool(decimate2)

    @classmethod
    def from_numpy_tables(cls, tables: dict, dims: EngineDims, fs: float, *,
                          bitrate: float, bit_inset: int, edge_pad: int = 100,
                          decimate2: bool = False, device) -> "FusedDecoder":
        """Build the buffers from exactly the numpy arrays the JAX program
        is given (``engine_tables``)."""
        m = cls(dims, fs, bitrate, bit_inset, edge_pad, decimate2)
        register_tables(m, tables, decimate2, torch.device(device))
        return m

    def stage1(self, pcm: torch.Tensor, n_valid: torch.Tensor) -> dict:
        """The front half alone (``stage1_core``), for callers that run the
        two halves apart (``parallel.pipeline``); no decimation."""
        return stage1_core(pcm, n_valid, self.power_trig, self.sos, self.bit_trig,
                           self.dims, self.fs, self.bitrate, self.bit_inset,
                           self.edge_pad)

    def back_half(self, s1: dict, n_valid: torch.Tensor) -> torch.Tensor:
        """The back half of a batch of ``stage1`` outputs: the (B, L) matrix."""
        return batched_back_half(s1, n_valid, self.trig_i, self.trig_f,
                                 self.hdr_rel, self.calib_off, self.dims, self.fs)

    def forward(self, pcm: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
        return fused_core(
            pcm, n_valid, self.power_trig, self.sos, self.bit_trig,
            self.trig_i, self.trig_f, self.hdr_rel, self.calib_off,
            self.dims, self.fs, self.bitrate, self.bit_inset, self.edge_pad,
            decimate2=self.decimate2, decim_sos=getattr(self, "decim_sos", None))


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _designed_tables(key, fs: float, n_power: int, npcm: int):
    mark, space, dead, use_bp = key
    power_trig = goertzel.tone_matrix(n_power, [400.0, 7500.0, dead], fs,
                                      dtype=np.float32)
    bit_trig = goertzel.tone_matrix(npcm, [mark, space], fs, dtype=np.float32)
    sos = iir.design_sos(fs, use_bp)
    return power_trig, bit_trig, sos


def back_half_tables(cfg: DecoderConfig, fs: float) -> dict:
    """The back half's numpy tables: trigger thresholds, header window
    offsets and the calibration offset."""
    trig_i, trig_f = trigger_tables(cfg, fs)
    return dict(trig_i=trig_i, trig_f=trig_f, hdr_rel=header_rel_offsets(fs),
                calib_off=np.asarray(int(fs * 3.8), np.int32))


def engine_tables(cfg: DecoderConfig, fs: float, dims: EngineDims,
                  decimate2: bool = False) -> dict:
    """The decode's constant numpy tables: tone matrices, demod SOS,
    trigger thresholds, header window offsets, the calibration offset and
    (for >50 kHz input) the decimator's SOS.  Equal, array for array, to
    what the JAX engine feeds its program."""
    key = (cfg.mark_freq, cfg.space_freq, cfg.dead_freq, cfg.use_bandpass)
    power_trig, bit_trig, sos = _designed_tables(key, fs, dims.n_power, dims.npcm)
    tables = dict(power_trig=power_trig, bit_trig=bit_trig,
                  sos=sos.astype(np.float32), **back_half_tables(cfg, fs))
    if decimate2:
        tables["decim_sos"] = iir.design_decim_sos().astype(np.float32)
    return tables


EDGE_PAD = 100  # samples at the start of a drop where no bit edge is taken


def fused_program(tables: dict, dims: EngineDims, fs: float, cfg: DecoderConfig,
                  pcm: np.ndarray, device, *, decimate2: bool = False) -> programs.Program:
    """The cached program (``models.programs``) of the fused decode of
    wire-format PCM of `pcm`'s dtype and shape, one waveform or a (B, N)
    batch, on `device`: a ``FusedDecoder`` with `tables` on the device, a
    static input of that shape and its ``n_valid`` (0-d, or one per row).
    The key holds everything the forward takes as a constant."""
    dev = programs.device_key(device)
    bitrate, bit_inset = float(cfg.bitrate), int(cfg.bit_inset)
    key = ("fused", dims, float(fs), bool(decimate2), pcm.dtype.str, pcm.shape, str(dev),
           bitrate, bit_inset, EDGE_PAD, programs.table_key(tables))

    def build():
        model = FusedDecoder.from_numpy_tables(
            tables, dims, fs, bitrate=bitrate, bit_inset=bit_inset, edge_pad=EDGE_PAD,
            decimate2=decimate2, device=dev)
        x = torch.empty(pcm.shape, dtype=torch.from_numpy(pcm[:0]).dtype, device=dev)
        n_valid = torch.empty(pcm.shape[:-1], dtype=torch.int64, device=dev)
        return programs.Program(model, (x, n_valid), dev, module=model)

    return programs.cached(key, build)


def qc_limits(cfg: DecoderConfig, dtype=np.float32) -> np.ndarray:
    """The six in-profile QC limits as one array: min dR7500, min R400, the
    temperature bounds, the salinity bounds."""
    return np.asarray([cfg.min_dr7500_inprof, cfg.min_r400_inprof,
                       cfg.tlims[0], cfg.tlims[1], cfg.slims[0], cfg.slims[1]],
                      dtype=dtype)


def fused_inputs(cfg: DecoderConfig, fs: float, dtype=np.float32, device="cpu") -> dict:
    """The parameter arrays of one fused decode call as tensors on `device`,
    under the JAX engine's names: the trigger, header-window and calibration
    tables of :func:`engine_tables`, then the coefficient defaults (rows z,
    t, c), the temperature LUT and the QC limits, which the device program
    does not read (the host converts and filters in float64).
    ``FusedDecoder`` registers the first four once, as buffers."""
    dev = torch.device(device)
    arrays = dict(
        **back_half_tables(cfg, fs),
        coeff_defaults=np.asarray(
            [cfg.zcoeff_default, cfg.tcoeff_default, cfg.ccoeff_default], np.float32),
        temp_lut=np.asarray(load_temp_lut(), dtype),
        limits=qc_limits(cfg, dtype))
    return {k: to_device(v, dev).reshape(np.shape(v)) for k, v in arrays.items()}


def attach_profile(result: DecodeResult, out: dict, cfg: DecoderConfig,
                   fs: float, profstart: int, live: dict) -> DecodeResult:
    """Science conversion + QC on the host in float64 from the per-frame
    outputs (reference parse.py:103-147, AXCTDprocessor.py:559-609)."""
    from . import convert

    n_frames = int(out["scal_i"][2])
    hexpack = np.asarray(out["hexpack"][:n_frames])
    edges = np.asarray(out["edges"][:n_frames], dtype=np.int64)
    fr = np.asarray(out["ratios"][:, :n_frames], dtype=np.float64)
    fr[fr == -32768] = np.nan  # int16 NaN sentinel
    r400, r7500 = fr / 100.0

    tint = (hexpack >> 6) & 0xFFF    # frame bits 14:26
    cint = (hexpack >> 18) & 0xFFF   # frame bits 2:14
    times_raw = (edges - profstart) / fs
    with profiling.span("convert"):
        temps, conds, psals, depths = convert.ints_to_observations(
            tint, cint, times_raw, load_temp_lut(),
            live["tcoeff"], live["ccoeff"], live["zcoeff"])

    times = np.round(times_raw + profstart / fs, 2)
    depths = np.round(depths, 2)
    temps = np.round(temps, 2)
    conds = np.round(conds, 2)
    psals = np.round(psals, 2)

    with profiling.span("qc"):
        good = convert.qc_bounds_mask(r400, r7500, temps, psals, cfg)
        if np.any(good):
            sub = np.flatnonzero(good)
            good[sub] &= convert.qc_spike_mask(temps[sub], psals[sub])

    # Whole-array passes: a column's floats come out of one .tolist(), and
    # every frame's 8 lowercase hex digits out of one byte table, split once.
    with profiling.span("profile_rows"):
        keep = np.flatnonzero(good)
        result.time = times[keep].tolist()
        result.depth = depths[keep].tolist()
        result.temperature = temps[keep].tolist()
        result.conductivity = conds[keep].tolist()
        result.salinity = psals[keep].tolist()
        result.r400 = r400[keep].tolist()
        result.r7500 = r7500[keep].tolist()
        nibbles = (hexpack[:, None] >> np.arange(28, -1, -4, dtype=np.uint32)) & 0xF
        text = np.empty((hexpack.size, 9), np.uint8)
        text[:, :8] = np.frombuffer(b"0123456789abcdef", np.uint8)[nibbles]
        text[:, 8] = ord("\n")
        # hexframes bypass QC (upstream contract); hexframes_qc is aligned
        result.hexframes = text.tobytes().decode("ascii").split("\n")[:-1]
        result.hexframes_qc = [result.hexframes[i] for i in keep.tolist()]
    return result


HDR_N = 72  # found flags per header in the packed hdr array
_HDR_LEN = 10 * HDR_N
_HEAD_LEN = 6 + 2 + _HDR_LEN  # scal_i + scal_f + hdr prefix


def unpack_result(buf: np.ndarray) -> dict:
    """Inverse of the single-vector packing: {hexpack, edges, ratios, hdr,
    scal_i, scal_f} as numpy views (ratios stay int16 centi-units)."""
    buf = np.ascontiguousarray(np.asarray(buf), dtype=np.int32)
    mf = (buf.shape[0] - _HEAD_LEN) // 3
    off = _HEAD_LEN
    return dict(hexpack=buf[off: off + mf].view(np.uint32),
                edges=buf[off + mf: off + 2 * mf],
                ratios=buf[off + 2 * mf:].view(np.int16).reshape(2, mf),
                hdr=buf[8: 8 + _HDR_LEN], scal_i=buf[:6],
                scal_f=buf[6:8].view(np.float32))


def finish_result(out, fs_report, n: int, fs: float, cfg: DecoderConfig,
                  wire_used: str | None = None) -> DecodeResult:
    """DecodeResult from one packed decode output: status, exact float64
    metadata from the header frames, and the profile."""
    if not isinstance(out, dict):
        out = unpack_result(out)
    result = DecodeResult(fs=fs_report, numpoints=n, wire=wire_used)
    scal_i = np.asarray(out["scal_i"])
    result.overflow = int(scal_i[5])
    fp = int(scal_i[0])
    if fp < 0:
        result.status = 0
        return result
    result.status = 1
    result.firstpulse400 = fp

    hdr = np.asarray(out["hdr"])
    h2 = (frames_host.header_dict_from_device(
              hdr[:HDR_N] > 0, hdr[2 * HDR_N: 6 * HDR_N].reshape(HDR_N, 4))
          if scal_i[3] else None)
    h3 = (frames_host.header_dict_from_device(
              hdr[HDR_N: 2 * HDR_N] > 0, hdr[6 * HDR_N:].reshape(HDR_N, 4))
          if scal_i[4] else None)
    live = {"tcoeff": list(cfg.tcoeff_default), "ccoeff": list(cfg.ccoeff_default),
            "zcoeff": list(cfg.zcoeff_default)}
    md.merge_headers(result.metadata, h2, h3, live)

    profstart = int(scal_i[1])
    if profstart < 0:
        return result
    result.status = 2
    result.profstartind = profstart
    result.firstpointtime = profstart / fs
    return attach_profile(result, out, cfg, fs, profstart, live)


def lossy_retry_worthy(res: DecodeResult, n: int, fs: float,
                       cfg: DecoderConfig) -> bool:
    """True when an int4-wire decode looks degenerate (no profile, or fewer
    than a quarter of the bitrate/32 frames per second a healthy stream
    yields) and is worth one lossless retry at int8."""
    if (res.wire or "") != "int4":
        return False
    if res.status != 2:
        return True
    dur = max(n / fs - max(res.firstpointtime, 0.0), 1.0)
    expected = dur * cfg.bitrate / 32.0
    return len(res.hexframes) < 0.25 * expected


def trigger_scalars(r400: np.ndarray, r7500: np.ndarray, cfg: DecoderConfig,
                    fs: float, d_pcm: int, n_valid: int | None = None):
    """Host scalar logic over the 25 Hz power series (numpy): pulse
    detection, 7500 Hz baseline, profile trigger; the host form of
    :func:`trigger_core`.  Returns (firstpulse|-1, mean7500, profstart|-1).

    ``n_valid`` is the true (pre-padding) sample count: decode inputs are
    zero-padded to length buckets, and the hard-timeout trigger compares
    against the *last* power window, so padding must not extend the grid."""
    if n_valid is not None:
        n_power = int(fs / 10)
        n_win_true = max(int(math.ceil((n_valid - n_power) / d_pcm)), 1)
        r400 = r400[:n_win_true]
        r7500 = r7500[:n_win_true]
    win_samples = np.arange(len(r400)) * d_pcm
    pulse_hits = np.flatnonzero(r400 >= cfg.min_r400)
    if pulse_hits.size == 0:
        return -1, np.nan, -1
    firstpulse = int(win_samples[int(pulse_hits[0])])

    base_mask = (win_samples >= firstpulse + 4.5 * fs) & (
        win_samples <= firstpulse + 5.5 * fs)
    with np.errstate(invalid="ignore"):
        mean7500 = float(np.nanmean(r7500[base_mask])) if base_mask.any() else np.nan

    trig_mask = (win_samples > firstpulse + cfg.trigger_range[0] * fs) & (
        r7500 - mean7500 >= cfg.min_dr7500)
    profstart = -1
    tone_path = not np.isnan(mean7500)
    if tone_path and trig_mask.any():
        profstart = int(win_samples[np.flatnonzero(trig_mask)[0]])
    elif (cfg.trigger_range[1] > 0
          and (cfg.compat == "fixed" or not tone_path)
          and win_samples[-1] >= firstpulse + int(fs * cfg.trigger_range[1])):
        profstart = firstpulse + int(fs * cfg.trigger_range[1])
    return firstpulse, mean7500, profstart


BUCKET_SECONDS = 15  # decode-length granularity: one shape per bucket
AUTO_SEGMENT_SECONDS = 300  # "auto" sends longer waveforms to the segmented engine


def resolve_device(device) -> torch.device:
    """The requested device; asking for CUDA without a GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() "
                           "is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


resolve_wire = wire_ops.resolve_wire  # the rule lives in ops.wire


def report_rate(fs) -> float | int:
    """The rate a report prints for input decoded at its own rate `fs`:
    `fs` as given, an int staying an int (the reference prints fs
    verbatim).  The batch paths, which never decimate, take it alone."""
    return float(fs) if isinstance(fs, float) else int(fs)


def decode_rates(fs) -> tuple:
    """A single drop's rates: (decode rate, report rate, raw samples per
    decoded sample).  Input above 50 kHz is decimated by 2 on the device and
    its report prints the halved rate as a float (the reference's host
    ``fs /= 2``); other input decodes at `fs`, reported as
    :func:`report_rate` says."""
    if float(fs) > 50000.0:
        return float(fs) / 2.0, float(fs) / 2.0, 2
    return float(fs), report_rate(fs), 1


def wait_for(out: torch.Tensor) -> None:
    """Block the host until the work queued on `out`'s device's current
    stream is done (nothing on the CPU): a fetch's wait, apart from its copy."""
    if out.is_cuda:
        torch.cuda.current_stream(out.device).synchronize()


@profiling.entry_point
def decode_waveform(pcm, fs, *, device="cuda", config: DecoderConfig | None = None,
                    wire: str = "auto", mode: str = "auto",
                    lossy_retry: bool = True, timer=None) -> DecodeResult:
    """Decode a conditioned float or raw-integer waveform on `device`.

    ``mode`` routes as the JAX engine does: "auto" sends waveforms longer
    than ``AUTO_SEGMENT_SECONDS`` (counted at the raw rate) to the
    segmented engine (``models.segmented``) and decodes shorter ones in
    one program; "segmented" and "monolithic" force a path.

    The monolithic program: waveforms are zero-padded up to 15 s buckets;
    the true length rides along as ``n_valid`` (exact conditioning, no
    crossings in the padding, trigger grid clipped to real windows).  Each
    bucket, wire and rate is one cached program (``fused_program``): the
    first decode of a shape runs its module eagerly, the second captures it
    as a CUDA graph on a GPU, later ones replay it.
    Integer PCM ships as the `wire` format and is conditioned on the
    device; >50 kHz input is decimated by 2 on the device.  An int4-wire
    decode that comes back degenerate is retried once at int8
    (``lossy_retry``).  ``timer`` (a ``StageTimer``;
    ``utils.profiling.entry_point``) takes the host's wire encode
    (``host_encode_stats``), the padding, the program's lookup and the
    pinning and queueing of the upload (``build_upload``), the copy down
    (``fetch``, its wait ``device_wait`` first) and ``finish_result``
    (``host_finish``), under the segmented engine's stage names.
    """
    dev = resolve_device(device)
    cfg = config or DecoderConfig()
    pcm, wire_used = wire_ops.intake(pcm, wire, dev)
    pcm0, fs0 = pcm, fs  # before the wire's encode (the lossless retry's input)
    if mode not in ("auto", "monolithic", "segmented"):
        raise ValueError(f"mode must be 'auto', 'monolithic' or 'segmented', got {mode!r}")
    if mode == "segmented" or (
            mode == "auto" and len(pcm) > AUTO_SEGMENT_SECONDS * float(fs)):
        from .segmented import decode_waveform_segmented

        return decode_waveform_segmented(pcm, fs, device=dev, config=cfg,
                                         wire=wire, lossy_retry=lossy_retry,
                                         timer=timer)
    n_raw = int(len(pcm))
    if wire_used != "float32":
        with timer.stage("host_encode_stats"):
            pcm = wire_ops.encode(pcm, wire_used)
    packed4 = pcm.dtype == np.uint8
    fs, fs_report, rate_mult = decode_rates(fs)
    decimate2 = rate_mult == 2
    unit = int(BUCKET_SECONDS * fs) * rate_mult
    n_padded = max(int(np.ceil(n_raw / unit)) * unit, unit)
    with timer.stage("build_upload"):
        if packed4:
            n_padded += n_padded % 2
            # pad with 0x88 (two zero-level nibbles) so the DC mean stays exact
            need = n_padded // 2
            if len(pcm) < need:
                pcm = np.concatenate([pcm, np.full(need - len(pcm), 0x88, np.uint8)])
        elif n_padded != n_raw:
            pcm = np.concatenate([pcm, np.zeros(n_padded - n_raw, pcm.dtype)])
        with timer.stage("program_lookup"):
            dims = EngineDims.for_waveform(n_padded // rate_mult, fs, cfg.bitrate,
                                           probe_window(cfg, fs))
            # the shape's cached program; the upload goes into its static input
            program = fused_program(engine_tables(cfg, fs, dims, decimate2), dims, fs, cfg,
                                    pcm, dev, decimate2=decimate2)
        program.load(pcm, n_raw)
    n = (n_raw + rate_mult - 1) // rate_mult
    out = program.run()
    with timer.stage("fetch"):
        with timer.stage("device_wait"):
            wait_for(out)
        host = out.cpu().numpy()  # the decode's one device-to-host transfer
    with timer.stage("host_finish"):
        res = finish_result(host, fs_report, n, fs, cfg, wire_used=wire_used)
    if lossy_retry and lossy_retry_worthy(res, n, fs, cfg):
        return decode_waveform(pcm0, fs0, device=dev, config=cfg,
                               mode="monolithic", wire="int8", timer=timer)
    return res


@profiling.entry_point
def decode_wav(path: str, timerange=(0, -1), settings: dict | None = None,
               compat: str = "strict", wire: str = "auto", *, device="cuda",
               mode: str = "auto", timer=None) -> DecodeResult:
    """Read and decode a WAV on `device` (``mode`` and ``timer`` as in
    ``decode_waveform``; the read is the stage ``read_wav``).  int16 mono
    WAVs ship raw and are conditioned (and, above 50 kHz, decimated) on the
    device; other encodings take the host conditioning path (float PCM,
    which ignores `wire`)."""
    from ..utils.wavio import read_wav, read_wav_raw16

    device = resolve_device(device)
    cfg = resolve_settings(settings, compat=compat)
    with timer.stage("read_wav"):
        raw = read_wav_raw16(path, timerange, allow_highrate=True)
        pcm, fs = raw if raw is not None else read_wav(path, timerange)
    return decode_waveform(pcm, fs, device=device, config=cfg, wire=wire, mode=mode,
                           timer=timer)
