"""Sequence-parallel decode: one waveform's time axis sharded over devices
(port of axctdprocessor_tpu.parallel.timeshard).

For very long recordings (or many long drops at once) the compute-heavy
front end (tone-power windows, the demod filter, zero-crossing extraction,
per-crossing tone probes) is cut into ``sp`` blocks of the time axis, one
per device of a ``("dp", "sp")`` mesh (``parallel.mesh``), with **halo
exchange** between neighbours:

* each block receives ``n_power`` raw samples from its right neighbour so
  its strided power windows can straddle the boundary;
* each block receives a warm-up tail of raw samples from its left
  neighbour so the filter is settled by the block start;
* each block receives a short filtered halo from the right for crossing
  detection and the per-crossing mark/space probes at the boundary.

Tone probes are computed for **every zero crossing**, not just chained bit
edges (about twice the probes, with no sequencing between blocks).  The
small chained part, the greedy bit-edge walk, then runs on the gathered
(crossing, mark, space) tables of a mesh row's drops, all at once, on the
first device of the row.

Where the JAX module writes a ``shard_map`` body with ``ppermute``,
``psum`` and ``pmax``, one Python process here calls the block body once
per place of the mesh, on that place's device.  A halo is
``Tensor.to(neighbour, non_blocking=True)`` (PyTorch orders a copy between
devices against the current streams of both); the first and last block get
zeros and nothing wraps around.  A reduction over ``sp`` is a copy of each
block's partial result to the row's first device and a sum or maximum there
**in shard order**, so it is the same on every run.  Every shard's work
stays on its device's current stream.

The tone powers are raw (``tonepower.tone_powers``: the tone kernel's
powers-only variant on the card), as the JAX path's are a plain matmul:
smoothing needs the gathered series.  A block's front end runs over the
``b`` rows of its mesh row in one pass (filter, crossings, probes at every
crossing with ``goertzel.probe_at``), as the JAX ``shard_map`` body runs over
its rows; each row is the row alone bit for bit.  Outputs match
``engine.stage1_core``'s contract, so the back half and the host finish are
shared with the batch path.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models import engine as eng
from ..models.result import DecodeResult
from ..ops import chain as chain_ops
from ..ops import goertzel, iir, tonepower
from ..utils.config import DecoderConfig
from .mesh import Mesh

WARMUP = 2048  # filter warm-up halo (the transient is under ~1k samples at 44.1 kHz)
BIG = eng.BIG


def pad_for_mesh(pcms: np.ndarray, fs: float, n_sp: int) -> np.ndarray:
    """Zero-pad (B, N) so N divides evenly into n_sp blocks of whole
    power-window strides."""
    b, n = pcms.shape
    d_pcm = int(round(fs / 25))
    unit = n_sp * d_pcm
    n_pad = int(np.ceil(n / unit)) * unit
    if n_pad == n:
        return pcms
    out = np.zeros((b, n_pad), dtype=pcms.dtype)
    out[:, :n] = pcms
    return out


def _upload_blocks(run: np.ndarray, devices: list[torch.device], block: int):
    """The ``sp`` blocks of one ``dp`` run of rows, each on its device.
    Consecutive blocks that share a device are views of one pinned upload of
    their span, so a row whose blocks all lie on one device goes up once."""
    blocks = []
    j = 0
    while j < len(devices):
        k = j + 1
        while k < len(devices) and devices[k] == devices[j]:
            k += 1
        span = eng.to_device(run[:, j * block: k * block], devices[j])
        blocks += [span[:, (i - j) * block: (i - j + 1) * block] for i in range(j, k)]
        j = k
    return blocks


def _condition_blocks(blocks: list, n_valid: dict, block: int):
    """Integer blocks of one mesh row conditioned as the whole rows are
    (``engine.condition_integer``), bit for bit: the DC mean and the peak are
    statistics of the whole row, so each block's exact sum
    (``engine.integer_row_sums``) and absolute peak go to the row's first
    device and are reduced there.  Exact sums and maxima do not depend on
    the order of the reduction, and the mean is the whole row's: the exact
    sum over the true length rounded once to float32.  The zero padding past
    ``n_valid`` adds nothing to the sum or the peak, and the tail is zeroed
    again.  Returns (the float32 blocks, the rows' mean, the rows' peak
    clamped to 1)."""
    first = blocks[0].device
    xf = [x.to(torch.float32) for x in blocks]
    sums = [eng.integer_row_sums(raw, x).to(first, non_blocking=True)
            for raw, x in zip(blocks, xf)]
    peaks = [torch.linalg.vector_norm(x, ord=math.inf, dim=-1).to(first, non_blocking=True)
             for x in xf]
    total = torch.stack(sums).sum(0)
    mean = eng.exact_mean(total, n_valid[first])
    peak = torch.stack(peaks).amax(0).clamp_(min=1.0)
    out = []
    for j, x in enumerate(xf):
        dev = x.device
        gpos = torch.arange(block, device=dev) + j * block
        m = mean.to(dev, non_blocking=True)[:, None]
        p = peak.to(dev, non_blocking=True)[:, None]
        out.append(torch.where(gpos[None, :] < n_valid[dev][:, None], (x - m) / p, 0.0))
    return out, mean, peak


def _halo(neighbour, cut, like: torch.Tensor, width: int) -> torch.Tensor:
    """`cut` of the neighbouring block's tensor on `like`'s device, or
    zeros of `width` samples at an edge of the mesh (nothing wraps)."""
    if neighbour is None:
        return torch.zeros(like.shape[:-1] + (width,), dtype=like.dtype, device=like.device)
    return neighbour[..., cut].to(like.device, non_blocking=True)


def block_powers(x_blk: torch.Tensor, right_raw: torch.Tensor, power_trig: torch.Tensor,
                 dims: eng.EngineDims) -> torch.Tensor:
    """Raw tone powers of the ``block / d_pcm`` windows that start in a
    block, given ``n_power`` raw samples of the next one: (b, n_win_blk, 3)
    for the block's (b, block) rows, one pass."""
    x_ext = torch.cat([x_blk, right_raw], dim=-1)
    return tonepower.tone_powers(x_ext, power_trig, dims.n_power, dims.d_pcm)


def filter_nfft(block: int) -> int:
    """FFT length of one block's filter: the block and its warm-up halo."""
    return iir.next_pow2(block + WARMUP)


def block_filter(x_blk: torch.Tensor, left_raw: torch.Tensor,
                 response: torch.Tensor) -> torch.Tensor:
    """The demod filter over a block, one row (block,) or the block's rows
    (b, block) in one pass, with the ``WARMUP`` raw samples before each
    (overlap-save: the warm-up absorbs both the filter's ring-in and the
    circular wrap-around); `response` is the SOS cascade's at
    ``filter_nfft(block)`` points.  A row is filtered alike in any batch
    and alone (``engine.apply_response``)."""
    block = x_blk.shape[-1]
    x_warm = torch.cat([left_raw, x_blk], dim=-1)
    filt = eng.apply_response(x_warm, response, filter_nfft(block))
    return filt[..., WARMUP: WARMUP + block].to(x_blk.dtype)


def block_crossings(filt: torch.Tensor, right_f: torch.Tensor, n_valid, sp_i: int,
                    bit_trig: torch.Tensor, dims: eng.EngineDims, fs: float,
                    bit_inset: int, edge_pad: int, max_cross_blk: int):
    """The zero crossings of a filtered block, one row (block,) or the
    block's rows (b, block) with (b,) `n_valid`, in one pass (the crossing
    between a block's last sample and the next block's first belongs to it),
    and the mark and space powers at every one of them, given ``cross_halo``
    filtered samples of the next block.  Returns (global positions int64
    (..., max_cross_blk), then ``BIG``; mark powers; space powers; the
    truncation flags)."""
    block = filt.shape[-1]
    f_ext = torch.cat([filt, right_f], dim=-1)
    pos, cnt, rovf = eng.find_crossings(f_ext, block, sp_i * block, n_valid, edge_pad,
                                        max_cross_blk, fs)
    probes = goertzel.probe_at(f_ext, torch.clamp(pos, 0, block - 1) + bit_inset,
                               dims.npcm, bit_trig)
    gpos = torch.where(pos < BIG, pos + sp_i * block, BIG)
    ovf = (cnt > max_cross_blk).to(torch.int32) | rovf
    return gpos, probes[..., 0], probes[..., 1], ovf


def _sharded_frontend(blocks: list, n_valid: dict, tables: dict, dims: eng.EngineDims,
                      fs: float, bit_inset: int, edge_pad: int) -> list:
    """The front end over one mesh row: `blocks` are the ``sp`` blocks of the
    row's (b, N) drops, each on its device (integer blocks are conditioned
    first); `n_valid` and `tables` map each device of the row to the true
    lengths and to the constant tables there (``power_trig``, ``bit_trig``
    and ``response``, the filter's at ``filter_nfft(block)`` points).

    Returns per block (powers (b, n_win_blk, 3), gpos (b, max_cross_blk),
    mark and space powers alike, overflow (b,)), on the block's device: what
    the JAX module's ``shard_map`` body returns per shard."""
    n_sp = len(blocks)
    block = blocks[0].shape[-1]
    cross_halo = dims.npcm + bit_inset + 1
    # crossing capacity is duration-based (ops.chain.CROSSINGS_PER_SECOND),
    # as the bound EngineDims.for_waveform uses for the whole waveform
    max_cross_blk = max(int(block / fs * chain_ops.CROSSINGS_PER_SECOND) + 256, 1024)
    if not blocks[0].is_floating_point():
        blocks, _, _ = _condition_blocks(blocks, n_valid, block)

    def neighbour(seq, j):
        return seq[j] if 0 <= j < n_sp else None

    powers, filt = [], []
    for j, x in enumerate(blocks):
        t = tables[x.device]
        right_raw = _halo(neighbour(blocks, j + 1), slice(0, dims.n_power), x, dims.n_power)
        powers.append(block_powers(x, right_raw, t["power_trig"], dims))
        left_raw = _halo(neighbour(blocks, j - 1), slice(block - WARMUP, block), x, WARMUP)
        filt.append(block_filter(x, left_raw, t["response"]))

    out = []
    for j, x in enumerate(blocks):
        t = tables[x.device]
        right_f = _halo(neighbour(filt, j + 1), slice(0, cross_halo), filt[j], cross_halo)
        gpos, p1, p2, ovf = block_crossings(filt[j], right_f, n_valid[x.device], j,
                                            t["bit_trig"], dims, fs, bit_inset, edge_pad,
                                            max_cross_blk)
        out.append((powers[j], gpos, p1, p2, ovf))
    return out


def sharded_stage1(pcms, fs: float, cfg: DecoderConfig, mesh: Mesh, lengths=None):
    """Time+data sharded stage 1 over a ("dp", "sp") mesh.

    `pcms` is (B, N) with N divisible by n_sp * d_pcm (see pad_for_mesh) and
    B by the ``dp`` size.  Integer batches ship raw (half the host-to-device
    bytes) and are conditioned on the devices with row statistics reduced
    over ``sp``.  Returns (one ``engine.stage1_core`` output dict per ``dp``
    place, batched over its rows, on the first device of its mesh row; the
    decode's ``EngineDims``)."""
    fs = float(fs)
    pcms = np.asarray(pcms)
    b, n = pcms.shape
    n_dp, n_sp = mesh.shape["dp"], mesh.shape["sp"]
    dims = eng.EngineDims.for_waveform(n, fs, cfg.bitrate, eng.probe_window(cfg, fs))
    if b % n_dp:
        raise ValueError(f"{b} rows over dp = {n_dp}: pad with batch.pad_to_multiple first")
    if n % (n_sp * dims.d_pcm):
        raise ValueError(f"{n} samples over sp = {n_sp}: pad with pad_for_mesh first")
    lengths = np.full(b, n, np.int64) if lengths is None else np.asarray(lengths, np.int64)
    host_tables = eng.engine_tables(cfg, fs, dims)
    per, block = b // n_dp, n // n_sp

    stage1 = []
    with torch.inference_mode():
        for i in range(n_dp):
            devices = mesh.devices_along("sp", dp=i)
            first = devices[0]
            tables, n_valid = {}, {}
            for dev in dict.fromkeys(devices):  # once per distinct device of the row
                tables[dev] = dict(
                    power_trig=eng.to_device(host_tables["power_trig"], dev),
                    bit_trig=eng.to_device(host_tables["bit_trig"], dev),
                    response=eng.sos_response_on_device(
                        eng.to_device(host_tables["sos"], dev), filter_nfft(block)))
                n_valid[dev] = eng.to_device(lengths[i * per: (i + 1) * per], dev)
            blocks = _upload_blocks(pcms[i * per: (i + 1) * per], devices, block)
            shards = _sharded_frontend(blocks, n_valid, tables, dims, fs, cfg.bit_inset, 100)
            # all-gather along "sp" onto the row's first device, in shard order
            powers, gpos, p1, p2, ovf = (
                torch.cat([t.to(first, non_blocking=True) for t in col], dim=1)
                for col in zip(*[(pw, g, a, c, o[:, None]) for pw, g, a, c, o in shards]))
            stage1.append(_assemble_rows(powers, gpos, p1, p2, ovf, dims, fs, cfg))
    return stage1, dims


def _assemble_rows(powers, gpos, p1, p2, ovf, dims: eng.EngineDims, fs: float,
                   cfg: DecoderConfig) -> dict:
    """From the gathered per-block outputs of a ``dp`` place's rows to its
    stage-1 dict: the blocks' crossing tables into global order (a stable
    sort: ``BIG`` fills go last), the six-tap box mean and the two log10
    ratios on the gathered power series, and the greedy bit-edge chain on
    the rows' crossing tables, all rows in one call (one walk launch on the
    card)."""
    gpos_s, order = torch.sort(gpos, dim=1, stable=True)
    p1_s = torch.gather(p1, 1, order)
    p2_s = torch.gather(p2, 1, order)
    n_cross = (gpos_s < BIG).sum(dim=1)
    r400, r7500 = tonepower.ratios_from_powers(powers)

    edge_idx, n_edges = chain_ops.enumerate_bit_edges(
        gpos_s, n_cross, fs, float(cfg.bitrate), dims.max_edges)
    safe = torch.clamp(edge_idx, 0, gpos_s.shape[1] - 1)
    return dict(r400=r400, r7500=r7500, edge_samples=torch.gather(gpos_s, 1, safe),
                n_edges=n_edges, s1=torch.gather(p1_s, 1, safe),
                s2=torch.gather(p2_s, 1, safe), overflow=ovf.amax(dim=1))


def decode_batch_timesharded(pcms, fs, config: DecoderConfig | None = None, *,
                             mesh: Mesh, lengths=None) -> list[DecodeResult]:
    """Full batched decode with the time-sharded front end.

    DP x SP mesh: drops cut over "dp", each drop's waveform over "sp"; the
    back half runs per "dp" place on the first device of its mesh row (it is
    tiny next to the front end).  Integer batches stay integer through the
    host-to-device transfer (half the bytes on exactly the long-file path
    this mode exists for) and are conditioned on the devices.  The mesh
    places everything: there is no `device` argument."""
    from .batch import finish_batch, pad_to_multiple, queue_back_half_batched

    cfg = config or DecoderConfig()
    fs_report = eng.report_rate(fs)
    fs = float(fs)
    pcms = np.asarray(pcms)
    if not np.issubdtype(pcms.dtype, np.integer):
        pcms = pcms.astype(np.float32)
    if lengths is None:
        lengths = np.full(pcms.shape[0], pcms.shape[1], np.int32)
    lengths = np.asarray(lengths, np.int32)
    pcms = pad_for_mesh(pcms, fs, mesh.shape["sp"])
    b_orig = pcms.shape[0]
    n_dp = mesh.shape["dp"]
    if b_orig % n_dp:
        (pcms, lengths), _ = pad_to_multiple([pcms, lengths], n_dp)

    stage1, dims = sharded_stage1(pcms, fs, cfg, mesh, lengths=lengths)

    per = len(pcms) // n_dp
    firsts = mesh.devices_along("dp")
    runs = [lengths[i * per: (i + 1) * per] for i in range(n_dp)]
    # queue every back half before the first fetch waits for its device
    outs = [queue_back_half_batched(s1, cfg, fs, dims, run, device=dev)
            for s1, run, dev in zip(stage1, runs, firsts)]
    results = []
    for out, run in zip(outs, runs):
        results += finish_batch(out.cpu().numpy(), cfg, fs, fs_report, run)
    return results[:b_orig]
