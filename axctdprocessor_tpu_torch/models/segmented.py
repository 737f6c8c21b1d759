"""Segmented decode in PyTorch (port of axctdprocessor_tpu.models.segmented).

Stage 1 runs per ~24 s segment of one fixed shape, whatever the file's
length; each segment carries a raw left halo (the FFT filter's ring-in)
and a right halo (power-window straddle and crossing probes).  Segment
length is a whole number of power-window strides, so the global 25 Hz
window grid stays aligned across segments.  The assemble then merges the
per-segment tone powers, crossings and probe ratios and hands them to the
fused back half (``engine.back_half_core``), so a segmented decode packs
the same int32 vector as the JAX engine's.

* :class:`SegmentedDecoder` — the module: the constant tables
  (``engine.engine_tables``) are its buffers; ``segment`` decodes one
  haloed segment or a group of them in one pass, ``assemble`` finishes
  (``assemble_bucket``: over a bucket's stacked rows, those from a segment
  count on the zero segment), and ``forward`` is the whole resident decode
  over a staged stack (every segment in one pass).
* :func:`segment_program` / :func:`assemble_program` — the cached programs
  (``models.programs``) of a group shape and of an assemble bucket, the JAX
  package's ``_segment_program`` / ``_segment_program_grouped`` and
  ``_assemble_program`` / ``_assemble_program_chunked``: every per-decode
  value (extensions, body offsets, ``dc``, ``peak``, valid lengths, the
  segment count) is a static input.
* :func:`decode_waveform_segmented` — the streamed decode: each group of
  segments through the group program and into the assemble program's
  inputs, with no host sync until the one fetch.  Every wire stages the
  drop on the device whole: a lossy wire (int8, int4) encoded on the host
  first, then one upload (:func:`_stage_device`), the conditioning
  statistics of integer samples taken there (:func:`_device_stats`; int4's
  are its encoder's), and each group a strided view of the staged drop
  (``DropPlan.device_groups``; :func:`_chunk_host` is the host's cut that
  tests hold it to).
* :func:`prestage_waveform` / :class:`PrestagedDrop` — every group staged
  on the device first; ``decode()`` is then compute and one fetch.

The JAX package vmaps groups of ``GROUP`` segments into one dispatch
(``_segment_program_grouped``) and the resident decode maps that over
every staged chunk (``_resident_program``).  Here too a group is one pass
over a (G, in_len) tensor, and the prestaged ``fused`` forward one pass
over all the drop's segments: no loop over segments.  A segment decodes
bit for bit alike in a group of any size and alone (the stream decoder's
one segment per push): the FFT filters a row of a batch as the row alone
(``engine.apply_response``), the crossings are integer, and the raw tone powers
and the probes are kernels with a fixed order of sums per window and per
probe (``tonepower.tone_powers``, ``goertzel.probe_at``).  Every group of a
path has the same G rows (a drop's last group is padded, as the JAX
package's chunks are), so a path takes one group shape.

Tone powers on this path are raw and smoothed globally in the assemble, as
the JAX engine's; on the card they come from the tone kernel's powers-only
variant, on the CPU from the plain tiled version.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn

from ..ops import chain as chain_ops
from ..ops import iir, tonepower
from ..ops import wire as wire_ops
from ..utils import profiling
from ..utils.config import DecoderConfig
from . import engine as eng
from . import programs
from .result import DecodeResult

SEG_NFFT = 1 << 20          # per-segment FFT size (fixed pow2)
LEFT_HALO = 4096            # raw ring-in for the filter (transient < ~1k)
BIG = eng.BIG
GROUP = 4                   # default segments per upload
STAGE_CHUNK = 1 << 21       # samples per pinned copy of a drop staged on the device


def _seg_geometry(fs: float):
    """Segment geometry: the largest whole-stride segment whose haloed
    extension fits SEG_NFFT (~23.6 s at 44.1 kHz).  Returns (d_pcm,
    n_power, seg_len, right halo, crossing capacity per segment)."""
    d_pcm = int(round(fs / 25))
    n_power = int(fs / 10)
    right = n_power  # covers window straddle and crossing-probe lookahead
    strides = (SEG_NFFT - LEFT_HALO - right) // d_pcm
    seg_len = strides * d_pcm
    c_seg = max(int(seg_len / fs * chain_ops.CROSSINGS_PER_SECOND) + 256,
                1024)
    return d_pcm, n_power, seg_len, right, c_seg


def _bucket_count(k: int) -> int:
    """Smallest m * 2^e >= k with mantissa m in {4..7} (exact below 4): the
    assemble's segment count, padded with the shared zero segment, takes
    O(log) sizes with <= 25% padding."""
    if k <= 4:
        return max(k, 1)
    e = 0
    while (k + (1 << e) - 1) >> e > 7:
        e += 1
    return ((k + (1 << e) - 1) >> e) << e


class SegmentedDecoder(nn.Module):
    """Per-segment stage 1 and the assemble for one configuration and
    decode rate ``fs`` (post-decimation; ``decim2`` segments arrive at
    twice it).  Its buffers are ``engine.engine_tables``, the numpy arrays
    the JAX programs get."""

    def __init__(self, fs: float, npcm: int, bitrate: float, bit_inset: int,
                 edge_pad: int = 100, decim2: bool = False):
        super().__init__()
        self.fs, self.npcm, self.bitrate = float(fs), int(npcm), float(bitrate)
        self.bit_inset, self.edge_pad, self.decim2 = int(bit_inset), int(edge_pad), bool(decim2)
        (self.d_pcm, self.n_power, self.seg_len, self.right,
         self.c_seg) = _seg_geometry(self.fs)
        self.raw_mult = 2 if decim2 else 1
        self.ext_len = LEFT_HALO + self.seg_len + self.right
        self.in_len = self.ext_len * self.raw_mult
        self.nfft = iir.next_pow2(self.ext_len)
        self._zero = None

    @classmethod
    def from_config(cls, cfg: DecoderConfig, fs: float, decim2: bool,
                    device) -> "SegmentedDecoder":
        npcm, tables, _ = _module_tables(cfg, fs, decim2)
        m = cls(fs, npcm, cfg.bitrate, cfg.bit_inset, eng.EDGE_PAD, decim2)
        eng.register_tables(m, tables, decim2, torch.device(device))
        return m

    def segment(self, ext: torch.Tensor, k_off, dc: torch.Tensor,
                peak: torch.Tensor, n_valid):
        """Stage 1 of one haloed segment extension (in_len,) or of a group
        (G, in_len) in one pass (raw rate; packed int4 bytes, integer or float
        PCM), whose bodies start at decode-rate samples `k_off` (an int, or
        a (G,) tensor), with `n_valid` the raw valid length of the file (an
        int, or a 0-d int64 tensor: the programs' static input; the masks
        are integer comparisons either way).
        Returns (powers (strides, 3), global crossing positions int64[c_seg]
        then BIG, probe ratios, the true crossing count, the row-overflow
        flag), each with a leading G for a group."""
        x, filt = self.filter_segment(ext, k_off, dc, peak, n_valid)
        return self.probe_segment(x, filt, k_off, n_valid)

    @staticmethod
    def _per_row(k_off, lead: int):
        """`k_off` broadcast against a segment's samples: a scalar, or one
        offset per row of a group."""
        return k_off[:, None] if isinstance(k_off, torch.Tensor) and lead else k_off

    def filter_segment(self, ext: torch.Tensor, k_off, dc: torch.Tensor,
                       peak: torch.Tensor, n_valid):
        """Conditioning ``(x - dc) / peak`` (a true division: `dc` and `peak`
        are device tensors) masked to the valid samples, the optional
        decimation, and the FFT filter, over one extension or a group's rows.
        Returns (conditioned decode-rate extension, filtered extension)."""
        rm = self.raw_mult
        if ext.dtype == torch.uint8:
            x = eng.unpack_int4(ext, self.in_len).to(torch.float32)
        else:
            x = ext.to(torch.float32)
        k = self._per_row(k_off, ext.dim() - 1)
        gpos_raw = torch.arange(self.in_len, device=x.device) + rm * (k - LEFT_HALO)
        x = torch.where((gpos_raw >= 0) & (gpos_raw < n_valid), (x - dc) / peak, 0.0)
        if self.decim2:  # the halos absorb the zero-phase filter's ring
            nv_dec = (n_valid + rm - 1) // rm
            x = eng.zero_phase_decimate2(x, self.decim_sos, iir.next_pow2(self.in_len))
            gpos = torch.arange(self.ext_len, device=x.device) + (k - LEFT_HALO)
            x = torch.where((gpos >= 0) & (gpos < nv_dec), x, 0.0)
        return x, eng.fft_filter(x, self.sos, self.nfft)[..., : self.ext_len]

    def probe_segment(self, x: torch.Tensor, filt: torch.Tensor, k_off, n_valid):
        """Raw tone powers on the global grid (smoothing is global, in the
        assemble), crossings and their probe ratios, from ``filter_segment``'s
        outputs (one extension or a group's rows)."""
        nv_dec = (n_valid + self.raw_mult - 1) // self.raw_mult
        # exactly seg_len / d_pcm windows
        body = x[..., LEFT_HALO: LEFT_HALO + self.seg_len + self.right]
        powers = tonepower.tone_powers(body, self.power_trig, self.n_power, self.d_pcm)
        fbody = filt[..., LEFT_HALO:]
        pos, cnt, rovf = eng.find_crossings(fbody, self.seg_len, k_off, nv_dec,
                                            self.edge_pad, self.c_seg, self.fs)
        c0 = eng.probe_ratio(fbody, torch.clamp(pos, 0, self.seg_len - 1) + self.bit_inset,
                             self.npcm, self.bit_trig)
        gpos = torch.where(pos < BIG, pos + self._per_row(k_off, x.dim() - 1), BIG)
        return powers, gpos, c0, cnt, rovf

    def _offsets(self, first: int, rows: int, dev) -> torch.Tensor:
        """Body offsets of `rows` consecutive segments from segment `first`,
        made on the device (no host copy)."""
        return (torch.arange(rows, device=dev) + first) * self.seg_len

    def zero_segment(self):
        """The shared padding segment: nothing valid, so zero powers, no
        crossings, zero probe ratios."""
        if self._zero is None:
            dev = self.sos.device
            self._zero = self.segment(
                torch.zeros(self.in_len, device=dev), 0,
                torch.zeros((), device=dev), torch.ones((), device=dev), 0)
        return self._zero

    def assemble(self, outs: list, n_valid: torch.Tensor,
                 dims: eng.EngineDims) -> torch.Tensor:
        """Stage-1 outputs in time order -> the packed int32 vector: each
        item one segment's (``segment`` of one extension) or a group's
        (leading G).  Pads with the zero segment up to the bucket ``dims.n
        // seg_len`` and hands the stacked rows to :meth:`assemble_stacked`.
        `n_valid` is the decode-rate length."""
        outs = [o if o[0].dim() == 3 else tuple(t[None] for t in o) for o in outs]
        pad = dims.n // self.seg_len - sum(o[0].shape[0] for o in outs)
        outs += [tuple(t[None] for t in self.zero_segment())] * pad
        return self.assemble_stacked(*(torch.cat([o[i] for o in outs]) for i in range(5)),
                                     n_valid, dims)

    def assemble_bucket(self, powers, gpos, c0, cnt, rovf, n_seg: torch.Tensor,
                        n_valid: torch.Tensor, dims: eng.EngineDims) -> torch.Tensor:
        """The assemble program's forward: the bucket's stacked segment
        outputs, of which the rows from `n_seg` (a device count) on are
        replaced by the zero segment, whatever they hold (a longer drop's
        segments from the program's previous call, a group's padding
        rows), then :meth:`assemble_stacked`."""
        live = torch.arange(powers.shape[0], device=powers.device) < n_seg
        rows = [torch.where(live.reshape((-1,) + (1,) * (t.dim() - 1)), t, z)
                for t, z in zip((powers, gpos, c0, cnt, rovf), self.zero_segment())]
        return self.assemble_stacked(*rows, n_valid, dims)

    def assemble_stacked(self, powers, gpos, c0, cnt, rovf, n_valid: torch.Tensor,
                         dims: eng.EngineDims) -> torch.Tensor:
        """The bucket's stacked segment outputs (``dims.n // seg_len`` rows)
        -> the packed int32 vector: smooths the powers globally, merges the
        crossings, runs the bit-edge chain and the back half."""
        r400, r7500 = tonepower.ratios_from_powers(powers.reshape(-1, powers.shape[-1]))

        # Ragged merge, written as a gather: the JAX engine writes each
        # segment's c_seg slots at coff[k] in turn, a later write covering
        # the earlier one's tail.  Slot j holds the last segment k with
        # coff[k] <= j whose write reached it (a scatter with overlapping
        # slots has no defined winner on CUDA).
        k_seg, c_seg = gpos.shape
        m = k_seg * c_seg
        cnts = torch.clamp(cnt, max=c_seg)
        coff = torch.cumsum(cnts, 0) - cnts
        n_cross = coff[-1] + cnts[-1]
        j = torch.arange(m, device=gpos.device)
        k = torch.searchsorted(coff, j, right=True) - 1
        off = j - coff[k]
        covered = off < c_seg
        src = k * c_seg + torch.clamp(off, max=c_seg - 1)
        g_s = torch.where(covered & (j < n_cross), gpos.reshape(-1)[src], BIG)
        c0_s = torch.where(covered, c0.reshape(-1)[src], 0.0)

        edge_idx, n_edges = chain_ops.enumerate_bit_edges(
            g_s, n_cross, self.fs, self.bitrate, dims.max_edges)
        safe = torch.clamp(edge_idx, 0, m - 1)
        ovf0 = ((cnt > c_seg).to(torch.int32) | rovf).max()
        return eng.back_half_core(
            r400, r7500, g_s[safe], n_edges, c0_s[safe], n_valid, self.trig_i,
            self.trig_f, self.hdr_rel, self.calib_off, dims, self.fs,
            overflow0=ovf0)

    def forward(self, ext_all: torch.Tensor, n_seg: int, dc, peak, nv_raw: int,
                nv_dec: torch.Tensor, dims: eng.EngineDims) -> torch.Tensor:
        """The whole resident decode in one forward over the staged
        (n_chunk, G, buf_len) stack, whose first `n_seg` rows in order are
        the segments: stage 1 of every segment in one pass (the last group's
        padding rows are not read), then the assemble."""
        rows = ext_all.reshape(-1, ext_all.shape[-1])[:n_seg]
        return self.assemble([self.segment(rows, self._offsets(0, n_seg, rows.device), dc,
                                           peak, nv_raw)], nv_dec, dims)


_TABLES: dict = {}  # (repr(cfg), fs, decim2) -> (npcm, tables, their program key)
_TABLES_KEPT = 16


def _module_tables(cfg: DecoderConfig, fs: float, decim2: bool) -> tuple:
    """The probe window, the numpy tables of a segmented module and their
    ``programs.table_key``, made once per configuration, rate and
    decimation (the JAX package's ``_engine_tables_cached``): a program
    lookup, at every decode and every streamed segment, then hashes no
    table."""
    fs = float(fs)
    key = (repr(cfg), fs, bool(decim2))
    hit = _TABLES.get(key)
    if hit is None:
        npcm = eng.probe_window(cfg, fs)
        dims = eng.EngineDims.for_waveform(_seg_geometry(fs)[2], fs, cfg.bitrate, npcm)
        tables = eng.engine_tables(cfg, fs, dims, decim2)
        if len(_TABLES) >= _TABLES_KEPT:
            _TABLES.pop(next(iter(_TABLES)))
        hit = _TABLES[key] = (npcm, tables, programs.table_key(tables))
    return hit


def segment_program(cfg: DecoderConfig, fs: float, decim2: bool, rows: int, dtype,
                    device) -> programs.Program:
    """The cached program of stage 1 over `rows` haloed segment extensions
    of wire dtype `dtype` at decode rate `fs` (the JAX package's
    ``_segment_program`` for one row, the stream's, and
    ``_segment_program_grouped`` for a group): a ``SegmentedDecoder`` with
    its tables on the device, built once.  Static inputs: the (rows,
    buf_len) extensions, their (rows,) body offsets ``k_off``, ``dc``,
    ``peak`` and the raw valid length ``n_valid``; the outputs are
    ``segment``'s five, each with a leading row axis.  ``offsets`` (on the
    program) is ``arange(rows) * seg_len`` on the device: a group's
    ``k_off`` is it plus the first body's offset."""
    dev = programs.device_key(device)
    fs = float(fs)
    npcm, _, tables_key = _module_tables(cfg, fs, decim2)
    dtype = np.dtype(dtype)
    key = ("segment", fs, npcm, int(cfg.bit_inset), eng.EDGE_PAD, bool(decim2), int(rows),
           dtype.str, str(dev), tables_key)

    def build():
        model = SegmentedDecoder.from_config(cfg, fs, decim2, dev)
        pk = 2 if dtype == np.uint8 else 1
        ext = torch.empty((rows, model.in_len // pk), dtype=torch.from_numpy(
            np.empty(0, dtype)).dtype, device=dev)
        k_off = torch.zeros(rows, dtype=torch.int64, device=dev)
        dc, peak = torch.zeros((), device=dev), torch.ones((), device=dev)
        n_valid = torch.zeros((), dtype=torch.int64, device=dev)
        program = programs.Program(model.segment, (ext, k_off, dc, peak, n_valid), dev,
                                   module=model)
        program.offsets = model._offsets(0, rows, dev)
        return program

    return programs.cached(key, build)


def assemble_program(cfg: DecoderConfig, fs: float, decim2: bool, k_seg: int,
                     device) -> programs.Program:
    """The cached program of the assemble over a bucket of `k_seg` segments
    (``_bucket_count``, which fixes ``dims``): the JAX package's
    ``_assemble_program`` / ``_assemble_program_chunked``.  Static inputs:
    the stacked segment outputs (powers (k_seg, strides, 3), crossing
    positions and probe ratios (k_seg, c_seg), counts and row-overflow
    flags (k_seg,)), the count of live rows ``n_seg`` and the decode-rate
    valid length; the rows from ``n_seg`` on are the zero segment inside the
    forward (``SegmentedDecoder.assemble_bucket``), whatever a caller left
    there.  The ragged merge, the bit-edge chain and the back half run
    inside the graph."""
    dev = programs.device_key(device)
    fs = float(fs)
    npcm, _, tables_key = _module_tables(cfg, fs, decim2)
    dims = eng.EngineDims.for_waveform(k_seg * _seg_geometry(fs)[2], fs, cfg.bitrate, npcm)
    key = ("assemble", int(k_seg), dims, fs, float(cfg.bitrate), bool(decim2), str(dev),
           tables_key)

    def build():
        model = SegmentedDecoder.from_config(cfg, fs, decim2, dev)
        with torch.inference_mode():
            rows = tuple(torch.zeros((k_seg,) + z.shape, dtype=z.dtype, device=dev)
                         for z in model.zero_segment())
        counts = tuple(torch.zeros((), dtype=torch.int64, device=dev) for _ in range(2))
        return programs.Program(functools.partial(model.assemble_bucket, dims=dims),
                                rows + counts, dev, module=model)

    return programs.cached(key, build)


@dataclasses.dataclass
class DropPlan:
    """Plan of one segmented decode: the wire-encoded PCM on the host and
    staged on the device, its conditioning statistics, the segment/group
    geometry, and the module with its tables on the device (the group
    program's)."""

    cfg: DecoderConfig
    fs: float
    fs_report: float | int
    raw_mult: int
    n_raw: int
    n: int                 # decode-rate length
    wire: str
    pcm: np.ndarray        # encoded samples (packed bytes for int4)
    n_seg: int
    group: int
    dims: eng.EngineDims
    model: SegmentedDecoder
    dc: torch.Tensor
    peak: torch.Tensor
    nv_dec: torch.Tensor
    pk: int                # samples per byte (2 for int4)
    fill: int              # the wire's zero: two zero-level nibbles (0x88) a byte of int4
    buf_len: int
    decim2: bool
    staged: torch.Tensor   # the encoded drop on the device, haloed with the wire's zero

    @property
    def n_chunk(self) -> int:
        return -(-self.n_seg // self.group)

    def device_groups(self) -> list:
        """Each group's G rows of the staged drop, strided views of
        ``staged``: row k is segment k's haloed extension, the wire's zero
        past the drop's ends, ``_chunk_host``'s row byte for byte.  The last
        group's rows past the last segment are the wire's zero (its tail
        would be their left halo), as ``_chunk_host`` fills them."""
        g = self.group
        rows = self.staged.unfold(0, self.buf_len,
                                  self.model.seg_len * self.raw_mult // self.pk)
        groups = [rows[j * g: (j + 1) * g] for j in range(self.n_chunk)]
        pad = self.n_chunk * g - self.n_seg
        if pad:
            groups[-1] = torch.cat([groups[-1], rows.new_full((pad, self.buf_len), self.fill)])
        return groups

    def group_programs(self) -> tuple:
        """The cached group and assemble programs of this drop's shapes
        (looked up at each decode: an evicted program is built again)."""
        dev = self.nv_dec.device
        with profiling.span("program_lookup"):
            seg = segment_program(self.cfg, self.fs, self.decim2, self.group, self.pcm.dtype,
                                  dev)
            with programs.pinned(seg):  # the second lookup may evict
                return seg, assemble_program(self.cfg, self.fs, self.decim2,
                                             _bucket_count(self.n_seg), dev)


def _encode_lossy(pcm: np.ndarray, wire: str) -> tuple:
    """A lossy wire's encoding on the host: (samples, None) for int8, whose
    statistics are taken on the device; (packed bytes, (dc, peak)) for int4,
    with its encoder's statistics (the C encoder's closed-form ``dc`` and
    ``peak``, see ``wire.ChunkedInt4Encoder``, run over the whole drop;
    without the C library the one-shot encoder's)."""
    if wire == "int8":
        return wire_ops.encode(pcm, wire), None
    enc = wire_ops.chunked_int4_encoder(pcm)
    if enc is None:
        packed, dc, peak = wire_ops.quantize_int4_packed_stats(pcm)
        return packed, (dc, peak)
    enc.ensure(len(pcm))
    return enc.packed, (enc.dc, enc.peak)


def _plan_waveform(pcm, fs, config, wire, timer, device, group) -> DropPlan:
    """Resolve the wire, fix the geometry, stage the drop and take its
    conditioning statistics, and take the module from the cached group
    program (tables uploaded once per shape).  Every wire is staged whole
    inside the span ``stage_device``: a lossy wire (int8, int4) is first
    encoded on the host (``host_encode_stats``), then the drop is uploaded
    once (``build_upload``), then its statistics are taken
    (``host_encode_stats``): on the device for integer samples, int4's from
    its encoder, 0 and 1 for float input."""
    dev = eng.resolve_device(device)
    cfg = config or DecoderConfig()
    pcm, w = wire_ops.intake(pcm, wire, dev)
    if group < 1:
        raise ValueError(f"group must be >= 1, got {group}")
    # >50 kHz input decimates by 2 on the device, per segment
    fs, fs_report, raw_mult = eng.decode_rates(fs)
    decim2 = raw_mult == 2
    n_raw = int(len(pcm))
    n = (n_raw + raw_mult - 1) // raw_mult
    _, _, seg_len, right, _ = _seg_geometry(fs)
    ext_len = LEFT_HALO + seg_len + right
    n_seg = max(-(-n // seg_len), 1)
    if w == "int4" and (seg_len % 2 or ext_len % 2):
        w = "int8"  # packed slicing needs even segment boundaries
    pk, fill = (2, 0x88) if w == "int4" else (1, 0)

    def scalar(v, dtype):
        return torch.full((), v, dtype=dtype, device=dev)

    stats = None
    with timer.stage("stage_device"):
        if w in ("int8", "int4"):
            with timer.stage("host_encode_stats"):
                pcm, stats = _encode_lossy(pcm, w)
        with timer.stage("build_upload"):
            staged = _stage_device(pcm, (LEFT_HALO + n_seg * seg_len + right) * raw_mult // pk,
                                   LEFT_HALO * raw_mult // pk, fill, dev)
        with timer.stage("host_encode_stats"):
            if w == "float32":
                dc, peak = scalar(0.0, torch.float32), scalar(1.0, torch.float32)
            elif stats is not None:
                dc, peak = (scalar(float(np.float32(v)), torch.float32) for v in stats)
            else:
                dc, peak = _device_stats(staged, n_raw)

    dims = eng.EngineDims.for_waveform(_bucket_count(n_seg) * seg_len, fs,
                                       cfg.bitrate, eng.probe_window(cfg, fs))

    with timer.stage("program_lookup"):
        model = segment_program(cfg, fs, decim2, int(group), pcm.dtype, dev).module
    return DropPlan(
        cfg=cfg, fs=fs, fs_report=fs_report, raw_mult=raw_mult, n_raw=n_raw,
        n=n, wire=w, pcm=pcm, n_seg=n_seg, group=int(group), dims=dims,
        model=model, dc=dc, peak=peak, nv_dec=scalar(n, torch.int64), pk=pk, fill=fill,
        buf_len=ext_len * raw_mult // pk, decim2=decim2, staged=staged)


def _stage_device(pcm: np.ndarray, length: int, at: int, fill: int,
                  dev: torch.device) -> torch.Tensor:
    """The drop's encoded samples, once, into a device buffer of `length`
    elements filled with `fill` (the wire's zero) at offset `at` (the span
    ``pin_upload``).  On a GPU they pass through one pinned buffer (the
    caching host allocator's, reused from drop to drop once its copies are
    done) a chunk at a time: each chunk's copy to the card is queued on the
    current stream, without a host sync, while the host fills the next."""
    dtype, n = torch.from_numpy(np.empty(0, pcm.dtype)).dtype, len(pcm)
    buf = torch.full((length,), fill, dtype=dtype, device=dev)
    with profiling.span("pin_upload"):
        if dev.type != "cuda":
            buf.numpy()[at: at + n] = pcm
            return buf
        pinned = torch.empty(n, dtype=dtype, pin_memory=True)
        host = pinned.numpy()
        for lo in range(0, n, STAGE_CHUNK):
            hi = min(lo + STAGE_CHUNK, n)
            host[lo:hi] = pcm[lo:hi]
            buf[at + lo: at + hi].copy_(pinned[lo:hi], non_blocking=True)
    return buf


def _device_stats(staged: torch.Tensor, n_raw: int) -> tuple:
    """``dc`` and ``peak`` of a staged integer drop (int16, int8) as 0-d
    float32 device tensors, bit for bit the host's
    ``np.float32(np.mean(pcm))`` and ``max(max, -min, 1)``: every partial
    sum of such samples is an integer below 2**53, so the int64 sum is
    numpy's float64 sum exactly; the float64 division (by a device tensor: a
    CUDA division by a host scalar multiplies by its reciprocal) rounds once
    and the float32 cast once more, as on the host.  The peak is taken in
    int64 (the type's minimum does not wrap).  The zero halos change
    neither, and nothing reads the device."""
    total = staged.sum(dtype=torch.int64).to(torch.float64)
    count = torch.full((), n_raw, dtype=torch.float64, device=staged.device)
    lo, hi = torch.aminmax(staged)
    peak = torch.maximum(hi.to(torch.int64), -lo.to(torch.int64)).clamp_(min=1)
    return (total / count).to(torch.float32), peak.to(torch.float32)


def _chunk_host(p: DropPlan, j: int) -> np.ndarray:
    """Group j's stacked haloed segment extensions, G rows, cut on the host:
    a row past the last segment holds the wire's zero (the assemble takes
    the zero segment in its place).  The reference of the cut the device
    makes (``DropPlan.device_groups``); no decode calls it."""
    rows = min(p.group, p.n_seg - j * p.group)
    exts = np.full((p.group, p.buf_len), p.fill, dtype=p.pcm.dtype)
    seg_len, rm, pk = p.model.seg_len, p.raw_mult, p.pk
    for r in range(rows):
        k = j * p.group + r
        lo = (k * seg_len - LEFT_HALO) * rm
        hi = (k * seg_len + seg_len + p.model.right) * rm
        src_lo, src_hi = max(lo, 0), min(hi, p.n_raw)
        if src_hi > src_lo:
            exts[r, (src_lo - lo) // pk: (src_hi - lo + pk - 1) // pk] = \
                p.pcm[src_lo // pk: (src_hi + pk - 1) // pk]
    return exts


def _queue_drop(p: DropPlan, seg: programs.Program, asm: programs.Program, exts) -> None:
    """The drop's per-decode values into the programs' static inputs, then,
    on the current stream, each group of `exts` (in order; device tensors
    the stream may read, or host arrays) into the group program's static
    input with its body offsets, the group program's call, and the rows of
    its outputs that fall inside the bucket copied into the assemble
    program's static inputs before its next call overwrites them."""
    seg.load_at(2, p.dc)
    seg.load_at(3, p.peak)
    seg.load_at(4, p.n_raw)
    asm.load_at(5, p.n_seg)
    asm.load_at(6, p.nv_dec)
    k_seg, seg_len = asm.inputs[0].shape[0], p.model.seg_len
    for j, ext in enumerate(exts):
        first = j * p.group
        seg.load_at(0, ext)
        with torch.inference_mode():
            torch.add(seg.offsets, first * seg_len, out=seg.inputs[1])
            outs = seg.run(clone=False)
            keep = min(p.group, k_seg - first)
            if keep > 0:
                for buf, t in zip(asm.inputs, outs):
                    buf[first: first + keep].copy_(t[:keep])


@profiling.entry_point
def decode_waveform_segmented(pcm, fs, *, device="cuda",
                              config: DecoderConfig | None = None,
                              wire: str = "auto", timer=None,
                              lossy_retry: bool = True,
                              group: int = GROUP) -> DecodeResult:
    """Decode with per-segment stage 1, `group` segments a pass, through
    the cached group and assemble programs.

    Same result contract as ``engine.decode_waveform``; integer input is
    conditioned on the device.  The drop is staged on the device whole and
    each group is a view of it (``DropPlan.device_groups``).  ``timer`` (a
    ``StageTimer``; ``utils.profiling.entry_point``) splits the wall into
    staging (``stage_device`` around ``build_upload`` and
    ``host_encode_stats``), dispatch loop, assemble, fetch (its wait
    ``device_wait`` first) and host-finish stages.  Nothing reads the device
    until the fetch.  A degenerate int4-wire decode is retried once at int8
    (``lossy_retry``)."""
    p = _plan_waveform(pcm, fs, config, wire, timer, device, group)
    groups = p.device_groups()
    seg, asm = p.group_programs()
    with programs.pinned(seg, asm):
        with timer.stage("dispatch_loop"):
            _queue_drop(p, seg, asm, groups)
        with timer.stage("assemble_dispatch"):
            out = asm.run()
    with timer.stage("fetch"):
        with timer.stage("device_wait"):
            eng.wait_for(out)
        host = out.cpu().numpy()  # the decode's one device-to-host copy
    with timer.stage("host_finish"):
        res = eng.finish_result(host, p.fs_report, p.n, p.fs, p.cfg, wire_used=p.wire)
    if lossy_retry and eng.lossy_retry_worthy(res, p.n, p.fs, p.cfg):
        return decode_waveform_segmented(pcm, fs, device=device, config=p.cfg,
                                         wire="int8", timer=timer, group=group)
    return res


class PrestagedDrop:
    """A drop staged for device-resident decode: every group already on
    the device, the tables staged.  ``decode()`` is then compute plus one
    packed-result fetch, with no upload.  ``fused`` keeps the groups as one
    (n_chunk, G, buf_len) stack decoded by one module forward
    (``SegmentedDecoder.forward``) through the drop's own program
    (``models.programs``, the JAX package's ``_resident_program``: a CUDA
    graph on a GPU from the second ``dispatch()`` on); otherwise a list of
    groups decoded group by group through the cached group and assemble
    programs, as the streamed decode runs them.  Both run the same
    computation and give equal results."""

    def __init__(self, plan: DropPlan, exts: list, fused: bool = False):
        self.plan = plan
        self.fused = fused
        if fused:
            self.ext_all = torch.stack(exts)
            # the forward takes the segment count and the valid length as
            # Python ints, which a capture freezes: they are this drop's, so
            # the program (and its graph) is the drop's, not a shared cache's
            self.program = programs.Program(
                functools.partial(plan.model, self.ext_all, plan.n_seg, plan.dc, plan.peak,
                                  plan.n_raw, plan.nv_dec, plan.dims), (), plan.nv_dec.device,
                module=plan.model)
        else:
            self.exts = exts

    def dispatch(self) -> torch.Tensor:
        """Queue the whole decode; returns the packed result on the device
        without waiting (back-to-back dispatches queue behind each other,
        each its own tensor)."""
        if self.fused:
            return self.program()
        seg, asm = self.plan.group_programs()
        with programs.pinned(seg, asm):
            _queue_drop(self.plan, seg, asm, self.exts)
            return asm.run()

    def finish(self, out: torch.Tensor) -> DecodeResult:
        """Fetch and host-finish a ``dispatch()`` output."""
        p = self.plan
        return eng.finish_result(out.cpu().numpy(), p.fs_report, p.n, p.fs,
                                 p.cfg, wire_used=p.wire)

    def decode(self) -> DecodeResult:
        return self.finish(self.dispatch())


def prestage_waveform(pcm, fs, *, device="cuda", config: DecoderConfig | None = None,
                      wire: str = "int8", fused: bool = False,
                      group: int = GROUP) -> PrestagedDrop:
    """Encode and stage ``pcm`` on the device whole, its groups views of
    it, and wait until staged.  The default wire is int8: a resident decode
    uploads nothing per decode, so a smaller wire buys nothing once
    staged."""
    p = _plan_waveform(pcm, fs, config, wire, profiling.current(), device, group)
    exts = p.device_groups()
    dev = p.nv_dec.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return PrestagedDrop(p, exts, fused=fused)
