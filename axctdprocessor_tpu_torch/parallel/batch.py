"""Batched multi-drop decode, on one device or data-parallel over a mesh
(port of axctdprocessor_tpu.parallel.batch).

The archive path: a (B, N) batch of drops through the fused decode
(``engine.FusedDecoder`` on a batch).  The batch is conditioned as one
tensor and its tone ratios are ONE launch of the tone-ratio kernel, as the
JAX engine's vmapped Pallas kernel is one ``pallas_call`` with a batch grid
axis; the demod front end and the back half then run row by row on the
device.  ``dispatch_batch`` queues all of it without a host sync, through
the cached program of the batch's shape (``models.programs``: one per
dtype, rows, width, fs, config, wire and device, the JAX package's
``_batched_fused``; a CUDA graph on a GPU from the shape's second batch
on), and behind it the batch's one device-to-host copy of the (B, L)
packed matrix, on the program's fetch stream; ``finish_dispatched`` waits
for that copy alone and the host finishes each row.  ``BatchPlan`` holds
what the batches of one shape share; ``parallel.pipeline`` runs on it too.

With a ``mesh`` (``parallel.mesh``) the rows are padded to a multiple of its
``dp`` axis and cut into ``dp`` contiguous runs, each queued on its device as
a batch of its own (one tone-ratio launch per run, its fetch behind it on
that device's side stream); drops are independent, so no device waits for
another.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..models import engine as eng
from ..models import programs
from ..models.result import DecodeResult
from ..ops import wire as wire_ops
from ..utils import profiling
from ..utils.config import DecoderConfig


def pad_to_multiple(batch_arrays: list[np.ndarray], m: int):
    """Pad every array's leading dim up to a multiple of m (repeating row 0).

    Returns (padded arrays, original batch size).  Used to satisfy mesh
    divisibility; padded rows' outputs are discarded by the caller.
    """
    b = batch_arrays[0].shape[0]
    b_pad = int(np.ceil(b / m)) * m
    if b_pad == b:
        return batch_arrays, b
    out = []
    for a in batch_arrays:
        reps = np.repeat(a[:1], b_pad - b, axis=0)
        out.append(np.concatenate([a, reps], axis=0))
    return out, b


def pad_batch(pcms: list[np.ndarray], dtype=None) -> np.ndarray:
    """Stack ragged waveforms into a zero-padded (B, N_max) batch.

    Trailing zeros are decode-neutral when each row's true length goes
    along as ``lengths``.  Integer batches keep the widest input integer
    type (conditioned on the device); others become float32."""
    n_max = max(len(p) for p in pcms)
    if dtype is None:
        if all(np.issubdtype(np.asarray(p).dtype, np.integer) for p in pcms):
            dtype = np.result_type(*[np.asarray(p).dtype for p in pcms])
        else:
            dtype = np.float32
    out = np.zeros((len(pcms), n_max), dtype=dtype)
    for i, p in enumerate(pcms):
        out[i, : len(p)] = p
    return out


def finish_batch(out_host, cfg: DecoderConfig, fs: float, fs_report, lengths,
                 wire_used: str | None = None) -> list[DecodeResult]:
    """Per-row host finish of a (B, L) packed result matrix."""
    out_host = np.asarray(out_host)
    return [eng.finish_result(out_host[i], fs_report, int(lengths[i]), fs, cfg,
                              wire_used=wire_used)
            for i in range(out_host.shape[0])]


def queue_back_half_batched(s1: dict, cfg: DecoderConfig, fs: float,
                             dims: eng.EngineDims, lengths, *, device) -> torch.Tensor:
    """Queue the device back half of an externally computed stage 1 (tensors
    on `device`) without a host sync: the (B, L) packed matrix, on `device`."""
    dev = eng.resolve_device(device)
    t = eng.engine_tables(cfg, fs, dims)
    tables = [eng.to_device(t[k], dev) for k in ("trig_i", "trig_f", "hdr_rel", "calib_off")]
    n_valid = eng.to_device(np.asarray(lengths, np.int64), dev)
    with torch.inference_mode():
        return eng.batched_back_half(s1, n_valid, *tables, dims, float(fs))


def run_back_half_batched(s1: dict, cfg: DecoderConfig, fs: float,
                          dims: eng.EngineDims, lengths, fs_report, *,
                          device) -> list[DecodeResult]:
    """Device back half and host finish for an externally computed stage 1
    (tensors on `device`): one device-to-host copy for the batch."""
    out = queue_back_half_batched(s1, cfg, fs, dims, lengths, device=device)
    return finish_batch(out.cpu().numpy(), cfg, fs, fs_report, lengths)


class BatchPlan:
    """What every batch of one (dtype, N, fs, config, wire) shares: the wire
    format and the tables; the cached program of a batch's shape
    (:meth:`program`, ``models.programs``: the module with its tables on the
    device, captured as a CUDA graph on a GPU, with a fetch stream of its
    own), and the cached programs of its two halves for callers that run
    them apart (:meth:`stage1_program`, :meth:`back_half_program`: the JAX
    package's ``_batched_stage1`` and ``_batched_back_half``,
    ``parallel.pipeline``), which share one module, ``model``."""

    def __init__(self, dtype, n: int, fs, config: DecoderConfig | None, wire: str,
                 device):
        self.dev = eng.resolve_device(device)
        self.cfg = config or DecoderConfig()
        self.fs_report = eng.report_rate(fs)
        self.fs = float(fs)
        self.wire_used = wire_ops.input_wire(dtype, wire, self.dev)
        if self.wire_used == "int4":
            n += n % 2  # packed int4 rows carry an even sample count
        cfg = self.cfg
        self.dims = eng.EngineDims.for_waveform(n, self.fs, cfg.bitrate,
                                                eng.probe_window(cfg, self.fs))
        self.tables = eng.engine_tables(cfg, self.fs, self.dims)
        self.on_card = self.dev.type == "cuda"

    @functools.cached_property
    def model(self) -> eng.FusedDecoder:
        """The decoder module, its tables on the device: the halves'
        programs are built over it."""
        return eng.FusedDecoder.from_numpy_tables(
            self.tables, self.dims, self.fs, bitrate=float(self.cfg.bitrate),
            bit_inset=self.cfg.bit_inset, edge_pad=eng.EDGE_PAD,
            device=programs.device_key(self.dev))

    @functools.cached_property
    def _tables_key(self) -> tuple:
        return programs.table_key(self.tables)

    @functools.cached_property
    def fetch_stream(self):
        """The side stream that fetches packed results (a GPU only)."""
        return torch.cuda.Stream(self.dev) if self.on_card else None

    def program(self, rows: np.ndarray):
        """The cached program of a batch of these encoded rows' shape."""
        return eng.fused_program(self.tables, self.dims, self.fs, self.cfg, rows, self.dev)

    def _half_program(self, half: str, shapes: tuple, build):
        cfg, dev = self.cfg, programs.device_key(self.dev)
        key = (half, self.dims, self.fs, shapes, str(dev), float(cfg.bitrate),
               int(cfg.bit_inset), eng.EDGE_PAD, self._tables_key)
        return programs.cached(key, lambda: build(self.model, dev))

    def stage1_program(self, x: torch.Tensor):
        """The cached program of stage 1 (``FusedDecoder.stage1``) over a
        batch of encoded rows of `x`'s dtype and shape: static inputs the
        rows and their (B,) true lengths; the output the dict of stage-1
        tensors."""
        def build(model, dev):
            return programs.Program(model.stage1, (
                torch.empty(x.shape, dtype=x.dtype, device=dev),
                torch.empty(x.shape[:-1], dtype=torch.int64, device=dev)), dev, module=model)

        return self._half_program("stage1", (str(x.dtype), tuple(x.shape)), build)

    def back_half_program(self, s1: dict):
        """The cached program of the back half (``FusedDecoder.back_half``)
        of stage-1 outputs shaped as `s1`, on this plan's device: static
        inputs a tensor for each of them and the (B,) true lengths; the
        output the (B, L) packed matrix."""
        names = tuple(s1)

        def build(model, dev):
            def forward(*ts):
                return model.back_half(dict(zip(names, ts[:-1])), ts[-1])

            rows = next(iter(s1.values())).shape[:1]
            return programs.Program(forward, tuple(
                torch.empty(t.shape, dtype=t.dtype, device=dev) for t in s1.values()) + (
                torch.empty(rows, dtype=torch.int64, device=dev),), dev, module=model)

        return self._half_program("back_half", tuple(
            (k, str(t.dtype), tuple(t.shape)) for k, t in s1.items()), build)

    def encode(self, pcms: np.ndarray) -> np.ndarray:
        """The rows as they go to the device: the wire format of integer
        rows, float32 otherwise."""
        if self.wire_used != "float32":
            return wire_ops.encode_rows(pcms, self.wire_used)
        return pcms.astype(np.float32)

    def start_fetch(self, out: torch.Tensor, stream=None):
        """Queue the copy of a packed matrix to pinned host memory behind
        the work queued so far, on `stream` (the plan's fetch stream by
        default), so that waiting for it does not wait for work queued
        later.  Returns (host tensor, the copy's event); on the CPU the
        matrix itself and None."""
        if not self.on_card:
            return out, None
        stream = stream or self.fetch_stream
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.dev))
        stream.wait_event(done)
        with torch.cuda.stream(stream):
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(stream)
        out.record_stream(stream)
        return host, copied

    def finish(self, host: torch.Tensor, copied, lengths) -> list[DecodeResult]:
        """Wait for one batch's fetch (its one host wait: the span
        ``device_wait``) and host-finish its rows (``host_finish``)."""
        with profiling.span("device_wait"):
            if copied is not None:
                copied.synchronize()
        with profiling.span("host_finish"):
            return finish_batch(host.numpy(), self.cfg, self.fs, self.fs_report,
                                lengths, wire_used=self.wire_used)


def row_lengths(pcms: np.ndarray, lengths) -> np.ndarray:
    """True samples per row; the full width where none are given."""
    if lengths is None:
        return np.full(pcms.shape[0], pcms.shape[1], np.int32)
    return np.asarray(lengths, np.int32)


def dispatch_batch(pcms, fs, config: DecoderConfig | None = None, *, device="cuda",
                   mesh=None, lengths=None, wire: str = "auto"):
    """Queue a (B, N) batch decode on `device`, and the fetch of its packed
    result behind it; returns (out, ctx) for :func:`finish_dispatched`.

    The upload is pinned and non-blocking and nothing reads the device, so
    the call returns while the device works and the caller can overlap the
    next batch's host work.  Integer rows ship as the `wire` format and
    are conditioned on the device (``"auto"`` is int16); ``lengths`` are
    the true samples per row of a zero-padded ragged batch.

    With a `mesh` the batch is placed by the mesh alone and `device` is not
    read: the rows, padded to a multiple of ``mesh.shape["dp"]`` by
    repeating row 0 (as ``pad_to_multiple`` pads them), are cut into ``dp``
    contiguous runs and run k is queued on the k-th device along ``dp``, as
    a batch of its own.  Only a run that reaches past the batch's last row
    is copied: the others are views of `pcms`.  `out` is then the list of
    the runs' packed matrices, each on its device.  Spans (a mesh only):
    ``mesh.pad`` around the copy of each padded run, ``mesh.run`` around
    each run's encode, lookup, upload, launch and queued fetch."""
    pcms = np.asarray(pcms)
    lengths = row_lengths(pcms, lengths)
    if mesh is None:
        out, run = _dispatch_run(pcms, lengths, fs, config, wire, device)
        return out, ([run], len(pcms))
    b_orig = len(pcms)
    devices = mesh.devices_along("dp")
    per = -(-b_orig // len(devices))
    queued = []
    for k, dev in enumerate(devices):
        rows = range(k * per, (k + 1) * per)
        if rows.stop <= b_orig:  # a whole run: a view of the batch
            part, part_lengths = pcms[rows.start: rows.stop], lengths[rows.start: rows.stop]
        else:  # a run past the batch's end: its own rows, then row 0 again
            with profiling.span("mesh.pad"):
                idx = [i if i < b_orig else 0 for i in rows]
                part, part_lengths = pcms[idx], lengths[idx]
        with profiling.span("mesh.run"):
            queued.append(_dispatch_run(part, part_lengths, fs, config, wire, dev))
    return [out for out, _ in queued], ([run for _, run in queued], b_orig)


def _dispatch_run(pcms: np.ndarray, lengths: np.ndarray, fs, config, wire: str, device):
    """Queue one batch on one device through the cached program of its
    shape: (its packed matrix, a clone of the program's static output that
    the next batch's replay does not touch; (plan, fetch, lengths))."""
    plan = BatchPlan(pcms.dtype, pcms.shape[1], fs, config, wire, device)
    rows = plan.encode(pcms)
    with profiling.span("program_lookup"):
        program = plan.program(rows)
    out = program(rows, lengths.astype(np.int64))
    fetch = plan.start_fetch(out, program.fetch_stream)
    return out, (plan, fetch, lengths)


def finish_dispatched(out, ctx) -> list[DecodeResult]:
    """Wait for the fetch of a ``dispatch_batch`` result (per device the
    batch's one device-to-host copy, which does not wait for batches queued
    after it), in the order of the runs, and host-finish the rows; the rows
    that padded the batch to the mesh are dropped."""
    runs, b_orig = ctx
    results = []
    for plan, fetch, lengths in runs:
        results += plan.finish(*fetch, lengths)
    return results[:b_orig]


@profiling.entry_point
def decode_batch(pcms, fs, config: DecoderConfig | None = None, *, device="cuda",
                 mesh=None, lengths=None, wire: str = "auto",
                 lossy_retry: bool = True, timer=None) -> list[DecodeResult]:
    """Decode a (B, N) batch of waveforms on `device`, or data-parallel over
    `mesh` (see :func:`dispatch_batch`); returns B results.

    Rows whose int4-wire decode comes back degenerate are decoded again at
    int8 in one batch (``lossy_retry``).  ``timer`` (a ``StageTimer``;
    ``utils.profiling.entry_point``) takes the spans below: the program's
    lookup and upload, the wait for the fetch and the host finish."""
    results = finish_dispatched(*dispatch_batch(
        pcms, fs, config=config, device=device, mesh=mesh, lengths=lengths, wire=wire))
    if lossy_retry:
        results = retry_lossy_rows(results, pcms, fs, config=config, device=device,
                                   mesh=mesh, lengths=lengths)
    return results


def redo_at_int8(rows, lengths, width: int, fs, config: DecoderConfig | None, *,
                 device, mesh=None) -> list[DecodeResult]:
    """Decode `rows` (equal-width waveforms with their true lengths) again
    at int8, in batches of `width` rows, the last padded by repeating its
    first row (the shape of a first-class int8 decode of such a batch)."""
    redone = []
    for g in range(0, len(rows), width):
        idx = list(range(g, min(g + width, len(rows))))
        pad = idx + [g] * (width - len(idx))
        redo = decode_batch(np.stack([rows[i] for i in pad]), fs, config=config,
                            device=device, mesh=mesh,
                            lengths=[int(lengths[i]) for i in pad],
                            wire="int8", lossy_retry=False)
        redone += redo[: len(idx)]
    return redone


def retry_lossy_rows(results: list[DecodeResult], pcms, fs,
                     config: DecoderConfig | None = None, *, device, mesh=None,
                     lengths=None) -> list[DecodeResult]:
    """Decode the degenerate int4-wire rows of ``results`` again at int8,
    all in one batch of the original batch size."""
    cfg = config or DecoderConfig()
    pcms = np.asarray(pcms)
    lengths = row_lengths(pcms, lengths)
    flagged = [i for i, r in enumerate(results)
               if eng.lossy_retry_worthy(r, int(lengths[i]), float(fs), cfg)]
    if not flagged:
        return results
    redo = redo_at_int8([pcms[i] for i in flagged], lengths[flagged], len(pcms), fs,
                        cfg, device=device, mesh=mesh)
    out = list(results)
    for i, r in zip(flagged, redo):
        out[i] = r
    return out
