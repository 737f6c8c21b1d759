"""Batched multi-drop decode, on one device or data-parallel over a mesh
(port of axctdprocessor_tpu.parallel.batch).

The archive path: a (B, N) batch of drops through the fused decode
(``engine.FusedDecoder`` on a batch).  The batch is conditioned as one
tensor and its tone ratios are ONE launch of the tone-ratio kernel, as the
JAX engine's vmapped Pallas kernel is one ``pallas_call`` with a batch grid
axis; the demod front end and the back half then run row by row on the
device.  ``dispatch_batch`` queues all of it without a host sync, and
behind it the batch's one device-to-host copy of the (B, L) packed matrix,
on a side stream; ``finish_dispatched`` waits for that copy alone and the
host finishes each row.  ``BatchPlan`` holds what the batches of one shape
share; ``parallel.pipeline`` runs on it too.

With a ``mesh`` (``parallel.mesh``) the rows are padded to a multiple of its
``dp`` axis and cut into ``dp`` contiguous runs, each queued on its device as
a batch of its own (one tone-ratio launch per run, its fetch behind it on
that device's side stream); drops are independent, so no device waits for
another.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import engine as eng
from ..models.result import DecodeResult
from ..ops import wire as wire_ops
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
    format, the decoder module with its tables on the device, and the side
    stream that fetches packed results (a GPU only)."""

    def __init__(self, dtype, n: int, fs, config: DecoderConfig | None, wire: str,
                 device):
        self.dev = eng.resolve_device(device)
        self.cfg = config or DecoderConfig()
        self.fs_report = float(fs) if isinstance(fs, float) else int(fs)
        self.fs = float(fs)
        if dtype == np.uint8:
            raise ValueError("pass unpacked integer rows with wire='int4'; "
                             "pre-packed nibble streams lose the sample count")
        self.integer = np.issubdtype(dtype, np.integer)
        self.wire_used = eng.resolve_wire(wire, dtype, self.dev) if self.integer else "float32"
        if self.wire_used == "int4":
            n += n % 2  # packed int4 rows carry an even sample count
        cfg = self.cfg
        dims = eng.EngineDims.for_waveform(n, self.fs, cfg.bitrate,
                                           eng.probe_window(cfg, self.fs))
        self.model = eng.FusedDecoder.from_numpy_tables(
            eng.engine_tables(cfg, self.fs, dims), dims, self.fs,
            bitrate=float(cfg.bitrate), bit_inset=cfg.bit_inset, edge_pad=100,
            device=self.dev)
        self.on_card = self.dev.type == "cuda"
        self.fetch_stream = torch.cuda.Stream(self.dev) if self.on_card else None

    def encode(self, pcms: np.ndarray) -> np.ndarray:
        """The rows as they go to the device: the wire format of integer
        rows, float32 otherwise."""
        if self.integer:
            return wire_ops.encode_rows(pcms, self.wire_used)
        return pcms.astype(np.float32)

    def start_fetch(self, out: torch.Tensor):
        """Queue the copy of a packed matrix to pinned host memory behind
        the work queued so far, on the fetch stream, so that waiting for it
        does not wait for work queued later.  Returns (host tensor, the
        copy's event); on the CPU the matrix itself and None."""
        if not self.on_card:
            return out, None
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.dev))
        self.fetch_stream.wait_event(done)
        with torch.cuda.stream(self.fetch_stream):
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self.fetch_stream)
        out.record_stream(self.fetch_stream)
        return host, copied

    def finish(self, host: torch.Tensor, copied, lengths) -> list[DecodeResult]:
        """Wait for one batch's fetch (its one host wait) and host-finish
        its rows."""
        if copied is not None:
            copied.synchronize()
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
    repeating row 0, are cut into ``dp`` contiguous runs and run k is
    queued on the k-th device along ``dp``, as a batch of its own.  `out` is
    then the list of the runs' packed matrices, each on its device."""
    pcms = np.asarray(pcms)
    lengths = row_lengths(pcms, lengths)
    if mesh is None:
        out, run = _dispatch_run(pcms, lengths, fs, config, wire, device)
        return out, ([run], len(pcms))
    b_orig = len(pcms)
    devices = mesh.devices_along("dp")
    (pcms, lengths), _ = pad_to_multiple([pcms, lengths], len(devices))
    per = len(pcms) // len(devices)
    queued = [_dispatch_run(pcms[k * per: (k + 1) * per], lengths[k * per: (k + 1) * per],
                            fs, config, wire, dev) for k, dev in enumerate(devices)]
    return [out for out, _ in queued], ([run for _, run in queued], b_orig)


def _dispatch_run(pcms: np.ndarray, lengths: np.ndarray, fs, config, wire: str, device):
    """Queue one batch on one device: (its packed matrix, (plan, fetch, lengths))."""
    plan = BatchPlan(pcms.dtype, pcms.shape[1], fs, config, wire, device)
    with torch.inference_mode():
        out = plan.model(eng.to_device(plan.encode(pcms), plan.dev),
                         eng.to_device(lengths.astype(np.int64), plan.dev))
        fetch = plan.start_fetch(out)
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


def decode_batch(pcms, fs, config: DecoderConfig | None = None, *, device="cuda",
                 mesh=None, lengths=None, wire: str = "auto",
                 lossy_retry: bool = True) -> list[DecodeResult]:
    """Decode a (B, N) batch of waveforms on `device`, or data-parallel over
    `mesh` (see :func:`dispatch_batch`); returns B results.

    Rows whose int4-wire decode comes back degenerate are decoded again at
    int8 in one batch (``lossy_retry``)."""
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
