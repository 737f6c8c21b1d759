"""Batched multi-drop decode on one device (port of
axctdprocessor_tpu.parallel.batch).

The archive path: a (B, N) batch of drops through the fused decode
(``engine.FusedDecoder`` on a batch).  The batch is conditioned as one
tensor and its tone ratios are ONE launch of the tone-ratio kernel, as the
JAX engine's vmapped Pallas kernel is one ``pallas_call`` with a batch grid
axis; the demod front end and the back half then run row by row on the
device.  ``dispatch_batch`` queues all of it without a host sync;
``finish_dispatched`` makes the batch's one device-to-host copy of the
(B, L) packed matrix, and the host finishes each row.

Data parallelism over several GPUs (the JAX ``mesh`` argument and
``pad_to_multiple``) belongs with the time-sharded and multi-host paths.
"""

from __future__ import annotations

import numpy as np
import torch

from axctdprocessor_tpu.ops import wire as wire_ops
from axctdprocessor_tpu.utils.config import DecoderConfig

from ..models import engine as eng
from ..models.result import DecodeResult


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


def batched_back_half(s1: dict, n_valid: torch.Tensor, tables: dict,
                      dims: eng.EngineDims, fs: float) -> torch.Tensor:
    """The device back half over a batch of externally computed stage-1
    outputs (rows of ``r400``, ``r7500``, ``edge_samples``, ``n_edges``,
    mark powers ``s1``, space powers ``s2`` and, optionally,
    ``overflow``): the (B, L) packed matrix."""
    ovf0 = s1.get("overflow")
    if ovf0 is None:
        ovf0 = torch.zeros_like(s1["n_edges"], dtype=torch.int32)
    rows = []
    for b in range(n_valid.shape[0]):
        c0 = s1["s2"][b] / torch.clamp(s1["s1"][b], min=1e-30)
        rows.append(eng.back_half_core(
            s1["r400"][b], s1["r7500"][b], s1["edge_samples"][b], s1["n_edges"][b],
            c0, n_valid[b], tables["trig_i"], tables["trig_f"], tables["hdr_rel"],
            tables["calib_off"], dims, fs, overflow0=ovf0[b]))
    return torch.stack(rows)


def run_back_half_batched(s1: dict, cfg: DecoderConfig, fs: float,
                          dims: eng.EngineDims, lengths, fs_report, *,
                          device) -> list[DecodeResult]:
    """Device back half and host finish for an externally computed stage 1
    (tensors on `device`): one device-to-host copy for the batch."""
    dev = eng.resolve_device(device)
    t = eng.engine_tables(cfg, fs, dims)
    tables = {k: eng.to_device(t[k], dev) for k in ("trig_i", "trig_f", "hdr_rel", "calib_off")}
    n_valid = eng.to_device(np.asarray(lengths, np.int64), dev)
    with torch.inference_mode():
        out = batched_back_half(s1, n_valid, tables, dims, float(fs))
        host = out.cpu().numpy()
    return finish_batch(host, cfg, fs, fs_report, lengths)


def dispatch_batch(pcms, fs, config: DecoderConfig | None = None, *, device,
                   lengths=None, wire: str = "auto"):
    """Queue a (B, N) batch decode on `device`; returns (out, ctx) for
    :func:`finish_dispatched`.

    The upload is pinned and non-blocking and nothing reads the device, so
    the call returns while the device works and the caller can overlap the
    next batch's host work.  Integer rows ship as the `wire` format and
    are conditioned on the device (``"auto"`` is int16); ``lengths`` are
    the true samples per row of a zero-padded ragged batch."""
    dev = eng.resolve_device(device)
    cfg = config or DecoderConfig()
    fs_report = float(fs) if isinstance(fs, float) else int(fs)
    fs = float(fs)
    pcms = np.asarray(pcms)
    if pcms.dtype == np.uint8:
        raise ValueError("pass unpacked integer rows with wire='int4'; "
                         "pre-packed nibble streams lose the sample count")
    b, n = pcms.shape
    lengths = np.full(b, n, np.int32) if lengths is None else np.asarray(lengths, np.int32)
    if np.issubdtype(pcms.dtype, np.integer):
        wire_used = eng.resolve_wire(wire)
        pcms = wire_ops.encode_rows(pcms, wire_used)
        if pcms.dtype == np.uint8:
            n += n % 2  # packed int4 rows carry an even sample count
    else:
        wire_used = "float32"
        pcms = pcms.astype(np.float32)
    dims = eng.EngineDims.for_waveform(n, fs, cfg.bitrate, eng.probe_window(cfg, fs))
    model = eng.FusedDecoder.from_numpy_tables(
        eng.engine_tables(cfg, fs, dims), dims, fs, bitrate=float(cfg.bitrate),
        bit_inset=cfg.bit_inset, edge_pad=100, device=dev)
    with torch.inference_mode():
        out = model(eng.to_device(pcms, dev),
                    eng.to_device(lengths.astype(np.int64), dev))
    return out, (cfg, fs, fs_report, lengths, wire_used)


def finish_dispatched(out: torch.Tensor, ctx) -> list[DecodeResult]:
    """Fetch (the batch's one device-to-host copy) and host-finish a
    ``dispatch_batch`` result."""
    cfg, fs, fs_report, lengths, wire_used = ctx
    return finish_batch(out.cpu().numpy(), cfg, fs, fs_report, lengths,
                        wire_used=wire_used)


def decode_batch(pcms, fs, config: DecoderConfig | None = None, *, device,
                 lengths=None, wire: str = "auto",
                 lossy_retry: bool = True) -> list[DecodeResult]:
    """Decode a (B, N) batch of waveforms on `device`; returns B results.

    Rows whose int4-wire decode comes back degenerate are decoded again at
    int8 in one batch (``lossy_retry``)."""
    results = finish_dispatched(*dispatch_batch(
        pcms, fs, config=config, device=device, lengths=lengths, wire=wire))
    if lossy_retry:
        results = retry_lossy_rows(results, pcms, fs, config=config, device=device,
                                   lengths=lengths)
    return results


def retry_lossy_rows(results: list[DecodeResult], pcms, fs,
                     config: DecoderConfig | None = None, *, device,
                     lengths=None) -> list[DecodeResult]:
    """Decode the degenerate int4-wire rows of ``results`` again at int8.

    All flagged rows go in one batch, padded to the original batch size by
    repeating the first flagged row (the shape of a first-class int8 decode
    of this batch)."""
    cfg = config or DecoderConfig()
    pcms = np.asarray(pcms)
    b, n = pcms.shape
    lengths = np.full(b, n, np.int32) if lengths is None else np.asarray(lengths)
    flagged = [i for i, r in enumerate(results)
               if eng.lossy_retry_worthy(r, int(lengths[i]), float(fs), cfg)]
    if not flagged:
        return results
    idx = flagged + [flagged[0]] * (b - len(flagged))
    redo = decode_batch(pcms[idx], fs, config=cfg, device=device,
                        lengths=lengths[idx], wire="int8", lossy_retry=False)
    out = list(results)
    for k, i in enumerate(flagged):
        out[i] = redo[k]
    return out
