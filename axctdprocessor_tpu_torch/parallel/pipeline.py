"""Two-stage pipeline for archive decoding, on one device or with the back
half on a second (port of axctdprocessor_tpu.parallel.pipeline).

The decode of a batch runs as its two halves, apart: stage 1
(``engine.FusedDecoder.stage1``: conditioning, ONE launch of the tone-ratio
kernel for the (B, n) batch, the demod front end) and the back half
(``FusedDecoder.back_half``: trigger, bit decisions, headers, profile).  The
JAX version places the halves on two devices, and so does ``devices=[front,
back]`` here: a second decoder holds the back half's tables on ``back``, and
each batch's stage-1 outputs are copied across without blocking before its
back half is queued there.  On one GPU both halves run on the card and what
overlaps is host work and card work:

* batch k+1's wire encode and upload run in a one-worker stager thread while
  the main thread dispatches batch k.  On a GPU the upload leaves pinned
  memory on a side stream of the stager's own (``torch.cuda.stream`` is per
  thread), and the compute stream waits on the upload's event before the
  first kernel reads the batch;
* batch k-1's packed (B, L) matrix is fetched and host-finished while batch
  k computes: an event is recorded after k-1's back half, a second side
  stream waits on it and copies the matrix into pinned memory, and the host
  waits for that copy's event only (``out.cpu()`` on the compute stream
  would wait for batch k too).

Nothing in the loop reads the device besides that one event wait per batch.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..models import engine as eng
from ..models.result import DecodeResult
from ..utils.config import DecoderConfig
from .batch import BatchPlan, redo_at_int8, row_lengths


def decode_batches_pipelined(batches, fs, config: DecoderConfig | None = None, *,
                             device="cuda", devices=None, wire: str = "auto",
                             lossy_retry: bool = True) -> list[list[DecodeResult]]:
    """Decode an iterable of (pcms, lengths) batches on `device` through the
    stage-1 / back-half pipeline.  Every batch must share (fs, shape).
    Integer batches ship as the ``wire`` format (``"auto"`` is int16); rows
    whose int4-wire decode comes back degenerate are decoded again at int8,
    grouped into full-width ``decode_batch`` calls.

    With ``devices=[front, back]`` stage 1 runs on ``front`` and the back
    half on ``back`` (a list of one is both), and `device` is not read.

    Returns one list of DecodeResults per input batch, in order.
    """
    if devices is None:
        dev = d_back = eng.resolve_device(device)
    else:
        devs = [eng.resolve_device(d) for d in devices]
        dev, d_back = devs[0], devs[1] if len(devs) > 1 else devs[0]
    batches = [(np.asarray(pcms), row_lengths(np.asarray(pcms), lengths))
               for pcms, lengths in batches]
    if not batches:
        return []
    first = batches[0][0]
    plan = BatchPlan(first.dtype, first.shape[1], fs, config, wire, dev)
    model = plan.model
    # the back half's tables, and the stream that fetches its packed matrix,
    # belong to the device that runs it
    back = plan if devices is None else BatchPlan(first.dtype, first.shape[1], fs,
                                                  config, wire, d_back)
    upload_stream = torch.cuda.Stream(dev) if plan.on_card else None

    def stage(item):
        """Encode one batch and start its upload (the stager thread)."""
        pcms, lengths = item
        host = (torch.from_numpy(np.ascontiguousarray(plan.encode(pcms))),
                torch.from_numpy(lengths.astype(np.int64)))
        if not plan.on_card:
            return host[0], host[1], None
        # the pinned blocks come from PyTorch's host allocator, which hands
        # one out again only after the copy that reads it has finished
        with torch.cuda.stream(upload_stream):
            x, nv = (t.pin_memory().to(dev, non_blocking=True) for t in host)
            ready = torch.cuda.Event()
            ready.record(upload_stream)
        return x, nv, ready

    results: list[list[DecodeResult]] = []
    inflight = []  # (pinned packed matrix, its copy's event, lengths)
    with ThreadPoolExecutor(max_workers=1) as stager, torch.inference_mode():
        staged = stager.submit(stage, batches[0])
        for bi in range(len(batches)):
            x, nv, ready = staged.result()
            staged = (stager.submit(stage, batches[bi + 1])
                      if bi + 1 < len(batches) else None)
            if ready is not None:
                compute = torch.cuda.current_stream(dev)
                compute.wait_event(ready)
                x.record_stream(compute)
                nv.record_stream(compute)
            s1 = model.stage1(x, nv)
            if back is not plan:
                # ordered against both devices' current streams by PyTorch
                s1 = {k: v.to(d_back, non_blocking=True) for k, v in s1.items()}
                nv = nv.to(d_back, non_blocking=True)
            out = back.model.back_half(s1, nv)
            inflight.append(back.start_fetch(out) + (batches[bi][1],))
            # keep one batch in flight: fetch k-1 while k computes
            if len(inflight) > 1:
                results.append(back.finish(*inflight.pop(0)))
        while inflight:
            results.append(back.finish(*inflight.pop(0)))

    if lossy_retry:
        flagged = [(bi, ri)
                   for bi, batch_res in enumerate(results)
                   for ri, r in enumerate(batch_res)
                   if eng.lossy_retry_worthy(r, int(batches[bi][1][ri]), plan.fs,
                                             plan.cfg)]
        redo = redo_at_int8([batches[bi][0][ri] for bi, ri in flagged],
                            [batches[bi][1][ri] for bi, ri in flagged],
                            first.shape[0], plan.fs_report, plan.cfg, device=dev)
        for (bi, ri), r in zip(flagged, redo):
            results[bi][ri] = r
    return results
