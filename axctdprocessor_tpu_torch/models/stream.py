"""Realtime / push-based streaming decode API (host).

A copy of axctdprocessor_tpu.models.stream, the same code, over the port's
``ParityDecoder``: a host decoder with no ``device=``.  The push decoder that
runs on the card is ``models.stream_device.DeviceStreamDecoder``.

The reference was "deliberately written as a streaming chunked state
machine ... so it can be transplanted into a realtime radio-receiver
frontend" (reference README.md:130, the ``keepgoing``/sleep hooks at
AXCTDprocessor.py:119,283,338) — but only ships a whole-file CLI.  This
module makes the streaming capability a real API: push PCM as it arrives
from a receiver, read out profile rows as they decode.

Semantics are exactly the parity engine's (same chunk state machine), so
``feed()``-ing a signal in arbitrary pieces and then ``finalize()``-ing
produces results identical to a whole-file decode.

Notes for live use:

* samples should be float PCM; the decoder's tone-power *ratios* are
  scale-free, so receiver gain normalization is not required (the
  whole-file path's DC/peak normalization is a file-conditioning step,
  not a decoder requirement);
* ``latest_rows()`` yields only rows appended since the previous call,
  so a UI can poll incrementally;
* processing advances in ~``refresh_rate`` (2 s) chunks, the reference's
  own realtime granularity.
"""

from __future__ import annotations

import numpy as np

from ..utils.config import DecoderConfig
from .parity_engine import ParityDecoder
from .result import DecodeResult


class AXCTDStreamDecoder:
    """Incremental AXCTD decoder for realtime PCM feeds."""

    def __init__(self, fs: float, config: DecoderConfig | None = None):
        self._engine = ParityDecoder(None, fs, config=config)
        self._consumed_rows = 0
        self._finalized = False

    @property
    def status(self) -> int:
        """-1/0 idle/searching, 1 pulse found, 2 in profile."""
        return self._engine.status

    @property
    def result(self) -> DecodeResult:
        return self._engine._snapshot()

    def feed(self, samples) -> DecodeResult:
        """Push a block of PCM samples; processes any complete chunks."""
        if self._finalized:
            raise RuntimeError("decoder already finalized")
        return self._engine.feed(np.asarray(samples, dtype=np.float64))

    def abort(self) -> DecodeResult:
        """Stop immediately (the upstream ``keepgoing`` kill-flag analog,
        AXCTDprocessor.py:119): no further processing, current results
        kept.  The decoder refuses further feeds."""
        self._finalized = True
        return self._engine._snapshot()

    def finalize(self) -> DecodeResult:
        """End of stream: flush remaining samples with end-of-file semantics."""
        self._finalized = True
        return self._engine.finalize()

    def save_checkpoint(self, path: str) -> None:
        """Snapshot the full decode state (preemption-safe resume)."""
        import pickle

        with open(path, "wb") as f:
            pickle.dump(
                {"engine": self._engine, "rows": self._consumed_rows,
                 "finalized": self._finalized}, f,
                protocol=pickle.HIGHEST_PROTOCOL)

    @classmethod
    def load_checkpoint(cls, path: str) -> "AXCTDStreamDecoder":
        import pickle

        with open(path, "rb") as f:
            state = pickle.load(f)
        obj = cls.__new__(cls)
        obj._engine = state["engine"]
        obj._consumed_rows = state["rows"]
        obj._finalized = state["finalized"]
        return obj

    def latest_rows(self) -> list[dict]:
        """Profile rows appended since the last call (for live display)."""
        res = self._engine.result
        new = []
        for i in range(self._consumed_rows, len(res.time)):
            new.append({
                "time": res.time[i],
                "depth": res.depth[i],
                "temperature": res.temperature[i],
                "conductivity": res.conductivity[i],
                "salinity": res.salinity[i],
                "r400": res.r400[i],
                "r7500": res.r7500[i],
            })
        self._consumed_rows = len(res.time)
        return new
