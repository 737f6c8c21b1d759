"""Push-style streaming decode on the device over the segmented engine
(port of axctdprocessor_tpu.models.stream_tpu, ``TPUStreamDecoder``).

* ``feed()`` buffers PCM; once a segment's whole haloed extension has
  arrived, that segment's stage 1 is queued on the device (no host sync),
  and the host never touches old audio again;
* ``results()`` assembles the segments decoded so far into a full
  ``DecodeResult`` snapshot: headers, trigger state and profile rows
  re-derive from the accumulated device tables, so rows appear as
  segments complete;
* ``finalize()`` flushes the partial tail segment with true end-of-data
  masking and returns a result identical to the offline
  ``decode_waveform_segmented`` of the concatenated stream (same module,
  same inputs).

Interior segments take an effectively infinite valid length (``BIG_N``):
a segment is queued only once all of its extension is real data, so the
masks cannot bind and its outputs equal the offline decode's, which passes
the file length.  Input is float PCM from a receiver front end
(conditioning is the receiver's), fed as ``dc = 0``, ``peak = 1``; >50 kHz
feeds decimate by 2 on the device inside each segment, as offline.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.config import DecoderConfig
from . import engine as eng
from . import segmented as seg
from .result import DecodeResult

BIG_N = 2 ** 30  # "no end in sight" valid length for interior segments


class DeviceStreamDecoder:
    """Incremental AXCTD decoder: the segmented engine fed push-style on
    `device`."""

    def __init__(self, fs, config: DecoderConfig | None = None,
                 max_duration: float | None = None, *, device="cuda"):
        """``max_duration`` (seconds) pins every ``results()`` snapshot to
        one assemble size, the bucket of a stream that long, and runs that
        assemble once here.  On a GPU nothing compiles, but the first run
        of a shape pays for what a live receiver should not wait on
        mid-drop: the cuFFT plan of the segment FFT, the first launch of
        each kernel (lazy module loading) and the growth of the caching
        allocator to the largest snapshot's working set.  Streams may run
        past ``max_duration``; only then do snapshots grow."""
        self.cfg = config or DecoderConfig()
        dev = eng.resolve_device(device)
        decim2 = float(fs) > 50000.0
        self.fs = float(fs) / 2.0 if decim2 else float(fs)
        self._fs_report = (self.fs if decim2
                           else (float(fs) if isinstance(fs, float) else int(fs)))
        self._model = seg.SegmentedDecoder.from_config(self.cfg, self.fs, decim2, dev)
        self._seg_len, self._right = self._model.seg_len, self._model.right
        self._raw_mult = self._model.raw_mult
        self._zero_dc = torch.zeros((), device=dev)
        self._unit = torch.ones((), device=dev)

        # rolling raw buffer: samples [self._pend_at, self._fed)
        self._pend = np.zeros(0, np.float32)
        self._pend_at = 0
        self._fed = 0
        self._outs: list = []     # per-segment device outputs, in order
        self._next_k = 0          # first segment not yet queued
        self._finalized = False
        self._final = None
        self._consumed_rows = 0

        self._pin_bucket = 0
        if max_duration is not None:
            n_seg_max = max(int(np.ceil(max_duration * self.fs / self._seg_len)), 1)
            self._pin_bucket = seg._bucket_count(n_seg_max)
            self._assemble(0, 0)

    # -- feeding -----------------------------------------------------------

    def feed(self, samples) -> int:
        """Push a block of float PCM; queues every segment whose whole
        haloed extension is now buffered.  Returns the number of segments
        queued so far."""
        if self._finalized:
            raise RuntimeError("decoder already finalized")
        x = np.asarray(samples, np.float32).reshape(-1)
        if len(x):
            self._pend = np.concatenate([self._pend, x])
            self._fed += len(x)
        rm = self._raw_mult
        while self._fed >= ((self._next_k + 1) * self._seg_len + self._right) * rm:
            self._dispatch(self._next_k, BIG_N)
            self._next_k += 1
            # drop raw samples no later segment's left halo can reach
            keep_from = max((self._next_k * self._seg_len - seg.LEFT_HALO) * rm, 0)
            if keep_from > self._pend_at:
                self._pend = self._pend[keep_from - self._pend_at:]
                self._pend_at = keep_from
        return self._next_k

    def _dispatch(self, k: int, n_valid: int) -> None:
        rm = self._raw_mult
        lo = (k * self._seg_len - seg.LEFT_HALO) * rm
        ext = np.zeros(self._model.in_len, np.float32)
        src_lo, src_hi = max(lo, 0), min(lo + self._model.in_len, self._fed)
        if src_hi > src_lo:
            ext[src_lo - lo: src_hi - lo] = \
                self._pend[src_lo - self._pend_at: src_hi - self._pend_at]
        with torch.inference_mode():
            self._outs.append(self._model.segment(
                eng.to_device(ext, self._unit.device), k * self._seg_len,
                self._zero_dc, self._unit, n_valid))

    # -- reading -----------------------------------------------------------

    def _assemble(self, n_seg: int, nv_dec: int) -> DecodeResult:
        n_seg = max(n_seg, 1)
        n_seg_pad = max(seg._bucket_count(n_seg), self._pin_bucket)
        dims = eng.EngineDims.for_waveform(n_seg_pad * self._seg_len, self.fs,
                                           self.cfg.bitrate, self._model.npcm)
        dev = self._unit.device
        with torch.inference_mode():
            out = self._model.assemble(
                self._outs[:n_seg],
                torch.full((), nv_dec, dtype=torch.int64, device=dev), dims)
            host = out.cpu().numpy()
        return eng.finish_result(host, self._fs_report, nv_dec, self.fs, self.cfg,
                                 wire_used="float32")

    def results(self) -> DecodeResult:
        """Snapshot of everything decodable from the complete segments so
        far (one assemble over the accumulated device tables)."""
        return self._assemble(self._next_k, self._next_k * self._seg_len)

    def latest_rows(self) -> list[dict]:
        """Profile rows appended since the last call (for live display).
        Each call runs one snapshot: poll at display rate, not per feed."""
        res = self.results() if not self._finalized else self._final
        new = [
            {"time": res.time[i], "depth": res.depth[i],
             "temperature": res.temperature[i],
             "conductivity": res.conductivity[i],
             "salinity": res.salinity[i],
             "r400": res.r400[i], "r7500": res.r7500[i]}
            for i in range(self._consumed_rows, len(res.time))
        ]
        self._consumed_rows = len(res.time)
        return new

    def finalize(self) -> DecodeResult:
        """End of stream: queue the partial tail segment(s) with true
        end-of-data masking and assemble.  The result is identical to the
        offline ``decode_waveform_segmented`` of the whole stream."""
        if self._finalized:
            return self._final
        self._finalized = True
        rm = self._raw_mult
        n_raw = self._fed
        n_dec = (n_raw + rm - 1) // rm
        n_seg = max(-(-n_dec // self._seg_len), 1)
        while self._next_k < n_seg:
            self._dispatch(self._next_k, n_raw)
            self._next_k += 1
        self._final = self._assemble(n_seg, n_dec)
        return self._final
