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

Both steps run through cached programs (``models/programs.py``), the JAX
package's ``_segment_program`` and ``_assemble_program``: each segment
through the one-row segment program, whose static inputs take its
extension, body offset and valid length (``stream_tpu.py`` passes them as
device arrays too), its outputs copied into the stream's own lists; each
snapshot through the assemble program of its bucket, its rows filled from
those lists.  A stream holds the one-row program, and with ``max_duration``
its bucket's assemble program, from its constructor to its ``finalize()``
(``programs.pin``): other decodes in the process never evict them, so a
live drop never builds or captures one again.  Their bytes count against
the cache's budget like any other program's.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..utils.config import DecoderConfig
from . import engine as eng
from . import programs
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
        assemble's program and the segment program here twice each: the
        first call (the cuFFT plan of the segment FFT, the first launch of
        each kernel, the growth of the caching allocator) and the second,
        the capture of their CUDA graphs (a device sync and an emptied
        cache), are what a live receiver should not wait on mid-drop.
        Streams may run past ``max_duration``; only then do snapshots
        grow.  The programs the stream runs at every segment and snapshot
        are pinned in the cache until ``finalize()`` (or until the stream
        is collected)."""
        self.cfg = config or DecoderConfig()
        self._dev = programs.device_key(eng.resolve_device(device))
        self.fs, self._fs_report, self._raw_mult = eng.decode_rates(fs)
        self._decim2 = self._raw_mult == 2
        self._one = seg.segment_program(self.cfg, self.fs, self._decim2, 1, np.float32,
                                        self._dev)
        held = [self._one]
        programs.pin(self._one)  # before the assemble's lookup may evict
        self._model = self._one.module
        self._seg_len, self._right = self._model.seg_len, self._model.right

        # rolling raw buffer: samples [self._pend_at, self._fed)
        self._pend = np.zeros(0, np.float32)
        self._pend_at = 0
        self._fed = 0
        self._outs: list = [[] for _ in range(5)]  # per-segment device outputs, by output
        self._next_k = 0          # first segment not yet queued
        self._finalized = False
        self._final = None
        self._consumed_rows = 0

        self._pin_bucket = 0
        self._asm = None
        if max_duration is not None:
            n_seg_max = max(int(np.ceil(max_duration * self.fs / self._seg_len)), 1)
            self._pin_bucket = seg._bucket_count(n_seg_max)
            self._asm = seg.assemble_program(self.cfg, self.fs, self._decim2,
                                             self._pin_bucket, self._dev)
            programs.pin(self._asm)
            held.append(self._asm)
        self._unpin = weakref.finalize(self, programs.unpin, *held)
        if self._asm is not None:
            one, asm = self._one, self._asm
            for _ in range(max(0, 2 - one.calls)):
                one.load(0.0, 0, 0.0, 1.0, 0)  # the zero segment
                one.run(clone=False)
            for _ in range(max(0, 2 - asm.calls)):
                asm.load_at(5, 0)
                asm.load_at(6, 0)
                asm.run()

    def _assemble_program(self, k_seg: int) -> programs.Program:
        if k_seg == self._pin_bucket:
            return self._asm
        return seg.assemble_program(self.cfg, self.fs, self._decim2, k_seg, self._dev)

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
        """Segment k through the one-row segment program; its outputs are
        copied out (the program's next call overwrites them)."""
        rm = self._raw_mult
        lo = (k * self._seg_len - seg.LEFT_HALO) * rm
        ext = np.zeros((1, self._model.in_len), np.float32)
        src_lo, src_hi = max(lo, 0), min(lo + self._model.in_len, self._fed)
        if src_hi > src_lo:
            ext[0, src_lo - lo: src_hi - lo] = \
                self._pend[src_lo - self._pend_at: src_hi - self._pend_at]
        self._one.load(ext, k * self._seg_len, 0.0, 1.0, n_valid)
        with torch.inference_mode():
            for outs, t in zip(self._outs, self._one.run()):
                outs.append(t)

    # -- reading -----------------------------------------------------------

    def _assemble(self, n_seg: int, nv_dec: int) -> DecodeResult:
        """The first `n_seg` segments (those queued) through the assemble
        program of their bucket, or of the pinned one."""
        n_seg = min(n_seg, self._next_k)
        k_seg = max(seg._bucket_count(max(n_seg, 1)), self._pin_bucket)
        asm = self._assemble_program(k_seg)
        with programs.pinned(asm), torch.inference_mode():
            if n_seg:
                for buf, outs in zip(asm.inputs, self._outs):
                    torch.cat(outs[:n_seg], out=buf[:n_seg])
            asm.load_at(5, n_seg)
            asm.load_at(6, nv_dec)
            host = asm.run().cpu().numpy()
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
        self._unpin()
        return self._final
