"""Compact host->device wire formats for raw PCM.

A copy of axctdprocessor_tpu.ops.wire: the port imports nothing of the JAX
package.  :func:`default_wire` and :func:`resolve_wire` are the port's own
(the JAX ones ask jax for its backend; these hold the card's measurement),
and every decode path resolves its wire through them;
:func:`encode` and :func:`encode_rows` take a resolved wire.  The C encoders
come from the port's own ``utils.native``.

A 600 s drop is 53 MB as int16.  This module quantizes integer PCM to int8
or noise-shaped int4 on the host (one fused pass) so the upload shrinks.

Why this is safe: every downstream consumer is invariant to an affine
amplitude scale — tone-power *ratios*, zero-crossing signs, and
mark/space power *comparisons* — and the device's integer conditioning
(engine.condition_integer) re-removes the (quantized) DC and
re-normalizes the peak.  So int8/int4 samples flow through the exact
same integer machinery as int16; the only effect is quantization noise
(~48 dB flat for int8; int4's is NOISE-SHAPED by the C encoder so the
<=1300 Hz bands the decode actually reads sit at int8-class SNR), far
below what an FSK decode at the reference's own thresholds can resolve
(the reference conditions to float64 on the host,
AXCTDprocessor.py:55-57, and then makes 2-decimal decisions on log10
power ratios).  "int16" ships samples verbatim (bit-exact with the
host-conditioned decode).
"""

from __future__ import annotations

import numpy as np

WIRE_FORMATS = ("auto", "int16", "int8", "int4")


def default_wire(device=None) -> str:
    """The wire ``"auto"`` stands for on `device`: int16, on every device
    and every path (the JAX package picks noise-shaped int4 on a TPU).

    Measured, not assumed (``chip_smoke.py`` phase 9e; NVIDIA H100 80GB
    HBM3, 700.00 W; warm walls, median of 3 taken in turns; six runs of
    the phase, on hosts of different speed).  The 600 s drop at int16 /
    int8 / int4, one run: monolithic 0.1717 / 0.2367 / 0.3863 s ([0.2143,
    0.1708, 0.1717], [0.2822, 0.1985, 0.2367], [0.3863, 0.5523, 0.3348]),
    segmented 0.3320 / 0.3641 / 0.5184 s; the 64 x 60 s archive rows through
    ``decode_batch`` 8 x 8 3.685 / 3.982 / 8.132 s (at int4 20 of the 64 rows
    collapse and are decoded again at int8).  Over the runs, against int16
    in the same run: int4 is 0.10-0.25 s slower monolithic, 0.09-0.19 s
    segmented and 2.2-2.4x on the rows, every time.  int8 is from 0.003 s
    faster to 0.070 s slower monolithic (mean +0.03 s), from 0.043 s faster
    to 0.059 s slower segmented (mean +0.003 s over five runs, the sign
    changing from run to run: its encode costs what its smaller chunks
    save), and from 0.04 s faster to 0.30 s slower on the rows: no gain
    that repeats.  A smaller wire saves under 1 ms of a 1.15 ms pinned copy
    (52.9 MB) and costs the host 20-32 ms (int8) or 135-177 ms (int4) of
    encoding per 600 s, on paths whose wall is the host queueing kernel
    launches.  So no lossy wire is the default on any path; the argument
    stays for callers who want the smaller upload.  One function holds the
    decision: a card or a host that changes the measurement changes this
    body."""
    return "int16"


def resolve_wire(wire: str, dtype, device=None) -> str:
    """Resolve a wire request against the input dtype (floats ship as they
    are, "int16" meaning no re-encoding: they arrive conditioned and are
    not renormalized on the device); ``"auto"`` is :func:`default_wire` of
    `device`.  The one place where a decode path's wire is decided; results,
    reports and manifests record the wire used."""
    if wire not in WIRE_FORMATS:
        raise ValueError(f"wire must be one of {WIRE_FORMATS}, got {wire!r}")
    if not np.issubdtype(np.dtype(dtype), np.integer):
        return "int16"
    return default_wire(device) if wire == "auto" else wire


def _widened(x: np.ndarray) -> np.ndarray:
    """Signed ints widened one step so np.abs cannot wrap at the minimum
    (np.abs(int16(-32768)) == -32768; the C quantizers compute |x| in
    int32 and would otherwise disagree with this fallback by one peak
    step, flipping values that land near rounding boundaries)."""
    if x.dtype in (np.int8, np.int16):
        return x.astype(np.int32)
    if x.dtype == np.int32:
        return x.astype(np.int64)
    return x


def quantize_int8(pcm: np.ndarray) -> np.ndarray:
    """Quantize integer PCM to int8 at the waveform's own peak.

    ``q = rint(pcm * 127/max|pcm|)`` stays within [-127, 127] by
    construction.  The sub-LSB DC offset this drops is re-estimated and
    removed by the device conditioning (mean over q), so no separate
    scale/offset needs to cross the wire.

    int16 input takes the C path (utils.native; the numpy version's 3-4
    float passes cost ~210 ms for a 600 s drop on one host core —
    a material slice of the decode wall).
    """
    pcm = np.asarray(pcm)
    if pcm.dtype == np.int8:
        return pcm
    if pcm.dtype == np.int16 and pcm.size:
        from ..utils import native

        q = native.quantize_int8_native(pcm)
        if q is not None:
            return q
    peak = float(np.max(np.abs(_widened(pcm)))) if pcm.size else 0.0
    scale = np.float32(127.0 / max(peak, 1.0))
    q = np.multiply(pcm, scale, dtype=np.float32)
    np.rint(q, out=q)
    return q.astype(np.int8)


def quantize_int8_rows(pcms: np.ndarray) -> np.ndarray:
    """Row-wise int8 quantization for a (B, N) integer batch.

    Each drop quantizes at its own peak (drops are independent; the
    device conditions per row).  Zero padding stays exactly zero.
    """
    pcms = np.asarray(pcms)
    if pcms.dtype == np.int8:
        return pcms
    if pcms.dtype == np.int16 and pcms.size:
        from ..utils import native

        if native.get_library() is not None:
            out = np.empty(pcms.shape, np.int8)
            for i in range(pcms.shape[0]):  # per row: each drop's own peak
                out[i] = native.quantize_int8_native(pcms[i])
            return out
    peaks = np.max(np.abs(_widened(pcms)), axis=1,
                   keepdims=True).astype(np.float32)
    scales = np.float32(127.0) / np.maximum(peaks, 1.0)
    q = np.multiply(pcms, scales, dtype=np.float32)
    np.rint(q, out=q)
    return q.astype(np.int8)


def quantize_int4_packed(pcm: np.ndarray) -> np.ndarray:
    """Quantize integer PCM to 4 bits and pack two samples per byte.

    Sample k lives in byte k//2 — even samples in the high nibble — as
    a [-7, 7] level + 8; an odd final sample is padded with the zero
    level.  Device-side inverse: engine.unpack_int4.

    int16 input takes the C path, which NOISE-SHAPES: first-order error
    feedback moves ~14-21 dB of the quantization noise out of the
    <=1300 Hz demod band into frequencies the decode never reads (the
    wire format and device unpack are unchanged — shaping is purely an
    encoder choice, like a dithered ADC).  The numpy fallback is the
    plain nearest-even rounding (an exact error-feedback loop cannot be
    vectorized; ~460 ms/600 s in Python loops would cost more than the
    wire saves) — slightly noisier in-band, same format."""
    pcm = np.asarray(pcm)
    if pcm.dtype == np.int16 and pcm.size:
        from ..utils import native

        q = native.quantize_int4_ns_native(pcm)
        if q is not None:
            return q
    peak = float(np.max(np.abs(_widened(pcm)))) if pcm.size else 0.0
    q = np.multiply(pcm, np.float32(7.0 / max(peak, 1.0)), dtype=np.float32)
    np.rint(q, out=q)
    q = (np.clip(q, -7, 7) + 8).astype(np.uint8)
    if len(q) % 2:
        q = np.concatenate([q, np.asarray([8], np.uint8)])
    return (q[0::2] << 4) | q[1::2]


def quantize_int4_packed_rows(pcms: np.ndarray) -> np.ndarray:
    """Row-wise packed int4 for a (B, N) integer batch (per-row peak)."""
    pcms = np.asarray(pcms)
    if pcms.dtype == np.int16 and pcms.size:
        from ..utils import native

        if native.get_library() is not None:
            out = np.empty((pcms.shape[0], (pcms.shape[1] + 1) // 2),
                           np.uint8)
            for i in range(pcms.shape[0]):  # noise-shaped per row
                out[i] = native.quantize_int4_ns_native(pcms[i])
            return out
    peaks = np.max(np.abs(_widened(pcms)), axis=1,
                   keepdims=True).astype(np.float32)
    q = np.multiply(pcms, np.float32(7.0) / np.maximum(peaks, 1.0),
                    dtype=np.float32)
    np.rint(q, out=q)
    q = (np.clip(q, -7, 7) + 8).astype(np.uint8)
    if q.shape[1] % 2:
        pad = np.full((q.shape[0], 1), 8, np.uint8)
        q = np.concatenate([q, pad], axis=1)
    return (q[:, 0::2] << 4) | q[:, 1::2]


# per-byte lookup tables for int4_stats: nibble-value sum (hi+lo) and
# max nibble magnitude of each possible packed byte
_BYTE = np.arange(256)
_INT4_SUM_LUT = ((_BYTE >> 4) + (_BYTE & 15) - 16).astype(np.int16)
_INT4_MAX_LUT = np.maximum(np.abs((_BYTE >> 4) - 8),
                           np.abs((_BYTE & 15) - 8)).astype(np.uint8)


def quantize_int4_packed_stats(pcm: np.ndarray):
    """(packed, dc, peak) for the int4 wire in ONE pass.

    The C encoder accumulates the emitted-level sum and max magnitude
    inside its quantization loop, so the segmented decoder's device-
    conditioning statistics come for free; the fallback packs first and
    reads the stats back through the int4_stats LUTs."""
    pcm = np.asarray(pcm)
    if pcm.dtype == np.int16 and pcm.size:
        from ..utils import native

        r = native.quantize_int4_ns_stats_native(pcm)
        if r is not None:
            return r
    packed = quantize_int4_packed(pcm)
    return (packed, *int4_stats(packed, len(pcm)))


class ChunkedInt4Encoder:
    """Incremental noise-shaped int4 encoder over the C chunk API.

    Quantizes on demand ahead of an upload cursor so the first
    host->device segment transfer starts after ~6 ms of encoding instead
    of after the whole ~140 ms waveform pass; the remaining chunks run
    under the (IO-bound) wire drain.  The concatenated output is
    byte-identical to one whole-waveform ``quantize_int4_packed`` call.

    Conditioning stats come closed-form from one fast raw sum/peak pass:
    the error-feedback loop's noise transfer function has a zero at DC,
    so the emitted-level mean equals ``raw_mean * scale`` up to the
    final carried error / n (< 1e-7 steps at waveform sizes), and the
    scale maps the raw peak to the full-scale level by construction
    (``peak = 7``).  Downstream is affine-invariant, so the sub-LSB
    closed-form-vs-exact difference is far below decode resolution.
    """

    def __init__(self, pcm: np.ndarray, lib):
        import ctypes

        self._ct = ctypes
        self.pcm = np.ascontiguousarray(pcm)
        self.n = len(pcm)
        self._lib = lib
        s = ctypes.c_int64()
        p = ctypes.c_int32()
        lib.axctd_sum_peak_int16(self.pcm, self.n, ctypes.byref(s),
                                 ctypes.byref(p))
        self.scale = np.float32(7.0 / float(p.value))
        self.dc = float(s.value) * float(self.scale) / max(self.n, 1)
        self.peak = 7.0
        self.packed = np.empty((self.n + 1) // 2, np.uint8)
        self._e = ctypes.c_float(0.0)
        self._done = 0  # samples encoded so far (always even mid-stream)

    def ensure(self, n_samples: int) -> None:
        """Encode through at least `n_samples` (clamped to the end)."""
        need = min(max(n_samples, 0), self.n)
        if need <= self._done:
            return
        take = need - self._done
        if need < self.n:
            take += take & 1  # keep the stream cursor byte-aligned
        self._lib.axctd_quantize_int4_ns_chunk(
            self.pcm[self._done:], take, self.packed[self._done // 2:],
            self._ct.c_float(self.scale), self._ct.byref(self._e))
        self._done += take


def chunked_int4_encoder(pcm: np.ndarray):
    """A ChunkedInt4Encoder for int16 input, or None (caller falls back
    to the one-shot quantize_int4_packed_stats)."""
    from ..utils import native

    pcm = np.asarray(pcm)
    lib = native.get_library()
    if lib is None or pcm.dtype != np.int16 or not pcm.size:
        return None
    return ChunkedInt4Encoder(pcm, lib)


def int4_stats(packed: np.ndarray, n: int) -> tuple[float, float]:
    """(dc, peak) of the unpacked int4 samples — the host statistics the
    segmented decoder's device conditioning uses.  Padding nibbles encode
    value 0, so sums over the packed array are exact for any n.

    Computed through 256-entry per-byte LUTs: the naive unpack
    (astype(int32), shifts, masks) allocates ~5 waveform-sized
    intermediates, and this host's first touch of fresh large pages is
    pathologically slow (measured 11-15 s for a 600 s drop inside the
    decode path vs ~0.4 s with warm pages); two byte->small-int lookups
    keep the footprint at 3 bytes/sample and run in ~60 ms."""
    if n == 0:
        return 0.0, 1.0
    dc = float(_INT4_SUM_LUT[packed].sum(dtype=np.int64)) / n
    peak = float(_INT4_MAX_LUT[packed].max())
    return dc, max(peak, 1.0)


def _wire_for(wire: str, dtype) -> str:
    """A resolved wire checked against the input dtype (:func:`resolve_wire`;
    ``"auto"`` is resolved by the caller, who knows the device)."""
    if wire == "auto":
        raise ValueError(f"wire must be one of {WIRE_FORMATS[1:]}, got {wire!r}")
    return resolve_wire(wire, dtype)


def encode(pcm: np.ndarray, wire: str) -> np.ndarray:
    """Encode a 1-D integer waveform for the resolved wire format.

    int4 output is a packed uint8 array of ceil(n/2) bytes — consumers
    recognize it by dtype (uint8 == packed nibbles) and unpack on
    device."""
    pcm = np.asarray(pcm)
    if pcm.dtype == np.uint8:
        return pcm  # already packed int4
    w = _wire_for(wire, pcm.dtype)
    if w == "int8":
        return quantize_int8(pcm)
    if w == "int4":
        return quantize_int4_packed(pcm)
    return pcm


def encode_rows(pcms: np.ndarray, wire: str) -> np.ndarray:
    """Encode a (B, N) integer batch for the resolved wire format."""
    pcms = np.asarray(pcms)
    if pcms.dtype == np.uint8:
        return pcms  # already packed int4
    w = _wire_for(wire, pcms.dtype)
    if w == "int8":
        return quantize_int8_rows(pcms)
    if w == "int4":
        return quantize_int4_packed_rows(pcms)
    return pcms
