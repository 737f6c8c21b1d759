# Frozen copy of axctdprocessor_tpu_torch/models/demod.py at commit 05168f0, for the
# benchmark's plain reference: imports rewritten to this package.
"""FSK demodulation of one PCM chunk (host, reference-exact float64).

A copy of axctdprocessor_tpu.models.demod, the same code: numpy and scipy in
float64, nothing on a device.  ``design_filter`` takes the port's
``ops.iir.design_sos``.

The demodulation contract (reference demodulate.py:59-116):

1. low-pass (or band-pass) the chunk with the order-6 Butterworth SOS
   cascade, state reset every chunk (the per-chunk transient is masked by
   the 100-sample edge buffer and is parity-relevant);
2. find zero crossings of the filtered signal (zeros count as positive),
   discard those before the edge buffer;
3. chain bit edges greedily: from the current crossing, pick among the
   next four crossings the one nearest to (current + fs/bitrate);
4. for each chained edge except the last, measure single-bin DFT power
   at the mark and space frequencies over the inset window, scale the
   space power by the adaptive high_bit_scale, and call the bit for the
   stronger tone; confidence = scaled space power / mark power;
5. the final edge is re-discovered next chunk (next_start = last edge - 1)
   and its bit is emitted then.

The per-bit power loop deliberately calls ``np.sum`` per window so the
float64 accumulation order matches the upstream implementation exactly
(np.dot/BLAS would differ in the last bits and break byte parity of the
confidence-derived calibration).
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy import signal


@dataclasses.dataclass
class ChunkDemodResult:
    bits: list
    conf: list
    bit_edges: list
    next_start: int


def design_filter(fs: float, use_bandpass: bool):
    """Order-6 Butterworth SOS: 100-1200 Hz bandpass or 1200 Hz lowpass.

    Single source of truth shared with the device engine (ops.iir)."""
    from .iir import design_sos

    return design_sos(fs, use_bandpass)


def make_bit_trig(fs: float, f1: float, f2: float, npcm: int):
    """cos/sin tables for the two per-bit tone probes (length npcm)."""
    k = 2 * np.pi * np.arange(0, npcm) / fs
    return (np.cos(k * f1), np.sin(k * f1), np.cos(k * f2), np.sin(k * f2))


def demodulate_chunk(pcm, fs, edge_buffer, sos, bitrate, bit_trig, npcm,
                     bit_inset, high_bit_scale) -> ChunkDemodResult:
    cos1, sin1, cos2, sin2 = bit_trig
    filtered = signal.sosfilt(sos, pcm)

    sgn = np.sign(filtered)
    sgn[sgn == 0] = 1
    crossings = np.flatnonzero(sgn[:-1] != sgn[1:])
    crossings = crossings[crossings >= edge_buffer]

    # greedy 4-candidate bit-edge chain
    target = fs / bitrate
    edges = [crossings[0]]
    c = 0
    n = len(crossings)
    while c < n - 5:
        options = crossings[c + 1 : c + 5]
        c += 1 + int(np.argmin(np.abs(options - (crossings[c] + target))))
        edges.append(crossings[c])

    bits, conf = [], []
    for e in edges[:-1]:
        w = filtered[e + bit_inset : e + bit_inset + npcm]
        p1 = np.abs(np.sum(w * cos1 + 1j * w * sin1))
        p2 = np.abs(np.sum(w * cos2 + 1j * w * sin2)) * high_bit_scale
        conf.append(p2 / p1)
        bits.append(1 if p1 >= p2 else 0)

    return ChunkDemodResult(bits, conf, edges, int(edges[-1]) - 1)


def calibrate_scale_factor(confs, scale_factor: float) -> float:
    """Re-fit high_bit_scale from header-1 confidence ratios.

    Contract (reference demodulate.py:124-157): histogram the confidence
    ratios on [0, 3) in 0.01 bins, find where the cumulative-percentage
    curve is flattest within the 30-65% band (the valley between the
    mark and space confidence modes), and divide the scale factor by that
    threshold so the decision boundary sits at confidence 1.0.
    """
    npts = len(confs)
    values = np.asarray(confs)
    edges = np.arange(0.0, 3, 0.01)
    counts, edges = np.histogram(values, bins=edges)
    centers = edges[:-1] + np.diff(edges) / 2
    cum_pct = 100 * np.cumsum(counts) / npts

    slope = np.array((cum_pct[1] - cum_pct[0]) / (centers[1] - centers[0]))
    slope = np.append(slope, (cum_pct[2:] - cum_pct[:-2]) / (centers[2:] - centers[:-2]))
    slope = np.append(slope, (cum_pct[-1] - cum_pct[-2]) / (centers[-1] - centers[-2]))

    in_band = [30 <= cp <= 65 for cp in cum_pct]
    centers, slope = centers[in_band], slope[in_band]

    flattest = np.flatnonzero(slope == np.min(slope))
    threshold = np.nanmean([centers[flattest[0]], centers[flattest[-1]]])
    return scale_factor / threshold
