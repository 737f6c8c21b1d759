# Frozen copy of axctdprocessor_tpu_torch/models/frames.py at commit 05168f0, for the
# benchmark's plain reference: imports rewritten to this package; dropped the torch form header_dict_from_device.
"""Header trimming/parsing and profile frame sync (host, reference-exact).

A jax-free copy of axctdprocessor_tpu.models.frames, the same code
(reference parse.py:41-285): vectorized NumPy with an index-only jump chain,
every window's validity precomputed at once (CRC as a GF(2) matrix product
over all sliding windows).  The host parity engine uses ``trim_header``,
``parse_header`` and ``sync_profile_frames``; the device engine frame-syncs
the header windows itself and ships (found, nibbles) arrays, which
``header_dict_from_device`` decodes in float64 from the exact integers.
"""

from __future__ import annotations

import numpy as np

from . import crc
from .bits import bits_to_hex_np, bits_to_int_np
from . import metadata as md

HEADER_FRAMES = 72
FRAME_BITS = 32


def trim_header(bits_in) -> np.ndarray:
    """Locate the end of the 400 Hz pulse and return 75 frames of bits.

    Contract (reference parse.py:157-183): force the first 25 bits to 1;
    track the last index ending a run of 8 ones (for i > 10); stop at the
    first i >= 400 whose trailing 25-bit window holds <= 20 ones (pulse
    over, data underway); return bits[last_run_end : +32*75].
    """
    bits = np.asarray(bits_in, dtype=np.int64).copy()
    n = len(bits)
    bits[:25] = 1

    # ones in the trailing 25-bit window ending at i (shorter near start)
    csum = np.concatenate([[0], np.cumsum(bits)])
    idx = np.arange(n)
    ones25 = csum[idx + 1] - csum[np.maximum(idx - 24, 0)]

    # first break index: i > 24, i >= 400, window density dropped
    stop_candidates = np.flatnonzero((idx >= 400) & (ones25 <= 20))
    stop = stop_candidates[0] if stop_candidates.size else n - 1

    # run of 8 ones ending at i, for i > 10, at or before the break
    run8 = csum[idx + 1] - csum[np.maximum(idx - 7, 0)]
    pulse_ends = np.flatnonzero((idx > 10) & (idx >= 7) & (run8 == 8) & (idx <= stop))
    last_pulse_end = int(pulse_ends[-1]) if pulse_ends.size else 0

    return bits[last_pulse_end : last_pulse_end + FRAME_BITS * 75]


def parse_header(bits_in) -> dict:
    """Decode one 72-frame header transmission into a metadata dict.

    Frame layout: '10' + 8-bit counter (64-71 sent as '11111'+3 bits) +
    16 data bits (4 hex nibbles) + CRC-6.  Fields: frames 4-5 serial,
    6 max depth, 7 probe code; coefficient i of z/t/c spans frames
    (21,18,15,12)[i] / (33,30,27,24)[i] / (45,42,39,36)[i] and the two
    following (high frame first), decoded as sign+mantissa / sign+exponent
    decimal strings with 'B'='+', 'D'='-'.  (Reference parse.py:197-285.)
    """
    bits = np.asarray(bits_in, dtype=np.int64)
    n = len(bits)

    counter_found = [False] * HEADER_FRAMES
    frame_data: list = [None] * HEADER_FRAMES

    # precompute window validity, then jump 1 (invalid) / 32 (frame)
    valid = crc.check_crc_all_windows_np(bits)
    sync_ok = (bits[:-1] == 1) & (bits[1:] == 0)
    s, last = 0, -1
    while last < 71 and s < n - FRAME_BITS:
        if not (s < len(valid) and valid[s] and sync_ok[s]):
            s += 1
            continue
        counter_bits = bits[s + 2 : s + 10]
        if counter_bits[:5].sum() == 5:
            counter = int(bits_to_int_np(counter_bits[5:])) + 64
        else:
            counter = int(bits_to_int_np(counter_bits))
        if counter <= 71:
            counter_found[counter] = True
            last = counter
            frame_data[counter] = bits_to_hex_np(bits[s + 10 : s + 26])
        s += FRAME_BITS

    return header_fields_from_frames(counter_found, frame_data)


def header_fields_from_frames(counter_found: list, frame_data: list) -> dict:
    """Field/coefficient decode from per-counter frame data.

    Raises ValueError on upstream-unparseable coefficient hex (the
    reference's ``int()`` crash), which callers treat as "whole header
    unusable".
    """
    out = md.new_metadata()
    if counter_found[4] and counter_found[5]:
        out["serial_no"] = frame_data[4] + frame_data[5]
    if counter_found[6]:
        out["max_depth"] = frame_data[6]
    if counter_found[7]:
        out["probe_code"] = frame_data[7]

    for name, bases in (("z", (21, 18, 15, 12)), ("t", (33, 30, 27, 24)),
                        ("c", (45, 42, 39, 36))):
        for i, base in enumerate(bases):
            if all(counter_found[base: base + 3]):
                out[f"{name}coeff_hex"][i] = "".join(frame_data[base: base + 3])

    for name in md.COEFF_NAMES:
        for i in range(4):
            chex = out[f"{name}coeff_hex"][i]
            if chex != "":
                signed = chex.upper().replace("B", "+").replace("D", "-")
                out[f"{name}coeff"][i] = int(signed[:9]) / 1e7 * 10 ** int(signed[9:])
                out[f"{name}coeff_valid"][i] = True

    out["frame_data"] = frame_data
    out["counter_found"] = counter_found
    return out


def sync_profile_frames(bits_in, r7500_in) -> tuple[np.ndarray, int]:
    """Frame-sync a profile bitstream: start indices of accepted frames.

    Acceptance (reference parse.py:68): window starts '10', passes CRC,
    and its bit's 7500 Hz level is positive.  Scan advances 1 on reject
    and 32 on accept; returns (accepted start indices, next unconsumed
    bit index).
    """
    bits = np.asarray(bits_in, dtype=np.int64)
    n = len(bits)
    if n < FRAME_BITS + 1:
        return np.zeros(0, dtype=np.int64), 0
    r7500 = np.asarray(r7500_in, dtype=np.float64)
    valid = crc.check_crc_all_windows_np(bits)
    nv = len(valid)
    accept = np.zeros(nv, dtype=bool)
    accept[:nv] = valid & (bits[:nv] == 1) & (bits[1 : nv + 1] == 0)
    accept &= r7500[:nv] > 0

    starts = []
    s = 0
    while s < n - FRAME_BITS:
        if accept[s]:
            starts.append(s)
            s += FRAME_BITS
        else:
            s += 1
    return np.asarray(starts, dtype=np.int64), s
