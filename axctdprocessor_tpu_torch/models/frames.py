"""Header field decode from per-counter frame data (host).

A jax-free copy of ``header_fields_from_frames`` and
``header_dict_from_device`` from axctdprocessor_tpu.models.frames
(reference parse.py:197-285): the device frame-syncs the header windows and
ships (found, nibbles) arrays; the host decodes fields and coefficients in
float64 from the exact integers.
"""

from __future__ import annotations

import numpy as np

from axctdprocessor_tpu.models import metadata as md

HEADER_FRAMES = 72


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


def header_dict_from_device(found, frames) -> dict | None:
    """Header dict from device (found, frames) arrays, or None when the
    upstream decode would have crashed on unparseable coefficient hex."""
    found = [bool(f) for f in np.asarray(found)]
    nibbles = np.asarray(frames)
    frame_data = [
        "".join("0123456789abcdef"[v] for v in nibbles[k]) if found[k] else None
        for k in range(HEADER_FRAMES)
    ]
    try:
        return header_fields_from_frames(found, frame_data)
    except ValueError:
        return None
