"""AXCTD metadata container and header-merge policy.

A copy of axctdprocessor_tpu.models.metadata, whole: the port imports
nothing of the JAX package.

Mirrors the reference metadata dict contract (parse.py:187-192) and the
two-header merge at AXCTDprocessor.py:505-535, including its quirks:

* per-coefficient fill-in, later header (header 3) winning per slot;
* scalar fields (serial/probe/max depth/misc) first-wins;
* live ``zcoeff`` adoption is gated on *tcoeff* validity — the upstream
  copy-paste bug (SURVEY.md 2.3 #7), preserved for output parity.
"""

from __future__ import annotations

COEFF_NAMES = ("t", "c", "z")
SCALAR_FIELDS = ("serial_no", "probe_code", "max_depth", "misc")


def new_metadata() -> dict:
    """Fresh metadata dict (reference initialize_axctd_metadata)."""
    md = {
        "tcoeff": [0, 1, 0, 0],
        "ccoeff": [0, 1, 0, 0],
        "zcoeff": [1, 1, 1, 1],
        "serial_no": None,
        "probe_code": None,
        "max_depth": None,
        "misc": None,
    }
    for name in COEFF_NAMES:
        md[f"{name}coeff_hex"] = ["", "", "", ""]
        md[f"{name}coeff_valid"] = [False] * 4
    return md


def merge_headers(metadata: dict, header2: dict | None, header3: dict | None,
                  live_coeffs: dict) -> None:
    """Fold decoded header(s) into `metadata` and update live coefficients.

    ``live_coeffs`` holds the decoder's active ``tcoeff/ccoeff/zcoeff``
    lists (initialized from config defaults) and is updated in place when
    a full coefficient set becomes valid.
    """
    for slot, header in ((2, header2), (3, header3)):
        if header is None:
            continue
        metadata[f"frame_data_{slot}"] = header["frame_data"]
        metadata[f"counter_found_{slot}"] = header["counter_found"]
        for name in COEFF_NAMES:
            for ci in range(4):
                if header[f"{name}coeff_valid"][ci]:
                    metadata[f"{name}coeff"][ci] = header[f"{name}coeff"][ci]
                    metadata[f"{name}coeff_hex"][ci] = header[f"{name}coeff_hex"][ci]
                    metadata[f"{name}coeff_valid"][ci] = True
        for key in SCALAR_FIELDS:
            if header[key] is not None and metadata[key] is None:
                metadata[key] = header[key]

    if header2 is not None or header3 is not None:
        if sum(metadata["tcoeff_valid"]) == 4:
            live_coeffs["tcoeff"] = metadata["tcoeff"]
        if sum(metadata["ccoeff_valid"]) == 4:
            live_coeffs["ccoeff"] = metadata["ccoeff"]
        # upstream gates zcoeff adoption on *tcoeff* validity (bug kept
        # for parity; AXCTDprocessor.py:534-535)
        if sum(metadata["tcoeff_valid"]) == 4:
            live_coeffs["zcoeff"] = metadata["zcoeff"]
