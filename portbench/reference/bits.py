# Frozen copy of axctdprocessor_tpu_torch/ops/bits.py at commit 05168f0, for the
# benchmark's plain reference: imports rewritten to this package; dropped the torch forms bits_to_int, frames_to_nibbles.
"""Bit/int/hex codecs for AXCTD frames (port of axctdprocessor_tpu.ops.bits).

The ``*_np`` helpers are jax-free copies (reference parse.py:331-379):
MSB-first bit<->int packing and the nibble-at-a-time hex codec of the
report's hex column.  :func:`bits_to_int` and :func:`frames_to_nibbles` are
the device forms, on tensors; torch is imported inside them, because the
host parity engine imports this module.
"""

from __future__ import annotations

import numpy as np

_HEXCHARS = "0123456789abcdef"


def bits_to_int_np(bits) -> np.ndarray:
    """MSB-first bit vector(s) -> integer; last axis is the bit axis."""
    bits = np.asarray(bits, dtype=np.int64)
    w = 1 << np.arange(bits.shape[-1] - 1, -1, -1, dtype=np.int64)
    return bits @ w


def int_to_bits_np(value: int, width: int) -> np.ndarray:
    """Integer -> MSB-first bit vector of exactly `width` bits."""
    if value < 0 or value >= (1 << width):
        raise ValueError(f"{value} does not fit in {width} bits")
    return (value >> np.arange(width - 1, -1, -1)) & 1


def bits_to_hex_np(bits) -> str:
    """Bit list (length multiple of 4) -> lowercase hex string."""
    bits = np.asarray(bits, dtype=np.int64)
    if bits.size % 4:
        raise ValueError("bit length must be a multiple of 4")
    nibbles = bits.reshape(-1, 4) @ np.array([8, 4, 2, 1], dtype=np.int64)
    return "".join(_HEXCHARS[n] for n in nibbles)


def hex_to_bits_np(hexstr: str) -> np.ndarray:
    """Lowercase/uppercase hex string -> MSB-first bit vector (encoder side)."""
    vals = [int(ch, 16) for ch in hexstr]
    return np.concatenate([int_to_bits_np(v, 4) for v in vals])


def nibbles_to_hex_np(nibbles) -> list[str]:
    """(N, 8) nibble values -> list of 8-char lowercase hex strings (host)."""
    nibbles = np.asarray(nibbles)
    return ["".join(_HEXCHARS[v] for v in row) for row in nibbles]
