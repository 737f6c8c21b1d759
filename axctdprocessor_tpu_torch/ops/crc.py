"""CRC-6 frame validation for the 32-bit AXCTD frame
(port of axctdprocessor_tpu.ops.crc).

Generator x^6 + x^5 + x^2 + 1 (bit vector ``1100101``; reference
parse.py:310-322).  A frame is valid iff GF(2) long division of its 32 bits
leaves remainder zero; by linearity the remainder of a window is the XOR of
the remainders of its one-hot bits (:func:`parity_matrix`).

The numpy part is a jax-free copy of the JAX module's.  The torch part runs
on the device (torch is imported inside it: the host parity engine and the
simulator import this module for the numpy part):

* :func:`check_crc_words` — validity of pre-built frame words.  Torch has no
  uint32 shifts on the CPU and no popcount, so words are int64 holding the
  32-bit pattern, and each parity bit is an XOR fold of ``word & mask``.
* :func:`check_crc_all_windows` — validity of every 32-bit window of a bit
  stream (or of each row of a batch), as 32 shifted XORs of bit-packed
  parity rows.
"""

from __future__ import annotations

import numpy as np

GENERATOR = np.array([1, 1, 0, 0, 1, 0, 1], dtype=np.uint8)
FRAME_BITS = 32
DATA_BITS = 26
CRC_BITS = 6


def _remainder_np(bits: np.ndarray) -> np.ndarray:
    """GF(2) long-division remainder of a 32-bit word (numpy)."""
    r = np.array(bits, dtype=np.uint8, copy=True)
    for k in range(DATA_BITS):
        if r[k]:
            r[k: k + 7] ^= GENERATOR
    return r[DATA_BITS:]


def check_crc_np(frame) -> bool:
    """True iff the 32-bit frame passes CRC-6 (remainder == 0)."""
    frame = np.asarray(frame, dtype=np.uint8)
    if frame.shape != (FRAME_BITS,):
        raise ValueError(f"frame must be 32 bits, got {frame.shape}")
    return not _remainder_np(frame).any()


def encode_crc_np(payload) -> np.ndarray:
    """Append the 6 CRC bits to a 26-bit payload, producing a valid frame."""
    payload = np.asarray(payload, dtype=np.uint8)
    if payload.shape != (DATA_BITS,):
        raise ValueError(f"payload must be 26 bits, got {payload.shape}")
    word = np.concatenate([payload, np.zeros(CRC_BITS, dtype=np.uint8)])
    crc = _remainder_np(word)
    return np.concatenate([payload, crc])


def parity_matrix() -> np.ndarray:
    """The 32x6 GF(2) matrix P with remainder(w) = (w @ P) mod 2."""
    p = np.zeros((FRAME_BITS, CRC_BITS), dtype=np.uint8)
    for i in range(FRAME_BITS):
        onehot = np.zeros(FRAME_BITS, dtype=np.uint8)
        onehot[i] = 1
        p[i] = _remainder_np(onehot)
    return p


_PARITY = parity_matrix()


def check_crc_all_windows_np(bitstream: np.ndarray) -> np.ndarray:
    """CRC validity of every 32-bit sliding window of `bitstream` (numpy,
    the host parity engine's): a bool array of length ``len(bitstream) - 31``."""
    bits = np.asarray(bitstream, dtype=np.uint8)
    n = len(bits) - FRAME_BITS + 1
    if n <= 0:
        return np.zeros(0, dtype=bool)
    windows = np.lib.stride_tricks.sliding_window_view(bits, FRAME_BITS)
    rem = (windows.astype(np.int32) @ _PARITY.astype(np.int32)) & 1
    return ~rem.any(axis=1)


# parity row i packed into one int: bit j is _PARITY[i, j]
_PACKED = (_PARITY.astype(np.int64) << np.arange(CRC_BITS)).sum(axis=1)

# column j of the parity matrix as a mask over the frame word layout
# word[i] = sum_k bits[i+k] << (31-k)
_COLMASK = [int(sum(int(_PARITY[k, j]) << (31 - k) for k in range(FRAME_BITS)))
            for j in range(CRC_BITS)]


def _parity32(v):
    """Parity (popcount mod 2) of the low 32 bits of non-negative int64s."""
    for s in (16, 8, 4, 2, 1):
        v = v ^ (v >> s)
    return v & 1


def check_crc_words(words):
    """CRC validity from 32-bit frame words held in int64 (bit i of the
    window in bit 31-i).  A zero word reads as valid: callers mask the tail."""
    import torch

    w = words.to(torch.int64)
    bad = torch.zeros_like(w)
    for mask in _COLMASK:
        bad = bad | _parity32(w & mask)
    return bad == 0


def check_crc_all_windows(bitstream):
    """CRC validity of every 32-bit sliding window of a 0/1 stream of
    length N along the last dimension (one stream, or a batch of rows);
    positions past N-32 are False."""
    import torch

    bits = bitstream.to(torch.int64)
    n = bits.shape[-1]
    rem = torch.zeros_like(bits)
    for i in range(FRAME_BITS):
        rem = rem ^ (torch.roll(bits, -i, dims=-1) * int(_PACKED[i]))
    idx = torch.arange(n, device=bits.device)
    return (rem == 0) & (idx <= n - FRAME_BITS)
