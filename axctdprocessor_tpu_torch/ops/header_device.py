"""Device-side header codec: trim, frame sync and coefficient decode of the
header capture windows (port of axctdprocessor_tpu.ops.header_device).

Same contracts as the host versions (reference parse.py:157-285):

* :func:`trim_header` — force the first 25 bits high, find the last
  run-of-8-ones before the ones-density collapse (the pulse end), return
  the start and length of the 75-frame window;
* :func:`parse_header_frames` — frame sync with the +1/+32 jump chain,
  counter decode incl. the '11111'+3 form, and each frame's 16 data bits
  (4 nibbles) into its counter slot, the later frame winning;
* :func:`parse_header_window` — both, for one fixed-size capture window;
* :func:`decode_coefficients` — the sign/mantissa/exponent decimal decode
  of the 12-nibble coefficient strings, with per-coefficient validity, and
  :func:`merge_live_coeffs`, the header merge and live-coefficient adoption.

The fused decode calls neither of the last two (the JAX engine's back half
computes and then discards them): it ships the raw (found, nibbles) arrays
and the host decodes the coefficients in float64.

The first three work along the last dimension: one window, or a batch of
windows (B, n) with per-row bit counts (B,), each row as it would be alone
(the JAX package ``vmap``s them with its back half).
"""

from __future__ import annotations

import numpy as np
import torch

from . import chain as chain_ops
from . import crc as crc_ops

HEADER_FRAMES = 72
FRAME_BITS = 32
WINDOW_BITS = FRAME_BITS * 75  # trimmed header window capacity


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last dimension of a bool mask (0
    when none), on the device; torch's argmax does not take bool and
    returns the first maximal index."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def trim_header(bits: torch.Tensor, n_bits):
    """(start index of the 75-frame header window, window length)."""
    n = bits.shape[-1]
    dev = bits.device
    idx = torch.arange(n, device=dev)
    valid = idx < n_bits[..., None]
    b = torch.where(idx < 25, 1, torch.where(valid, bits.to(torch.int64), 0))

    csum = torch.cat([torch.zeros(b.shape[:-1] + (1,), dtype=torch.int64, device=dev),
                      torch.cumsum(b, -1)], -1)
    ones25 = csum[..., idx + 1] - csum[..., torch.clamp(idx - 24, min=0)]
    run8 = csum[..., idx + 1] - csum[..., torch.clamp(idx - 7, min=0)]

    stop_mask = (idx >= 400) & (ones25 <= 20) & valid
    stop = torch.where(stop_mask.any(-1), first_true(stop_mask), n_bits - 1)

    pulse_mask = (idx > 10) & (run8 == 8) & (idx <= stop[..., None]) & valid
    # last True index: length-1 - first True of the reversed mask
    last = torch.where(pulse_mask.any(-1), n - 1 - first_true(pulse_mask.flip(-1)), 0)
    length = torch.clamp(n_bits - last, max=FRAME_BITS * 75)
    return last, length


def parse_header_frames(bits: torch.Tensor, n_bits):
    """Frame-sync a trimmed header window: (found bool[72], nibbles
    int64[72, 4]).

    Advance 1 on an invalid window and 32 on a '10'+CRC frame; frames whose
    counter exceeds 71 are consumed but ignored, and nothing after the first
    frame 71 writes a slot (the upstream loop stops there).  A repeated
    counter keeps the LATER frame, as the upstream dict assignment does:
    the winner per slot is chosen explicitly (torch's index_put with
    duplicate indices leaves the winner undefined on CUDA).
    """
    n = bits.shape[-1]
    dev = bits.device
    batch = bits.shape[:-1]
    bits = bits.to(torch.int64)
    idx = torch.arange(n, device=dev)
    in_range = idx < n_bits[..., None]
    crc_ok = crc_ops.check_crc_all_windows(bits)
    sync = (bits == 1) & (torch.roll(bits, -1, dims=-1) == 0)
    accept = sync & crc_ok & in_range & (idx < n_bits[..., None] - FRAME_BITS)

    max_frames = n // FRAME_BITS + 2
    starts, n_frames, _, _ = chain_ops.enumerate_frames(
        accept, n_bits, max_frames=max_frames)

    offs = torch.arange(FRAME_BITS, device=dev)
    at = torch.clamp(starts[..., None] + offs, 0, n - 1)
    fwin = torch.gather(bits, -1, at.reshape(batch + (-1,))).reshape(at.shape)
    k = torch.arange(max_frames, device=dev)
    frame_ok = k < n_frames[..., None]

    counter_bits = fwin[..., 2:10]
    w8 = 1 << torch.arange(7, -1, -1, device=dev)
    plain = (counter_bits * w8).sum(dim=-1)
    high = counter_bits[..., :5].sum(dim=-1) == 5
    w3 = 1 << torch.arange(2, -1, -1, device=dev)
    counter = torch.where(high, (counter_bits[..., 5:] * w3).sum(dim=-1) + 64, plain)
    counter_ok = frame_ok & (counter <= 71)
    saw71 = counter_ok & (counter == 71)
    k71 = torch.where(saw71.any(-1), first_true(saw71), max_frames)
    counter_ok &= k <= k71[..., None]

    # integer matmuls have no CUDA kernel: multiply and sum
    nib = (fwin[..., 10:26].reshape(batch + (max_frames, 4, 4))
           * (1 << torch.arange(3, -1, -1, device=dev))).sum(dim=-1)
    slot = torch.where(counter_ok, counter, HEADER_FRAMES)
    # last-wins: the highest frame index per slot, then one gather
    winner = torch.full(batch + (HEADER_FRAMES + 1,), -1, dtype=torch.int64, device=dev)
    winner = winner.scatter_reduce(-1, slot, k.expand(slot.shape),
                                   reduce="amax")[..., :HEADER_FRAMES]
    found = winner >= 0
    pick = torch.clamp(winner, min=0)[..., None].expand(batch + (HEADER_FRAMES, 4))
    frames = torch.where(found[..., None], torch.gather(nib, -2, pick), 0)
    return found, frames


def parse_header_window(win_bits: torch.Tensor, n_bits):
    """One header capture window -> (found bool[72], nibbles int64[72, 4],
    usable bool).  A window shorter than 72 frames before or after trimming
    never yields a header."""
    start, length = trim_header(win_bits, n_bits)
    idx = torch.arange(WINDOW_BITS, device=win_bits.device)
    at = torch.clamp(start[..., None] + idx, 0, win_bits.shape[-1] - 1)
    trimmed = torch.where(idx < length[..., None], torch.gather(win_bits, -1, at), 0)
    found, frames = parse_header_frames(trimmed, length)
    usable = (n_bits >= HEADER_FRAMES * FRAME_BITS) & \
        (length >= HEADER_FRAMES * FRAME_BITS)
    return found & usable[..., None], frames, usable


# coefficient layout: coefficient i of z/t/c spans these base frames + 2
COEFF_BASES = {
    "z": (21, 18, 15, 12),
    "t": (33, 30, 27, 24),
    "c": (45, 42, 39, 36),
}


def merge_live_coeffs(vals2, ok2, vals3, ok3, defaults):
    """The header merge and live-coefficient adoption on the device.

    ``vals*/ok*`` are :func:`decode_coefficients` outputs (rows z, t, c)
    with any crashed header's ``ok`` rows already zeroed; ``defaults`` is
    f32[3, 4] (config defaults, same row order).  As
    ``models.metadata.merge_headers``: per-slot fill-in with header 3
    winning, adoption of a full 4/4-valid set, and the upstream quirk that
    **zcoeff adoption is gated on tcoeff validity**, including the
    initializer leak: the adopted zcoeff row is the *metadata* row, whose
    never-decoded slots hold the metadata initializer 1.0, not the config
    default (reference AXCTDprocessor.py:534-535, parse.py:190).
    Returns (live_z, live_t, live_c)."""
    ok = ok2 | ok3
    merged = torch.where(ok3, vals3, torch.where(ok2, vals2, 0.0))
    t_all = ok[1].all()
    c_all = ok[2].all()
    z_meta = torch.where(ok[0], merged[0], 1.0)  # metadata zcoeff init is 1s
    live_z = torch.where(t_all, z_meta, defaults[0])
    live_t = torch.where(t_all, merged[1], defaults[1])
    live_c = torch.where(c_all, merged[2], defaults[2])
    return live_z, live_t, live_c


def decode_coefficients(found: torch.Tensor, frames: torch.Tensor):
    """All twelve conversion coefficients from header frame data.

    Returns ``(values f32[3,4], valid bool[3,4], mant i32[3,4],
    exp i32[3,4], crash bool)`` ordered z, t, c.

    Decode contract = the upstream expression
    ``int(chex[:9].replace(B,+).replace(D,-)) / 1e7 * 10**int(chex[9:])``
    (reference parse.py:277-279): position 0 / 9 may be a sign nibble
    (0xB='+', 0xD='-') **or a plain decimal digit** (9-digit mantissa /
    3-digit exponent); every other nibble must be decimal.  Any other
    nibble makes ``int()`` raise upstream: ``crash`` is True when any
    coefficient with all three frames found is unparseable, so callers can
    discard the whole header as the host path's try/except ValueError does.
    ``mant``/``exp`` are the exact signed integers, from which the host
    rebuilds the float64 value bit for bit; ``values`` is the float32
    on-device version: ``f32(mant) / f32(1e7)``, a true division of two
    tensors, times ``10 ** f32(clip(exp, -40, 40))``.
    """
    dev = found.device
    frames = frames.to(torch.int64)
    bases = torch.tensor([b for name in "ztc" for b in COEFF_BASES[name]], device=dev)
    have = found[bases] & found[bases + 1] & found[bases + 2]
    nib = torch.cat([frames[bases], frames[bases + 1], frames[bases + 2]], dim=1)  # (12, 12)

    def sign_nibble(v):
        return (v == 0xB) | (v == 0xD)

    m_sign_nib, e_sign_nib = sign_nibble(nib[:, 0]), sign_nibble(nib[:, 9])
    m_ok = (m_sign_nib | (nib[:, 0] <= 9)) & (nib[:, 1:9] <= 9).all(dim=1)
    e_ok = (e_sign_nib | (nib[:, 9] <= 9)) & (nib[:, 10:] <= 9).all(dim=1)

    digits = torch.clamp(nib, max=9)
    w8 = torch.tensor((10 ** np.arange(7, -1, -1)).tolist(), device=dev)
    d8 = (digits[:, 1:9] * w8).sum(dim=1)
    msign = torch.where(nib[:, 0] == 0xD, -1, 1)
    mant = torch.where(m_sign_nib, msign * d8, digits[:, 0] * 10 ** 8 + d8)
    d2 = digits[:, 10] * 10 + digits[:, 11]
    esign = torch.where(nib[:, 9] == 0xD, -1, 1)
    exp = torch.where(e_sign_nib, esign * d2, digits[:, 9] * 100 + d2)

    ten = torch.full((), 10.0, dtype=torch.float32, device=dev)
    scale = torch.full((), 1e7, dtype=torch.float32, device=dev)
    values = mant.to(torch.float32) / scale * ten ** torch.clamp(exp, -40, 40).to(torch.float32)
    ok = m_ok & e_ok
    return (values.reshape(3, 4), (have & ok).reshape(3, 4),
            mant.to(torch.int32).reshape(3, 4), exp.to(torch.int32).reshape(3, 4),
            (have & ~ok).any())
