"""Pointer-doubling chain enumeration (port of axctdprocessor_tpu.ops.chain).

Two decode stages are sequential in the reference: the greedy bit-edge
chain over zero crossings (demodulate.py:85-93) and frame sync
(parse.py:57-89).  Both are successor functions ``next(i)`` computable for
all positions at once; the chain from a start node is then enumerated by
path doubling (``chain[2^p : 2^{p+1}] = J_p[chain[0 : 2^p]]``,
``J_{p+1} = J_p[J_p]``).

The outputs equal the JAX functions' exactly.  Index tensors are int64
(torch's indexing type); values that the packed result carries are cast
to int32 by the caller.  Scatters that the JAX code writes with
``mode="drop"`` send dropped entries to a dump slot at ``size`` that is
sliced off.  Nothing here reads a device value on the host.
"""

from __future__ import annotations

import torch

# zero-crossing capacity per second of audio: a >=2x ceiling over the
# Rice-rate crossing density of anything the order-6 ~1300 Hz demod
# filter passes (see the JAX module for the derivation)
CROSSINGS_PER_SECOND = 3000


def compact_indices(mask: torch.Tensor, size: int, fill: int):
    """Indices of True entries compacted into a fixed-size buffer.

    Returns (indices int64[size] ascending then `fill`, true count — may
    exceed `size`, the caller's overflow signal)."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    slot = torch.where(mask, torch.clamp(pos, max=size), size)
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    out.scatter_(0, slot, torch.arange(n, device=mask.device))
    return out[:size], pos[-1] + 1


def _block_compact_rows(m: torch.Tensor):
    """Stable within-row compaction of a (n_blk, B) boolean mask's set lane
    indices to the row front, via an LSB-first barrel shift.

    Each set lane moves left by ``dist = lane - rank`` (the count of unset
    lanes before it), which is non-decreasing along the row, so the log2(B)
    power-of-two shift rounds never collide.  Element-wise ops and lane
    rolls only.  Returns (lanes int64 (n_blk, B): set-lane indices packed at
    the row front, garbage beyond the row's count; counts int64 (n_blk,))."""
    n_blk, b_sz = m.shape
    v = m > 0
    lane = torch.arange(b_sz, device=m.device)[None, :]
    pos = torch.cumsum(v.to(torch.int64), dim=1) - 1    # rank within row
    counts = pos[:, -1] + 1
    dist = torch.where(v, lane - pos, 0)                # left-shift amount
    val = lane.expand(n_blk, b_sz)
    step = 1
    while step < b_sz:
        move = v & ((dist & step) > 0)
        # incoming occupant from lane + step (no wrap-around within a row)
        can_recv = lane < b_sz - step
        val_in = torch.roll(val, -step, dims=1)
        dist_in = torch.roll(dist, -step, dims=1)
        move_in = torch.roll(move, -step, dims=1) & can_recv
        stay = v & ~move
        val = torch.where(move_in, val_in, val)
        dist = torch.where(move_in, dist_in - step, dist)
        v = move_in | stay
        step *= 2
    return val, counts


def compact_indices_blocked(mask: torch.Tensor, size: int, fill: int):
    """Scatter-free compaction, a recorded negative result of the JAX
    package: 128-lane blocks compact locally with a barrel shift, then the
    result is stitched from per-block offsets with one size-bounded gather
    (the block of each output slot comes from one mark per block start,
    added into a size-length array and prefix-summed, not from a binary
    search).  There it measured slower than the cumsum + scatter of
    :func:`compact_indices` (more passes, each with a fixed cost); on an
    NVIDIA GPU it is unmeasured, and no decode path calls it.  Returns what
    :func:`compact_indices` returns, bit for bit."""
    n = mask.shape[0]
    dev = mask.device
    b = 128
    n_blk = -(-n // b)
    m = torch.nn.functional.pad(mask.to(torch.bool), (0, n_blk * b - n)).reshape(n_blk, b)
    lanes, counts = _block_compact_rows(m)
    coff = torch.cumsum(counts, 0) - counts             # exclusive offsets
    total = coff[-1] + counts[-1]
    base = torch.arange(n_blk, device=dev) * b          # block -> global
    marks = torch.zeros(size + 1, dtype=torch.int64, device=dev)
    marks.index_add_(0, torch.clamp(coff, max=size), torch.ones_like(coff))
    blk = torch.clamp(torch.cumsum(marks[:size], 0) - 1, 0, n_blk - 1)
    j = torch.arange(size, device=dev)
    r = torch.clamp(j - coff[blk], 0, b - 1)
    vals = lanes.reshape(-1)[blk * b + r] + base[blk]
    out = torch.where(j < torch.clamp(total, max=size), vals, fill)
    return out, total


def rowcap_for_fs(fs: float) -> int:
    """Per-128-sample-row survivor cap for crossing compaction at `fs`
    (crossings are >= fs/2600 samples apart behind the demod filter)."""
    spacing = float(fs) / 2600.0
    return int(min(128, max(16, int(128.0 / max(spacing, 1.0)) + 8)))


def compact_indices_rowcap(mask: torch.Tensor, size: int, fill: int,
                           row_cap: int = 16):
    """Crossing-mask compaction with a per-128-row survivor cap.

    Each row's ascending set positions come from one ``topk`` of
    ``-lane``; rows keep at most `row_cap`.  Returns (indices int64[size],
    exact true count, row_overflow int32 flag)."""
    n = mask.shape[0]
    dev = mask.device
    b = 128
    n_blk = -(-n // b)
    m = torch.nn.functional.pad(mask.to(torch.int32), (0, n_blk * b - n))
    m = m.reshape(n_blk, b)
    lane = torch.arange(b, device=dev, dtype=torch.int32).expand(n_blk, b)
    neg, _ = torch.topk(torch.where(m > 0, -lane, -(2 ** 30)), row_cap, dim=1)
    lanes = -neg.to(torch.int64)                      # (n_blk, row_cap)
    cnt = m.sum(dim=1, dtype=torch.int64)
    total = cnt.sum()
    row_ovf = (cnt.max() > row_cap).to(torch.int32)
    cntc = torch.clamp(cnt, max=row_cap)
    coff = torch.cumsum(cntc, 0) - cntc
    j = torch.arange(row_cap, device=dev).expand(n_blk, row_cap)
    valid = j < cntc[:, None]
    slot = torch.where(valid, coff[:, None] + j, size).clamp(max=size)
    base = torch.arange(n_blk, device=dev)[:, None] * b
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=dev)
    out.scatter_(0, slot.reshape(-1), (lanes + base).reshape(-1))
    return out[:size], total, row_ovf


def chain_enumerate(next_idx: torch.Tensor, start: int, length: int,
                    max_level: int = 6) -> torch.Tensor:
    """``chain[j+1] = next_idx[chain[j]]`` for `length` steps (fixed points
    repeat at the end).  The jump table is squared up to 2^max_level steps,
    then span-sized chunks are extended with it."""
    k = int(length)
    jumps = next_idx.to(torch.int64)
    first = min(1 << (k - 1).bit_length(), 1 << max_level)
    span = 1
    # every slot past 0 is written below; a full() and not chain0[0] = start,
    # which copies the scalar from the host and waits for the device
    chain0 = torch.full((first,), start, dtype=torch.int64, device=jumps.device)
    while span < first:
        chain0[span: 2 * span] = jumps[chain0[:span]]
        if 2 * span < k:  # skip the squaring no later step will use
            jumps = jumps[jumps]
        span *= 2
    if first >= k:
        return chain0[:k]
    pieces = [chain0]
    nc = chain0
    for _ in range(-(-(k - first) // first)):
        nc = jumps[nc]
        pieces.append(nc)
    return torch.cat(pieces)[:k]


def chain_enumerate_strided(next_idx: torch.Tensor, start: int, length: int,
                            stride_bound: int = 4,
                            max_level: int = 7) -> torch.Tensor:
    """`chain_enumerate` for successor maps with ``next_idx[i] - i`` in
    {0} ∪ [1, stride_bound] (the bit-edge chain).

    The jump-table squarings are gather-free: with ``delta_L[i] =
    next^L[i] - i``, ``delta_2L[i] = delta_L[i] + delta_L[i + delta_L[i]]``,
    a select over the shifted copies ``delta_L[i + s]``, s in
    [L, stride_bound*L] (a stalled walk keeps its delta, which is exact).
    The tail is extended from the last table in a host loop of small
    gathers (~4,700 steps of 128 at 600 s; the launches bound the decode on
    a GPU), with no device-to-host read.
    """
    k = int(length)
    n = next_idx.shape[0]
    dev = next_idx.device
    assert stride_bound << max_level <= 32767, "delta exceeds int16"
    idx = torch.arange(n, device=dev)
    delta = (next_idx.to(torch.int64) - idx).to(torch.int16)
    first = min(1 << (k - 1).bit_length(), 1 << max_level)

    deltas = [delta]
    span, hi = 1, stride_bound
    while 2 * span <= first and 2 * span < k:
        acc = torch.zeros_like(delta)
        for s in range(span, hi + 1):
            if s < n:
                shifted = torch.cat(
                    [delta[s:], torch.zeros((s,), dtype=torch.int16, device=dev)])
            else:  # shift past the table: everything lands on the pad
                shifted = torch.zeros((n,), dtype=torch.int16, device=dev)
            acc = torch.where(delta == s, shifted, acc)
        delta = delta + acc
        deltas.append(delta)
        span *= 2
        hi *= 2

    chain0 = torch.full((first,), start, dtype=torch.int64, device=dev)
    s2 = 1
    for d in deltas:
        if s2 >= first:
            break
        chain0[s2: 2 * s2] = chain0[:s2] + d[chain0[:s2]].to(torch.int64)
        s2 *= 2
    if first >= k:
        return chain0[:k]

    d_last = deltas[-1].to(torch.int64)
    pieces = [chain0]
    nc = chain0
    for _ in range(-(-(k - first) // first)):
        nc = nc + d_last[nc]
        pieces.append(nc)
    return torch.cat(pieces)[:k]


def bit_edge_successors(crossings: torch.Tensor, n_valid, fs: float,
                        bitrate: float) -> torch.Tensor:
    """Successor table of the greedy 4-candidate bit-edge chain: i + 1 +
    argmin over the next four crossings of their distance to crossings[i] +
    fs/bitrate (ties keep the earlier); positions with fewer than 5
    crossings left are fixed points."""
    m = crossings.shape[0]
    dev = crossings.device
    big = torch.iinfo(torch.int32).max // 2
    padded = torch.cat([crossings, torch.full((5,), big, dtype=crossings.dtype,
                                              device=dev)])
    target = torch.full((), fs / bitrate, dtype=torch.float32, device=dev)
    pick = torch.zeros((m,), dtype=torch.int64, device=dev)
    # distances on small integer gaps: absolute positions in f32 would
    # quantize by ~2 samples on long files
    best = torch.abs((padded[1: 1 + m] - crossings).to(torch.float32) - target)
    for s in range(2, 5):
        d = torch.abs((padded[s: s + m] - crossings).to(torch.float32) - target)
        better = d < best
        pick = torch.where(better, s - 1, pick)
        best = torch.where(better, d, best)
    idx = torch.arange(m, device=dev)
    nxt = torch.where(idx < n_valid - 5, idx + 1 + pick, idx)
    return torch.clamp(nxt, 0, m - 1)


def enumerate_bit_edges(crossings: torch.Tensor, n_valid, fs: float,
                        bitrate: float, max_edges: int):
    """(edge positions int64[max_edges] as crossing-array indices, n_edges);
    entries beyond n_edges repeat the terminal index."""
    nxt = bit_edge_successors(crossings, n_valid, fs, bitrate)
    chain = chain_enumerate_strided(nxt, 0, max_edges)
    advanced = torch.cat([torch.ones((1,), dtype=torch.bool, device=chain.device),
                          chain[1:] > chain[:-1]])
    n_edges = torch.cumprod(advanced.to(torch.int64), 0).sum()
    return chain, n_edges


def enumerate_frames(accept: torch.Tensor, n_bits, max_frames: int,
                     max_level: int = 6):
    """Frame sync over the whole bit stream: advance 1 bit on a reject, 32
    on an accepted frame, stop at ``n_bits - 32`` (parse.py:57-89).

    The walk is "next accepted offset at or after s + 32", run in the
    accept-compacted domain.  Returns (frame_starts int64[max_frames],
    n_frames, consumed, overflow int32: bit 0 accepts exceeded the
    compaction capacity, bit 1 the frame table filled)."""
    n = accept.shape[0]
    dev = accept.device
    cap = min(n, n // 16 + 1024)
    big = torch.iinfo(torch.int32).max // 2
    idx = torch.arange(n, device=dev)
    accept = accept & (idx < n_bits - 32)
    apos, n_acc = compact_indices(accept, cap, big)

    n_keep = torch.clamp(n_acc, max=cap)
    succ = torch.searchsorted(apos, apos + 32)
    j = torch.arange(cap, device=dev)
    succ = torch.where((j < n_keep) & (succ < n_keep), succ, j)

    chain = chain_enumerate(succ, 0, max_frames, max_level=max_level)
    advancing = torch.cat([(n_acc > 0).reshape(1), chain[1:] > chain[:-1]])
    is_frame = torch.cumprod(advancing.to(torch.int64), 0).to(torch.bool)
    n_frames = is_frame.to(torch.int64).sum()
    starts = torch.where(is_frame, apos[torch.clamp(chain, 0, cap - 1)], 0)

    floor_pos = torch.clamp(n_bits - 32, min=0)
    last_start = torch.where(is_frame, starts, -1).max()
    last_end = torch.where(n_frames > 0, last_start + 32, 0)
    consumed = torch.clamp(torch.maximum(floor_pos, last_end), max=n - 1)
    overflow = ((n_acc > cap).to(torch.int32)
                | ((n_frames >= max_frames).to(torch.int32) << 1))
    return starts, n_frames, consumed, overflow
