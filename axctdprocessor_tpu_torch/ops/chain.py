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

The chain functions and :func:`compact_indices` work along the last
dimension: one row (n,) as the JAX functions take it, or a batch (B, n)
with per-row scalars of shape (B,), each row computed as it would be alone
(the batch dimension written out where the JAX package would ``vmap``).

The walks are hand-written CUDA kernels on the card (``ops/kernels/chain.cu``),
where the JAX package runs ``lax.scan`` and fused XLA: :func:`chain_enumerate_strided`,
the bit-edge chain, as one segment-parallel walk of the successor table (no
level tables); :func:`chain_enumerate_frames`, frame sync's chain, as one pass
over segments of 32 entries with a look-back across tiles (no jump tables);
and :func:`chain_walk`, the doubling fill and tail over full jump tables of a
general map (:func:`chain_enumerate`, which no decode path calls).  Each
wrapper takes its plain version for a CPU tensor, launches its kernel for a
CUDA tensor and adds its launches to its ``launches`` count, and raises on any
other device; nothing falls back.  :func:`chain_enumerate_strided_reference`
(the JAX package's level tables, :func:`chain_compose_reference` and the
doubling walk) and :func:`chain_enumerate_reference` are the whole
enumerations in plain PyTorch, for comparison runs.
"""

from __future__ import annotations

import torch

# zero-crossing capacity per second of audio: a >=2x ceiling over the
# Rice-rate crossing density of anything the order-6 ~1300 Hz demod
# filter passes (see the JAX module for the derivation)
CROSSINGS_PER_SECOND = 3000


def _col(v):
    """A per-row scalar (a 0-dim or (B,) tensor, or a Python number) shaped
    to broadcast against the last dimension."""
    return v[..., None] if isinstance(v, torch.Tensor) else v


def compact_indices(mask: torch.Tensor, size: int, fill: int):
    """Indices of True entries compacted into a fixed-size buffer, along the
    last dimension.

    Returns (indices int64[..., size] ascending then `fill`, true count per
    row — may exceed `size`, the caller's overflow signal)."""
    n = mask.shape[-1]
    pos = torch.cumsum(mask.to(torch.int64), -1) - 1
    slot = torch.where(mask, torch.clamp(pos, max=size), size)
    out = torch.full(mask.shape[:-1] + (size + 1,), fill, dtype=torch.int64,
                     device=mask.device)
    out.scatter_(-1, slot, torch.arange(n, device=mask.device).expand(slot.shape))
    return out[..., :size], pos[..., -1] + 1


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
    """Crossing-mask compaction with a per-128-row survivor cap, along the
    last dimension (leading dimensions are rows of a batch, each compacted
    on its own).

    Each 128-sample block's ascending set positions come from one ``topk``
    of ``-lane``; blocks keep at most `row_cap`.  Returns (indices int64
    (..., size), the exact true count (...), the row-overflow int32 flag
    (...)); a 1-D mask gives int64[size] and two scalars.  Integer
    throughout, so a row of a batch is exactly the 1-D call on it."""
    *lead, n = mask.shape
    dev = mask.device
    b = 128
    n_blk = -(-n // b)
    m = torch.nn.functional.pad(mask.to(torch.int32), (0, n_blk * b - n))
    m = m.reshape(-1, n_blk, b)
    rows = m.shape[0]
    lane = torch.arange(b, device=dev, dtype=torch.int32).expand(rows, n_blk, b)
    neg, _ = torch.topk(torch.where(m > 0, -lane, -(2 ** 30)), row_cap, dim=-1)
    lanes = -neg.to(torch.int64)                      # (rows, n_blk, row_cap)
    cnt = m.sum(dim=-1, dtype=torch.int64)            # (rows, n_blk)
    total = cnt.sum(-1)
    row_ovf = (cnt.amax(-1) > row_cap).to(torch.int32)
    cntc = torch.clamp(cnt, max=row_cap)
    coff = torch.cumsum(cntc, -1) - cntc
    j = torch.arange(row_cap, device=dev)
    valid = j < cntc[..., None]
    slot = torch.where(valid, coff[..., None] + j, size).clamp(max=size)
    base = torch.arange(n_blk, device=dev)[:, None] * b
    out = torch.full((rows, size + 1), fill, dtype=torch.int64, device=dev)
    out.scatter_(-1, slot.reshape(rows, -1), (lanes + base).reshape(rows, -1))
    return (out[:, :size].reshape(*lead, size), total.reshape(lead),
            row_ovf.reshape(lead))


def _first(k: int, max_level: int) -> int:
    """Chain entries filled by doubling: a power of two, at most 2^max_level."""
    return min(1 << (k - 1).bit_length(), 1 << max_level)


def _n_levels(k: int, first: int) -> int:
    """Level tables a walk reads: log2(first) for the doubling, one more
    (the first-step table) when a tail remains."""
    return max(first.bit_length() - 1 + (k > first), 1)


def _on_card(t: torch.Tensor, name: str) -> bool:
    """False for a CPU tensor (take the plain version), True for a CUDA
    tensor (launch the kernel); raises on any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def chain_compose_reference(delta: torch.Tensor, span: int, hi: int) -> torch.Tensor:
    """One squaring level of a strided delta table (int16, along the last
    dimension), as the JAX package writes it: ``delta + acc`` where ``acc``
    selects ``delta[i + s]`` (0 past the table's end) for the ``s`` in
    [span, hi] equal to ``delta[i]``.  A walk stalled within `span` steps
    (delta < span) keeps its delta, which is exact."""
    n = delta.shape[-1]
    acc = torch.zeros_like(delta)
    for s in range(span, hi + 1):
        if s < n:
            shifted = torch.cat([delta[..., s:], torch.zeros(
                delta.shape[:-1] + (s,), dtype=torch.int16, device=delta.device)], -1)
        else:  # shift past the table: everything lands on the pad
            shifted = torch.zeros_like(delta)
        acc = torch.where(delta == s, shifted, acc)
    return delta + acc


def _walk_reference(levels: torch.Tensor, start: int, k: int, first: int,
                    strided: bool) -> torch.Tensor:
    """The plain walk over (n_levels, rows, m) level tables: the doubling
    fill of ``chain[:first]`` (level p extends ``chain[2^p : 2^(p+1)]``),
    then the tail, ``first`` entries per step through the last level.  A
    step is ``nc + d[nc]`` over delta tables (`strided`), ``J[nc]`` over
    jump tables."""
    def step(table, nc):  # int64 + int16 deltas promotes to int64
        got = torch.gather(table, -1, nc)
        return nc + got if strided else got

    rows = levels.shape[1]
    # every slot past 0 is written below; a full() and not chain0[0] = start,
    # which copies the scalar from the host and waits for the device
    chain0 = torch.full((rows, first), start, dtype=torch.int64, device=levels.device)
    s2 = 1
    for table in levels:
        if s2 >= first:
            break
        chain0[:, s2: 2 * s2] = step(table, chain0[:, :s2])
        s2 *= 2
    if first >= k:
        return chain0[:, :k]
    last = levels[-1]
    pieces = [chain0]
    nc = chain0
    for _ in range(-(-(k - first) // first)):
        nc = step(last, nc)
        pieces.append(nc)
    return torch.cat(pieces, 1)[:, :k]


def chain_walk_strided_reference(levels: torch.Tensor, start: int, k: int,
                                 first: int) -> torch.Tensor:
    """The (rows, k) int64 chain from `start` over (n_levels, rows, m) int16
    delta tables (level p holds ``next^(2^p)[i] - i``; the last one is the
    tail's)."""
    return _walk_reference(levels, start, k, first, strided=True)


def chain_walk_reference(levels: torch.Tensor, start: int, k: int,
                         first: int) -> torch.Tensor:
    """Plain version of :func:`chain_walk`."""
    return _walk_reference(levels, start, k, first, strided=False)


def chain_walk(levels: torch.Tensor, start: int, k: int, first: int) -> torch.Tensor:
    """The (rows, k) int64 chain from `start` over (n_levels, rows, m) int64
    full jump tables (level p holds ``next^(2^p)``; the last one is the
    tail's).  On the card one launch of ``chain_walk_kernel`` for every row."""
    if not _on_card(levels, "chain_walk"):
        return chain_walk_reference(levels, start, k, first)
    from .kernels import extension

    out = extension().chain_walk(levels, start, k, first)
    if out.numel():
        chain_walk.launches += 1
    return out


chain_walk.launches = 0


def jump_levels(next_idx: torch.Tensor, k: int, max_level: int = 6):
    """(the (n_levels, rows, m) int64 tables ``next^(2^p)`` a `k`-step walk
    reads, first): the squarings ``J_(p+1) = J_p[J_p]`` as gathers, the one
    no step reads skipped."""
    m = next_idx.shape[-1]
    first = _first(k, max_level)
    jumps = next_idx.reshape(-1, m).to(torch.int64)
    levels = [jumps]
    for _ in range(1, _n_levels(k, first)):
        jumps = torch.gather(jumps, -1, jumps)
        levels.append(jumps)
    return torch.stack(levels), first


def delta_levels(next_idx: torch.Tensor, k: int, stride_bound: int = 4,
                 max_level: int = 7):
    """(the (n_levels, rows, m) int16 tables ``next^(2^p)[i] - i`` a
    `k`-step walk reads, first), each level from the one before by
    :func:`chain_compose_reference`."""
    assert stride_bound << max_level <= 32767, "delta exceeds int16"
    m = next_idx.shape[-1]
    rows = next_idx.reshape(-1, m)
    first = _first(k, max_level)
    levels = torch.empty((_n_levels(k, first),) + rows.shape, dtype=torch.int16,
                         device=rows.device)
    levels[0] = rows.to(torch.int64) - torch.arange(m, device=rows.device)
    span, hi = 1, stride_bound
    for j in range(1, levels.shape[0]):
        levels[j] = chain_compose_reference(levels[j - 1], span, hi)
        span *= 2
        hi *= 2
    return levels, first


def chain_enumerate(next_idx: torch.Tensor, start: int, length: int,
                    max_level: int = 6) -> torch.Tensor:
    """``chain[j+1] = next_idx[chain[j]]`` for `length` steps along the last
    dimension (fixed points repeat at the end), for any map.  The jump table
    is squared up to 2^max_level steps, then span-sized chunks are extended
    with it (:func:`chain_walk`).  No decode path calls it: frame sync's
    bounded-stride chain is :func:`chain_enumerate_frames`."""
    k = int(length)
    levels, first = jump_levels(next_idx, k, max_level)
    return chain_walk(levels, start, k, first).reshape(next_idx.shape[:-1] + (k,))


def chain_enumerate_reference(next_idx: torch.Tensor, start: int, length: int,
                              max_level: int = 6) -> torch.Tensor:
    """:func:`chain_enumerate` in plain PyTorch on any device."""
    k = int(length)
    levels, first = jump_levels(next_idx, k, max_level)
    return chain_walk_reference(levels, start, k, first).reshape(next_idx.shape[:-1] + (k,))


# chain_walk_frames' tiling: warps of a tile (at most 32), segments of 32
# entries a warp (1, 2, 4 or 8); swept on the card by tools/chain_variants.py
# --frames (ops/kernels/chain.cu's header)
FRAME_STRIDE = 32
FRAME_WARPS = 16
FRAME_SEGMENTS_PER_WARP = 4


def chain_enumerate_frames(succ: torch.Tensor, start: int, length: int,
                           max_level: int = 6) -> torch.Tensor:
    """:func:`chain_enumerate` for successor maps with ``succ[i] - i`` in
    {0} ∪ [1, FRAME_STRIDE] and ``succ[i] < m`` (frame sync's, from
    :func:`frame_successors`), along the last dimension.

    On a CPU tensor :func:`chain_enumerate_reference`, the JAX package's
    structure (jump tables up to 2^max_level, then the tail).  On the card one
    launch of ``chain_walk_frames`` (and one fill of its look-back flags),
    which computes ``succ^j(start)`` without jump tables; the result is the
    same bit for bit, whatever `max_level` the reference would use."""
    k = int(length)
    if not _on_card(succ, "chain_enumerate_frames"):
        return chain_enumerate_reference(succ, start, k, max_level)
    from .kernels import extension

    m = succ.shape[-1]
    rows = succ.reshape(-1, m).to(torch.int64).contiguous()
    if rows.shape[0] == 0 or k == 0:
        return torch.empty(succ.shape[:-1] + (k,), dtype=torch.int64, device=succ.device)
    out = extension().chain_walk_frames(rows, int(start), k, FRAME_WARPS,
                                        FRAME_SEGMENTS_PER_WARP)
    chain_enumerate_frames.launches += 1
    return out.reshape(succ.shape[:-1] + (k,))


chain_enumerate_frames.launches = 0


# chain_walk_segments' tiling: segments of SEGMENT entries (a multiple of 4),
# SEGMENTS_PER_BLOCK of them (a power of two, one a thread) per block; swept on
# the card by tools/chain_variants.py --sweep (ops/kernels/chain.cu's header)
SEGMENT = 32
SEGMENTS_PER_BLOCK = 128


def chain_enumerate_strided(next_idx: torch.Tensor, start: int, length: int,
                            stride_bound: int = 4,
                            max_level: int = 7) -> torch.Tensor:
    """`chain_enumerate` for successor maps with ``next_idx[i] - i`` in
    {0} ∪ [1, stride_bound] (the bit-edge chain), along the last dimension.

    On a CPU tensor :func:`chain_enumerate_strided_reference`, the JAX
    package's structure.  On the card one call of ``chain_walk_segments``
    (three launches: segment records, the scan over tiles, the write; built
    for stride_bound 4, the bit edges'), which computes ``next^j(start)``
    without level tables; the result is the same bit for bit, whatever
    `max_level` the reference would use."""
    k = int(length)
    if not _on_card(next_idx, "chain_enumerate_strided"):
        return chain_enumerate_strided_reference(next_idx, start, k, stride_bound, max_level)
    from .kernels import extension

    m = next_idx.shape[-1]
    rows = next_idx.reshape(-1, m).to(torch.int64).contiguous()
    if rows.shape[0] == 0 or k == 0:
        return torch.empty(next_idx.shape[:-1] + (k,), dtype=torch.int64, device=next_idx.device)
    out = extension().chain_walk_segments(rows, int(start), k, stride_bound, SEGMENT,
                                          SEGMENTS_PER_BLOCK)
    chain_enumerate_strided.launches += 3
    return out.reshape(next_idx.shape[:-1] + (k,))


chain_enumerate_strided.launches = 0


def chain_enumerate_strided_reference(next_idx: torch.Tensor, start: int, length: int,
                                      stride_bound: int = 4,
                                      max_level: int = 7) -> torch.Tensor:
    """:func:`chain_enumerate_strided` in plain PyTorch on any device, as
    the JAX package computes it: the level tables ``delta_2L[i] = delta_L[i]
    + delta_L[i + delta_L[i]]`` by shifted selects over ``delta_L[i + s]``,
    s in [L, stride_bound*L] (a stalled walk keeps its delta, which is exact),
    then the doubling fill of the first ``first`` entries and a host loop of
    small gathers for the tail."""
    k = int(length)
    levels, first = delta_levels(next_idx, k, stride_bound, max_level)
    return chain_walk_strided_reference(levels, start, k, first).reshape(
        next_idx.shape[:-1] + (k,))


def bit_edge_successors(crossings: torch.Tensor, n_valid, fs: float,
                        bitrate: float) -> torch.Tensor:
    """Successor table of the greedy 4-candidate bit-edge chain: i + 1 +
    argmin over the next four crossings of their distance to crossings[i] +
    fs/bitrate (ties keep the earlier); positions with fewer than 5
    crossings left are fixed points.  Along the last dimension."""
    m = crossings.shape[-1]
    dev = crossings.device
    big = torch.iinfo(torch.int32).max // 2
    padded = torch.cat([crossings, torch.full(crossings.shape[:-1] + (5,), big,
                                              dtype=crossings.dtype, device=dev)], -1)
    target = torch.full((), fs / bitrate, dtype=torch.float32, device=dev)
    pick = torch.zeros(crossings.shape, dtype=torch.int64, device=dev)
    # distances on small integer gaps: absolute positions in f32 would
    # quantize by ~2 samples on long files
    best = torch.abs((padded[..., 1: 1 + m] - crossings).to(torch.float32) - target)
    for s in range(2, 5):
        d = torch.abs((padded[..., s: s + m] - crossings).to(torch.float32) - target)
        better = d < best
        pick = torch.where(better, s - 1, pick)
        best = torch.where(better, d, best)
    idx = torch.arange(m, device=dev)
    nxt = torch.where(idx < _col(n_valid) - 5, idx + 1 + pick, idx)
    return torch.clamp(nxt, 0, m - 1)


def enumerate_bit_edges(crossings: torch.Tensor, n_valid, fs: float,
                        bitrate: float, max_edges: int):
    """(edge positions int64[..., max_edges] as crossing-array indices,
    n_edges per row); entries beyond n_edges repeat the terminal index."""
    nxt = bit_edge_successors(crossings, n_valid, fs, bitrate)
    chain = chain_enumerate_strided(nxt, 0, max_edges)
    advanced = torch.cat([torch.ones(chain.shape[:-1] + (1,), dtype=torch.bool,
                                     device=chain.device),
                          chain[..., 1:] > chain[..., :-1]], -1)
    n_edges = torch.cumprod(advanced.to(torch.int64), -1).sum(-1)
    return chain, n_edges


def frame_successors(accept: torch.Tensor, n_bits):
    """Frame sync's successor table in the accept-compacted domain, along the
    last dimension: (apos int64[..., cap], the accepted offsets ascending then
    a fill, cap = n/16 + 1024 (16x the densest real stream's, see the JAX
    module); n_acc, the true count per row (may exceed cap); succ int64[...,
    cap], the index of the first accept at or after ``apos[j] + 32``).

    Accepts are distinct and ascending, so ``apos[j + 32] >= apos[j] + 32``
    and ``succ[j] - j`` lies in [1, FRAME_STRIDE]; the guard makes every
    other entry (past the kept accepts, or with no accept after it) a fixed
    point: the precondition of :func:`chain_enumerate_frames`."""
    n = accept.shape[-1]
    dev = accept.device
    cap = min(n, n // 16 + 1024)
    big = torch.iinfo(torch.int32).max // 2
    idx = torch.arange(n, device=dev)
    accept = accept & (idx < _col(n_bits) - 32)
    apos, n_acc = compact_indices(accept, cap, big)
    apos = apos.clone()  # contiguous for searchsorted: one copy whatever the batch

    n_keep = torch.clamp(n_acc, max=cap)
    succ = torch.searchsorted(apos, apos + 32)
    j = torch.arange(cap, device=dev)
    succ = torch.where((j < _col(n_keep)) & (succ < _col(n_keep)), succ, j)
    return apos, n_acc, succ


def enumerate_frames(accept: torch.Tensor, n_bits, max_frames: int,
                     max_level: int = 6):
    """Frame sync over the whole bit stream: advance 1 bit on a reject, 32
    on an accepted frame, stop at ``n_bits - 32`` (parse.py:57-89).

    The walk is "next accepted offset at or after s + 32", run in the
    accept-compacted domain.  Along the last dimension, with `n_bits` a
    tensor per row.  Returns (frame_starts int64[..., max_frames],
    n_frames, consumed, overflow int32: bit 0 accepts exceeded the
    compaction capacity, bit 1 the frame table filled)."""
    n = accept.shape[-1]
    apos, n_acc, succ = frame_successors(accept, n_bits)
    cap = apos.shape[-1]
    chain = chain_enumerate_frames(succ, 0, max_frames, max_level=max_level)
    advancing = torch.cat([(n_acc > 0)[..., None], chain[..., 1:] > chain[..., :-1]], -1)
    is_frame = torch.cumprod(advancing.to(torch.int64), -1).to(torch.bool)
    n_frames = is_frame.to(torch.int64).sum(-1)
    starts = torch.where(is_frame, torch.gather(apos, -1, torch.clamp(chain, 0, cap - 1)), 0)

    floor_pos = torch.clamp(n_bits - 32, min=0)
    last_start = torch.where(is_frame, starts, -1).amax(-1)
    last_end = torch.where(n_frames > 0, last_start + 32, 0)
    consumed = torch.clamp(torch.maximum(floor_pos, last_end), max=n - 1)
    overflow = ((n_acc > cap).to(torch.int32)
                | ((n_frames >= max_frames).to(torch.int32) << 1))
    return starts, n_frames, consumed, overflow
