"""The segment-parallel walk of ``ops/kernels/chain.cu`` (chain_walk_segments)
as a numpy model, against the JAX package, on the CPU.

The CUDA kernel has no CPU mode, so its decomposition is held here instead:
a test-local numpy model of exactly the three kernels it launches, with the
same tiling rule (segments of ``seg`` >= stride_bound entries, ``tpb`` (a power
of two) segments per tile, the tiling's origin at ``start``), the same map
records and the same order of composition.  The kernel also wants ``seg`` a
multiple of 4 (it keeps four deltas to a word); the decomposition does not,
so the model runs odd segment sizes as well:

* records: each segment's map of its first ``sb`` entries (exit offset into
  the next segment or STOP with the tile-relative terminal, and the chain
  entries passed) by one backward pass with a window of the next ``sb``
  entries' results, each tile's map by a tree of pairwise compositions;
* scan: the tiles' maps composed over 32 lanes, each a run of tiles, then
  across the lanes from entry 0; each tile's true entry and rank, the row's
  length and terminal;
* write: the tile's segment maps scanned inclusively (Hillis-Steele), each
  live segment passed again forward from its true entry, then the terminal
  repeated to k.

The model must give JAX's ``chain_enumerate_strided`` (jit on the CPU) and the
port's ``chain_enumerate_strided_reference`` bit for bit.  JAX compiles its
level tables at ``max_level`` 3 (first = 8): the result does not depend on the
level count, and XLA's CPU compile of the decode's eight shifted-select
levels takes minutes.  A last test shows that the records' composition is
associative: any grouping of a row's segment maps gives the same map, and
another that the backward pass gives the walk from each entry.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from axctdprocessor_tpu.ops import chain as jchain
from axctdprocessor_tpu_torch.ops import chain

SB = 4      # the bit-edge chain's stride bound
LANES = 32  # chain.cu kLanes: the scan's warp

# ---------------------------------------------------------------------------
# the model: one row, three phases
# ---------------------------------------------------------------------------


def _then(a, b):
    """Map entry ``a`` = (st, cnt), then the map ``b`` (indexed by entry)."""
    st, cnt = a
    if st < 0:
        return a
    return b[st][0], cnt + b[st][1]


def _compose(a, b):
    """The map ``a``, then the map ``b`` (both (sb, 2))."""
    return np.asarray([_then(x, b) for x in a], np.int64)


def _walk(d, pos, hi):
    """A walk of one segment (positions below `hi`) from `pos`: (exit offset
    into the next segment, or -1 - terminal; chain entries passed)."""
    cnt = 0
    while True:
        cnt += 1
        dd = int(d[pos])
        if dd == 0:
            return -1 - pos, cnt
        if pos + dd >= hi:
            return pos + dd - hi, cnt
        pos += dd


def _segment_map(dseg, base, sb):
    """The map of a segment's first `sb` entries by the kernel's backward
    pass: the walk from entry j goes on as the walk from j + d[j], whose
    result the window ``w`` holds (``w[k]``: entry j + 1 + k; past the end,
    the exit at offset k).  `base`: the segment's first tile position."""
    w = [(k, 0) for k in range(sb)]
    for j in range(len(dseg) - 1, -1, -1):
        dd = int(dseg[j])
        r = (-1 - (base + j), 1) if dd == 0 else (w[dd - 1][0], w[dd - 1][1] + 1)
        w = [r] + w[:-1]
    return w


def phase_records(nxt, start, seg, tpb, sb):
    """chain_segments_records over every tile of one row: (the tiles'
    deltas (n_blk, tile), segment maps (n_blk, tpb, sb, 2) with tile-relative
    terminals, tile maps (n_blk, sb, 2))."""
    m = len(nxt)
    n, tile = m - start, seg * tpb
    n_blk = -(-n // tile)
    d = np.zeros(n_blk * tile, np.int64)
    d[:n] = np.asarray(nxt[start:], np.int64) - np.arange(start, m)
    d = d.reshape(n_blk, tile)
    seg_rec = np.zeros((n_blk, tpb, sb, 2), np.int64)
    blk_rec = np.zeros((n_blk, sb, 2), np.int64)
    for b in range(n_blk):
        for t in range(tpb):  # past the row's end the deltas are 0: fixed points
            seg_rec[b, t] = _segment_map(d[b, t * seg: (t + 1) * seg], t * seg, sb)
        rec = seg_rec[b].copy()
        h = 1
        while h < tpb:  # the tree, in place, as the kernel's shared buffer
            for i in range(0, tpb, 2 * h):
                rec[i] = _compose(rec[i], rec[i + h])
            h *= 2
        blk_rec[b] = rec[0]
    return d, seg_rec, blk_rec


def phase_scan(blk_rec, tile):
    """chain_segments_scan of one row: (each tile's entry (-1 once the chain
    has ended) and rank (n_blk, 2), (-1 - terminal, length))."""
    n_blk, sb, _ = blk_rec.shape
    run = -(-n_blk // LANES)
    lane_map, chunks = [], []
    for lane in range(LANES):
        b0 = min(lane * run, n_blk)
        chunks.append(range(b0, min(b0 + run, n_blk)))
        a = [(e, 0) for e in range(sb)]
        for b in chunks[-1]:
            for e in range(sb):
                if a[e][0] >= 0:
                    st, cnt = blk_rec[b, a[e][0]]
                    a[e] = (st if st >= 0 else st - b * tile, a[e][1] + cnt)
        lane_map.append(a)
    x, lane_in = (0, 0), []
    for lane in range(LANES):
        lane_in.append(x)
        x = _then(x, lane_map[lane])
    row_end = x
    blk_in = np.zeros((n_blk, 2), np.int64)
    for lane in range(LANES):
        x = lane_in[lane]
        for b in chunks[lane]:
            blk_in[b] = (x[0] if x[0] >= 0 else -1, x[1])
            if x[0] >= 0:
                st, cnt = blk_rec[b, x[0]]
                x = (st if st >= 0 else -1, x[1] + cnt)
    return blk_in, row_end


def phase_write(d, seg_rec, blk_in, row_end, start, k, seg, tpb):
    """chain_segments_write of one row: the (k,) chain."""
    n_blk = len(blk_in)
    tile = seg * tpb
    out = np.full(k, -7, np.int64)  # every slot is written below
    for b in range(n_blk):
        e0, base = blk_in[b]
        if e0 >= 0 and base < k:
            cur = seg_rec[b].copy()
            off = 1
            while off < tpb:
                cur = np.stack([_compose(cur[t - off], cur[t]) if t >= off else cur[t]
                                for t in range(tpb)])
                off *= 2
            buf = np.full(tile, -1, np.int64)
            for t in range(tpb):
                st, r = (e0, 0) if t == 0 else cur[t - 1][e0]
                if st >= 0:  # one forward pass from the true entry
                    nxt = st
                    for j in range(st, seg):
                        if j == nxt:
                            buf[r] = t * seg + j
                            r += 1
                            dd = int(d[b, t * seg + j])
                            nxt = seg if dd == 0 else j + dd
            n_out = min(int(cur[tpb - 1][e0][1]), k - base)
            out[base: base + n_out] = start + b * tile + buf[:n_out]
    # chain[length:k]: the kernel spreads it over the row's tiles
    out[row_end[1]:] = start + (-1 - row_end[0])
    return out


def model_chain(nxt_rows, start, k, seg, tpb, sb=SB):
    """The model's (rows, k) chain, row by row as the kernels' grid does."""
    out = []
    for nxt in np.asarray(nxt_rows):
        d, seg_rec, blk_rec = phase_records(nxt, start, seg, tpb, sb)
        blk_in, row_end = phase_scan(blk_rec, seg * tpb)
        out.append(phase_write(d, seg_rec, blk_in, row_end, start, k, seg, tpb))
    return np.stack(out)


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


def _random_map(rng, m, stall=0.0):
    """next[i] - i in [1, 4], a fraction `stall` of fixed points inside, the
    last entries clamped to the table (the last one a fixed point)."""
    nxt = np.arange(m) + rng.integers(1, SB + 1, m)
    nxt = np.where(rng.random(m) < stall, np.arange(m), nxt)
    return np.minimum(nxt, m - 1)


def _successors(rng, m, n_valid):
    """The port's bit-edge successor table of crossings spaced like the
    800-baud signal's at 44.1 kHz, each row live up to its `n_valid`."""
    cross = np.cumsum(rng.integers(12, 24, (len(n_valid), m)), axis=1)
    cross = np.where(np.arange(m) < np.asarray(n_valid)[:, None], cross,
                     np.iinfo(np.int32).max // 2)
    return chain.bit_edge_successors(torch.from_numpy(cross), torch.as_tensor(n_valid),
                                     44100.0, 800.0).numpy()


def _case(name):
    """(successor rows (rows, m), start, k) of each named case."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "random, no fixed point inside":
        return np.stack([_random_map(rng, 3000) for _ in range(2)]), 0, 1200
    if name == "random, fixed points inside":
        return np.stack([_random_map(rng, 3000, stall=0.01) for _ in range(2)]), 0, 1200
    if name == "stride 4 onto every boundary":
        # from 0 the chain steps on every multiple of 4, so it enters every
        # segment of 4, 64 and 256 entries at offset 0; a fixed point at 1280
        # (a first entry for seg 4, 5, 64 and 256), and one at 1279 (a last
        # entry for all four), reached by a step of 3 from 1276
        step4 = np.minimum(np.arange(2100) + 4, 2099)
        first, last = step4.copy(), step4.copy()
        first[1280] = 1280
        last[[1276, 1279]] = [1279, 1279]
        return np.stack([step4, first, last]), 0, 900
    if name == "m < seg":
        return np.stack([_random_map(rng, 50), _random_map(rng, 50, stall=0.05)]), 0, 30
    if name == "k = 1":
        return np.stack([_random_map(rng, 700)]), 0, 1
    if name == "k longer than the chain":
        return np.stack([_random_map(rng, 600, stall=0.02) for _ in range(2)]), 0, 900
    if name == "k shorter than the chain":
        return np.stack([_random_map(rng, 4000)]), 0, 300
    if name == "start != 0":
        return np.stack([_random_map(rng, 2000, stall=0.01) for _ in range(2)]), 333, 700
    if name == "rows of different n_valid, a dead row":
        return _successors(rng, 2500, [2500, 1700, 400, 0]), 0, 1000
    raise KeyError(name)


CASES = ["random, no fixed point inside", "random, fixed points inside",
         "stride 4 onto every boundary", "m < seg", "k = 1", "k longer than the chain",
         "k shorter than the chain", "start != 0", "rows of different n_valid, a dead row"]


@functools.lru_cache(maxsize=None)
def _want(name):
    """(case, JAX's chain of every row, the port's reference)."""
    nxt, start, k = _case(name)
    fn = jax.jit(jchain.chain_enumerate_strided, static_argnums=(2, 3, 4))
    jax_rows = np.stack([np.asarray(fn(jnp.asarray(r.astype(np.int32)), start, k, SB, 3))
                         for r in nxt])
    ref = chain.chain_enumerate_strided_reference(torch.from_numpy(nxt), start, k).numpy()
    return (nxt, start, k), jax_rows, ref


@pytest.mark.parametrize("seg,tpb", [(4, 8), (5, 4), (64, 2), (256, 4)])
@pytest.mark.parametrize("name", CASES)
def test_segment_model_equals_jax(name, seg, tpb):
    """The model at each segment size (seg >= stride_bound) against JAX and
    the port's plain version, bit for bit; and JAX equal to the port's."""
    (nxt, start, k), jax_rows, ref = _want(name)
    np.testing.assert_array_equal(ref, jax_rows)
    got = model_chain(nxt, start, k, seg, tpb)
    assert got.shape == (len(nxt), k)
    np.testing.assert_array_equal(got, jax_rows, err_msg=f"{name}, seg {seg}, tpb {tpb}")


def test_segment_model_kernel_tiling_and_rows_alone():
    """The kernel's own tiling (ops.chain.SEGMENT, SEGMENTS_PER_BLOCK) on
    rows longer than one tile, each row equal to its 1-D plain call."""
    rng = np.random.default_rng(12)
    nxt = _successors(rng, 20000, [20000, 9000, 17000])
    got = model_chain(nxt, 0, 6000, chain.SEGMENT, chain.SEGMENTS_PER_BLOCK)
    for r in range(len(nxt)):
        one = chain.chain_enumerate_strided(torch.from_numpy(nxt[r]), 0, 6000).numpy()
        np.testing.assert_array_equal(got[r], one)


@pytest.mark.parametrize("seg", [4, 5, 64, 256])
def test_segment_maps_equal_walks_from_each_entry(seg):
    """The backward pass's map of every segment equals the walk from each of
    its first sb entries that lies before the row's end."""
    rng = np.random.default_rng(seg)
    nxt = _random_map(rng, 2000 + seg // 3, stall=0.01)
    d, seg_rec, _ = phase_records(nxt, 7, seg, 4, SB)
    n = len(nxt) - 7
    for b, tile_maps in enumerate(seg_rec):
        for t, rec in enumerate(tile_maps):
            for e in range(SB):
                if b * 4 * seg + t * seg + e < n:
                    assert tuple(rec[e]) == _walk(d[b], t * seg + e, (t + 1) * seg), (b, t, e)


def _grouped(maps, rng):
    """The composition of `maps` in a random binary grouping."""
    if len(maps) == 1:
        return maps[0]
    cut = int(rng.integers(1, len(maps)))
    return _compose(_grouped(maps[:cut], rng), _grouped(maps[cut:], rng))


@pytest.mark.parametrize("seed", range(4))
def test_record_composition_is_associative(seed):
    """A row's segment maps (terminals made row-relative) composed left to
    right and in random groupings: the same map for every entry, and from
    entry 0 the chain's length and terminal."""
    rng = np.random.default_rng(seed)
    seg, tpb = 5, 4
    nxt = _random_map(rng, 900, stall=0.004 * seed)
    _, seg_rec, _ = phase_records(nxt, 0, seg, tpb, SB)
    maps = []
    for b, tile_maps in enumerate(seg_rec):
        for rec in tile_maps:
            rec = rec.copy()
            rec[:, 0] = np.where(rec[:, 0] < 0, rec[:, 0] - b * seg * tpb, rec[:, 0])
            maps.append(rec)
    left = functools.reduce(_compose, maps)
    for _ in range(5):
        np.testing.assert_array_equal(_grouped(maps, rng), left)
    want = chain.chain_enumerate_strided_reference(torch.from_numpy(nxt), 0, len(nxt)).numpy()
    length = int(np.sum(np.concatenate([[True], want[1:] > want[:-1]])))
    assert left[0][1] == length and -1 - left[0][0] == want[-1]
