"""Frame sync's walk of ``ops/kernels/chain.cu`` (chain_walk_frames) as a
numpy model, and the stride bound it rests on, against the JAX package on the
CPU.

The CUDA kernel has no CPU mode, so its decomposition is held here instead: a
test-local numpy model of its one pass, with the same tiling (a tile of
``warps`` warps, each ``spw`` segments of 32 entries, the tiling's origin at
``start``), the same records and the same order of composition:

* lanes: entry e of a segment is lane e; the walk from each entry to where it
  leaves the segment (exit offset, or STOP with the terminal) and the entries
  it passes, by 5 rounds of pointer jumping (``p[q]`` stands for
  ``__shfl_sync``), the rounds' pointers packed 6 bits each;
* composition: a warp's segment maps left to right, then an inclusive
  Hillis-Steele scan over the tile's warps;
* look-back: each tile publishes its map, then folds its predecessors' maps
  back to the nearest one that has published its exit state, in windows of
  32; which predecessors have done so is drawn at random for every tile, as
  the tiles' arrival on the card would leave it;
* write: each live segment's positions by the doubling fill through the
  rounds' pointers, the row's last tile repeating the terminal to k.

The model must give JAX's ``chain_enumerate`` and ``enumerate_frames`` (jit
on the CPU) and the port's ``chain_enumerate_reference`` bit for bit.  The
successor tables come from the port's ``frame_successors``, whose stride bound
(``succ[i] - i`` in {0} ∪ [1, 32]) the kernel needs; a test holds it on
random accept masks from sparse to overflowing.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from axctdprocessor_tpu.ops import chain as jchain
from axctdprocessor_tpu_torch.ops import chain

LANES = 32
NONE = 32  # chain.cu kNone: the walk has left the segment or stopped

# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _then(a, b):
    """Per lane: the state ``a`` = (st, cnt), then the map ``b`` whose entry e
    lane e holds (``then_warp``: one shuffle from lane ``a.st``)."""
    q = np.where(a[0] >= 0, a[0], 0)
    return (np.where(a[0] >= 0, b[0][q], a[0]),
            np.where(a[0] >= 0, a[1] + b[1][q], a[1]))


def _segments(d, base):
    """Every segment of 32 entries at once: d (n_seg, 32) deltas, base
    (n_seg,) each segment's first entry from start.  Returns (the maps'
    (st, cnt), the rounds' pointers packed 6 bits each), (n_seg, 32) each."""
    lane = np.arange(LANES)[None, :]
    p = np.where(d == 0, -1 - lane, lane + d)
    c = np.ones_like(p)
    word = np.zeros_like(p)
    for r in range(5):
        inside = (p >= 0) & (p < LANES)
        word |= np.where(inside, p, NONE) << (6 * r)
        q = np.where(inside, p, lane)
        pq = np.take_along_axis(p, q, 1)  # __shfl_sync(p, q)
        cq = np.take_along_axis(c, q, 1)
        p, c = np.where(inside, pq, p), np.where(inside, c + cq, c)
    assert ((p < 0) | (p >= LANES)).all(), "5 rounds leave every walk out of its segment"
    st_ = np.where(p < 0, -1 - (base[:, None] + (-1 - p)), p - LANES)
    return (st_, c), word


def _fill(x, word):
    """Lane i's chain[rank + i] from the entry x by doubling through the
    rounds' pointers (NONE once the walk has left or stopped)."""
    lane = np.arange(LANES)
    pos = np.where(lane == 0, x, NONE)
    for r in range(5):
        q = pos[np.where(lane >= 1 << r, lane - (1 << r), 0)]
        lq = word[np.where(q == NONE, 0, q)]
        upd = (lane >= 1 << r) & (lane < 2 << r)
        pos = np.where(upd, np.where(q == NONE, NONE, (lq >> (6 * r)) & 63), pos)
    return pos


def model_row(succ, start, k, warps, spw, rng):
    """The kernel's (k,) chain of one row; `rng` draws which predecessors a
    tile finds with their exit state published."""
    m = len(succ)
    n = m - start
    tile = warps * spw * LANES
    n_tiles = -(-n // tile)
    i = np.arange(n_tiles * tile)
    v = np.where(i < n, np.asarray(succ, np.int64)[np.minimum(start + i, m - 1)], start + i)
    n_seg = len(i) // LANES
    seg_map, seg_word = _segments((v - (start + i)).reshape(n_seg, LANES),
                                  np.arange(n_seg) * LANES)
    seg_map = np.stack(seg_map, 1)  # (n_seg, 2, 32)
    out = np.full(k, -7, np.int64)  # every slot is written below
    agg, inc, flag = {}, {}, {}
    for b in range(n_tiles):
        segs = np.arange(b * warps * spw, (b + 1) * warps * spw).reshape(warps, spw)
        pre = []  # each warp's run of segments, then the inclusive scan
        for w in range(warps):
            run = tuple(seg_map[segs[w, 0]])
            for s in segs[w, 1:]:
                run = _then(run, seg_map[s])
            pre.append(run)
        off = 1
        while off < warps:
            pre = [_then(pre[w - off], pre[w]) if w >= off else pre[w] for w in range(warps)]
            off *= 2
        whole = pre[-1]
        tin = (0, 0)
        if b > 0:
            agg[b] = whole
            for t in range(b):  # as the tiles' arrival may leave them
                flag[t] = 2 if t == 0 else int(rng.integers(1, 3))
            c = (np.arange(LANES), np.zeros(LANES, np.int64))
            j = b - 1
            while True:
                ready = [lane for lane in range(LANES) if j - lane >= 0 and flag[j - lane] == 2]
                upto = ready[0] if ready else LANES
                for s in range(upto):
                    c = _then(agg[j - s], c)
                if ready:
                    x = inc[j - upto]
                    tin = x if x[0] < 0 else (int(c[0][x[0]]), x[1] + int(c[1][x[0]]))
                    break
                j -= LANES
        e = tin if tin[0] < 0 else (int(whole[0][tin[0]]), tin[1] + int(whole[1][tin[0]]))
        inc[b] = e
        for w in range(warps):
            x = tin if w == 0 or tin[0] < 0 else (
                int(pre[w - 1][0][tin[0]]), tin[1] + int(pre[w - 1][1][tin[0]]))
            for s in segs[w]:
                if x[0] < 0 or x[1] >= k:
                    break
                pos = _fill(x[0], seg_word[s])
                for lane in range(LANES):
                    if pos[lane] != NONE and x[1] + lane < k:
                        out[x[1] + lane] = start + s * LANES + pos[lane]
                x = (int(seg_map[s, 0, x[0]]), x[1] + int(seg_map[s, 1, x[0]]))
        if b == n_tiles - 1:  # the row ends at a fixed point
            assert e[0] < 0
            out[e[1]:] = start + (-1 - e[0])
    return out


def model_chain(succ_rows, start, k, warps, spw, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([model_row(r, start, k, warps, spw, rng)
                     for r in np.asarray(succ_rows).reshape(-1, np.shape(succ_rows)[-1])])


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


def _accepts(rng, n, density, runs=False):
    """A random accept mask; with `runs`, a run of accepts every 32 bits
    from a random offset (a clean stretch of frames)."""
    a = rng.random(n) < density
    if runs:
        s = int(rng.integers(0, n // 2))
        a[s: s + n // 3: 32] = True
    return a


def _successors(accept, n_bits):
    _, _, succ = chain.frame_successors(torch.from_numpy(accept), torch.as_tensor(n_bits))
    return succ.numpy()


def _case(name):
    """(successor rows (rows, m), start, k) of each named case."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "accepts, sparse to overflowing":
        n = 3000  # cap = 1211
        rows = [_successors(_accepts(rng, n, dens, runs=dens < 0.5), n - int(rng.integers(0, 400)))
                for dens in (0.01, 0.1, 0.4, 0.95)]
        return np.stack(rows), 0, 600
    if name == "stride 32 onto every segment and tile boundary":
        m = 2100
        s32 = np.minimum(np.arange(m) + 32, m - 1)
        first, last = s32.copy(), s32.copy()
        first[5 * LANES] = 5 * LANES                      # a warp's first lane
        last[[7 * LANES, 8 * LANES - 1]] = 8 * LANES - 1  # a warp's last lane, by a step of 31
        return np.stack([s32, first, last]), 0, 80
    if name == "cap < 32":
        return np.stack([_successors(_accepts(rng, 20, 0.3), 20),
                         np.minimum(np.arange(20) + rng.integers(1, 9, 20), 19)]), 0, 12
    if name == "cap no multiple of a segment, start != 0":
        rows = np.minimum(np.arange(1000) + rng.integers(1, 33, (2, 1000)), 999)
        rows[1, 700] = 700
        return rows, 45, 300
    if name == "a dead row beside live rows, overflow":
        n = 2500
        rows = [_successors(_accepts(rng, n, 0.05, runs=True), n),
                _successors(np.zeros(n, bool), n),
                _successors(_accepts(rng, n, 0.9), n)]
        return np.stack(rows), 0, 400
    if name == "k = 1":
        return np.stack([_successors(_accepts(rng, 3000, 0.1), 3000)]), 0, 1
    if name == "k longer than the chain":
        return np.stack([_successors(_accepts(rng, 3000, 0.02), 3000)]), 0, 1500
    if name == "rows of different n_keep":
        n = 1600
        acc = _accepts(rng, n, 0.3, runs=True)
        return np.stack([_successors(acc, nb) for nb in np.linspace(0, n, 12).astype(int)]), 0, 100
    raise KeyError(name)


CASES = ["accepts, sparse to overflowing", "stride 32 onto every segment and tile boundary",
         "cap < 32", "cap no multiple of a segment, start != 0",
         "a dead row beside live rows, overflow", "k = 1", "k longer than the chain",
         "rows of different n_keep"]


@functools.lru_cache(maxsize=None)
def _want(name):
    """(case, JAX's chain of every row, the port's reference)."""
    succ, start, k = _case(name)
    fn = jax.jit(jchain.chain_enumerate, static_argnums=(2,))
    jax_rows = np.stack([np.asarray(fn(jnp.asarray(r.astype(np.int32)), start, k)) for r in succ])
    ref = chain.chain_enumerate_reference(torch.from_numpy(succ), start, k).numpy()
    return (succ, start, k), jax_rows, ref


def _stride_ok(succ):
    d = succ - np.arange(succ.shape[-1])
    return bool((((d >= 1) & (d <= chain.FRAME_STRIDE)) | (d == 0)).all()
                and (succ < succ.shape[-1]).all())


@pytest.mark.parametrize("warps,spw", [(1, 1), (2, 2), (32, 1), (1, 2)])
@pytest.mark.parametrize("name", CASES)
def test_frame_model_equals_jax(name, warps, spw):
    """The model at segments of 32 and 64 entries a warp and tiles of 1, 2
    and 32 warps against JAX and the port's plain version, bit for bit; and
    JAX equal to the port's."""
    (succ, start, k), jax_rows, ref = _want(name)
    assert _stride_ok(succ), name
    np.testing.assert_array_equal(ref, jax_rows)
    got = model_chain(succ, start, k, warps, spw, seed=warps * 10 + spw)
    assert got.shape == (len(succ), k)
    np.testing.assert_array_equal(got, jax_rows, err_msg=f"{name}, {warps} warps x {spw}")


@pytest.mark.parametrize("seed", range(3))
def test_frame_model_any_arrival_order(seed):
    """Rows of 60 tiles of one segment: the look-back crosses windows of 32
    tiles, and whichever predecessors it finds with their exit state, the
    chain is the same."""
    rng = np.random.default_rng(40 + seed)
    succ = np.stack([_successors(_accepts(rng, 20000, 0.06, runs=True), 20000)])
    assert succ.shape[-1] > 60 * LANES
    want = chain.chain_enumerate_reference(torch.from_numpy(succ), 0, 900).numpy()
    for draw in range(3):
        got = model_chain(succ, 0, 900, 1, 1, seed=100 * seed + draw)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("density", [0.04, 0.6])
def test_enumerate_frames_through_model_equals_jax(density, monkeypatch):
    """The port's enumerate_frames with the model in place of its walk (the
    kernel's tiling, ops.chain.FRAME_WARPS and FRAME_SEGMENTS_PER_WARP)
    against JAX's enumerate_frames: starts, counts, consumed and overflow."""
    rng = np.random.default_rng(int(density * 100))
    n, n_bits = 8000, 7600
    accept = rng.random(n) < density
    max_frames = n // 32 + 8
    monkeypatch.setattr(chain, "chain_enumerate_frames", lambda succ, start, k, max_level=6: (
        torch.from_numpy(model_chain(succ.numpy(), start, k, chain.FRAME_WARPS,
                                     chain.FRAME_SEGMENTS_PER_WARP)).reshape(succ.shape[:-1] + (k,))))
    got = chain.enumerate_frames(torch.from_numpy(accept), torch.tensor(n_bits), max_frames)
    want = jax.jit(jchain.enumerate_frames, static_argnums=(2, 3))(
        jnp.asarray(accept), n_bits, n, max_frames)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@settings(max_examples=60, deadline=None, database=None)
@given(n=st.integers(1, 6000), density=st.floats(0.0, 1.0), cut=st.integers(0, 200),
       runs=st.booleans(), seed=st.integers(0, 2 ** 31))
def test_frame_successors_stride_bound(n, density, cut, runs, seed):
    """``frame_successors``' table: every entry a fixed point or 1 to 32
    entries on, and inside the table, at any accept density (overflowing the
    capacity too), with n_bits cut short and runs of frames every 32 bits."""
    rng = np.random.default_rng(seed)
    accept = _accepts(rng, n, density, runs=runs and n >= 64)
    succ = _successors(accept, max(n - cut, 0))
    assert succ.shape == (min(n, n // 16 + 1024),)  # the accept capacity
    assert _stride_ok(succ)


def test_frame_successors_reach_the_stride_bound():
    """A stride of exactly 32 occurs: accepts on every bit."""
    succ = _successors(np.ones(4000, bool), 4000)
    d = succ - np.arange(len(succ))
    assert d.max() == chain.FRAME_STRIDE and _stride_ok(succ)


def _grouped(maps, rng):
    if len(maps) == 1:
        return maps[0]
    cut = int(rng.integers(1, len(maps)))
    return _then(_grouped(maps[:cut], rng), _grouped(maps[cut:], rng))


@pytest.mark.parametrize("seed", range(4))
def test_frame_map_composition_is_associative(seed):
    """A row's 32-state segment maps composed left to right and in random
    groupings: the same map for every entry, and from entry 0 the chain's
    length and terminal."""
    rng = np.random.default_rng(seed)
    succ = _successors(_accepts(rng, 12000, 0.05 + 0.1 * seed, runs=True), 12000 - 50 * seed)
    n_seg = -(-len(succ) // LANES)
    i = np.arange(n_seg * LANES)
    v = np.where(i < len(succ), succ[np.minimum(i, len(succ) - 1)], i)
    (st_, cnt), _ = _segments((v - i).reshape(n_seg, LANES), np.arange(n_seg) * LANES)
    maps = [(st_[s], cnt[s]) for s in range(n_seg)]
    left = functools.reduce(_then, maps)
    for _ in range(5):
        g = _grouped(maps, rng)
        np.testing.assert_array_equal(g[0], left[0])
        np.testing.assert_array_equal(g[1], left[1])
    want = chain.chain_enumerate_reference(torch.from_numpy(succ), 0, len(succ)).numpy()
    length = int(np.sum(np.concatenate([[True], want[1:] > want[:-1]])))
    assert left[1][0] == length and -1 - left[0][0] == want[-1]
