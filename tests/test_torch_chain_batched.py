"""The batched chain walks and the batched back half against the JAX
package, on the CPU.

* one squaring level of a strided delta table in its gather form (a
  test-local torch helper) and in the port's plain
  ``chain_compose_reference`` against the JAX package's shifted select;
* the batched plain ``chain_enumerate_strided``, ``chain_enumerate`` and
  ``enumerate_frames`` against the jitted JAX functions row by row, at
  lengths around ``first`` (where the tail starts or is absent);
* the batched back half against JAX's vmapped ``_batched_back_half`` on the
  same stage-1 arrays (three rows of 30, 45 and 50 s), every row of a batch
  bitwise equal to the row alone, and the number of aten ops it dispatches
  the same for B = 1 and B = 4 (no loop over rows).

Integer outputs must match exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from axctdprocessor_tpu.models import tpu_engine as jeng
from axctdprocessor_tpu.ops import chain as jchain
from axctdprocessor_tpu.parallel import batch as jbatch
from axctdprocessor_tpu.utils.config import DecoderConfig
from axctdprocessor_tpu_torch.models import engine, simulator
from axctdprocessor_tpu_torch.ops import chain

torch.set_num_threads(2)

FS = 44100.0
LENGTHS = [63, 64, 65, 127, 128, 129, 700]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# one compose level: the gather form against JAX's shifted select
# ---------------------------------------------------------------------------

def _compose_gather(d: torch.Tensor, span: int, hi: int) -> torch.Tensor:
    """The squaring as one bounded gather, per entry:
    d[i] + (span <= d[i] <= hi and i + d[i] < m ? d[i + d[i]] : 0)."""
    m = d.shape[-1]
    i = torch.arange(m)
    di = d.to(torch.int64)
    ok = (di >= span) & (di <= hi) & (i + di < m)
    add = torch.gather(d, -1, torch.clamp(i + di, 0, m - 1)).to(torch.int64)
    return (di + torch.where(ok, add, 0)).to(torch.int16)


def _compose_jax(delta, span: int, hi: int):
    """axctdprocessor_tpu/ops/chain.py:286-294, one level."""
    n = delta.shape[0]
    acc = jnp.zeros_like(delta)
    for s in range(span, hi + 1):
        shifted = (jnp.concatenate([delta[s:], jnp.zeros((s,), jnp.int16)]) if s < n
                   else jnp.zeros((n,), jnp.int16))
        acc = jnp.where(delta == jnp.int16(s), shifted, acc)
    return delta + acc


@pytest.mark.parametrize("level", range(7))
def test_compose_gather_form_equals_jax_shifted_select(level):
    """Random tables with stalls (delta below span), fixed points (0) and
    jumps past the table's end, at every level of the 600 s decode."""
    span, hi = 1 << level, 4 << level
    rng = np.random.default_rng(level)
    m = 3 * hi + 40
    d = rng.integers(span, hi + 1, (3, m))
    d[rng.random((3, m)) < 0.1] = 0                               # fixed points
    stall = rng.random((3, m)) < 0.1
    d[stall] = rng.integers(0, span, int(stall.sum()))            # stalled walks
    d[:, -hi:] = rng.integers(0, hi + 1, (3, hi))                  # the table's end
    d = d.astype(np.int16)
    got = _compose_gather(torch.from_numpy(d), span, hi)
    fn = jax.jit(_compose_jax, static_argnums=(1, 2))
    for r in range(3):
        np.testing.assert_array_equal(_np(got[r]), np.asarray(fn(jnp.asarray(d[r]), span, hi)))
    np.testing.assert_array_equal(_np(chain.chain_compose_reference(torch.from_numpy(d), span, hi)),
                                  _np(got))


# ---------------------------------------------------------------------------
# the batched plain walks against JAX, row by row
# ---------------------------------------------------------------------------

def _strided_tables(rows: int, m: int, seed: int) -> np.ndarray:
    """Bit-edge-like successor tables (next - i in [1, 4]) with fixed points
    inside (early stalls), a dead row (all fixed points) and rows whose live
    part ends at different places (the rest fixed points: a zero-padded
    tail)."""
    rng = np.random.default_rng(seed)
    nxt = np.arange(m) + rng.integers(1, 5, (rows, m))
    nxt[rng.random((rows, m)) < 0.003] = 0
    nxt = np.where(nxt == 0, np.arange(m), nxt)
    for r in range(rows):
        end = m - r * m // (2 * rows)
        nxt[r, end:] = np.arange(end, m)
    nxt[-1] = np.arange(m)
    return np.minimum(nxt, m - 1).astype(np.int32)


@pytest.mark.parametrize("k", LENGTHS)
def test_chain_enumerate_strided_batched_equals_jax(k):
    """At the decode's max_level 7 (first = 128) up to k = 128; past it at
    max_level 6 (first = 64, tails of one step and more): XLA's CPU compile
    of eight shifted-select levels takes minutes."""
    max_level = 7 if k <= 128 else 6
    nxt = _strided_tables(4, 3 * k + 300, k)
    got = chain.chain_enumerate_strided(torch.from_numpy(nxt), 0, k, max_level=max_level)
    ref = chain.chain_enumerate_strided_reference(torch.from_numpy(nxt), 0, k,
                                                  max_level=max_level)
    assert got.shape == (4, k) and got.dtype == torch.int64
    assert torch.equal(got, ref)
    assert torch.equal(chain.chain_enumerate_strided(torch.from_numpy(nxt), 0, k), got)
    fn = jax.jit(jchain.chain_enumerate_strided, static_argnums=(2, 3, 4))
    for r in range(4):
        np.testing.assert_array_equal(
            _np(got[r]), np.asarray(fn(jnp.asarray(nxt[r]), 0, k, 4, max_level)))
        assert torch.equal(chain.chain_enumerate_strided(torch.from_numpy(nxt[r]), 0, k), got[r])


@pytest.mark.parametrize("k", LENGTHS)
def test_chain_enumerate_batched_equals_jax(k):
    rng = np.random.default_rng(k)
    m = 2 * k + 100
    nxt = np.minimum(np.arange(m) + rng.integers(0, 6, (3, m)), m - 1)
    nxt[1] = np.arange(m)                                           # a dead table
    nxt = nxt.astype(np.int32)
    got = chain.chain_enumerate(torch.from_numpy(nxt), 2, k)
    assert torch.equal(got, chain.chain_enumerate_reference(torch.from_numpy(nxt), 2, k))
    fn = jax.jit(jchain.chain_enumerate, static_argnums=(2,))
    for r in range(3):
        np.testing.assert_array_equal(_np(got[r]), np.asarray(fn(jnp.asarray(nxt[r]), 2, k)))


@pytest.mark.parametrize("max_frames", LENGTHS)
def test_enumerate_frames_batched_equals_jax(max_frames):
    """Rows of different true lengths (n_bits), one with no accepts."""
    rng = np.random.default_rng(max_frames)
    n = 40 * max_frames + 64
    accept = rng.random((3, n)) < 0.05
    accept[2] = False
    n_bits = np.asarray([n, n - 1000, n // 2], np.int64)
    got = chain.enumerate_frames(torch.from_numpy(accept), torch.from_numpy(n_bits),
                                 max_frames=max_frames)
    fn = jax.jit(jchain.enumerate_frames, static_argnums=(2, 3))
    for r in range(3):
        want = fn(jnp.asarray(accept[r]), int(n_bits[r]), n, max_frames)
        one = chain.enumerate_frames(torch.from_numpy(accept[r]), torch.tensor(int(n_bits[r])),
                                     max_frames=max_frames)
        for g, o, w in zip(got, one, want):
            np.testing.assert_array_equal(_np(g[r]), np.asarray(w))
            assert torch.equal(g[r], o)


# ---------------------------------------------------------------------------
# the batched back half
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stage1():
    """The port's stage 1 of three int16 drops of 30, 45 and 50 s (zero-padded
    to 50 s, with lengths): (dims, the stage-1 tensors, lengths, tables)."""
    drops = [simulator.synthesize(simulator.SimSpec(duration=d, profile_start=p, seed=s))[0]
             for d, p, s in ((30.0, 25.0, 4), (45.0, 33.0, 3), (50.0, 33.0, 8))]
    n = max(len(x) for x in drops)
    pcms = np.zeros((3, n), np.int16)
    for r, x in enumerate(drops):
        pcms[r, : len(x)] = np.round(x * 28000 / np.max(np.abs(x)))
    lengths = np.asarray([len(x) for x in drops], np.int64)
    cfg = DecoderConfig()
    dims = engine.EngineDims.for_waveform(n, FS, cfg.bitrate, engine.probe_window(cfg, FS))
    model = engine.FusedDecoder.from_numpy_tables(
        engine.engine_tables(cfg, FS, dims), dims, FS, bitrate=float(cfg.bitrate),
        bit_inset=cfg.bit_inset, device="cpu")
    with torch.inference_mode():
        s1 = model.stage1(torch.from_numpy(pcms), torch.from_numpy(lengths))
    tables = [getattr(model, k) for k in ("trig_i", "trig_f", "hdr_rel", "calib_off")]
    return dims, s1, lengths, tables


def test_batched_back_half_equals_jax_vmapped(stage1):
    """JAX's ``_batched_back_half`` (``jax.vmap`` of the back half) and the
    port's, fed the same stage-1 arrays."""
    dims, s1, lengths, tables = stage1
    cfg = DecoderConfig()
    jdims = jeng.EngineDims.for_waveform(dims.n, FS, cfg.bitrate, dims.npcm)
    fi = jeng.fused_inputs(cfg, FS)

    def j(k, dtype=None):
        a = s1[k].numpy()
        return jnp.asarray(a if dtype is None else a.astype(dtype))

    want = np.asarray(jbatch._batched_back_half(jdims, FS)(
        j("r400"), j("r7500"), j("edge_samples", np.int32), j("n_edges", np.int32),
        j("s1"), j("s2"), jnp.asarray(lengths.astype(np.int32)), j("overflow"),
        fi["trig_i"], fi["trig_f"], fi["hdr_rel"], fi["calib_off"], fi["coeff_defaults"],
        fi["temp_lut"], fi["limits"]))
    with torch.inference_mode():
        got = engine.batched_back_half(s1, torch.from_numpy(lengths), *tables, dims, FS)
    assert got.dtype == torch.int32 and got.shape == want.shape and got.shape[0] == 3
    np.testing.assert_array_equal(got.numpy(), want)
    statuses = [engine.finish_result(row, 44100, int(n), FS, cfg).status
                for row, n in zip(got.numpy(), lengths)]
    assert statuses[1:] == [2, 2], statuses


def test_batch_row_equals_row_alone(stage1):
    """Each row of the batched back half bitwise equal to the same row alone
    (``back_half``, the B = 1 case), and to that row inside a batch of
    other companions."""
    dims, s1, lengths, tables = stage1
    nv = torch.from_numpy(lengths)
    with torch.inference_mode():
        full = engine.batched_back_half(s1, nv, *tables, dims, FS)
        for r in range(3):
            alone = engine.back_half({k: v[r] for k, v in s1.items()}, nv[r], *tables, dims, FS)
            assert torch.equal(full[r], alone), r
        flipped = engine.batched_back_half({k: v.flip(0) for k, v in s1.items()}, nv.flip(0),
                                           *tables, dims, FS)
    assert torch.equal(flipped, full.flip(0))


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_back_half_op_count_does_not_grow_with_batch(stage1):
    """The aten ops the back half dispatches for 1 row and for 4 (rows
    repeated): the same number, so no step loops over rows."""
    dims, s1, lengths, tables = stage1
    counts = {}
    for b in (1, 4):
        idx = torch.arange(b) % 3
        rows = {k: v[idx] for k, v in s1.items()}
        with torch.inference_mode(), _CountOps() as mode:
            engine.batched_back_half(rows, torch.from_numpy(lengths)[idx], *tables, dims, FS)
        counts[b] = mode.n
    assert counts[1] == counts[4] and counts[1] > 100, counts
