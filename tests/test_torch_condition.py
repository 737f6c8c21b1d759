"""The port's conditioning of integer PCM, on the CPU.

``engine.condition_integer`` takes the DC mean as the exact sum of the row
over its true length, rounded once to float32, and the peak as an exact max:
a row conditioned in a batch is the row conditioned alone, bit for bit, at
any batch shape, and the time-sharded conditioning (``timeshard.
_condition_blocks``) is the whole row's.  JAX's conditioning (a float32 sum
in no fixed order) stays within 1e-6, and a batch of the test drops still
decodes to JAX's hexframes and report bytes.  The card's side (card equal
to the CPU) is in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from axctdprocessor_tpu.models import tpu_engine as jeng
from axctdprocessor_tpu.parallel import batch as jbatch
from axctdprocessor_tpu.utils import report as jreport
from axctdprocessor_tpu.utils.config import DecoderConfig as JConfig
from axctdprocessor_tpu_torch.models import engine, simulator
from axctdprocessor_tpu_torch.ops import wire as wire_ops
from axctdprocessor_tpu_torch.parallel import batch, timeshard
from axctdprocessor_tpu_torch.utils import report
from axctdprocessor_tpu_torch.utils.config import DecoderConfig

torch.set_num_threads(2)

FS = 44100
CPU = torch.device("cpu")
# the wires' integer PCM as condition_integer is handed it: int16, the int8
# wire, the int4 wire unpacked (int32 levels) and packed (through
# engine.conditioned, which hands the levels over as int8)
WIRES = ("int16", "int8", "int4 unpacked", "int4 packed")


def _rows(b: int, n: int, seed: int):
    """(b, n) int16 rows with a DC offset, zero-padded past their lengths."""
    rng = np.random.default_rng(seed)
    pcm = np.clip(rng.normal(700.0, 9000.0, (b, n)), -32768, 32767).astype(np.int16)
    lengths = (n - rng.integers(0, n // 5, b)).astype(np.int64)
    lengths[0] = n
    for r, m in enumerate(lengths):
        pcm[r, m:] = 0
    return pcm, lengths


def _conditioned(pcm: np.ndarray, lengths, wire: str) -> torch.Tensor:
    """What the decode conditions for `wire`, on the CPU."""
    n = pcm.shape[-1]
    nv = torch.from_numpy(np.asarray(lengths))
    if wire == "int16":
        return engine.condition_integer(torch.from_numpy(pcm), n, nv)
    if wire == "int8":
        q = wire_ops.quantize_int8_rows(np.atleast_2d(pcm)).reshape(pcm.shape)
        return engine.condition_integer(torch.from_numpy(q), n, nv)
    packed = torch.from_numpy(
        wire_ops.quantize_int4_packed_rows(np.atleast_2d(pcm)).reshape(pcm.shape[:-1] + (-1,)))
    if wire == "int4 packed":
        return engine.conditioned(packed, nv)[..., :n]
    unpacked = engine.unpack_int4(packed, n)
    assert unpacked.dtype == torch.int32
    return engine.condition_integer(unpacked, n, nv)


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("wire", WIRES)
def test_batch_row_equals_row_alone(wire, b):
    """Every row of a (b, n) batch, zero-padded rows with their ``n_valid``
    among them, bit-equal to the row conditioned alone (1-D) and as a batch
    of one; the padded tails zero."""
    n = 50_002  # even: the int4 wire packs two samples a byte
    pcm, lengths = _rows(8, n, seed=b)
    pcm, lengths = pcm[:b], lengths[:b]
    got = _conditioned(pcm, lengths, wire)
    assert got.dtype == torch.float32 and got.shape == (b, n)
    for r in range(b):
        alone = _conditioned(pcm[r], lengths[r], wire)
        assert torch.equal(alone, got[r]), r
        assert torch.equal(_conditioned(pcm[r: r + 1], lengths[r: r + 1], wire)[0], got[r]), r
        assert not got[r, lengths[r]:].any()


@pytest.mark.parametrize("n", [77, 50_000, 50_021])
@pytest.mark.parametrize("dtype", [np.int16, np.int8, np.int32])
def test_mean_is_the_exact_mean_rounded_once(dtype, n):
    """The row sums are the exact integer sums (a row shorter than a chunk,
    one with a divisor in [128, 256], one without: chunks and a tail; int32
    through torch's int64 sum) and the mean is the float64 sum over the
    float64 true length, rounded once to float32; the conditioned row is
    ``(x - mean) / peak`` with that mean."""
    rng = np.random.default_rng(n)
    hi = {np.int16: 32767, np.int8: 127, np.int32: 2 ** 20}[dtype]
    pcm = rng.integers(-hi, hi + 1, (3, n)).astype(dtype)
    pcm[:, : n // 3] = dtype(hi)  # every chunk's partial sums at their largest
    lengths = np.asarray([n, n - n // 7, n // 2], np.int64)
    for r, m in enumerate(lengths):
        pcm[r, m:] = 0
    t = torch.from_numpy(pcm)
    sums = engine.integer_row_sums(t, t.to(torch.float32))
    want = pcm.astype(np.int64).sum(-1)
    assert sums.dtype == torch.float64
    np.testing.assert_array_equal(sums.numpy(), want.astype(np.float64))
    mean = engine.exact_mean(sums, torch.from_numpy(lengths))
    want_mean = (want.astype(np.float64) / lengths.astype(np.float64)).astype(np.float32)
    assert mean.dtype == torch.float32
    np.testing.assert_array_equal(mean.numpy(), want_mean)
    got = engine.condition_integer(t, n, torch.from_numpy(lengths))
    xf = pcm.astype(np.float32)
    peak = np.maximum(np.abs(xf).max(-1, keepdims=True), np.float32(1.0))
    for r, m in enumerate(lengths):
        np.testing.assert_array_equal(got[r, :m].numpy(), (xf[r, :m] - want_mean[r]) / peak[r])


@pytest.mark.parametrize("dtype", [np.int16, np.int8])
def test_within_1e6_of_jax(dtype):
    """Each row within 1e-6 of JAX's ``condition_integer`` (a float32 sum in
    its own order), the padded tails zero in both."""
    pcm, lengths = _rows(3, 88_200, seed=4)
    if dtype == np.int8:
        pcm = wire_ops.quantize_int8_rows(pcm)
    got = engine.condition_integer(torch.from_numpy(pcm), pcm.shape[1], torch.from_numpy(lengths))
    for r in range(3):
        want = jeng.condition_integer(jnp.asarray(pcm[r]), pcm.shape[1],
                                      jnp.asarray(lengths[r], jnp.int32))
        np.testing.assert_allclose(got[r].numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("sp", [2, 4])
def test_timeshard_blocks_equal_the_whole_row(sp):
    """``timeshard._condition_blocks`` over `sp` blocks bit-equal to the whole
    rows conditioned at once: the blocks, the mean and the peak."""
    pcm, lengths = _rows(3, 3 * FS + 123, seed=sp)
    raw = timeshard.pad_for_mesh(pcm, FS, sp)
    block = raw.shape[1] // sp
    blocks = timeshard._upload_blocks(raw, [CPU] * sp, block)
    nv = torch.from_numpy(lengths)
    cond, mean, peak = timeshard._condition_blocks(blocks, {CPU: nv}, block)
    whole = engine.condition_integer(torch.from_numpy(raw), raw.shape[1], nv)
    assert torch.equal(torch.cat(cond, dim=1), whole)
    xf = torch.from_numpy(raw).to(torch.float32)
    assert torch.equal(mean, engine.exact_mean(engine.integer_row_sums(
        torch.from_numpy(raw), xf), nv))
    assert torch.equal(peak, xf.abs().amax(-1).clamp(min=1.0))


@pytest.fixture(scope="module")
def drops():
    rows = [simulator.synthesize(simulator.SimSpec(duration=d, profile_start=33.0, seed=s))[0]
            for d, s in ((44.0, 5), (41.0, 23))]
    rows = [np.round(p * 28000 / np.max(np.abs(p))).astype(np.int16) for p in rows]
    return batch.pad_batch(rows), np.asarray([len(r) for r in rows], np.int32)


def test_batch_of_test_drops_equals_jax(drops, tmp_path):
    """A ragged batch of two test drops through the port's ``decode_batch``
    and JAX's: the same hexframe sets and report bytes, row for row."""
    pcms, lengths = drops
    ours = batch.decode_batch(pcms, FS, device="cpu", lengths=lengths, wire="int16")
    theirs = jbatch.decode_batch(pcms, FS, lengths=lengths, wire="int16")
    cfg = DecoderConfig()
    echo = {"minR400": cfg.min_r400, "mindR7500": cfg.min_dr7500, "deadfreq": cfg.dead_freq,
            "pointsperloop": 100000, "triggerrange": list(cfg.trigger_range)}
    for b, (r, j) in enumerate(zip(ours, theirs)):
        assert r.status == j.status == 2, b
        assert set(r.hexframes) == set(j.hexframes) and len(r.hexframes) > 100, b
        mine, ref = tmp_path / f"ours{b}.txt", tmp_path / f"jax{b}.txt"
        report.write_report(str(mine), r, f"drop{b}.wav", [0, -1], echo, cfg)
        jreport.write_report(str(ref), j, f"drop{b}.wav", [0, -1], echo, JConfig())
        assert mine.read_bytes() == ref.read_bytes(), b
