"""The port's batch path against the JAX package's, on the CPU.

A small ragged int16 batch (three drops of 42-50 s, zero-padded, with
``lengths``) through JAX ``decode_batch`` (one vmapped program) and the
port's: the packed (B, L) matrices row for row and every row's
``DecodeResult``.  Also ``pad_batch``, the batched back half given JAX's
stage-1 outputs, ``retry_lossy_rows``, and the pipelined decode of the same
batch against the same JAX results.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from axctdprocessor_tpu.models import tpu_engine as jeng
from axctdprocessor_tpu.parallel import batch as jbatch
from axctdprocessor_tpu.utils.config import DecoderConfig
from axctdprocessor_tpu_torch.models import engine, simulator
from axctdprocessor_tpu_torch.parallel import batch
from torch_packed import assert_packed_close

torch.set_num_threads(2)

FS = 44100


def _int16(pcm):
    return np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)


@pytest.fixture(scope="module")
def ragged():
    rows = [_int16(simulator.synthesize(simulator.SimSpec(
        duration=d, profile_start=33.0, seed=s))[0]) for d, s in ((45.0, 3), (50.0, 8), (42.0, 17))]
    return batch.pad_batch(rows), np.asarray([len(r) for r in rows], np.int32)


@pytest.fixture(scope="module")
def packed(ragged):
    """Both packed matrices and both engines' per-row results."""
    pcms, lengths = ragged
    out, ctx = batch.dispatch_batch(pcms, FS, device="cpu", lengths=lengths)
    ours = out.numpy()
    jout, jctx = jbatch.dispatch_batch(pcms, FS, lengths=lengths, wire="int16")
    ref = np.asarray(jax.device_get(jout))
    return (ours, batch.finish_dispatched(out, ctx), ref,
            jbatch.finish_dispatched(jout, jctx))


def test_pad_batch_equals_jax():
    rng = np.random.default_rng(3)
    for dtype in (np.int16, np.int32, np.float32, np.float64):
        rows = [(rng.standard_normal(int(n)) * 1000).astype(dtype)
                for n in rng.integers(10, 50, 4)]
        got, want = batch.pad_batch(rows), jbatch.pad_batch(rows)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_batch_packed_matrix_equals_jax(packed):
    """Row for row: every integer field equal; the smoothed ratios as
    ``torch_packed`` states (here one ``mean7500`` moves by 13 ulps, no
    ratio moves)."""
    ours, _, ref, _ = packed
    assert ours.shape == ref.shape and ours.shape[0] == 3
    for b in range(3):
        assert_packed_close(ours[b], ref[b])


def test_batch_results_equal_jax(packed, ragged):
    _, res, _, jres = packed
    _, lengths = ragged
    assert len(res) == len(jres) == 3
    for b, (r, j) in enumerate(zip(res, jres)):
        assert r.status == j.status == 2, b
        assert r.numpoints == j.numpoints == lengths[b]
        assert r.metadata == j.metadata
        assert r.metadata["serial_no"] == "00123456"
        assert r.firstpulse400 == j.firstpulse400
        assert r.profstartind == j.profstartind
        assert r.hexframes == j.hexframes
        assert r.time == j.time and r.temperature == j.temperature
        assert r.wire == j.wire == "int16"


def test_pipelined_rows_equal_jax_decode_batch(packed, ragged):
    """``decode_batches_pipelined`` against the JAX package directly: the
    ragged batch given twice, every row equal to JAX ``decode_batch``'s
    (the program the ``packed`` fixture has compiled)."""
    from axctdprocessor_tpu_torch.parallel import pipeline

    pcms, lengths = ragged
    _, _, _, jres = packed
    out = pipeline.decode_batches_pipelined([(pcms, lengths)] * 2, FS, device="cpu")
    assert [len(b) for b in out] == [3, 3]
    for rows in out:
        for b, (r, j) in enumerate(zip(rows, jres)):
            assert r.status == j.status == 2, b
            assert r.numpoints == j.numpoints == lengths[b]
            assert r.metadata == j.metadata
            assert (r.firstpulse400, r.profstartind) == (j.firstpulse400, j.profstartind)
            assert r.hexframes == j.hexframes and len(r.hexframes) > 100
            assert r.time == j.time and r.temperature == j.temperature
            assert r.wire == j.wire == "int16"


def test_batched_back_half_equals_jax(ragged):
    """Both back halves, given JAX's vmapped stage-1 outputs."""
    pcms, lengths = ragged
    cfg = DecoderConfig()
    n = pcms.shape[1]
    npcm = int(np.round(FS / cfg.bitrate * (1 - cfg.phase_error / 100))) - 2 * cfg.bit_inset
    dims = engine.EngineDims.for_waveform(n, float(FS), cfg.bitrate, npcm)
    jdims = jeng.EngineDims.for_waveform(n, float(FS), cfg.bitrate, npcm)
    ptrig, btrig, sos = jeng.engine_tables(cfg, float(FS), jdims)

    def one(pcm, n_valid):
        return jeng.stage1_core(pcm, jnp.asarray(ptrig), jnp.asarray(sos), jnp.asarray(btrig),
                                jdims, float(FS), cfg.bitrate, cfg.bit_inset, 100,
                                n_valid=n_valid)

    s1 = jax.jit(jax.vmap(one))(jnp.asarray(pcms), jnp.asarray(lengths))
    fi = jeng.fused_inputs(cfg, float(FS))
    want = np.asarray(jbatch._batched_back_half(jdims, float(FS))(
        s1["r400"], s1["r7500"], s1["edge_samples"], s1["n_edges"], s1["s1"], s1["s2"],
        jnp.asarray(lengths), s1["overflow"], fi["trig_i"], fi["trig_f"], fi["hdr_rel"],
        fi["calib_off"], fi["coeff_defaults"], fi["temp_lut"], fi["limits"]))
    t1 = {k: torch.from_numpy(np.array(v)) for k, v in s1.items()}
    t1["edge_samples"], t1["n_edges"] = t1["edge_samples"].long(), t1["n_edges"].long()
    t = engine.engine_tables(cfg, float(FS), dims)
    tables = [torch.from_numpy(t[k]) for k in ("trig_i", "trig_f", "hdr_rel", "calib_off")]
    with torch.inference_mode():
        got = engine.batched_back_half(t1, torch.from_numpy(lengths.astype(np.int64)),
                                       *tables, dims, float(FS)).numpy()
    np.testing.assert_array_equal(got, want)
    res = batch.run_back_half_batched(t1, cfg, float(FS), dims, lengths, FS, device="cpu")
    assert [r.status for r in res] == [2, 2, 2]


def test_retry_lossy_rows_redecodes_flagged_rows_at_int8(ragged, monkeypatch):
    pcms, lengths = ragged
    first = batch.decode_batch(pcms, FS, device="cpu", lengths=lengths, wire="int4",
                               lossy_retry=False)
    assert [r.wire for r in first] == ["int4"] * 3
    flagged = {id(first[1])}
    real = engine.lossy_retry_worthy
    monkeypatch.setattr(engine, "lossy_retry_worthy",
                        lambda r, *a: id(r) in flagged or real(r, *a))
    out = batch.retry_lossy_rows(first, pcms, FS, device="cpu", lengths=lengths)
    assert out[0] is first[0] and out[2] is first[2]
    assert out[1].wire == "int8" and out[1].status == 2
    int8 = batch.decode_batch(pcms, FS, device="cpu", lengths=lengths, wire="int8")
    assert out[1].hexframes == int8[1].hexframes
    assert out[1].metadata == int8[1].metadata


@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_batch_lossy_wires_equal_jax(ragged, wire):
    """The ragged batch at the lossy wires against JAX ``decode_batch`` at
    the same wire: per row the wire recorded, the trigger indices, the
    metadata and the hexframes.  At int4 the 50 s row collapses in both
    packages and both decode it again at int8."""
    pcms, lengths = ragged
    res = batch.decode_batch(pcms, FS, device="cpu", lengths=lengths, wire=wire)
    jres = jbatch.decode_batch(pcms, FS, lengths=lengths, wire=wire)
    assert len(res) == len(jres) == 3
    for b, (r, j) in enumerate(zip(res, jres)):
        assert r.wire == j.wire == ("int8" if (wire, b) == ("int4", 1) else wire), b
        assert r.status == j.status == 2 and r.overflow == j.overflow == 0, b
        assert r.numpoints == j.numpoints == lengths[b]
        assert (r.firstpulse400, r.profstartind) == (j.firstpulse400, j.profstartind), b
        assert r.metadata == j.metadata
        assert set(r.hexframes) == set(j.hexframes) and len(r.hexframes) > 100, b
