"""The port's two-stage pipeline (``parallel.pipeline``), on the CPU.

* the split: ``stage1_core`` on a (3, n) batch equals its rows from the 1-D
  call, and followed by the batched back half it equals ``FusedDecoder`` on
  the same batch, element for element (exact);
* ``decode_batches_pipelined`` on two batches of two 42 s drops (three drops
  with different serials and a noise-only dud) equals the port's
  ``decode_batch`` on the same batches: status, metadata, hexframes, ``time``
  and ``salinity`` exact;
* a ragged int16 batch with ``lengths``; an int4 batch whose degenerate row
  is retried at int8; the uint8 refusal; a missing GPU raises before work;
* against the JAX package: in the fast set, tests/test_torch_batch.py holds
  the pipelined rows against JAX ``decode_batch`` on its ragged batch (one
  JAX program compiled for both); marked slow here (JAX compiles its vmapped
  stage-1 and back-half programs), against the JAX package's
  ``decode_batches_pipelined`` (hexframes and metadata equal).
"""

import numpy as np
import pytest
import torch

from axctdprocessor_tpu_torch.models import engine, simulator
from axctdprocessor_tpu_torch.parallel import batch, pipeline
from axctdprocessor_tpu_torch.utils.config import DecoderConfig

torch.set_num_threads(2)

FS = 44100


def _int16(pcm):
    return np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)


@pytest.fixture(scope="module")
def small_batch():
    """Three 42 s drops with different serials, conditioned float32, and a
    noise-only dud (tests/test_parallel.py's ``small_batch``)."""
    drops = []
    for i, serial in enumerate(["00123456", "0abc1234", "deadbeef"]):
        spec = simulator.SimSpec(duration=42.0, profile_start=33.0, seed=20 + i,
                                 serial_hex=serial)
        pcm, truth = simulator.synthesize(spec)
        pcm = (pcm - np.mean(pcm)) / np.max(np.abs(pcm))
        drops.append((pcm.astype(np.float32), truth))
    rng = np.random.default_rng(0)
    drops.append(((rng.standard_normal(int(42.0 * FS)) * 0.3).astype(np.float32), None))
    return drops


@pytest.fixture(scope="module")
def ragged():
    rows = [_int16(simulator.synthesize(simulator.SimSpec(
        duration=d, profile_start=33.0, seed=s))[0]) for d, s in ((45.0, 3), (50.0, 8), (42.0, 17))]
    return batch.pad_batch(rows), np.asarray([len(r) for r in rows], np.int32)


def _same(a, b):
    assert a.status == b.status
    assert a.metadata == b.metadata
    assert a.hexframes == b.hexframes
    assert a.time == b.time and a.salinity == b.salinity
    assert (a.firstpulse400, a.profstartind, a.numpoints, a.wire, a.overflow) == (
        b.firstpulse400, b.profstartind, b.numpoints, b.wire, b.overflow)


def test_split_stage1_and_back_half_equal_fused(ragged):
    pcms, lengths = ragged
    cfg = DecoderConfig()
    dims = engine.EngineDims.for_waveform(pcms.shape[1], float(FS), cfg.bitrate,
                                          engine.probe_window(cfg, float(FS)))
    model = engine.FusedDecoder.from_numpy_tables(
        engine.engine_tables(cfg, float(FS), dims), dims, float(FS),
        bitrate=float(cfg.bitrate), bit_inset=cfg.bit_inset, device="cpu")
    x, nv = torch.from_numpy(pcms), torch.from_numpy(lengths.astype(np.int64))
    with torch.inference_mode():
        s1 = model.stage1(x, nv)
        assert set(s1) == {"r400", "r7500", "edge_samples", "n_edges", "s1", "s2", "overflow"}
        assert all(v.shape[0] == 3 for v in s1.values())
        for b in range(3):
            one = model.stage1(x[b], nv[b])
            for k in s1:
                assert torch.equal(torch.nan_to_num(s1[k][b], nan=7.0),
                                   torch.nan_to_num(one[k], nan=7.0)), (b, k)
        split = model.back_half(s1, nv)
        fused = model(x, nv)
        tables = [getattr(model, k) for k in ("trig_i", "trig_f", "hdr_rel", "calib_off")]
        via_batch = engine.batched_back_half(s1, nv, *tables, dims, float(FS))
    assert split.dtype == torch.int32 and split.shape == fused.shape
    assert torch.equal(split, fused)
    assert torch.equal(via_batch, fused)
    assert int(engine.unpack_result(fused[0].numpy())["scal_i"][2]) > 100  # frames


def test_pipelined_equals_decode_batch(small_batch):
    rows = batch.pad_batch([p for p, _ in small_batch])
    batches = [(rows[:2], None), (rows[2:], None)]
    out = pipeline.decode_batches_pipelined(batches, float(FS), device="cpu")
    assert [len(b) for b in out] == [2, 2]
    want = [batch.decode_batch(sub, float(FS), device="cpu") for sub, _ in batches]
    for got_b, want_b in zip(out, want):
        for g, w in zip(got_b, want_b):
            _same(g, w)
    flat = out[0] + out[1]
    for (pcm, truth), res in zip(small_batch, flat):
        if truth is None:
            assert res.status == 0 and len(res.time) == 0
        else:
            assert res.status == 2 and len(res.time) > 100
            assert res.metadata["serial_no"] == truth["serial_no"]
        assert res.wire == "float32" and res.numpoints == len(pcm)


def test_pipelined_ragged_int16_with_lengths(ragged):
    pcms, lengths = ragged
    out = pipeline.decode_batches_pipelined([(pcms, lengths)], FS, device="cpu")
    want = batch.decode_batch(pcms, FS, device="cpu", lengths=lengths)
    assert len(out) == 1 and len(out[0]) == 3
    for b, (g, w) in enumerate(zip(out[0], want)):
        _same(g, w)
        assert g.status == 2 and g.wire == "int16" and g.numpoints == lengths[b]
        assert isinstance(g.fs, int)


def test_pipelined_int4_retries_the_degenerate_row_at_int8():
    """Seed 11's 60 s drop (profile at 40 s) collapses at the int4 wire
    to a few dozen frames and seed 21's does not: the pipeline decodes the
    flagged row again at int8 in a full-width ``decode_batch``, as
    ``decode_batch`` itself does."""
    rows = np.stack([_int16(simulator.synthesize(simulator.SimSpec(
        duration=60.0, profile_start=p, seed=s))[0]) for s, p in ((11, 40.0), (21, 40.0))])
    raw4 = pipeline.decode_batches_pipelined([(rows, None)], FS, device="cpu", wire="int4",
                                             lossy_retry=False)[0]
    assert [r.wire for r in raw4] == ["int4", "int4"]
    cfg = DecoderConfig()
    worthy = [engine.lossy_retry_worthy(r, rows.shape[1], float(FS), cfg) for r in raw4]
    assert worthy == [True, False]
    out = pipeline.decode_batches_pipelined([(rows, None)], FS, device="cpu", wire="int4")[0]
    want = batch.decode_batch(rows, FS, device="cpu", wire="int4")
    assert [r.wire for r in out] == ["int8", "int4"]
    for g, w in zip(out, want):
        _same(g, w)
        assert g.status == 2 and g.metadata["serial_no"] == "00123456"


def test_pipelined_refusals(ragged):
    pcms, lengths = ragged
    assert pipeline.decode_batches_pipelined([], FS, device="cpu") == []
    with pytest.raises(ValueError, match="unpacked integer rows"):
        pipeline.decode_batches_pipelined([(pcms.view(np.uint8), None)], FS, device="cpu")
    with pytest.raises(ValueError, match="wire"):
        pipeline.decode_batches_pipelined([(pcms, lengths)], FS, device="cpu", wire="int2")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pipeline.decode_batches_pipelined([(pcms, lengths)], FS)


@pytest.mark.slow  # JAX compiles its vmapped stage-1 and back-half programs
def test_pipelined_equals_jax_pipelined(small_batch):
    from axctdprocessor_tpu.parallel import pipeline as jpipeline

    rows = batch.pad_batch([p for p, _ in small_batch])
    batches = [(rows[:2], None), (rows[2:], None)]
    ours = pipeline.decode_batches_pipelined(batches, float(FS), device="cpu")
    ref = jpipeline.decode_batches_pipelined(batches, float(FS))
    for got_b, ref_b in zip(ours, ref):
        for g, r in zip(got_b, ref_b):
            assert g.status == r.status
            assert g.metadata == r.metadata
            assert g.hexframes == r.hexframes
