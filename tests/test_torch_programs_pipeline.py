"""The pipeline's cached programs (``parallel/batch.BatchPlan``'s stage-1
and back-half programs, run by ``parallel/pipeline.py``) on the CPU.

On the CPU a program runs its module eagerly over its static buffers: the
stage-1 program's static outputs are copied into the back-half program's
static inputs before the next batch's stage 1 overwrites them, as on the
card, so a stale input shows here too.

* three batches of one shape (their own row orders and true lengths)
  through ``decode_batches_pipelined``: one stage-1 and one back-half
  program, each run three times; every row's packed vector bit for bit a
  fresh ``FusedDecoder``'s forward on that batch, every result equal to
  ``decode_batch``'s and to the JAX package's pipeline (packed vectors by
  ``torch_packed.assert_packed_close``, hexframes and metadata equal);
* ``devices=[cpu, cpu]`` (the two-device form, its back half's program
  fed across "devices") decodes the same.
"""

import numpy as np
import pytest
import torch

from axctdprocessor_tpu.models import tpu_engine as jeng
from axctdprocessor_tpu.parallel import pipeline as jpipeline
from axctdprocessor_tpu_torch.models import engine, programs, simulator
from axctdprocessor_tpu_torch.parallel import batch, pipeline
from torch_packed import assert_packed_close

torch.set_num_threads(2)

FS = 44100


def _int16(pcm: np.ndarray) -> np.ndarray:
    return np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)


@pytest.fixture(scope="module")
def batches():
    """Three batches of two 40 s drops: the rows, the rows swapped, and a
    third drop beside the first; each row zero-padded past its own true
    length."""
    rows = [_int16(simulator.synthesize(simulator.SimSpec(
        duration=40.0, profile_start=20.0, seed=s))[0]) for s in (3, 8, 17)]
    out = []
    for pick, cut in (((0, 1), (0, 2000)), ((1, 0), (700, 0)), ((2, 0), (0, 30000))):
        sub = np.stack([rows[i] for i in pick])
        lengths = np.asarray([sub.shape[1] - c for c in cut], np.int32)
        for r, n in enumerate(lengths):
            sub[r, n:] = 0
        out.append((sub, lengths))
    return out


@pytest.fixture
def packed_of(monkeypatch):
    seen = {"port": [], "jax": []}

    def spy(where, real):
        def finish(out, *args, **kwargs):
            seen[where].append(np.array(out, dtype=np.int32))
            return real(out, *args, **kwargs)
        return finish

    monkeypatch.setattr(engine, "finish_result", spy("port", engine.finish_result))
    monkeypatch.setattr(jeng, "finish_result", spy("jax", jeng.finish_result))
    return seen


def _same(a, b):
    assert a.status == b.status == 2
    assert a.metadata == b.metadata
    assert a.hexframes == b.hexframes and len(a.hexframes) > 100
    assert a.time == b.time and a.salinity == b.salinity
    assert (a.firstpulse400, a.profstartind, a.numpoints, a.wire, a.overflow) == (
        b.firstpulse400, b.profstartind, b.numpoints, b.wire, b.overflow)


def test_pipelined_batches_equal_fresh_module_decode_batch_and_jax(batches, packed_of):
    programs.clear()
    out = pipeline.decode_batches_pipelined(batches, FS, device="cpu")
    front, back = programs.programs()
    assert front.calls == back.calls == 3
    assert front.inputs[0].shape == batches[0][0].shape and isinstance(front.output, dict)
    assert len(back.inputs) == len(front.output) + 1
    got = packed_of["port"][:]
    plan = batch.BatchPlan(np.dtype(np.int16), batches[0][0].shape[1], FS, None, "auto", "cpu")
    for b, (rows, lengths) in enumerate(batches):
        with torch.inference_mode():
            want = plan.model(torch.from_numpy(rows),
                              torch.from_numpy(lengths.astype(np.int64))).numpy()
        np.testing.assert_array_equal(np.stack(got[2 * b: 2 * b + 2]), want)
        for g, w in zip(out[b], batch.decode_batch(rows, FS, device="cpu", lengths=lengths)):
            _same(g, w)
    ref = jpipeline.decode_batches_pipelined(batches, FS)
    for g, w in zip(got, packed_of["jax"]):
        assert_packed_close(g, w)
    for got_b, ref_b in zip(out, ref):
        for g, r in zip(got_b, ref_b):
            assert g.status == r.status == 2
            assert g.metadata == r.metadata and g.hexframes == r.hexframes
    programs.clear()


def test_two_device_pipeline_feeds_its_back_half_program_the_same(batches):
    programs.clear()
    one = pipeline.decode_batches_pipelined(batches[:2], FS, device="cpu")
    two = pipeline.decode_batches_pipelined(batches[:2], FS, devices=["cpu", "cpu"])
    assert [p.calls for p in programs.programs()] == [4, 4]
    for a_b, b_b in zip(one, two):
        for a, b in zip(a_b, b_b):
            _same(a, b)
    programs.clear()
