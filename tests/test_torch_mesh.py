"""The port's mesh (``parallel.mesh``) and the ``dp`` paths over it, on the CPU.

A mesh here is a grid of ``torch.device``s; the tests build theirs from
``[torch.device("cpu")] * k``, the same device at every place, as the JAX
tests get eight virtual CPU devices from XLA.  ``make_mesh`` against the JAX
one (shapes, axis names, the error for too few devices); ``decode_batch``
over ``{"dp": 2}`` on three rows (so one row is padding) against the same call
without a mesh, rows **equal** (the same arithmetic per row); the int8 retry
over a mesh; ``decode_batches_pipelined(devices=[cpu, cpu])`` against
``devices=None``, rows equal; ``reprocess_corpus(mesh=)`` against
``device="cpu"``, report bytes equal.
"""

import os

import numpy as np
import pytest
import torch

from axctdprocessor_tpu.parallel import mesh as jmesh
from axctdprocessor_tpu_torch.models import engine, simulator
from axctdprocessor_tpu_torch.parallel import batch, pipeline
from axctdprocessor_tpu_torch.parallel.archive import reprocess_corpus
from axctdprocessor_tpu_torch.parallel.mesh import Mesh, make_mesh

torch.set_num_threads(2)

CPU = torch.device("cpu")
FS = 44100


@pytest.mark.parametrize("shape", [{"dp": 8}, {"dp": 2, "sp": 4}, {"dp": 1, "sp": 8},
                                   {"dp": 3}, {"sp": 2, "dp": 2}, None])
def test_make_mesh_shapes_and_axis_names_equal_jax(shape):
    """The same shape dict through both: axis names in the dict's order,
    ``mesh.shape`` by name, the grid's dimensions; ``None`` is one ``dp`` axis
    over every device of the list (JAX: over its 8 virtual CPU devices)."""
    ours, ref = make_mesh(shape, [CPU] * 8), jmesh.make_mesh(shape)
    assert isinstance(ours, Mesh)
    assert ours.axis_names == tuple(ref.axis_names)
    assert ours.shape == dict(ref.shape)
    assert ours.devices.shape == ref.devices.shape
    assert all(d == CPU for d in ours.devices.reshape(-1))


@pytest.mark.parametrize("shape", [{"dp": 16}, {"dp": 3, "sp": 3}])
def test_make_mesh_raises_on_too_few_devices_as_jax(shape):
    with pytest.raises(ValueError) as ours:
        make_mesh(shape, [CPU] * 8)
    with pytest.raises(ValueError) as ref:
        jmesh.make_mesh(shape)
    assert str(ours.value) == str(ref.value)
    assert "needs" in str(ours.value) and "have 8" in str(ours.value)


def test_make_mesh_takes_names_and_a_repeated_device():
    mesh = make_mesh({"dp": 2, "sp": 2}, ["cpu", CPU, "cpu", "cpu", "cpu"])
    assert mesh.shape == {"dp": 2, "sp": 2}  # the list may be longer than the mesh
    assert mesh.devices_along("sp", dp=1) == [CPU, CPU]
    assert mesh.devices_along("dp") == [CPU, CPU]
    assert "cpu" in repr(mesh)
    with pytest.raises(ValueError, match="unsupported device"):
        make_mesh({"dp": 1}, ["meta"])


def test_devices_along_walks_the_named_axis():
    """Tagged stand-ins for devices: row i of the grid is ``sp`` at dp = i."""
    grid = np.empty((2, 3), dtype=object)
    for i in range(2):
        for j in range(3):
            grid[i, j] = f"d{i}{j}"
    mesh = Mesh(grid, ("dp", "sp"))
    assert mesh.shape == {"dp": 2, "sp": 3}
    assert mesh.devices_along("sp", dp=1) == ["d10", "d11", "d12"]
    assert mesh.devices_along("sp") == ["d00", "d01", "d02"]
    assert mesh.devices_along("dp") == ["d00", "d10"]
    assert mesh.devices_along("dp", sp=2) == ["d02", "d12"]
    with pytest.raises(ValueError, match="axes"):
        Mesh(grid, ("dp",))


def test_make_mesh_without_arguments_needs_a_gpu():
    """No device list: every visible CUDA device, and without one an error;
    nothing folds the mesh onto the CPU."""
    if torch.cuda.is_available():
        mesh = make_mesh()
        assert mesh.shape == {"dp": torch.cuda.device_count()}
        assert all(d.type == "cuda" for d in mesh.devices_along("dp"))
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh()
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh({"dp": 2}, ["cuda:0", "cuda:0"])


def _int16(pcm):
    return np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)


@pytest.fixture(scope="module")
def three_rows():
    rows = [_int16(simulator.synthesize(simulator.SimSpec(
        duration=d, profile_start=33.0, seed=s))[0]) for d, s in ((42.0, 3), (40.0, 8), (41.0, 17))]
    return batch.pad_batch(rows), np.asarray([len(r) for r in rows], np.int32)


@pytest.fixture(scope="module")
def plain_rows(three_rows):
    pcms, lengths = three_rows
    return batch.decode_batch(pcms, FS, device="cpu", lengths=lengths)


def _assert_rows_equal(got, want):
    assert len(got) == len(want)
    for b, (g, w) in enumerate(zip(got, want)):
        assert g.status == w.status == 2, b
        assert g.metadata == w.metadata and g.numpoints == w.numpoints, b
        assert (g.firstpulse400, g.profstartind) == (w.firstpulse400, w.profstartind), b
        assert g.hexframes == w.hexframes and len(g.hexframes) > 100, b
        assert g.time == w.time and g.temperature == w.temperature, b
        assert g.wire == w.wire and g.overflow == w.overflow == 0, b


def test_decode_batch_over_dp_mesh_equals_no_mesh(three_rows, plain_rows):
    """Three rows over ``dp = 2``: the batch is padded to four by repeating
    row 0, cut into two runs of two, and the padding dropped.  ``device`` is
    not read (its default is the card, and there is none here)."""
    pcms, lengths = three_rows
    mesh = make_mesh({"dp": 2}, [CPU] * 2)
    _assert_rows_equal(batch.decode_batch(pcms, FS, mesh=mesh, lengths=lengths), plain_rows)
    out, ctx = batch.dispatch_batch(pcms, FS, mesh=mesh, lengths=lengths)
    assert [tuple(o.shape) for o in out] == [(2, out[0].shape[1])] * 2
    plain_out, _ = batch.dispatch_batch(pcms, FS, device="cpu", lengths=lengths)
    assert torch.equal(torch.cat(out)[:3], plain_out)  # packed rows; out[1][1] is row 0 again
    assert torch.equal(out[1][1], plain_out[0])
    _assert_rows_equal(batch.finish_dispatched(out, ctx), plain_rows)


@pytest.mark.parametrize("shape", [{"dp": 1}, {"dp": 3}, {"dp": 2, "sp": 2}])
def test_decode_batch_over_other_meshes_equals_no_mesh(three_rows, plain_rows, shape):
    """``dp`` of 1 (one run), of 3 (a run per row) and a mesh with an ``sp``
    axis as well, which the batch path does not use (replicated in JAX)."""
    pcms, lengths = three_rows
    mesh = make_mesh(shape, [CPU] * 4)
    _assert_rows_equal(batch.decode_batch(pcms, FS, mesh=mesh, lengths=lengths), plain_rows)


def test_retry_lossy_rows_over_a_mesh(three_rows, monkeypatch):
    pcms, lengths = three_rows
    mesh = make_mesh({"dp": 2}, [CPU] * 2)
    first = batch.decode_batch(pcms, FS, mesh=mesh, lengths=lengths, wire="int4",
                               lossy_retry=False)
    assert [r.wire for r in first] == ["int4"] * 3
    flagged = {id(first[2])}
    real = engine.lossy_retry_worthy
    monkeypatch.setattr(engine, "lossy_retry_worthy",
                        lambda r, *a: id(r) in flagged or real(r, *a))
    out = batch.retry_lossy_rows(first, pcms, FS, device="cuda", mesh=mesh, lengths=lengths)
    assert out[0] is first[0] and out[1] is first[1]
    int8 = batch.decode_batch(pcms, FS, device="cpu", lengths=lengths, wire="int8")
    assert out[2].wire == "int8" and out[2].hexframes == int8[2].hexframes
    assert out[2].metadata == int8[2].metadata


def test_pipelined_on_two_devices_equals_one(three_rows, plain_rows):
    """``devices=[cpu, cpu]``: a second decoder holds the back half's tables
    and each batch's stage-1 outputs are copied to its device; rows equal to
    ``devices=None`` and to ``decode_batch``."""
    pcms, lengths = three_rows
    batches = [(pcms, lengths), (pcms[::-1].copy(), lengths[::-1].copy())]
    one = pipeline.decode_batches_pipelined(batches, FS, device="cpu")
    two = pipeline.decode_batches_pipelined(batches, FS, devices=[CPU, CPU])
    assert [len(b) for b in two] == [3, 3]
    for got, want in zip(two, one):
        _assert_rows_equal(got, want)
    _assert_rows_equal(two[0], plain_rows)
    _assert_rows_equal(two[1][::-1], plain_rows)
    alone = pipeline.decode_batches_pipelined(batches[:1], FS, devices=[CPU])
    _assert_rows_equal(alone[0], plain_rows)


def test_reprocess_corpus_over_a_mesh_writes_the_same_reports(tmp_path):
    paths = []
    for i in range(3):
        spec = simulator.SimSpec(duration=40.0, profile_start=33.0, seed=50 + i)
        paths.append(str(tmp_path / f"drop{i}.wav"))
        simulator.write_wav(paths[-1], simulator.synthesize(spec)[0], spec.fs)
    plain = reprocess_corpus(paths, str(tmp_path / "plain"), batch_size=3, device="cpu")
    mesh = make_mesh({"dp": 2}, [CPU] * 2)
    meshed = reprocess_corpus(paths, str(tmp_path / "mesh"), batch_size=3, mesh=mesh)
    for i in range(3):
        name = f"drop{i}"
        assert meshed["files"][name + ".wav"]["status"] == "done"
        got = open(os.path.join(tmp_path, "mesh", name + ".txt"), "rb").read()
        assert got == open(os.path.join(tmp_path, "plain", name + ".txt"), "rb").read()
        assert b"Probe Serial: 00123456" in got
    drop = ("finished_at", "output")
    strip = lambda m: {k: {f: v for f, v in e.items() if f not in drop}  # noqa: E731
                       for k, e in m["files"].items()}
    assert strip(meshed) == strip(plain)
