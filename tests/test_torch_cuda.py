"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

The CUDA kernel has no CPU or interpret mode, so these skip on a CPU-only
machine.  This file imports no jax (the machine with the card has none),
so it runs there on its own, without the repository's conftest (which
configures jax):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from axctdprocessor_tpu_torch.models import engine, segmented, simulator
from axctdprocessor_tpu_torch.ops import goertzel, tonepower

FREQS = [400.0, 7500.0, 3000.0]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU or interpret mode")


def _signal(fs, n, tail, rng):
    t = np.arange(n) / fs
    x = (0.4 * np.sin(2 * np.pi * 400 * t) + 0.2 * np.sin(2 * np.pi * 7500 * t)
         + 0.05 * rng.standard_normal(n)).astype(np.float32)
    x[int(n * (1 - tail)):] = 0.0
    return x


def _assert_close(got, want, shape):
    for g, w in zip(got, want):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        assert g.shape == w.shape == shape
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("fs,n,tail", [
    (44100.0, 600 * 44100, 0.0),
    (44100.0, 60 * 44100, 0.25),
    (16000.0, 45 * 16000, 0.1),
    (22050.0, 120 * 22050 + 3, 0.1),   # stride 882: tiles not 16-byte aligned
    (44100.0, 2 * 44100, 0.0),         # shorter than one block's run of windows
    (44100.0, 4410 + 1, 0.0),          # one window
    (50000.0, 30 * 50000, 0.0),        # the highest rate the kernel sees
])
def test_kernel_vs_plain(fs, n, tail):
    """rtol/atol 2e-4 (the Pallas kernel's tolerance), equal NaN positions."""
    _need_cuda()
    x = _signal(fs, n, tail, np.random.default_rng(5))
    window, stride = int(fs / 10), int(round(fs / 25))
    xd = torch.from_numpy(x).cuda()
    tm = torch.from_numpy(goertzel.tone_matrix(window, FREQS, fs, np.float32)).cuda()
    before = tonepower.tone_ratios.launches
    got = tonepower.tone_ratios(xd, tm, window, stride)
    want = tonepower.tone_ratios_reference(xd, tm, window, stride)
    torch.cuda.synchronize()
    assert tonepower.tone_ratios.launches == before + 1
    _assert_close(got, want, (tonepower.n_windows(len(x), window, stride),))


@pytest.mark.cuda
def test_kernel_with_no_window_launches_nothing():
    """n_win = 0 (a signal no longer than one window): empty outputs, no launch."""
    _need_cuda()
    tm = torch.from_numpy(goertzel.tone_matrix(4410, FREQS, 44100.0, np.float32)).cuda()
    before = tonepower.tone_ratios.launches
    for x in (torch.zeros(4410, device="cuda"), torch.zeros((3, 100), device="cuda")):
        got = tonepower.tone_ratios(x, tm, 4410, 1764)
        assert got[0].shape == got[1].shape == x.shape[:-1] + (0,)
    assert tonepower.tone_ratios.launches == before


@pytest.mark.cuda
def test_ragged_batch_rows_bitwise():
    """A batch whose n is no multiple of 4 (rows not 16-byte aligned): one
    launch, within 2e-4 of the plain version, rows bitwise equal to the 1-D
    kernel on each row (a view that starts mid-allocation)."""
    _need_cuda()
    fs, window, stride = 44100.0, 4410, 1764
    n = 20 * 44100 + 777
    rng = np.random.default_rng(8)
    xd = torch.from_numpy(np.stack([_signal(fs, n, tail, rng) for tail in (0.0, 0.2, 0.5)])).cuda()
    tm = torch.from_numpy(goertzel.tone_matrix(window, FREQS, fs, np.float32)).cuda()
    before = tonepower.tone_ratios.launches
    got = tonepower.tone_ratios(xd, tm, window, stride)
    assert tonepower.tone_ratios.launches == before + 1
    for b in range(3):
        one = tonepower.tone_ratios(xd[b], tm, window, stride)
        for g, o in zip(got, one):
            assert torch.equal(torch.nan_to_num(g[b], nan=7.0), torch.nan_to_num(o, nan=7.0))
    want = tonepower.tone_ratios_reference(xd, tm, window, stride)
    _assert_close(got, want, (3, tonepower.n_windows(n, window, stride)))


@pytest.mark.cuda
def test_batched_kernel_vs_plain_and_rows_bitwise():
    """One launch for a (5, n) batch: within 2e-4 of the plain version with
    equal NaN positions, and every row bitwise equal to the 1-D kernel."""
    _need_cuda()
    fs, window, stride = 44100.0, 4410, 1764
    rng = np.random.default_rng(6)
    t = np.arange(int(fs * 30.0)) / fs
    rows = []
    for b in range(5):
        x = (0.4 * np.sin(2 * np.pi * 400 * t) + 0.2 * np.sin(2 * np.pi * 7500 * t)
             + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
        x[int(len(x) * (1 - 0.1 * b)):] = 0.0
        rows.append(x)
    xd = torch.from_numpy(np.stack(rows)).cuda()
    tm = torch.from_numpy(goertzel.tone_matrix(window, FREQS, fs, np.float32)).cuda()
    before = tonepower.tone_ratios.launches
    got = tonepower.tone_ratios(xd, tm, window, stride)
    assert tonepower.tone_ratios.launches == before + 1
    want = tonepower.tone_ratios_reference(xd, tm, window, stride)
    for b in range(5):
        one = tonepower.tone_ratios(xd[b], tm, window, stride)
        for g, o in zip(got, one):
            assert torch.equal(torch.nan_to_num(g[b], nan=7.0), torch.nan_to_num(o, nan=7.0))
    for g, w in zip(got, want):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        assert g.shape == w.shape == (5, tonepower.n_windows(len(t), window, stride))
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    _need_cuda()
    x = torch.zeros(100000, device="cuda")
    tm = torch.zeros((4410, 6), device="cuda")
    with pytest.raises(RuntimeError, match="float32"):
        tonepower.tone_ratios(x.double(), tm, 4410, 1764)
    with pytest.raises(RuntimeError, match="contiguous"):
        tonepower.tone_ratios(torch.zeros(200000, device="cuda")[::2], tm, 4410, 1764)
    with pytest.raises(RuntimeError, match="window, 6"):
        tonepower.tone_ratios(x, tm[:, :4].contiguous(), 4410, 1764)
    with pytest.raises(RuntimeError, match="CUDA"):
        tonepower.tone_ratios(x, tm.cpu(), 4410, 1764)
    with pytest.raises(RuntimeError, match="rows, n"):
        tonepower.tone_ratios(x.reshape(2, 5, -1), tm, 4410, 1764)
    with pytest.raises(RuntimeError, match="contiguous"):
        tonepower.tone_ratios(torch.zeros((50000, 4), device="cuda").t(), tm, 4410, 1764)
    with pytest.raises(RuntimeError, match="float32"):
        tonepower.tone_ratios(torch.zeros((4, 50000), dtype=torch.int16, device="cuda"),
                              tm, 4410, 1764)
    with pytest.raises(RuntimeError, match="at most 3 strides"):
        tonepower.tone_ratios(x, tm, 4410, 1000)


@pytest.mark.cuda
def test_decode_on_card_equals_cpu_decode():
    """The whole decode of the 50 s default drop: CUDA against CPU."""
    _need_cuda()
    pcm, truth = simulator.synthesize()
    raw = np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)
    before = tonepower.tone_ratios.launches
    gpu = engine.decode_waveform(raw, truth["spec"].fs, device="cuda")
    assert tonepower.tone_ratios.launches == before + 1
    cpu = engine.decode_waveform(raw, truth["spec"].fs, device="cpu")
    assert gpu.status == cpu.status == 2
    assert gpu.metadata == cpu.metadata
    assert gpu.firstpulse400 == cpu.firstpulse400
    assert gpu.profstartind == cpu.profstartind
    assert set(gpu.hexframes) == set(cpu.hexframes)


@pytest.mark.cuda
def test_segmented_decode_on_card_equals_cpu_decode():
    """The segmented decode of the 50 s default drop: CUDA against CPU."""
    _need_cuda()
    pcm, truth = simulator.synthesize()
    raw = np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)
    before = tonepower.tone_ratios.launches
    gpu = segmented.decode_waveform_segmented(raw, truth["spec"].fs, device="cuda")
    assert tonepower.tone_ratios.launches == before  # no kernel on this path
    cpu = segmented.decode_waveform_segmented(raw, truth["spec"].fs, device="cpu")
    assert gpu.status == cpu.status == 2
    assert gpu.metadata == cpu.metadata
    a, b = set(gpu.hexframes), set(cpu.hexframes)
    assert len(a & b) / max(len(a | b), 1) >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["monolithic", "segmented"])
@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_lossy_wire_decode_on_card_equals_cpu_decode(wire, mode):
    """The 50 s default drop at the lossy wires: CUDA against CPU, the same
    wire recorded, agreement >= 0.99."""
    _need_cuda()
    pcm, truth = simulator.synthesize()
    raw = np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)
    before = tonepower.tone_ratios.launches
    gpu = engine.decode_waveform(raw, truth["spec"].fs, device="cuda", wire=wire, mode=mode)
    assert tonepower.tone_ratios.launches == before + (mode == "monolithic")
    cpu = engine.decode_waveform(raw, truth["spec"].fs, device="cpu", wire=wire, mode=mode)
    assert gpu.wire == cpu.wire == wire
    assert gpu.status == cpu.status == 2
    assert gpu.metadata == cpu.metadata
    assert gpu.metadata["serial_no"] == truth["serial_no"]
    a, b = set(gpu.hexframes), set(cpu.hexframes)
    assert len(a & b) / max(len(a | b), 1) >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1_000_001,), (8, 99_999), (3, 44_100)])
def test_unpack_int4_and_conditioning_on_card_equal_cpu(shape):
    """``unpack_int4`` bit-equal across devices on random bytes (odd and
    even widths, rows); ``condition_integer`` within 1e-6."""
    _need_cuda()
    n = shape[-1]
    packed = torch.from_numpy(np.random.default_rng(n).integers(
        0, 256, shape[:-1] + ((n + 1) // 2,)).astype(np.uint8))
    cpu = engine.unpack_int4(packed, n)
    gpu = engine.unpack_int4(packed.cuda(), n)
    assert gpu.dtype == torch.int32 and gpu.shape == shape
    assert torch.equal(gpu.cpu(), cpu)
    nv = torch.full(shape[:-1], n)
    c_cpu = engine.condition_integer(cpu, n, nv)
    c_gpu = engine.condition_integer(gpu, n, nv.cuda())
    assert float((c_gpu.cpu() - c_cpu).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_forced_int4_retry_on_card():
    """Seed 11's 60 s drop collapses at int4: with the retry it comes back
    at int8 after two kernel launches, without it degenerate at int4."""
    _need_cuda()
    from axctdprocessor_tpu_torch.utils.config import DecoderConfig

    pcm, truth = simulator.synthesize(simulator.SimSpec(duration=60.0, profile_start=40.0,
                                                        seed=11))
    raw = np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)
    fs = truth["spec"].fs
    bare = engine.decode_waveform(raw, fs, device="cuda", wire="int4", lossy_retry=False)
    assert bare.wire == "int4"
    assert engine.lossy_retry_worthy(bare, len(raw), float(fs), DecoderConfig())
    before = tonepower.tone_ratios.launches
    res = engine.decode_waveform(raw, fs, device="cuda", wire="int4")
    assert tonepower.tone_ratios.launches == before + 2
    assert res.wire == "int8" and res.status == 2
    assert res.metadata["serial_no"] == truth["serial_no"]
    assert len(res.hexframes) > 4 * len(bare.hexframes)


def _three_drops():
    return np.stack([np.round(p * 28000 / np.max(np.abs(p))).astype(np.int16) for p in (
        simulator.synthesize(simulator.SimSpec(duration=42.0, profile_start=33.0, seed=s))[0]
        for s in (20, 21, 22))])


@pytest.mark.cuda
def test_pipelined_batches_on_card_equal_decode_batch():
    """Three batches through the pipeline (stager thread, upload and fetch
    streams): one kernel launch per batch, every row equal to
    ``decode_batch`` of the same batch on the card."""
    _need_cuda()
    from axctdprocessor_tpu_torch.parallel import batch, pipeline

    rows = _three_drops()
    batches = [(rows, None), (rows[::-1].copy(), None),
               (rows[[1, 2, 0]], [1852200, 1800000, 1852200])]
    before = tonepower.tone_ratios.launches
    out = pipeline.decode_batches_pipelined(batches, 44100, device="cuda")
    assert tonepower.tone_ratios.launches == before + 3
    for (pcms, lengths), got in zip(batches, out):
        want = batch.decode_batch(pcms, 44100, device="cuda", lengths=lengths)
        for g, w in zip(got, want):
            assert g.status == w.status == 2 and g.overflow == 0
            assert g.metadata == w.metadata and g.hexframes == w.hexframes
            assert g.time == w.time and g.numpoints == w.numpoints


@pytest.mark.cuda
def test_corpus_on_card(tmp_path):
    """Three WAVs and a corrupt file through ``reprocess_corpus`` on the card
    in batches of 2: two kernel launches, reports equal to the CPU run's but
    for frames a device difference may move (hexframe agreement >= 0.99)."""
    _need_cuda()
    from axctdprocessor_tpu_torch.parallel.archive import reprocess_corpus

    paths = []
    for i in range(3):
        spec = simulator.SimSpec(duration=40.0, profile_start=33.0, seed=50 + i)
        paths.append(str(tmp_path / f"drop{i}.wav"))
        simulator.write_wav(paths[-1], simulator.synthesize(spec)[0], spec.fs)
    bad = str(tmp_path / "corrupt.wav")
    open(bad, "wb").write(b"RIFFgarbage_that_is_not_a_wav")
    before = tonepower.tone_ratios.launches
    manifest = reprocess_corpus(paths + [bad], str(tmp_path / "gpu"), batch_size=2, device="cuda")
    assert tonepower.tone_ratios.launches == before + 2
    reprocess_corpus(paths, str(tmp_path / "cpu"), batch_size=2, device="cpu")
    assert manifest["files"]["corrupt.wav"]["status"] == "failed"
    for i in range(3):
        assert manifest["files"][f"drop{i}.wav"]["status"] == "done"
        gpu, cpu = (set(ln.split(",")[1] for ln in open(tmp_path / d / f"drop{i}.txt")
                        if ln.count(",") == 5) for d in ("gpu", "cpu"))
        assert len(gpu) > 100 and len(gpu & cpu) / len(gpu | cpu) >= 0.99


@pytest.mark.cuda
def test_timesharded_decode_on_card():
    """Two drops over a 2 x 2 mesh whose every place is the one card (the
    caller's list repeats it): no kernel launch (plain tone powers), metadata
    equal to the batch path's on the card and hexframe agreement >= 0.99."""
    _need_cuda()
    from axctdprocessor_tpu_torch.parallel import batch, timeshard
    from axctdprocessor_tpu_torch.parallel.mesh import make_mesh

    rows = _three_drops()[:2]
    mesh = make_mesh({"dp": 2, "sp": 2}, [torch.device("cuda", 0)] * 4)
    before = tonepower.tone_ratios.launches
    got = timeshard.decode_batch_timesharded(rows, 44100, mesh=mesh)
    assert tonepower.tone_ratios.launches == before
    want = batch.decode_batch(rows, 44100, device="cuda")
    for g, w in zip(got, want):
        assert g.status == w.status == 2 and g.overflow == 0
        assert g.metadata == w.metadata
        assert (g.firstpulse400, g.profstartind) == (w.firstpulse400, w.profstartind)
        a, b = set(g.hexframes), set(w.hexframes)
        assert len(a) > 100 and len(a & b) / len(a | b) >= 0.99


@pytest.mark.cuda
def test_dp_mesh_batch_on_card_equals_decode_batch():
    """Three rows over ``dp = 2`` on the one card: one kernel launch per run
    (two) and the padding row dropped; every row equal to ``decode_batch`` of
    its run alone (rows 0-1, then row 2 with row 0 as padding).  The pipeline
    with both halves' devices named: rows equal to ``decode_batch``'s."""
    _need_cuda()
    from axctdprocessor_tpu_torch.parallel import batch, pipeline
    from axctdprocessor_tpu_torch.parallel.mesh import make_mesh

    def same(res, want):
        assert len(res) == len(want) == 3
        for g, w in zip(res, want):
            assert g.status == w.status == 2 and g.overflow == 0
            assert g.metadata == w.metadata and g.hexframes == w.hexframes
            assert g.time == w.time

    rows = _three_drops()
    card = torch.device("cuda", 0)
    runs = (batch.decode_batch(rows[:2], 44100, device="cuda")
            + batch.decode_batch(rows[[2, 0]], 44100, device="cuda")[:1])
    before = tonepower.tone_ratios.launches
    got = batch.decode_batch(rows, 44100, mesh=make_mesh({"dp": 2}, [card] * 2))
    assert tonepower.tone_ratios.launches == before + 2
    same(got, runs)
    piped = pipeline.decode_batches_pipelined([(rows, None)], 44100, devices=[card, card])
    assert tonepower.tone_ratios.launches == before + 3
    same(piped[0], batch.decode_batch(rows, 44100, device="cuda"))
