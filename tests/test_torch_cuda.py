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
    even widths, rows); ``condition_integer`` too (an exact DC mean)."""
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
    assert torch.equal(c_gpu.cpu(), c_cpu)


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


def _strided_table(rows: int, m: int, seed: int) -> np.ndarray:
    """Bit-edge-like successors (next - i in [1, 4]) with stalls; with
    three rows or more a row whose live part ends early, with two or more a
    dead row (all fixed points)."""
    rng = np.random.default_rng(seed)
    nxt = np.arange(m) + rng.integers(1, 5, (rows, m))
    nxt = np.where(rng.random((rows, m)) < 0.003, np.arange(m), nxt)
    if rows > 2:
        nxt[0, m // 3:] = np.arange(m // 3, m)
    if rows > 1:
        nxt[-1] = np.arange(m)
    return np.minimum(nxt, m - 1).astype(np.int64)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,m,k", [
    (1, 1_801_024, 600_064),   # the 600 s drop's table
    (8, 181_024, 60_064),      # 8 rows of 60 s
    (3, 5000, 1000),           # k not a multiple of first
    (3, 2000, 100),            # k <= first: no tail
    (2, 500, 1),
])
def test_chain_enumerate_strided_kernels_vs_plain(rows, m, k):
    """Bit for bit; three launches of ``chain_walk_segments`` per call,
    whatever the rows; each row equal to its 1-D call."""
    _need_cuda()
    from axctdprocessor_tpu_torch.ops import chain

    nxt = torch.from_numpy(_strided_table(rows, m, k)).cuda()
    before = chain.chain_enumerate_strided.launches
    got = chain.chain_enumerate_strided(nxt, 0, k)
    assert chain.chain_enumerate_strided.launches == before + 3
    want = chain.chain_enumerate_strided_reference(nxt, 0, k)
    assert got.shape == (rows, k) and torch.equal(got, want)
    for r in range(rows):
        assert torch.equal(chain.chain_enumerate_strided(nxt[r], 0, k), got[r])


@pytest.mark.cuda
def test_chain_enumerate_strided_kernel_seams():
    """The tiling's seams: a chain of stride 4 that enters every segment at
    its first entry, fixed points on a segment's first and last entry and on
    a tile's last entry, a table shorter than one segment, start != 0, and k
    longer than the chain."""
    _need_cuda()
    from axctdprocessor_tpu_torch.ops import chain

    seg, tile = chain.SEGMENT, chain.SEGMENT * chain.SEGMENTS_PER_BLOCK
    m = 3 * tile + 77
    step4 = np.minimum(np.arange(m) + 4, m - 1)
    rows = np.stack([step4] * 4)
    rows[1, 5 * seg] = 5 * seg
    rows[2, [8 * seg - 4, 8 * seg - 1]] = 8 * seg - 1
    rows[3, [tile - 4, tile - 1]] = tile - 1
    nxt = torch.from_numpy(rows).cuda()
    for start, k in ((0, m), (0, 1), (3, 2 * tile), (tile + 1, 5000)):
        got = chain.chain_enumerate_strided(nxt, start, k)
        assert torch.equal(got, chain.chain_enumerate_strided_reference(nxt, start, k)), (start, k)
    short = torch.from_numpy(np.minimum(np.arange(seg // 2) + 3, seg // 2 - 1)).cuda()
    assert torch.equal(chain.chain_enumerate_strided(short, 0, 40),
                       chain.chain_enumerate_strided_reference(short, 0, 40))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,m,k", [(1, 38_528, 18_760), (8, 4_778, 1_884), (3, 3000, 50)])
def test_chain_enumerate_kernel_vs_plain(rows, m, k):
    """The walk of a general map over full jump tables: bit for bit, one
    launch."""
    _need_cuda()
    from axctdprocessor_tpu_torch.ops import chain

    rng = np.random.default_rng(k)
    nxt = np.minimum(np.arange(m) + rng.integers(0, 40, (rows, m)), m - 1)
    nxt[-1] = np.arange(m)
    nxt = torch.from_numpy(nxt).cuda()
    before = chain.chain_walk.launches
    got = chain.chain_enumerate(nxt, 0, k)
    assert chain.chain_walk.launches == before + 1
    assert torch.equal(got, chain.chain_enumerate_reference(nxt, 0, k))


def _frame_table(rows: int, n: int, k: int, density: float = 0.05) -> torch.Tensor:
    """Frame sync's successor table on the card, built as the decodes build
    it from random accepts with a run of frames every 32 bits; rows cut short
    at different n_bits, the last one with no accept at all."""
    from axctdprocessor_tpu_torch.ops import chain

    rng = np.random.default_rng(k)
    acc = rng.random((rows, n)) < density
    for r in range(rows):
        s0 = int(rng.integers(0, n // 2))
        acc[r, s0: s0 + n // 3: 32] = True
    n_bits = np.linspace(n, n // 3, rows).astype(np.int64)
    if rows > 1:
        acc[-1] = False
    _, _, succ = chain.frame_successors(torch.from_numpy(acc).cuda(),
                                        torch.from_numpy(n_bits).cuda())
    return succ


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,k", [
    (1, 600_064, 18_760),   # the 600 s drop's profile frames: cap 38,528
    (8, 60_064, 1_885),     # 8 rows of 60 s: cap 4,778
    (64, 60_064, 1_885),
    (1, 2_400, 77),         # a header window: cap 1,174
    (8, 2_400, 77),
    (3, 20, 12),            # cap < 32
    (2, 40_000, 1),
    (2, 40_000, 3_000),     # k longer than the chain
])
def test_chain_enumerate_frames_kernel_vs_plain(rows, n, k):
    """Frame sync's walk: bit for bit the plain version and the jump-table
    walk, one launch of ``chain_walk_frames`` per call and no ``chain_walk``,
    each row equal to its 1-D call."""
    _need_cuda()
    from axctdprocessor_tpu_torch.ops import chain

    succ = _frame_table(rows, n, k)
    before, walks = chain.chain_enumerate_frames.launches, chain.chain_walk.launches
    got = chain.chain_enumerate_frames(succ, 0, k)
    assert chain.chain_enumerate_frames.launches == before + 1
    assert chain.chain_walk.launches == walks
    assert got.shape == (rows, k)
    assert torch.equal(got, chain.chain_enumerate_reference(succ, 0, k))
    assert torch.equal(got, chain.chain_enumerate(succ, 0, k))
    for r in range(rows):
        assert torch.equal(chain.chain_enumerate_frames(succ[r], 0, k), got[r])


@pytest.mark.cuda
def test_chain_enumerate_frames_kernel_seams():
    """The frame walk's seams: a stride of 32 that enters every segment and
    tile at offset 0, fixed points on a warp's first and last lane and a
    tile's last entry, a start inside a segment, a table that is no multiple
    of a segment, accepts that overflow the capacity."""
    _need_cuda()
    from axctdprocessor_tpu_torch.ops import chain

    seg = chain.FRAME_STRIDE
    tile = seg * chain.FRAME_WARPS * chain.FRAME_SEGMENTS_PER_WARP
    m = 3 * tile + 77
    s32 = np.minimum(np.arange(m) + seg, m - 1)
    rows = np.stack([s32] * 4)
    rows[1, 5 * seg] = 5 * seg
    rows[2, [7 * seg, 8 * seg - 1]] = 8 * seg - 1
    rows[3, [tile - seg, tile - 1]] = tile - 1
    succ = torch.from_numpy(rows).cuda()
    for start, k in ((0, m), (0, 1), (seg + 5, 400), (tile + 1, 5000)):
        got = chain.chain_enumerate_frames(succ, start, k)
        assert torch.equal(got, chain.chain_enumerate_reference(succ, start, k)), (start, k)
    over = _frame_table(2, 40_000, 2_000, density=0.9)
    assert torch.equal(chain.chain_enumerate_frames(over, 0, 2_000),
                       chain.chain_enumerate_reference(over, 0, 2_000))


@pytest.mark.cuda
def test_batched_back_half_on_card_rows_equal_rows_alone():
    """The back half of three rows in one pass on the card: each row bitwise
    the row alone (``back_half``, the B = 1 case), and equal to the CPU's."""
    _need_cuda()
    from axctdprocessor_tpu_torch.utils.config import DecoderConfig

    rows = _three_drops()
    cfg = DecoderConfig()
    n = rows.shape[1]
    dims = engine.EngineDims.for_waveform(n, 44100.0, cfg.bitrate, engine.probe_window(cfg, 44100.0))
    outs = {}
    for dev in ("cuda", "cpu"):
        model = engine.FusedDecoder.from_numpy_tables(
            engine.engine_tables(cfg, 44100.0, dims), dims, 44100.0, bitrate=float(cfg.bitrate),
            bit_inset=cfg.bit_inset, device=dev)
        x = torch.from_numpy(rows).to(dev)
        nv = torch.full((3,), n, dtype=torch.int64, device=dev)
        with torch.inference_mode():
            s1 = model.stage1(x, nv)
            full = model.back_half(s1, nv)
            tables = [getattr(model, k) for k in ("trig_i", "trig_f", "hdr_rel", "calib_off")]
            for r in range(3):
                one = engine.back_half({k: v[r] for k, v in s1.items()}, nv[r], *tables,
                                       dims, 44100.0)
                assert torch.equal(full[r], one), (dev, r)
        outs[dev] = [engine.finish_result(row, 44100, n, 44100.0, cfg)
                     for row in full.cpu().numpy()]
    for g, c in zip(outs["cuda"], outs["cpu"]):
        assert g.status == c.status == 2 and g.metadata == c.metadata


BIT_FREQS = [400.0, 800.0]  # the default mark and space tones


def _probe_case(rows, length, k, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((rows, length)).astype(np.float32)).cuda()
    starts = torch.from_numpy(np.sort(rng.integers(-50, length + 50, (rows, k)), axis=1)).cuda()
    trig = torch.from_numpy(goertzel.tone_matrix(39, BIT_FREQS, 44100.0, np.float32)).cuda()
    return x, starts, trig


@pytest.mark.cuda
def test_probe_at_kernel_vs_plain_and_rows_bitwise():
    """``probe_at`` over 8 rows: one launch, within 2e-4 of the plain version
    (``tone_power_at``), every row bit-equal to the 1-D call on that row, and
    on rows that are a view of a wider tensor."""
    _need_cuda()
    x, starts, trig = _probe_case(8, 200_000, 3_000, 11)
    before = goertzel.probe_at.launches
    got = goertzel.probe_at(x, starts, 39, trig)
    assert goertzel.probe_at.launches == before + 1 and got.shape == (8, 3_000, 2)
    want = goertzel.tone_power_at(x, starts, 39, trig)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=2e-4, atol=2e-4)
    for r in range(8):
        assert torch.equal(goertzel.probe_at(x[r], starts[r], 39, trig), got[r]), r
    view = x[:, 1_000: 150_001]
    np.testing.assert_allclose(goertzel.probe_at(view, starts, 39, trig).cpu().numpy(),
                               goertzel.tone_power_at(view, starts, 39, trig).cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    assert torch.equal(goertzel.probe_at(view, starts, 39, trig),
                       goertzel.probe_at(view.contiguous(), starts, 39, trig))


@pytest.mark.cuda
@pytest.mark.parametrize("length", [5_000, 39])
def test_probe_at_kernel_edges(length):
    """Starts of 0 and L - window, and clamped beyond both ends; rows one
    window long; K = 0 launches nothing."""
    _need_cuda()
    x, _, trig = _probe_case(2, length, 1, 12)
    last = length - 39
    starts = torch.tensor([[0, last, last + 1, length + 100, -5]] * 2, device="cuda")
    got = goertzel.probe_at(x, starts, 39, trig)
    np.testing.assert_allclose(got.cpu().numpy(),
                               goertzel.tone_power_at(x, starts, 39, trig).cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    assert torch.equal(got, goertzel.probe_at(x, starts.clamp(0, last), 39, trig))
    before = goertzel.probe_at.launches
    assert goertzel.probe_at(x, starts[:, :0], 39, trig).shape == (2, 0, 2)
    assert goertzel.probe_at.launches == before
    with pytest.raises(RuntimeError, match="window"):
        goertzel.probe_at(x[:, :20].contiguous(), starts, 39, trig)


def _probe_run_starts(case, k, length, rng):
    """(3, k) starts of one of the probe kernel's run cases (see
    ``test_probe_at_kernel_runs``)."""
    gap = 97 if case == "overflowing" else 55
    live = {"sorted tail": k - 300, "unsorted": k - 300, "K below the run": k - 10}.get(case, k)
    e = np.cumsum(rng.integers(gap - 1, gap + 2, (3, k)), axis=1) + rng.integers(0, 50, (3, 1))
    e[:, live:] = e[:, live - 1: live]
    if case == "unsorted":
        e = rng.permuted(e, axis=1)
    if case == "clamped last":
        e[:, -1] = length + 100
    return torch.from_numpy(e.astype(np.int64)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("case,k", [("sorted tail", 1_000), ("unsorted", 1_000),
                                    ("overflowing", 1_000), ("clamped last", 300),
                                    ("K below the run", 50)])
def test_probe_at_kernel_runs(case, k):
    """The probe's runs at their edges, on 3 rows at an odd pitch: bit edges
    with a long tail of the terminal edge (K no multiple of the run), the
    same unsorted, starts 97 apart (every run's span overflows the staged
    buffer), one start beyond L after live edges (clamped to L - window; its
    run overflows), K below the run.  Within 2e-4 of the plain version,
    every row bit-equal to its 1-D call, every probe bit-equal to its frame
    probed in a staged run of its own."""
    _need_cuda()
    from axctdprocessor_tpu_torch.ops.kernels import extension

    run, span = extension().probe_geometry(39)
    assert run * 97 > span > run * 57  # edges 55 apart are staged, 97 apart overflow
    rng = np.random.default_rng(13)
    length = 200_000
    wide = torch.from_numpy(rng.standard_normal((3, length + 11)).astype(np.float32)).cuda()
    x = wide[:, 3: 3 + length]
    trig = torch.from_numpy(goertzel.tone_matrix(39, [1200.0, 2400.0], 44100.0,
                                                 np.float32)).cuda()
    starts = _probe_run_starts(case, k, length, rng)
    got = goertzel.probe_at(x, starts, 39, trig)
    np.testing.assert_allclose(got.cpu().numpy(),
                               goertzel.tone_power_at(x, starts, 39, trig).cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    for r in range(3):
        assert torch.equal(goertzel.probe_at(x[r], starts[r], 39, trig), got[r]), r
    alone = goertzel.probe_at(x, starts.repeat_interleave(run, dim=-1), 39, trig)
    assert torch.equal(alone[:, ::run], got)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,seconds", [(4, 23.72), (1, 23.72), (1, 150.0), (26, 23.72)])
def test_tone_powers_small_grid_equals_standard(rows, seconds):
    """``tone_powers`` at every block shape of the kernel (the extension's
    ``tone_powers_shapes()``: warps, windows a warp; the standard one first)
    bit-equal to the standard one and to the launcher's choice, on the
    segmented path's shapes: a group of 4 segments, one segment, a time
    block, 26 segments."""
    _need_cuda()
    from axctdprocessor_tpu_torch.ops.kernels import extension

    shapes = extension().tone_powers_shapes()
    fs, window, stride = 44100.0, 4410, 1764
    rng = np.random.default_rng(rows)
    x = torch.from_numpy(np.stack([_signal(fs, int(seconds * fs), 0.0, rng)
                                   for _ in range(rows)])).cuda()
    tm = torch.from_numpy(goertzel.tone_matrix(window, FREQS, fs, np.float32)).cuda()
    want = tonepower.tone_powers(x, tm, window, stride, shapes[0])
    assert torch.equal(tonepower.tone_powers(x, tm, window, stride), want)
    for shape in shapes:
        assert torch.equal(tonepower.tone_powers(x, tm, window, stride, shape), want), shape
    with pytest.raises(RuntimeError, match="block shape"):
        tonepower.tone_powers(x, tm, window, stride, (16, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int16, np.int8, np.int32])
def test_conditioning_on_card_rows_equal_rows_alone_and_cpu(dtype):
    """``condition_integer`` of 8 zero-padded integer rows on the card: each
    row bit-equal to the row conditioned alone, and the whole to the CPU."""
    _need_cuda()
    rng = np.random.default_rng(3)
    hi = {np.int16: 30000, np.int8: 120, np.int32: 7}[dtype]
    n = 441_001
    pcm = np.clip(rng.integers(-hi, hi, (8, n)) + hi // 10, -hi, hi).astype(dtype)
    lengths = n - rng.integers(0, 50_000, 8)
    for r, m in enumerate(lengths):
        pcm[r, m:] = 0
    cpu, nv = torch.from_numpy(pcm), torch.from_numpy(lengths)
    got = engine.condition_integer(cpu.cuda(), n, nv.cuda())
    assert torch.equal(got.cpu(), engine.condition_integer(cpu, n, nv))
    for r in range(8):
        assert torch.equal(engine.condition_integer(cpu[r].cuda(), n, nv[r].cuda()), got[r]), r


@pytest.mark.cuda
def test_tone_powers_kernel_vs_plain_and_rows_bitwise():
    """``tone_powers`` over 8 rows that are a view of a wider tensor (the
    segmented path's bodies): one launch, within 2e-4 of the plain tiled
    powers, every row bit-equal to the 1-D call, and equal to the powers of
    a contiguous copy; no window launches nothing."""
    _need_cuda()
    fs, window, stride = 44100.0, 4410, 1764
    rng = np.random.default_rng(9)
    wide = torch.from_numpy(np.stack([_signal(fs, 30 * 44100, 0.1 * b, rng)
                                      for b in range(8)])).cuda()
    x = wide[:, 4096: 4096 + 20 * 44100 + 5]
    tm = torch.from_numpy(goertzel.tone_matrix(window, FREQS, fs, np.float32)).cuda()
    before = tonepower.tone_powers.launches
    got = tonepower.tone_powers(x, tm, window, stride)
    assert tonepower.tone_powers.launches == before + 1
    n_win = tonepower.n_windows(x.shape[-1], window, stride)
    assert got.shape == (8, n_win, 3)
    want = tonepower.tone_powers_reference(x, tm, window, stride)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=2e-4, atol=2e-4)
    assert torch.equal(got, tonepower.tone_powers(x.contiguous(), tm, window, stride))
    for r in range(8):
        assert torch.equal(tonepower.tone_powers(x[r], tm, window, stride), got[r]), r
    before = tonepower.tone_powers.launches
    assert tonepower.tone_powers(x[:, :100], tm, window, stride).shape == (8, 0, 3)
    assert tonepower.tone_powers.launches == before


@pytest.mark.cuda
def test_segment_group_on_card_rows_equal_segments_alone():
    """A group of 4 segments of a 100 s drop in one pass on the card: every
    output of every segment bit-equal to the segment alone."""
    _need_cuda()
    from axctdprocessor_tpu_torch.utils.config import DecoderConfig

    pcm, _ = simulator.synthesize(simulator.SimSpec(duration=100.0, profile_start=33.0, seed=91))
    raw = np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)
    model = segmented.SegmentedDecoder.from_config(DecoderConfig(), 44100.0, False, "cuda")
    exts = np.zeros((4, model.in_len), np.int16)
    for k in range(4):
        lo = k * model.seg_len - segmented.LEFT_HALO
        s_lo, s_hi = max(lo, 0), min(lo + model.in_len, len(raw))
        exts[k, s_lo - lo: s_hi - lo] = raw[s_lo:s_hi]
    ext = torch.from_numpy(exts).cuda()
    dc = torch.full((), float(np.mean(raw)), device="cuda")
    peak = torch.full((), float(np.max(np.abs(raw.astype(np.int32)))), device="cuda")
    with torch.inference_mode():
        group = model.segment(ext, torch.arange(4, device="cuda") * model.seg_len, dc, peak,
                              len(raw))
        for k in range(4):
            alone = model.segment(ext[k], k * model.seg_len, dc, peak, len(raw))
            for g, a in zip(group, alone):
                assert torch.equal(g[k], a), k


@pytest.mark.cuda
def test_stage1_on_card_rows_equal_rows_alone():
    """``FusedDecoder.stage1`` over three rows, conditioned on the card as a
    batch, in one pass: every output of every row bit-equal to the row as a
    batch of one (the conditioning's row sums are taken once: their order of
    summation on the card depends on the batch's shape)."""
    _need_cuda()
    from axctdprocessor_tpu_torch.utils.config import DecoderConfig

    rows = _three_drops()
    cfg = DecoderConfig()
    n = rows.shape[1]
    dims = engine.EngineDims.for_waveform(n, 44100.0, cfg.bitrate, engine.probe_window(cfg, 44100.0))
    model = engine.FusedDecoder.from_numpy_tables(
        engine.engine_tables(cfg, 44100.0, dims), dims, 44100.0, bitrate=float(cfg.bitrate),
        bit_inset=cfg.bit_inset, device="cuda")
    nv = torch.full((3,), n, dtype=torch.int64, device="cuda")
    x = engine.conditioned(torch.from_numpy(rows).cuda(), nv)
    with torch.inference_mode():
        s1 = model.stage1(x, nv)
        for r in range(3):
            one = model.stage1(x[r: r + 1], nv[r: r + 1])
            for key, v in s1.items():
                assert torch.equal(one[key][0], v[r]), (r, key)


@pytest.mark.cuda
@pytest.mark.parametrize("fs", [88200.0, 96000.0])
@pytest.mark.parametrize("rows", [0, 8])
def test_streamed_table_kernel_vs_plain(fs, rows):
    """Windows whose table does not fit beside the ring (88.2 kHz: 8,820 /
    3,528; 96 kHz: 9,600 / 3,840), as the batch and archive paths hand them
    over at the native rate: ``tone_ratios`` and ``tone_powers`` launch the
    streamed table (the extension's plan says so, ``streamed_launches``
    counts it), within 2e-4 of the plain version with equal NaN positions,
    every row bit-equal to its 1-D call; ``tone_powers`` bit-equal at every
    block shape, the resident table among them where it fits (88.2 kHz at
    (8, 2))."""
    _need_cuda()
    from axctdprocessor_tpu_torch.ops.kernels import extension

    window, stride = int(fs / 10), int(round(fs / 25))
    rng = np.random.default_rng(int(fs) + rows)
    n = int(20 * fs) + 3
    x = np.stack([_signal(fs, n, 0.1 * (r % 3), rng) for r in range(max(rows, 1))])
    xd = torch.from_numpy(x if rows else x[0]).cuda()
    tm = torch.from_numpy(goertzel.tone_matrix(window, FREQS, fs, np.float32)).cuda()
    n_win = tonepower.n_windows(n, window, stride)
    ext = extension()
    plan = ext.tone_plan(False, max(rows, 1), n_win, window, stride)
    assert plan[4] <= plan[5], plan
    before, streamed = tonepower.tone_ratios.launches, tonepower.tone_ratios.streamed_launches
    got = tonepower.tone_ratios(xd, tm, window, stride)
    assert tonepower.tone_ratios.launches == before + 1
    assert tonepower.tone_ratios.streamed_launches == streamed + (plan[0] == "streamed")
    _assert_close(got, tonepower.tone_ratios_reference(xd, tm, window, stride),
                  xd.shape[:-1] + (n_win,))
    # the ratios at every block shape (the standard one streams the table;
    # the launcher takes a small one on these grids under one wave)
    ratio_variants = set()
    for shape in ext.tone_powers_shapes():
        r400, r7500, was_streamed = ext.tone_ratios(xd, tm, window, stride, n_win, *shape)
        for g, w in zip((r400, r7500), got):
            assert torch.equal(torch.nan_to_num(g, nan=7.0), torch.nan_to_num(w, nan=7.0)), shape
        ratio_variants.add(was_streamed)
        if shape == (8, 16):
            assert was_streamed, shape
    assert ratio_variants == ({False, True} if fs == 88200.0 else {True}), ratio_variants
    powers = tonepower.tone_powers(xd, tm, window, stride)
    np.testing.assert_allclose(powers.cpu().numpy(),
                               tonepower.tone_powers_reference(xd, tm, window, stride)
                               .cpu().numpy(), rtol=2e-4, atol=2e-4)
    variants = set()
    for shape in extension().tone_powers_shapes():
        before = tonepower.tone_powers.streamed_launches
        assert torch.equal(tonepower.tone_powers(xd, tm, window, stride, shape), powers), shape
        variants.add(tonepower.tone_powers.streamed_launches - before)
    assert variants == ({0, 1} if fs == 88200.0 else {1}), variants
    for r in range(rows):
        one = tonepower.tone_ratios(xd[r], tm, window, stride)
        for g, o in zip(got, one):
            assert torch.equal(torch.nan_to_num(g[r], nan=7.0), torch.nan_to_num(o, nan=7.0)), r
        assert torch.equal(tonepower.tone_powers(xd[r], tm, window, stride), powers[r]), r


@pytest.mark.cuda
def test_tone_plan_reports_the_launch():
    """The extension's plan: the resident table at 44.1 and 48 kHz in the
    standard shape, the streamed one above; the raw powers' small shapes on
    a grid under one wave; a window over 3 strides refused."""
    _need_cuda()
    from axctdprocessor_tpu_torch.ops.kernels import extension

    ext = extension()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for fs, want in ((44100.0, "resident"), (48000.0, "resident"), (88200.0, "streamed"),
                     (96000.0, "streamed"), (192000.0, "streamed")):
        window, stride = int(fs / 10), int(round(fs / 25))
        for powers in (False, True):
            variant, warps, wpw, blocks, smem, optin = ext.tone_plan(powers, 64, 1500, window,
                                                                     stride)
            assert (variant, warps, wpw) == (want, 8, 16), (fs, powers, variant, warps, wpw)
            assert blocks == 64 * 13 and smem <= optin, (blocks, smem, optin)
    variant, warps, wpw, blocks, _, _ = ext.tone_plan(True, 1, 589, 4410, 1764)
    assert (variant, warps, wpw) == ("resident", 8, 2) and blocks <= sms
    with pytest.raises(RuntimeError, match="at most 3 strides"):
        ext.tone_plan(False, 1, 100, 4410, 1000)


def _drop(fs, seconds, seed):
    """(x on the card, tm, window, stride, n_win) of one drop of `seconds`
    at `fs` as the monolithic decode hands it to the tone kernel (a 15 s
    bucket, its tail zero)."""
    window, stride = int(fs / 10), int(round(fs / 25))
    x = torch.from_numpy(_signal(fs, int(seconds * fs), 0.1, np.random.default_rng(seed))).cuda()
    tm = torch.from_numpy(goertzel.tone_matrix(window, FREQS, fs, np.float32)).cuda()
    return x, tm, window, stride, tonepower.n_windows(x.shape[-1], window, stride)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["60 s", "300 s", "88.2 kHz 60 s, streamed", "B = 3"])
def test_tone_ratios_small_grid_equals_standard(case):
    """``tone_ratios`` at every block shape of the kernel (the extension's
    ``tone_powers_shapes()``, the standard one first) bit-equal to the
    standard shape and to the launcher's choice, which is a small shape on
    these grids under one wave, as the plan says and the launcher's record
    names: one drop of 60 s and of 300 s, one 88.2 kHz row of 60 s (the
    streamed table), 3 rows of 60 s."""
    _need_cuda()
    from axctdprocessor_tpu_torch.ops.kernels import extension

    ext = extension()
    fs = 88200.0 if case.startswith("88.2") else 44100.0
    x, tm, window, stride, n_win = _drop(fs, 300.0 if case == "300 s" else 60.0, 7)
    if case == "B = 3":
        x = torch.stack([x, x.roll(1000), x.flip(0)])
    rows = x.shape[0] if x.dim() == 2 else 1
    variant, warps, wpw, blocks, _, _ = ext.tone_plan(False, rows, n_win, window, stride)
    shapes = ext.tone_powers_shapes()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert (warps, wpw) != shapes[0] and blocks <= sms, (warps, wpw, blocks)
    got = tonepower.tone_ratios(x, tm, window, stride)
    assert ext.tone_last_launch() == (3, False, warps, wpw, variant == "streamed")
    for shape in shapes:
        r400, r7500, _ = ext.tone_ratios(x, tm, window, stride, n_win, *shape)
        for g, w in zip((r400, r7500), got):
            assert torch.equal(torch.nan_to_num(g, nan=7.0), torch.nan_to_num(w, nan=7.0)), shape
    with pytest.raises(RuntimeError, match="block shape"):
        ext.tone_ratios(x, tm, window, stride, n_win, 16, 8)


@pytest.mark.cuda
def test_tone_plan_names_the_ratios_small_shape():
    """``tone_plan(False, 1, n_win, ...)`` of one drop of 60 s names a small
    block shape whose grid fits one wave, the same as the raw powers'; at 600
    s, 8 and 64 rows of 60 s the standard shape."""
    _need_cuda()
    from axctdprocessor_tpu_torch.ops.kernels import extension

    ext = extension()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    standard = ext.tone_powers_shapes()[0]
    n_win = tonepower.n_windows(60 * 44100, 4410, 1764)
    plan = ext.tone_plan(False, 1, n_win, 4410, 1764)
    assert plan[1:3] != standard and plan[3] <= sms, plan
    assert plan == ext.tone_plan(True, 1, n_win, 4410, 1764), plan
    for rows, seconds in ((1, 600), (8, 60), (64, 60)):
        n_win = tonepower.n_windows(seconds * 44100, 4410, 1764)
        assert ext.tone_plan(False, rows, n_win, 4410, 1764)[1:3] == standard, (rows, seconds)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [39, 81, 88])
def test_probe_geometry_by_window(window):
    """The probe's geometry for the engine's windows at 44.1, 88.2 and 96
    kHz: the standard one (the first of ``probe_geometries()``) at 39, the
    high-rate one above 50, whose buffer holds a run of bit edges at that
    rate (110.25 and 120 samples a bit); a probe call's record names the
    geometry it launched, a call with no start none."""
    _need_cuda()
    from axctdprocessor_tpu_torch.ops.kernels import extension

    ext = extension()
    geometries = [tuple(g) for g in ext.probe_geometries()]
    run, span = ext.probe_geometry(window)
    assert ((run, span) == geometries[0]) == (window <= 50), (window, run, span)
    bit = {39: 44100, 81: 88200, 88: 96000}[window] / 800
    assert (run - 1) * bit + window + 3 <= span, (window, run, span)
    x = torch.randn(2, 50_000, device="cuda")
    trig = torch.from_numpy(goertzel.tone_matrix(window, BIT_FREQS, 44100.0, np.float32)).cuda()
    starts = torch.arange(0, 40_000, int(bit), device="cuda").repeat(2, 1)
    goertzel.probe_at(x, starts, window, trig)
    assert ext.probe_last_launch() == (run, span)
    goertzel.probe_at(x, starts[:, :0], window, trig)
    assert ext.probe_last_launch() == (0, 0)


@pytest.mark.cuda
def test_probe_at_88_khz_batch_rows_bitwise_at_every_geometry():
    """``probe_at`` on 8 rows of 60 s at 88.2 kHz (window 81) with bit edges
    110.25 samples apart after a quiet start and a tail of the terminal edge:
    within 2e-4 of the plain version, every row bit-equal to its 1-D call,
    and bit-equal at every geometry forced (the standard one, whose runs
    mostly read straight from device memory here, among them)."""
    _need_cuda()
    from axctdprocessor_tpu_torch.ops.kernels import extension

    ext = extension()
    fs, window, length, live, k = 88200.0, 81, int(60 * 88200), 47_600, 60_064
    rng = np.random.default_rng(88)
    x = torch.from_numpy(rng.standard_normal((8, length)).astype(np.float32)).cuda()
    gaps = np.round(fs / 800 + rng.uniform(-1, 1, (8, live)))
    edges = (0.3 * fs + rng.integers(0, 200, (8, 1)) + np.cumsum(gaps, axis=1)).astype(np.int64)
    st = np.concatenate([edges, np.repeat(edges[:, -1:], k - live, axis=1)], axis=1)
    starts = torch.from_numpy(st).cuda()
    trig = torch.from_numpy(goertzel.tone_matrix(window, BIT_FREQS, fs, np.float32)).cuda()
    got = goertzel.probe_at(x, starts, window, trig)
    assert ext.probe_last_launch() == ext.probe_geometry(window)
    np.testing.assert_allclose(got.cpu().numpy(),
                               goertzel.tone_power_at(x, starts, window, trig).cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    for r in range(8):
        assert torch.equal(goertzel.probe_at(x[r], starts[r], window, trig), got[r]), r
    for g in ext.probe_geometries():
        assert torch.equal(ext.probe_at(x, starts, trig, *g), got), g
    with pytest.raises(RuntimeError, match="geometry"):
        ext.probe_at(x, starts, trig, 96, 4096)


@pytest.mark.cuda
def test_tone_last_launch_names_the_instance():
    """The extension's record of the instance a tone call launched (its
    template arguments) is the plan's: the resident standard shape at 44.1
    kHz, the streamed one at 88.2 kHz, every forced raw-powers shape (at
    88.2 kHz all streamed but (8, 2)); all zero after a call with no
    window."""
    _need_cuda()
    from axctdprocessor_tpu_torch.ops.kernels import extension

    ext = extension()
    for fs in (44100.0, 88200.0):
        window, stride = int(fs / 10), int(round(fs / 25))
        nseg = -(-window // stride)
        x = torch.zeros(int(20 * fs), device="cuda")
        tm = torch.from_numpy(goertzel.tone_matrix(window, FREQS, fs, np.float32)).cuda()
        n_win = tonepower.n_windows(x.shape[-1], window, stride)
        variant, warps, wpw, _, _, _ = ext.tone_plan(False, 1, n_win, window, stride)
        tonepower.tone_ratios(x, tm, window, stride)
        assert ext.tone_last_launch() == (nseg, False, warps, wpw, variant == "streamed"), fs
        for shape in ext.tone_powers_shapes():
            tonepower.tone_powers(x, tm, window, stride, shape)
            streamed = fs == 88200.0 and shape != (8, 2)  # (8, 2) holds 88.2 kHz resident
            assert ext.tone_last_launch() == (nseg, True, *shape, streamed), (fs, shape)
        tonepower.tone_powers(x[:window - 1], tm, window, stride)
        assert ext.tone_last_launch() == (0, False, 0, 0, False), fs


_REFUSAL_CHILD = r"""
import numpy as np, torch
from axctdprocessor_tpu_torch.ops import goertzel, tonepower
x = torch.zeros(200000, device="cuda")
tm = torch.zeros((4410, 6), device="cuda")
for call in (lambda: tonepower.tone_ratios(x, tm, 4410, 1000),
             lambda: tonepower.tone_powers(x, tm, 4410, 1000),
             lambda: tonepower.tone_powers(x, tm, 4410, 1764, (16, 8)),
             lambda: tonepower.tone_powers(x, tm, 4410, 1764, (8, 7))):
    try:
        call()
    except RuntimeError as e:
        print("REFUSED", str(e).splitlines()[0])
    else:
        raise SystemExit("not refused")
torch.cuda.synchronize()
tm = torch.from_numpy(goertzel.tone_matrix(4410, [400.0, 7500.0, 3000.0], 44100.0,
                                           np.float32)).cuda()
r400, _ = tonepower.tone_ratios(x, tm, 4410, 1764)
torch.cuda.synchronize()
print("ALIVE", r400.shape[0])
"""


@pytest.mark.cuda
def test_refused_launch_raises_and_the_process_lives():
    """A window over 3 strides and a block shape the kernel does not have are
    refused with a RuntimeError, in a child process that then launches the
    kernel and exits 0 (a refusal once took the process down)."""
    _need_cuda()
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    done = subprocess.run([sys.executable, "-c", _REFUSAL_CHILD], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, (done.returncode, done.stdout, done.stderr[-3000:])
    lines = done.stdout.splitlines()
    assert sum(ln.startswith("REFUSED") for ln in lines) == 4, lines
    assert lines[-1] == f"ALIVE {tonepower.n_windows(200000, 4410, 1764)}", lines


@pytest.mark.cuda
@pytest.mark.parametrize("fs", [88200, 96000])
def test_high_rate_batch_on_card_equals_cpu(fs):
    """Rows above 50 kHz decode at their native rate through ``decode_batch``
    (the streamed table): on the card status 2 with the truth's serial, and
    the CPU's hexframes and integer fields of the packed result."""
    _need_cuda()
    from axctdprocessor_tpu_torch.parallel import batch

    spec = simulator.SimSpec(fs=fs, duration=42.0, profile_start=33.0, seed=31)
    pcm, truth = simulator.synthesize(spec)
    base = np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)
    rng = np.random.default_rng(fs)
    rows = np.stack([np.clip(base + rng.integers(-300, 300, len(base)), -32768, 32767)
                     .astype(np.int16) for _ in range(2)])
    before = tonepower.tone_ratios.streamed_launches
    out, ctx = batch.dispatch_batch(rows, fs, device="cuda")
    card = out.cpu().numpy()
    got = batch.finish_dispatched(out, ctx)
    assert tonepower.tone_ratios.streamed_launches == before + 1
    out_cpu, ctx_cpu = batch.dispatch_batch(rows, fs, device="cpu")
    want = batch.finish_dispatched(out_cpu, ctx_cpu)
    for r, (g, w) in enumerate(zip(got, want)):
        assert g.status == 2 and g.metadata["serial_no"] == truth["serial_no"], r
        assert g.hexframes == w.hexframes and g.metadata == w.metadata, r
        gu, wu = engine.unpack_result(card[r]), engine.unpack_result(out_cpu.numpy()[r])
        for name in ("scal_i", "hdr", "hexpack", "edges"):
            np.testing.assert_array_equal(gu[name], wu[name], err_msg=f"{name} row {r}")



def _counts():
    from axctdprocessor_tpu_torch.ops import chain

    return {"tone_ratios": tonepower.tone_ratios.launches, "probe_at": goertzel.probe_at.launches,
            "chain_walk_segments": chain.chain_enumerate_strided.launches,
            "chain_walk_frames": chain.chain_enumerate_frames.launches}


def _int16_drop(duration: float, seed: int) -> np.ndarray:
    pcm, _ = simulator.synthesize(simulator.SimSpec(duration=duration, profile_start=20.0,
                                                    seed=seed))
    return np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)


@pytest.mark.cuda
def test_program_replay_equals_the_eager_module(monkeypatch):
    """Four drops of one 45 s bucket in a row through the monolithic decode's
    cached program (eager; captured and replayed; replayed twice): each
    packed vector bit for bit a fresh ``FusedDecoder``'s eager forward on
    the card; every decode, replayed or not, adds the eager forward's
    launches to each kernel's count, and the program's records name the
    launches its capture made."""
    _need_cuda()
    from axctdprocessor_tpu_torch.models import programs
    from axctdprocessor_tpu_torch.ops.kernels import extension
    from axctdprocessor_tpu_torch.utils.config import DecoderConfig

    packed = []
    real = engine.finish_result
    monkeypatch.setattr(engine, "finish_result",
                        lambda out, *a, **k: packed.append(np.array(out)) or real(out, *a, **k))
    programs.clear()
    drops = [_int16_drop(d, s) for d, s in ((36.0, 3), (44.0, 8), (40.0, 17), (41.0, 5))]
    steps = []
    for raw in drops:
        before = _counts()
        assert engine.decode_waveform(raw, 44100, device="cuda").status == 2
        steps.append({k: v - before[k] for k, v in _counts().items()})
    (program,) = programs.programs()
    assert program.calls == 4 and program.graph is not None
    assert steps[0]["tone_ratios"] == 1 and all(s == steps[0] for s in steps), steps
    assert program.records["tone"] is not None
    assert program.records["probe"] == tuple(extension().probe_geometry(program.module.dims.npcm))
    cfg = DecoderConfig()
    dims = program.module.dims
    fresh = engine.FusedDecoder.from_numpy_tables(
        engine.engine_tables(cfg, 44100.0, dims), dims, 44100.0, bitrate=cfg.bitrate,
        bit_inset=cfg.bit_inset, device="cuda")
    for raw, got in zip(drops, packed):
        x = torch.from_numpy(np.concatenate([raw, np.zeros(dims.n - len(raw), np.int16)]))
        with torch.inference_mode():
            want = fresh(x.cuda(), torch.tensor(len(raw), device="cuda")).cpu().numpy()
        np.testing.assert_array_equal(got, want)
    programs.clear()


@pytest.mark.cuda
def test_program_whose_capture_fails_raises():
    """A forward that cannot be captured (it reads a device value on the
    host) runs on its first call, raises at its capture and at every later
    call, and never decodes eagerly in its place; the card goes on
    capturing other programs."""
    _need_cuda()
    from axctdprocessor_tpu_torch.models import programs

    ones = np.ones(4, np.float32)
    bad = programs.Program(lambda x: x * x.sum().item(), (torch.zeros(4, device="cuda"),),
                           "cuda")
    assert torch.equal(bad(ones).cpu(), torch.full((4,), 4.0))
    before = _counts()
    for _ in range(2):
        with pytest.raises(RuntimeError):
            bad(ones)
        assert bad.graph is None and bad.calls == 1
    assert _counts() == before
    good = programs.Program(lambda x: x * 2, (torch.zeros(4, device="cuda"),), "cuda")
    outs = [good(ones * k) for k in (1, 2, 3)]
    assert good.graph is not None
    for k, out in zip((1, 2, 3), outs):
        assert torch.equal(out.cpu(), torch.full((4,), 2.0 * k))


@pytest.mark.cuda
def test_program_capture_opens_its_span_once():
    """On a card a program's first call opens ``program.eager``, its second
    ``program.capture``, and a replay opens no ``program.*`` span."""
    _need_cuda()
    from axctdprocessor_tpu_torch.models import programs
    from axctdprocessor_tpu_torch.utils import profiling

    timer = profiling.StageTimer()
    program = programs.Program(lambda x: x * 3, (torch.zeros(4, device="cuda"),), "cuda")
    with profiling.installed(timer):
        outs = [program(np.full(4, k, np.float32)) for k in (1, 2, 3)]
    assert program.graph is not None
    assert {k: v for k, v in timer.counts.items() if k.startswith("program.")} == {
        "program.eager": 1, "program.capture": 1}
    assert timer.counts["pin_upload"] == 3
    for k, out in zip((1, 2, 3), outs):
        assert torch.equal(out.cpu(), torch.full((4,), 3.0 * k))


@pytest.mark.cuda
def test_program_captures_on_a_stream_of_its_own_device():
    """A program on the last card, called while card 0 is current (the
    pipeline's back half on a second card): it captures on a stream of its
    own device, and each replay gives the forward of the input just
    loaded, not the capture's (on one card both devices are card 0)."""
    _need_cuda()
    from axctdprocessor_tpu_torch.models import programs

    last = torch.device("cuda", torch.cuda.device_count() - 1)
    program = programs.Program(lambda x: x * 2 + 1, (torch.zeros(4, device=last),), last)
    with torch.cuda.device(0):
        outs = [program(np.full(4, k, np.float32)) for k in (1, 2, 3, 4)]
    assert program.graph is not None and program.calls == 4
    assert program.capture_stream.device == program.device == last
    for k, out in zip((1, 2, 3, 4), outs):
        assert out.device == last and torch.equal(out.cpu(), torch.full((4,), 2.0 * k + 1))


@pytest.mark.cuda
def test_pipeline_on_two_cards_equals_decode_batch():
    """Three batches through ``decode_batches_pipelined(devices=[cuda:0,
    cuda:1])``: the back half's programs live and are captured on card 1
    while card 0 is current, and every batch's packed matrix equals
    ``decode_batch``'s on card 0 bit for bit.  Needs two cards."""
    _need_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    from axctdprocessor_tpu_torch.models import programs
    from axctdprocessor_tpu_torch.parallel import batch, pipeline

    programs.clear()
    rows = np.stack([_int16_drop(40.0, s) for s in (3, 8, 17)])
    batches = [(rows[[0, 1]], None), (rows[[1, 2]], None), (rows[[2, 0]], None)]
    packed = []
    real = engine.finish_result
    engine.finish_result = lambda out, *a, **k: packed.append(np.array(out)) or real(out, *a, **k)
    try:
        with torch.cuda.device(0):
            out = pipeline.decode_batches_pipelined(batches, 44100,
                                                    devices=["cuda:0", "cuda:1"])
    finally:
        engine.finish_result = real
    front, back = programs.programs()
    assert front.device == torch.device("cuda", 0) and back.device == torch.device("cuda", 1)
    assert front.graph is not None and back.graph is not None and back.calls == 3
    assert back.capture_stream.device == back.device
    for b, (sub, _) in enumerate(batches):
        want, _ = batch.dispatch_batch(sub, 44100, device="cuda:0")
        np.testing.assert_array_equal(np.stack(packed[2 * b: 2 * b + 2]), want.cpu().numpy())
        assert all(r.status == 2 for r in out[b])
    programs.clear()


@pytest.mark.cuda
def test_reprocess_corpus_over_four_cards_equals_one_card(tmp_path):
    """``reprocess_corpus`` over ``make_mesh({"dp": 4})`` on four cards, in
    batches of 3 padded to 4 (one row a card): six 45 s, six 90 s and four
    88.2 kHz drops make each of a card's three shapes twice a pass, so the
    first pass builds, runs eagerly and captures on every card, the second
    replays on every card.  Both passes' reports are byte for byte those of
    one card (``device="cuda:0"``); the second pass builds, captures and
    evicts nothing on any card.  Needs four cards."""
    _need_cuda()
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    import os

    from axctdprocessor_tpu_torch.models import programs
    from axctdprocessor_tpu_torch.parallel.archive import reprocess_corpus
    from axctdprocessor_tpu_torch.parallel.mesh import make_mesh

    programs.clear()
    paths = []
    for i, (duration, fs) in enumerate([(45.0, 44100)] * 6 + [(90.0, 44100)] * 6
                                       + [(60.0, 88200)] * 4):
        spec = simulator.SimSpec(duration=duration, fs=fs, profile_start=33.0, seed=60 + i)
        paths.append(str(tmp_path / f"drop{i:02d}.wav"))
        simulator.write_wav(paths[-1], simulator.synthesize(spec)[0], spec.fs)
    mesh = make_mesh({"dp": 4})
    cards = mesh.devices_along("dp")
    assert cards == [torch.device("cuda", k) for k in range(4)]

    def counts():
        return {str(c): {k: programs.cache_stats(c)[k] for k in ("builds", "captures",
                                                                 "evictions")} for c in cards}

    one = reprocess_corpus(paths, str(tmp_path / "one"), batch_size=3, device="cuda:0")
    programs.clear()  # its last batch, one float row, is a mesh run's shape on card 0
    before = counts()
    first = reprocess_corpus(paths, str(tmp_path / "mesh0"), batch_size=3, mesh=mesh,
                             resume=False)
    mid = counts()
    second = reprocess_corpus(paths, str(tmp_path / "mesh1"), batch_size=3, mesh=mesh,
                              resume=False)
    for c in map(str, cards):
        made = {k: mid[c][k] - before[c][k] for k in mid[c]}
        assert made == {"builds": 3, "captures": 3, "evictions": 0}, (c, made)
    assert counts() == mid
    assert first["program_cache"]["captures"] == 12
    assert {k: second["program_cache"][k] for k in ("builds", "captures", "evictions")} == \
        {"builds": 0, "captures": 0, "evictions": 0}
    for name in sorted(one["files"]):
        assert one["files"][name]["status"] == "done", name
        stem = os.path.splitext(name)[0] + ".txt"
        want = open(tmp_path / "one" / stem, "rb").read()
        assert b"Probe Serial: 00123456" in want
        for out in ("mesh0", "mesh1"):
            assert open(tmp_path / out / stem, "rb").read() == want, (out, name)
    programs.clear()


@pytest.mark.cuda
def test_program_replay_adds_the_counts_of_its_capture():
    """A batch program's replays: the kernels' counts rise by the capture's
    deltas on every replay, as the eager forward raises them; interleaved
    dispatches of two batches each equal the batch's eager forward."""
    _need_cuda()
    from axctdprocessor_tpu_torch.models import programs
    from axctdprocessor_tpu_torch.parallel import batch

    programs.clear()
    rows = np.stack([_int16_drop(40.0, s) for s in (3, 8, 17, 21)])
    before = _counts()
    outs = [batch.dispatch_batch(sub, 44100, device="cuda") for sub in (rows[:2], rows[2:]) * 2]
    after = _counts()
    (program,) = programs.programs()
    assert program.calls == 4 and program.graph is not None
    assert {k: (after[k] - before[k]) / 4 for k in after} == {
        "tone_ratios": 1, "probe_at": 1, "chain_walk_segments": 3, "chain_walk_frames": 3}
    assert sum(d for (_, name, count), d in program.deltas.items()
               if name == "tone_ratios" and count == "launches") == 1
    plan = batch.BatchPlan(rows.dtype, rows.shape[1], 44100, None, "auto", "cuda")
    for k, (out, ctx) in enumerate(outs):
        sub = (rows[:2], rows[2:])[k % 2]
        with torch.inference_mode():
            want = plan.model(torch.from_numpy(sub).cuda(),
                              torch.full((2,), sub.shape[1], device="cuda"))
        assert torch.equal(out, want), k
        assert all(r.status == 2 for r in batch.finish_dispatched(out, ctx))
    programs.clear()


@pytest.mark.cuda
def test_program_cache_over_its_byte_budget_releases_pools(monkeypatch):
    """Two captured programs, one of whose graphs holds a 256 MiB
    intermediate in its pool: under a budget of 300 MiB both stay; at 100
    MiB the next lookup evicts the large one (the least recently used with
    a pool), and after ``empty_cache`` the card's reserved memory falls by
    at least its pool."""
    _need_cuda()
    from axctdprocessor_tpu_torch.models import programs

    programs.clear()
    torch.cuda.empty_cache()
    budget = {"bytes": 300 * 2 ** 20}
    monkeypatch.setattr(programs, "pool_budget", lambda device: budget["bytes"])
    x = torch.ones(16384, device="cuda")

    def build(width):
        return lambda: programs.Program(
            lambda v: (v[:, None] * torch.ones(width, device="cuda")).sum(1), (x.clone(),),
            "cuda")

    large = programs.cached("large", build(4096))
    small = programs.cached("small", build(4))
    for p, width in ((large, 4096), (small, 4)) * 2:
        assert torch.equal(p(x).cpu(), torch.full((16384,), float(width)))
    assert large.graph is not None and small.graph is not None
    assert large.pool_bytes >= 256 * 2 ** 20 > small.pool_bytes
    assert programs.programs() == [large, small]
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    budget["bytes"] = 100 * 2 ** 20
    programs.cached("small", build(4))
    assert programs.programs() == [small] and large.graph is None
    torch.cuda.empty_cache()
    assert torch.cuda.memory_reserved() <= before - 256 * 2 ** 20
    programs.clear()


def _segmented_fresh(raw, group: int, fs=44100):
    """The eager module's forward over a drop's extensions on the card."""
    from axctdprocessor_tpu_torch.utils.config import DecoderConfig
    from axctdprocessor_tpu_torch.utils.profiling import StageTimer

    p = segmented._plan_waveform(raw, fs, None, "auto", StageTimer(), "cuda", group)
    exts = np.concatenate([segmented._chunk_host(p, j) for j in range(p.n_chunk)])
    fresh = segmented.SegmentedDecoder.from_config(DecoderConfig(), float(fs), False, "cuda")
    with torch.inference_mode():
        return fresh(torch.from_numpy(exts).cuda()[None], p.n_seg, p.dc, p.peak, p.n_raw,
                     p.nv_dec, p.dims).cpu().numpy()


@pytest.mark.cuda
def test_segment_and_assemble_programs_replay_the_eager_module(monkeypatch):
    """Three drops of one 3-segment bucket through the streamed segmented
    decode (each program: eager, captured, replayed), then three prestaged
    group-by-group dispatches, then a longer and a shorter drop in one
    pinned bucket: every packed vector bit for bit the eager module's
    forward on the card; every decode adds the eager launches."""
    _need_cuda()
    from axctdprocessor_tpu_torch.models import programs

    packed = []
    real = engine.finish_result
    monkeypatch.setattr(engine, "finish_result",
                        lambda out, *a, **k: packed.append(np.array(out)) or real(out, *a, **k))
    programs.clear()
    drops = [_int16_drop(d, s) for d, s in ((52.0, 3), (66.0, 8), (59.0, 17))]
    steps = []
    for raw in drops:
        before = _counts()
        assert segmented.decode_waveform_segmented(raw, 44100, device="cuda").status == 2
        steps.append({k: v - before[k] for k, v in _counts().items()})
    seg, asm = programs.programs()
    assert seg.graph is not None and asm.graph is not None and seg.calls == asm.calls == 3
    # the first decode also builds the assemble program, whose module makes
    # its zero segment once
    assert steps[1] == steps[2] and all(steps[0][k] >= v for k, v in steps[1].items()), steps
    for raw, got in zip(drops, packed):
        np.testing.assert_array_equal(got, _segmented_fresh(raw, segmented.GROUP))
    staged = segmented.prestage_waveform(drops[0], 44100, device="cuda", wire="int16",
                                         group=2)
    outs = [staged.dispatch() for _ in range(3)]
    want = _segmented_fresh(drops[0], 2)
    assert all(np.array_equal(o.cpu().numpy(), want) for o in outs)
    monkeypatch.setattr(segmented, "_bucket_count", lambda k: 4)
    packed.clear()
    pair = [_int16_drop(90.0, 5), _int16_drop(40.0, 7)]
    for _ in range(2):  # the second time through captured programs
        for raw in pair:
            segmented.decode_waveform_segmented(raw, 44100, device="cuda", group=2)
    for raw, got in zip(pair * 2, packed):
        np.testing.assert_array_equal(got, _segmented_fresh(raw, 2))
    programs.clear()


@pytest.mark.cuda
def test_device_staged_600_s_drop_on_card_equals_host_staging(monkeypatch):
    """A 600 s int16 drop staged on the card: every group byte for byte
    ``_chunk_host``'s and ``dc`` / ``peak`` bit for bit the host's float64
    statistics; the decode's packed vector bit for bit the same programs fed
    the host-staged groups and statistics; a warm decode (the third: the
    assemble program runs once a decode, so the second captures it) replays
    the cached group and assemble programs (no build, eager run or capture)
    and equals the first decode bit for bit and the CPU decode (agreement
    >= 0.99)."""
    _need_cuda()
    import dataclasses

    from axctdprocessor_tpu_torch.models import programs
    from axctdprocessor_tpu_torch.utils import profiling

    raw = _int16_drop(600.0, 11)
    raw[len(raw) // 3] = -32768
    p = segmented._plan_waveform(raw, 44100, None, "auto", profiling.NO_TIMER, "cuda",
                                 segmented.GROUP)
    assert p.wire == "int16" and p.staged is not None and p.n_chunk == 7
    for j, group in enumerate(p.device_groups()):
        assert np.array_equal(group.cpu().numpy(), segmented._chunk_host(p, j)), j
    dc, peak = np.float32(np.mean(raw)), np.float32(32768.0)
    assert p.dc.cpu().numpy().tobytes() == dc.tobytes()
    assert p.peak.cpu().numpy().tobytes() == peak.tobytes()

    packed = []
    real = engine.finish_result
    monkeypatch.setattr(engine, "finish_result",
                        lambda out, *a, **k: packed.append(np.array(out)) or real(out, *a, **k))
    programs.clear()
    first = segmented.decode_waveform_segmented(raw, 44100, device="cuda")
    segmented.decode_waveform_segmented(raw, 44100, device="cuda")
    timer = profiling.StageTimer()
    warm = segmented.decode_waveform_segmented(raw, 44100, device="cuda", timer=timer)
    seg, asm = programs.programs()
    assert seg.graph is not None and asm.graph is not None
    assert seg.calls == 21 and asm.calls == 3
    assert not [k for k in timer.counts if k.startswith("program.")], dict(timer.counts)
    assert timer.counts["stage_device"] == 1
    np.testing.assert_array_equal(packed[0], packed[1])
    np.testing.assert_array_equal(packed[0], packed[2])
    host = dataclasses.replace(p, staged=None, dc=torch.tensor(dc, device="cuda"),
                               peak=torch.tensor(peak, device="cuda"))
    with programs.pinned(seg, asm):
        segmented._queue_drop(host, seg, asm, [torch.from_numpy(segmented._chunk_host(host, j))
                                               .cuda() for j in range(host.n_chunk)])
        np.testing.assert_array_equal(asm.run().cpu().numpy(), packed[2])
    cpu = segmented.decode_waveform_segmented(raw, 44100, device="cpu")
    assert first.status == warm.status == cpu.status == 2
    assert first.metadata == warm.metadata == cpu.metadata
    assert first.hexframes == warm.hexframes and first.time == warm.time
    a, b = set(warm.hexframes), set(cpu.hexframes)
    assert len(a & b) / max(len(a | b), 1) >= 0.99
    programs.clear()


@pytest.mark.cuda
def test_pinned_stream_captures_nothing_after_its_constructor(monkeypatch):
    """A stream pinned to a 3-segment bucket: its constructor captures the
    one-row segment program and the bucket's assemble program; feeding a
    62 s drop in 1 s blocks with a snapshot at each new segment and
    finalizing captures nothing more, and every snapshot is bit for bit
    the eager module's assemble of the same segments."""
    _need_cuda()
    from axctdprocessor_tpu_torch.models import programs
    from axctdprocessor_tpu_torch.models.stream_device import BIG_N, DeviceStreamDecoder

    programs.clear()
    pcm, _ = simulator.synthesize(simulator.SimSpec(duration=62.0, profile_start=20.0, seed=12))
    x = ((pcm - np.mean(pcm)) / np.max(np.abs(pcm))).astype(np.float32)
    dec = DeviceStreamDecoder(44100, max_duration=70.0, device="cuda")
    assert [p.graph is not None for p in programs.programs()] == [True, True]
    captures = []
    real_capture = programs.Program.capture
    monkeypatch.setattr(programs.Program, "capture",
                        lambda self: captures.append(self) or real_capture(self))
    packed = []
    real = engine.finish_result
    monkeypatch.setattr(engine, "finish_result",
                        lambda out, *a, **k: packed.append(np.array(out)) or real(out, *a, **k))
    snaps = []
    for i in range(0, len(x), 44100):
        before = dec._next_k
        if dec.feed(x[i: i + 44100]) > before:
            dec.results()
            snaps.append(dec._next_k)
    final = dec.finalize()
    assert captures == [] and snaps == [1, 2] and final.status == 2
    model = segmented.SegmentedDecoder.from_config(dec.cfg, 44100.0, False, "cuda")
    dims = engine.EngineDims.for_waveform(3 * model.seg_len, 44100.0, model.bitrate, model.npcm)
    for n_seg, got, last in ((1, packed[0], False), (2, packed[1], False),
                             (3, packed[2], True)):
        outs = []
        with torch.inference_mode():
            for k in range(n_seg):
                lo = k * model.seg_len - segmented.LEFT_HALO
                ext = np.zeros(model.in_len, np.float32)
                src = x[max(lo, 0): lo + model.in_len]
                ext[max(-lo, 0): max(-lo, 0) + len(src)] = src
                outs.append(model.segment(torch.from_numpy(ext).cuda(), k * model.seg_len,
                                          torch.zeros((), device="cuda"),
                                          torch.ones((), device="cuda"),
                                          len(x) if last else BIG_N))
            n_valid = len(x) if last else n_seg * model.seg_len
            want = model.assemble(outs, torch.tensor(n_valid, device="cuda"), dims)
        np.testing.assert_array_equal(got, want.cpu().numpy())
    programs.clear()


@pytest.mark.cuda
def test_pipeline_programs_replay_the_eager_module():
    """Three batches of one shape through ``decode_batches_pipelined``: the
    stage-1 and back-half programs each eager, captured, replayed; every
    batch's rows bit for bit the eager module's forward on the card."""
    _need_cuda()
    from axctdprocessor_tpu_torch.models import programs
    from axctdprocessor_tpu_torch.parallel import batch, pipeline

    programs.clear()
    rows = np.stack([_int16_drop(40.0, s) for s in (3, 8, 17)])
    batches = [(rows[[0, 1]], None), (rows[[1, 2]], None), (rows[[2, 0]], None)]
    packed = []
    real = engine.finish_result
    engine.finish_result = lambda out, *a, **k: packed.append(np.array(out)) or real(out, *a, **k)
    try:
        out = pipeline.decode_batches_pipelined(batches, 44100, device="cuda")
    finally:
        engine.finish_result = real
    front, back = programs.programs()
    assert front.graph is not None and back.graph is not None
    assert front.calls == back.calls == 3
    plan = batch.BatchPlan(rows.dtype, rows.shape[1], 44100, None, "auto", "cuda")
    for b, (sub, _) in enumerate(batches):
        with torch.inference_mode():
            want = plan.model(torch.from_numpy(sub).cuda(),
                              torch.full((2,), sub.shape[1], device="cuda")).cpu().numpy()
        np.testing.assert_array_equal(np.stack(packed[2 * b: 2 * b + 2]), want)
        assert all(r.status == 2 for r in out[b])
    programs.clear()


@pytest.mark.cuda
def test_segment_program_whose_capture_fails_raises():
    """The group program's forward made to read a device value on the host:
    the first decode runs its first group eagerly and raises at the second
    group's capture, as does the next decode; nothing decodes eagerly in
    the program's place."""
    _need_cuda()
    from axctdprocessor_tpu_torch.models import programs
    from axctdprocessor_tpu_torch.utils.config import DecoderConfig

    programs.clear()
    raw = _int16_drop(52.0, 3)
    seg = segmented.segment_program(DecoderConfig(), 44100.0, False, 1, np.int16, "cuda")
    real = seg.forward
    seg.forward = lambda *a: real(*a) if a[3].item() else None
    for _ in range(2):
        with pytest.raises(RuntimeError):
            segmented.decode_waveform_segmented(raw, 44100, device="cuda", group=1)
        assert seg.graph is None and seg.calls == 1
    programs.clear()


# archive.batch64's batches (portbench): reprocess_corpus(batch_size=64) over the corpus
# mix sorts its 128 files into two int16 batches of 64 and 57 rows, each 120 s wide, and
# one float32 batch of the 7 files at 88.2 kHz, decimated to 60 s rows at 44.1 kHz
WIDE_BATCHES = ((64, 120, np.int16), (57, 120, np.int16), (7, 60, np.float32))


def _wide_batch(rows: int, width_s: int, dtype, bases: list, seed: int):
    """`rows` drops of the mix's lengths (45, 60, 90 and 120 s in turn, at
    most `width_s`), each with noise of its own, zero-padded to `width_s`;
    float rows conditioned as the runner's host reader conditions them."""
    rng = np.random.default_rng(seed)
    fits = [b for b in bases if len(b) <= width_s * 44100]
    pcms = np.zeros((rows, width_s * 44100), dtype)
    lengths = []
    for r in range(rows):
        base = fits[r % len(fits)]
        pcm = np.clip(base.astype(np.int32) + rng.integers(-300, 300, len(base)), -32768, 32767)
        if dtype == np.float32:
            pcm = ((pcm - np.mean(pcm)) / max(np.max(np.abs(pcm)), 1)).astype(np.float32)
        pcms[r, : len(pcm)] = pcm
        lengths.append(len(pcm))
    return pcms, lengths


@pytest.fixture(scope="module")
def wide_passes():
    """Four passes of archive.batch64's three batch shapes through
    ``dispatch_batch`` from an empty cache, in the runner's order (eager,
    captured, replayed, replayed): the batches, each pass's packed
    matrices, and the cache's counts after the first three passes and
    after the fourth."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU or interpret mode")
    from axctdprocessor_tpu_torch.models import programs
    from axctdprocessor_tpu_torch.parallel import batch

    programs.clear()
    bases = [_int16_drop(d, s) for d, s in ((45.0, 3), (60.0, 8), (90.0, 17), (120.0, 5))]
    batches = [_wide_batch(rows, width, dtype, bases, seed)
               for seed, (rows, width, dtype) in enumerate(WIDE_BATCHES)]
    dev = torch.device("cuda", torch.cuda.current_device())
    start = programs.cache_stats(dev)
    packed, stats = [], []
    for k in range(4):
        packed.append([batch.dispatch_batch(pcms, 44100, device="cuda", lengths=lengths)[0]
                       .cpu().numpy() for pcms, lengths in batches])
        if k >= 2:
            now = programs.cache_stats(dev)
            stats.append(dict(now, **{c: now[c] - start[c]
                                      for c in ("builds", "captures", "evictions")}))
    held = {p.key: (p.graph is not None, p.bytes) for p in programs.programs()}
    yield batches, packed, stats, held, programs.pool_budget(dev)
    programs.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [64, 57])
def test_batch_fft_in_chunks_equals_the_whole_batch_fft_at_120_s(rows):
    """``apply_response`` over 64 (and 57) rows of the 120 s width, in calls of
    8 rows (the last of 57 one row), bit for bit the whole batch in one call
    and each row as a 1-D call."""
    _need_cuda()
    from axctdprocessor_tpu_torch.ops import iir
    from axctdprocessor_tpu_torch.utils.config import DecoderConfig

    cfg, fs, n = DecoderConfig(), 44100.0, 120 * 44100
    dims = engine.EngineDims.for_waveform(n, fs, cfg.bitrate, engine.probe_window(cfg, fs))
    nfft = iir.next_pow2(dims.n + 4096)
    sos = torch.from_numpy(engine.engine_tables(cfg, fs, dims)["sos"]).cuda()
    response = engine.sos_response_on_device(sos, nfft)
    gen = torch.Generator(device="cuda").manual_seed(rows)
    x = torch.randn((rows, dims.n), generator=gen, device="cuda")
    tails = torch.arange(dims.n, device="cuda") < torch.linspace(
        45 * 44100, dims.n, rows, device="cuda")[:, None]
    x = torch.where(tails, x, 0.0)
    assert engine.FFT_ROWS_PER_CALL["cuda"] == 8
    with torch.inference_mode():
        got = engine.apply_response(x, response, nfft)
        assert torch.equal(got, engine._response_rows(x, response, nfft))
        for r in (0, 7, 8, rows - 1):
            assert torch.equal(got[r], engine._response_rows(x[r], response, nfft)), r


@pytest.mark.cuda
def test_wide_batch_programs_replay_their_eager_modules(wide_passes):
    """Every pass of each of archive.batch64's batch programs (eager,
    captured, replayed twice) bit for bit a fresh ``FusedDecoder``'s eager
    forward of the batch."""
    from axctdprocessor_tpu_torch.parallel import batch

    batches, packed, _, _, _ = wide_passes
    for b, (pcms, lengths) in enumerate(batches):
        plan = batch.BatchPlan(pcms.dtype, pcms.shape[1], 44100, None, "auto", "cuda")
        fresh = engine.FusedDecoder.from_numpy_tables(
            plan.tables, plan.dims, plan.fs, bitrate=float(plan.cfg.bitrate),
            bit_inset=plan.cfg.bit_inset, edge_pad=engine.EDGE_PAD, device="cuda")
        with torch.inference_mode():
            want = fresh(torch.from_numpy(plan.encode(pcms)).cuda(),
                         torch.tensor(lengths, device="cuda")).cpu().numpy()
        del fresh
        for k in range(4):
            np.testing.assert_array_equal(packed[k][b], want, err_msg=f"batch {b}, pass {k}")


@pytest.mark.cuda
def test_wide_batch_programs_fit_the_cache_budget(wide_passes):
    """The three programs, captured, all held within the budget: three
    builds and three captures, no eviction (the cache evicts at a lookup or
    capture that finds it above the budget); the fourth pass builds,
    captures and evicts nothing."""
    _, _, stats, held, budget = wide_passes
    after_three, after_four = stats
    assert {c: after_three[c] for c in ("builds", "captures", "evictions")} == \
        {"builds": 3, "captures": 3, "evictions": 0}
    assert {c: after_four[c] for c in ("builds", "captures", "evictions")} == \
        {"builds": 3, "captures": 3, "evictions": 0}
    assert len(held) == 3 and all(captured for captured, _ in held.values())
    assert sum(b for _, b in held.values()) == after_four["held_bytes"] <= budget
