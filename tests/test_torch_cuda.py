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
