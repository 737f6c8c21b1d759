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

from axctdprocessor_tpu_torch.models import engine, simulator
from axctdprocessor_tpu_torch.ops import goertzel, tonepower

FREQS = [400.0, 7500.0, 3000.0]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU or interpret mode")


@pytest.mark.cuda
@pytest.mark.parametrize("fs,seconds,tail", [(44100.0, 600.0, 0.0),
                                             (44100.0, 60.0, 0.25),
                                             (16000.0, 45.0, 0.1)])
def test_kernel_vs_plain(fs, seconds, tail):
    """rtol/atol 2e-4 (the Pallas kernel's tolerance), equal NaN positions."""
    _need_cuda()
    rng = np.random.default_rng(5)
    t = np.arange(int(fs * seconds)) / fs
    x = (0.4 * np.sin(2 * np.pi * 400 * t) + 0.2 * np.sin(2 * np.pi * 7500 * t)
         + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
    x[int(len(x) * (1 - tail)):] = 0.0
    window, stride = int(fs / 10), int(round(fs / 25))
    xd = torch.from_numpy(x).cuda()
    tm = torch.from_numpy(goertzel.tone_matrix(window, FREQS, fs, np.float32)).cuda()
    before = tonepower.tone_ratios.launches
    got = tonepower.tone_ratios(xd, tm, window, stride)
    want = tonepower.tone_ratios_reference(xd, tm, window, stride)
    torch.cuda.synchronize()
    assert tonepower.tone_ratios.launches == before + 1
    for g, w in zip(got, want):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        assert g.shape == w.shape == (tonepower.n_windows(len(x), window, stride),)
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
