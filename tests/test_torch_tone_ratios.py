"""The port's tone-ratio function against the Pallas kernel it replaces.

On the CPU, ``tone_ratios_reference`` (the plain PyTorch version) is held
against JAX ``fused_tone_ratios(interpret=True)`` and against the unfused
XLA path, with rtol/atol 2e-4 (tests/test_pallas_kernels.py) and equal NaN
positions: the inputs end in a zero-padded tail, where the dead-tone mean
is 0 and the ratios are NaN.  The CUDA kernel itself runs only on a GPU,
where there is no jax: its tests are in tests/test_torch_cuda.py.

A (B, n) batch (the batch path) is held against the Pallas kernel under
``jax.vmap``, as the JAX batch path calls it.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from axctdprocessor_tpu.ops import goertzel as jgoertzel
from axctdprocessor_tpu.ops import iir as jiir
from axctdprocessor_tpu.ops.pallas import tonepower as jtonepower
from axctdprocessor_tpu_torch.ops import goertzel, tonepower

torch.set_num_threads(2)

FREQS = [400.0, 7500.0, 3000.0]


def _signal(fs: float, seconds: float, tail: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs * seconds)) / fs
    x = (0.4 * np.sin(2 * np.pi * 400 * t) + 0.2 * np.sin(2 * np.pi * 7500 * t)
         + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
    x[int(len(x) * (1 - tail)):] = 0.0
    return x


def _assert_ratios(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4)


CASES = [(44100.0, 3.0, 0.2, 1), (44100.0, 2.5, 0.0, 2), (16000.0, 4.0, 0.3, 3)]


@pytest.mark.parametrize("fs,seconds,tail,seed", CASES)
def test_reference_vs_pallas_interpret(fs, seconds, tail, seed):
    x = _signal(fs, seconds, tail, seed)
    window, stride = int(fs / 10), int(round(fs / 25))
    segs = jtonepower.trig_segments(window, stride, FREQS, fs)
    want = jtonepower.fused_tone_ratios(jnp.asarray(x), jnp.asarray(segs),
                                        window, stride, block=16, interpret=True)
    tm = torch.from_numpy(goertzel.tone_matrix(window, FREQS, fs, np.float32))
    got = tonepower.tone_ratios_reference(torch.from_numpy(x), tm, window, stride)
    _assert_ratios(got, want)
    if tail:
        assert np.isnan(got[0].numpy()).sum() > 0


@pytest.mark.parametrize("fs,seconds,tail,seed", CASES)
def test_reference_vs_unfused_xla(fs, seconds, tail, seed):
    x = _signal(fs, seconds, tail, seed)
    window, stride = int(fs / 10), int(round(fs / 25))
    trig = jgoertzel.tone_matrix(window, FREQS, fs, dtype=np.float32)
    p = jgoertzel.framed_tone_power_tiled(jnp.asarray(x), window, stride,
                                          jnp.asarray(trig))
    sm = [jiir.boxsmooth_lag(p[:, i], 5) for i in range(3)]
    want = (jnp.log10(sm[0] / sm[2]), jnp.log10(sm[1] / sm[2]))
    got = tonepower.tone_ratios_reference(torch.from_numpy(x),
                                          torch.from_numpy(trig), window, stride)
    _assert_ratios(got, want)


def test_dispatch_on_cpu_is_the_plain_version():
    x = _signal(44100.0, 2.0, 0.1, 4)
    tm = torch.from_numpy(goertzel.tone_matrix(4410, FREQS, 44100.0, np.float32))
    before = tonepower.tone_ratios.launches
    got = tonepower.tone_ratios(torch.from_numpy(x), tm, 4410, 1764)
    want = tonepower.tone_ratios_reference(torch.from_numpy(x), tm, 4410, 1764)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    assert tonepower.tone_ratios.launches == before  # no kernel on the CPU
    assert got[0].shape[0] == tonepower.n_windows(len(x), 4410, 1764)


def _batch(fs: float, seconds: float):
    """Three rows: tails of 0, 20% and 45% zeros, different noise."""
    return np.stack([_signal(fs, seconds, tail, seed)
                     for tail, seed in ((0.0, 5), (0.2, 6), (0.45, 7))])


@pytest.mark.parametrize("fs,seconds", [(44100.0, 3.0), (16000.0, 3.5)])
def test_batched_reference_vs_vmapped_pallas_interpret(fs, seconds):
    x = _batch(fs, seconds)
    window, stride = int(fs / 10), int(round(fs / 25))
    segs = jnp.asarray(jtonepower.trig_segments(window, stride, FREQS, fs))
    want = jax.vmap(lambda row: jtonepower.fused_tone_ratios(
        row, segs, window, stride, block=16, interpret=True))(jnp.asarray(x))
    tm = torch.from_numpy(goertzel.tone_matrix(window, FREQS, fs, np.float32))
    got = tonepower.tone_ratios_reference(torch.from_numpy(x), tm, window, stride)
    assert got[0].shape == (3, tonepower.n_windows(x.shape[1], window, stride))
    _assert_ratios(got, want)
    assert np.isnan(got[0][2].numpy()).sum() > np.isnan(got[0][1].numpy()).sum() > 0


def test_batched_reference_rows_equal_one_dimensional_calls():
    x = _batch(44100.0, 2.5)
    tm = torch.from_numpy(goertzel.tone_matrix(4410, FREQS, 44100.0, np.float32))
    before = tonepower.tone_ratios.launches
    got = tonepower.tone_ratios(torch.from_numpy(x), tm, 4410, 1764)
    assert tonepower.tone_ratios.launches == before  # no kernel on the CPU
    for b in range(3):
        want = tonepower.tone_ratios_reference(torch.from_numpy(x[b]), tm, 4410, 1764)
        for g, w in zip(got, want):
            torch.testing.assert_close(g[b], w, rtol=0, atol=0, equal_nan=True)
