"""The plain versions of the demod front end's two kernels against the JAX
package's functions, on the CPU.

* ``goertzel.probe_at`` (on a CPU tensor its plain version, the batched
  ``tone_power_at``) against JAX's ``tone_power_at`` (a correlation, then a
  gather) at rtol = atol = 2e-4, with hypothesis over starts at the edges of
  the rows, K = 0 and rows one window long, and at 88.2 and 96 kHz (the
  batch paths' native rates) on bit edges as a decode hands them over; each
  row of a batch bit for bit the 1-D call on that row;
* ``tonepower.tone_powers`` (on a CPU tensor ``framed_tone_power_tiled``)
  against JAX's ``framed_tone_power_tiled`` at the same tolerance, on rows
  and on views of a wider tensor; each row bit for bit the 1-D call;
* the dispatchers launch nothing on the CPU and refuse other devices.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings, strategies as st

from axctdprocessor_tpu.ops import goertzel as jgoertzel
from axctdprocessor_tpu_torch.ops import goertzel, tonepower

torch.set_num_threads(2)

FS = 44100.0
NPCM = 39  # the probe window at 44.1 kHz (engine.probe_window)
TOL = dict(rtol=2e-4, atol=2e-4)  # the tone kernel's tolerance


def _bit_trig():
    return goertzel.tone_matrix(NPCM, [400.0, 800.0], FS, np.float32)


def _jax_probe(row, starts):
    return np.asarray(jgoertzel.tone_power_at(jnp.asarray(row), jnp.asarray(starts), NPCM,
                                              jnp.asarray(_bit_trig())))


def _rows(b, length, seed):
    return np.random.default_rng(seed).standard_normal((b, length)).astype(np.float32)


@settings(max_examples=25, deadline=None)
@given(length=st.sampled_from([NPCM, NPCM + 1, 700, 4097]),
       k=st.integers(0, 40), seed=st.integers(0, 2 ** 16))
def test_probe_at_plain_equals_jax_at_the_edges(length, k, seed):
    """Starts drawn around both ends of the rows (clamped into [0, L -
    window]), K = 0 included; two rows in one call."""
    rng = np.random.default_rng(seed)
    x = _rows(2, length, seed)
    last = length - NPCM
    pool = np.array([-7, -1, 0, 1, last - 1, last, last + 1, length, length + 9])
    starts = np.where(rng.random((2, k)) < 0.5, rng.choice(pool, (2, k)),
                      rng.integers(0, last + 1, (2, k)))
    trig = torch.from_numpy(_bit_trig())
    got = goertzel.probe_at(torch.from_numpy(x), torch.from_numpy(starts), NPCM, trig).numpy()
    assert got.shape == (2, k, 2)
    for r in range(2):
        np.testing.assert_allclose(got[r], _jax_probe(x[r], starts[r]), **TOL)
        one = goertzel.probe_at(torch.from_numpy(x[r]), torch.from_numpy(starts[r]), NPCM, trig)
        np.testing.assert_array_equal(one.numpy(), got[r])


@pytest.mark.parametrize("rows", [1, 3, 8])
def test_probe_at_rows_bitwise_and_equal_jax(rows):
    """Rows of 60,000 samples with 2,000 sorted starts each, as the decode
    hands them (bit edges): every row within 2e-4 of JAX and bit for bit the
    1-D call, also when the rows are a view of a wider tensor."""
    wide = _rows(rows, 70_000, 3 + rows)
    rng = np.random.default_rng(rows)
    starts = np.sort(rng.integers(0, 60_000, (rows, 2_000)), axis=1)
    trig = torch.from_numpy(_bit_trig())
    for lo, t in ((0, torch.from_numpy(wide[:, :60_000].copy())),
                  (5_000, torch.from_numpy(wide)[:, 5_000: 65_000])):
        got = goertzel.probe_at(t, torch.from_numpy(starts), NPCM, trig).numpy()
        for r in range(rows):
            np.testing.assert_allclose(got[r], _jax_probe(wide[r, lo: lo + 60_000], starts[r]),
                                       **TOL)
            np.testing.assert_array_equal(
                goertzel.probe_at(t[r], torch.from_numpy(starts[r]), NPCM, trig).numpy(), got[r])


@pytest.mark.parametrize("fs", [88200.0, 96000.0])
def test_probe_at_plain_equals_jax_above_50_khz(fs):
    """At the batch paths' native rates, at the window ``engine.probe_window``
    gives (81 samples at 88.2 kHz, 88 at 96 kHz): 3 rows of 2 s, bit edges
    fs / 800 apart (a sample of jitter) after a quiet start of about 0.3 s,
    then a tail that repeats the terminal edge, its last entry beyond the
    row (clamped to L - window).  Each row within 2e-4 of JAX's
    ``tone_power_at`` and bit for bit the 1-D call."""
    from axctdprocessor_tpu_torch.models import engine
    from axctdprocessor_tpu_torch.utils.config import DecoderConfig

    window = engine.probe_window(DecoderConfig(), fs)
    assert window == {88200.0: 81, 96000.0: 88}[fs]
    length, live, k = int(2 * fs), 1_100, 1_300
    rng = np.random.default_rng(int(fs))
    x = _rows(3, length, int(fs))
    gaps = np.round(fs / 800 + rng.uniform(-1, 1, (3, live)))
    edges = (0.3 * fs + rng.integers(0, 200, (3, 1)) + np.cumsum(gaps, axis=1)).astype(np.int64)
    starts = np.concatenate([edges, np.repeat(edges[:, -1:], k - live, axis=1)], axis=1)
    starts[:, -1] = length + 50
    assert starts[:, live - 1].max() <= length - window
    trig = goertzel.tone_matrix(window, [400.0, 800.0], fs, np.float32)
    got = goertzel.probe_at(torch.from_numpy(x), torch.from_numpy(starts), window,
                            torch.from_numpy(trig)).numpy()
    assert got.shape == (3, k, 2)
    for r in range(3):
        want = np.asarray(jgoertzel.tone_power_at(jnp.asarray(x[r]), jnp.asarray(starts[r]),
                                                  window, jnp.asarray(trig)))
        np.testing.assert_allclose(got[r], want, **TOL)
        one = goertzel.probe_at(torch.from_numpy(x[r]), torch.from_numpy(starts[r]), window,
                                torch.from_numpy(trig))
        np.testing.assert_array_equal(one.numpy(), got[r])


@pytest.mark.parametrize("fs,n", [(44100.0, 20 * 44100 + 3), (22050.0, 30 * 22050),
                                  (16000.0, 12_345)])
def test_tone_powers_plain_equals_jax_and_rows_bitwise(fs, n):
    """The raw powers of 3 rows (a view of a wider tensor, as the segmented
    path hands them) within 2e-4 of JAX's ``framed_tone_power_tiled`` on
    each row, and each row bit for bit the 1-D call."""
    window, stride = int(fs / 10), int(round(fs / 25))
    tm = goertzel.tone_matrix(window, [400.0, 7500.0, 3000.0], fs, np.float32)
    wide = _rows(3, n + 4096 + 100, int(fs))
    x = torch.from_numpy(wide)[:, 4096: 4096 + n]
    got = tonepower.tone_powers(x, torch.from_numpy(tm), window, stride)
    assert got.shape == (3, tonepower.n_windows(n, window, stride), 3)
    for r in range(3):
        want = np.asarray(jgoertzel.framed_tone_power_tiled(
            jnp.asarray(wide[r, 4096: 4096 + n]), window, stride, jnp.asarray(tm)))
        np.testing.assert_allclose(got[r].numpy(), want, **TOL)
        np.testing.assert_array_equal(
            tonepower.tone_powers(x[r], torch.from_numpy(tm), window, stride).numpy(),
            got[r].numpy())


def test_dispatchers_on_the_cpu_launch_nothing_and_refuse_other_devices():
    x = torch.zeros((2, 50_000))
    starts = torch.zeros((2, 10), dtype=torch.int64)
    trig = torch.from_numpy(_bit_trig())
    tm = torch.from_numpy(goertzel.tone_matrix(4410, [400.0, 7500.0, 3000.0], FS, np.float32))
    before = goertzel.probe_at.launches, tonepower.tone_powers.launches
    goertzel.probe_at(x, starts, NPCM, trig)
    tonepower.tone_powers(x, tm, 4410, 1764)
    assert (goertzel.probe_at.launches, tonepower.tone_powers.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        goertzel.probe_at(x.to("meta"), starts.to("meta"), NPCM, trig.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tonepower.tone_powers(x.to("meta"), tm.to("meta"), 4410, 1764)
