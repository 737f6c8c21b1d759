"""The PyTorch port's device ops against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its port.  Integer outputs must match exactly; float32 outputs within
rtol/atol 2e-4 (the Pallas kernel's tolerance, tests/test_pallas_kernels.py)
unless stated tighter; the FFT-filtered waveform within atol 1e-5.  JAX is
given float32 arrays explicitly (tests/conftest.py turns on x64).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from axctdprocessor_tpu.models import simulator as jsim
from axctdprocessor_tpu.models import tpu_engine as jeng
from axctdprocessor_tpu.ops import chain as jchain
from axctdprocessor_tpu.ops import crc as jcrc
from axctdprocessor_tpu.ops import goertzel as jgoertzel
from axctdprocessor_tpu.ops import header_device as jhdr
from axctdprocessor_tpu.ops import iir as jiir
from axctdprocessor_tpu_torch.models import engine
from axctdprocessor_tpu_torch.ops import chain, crc, goertzel, header_device, iir

torch.set_num_threads(2)

F32 = dict(rtol=2e-4, atol=2e-4)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _crossing_mask(seed: int, seconds: float = 4.0, fs: float = 44100.0):
    """Sign-change mask of a noisy FSK signal: crossings ~1600/s."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, int(seconds * 800))
    x = jsim.fsk_waveform(bits, fs) + 0.05 * rng.standard_normal(
        int(np.ceil(len(bits) * fs / 800)))
    nonneg = x >= 0
    mask = np.concatenate([nonneg[:-1] != nonneg[1:], [False]])
    mask[:100] = False
    return mask


# ---------------------------------------------------------------------------
# stage-1 elementwise and FFT ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [4096, 4095])
def test_unpack_int4(n):
    packed = np.random.default_rng(n).integers(0, 256, (n + 1) // 2).astype(np.uint8)
    want = jeng.unpack_int4(jnp.asarray(packed), n)
    got = engine.unpack_int4(torch.from_numpy(packed), n)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("n", [2048, 2047])
def test_unpack_int4_rows(n):
    """A (B, n) batch unpacks row by row as the JAX 1-D unpack does."""
    packed = np.random.default_rng(n).integers(0, 256, (5, (n + 1) // 2)).astype(np.uint8)
    want = jax.vmap(lambda row: jeng.unpack_int4(row, n))(jnp.asarray(packed))
    got = engine.unpack_int4(torch.from_numpy(packed), n)
    assert got.dtype == torch.int32 and got.shape == (5, n)
    np.testing.assert_array_equal(_np(got), _np(want))
    for b in range(5):
        assert torch.equal(got[b], engine.unpack_int4(torch.from_numpy(packed[b]), n))


@pytest.mark.parametrize("fs", [44100, 88200])
def test_condition_integer(fs):
    rng = np.random.default_rng(fs)
    n_valid = int(fs * 1.3)
    pcm = np.zeros(int(fs * 2), np.int16)
    pcm[:n_valid] = rng.integers(-20000, 20000, n_valid) + 300
    want = jeng.condition_integer(jnp.asarray(pcm), len(pcm),
                                  jnp.asarray(n_valid, jnp.int32))
    got = engine.condition_integer(torch.from_numpy(pcm), len(pcm),
                                   torch.tensor(n_valid))
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-6)
    assert not _np(got)[n_valid:].any()


@pytest.mark.parametrize("fs", [44100, 88200])
def test_decimate2_on_device(fs):
    rng = np.random.default_rng(7)
    n, n_valid = int(fs * 1.5), int(fs * 1.2) + 1
    x = np.zeros(n, np.float32)
    x[:n_valid] = rng.standard_normal(n_valid) * 0.3
    sos = jiir.design_decim_sos().astype(np.float32)
    want, wn = jeng.decimate2_on_device(jnp.asarray(x),
                                        jnp.asarray(n_valid, jnp.int32),
                                        jnp.asarray(sos))
    got, gn = engine.decimate2_on_device(torch.from_numpy(x),
                                         torch.tensor(n_valid),
                                         torch.from_numpy(sos))
    assert int(gn) == int(wn) == (n_valid + 1) // 2
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("fs,bandpass", [(44100.0, False), (16000.0, True)])
def test_sos_response_on_device(fs, bandpass):
    sos = iir.design_sos(fs, bandpass).astype(np.float32)
    np.testing.assert_array_equal(sos, jiir.design_sos(fs, bandpass).astype(np.float32))
    nfft = 1 << 16
    want = _np(jeng.sos_response_on_device(jnp.asarray(sos), nfft))
    got = _np(engine.sos_response_on_device(torch.from_numpy(sos), nfft))
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got.real, want.real, **F32)
    np.testing.assert_allclose(got.imag, want.imag, **F32)


def test_boxsmooth_lag():
    x = np.random.default_rng(3).random(500).astype(np.float32) * 4.0 + 0.01
    want = jiir.boxsmooth_lag(jnp.asarray(x), 5)
    got = iir.boxsmooth_lag(torch.from_numpy(x), 5)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    assert iir.next_pow2(4097) == jiir.next_pow2(4097) == 8192


# ---------------------------------------------------------------------------
# goertzel
# ---------------------------------------------------------------------------

def test_tone_matrix_identical():
    a = goertzel.tone_matrix(4410, [400.0, 7500.0, 3000.0], 44100.0, np.float32)
    b = jgoertzel.tone_matrix(4410, [400.0, 7500.0, 3000.0], 44100.0, np.float32)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fs,extra", [(44100.0, 0), (44100.0, 777), (16000.0, 5)])
def test_framed_tone_power_tiled(fs, extra):
    window, stride = int(fs / 10), int(round(fs / 25))
    rng = np.random.default_rng(int(fs) + extra)
    x = rng.standard_normal(int(fs * 2) + extra).astype(np.float32)
    trig = goertzel.tone_matrix(window, [400.0, 7500.0, 3000.0], fs, np.float32)
    want = jgoertzel.framed_tone_power_tiled(jnp.asarray(x), window, stride,
                                             jnp.asarray(trig))
    got = goertzel.framed_tone_power_tiled(torch.from_numpy(x), window, stride,
                                           torch.from_numpy(trig))
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_tone_power_at():
    rng = np.random.default_rng(5)
    x = rng.standard_normal(20000).astype(np.float32)
    starts = np.concatenate([rng.integers(0, 20000, 300), [-5, 19990, 25000]])
    trig = goertzel.tone_matrix(39, [400.0, 800.0], 44100.0, np.float32)
    want = jgoertzel.tone_power_at(jnp.asarray(x), jnp.asarray(starts), 39,
                                   jnp.asarray(trig))
    got = goertzel.tone_power_at(torch.from_numpy(x), torch.from_numpy(starts),
                                 39, torch.from_numpy(trig))
    np.testing.assert_allclose(_np(got), _np(want), **F32)


# ---------------------------------------------------------------------------
# chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [512, 20000])  # overflowing and roomy
def test_compact_indices(size):
    mask = _crossing_mask(1, seconds=1.0)
    big = np.iinfo(np.int32).max // 2
    wi, wc = jchain.compact_indices(jnp.asarray(mask), size, big)
    gi, gc = chain.compact_indices(torch.from_numpy(mask), size, big)
    np.testing.assert_array_equal(_np(gi), _np(wi))
    assert int(gc) == int(wc) == mask.sum()


@pytest.mark.parametrize("case", ["44k", "16k_dense", "rowcap_overflow"])
def test_compact_indices_rowcap(case):
    mask = _crossing_mask(2, fs=16000.0 if case == "16k_dense" else 44100.0)
    fs = 16000.0 if case == "16k_dense" else 44100.0
    row_cap = chain.rowcap_for_fs(fs)
    assert row_cap == jchain.rowcap_for_fs(fs)
    if case == "rowcap_overflow":
        mask[1280:1300] = True  # 20 crossings in one 128-sample row
    size = int(mask.sum()) + 50
    big = np.iinfo(np.int32).max // 2
    wi, wt, wo = jchain.compact_indices_rowcap(jnp.asarray(mask), size, big,
                                               row_cap=row_cap)
    gi, gt, go = chain.compact_indices_rowcap(torch.from_numpy(mask), size, big,
                                              row_cap=row_cap)
    np.testing.assert_array_equal(_np(gi), _np(wi))
    assert int(gt) == int(wt)
    assert int(go) == int(wo) == (case == "rowcap_overflow")


def test_bit_edge_chain_same_crossings():
    mask = _crossing_mask(4)
    m = int(mask.sum()) + 1024
    big = np.iinfo(np.int32).max // 2
    cj, nj = jchain.compact_indices(jnp.asarray(mask), m, big)
    crossings = _np(cj).astype(np.int32)
    n_cross = int(nj)
    want_nxt = jax.jit(jchain.bit_edge_successors, static_argnums=(2, 3))(
        jnp.asarray(crossings), n_cross, 44100.0, 800.0)
    got_nxt = chain.bit_edge_successors(torch.from_numpy(crossings).long(),
                                        torch.tensor(n_cross), 44100.0, 800.0)
    np.testing.assert_array_equal(_np(got_nxt), _np(want_nxt))
    max_edges = int(len(mask) * 800 / 44100 * 1.25) + 64
    we, wn = jax.jit(jchain.enumerate_bit_edges, static_argnums=(2, 3, 4))(
        jnp.asarray(crossings), n_cross, 44100.0, 800.0, max_edges)
    ge, gn = chain.enumerate_bit_edges(torch.from_numpy(crossings).long(),
                                       torch.tensor(n_cross), 44100.0, 800.0,
                                       max_edges)
    np.testing.assert_array_equal(_np(ge), _np(we))
    assert int(gn) == int(wn) > 2000


@pytest.mark.parametrize("length,max_level", [(100, 7), (5000, 3)])
def test_chain_enumerate_strided(length, max_level):
    rng = np.random.default_rng(length)
    n = 3000
    nxt = np.arange(n) + rng.integers(1, 5, n)
    nxt[rng.random(n) < 0.002] = 0  # a few fixed points (delta 0)
    nxt = np.where(nxt == 0, np.arange(n), nxt)
    nxt = np.minimum(nxt, n - 1).astype(np.int32)
    want = jax.jit(jchain.chain_enumerate_strided, static_argnums=(2, 3, 4))(
        jnp.asarray(nxt), 0, length, 4, max_level)
    got = chain.chain_enumerate_strided(torch.from_numpy(nxt), 0, length,
                                        max_level=max_level)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_chain_enumerate():
    rng = np.random.default_rng(9)
    n = 2000
    nxt = np.minimum(np.arange(n) + rng.integers(0, 40, n), n - 1).astype(np.int32)
    want = jax.jit(jchain.chain_enumerate, static_argnums=(2,))(
        jnp.asarray(nxt), 3, 700)
    got = chain.chain_enumerate(torch.from_numpy(nxt), 3, 700)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("density", [0.04, 0.6])  # sparse, and cap overflow
def test_enumerate_frames(density):
    rng = np.random.default_rng(int(density * 100))
    n, n_bits = 8000, 7600
    accept = rng.random(n) < density
    want = jax.jit(jchain.enumerate_frames, static_argnums=(2, 3))(
        jnp.asarray(accept), n_bits, n, n // 32 + 8)
    got = chain.enumerate_frames(torch.from_numpy(accept), torch.tensor(n_bits),
                                 max_frames=n // 32 + 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


# ---------------------------------------------------------------------------
# crc
# ---------------------------------------------------------------------------

def test_check_crc_words():
    rng = np.random.default_rng(11)
    frames = [crc.encode_crc_np(rng.integers(0, 2, 26)) for _ in range(200)]
    valid_words = [int("".join(map(str, f)), 2) for f in frames]
    words = np.concatenate([np.asarray(valid_words, np.uint64),
                            rng.integers(0, 2 ** 32, 2000, dtype=np.uint64),
                            [0, 2 ** 32 - 1]])
    want = _np(jcrc.check_crc_words(jnp.asarray(words.astype(np.uint32))))
    got = _np(crc.check_crc_words(torch.from_numpy(words.astype(np.int64))))
    np.testing.assert_array_equal(got, want)
    assert got[:200].all()
    np.testing.assert_array_equal(crc.encode_crc_np(frames[0][:26]),
                                  jcrc.encode_crc_np(frames[0][:26]))


def test_check_crc_all_windows():
    rng = np.random.default_rng(12)
    bits = rng.integers(0, 2, 3000)
    for k in range(0, 2900, 97):  # embed valid frames
        bits[k: k + 32] = crc.encode_crc_np(rng.integers(0, 2, 26))
    want = _np(jax.jit(jcrc.check_crc_all_windows)(jnp.asarray(bits.astype(np.int32))))
    got = _np(crc.check_crc_all_windows(torch.from_numpy(bits)))
    np.testing.assert_array_equal(got, want)
    assert got.sum() >= 30


# ---------------------------------------------------------------------------
# header codec
# ---------------------------------------------------------------------------

def _header_window(duplicate: bool):
    """Pulse bits, then 72 header frames (optionally frame 5 sent again
    with other data right after the original), then noise bits."""
    rng = np.random.default_rng(21)
    frames = list(jsim.encode_header_frames())
    if duplicate:
        frames.insert(6, jsim.encode_header_frame(5, "beef"))
    bits = np.concatenate([np.ones(600, np.int64), np.concatenate(frames),
                           rng.integers(0, 2, 500)])
    win = np.zeros(6144, np.int32)
    win[: len(bits)] = bits
    return win, len(bits)


_parse_header_window_jax = jax.jit(jhdr.parse_header_window)


@pytest.mark.parametrize("duplicate", [False, True])
def test_parse_header_window(duplicate):
    win, n_bits = _header_window(duplicate)
    wf, wfr, wu = _parse_header_window_jax(jnp.asarray(win),
                                           jnp.asarray(n_bits, jnp.int32))
    gf, gfr, gu = header_device.parse_header_window(torch.from_numpy(win),
                                                    torch.tensor(n_bits))
    np.testing.assert_array_equal(_np(gf), _np(wf))
    np.testing.assert_array_equal(_np(gfr), _np(wfr))
    assert bool(gu) == bool(wu) is True
    assert _np(gf).all()
    nib5 = "".join("0123456789abcdef"[v] for v in _np(gfr)[5])
    assert nib5 == ("beef" if duplicate else "3456")  # the later frame wins


def test_parse_header_window_short():
    win, _ = _header_window(False)
    wf, wfr, wu = _parse_header_window_jax(jnp.asarray(win),
                                           jnp.asarray(1500, jnp.int32))
    gf, gfr, gu = header_device.parse_header_window(torch.from_numpy(win),
                                                    torch.tensor(1500))
    assert bool(gu) == bool(wu) is False
    np.testing.assert_array_equal(_np(gf), _np(wf))
    np.testing.assert_array_equal(_np(gfr), _np(wfr))
