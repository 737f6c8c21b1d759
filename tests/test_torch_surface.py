"""The rest of the JAX package's op surface in the port, on the CPU.

Functions no decode path calls, which the JAX package's own tests exercise:
the time-domain and FFT forms of the SOS cascade, the gather form of the
tone powers, the scatter-free compaction, the header coefficient decode,
the device bit and salinity helpers, the host form of the trigger, the
parameter tables of one call, the unshaped int4 encoder and the profiler
hook.  The same numpy inputs, made from a seed, go through the JAX function
and its port: integers bit-equal, floats to the tolerance the JAX package's
own test of that function uses (named at each test).  JAX runs in x64 here
(tests/conftest.py), so float64 inputs stay float64 on both sides.
"""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy import signal as sg

from axctdprocessor_tpu.models import frames as jframes
from axctdprocessor_tpu.models import simulator as jsim
from axctdprocessor_tpu.models import tpu_engine as jeng
from axctdprocessor_tpu.ops import bits as jbits
from axctdprocessor_tpu.ops import chain as jchain
from axctdprocessor_tpu.ops import crc as jcrc
from axctdprocessor_tpu.ops import goertzel as jgoertzel
from axctdprocessor_tpu.ops import header_device as jhdr
from axctdprocessor_tpu.ops import iir as jiir
from axctdprocessor_tpu.ops import seawater as jsea
from axctdprocessor_tpu.utils import native as jnative
from axctdprocessor_tpu.utils.config import DecoderConfig
from axctdprocessor_tpu_torch.models import engine
from axctdprocessor_tpu_torch.ops import bits, chain, crc, goertzel, header_device, iir, seawater
from axctdprocessor_tpu_torch.utils import native, profiling

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# ops/iir.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bandpass", [False, True], ids=["lowpass", "bandpass"])
def test_sosfilt_scan_matches_scipy_and_jax(bandpass):
    """tests/test_tpu_ops.py:11-19: rtol 1e-9, atol 1e-12 in float64."""
    x = np.random.default_rng(42).standard_normal(5000)
    sos = iir.design_sos(44100.0, use_bandpass=bandpass)
    got = iir.sosfilt_scan(sos, _t(x))
    assert got.dtype == torch.float64 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), sg.sosfilt(sos, x), rtol=1e-9, atol=1e-12)
    want = np.asarray(jiir.sosfilt_scan(sos, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("bandpass", [False, True], ids=["lowpass", "bandpass"])
def test_sosfilt_parallel_matches_scipy_and_jax(bandpass):
    """tests/test_tpu_ops.py:22-29: rtol 1e-7, atol 1e-10 in float64, the
    log-step scan against scipy's sequential recurrence."""
    x = np.random.default_rng(7).standard_normal(20000)
    sos = iir.design_sos(44100.0, use_bandpass=bandpass)
    got = iir.sosfilt(sos, _t(x)).numpy()
    np.testing.assert_allclose(got, sg.sosfilt(sos, x), rtol=1e-7, atol=1e-10)
    want = np.asarray(jiir.sosfilt(sos, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-10)


@pytest.mark.parametrize("n", [1, 2, 5, 1000])
def test_sosfilt_parallel_short_and_odd_lengths(n):
    x = np.random.default_rng(n).standard_normal(n)
    sos = iir.design_sos(44100.0)
    np.testing.assert_allclose(iir.sosfilt(sos, _t(x)).numpy(), sg.sosfilt(sos, x),
                               rtol=1e-7, atol=1e-10)


def test_affine_combine_equals_jax():
    rng = np.random.default_rng(5)
    left, right = rng.standard_normal((6, 40)), rng.standard_normal((6, 40))
    got = iir._affine_combine(tuple(_t(a) for a in left), tuple(_t(a) for a in right))
    want = jiir._affine_combine(tuple(jnp.asarray(a) for a in left),
                                tuple(jnp.asarray(a) for a in right))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-14, atol=0)


@pytest.mark.parametrize("bandpass", [False, True], ids=["lowpass", "bandpass"])
def test_sosfilt_fft_matches_scipy_steady_state_and_jax(bandpass):
    """tests/test_tpu_ops.py:165-172: beyond sample 3000, rtol 1e-6, atol
    1e-8 in float64 (the transient differs within the impulse response)."""
    x = np.random.default_rng(3).standard_normal(60000)
    sos = iir.design_sos(44100.0, use_bandpass=bandpass)
    got = iir.sosfilt_fft(sos, _t(x))
    assert got.dtype == torch.float64 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy()[3000:], sg.sosfilt(sos, x)[3000:],
                               rtol=1e-6, atol=1e-8)
    want = np.asarray(jiir.sosfilt_fft(sos, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-8)


def test_sosfilt_fft_is_the_decode_filter():
    """One FFT filter: on float32 it is ``engine.fft_filter``, bit for bit."""
    x = _t(np.random.default_rng(1).standard_normal(30000).astype(np.float32))
    sos = iir.design_sos(44100.0).astype(np.float32)
    nfft = iir.next_pow2(30000 + 4096)
    want = engine.fft_filter(x, _t(sos), nfft)[:30000]
    assert torch.equal(iir.sosfilt_fft(sos, x), want)


@pytest.mark.parametrize("nfft", [4096, 1 << 16])
def test_sos_freq_response_equals_jax(nfft):
    sos = iir.design_sos(44100.0, use_bandpass=True)
    got, want = iir.sos_freq_response(sos, nfft), jiir.sos_freq_response(sos, nfft)
    assert got.dtype == want.dtype == np.complex128
    np.testing.assert_array_equal(got, want)
    # the device's response in float64 is this one
    dev = engine.sos_response_on_device(_t(sos), nfft).numpy()
    np.testing.assert_allclose(dev, want, rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------------------
# ops/goertzel.py, ops/chain.py
# ---------------------------------------------------------------------------

def test_framed_tone_power_matches_tiled_and_jax():
    """tests/test_tpu_ops.py:153-162: the gather form against the tiled one
    on all but the last 2 windows, rtol = atol 1e-9 in float64."""
    fs = 44100.0
    x = np.random.default_rng(12345).standard_normal(int(fs * 2.3))
    window, stride = int(fs / 10), int(round(fs / 25))
    trig = goertzel.tone_matrix(window, [400.0, 7500.0, 3000.0], fs)
    a = goertzel.framed_tone_power(_t(x), window, stride, _t(trig)).numpy()
    b = goertzel.framed_tone_power_tiled(_t(x), window, stride, _t(trig)).numpy()
    assert a.shape == b.shape == (int(np.ceil((len(x) - window) / stride)), 3)
    np.testing.assert_allclose(a[:-2], b[:-2], rtol=1e-9, atol=1e-9)
    want = np.asarray(jgoertzel.framed_tone_power(jnp.asarray(x), window, stride, trig))
    np.testing.assert_allclose(a, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("case", ["sparse", "fifth", "dense", "overflowing", "ragged", "empty"])
def test_compact_indices_blocked_equals_compact_indices_and_jax(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    n = {"ragged": 4999, "empty": 700}.get(case, 4096)
    density = {"sparse": 0.01, "fifth": 0.2, "dense": 0.9, "overflowing": 0.5,
               "ragged": 0.3, "empty": 0.0}[case]
    mask = rng.random(n) < density
    size = 500 if case == "overflowing" else int(mask.sum()) + 37
    fill = 2 ** 30
    got, cnt = chain.compact_indices_blocked(_t(mask), size, fill)
    ref, ref_cnt = chain.compact_indices(_t(mask), size, fill)
    assert torch.equal(got, ref) and int(cnt) == int(ref_cnt) == int(mask.sum())
    want, want_cnt = jchain.compact_indices_blocked(jnp.asarray(mask), size, fill)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(cnt) == int(want_cnt)
    if case == "overflowing":
        assert int(cnt) > size and int(got[-1]) < fill


def test_block_compact_rows_equals_jax():
    m = np.random.default_rng(9).random((37, 128)) < 0.3
    lanes, counts = chain._block_compact_rows(_t(m))
    jl, jc = jchain._block_compact_rows(jnp.asarray(m))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    for r in range(m.shape[0]):  # beyond a row's count the lanes are garbage
        k = int(counts[r])
        np.testing.assert_array_equal(lanes[r, :k].numpy(), np.flatnonzero(m[r]))
        np.testing.assert_array_equal(lanes[r, :k].numpy(), np.asarray(jl)[r, :k])


# ---------------------------------------------------------------------------
# ops/header_device.py: decode_coefficients, merge_live_coeffs
# ---------------------------------------------------------------------------

CAP = 8192  # fixed device buffer size (tests/test_header_device.py)

COEFF_SETS = {
    "simulator_defaults": None,
    "signed_small": ((1.2345678e-2, 2.5, -3.1e-4, 7.77e-8),
                     (-0.5, 1.0203, 4.4e-5, -9.9e-9),
                     (0.25, 0.98765, -1.1e-6, 2.2e-10)),
}


def _header_window(frames72: np.ndarray):
    stream = np.concatenate([np.ones(1200, np.int64), frames72.ravel()])
    buf = np.zeros(CAP, np.int32)
    buf[: len(stream)] = stream
    return stream, buf, len(stream)


def _parsed_both(buf, n):
    found, frames, usable = header_device.parse_header_window(_t(buf), torch.tensor(n))
    jfound, jframes_, jusable = jhdr.parse_header_window(jnp.asarray(buf),
                                                         jnp.asarray(n, jnp.int32))
    assert bool(usable) and bool(jusable)
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jframes_))
    return (found, frames), (jfound, jframes_)


def _coefficients_equal_jax(ours, ref):
    """mant, exp, valid, crash bit-equal; values float32, equal to XLA's
    within 1 ulp (rtol 1.2e-7: ``10 ** exp`` is a pow on both sides, each
    library's own)."""
    values, valid, mant, exp, crash = header_device.decode_coefficients(*ours)
    jvalues, jvalid, jmant, jexp, jcrash = jhdr.decode_coefficients(*ref)
    assert values.dtype == torch.float32 and valid.dtype == torch.bool
    assert mant.dtype == exp.dtype == torch.int32 and values.shape == (3, 4)
    np.testing.assert_array_equal(mant.numpy(), np.asarray(jmant))
    np.testing.assert_array_equal(exp.numpy(), np.asarray(jexp))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert bool(crash) == bool(jcrash)
    np.testing.assert_allclose(values.numpy(), np.asarray(jvalues), rtol=1.2e-7, atol=0)
    return values, valid, mant, exp, crash


@pytest.mark.parametrize("name", list(COEFF_SETS))
def test_decode_coefficients_equals_jax_and_host(name):
    coeffs = COEFF_SETS[name]
    kw = {} if coeffs is None else dict(zcoeff=coeffs[0], tcoeff=coeffs[1], ccoeff=coeffs[2])
    stream, buf, n = _header_window(jsim.encode_header_frames(**kw))
    host = jframes.parse_header(jframes.trim_header(stream))
    values, valid, mant, exp, crash = _coefficients_equal_jax(*_parsed_both(buf, n))
    assert not bool(crash)
    for ci, key in enumerate(("z", "t", "c")):
        np.testing.assert_array_equal(valid[ci].numpy(), host[f"{key}coeff_valid"])
        for j in range(4):
            want = host[f"{key}coeff"][j]
            assert abs(float(values[ci, j]) - want) <= 1e-6 * max(abs(want), 1e-12)
            # the exact integers rebuild the host's float64 value bit for bit
            assert int(mant[ci, j]) / 1e7 * 10 ** int(exp[ci, j]) == want


def test_decode_coefficients_corrupt_marks_invalid_and_crash():
    """tests/test_header_device.py:98-117: hex digits in a decimal field."""
    hdr = jsim.encode_header_frames().copy()
    hdr[22] = jsim.encode_header_frame(22, "ffff")  # zcoeff[0]'s middle frame
    _, buf, n = _header_window(hdr)
    _, valid, _, _, crash = _coefficients_equal_jax(*_parsed_both(buf, n))
    assert not valid[0, 0] and valid[0, 1:].all() and valid[1:].all() and bool(crash)


def test_decode_coefficients_digit_in_sign_position():
    """tests/test_header_device.py:120-144: a plain digit where the sign
    nibble usually goes (9-digit mantissa, 3-digit exponent)."""
    hdr = jsim.encode_header_frames().copy()
    hdr[12] = jsim.encode_header_frame(12, "5123")
    hdr[13] = jsim.encode_header_frame(13, "4567")
    hdr[14] = jsim.encode_header_frame(14, "8b07")
    _, buf, n = _header_window(hdr)
    values, valid, mant, exp, crash = _coefficients_equal_jax(*_parsed_both(buf, n))
    expected = int("512345678") / 1e7 * 10 ** 7
    assert not bool(crash) and bool(valid[0, 3])
    assert int(mant[0, 3]) / 1e7 * 10 ** int(exp[0, 3]) == expected
    assert abs(float(values[0, 3]) - expected) < 1e-4 * expected


def test_decode_coefficients_missing_frames_are_not_a_crash():
    found = torch.zeros(72, dtype=torch.bool)
    frames = torch.full((72, 4), 15, dtype=torch.int64)  # unparseable, but not found
    _, valid, _, _, crash = _coefficients_equal_jax(
        (found, frames), (jnp.asarray(found.numpy()), jnp.asarray(frames.numpy())))
    assert not valid.any() and not bool(crash)


@pytest.mark.parametrize("case", ["all_valid_h3_wins", "t_incomplete_blocks_z",
                                  "z_leaks_initializer", "nothing_valid"])
def test_merge_live_coeffs_equals_jax(case):
    rng = np.random.default_rng(len(case))
    vals2, vals3 = (rng.standard_normal((3, 4)).astype(np.float32) for _ in range(2))
    defaults = rng.standard_normal((3, 4)).astype(np.float32)
    ok2, ok3 = np.ones((3, 4), bool), np.ones((3, 4), bool)
    if case == "t_incomplete_blocks_z":
        ok2[1, 2] = ok3[1, 2] = False
    elif case == "z_leaks_initializer":
        ok2[0, 1] = ok3[0, 1] = False
        ok3[2] = False
    elif case == "nothing_valid":
        ok2[:] = ok3[:] = False
    got = header_device.merge_live_coeffs(_t(vals2), _t(ok2), _t(vals3), _t(ok3), _t(defaults))
    want = jhdr.merge_live_coeffs(jnp.asarray(vals2), jnp.asarray(ok2), jnp.asarray(vals3),
                                  jnp.asarray(ok3), jnp.asarray(defaults))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if case == "all_valid_h3_wins":
        np.testing.assert_array_equal(got[1].numpy(), vals3[1])
    if case == "t_incomplete_blocks_z":  # zcoeff adoption is gated on tcoeff validity
        np.testing.assert_array_equal(got[0].numpy(), defaults[0])
    if case == "z_leaks_initializer":    # the never-decoded slot holds 1.0, not the default
        assert float(got[0][1]) == 1.0
        np.testing.assert_array_equal(got[2].numpy(), vals2[2])


# ---------------------------------------------------------------------------
# ops/bits.py, ops/crc.py, ops/seawater.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(12,), (50, 32), (3, 7, 8)])
def test_bits_to_int_equals_jax(shape):
    b = np.random.default_rng(len(shape)).integers(0, 2, shape)
    got = bits.bits_to_int(_t(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbits.bits_to_int(jnp.asarray(b))))
    if shape[-1] < 32:
        np.testing.assert_array_equal(got.numpy(), bits.bits_to_int_np(b))


def test_frames_to_nibbles_and_hex_equal_jax():
    frames = np.random.default_rng(4).integers(0, 2, (40, 32))
    got = bits.frames_to_nibbles(_t(frames))
    want = np.asarray(jbits.frames_to_nibbles(jnp.asarray(frames)))
    assert got.dtype == torch.int32 and got.shape == (40, 8)
    np.testing.assert_array_equal(got.numpy(), want)
    hexes = bits.nibbles_to_hex_np(got.numpy())
    assert hexes == jbits.nibbles_to_hex_np(want)
    assert hexes == [bits.bits_to_hex_np(f) for f in frames]


def test_check_crc_np_equals_jax():
    rng = np.random.default_rng(6)
    for trial in range(40):
        frame = crc.encode_crc_np(rng.integers(0, 2, 26).astype(np.uint8))
        if trial % 2:
            frame[rng.integers(0, 32)] ^= 1  # one flipped bit never passes
        assert crc.check_crc_np(frame) == jcrc.check_crc_np(frame) == (trial % 2 == 0)
        assert crc.check_crc_np(frame) == bool(crc.check_crc_all_windows(_t(frame))[0])
    with pytest.raises(ValueError, match="32 bits"):
        crc.check_crc_np(np.zeros(31, np.uint8))


def test_sp_from_c_equals_numpy_and_jax():
    """tests/test_seawater.py:36-42: float64, equal to ``sp_from_c_np``
    (here rtol 1e-13: torch and numpy may round a sqrt or a fused multiply
    differently), the Hill branch and the invalid marks included."""
    rng = np.random.default_rng(2)
    c = rng.uniform(0.05, 60.0, size=256)
    c[:8] = rng.uniform(0.05, 2.5, size=8)   # SP < 2: the Hill et al. branch
    c[8] = -1.0                               # invalid
    c[9] = np.nan
    t = rng.uniform(-2.0, 32.0, size=256)
    p = rng.uniform(0.0, 2000.0, size=256)
    got = seawater.sp_from_c(_t(c), _t(t), _t(p))
    assert got.dtype == torch.float64
    want = seawater.sp_from_c_np(c, t, p)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=0)
    assert got[8] == seawater.GSW_INVALID_VALUE and torch.isnan(got[9])
    jwant = np.asarray(jsea.sp_from_c(jnp.float64(c), jnp.float64(t), jnp.float64(p)))
    np.testing.assert_allclose(got.numpy(), jwant, rtol=1e-13, atol=0)
    # float32 in, float32 out, at float32's precision
    got32 = seawater.sp_from_c(_t(c.astype(np.float32)), _t(t.astype(np.float32)),
                               _t(p.astype(np.float32)))
    assert got32.dtype == torch.float32
    fin = np.isfinite(want) & (want < 1e15)
    np.testing.assert_allclose(got32.numpy()[fin], want[fin], rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# models/engine.py: trigger_scalars, qc_limits, fused_inputs
# ---------------------------------------------------------------------------

def _trigger_case(trial: int, rng):
    n_win = int(rng.integers(30, 500))
    r400 = rng.normal(1.2, 0.9, n_win).astype(np.float32)
    r7500 = rng.normal(0.8, 1.0, n_win).astype(np.float32)
    if trial % 4 == 0:
        r400 -= 10.0  # no pulse at all
    if trial % 3 == 0:
        r7500[:] = np.nan  # no usable baseline -> the timeout path
    cfg = DecoderConfig(
        trigger_range=(float(rng.integers(0, 12)), float(rng.choice([-1.0, 3.0, 7.5]))),
        compat="fixed" if trial % 2 else "strict")
    return r400, r7500, cfg


@pytest.mark.parametrize("trial", range(12))
def test_trigger_scalars_equals_jax_and_trigger_core(trial):
    """tests/test_tpu_engine.py:219-255: the host form against the device
    form over random series and configs; the mean within 1e-5."""
    fs = 44100.0
    d_pcm, n_power = int(round(fs / 25)), int(fs / 10)
    r400, r7500, cfg = _trigger_case(trial, np.random.default_rng(100 + trial))
    n = n_power + d_pcm * len(r400)  # exactly len(r400) real windows
    args = (r400.astype(np.float64), r7500.astype(np.float64), cfg, fs, d_pcm)
    host = engine.trigger_scalars(*args, n_valid=n)
    want = jeng.trigger_scalars(*args, n_valid=n)
    assert host[0] == want[0] and host[2] == want[2]
    np.testing.assert_array_equal(host[1], want[1])  # NaN where there is no baseline
    dims = engine.EngineDims.for_waveform(n, fs, 800, 39)
    trig_i, trig_f = engine.trigger_tables(cfg, fs)
    fp, mean, prof = engine.trigger_core(_t(r400), _t(r7500), torch.tensor(n), _t(trig_i),
                                         _t(trig_f), dims, fs)
    assert int(fp) == host[0] and int(prof) == host[2]
    if np.isnan(host[1]):
        assert np.isnan(float(mean))
    else:
        assert abs(float(mean) - host[1]) < 1e-5


def test_trigger_scalars_on_the_default_drop(default_drop):
    """The host trigger over the port's own tone ratios of the default drop
    finds the pulse and the profile start that the fused decode reports."""
    pcm, truth = default_drop
    fs = float(truth["spec"].fs)
    cfg = DecoderConfig()
    x = ((pcm - pcm.mean()) / np.abs(pcm).max()).astype(np.float32)
    res = engine.decode_waveform(x, fs, device="cpu", mode="monolithic")
    from axctdprocessor_tpu_torch.ops import tonepower

    n_power, d_pcm = int(fs / 10), int(round(fs / 25))
    tm = _t(goertzel.tone_matrix(n_power, [400.0, 7500.0, cfg.dead_freq], fs, dtype=np.float32))
    r400, r7500 = tonepower.tone_ratios_reference(_t(x), tm, n_power, d_pcm)
    args = (r400.numpy().astype(np.float64), r7500.numpy().astype(np.float64), cfg, fs, d_pcm)
    fp, mean, prof = engine.trigger_scalars(*args, n_valid=len(x))
    assert (fp, prof) == (res.firstpulse400, res.profstartind) and prof > fp > 0
    assert engine.trigger_scalars(*args, n_valid=len(x)) == jeng.trigger_scalars(
        *args, n_valid=len(x))
    assert np.isfinite(mean)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_qc_limits_equals_jax(dtype):
    cfg = DecoderConfig(tlims=(-3.0, 36.5), slims=(0.5, 41.0))
    got, want = engine.qc_limits(cfg, dtype), jeng.qc_limits(cfg, dtype)
    assert got.dtype == want.dtype == dtype and got.shape == (6,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fs,cfg", [
    (44100.0, DecoderConfig()),
    (16000.0, DecoderConfig(trigger_range=(5, 14), compat="fixed", min_r400=2.5)),
])
def test_fused_inputs_equals_jax(fs, cfg):
    got, want = engine.fused_inputs(cfg, fs), jeng.fused_inputs(cfg, fs)
    assert list(got) == list(want)
    for name, w in want.items():
        w = np.asarray(w)
        assert got[name].device.type == "cpu"
        assert got[name].numpy().dtype == w.dtype and got[name].shape == w.shape, name
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)
    dims = engine.EngineDims.for_waveform(int(fs * 30), fs, cfg.bitrate,
                                          engine.probe_window(cfg, fs))
    tables = engine.engine_tables(cfg, fs, dims)
    for name in ("trig_i", "trig_f", "hdr_rel", "calib_off"):  # the registered buffers
        np.testing.assert_array_equal(got[name].numpy(), tables[name])


# ---------------------------------------------------------------------------
# utils/native.py, utils/profiling.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [44100, 44101])
def test_quantize_int4_native_equals_jax_and_numpy(n, monkeypatch):
    if native.get_library() is None:
        pytest.skip("no C++ compiler for the native library")
    from axctdprocessor_tpu_torch.ops import wire

    rng = np.random.default_rng(n)
    x = np.clip(9000 * np.sin(np.arange(n) / 17.0) + 2000 * rng.standard_normal(n),
                -32768, 32767).astype(np.int16)
    got = native.quantize_int4_native(x)
    assert got.dtype == np.uint8 and got.shape == ((n + 1) // 2,)
    assert got.tobytes() == jnative.quantize_int4_native(x).tobytes()
    assert native.quantize_int4_native(x.astype(np.int32)) is None
    # the unshaped rounding is the numpy encoder's
    monkeypatch.setenv("AXCTD_NO_NATIVE", "1")
    assert got.tobytes() == wire.quantize_int4_packed(x).tobytes()


def test_device_trace_writes_a_chrome_trace_and_is_a_noop_on_none(tmp_path):
    with profiling.device_trace(None):
        y = torch.arange(8).sum()
    assert int(y) == 28 and not list(tmp_path.iterdir())
    trace_dir = tmp_path / "trace"
    with profiling.device_trace(str(trace_dir)):
        torch.fft.rfft(torch.ones(1024)).abs().sum().item()
    trace = json.loads((trace_dir / "trace.json").read_text())
    assert any("fft" in e.get("name", "") for e in trace["traceEvents"])
