"""The port's own copies of the JAX package's host modules give the same
outputs as their sources.

The port imports nothing of the JAX package, so it carries copies of
``utils.config``, ``utils.lut`` (with its data file), ``utils.timeparse``,
``utils.wavio``, ``utils.native`` (with its C++ source), ``models.metadata``,
``ops.wire``'s encoders, the host parity engine's ``models.demod`` and
``models.frames``, and the host-only helpers of the mesh paths
(``batch.pad_to_multiple``, ``timeshard.pad_for_mesh``,
``multihost.partition_corpus``).  Each case feeds both the same input and asks
for equal results: arrays bitwise, dataclasses field by field, wire bytes
with the C library and with ``AXCTD_NO_NATIVE=1`` (the numpy encoders).
"""

import copy
import dataclasses
import os

import numpy as np
import pytest
from scipy.io import wavfile

from axctdprocessor_tpu.models import demod as jdemod
from axctdprocessor_tpu.models import frames as jframes
from axctdprocessor_tpu.models import metadata as jmd
from axctdprocessor_tpu.ops import crc as jcrc
from axctdprocessor_tpu.ops import wire as jwire
from axctdprocessor_tpu.parallel import batch as jbatch
from axctdprocessor_tpu.parallel import multihost as jmultihost
from axctdprocessor_tpu.parallel import timeshard as jtimeshard
from axctdprocessor_tpu.utils import config as jconfig
from axctdprocessor_tpu.utils import lut as jlut
from axctdprocessor_tpu.utils import timeparse as jtimeparse
from axctdprocessor_tpu.utils import native as jnative
from axctdprocessor_tpu.utils import wavio as jwavio
from axctdprocessor_tpu_torch.models import demod, frames, metadata, simulator
from axctdprocessor_tpu_torch.ops import crc, wire
from axctdprocessor_tpu_torch.parallel import batch, multihost, timeshard
from axctdprocessor_tpu_torch.utils import config, lut, native, timeparse, wavio


def test_temp_lut_equals_source():
    ours = lut.load_temp_lut()
    np.testing.assert_array_equal(ours, jlut.load_temp_lut())
    assert ours.dtype == np.float64 and ours.shape == (lut.LUT_SIZE,)


REFERENCE_STYLE = {  # CLI-cased keys (inert under "strict") beside engine keys
    "minR400": 3.0, "mindR7500": 1.2, "use_bandpass": True, "pointsperloop": 88200,
    "deadfreq": 2800, "mark_space_freqs": [400, 800], "triggerrange": [12, 400],
    "refreshrate": 1.0, "minr400": 2.5,
}


@pytest.mark.parametrize("compat", ["strict", "fixed"])
@pytest.mark.parametrize("settings", [None, REFERENCE_STYLE], ids=["defaults", "reference"])
def test_resolve_settings_equals_source(settings, compat):
    ours = config.resolve_settings(copy.deepcopy(settings), compat=compat)
    ref = jconfig.resolve_settings(copy.deepcopy(settings), compat=compat)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (ours.min_r400_inprof, ours.min_dr7500_inprof) == (
        ref.min_r400_inprof, ref.min_dr7500_inprof)


@pytest.mark.parametrize("text", ["12", "1:30", "01:02:03", "1:2:3:4", "abc", "", "-5",
                                  "10:xx"])
def test_parse_time_string_equals_source(text):
    assert timeparse.parse_time_string(text) == jtimeparse.parse_time_string(text)


def _header(rng):
    h = {"frame_data": [f"{v:03x}" for v in rng.integers(0, 4096, 16)],
         "counter_found": [bool(v) for v in rng.integers(0, 2, 16)]}
    for name in ("t", "c", "z"):
        h[f"{name}coeff"] = [float(v) for v in rng.standard_normal(4)]
        h[f"{name}coeff_valid"] = [bool(v) for v in rng.integers(0, 2, 4)]
        h[f"{name}coeff_hex"] = [f"{v:09x}" for v in rng.integers(0, 2 ** 32, 4)]
    for key in ("serial_no", "probe_code", "max_depth", "misc"):
        h[key] = None if rng.integers(0, 3) == 0 else f"{int(rng.integers(0, 99999)):05d}"
    return h


def test_new_metadata_equals_source():
    assert metadata.new_metadata() == jmd.new_metadata()
    assert (metadata.COEFF_NAMES, metadata.SCALAR_FIELDS) == (jmd.COEFF_NAMES,
                                                              jmd.SCALAR_FIELDS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_headers_equals_source(seed):
    rng = np.random.default_rng(seed)
    h2, h3 = _header(rng), _header(rng)
    if seed == 2:  # every tcoeff valid: the live coefficients are adopted
        h3["tcoeff_valid"] = [True] * 4
        h2 = None
    live0 = {"tcoeff": [0.0, 1.0, 0.0, 0.0], "ccoeff": [0.0, 1.0, 0.0, 0.0],
             "zcoeff": [1.0, 1.0, 1.0, 1.0]}
    ours, ref = metadata.new_metadata(), jmd.new_metadata()
    live_ours, live_ref = copy.deepcopy(live0), copy.deepcopy(live0)
    metadata.merge_headers(ours, copy.deepcopy(h2), copy.deepcopy(h3), live_ours)
    jmd.merge_headers(ref, copy.deepcopy(h2), copy.deepcopy(h3), live_ref)
    assert ours == ref
    assert live_ours == live_ref


@pytest.fixture(scope="module")
def pcm16():
    rng = np.random.default_rng(3)
    t = np.arange(44100 * 3 + 1) / 44100  # odd length: a padded int4 nibble
    x = 9000 * np.sin(2 * np.pi * 400 * t) + 2000 * rng.standard_normal(len(t))
    x[5] = -32768  # the int16 minimum, where np.abs would wrap
    return np.clip(np.round(x), -32768, 32767).astype(np.int16)


@pytest.fixture(params=["c_library", "numpy"])
def encoder(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setenv("AXCTD_NO_NATIVE", "1")
    elif native.get_library() is None:
        pytest.skip("no C++ compiler for the native library")
    return request.param


@pytest.mark.parametrize("wire_name", ["int16", "int8", "int4"])
def test_wire_encode_equals_source(pcm16, encoder, wire_name):
    ours = wire.encode(pcm16, wire_name)
    ref = jwire.encode(pcm16, wire_name)
    assert ours.dtype == ref.dtype and ours.tobytes() == ref.tobytes()
    rows = np.stack([pcm16, (pcm16 // 3).astype(np.int16)])
    ours, ref = wire.encode_rows(rows, wire_name), jwire.encode_rows(rows, wire_name)
    assert ours.dtype == ref.dtype and ours.tobytes() == ref.tobytes()


def test_int4_statistics_equal_source(pcm16, encoder):
    packed, dc, peak = wire.quantize_int4_packed_stats(pcm16)
    jpacked, jdc, jpeak = jwire.quantize_int4_packed_stats(pcm16)
    assert packed.tobytes() == jpacked.tobytes() and (dc, peak) == (jdc, jpeak)
    assert wire.int4_stats(packed, len(pcm16)) == jwire.int4_stats(jpacked, len(pcm16))


def test_chunked_int4_encoder_equals_source(pcm16):
    ours, ref = wire.chunked_int4_encoder(pcm16), jwire.chunked_int4_encoder(pcm16)
    if ours is None or ref is None:
        pytest.skip("no C++ compiler for the native library")
    for upto in (1000, 77777, len(pcm16)):
        ours.ensure(upto)
        ref.ensure(upto)
    assert ours.packed.tobytes() == ref.packed.tobytes()
    assert (ours.dc, ours.peak) == (ref.dc, ref.peak)


def test_wire_encode_takes_a_resolved_wire(pcm16):
    with pytest.raises(ValueError, match="wire"):
        wire.encode(pcm16, "auto")
    f = pcm16.astype(np.float32)
    assert wire.encode(f, "int8") is not None and wire.encode(f, "int8").dtype == np.float32


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    rng = np.random.default_rng(4)
    d = tmp_path_factory.mktemp("wavs")
    out = {}
    for name, fs, data in [
        ("int16_44k", 44100, (rng.standard_normal(44100 * 2) * 8000).astype(np.int16)),
        ("int16_88k", 88200, (rng.standard_normal(88200 * 2) * 8000).astype(np.int16)),
        ("float32_44k", 44100, (rng.standard_normal(44100 * 2) * 0.3).astype(np.float32)),
    ]:
        path = str(d / f"{name}.wav")
        wavfile.write(path, fs, data)
        out[name] = path
    return out


@pytest.mark.parametrize("timerange", [(0, -1), (0.5, 1.5)])
@pytest.mark.parametrize("name", ["int16_44k", "int16_88k", "float32_44k"])
def test_read_wav_equals_source(wavs, name, timerange):
    pcm, fs = wavio.read_wav(wavs[name], timerange)
    jpcm, jfs = jwavio.read_wav(wavs[name], timerange)
    assert fs == jfs and type(fs) is type(jfs)
    np.testing.assert_array_equal(pcm, jpcm)


@pytest.mark.parametrize("allow_highrate", [False, True])
@pytest.mark.parametrize("name", ["int16_44k", "int16_88k", "float32_44k"])
def test_read_wav_raw16_equals_source(wavs, name, allow_highrate):
    ours = wavio.read_wav_raw16(wavs[name], (0, -1), allow_highrate=allow_highrate)
    ref = jwavio.read_wav_raw16(wavs[name], (0, -1), allow_highrate=allow_highrate)
    assert (ours is None) == (ref is None)
    if ref is not None:
        assert ours[1] == ref[1]
        np.testing.assert_array_equal(ours[0], ref[0])


def test_wav_info_equals_source(wavs, encoder):
    """``wav_info`` with the C library (the source's answer) and without
    (None from both: the archive runner then asks scipy)."""
    for name, path in wavs.items():
        ours, ref = native.wav_info(path), jnative.wav_info(path)
        assert ours == ref, name
        assert (ours is None) == (encoder == "numpy")
    assert native.wav_info(wavs["int16_44k"] + ".missing") is None


@pytest.mark.parametrize("name", ["int16_44k", "int16_88k", "float32_44k"])
def test_read_wav_conditioned_f32_equals_source(wavs, encoder, name):
    ours = native.read_wav_conditioned_f32(wavs[name])
    ref = jnative.read_wav_conditioned_f32(wavs[name])
    assert (ours is None) == (ref is None)
    if encoder == "numpy" or name == "int16_88k":  # no library; or the decimation path
        assert ours is None
    if ours is not None:
        assert ours[1] == ref[1] and ours[0].dtype == np.float32
        np.testing.assert_array_equal(ours[0], ref[0])


@pytest.fixture(scope="module")
def chunk():
    """Two seconds of a simulated drop's header transmission, conditioned."""
    pcm, _ = simulator.synthesize(simulator.SimSpec(duration=20.0, seed=4))
    x = (pcm - np.mean(pcm)) / np.max(np.abs(pcm))
    return x[int(11.0 * 44100): int(13.0 * 44100)]


@pytest.mark.parametrize("use_bandpass", [False, True])
def test_demodulate_chunk_equals_source(chunk, use_bandpass):
    fs, npcm = 44100, 51
    np.testing.assert_array_equal(demod.design_filter(fs, use_bandpass),
                                  jdemod.design_filter(fs, use_bandpass))
    trig, jtrig = (m.make_bit_trig(fs, 400.0, 800.0, npcm) for m in (demod, jdemod))
    for a, b in zip(trig, jtrig):
        np.testing.assert_array_equal(a, b)
    sos = demod.design_filter(fs, use_bandpass)
    ours = demod.demodulate_chunk(chunk, fs, 100, sos, 800.0, trig, npcm, 2, 1.5)
    ref = jdemod.demodulate_chunk(chunk, fs, 100, sos, 800.0, jtrig, npcm, 2, 1.5)
    assert ours.bits == ref.bits and len(ours.bits) > 1000
    assert ours.conf == ref.conf  # float64, same accumulation order
    assert list(ours.bit_edges) == list(ref.bit_edges)
    assert ours.next_start == ref.next_start


@pytest.mark.parametrize("seed", [0, 1])
def test_calibrate_scale_factor_equals_source(seed):
    rng = np.random.default_rng(seed)
    confs = np.concatenate([rng.normal(0.4, 0.1, 400), rng.normal(1.9, 0.3, 400)])
    rng.shuffle(confs)
    assert demod.calibrate_scale_factor(list(confs), 1.5) == \
        jdemod.calibrate_scale_factor(list(confs), 1.5)


@pytest.fixture(scope="module")
def header_bits():
    """A header capture window as the parity engine cuts it: the 400 Hz
    pulse's run of ones, then the 72 header frames twice, a few bits wrong."""
    _, truth = simulator.synthesize(simulator.SimSpec(duration=20.0, seed=4))
    frames_bits = np.asarray(truth["header_frames"]).reshape(-1)
    rng = np.random.default_rng(5)
    bits = np.concatenate([np.ones(500, np.int64), frames_bits, frames_bits,
                           rng.integers(0, 2, 300)])
    bits[rng.integers(600, len(bits), 6)] ^= 1
    return bits


def test_trim_and_parse_header_equal_source(header_bits):
    ours, ref = frames.trim_header(header_bits), jframes.trim_header(header_bits)
    np.testing.assert_array_equal(ours, ref)
    assert len(ours) == 32 * 75
    got, want = frames.parse_header(ours), jframes.parse_header(ref)
    assert got == want
    assert got["serial_no"] == "00123456" and all(got["tcoeff_valid"])
    short = header_bits[:450]  # no end of pulse inside the window
    np.testing.assert_array_equal(frames.trim_header(short), jframes.trim_header(short))


@pytest.mark.parametrize("n", [20, 33, 5000])
def test_sync_profile_frames_and_crc_windows_equal_source(n):
    rng = np.random.default_rng(n)
    _, truth = simulator.synthesize(simulator.SimSpec(duration=20.0, seed=4))
    hdr = np.asarray(truth["header_frames"]).reshape(-1)
    bits = np.concatenate([rng.integers(0, 2, 7), hdr, rng.integers(0, 2, 40), hdr])[:n]
    r7500 = rng.standard_normal(len(bits))
    np.testing.assert_array_equal(crc.check_crc_all_windows_np(bits),
                                  jcrc.check_crc_all_windows_np(bits))
    (starts, used), (jstarts, jused) = (m.sync_profile_frames(bits, r7500)
                                        for m in (frames, jframes))
    np.testing.assert_array_equal(starts, jstarts)
    assert used == jused
    if n == 5000:
        assert len(starts) > 50


@pytest.mark.parametrize("b,m", [(3, 2), (4, 2), (1, 4), (5, 8), (6, 3)])
def test_pad_to_multiple_equals_source(b, m):
    rng = np.random.default_rng(b * 10 + m)
    rows = (rng.standard_normal((b, 37)) * 1000).astype(np.int16)
    lengths = rng.integers(1, 37, b).astype(np.int32)
    (got, got_len), got_b = batch.pad_to_multiple([rows, lengths], m)
    (want, want_len), want_b = jbatch.pad_to_multiple([rows, lengths], m)
    assert got_b == want_b == b and len(got) % m == 0
    assert got.dtype == want.dtype and got_len.dtype == want_len.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_len, want_len)
    if b % m:  # the padding repeats row 0
        np.testing.assert_array_equal(got[b:], np.repeat(rows[:1], len(got) - b, axis=0))


@pytest.mark.parametrize("fs,n,n_sp,dtype", [
    (44100.0, 1852200, 4, np.float32), (44100.0, 1852201, 4, np.int16),
    (44100.0, 1764 * 8, 8, np.int16), (16000.0, 672000, 8, np.float32),
    (22050.0, 100001, 2, np.int32), (44100.0, 5000, 1, np.float32),
])
def test_pad_for_mesh_equals_source(fs, n, n_sp, dtype):
    rng = np.random.default_rng(n % 1000)
    rows = (rng.standard_normal((2, n)) * 100).astype(dtype)
    got, want = timeshard.pad_for_mesh(rows, fs, n_sp), jtimeshard.pad_for_mesh(rows, fs, n_sp)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] % (n_sp * int(round(fs / 25))) == 0 and got.shape[1] >= n
    assert (got is rows) == (want is rows)  # nothing to pad: the input itself


@pytest.mark.parametrize("count", [1, 2, 3, 5])
def test_partition_corpus_equals_source(tmp_path, count):
    """Files of different sizes, one missing (size 0): each host's slice is
    the source's, and the slices are disjoint and cover the list."""
    rng = np.random.default_rng(count)
    paths = []
    for i, size in enumerate(rng.integers(1, 5000, 11)):
        paths.append(str(tmp_path / f"drop{i:02d}.wav"))
        open(paths[-1], "wb").write(bytes(int(size)))
    paths.append(str(tmp_path / "missing.wav"))
    rng.shuffle(paths)
    slices = [multihost.partition_corpus(paths, k, count) for k in range(count)]
    for k in range(count):
        assert slices[k] == jmultihost.partition_corpus(paths, k, count)
    flat = [p for sl in slices for p in sl]
    assert sorted(flat) == sorted(paths) and len(set(flat)) == len(paths)
    if count > 1:
        sizes = [sum(os.path.getsize(p) for p in sl if os.path.exists(p)) for sl in slices]
        assert max(sizes) - min(sizes) <= 5000  # balanced to within one file
