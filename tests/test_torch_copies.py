"""The port's own copies of the JAX package's host modules give the same
outputs as their sources.

The port imports nothing of the JAX package, so it carries copies of
``utils.config``, ``utils.lut`` (with its data file), ``utils.timeparse``,
``utils.wavio``, ``utils.native`` (with its C++ source), ``models.metadata``
and ``ops.wire``'s encoders.  Each case feeds both the same input and asks
for equal results: arrays bitwise, dataclasses field by field, wire bytes
with the C library and with ``AXCTD_NO_NATIVE=1`` (the numpy encoders).
"""

import copy
import dataclasses

import numpy as np
import pytest
from scipy.io import wavfile

from axctdprocessor_tpu.models import metadata as jmd
from axctdprocessor_tpu.ops import wire as jwire
from axctdprocessor_tpu.utils import config as jconfig
from axctdprocessor_tpu.utils import lut as jlut
from axctdprocessor_tpu.utils import timeparse as jtimeparse
from axctdprocessor_tpu.utils import wavio as jwavio
from axctdprocessor_tpu_torch.models import metadata
from axctdprocessor_tpu_torch.ops import wire
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
