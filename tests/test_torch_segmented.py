"""The port's segmented engine against the JAX package's, on the CPU.

* geometry and bucket sizes equal JAX's;
* one haloed segment of the 130 s drop (JAX's ``drop130``) through JAX's
  segment program and the port's ``SegmentedDecoder.segment``: tone powers
  and probe ratios within rtol = atol = 2e-4, crossing positions, counts
  and overflow flags exact;
* the JAX segment outputs through both assembles: packed vectors equal
  element for element;
* the whole segmented decode, float and int16 input: status, metadata,
  trigger indices, hexframes and report bytes equal JAX's;
* the port against itself: group sizes, zero-segment padding, prestaged
  (both forms), no pulse, the 88.2 kHz valid lengths, and ``"auto"``
  routing in ``engine.decode_waveform``;
* marked slow: the 88.2 kHz and int4-wire decodes against JAX.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from axctdprocessor_tpu.models import segmented as jseg
from axctdprocessor_tpu.models import tpu_engine as jeng
from axctdprocessor_tpu.utils import report as jreport
from axctdprocessor_tpu.utils.config import DecoderConfig, resolve_settings
from axctdprocessor_tpu_torch.models import engine, segmented, simulator
from axctdprocessor_tpu_torch.utils import report
from torch_packed import assert_packed_close

torch.set_num_threads(2)

FS = 44100.0
SETTINGS = {"triggerrange": [30, -1], "minR400": 2.0, "mindR7500": 1.5,
            "deadfreq": 3000.0, "pointsperloop": 100000,
            "mark_space_freqs": [400.0, 800.0], "use_bandpass": False}


@pytest.fixture(scope="module")
def drop130():
    """A 130 s drop: 6 segments of 23.56 s (JAX's tests/test_segmented.py
    fixture)."""
    spec = simulator.SimSpec(duration=130.0, profile_start=33.0, seed=91)
    return simulator.synthesize(spec)


def _conditioned(pcm):
    return ((pcm - np.mean(pcm)) / np.max(np.abs(pcm))).astype(np.float32)


def _int16(pcm):
    return np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)


@pytest.mark.parametrize("fs", [16000.0, 22050.0, 44100.0, 48000.0])
def test_seg_geometry_equals_jax(fs):
    assert segmented._seg_geometry(fs) == jseg._seg_geometry(fs)


def test_bucket_count_equals_jax():
    ks = range(1, 65)
    assert [segmented._bucket_count(k) for k in ks] == [jseg._bucket_count(k) for k in ks]


def _jax_segment_args(cfg, fs, model, pcm, integer):
    """The inputs JAX's segment program and the port's module get: host
    statistics as the segmented decode takes them, and the tables."""
    if integer:
        dc = float(np.mean(pcm))
        peak = float(max(int(pcm.max()), -int(pcm.min()), 1))
    else:
        dc, peak = 0.0, 1.0
    dims = jeng.EngineDims.for_waveform(model.seg_len, fs, cfg.bitrate, model.npcm)
    ptrig, btrig, sos = jeng.engine_tables(cfg, fs, dims)
    tables = tuple(jnp.asarray(a, jnp.float32) for a in (ptrig, sos, btrig))
    return np.float32(dc), np.float32(peak), tables


def _ext(pcm, k, model):
    lo = k * model.seg_len - segmented.LEFT_HALO
    ext = np.zeros(model.ext_len, pcm.dtype)
    s_lo, s_hi = max(lo, 0), min(lo + model.ext_len, len(pcm))
    ext[s_lo - lo: s_hi - lo] = pcm[s_lo:s_hi]
    return ext


def _jax_segments(cfg, model, pcm, integer):
    """Every segment of `pcm` through JAX's one-segment program (numpy)."""
    dc, peak, tables = _jax_segment_args(cfg, FS, model, pcm, integer)
    prog = jseg._segment_program(FS, model.npcm, cfg.bit_inset, 100, integer)
    n_seg = -(-len(pcm) // model.seg_len)
    return [tuple(np.asarray(o) for o in prog(
        jnp.asarray(_ext(pcm, k, model)), jnp.asarray(dc), jnp.asarray(peak),
        jnp.asarray(k * model.seg_len, jnp.int32), jnp.asarray(len(pcm), jnp.int32),
        *tables, jnp.zeros((1, 6), jnp.float32))) for k in range(n_seg)]


@pytest.fixture(scope="module")
def jax_segment_outputs(drop130):
    cfg = DecoderConfig()
    model = segmented.SegmentedDecoder.from_config(cfg, FS, False, "cpu")
    pcm, _ = drop130
    return {integer: _jax_segments(cfg, model, _int16(pcm) if integer else _conditioned(pcm),
                                   integer)
            for integer in (False, True)}


def _jax_filtered(model, ext, dc, peak, k_off, n_valid, sos):
    """The conditioned and filtered extension exactly as JAX's segment body
    computes them (models/segmented.py:109-130, no decimation)."""
    def run(ext, dc, peak, k_off, n_valid, sos):
        x = ext.astype(jnp.float32)
        gpos_raw = jnp.arange(model.in_len) + (k_off - segmented.LEFT_HALO)
        x = jnp.where((gpos_raw >= 0) & (gpos_raw < n_valid), (x - dc) / peak, 0.0)
        spec = jnp.fft.rfft(x, model.nfft) * jeng.sos_response_on_device(sos, model.nfft)
        return x, jnp.fft.irfft(spec, model.nfft)[: model.ext_len].astype(jnp.float32)

    out = jax.jit(run)(jnp.asarray(ext), jnp.asarray(dc), jnp.asarray(peak),
                       jnp.asarray(k_off, jnp.int32), jnp.asarray(n_valid, jnp.int32),
                       sos)
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("k", [0, 2, 5])
def test_segment_body_equals_jax(drop130, jax_segment_outputs, integer, k):
    """Segment 0 starts in the left halo's zeros (edge_pad), 2 is interior,
    5 ends in the file's tail (valid-length masks).

    Given JAX's filtered array, the port's crossings, counts and flags are
    JAX's exactly.  Its own FFT (pocketfft, not XLA's) rounds otherwise:
    the crossings it moves (under 0.5%, most in the quiet start before the
    pulse) sit on samples within 1e-5 of zero."""
    pcm, _ = drop130
    pcm = _int16(pcm) if integer else _conditioned(pcm)
    cfg = DecoderConfig()
    model = segmented.SegmentedDecoder.from_config(cfg, FS, False, "cpu")
    dc, peak, (_, sos, _) = _jax_segment_args(cfg, FS, model, pcm, integer)
    powers, gpos, c0, cnt, rovf = jax_segment_outputs[integer][k]
    ext, k_off = _ext(pcm, k, model), k * model.seg_len
    x_j, filt_j = _jax_filtered(model, ext, dc, peak, k_off, len(pcm), sos)
    with torch.inference_mode():
        x, filt = model.filter_segment(torch.from_numpy(ext), k_off, torch.tensor(dc),
                                       torch.tensor(peak), len(pcm))
        same = model.probe_segment(torch.from_numpy(x_j), torch.from_numpy(filt_j),
                                   k_off, len(pcm))
        own = model.probe_segment(x, filt, k_off, len(pcm))
    np.testing.assert_array_equal(x.numpy(), x_j)
    np.testing.assert_allclose(filt.numpy(), filt_j, rtol=0, atol=1e-5)

    g_powers, g_gpos, g_c0, g_cnt, g_rovf = (t.numpy() for t in same)
    np.testing.assert_allclose(g_powers, powers, rtol=2e-4, atol=2e-4)
    assert int(g_cnt) == int(cnt) > 1000
    assert int(g_rovf) == int(rovf) == 0
    np.testing.assert_array_equal(g_gpos, gpos.astype(np.int64))
    np.testing.assert_allclose(g_c0, c0, rtol=2e-4, atol=2e-4)

    moved = set(own[1].numpy().tolist()) ^ set(gpos.tolist())
    assert len(moved) <= int(cnt) // 200
    fbody = filt_j[segmented.LEFT_HALO:]
    for g in moved:
        i = g - k_off
        assert min(abs(fbody[i]), abs(fbody[i + 1])) < 1e-5, (g, fbody[i: i + 2])


@pytest.mark.parametrize("integer", [False, True])
def test_assemble_packed_vector_equal(drop130, jax_segment_outputs, integer):
    """Both assembles, given JAX's per-segment outputs of the whole drop:
    every integer field equal; the smoothed ratios as ``torch_packed``
    states (6 of 4,848 ratios move by one centi-unit here)."""
    pcm, _ = drop130
    outs = jax_segment_outputs[integer]
    cfg = DecoderConfig()
    model = segmented.SegmentedDecoder.from_config(cfg, FS, False, "cpu")
    dims = engine.EngineDims.for_waveform(len(outs) * model.seg_len, FS, cfg.bitrate,
                                          model.npcm)
    jdims = jeng.EngineDims.for_waveform(len(outs) * model.seg_len, FS, cfg.bitrate,
                                         model.npcm)
    fi = jeng.fused_inputs(cfg, FS)
    want = np.asarray(jseg._assemble_program(len(outs), jdims, FS, cfg.bitrate)(
        *[tuple(jnp.asarray(o[i]) for o in outs) for i in range(5)],
        jnp.asarray(len(pcm), jnp.int32), fi["trig_i"], fi["trig_f"], fi["hdr_rel"],
        fi["calib_off"], fi["coeff_defaults"], fi["temp_lut"], fi["limits"]))
    t_outs = [(torch.from_numpy(p.copy()), torch.from_numpy(g.astype(np.int64)),
               torch.from_numpy(c.copy()), torch.tensor(int(n)),
               torch.tensor(int(r), dtype=torch.int32)) for p, g, c, n, r in outs]
    with torch.inference_mode():
        got = model.assemble(t_outs, torch.tensor(len(pcm)), dims).numpy()
    assert_packed_close(got, want)
    res = engine.finish_result(got, 44100, len(pcm), FS, cfg)
    assert res.status == 2 and len(res.hexframes) > 1000


@pytest.fixture(scope="module")
def decoded(drop130):
    """The drop through both segmented engines: float and int16 input."""
    pcm, truth = drop130
    out = {}
    for kind, x in (("float", _conditioned(pcm)), ("int16", _int16(pcm))):
        out[kind] = (segmented.decode_waveform_segmented(x, 44100, device="cpu"),
                     jseg.decode_waveform_segmented(x, 44100, wire="int16"))
    return out, truth


@pytest.mark.parametrize("kind", ["float", "int16"])
def test_segmented_decode_equals_jax(decoded, kind):
    out, truth = decoded
    ours, ref = out[kind]
    assert ours.status == ref.status == 2
    assert ours.metadata == ref.metadata
    assert ours.metadata["serial_no"] == truth["serial_no"]
    assert ours.firstpulse400 == ref.firstpulse400 > 0
    assert ours.profstartind == ref.profstartind > 0
    assert ours.hexframes == ref.hexframes
    assert ours.overflow == ref.overflow == 0
    assert ours.wire == ref.wire


@pytest.mark.parametrize("kind", ["float", "int16"])
def test_segmented_report_identical(decoded, kind, tmp_path):
    """``write_report`` bytes are identical.  In the diagnostics table only
    the two tone-ratio columns may differ, by one centi-unit on a few rows
    (the smoothing form, ``torch_packed``)."""
    out, _ = decoded
    ours, ref = out[kind]
    cfg = resolve_settings(SETTINGS)
    paths = tmp_path / "torch.txt", tmp_path / "jax.txt"
    report.write_report(str(paths[0]), ours, "drop130.wav", [0, -1], SETTINGS, cfg)
    jreport.write_report(str(paths[1]), ref, "drop130.wav", [0, -1], SETTINGS, cfg)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert paths[0].read_text().count("\n") > 1000
    a = report.format_report(ours, "drop130.wav", [0, -1], SETTINGS, cfg, True).splitlines()
    b = jreport.format_report(ref, "drop130.wav", [0, -1], SETTINGS, cfg, True).splitlines()
    assert len(a) == len(b)
    moved = 0
    for la, lb in zip(a, b):
        if la != lb:
            ca, cb = la.split(","), lb.split(",")
            assert ca[:-2] == cb[:-2]
            assert max(abs(float(u) - float(v)) for u, v in zip(ca[-2:], cb[-2:])) < 0.0101
            moved += 1
    assert moved <= 10


def test_segmented_int16_device_conditioning(drop130, decoded):
    """Raw int16 (host f64 DC/peak, device conditioning) decodes like the
    host-conditioned float input."""
    out, truth = decoded
    pcm, _ = drop130
    raw = _int16(pcm)
    cond = ((raw.astype(np.float64) - np.mean(raw)) / np.max(np.abs(raw))).astype(np.float32)
    res_f = segmented.decode_waveform_segmented(cond, 44100, device="cpu")
    res_i = out["int16"][0]
    assert res_i.status == 2 and res_i.metadata["serial_no"] == truth["serial_no"]
    assert res_i.hexframes == res_f.hexframes


@pytest.mark.parametrize("group", [1, 4, 6])  # 6 is the drop's segment count
def test_group_size_does_not_change_the_decode(drop130, decoded, group):
    pcm, _ = drop130
    base = decoded[0]["int16"][0]
    res = segmented.decode_waveform_segmented(_int16(pcm), 44100, device="cpu", group=group)
    assert res.metadata == base.metadata
    assert res.hexframes == base.hexframes
    assert res.time == base.time
    assert res.salinity == base.salinity


def test_zero_segment_padding_is_neutral(drop130, decoded, monkeypatch):
    """130 s = 6 real segments; force an 8-segment bucket."""
    pcm, _ = drop130
    base = decoded[0]["float"][0]
    monkeypatch.setattr(segmented, "_bucket_count", lambda k: k + 2)
    padded = segmented.decode_waveform_segmented(_conditioned(pcm), 44100, device="cpu")
    assert padded.status == base.status == 2
    assert padded.metadata == base.metadata
    assert padded.hexframes == base.hexframes
    assert padded.time == base.time


def test_prestaged_equals_segmented(drop130):
    pcm, _ = drop130
    raw = _int16(pcm)
    base = segmented.decode_waveform_segmented(raw, 44100, device="cpu", wire="int8")
    for fused in (False, True):
        st = segmented.prestage_waveform(raw, 44100, device="cpu", fused=fused, group=2)
        for res in [st.decode()] + [st.finish(o) for o in [st.dispatch(), st.dispatch()]]:
            assert res.status == base.status == 2
            assert res.wire == base.wire == "int8"
            assert res.metadata == base.metadata
            assert res.hexframes == base.hexframes
            assert res.time == base.time


def test_segmented_no_pulse():
    noise = (np.random.default_rng(5).standard_normal(int(70 * 44100)) * 0.3).astype(np.float32)
    res = segmented.decode_waveform_segmented(noise, 44100, device="cpu")
    assert res.status == 0
    assert res.time == []


def test_segmented_highrate_no_bogus_timeout():
    """The assemble and back half take the decode-rate valid length: a
    raw-rate count would stretch the trigger grid and fire the hard timeout
    on a 40 s 88.2 kHz file shorter than it (JAX's regression test)."""
    spec = simulator.SimSpec(fs=88200, duration=40.0, profile_start=1e9, seed=13)
    pcm, _ = simulator.synthesize(spec)
    cfg = resolve_settings({"triggerrange": [30, 60]}, compat="fixed")
    res = segmented.decode_waveform_segmented(_int16(pcm), 88200, device="cpu", config=cfg)
    assert res.status == 1
    assert isinstance(res.fs, float) and res.fs == 44100.0


def test_auto_mode_routes_long_drops_to_segmented(drop130, decoded, monkeypatch):
    """"auto" takes the segmented engine above AUTO_SEGMENT_SECONDS (here
    lowered to 100 s), "monolithic" the fused program."""
    pcm, _ = drop130
    raw = _int16(pcm)
    calls = []
    real = segmented.decode_waveform_segmented

    def spy(*args, **kwargs):
        calls.append(args[1])
        return real(*args, **kwargs)

    monkeypatch.setattr(segmented, "decode_waveform_segmented", spy)
    monkeypatch.setattr(engine, "AUTO_SEGMENT_SECONDS", 100)
    seg = decoded[0]["int16"][0]
    auto = engine.decode_waveform(raw, 44100, device="cpu")
    assert len(calls) == 1
    assert auto.hexframes == seg.hexframes and auto.time == seg.time
    mono = engine.decode_waveform(raw, 44100, device="cpu", mode="monolithic")
    assert len(calls) == 1
    monkeypatch.setattr(engine, "AUTO_SEGMENT_SECONDS", 300)
    assert engine.decode_waveform(raw, 44100, device="cpu").time == mono.time
    assert len(calls) == 1
    assert mono.status == 2 and mono.metadata == seg.metadata


@pytest.mark.slow  # JAX compiles the decimating segment program
def test_segmented_highrate_equals_jax():
    spec = simulator.SimSpec(fs=88200, duration=70.0, profile_start=33.0, seed=41)
    pcm, truth = simulator.synthesize(spec)
    raw = _int16(pcm)
    ours = segmented.decode_waveform_segmented(raw, 88200, device="cpu")
    ref = jseg.decode_waveform_segmented(raw, 88200, wire="int16")
    assert ours.status == ref.status == 2
    assert ours.metadata == ref.metadata
    assert ours.metadata["serial_no"] == truth["serial_no"]
    assert isinstance(ours.fs, float) and ours.fs == ref.fs == 44100.0
    assert ours.numpoints == ref.numpoints == (len(raw) + 1) // 2
    assert ours.profstartind == ref.profstartind
    assert ours.hexframes == ref.hexframes


@pytest.mark.slow  # JAX compiles the int4 segment program
def test_segmented_int4_wire_equals_jax(drop130):
    pcm, _ = drop130
    raw = _int16(pcm)
    ours = segmented.decode_waveform_segmented(raw, 44100, device="cpu", wire="int4")
    ref = jseg.decode_waveform_segmented(raw, 44100, wire="int4")
    assert ours.wire == ref.wire
    assert ours.status == ref.status
    assert ours.metadata == ref.metadata
    assert ours.profstartind == ref.profstartind
    assert ours.hexframes == ref.hexframes
