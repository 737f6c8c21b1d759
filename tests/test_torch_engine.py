"""The port's fused decode against the JAX engine, on the CPU.

* the constant tables and static shapes are the JAX engine's, bit for bit;
* given the SAME stage-1 outputs (the JAX engine's, on the default drop),
  the two back halves pack equal int32 vectors, element for element;
* end to end on the default drop, the port's ``decode_waveform(device=
  "cpu")`` gives the JAX monolithic decode's hexframes, trigger indices,
  metadata and report text;
* own-truth checks of the port alone (an 88.2 kHz drop, the int4 wire),
  and, marked slow, the same two drops against JAX (each costs a whole
  JAX program compile).
"""

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from axctdprocessor_tpu.models import tpu_engine as jeng
from axctdprocessor_tpu.ops import iir as jiir
from axctdprocessor_tpu.utils import report as jreport
from axctdprocessor_tpu.utils.config import DecoderConfig, resolve_settings
from axctdprocessor_tpu.utils.wavio import read_wav_raw16
from axctdprocessor_tpu.ops import wire as jwire
from axctdprocessor_tpu_torch.models import engine, simulator
from axctdprocessor_tpu_torch.ops import wire as wire_ops
from axctdprocessor_tpu_torch.utils import report

torch.set_num_threads(2)

# the CLI's default settings, echoed into the report
SETTINGS = {"triggerrange": [30, -1], "minR400": 2.0, "mindR7500": 1.5,
            "deadfreq": 3000.0, "pointsperloop": 100000,
            "mark_space_freqs": [400.0, 800.0], "use_bandpass": False}


def _agreement(a, b) -> float:
    a, b = set(a), set(b)
    return len(a & b) / max(len(a | b), 1)


def _dims(n: int, fs: float, cfg: DecoderConfig):
    npcm = int(np.round(fs / cfg.bitrate * (1 - cfg.phase_error / 100))) - 2 * cfg.bit_inset
    return (engine.EngineDims.for_waveform(n, fs, cfg.bitrate, npcm),
            jeng.EngineDims.for_waveform(n, fs, cfg.bitrate, npcm))


@pytest.mark.parametrize("fs,decimate2,cfg", [
    (44100.0, False, DecoderConfig()),
    (44100.0, True, DecoderConfig(trigger_range=(5, 14), compat="fixed")),
    (16000.0, False, DecoderConfig(use_bandpass=True, dead_freq=2500.0)),
])
def test_engine_tables_equal_jax(fs, decimate2, cfg):
    dims, jdims = _dims(int(fs * 45), fs, cfg)
    assert dataclasses.asdict(dims) == dataclasses.asdict(jdims)
    tables = engine.engine_tables(cfg, fs, dims, decimate2)
    power_trig, bit_trig, sos = jeng.engine_tables(cfg, fs, jdims)
    trig_i, trig_f = jeng.trigger_tables(cfg, fs)
    want = dict(power_trig=power_trig, bit_trig=bit_trig, sos=sos,
                trig_i=trig_i, trig_f=trig_f,
                hdr_rel=jeng.header_rel_offsets(fs),
                calib_off=np.asarray(int(fs * 3.8), np.int32))
    if decimate2:
        want["decim_sos"] = jiir.design_decim_sos().astype(np.float32)
    assert sorted(tables) == sorted(want)
    for name, arr in want.items():
        assert tables[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(tables[name], arr, err_msg=name)
    model = engine.FusedDecoder.from_numpy_tables(
        tables, dims, fs, bitrate=800.0, bit_inset=1, decimate2=decimate2,
        device="cpu")
    for name, arr in want.items():
        np.testing.assert_array_equal(getattr(model, name).numpy(), arr)


def _padded_wire(raw: np.ndarray, n_padded: int, wire: str) -> np.ndarray:
    """`raw` as the monolithic decode ships it at `wire`: encoded on the
    host, then padded to the bucket (0x88, two zero levels, for packed int4)."""
    enc = wire_ops.encode(raw, wire)
    if enc.dtype == np.uint8:
        return np.concatenate([enc, np.full(n_padded // 2 - len(enc), 0x88, np.uint8)])
    return np.concatenate([enc, np.zeros(n_padded - len(enc), enc.dtype)])


def test_back_half_packed_vector_equal(default_drop_wav):
    """Both back halves, given the JAX stage-1 outputs of the default drop."""
    _back_halves_pack_equal_vectors(default_drop_wav, "int16")


@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_back_half_packed_vector_equal_lossy_wire(default_drop_wav, wire):
    """The same at the lossy wires: the JAX stage 1 runs on the encoded
    samples (unpacked and conditioned in its program), and on its outputs
    the two back halves pack equal vectors."""
    _back_halves_pack_equal_vectors(default_drop_wav, wire)


def _back_halves_pack_equal_vectors(default_drop_wav, wire: str):
    wav, _ = default_drop_wav
    raw, fs = read_wav_raw16(wav)
    fs = float(fs)
    cfg = DecoderConfig()
    unit = int(engine.BUCKET_SECONDS * fs)
    n_padded = max(math.ceil(len(raw) / unit) * unit, unit)
    pcm = _padded_wire(raw, n_padded, wire)
    dims, jdims = _dims(n_padded, fs, cfg)
    tables = engine.engine_tables(cfg, fs, dims)
    n_valid = jnp.asarray(len(raw), jnp.int32)

    s1 = jax.jit(jeng.stage1_core, static_argnames=(
        "dims", "fs", "bitrate", "bit_inset", "edge_pad", "use_pallas"))(
        jnp.asarray(pcm), jnp.asarray(tables["power_trig"]),
        jnp.asarray(tables["sos"]), jnp.asarray(tables["bit_trig"]),
        dims=jdims, fs=fs, bitrate=800.0, bit_inset=1, edge_pad=100,
        n_valid=n_valid)
    c0 = s1["s2"] / jnp.maximum(s1["s1"], 1e-30)
    fi = jeng.fused_inputs(cfg, fs)
    want = jax.jit(jeng.back_half_core, static_argnames=("dims", "fs"))(
        s1["r400"], s1["r7500"], s1["edge_samples"], s1["n_edges"], c0,
        n_valid, fi["trig_i"], fi["trig_f"], fi["hdr_rel"], fi["calib_off"],
        fi["coeff_defaults"], fi["temp_lut"], fi["limits"], dims=jdims, fs=fs,
        overflow0=s1["overflow"])

    def t(x):
        return torch.from_numpy(np.array(x))

    got = engine.back_half_core(
        t(s1["r400"]), t(s1["r7500"]), t(s1["edge_samples"]).long(),
        t(s1["n_edges"]).long(), t(c0), torch.tensor(len(raw)),
        *(t(tables[k]) for k in ("trig_i", "trig_f", "hdr_rel", "calib_off")),
        dims, fs, overflow0=t(s1["overflow"]))
    want = np.asarray(want)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    res = engine.finish_result(got.numpy(), 44100, len(raw), fs, cfg)
    assert res.status == 2 and len(res.hexframes) > 300


@pytest.fixture(scope="module")
def decoded_pair(default_drop_wav):
    """The default drop as int16, decoded by the port (CPU) and by the JAX
    monolithic engine."""
    wav, truth = default_drop_wav
    raw, fs = read_wav_raw16(wav)
    ours = engine.decode_waveform(raw, fs, device="cpu", wire="int16")
    ref = jeng.decode_waveform_tpu(raw, fs, mode="monolithic", wire="int16")
    return ours, ref, wav, truth


def test_whole_decode_hexframes_equal_jax(decoded_pair):
    ours, ref, _, _ = decoded_pair
    assert ours.status == ref.status == 2
    assert _agreement(ours.hexframes, ref.hexframes) == 1.0
    assert ours.hexframes == ref.hexframes
    assert ours.hexframes_qc == ref.hexframes_qc


def test_whole_decode_triggers_and_metadata_equal_jax(decoded_pair):
    ours, ref, _, truth = decoded_pair
    assert ours.firstpulse400 == ref.firstpulse400 > 0
    assert ours.profstartind == ref.profstartind > 0
    assert ours.metadata == ref.metadata
    assert ours.metadata["serial_no"] == truth["serial_no"]
    assert ours.overflow == ref.overflow == 0
    assert ours.wire == ref.wire == "int16"


def test_whole_decode_report_identical(decoded_pair):
    ours, ref, wav, _ = decoded_pair
    cfg = resolve_settings(SETTINGS)
    for diagnostics in (False, True):
        a = report.format_report(ours, wav, [0, -1], SETTINGS, cfg, diagnostics)
        b = jreport.format_report(ref, wav, [0, -1], SETTINGS, cfg, diagnostics)
        assert a == b
    assert a.count("\n") > 300


@pytest.mark.parametrize("ours_args, jax_args", [
    (["--engine", "cuda", "--device", "cpu"], ["--engine", "tpu", "--wire", "int16"]),
    (["--engine", "parity"], ["--engine", "parity"]),
    (["--device", "cpu"], ["--engine", "tpu", "--wire", "int16"]),  # default: the device engine
], ids=["cuda_on_cpu", "parity", "default"])
def test_cli_report_bytes_equal_jax_cli(decoded_pair, tmp_path, ours_args, jax_args):
    """The port's CLI writes the JAX CLI's report bytes: its fused engine
    (--engine cuda --device cpu) against --engine tpu, its parity engine
    against the JAX parity engine, and its default engine (the device one,
    here on the CPU) against --engine tpu."""
    from axctdprocessor_tpu import cli as jcli
    from axctdprocessor_tpu_torch import cli

    _, _, wav, _ = decoded_pair
    ours, ref = tmp_path / "torch.txt", tmp_path / "jax.txt"
    assert cli.main(["-i", wav, "-o", str(ours), "--quiet"] + ours_args) == 0
    assert jcli.main(["-i", wav, "-o", str(ref), "--quiet"] + jax_args) == 0
    assert ours.read_bytes() == ref.read_bytes()
    assert "Probe Serial: 00123456" in ours.read_text()


def _highrate_drop(tmp_path):
    spec = simulator.SimSpec(fs=88200, duration=42.0, profile_start=33.0, seed=31)
    pcm, truth = simulator.synthesize(spec)
    wav = str(tmp_path / "hi.wav")
    simulator.write_wav(wav, pcm, spec.fs)
    return wav, truth


def test_highrate_decode_own_truth(tmp_path):
    wav, truth = _highrate_drop(tmp_path)
    res = engine.decode_wav(wav, device="cpu")
    assert res.status == 2
    assert isinstance(res.fs, float) and res.fs == 44100.0
    assert res.numpoints == (int(42.0 * 88200) + 1) // 2
    for key in ("serial_no", "probe_code", "max_depth"):
        assert res.metadata[key] == truth[key]
    for key in ("tcoeff", "ccoeff", "zcoeff"):
        np.testing.assert_allclose(res.metadata[key], truth[key])
    truth_set = set(truth["frame_hex"])
    assert sum(h in truth_set for h in res.hexframes) / len(res.hexframes) > 0.97


@pytest.mark.parametrize("lossy_retry", [True, False])
def test_int4_wire_decode_own_truth(default_drop, lossy_retry):
    pcm, truth = default_drop
    raw = np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)
    res = engine.decode_waveform(raw, truth["spec"].fs, device="cpu",
                                 wire="int4", lossy_retry=lossy_retry)
    assert res.wire == "int4" if not lossy_retry else res.wire in ("int4", "int8")
    assert res.status == 2
    assert res.metadata["serial_no"] == truth["serial_no"]
    truth_set = set(truth["frame_hex"])
    assert sum(h in truth_set for h in res.hexframes) / len(res.hexframes) > 0.97


@pytest.fixture(scope="module")
def default_raw(default_drop):
    pcm, truth = default_drop
    return np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16), truth


@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_lossy_wire_decode_equals_jax(default_raw, wire):
    """The default 50 s drop at the lossy wires, end to end against the JAX
    engine at the same wire: the same wire recorded, equal trigger indices
    and metadata, equal hexframe sets."""
    raw, truth = default_raw
    fs = truth["spec"].fs
    ours = engine.decode_waveform(raw, fs, device="cpu", wire=wire)
    ref = jeng.decode_waveform_tpu(raw, fs, mode="monolithic", wire=wire)
    assert ours.wire == ref.wire == wire
    assert ours.status == ref.status == 2 and ours.overflow == ref.overflow == 0
    assert (ours.firstpulse400, ours.profstartind) == (ref.firstpulse400, ref.profstartind)
    assert ours.metadata == ref.metadata
    assert ours.metadata["serial_no"] == truth["serial_no"]
    assert set(ours.hexframes) == set(ref.hexframes) and len(ours.hexframes) > 300
    assert ours.hexframes == ref.hexframes


@pytest.fixture(scope="module")
def collapsing_drop():
    """Seed 11's 60 s drop (profile at 40 s): it collapses at the int4 wire
    to a few dozen frames, in both packages."""
    pcm, truth = simulator.synthesize(simulator.SimSpec(duration=60.0, profile_start=40.0,
                                                        seed=11))
    return np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16), truth


@pytest.mark.parametrize("lossy_retry", [True, False], ids=["retry", "no_retry"])
def test_forced_int4_retry_in_both_packages(collapsing_drop, lossy_retry):
    raw, truth = collapsing_drop
    fs = truth["spec"].fs
    ours = engine.decode_waveform(raw, fs, device="cpu", wire="int4", lossy_retry=lossy_retry)
    ref = jeng.decode_waveform_tpu(raw, fs, mode="monolithic", wire="int4",
                                   lossy_retry=lossy_retry)
    cfg = DecoderConfig()
    if lossy_retry:
        assert ours.wire == ref.wire == "int8"
        assert ours.status == ref.status == 2 and len(ours.hexframes) > 400
        assert ours.metadata == ref.metadata
        assert ours.metadata["serial_no"] == truth["serial_no"]
        assert set(ours.hexframes) == set(ref.hexframes)
    else:
        assert ours.wire == ref.wire == "int4"
        for res, worthy in ((ours, engine.lossy_retry_worthy), (ref, jeng.lossy_retry_worthy)):
            assert worthy(res, len(raw), float(fs), cfg)
            assert len(res.hexframes) < 100


@pytest.mark.parametrize("mode", ["monolithic", "segmented"])
def test_int4_retry_keeps_the_mode_and_fills_the_timer(collapsing_drop, mode):
    """The retry of a monolithic decode is monolithic and that of a
    segmented decode segmented, as in the JAX package; both leave the
    host's encode and upload stages in the caller's timer."""
    from axctdprocessor_tpu_torch.utils.profiling import StageTimer

    raw, truth = collapsing_drop
    timer = StageTimer()
    res = engine.decode_waveform(raw, truth["spec"].fs, device="cpu", wire="int4", mode=mode,
                                 timer=timer)
    assert res.wire == "int8" and res.status == 2 and len(res.hexframes) > 400
    # the int4 decode and its int8 retry: each encodes once, and a segmented
    # decode then takes its statistics in the span too
    assert timer.counts["host_encode_stats"] == (2 if mode == "monolithic" else 4)
    assert timer.counts["build_upload"] >= 2
    assert ("dispatch_loop" in timer.counts) == (mode == "segmented")


def test_int4_wire_odd_bucket_equals_jax():
    """At 11.025 kHz a 15 s bucket is an odd number of samples: the packed
    int4 buffer is padded to an even count with zero-level nibbles (0x88),
    in both packages, and an odd-length drop decodes to the same status."""
    fs = 11025
    t = np.arange(5 * fs + 1) / fs
    raw = np.round(9000 * np.sin(2 * np.pi * 400 * t)
                   + 500 * np.random.default_rng(1).standard_normal(len(t))).astype(np.int16)
    ours = engine.decode_waveform(raw, fs, device="cpu", wire="int4", lossy_retry=False)
    ref = jeng.decode_waveform_tpu(raw, fs, mode="monolithic", wire="int4", lossy_retry=False)
    assert ours.wire == ref.wire == "int4"
    assert ours.numpoints == ref.numpoints == len(raw)
    assert (ours.status, ours.firstpulse400, ours.profstartind, ours.overflow) == (
        ref.status, ref.firstpulse400, ref.profstartind, ref.overflow)
    assert ours.status == 1 and ours.hexframes == ref.hexframes == []


@pytest.mark.parametrize("default", ["int4", "int16"])
@pytest.mark.parametrize("dtype", [np.int16, np.int8, np.int32, np.float32, np.float64])
@pytest.mark.parametrize("wire", ["auto", "int16", "int8", "int4", "int2"])
def test_resolve_wire_table_equals_jax(monkeypatch, wire, dtype, default):
    """Every (wire, dtype) pair against the JAX package's rule
    (axctdprocessor_tpu/ops/wire.py:54-66), with both packages' defaults
    patched to the same wire."""
    monkeypatch.setattr(jwire, "default_wire", lambda: default)
    monkeypatch.setattr(wire_ops, "default_wire", lambda device=None: default)
    if wire == "int2":
        for resolve in (jwire.resolve_wire, wire_ops.resolve_wire):
            with pytest.raises(ValueError, match="wire"):
                resolve(wire, dtype)
        return
    got = wire_ops.resolve_wire(wire, dtype)
    assert got == jwire.resolve_wire(wire, dtype)
    assert got == engine.resolve_wire(wire, dtype, torch.device("cpu"))
    if not np.issubdtype(dtype, np.integer):
        assert got == "int16"  # floats are never re-encoded
    elif wire == "auto":
        assert got == default


def test_auto_wire_is_int16_on_every_path():
    """The port's measured default: ``"auto"`` is int16 for every device."""
    from axctdprocessor_tpu_torch.parallel import batch

    assert engine.resolve_wire is wire_ops.resolve_wire
    for device in (None, "cpu", torch.device("cuda", 0)):
        assert wire_ops.default_wire(device) == "int16"
        assert wire_ops.resolve_wire("auto", np.int16, device) == "int16"
    assert batch.BatchPlan(np.int16, 44100, 44100, None, "auto", "cpu").wire_used == "int16"
    assert batch.BatchPlan(np.float32, 44100, 44100, None, "int4", "cpu").wire_used == "float32"


def test_trigger_core_matches_jax():
    """Pulse, baseline and trigger over random series and configs (the
    JAX engine's own host-equivalence test, tests/test_tpu_engine.py)."""
    rng = np.random.default_rng(77)
    fs = 44100.0
    d_pcm, n_power = int(round(fs / 25)), int(fs / 10)
    jtrig = jax.jit(jeng.trigger_core, static_argnames=("dims", "fs"))
    for trial in range(24):
        n_win = int(rng.integers(30, 500))
        r400 = rng.normal(1.2, 0.9, n_win).astype(np.float32)
        r7500 = rng.normal(0.8, 1.0, n_win).astype(np.float32)
        if trial % 4 == 0:
            r400 -= 10.0  # no pulse at all
        if trial % 3 == 0:
            r7500[:] = np.nan  # no usable baseline -> timeout path
        if trial % 5 == 1:
            r7500[rng.random(n_win) < 0.2] = np.nan  # holes in the baseline
        cfg = DecoderConfig(
            trigger_range=(float(rng.integers(0, 12)),
                           float(rng.choice([-1.0, 3.0, 7.5]))),
            compat="fixed" if trial % 2 else "strict")
        n = n_power + d_pcm * n_win
        dims, jdims = _dims(n, fs, cfg)
        trig_i, trig_f = engine.trigger_tables(cfg, fs)
        want = jtrig(jnp.asarray(r400), jnp.asarray(r7500),
                     jnp.asarray(n, jnp.int32), jnp.asarray(trig_i),
                     jnp.asarray(trig_f), dims=jdims, fs=fs)
        got = engine.trigger_core(torch.from_numpy(r400), torch.from_numpy(r7500),
                                  torch.tensor(n), torch.from_numpy(trig_i),
                                  torch.from_numpy(trig_f), dims, fs)
        assert int(got[0]) == int(want[0]), trial
        assert int(got[2]) == int(want[2]), trial
        np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-6,
                                   atol=0, equal_nan=True, err_msg=str(trial))


def _short_drop(kind: str):
    """16 s int16 drops (one 30 s bucket, so one JAX compile for all)."""
    if kind == "noise":
        return (np.random.default_rng(0).standard_normal(16 * 44100) * 3000).astype(np.int16)
    spec = simulator.SimSpec(duration=16.0, profile_start=200.0, tone7500_amp=0.0, seed=5)
    pcm, _ = simulator.synthesize(spec)
    return np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)


@pytest.mark.parametrize("kind,cfg,status", [
    ("noise", DecoderConfig(), 0),                                   # no pulse
    ("pulse", DecoderConfig(), 1),                                   # no profile
    ("pulse", DecoderConfig(trigger_range=(5, 14), compat="fixed"), 2),  # timeout fires
    ("pulse", DecoderConfig(trigger_range=(5, 18), compat="fixed"), 1),  # only in the padding
])
def test_short_drops_equal_jax(kind, cfg, status):
    raw = _short_drop(kind)
    ours = engine.decode_waveform(raw, 44100, device="cpu", config=cfg)
    ref = jeng.decode_waveform_tpu(raw, 44100, mode="monolithic", config=cfg)
    assert ours.status == ref.status == status
    assert ours.firstpulse400 == ref.firstpulse400
    assert ours.profstartind == ref.profstartind
    assert ours.metadata == ref.metadata
    assert ours.hexframes == ref.hexframes


def test_device_and_mode_are_explicit(tmp_path):
    if torch.cuda.is_available():
        assert engine.resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            engine.resolve_device("cuda")
        # every entry point runs on the card unless asked for the CPU: here,
        # without a GPU, a call that names no device raises before any work
        from axctdprocessor_tpu_torch.models import segmented
        from axctdprocessor_tpu_torch.models.stream_device import DeviceStreamDecoder
        import axctdprocessor_tpu_torch as ax
        from axctdprocessor_tpu_torch import cli
        from axctdprocessor_tpu_torch.parallel import batch

        pcm = np.zeros(44100, np.int16)
        wav = str(tmp_path / "silence.wav")
        simulator.write_wav(wav, pcm.astype(np.float64), 44100)
        calls = [
            lambda: engine.decode_wav(str(tmp_path / "absent.wav")),
            lambda: engine.decode_waveform(pcm, 44100),
            lambda: segmented.decode_waveform_segmented(pcm, 44100),
            lambda: segmented.prestage_waveform(pcm, 44100),
            lambda: DeviceStreamDecoder(44100),
            lambda: batch.dispatch_batch(pcm[None], 44100),
            lambda: batch.decode_batch(pcm[None], 44100),
            lambda: ax.decode_wav(wav),
            lambda: ax.decode_waveform(pcm, 44100),
            lambda: ax.decode_batches_pipelined([(pcm[None], None)], 44100),
            lambda: ax.reprocess_corpus([wav], str(tmp_path / "out")),
            lambda: cli.main(["-i", wav, "-o", str(tmp_path / "o.txt"), "--quiet"]),
            lambda: cli.main(["--corpus", str(tmp_path), "-o", str(tmp_path / "out"),
                              "--quiet"]),
        ]
        for call in calls:
            with pytest.raises(RuntimeError, match="cuda"):
                call()
    with pytest.raises(ValueError, match="mode"):
        engine.decode_waveform(np.zeros(44100, np.int16), 44100, device="cpu",
                               mode="sharded")
    res = engine.decode_waveform(np.zeros(44100, np.int16), 44100, device="cpu",
                                 mode="segmented")
    assert res.status == 0 and res.numpoints == 44100
    assert engine.resolve_wire("auto", np.int16) == "int16"


@pytest.mark.slow  # a whole JAX program compile at 88.2 kHz
def test_highrate_decode_equals_jax(tmp_path):
    wav, _ = _highrate_drop(tmp_path)
    ours = engine.decode_wav(wav, device="cpu")
    ref = jeng.decode_wav_tpu(wav)
    assert ours.metadata == ref.metadata
    assert ours.firstpulse400 == ref.firstpulse400
    assert ours.profstartind == ref.profstartind
    assert _agreement(ours.hexframes, ref.hexframes) == 1.0


@pytest.mark.slow  # a whole JAX program compile for the int4 wire
def test_int4_wire_decode_equals_jax(default_drop):
    pcm, truth = default_drop
    raw = np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)
    ours = engine.decode_waveform(raw, truth["spec"].fs, device="cpu", wire="int4")
    ref = jeng.decode_waveform_tpu(raw, truth["spec"].fs, mode="monolithic",
                                   wire="int4")
    assert ours.wire == ref.wire
    assert ours.metadata == ref.metadata
    assert ours.profstartind == ref.profstartind
    assert _agreement(ours.hexframes, ref.hexframes) == 1.0
