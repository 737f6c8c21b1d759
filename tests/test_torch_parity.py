"""The port's host parity engine against the JAX package's, on the CPU.

Both are float64 numpy/scipy state machines; the port's is a copy over the
port's own ``demod``, ``frames``, ``convert`` and ``metadata``.  The same WAV
through both ``decode_wav``s: every field of the result and the
``write_report`` bytes **equal** (exact; no tolerance), for the default drop,
``-d 2500``, ``compat="fixed"`` with the bandpass, a trimmed ``timerange``,
the 88.2 kHz drop (decimation path) and a ``--diagnostics`` report.
"""

import numpy as np
import pytest

from axctdprocessor_tpu.models import parity_engine as jparity
from axctdprocessor_tpu.utils import report as jreport
from axctdprocessor_tpu.utils.config import resolve_settings as jresolve
from axctdprocessor_tpu_torch.models import parity_engine, simulator
from axctdprocessor_tpu_torch.models.result import DecodeResult
from axctdprocessor_tpu_torch.utils import report
from axctdprocessor_tpu_torch.utils.config import resolve_settings

ARRAYS = ("time", "r400", "r7500", "depth", "temperature", "conductivity", "salinity")


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("parity_wavs")
    out = {}
    for name, spec in (("default", simulator.SimSpec()),
                       ("hi88k", simulator.SimSpec(fs=88200, duration=45.0,
                                                   profile_start=33.0, seed=3))):
        pcm, _ = simulator.synthesize(spec)
        out[name] = str(d / f"{name}.wav")
        simulator.write_wav(out[name], pcm, spec.fs)
    return out


ECHO = {"triggerrange": [30, -1], "minR400": 2.0, "mindR7500": 1.5, "deadfreq": 3000.0,
        "pointsperloop": 100000, "mark_space_freqs": [400.0, 800.0], "use_bandpass": False}

CASES = {
    "default": dict(),
    "deadfreq_2500": dict(settings={"deadfreq": 2500.0}),
    "fixed_bandpass": dict(settings={"use_bandpass": True, "minR400": 2.5,
                                     "triggerrange": [30, 45]}, compat="fixed"),
    "timerange": dict(timerange=(2.0, 44.0)),
    "decimation_88k": dict(wav="hi88k"),
    "diagnostics": dict(diagnostics=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_parity_decode_and_report_bytes_equal_jax(wavs, tmp_path, case):
    c = CASES[case]
    wav = wavs[c.get("wav", "default")]
    timerange = c.get("timerange", (0, -1))
    settings, compat = c.get("settings"), c.get("compat", "strict")
    ours = parity_engine.decode_wav(wav, timerange, settings and dict(settings), compat=compat)
    ref = jparity.decode_wav(wav, timerange, settings and dict(settings), compat=compat)

    assert isinstance(ours, DecodeResult)
    assert ours.status == ref.status == 2
    assert (ours.fs, ours.numpoints) == (ref.fs, ref.numpoints)
    assert type(ours.fs) is type(ref.fs)
    assert ours.firstpulse400 == ref.firstpulse400
    assert ours.profstartind == ref.profstartind
    assert ours.firstpointtime == ref.firstpointtime
    assert ours.metadata == ref.metadata
    assert ours.hexframes == ref.hexframes and len(ours.hexframes) > 100
    assert list(ours.hexframes_qc) == list(ref.hexframes_qc)
    assert ours.wire is None and ours.overflow == 0
    for name in ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(ours, name)),
                                      np.asarray(getattr(ref, name)), err_msg=name)

    echo = {**ECHO, **(settings or {})}  # the CLI echoes every setting
    a, b = tmp_path / "torch.txt", tmp_path / "jax.txt"
    diag = c.get("diagnostics", False)
    report.write_report(str(a), ours, wav, list(timerange), echo,
                        resolve_settings(settings and dict(settings), compat=compat),
                        diagnostics=diag)
    jreport.write_report(str(b), ref, wav, list(timerange), echo,
                         jresolve(settings and dict(settings), compat=compat),
                         diagnostics=diag)
    assert a.read_bytes() == b.read_bytes()
    assert a.read_bytes().count(b"\n") > 200


def test_parity_decode_waveform_and_progress(wavs):
    """``decode_waveform`` on conditioned samples, with the progress callback
    the CLI passes: the same calls in the same order as the source's."""
    from axctdprocessor_tpu.utils.wavio import read_wav

    pcm, fs = read_wav(wavs["default"])
    seen, jseen = [], []
    ours = parity_engine.decode_waveform(pcm, fs, progress=seen.append)
    ref = jparity.decode_waveform(pcm, fs, progress=jseen.append)
    assert seen == jseen and seen[-1] == 100
    assert ours.hexframes == ref.hexframes
    assert ours.time == ref.time


def test_parity_checkpoint_round_trip(wavs, tmp_path):
    """``save_checkpoint`` mid-decode, ``load_checkpoint``, feed the rest:
    equal to the uninterrupted decode; a pickle of something else raises."""
    import pickle

    from axctdprocessor_tpu_torch.utils.wavio import read_wav

    pcm, fs = read_wav(wavs["default"])
    whole = parity_engine.decode_waveform(pcm, fs)
    dec = parity_engine.ParityDecoder(None, fs)
    cut = int(25 * fs)
    dec.feed(pcm[:cut])
    path = str(tmp_path / "parity.ckpt")
    dec.save_checkpoint(path)
    resumed = parity_engine.ParityDecoder.load_checkpoint(path)
    resumed.feed(pcm[cut:])
    res = resumed.finalize()
    assert res.hexframes == whole.hexframes and res.metadata == whole.metadata
    assert res.time == whole.time
    other = str(tmp_path / "other.ckpt")
    with open(other, "wb") as f:
        pickle.dump({"not": "a decoder"}, f)
    with pytest.raises(TypeError):
        parity_engine.ParityDecoder.load_checkpoint(other)
