"""The frozen reference: the same as the port's host modules at the commit it
was copied from, in agreement with the port's CPU decode by the benchmark's
own comparison, and its control (salinity from rounded T and C) caught by it."""

import numpy as np
import pytest

from portbench.core import inputs, judge
from portbench.reference import job, parity_engine as ref_parity, report as ref_report
from portbench.reference import simulator as ref_sim
from portbench.reference.config import DecoderConfig


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    spec = {"duration_s": 60.0, "fs": 44100, "profile_start_s": 33.0, "seed": 424242}
    return inputs.render(spec, str(d / "drop.wav"))["path"]


def test_frozen_simulator_and_parity_engine_equal_the_ports(wav):
    from axctdprocessor_tpu_torch.models import parity_engine, simulator
    from axctdprocessor_tpu_torch.utils import report

    spec = dict(duration=20.0, profile_start=12.0, seed=9)
    a, ta = ref_sim.synthesize(ref_sim.SimSpec(**spec))
    b, tb = simulator.synthesize(simulator.SimSpec(**spec))
    np.testing.assert_array_equal(a, b)
    assert ta["frame_hex"] == tb["frame_hex"]
    cfg = DecoderConfig()
    echo = job.echo_settings(cfg)
    ours = ref_report.format_report(ref_parity.decode_wav(wav), wav, [0, -1], echo, cfg)
    port = report.format_report(parity_engine.decode_wav(wav), wav, [0, -1], echo, cfg)
    assert ours == port


def test_reference_agrees_with_the_ports_cpu_decode(wav, tmp_path):
    from axctdprocessor_tpu_torch.models.engine import decode_wav
    from axctdprocessor_tpu_torch.utils.report import write_report

    cfg = DecoderConfig()
    res = decode_wav(wav, device="cpu")
    out = tmp_path / "port.txt"
    write_report(str(out), res, wav, [0, -1], job.echo_settings(cfg), cfg)
    ref = job.decode({"path": wav, "name": wav})
    got = judge.compare(out.read_text(), res, ref, wav)
    assert got["header_wrong"] == got["report_wrong"] == got["rows_wrong"] == 0
    assert got["frames_missing"] == 0 and got["rows_unknown"] == 0 and got["rows"] > 500
    assert got["rows_missing"] < 0.02 and got["trigger_gap_s"] < 0.05


def test_control_and_planted_faults_in_the_ports_place_are_caught(tmp_path):
    spec = {"duration_s": 60.0, "fs": 44100, "profile_start_s": 33.0, "seed": 77}
    path = inputs.render(spec, str(tmp_path / "drop.wav"))["path"]
    ref = job.decode({"path": path, "name": path})

    def judged(variant):
        out = job.decode({"path": path, "name": path, "variant": variant, "keep_result": True})
        return judge.compare(out["text"], out["result"], ref, path)

    same = judged("float64")
    assert same["rows_wrong"] == same["rows_missing"] == same["trigger_gap_s"] == 0
    assert same["frames_missing"] == same["rows_unknown"] == same["report_wrong"] == 0
    assert judged("rounded")["rows_wrong"] > 0
    assert judged("truncated")["rows_missing"] >= 0.25
    assert judged("frames_cut")["frames_missing"] >= 0.09
    assert judged("late_start")["trigger_gap_s"] >= 0.19
    assert judged("made_up")["rows_unknown"] >= 0.09
