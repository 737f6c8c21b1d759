"""The metric readers' arithmetic, discovery by name and the comparison's
numbers, on synthetic inputs."""

import json
import os
import types

import numpy as np
import pytest

from portbench.core import judge, readers, registry, stats, trace, work
from portbench.core.harness import Reading, Step


def _trace():
    return trace.Trace(
        window=(0.0, 10.0),
        device=[("void tone_ratios_kernel<8, true>(float const*)", 1.0, 2.0),
                ("void probe_run_kernel<128, 9216>(float const*)", 1.5, 3.0),
                ("Memcpy HtoD (Pinned -> Device)", 5.0, 6.0),
                ("void tone_ratios_kernel<8, true>(float const*)", 9.5, 12.0)],
        host_calls={"kernel launches": 3, "graph launches": 1, "copies": 1, "fills": 1},
        spans=[("decode_wav", 0.0, 10.0), ("dispatch_loop", 0.5, 3.5),
               ("write_report", 7.0, 9.0)],
        units=2)


def test_busy_is_the_union_of_device_activity_inside_the_window():
    tr = _trace()
    assert tr.busy_intervals() == [(1.0, 3.0), (5.0, 6.0), (9.5, 10.0)]
    assert tr.busy_s == pytest.approx(3.5)
    reading = Reading(setup_s=1.0, window_s=1.0, steps=[], trace=tr)
    assert readers.idle_share(reading) == pytest.approx(65.0)


def test_idle_gaps_are_labelled_by_the_innermost_open_span():
    gaps = dict(map(tuple, _trace().idle_gaps()))
    # gaps (0, 1), (3, 5) and (6, 9.5), cut at the spans' edges 0.5, 3.5, 7 and 9
    assert gaps == pytest.approx({"dispatch_loop": 1.0, "decode_wav": 3.5,
                                  "write_report": 2.0})


def test_launches_per_unit_and_launch_kinds():
    reading = Reading(setup_s=1.0, window_s=1.0, steps=[], trace=_trace())
    assert readers.launches_per_unit(reading) == pytest.approx(3.0)
    assert trace.launch_kind("cudaGraphLaunch") == "graph launches"
    assert trace.launch_kind("cudaLaunchKernel") == "kernel launches"
    assert trace.launch_kind("cuLaunchKernelEx") == "kernel launches"
    assert trace.launch_kind("cudaMemcpyAsync") == "copies"
    assert trace.launch_kind("cudaMemsetAsync") == "fills"
    assert trace.launch_kind("aten::add") is None


def test_from_profile_reads_window_spans_devices_and_launches():
    from torch.autograd import DeviceType

    def ev(name, a, b, dev=DeviceType.CPU):
        return types.SimpleNamespace(name=name, device_type=dev,
                                     time_range=types.SimpleNamespace(start=a, end=b))

    prof = types.SimpleNamespace(events=lambda: [
        ev("cudaLaunchKernel", 5, 6), ev("cudaGraphLaunch", 20, 21),
        ev("cudaLaunchKernel", 2e6, 2e6 + 1),  # after the window: not counted
        ev(trace.WINDOW_SPAN, 0, 1e6), ev("portbench/write_report", 100, 200),
        ev("probe_run_kernel<64, 9216>", 30, 40, DeviceType.CUDA)])
    tr = trace.from_profile(prof, units=1)
    assert tr.window == (0.0, 1.0)
    assert tr.host_launch_calls == 2
    assert [s[0] for s in tr.spans] == ["write_report"]
    assert tr.spans[0][1:] == pytest.approx((1e-4, 2e-4))
    assert tr.device_seconds(("probe_run_kernel",)) == pytest.approx(1e-5)
    assert trace.from_profile(types.SimpleNamespace(events=lambda: []), 1) is None


def test_tone_and_probe_work_counted_from_the_inputs():
    fs, n = 44100, 600 * 44100
    n_win = (n - 4410) / 1764
    assert work.windows(n, fs) == pytest.approx(n_win)
    bytes_s = (4 * n + 8 * n_win) / 3.35e12
    flop_s = n_win * 3 * 4410 * 4 / 66.9e12
    assert work.tone_least_seconds(n, fs) == pytest.approx(max(bytes_s, flop_s))
    assert bytes_s > flop_s  # memory bound: about 31.6 us at 600 s
    assert work.probe_window(44100) == 39 and work.probe_window(88200) == 81
    probes = 600 * 800
    want = (4 * probes * 39 + 16 * probes) / 3.35e12
    assert work.probe_least_seconds(n, fs) == pytest.approx(max(want, probes * 312 / 66.9e12))


def test_roofline_divides_the_least_time_by_the_kernels_device_time():
    tr = _trace()
    steps = [Step(latency_s=0.1, audio_s=600, spans={}, samples=600 * 44100, fs=44100)] * 2
    reading = Reading(setup_s=1.0, window_s=1.0, steps=[], trace=tr, traced=steps)
    got = readers.roofline(reading, work.tone_least_seconds, ("tone_ratios_kernel",))
    assert got == pytest.approx(100 * 2 * work.tone_least_seconds(600 * 44100, 44100) / 3.5)
    assert readers.roofline(reading, work.tone_least_seconds, ("absent",)) is None


def test_percentiles_and_rates_over_every_sample():
    lat = list(np.linspace(0.1, 0.2, 101)) + [5.0] * 9  # a tail of 9 of 110
    steps = [Step(latency_s=x, audio_s=600.0, spans={"write_report": 0.01}) for x in lat]
    reading = Reading(setup_s=1.0, window_s=30.0, steps=steps)
    assert readers.p95_ms(reading) == pytest.approx(1e3 * np.percentile(lat, 95))
    assert readers.p95_ms(reading) > 1000  # the tail is every request's, not a median's
    assert readers.rate(reading) == pytest.approx(110 * 600 / 30.0)
    assert readers.span_ms_per_unit(reading, ["write_report"]) == pytest.approx(10.0)
    assert readers.span_ms_per_unit(reading, ["absent"]) is None
    assert stats.percentile([], 95) is None


def test_cell_and_metric_found_by_name_in_a_new_directory(tmp_path):
    for sub in ("configs", "traffic", "cells", "metrics", "clients"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "cfg-x.json").write_text(json.dumps({"name": "cfg-x"}))
    (tmp_path / "traffic" / "mix-x.json").write_text(json.dumps({"client": "cli_x"}))
    (tmp_path / "cells" / "cell.x.json").write_text(json.dumps({"limits": {"a": 0}}))
    (tmp_path / "clients" / "cli_x.py").write_text("class Client:\n    kind = 'x'\n")
    (tmp_path / "metrics" / "new_ms.x.py").write_text(
        "def read(reading):\n    return 2 * reading.setup_s\n")
    base = str(tmp_path)
    assert registry.config("cfg-x", base)["name"] == "cfg-x"
    assert registry.traffic("mix-x", base)["client"] == "cli_x"
    assert registry.cell("cell.x", base)["limits"] == {"a": 0}
    assert registry.client("cli_x", base).Client.kind == "x"
    bench = {"end_to_end": [], "per_layer": [
        {"name": "new_ms.x", "unit": "ms", "workloads": ["cell.x"]},
        {"name": "other", "unit": "ms", "workloads": ["cell.y"]}]}
    from portbench.core.harness import read_metrics

    got = read_metrics(bench, "cell.x", True, Reading(setup_s=1.5, window_s=1, steps=[]), base)
    assert got == {"new_ms.x": {"value": 3.0, "unit": "ms"}}


def test_every_benchmark_metric_and_cell_has_its_files():
    bench = registry.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert hasattr(registry.metric(m["name"]), "read"), m["name"]
    for w in bench["workloads"]:
        registry.config(w["config"])
        assert "client" in registry.traffic(w["traffic"])
        assert set(registry.cell(w["name"])["limits"]) >= {"rows_wrong", "reports_missing"}
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(registry.ROOT, c["file"]))


LIVE = {"zcoeff": [0.72, 2.76124, -0.000238007, 0.0],
        "tcoeff": [-0.053328, 0.994372, 0.0, 0.0],
        "ccoeff": [-0.0622192, 1.04584, 0.0, 0.0]}
FS = 44100


def _decoded(n=40, qc_out=(), codes=None):
    """A decode result of `n` profile frames of the simulator's codes, 0.04 s
    apart from a profile start at 33 s, converted as a decoder does; quality
    control left out the frames in `qc_out` (their hex stays in
    ``hexframes``)."""
    from portbench.reference import convert, simulator
    from portbench.reference.lut import load_temp_lut
    from portbench.reference.result import DecodeResult

    tints, cints = codes or simulator.default_profile_ints(n)
    words = [simulator.bits_to_hex_np(simulator.encode_profile_frame(t, c))
             for t, c in zip(tints, cints)]
    times_raw = 0.04 * np.arange(n) + 0.0123
    temp, cond, psal, z = convert.ints_to_observations(
        tints, cints, times_raw, load_temp_lut(), LIVE["tcoeff"], LIVE["ccoeff"], LIVE["zcoeff"])
    res = DecodeResult(fs=FS, numpoints=60 * FS, firstpulse400=int(0.96 * FS),
                       profstartind=33 * FS, firstpointtime=33.0)
    keep = [i for i in range(n) if i not in qc_out]
    res.time = [float(np.round(times_raw[i] + 33.0, 2)) for i in keep]
    res.depth = [float(np.round(z[i], 2)) for i in keep]
    res.temperature = [float(np.round(temp[i], 2)) for i in keep]
    res.conductivity = [float(np.round(cond[i], 2)) for i in keep]
    res.salinity = [float(np.round(psal[i], 2)) for i in keep]
    res.hexframes = list(words)
    res.hexframes_qc = [words[i] for i in keep]
    frames = [(int(t), int(c), float(tr + 33.0)) for t, c, tr in zip(tints, cints, times_raw)]
    return res, frames


def _reference(qc_out=(3, 4, 20)):
    from portbench.reference import job

    res, frames = _decoded(qc_out=qc_out)
    return {"text": job.report_of(res, "x.wav"), "live": LIVE, "rows": judge.aligned_rows(res),
            "frames": frames, "hexframes": list(res.hexframes)}


def _judged(res, text=None):
    from portbench.reference import job

    return judge.compare(job.report_of(res, "x.wav") if text is None else text, res,
                         _reference(), "x.wav")


def _changed(res, name, k, delta):
    values = list(getattr(res, name))
    values[k] = values[k] + delta
    setattr(res, name, values)
    return res


def test_compare_reads_a_sound_report_as_right_and_each_fault_as_wrong():
    import copy

    sound, _ = _decoded(qc_out=(3, 4))  # the reference's quality control left out one more
    got = _judged(sound)
    assert got["rows_wrong"] == got["header_wrong"] == got["report_wrong"] == 0
    assert got["rows_missing"] == got["frames_missing"] == got["trigger_gap_s"] == 0
    assert got["rows_unknown"] == 0
    for name, delta in (("temperature", 0.01), ("salinity", 0.01), ("depth", 0.05)):
        assert _judged(_changed(copy.deepcopy(sound), name, 10, delta))["rows_wrong"] == 1, name
    other = copy.deepcopy(sound)
    other.hexframes_qc[10] = sound.hexframes_qc[30]  # the row beside another frame
    assert _judged(other)["rows_wrong"] == 1
    from portbench.reference import job

    text = job.report_of(sound, "x.wav")
    row = text.splitlines(keepends=True)[-7]
    assert _judged(sound, text.replace(row, row[:-3] + "9\n"))["report_wrong"] == 1
    assert _judged(sound, text.replace("Serial: None", "Serial: 00123457"))["report_wrong"] == 1
    header = job.report_of(copy.deepcopy(sound), "x.wav").replace("Probe Code: None",
                                                                  "Probe Code: a000")
    assert judge.compare(header, None, _reference())["header_wrong"] == 1
    late = copy.deepcopy(sound)
    late.profstartind += int(0.08 * FS)
    assert _judged(late)["trigger_gap_s"] == pytest.approx(0.08)
    assert judge.compare(None, sound, _reference()) == {"reports_missing": 1}
    assert judge.compare("garbage", sound, _reference()) == {"reports_missing": 1}


def test_rows_and_frames_lost_or_made_up_are_counted():
    import copy

    sound, _ = _decoded()
    tail = copy.deepcopy(sound)  # the deepest quarter of the rows lost
    for name in ("time", "depth", "temperature", "conductivity", "salinity", "hexframes_qc"):
        setattr(tail, name, getattr(tail, name)[:27])
    assert _judged(tail)["rows_missing"] == pytest.approx(13 / 37)
    assert _judged(tail)["frames_missing"] == 0
    cut = copy.deepcopy(tail)
    cut.hexframes = cut.hexframes[:30]
    assert _judged(cut)["frames_missing"] == pytest.approx(10 / 40)
    from portbench.reference import simulator

    tints, cints = simulator.default_profile_ints(40)
    tints = np.array(tints)
    tints[12] += 40  # one frame decoded wrong where it is produced: its row follows it
    made_up, _ = _decoded(codes=(tints, cints))
    got = _judged(made_up)
    assert got["rows_wrong"] == 0 and got["rows_unknown"] == pytest.approx(1 / 40)
    assert got["frames_missing"] == pytest.approx(1 / 40)


def test_rows_pair_with_the_reference_near_their_time_one_for_one():
    ref = [("a", 10.0), ("a", 10.04), ("b", 10.08), ("c", 20.0)]
    assert judge.rows_missing([("a", 10.3), ("b", 10.1), ("c", 20.9)], ref) == 0.25
    assert judge.rows_missing([("a", 9.5), ("a", 10.5), ("b", 10.1), ("c", 20.9)], ref) == 0
    assert judge.rows_missing([("a", 12.0), ("b", 10.1), ("c", 20.0)], ref) == 0.5
    assert judge.frames_missing(list("abcxd"), list("abcd")) == 0
    assert judge.frames_missing(list("abd"), list("abcd")) == 0.25
    assert judge.frames_missing(list("ab") + ["z"] * 30 + ["c"], list("abc")) == pytest.approx(1 / 3)


def test_rows_shown_live_have_to_be_the_finished_rows():
    res, _ = _decoded()
    keys = ("time", "depth", "temperature", "conductivity", "salinity")
    shown = [{k: getattr(res, k)[i] for k in keys} for i in range(30)]
    assert judge.streamed_wrong(shown, res) == 0
    shown[7] = dict(shown[7], salinity=shown[7]["salinity"] + 0.01)
    assert judge.streamed_wrong(shown, res) == 1
    assert judge.streamed_wrong(shown[:7] + shown[8:], res) == 22  # a row left out
    assert judge.streamed_wrong([{k: 1.0 for k in keys}] * 41, res) == 41


def test_verdict_sums_counts_and_takes_the_worst_gap():
    limits = {"rows_wrong": 0, "rows_missing": 0.01, "reports_missing": 0}
    ok, table, failed = judge.verdict(
        [{"rows_wrong": 0, "rows_missing": 0.005, "reports_missing": 0},
         {"rows_wrong": 0, "rows_missing": 0.002, "reports_missing": 0}], limits)
    assert ok and failed == 0 and table["rows_missing"] == {"value": 0.005, "limit": 0.01}
    ok, table, failed = judge.verdict(
        [{"rows_wrong": 2, "rows_missing": 0.0, "reports_missing": 0}, {"reports_missing": 1}],
        limits)
    assert not ok and failed == 2 and table["rows_wrong"]["value"] == 2
    assert not judge.verdict([], limits)[0]
