"""The rest of a run on the CPU (past run.py's look for a card), at a size a
test can hold: sound runs come out correct, and each fault a cell can have,
planted under the timed path, comes out not correct.  The faults: an answer
altered where it is produced (every drop's; one drop's in the middle of the
window; a stream's; the rows a live display is shown; the profile's deep
rows lost; the profile start moved), and half of each archive batch's
answers left out."""

import os

import pytest

from portbench.core import harness

DROPS = {"drops": [{"duration_s": 50.0, "fs": 44100, "profile_start_s": 33.0},
                   {"duration_s": 46.0, "fs": 44100, "profile_start_s": 34.0}],
         "warmup_rounds": 1}
ARCHIVE = {"kinds": [{"duration_s": 45.0, "fs": 44100, "count": 3, "profile_start_s": [33.0],
                      "noise_int16": 300},
                     {"duration_s": 40.0, "fs": 88200, "count": 1, "profile_start_s": [33.0],
                      "noise_int16": 300}], "warmup_passes": 1}
STREAM = {"drops": [{"duration_s": 42.0, "fs": 44100, "profile_start_s": 33.0}],
          "max_duration_s": 42.0, "warmup_blocks": 3}
# rows shown live and a mid-drop snapshot with rows: its middle past a segment and the profile start
STREAM_LONG = {"drops": [{"duration_s": 75.0, "fs": 44100, "profile_start_s": 33.0}],
               "max_duration_s": 75.0, "warmup_blocks": 3}
SEED = 2**31 + 99


# the live-stream cell is out of BENCHMARK.json until its shown rows are the finished rows
# (PERF.md section 7); its client, traffic and limits stay, and are tested here
STREAM_CELL = {"name": "stream600.live", "config": "drop-44k1", "traffic": "stream600",
               "chips": 1, "why": "a live receiver"}


@pytest.fixture(autouse=True)
def _with_the_stream_cell(monkeypatch):
    from portbench.core import registry

    bench = registry.benchmark()
    bench = dict(bench, workloads=bench["workloads"] + [STREAM_CELL])
    monkeypatch.setattr(registry, "benchmark", lambda root=registry.ROOT: bench)


def _run(workload, override, seconds=None):
    # long enough that the window finishes a stream's drop on the CPU
    seconds = seconds or (25.0 if override is STREAM_LONG else
                          8.0 if workload.startswith("stream") else 2.0)
    return harness.run(workload, SEED, seconds, False, device="cpu", traffic_override=override)


def _warm_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)


@pytest.mark.parametrize("workload,override", [("drop600.auto", DROPS),
                                               ("archive.mix", ARCHIVE),
                                               ("stream600.live", STREAM),
                                               ("stream600.live", STREAM_LONG)])
def test_sound_runs_are_correct_and_leave_nothing_behind(workload, override, tmp_path,
                                                         monkeypatch, capsys):
    _warm_tmp(tmp_path, monkeypatch)
    line = _run(workload, override)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    assert os.listdir(tmp_path) == []  # every scratch file under TMPDIR is gone
    assert capsys.readouterr().out == ""  # progress goes to standard error


def _alter(result, k=5):
    if len(result.temperature) > k:
        result.temperature[k] = result.temperature[k] + 1.0
    return result


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from axctdprocessor_tpu_torch.models import engine

    attach = engine.attach_profile
    monkeypatch.setattr(engine, "attach_profile", lambda *a, **k: _alter(attach(*a, **k)))
    line = _run("drop600.auto", DROPS)
    assert line["correct"] is False and line["checks"]["rows_wrong"]["value"] > 0


def test_one_answer_altered_in_the_middle_of_the_window(monkeypatch):
    from axctdprocessor_tpu_torch.models import engine

    attach, calls = engine.attach_profile, []

    def once(*a, **k):
        calls.append(1)
        res = attach(*a, **k)
        return _alter(res) if len(calls) == 5 else res  # 2 warm-up, 2 checked, then this

    monkeypatch.setattr(engine, "attach_profile", once)
    line = _run("drop600.auto", DROPS, seconds=4.0)
    assert line["attempted"] >= 5
    assert line["correct"] is False and line["checks"]["reports_unstable"]["value"] == 1


def test_half_of_each_archive_batch_left_out(monkeypatch):
    from axctdprocessor_tpu_torch.parallel import archive

    finish = archive.finish_dispatched
    monkeypatch.setattr(archive, "finish_dispatched",
                        lambda *a, **k: (lambda r: r[: max(len(r) // 2, 1)])(finish(*a, **k)))
    line = _run("archive.mix", ARCHIVE)
    assert line["correct"] is False and line["checks"]["reports_missing"]["value"] > 0


def test_a_stream_answer_altered_where_it_is_produced(monkeypatch):
    from axctdprocessor_tpu_torch.models import engine

    attach = engine.attach_profile
    monkeypatch.setattr(engine, "attach_profile", lambda *a, **k: _alter(attach(*a, **k)))
    line = _run("stream600.live", STREAM)
    assert line["correct"] is False and line["checks"]["rows_wrong"]["value"] > 0


def test_the_deep_rows_lost_where_they_are_produced(monkeypatch):
    from axctdprocessor_tpu_torch.models import engine

    attach = engine.attach_profile

    def lose_tail(*a, **k):
        res = attach(*a, **k)
        n = int(len(res.time) * 0.75)
        for name in ("time", "depth", "temperature", "conductivity", "salinity", "r400",
                     "r7500", "hexframes_qc"):
            setattr(res, name, getattr(res, name)[:n])
        return res

    monkeypatch.setattr(engine, "attach_profile", lose_tail)
    line = _run("drop600.auto", DROPS)
    assert line["correct"] is False and line["checks"]["rows_missing"]["value"] > 0.2


def test_the_profile_start_moved_where_it_is_produced(monkeypatch):
    from axctdprocessor_tpu_torch.models import engine

    attach = engine.attach_profile

    def late(result, out, cfg, fs, profstart, live):
        profstart += int(0.2 * fs)
        result.profstartind = profstart
        return attach(result, out, cfg, fs, profstart, live)

    monkeypatch.setattr(engine, "attach_profile", late)
    line = _run("drop600.auto", DROPS)
    assert line["correct"] is False and line["checks"]["trigger_gap_s"]["value"] > 0.15
    assert line["checks"]["rows_wrong"]["value"] == 0  # its rows follow the moved start


def test_rows_shown_live_altered_where_they_are_produced(monkeypatch):
    from axctdprocessor_tpu_torch.models import stream_device

    latest = stream_device.DeviceStreamDecoder.latest_rows

    def altered(self):
        rows = latest(self)
        return [dict(r, temperature=r["temperature"] + 0.01) for r in rows]

    monkeypatch.setattr(stream_device.DeviceStreamDecoder, "latest_rows", altered)
    line = _run("stream600.live", STREAM_LONG)
    assert line["attempted"] >= 2  # a finished drop (its shown rows) and a snapshot
    assert line["correct"] is False and line["checks"]["streamed_wrong"]["value"] > 0


def test_a_stream_snapshot_altered_where_it_is_produced(monkeypatch):
    from axctdprocessor_tpu_torch.models import stream_device

    results = stream_device.DeviceStreamDecoder.results

    def altered(self):  # what a snapshot shows, not the rows: only the snapshot's judge sees it
        res = results(self)
        res.metadata["serial_no"] = "0badf00d"
        return res

    monkeypatch.setattr(stream_device.DeviceStreamDecoder, "results", altered)
    line = _run("stream600.live", STREAM_LONG)
    assert line["correct"] is False and line["checks"]["header_wrong"]["value"] > 0
    assert line["checks"]["streamed_wrong"]["value"] == 0
