"""The four-card archive cell (``archive.dp4``) on the CPU: the cell run over
a mesh of the CPU four times, at a size a test can hold, comes out correct
with every batch cut into four runs; each of its new readers on stand-in
readings, and nothing read where the program has none of what it reads."""

import os

import pytest
import torch

from portbench.core import registry, trace
from portbench.core.harness import Reading, Step

# 5 files of 45 s (one batch of 5 rows, padded to 8: four runs of 2) and one at 88.2 kHz (a
# float batch of one row, padded to 4: four runs of 1)
ARCHIVE = {"kinds": [{"duration_s": 45.0, "fs": 44100, "count": 5, "profile_start_s": [33.0],
                      "noise_int16": 300},
                     {"duration_s": 40.0, "fs": 88200, "count": 1, "profile_start_s": [33.0],
                      "noise_int16": 300}], "warmup_passes": 1}
NEW = ("mesh_pad_ms.dp4", "dispatch_ms.dp4", "card_idle_share.dp4", "cache_gib.dp4")
SEED = 2**31 + 99


def _warm_tmp(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)


def test_the_cell_over_the_cpu_four_times_is_correct(tmp_path, monkeypatch, capsys):
    from axctdprocessor_tpu_torch.parallel import batch
    from portbench.core import harness

    _warm_tmp(tmp_path, monkeypatch)
    runs = []
    dispatch = batch._dispatch_run
    monkeypatch.setattr(batch, "_dispatch_run",
                        lambda pcms, *a: runs.append((len(pcms), a[-1])) or dispatch(pcms, *a))
    line = harness.run("archive.dp4", SEED, 2.0, False, device="cpu", traffic_override=ARCHIVE)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 6
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())
    assert set(line["metrics"]) == {"archive_rtf", "setup_s"}
    # two batches a pass (5 rows padded to 8, the float row padded to 4), four runs each
    assert runs[:8] == [(2, torch.device("cpu"))] * 4 + [(1, torch.device("cpu"))] * 4
    assert os.listdir(tmp_path) == []
    assert capsys.readouterr().out == ""


def test_the_cell_and_its_metrics_are_the_benchmarks_entries():
    bench = registry.benchmark()
    cell = registry.workload(bench, "archive.dp4")
    assert cell["chips"] == 4 and cell["config"] == "archive-44k1-dp4"
    config = registry.config(cell["config"])
    assert config["runner"] == {"batch_size": 32, "dp": 4}
    mix, mesh = registry.traffic("archive-mix128"), registry.traffic(cell["traffic"])
    assert mesh["client"] == "corpus_mesh"
    assert {k: v for k, v in mesh.items() if k not in ("client", "why")} == \
        {k: v for k, v in mix.items() if k not in ("client", "why")}
    assert registry.cell("archive.dp4") == registry.cell("archive.mix")
    entries = {m["name"]: m for m in bench["per_layer"] + bench["end_to_end"]}
    for name in NEW:
        assert entries[name]["workloads"] == ["archive.dp4"], name
        assert entries[name]["moves"] == "archive_rtf", name
    for name in ("archive_rtf", "program_build_ms.archive"):
        assert entries[name]["workloads"][-1] == "archive.dp4", name
    got = {m["name"] for m in registry.metrics_of(bench, "archive.dp4", True)}
    assert got == set(NEW) | {"program_build_ms.archive"}


def _reading(spans_of_each, batches, tr=None):
    steps = [Step(latency_s=0.5, audio_s=600.0, spans=dict(s), batches=batches)
             for s in spans_of_each]
    return Reading(setup_s=1.0, window_s=1.0, steps=steps, trace=tr)


def _read(name, reading):
    return registry.metric(name).read(reading)


@pytest.mark.parametrize("name,span", [("mesh_pad_ms.dp4", "mesh.pad"),
                                       ("dispatch_ms.dp4", "mesh.run")])
def test_mesh_readers_read_their_span_per_batch(name, span):
    """Two passes of 5 batches: the span's seconds over the 10 batches (a
    batch's four runs summed); nothing for a program without the span."""
    steps = [{span: 0.020, "device.dispatch_batch": 0.5}, {span: 0.030, "pad_batch": 0.1}]
    assert _read(name, _reading(steps, 5)) == pytest.approx(1e3 * 0.050 / 10)
    before = [{"device.dispatch_batch": 0.5, "device_wait": 0.01}] * 2
    assert _read(name, _reading(before, 5)) is None


def test_card_idle_share_counts_every_cards_operations_in_the_window():
    """A 10 s window over four cards: operations of 2 + 1 + 1 + 3 s inside it
    (two overlapping on one card, counted twice) and one of 4 s half
    outside: 9 busy seconds of 40, so 77.5% idle."""
    tr = trace.Trace(window=(0.0, 10.0),
                     device=[("kernel a", 1.0, 3.0), ("Memcpy DtoH", 2.0, 3.0),
                             ("kernel b", 4.0, 5.0), ("kernel c", 6.0, 9.0),
                             ("kernel d", 8.0, 12.0)],
                     host_calls={}, spans=[], units=1)
    assert _read("card_idle_share.dp4", _reading([{}], 5, tr)) == pytest.approx(77.5)
    assert _read("card_idle_share.dp4", _reading([{}], 5)) is None
    empty = trace.Trace(window=(0.0, 10.0), device=[], host_calls={}, spans=[], units=1)
    assert _read("card_idle_share.dp4", _reading([{}], 5, empty)) is None


def test_cache_gib_is_the_fullest_cards_peak(monkeypatch):
    from axctdprocessor_tpu_torch.models import programs

    peaks = {0: 3 * 2 ** 30, 1: 7 * 2 ** 29, 2: 2 ** 30, 3: 0}
    asked = []

    def stats(device):
        asked.append(device)
        return {"builds": 4, "captures": 4, "evictions": 0, "held_bytes": 0,
                "peak_held_bytes": peaks[device.index]}

    monkeypatch.setattr(programs, "cache_stats", stats)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert _read("cache_gib.dp4", _reading([{}], 5)) == 3.5
    assert asked == [torch.device("cuda", k) for k in range(4)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _read("cache_gib.dp4", _reading([{}], 5)) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delattr(programs, "cache_stats")
    assert _read("cache_gib.dp4", _reading([{}], 5)) is None
