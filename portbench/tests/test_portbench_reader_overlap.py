"""The reader of ``reader_overlap.archive``, on synthetic readings: the
seconds of the files' reads over those of the batches' loads, and nothing
for a program whose readers open no ``io.read_file`` span."""

import pytest

from portbench.core import registry
from portbench.core.harness import Reading, Step

NAME = "reader_overlap.archive"


def _reading(spans_of_each, batches=3):
    steps = [Step(latency_s=1.0, audio_s=60.0, spans=dict(spans), batches=batches)
             for spans in spans_of_each]
    return Reading(setup_s=1.0, window_s=1.0, steps=steps)


def _read(reading):
    return registry.metric(NAME).read(reading)


def test_the_reader_is_the_benchmarks_entry():
    entry = {m["name"]: m for m in registry.benchmark()["per_layer"]}[NAME]
    assert entry["workloads"] == ["archive.mix", "archive.batch64", "archive.dp4"]
    assert (entry["unit"], entry["better"], entry["moves"]) == ("x", "higher", "archive_rtf")
    assert entry["layer"] == "parallel/archive readers"


@pytest.mark.parametrize("files,loads,want", [
    ((0.7, 0.7), (0.1, 0.1), 7.0),      # seven files read at once in each pass
    ((0.3, 0.9), (0.3, 0.3), 2.0),      # one pass in turn, one three at once
    ((0.2,), (0.2,), 1.0),              # one file a batch
])
def test_overlap_is_the_files_seconds_over_the_loads(files, loads, want):
    steps = [{"io.read_file": f, "io.read_wavs": w, "io.wait_reader": 0.05,
              "reprocess_corpus": 2.0} for f, w in zip(files, loads)]
    assert _read(_reading(steps)) == pytest.approx(want)


def test_reads_nothing_without_the_file_span():
    """The parent's readers open io.read_wavs alone: the metric is left out,
    never 0 and never an error."""
    before = [{"io.read_wavs": 0.2, "io.wait_reader": 0.05}] * 2
    assert _read(_reading(before)) is None
    assert _read(_reading([{"io.read_file": 0.2}])) is None
    assert _read(_reading([{"io.read_file": 0.0, "io.read_wavs": 0.0}])) is None
    assert _read(Reading(setup_s=1.0, window_s=1.0, steps=[])) is None
