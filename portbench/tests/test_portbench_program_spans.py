"""The readers of the program's finer spans (read, upload, wait, finish,
convert, the program cache; the archive runner's own work), on synthetic
readings: each reads its spans, per drop or per batch; the program cache's
reads 0.0 in a window that rebuilt nothing, and every one reads nothing for
a program without these spans."""

import pytest

from portbench.core import registry
from portbench.core.harness import Reading, Step

DROP = {"wav_read_ms.drop": ["read_wav"], "pin_upload_ms.drop": ["pin_upload"],
        "device_wait_ms.drop": ["device_wait"], "finish_result_ms.drop": ["host_finish"],
        "convert_ms.drop": ["convert"],
        "program_build_ms.drop": ["program.build", "program.eager", "program.capture",
                                  "program.evict"]}
ARCHIVE = {"reader_wait_ms.archive": ["io.wait_reader"], "pad_ms.archive": ["pad_batch"],
           "device_wait_ms.archive": ["device_wait"],
           "finish_result_ms.archive": ["host_finish"],
           "program_build_ms.archive": ["program.build", "program.eager", "program.capture",
                                       "program.evict"]}


def _reading(spans_of_each, batches=0):
    steps = [Step(latency_s=0.1, audio_s=60.0, spans=dict(spans), batches=batches)
             for spans in spans_of_each]
    return Reading(setup_s=1.0, window_s=1.0, steps=steps)


def _read(name, reading):
    return registry.metric(name).read(reading)


def test_the_new_readers_are_the_benchmarks_entries():
    bench = registry.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in DROP:
        assert entries[name]["workloads"] == ["drop600.auto", "drop240.auto"], name
        assert entries[name]["moves"] == "drop_rtf" and entries[name]["unit"] == "ms"
    for name in ARCHIVE:
        assert entries[name]["workloads"] == ["archive.mix"], name
        assert entries[name]["moves"] == "archive_rtf" and entries[name]["unit"] == "ms/batch"


@pytest.mark.parametrize("name", sorted(DROP))
def test_drop_reader_reads_its_spans_per_drop(name):
    spans = DROP[name]
    # two drops: 3 ms and 5 ms in each named span, other spans beside them
    steps = [{**{n: 0.003 for n in spans}, "device_wait": 0.003, "write_report": 0.5},
             {**{n: 0.005 for n in spans}, "device_wait": 0.005, "decode_wav": 0.9}]
    want = 1e3 * (0.003 + 0.005) * len(spans) / 2
    assert _read(name, _reading(steps)) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(ARCHIVE))
def test_archive_reader_reads_its_spans_per_batch(name):
    spans = ARCHIVE[name]
    steps = [{**{n: 0.010 for n in spans}, "device_wait": 0.010, "reprocess_corpus": 2.0},
             {**{n: 0.030 for n in spans}, "device_wait": 0.030}]
    want = 1e3 * (0.010 + 0.030) * len(spans) / 8  # 4 batches a pass
    assert _read(name, _reading(steps, batches=4)) == pytest.approx(want)


@pytest.mark.parametrize("name,batches", [("program_build_ms.drop", 0),
                                          ("program_build_ms.archive", 4)])
def test_program_build_reads_zero_in_a_warm_window(name, batches):
    warm = [{"device_wait": 0.002, "host_finish": 0.01}] * 3
    assert _read(name, _reading(warm, batches)) == 0.0


@pytest.mark.parametrize("name", sorted(DROP) + sorted(ARCHIVE))
def test_reader_reads_nothing_without_the_programs_spans(name):
    """A program without these spans (the parent of this benchmark's
    readers): its metric is left out, never 0 and never an error."""
    before = [{"decode_wav": 0.05, "fetch": 0.01, "build_upload": 0.01}] * 2
    assert _read(name, _reading(before, batches=4)) is None
    assert _read(name, Reading(setup_s=1.0, window_s=1.0, steps=[])) is None
