"""The reader of ``cache_gib.archive``: nothing where the port has no
``programs.cache_stats`` (as before the cache counted), or where there is
no card; with both, the cache's most held bytes on the card in GiB."""

import torch

from axctdprocessor_tpu_torch.models import programs
from portbench.core import registry
from portbench.core.harness import Reading, Step

READING = Reading(setup_s=1.0, window_s=1.0,
                  steps=[Step(latency_s=1.0, audio_s=60.0, spans={}, batches=3)])


def _read():
    return registry.metric("cache_gib.archive").read(READING)


def test_nothing_without_cache_stats(monkeypatch):
    monkeypatch.delattr(programs, "cache_stats")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert _read() is None


def test_nothing_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _read() is None


def test_peak_held_bytes_of_the_card_in_gib(monkeypatch):
    asked = []

    def stats(device):
        asked.append(device)
        return {"builds": 3, "captures": 3, "evictions": 0, "held_bytes": 2 ** 30,
                "peak_held_bytes": 13 * 2 ** 29}

    monkeypatch.setattr(programs, "cache_stats", stats)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert _read() == 6.5
    assert asked == [torch.device("cuda", 0)]


def test_the_metric_is_the_benchmarks_entry():
    (entry,) = [m for m in registry.benchmark()["per_layer"] if m["name"] == "cache_gib.archive"]
    assert entry["unit"] == "GiB" and entry["better"] == "lower"
    assert entry["layer"] == "models/programs" and entry["moves"] == "archive_rtf"
    assert entry["workloads"] == ["archive.mix", "archive.batch64"]
