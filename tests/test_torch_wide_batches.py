"""The archive at batches wider than one minute and larger than the
corpus, and the program cache's counters, on the CPU.

* A small mixed corpus (40 s and 70 s drops at 44.1 kHz, a 40 s drop at
  88.2 kHz): at ``batch_size=8`` the 44.1 kHz drops share one batch 120 s
  wide; every report equals, byte for byte, its report at ``batch_size=2``
  and the file decoded alone by ``decode_wav``.
* ``engine.apply_response`` in chunks of rows (the card's path for batches
  above 8 rows) equals the row-by-row path.
* ``programs.cache_stats`` counts builds, captures and evictions and the
  bytes held, on stand-in programs under a budget set by hand (a capture's
  CUDA calls stood in for as well).
* ``reprocess_corpus`` writes the counts its own call caused into its
  manifest, under ``program_cache``.
"""

import contextlib
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from axctdprocessor_tpu_torch.models import engine, programs, simulator
from axctdprocessor_tpu_torch.parallel.archive import reprocess_corpus
from axctdprocessor_tpu_torch.utils.config import resolve_settings
from axctdprocessor_tpu_torch.utils.report import write_report

torch.set_num_threads(2)

DROPS = {"m0": (40.0, 44100), "m1": (70.0, 44100), "m2": (40.0, 44100), "m3": (40.0, 88200)}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("mixed")
    paths = []
    for i, (name, (duration, fs)) in enumerate(DROPS.items()):
        pcm, _ = simulator.synthesize(simulator.SimSpec(duration=duration, fs=fs,
                                                        profile_start=33.0, seed=60 + i))
        path = str(d / f"{name}.wav")
        wavfile.write(path, fs, np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16))
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """The corpus at batch sizes 8 and 2 (and 8 again, warm), from an empty
    cache; each file decoded alone, its report written as the runner writes
    it.  Returns ({run: {name: report bytes}}, {run: manifest})."""
    programs.clear()
    reports, manifests = {}, {}
    for run, size in (("b8", 8), ("b2", 2), ("b8_warm", 8)):
        out = str(tmp_path_factory.mktemp(run))
        manifests[run] = reprocess_corpus(corpus, out, batch_size=size, device="cpu",
                                          resume=False)
        reports[run] = {n: open(os.path.join(out, n + ".txt"), "rb").read() for n in DROPS}
    cfg = resolve_settings(None, compat="strict")
    echo = {"minR400": cfg.min_r400, "mindR7500": cfg.min_dr7500, "deadfreq": cfg.dead_freq,
            "pointsperloop": 100000, "triggerrange": list(cfg.trigger_range)}
    alone = str(tmp_path_factory.mktemp("alone"))
    reports["alone"] = {}
    for path in corpus:
        name = os.path.splitext(os.path.basename(path))[0]
        res = engine.decode_wav(path, device="cpu")
        write_report(os.path.join(alone, name + ".txt"), res, path, [0, -1], echo, cfg)
        reports["alone"][name] = open(os.path.join(alone, name + ".txt"), "rb").read()
    programs.clear()
    return reports, manifests


@pytest.mark.parametrize("name", sorted(DROPS))
def test_wide_batch_reports_equal_small_batches_and_each_drop_alone(runs, name):
    reports, _ = runs
    wide = reports["b8"][name]
    assert wide.count(b"\n") > 150 and b"Probe Serial: 00123456" in wide
    assert wide == reports["b2"][name]
    assert wide == reports["alone"][name]
    assert wide == reports["b8_warm"][name]


def test_manifest_holds_the_cache_counts_of_its_own_call(runs):
    """At 8: a 3-row 120 s int16 batch and a 1-row float batch, two builds;
    at 2: the 2-row and 1-row int16 batches are new, the float batch a hit;
    at 8 again: nothing built.  The CPU captures nothing and holds no bytes."""
    _, manifests = runs
    assert manifests["b8"]["program_cache"] == {"builds": 2, "captures": 0, "evictions": 0,
                                                "held_bytes": 0}
    assert manifests["b2"]["program_cache"]["builds"] == 2
    assert manifests["b8_warm"]["program_cache"] == {"builds": 0, "captures": 0,
                                                     "evictions": 0, "held_bytes": 0}


def test_manifest_counts_the_evictions_of_its_call(corpus, tmp_path, monkeypatch):
    """One program a kind: the second shape of a pass evicts the first, so a
    second pass builds both again and evicts twice."""
    programs.clear()
    monkeypatch.setattr(programs, "MAX_PROGRAMS", 1)
    paths = corpus[:3]  # the 44.1 kHz drops: batches [m0, m2] and [m1] at 2
    got = [reprocess_corpus(paths, str(tmp_path / f"p{k}"), batch_size=2, device="cpu",
                            resume=False)["program_cache"] for k in range(2)]
    programs.clear()
    assert got == [{"builds": 2, "captures": 0, "evictions": 1, "held_bytes": 0},
                   {"builds": 2, "captures": 0, "evictions": 2, "held_bytes": 0}]


@pytest.mark.parametrize("rows,per_call", [(7, 3), (7, 2), (9, 8), (7, 7), (7, 8)])
def test_apply_response_in_chunks_equals_row_by_row(rows, per_call, monkeypatch):
    """Chunks of `per_call` rows (the last one shorter) into one output, as
    the card runs a batch of more than 8 rows, against each row as a 1-D
    call (the CPU's rule); a batch of at most `per_call` rows is one call."""
    rng = np.random.default_rng(rows * 10 + per_call)
    n, nfft = 3000, 4096
    x = torch.from_numpy(rng.standard_normal((rows, n)).astype(np.float32))
    cfg = resolve_settings(None, compat="strict")
    dims = engine.EngineDims.for_waveform(n, 44100.0, cfg.bitrate,
                                          engine.probe_window(cfg, 44100.0))
    sos = torch.from_numpy(engine.engine_tables(cfg, 44100.0, dims)["sos"])
    response = engine.sos_response_on_device(sos, nfft)
    assert engine.FFT_ROWS_PER_CALL["cpu"] == 1
    want = engine.apply_response(x, response, nfft)
    for r in range(rows):
        assert torch.equal(want[r], torch.fft.irfft(torch.fft.rfft(x[r], nfft) * response, nfft))
    monkeypatch.setitem(engine.FFT_ROWS_PER_CALL, "cpu", per_call)
    calls = []
    real = engine._response_rows
    monkeypatch.setattr(engine, "_response_rows",
                        lambda v, *a: calls.append(tuple(v.shape)) or real(v, *a))
    got = engine.apply_response(x, response, nfft)
    assert got.shape == (rows, nfft) and got.dtype == x.dtype
    assert calls == [(min(per_call, rows - i), n) for i in range(0, rows, per_call)]
    # pocketfft rounds a row of a multi-row call otherwise: within float32 rounding
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    if per_call >= rows:
        assert torch.equal(got, real(x, response, nfft))


@pytest.fixture
def stand_in_captures(monkeypatch):
    """``Program.capture`` on the CPU: the CUDA graph, its stream and its
    pool stood in for; a capture's pool is the bytes set on the program as
    ``next_pool``."""
    class Graph:
        def replay(self):
            pass

        def reset(self):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph", lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(programs, "_pool_bytes", lambda graph: graph.owner.next_pool)
    monkeypatch.setattr(programs, "_launch_records", lambda deltas: {})
    monkeypatch.setattr(programs, "pool_budget", lambda device: 100)
    programs.clear()
    yield
    programs.clear()


def _stand_in(pool: int) -> programs.Program:
    program = programs.Program(lambda x: x * 2, (torch.zeros(3),), "cpu")
    program.next_pool = pool
    return program


def _capture(program):
    graph = torch.cuda.CUDAGraph()
    graph.owner = program
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "CUDAGraph", lambda: graph)
        program.capture()


def test_cache_stats_count_builds_captures_and_evictions(stand_in_captures):
    """Stand-ins under a budget of 100 bytes: three builds; captures of 40
    and 30 bytes fit; one of 50 more makes 120 held (the peak) and evicts
    the oldest, which is built again; clear() evicts nothing in the
    counts."""
    cpu = torch.device("cpu")
    before = programs.cache_stats(cpu)
    made = {k: _stand_in(pool) for k, pool in (("a", 40), ("b", 30), ("c", 50))}
    for k in "abc":
        programs.cached(k, lambda k=k: made[k])
    _capture(made["a"])
    _capture(made["b"])
    mid = programs.cache_stats(cpu)
    assert programs.held_bytes(cpu) == 70
    _capture(made["c"])
    assert made["a"].forward is None and programs.programs() == [made["b"], made["c"]]
    programs.cached("a", lambda: _stand_in(0))
    after = programs.cache_stats(cpu)
    delta = {k: after[k] - before[k] for k in ("builds", "captures", "evictions")}
    assert delta == {"builds": 4, "captures": 3, "evictions": 1}
    assert {k: mid[k] - before[k] for k in ("builds", "captures", "evictions")} == \
        {"builds": 3, "captures": 2, "evictions": 0}
    assert after["held_bytes"] == 80 and after["peak_held_bytes"] >= 120
    programs.clear()
    assert programs.cache_stats(cpu)["evictions"] == after["evictions"]
    assert programs.cache_stats(cpu)["held_bytes"] == 0
