"""The port's spans (``utils.profiling``), on the CPU.

* a monolithic and a segmented ``decode_wav`` open each span under the
  span it belongs to, the stages that were there before under their names
  and counts, no span inside one of its own name; a warm decode opens no
  ``program.*`` span;
* ``programs.cached`` and ``Program.run`` open ``program.build`` and
  ``program.eager`` once for a new shape and nothing on a warm call; a
  second program of a kind past ``MAX_PROGRAMS`` opens ``program.evict``;
* ``dispatch_batch`` over a mesh opens ``mesh.pad`` and a ``mesh.run`` a
  run, and without one neither;
* a decode given no timer builds no ``StageTimer`` and leaves none installed;
* a decode with a ``StageTimer`` inside ``device_trace`` leaves its spans as
  named ranges in the Chrome trace; ``StageTimer.report`` indents a stage
  under the one it was opened in, and counts every stage that threads open
  at once.
"""

import collections
import contextlib
import json
import threading

import numpy as np
import pytest
import torch

from axctdprocessor_tpu_torch.models import engine, programs, simulator
from axctdprocessor_tpu_torch.utils import profiling

torch.set_num_threads(2)


class Opened:
    """A timer that records (name, the stage open around it) of every stage
    opened, per thread."""

    def __init__(self):
        self.opened: list[tuple[str, str | None]] = []
        self._open = threading.local()

    @contextlib.contextmanager
    def stage(self, name):
        stack = self._open.__dict__.setdefault("stack", [])
        self.opened.append((name, stack[-1] if stack else None))
        stack.append(name)
        try:
            yield
        finally:
            stack.pop()

    def as_dict(self):
        return {}

    def counts(self):
        return collections.Counter(name for name, _ in self.opened)


@pytest.fixture(scope="module")
def wav(tmp_path_factory):
    """A 40 s drop whose profile starts at 33 s (a decode reaches status 2)."""
    spec = simulator.SimSpec(duration=40.0, profile_start=33.0, seed=3)
    pcm, _ = simulator.synthesize(spec)
    path = str(tmp_path_factory.mktemp("spans") / "drop.wav")
    simulator.write_wav(path, pcm, spec.fs)
    return path


@pytest.fixture
def empty_cache():
    programs.clear()
    yield
    programs.clear()


def _decode(wav, mode, timer):
    """The benchmark's drop client: the decode inside a span of its own."""
    with timer.stage("decode_wav"):
        return engine.decode_wav(wav, device="cpu", mode=mode, timer=timer)


COMMON = {("read_wav", "decode_wav"), ("fetch", "decode_wav"), ("device_wait", "fetch"),
          ("host_finish", "decode_wav"), ("convert", "host_finish"),
          ("qc", "host_finish"), ("profile_rows", "host_finish"),
          ("pin_upload", "build_upload")}
COLD = {  # a new shape's decode: the spans beside COMMON, with their parents
    "monolithic": {("host_encode_stats", "decode_wav"), ("build_upload", "decode_wav"),
                   ("program_lookup", "build_upload"), ("program.build", "program_lookup"),
                   ("program.eager", "decode_wav")},
    # the int16 drop staged on the device whole, its statistics taken there
    "segmented": {("stage_device", "decode_wav"), ("build_upload", "stage_device"),
                  ("host_encode_stats", "stage_device"), ("program_lookup", "decode_wav"),
                  ("program.build", "program_lookup"), ("dispatch_loop", "decode_wav"),
                  ("assemble_dispatch", "decode_wav"), ("program.eager", "dispatch_loop"),
                  ("program.eager", "assemble_dispatch")},
}
STAGES = {  # the stages there before these spans, with their counts a decode
    "monolithic": {"host_encode_stats": 1, "build_upload": 1, "fetch": 1, "host_finish": 1},
    "segmented": {"host_encode_stats": 1, "build_upload": 1, "dispatch_loop": 1,
                  "assemble_dispatch": 1, "fetch": 1, "host_finish": 1},
}


@pytest.mark.parametrize("mode", ["monolithic", "segmented"])
def test_decode_opens_each_span_under_its_parent(wav, mode, empty_cache):
    cold, warm = Opened(), Opened()
    res = _decode(wav, mode, cold)
    assert res.status == 2 and len(res.time) > 100
    assert _decode(wav, mode, warm).time == res.time
    assert set(cold.opened) == {("decode_wav", None)} | COMMON | COLD[mode]
    program_spans = {pair for pair in COLD[mode] if pair[0].startswith("program.")}
    assert set(warm.opened) == set(cold.opened) - program_spans
    for timer in (cold, warm):
        assert all(name != parent for name, parent in timer.opened)
        counts = timer.counts()
        assert {k: counts[k] for k in STAGES[mode]} == STAGES[mode]
        assert counts["convert"] == counts["read_wav"] == counts["device_wait"] == 1
        assert not any(name.startswith(" ") for name in counts)


def test_program_build_and_eager_once_for_a_new_shape(empty_cache):
    timer = Opened()

    def build():
        return programs.Program(lambda x: x * 2, (torch.zeros(3),), "cpu")

    with profiling.installed(timer):
        for _ in range(3):
            out = programs.cached(("spans", 3), build)(np.ones(3, np.float32))
            assert torch.equal(out, torch.full((3,), 2.0))
    assert timer.opened == [("program.build", None), ("pin_upload", None),
                            ("program.eager", None), ("pin_upload", None),
                            ("pin_upload", None)]


def test_a_kind_mate_past_the_bound_opens_program_evict(empty_cache, monkeypatch):
    monkeypatch.setattr(programs, "MAX_PROGRAMS", 1)
    timer = Opened()
    made = []

    def build():
        made.append(programs.Program(lambda x: x + 1, (torch.zeros(2),), "cpu"))
        return made[-1]

    with profiling.installed(timer):
        programs.cached(("spans", 1), build)
        assert timer.counts()["program.evict"] == 0
        programs.cached(("spans", 2), build)
    assert timer.counts() == {"program.build": 2, "program.evict": 1}
    assert made[0].forward is None and programs.programs() == [made[1]]


def test_mesh_spans_open_under_a_mesh_alone(empty_cache):
    """``dispatch_batch`` of three rows over ``dp`` 2 (padded to four):
    ``mesh.pad`` once and ``mesh.run`` once a run, each run's lookup inside
    its ``mesh.run``; the same batch without a mesh opens neither."""
    from axctdprocessor_tpu_torch.parallel import batch
    from axctdprocessor_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(0)
    pcms = rng.integers(-3000, 3000, (3, 16 * 44100)).astype(np.int16)
    meshed, plain = Opened(), Opened()
    with profiling.installed(meshed):
        batch.dispatch_batch(pcms, 44100, mesh=make_mesh({"dp": 2}, ["cpu"] * 2))
    counts = meshed.counts()
    assert counts["mesh.pad"] == 1 and counts["mesh.run"] == 2
    assert {parent for name, parent in meshed.opened if name == "program_lookup"} == {"mesh.run"}
    with profiling.installed(plain):
        batch.dispatch_batch(pcms, 44100, device="cpu")
    assert plain.counts()["program_lookup"] == 1
    assert not any(name.startswith("mesh.") for name, _ in plain.opened)


@pytest.mark.parametrize("mode", ["monolithic", "segmented"])
def test_decode_without_a_timer_builds_none(wav, mode, monkeypatch):
    def refuse(self):
        raise AssertionError("a StageTimer was built")

    monkeypatch.setattr(profiling.StageTimer, "__init__", refuse)
    res = engine.decode_wav(wav, device="cpu", mode=mode)
    assert res.status == 2
    assert profiling.current() is profiling.NO_TIMER
    assert profiling.span("fetch") is profiling.NO_SPAN


def test_installed_timer_is_reset_and_inherited():
    outer, inner = Opened(), Opened()
    with profiling.installed(outer) as t:
        assert t is outer
        with profiling.installed(None) as t:  # an entry point given none
            assert t is outer
            with profiling.span("a"):
                pass
        with profiling.installed(inner):
            with profiling.span("b"):
                pass
        with profiling.span("c"):
            pass
    assert outer.opened == [("a", None), ("c", None)] and inner.opened == [("b", None)]
    assert profiling.current() is profiling.NO_TIMER


def test_device_trace_holds_the_program_spans(wav, tmp_path):
    timer = profiling.StageTimer()
    with profiling.device_trace(str(tmp_path)):
        res = engine.decode_wav(wav, device="cpu", mode="monolithic", timer=timer)
    assert res.status == 2
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events if e.get("ph") == "X"}
    assert {"read_wav", "build_upload", "fetch", "host_finish", "convert"} <= names
    # outside a trace no range is opened
    assert profiling._tracing is False


def test_stage_timer_report_nests_by_first_opening():
    timer = profiling.StageTimer()
    for _ in range(2):
        with timer.stage("fetch"):
            with timer.stage("device_wait"):
                pass
        with timer.stage("host_finish"):
            with timer.stage("convert"):
                pass
    lines = timer.report().splitlines()
    assert len(lines) == 4 and all(line.rstrip().endswith("x2") for line in lines)
    depth = {line.split()[0]: len(line) - len(line.lstrip()) for line in lines}
    assert depth == {"fetch": 0, "device_wait": 2, "host_finish": 0, "convert": 2}
    assert lines.index(next(x for x in lines if "device_wait" in x)) == \
        lines.index(next(x for x in lines if x.startswith("fetch"))) + 1
    assert timer.parents == {"fetch": None, "device_wait": "fetch", "host_finish": None,
                             "convert": "host_finish"}
    assert set(timer.as_dict()) == set(depth)


def test_stage_timer_counts_every_stage_across_threads():
    """Threads opening one stage at once (the archive runner's readers) lose
    no count and no time: more threads than cores, the interpreter switching
    threads as often as it can."""
    import os
    import sys

    timer = profiling.StageTimer()
    n_threads, n_stages = 2 * (os.cpu_count() or 1) + 2, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def open_stages():
            for _ in range(n_stages):
                with timer.stage("io.read_file"):
                    pass

        threads = [threading.Thread(target=open_stages) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert timer.counts["io.read_file"] == n_threads * n_stages
    assert timer.parents["io.read_file"] is None and timer.totals["io.read_file"] > 0
