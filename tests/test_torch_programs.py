"""The port's cached decode programs (``models/programs.py``) on the CPU.

On the CPU a program runs its module eagerly over its static buffers and
returns a clone of its static output: the data flow of a CUDA-graph replay
without the graph, so the two faults a graph invites show here too: a
stale static input and a static output overwritten before it is read.

* the cache: two decodes of one bucket take one entry; another wire, rate,
  configuration of the device tables or bucket takes another, a host-only
  setting the same; a ninth key evicts the least recently used and
  releases it, and on stand-ins keyed to four cards a ninth on one card
  evicts that card's least recently used alone; on stand-in programs whose
  pools' bytes are set by hand, the byte budget evicts the least recently
  used until the pools fit, never the program just used nor a pinned one,
  and the count bound holds beside it;
* three drops of one bucket decoded in a row through the cached path: each
  packed vector equals a fresh ``FusedDecoder``'s forward bit for bit, and
  the JAX engine's (``torch_packed.assert_packed_close``, hexframes);
* ``dispatch_batch`` of two batches of one shape, interleaved (dispatch,
  dispatch, finish, finish): each equals that batch alone;
* a prestaged ``fused`` drop dispatched three times before any finish:
  three distinct tensors, each equal to the module's own forward.
"""

import numpy as np
import pytest
import torch

from axctdprocessor_tpu.models import tpu_engine as jeng
from axctdprocessor_tpu.utils.config import DecoderConfig as JaxConfig
from axctdprocessor_tpu_torch.models import engine, programs, segmented, simulator
from axctdprocessor_tpu_torch.parallel import batch
from axctdprocessor_tpu_torch.utils.config import DecoderConfig
from torch_packed import assert_packed_close

torch.set_num_threads(2)

FS = 44100


def _int16(pcm: np.ndarray) -> np.ndarray:
    return np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)


def _drop(duration: float, seed: int) -> np.ndarray:
    return _int16(simulator.synthesize(simulator.SimSpec(
        duration=duration, profile_start=20.0, seed=seed))[0])


def _noise(seconds: float, fs: int = FS) -> np.ndarray:
    return np.random.default_rng(0).integers(-3000, 3000, int(seconds * fs)).astype(np.int16)


@pytest.fixture
def packed_of(monkeypatch):
    """Records the packed vector each decode hands to ``finish_result``, in
    the port (key "port") and in the JAX engine (key "jax")."""
    seen = {"port": [], "jax": []}

    def spy(where, real):
        def finish(out, *args, **kwargs):
            seen[where].append(np.array(out, dtype=np.int32))
            return real(out, *args, **kwargs)
        return finish

    monkeypatch.setattr(engine, "finish_result", spy("port", engine.finish_result))
    monkeypatch.setattr(jeng, "finish_result", spy("jax", jeng.finish_result))
    return seen


@pytest.fixture
def empty_cache():
    programs.clear()
    yield
    programs.clear()


def test_one_bucket_takes_one_entry(empty_cache):
    engine.decode_waveform(_noise(16.0), FS, device="cpu")
    engine.decode_waveform(_noise(29.0), FS, device="cpu")  # the same 30 s bucket
    (only,) = programs.programs()
    assert only.calls == 2
    assert only.inputs[0].shape == (30 * FS,) and only.inputs[0].dtype == torch.int16
    assert only.inputs[1].shape == () and only.inputs[1].dtype == torch.int64


@pytest.mark.parametrize("what,kwargs,entries", [
    ("wire", dict(wire="int8"), 2),
    ("rate", dict(fs=22050), 2),
    ("device tables", dict(config=DecoderConfig(trigger_range=(5, 14), compat="fixed")), 2),
    ("bucket", dict(seconds=31.0), 2),
    ("host-only setting", dict(config=DecoderConfig(tlims=(-1.0, 30.0))), 1),
])
def test_other_keys_take_other_entries(empty_cache, what, kwargs, entries):
    engine.decode_waveform(_noise(16.0), FS, device="cpu")
    fs = kwargs.pop("fs", FS)
    engine.decode_waveform(_noise(kwargs.pop("seconds", 16.0), fs), fs, device="cpu",
                           **kwargs)
    assert len(programs.programs()) == entries, what
    assert [p.calls for p in programs.programs()] == ([1, 1] if entries == 2 else [2])


def test_ninth_key_evicts_the_least_recently_used(empty_cache):
    made = {}

    def build(k):
        def make():
            made[k] = programs.Program(lambda x: x * 2, (torch.zeros(3),), "cpu")
            return made[k]
        return make

    for k in range(8):
        programs.cached(("test", k), build(k))
    assert programs.cached(("test", 0), build(0)) is made[0]  # a hit: 0 is now the newest
    programs.cached(("test", 8), build(8))
    assert programs.programs() == [made[k] for k in (2, 3, 4, 5, 6, 7, 0, 8)]
    assert made[1].forward is None and made[1].inputs == ()  # released
    assert torch.equal(made[0](np.ones(3, np.float32)), torch.full((3,), 2.0))


def _stand_in(pool_bytes: int) -> programs.Program:
    program = programs.Program(lambda x: x * 2, (torch.zeros(3),), "cpu")
    program.pool_bytes = pool_bytes
    return program


def test_pools_past_the_byte_budget_evict_the_least_recently_used(empty_cache, monkeypatch):
    """A budget of 100 bytes: stand-ins of 40, 30 and 20 bytes fit; one of
    60 more evicts the oldest two (40 + 30 + 20 + 60 = 150, then 110, then
    80); a hit moves a program to the newest end; a program larger than
    the budget alone stays, the one just used, with the rest evicted."""
    monkeypatch.setattr(programs, "pool_budget", lambda device: 100)
    made = {k: _stand_in(b) for k, b in (("a", 40), ("b", 30), ("c", 20), ("d", 60),
                                         ("e", 150))}
    for k in "abc":
        assert programs.cached(k, lambda k=k: made[k]) is made[k]
    assert programs.programs() == [made[k] for k in "abc"] and programs.held_bytes() == 90
    programs.cached("d", lambda: made["d"])
    assert programs.programs() == [made["c"], made["d"]] and programs.held_bytes() == 80
    assert made["a"].forward is None and made["b"].forward is None  # released
    assert programs.cached("c", lambda: _stand_in(0)) is made["c"]  # a hit
    assert programs.programs() == [made["d"], made["c"]]
    programs.cached("e", lambda: made["e"])
    assert programs.programs() == [made["e"]] and programs.held_bytes() == 150
    assert torch.equal(made["e"](np.ones(3, np.float32)), torch.full((3,), 2.0))


def test_a_capture_past_the_budget_keeps_the_program_just_used_and_the_pinned(
        empty_cache, monkeypatch):
    """The bound enforced after a capture (here a program's bytes set as a
    capture sets them): the LRU programs go, not the one that captured nor
    one a running decode holds; beside the bytes, at most ``MAX_PROGRAMS``
    of one kind, whatever the other kinds hold."""
    monkeypatch.setattr(programs, "pool_budget", lambda device: 100)
    old, held, new = _stand_in(60), _stand_in(30), _stand_in(0)
    other = programs.cached(("other", 0), lambda: _stand_in(0))
    programs.cached(("t", "old"), lambda: old)
    programs.cached(("t", "held"), lambda: held)
    programs.cached(("t", "new"), lambda: new)
    with programs.pinned(held):
        new.pool_bytes = 50  # its capture's pool
        programs._evict(keep=new)
        assert programs.programs() == [other, held, new] and old.forward is None
        new.pool_bytes = 200
        programs._evict(keep=new)
        assert programs.programs() == [other, held, new]  # nothing else to evict
    assert held.pins == 0
    programs._evict(keep=new)
    assert programs.programs() == [other, new]
    for k in range(programs.MAX_PROGRAMS):
        programs.cached(("t", k), lambda: _stand_in(0))
    assert len(programs.programs()) == programs.MAX_PROGRAMS + 1
    assert new.forward is None and programs.programs()[0] is other


def test_the_count_bound_holds_on_each_device(empty_cache, monkeypatch):
    """Stand-ins keyed to four cards (built on the CPU, then placed: no card
    needed): 12 programs of one kind, 3 a card, are all kept, as are 5 more
    on card 0 (8 there); a ninth on card 0 evicts card 0's least recently
    used program and no other card's."""
    monkeypatch.setattr(programs, "pool_budget", lambda device: None)
    cards = [torch.device("cuda", k) for k in range(4)]
    made = {}

    def build(k, card):
        def make():
            made[k, card.index] = programs.Program(lambda x: x * 2, (torch.zeros(3),), "cpu")
            made[k, card.index].device = card
            return made[k, card.index]
        return make

    for k in range(3):
        for card in cards:
            programs.cached(("fused", k, str(card)), build(k, card))
    assert len(programs.programs()) == 12
    for k in range(3, 8):
        programs.cached(("fused", k, str(cards[0])), build(k, cards[0]))
    assert len(programs.programs()) == 17
    assert all(p.forward is not None for p in made.values())
    programs.cached(("fused", 8, str(cards[0])), build(8, cards[0]))
    assert made[0, 0].forward is None and made[0, 0] not in programs.programs()
    assert len(programs.programs()) == 17
    assert all(p.forward is not None for key, p in made.items() if key != (0, 0))
    assert sum(p.device == cards[0] for p in programs.programs()) == programs.MAX_PROGRAMS


def test_three_drops_of_one_bucket_equal_a_fresh_module_and_jax(empty_cache, packed_of):
    """Different lengths inside one 45 s bucket and different seeds, in a
    row through the cached program of that shape."""
    drops = [_drop(36.0, 3), _drop(44.0, 8), _drop(40.0, 17)]
    cfg = DecoderConfig()
    results = [engine.decode_waveform(raw, FS, device="cpu") for raw in drops]
    (program,) = programs.programs()
    assert program.calls == 3
    dims = engine.EngineDims.for_waveform(45 * FS, float(FS), cfg.bitrate,
                                          engine.probe_window(cfg, float(FS)))
    fresh = engine.FusedDecoder.from_numpy_tables(
        engine.engine_tables(cfg, float(FS), dims), dims, float(FS), bitrate=cfg.bitrate,
        bit_inset=cfg.bit_inset, device="cpu")
    for raw, got, res in zip(drops, packed_of["port"], results):
        x = torch.from_numpy(np.concatenate([raw, np.zeros(45 * FS - len(raw), np.int16)]))
        with torch.inference_mode():
            want = fresh(x, torch.tensor(len(raw))).numpy()
        np.testing.assert_array_equal(got, want)
        ref = jeng.decode_waveform_tpu(raw, FS, mode="monolithic", config=JaxConfig(),
                                       wire="int16")
        assert_packed_close(got, packed_of["jax"][-1])
        assert res.status == ref.status == 2
        assert res.hexframes == ref.hexframes and len(res.hexframes) > 100
        assert res.metadata == ref.metadata
    assert len({len(r.hexframes) for r in results}) == 3


def test_dispatch_batch_interleaved_equals_each_batch_alone(empty_cache):
    rows = np.stack([_drop(40.0, s) for s in (3, 8, 17, 21)])
    first, second = rows[:2], rows[2:]
    lengths = [40 * FS - 1000, 40 * FS]
    out_a, ctx_a = batch.dispatch_batch(first, FS, device="cpu", lengths=lengths)
    out_b, ctx_b = batch.dispatch_batch(second, FS, device="cpu", lengths=lengths)
    (program,) = programs.programs()
    assert program.calls == 2
    res_a = batch.finish_dispatched(out_a, ctx_a)
    res_b = batch.finish_dispatched(out_b, ctx_b)
    plan = batch.BatchPlan(rows.dtype, rows.shape[1], FS, None, "auto", "cpu")
    for sub, out, res in ((first, out_a, res_a), (second, out_b, res_b)):
        with torch.inference_mode():
            want = plan.model(torch.from_numpy(sub), torch.tensor(lengths))
        assert torch.equal(out, want)
        alone = batch.decode_batch(sub, FS, device="cpu", lengths=lengths)
        for r, a in zip(res, alone):
            assert r.status == a.status == 2
            assert r.hexframes == a.hexframes and r.metadata == a.metadata
    assert not torch.equal(out_a, out_b)


def test_prestaged_fused_dispatched_three_times_before_any_finish():
    raw = _drop(50.0, 5)
    staged = segmented.prestage_waveform(raw, FS, device="cpu", fused=True, group=2)
    outs = [staged.dispatch() for _ in range(3)]
    assert staged.program.calls == 3
    assert len({o.data_ptr() for o in outs}) == 3
    p = staged.plan
    with torch.inference_mode():
        want = p.model(staged.ext_all, p.n_seg, p.dc, p.peak, p.n_raw, p.nv_dec, p.dims)
    for o in outs:
        assert torch.equal(o, want)
    results = [staged.finish(o) for o in outs]
    assert results[0].status == 2 and len(results[0].hexframes) > 100
    assert all(r.hexframes == results[0].hexframes for r in results)
