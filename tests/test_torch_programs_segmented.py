"""The segmented engine's cached programs (``models/segmented.py``'s group
and assemble programs, ``models/stream_device.py``) on the CPU.

On the CPU a program runs its module eagerly over its static buffers and
returns its static outputs' clones (or, for the group program, the static
outputs, copied into the assemble program's inputs before its next call):
the data flow of a CUDA-graph replay without the graph, so a stale static
input shows here too.

* three drops of one bucket through ``decode_waveform_segmented``, one
  after another: each packed vector bit for bit a fresh
  ``SegmentedDecoder``'s forward on the same extensions, and close to the
  JAX engine's segmented decode (``torch_packed.assert_packed_close``,
  hexframes and metadata equal);
* a longer drop, then a shorter one in the same (pinned) bucket, in groups
  of 2: the shorter one's rows past its segments hold the longer one's
  segments and a group's padding row, and must decode as the zero segment;
* a prestaged drop decoded group by group three times, before any finish,
  and against the JAX package's prestaged drop;
* the stream, fed in two chunkings: every snapshot a fresh module's
  assemble of the same segments, ``finalize()`` the offline decode's packed
  vector and the JAX stream's result; a pinned stream's programs are run
  twice in its constructor, and it holds them until ``finalize()`` while
  other decodes fill the cache past its count.
"""

import numpy as np
import pytest
import torch

from axctdprocessor_tpu.models import segmented as jseg
from axctdprocessor_tpu.models import stream_tpu as jstream
from axctdprocessor_tpu.models import tpu_engine as jeng
from axctdprocessor_tpu_torch.models import engine, programs, segmented, simulator
from axctdprocessor_tpu_torch.models.stream_device import BIG_N, DeviceStreamDecoder
from axctdprocessor_tpu_torch.utils.config import DecoderConfig
from axctdprocessor_tpu_torch.utils.profiling import StageTimer
from torch_packed import assert_packed_close

torch.set_num_threads(2)

FS = 44100


def _pcm(duration: float, seed: int) -> np.ndarray:
    return simulator.synthesize(simulator.SimSpec(duration=duration, profile_start=20.0,
                                                  seed=seed))[0]


def _int16(pcm: np.ndarray) -> np.ndarray:
    return np.round(pcm * 28000 / np.max(np.abs(pcm))).astype(np.int16)


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


def _fresh_packed(raw, wire: str = "auto", group: int = segmented.GROUP) -> np.ndarray:
    """A fresh module's eager forward over the drop's extensions (the plan's
    encoding, its group's padding rows not read): the packed vector."""
    p = segmented._plan_waveform(raw, FS, None, wire, StageTimer(), "cpu", group)
    exts = np.concatenate([segmented._chunk_host(p, j) for j in range(p.n_chunk)])
    fresh = segmented.SegmentedDecoder.from_config(DecoderConfig(), float(FS), False, "cpu")
    with torch.inference_mode():
        return fresh(torch.from_numpy(exts)[None], p.n_seg, p.dc, p.peak, p.n_raw, p.nv_dec,
                     p.dims).numpy()


def test_three_drops_of_one_bucket_equal_a_fresh_module_and_jax(empty_cache, packed_of):
    """Three lengths of one 3-segment bucket, different seeds, in a row
    through the group program (G = 4: one padded group) and the assemble
    program of that bucket."""
    drops = [_int16(_pcm(d, s)) for d, s in ((52.0, 3), (66.0, 8), (59.0, 17))]
    results = [segmented.decode_waveform_segmented(raw, FS, device="cpu") for raw in drops]
    seg, asm = programs.programs()
    assert seg.calls == asm.calls == 3
    assert seg.inputs[0].shape == (4, segmented.SegmentedDecoder.from_config(
        DecoderConfig(), float(FS), False, "cpu").in_len)
    assert asm.inputs[0].shape[0] == segmented._bucket_count(3) == 3
    for raw, got, res in zip(drops, packed_of["port"], results):
        np.testing.assert_array_equal(got, _fresh_packed(raw))
        ref = jseg.decode_waveform_segmented(raw, FS, wire="int16")
        assert_packed_close(got, packed_of["jax"][-1])
        assert res.status == ref.status == 2
        assert res.hexframes == ref.hexframes and len(res.hexframes) > 100
        assert res.metadata == ref.metadata
    assert len({len(r.hexframes) for r in results}) == 3


def test_shorter_drop_after_a_longer_one_in_one_bucket(empty_cache, packed_of, monkeypatch):
    """Both drops in a 4-segment bucket, groups of 2: the longer one (4
    segments) fills every row of the assemble's inputs; the shorter one (3
    segments) leaves row 3 holding its second group's padding row, and
    the next shorter one (2) rows 2-3 holding the longer drop's segments.
    Each must equal its fresh decode, whose rows past its segments are the
    zero segment."""
    monkeypatch.setattr(segmented, "_bucket_count", lambda k: 4)
    drops = [_int16(_pcm(d, s)) for d, s in ((90.0, 5), (60.0, 6), (40.0, 7))]
    results = [segmented.decode_waveform_segmented(raw, FS, device="cpu", group=2)
               for raw in drops]
    seg, asm = programs.programs()
    assert asm.inputs[0].shape[0] == 4 and asm.calls == 3
    for raw, got in zip(drops, packed_of["port"]):
        np.testing.assert_array_equal(got, _fresh_packed(raw, group=2))
    assert [r.status for r in results] == [2, 2, 2]


def test_prestaged_group_by_group_dispatched_three_times_equals_fresh_and_jax(
        empty_cache, packed_of):
    raw = _int16(_pcm(55.0, 9))
    staged = segmented.prestage_waveform(raw, FS, device="cpu", wire="int16", group=2)
    outs = [staged.dispatch() for _ in range(3)]
    assert len({o.data_ptr() for o in outs}) == 3
    want = _fresh_packed(raw, wire="int16", group=2)
    for o in outs:
        np.testing.assert_array_equal(o.numpy(), want)
    res = staged.finish(outs[0])
    ref = jseg.prestage_waveform(raw, FS, wire="int16").decode()
    assert_packed_close(packed_of["port"][-1], packed_of["jax"][-1])
    assert res.status == ref.status == 2
    assert res.hexframes == ref.hexframes and res.metadata == ref.metadata


def _snapshot_of_fresh(fresh, x, n_seg: int, n_valid: int, final: bool,
                       bucket: int | None = None) -> np.ndarray:
    """A fresh module's eager assemble of the stream's first `n_seg`
    segments, each alone as the stream queues it, at their bucket's size
    or at `bucket` segments (a pinned stream's)."""
    seg_len = fresh.seg_len
    outs = []
    with torch.inference_mode():
        for k in range(n_seg):
            lo = k * seg_len - segmented.LEFT_HALO
            ext = np.zeros(fresh.in_len, np.float32)
            src = x[max(lo, 0): lo + fresh.in_len]
            ext[max(-lo, 0): max(-lo, 0) + len(src)] = src
            outs.append(fresh.segment(torch.from_numpy(ext), k * seg_len, torch.zeros(()),
                                      torch.ones(()), len(x) if final else BIG_N))
        dims = engine.EngineDims.for_waveform(
            (bucket or segmented._bucket_count(max(n_seg, 1))) * seg_len, float(FS), fresh.bitrate,
            fresh.npcm)
        return fresh.assemble(outs, torch.tensor(n_valid), dims).numpy()


@pytest.mark.parametrize("chunking", ["uniform_1s", "ragged"])
def test_stream_snapshots_and_finalize_equal_fresh_offline_and_jax(empty_cache, packed_of,
                                                                  chunking):
    pcm = _pcm(62.0, 12)
    x = ((pcm - np.mean(pcm)) / np.max(np.abs(pcm))).astype(np.float32)
    fresh = segmented.SegmentedDecoder.from_config(DecoderConfig(), float(FS), False, "cpu")
    dec = DeviceStreamDecoder(FS, device="cpu")
    rng = np.random.default_rng(4321)
    pos, snaps = 0, []
    while pos < len(x):
        step = FS if chunking == "uniform_1s" else int(rng.integers(1000, 150000))
        before = dec._next_k
        if dec.feed(x[pos: pos + step]) > before:
            dec.results()
            snaps.append(dec._next_k)
        pos += step
    final = dec.finalize()
    assert snaps == [1, 2]
    got = packed_of["port"]
    for n_seg, packed in zip(snaps, got):
        np.testing.assert_array_equal(packed, _snapshot_of_fresh(fresh, x, n_seg,
                                                                 n_seg * fresh.seg_len, False))
    np.testing.assert_array_equal(got[len(snaps)],
                                  _snapshot_of_fresh(fresh, x, 3, len(x), True))
    offline = segmented.decode_waveform_segmented(x, FS, device="cpu")
    np.testing.assert_array_equal(got[len(snaps)], got[-1])
    ref = jstream.TPUStreamDecoder(FS)
    for i in range(0, len(x), 2 * FS):
        ref.feed(x[i: i + 2 * FS])
    want = ref.finalize()
    assert_packed_close(got[len(snaps)], packed_of["jax"][-1])
    for a in (final, offline):
        assert a.status == want.status == 2
        assert a.metadata == want.metadata and a.hexframes == want.hexframes
        assert a.firstpulse400 == want.firstpulse400 and a.profstartind == want.profstartind


def test_pinned_stream_runs_its_programs_twice_in_the_constructor(empty_cache):
    """``max_duration`` pins a 5-segment bucket: the one-row segment program
    and that bucket's assemble program each run their first and second
    (on a card: the capturing) call before the constructor returns; a
    snapshot inside the bucket takes the same assemble program."""
    dec = DeviceStreamDecoder(FS, max_duration=100.0, device="cpu")
    seg, asm = programs.programs()
    assert seg.inputs[0].shape[0] == 1 and seg.calls == 2
    assert asm.inputs[0].shape[0] == dec._pin_bucket == 5 and asm.calls == 2
    x = _pcm(30.0, 12).astype(np.float32)
    dec.feed(x)
    res = dec.results()
    assert res.status in (0, 1, 2)
    assert programs.programs() == [seg, asm] and asm.calls == 3 and seg.calls == 3


def test_pinned_stream_keeps_its_programs_while_other_decodes_evict(empty_cache, packed_of,
                                                                   monkeypatch):
    """One program of each kind: a segmented decode of another bucket
    between two snapshots would evict the stream's one-row program and its
    bucket's assemble program; the stream holds them from its constructor
    to ``finalize()``, so it builds (on a card: captures) nothing after its
    constructor, and its snapshot and final result equal a fresh module's."""
    monkeypatch.setattr(programs, "MAX_PROGRAMS", 1)
    pcm = _pcm(50.0, 12)
    x = ((pcm - np.mean(pcm)) / np.max(np.abs(pcm))).astype(np.float32)
    fresh = segmented.SegmentedDecoder.from_config(DecoderConfig(), float(FS), False, "cpu")
    dec = DeviceStreamDecoder(FS, max_duration=70.0, device="cpu")
    held = programs.programs()
    assert len(held) == 2 and all(p.pins == 1 for p in held)
    built = []
    real = programs.Program.__init__
    monkeypatch.setattr(programs.Program, "__init__",
                        lambda self, *a, **k: built.append(self) or real(self, *a, **k))
    assert dec.feed(x[: 30 * FS]) == 1
    dec.results()
    other = segmented.decode_waveform_segmented(_int16(_pcm(40.0, 7)), FS, device="cpu",
                                                group=2)
    assert len(built) == 2 and all(p in programs.programs() for p in held)
    dec.feed(x[30 * FS:])
    final = dec.finalize()
    assert len(built) == 2 and all(p.forward is not None and p.pins == 0 for p in held)
    one, asm = held
    assert one.calls == 2 + dec._next_k == 5 and asm.calls == 2 + 2
    assert other.status == 2 and final.status == 2
    snap, _, last = packed_of["port"]
    bucket = dec._pin_bucket
    np.testing.assert_array_equal(snap, _snapshot_of_fresh(fresh, x, 1, fresh.seg_len, False,
                                                           bucket))
    np.testing.assert_array_equal(last, _snapshot_of_fresh(fresh, x, 3, len(x), True, bucket))
