"""The host finish's profile lists (``engine.attach_profile``), on the CPU.

``attach_profile`` builds the result's seven row columns with ``.tolist()``
and every frame's hex text from one byte table.  Each case here runs
``finish_result`` on a packed output built by hand and holds the nine lists,
element for element (NaN in the same places) and type for type, to the form
of record kept below as ``record_lists``: ``list(a[good])`` for each column
and ``f"{w:08x}"`` for each frame.  A CPU decode of a 240 s drop gives the
same report text either way, and the finish opens ``convert``, ``qc`` and
``profile_rows`` inside ``host_finish`` once a decode that reaches a profile.
"""

import collections
import contextlib
import dataclasses
import math

import numpy as np
import pytest
import torch

from axctdprocessor_tpu_torch.models import convert, engine, simulator
from axctdprocessor_tpu_torch.utils import profiling, report
from axctdprocessor_tpu_torch.utils.config import DecoderConfig

torch.set_num_threads(2)

FS = 44100.0
COLUMNS = ("time", "depth", "temperature", "conductivity", "salinity", "r400", "r7500")
FIELDS = COLUMNS + ("hexframes", "hexframes_qc")
EDGE_WORDS = [0, 1, 0x0000000F, 0x80000000, 0xFFFFFFFF]


def record_lists(out: dict, cfg: DecoderConfig, fs: float, profstart: int,
                 live: dict, temp_lut) -> dict:
    """The nine lists as ``attach_profile`` built them one element at a time."""
    n_frames = int(out["scal_i"][2])
    hexpack = np.asarray(out["hexpack"][:n_frames])
    edges = np.asarray(out["edges"][:n_frames], dtype=np.int64)
    fr = np.asarray(out["ratios"][:, :n_frames], dtype=np.float64)
    fr[fr == -32768] = np.nan
    r400, r7500 = fr / 100.0
    tint = (hexpack >> 6) & 0xFFF
    cint = (hexpack >> 18) & 0xFFF
    times_raw = (edges - profstart) / fs
    temps, conds, psals, depths = convert.ints_to_observations(
        tint, cint, times_raw, temp_lut, live["tcoeff"], live["ccoeff"], live["zcoeff"])
    times = np.round(times_raw + profstart / fs, 2)
    depths, temps, conds, psals = (np.round(a, 2) for a in (depths, temps, conds, psals))
    good = convert.qc_bounds_mask(r400, r7500, temps, psals, cfg)
    if np.any(good):
        sub = np.flatnonzero(good)
        good[sub] &= convert.qc_spike_mask(temps[sub], psals[sub])
    return dict(time=list(times[good]), depth=list(depths[good]),
                temperature=list(temps[good]), conductivity=list(conds[good]),
                salinity=list(psals[good]), r400=list(r400[good]), r7500=list(r7500[good]),
                hexframes=[f"{w:08x}" for w in hexpack],
                hexframes_qc=[f"{w:08x}" for w in hexpack[good]])


def packed(words, edges, ratios, profstart: int, capacity: int) -> np.ndarray:
    """One decode's int32 vector in ``unpack_result``'s layout: no header
    found, a pulse at sample 0, `words` frames in room for `capacity`."""
    n = len(words)
    hexpack = np.zeros(capacity, np.uint32)
    hexpack[:n] = words
    edge = np.zeros(capacity, np.int32)
    edge[:n] = edges
    ratio = np.zeros((2, capacity), np.int16)
    ratio[:, :n] = ratios
    scal_i = np.array([0, profstart, n, 0, 0, 0], np.int32)
    scal_f = np.zeros(2, np.float32)
    return np.concatenate([scal_i, scal_f.view(np.int32), np.zeros(engine._HDR_LEN, np.int32),
                           hexpack.view(np.int32), edge, ratio.reshape(-1).view(np.int32)])


def profile_words(n: int, rng) -> np.ndarray:
    """`n` frames of a smooth profile (T and C codes in their bit fields),
    the other bits random."""
    tint, cint = simulator.default_profile_ints(n)
    low = rng.integers(0, 64, n, dtype=np.uint32)
    top = rng.integers(0, 4, n, dtype=np.uint32) << 30
    return (top | (cint.astype(np.uint32) << 18) | (tint.astype(np.uint32) << 6) | low)


def make_case(name: str, rng):
    """(words, ratios in centi-units) of one case; a lookup-table hook or None."""
    n = 300
    words = profile_words(n, rng)
    ratios = np.stack([rng.integers(300, 3000, n), rng.integers(200, 2500, n)]).astype(np.int16)
    lut = None
    if name == "edge_words":
        words[:len(EDGE_WORDS)] = EDGE_WORDS
        words[-len(EDGE_WORDS):] = EDGE_WORDS
    elif name == "random_words":
        words = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    elif name == "ratio_sentinel":
        ratios[0, ::7] = -32768
        ratios[1, 3::11] = -32768
    elif name == "all_fail_qc":
        ratios[0] = 0  # every R400 below the in-profile minimum
    elif name == "no_frames":
        words, ratios = words[:0], ratios[:, :0]
    elif name == "nan_temperatures":
        lut = np.asarray(engine.load_temp_lut(), np.float64).copy()
        lut[simulator.default_profile_ints(n)[0][::5]] = np.nan
    return words, ratios, lut


def assert_lists_equal(got, want: dict):
    for field in FIELDS:
        a, b = getattr(got, field), want[field]
        assert type(a) is list and len(a) == len(b), field
        kind = str if field.startswith("hex") else float
        assert all(type(x) is kind for x in a), field
        for x, y in zip(a, b):
            assert x == y or (math.isnan(x) and math.isnan(y)), (field, x, y)


CASES = ["edge_words", "random_words", "ratio_sentinel", "all_fail_qc", "no_frames",
         "nan_temperatures"]


@pytest.mark.parametrize("case", CASES)
def test_finish_lists_equal_the_form_of_record(case, monkeypatch):
    rng = np.random.default_rng(CASES.index(case) + 11)
    words, ratios, lut = make_case(case, rng)
    if lut is not None:
        monkeypatch.setattr(engine, "load_temp_lut", lambda: lut)
    profstart = 33 * 44100
    edges = profstart + 1764 * np.arange(len(words)) + rng.integers(0, 40, len(words))
    buf = packed(words, edges, ratios, profstart, capacity=len(words) + 17)
    cfg = DecoderConfig()
    res = engine.finish_result(buf, 44100, 40 * 44100, FS, cfg)
    assert res.status == 2
    live = {"tcoeff": list(cfg.tcoeff_default), "ccoeff": list(cfg.ccoeff_default),
            "zcoeff": list(cfg.zcoeff_default)}
    want = record_lists(engine.unpack_result(buf), cfg, FS, profstart, live,
                        engine.load_temp_lut())
    assert_lists_equal(res, want)
    assert res.hexframes == want["hexframes"]
    assert len(res.hexframes) == len(words)
    if case == "edge_words":
        assert res.hexframes[:5] == ["00000000", "00000001", "0000000f", "80000000", "ffffffff"]
    if case == "ratio_sentinel":
        assert any(math.isnan(x) for x in res.r400) and any(math.isnan(x) for x in res.r7500)
    if case == "all_fail_qc":
        assert res.hexframes and not res.hexframes_qc and not res.time
    if case == "no_frames":
        assert all(getattr(res, field) == [] for field in FIELDS)
    if case == "nan_temperatures":
        assert any(math.isnan(x) for x in res.temperature)
    if case not in ("all_fail_qc", "no_frames"):
        assert len(res.time) > 100


def test_signed_words_are_read_as_their_bits():
    """A caller's dict whose words are int32 gives each word's unsigned hex."""
    words = np.array(EDGE_WORDS, np.uint32)
    buf = packed(words, 33 * 44100 + 1764 * np.arange(5), np.full((2, 5), 1000), 33 * 44100, 5)
    out = engine.unpack_result(buf)
    out["hexpack"] = out["hexpack"].view(np.int32)
    res = engine.finish_result(out, 44100, 40 * 44100, FS, DecoderConfig())
    assert res.hexframes == ["00000000", "00000001", "0000000f", "80000000", "ffffffff"]


class Opened:
    """A timer that records each stage opened with the stage open around it."""

    def __init__(self):
        self.opened: list[tuple[str, str | None]] = []
        self._stack: list[str] = []

    @contextlib.contextmanager
    def stage(self, name):
        self.opened.append((name, self._stack[-1] if self._stack else None))
        self._stack.append(name)
        try:
            yield
        finally:
            self._stack.pop()

    def as_dict(self):
        return {}

    def counts(self):
        return collections.Counter(name for name, _ in self.opened)


@pytest.fixture(scope="module")
def drop240():
    """A simulated 240 s drop decoded on the CPU under a recording timer:
    (its result, what its ``attach_profile`` was given, the timer)."""
    spec = simulator.SimSpec(duration=240.0, profile_start=33.0, seed=7)
    pcm, _ = simulator.synthesize(spec)
    seen = []
    real = engine.attach_profile

    def spy(result, out, cfg, fs, profstart, live):
        seen.append(dict(out=dict(out), cfg=cfg, fs=fs, profstart=profstart,
                         live={k: list(v) for k, v in live.items()}))
        return real(result, out, cfg, fs, profstart, live)

    timer = Opened()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(engine, "attach_profile", spy)
        res = engine.decode_waveform(pcm, spec.fs, device="cpu", mode="monolithic",
                                     timer=timer)
    assert res.status == 2 and len(res.time) > 4000 and len(seen) == 1
    return res, seen[0], timer


def test_report_of_a_240s_drop_equals_the_form_of_record(drop240):
    res, given, _ = drop240
    cfg = given["cfg"]
    want = record_lists(given["out"], cfg, given["fs"], given["profstart"], given["live"],
                        engine.load_temp_lut())
    assert_lists_equal(res, want)
    old = dataclasses.replace(res, **want)
    echo = {"triggerrange": [30, -1], "minR400": 2.0, "mindR7500": 1.5, "deadfreq": 3000.0,
            "pointsperloop": 100000}
    for diagnostics in (False, True):
        args = ("drop.wav", (0, -1), echo, cfg, diagnostics)
        assert report.format_report(res, *args) == report.format_report(old, *args)


def test_finish_spans_open_once_a_decode_with_a_profile(drop240):
    _, _, timer = drop240
    counts = timer.counts()
    for name in ("convert", "qc", "profile_rows"):
        assert counts[name] == 1, name
        assert (name, "host_finish") in timer.opened
    assert counts["host_finish"] == 1


def test_a_decode_without_a_profile_opens_no_qc_or_rows():
    spec = simulator.SimSpec(duration=25.0, profile_start=25.0, seed=4)
    pcm, _ = simulator.synthesize(spec)
    timer = Opened()
    res = engine.decode_waveform(pcm, spec.fs, device="cpu", mode="monolithic", timer=timer)
    assert res.status in (0, 1) and res.time == [] and res.hexframes == []
    counts = timer.counts()
    assert counts["host_finish"] == 1
    assert counts["qc"] == counts["profile_rows"] == counts["convert"] == 0
    with profiling.installed(timer):
        buf = packed(np.zeros(0, np.uint32), np.zeros(0), np.zeros((2, 0)), -1, 4)
        assert engine.finish_result(buf, 44100, 40 * 44100, FS, DecoderConfig()).status == 1
    assert timer.counts()["qc"] == timer.counts()["profile_rows"] == 0
