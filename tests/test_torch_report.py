"""The port's report writer (``utils/report``) against the per-row f-string.

``format_report`` writes the profile's rows as whole columns in numpy and
hands the rows it cannot write exactly to the f-string of record.  Every case
here holds its rows byte for byte to the writer's old loop, kept below as
``fstring_rows``: a drop decoded by the port's host parity engine, random
unrounded values over many magnitudes, ties and near-ties, negative zeros,
values not finite or wider than their field, an empty profile, hex frames
fewer or more than the rows or not 8 characters, and ``--diagnostics`` with
short ratio lists.  The span ``report_exact`` counts the reports that needed
the f-string.  Imports neither jax nor torch.
"""

import math
from decimal import Decimal
from fractions import Fraction

import numpy as np
import pytest

from axctdprocessor_tpu_torch.models import parity_engine, simulator
from axctdprocessor_tpu_torch.models.result import DecodeResult
from axctdprocessor_tpu_torch.utils import profiling, report
from axctdprocessor_tpu_torch.utils.config import DecoderConfig

COLUMNS = ("time", "depth", "temperature", "conductivity", "salinity")
ECHO = {"triggerrange": [30, -1], "minR400": 2.0, "mindR7500": 1.5, "deadfreq": 3000.0,
        "pointsperloop": 100000}


def fstring_rows(result, diagnostics=False):
    """The writer's rows as its per-row loop wrote them before the columns."""
    lines = []
    diag_cols = (result.r400, result.r7500) if diagnostics else ((), ())
    for k, (t, hf, z, temp, cond, psal) in enumerate(zip(
        result.time, result.hexframes, result.depth, result.temperature,
        result.conductivity, result.salinity,
    )):
        row = f"{t:8.2f},  {hf},{z:10.2f},{temp:16.2f},{cond:21.2f},{psal:15.2f}"
        if diagnostics:
            r4 = diag_cols[0][k] if k < len(diag_cols[0]) else float("nan")
            r75 = diag_cols[1][k] if k < len(diag_cols[1]) else float("nan")
            row += f",{r4:8.2f},{r75:8.2f}"
        lines.append(row + "\n")
    return "".join(lines)


def written_rows(result, diagnostics=False):
    """The rows of ``format_report``'s text, after the profile's header line."""
    text = report.format_report(result, "drop.wav", [0, -1], ECHO, DecoderConfig(),
                                diagnostics=diagnostics)
    head = "Salinity (PSU), R400, dR7500\n" if diagnostics else "Salinity (PSU)\n"
    return text.split(head, 1)[1]


def make_result(columns, hexframes=None, r400=(), r7500=()):
    """A result whose five row lists are `columns` (one list, or one a column)."""
    if not isinstance(columns, dict):
        columns = {name: list(columns) for name in COLUMNS}
    n = len(columns["time"])
    res = DecodeResult(fs=44100.0, numpoints=44100 * 60)
    for name in COLUMNS:
        setattr(res, name, list(columns[name]))
    res.hexframes = ([f"{(2654435761 * i) % 2**32:08x}" for i in range(n)]
                     if hexframes is None else hexframes)
    res.r400, res.r7500 = list(r400), list(r7500)
    return res


def assert_rows_equal(res, diagnostics=False):
    assert written_rows(res, diagnostics) == fstring_rows(res, diagnostics)


def exact_count(res, diagnostics=False):
    timer = profiling.StageTimer()
    with profiling.installed(timer):
        written_rows(res, diagnostics)
    return timer.counts["report_exact"]


@pytest.fixture(scope="module")
def decoded():
    """A 45 s drop through the port's host parity engine (numpy only)."""
    spec = simulator.SimSpec(duration=45.0, profile_start=33.0, seed=5)
    pcm, _ = simulator.synthesize(spec)
    res = parity_engine.decode_waveform(pcm, spec.fs)
    assert res.status == 2 and len(res.time) > 200
    return res


@pytest.mark.parametrize("diagnostics", [False, True])
def test_decoded_drop(decoded, diagnostics):
    assert_rows_equal(decoded, diagnostics)


def _rng_values(seed, n=400):
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.integers(-8, 22, n)
    return rng.standard_normal(n) * scale


@pytest.mark.parametrize("case", [
    "uniform_small", "uniform_wide", "magnitudes", "rounded", "halves_off_by_ulps",
    "integers", "per_column",
])
@pytest.mark.parametrize("seed", [0, 1, 2**31 + 7])
def test_random_values(case, seed):
    rng = np.random.default_rng(seed)
    n = 500
    if case == "uniform_small":
        values = rng.uniform(-1.0, 1.0, n)
    elif case == "uniform_wide":
        values = rng.uniform(-2e4, 2e4, n)
    elif case == "magnitudes":
        values = _rng_values(seed, n)
    elif case == "rounded":
        values = np.round(rng.uniform(-50.0, 2000.0, n), 2)
    elif case == "halves_off_by_ulps":
        half = (rng.integers(-10**6, 10**6, n) + 0.5) / 100
        values = half + rng.integers(-64, 65, n) * np.spacing(half)
    elif case == "integers":
        values = rng.integers(-10**5, 10**5, n).astype(np.float64)
    else:
        cols = {name: np.round(rng.uniform(lo, hi, n), 2) for name, (lo, hi) in zip(
            COLUMNS, [(33, 600), (0, 1100), (-2, 32), (0, 70), (0, 42)])}
        assert_rows_equal(make_result(cols))
        return
    assert_rows_equal(make_result(values))


def _near_halves():
    out = []
    for k in (-1001, -1, 0, 1, 2, 12, 100, 267, 99999, 999998):
        half = (k + 0.5) / 100
        out += [half, np.nextafter(half, -math.inf), np.nextafter(half, math.inf)]
    return out


@pytest.mark.parametrize("values", [
    [0.125, 0.375, 2.675, 1.005, -0.005, 0.005, 0.015, 1.115, -2.675, 0.045, 5e-3],
    _near_halves(),
    [-0.0, 0.0, -1e-300, -5e-324, -0.004, -0.0049999, 0.004, -0.005000001],
    [math.nan, math.inf, -math.inf, 1.0, -math.nan, 2.5],
    [9999.99, 9999.994, 9999.995, 9999.996, 10000.0, 10000.5, -9999.99, -9999.994,
     -9999.996, -10000.0, 99999.99, -99999.99],
], ids=["ties", "near_ties", "negative_zeros", "not_finite", "table_edges"])
def test_edge_values(values):
    assert_rows_equal(make_result(values))


@pytest.mark.parametrize("column,value", [
    ("time", 123456.78), ("time", -12345.67), ("time", 99999.99), ("time", -9999.99),
    ("depth", 1e8), ("depth", -1234567.0), ("depth", 12345.67),
    ("temperature", 1e14), ("temperature", -3e13),
    ("conductivity", 1e19), ("conductivity", -1e18), ("conductivity", 2.0**60),
    ("salinity", 1e13), ("salinity", -1e12), ("salinity", 1e300),
])
def test_values_wider_than_their_field(column, value):
    cols = {name: [1.0, 2.0, 3.0] for name in COLUMNS}
    cols[column] = [1.5, value, -value]
    assert_rows_equal(make_result(cols))


def test_empty_profile():
    res = make_result([])
    assert written_rows(res) == "" == fstring_rows(res)
    assert exact_count(res) == 0


@pytest.mark.parametrize("hexframes", [
    [f"{i:08x}" for i in range(3)],                 # fewer frames than rows
    [f"{i:08x}" for i in range(9)],                 # more
    ["abc", "0000000a", "0000000b", "0000000c", "0000000d"],
    ["0000000a", "0000000b0", "000000c", "0000000d", "0000000e"],
    ["0000000a\n", "0000000", "0000000c", "0000000d", "0000000e"],
    ["0000000a", "0000\n00b", "0000000c", "0000000d", "0000000e"],
    ["0000000a", "0000é00b", "0000000c", "0000000d", "0000000e"],
    [10, 11, 12, 13, 14],
    np.array([f"{i:08x}" for i in range(5)]),
], ids=["fewer", "more", "short", "long_and_short", "newline_end", "newline_inside",
        "not_ascii", "not_strings", "numpy_strings"])
def test_hex_frames(hexframes):
    assert_rows_equal(make_result([1.25e-3, 2.0, -3.5, 44.44, 5.0], hexframes=hexframes))


@pytest.mark.parametrize("n_r400,n_r7500", [(0, 0), (3, 5), (5, 2), (8, 9)])
def test_diagnostics_ratio_lists(n_r400, n_r7500):
    rng = np.random.default_rng(n_r400 * 10 + n_r7500)
    res = make_result(np.round(rng.uniform(0, 100, 5), 2),
                      r400=np.round(rng.uniform(0, 40, n_r400), 2),
                      r7500=np.round(rng.uniform(-5, 5, n_r7500), 2))
    assert_rows_equal(res, diagnostics=True)
    assert_rows_equal(res, diagnostics=False)


@pytest.mark.parametrize("values", [
    [1, 2, -3, 10**30, 0],
    list(np.float32([0.1, 2.675, -1e-3, 3.3e4, 7.25])),
    [Decimal("2.675"), Decimal("-0.001"), Decimal("1.00500000000000000001"), Decimal(7),
     Decimal("1e5")],
    [Fraction(1, 8), Fraction(-1, 3), Fraction(2675, 1000), Fraction(10**20, 3), 0],
    [True, False, 1.5, np.int64(-7), np.float64(0.125)],
    [1.5, 2.5, 1 + 2j, 3.5, 4.5],
], ids=["ints", "float32", "decimals", "fractions", "mixed", "complex"])
def test_value_types(values):
    assert_rows_equal(make_result(values))


def test_a_value_the_fstring_refuses_is_refused():
    res = make_result([1.5, None, 2.5])
    with pytest.raises(TypeError):
        fstring_rows(res)
    with pytest.raises(TypeError):
        written_rows(res)


@pytest.mark.parametrize("planted,expected", [
    (None, 0), ("tie", 1), ("nan", 1), ("wide", 1), ("short_hex", 1),
])
def test_report_exact_counts(decoded, planted, expected):
    res = make_result({name: list(getattr(decoded, name)) for name in COLUMNS},
                      hexframes=list(decoded.hexframes))
    if planted == "tie":
        res.temperature[7] = 2.675
    elif planted == "nan":
        res.salinity[3] = math.nan
    elif planted == "wide":
        res.depth[-1] = 1e12
    elif planted == "short_hex":
        res.hexframes[0] = "abc"
    assert exact_count(res) == expected
    assert_rows_equal(res)


def test_diagnostics_nan_ratios_take_the_fstring(decoded):
    res = make_result({name: list(getattr(decoded, name)) for name in COLUMNS},
                      hexframes=list(decoded.hexframes), r400=decoded.r400[:-4],
                      r7500=decoded.r7500)
    assert exact_count(res, diagnostics=True) == 1
    assert_rows_equal(res, diagnostics=True)
