"""Profile report writer — byte-identical to the reference ``output.txt``.

A jax-free copy of axctdprocessor_tpu.utils.report (whose module loads jax
through its ``DecodeResult`` import).  Format contract: reference
processAXCTD.py:144-183; row format
``{t:8.2f},  {hex},{z:10.2f},{T:16.2f},{C:21.2f},{S:15.2f}``.

The profile's rows are written as whole columns in numpy (:func:`_format_rows`)
into one fixed-width byte row per result row, over a template row that the
f-string of record, :func:`_exact_row`, writes: each number's last 8
characters from two tables, indexed by its integer hundredths.  A row that
this cannot write exactly as the f-string does (a value not finite, of 10,000
or more in magnitude, or whose hundredths lie near a half) is written by that
f-string; so is the whole profile when a column does not hold real numbers or
a hex frame is not 8 ASCII characters.  Each report that needs the f-string
for a row opens the span ``report_exact`` once.
"""

from __future__ import annotations

import functools

import numpy as np

from ..models.result import DecodeResult
from . import profiling
from .config import DecoderConfig

_CELL = 8  # bytes written at once: a hex frame, a number's last characters
_INT_LIMIT = 10 ** 4  # integer parts the table holds: "-9999" to " 9999"
# a float product 100 * x this near a half goes to the f-string: it lies
# within an ulp or two (2**-33 each below 2**20) of the exact product, also
# for an x that float() rounded (a Decimal, a Fraction)
_HALF_MARGIN = 2.0 ** -30


def _exact_row(t, hf, z, temp, cond, psal, diag=None) -> str:
    """One profile row as the reference writes it: the formatter of record."""
    row = f"{t:8.2f},  {hf},{z:10.2f},{temp:16.2f},{cond:21.2f},{psal:15.2f}"
    if diag is not None:
        r4, r75 = diag
        row += f",{r4:8.2f},{r75:8.2f}"
    return row + "\n"


def _layout(diagnostics: bool) -> tuple[bytes, int, tuple[int, ...]]:
    """The template row, the end of its hex field and the end of each number
    (the byte 3 past its '.'), in row order."""
    hexes = "h" * _CELL
    template = _exact_row(0, hexes, 0, 0, 0, 0, (0, 0) if diagnostics else None)
    ends = tuple(i + 3 for i, c in enumerate(template) if c == ".")
    return template.encode("ascii"), template.index(hexes) + _CELL, ends


@functools.cache
def _tables() -> tuple[np.ndarray, np.ndarray]:
    """A number's last _CELL characters are ``ints[q + _INT_LIMIT * neg] |
    hundredths[r]`` (uint64 cells) for the integer part q, the sign and the
    hundredths r: the integer part right-aligned in the first five bytes,
    "." and two digits in the last three."""
    ints = [f"{sign}{q}".rjust(5) for sign in ("", "-") for q in range(_INT_LIMIT)]
    cells = np.zeros((len(ints), _CELL), np.uint8)
    cells[:, :5] = np.frombuffer("".join(ints).encode("ascii"), np.uint8).reshape(-1, 5)
    tail = np.zeros((100, _CELL), np.uint8)
    tail[:, 5:] = np.frombuffer("".join(f".{r:02d}" for r in range(100)).encode("ascii"),
                                np.uint8).reshape(-1, 3)
    return cells.view(np.uint64).ravel(), tail.view(np.uint64).ravel()


def _cells(buf: np.ndarray, end: int) -> np.ndarray:
    """The _CELL bytes of each row of `buf` that end at column `end`, as one
    (unaligned) uint64 each: a view, written in one pass."""
    return np.ndarray((buf.shape[0],), np.uint64, buffer=buf, offset=end - _CELL,
                      strides=(buf.strides[0],))


def _reals(values, n: int) -> np.ndarray | None:
    """The first `n` of `values` as float64, as ``float()`` reads each, or
    None where one is no real number (None reads as NaN, which the f-string
    then refuses; a string of a number reads as that number)."""
    try:
        return np.fromiter(values, np.float64, n)
    except (TypeError, ValueError, OverflowError):
        return None


def _hex_cells(hexes, n: int) -> np.ndarray | None:
    """The first `n` hex frames as uint64 cells of their bytes, or None unless
    each is a string of _CELL ASCII characters."""
    try:
        joined = ("\n".join(hexes[:n]) + "\n").encode("ascii")
    except (TypeError, UnicodeEncodeError):
        return None
    rows = np.frombuffer(joined, np.uint8)
    if rows.size != (_CELL + 1) * n:
        return None
    rows = rows.reshape(n, _CELL + 1)
    # with no newline inside a frame, the newlines end every row only if
    # every frame is _CELL characters long
    if (rows[:, _CELL] != 10).any() or (rows[:, :_CELL] == 10).any():
        return None
    return _cells(rows, _CELL)


def _write_number(buf: np.ndarray, x: np.ndarray, end: int) -> np.ndarray:
    """Write the last _CELL characters of ``f"{x:.2f}"`` into each row of
    `buf` up to column `end`, for a field of at least _CELL characters whose
    template holds spaces before them; returns the mask of the rows it
    cannot write so (their cell is left garbled, in ASCII)."""
    y = x * 100.0
    ok = np.abs(y) < _INT_LIMIT * 100 - 0.5  # False for nan and inf
    y = np.where(ok, y, 0.0)
    k = np.rint(y)
    # Python rounds the exact value half to even; rint may round a product
    # near a half the other way
    ok &= np.abs(y - k) < 0.5 - _HALF_MARGIN
    q, r = np.divmod(np.abs(k).astype(np.int32), 100)
    ints, hundredths = _tables()
    # the sign bit: Python writes -0.0, and what rounds to it, as -0.00
    _cells(buf, end)[:] = (ints[q + _INT_LIMIT * np.signbit(x)]
                           | hundredths[r])
    return ~ok


def _format_rows(result: DecodeResult, diagnostics: bool) -> str:
    """The profile's rows, byte for byte what :func:`_exact_row` writes of
    each; the rows it alone can write, under the span ``report_exact``."""
    cols = (result.time, result.hexframes, result.depth, result.temperature,
            result.conductivity, result.salinity)
    n = min(map(len, cols))  # the rows zip pairs up
    ratios = (result.r400, result.r7500) if diagnostics else ()

    def exact(i: int) -> str:
        diag = tuple(r[i] if i < len(r) else float("nan") for r in ratios)
        return _exact_row(*(c[i] for c in cols), diag or None)

    if n == 0:
        return ""
    numbers = [_reals(c, n) for c in (cols[0],) + cols[2:]]
    for r in ratios:  # NaN past a short ratio list, as exact() pads it
        m = min(n, len(r))
        a = _reals(r, m)
        numbers.append(None if a is None else
                       np.concatenate([a, np.full(n - m, np.nan)]))
    hexes = _hex_cells(cols[1], n)
    if hexes is None or any(a is None for a in numbers):
        with profiling.span("report_exact"):
            return "".join(map(exact, range(n)))

    template, hex_end, ends = _layout(diagnostics)
    buf = np.empty((n, len(template)), np.uint8)
    buf[:] = np.frombuffer(template, np.uint8)
    _cells(buf, hex_end)[:] = hexes
    bad = np.zeros(n, bool)
    for x, end in zip(numbers, ends):
        bad |= _write_number(buf, x, end)
    text = str(buf, "ascii")  # decoded from the array's own buffer, no bytes copy
    rows = np.flatnonzero(bad).tolist()
    if not rows:
        return text
    with profiling.span("report_exact"):
        w = len(template)
        pieces, prev = [], 0
        for i in rows:
            pieces += (text[prev * w:i * w], exact(i))
            prev = i + 1
        pieces.append(text[prev * w:])
        return "".join(pieces)


def format_report(result: DecodeResult, wavfile: str, timerange,
                  echo_settings: dict, config: DecoderConfig,
                  diagnostics: bool = False) -> str:
    md = result.metadata
    fs = result.fs
    lines = []
    out = lines.append

    out(f"AXCTD profile for {wavfile}\n")
    out(f"Sampling frequency (fs): {fs} Hz\n")
    out(f"Audio file length: {result.numpoints/fs} sec\n")
    out(f"400 Hz pulse start: {result.firstpulse400/fs} sec\n")
    out(f"7500 Hz tone start: {result.profstartind/fs} sec\n")

    out("\nAXCTD header information:\n")
    for desc, key in zip(
        ["Probe Code", "Maximum Depth (m)", "Probe Serial"],
        ["probe_code", "max_depth", "serial_no"],
    ):
        out(f"{desc}: {md[key]}\n")
    out("Conversion equations:\n")
    defaults = {
        "z": config.zcoeff_default,
        "t": config.tcoeff_default,
        "c": config.ccoeff_default,
    }
    for coeff, desc, symb in zip(
        ["z", "t", "c"], ["Depth", "Temperature", "Conductivity"], ["t", "T", "C"]
    ):
        if sum(md[coeff + "coeff_valid"]) == 4:
            values = md[coeff + "coeff"]
            tag = ""
        else:
            values = defaults[coeff]
            tag = "(default)"
        eqn = " + ".join(f"{val}*{symb}^{i}" for i, val in enumerate(values))
        out(f"{desc}: {eqn} {tag}\n")

    out("\nProcessor Settings:\n")
    tr = echo_settings["triggerrange"]
    out(f"Time Range: {timerange[0]} sec to "
        f'{timerange[1] if timerange[1] >= 0 else "N/A"} sec\n')
    out(f'Min. 400 Hz power ratio: {echo_settings["minR400"]}\n')
    out(f'Min. 7500 Hz power ratio: {echo_settings["mindR7500"]}\n')
    out(f'Dead frequency: {echo_settings["deadfreq"]}\n')
    out(f'Points per loop: {echo_settings["pointsperloop"]}\n')
    out(f'Trigger range: {tr[0]} sec to {tr[1] if tr[1] >= 0 else "N/A"} sec\n')
    if diagnostics and result.wire is not None:
        out(f"Wire format: {result.wire}\n")

    out("\nAXCTD Profile:\n")
    # --diagnostics appends the per-point signal ratios the upstream engine
    # computes but never writes; the default stays byte-identical
    diag_hdr = ", R400, dR7500" if diagnostics else ""
    out("Time (s), Hex Frame, Depth (m), Temperature (C), "
        f"Conductivity (mS/cm), Salinity (PSU){diag_hdr}\n")
    out(_format_rows(result, diagnostics))

    return "".join(lines)


def write_report(path: str, result: DecodeResult, wavfile: str, timerange,
                 echo_settings: dict, config: DecoderConfig,
                 diagnostics: bool = False) -> None:
    with open(path, "w") as f:
        f.write(format_report(result, wavfile, timerange, echo_settings,
                              config, diagnostics=diagnostics))
