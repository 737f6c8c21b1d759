"""Profile report writer — byte-identical to the reference ``output.txt``.

A jax-free copy of axctdprocessor_tpu.utils.report (whose module loads jax
through its ``DecodeResult`` import).  Format contract: reference
processAXCTD.py:144-183; row format
``{t:8.2f},  {hex},{z:10.2f},{T:16.2f},{C:21.2f},{S:15.2f}``.
"""

from __future__ import annotations

from ..models.result import DecodeResult
from .config import DecoderConfig


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
        out(row + "\n")

    return "".join(lines)


def write_report(path: str, result: DecodeResult, wavfile: str, timerange,
                 echo_settings: dict, config: DecoderConfig,
                 diagnostics: bool = False) -> None:
    with open(path, "w") as f:
        f.write(format_report(result, wavfile, timerange, echo_settings,
                              config, diagnostics=diagnostics))
