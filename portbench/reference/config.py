# Frozen copy of axctdprocessor_tpu_torch/utils/config.py at commit 05168f0, for the
# benchmark's plain reference: imports rewritten to this package.
"""Decoder configuration.

A copy of axctdprocessor_tpu.utils.config, whole: the port imports nothing
of the JAX package.

The reference has a two-layer settings system with a pathological twist:
the CLI writes keys ``minR400 / mindR7500 / pointsperloop / use_bandpass``
(reference processAXCTD.py:93-99) but the engine reads ``minr400 /
mindr7500 / usebandpass / refreshrate`` (AXCTDprocessor.py:222-254), so
the ``-p -t -l -u`` flags are silently inert; ``-a/-b`` are separately
blocked by a hardcoded trigger range (AXCTDprocessor.py:250-251).  Only
``-d`` (dead frequency) and ``-m/-n`` (mark/space) actually reach the
engine.

This module models both behaviors explicitly:

* ``compat="strict"`` — reproduce the reference's effective settings
  exactly (required for byte-identical output);
* ``compat="fixed"`` — every documented flag works as documented.

``DecoderConfig`` is the flattened, engine-facing configuration; it is
constructed from a reference-style settings dict via
:func:`resolve_settings`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

# Engine-facing defaults (reference init_default_AXCTD_settings,
# AXCTDprocessor.py:187-208).
ENGINE_DEFAULTS = {
    "minr400": 2.0,
    "mindr7500": 1.5,
    "deadfreq": 3000,
    "triggerrange": ([30, -1],),  # note: trailing-comma tuple, as upstream
    "mark_space_freqs": [400, 800],
    "bitrate": 800,
    "bit_inset": 1,
    "phase_error": 25,
    "usebandpass": False,
    "refreshrate": 2.0,
    "zcoeff_axctd": [0.72, 2.76124, -0.000238007, 0],
    "tcoeff_axctd": [-0.053328, 0.994372, 0.0, 0.0],
    "ccoeff_axctd": [-0.0622192, 1.04584, 0.0, 0.0],
    "tlims_axctd": [-10, 50],
    "slims_axctd": [-1, 100],
}

# CLI-key -> engine-key mapping used by "fixed" mode (the mapping the
# reference *intended*; see SURVEY.md 2.3 #5).
_CLI_TO_ENGINE = {
    "minR400": "minr400",
    "mindR7500": "mindr7500",
    "use_bandpass": "usebandpass",
}


@dataclasses.dataclass
class DecoderConfig:
    """Flattened engine configuration (reference load_AXCTD_settings)."""

    min_r400: float = 2.0
    min_dr7500: float = 1.5
    dead_freq: float = 3000.0
    mark_freq: float = 400.0
    space_freq: float = 800.0
    bitrate: int = 800
    bit_inset: int = 1
    phase_error: float = 25.0
    use_bandpass: bool = False
    refresh_rate: float = 2.0
    trigger_range: Sequence[float] = (30, -1)
    zcoeff_default: Sequence[float] = (0.72, 2.76124, -0.000238007, 0)
    tcoeff_default: Sequence[float] = (-0.053328, 0.994372, 0.0, 0.0)
    ccoeff_default: Sequence[float] = (-0.0622192, 1.04584, 0.0, 0.0)
    tlims: Sequence[float] = (-10, 50)
    slims: Sequence[float] = (-1, 100)
    # points per processing loop; None -> refresh_rate * fs
    points_per_loop: int | None = None
    # which compatibility mode produced this config ("strict"/"fixed");
    # strict keeps the upstream quirk that the hard-timeout trigger only
    # fires when the 7500 Hz baseline could not be computed
    # (AXCTDprocessor.py:398-404 if/elif chain)
    compat: str = "strict"

    @property
    def min_r400_inprof(self) -> float:
        return self.min_r400 / 2

    @property
    def min_dr7500_inprof(self) -> float:
        return self.min_dr7500 / 2


def resolve_settings(user_settings: dict | None, compat: str = "strict") -> DecoderConfig:
    """Build a DecoderConfig from a reference-style settings dict.

    In ``strict`` mode the dict is interpreted exactly as the reference
    engine would: engine-key names take effect, CLI-cased keys are inert,
    and the trigger range is pinned to [30, -1].  In ``fixed`` mode CLI
    keys are mapped to their intended engine keys, ``triggerrange`` is
    honored, and ``pointsperloop`` controls the loop size.
    """
    if compat not in ("strict", "fixed"):
        raise ValueError(f"compat must be 'strict' or 'fixed', got {compat!r}")
    s = dict(ENGINE_DEFAULTS)
    user = dict(user_settings or {})
    if compat == "fixed":
        for cli_key, engine_key in _CLI_TO_ENGINE.items():
            if cli_key in user:
                user[engine_key] = user.pop(cli_key)
    s.update(user)

    cfg = DecoderConfig(
        min_r400=s["minr400"],
        min_dr7500=s["mindr7500"],
        dead_freq=s["deadfreq"],
        mark_freq=s["mark_space_freqs"][0],
        space_freq=s["mark_space_freqs"][1],
        bitrate=s["bitrate"],
        bit_inset=s["bit_inset"],
        phase_error=s["phase_error"],
        use_bandpass=s["usebandpass"],
        refresh_rate=s["refreshrate"],
        zcoeff_default=s["zcoeff_axctd"],
        tcoeff_default=s["tcoeff_axctd"],
        ccoeff_default=s["ccoeff_axctd"],
        tlims=s["tlims_axctd"],
        slims=s["slims_axctd"],
    )
    cfg.compat = compat
    if compat == "strict":
        cfg.trigger_range = [30, -1]  # hardcoded upstream (AXCTDprocessor.py:250)
    else:
        tr = s.get("triggerrange", [30, -1])
        if isinstance(tr, tuple) and len(tr) == 1:  # the trailing-comma default
            tr = tr[0]
        cfg.trigger_range = list(tr)
        if "pointsperloop" in user:
            cfg.points_per_loop = int(user["pointsperloop"])
    return cfg
