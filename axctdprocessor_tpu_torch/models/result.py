"""The decode result container.

A jax-free copy of ``DecodeResult`` from
axctdprocessor_tpu.models.parity_engine (whose module loads jax through its
imports), with the same fields and defaults, so the report writer and every
consumer read both engines' results alike.
"""

from __future__ import annotations

import dataclasses

from . import metadata as md


@dataclasses.dataclass
class DecodeResult:
    """Everything the report writer and downstream consumers need."""

    fs: float
    numpoints: int
    firstpulse400: int = -1
    profstartind: int = -1
    firstpointtime: float = -1.0
    status: int = 0
    metadata: dict = dataclasses.field(default_factory=md.new_metadata)
    time: list = dataclasses.field(default_factory=list)
    r400: list = dataclasses.field(default_factory=list)
    r7500: list = dataclasses.field(default_factory=list)
    depth: list = dataclasses.field(default_factory=list)
    temperature: list = dataclasses.field(default_factory=list)
    conductivity: list = dataclasses.field(default_factory=list)
    salinity: list = dataclasses.field(default_factory=list)
    # all frames, unfiltered (upstream quirk kept for report parity)
    hexframes: list = dataclasses.field(default_factory=list)
    # hex of only the QC-passing frames, aligned with the row lists above
    hexframes_qc: list = dataclasses.field(default_factory=list)
    # resolved host->device wire format ("int16"/"int8"/"int4"/"float32")
    wire: str | None = None
    # truncation indicator (0 = clean): bit 0 crossings hit capacity, bit 1
    # bit-edge table full, bit 2 frame-sync accept compaction overflowed,
    # bit 3 frame table full
    overflow: int = 0
