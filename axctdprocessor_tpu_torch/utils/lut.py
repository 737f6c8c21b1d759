"""Temperature lookup table (4096 12-bit codes -> uncalibrated deg C).

A copy of axctdprocessor_tpu.utils.lut that reads the port's own package
data (``axctdprocessor_tpu_torch/data/temp_LUT.txt``, a verbatim copy of the
JAX package's table): the port imports nothing of the JAX package.

The AXCTD probe transmits temperature as a 12-bit integer indexing a
4096-entry LUT (reference parse.py:139-147, data temp_LUT.txt).  Codes
0, 4094 and 4095 are ``-99.0`` sentinels.  :func:`load_temp_lut` parses it
exactly as the reference does (``float`` of the second comma field per
line) so values are bit-identical.
"""

from __future__ import annotations

import functools
from importlib import resources

import numpy as np

LUT_SIZE = 4096
SENTINEL = -99.0


@functools.lru_cache(maxsize=None)
def load_temp_lut() -> np.ndarray:
    """Load the packaged temperature LUT as a float64 array of length 4096."""
    text = (
        resources.files("axctdprocessor_tpu_torch.data")
        .joinpath("temp_LUT.txt")
        .read_text()
    )
    vals = []
    for line in text.splitlines():
        fields = line.strip().split(",")
        if len(fields) >= 2:
            vals.append(float(fields[1]))
    lut = np.asarray(vals, dtype=np.float64)
    if lut.shape != (LUT_SIZE,):
        raise RuntimeError(f"temp LUT has {lut.shape} entries, expected {LUT_SIZE}")
    return lut
