"""Comparison of packed result vectors (``engine.unpack_result`` layout)
from the port and the JAX engine when each computed its own tone ratios.

Every integer field must be equal: trigger indices, frame counts, header
frames, frame words and frame-start samples.  What the smoothed tone
ratios reach may move: the port sums the six box taps (the JAX engine
takes a float32 prefix sum) and torch's ``log10`` differs from XLA's in the
last bit, so a 2-decimal ratio can move by one centi-unit and ``mean7500``
(the 7500 Hz baseline, a sum of ratios) by a few ulps.
"""

import numpy as np

from axctdprocessor_tpu_torch.models import engine


def assert_packed_close(got: np.ndarray, want: np.ndarray, max_moved: int = 10) -> int:
    """Holds `got` to `want` as above; returns how many ratios moved."""
    assert got.dtype == np.int32 and got.shape == want.shape
    g, w = engine.unpack_result(got), engine.unpack_result(want)
    for name in ("scal_i", "hdr", "hexpack", "edges"):
        np.testing.assert_array_equal(g[name], w[name], err_msg=name)
    assert g["scal_f"][1] == w["scal_f"][1]  # calibration scale
    np.testing.assert_allclose(g["scal_f"][0], w["scal_f"][0], rtol=1e-5)  # mean7500
    moved = g["ratios"].astype(np.int32) - w["ratios"]
    assert np.abs(moved).max(initial=0) <= 1
    assert np.count_nonzero(moved) <= max_moved
    return int(np.count_nonzero(moved))
