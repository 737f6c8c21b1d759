# Frozen copy of design_sos from axctdprocessor_tpu_torch/ops/iir.py at commit 05168f0.
"""The demodulation filter's design (scipy, float64)."""

from __future__ import annotations


def design_sos(fs: float, use_bandpass: bool = False) -> np.ndarray:
    """Order-6 Butterworth SOS (100-1200 Hz bandpass or 1200 Hz lowpass)."""
    from scipy import signal

    if use_bandpass:
        return signal.butter(6, [100, 1200], btype="bandpass", fs=fs, output="sos")
    return signal.butter(6, 1200, btype="lowpass", fs=fs, output="sos")
