"""The work a cell's inputs need, counted from the inputs alone (never from
the shapes, padding or starts the port produces): the arithmetic behind the
roofline metrics.

Tone powers (``tone_ratios_kernel``, the ratios and the raw-powers variant):
every true sample at the decode rate read once as float32, two float32
outputs per power window; per window three tones of a ``fs / 10``-sample
DFT bin, 4 flop a sample and tone.  Windows advance ``fs / 25`` samples.

Per-bit probes (``probe_run_kernel``): 800 probes a second of audio, each
two tones over the probe window of the decoder's config (4 flop a sample
and tone), reading the covered samples once, an int64 start and writing
two float32 powers.
"""

from __future__ import annotations

from ..reference.config import DecoderConfig
from .peaks import least_seconds

POWER_RATE = 25  # power windows a second (the decoder's grid)


def windows(samples: float, fs: float) -> float:
    n_power, d_pcm = int(fs / 10), int(round(fs / POWER_RATE))
    return max((samples - n_power) / d_pcm, 0.0)


def tone_least_seconds(samples: float, fs: float) -> float:
    n_win = windows(samples, fs)
    nbytes = 4.0 * samples + 8.0 * n_win
    flop = n_win * 3 * int(fs / 10) * 4
    return least_seconds(nbytes, flop)


def probe_window(fs: float, cfg: DecoderConfig | None = None) -> int:
    cfg = cfg or DecoderConfig()
    return int(round(fs / cfg.bitrate * (1 - cfg.phase_error / 100))) - 2 * cfg.bit_inset


def probe_least_seconds(samples: float, fs: float) -> float:
    probes = samples / fs * DecoderConfig().bitrate
    window = probe_window(fs)
    covered = min(samples, probes * window)
    nbytes = 4.0 * covered + probes * (8 + 8)
    flop = probes * 2 * window * 4
    return least_seconds(nbytes, flop)
