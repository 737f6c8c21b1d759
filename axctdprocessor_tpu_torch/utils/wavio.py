"""WAV ingest and signal conditioning.

A copy of axctdprocessor_tpu.utils.wavio (``read_wav`` and
``read_wav_raw16``, whole): the port imports nothing of the JAX package.

Behavioral contract from reference readAXCTDwavfile (AXCTDprocessor.py:38-73):
stereo inputs use channel 0; the signal is DC-removed and peak-normalized
in float64; sample rates above 50 kHz are decimated by 2 (scipy FIR
decimator, which also halves fs — to a float, which then prints as e.g.
``48000.0`` in the report).

Time-range trimming is *dead code* upstream — it references ``self``
inside a module-level function and raises NameError for any nonzero
``-s``/``-e`` (SURVEY.md 2.3 #2).  Here trimming works: end first, then
start, both relative to the decimated rate, matching the obviously
intended semantics.
"""

from __future__ import annotations

import numpy as np
from scipy import signal
from scipy.io import wavfile


def read_wav(path: str, timerange=(0, -1)):
    """Read + condition an AXCTD WAV.  Returns (pcm float64, fs int|float)."""
    fs, snd = wavfile.read(path)
    if snd.ndim == 2:
        snd = snd[:, 0]
    elif snd.ndim != 1:
        raise ValueError("audio file has more than 2 dimensions")

    # DC offset and peak are computed on the raw integer array before the
    # float cast (order matters for bit parity, AXCTDprocessor.py:55-57)
    dc = np.mean(snd)
    peak = np.max(np.abs(snd))
    pcm = (snd.astype(np.float64) - dc) / peak

    if fs > 50000:
        pcm = signal.decimate(pcm, 2)
        fs /= 2

    if timerange[1] > 0:
        pcm = pcm[: int(fs * timerange[1])]
    if timerange[0] > 0:
        pcm = pcm[int(fs * timerange[0]):]

    return pcm, fs


def read_wav_raw16(path: str, timerange=(0, -1), allow_highrate=False):
    """Raw int16 mono samples + fs, or None if this WAV needs the full
    conditioning path (stereo uses ch0; non-int16 needs float
    conditioning; >50 kHz needs the decimator unless the caller
    decimates on device — ``allow_highrate``).

    The engines condition integer PCM on the device, so this read avoids
    both the host float conversion and half the host->device bytes.
    """
    fs, snd = wavfile.read(path, mmap=True)
    if (fs > 50000 and not allow_highrate) or snd.dtype != np.int16:
        return None
    if snd.ndim == 2:
        snd = snd[:, 0]
    elif snd.ndim != 1:
        return None
    snd = np.ascontiguousarray(snd)
    if timerange[1] > 0:
        snd = snd[: int(fs * timerange[1])]
    if timerange[0] > 0:
        snd = snd[int(fs * timerange[0]):]
    return snd, fs
