"""Synthetic AXCTD signal generator — the encoder inverse of the decoder.

A jax-free copy of axctdprocessor_tpu.models.simulator (which loads jax
through its ``ops`` imports): the same drop from the same ``SimSpec``,
sample for sample, so a machine without jax can make test drops.

Generates physically faithful AXCTD probe audio for tests, benchmarks and
golden-parity fixtures (the reference ships no fixtures at all).  The
transmission model follows the AXCTD format the decoder expects
(reference README.md:75-107, AXCTDprocessor.py:433-456):

* three pulse+header transmissions: a 1.8 s 400 Hz pulse (equivalently a
  run of mark bits), then 72 header frames (2.88 s at 25 frames/s), then
  a 5 s quiet gap — a ~9.68 s cycle, so header 2 lands in the decoder's
  [t0+10.5, t0+14.8] capture window and header 3 in [t0+20, t0+24.5];
* a continuous 7500 Hz profile-start tone plus an 800-baud FSK profile
  bitstream of 32-bit frames: '10' + 12-bit conductivity + 12-bit
  temperature + CRC-6;
* broadband Gaussian noise throughout (the decoder normalizes tone powers
  by a "dead" frequency, so a noise floor is required).

FSK is phase-continuous (true FM): per-sample frequency from the current
bit, phase accumulated by cumulative sum — mark bits advance phase by pi
per bit and space bits by 2*pi, which is what makes zero-crossing bit
tracking work.

Header frame layout encoded here (decode contract at reference
parse.py:197-285): bits 0-1 '10', bits 2-9 counter (plain 8-bit for 0-63,
'11111'+3 bits for 64-71), bits 10-25 four hex nibbles of data, bits
26-31 CRC-6.  Frames 4-5 serial, 6 max depth, 7 probe code, 12-23 /
24-35 / 36-47 the z/t/c cubic coefficients, three frames per coefficient,
high frame first, as sign+7-digit-mantissa/sign+2-digit-exponent decimal
strings with '+' as nibble 0xB and '-' as 0xD.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..ops import crc
from ..ops.bits import bits_to_hex_np, int_to_bits_np
from ..utils.lut import load_temp_lut

FRAME_BITS = 32
HEADER_FRAMES = 72
BITRATE = 800
FRAMES_PER_SEC = 25


# ---------------------------------------------------------------------------
# Frame encoders
# ---------------------------------------------------------------------------

def encode_counter_bits(counter: int) -> np.ndarray:
    """Header frame counter field: 8 bits plain for 0-63, '11111'+3 for 64-71."""
    if not 0 <= counter <= 71:
        raise ValueError(f"counter out of range: {counter}")
    if counter < 64:
        return int_to_bits_np(counter, 8)
    return np.concatenate([np.ones(5, dtype=np.int64), int_to_bits_np(counter - 64, 3)])


def encode_header_frame(counter: int, data_nibbles: str) -> np.ndarray:
    """One 32-bit header frame: '10' + counter + 16 data bits + CRC-6."""
    if len(data_nibbles) != 4:
        raise ValueError("header frame data must be 4 hex nibbles")
    data_bits = np.concatenate(
        [int_to_bits_np(int(ch, 16), 4) for ch in data_nibbles]
    )
    payload = np.concatenate([[1, 0], encode_counter_bits(counter), data_bits])
    return crc.encode_crc_np(payload)


def encode_profile_frame(tint: int, cint: int) -> np.ndarray:
    """One 32-bit profile frame: '10' + 12-bit Cint + 12-bit Tint + CRC-6."""
    payload = np.concatenate([[1, 0], int_to_bits_np(cint, 12), int_to_bits_np(tint, 12)])
    return crc.encode_crc_np(payload)


def coefficient_to_hex12(value: float) -> str:
    """Encode a conversion coefficient as the 12-nibble header string.

    Format: sign nibble ('b'=+, 'd'=-), 8 mantissa digits (value/10^exp
    scaled to d.ddddddd * 1e7), sign nibble, 2 exponent digits; e.g.
    0.72 -> 'b72000000d01' which decodes as +7200000/1e7 * 10**-1.
    """
    if value == 0:
        return "b00000000b00"
    sign = "b" if value > 0 else "d"
    mag = abs(value)
    exp = math.floor(math.log10(mag))
    mant = round(mag / 10.0**exp * 1e7)
    if mant >= 1e8:  # rounding pushed us to 10.0000000
        mant = round(mant / 10)
        exp += 1
    esign = "b" if exp >= 0 else "d"
    return f"{sign}{mant:08d}{esign}{abs(exp):02d}"


def decode_hex12(chex: str) -> float:
    """Decode a 12-nibble coefficient string (the decoder's contract)."""
    s = chex.upper().replace("B", "+").replace("D", "-")
    return int(s[:9]) / 1e7 * 10 ** int(s[9:])


def encode_header_frames(
    serial_hex: str = "00123456",
    max_depth_hex: str = "1000",
    probe_code_hex: str = "a000",
    zcoeff: tuple = (0.72, 2.76124, -0.000238007, 0.0),
    tcoeff: tuple = (-0.053328, 0.994372, 0.0, 0.0),
    ccoeff: tuple = (-0.0622192, 1.04584, 0.0, 0.0),
) -> np.ndarray:
    """All 72 header frames as a (72, 32) bit matrix.

    Coefficient i of z/t/c occupies frames (21,18,15,12)[i] / (33,30,27,24)[i]
    / (45,42,39,36)[i] and the two following, 4 nibbles per frame, high
    frame first.  Frames with no assigned payload carry zeros.
    """
    if len(serial_hex) != 8 or len(max_depth_hex) != 4 or len(probe_code_hex) != 4:
        raise ValueError("serial must be 8 nibbles; depth/probe code 4 nibbles")
    data = ["0000"] * HEADER_FRAMES
    data[4], data[5] = serial_hex[:4], serial_hex[4:]
    data[6] = max_depth_hex
    data[7] = probe_code_hex
    for coeffs, bases in (
        (zcoeff, (21, 18, 15, 12)),
        (tcoeff, (33, 30, 27, 24)),
        (ccoeff, (45, 42, 39, 36)),
    ):
        for i, base in enumerate(bases):
            hex12 = coefficient_to_hex12(float(coeffs[i]))
            for j in range(3):
                data[base + j] = hex12[4 * j : 4 * j + 4]
    return np.stack(
        [encode_header_frame(k, data[k]) for k in range(HEADER_FRAMES)]
    )


# ---------------------------------------------------------------------------
# Waveform synthesis
# ---------------------------------------------------------------------------

def fsk_waveform(bits: np.ndarray, fs: float, f_mark: float = 400.0,
                 f_space: float = 800.0, bitrate: float = BITRATE,
                 phase0: float = 0.0) -> np.ndarray:
    """Phase-continuous FSK: mark (bit 1) at `f_mark`, space (bit 0) at `f_space`.

    The phase is evaluated in continuous time with frequency switches at
    the exact (fractional-sample) bit boundaries k/bitrate, so each mark
    bit advances the phase by exactly pi and each space bit by exactly
    2*pi.  Quantizing the switch to sample boundaries instead would make
    per-bit phase errors random-walk until zero crossings drift off the
    bit grid and FSK zero-crossing tracking breaks.
    """
    bits = np.asarray(bits).ravel()
    freq_per_bit = np.where(bits == 1, f_mark, f_space).astype(np.float64)
    # phase at the start of each bit (exact multiples of pi by construction)
    phase_at_bit = phase0 + np.concatenate(
        [[0.0], np.cumsum(2 * np.pi * freq_per_bit / bitrate)]
    )
    nsamp = int(math.ceil(len(bits) * fs / bitrate))
    t = np.arange(nsamp) / fs
    bit_of_sample = np.minimum((t * bitrate).astype(np.int64), len(bits) - 1)
    t_in_bit = t - bit_of_sample / bitrate
    phase = (
        phase_at_bit[bit_of_sample]
        + 2 * np.pi * freq_per_bit[bit_of_sample] * t_in_bit
    )
    return np.sin(phase)


def tint_for_temperature(temp_c: np.ndarray) -> np.ndarray:
    """Nearest LUT code for target uncalibrated temperature(s)."""
    lut = load_temp_lut()
    valid = lut[1:4094]  # sentinel -99.0 at 0, 4094, 4095
    idx = np.searchsorted(valid, np.atleast_1d(temp_c))
    idx = np.clip(idx, 1, len(valid) - 1)
    below = valid[idx - 1]
    above = valid[idx]
    pick = np.where(np.abs(np.asarray(temp_c) - below) <= np.abs(above - np.asarray(temp_c)),
                    idx - 1, idx)
    return pick + 1


def cint_for_conductivity(cond: np.ndarray) -> np.ndarray:
    """Nearest 12-bit code for uncalibrated conductivity (Cuncal = Cint*60/4096)."""
    return np.clip(np.round(np.asarray(cond) * 4096.0 / 60.0), 0, 4095).astype(np.int64)


@dataclasses.dataclass
class SimSpec:
    """Parameters of a synthetic AXCTD drop."""

    fs: int = 44100
    duration: float = 50.0
    pulse_start: float = 1.0          # start of the first 400 Hz pulse (s)
    pulse_len: float = 1.8
    gap_len: float = 5.0
    profile_start: float = 33.0       # 7500 Hz tone + profile bits begin (s)
    noise_rms: float = 0.02
    fsk_amp: float = 1.0
    tone7500_amp: float = 0.35
    serial_hex: str = "00123456"
    max_depth_hex: str = "1000"
    probe_code_hex: str = "a000"
    # relative transmitter frequency error (crystal drift): all probe
    # tones (mark/space FSK, pulses, 7500 Hz) scale by (1 + freq_error)
    freq_error: float = 0.0
    zcoeff: tuple = (0.72, 2.76124, -0.000238007, 0.0)
    tcoeff: tuple = (-0.053328, 0.994372, 0.0, 0.0)
    ccoeff: tuple = (-0.0622192, 1.04584, 0.0, 0.0)
    seed: int = 0

    @property
    def header_len(self) -> float:
        return HEADER_FRAMES * FRAME_BITS / BITRATE  # 2.88 s

    @property
    def cycle_len(self) -> float:
        return self.pulse_len + self.header_len + self.gap_len  # 9.68 s


def default_profile_ints(n_frames: int) -> tuple[np.ndarray, np.ndarray]:
    """A smooth, realistic T/C profile in integer code space.

    Temperature decays from ~22 C toward ~8 C; conductivity from ~48
    toward ~35 mS/cm (uncalibrated units) — giving salinities around
    30-40 PSU after default calibration, comfortably inside QC bounds.
    """
    k = np.arange(n_frames)
    temp = 22.0 - 14.0 * (1 - np.exp(-k / (0.6 * max(n_frames, 1))))
    cond = 48.0 - 13.0 * (1 - np.exp(-k / (0.6 * max(n_frames, 1))))
    return tint_for_temperature(temp), cint_for_conductivity(cond)


def synthesize(spec: SimSpec | None = None,
               tints: np.ndarray | None = None,
               cints: np.ndarray | None = None):
    """Render a synthetic AXCTD drop.

    Returns ``(pcm, truth)`` where ``pcm`` is a float64 waveform in
    [-~1, ~1] and ``truth`` records everything the decoder should recover
    (header fields, coefficients, per-frame Tint/Cint, timing).
    """
    spec = spec or SimSpec()
    rng = np.random.default_rng(spec.seed)
    nsamp = int(spec.duration * spec.fs)
    pcm = rng.standard_normal(nsamp) * spec.noise_rms

    header_frames = encode_header_frames(
        spec.serial_hex, spec.max_depth_hex, spec.probe_code_hex,
        spec.zcoeff, spec.tcoeff, spec.ccoeff,
    )
    # one transmission = pulse (run of mark bits) + 72 header frames
    n_pulse_bits = int(round(spec.pulse_len * BITRATE))
    tx_bits = np.concatenate([np.ones(n_pulse_bits, dtype=np.int64),
                              header_frames.ravel()])

    scale = 1.0 + spec.freq_error
    for k in range(3):
        start = spec.pulse_start + k * spec.cycle_len
        wave = fsk_waveform(tx_bits, spec.fs, f_mark=400.0 * scale,
                            f_space=800.0 * scale,
                            bitrate=BITRATE * scale) * spec.fsk_amp
        s = int(round(start * spec.fs))
        if s >= nsamp:  # drop too short for this transmission cycle
            continue
        e = min(s + len(wave), nsamp)
        pcm[s:e] += wave[: e - s]

    # profile: FSK frames + 7500 Hz tone from profile_start to end of file
    # (a profile_start at/past the end of file means no profile at all —
    # useful for pulse-only / no-trigger fixtures)
    prof_samples = nsamp - int(round(spec.profile_start * spec.fs))
    n_frames = max(int(prof_samples / spec.fs * FRAMES_PER_SEC) - 1, 0)
    if tints is None or cints is None:
        tints, cints = default_profile_ints(n_frames)
    else:
        n_frames = len(tints)
    prof_frames = (np.stack([encode_profile_frame(t, c)
                             for t, c in zip(tints, cints)])
                   if n_frames > 0 else np.zeros((0, FRAME_BITS), np.int64))
    s = min(int(round(spec.profile_start * spec.fs)), nsamp)
    if n_frames > 0:
        prof_bits = prof_frames.ravel()
        wave = fsk_waveform(prof_bits, spec.fs, f_mark=400.0 * scale,
                            f_space=800.0 * scale,
                            bitrate=BITRATE * scale) * spec.fsk_amp
        e = min(s + len(wave), nsamp)
        pcm[s:e] += wave[: e - s]
    t7500 = np.arange(nsamp - s) / spec.fs
    pcm[s:] += spec.tone7500_amp * np.sin(2 * np.pi * 7500.0 * scale * t7500)

    truth = {
        "spec": spec,
        "header_frames": header_frames,
        "serial_no": spec.serial_hex,
        "max_depth": spec.max_depth_hex,
        "probe_code": spec.probe_code_hex,
        "zcoeff": [decode_hex12(coefficient_to_hex12(v)) for v in spec.zcoeff],
        "tcoeff": [decode_hex12(coefficient_to_hex12(v)) for v in spec.tcoeff],
        "ccoeff": [decode_hex12(coefficient_to_hex12(v)) for v in spec.ccoeff],
        "tints": np.asarray(tints),
        "cints": np.asarray(cints),
        "frame_hex": [bits_to_hex_np(f) for f in prof_frames],
        "profile_start_sample": s,
    }
    return pcm, truth


def write_wav(path: str, pcm: np.ndarray, fs: int, peak: int = 28000) -> None:
    """Write PCM to a 16-bit mono WAV (scaled to `peak` at max amplitude)."""
    from scipy.io import wavfile

    x = np.asarray(pcm, dtype=np.float64)
    scale = peak / max(np.max(np.abs(x)), 1e-12)
    wavfile.write(path, int(fs), (x * scale).astype(np.int16))
