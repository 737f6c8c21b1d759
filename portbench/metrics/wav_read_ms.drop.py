"""wav_read_ms.drop: ms per drop in the program's read_wav span (the WAV read of decode_wav)."""
from portbench.core.readers import span_ms_per_unit


def read(reading):
    return span_ms_per_unit(reading, ["read_wav"])
