"""setup_s: process start to the start of the measured window (s)."""


def read(reading):
    return reading.setup_s
