"""device_wait_ms.drop: ms per drop in the program's device_wait span: the host blocked on
the card before the copy down (the first part of fetch)."""
from portbench.core.readers import span_ms_per_unit


def read(reading):
    return span_ms_per_unit(reading, ["device_wait"])
