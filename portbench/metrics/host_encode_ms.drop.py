"""host_encode_ms.drop: ms per drop in the program's host_encode_stats span."""
from portbench.core.readers import span_ms_per_unit


def read(reading):
    return span_ms_per_unit(reading, ["host_encode_stats"])
