"""convert_ms.drop: ms per drop in the program's convert span (the LUT, polynomials and
salinity of finish_result, on the host)."""
from portbench.core.readers import span_ms_per_unit


def read(reading):
    return span_ms_per_unit(reading, ["convert"])
