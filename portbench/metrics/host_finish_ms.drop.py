"""host_finish_ms.drop: ms per drop in the program's fetch and host_finish spans
(the segmented engine; the monolithic program has none)."""
from portbench.core.readers import span_ms_per_unit


def read(reading):
    return span_ms_per_unit(reading, ["fetch", "host_finish"])
