"""finish_result_ms.drop: ms per drop in the program's host_finish span (finish_result on
the copied result, both engines)."""
from portbench.core.readers import span_ms_per_unit


def read(reading):
    return span_ms_per_unit(reading, ["host_finish"])
