"""report_ms.drop: ms per drop in the port's write_report (the client's span)."""
from portbench.core.readers import span_ms_per_unit


def read(reading):
    return span_ms_per_unit(reading, ["write_report"])
