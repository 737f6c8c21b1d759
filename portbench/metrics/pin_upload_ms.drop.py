"""pin_upload_ms.drop: ms per drop in the program's pin_upload spans (pinning host arrays
and queueing their copies to the card: the monolithic program's input, each segment group)."""
from portbench.core.readers import span_ms_per_unit


def read(reading):
    return span_ms_per_unit(reading, ["pin_upload"])
