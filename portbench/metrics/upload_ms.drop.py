"""upload_ms.drop: ms per drop in the program's build_upload and encode_chunks spans."""
from portbench.core.readers import span_ms_per_unit


def read(reading):
    return span_ms_per_unit(reading, ["build_upload", "encode_chunks"])
