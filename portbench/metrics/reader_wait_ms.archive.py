"""reader_wait_ms.archive: ms per batch in the runner's io.wait_reader span: its main thread
waiting for the reader threads' batch."""
from portbench.core.readers import span_ms_per_batch


def read(reading):
    return span_ms_per_batch(reading, "io.wait_reader")
