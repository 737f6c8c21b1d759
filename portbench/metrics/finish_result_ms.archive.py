"""finish_result_ms.archive: ms per batch in the program's host_finish span (finish_result
over the batch's rows, inside device.fetch_batch)."""
from portbench.core.readers import span_ms_per_batch


def read(reading):
    return span_ms_per_batch(reading, "host_finish")
