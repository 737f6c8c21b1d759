"""fetch_wait_ms.archive: ms per batch in device.fetch_batch: the host waiting on the card."""
from portbench.core.readers import span_ms_per_batch


def read(reading):
    return span_ms_per_batch(reading, "device.fetch_batch")
