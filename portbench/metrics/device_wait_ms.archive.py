"""device_wait_ms.archive: ms per batch in the program's device_wait span: the host blocked
on a batch's copy down (inside device.fetch_batch)."""
from portbench.core.readers import span_ms_per_batch


def read(reading):
    return span_ms_per_batch(reading, "device_wait")
