"""pad_ms.archive: ms per batch in the runner's pad_batch span (the zero-padded (B, N) array)."""
from portbench.core.readers import span_ms_per_batch


def read(reading):
    return span_ms_per_batch(reading, "pad_batch")
