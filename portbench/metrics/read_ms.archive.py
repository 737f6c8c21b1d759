"""read_ms.archive: ms per batch in the runner's io.read_wavs span (its reader threads)."""
from portbench.core.readers import span_ms_per_batch


def read(reading):
    return span_ms_per_batch(reading, "io.read_wavs")
