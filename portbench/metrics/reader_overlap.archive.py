"""reader_overlap.archive: how many files the runner's reader threads read at once, on average,
while a batch loaded: the seconds of every file's io.read_file span over those of the batches'
io.read_wavs spans (1.0 for files read one after another)."""
from portbench.core.readers import span_ms_per_batch


def read(reading):
    files = span_ms_per_batch(reading, "io.read_file")
    batches = span_ms_per_batch(reading, "io.read_wavs")
    if files is None or not batches:
        return None
    return files / batches
