"""program_build_ms.archive: ms per batch in the program cache's builds, first (eager)
runs, captures and evictions (program_build_ms.drop's spans).  0.0 in a window that rebuilt
nothing; nothing where the program opens no device_wait either."""

SPANS = ("program.build", "program.eager", "program.capture", "program.evict")


def read(reading):
    batches = sum(s.batches for s in reading.steps)
    if not batches or not any("device_wait" in s.spans for s in reading.steps):
        return None
    return 1e3 * sum(s.spans.get(n, 0.0) for s in reading.steps for n in SPANS) / batches
