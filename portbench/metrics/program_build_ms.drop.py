"""program_build_ms.drop: ms per drop in the program cache's builds, first (eager) runs,
captures and evictions: the spans program.build, program.eager, program.capture and
program.evict, which do not nest in one another.  0.0 in a window that rebuilt nothing;
nothing where the program opens no device_wait either (a program without these spans)."""

SPANS = ("program.build", "program.eager", "program.capture", "program.evict")


def read(reading):
    if not any("device_wait" in s.spans for s in reading.steps):
        return None
    return 1e3 * sum(s.spans.get(n, 0.0) for s in reading.steps for n in SPANS) \
        / len(reading.steps)
