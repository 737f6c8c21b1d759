"""dispatch_ms.dp4: ms per batch in the mesh's runs (``parallel/batch.dispatch_batch``'s span
``mesh.run``, one a card: the run's encode, program lookup, pinned upload, launch or replay
and the queued fetch), summed over the batch's runs.  Nothing where the program opens no such
span."""
from portbench.core.readers import span_ms_per_batch


def read(reading):
    return span_ms_per_batch(reading, "mesh.run")
