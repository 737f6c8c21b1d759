"""mesh_pad_ms.dp4: ms per batch in the mesh cut's padding (``parallel/batch.dispatch_batch``'s
span ``mesh.pad``: a batch whose rows are not a multiple of the mesh's dp pads its last run with
row 0 again; the span holds the copy of each such run, or of the whole batch where the program
pads it whole).  Nothing where the program opens no such span."""
from portbench.core.readers import span_ms_per_batch


def read(reading):
    return span_ms_per_batch(reading, "mesh.pad")
