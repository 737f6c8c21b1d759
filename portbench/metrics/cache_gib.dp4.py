"""cache_gib.dp4: GiB, the most any one card's program cache held since the process started:
the largest of ``programs.cache_stats(card)["peak_held_bytes"]`` (its graphs' pools and static
inputs) over the CARDS cards of the mesh, read after the run's passes.  Nothing where the port
has no ``cache_stats`` or there is no card."""

CARDS = 4  # the cell's dp mesh


def read(reading):
    import torch

    from axctdprocessor_tpu_torch.models import programs

    stats = getattr(programs, "cache_stats", None)
    if stats is None or not torch.cuda.is_available():
        return None
    return max(stats(torch.device("cuda", k))["peak_held_bytes"] for k in range(CARDS)) / 2 ** 30
