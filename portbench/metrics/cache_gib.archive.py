"""cache_gib.archive: GiB, the most the program cache held on the card since the process
started (``programs.cache_stats(device)["peak_held_bytes"]``: its graphs' pools and static
inputs), read after the run's passes.  Nothing where the port has no ``cache_stats``."""


def read(reading):
    import torch

    from axctdprocessor_tpu_torch.models import programs

    stats = getattr(programs, "cache_stats", None)
    if stats is None or not torch.cuda.is_available():
        return None
    return stats(torch.device("cuda", 0))["peak_held_bytes"] / 2 ** 30
