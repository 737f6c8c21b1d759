"""Multi-host corpus sharding for very large archive jobs (port of
axctdprocessor_tpu.parallel.multihost).

Drops are independent, so scaling over hosts is data partitioning: each host
runs its own archive job (``parallel.archive``, on a device or a mesh of its
own) over a deterministic, disjoint slice of the corpus.  Hosts only need to
agree on the file list and on who they are; results land as per-drop reports
and per-host manifests that merge trivially.

``init_distributed`` joins a ``torch.distributed`` group over gloo where the
JAX module calls ``jax.distributed.initialize()``: the hosts exchange no
tensor, so no device backend is needed.  With no coordinator (one host) it
touches nothing and host 0 owns everything.  Size balancing uses a greedy
longest-first bin packing over file sizes so hosts finish together even with
mixed-length drops.
"""

from __future__ import annotations

import os


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Join the process group if configured; returns (process_id, count).

    `coordinator` is ``host:port`` of rank 0.  With no coordinator
    (single-host), returns (0, 1) without touching ``torch.distributed``.
    """
    if not coordinator:
        return 0, 1
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def partition_corpus(wav_paths: list[str], process_id: int,
                     process_count: int) -> list[str]:
    """This host's slice of the corpus: greedy size-balanced, deterministic.

    Every host computes the same assignment from the same sorted file
    list (no communication needed), and the slices are disjoint and
    cover the corpus.
    """
    if process_count <= 1:
        return list(wav_paths)

    def size_of(p):
        try:
            return os.path.getsize(p)
        except OSError:
            return 0

    ranked = sorted(sorted(wav_paths), key=size_of, reverse=True)
    loads = [0] * process_count
    mine = []
    for path in ranked:
        target = loads.index(min(loads))
        loads[target] += max(size_of(path), 1)
        if target == process_id:
            mine.append(path)
    return mine


def reprocess_corpus_multihost(wav_paths: list[str], out_dir: str,
                               coordinator: str | None = None,
                               num_processes: int | None = None,
                               process_id: int | None = None,
                               **kwargs) -> dict:
    """Archive reprocessing across hosts: partition, then run this host's
    share with parallel.archive (per-host manifest under out_dir/host<k>);
    ``device=`` or ``mesh=`` and the rest of `kwargs` go to
    ``reprocess_corpus``."""
    from .archive import reprocess_corpus

    pid, count = init_distributed(coordinator, num_processes, process_id)
    mine = partition_corpus(wav_paths, pid, count)
    host_dir = os.path.join(out_dir, f"host{pid}") if count > 1 else out_dir
    return reprocess_corpus(mine, host_dir, **kwargs)
