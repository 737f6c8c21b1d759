"""Scale-out: batched multi-drop decode (DP) and time-axis sharding (SP).

The reference is strictly single-threaded; these are the scale axes of the
JAX package, module for module:

* :mod:`.mesh` — a mesh is a grid of ``torch.device``s with named axes,
  driven by one process; a device may stand at several places of it;
* :mod:`.batch` — multi-drop decode with one tone-ratio launch per batch,
  data-parallel over a mesh's ``dp`` axis (the archive-reprocessing path);
* :mod:`.timeshard` — one long waveform's time axis cut over the devices of
  the ``sp`` axis, with halo copies between neighbours for filter warm-up
  and window overlap;
* :mod:`.pipeline` — two-stage front-end/back-half pipeline, on one device
  or with the back half placed on a second;
* :mod:`.archive` — corpus reprocessing with length bucketing, threaded
  read-ahead, dispatch/fetch software pipelining, and manifest
  checkpoint/resume;
* :mod:`.multihost` — corpus sharding across hosts (deterministic
  size-balanced partitioner; ``torch.distributed`` over gloo only to agree
  on ranks).
"""
