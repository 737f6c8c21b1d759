"""Device mesh construction (port of axctdprocessor_tpu.parallel.mesh).

A mesh is a grid of ``torch.device``s with named axes.  One Python process
drives every place of it, as ``shard_map`` is single-controller in JAX: the
caller of a mesh runs a plain function on tensors once per place, on that
place's device.  The same device may stand at several places (that is how a
2 x 4 mesh runs on one CPU or on one card), but only when the caller's
device list says so.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.engine import resolve_device


class Mesh:
    """A grid of ``torch.device``s (`devices`, an object array) with one
    name per axis; ``mesh.shape`` maps each name to its size, as
    ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device grid with axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def devices_along(self, axis: str, **at: int) -> list[torch.device]:
        """The devices along `axis`, at index ``at[name]`` (0 where none is
        given) of every other axis.  It stands for the JAX module's
        ``shard_over`` (a ``NamedSharding`` that places an array dimension
        over a mesh axis): here the caller cuts the array itself and puts
        run k on ``devices_along(axis)[k]``; an axis it does not name is one
        the array is replicated over in JAX and simply not used here."""
        index = tuple(slice(None) if name == axis else at.get(name, 0)
                      for name in self.axis_names)
        return list(self.devices[index])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def make_mesh(shape: dict[str, int] | None = None, devices=None) -> Mesh:
    """Build a named mesh, e.g. ``make_mesh({"dp": 4, "sp": 2})``.

    `devices` is a list of ``torch.device``s (or their names) and may
    repeat one; ``None`` is every visible CUDA device, and raises without a
    GPU.  ``shape=None`` is one ``dp`` axis over all of them.
    """
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if shape is None:
        shape = {"dp": len(devices)}
    names = tuple(shape.keys())
    dims = tuple(shape.values())
    total = int(np.prod(dims))
    if total > len(devices):
        raise ValueError(f"mesh {shape} needs {total} devices, have {len(devices)}")
    arr = np.empty(total, dtype=object)
    arr[:] = devices[:total]
    return Mesh(arr.reshape(dims), names)
