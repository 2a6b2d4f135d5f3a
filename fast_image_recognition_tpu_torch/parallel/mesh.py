"""Device meshes (JAX ``parallel/mesh.py``): axes ``data``, ``gallery``,
``model``; a :class:`Mesh` is a grid of ``torch.device``s one process drives,
a device may repeat."""

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


class Mesh:
    """A numpy object array of ``torch.device``s and one name per axis."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-d device grid needs {devices.ndim} axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def shard_devices(self, axes: Tuple[str, ...]) -> list:
        """The shards' devices over ``axes``, first axis major; other axes hold replicas."""
        order = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(self.devices.ndim) if i not in order]
        grid = np.transpose(self.devices, order + rest)
        grid = grid.reshape(grid.shape[: len(axes)] + (-1,))[..., 0]
        return list(grid.reshape(-1))


def _devices(devices: Optional[Sequence[DeviceLike]]) -> list:
    """``None``: every visible CUDA device (raises without one); else the given ones, repeats kept."""
    if devices is None:
        resolve_device(None)  # raises without a card
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [resolve_device(d) for d in devices]


def make_mesh(data: int = 1, gallery: int = 1, model: int = 1, devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    devices = _devices(devices)
    need = data * gallery * model
    if need > len(devices):
        raise ValueError(f"mesh {data}x{gallery}x{model} needs {need} devices, have {len(devices)}")
    grid = np.empty(need, dtype=object)
    grid[:] = devices[:need]
    return Mesh(grid.reshape(data, gallery, model), ("data", "gallery", "model"))


def gallery_mesh(num_shards: Optional[int] = None, devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A 1-axis mesh over all (or the first ``num_shards``) devices for gallery sharding."""
    devices = _devices(devices)
    n = num_shards if num_shards is not None else len(devices)
    if n > len(devices):
        raise ValueError(f"{n} gallery shards need {n} devices, have {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return Mesh(grid, ("gallery",))
