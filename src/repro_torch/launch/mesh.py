"""Device meshes for the mesh-sharded back-projection.

A :class:`Mesh` is a named grid of torch devices in one process: the
entries, row-major, with the grid's ``shape`` and ``axis_names``. An entry
may repeat (the fleet's convention): ``("cpu",) * 8`` makes a 2 x 2 x 2
mesh on the CPU, ``("cuda:0",) * 8`` one on a single card. The JAX
package's mesh spans devices under one controller as well; the port
drives each entry from the calling thread, and a plain loop over the
entries overlaps distinct cards because launches are asynchronous.

Meshes are built by FUNCTIONS, never at import, so importing this module
touches no device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices`` row-major over ``shape``, one name an axis. Frozen and
    hashable: program caches key on it."""

    devices: Tuple[torch.device, ...]
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def axis_size(self, name: str) -> int:
        """The size of axis ``name``; 1 for an axis the mesh lacks."""
        if name not in self.axis_names:
            return 1
        return self.shape[self.axis_names.index(name)]

    def device_at(self, **coords: int) -> torch.device:
        """The entry at the given axis coordinates (0 on an axis not
        named)."""
        flat = 0
        for name, size in zip(self.axis_names, self.shape):
            flat = flat * size + int(coords.get(name, 0))
        return self.devices[flat]


def make_mesh(shape: Sequence[int], names: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` with axis ``names``.

    ``devices=None`` takes every visible CUDA device, and there must be
    exactly ``prod(shape)`` of them (``ValueError`` otherwise, also when
    there is no card). An explicit ``devices`` sequence may repeat
    entries; it must hold ``prod(shape)`` entries of one device type.
    """
    from repro_torch.runtime.executor import _fleet_device, _one_device_type

    shape = tuple(int(s) for s in shape)
    names = tuple(str(n) for n in names)
    if len(shape) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"a mesh needs one distinct name an axis: shape "
                         f"{shape}, names {names}")
    n = math.prod(shape)
    if devices is None:
        count = torch.cuda.device_count()
        if count != n:
            raise ValueError(f"mesh {dict(zip(names, shape))} needs {n} "
                             f"devices, {count} CUDA devices are visible")
        devices = [f"cuda:{i}" for i in range(count)]
    if len(devices) != n:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs {n} "
                         f"devices, got {len(devices)}")
    devs = _one_device_type(tuple(_fleet_device(d) for d in devices))
    return Mesh(devs, shape, names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The target deployment mesh over every visible card.

    Single pod: (data=16, model=16) = 256 devices. Multi-pod: (pod=2,
    data=16, model=16) = 512 devices; only the volume's sum crosses the
    "pod" axis. ``ValueError`` unless exactly that many cards are
    visible.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh() -> Mesh:
    """An (n, 1) ("data", "model") mesh over every visible card (raises
    without one)."""
    from repro_torch._device import resolve_device
    resolve_device("cuda")
    n = torch.cuda.device_count()
    return make_mesh((n, 1), ("data", "model"))


def data_axes(mesh: Mesh) -> tuple:
    """Axes that shard the batch: ('pod','data') when pod exists."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)
