"""State carried across from the JAX package.

CT has no trained weights: the state both packages share is the
acquisition geometry and the projection stack. These two functions take
them over from plain Python and numpy values, so the port never imports
the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.geometry import CTGeometry


def geometry_from_reference(fields: Mapping) -> CTGeometry:
    """A :class:`CTGeometry` from the field mapping of another package's
    geometry record (``dataclasses.asdict(geom)``).

    Raises ``ValueError`` on a missing or unknown field.
    """
    names = {f.name for f in dataclasses.fields(CTGeometry)}
    missing, extra = names - set(fields), set(fields) - names
    if missing or extra:
        raise ValueError(
            f"geometry fields do not match CTGeometry: missing "
            f"{sorted(missing)}, unknown {sorted(extra)}")
    kw = dict(fields)
    kw["voxel_size"] = tuple(float(v) for v in kw["voxel_size"])
    kw["det_spacing"] = tuple(float(v) for v in kw["det_spacing"])
    return CTGeometry(**kw)


def tensor_from_numpy(a, device=None) -> torch.Tensor:
    """A float32 tensor on ``device`` (``None`` -> the CUDA card) holding
    the values of array ``a`` (on the CPU it may share ``a``'s memory)."""
    dev = resolve_device(device)
    arr = np.ascontiguousarray(a, np.float32)
    if not arr.flags.writeable:     # e.g. a view of another framework's
        arr = arr.copy()            # buffer: torch wants writable memory
    return torch.from_numpy(arr).to(dev)
