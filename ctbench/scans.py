"""Raw cone-beam scans made from the seed, on the device.

A scan is a smooth positive field, as line integrals through an object
are, with a little detector noise on top: coarse uniform noise on a grid
of one point per 16 pixels and per 8 views, interpolated to the full
``(views, detector, detector)`` size, plus Gaussian noise of standard
deviation 0.01. The back-projection's work does not depend on the values;
the smooth field keeps the float32 rounding of the geometry from
dominating the check's reading.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def make_scans(cfg: dict, seed: int, count: int, device) -> list:
    """``count`` distinct float32 scans ``(views, det, det)`` on
    ``device``, all drawn from one generator seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    nv, nd = cfg["views"], cfg["detector"]
    coarse = (max(2, nv // 8), max(2, nd // 16), max(2, nd // 16))
    scans = []
    for _ in range(count):
        grid = torch.rand((1, 1) + coarse, generator=gen, device=device)
        field = F.interpolate(grid, size=(nv, nd, nd), mode="trilinear",
                              align_corners=True)[0, 0]
        noise = torch.randn((nv, nd, nd), generator=gen, device=device)
        scans.append(field.add_(noise, alpha=0.01).contiguous())
        del grid, noise
    return scans
