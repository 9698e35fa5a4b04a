"""3-D Shepp-Logan phantom: the synthetic data source for every CT test.

Standard 10-ellipsoid definition (Kak & Slaney variant with the commonly
used "modified" contrast values so soft-tissue detail is visible). The
phantom lives in the unit cube [-1, 1]^3 and is sampled at voxel centers.
"""

from __future__ import annotations

import numpy as np

# (value, x0, y0, z0, a, b, c, phi_deg) — value is *additive* density,
# (x0,y0,z0) center, (a,b,c) semi-axes, phi rotation about Z.
_ELLIPSOIDS = [
    (1.00,  0.0,    0.0,    0.0,   0.69,  0.92,  0.81,   0.0),
    (-0.80, 0.0,   -0.0184, 0.0,   0.6624, 0.874, 0.780,  0.0),
    (-0.20, 0.22,   0.0,    0.0,   0.11,  0.31,  0.22, -18.0),
    (-0.20, -0.22,  0.0,    0.0,   0.16,  0.41,  0.28,  18.0),
    (0.10,  0.0,    0.35,  -0.15,  0.21,  0.25,  0.41,   0.0),
    (0.10,  0.0,    0.1,    0.25,  0.046, 0.046, 0.05,   0.0),
    (0.10,  0.0,   -0.1,    0.25,  0.046, 0.046, 0.05,   0.0),
    (0.10, -0.08,  -0.605,  0.0,   0.046, 0.023, 0.05,   0.0),
    (0.10,  0.0,   -0.606,  0.0,   0.023, 0.023, 0.02,   0.0),
    (0.10,  0.06,  -0.605,  0.0,   0.023, 0.046, 0.02,   0.0),
]


def shepp_logan_3d(nx: int, ny: int | None = None, nz: int | None = None,
                   dtype=np.float32) -> np.ndarray:
    """Sample the phantom on an (nx, ny, nz) grid; returns volume[z][y][x]."""
    ny = ny if ny is not None else nx
    nz = nz if nz is not None else nx
    xs = np.linspace(-1.0, 1.0, nx, dtype=np.float64)
    ys = np.linspace(-1.0, 1.0, ny, dtype=np.float64)
    zs = np.linspace(-1.0, 1.0, nz, dtype=np.float64)
    Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
    return shepp_logan_at(X, Y, Z).astype(dtype)


def shepp_logan_at(X: np.ndarray, Y: np.ndarray,
                   Z: np.ndarray) -> np.ndarray:
    """The phantom's float64 density at the points (X, Y, Z) of [-1, 1]^3
    (arrays of one shape): :func:`shepp_logan_3d` on any part of its grid,
    a slab of z planes, say, gives the same values."""
    vol = np.zeros(X.shape, dtype=np.float64)
    for (val, x0, y0, z0, a, b, c, phi_deg) in _ELLIPSOIDS:
        phi = np.deg2rad(phi_deg)
        cp, sp = np.cos(phi), np.sin(phi)
        xr = (X - x0) * cp + (Y - y0) * sp
        yr = -(X - x0) * sp + (Y - y0) * cp
        zr = Z - z0
        inside = (xr / a) ** 2 + (yr / b) ** 2 + (zr / c) ** 2 <= 1.0
        vol += val * inside
    return vol


def ball_phantom(n: int, radius: float = 0.5, dtype=np.float32) -> np.ndarray:
    """A single centered ball: analytically checkable forward projections."""
    xs = np.linspace(-1.0, 1.0, n)
    Z, Y, X = np.meshgrid(xs, xs, xs, indexing="ij")
    return (X ** 2 + Y ** 2 + Z ** 2 <= radius ** 2).astype(dtype)
