"""Cone-beam CT (CBCT) geometry: the paper's Fig. 1 setup.

The X-ray source rotates on a circle of radius ``sad`` (source-axis
distance, the paper's ``d``) in the Z=0 plane. A flat-panel detector of
``nh x nw`` pixels sits at distance ``sdd`` (source-detector distance,
the paper's ``D``) from the source, perpendicular to the central ray. The
detector V axis is parallel to the world Z axis (paper §2.1.1), so a line
of voxels along Z projects onto a line of detector pixels along V.

All geometric information per view is collapsed into a 3x4 *projection
matrix* ``M`` acting on homogeneous voxel indices ``(i, j, k, 1)``:

    z      = M[2] . (i,j,k,1)        # depth along the central ray
    x_pix  = (M[0] . (i,j,k,1)) / z  # detector column (U), pixels
    y_pix  = (M[1] . (i,j,k,1)) / z  # detector row (V), pixels

Two structural facts the paper's optimizations rely on hold *exactly*
for matrices built here (volume and detector centered):

  * ``M[0][2] == M[2][2] == 0``: ``x`` and ``z`` are invariant in ``k``
    (hoisting, §3.1.2);
  * voxels mirrored about the volume's central XY plane project to
    ``y' = (nh-1) - y`` (geometric symmetry, §3.1.2 after Zhao et al.).

The matrices are built in float64 numpy and cast to float32 once, exactly
as the JAX package builds them, so both packages see bitwise-equal
matrices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class CTGeometry:
    """Full description of a circular-trajectory CBCT acquisition."""

    # Volume, in voxels (paper: nx, ny, nz; row-major volume[z][y][x]).
    nx: int
    ny: int
    nz: int
    # Flat-panel detector, in pixels (paper: nw wide (U), nh tall (V)).
    nw: int
    nh: int
    # Number of projections over the full circle (paper: np).
    n_proj: int
    # Source-axis distance d and source-detector distance D (world units).
    sad: float
    sdd: float
    # Physical voxel pitch (sx, sy, sz) and detector pixel pitch (du, dv).
    voxel_size: Tuple[float, float, float]
    det_spacing: Tuple[float, float]

    @property
    def magnification(self) -> float:
        return self.sdd / self.sad

    @property
    def angles(self) -> np.ndarray:
        """View angles, full 2*pi circle, endpoint excluded."""
        return np.linspace(0.0, 2.0 * math.pi, self.n_proj, endpoint=False)

    @property
    def volume_shape_zyx(self) -> Tuple[int, int, int]:
        """Native layout volume[nz][ny][nx]."""
        return (self.nz, self.ny, self.nx)

    @property
    def volume_shape_xyz(self) -> Tuple[int, int, int]:
        """Transposed layout volume[nx][ny][nz] (paper Algorithm 1)."""
        return (self.nx, self.ny, self.nz)

    @property
    def proj_shape_hw(self) -> Tuple[int, int, int]:
        """Native layout img[np][nh][nw]."""
        return (self.n_proj, self.nh, self.nw)

    @property
    def proj_shape_wh(self) -> Tuple[int, int, int]:
        """Transposed layout img[np][nw][nh] (paper Algorithm 1)."""
        return (self.n_proj, self.nw, self.nh)

    def voxel_updates(self, n_proj: int | None = None) -> int:
        """Total voxel updates: numerator of the paper's GUPS metric."""
        n = self.n_proj if n_proj is None else n_proj
        return self.nx * self.ny * self.nz * n


def standard_geometry(
    n: int = 64,
    n_det: int | None = None,
    n_proj: int | None = None,
    *,
    sad: float = 1000.0,
    sdd: float = 1536.0,
) -> CTGeometry:
    """A well-conditioned default geometry, RabbitCT-flavoured.

    The detector is sized so the cone fully covers the volume at the given
    magnification; the volume is a cube of ``n`` voxels spanning 256 world
    units (RabbitCT's C-arm dataset uses sad~1000mm, sdd~1536mm).
    """
    n_det = n_det if n_det is not None else n
    n_proj = n_proj if n_proj is not None else n
    extent = 256.0  # world units across the volume
    vox = extent / n
    # Project the volume's circumscribing sphere onto the detector and pad.
    mag = sdd / sad
    det_extent = extent * mag * 1.25
    du = det_extent / n_det
    return CTGeometry(
        nx=n, ny=n, nz=n,
        nw=n_det, nh=n_det,
        n_proj=n_proj,
        sad=sad, sdd=sdd,
        voxel_size=(vox, vox, vox),
        det_spacing=(du, du),
    )


def projection_matrix(geom: CTGeometry, theta: float) -> np.ndarray:
    """Build the 3x4 index-space projection matrix for one view angle.

    Derivation (world frame): source s = (d cos t, d sin t, 0); optical axis
    unit vector points from source through the rotation axis; detector axes
    u_hat = (-sin t, cos t, 0), v_hat = (0,0,1) = Z (paper: V parallel Z).
    For world point p:

        z      = d - p_x cos t - p_y sin t           (paper §3.1.2)
        u_phys = D * (-p_x sin t + p_y cos t) / z
        v_phys = D * p_z / z

    with voxel index -> world mapping p = (idx - center) * pitch and pixel
    mapping x_pix = u_phys/du + (nw-1)/2, y_pix = v_phys/dv + (nh-1)/2.
    """
    d, D = geom.sad, geom.sdd
    sx, sy, sz = geom.voxel_size
    du, dv = geom.det_spacing
    cx = (geom.nx - 1) / 2.0
    cy = (geom.ny - 1) / 2.0
    cz = (geom.nz - 1) / 2.0
    cu = (geom.nw - 1) / 2.0
    cv = (geom.nh - 1) / 2.0
    ct, st = math.cos(theta), math.sin(theta)

    # Depth row: z = d - p_x ct - p_y st, p_x = (i - cx) sx, p_y = (j - cy) sy
    rz = np.array(
        [-sx * ct, -sy * st, 0.0, d + cx * sx * ct + cy * sy * st],
        dtype=np.float64,
    )
    # Physical detector u: D * (-p_x st + p_y ct)
    ru = (D / du) * np.array(
        [-sx * st, sy * ct, 0.0, cx * sx * st - cy * sy * ct],
        dtype=np.float64,
    )
    # Physical detector v: D * p_z
    rv = (D / dv) * np.array([0.0, 0.0, sz, -cz * sz], dtype=np.float64)

    m = np.stack([ru + cu * rz, rv + cv * rz, rz])
    return m.astype(np.float32)


def projection_matrices(geom: CTGeometry, device=None) -> torch.Tensor:
    """All per-view matrices, shape (n_proj, 3, 4) float32, on ``device``
    (``None`` -> the CUDA card)."""
    dev = resolve_device(device)
    mats = np.stack([projection_matrix(geom, t) for t in geom.angles])
    return torch.from_numpy(mats).to(dev)


def source_positions(geom: CTGeometry) -> np.ndarray:
    """World-space source positions per view, shape (n_proj, 3)."""
    t = geom.angles
    return np.stack(
        [geom.sad * np.cos(t), geom.sad * np.sin(t), np.zeros_like(t)], axis=-1
    ).astype(np.float32)


def detector_frame(geom: CTGeometry, theta: float):
    """(origin, u_hat*du, v_hat*dv) of the detector plane in world space.

    ``origin`` is the world position of detector pixel (0, 0) (x_pix=0,
    y_pix=0); stepping one pixel in x_pix adds ``ustep``; one pixel in
    y_pix adds ``vstep``. Used by the ray-driven forward projector.
    """
    d, D = geom.sad, geom.sdd
    du, dv = geom.det_spacing
    ct, st = math.cos(theta), math.sin(theta)
    src = np.array([d * ct, d * st, 0.0])
    axis_dir = -np.array([ct, st, 0.0])  # source -> rotation axis
    center = src + D * axis_dir  # detector center (pixel (cu, cv))
    u_hat = np.array([-st, ct, 0.0])
    v_hat = np.array([0.0, 0.0, 1.0])
    cu = (geom.nw - 1) / 2.0
    cv = (geom.nh - 1) / 2.0
    origin = center - cu * du * u_hat - cv * dv * v_hat
    return (
        origin.astype(np.float32),
        (du * u_hat).astype(np.float32),
        (dv * v_hat).astype(np.float32),
    )


def voxel_world_coords(geom: CTGeometry):
    """1-D world coordinate arrays (xs, ys, zs) of voxel centers."""
    sx, sy, sz = geom.voxel_size
    xs = (np.arange(geom.nx) - (geom.nx - 1) / 2.0) * sx
    ys = (np.arange(geom.ny) - (geom.ny - 1) / 2.0) * sy
    zs = (np.arange(geom.nz) - (geom.nz - 1) / 2.0) * sz
    return xs.astype(np.float32), ys.astype(np.float32), zs.astype(np.float32)
