"""RTK-style baseline back-projection (the paper's Listing 1), in PyTorch.

The reference semantics every optimized variant must match to the
paper's validation bar (RMSE < 1e-5, §4.2). Layouts follow RTK exactly:

    img:    (np, nh, nw)   row-major projections, img[s][y][x]
    mat:    (np, 3, 4)     index-space projection matrices
    volume: (nz, ny, nx)   row-major volume, volume[k][j][i]

For every projection ``s`` and voxel ``(i,j,k)``:

    z = mat[s][2] . (i,j,k,1);  f = 1/z
    x = (mat[s][0] . (i,j,k,1)) * f
    y = (mat[s][1] . (i,j,k,1)) * f
    volume[k][j][i] += Bilinear(img[s], x, y) * f * f

Boundary convention (shared by every variant): a sample contributes iff
``floor(x)`` and ``floor(x)+1`` are both in bounds (same for y) and
``z > 0``; otherwise the contribution is exactly zero. Out-of-range
samples gather a valid element and are then masked.
"""

from __future__ import annotations

import torch


def bilinear_gather(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Bilinear interpolation of img[y][x] at fractional (x, y).

    img: (nh, nw). x, y: broadcastable shapes. Returns (values,
    valid_mask) under the boundary convention above.
    """
    nh, nw = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = x - x0
    dy = y - y0
    x_ok = (x0 >= 0) & (x0 <= nw - 2)
    y_ok = (y0 >= 0) & (y0 <= nh - 2)
    ixc = torch.where(x_ok, x0, 0.0).long()
    iyc = torch.where(y_ok, y0, 0.0).long()
    flat = img.reshape(-1)
    base = iyc * nw + ixc
    v00 = flat[base]
    v01 = flat[base + 1]
    v10 = flat[base + nw]
    v11 = flat[base + nw + 1]
    s0 = v00 * (1.0 - dx) + v01 * dx  # mix along x (paper's Listing 2)
    s1 = v10 * (1.0 - dx) + v11 * dx
    val = s0 * (1.0 - dy) + s1 * dy   # mix along y
    return val, x_ok & y_ok


def _voxel_index_grid(nz: int, ny: int, nx: int, device=None):
    """Homogeneous (i, j, k) coordinate grids, broadcastable to
    (nz, ny, nx)."""
    k = torch.arange(nz, dtype=torch.float32, device=device)[:, None, None]
    j = torch.arange(ny, dtype=torch.float32, device=device)[None, :, None]
    i = torch.arange(nx, dtype=torch.float32, device=device)[None, None, :]
    return i, j, k


def backproject_single(img_s: torch.Tensor, mat_s: torch.Tensor,
                       vol_shape_zyx) -> torch.Tensor:
    """Back-project ONE projection onto a zero volume (zyx layout)."""
    nz, ny, nx = vol_shape_zyx
    i, j, k = _voxel_index_grid(nz, ny, nx, img_s.device)
    # dot4(mat[r], (i,j,k,1)) for the three rows
    z = mat_s[2, 0] * i + mat_s[2, 1] * j + mat_s[2, 2] * k + mat_s[2, 3]
    f = 1.0 / z
    x = (mat_s[0, 0] * i + mat_s[0, 1] * j + mat_s[0, 2] * k
         + mat_s[0, 3]) * f
    y = (mat_s[1, 0] * i + mat_s[1, 1] * j + mat_s[1, 2] * k
         + mat_s[1, 3]) * f
    val, valid = bilinear_gather(img_s, x, y)
    return torch.where(valid & (z > 0), val * (f * f), 0.0)


def backproject_rtk(img: torch.Tensor, mat: torch.Tensor,
                    vol_shape_zyx) -> torch.Tensor:
    """Full baseline: sequential loop over projections (Listing 1 order).

    img (np, nh, nw); mat (np, 3, 4). Returns volume (nz, ny, nx)
    float32 on the tensors' device; one full volume sweep per projection.
    """
    shape = tuple(int(v) for v in vol_shape_zyx)
    vol = torch.zeros(shape, dtype=torch.float32, device=img.device)
    for s in range(img.shape[0]):
        vol += backproject_single(img[s], mat[s], shape)
    return vol
