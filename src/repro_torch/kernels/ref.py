"""Plain oracles for the back-projection kernels.

The oracle implements the exact math of the paper's Algorithm 1
(transpose + hoist + subline, without the symmetry split, which is exact
for centered geometries) as a simple sum over projections. Every kernel
of the port must match it to fp32 interpolation tolerance.
"""

from __future__ import annotations

import torch

from repro_torch.core.backproject import _bp_subline_single


def backproject_ref(img_t: torch.Tensor, mat: torch.Tensor,
                    vol_shape_xyz) -> torch.Tensor:
    """Oracle: subline back-projection, summed over projections.

    img_t: (np, nw, nh) transposed projections (float32)
    mat:   (np, 3, 4) projection matrices
    returns vol_t: (nx, ny, nz) float32
    """
    shape = tuple(vol_shape_xyz)
    img_t = img_t.float()
    mat = mat.float()
    vol = torch.zeros(shape, dtype=torch.float32, device=img_t.device)
    for s in range(img_t.shape[0]):
        vol += _bp_subline_single(img_t[s], mat[s], shape)
    return vol


def subline_blend_ref(img_ts: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Oracle for just the sub-line blend stage (Fig. 3a).

    img_ts: (nw, nh); x: (n_lines,) fractional columns.
    Returns (n_lines, nh) blended sub-lines (columns clamped like the
    kernel; validity handled by the caller's mask).
    """
    nw = img_ts.shape[0]
    x0 = torch.floor(x)
    ix = x0.long().clamp(0, nw - 2)
    dx = x - x0
    c0 = img_ts[ix]
    c1 = img_ts[ix + 1]
    return c0 * (1.0 - dx)[:, None] + c1 * dx[:, None]
