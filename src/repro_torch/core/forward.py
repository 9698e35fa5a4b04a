"""Ray-driven cone-beam forward projector.

The paper synthesizes its evaluation projections with RTK's forward
projector (§4.2); this is the equivalent, so every experiment is
self-contained. For each detector pixel the ray from the source to the
pixel is marched in fixed world-space steps, sampling the volume
trilinearly.

It is deliberately the *dual* discretization of the back-projector
(voxel-driven BP vs ray-driven FP), the standard unmatched pair of FDK
pipelines. Plain PyTorch on the volume's device, a chunk of views at a
time, the march steps in a Python loop; not a performance target (the
paper's contribution is back-projection).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.convert import tensor_from_numpy

from .geometry import (CTGeometry, detector_frame, source_positions,
                       voxel_world_coords)


def trilinear_sample(vol_zyx: torch.Tensor, px, py, pz, origin, inv_pitch):
    """Sample volume (z,y,x layout) at world points; zero outside."""
    nz, ny, nx = vol_zyx.shape
    # world -> fractional voxel index
    fx = (px - origin[0]) * inv_pitch[0]
    fy = (py - origin[1]) * inv_pitch[1]
    fz = (pz - origin[2]) * inv_pitch[2]
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    z0 = torch.floor(fz)
    dx = fx - x0
    dy = fy - y0
    dz = fz - z0
    valid = ((x0 >= 0) & (x0 <= nx - 2) & (y0 >= 0) & (y0 <= ny - 2)
             & (z0 >= 0) & (z0 <= nz - 2))
    ix = torch.where(valid, x0, 0.0).long()
    iy = torch.where(valid, y0, 0.0).long()
    iz = torch.where(valid, z0, 0.0).long()
    flat = vol_zyx.reshape(-1)
    base = (iz * ny + iy) * nx + ix

    def at(dzi, dyi, dxi):
        return flat[base + (dzi * ny + dyi) * nx + dxi]

    c00 = at(0, 0, 0) * (1 - dx) + at(0, 0, 1) * dx
    c01 = at(0, 1, 0) * (1 - dx) + at(0, 1, 1) * dx
    c10 = at(1, 0, 0) * (1 - dx) + at(1, 0, 1) * dx
    c11 = at(1, 1, 0) * (1 - dx) + at(1, 1, 1) * dx
    c0 = c00 * (1 - dy) + c01 * dy
    c1 = c10 * (1 - dy) + c11 * dy
    return torch.where(valid, c0 * (1 - dz) + c1 * dz, 0.0)


def _project_view_impl(vol_zyx, src, det_origin, ustep, vstep, vol_origin,
                       inv_pitch, n_steps: int, nh: int, nw: int, step_len,
                       t_near):
    """Projection images for one view (frames of shape (3,): returns
    (nh, nw)) or a chunk of views (frames (k, 3): returns (k, nh, nw)).
    One accumulator buffer; the march steps are added in order."""
    dev = vol_zyx.device
    u = torch.arange(nw, dtype=torch.float32, device=dev)
    v = torch.arange(nh, dtype=torch.float32, device=dev)
    V, U = torch.meshgrid(v, u, indexing="ij")     # (nh, nw)

    def col(a, c):      # frame component c, broadcast over (nh, nw)
        return a[..., c, None, None]

    # detector pixel world positions
    px = col(det_origin, 0) + U * col(ustep, 0) + V * col(vstep, 0)
    py = col(det_origin, 1) + U * col(ustep, 1) + V * col(vstep, 1)
    pz = col(det_origin, 2) + U * col(ustep, 2) + V * col(vstep, 2)
    sx, sy, sz = col(src, 0), col(src, 1), col(src, 2)
    dirx, diry, dirz = px - sx, py - sy, pz - sz
    norm = torch.sqrt(dirx ** 2 + diry ** 2 + dirz ** 2)
    dirx, diry, dirz = dirx / norm, diry / norm, dirz / norm

    step = np.float32(step_len)
    ts = np.float32(t_near) + (np.arange(n_steps, dtype=np.float32)
                               + np.float32(0.5)) * step
    acc = torch.zeros(dirx.shape, dtype=torch.float32, device=dev)
    for t in ts.tolist():
        acc += trilinear_sample(vol_zyx, sx + dirx * t, sy + diry * t,
                                sz + dirz * t, vol_origin, inv_pitch)
    return acc * float(step)


def march_params(geom: CTGeometry, oversample: float = 2.0, device=None):
    """Ray-march constants shared by every view of one geometry:
    ``(vol_origin, inv_pitch, step_len, t_near, n_steps)``, the first two
    as float32 tensors on ``device`` (``None`` -> the CUDA card). The
    march covers the volume's circumscribing sphere only."""
    from repro_torch._device import resolve_device
    dev = resolve_device(device)
    sx, sy, sz = geom.voxel_size
    xs, ys, zs = voxel_world_coords(geom)
    vol_origin = torch.tensor([xs[0], ys[0], zs[0]], dtype=torch.float32,
                              device=dev)
    inv_pitch = torch.tensor(np.asarray([1 / sx, 1 / sy, 1 / sz],
                                        np.float32), device=dev)
    radius = 0.5 * float(np.sqrt((geom.nx*sx)**2 + (geom.ny*sy)**2
                                 + (geom.nz*sz)**2))
    t_near = geom.sad - radius
    t_far = geom.sad + radius
    step_len = min(sx, sy, sz) / oversample
    n_steps = int(np.ceil((t_far - t_near) / step_len))
    return vol_origin, inv_pitch, float(step_len), float(t_near), n_steps


def view_frames(geom: CTGeometry):
    """Per-view ray frames, stacked: ``(srcs, origins, usteps, vsteps)``,
    each of shape (n_proj, 3) float32 numpy."""
    srcs = source_positions(geom)
    origins = np.empty((geom.n_proj, 3), np.float32)
    usteps = np.empty((geom.n_proj, 3), np.float32)
    vsteps = np.empty((geom.n_proj, 3), np.float32)
    for p, theta in enumerate(geom.angles):
        origins[p], usteps[p], vsteps[p] = detector_frame(geom, float(theta))
    return srcs, origins, usteps, vsteps


def forward_project(vol_zyx, geom: CTGeometry, oversample: float = 2.0, *,
                    proj_batch: Optional[int] = None,
                    views: Union[slice, Sequence[int], None] = None,
                    device=None) -> torch.Tensor:
    """Project volume (nz, ny, nx) into (k, nh, nw) projections.

    Runs on the volume tensor's device; a numpy volume is copied to
    ``device`` first (``None`` -> the CUDA card). ``proj_batch`` marches
    that many views at a time (one chunk's ray grid and temporaries
    instead of all views at once); ``None`` marches every view at once.
    ``views`` selects a subset of view indices (a slice or an index
    sequence), the ordered-subset forward pass; the default projects the
    full scan. Rows come back in the requested view order.
    """
    if not isinstance(vol_zyx, torch.Tensor):
        vol_zyx = tensor_from_numpy(vol_zyx, device)
    dev = vol_zyx.device
    vol_zyx = vol_zyx.to(torch.float32).contiguous()
    vol_origin, inv_pitch, step_len, t_near, n_steps = march_params(
        geom, oversample, dev)
    frames = view_frames(geom)
    idx = (np.arange(geom.n_proj)[views] if views is not None
           else np.arange(geom.n_proj))
    k = len(idx)
    out = torch.empty((k, geom.nh, geom.nw), dtype=torch.float32, device=dev)
    chunk = k if proj_batch is None else max(1, min(int(proj_batch), k))
    for c0 in range(0, k, chunk):
        sel = idx[c0:c0 + chunk]
        src, org, ust, vst = (torch.from_numpy(np.ascontiguousarray(f[sel]))
                              .to(dev) for f in frames)
        out[c0:c0 + len(sel)] = _project_view_impl(
            vol_zyx, src, org, ust, vst, vol_origin, inv_pitch, n_steps,
            geom.nh, geom.nw, step_len, t_near)
    return out
