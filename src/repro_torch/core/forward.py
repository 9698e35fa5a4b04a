"""Ray-driven cone-beam forward projector.

The paper synthesizes its evaluation projections with RTK's forward
projector (§4.2); this is the equivalent, so every experiment is
self-contained. For each detector pixel the ray from the source to the
pixel is marched in fixed world-space steps, sampling the volume
trilinearly.

It is deliberately the *dual* discretization of the back-projector
(voxel-driven BP vs ray-driven FP), the standard unmatched pair of FDK
pipelines. On the card the march is the CUDA kernel F1
(``kernels/forward_project.py``), which the iterative solvers run every
iteration; on the CPU it is F1's plain PyTorch version, a chunk of views
at a time with the march steps in a Python loop.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.convert import tensor_from_numpy
# the plain march keeps the JAX package's names here
from repro_torch.kernels.forward_project import (  # noqa: F401
    forward_project_kernel, forward_project_plain as _project_view_impl,
    trilinear_sample)

from .geometry import (CTGeometry, detector_frame, source_positions,
                       voxel_world_coords)


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
    full scan. Rows come back in the requested view order. A CUDA volume
    is marched by the kernel F1, one launch per chunk of views; a CPU
    volume by its plain version. Neither ``proj_batch`` nor ``views``
    changes a value.
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
    if k == 0:
        return out
    chunk = k if proj_batch is None else max(1, min(int(proj_batch), k))
    for c0 in range(0, k, chunk):
        sel = idx[c0:c0 + chunk]
        src, org, ust, vst = (torch.from_numpy(np.ascontiguousarray(f[sel]))
                              .to(dev) for f in frames)
        out[c0:c0 + len(sel)] = forward_project_kernel(
            vol_zyx, src, org, ust, vst, vol_origin, inv_pitch, n_steps,
            geom.nh, geom.nw, step_len, t_near)
    return out
