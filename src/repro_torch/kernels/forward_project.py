"""F1, the ray-driven forward projector, as a CUDA kernel for Hopper.

The JAX package has no Pallas kernel here: it marches the rays in one XLA
program, ``_project_views`` of ``src/repro/core/forward.py`` (l.97), a
``jit(vmap(scan))`` over a chunk's views and the march steps. Its
counterpart on the card is ``march_kernel`` in ``csrc/forward_project.cu``,
one thread per detector pixel of one view, which marches every step in a
register (the design and what bounds it are in the source).
:func:`forward_project_plain` is the same function in plain PyTorch, a
chunk of views at a time with the march steps in a Python loop; the
iterative solvers multiply its cost by two or more projections an
iteration, which is why the card runs the kernel.

On a CPU volume :func:`forward_project_kernel` runs the plain version; on
a CUDA volume it launches the kernel or raises. Nothing else selects the
path.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

#: Launches of the kernel wrapper in this process (one per launch, counted
#: only where the wrapper launches the CUDA kernel).
LAUNCHES: Dict[str, int] = {"forward_project_kernel": 0}

_LIB = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib():
    global _LIB
    if _LIB is None:
        from . import _build
        lib = _build.load("forward_project")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fp_launch.argtypes = [vp] * 8 + [ci] * 7 + [cf, cf, vp]
        lib.fp_launch.restype = ci
        lib.fp_cuda_error_string.argtypes = [ci]
        lib.fp_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


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


def forward_project_plain(vol_zyx, src, det_origin, ustep, vstep, vol_origin,
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


def _check(vol_zyx, frames, vol_origin, inv_pitch) -> int:
    """Validate a call; return the number of views k."""
    tensors = (vol_zyx, *frames, vol_origin, inv_pitch)
    if not all(isinstance(t, torch.Tensor) for t in tensors):
        raise TypeError("the volume, frames and march constants must be "
                        "torch tensors")
    dev = vol_zyx.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"every input must lie on the volume's device "
                         f"{dev}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("every input must be float32")
    if vol_zyx.dim() != 3 or min(vol_zyx.shape) < 1:
        raise ValueError(f"vol_zyx must be (nz, ny, nx), got "
                         f"{tuple(vol_zyx.shape)}")
    k = frames[0].shape[0] if frames[0].dim() == 2 else None
    if k is None or any(tuple(f.shape) != (k, 3) for f in frames):
        raise ValueError(f"the four frames must each be (k, 3), got "
                         f"{[tuple(f.shape) for f in frames]}")
    if tuple(vol_origin.shape) != (3,) or tuple(inv_pitch.shape) != (3,):
        raise ValueError("vol_origin and inv_pitch must be (3,)")
    return k


def forward_project_kernel(vol_zyx, src, det_origin, ustep, vstep,
                           vol_origin, inv_pitch, n_steps: int, nh: int,
                           nw: int, step_len, t_near) -> torch.Tensor:
    """F1: the projection images ``(k, nh, nw)`` f32 of ``vol_zyx`` (nz,
    ny, nx) for k views with frames ``src``, ``det_origin``, ``ustep``,
    ``vstep`` (each (k, 3)), under the march constants of
    ``core.forward.march_params``. Arguments as :func:`forward_project_plain`
    takes them for a chunk; every tensor f32 on one device."""
    frames = (src, det_origin, ustep, vstep)
    k = _check(vol_zyx, frames, vol_origin, inv_pitch)
    n_steps, nh, nw = int(n_steps), int(nh), int(nw)
    if n_steps < 0 or nh < 1 or nw < 1:
        raise ValueError(f"need n_steps >= 0, nh >= 1 and nw >= 1, got "
                         f"{n_steps}, {nh}, {nw}")
    if vol_zyx.device.type == "cpu":
        return forward_project_plain(vol_zyx, *frames, vol_origin, inv_pitch,
                                     n_steps, nh, nw, step_len, t_near)
    out = torch.empty((k, nh, nw), dtype=torch.float32,
                      device=vol_zyx.device)
    if k == 0:
        return out
    if k > 65535:
        raise ValueError(f"one launch takes at most 65535 views, got {k}")
    vol = vol_zyx.contiguous()
    frames = tuple(f.contiguous() for f in frames)
    vol_origin = vol_origin.contiguous()
    inv_pitch = inv_pitch.contiguous()
    nz, ny, nx = vol.shape
    lib = _lib()
    with torch.cuda.device(vol.device):
        stream = torch.cuda.current_stream(vol.device).cuda_stream
        err = lib.fp_launch(
            vol.data_ptr(), *(f.data_ptr() for f in frames),
            vol_origin.data_ptr(), inv_pitch.data_ptr(), out.data_ptr(), k,
            nh, nw, nx, ny, nz, n_steps, float(np.float32(step_len)),
            float(np.float32(t_near)), stream)
    if err != 0:
        raise RuntimeError(
            f"forward_project launch failed: CUDA error {err} "
            f"({lib.fp_cuda_error_string(err).decode()})")
    LAUNCHES["forward_project_kernel"] += 1
    return out
