"""Sub-line back-projection kernel for Hopper (paper Algorithm 1).

Replaces the two Pallas kernels of the JAX package's
``kernels/backproject_subline.py``: ``backproject_subline_pallas``
(l.204, K1) and ``backproject_subline_fused`` (l.240, K2). One CUDA
kernel, ``csrc/backproject_subline.cu``, serves both: K1 stages one
projection per step of its projection loop, K2 stages ``nb``.

What bounds it on an H100. By the repo's cost model (8 floating-point
operations per voxel-view update) the kernel is bound by operations: at
P5 (512^3 voxels, 512 views) 5.5e11 FLOP against 1.07 GB of compulsory
traffic (the projections read once, the volume written once), about 510
FLOP per byte. The design answers with what the TPU kernel did through
its output-stationary grid: each block walks over all projections
itself, every voxel's sum stays in a register of one lane, and the
volume is written once, with no atomics and a fixed summation order. The
traffic the design does NOT remove is stage 1: every voxel line reads its
two detector columns (2*nh floats) per projection through L2 into shared
memory, 8 bytes per update at P5 (about 550 GB in all), which the columns
shared between neighbouring lines could cut in a later change.

On a CPU tensor the wrappers run :func:`backproject_subline_plain`, the
same function in plain PyTorch; on a CUDA tensor they launch the kernel
or raise. Nothing else selects the path.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

#: Launches of each kernel wrapper in this process (one per launch, counted
#: only where the wrapper launches the CUDA kernel).
LAUNCHES: Dict[str, int] = {"backproject_subline_kernel": 0,
                            "backproject_subline_fused": 0}

#: Dynamic shared memory a block may use on an H100 (227 KB).
SMEM_PER_BLOCK = 232448

_LIB = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def fused_batch_ok(n_proj: int, nb: int, proj_loop: bool) -> bool:
    """Whether the fused multi-batch (``proj_loop``) kernel may run: an
    in-kernel batch needs nb >= 2 and an nb-divisible projection count
    (the executor pads globally; raw callers run K1 instead)."""
    return bool(proj_loop) and nb > 1 and n_proj % nb == 0


def _lib():
    global _LIB
    if _LIB is None:
        from . import _build
        lib = _build.load("backproject_subline")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.bp_subline_launch.argtypes = [vp, vp, vp] + [ci] * 7 + [vp]
        lib.bp_subline_launch.restype = ci
        lib.bp_subline_smem_bytes.argtypes = [ci, ci]
        lib.bp_subline_smem_bytes.restype = ctypes.c_size_t
        lib.bp_subline_max_khp.argtypes = []
        lib.bp_subline_max_khp.restype = ci
        lib.bp_banded_launch.argtypes = [vp] * 4 + [ci] * 12 + [vp]
        lib.bp_banded_launch.restype = ci
        lib.bp_cuda_error_string.argtypes = [ci]
        lib.bp_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(img_t, mat, vol_shape_xyz, block) -> tuple:
    """Validate the call; return the volume shape as three ints."""
    if not (isinstance(img_t, torch.Tensor) and isinstance(mat, torch.Tensor)):
        raise TypeError("img_t and mat must be torch tensors")
    if img_t.device != mat.device:
        raise ValueError(f"img_t on {img_t.device} but mat on {mat.device}")
    if img_t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {img_t.device}")
    if img_t.dtype != torch.float32 or mat.dtype != torch.float32:
        raise TypeError(f"img_t and mat must be float32, got {img_t.dtype} "
                        f"and {mat.dtype}")
    if img_t.dim() != 3 or img_t.shape[1] < 2 or img_t.shape[2] < 2:
        raise ValueError(f"img_t must be (np, nw>=2, nh>=2), got "
                         f"{tuple(img_t.shape)}")
    if tuple(mat.shape) != (img_t.shape[0], 3, 4):
        raise ValueError(f"mat must be ({img_t.shape[0]}, 3, 4), got "
                         f"{tuple(mat.shape)}")
    if not (img_t.is_contiguous() and mat.is_contiguous()):
        raise ValueError("img_t and mat must be contiguous")
    shape = tuple(int(v) for v in vol_shape_xyz)
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f"vol_shape_xyz must be 3 positive ints, got "
                         f"{vol_shape_xyz}")
    bi, bj = (int(v) for v in block)
    if bi < 1 or bj < 8 or bj % 8:
        raise ValueError(f"block must be (BI >= 1, BJ a multiple of 8), "
                         f"got {block}")
    return shape


def _interp(sm: torch.Tensor, y: torch.Tensor, nh: int) -> torch.Tensor:
    """Rows of ``sm`` (lines, nh) interpolated at ``y`` (lines, nk); 0
    where floor(y) falls outside [0, nh-2]."""
    y0 = torch.floor(y)
    dy = y - y0
    valid = (y0 >= 0) & (y0 <= nh - 2)
    iy = torch.where(valid, y0, 0.0).long()
    v = (torch.gather(sm, 1, iy) * (1.0 - dy)
         + torch.gather(sm, 1, iy + 1) * dy)
    return torch.where(valid, v, 0.0)


def _line_grid(ni: int, nj: int, device, origin=(0, 0)) -> tuple:
    """The (i, j) index of every voxel line of the ni x nj box at
    ``origin``, flat in i*nj + j order, as float32 vectors."""
    i = torch.arange(origin[0], origin[0] + ni, dtype=torch.float32,
                     device=device)
    j = torch.arange(origin[1], origin[1] + nj, dtype=torch.float32,
                     device=device)
    return (i[:, None].expand(ni, nj).reshape(-1),
            j[None, :].expand(ni, nj).reshape(-1))


def _line_scalars(m: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
                  nw: int) -> tuple:
    """The k-invariant scalars of every line for one matrix ``m``: the
    validity mask ``ok`` (z > 0 and 0 <= floor(x) <= nw-2), f = 1/z, the
    column ``ixc`` (0 where invalid) and the blend weight ``dx``."""
    z = m[2, 0] * i + m[2, 1] * j + m[2, 3]
    f = 1.0 / z
    x = (m[0, 0] * i + m[0, 1] * j + m[0, 3]) * f
    x0 = torch.floor(x)
    ok = (z > 0) & (x0 >= 0) & (x0 <= nw - 2)
    dx = torch.where(ok, x - x0, 0.0)
    ixc = torch.where(ok, x0, 0.0).long()
    return ok, f, ixc, dx


def _accumulate(vol: torch.Tensor, sm: torch.Tensor, m: torch.Tensor,
                i: torch.Tensor, j: torch.Tensor, f: torch.Tensor,
                w: torch.Tensor, interp=_interp) -> None:
    """Stage 2 of one projection into ``vol`` (lines, nz): ``interp`` of
    the sub-lines ``sm`` at y = a + b*k over k < khp = nz - nz//2, and at
    the O3 mirror (nh-1) - y for the planes k >= khp, times ``w``."""
    nz = vol.shape[1]
    nh = sm.shape[1]
    kh = nz // 2
    khp = nz - kh
    k = torch.arange(khp, dtype=torch.float32, device=vol.device)
    a = (m[1, 0] * i + m[1, 1] * j + m[1, 3]) * f
    b = m[1, 2] * f
    y = a[:, None] + b[:, None] * k                         # (lines, khp)
    w = w[:, None]
    vol[:, :khp] += interp(sm, y, nh) * w
    if kh:
        y_m = (nh - 1.0) - y[:, :kh]                        # O3 mirror
        vol[:, khp:] += (interp(sm, y_m, nh) * w).flip(1)


def backproject_subline_plain(img_t: torch.Tensor, mat: torch.Tensor,
                              vol_shape_xyz: Sequence[int]) -> torch.Tensor:
    """The kernel's function in plain PyTorch, per projection: the stage-1
    blend of each line's two detector columns into a (lines, nh) sub-line
    buffer, then the y-affine stage 2 over k < khp and the O3 mirror
    (nh-1) - y for the planes k >= khp."""
    ni, nj, nz = (int(v) for v in vol_shape_xyz)
    nw = img_t.shape[1]
    i, j = _line_grid(ni, nj, img_t.device)
    vol = torch.zeros((ni * nj, nz), dtype=torch.float32,
                      device=img_t.device)
    for s in range(img_t.shape[0]):
        m = mat[s]
        ok, f, ixc, dx = _line_scalars(m, i, j, nw)
        sm = (img_t[s][ixc] * (1.0 - dx)[:, None]
              + img_t[s][ixc + 1] * dx[:, None])           # stage 1
        _accumulate(vol, sm, m, i, j, f, torch.where(ok, f * f, 0.0))
    return vol.reshape(ni, nj, nz)


def launch_error(name: str, lib, err: int) -> RuntimeError:
    return RuntimeError(
        f"{name} launch failed: CUDA error {err} "
        f"({lib.bp_cuda_error_string(err).decode()})")


def max_stage(nb: int, fits) -> int:
    """Deepest staging (<= nb) for which ``fits(stage)`` (the block's
    buffers fit its shared memory). The depth changes no result: each
    voxel's sum is taken in projection order whatever the staging."""
    stage = nb
    while stage > 1 and not fits(stage):
        stage -= 1
    return stage


def check_depth(lib, nz: int) -> None:
    if nz - nz // 2 > lib.bp_subline_max_khp():
        raise ValueError(f"nz={nz} exceeds the kernel's largest depth "
                         f"{2 * lib.bp_subline_max_khp()}")


def _launch(img_t, mat, shape, stage: int) -> torch.Tensor:
    lib = _lib()
    ni, nj, nz = shape
    n_proj, nw, nh = img_t.shape
    check_depth(lib, nz)
    if lib.bp_subline_smem_bytes(nh, stage) > SMEM_PER_BLOCK:
        raise ValueError(f"nh={nh} needs more shared memory per block than "
                         f"the card has, even at one staged projection")
    out = torch.empty(shape, dtype=torch.float32, device=img_t.device)
    with torch.cuda.device(img_t.device):
        stream = torch.cuda.current_stream(img_t.device).cuda_stream
        err = lib.bp_subline_launch(
            img_t.data_ptr(), mat.data_ptr(), out.data_ptr(), n_proj, nw, nh,
            ni, nj, nz, stage, stream)
    if err != 0:
        raise launch_error("backproject_subline", lib, err)
    return out


def _max_stage(nh: int, nb: int) -> int:
    lib = _lib()
    return max_stage(
        nb, lambda st: lib.bp_subline_smem_bytes(nh, st) <= SMEM_PER_BLOCK)


def backproject_subline_kernel(img_t: torch.Tensor, mat: torch.Tensor,
                               vol_shape_xyz, *, block=(4, 8)) -> torch.Tensor:
    """K1: back-project with one staged projection per loop step.

    img_t (np, nw, nh) f32; mat (np, 3, 4) f32, both contiguous and on
    one device. Returns vol_t (nx, ny, nz) f32. ``block`` is only the
    i/j padding granularity of the caller (``ops._run_padded``); the
    kernel masks its own ragged edge. Any nz up to 2048 (odd nz by an
    uneven half-split).
    """
    shape = _check(img_t, mat, vol_shape_xyz, block)
    if img_t.device.type == "cpu":
        return backproject_subline_plain(img_t, mat, shape)
    out = _launch(img_t, mat, shape, stage=1)
    LAUNCHES["backproject_subline_kernel"] += 1
    return out


def backproject_subline_fused(img_t: torch.Tensor, mat: torch.Tensor,
                              vol_shape_xyz, *, block=(4, 8),
                              nb: int = 8) -> torch.Tensor:
    """K2: the fused multi-batch (``proj_loop``) form of K1.

    Identical math; each step of the kernel's projection loop stages
    ``nb`` projections (fewer only where nb of them would not fit a
    block's shared memory). Requires ``n_proj % nb == 0``, like the
    reference's fused kernel.
    """
    shape = _check(img_t, mat, vol_shape_xyz, block)
    nb = int(nb)
    if nb < 1 or img_t.shape[0] % nb:
        raise ValueError(f"the fused kernel needs nb >= 1 dividing "
                         f"n_proj={img_t.shape[0]}, got nb={nb}")
    if img_t.device.type == "cpu":
        return backproject_subline_plain(img_t, mat, shape)
    out = _launch(img_t, mat, shape, stage=_max_stage(img_t.shape[2], nb))
    LAUNCHES["backproject_subline_fused"] += 1
    return out
