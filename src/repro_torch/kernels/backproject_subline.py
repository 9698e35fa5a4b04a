"""Sub-line back-projection kernel for Hopper (paper Algorithm 1).

Replaces the two Pallas kernels of the JAX package's
``kernels/backproject_subline.py``: ``backproject_subline_pallas``
(l.204, K1) and ``backproject_subline_fused`` (l.240, K2). One CUDA
kernel, ``tile_kernel`` in ``csrc/backproject_subline.cu``, serves both
with the same launch (:func:`launch_plan`); K2 keeps ``nb`` for the
reference's ``n_proj % nb == 0`` contract. The one-hot K3/K4
(``backproject_onehot.py``) launch the same kernel in its two-hot form
through :func:`launch_tile`, and the banded K5/K6
(``backproject_banded.py``) its linear form reading the band layout,
under the same plan.

What bounds it on an H100. By the repo's cost model (8 floating-point
operations per voxel-view update) the function is bound by operations: at
P5 (512^3 voxels, 512 views) 5.5e11 FLOP against 1.07 GB of compulsory
traffic (the projections read once, the volume written once). A block
owns a tile of 8 x 8 voxel lines and a mirror-paired chunk of k planes,
walks over all projections itself, keeps every voxel's sum in a register
of one lane and writes it once, with no atomics and a fixed summation
order: what the TPU kernel's output-stationary grid gave. Per view the
tile's detector window (the columns its lines' floor(x) reach and the rows
its k chunk's samples reach) goes into shared memory once, copied with
``cp.async`` into a ring of two windows that runs one view ahead, and the
64 lines blend their sub-lines from it; the kernel it replaced read two
columns per line per view through L2 (about 550 GB at P5). What is left is
instruction issue: about 20 instructions a sample in stage 1 and stage 2,
against the cost model's 8 FLOP. :func:`launch_plan` shortens the k
chunk where the detector is finer than the voxels, so that a chunk's rows
still fit a window slot (P4, P7, P8); it reads the rows a plane spans
from the launch's matrices, so a Z-slab of a tiled walk gets the plan of
the volume it belongs to. A window wider than the kernel's 16
columns (those problems, oblique geometries) or still taller than the slot
is read from global memory instead, for that tile and view.

The lane wrappers (:func:`backproject_subline_kernel_lanes`,
:func:`backproject_subline_fused_lanes`) back-project rb stacked inputs
``img_b (rb, np, nw, nh)`` against one shared ``mat`` in ONE launch of the
same kernel (:func:`launch_tile_lanes`: the grid's z is the lane), each
lane equal bit for bit to the solo launch on that lane's input; this is
what batches requests (``runtime.executor.ProgramCache.batch_program``).

On a CPU tensor the wrappers run :func:`backproject_subline_plain` (the
lane wrappers once per lane), the same function in plain PyTorch; on a
CUDA tensor they launch the kernel or raise. Nothing else selects the
path.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, Sequence

import torch

#: Launches of each kernel wrapper in this process (one per launch, counted
#: only where the wrapper launches the CUDA kernel).
LAUNCHES: Dict[str, int] = {"backproject_subline_kernel": 0,
                            "backproject_subline_fused": 0,
                            "backproject_subline_kernel_lanes": 0,
                            "backproject_subline_fused_lanes": 0}

#: Dynamic shared memory a block may use on an H100 (227 KB).
SMEM_PER_BLOCK = 232448

#: The voxel lines (i, j) one block of the tiled K1-K6 kernel owns
#: (``tiled::kTi``, ``tiled::kTj`` of the CUDA source).
TILE = (8, 8)

#: Stage 2's interpolation forms of the tiled kernel (``tiled::kLinear``,
#: ``tiled::kTwoHot``): K1/K2 interpolate linearly, K3/K4 take the two-hot
#: contraction's nonzero terms.
LINEAR, TWO_HOT = 0, 1

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
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bp_tile_launch_lanes.argtypes = ([vp, vp, vp, ci, cl, cl]
                                             + [ci] * 9 + [vp])
        lib.bp_tile_launch_lanes.restype = ci
        lib.bp_tile_smem_bytes.argtypes = [ci, ci]
        lib.bp_tile_smem_bytes.restype = ctypes.c_size_t
        lib.bp_tile_occupancy.argtypes = [ci] * 5 + [ctypes.POINTER(ci)] * 3
        lib.bp_tile_occupancy.restype = ci
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


def _check_lanes(img_b, mat, vol_shape_xyz, block) -> tuple:
    """Validate an rb-lane call (``img_b`` (rb, np, nw, nh), each lane
    contiguous, lanes at any stride apart); return the volume shape."""
    if not isinstance(img_b, torch.Tensor) or img_b.dim() != 4 \
            or img_b.shape[0] < 1:
        raise ValueError(f"img_b must be a (rb >= 1, np, nw, nh) tensor, "
                         f"got {getattr(img_b, 'shape', type(img_b))}")
    if img_b.shape[0] > 65535:
        raise ValueError(f"rb={img_b.shape[0]} lanes exceed a grid's "
                         f"65535")
    return _check(img_b[0], mat, vol_shape_xyz, block)


def lane_stride(t: torch.Tensor) -> int:
    """Elements between the lanes of ``t`` (0 for one lane)."""
    return int(t.stride(0)) if t.shape[0] > 1 else 0


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


def backproject_subline_lanes_plain(img_b: torch.Tensor, mat: torch.Tensor,
                                    vol_shape_xyz) -> torch.Tensor:
    """The lane wrappers' plain version: the plain version once per lane,
    stacked to (rb, ni, nj, nz)."""
    return torch.stack([backproject_subline_plain(img_b[r], mat,
                                                  vol_shape_xyz)
                        for r in range(img_b.shape[0])])


def launch_error(name: str, lib, err: int) -> RuntimeError:
    return RuntimeError(
        f"{name} launch failed: CUDA error {err} "
        f"({lib.bp_cuda_error_string(err).decode()})")


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How the tiled K1-K6 kernel (tiles of TILE lines) is launched for
    one call. The kernel lays out its shared memory from ``win_rows`` and
    the detector height (``bp_tile_smem_bytes``)."""
    kpt: int             # direct planes per lane of a block
    k_chunk: int         # direct planes per block (32 * kpt), with mirrors
    grid: tuple          # blocks: (tiles, k chunks)
    win_rows: int        # detector rows a window slot holds (of 16 columns)


def plane_rows(mat: torch.Tensor, vol_shape_xyz) -> float:
    """The detector rows one k plane spans at the centre line of the box,
    the most over the views: |M[1][2]| / z there (y is affine in k with
    slope M[1][2] / z, V being parallel to Z). It reads the matrices the
    launch is given, translated to a sub-box or not, so a Z-slab sees the
    magnification of the volume it belongs to, whatever its depth. One
    value is read back from the device."""
    ni, nj, _ = (int(v) for v in vol_shape_xyz)
    z = (mat[:, 2, 0] * ((ni - 1) / 2.0) + mat[:, 2, 1] * ((nj - 1) / 2.0)
         + mat[:, 2, 3])
    rows = torch.where(z > 0, mat[:, 1, 2].abs() / z, 0.0)
    return float(rows.max())


def launch_plan(vol_shape_xyz, nh: int, rows=None) -> LaunchPlan:
    """The tiled kernel's launch for a volume and detector height.

    k is split into chunks of 32*kpt direct planes with their O3 mirrors,
    kpt the smallest of 1, 2, 4 whose chunk holds the direct half, 4 past
    that (the fewer chunks, the less per-view work repeats; 64 sums a lane
    at most). A plane spans ``m`` detector rows: ``ceil(rows)``, the rows
    a launch's matrices give (:func:`plane_rows`), or without them ``m =
    ceil(nh / nz)``, which holds where the detector frames the volume
    (``standard_geometry``; P4, P7, P8 have m = 2, 4, 2; on P1-P10 the
    two rules give the same plan). kpt is halved while a chunk would span more than 128 rows, and
    a window slot holds the chunk's direct and mirrored rows at m rows a
    plane (4 at most), with 8 rows of margin each. A window that still
    does not fit takes the kernel's global-read paths.
    """
    ni, nj, nz = (int(v) for v in vol_shape_xyz)
    khp = nz - nz // 2
    m = -(-nh // nz) if rows is None else max(1, math.ceil(rows))
    kpt = 1 if khp <= 32 else 2 if khp <= 64 else 4
    while kpt > 1 and 32 * kpt * m > 128:
        kpt //= 2
    k_chunk = 32 * kpt
    n_chunks = -(-khp // k_chunk)
    if n_chunks > 65535:
        raise ValueError(f"nz={nz} needs {n_chunks} k chunks, more than a "
                         f"grid's 65535")
    grid = (-(-ni // TILE[0]) * -(-nj // TILE[1]), n_chunks)
    return LaunchPlan(kpt, k_chunk, grid, 2 * k_chunk * min(m, 4) + 16)


def launch_tile_lanes(img_b, mat, shape, form: int,
                      name: str) -> torch.Tensor:
    """One launch of the tiled kernel over the rb lanes of ``img_b`` (rb,
    np, nw, nh) under :func:`launch_plan`, stage 2 in ``form``; returns
    (rb,) + shape and raises naming ``name`` if the launch fails."""
    lib = _lib()
    ni, nj, nz = shape
    rb, n_proj, nw, nh = img_b.shape
    plan = launch_plan(shape, nh, plane_rows(mat, shape))
    out = torch.empty((rb,) + tuple(shape), dtype=torch.float32,
                      device=img_b.device)
    with torch.cuda.device(img_b.device):
        stream = torch.cuda.current_stream(img_b.device).cuda_stream
        err = lib.bp_tile_launch_lanes(
            img_b.data_ptr(), mat.data_ptr(), out.data_ptr(), rb,
            lane_stride(img_b), lane_stride(out), n_proj, nw, nh, ni, nj,
            nz, plan.kpt, plan.win_rows, form, stream)
    if err != 0:
        raise launch_error(name, lib, err)
    return out


def launch_tile(img_t, mat, shape, form: int, name: str) -> torch.Tensor:
    """One launch of the tiled kernel on one input (the one-lane launch
    of :func:`launch_tile_lanes`)."""
    return launch_tile_lanes(img_t[None], mat, shape, form, name)[0]


def backproject_subline_kernel(img_t: torch.Tensor, mat: torch.Tensor,
                               vol_shape_xyz, *, block=(4, 8)) -> torch.Tensor:
    """K1: back-project through the tiled kernel.

    img_t (np, nw, nh) f32; mat (np, 3, 4) f32, both contiguous and on
    one device. Returns vol_t (nx, ny, nz) f32. ``block`` is only the
    i/j padding granularity of the caller (``ops._run_padded``); the
    kernel masks its own ragged edge. Any nz (odd nz by an uneven
    half-split).
    """
    shape = _check(img_t, mat, vol_shape_xyz, block)
    if img_t.device.type == "cpu":
        return backproject_subline_plain(img_t, mat, shape)
    out = launch_tile(img_t, mat, shape, LINEAR, "backproject_subline")
    LAUNCHES["backproject_subline_kernel"] += 1
    return out


def backproject_subline_fused(img_t: torch.Tensor, mat: torch.Tensor,
                              vol_shape_xyz, *, block=(4, 8),
                              nb: int = 8) -> torch.Tensor:
    """K2: the fused multi-batch (``proj_loop``) form of K1.

    The same launch as K1, so the same bits: the kernel walks every view
    itself, one window ahead, whatever ``nb``. Requires ``n_proj % nb ==
    0``, like the reference's fused kernel.
    """
    shape = _check(img_t, mat, vol_shape_xyz, block)
    nb = int(nb)
    if nb < 1 or img_t.shape[0] % nb:
        raise ValueError(f"the fused kernel needs nb >= 1 dividing "
                         f"n_proj={img_t.shape[0]}, got nb={nb}")
    if img_t.device.type == "cpu":
        return backproject_subline_plain(img_t, mat, shape)
    out = launch_tile(img_t, mat, shape, LINEAR, "backproject_subline")
    LAUNCHES["backproject_subline_fused"] += 1
    return out


def backproject_subline_kernel_lanes(img_b: torch.Tensor, mat: torch.Tensor,
                                     vol_shape_xyz, *,
                                     block=(4, 8)) -> torch.Tensor:
    """K1 on rb lanes: ``img_b`` (rb, np, nw, nh), one ``mat`` (np, 3, 4)
    -> (rb, nx, ny, nz), one launch; lane r equals
    :func:`backproject_subline_kernel` on ``img_b[r]`` bit for bit."""
    shape = _check_lanes(img_b, mat, vol_shape_xyz, block)
    if img_b.device.type == "cpu":
        return backproject_subline_lanes_plain(img_b, mat, shape)
    out = launch_tile_lanes(img_b, mat, shape, LINEAR, "backproject_subline")
    LAUNCHES["backproject_subline_kernel_lanes"] += 1
    return out


def backproject_subline_fused_lanes(img_b: torch.Tensor, mat: torch.Tensor,
                                    vol_shape_xyz, *, block=(4, 8),
                                    nb: int = 8) -> torch.Tensor:
    """K2 on rb lanes: K1's lane launch under K2's ``n_proj % nb == 0``
    contract."""
    shape = _check_lanes(img_b, mat, vol_shape_xyz, block)
    nb = int(nb)
    if nb < 1 or img_b.shape[1] % nb:
        raise ValueError(f"the fused kernel needs nb >= 1 dividing "
                         f"n_proj={img_b.shape[1]}, got nb={nb}")
    if img_b.device.type == "cpu":
        return backproject_subline_lanes_plain(img_b, mat, shape)
    out = launch_tile_lanes(img_b, mat, shape, LINEAR, "backproject_subline")
    LAUNCHES["backproject_subline_fused_lanes"] += 1
    return out
