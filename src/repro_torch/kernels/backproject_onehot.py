"""One-hot interpolation back-projection kernel for Hopper.

Replaces the two Pallas kernels of the JAX package's
``kernels/backproject_onehot.py``: ``backproject_onehot_pallas`` (l.144,
K3) and ``backproject_onehot_fused`` (l.175, K4). One CUDA kernel,
``csrc/backproject_onehot.cu``, serves both: K3 stages one projection per
step of its projection loop, K4 stages ``nb``.

The schedule, hoisting, symmetry and stage 1 are the sub-line kernel's.
Stage 2 is the reference's contraction over the detector rows,
``val[k] = sum_n A[k, n] * row[n]``, with the two-hot interpolation row
``A`` built from compares, in ``k_chunk`` tiles of k: 2*nh FLOP per
sample where the sub-line kernel gathers two rows.

What bounds it on an H100. The function is K1's (8 FLOP per voxel-view
update: 5.5e11 FLOP at P5, 8.2 ms at 67 TFLOP/s). The design's own work
is the contraction, 2*nh FLOP per sample: 7.0e13 FLOP at P5, about 1.05 s
of FP32 FMA on the CUDA cores, each FMA with its two compares and selects.
On the TPU the contraction ran on the MXU as a batched GEMV with a
different ``A`` per line; the tensor cores' ``mma``/``wgmma`` need N >= 8
columns sharing one A, and plain TF32 would miss the 1e-6 bar to K1, so
this kernel contracts in FP32 on the CUDA cores, every lane holding a few
planes and reading the row once per n as a shared-memory broadcast.

On a CPU tensor the wrappers run :func:`backproject_onehot_plain`; on a
CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence

import torch

from . import backproject_subline as ks

#: Launches of each kernel wrapper in this process (one per launch, counted
#: only where the wrapper launches the CUDA kernel).
LAUNCHES: Dict[str, int] = {"backproject_onehot_kernel": 0,
                            "backproject_onehot_fused": 0}

#: Bytes of one (lines, kc, nh) block of ``A`` in the plain version; the
#: lines are chunked to stay under it.
PLAIN_BLOCK_BYTES = 1 << 26

_LIB = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib():
    global _LIB
    if _LIB is None:
        from . import _build
        lib = _build.load("backproject_onehot")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.bp_onehot_launch.argtypes = [vp, vp, vp] + [ci] * 8 + [vp]
        lib.bp_onehot_launch.restype = ci
        lib.bp_onehot_smem_bytes.argtypes = [ci, ci, ci]
        lib.bp_onehot_smem_bytes.restype = ctypes.c_size_t
        lib.bp_cuda_error_string.argtypes = [ci]
        lib.bp_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def clip_k_chunk(k_chunk: int, nz: int) -> int:
    """The reference's clip: at most the direct half's nz - nz//2 planes."""
    k_chunk = min(int(k_chunk), nz - nz // 2)
    if k_chunk < 1:
        raise ValueError(f"k_chunk must be >= 1, got {k_chunk}")
    return k_chunk


def _interp_onehot(sm: torch.Tensor, y: torch.Tensor, nh: int,
                   k_chunk: int) -> torch.Tensor:
    """Rows of ``sm`` (lines, nh) at ``y`` (lines, nk) by the two-hot
    contraction: ``A = lo*(1-dy) + hi*dy`` from compares with
    ``iyc = clip(floor(y), 0, nh-2)``, masked by ``ok`` (floor(y) in
    [0, nh-2]), contracted with the rows k_chunk planes at a time, the
    lines chunked so one block of A stays under PLAIN_BLOCK_BYTES."""
    lines, nk = y.shape
    n = torch.arange(nh, device=y.device)
    out = torch.empty_like(y)
    step = max(1, PLAIN_BLOCK_BYTES // (4 * k_chunk * nh))
    for l0 in range(0, lines, step):
        rows = sm[l0:l0 + step]
        for k0 in range(0, nk, k_chunk):
            yy = y[l0:l0 + step, k0:k0 + k_chunk]
            y0 = torch.floor(yy)
            dy = yy - y0
            ok = (y0 >= 0) & (y0 <= nh - 2)
            iyc = torch.where(ok, y0, 0.0).long()[..., None]
            lo = (n == iyc).to(torch.float32)
            hi = (n == iyc + 1).to(torch.float32)
            a = lo * (1.0 - dy)[..., None] + hi * dy[..., None]
            a = a * ok[..., None].to(torch.float32)
            out[l0:l0 + step, k0:k0 + k_chunk] = torch.einsum(
                "lkn,ln->lk", a, rows)
    return out


def backproject_onehot_plain(img_t: torch.Tensor, mat: torch.Tensor,
                             vol_shape_xyz: Sequence[int], *,
                             k_chunk: int = 128,
                             origin=(0, 0)) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the sub-line plain version
    with stage 2 as the two-hot contraction (:func:`_interp_onehot`). The
    mirrored half covers k < nz//2 only; the middle plane of odd nz comes
    from the direct half.

    ``origin`` (i0, j0) computes only the ni x nj box of lines from there
    of a larger volume of the same nz, with the same arithmetic per line:
    the way to hold the kernel against this version where the whole
    volume would take it too long."""
    ni, nj, nz = (int(v) for v in vol_shape_xyz)
    nw, nh = img_t.shape[1], img_t.shape[2]
    kc = clip_k_chunk(k_chunk, nz)
    i, j = ks._line_grid(ni, nj, img_t.device, origin)
    vol = torch.zeros((ni * nj, nz), dtype=torch.float32,
                      device=img_t.device)
    interp = functools.partial(_interp_onehot, k_chunk=kc)
    for s in range(img_t.shape[0]):
        m = mat[s]
        ok, f, ixc, dx = ks._line_scalars(m, i, j, nw)
        sm = (img_t[s][ixc] * (1.0 - dx)[:, None]
              + img_t[s][ixc + 1] * dx[:, None])           # stage 1
        ks._accumulate(vol, sm, m, i, j, f, torch.where(ok, f * f, 0.0),
                       interp=interp)
    return vol.reshape(ni, nj, nz)


def _launch(img_t, mat, shape, k_chunk: int, stage: int) -> torch.Tensor:
    lib = _lib()
    ni, nj, nz = shape
    n_proj, nw, nh = img_t.shape
    if lib.bp_onehot_smem_bytes(nh, nz, stage) > ks.SMEM_PER_BLOCK:
        raise ValueError(f"nh={nh}, nz={nz} need more shared memory per "
                         f"block than the card has, even at one staged "
                         f"projection")
    out = torch.empty(shape, dtype=torch.float32, device=img_t.device)
    with torch.cuda.device(img_t.device):
        stream = torch.cuda.current_stream(img_t.device).cuda_stream
        err = lib.bp_onehot_launch(
            img_t.data_ptr(), mat.data_ptr(), out.data_ptr(), n_proj, nw, nh,
            ni, nj, nz, stage, k_chunk, stream)
    if err != 0:
        raise ks.launch_error("backproject_onehot", lib, err)
    return out


def _max_stage(nh: int, nz: int, nb: int) -> int:
    lib = _lib()
    return ks.max_stage(
        nb, lambda st: lib.bp_onehot_smem_bytes(nh, nz, st)
        <= ks.SMEM_PER_BLOCK)


def backproject_onehot_kernel(img_t: torch.Tensor, mat: torch.Tensor,
                              vol_shape_xyz, *, block=(4, 8),
                              k_chunk: int = 128) -> torch.Tensor:
    """K3: one-hot back-projection, one staged projection per loop step.

    img_t (np, nw, nh) f32; mat (np, 3, 4) f32, both contiguous and on
    one device. Returns vol_t (nx, ny, nz) f32. ``block`` is only the
    caller's i/j padding granularity; ``k_chunk`` tiles the k range
    (clipped to nz - nz//2) and changes no result.
    """
    shape = ks._check(img_t, mat, vol_shape_xyz, block)
    kc = clip_k_chunk(k_chunk, shape[2])
    if img_t.device.type == "cpu":
        return backproject_onehot_plain(img_t, mat, shape, k_chunk=kc)
    out = _launch(img_t, mat, shape, kc, stage=1)
    LAUNCHES["backproject_onehot_kernel"] += 1
    return out


def backproject_onehot_fused(img_t: torch.Tensor, mat: torch.Tensor,
                             vol_shape_xyz, *, block=(4, 8),
                             k_chunk: int = 128, nb: int = 8) -> torch.Tensor:
    """K4: K3 staging ``nb`` projections per loop step (fewer only where
    shared memory caps the depth). Requires ``n_proj % nb == 0``."""
    shape = ks._check(img_t, mat, vol_shape_xyz, block)
    kc = clip_k_chunk(k_chunk, shape[2])
    nb = int(nb)
    if nb < 1 or img_t.shape[0] % nb:
        raise ValueError(f"the fused kernel needs nb >= 1 dividing "
                         f"n_proj={img_t.shape[0]}, got nb={nb}")
    if img_t.device.type == "cpu":
        return backproject_onehot_plain(img_t, mat, shape, k_chunk=kc)
    out = _launch(img_t, mat, shape, kc,
                  stage=_max_stage(img_t.shape[2], shape[2], nb))
    LAUNCHES["backproject_onehot_fused"] += 1
    return out
