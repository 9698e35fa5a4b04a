"""One-hot interpolation back-projection for Hopper.

Replaces the two Pallas kernels of the JAX package's
``kernels/backproject_onehot.py``: ``backproject_onehot_pallas`` (l.144,
K3) and ``backproject_onehot_fused`` (l.175, K4). Both launch the tiled
sub-line kernel (``tile_kernel`` in ``csrc/backproject_subline.cu``,
under ``backproject_subline.launch_plan``) with stage 2 in its two-hot
form, ``bp::twohot_rn``: the nonzero terms of the reference's contraction
``val[k] = sum_n A[k, n] * row[n]``, whose two-hot row ``A`` is zero but
for ``1 - dy`` at ``iyc`` and ``dy`` at ``iyc + 1``. Taken in the dense
sum's roundings, ``fma(dy, row[iyc+1], (1-dy) * row[iyc])``, they give the
dense sum bit for bit on finite projections (a term ``0 * row[n]`` leaves
a finite partial sum as it is), up to the sign of a zero sum. A
non-finite projection value the dense form spreads to every plane of the
line (``0 * inf = NaN``); the kernel, like the oracle, keeps it to the
planes that sample it.

``k_chunk`` is accepted and clipped as the reference does, and changes no
bit: in the contraction it only tiles the planes, and each plane's value
depends on its own row of ``A`` alone. The kernel's k chunks come from
the launch plan. K4 keeps ``nb`` for the reference's ``n_proj % nb == 0``
contract; it is the same launch as K3, so K3 = K4 bit for bit.

What bounds it on an H100. The function is K1's, bound by operations:
8 FLOP per voxel-view update, 5.5e11 FLOP at P5, 8.2 ms at 67 TFLOP/s.
What bounds this design is K1's too, instruction issue (about 20 a
sample, 2 blocks of 8 warps an SM at P5): the two-hot form costs what the
linear one does, an fsub, an fmul and an fma. The kernel it replaced ran
the contraction densely over all nh rows, 2*nh FMAs a sample (7.0e13
FLOP at P5), each with two compares and two selects to build ``A``: about
7.5 s at P5. On the TPU the dense form paid (the MXU contracts it, where a
gather along lanes serialises); on Hopper a gather from shared memory is
cheap, and the tensor cores cannot take it (each line has its own ``A``).

The lane wrappers (:func:`backproject_onehot_kernel_lanes`,
:func:`backproject_onehot_fused_lanes`) take rb stacked inputs against one
``mat`` in one launch (``backproject_subline.launch_tile_lanes``), each
lane equal bit for bit to the solo launch on it.

On a CPU tensor the wrappers run :func:`backproject_onehot_plain`, the
dense contraction (the lane wrappers once per lane); on a CUDA tensor
they launch the kernel or raise.
"""

from __future__ import annotations

import functools
from typing import Dict, Sequence

import torch

from . import backproject_subline as ks

#: Launches of each kernel wrapper in this process (one per launch, counted
#: only where the wrapper launches the CUDA kernel).
LAUNCHES: Dict[str, int] = {"backproject_onehot_kernel": 0,
                            "backproject_onehot_fused": 0,
                            "backproject_onehot_kernel_lanes": 0,
                            "backproject_onehot_fused_lanes": 0}

#: Bytes of one (lines, kc, nh) block of ``A`` in the plain version; the
#: lines are chunked to stay under it.
PLAIN_BLOCK_BYTES = 1 << 26


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def backproject_onehot_kernel(img_t: torch.Tensor, mat: torch.Tensor,
                              vol_shape_xyz, *, block=(4, 8),
                              k_chunk: int = 128) -> torch.Tensor:
    """K3: one-hot back-projection through the tiled kernel's two-hot
    form.

    img_t (np, nw, nh) f32; mat (np, 3, 4) f32, both contiguous and on
    one device. Returns vol_t (nx, ny, nz) f32. ``block`` is only the
    caller's i/j padding granularity; ``k_chunk`` is the reference's k
    tile, clipped to nz - nz//2, and changes no bit.
    """
    shape = ks._check(img_t, mat, vol_shape_xyz, block)
    kc = clip_k_chunk(k_chunk, shape[2])
    if img_t.device.type == "cpu":
        return backproject_onehot_plain(img_t, mat, shape, k_chunk=kc)
    out = ks.launch_tile(img_t, mat, shape, ks.TWO_HOT, "backproject_onehot")
    LAUNCHES["backproject_onehot_kernel"] += 1
    return out


def backproject_onehot_fused(img_t: torch.Tensor, mat: torch.Tensor,
                             vol_shape_xyz, *, block=(4, 8),
                             k_chunk: int = 128, nb: int = 8) -> torch.Tensor:
    """K4: the fused multi-batch form of K3, the same launch, so the same
    bits whatever ``nb``. Requires ``n_proj % nb == 0``, like the
    reference's fused kernel."""
    shape = ks._check(img_t, mat, vol_shape_xyz, block)
    kc = clip_k_chunk(k_chunk, shape[2])
    nb = int(nb)
    if nb < 1 or img_t.shape[0] % nb:
        raise ValueError(f"the fused kernel needs nb >= 1 dividing "
                         f"n_proj={img_t.shape[0]}, got nb={nb}")
    if img_t.device.type == "cpu":
        return backproject_onehot_plain(img_t, mat, shape, k_chunk=kc)
    out = ks.launch_tile(img_t, mat, shape, ks.TWO_HOT, "backproject_onehot")
    LAUNCHES["backproject_onehot_fused"] += 1
    return out


def backproject_onehot_lanes_plain(img_b: torch.Tensor, mat: torch.Tensor,
                                   vol_shape_xyz, *,
                                   k_chunk: int = 128) -> torch.Tensor:
    """The lane wrappers' plain version: the dense contraction once per
    lane, stacked to (rb, ni, nj, nz)."""
    return torch.stack([backproject_onehot_plain(img_b[r], mat,
                                                 vol_shape_xyz,
                                                 k_chunk=k_chunk)
                        for r in range(img_b.shape[0])])


def backproject_onehot_kernel_lanes(img_b: torch.Tensor, mat: torch.Tensor,
                                    vol_shape_xyz, *, block=(4, 8),
                                    k_chunk: int = 128) -> torch.Tensor:
    """K3 on rb lanes: ``img_b`` (rb, np, nw, nh), one ``mat`` -> (rb, nx,
    ny, nz), one launch; lane r equals :func:`backproject_onehot_kernel`
    on ``img_b[r]`` bit for bit."""
    shape = ks._check_lanes(img_b, mat, vol_shape_xyz, block)
    kc = clip_k_chunk(k_chunk, shape[2])
    if img_b.device.type == "cpu":
        return backproject_onehot_lanes_plain(img_b, mat, shape, k_chunk=kc)
    out = ks.launch_tile_lanes(img_b, mat, shape, ks.TWO_HOT,
                               "backproject_onehot")
    LAUNCHES["backproject_onehot_kernel_lanes"] += 1
    return out


def backproject_onehot_fused_lanes(img_b: torch.Tensor, mat: torch.Tensor,
                                   vol_shape_xyz, *, block=(4, 8),
                                   k_chunk: int = 128,
                                   nb: int = 8) -> torch.Tensor:
    """K4 on rb lanes: K3's lane launch under K4's ``n_proj % nb == 0``
    contract."""
    shape = ks._check_lanes(img_b, mat, vol_shape_xyz, block)
    kc = clip_k_chunk(k_chunk, shape[2])
    nb = int(nb)
    if nb < 1 or img_b.shape[1] % nb:
        raise ValueError(f"the fused kernel needs nb >= 1 dividing "
                         f"n_proj={img_b.shape[1]}, got nb={nb}")
    if img_b.device.type == "cpu":
        return backproject_onehot_lanes_plain(img_b, mat, shape, k_chunk=kc)
    out = ks.launch_tile_lanes(img_b, mat, shape, ks.TWO_HOT,
                               "backproject_onehot")
    LAUNCHES["backproject_onehot_fused_lanes"] += 1
    return out
