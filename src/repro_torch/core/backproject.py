"""The paper's Algorithm 1 as plain PyTorch back-projectors.

Every function below consumes the *transposed* layouts of §3.1.1:

    img_t:  (np, nw, nh)   img_t[s][x][y]: detector columns contiguous
    mat:    (np, 3, 4)     index-space projection matrices
    vol_t:  (nx, ny, nz)   vol_t[i][j][k]: Z contiguous

These are the plain versions of the port: they run on whatever device
their tensors lie on, serve as the registry's ``_mp`` variants, and are
the oracles the CUDA kernel is held against. The paper's ladder
(Table 2):

    transpose               O1: layouts only
    share                   O1+O2: hoist F/W/X out of the k loop
    symmetry                O1+O2+O3: y for half the k range, mirror the rest
    subline                 O1+O2+O4: two-stage interpolation via sMem
    subline_batch           O1+O2+O4+O5: no O3 mirror (slab-safe)
    subline_symmetry_batch  O1..O5 = the paper's Algorithm 1
"""

from __future__ import annotations

import torch


# --------------------------------------------------------------------------
# Layout helpers (O1)
# --------------------------------------------------------------------------

def transpose_projections(img: torch.Tensor) -> torch.Tensor:
    """(np, nh, nw) -> (np, nw, nh), materialized (contiguous)."""
    return img.transpose(1, 2).contiguous()


def volume_to_native(vol_t: torch.Tensor) -> torch.Tensor:
    """(nx, ny, nz) -> (nz, ny, nx), as a view."""
    return vol_t.permute(2, 1, 0)


def volume_to_transposed(vol: torch.Tensor) -> torch.Tensor:
    """(nz, ny, nx) -> (nx, ny, nz), as a view."""
    return vol.permute(2, 1, 0)


# --------------------------------------------------------------------------
# Shared pieces
# --------------------------------------------------------------------------

def _ij_grids(ni: int, nj: int, device):
    i = torch.arange(ni, dtype=torch.float32, device=device)[:, None]
    j = torch.arange(nj, dtype=torch.float32, device=device)[None, :]
    return i, j


def hoisted_fwx(mat_s: torch.Tensor, ni: int, nj: int):
    """O2: the k-invariant per-(i,j) quantities for one projection.

    Returns F = 1/z, W = F*F, X = x (detector column) and z, each
    (ni, nj). Exactness relies on mat_s[0,2] == mat_s[2,2] == 0, which
    geometry.py guarantees (V axis parallel to Z).
    """
    i, j = _ij_grids(ni, nj, mat_s.device)
    z = mat_s[2, 0] * i + mat_s[2, 1] * j + mat_s[2, 3]
    f = 1.0 / z
    x = (mat_s[0, 0] * i + mat_s[0, 1] * j + mat_s[0, 3]) * f
    return f, f * f, x, z


def _y_coeffs(mat_s: torch.Tensor, f: torch.Tensor, ni: int, nj: int):
    """y(i,j,k) = a + b*k with a,b per-(i,j): affine in k (O2)."""
    i, j = _ij_grids(ni, nj, mat_s.device)
    a = (mat_s[1, 0] * i + mat_s[1, 1] * j + mat_s[1, 3]) * f
    b = mat_s[1, 2] * f
    return a, b.expand_as(a)


def _interp_column(sm: torch.Tensor, y: torch.Tensor, nh: int):
    """1-D interpolation inside the sub-line buffer (Fig. 3b).

    sm: (..., nh) sub-line values; y: (..., nk) fractional row coords.
    Returns (vals, valid) of shape (..., nk). Invalid rows gather row 0
    (their values are masked by the caller).
    """
    y0 = torch.floor(y)
    dy = y - y0
    valid = (y0 >= 0) & (y0 <= nh - 2)
    iyc = torch.where(valid, y0, 0.0).long()
    s0 = torch.gather(sm, -1, iyc)
    s1 = torch.gather(sm, -1, iyc + 1)
    return s0 * (1.0 - dy) + s1 * dy, valid


def _subline_buffer(img_ts: torch.Tensor, x: torch.Tensor, nw: int):
    """O4 stage one: blend detector columns floor(x), floor(x)+1 (Fig. 3a).

    img_ts: (nw, nh) one transposed projection; x: (ni, nj).
    Returns (sMem (ni, nj, nh), x_valid (ni, nj)).
    """
    x0 = torch.floor(x)
    dx = x - x0
    x_valid = (x0 >= 0) & (x0 <= nw - 2)
    ixc = torch.where(x_valid, x0, 0.0).long()
    col0 = img_ts[ixc]          # (ni, nj, nh)
    col1 = img_ts[ixc + 1]      # (ni, nj, nh)
    return col0 * (1.0 - dx)[..., None] + col1 * dx[..., None], x_valid


def _gather_corners(img_ts: torch.Tensor, ixc: torch.Tensor,
                    iyc: torch.Tensor):
    """The four bilinear corners ``img_ts[ixc(+1), iyc(+1)]`` of a
    transposed projection, at broadcastable integer indices."""
    nh = img_ts.shape[1]
    flat = img_ts.reshape(-1)
    base = ixc * nh + iyc
    return flat[base], flat[base + nh], flat[base + 1], flat[base + nh + 1]


def _clamped(v: torch.Tensor, hi: int):
    """floor(v) as an index, its fraction, and whether 0 <= floor(v) <=
    hi; invalid entries index 0 (their values are masked by the caller)."""
    v0 = torch.floor(v)
    valid = (v0 >= 0) & (v0 <= hi)
    return torch.where(valid, v0, 0.0).long(), v - v0, valid


# --------------------------------------------------------------------------
# O1: transpose only -- per-voxel math identical to the baseline
# --------------------------------------------------------------------------

def _bp_transpose_single(img_ts, mat_s, vol_shape_xyz):
    ni, nj, nk = vol_shape_xyz
    nw, nh = img_ts.shape
    dev = img_ts.device
    i = torch.arange(ni, dtype=torch.float32, device=dev)[:, None, None]
    j = torch.arange(nj, dtype=torch.float32, device=dev)[None, :, None]
    k = torch.arange(nk, dtype=torch.float32, device=dev)[None, None, :]
    z = mat_s[2, 0] * i + mat_s[2, 1] * j + mat_s[2, 2] * k + mat_s[2, 3]
    f = 1.0 / z
    x = (mat_s[0, 0] * i + mat_s[0, 1] * j + mat_s[0, 2] * k
         + mat_s[0, 3]) * f
    y = (mat_s[1, 0] * i + mat_s[1, 1] * j + mat_s[1, 2] * k
         + mat_s[1, 3]) * f
    # bilinear on the transposed image: img_t[x][y]
    ixc, dx, x_valid = _clamped(x, nw - 2)
    iyc, dy, y_valid = _clamped(y, nh - 2)
    v00, v10, v01, v11 = _gather_corners(img_ts, ixc, iyc)
    s0 = v00 * (1.0 - dx) + v10 * dx
    s1 = v01 * (1.0 - dx) + v11 * dx
    val = s0 * (1.0 - dy) + s1 * dy
    return torch.where(x_valid & y_valid & (z > 0), val * f * f, 0.0)


def bp_transpose(img_t, mat, vol_shape_xyz):
    shape = tuple(vol_shape_xyz)
    return _nb_batched(lambda im, mm: _bp_transpose_single(im, mm, shape),
                       img_t, mat, shape, 1)


# --------------------------------------------------------------------------
# O1+O2: hoisting F/W/X
# --------------------------------------------------------------------------

def _four_corner_interp(img_ts, x, y):
    """Per-point bilinear interpolation at hoisted columns ``x`` (ni, nj)
    and rows ``y`` (ni, nj, nk): four corner gathers per sample. Returns
    (vals, x_valid (ni, nj), y_valid (ni, nj, nk))."""
    nw, nh = img_ts.shape
    ixc, dx, x_valid = _clamped(x, nw - 2)
    iyc, dy, y_valid = _clamped(y, nh - 2)
    v00, v10, v01, v11 = _gather_corners(img_ts, ixc[..., None], iyc)
    s0 = v00 * (1.0 - dx)[..., None] + v10 * dx[..., None]
    s1 = v01 * (1.0 - dx)[..., None] + v11 * dx[..., None]
    return s0 * (1.0 - dy) + s1 * dy, x_valid, y_valid


def _bp_share_single(img_ts, mat_s, vol_shape_xyz):
    ni, nj, nk = vol_shape_xyz
    f, w, x, z = hoisted_fwx(mat_s, ni, nj)
    a, b = _y_coeffs(mat_s, f, ni, nj)
    k = torch.arange(nk, dtype=torch.float32, device=img_ts.device)
    y = a[..., None] + b[..., None] * k           # (ni, nj, nk)
    # interpolation still per point (no sub-line yet): four corners
    val, x_valid, y_valid = _four_corner_interp(img_ts, x, y)
    ok = (x_valid & (z > 0))[..., None] & y_valid
    return torch.where(ok, val * w[..., None], 0.0)


def bp_share(img_t, mat, vol_shape_xyz):
    shape = tuple(vol_shape_xyz)
    return _nb_batched(lambda im, mm: _bp_share_single(im, mm, shape),
                       img_t, mat, shape, 1)


# --------------------------------------------------------------------------
# O1+O2+O4: subline interpolation
# --------------------------------------------------------------------------

def _bp_subline_single(img_ts, mat_s, vol_shape_xyz):
    ni, nj, nk = vol_shape_xyz
    nw, nh = img_ts.shape
    f, w, x, z = hoisted_fwx(mat_s, ni, nj)
    sm, x_valid = _subline_buffer(img_ts, x, nw)  # (ni, nj, nh)
    a, b = _y_coeffs(mat_s, f, ni, nj)
    k = torch.arange(nk, dtype=torch.float32, device=img_ts.device)
    y = a[..., None] + b[..., None] * k
    val, y_valid = _interp_column(sm, y, nh)
    ok = (x_valid & (z > 0))[..., None] & y_valid
    return torch.where(ok, val * w[..., None], 0.0)


def bp_subline(img_t, mat, vol_shape_xyz):
    shape = tuple(vol_shape_xyz)
    return _nb_batched(lambda im, mm: _bp_subline_single(im, mm, shape),
                       img_t, mat, shape, 1)


def _nb_batched(single_fn, img_t, mat, vol_shape_xyz, nb):
    """Shared O5 scaffold: a loop over nb-batches of projections. Within
    a batch the partial sum accumulates apart from the volume, which is
    updated ONCE per batch (the 1/nb write-traffic reduction of §3.1.3).
    np must be divisible by nb (pad upstream via
    tiling.pad_projection_batch); nb = 1 is the per-projection loop of
    the unbatched rungs. The sums are taken in place, so peak memory stays
    one per-projection working set."""
    n_proj = img_t.shape[0]
    if n_proj % nb:
        raise ValueError(f"np={n_proj} not divisible by nb={nb}")
    vol = torch.zeros(tuple(vol_shape_xyz), dtype=torch.float32,
                      device=img_t.device)
    for s0 in range(0, n_proj, nb):
        part = single_fn(img_t[s0], mat[s0])
        for s in range(s0 + 1, s0 + nb):
            part += single_fn(img_t[s], mat[s])
        vol += part
    return vol


def bp_subline_batch(img_t, mat, vol_shape_xyz, nb: int = 8):
    """O1+O2+O4+O5: nb-batched subline WITHOUT the O3 mirror.

    The symmetry-free member of the batched family: exact on ANY
    translated sub-box of the volume (the O3 pairing k <-> nk-1-k is
    only meaningful when the box is centered on the volume's Z midplane).
    """
    shape = tuple(vol_shape_xyz)
    return _nb_batched(lambda im, mm: _bp_subline_single(im, mm, shape),
                       img_t, mat, shape, nb)


# --------------------------------------------------------------------------
# O1+O2+O3(+O4): symmetry -- y for k < nz/2 only, mirror the rest
# --------------------------------------------------------------------------

def _bp_symmetry_single(img_ts, mat_s, vol_shape_xyz, *, use_subline: bool):
    ni, nj, nk = vol_shape_xyz
    # Uneven half-split: k in [0, khp) computed directly (including the
    # self-mirrored middle plane when nk is odd), k in [khp, nk) filled
    # from the O3 mirror.
    kh = nk // 2           # mirrored half
    khp = nk - kh          # direct half (== kh, or kh+1 when nk odd)
    nw, nh = img_ts.shape
    f, w, x, z = hoisted_fwx(mat_s, ni, nj)
    a, b = _y_coeffs(mat_s, f, ni, nj)
    # O3 as a hoisted affine fold: the mirror identity gives the upper
    # half's row coordinate as y'(k) = (nh-1) - y(nk-1-k), itself affine
    # in k with the SAME slope b: y'(k) = (nh-1) - a - b*(nk-1) + b*k.
    a_m = (nh - 1.0) - a - b * (nk - 1.0)
    k = torch.arange(nk, dtype=torch.float32, device=img_ts.device)
    direct = k < khp
    y = torch.where(direct, a[..., None], a_m[..., None]) + b[..., None] * k
    if use_subline:
        sm, x_valid = _subline_buffer(img_ts, x, nw)
        val, y_valid = _interp_column(sm, y, nh)
    else:       # per-point four-corner gathers, shared x columns
        val, x_valid, y_valid = _four_corner_interp(img_ts, x, y)
    ok = (x_valid & (z > 0))[..., None] & y_valid
    return torch.where(ok, val * w[..., None], 0.0)


def bp_symmetry(img_t, mat, vol_shape_xyz):
    shape = tuple(vol_shape_xyz)
    return _nb_batched(
        lambda im, mm: _bp_symmetry_single(im, mm, shape, use_subline=False),
        img_t, mat, shape, 1)


# --------------------------------------------------------------------------
# O1..O5: the paper's Algorithm 1 (subline + symmetry + nb batching)
# --------------------------------------------------------------------------

def bp_subline_symmetry_batch(img_t, mat, vol_shape_xyz, nb: int = 8):
    """Paper Algorithm 1 semantics in plain PyTorch.

    Projections are processed in batches of ``nb``; within a batch the
    partial sums accumulate apart from the volume, and the volume is
    updated ONCE per batch (the 1/nb write-traffic reduction of §3.1.3).
    """
    shape = tuple(vol_shape_xyz)
    return _nb_batched(
        lambda im, mm: _bp_symmetry_single(im, mm, shape, use_subline=True),
        img_t, mat, shape, nb)


def bp_subline_symmetry_scan(img_t, mat, vol_shape_xyz):
    """Algorithm 1 semantics with SEQUENTIAL per-projection accumulation:
    the same math as :func:`bp_subline_symmetry_batch`, with the volume
    updated after every projection (peak temporaries one per-projection
    working set). The multi-device path uses it."""
    shape = tuple(vol_shape_xyz)
    return _nb_batched(
        lambda im, mm: _bp_symmetry_single(im, mm, shape, use_subline=True),
        img_t, mat, shape, 1)
