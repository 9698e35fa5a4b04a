"""Banded, geometry-scheduled sub-line back-projection for Hopper.

Replaces the two Pallas kernels of the JAX package's
``kernels/backproject_banded.py``: ``_banded_call`` (l.148, K5) and
``_banded_call_fused`` (l.186, K6), with their driver
``backproject_banded`` (l.216) and host helpers ``band_layout`` (l.40)
and ``tile_bands`` (l.51).

A (BI, BJ) voxel tile touches only a narrow band of detector columns per
projection: x(i, j) is a ratio of linear functions, so its extrema over
the tile sit at the tile's corners. :func:`tile_bands` finds each
(projection group, tile)'s band from the corners, :func:`band_layout`
lays the projections out once as 2x-overlapping bands of ``2*bw``
columns, and the kernel reads each line's two columns from its tile's
band. Both helpers run on the tensors' own device; the band schedule is
float64 there, in the reference's order of operations, and gives the
reference's band array bit for bit.

The kernel is ``tile_kernel`` of ``csrc/backproject_subline.cu`` in K1's
linear form, with the band layout as its column source: under K1's
launch plan (``backproject_subline.launch_plan``), a line of band tile
(i/BI, j/BJ) reads band ``b = band[s // group, i // BI, j // BJ]`` and is
dropped for view ``s`` where ``rel = floor(x) - b*bw`` misses
``[0, 2*bw-2]``; the tile's detector window is copied from the bands
(column c from band c // bw), so one 8 x 8 kernel tile may span several
band tiles. K6 is the same launch with one band per group of nb
projections (``group = nb``): the kernel walks every view itself, one
window ahead, whatever nb is. Where no line is dropped, which the band
search guarantees, K5 and K6 give K1's volume bit for bit, at any nz.
What bounds it on an H100 is K1's bound, the same function's 8 FLOP per
voxel-view update (operations, 8.2 ms at P5); the band layout adds 2x
the projections' bytes of device traffic per call. On the TPU the band
cut the projection stream through VMEM; here each tile's window is in
shared memory already, so the band decides which lines count and adds
one band load per line and view.

The lane driver :func:`backproject_banded_lanes` back-projects rb stacked
inputs ``img_b (rb, np, nw, nh)`` against one ``mat``: the band search
reads only the matrices, so it runs once for all lanes
(:func:`band_search`), each lane is laid out in bands, and one launch
covers every lane (the grid's z is the lane), each equal bit for bit to
the solo launch on it.

On a CPU tensor the kernel wrappers run :func:`backproject_banded_plain`
(the lane wrappers once per lane); on a CUDA tensor they launch the
kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from . import backproject_subline as ks

#: Launches of each kernel wrapper in this process (one per launch, counted
#: only where the wrapper launches the CUDA kernel).
LAUNCHES: Dict[str, int] = {"backproject_banded_kernel": 0,
                            "backproject_banded_fused": 0,
                            "backproject_banded_kernel_lanes": 0,
                            "backproject_banded_fused_lanes": 0}


_LIB = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib():
    global _LIB
    if _LIB is None:
        lib = ks._lib()    # the same library: backproject_subline.cu
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bp_tile_launch_banded_lanes.argtypes = ([vp] * 4 + [ci, cl, cl]
                                                    + [ci] * 13 + [vp])
        lib.bp_tile_launch_banded_lanes.restype = ci
        _LIB = lib
    return _LIB


def band_layout(img_t: torch.Tensor, bw: int):
    """(np, nw, nh) -> overlapping bands (np, n_bands, 2*bw, nh), on the
    input's device: band b holds detector columns [b*bw, b*bw + 2*bw),
    zero past nw."""
    n_proj, nw, nh = img_t.shape
    n_bands = max(1, -(-nw // bw))
    pad = n_bands * bw + bw - nw
    img_p = torch.nn.functional.pad(img_t, (0, 0, 0, pad))
    # unfold: (np, n_bands, nh, 2*bw) windows of stride bw over the columns
    return img_p.unfold(1, 2 * bw, bw).transpose(2, 3).contiguous(), n_bands


def tile_bands(mat: torch.Tensor, ni: int, nj: int, BI: int, BJ: int,
               bw: int, n_bands: int, nw: int, group: int = 1):
    """band[g, ti, tj] (int32, on ``mat``'s device) and the largest tile
    x-span + 2, for the ``span <= bw`` check.

    Evaluated in float64 at the four corners of every tile (exact for
    z > 0: a linear-fractional x takes its extrema at corners). With
    ``group > 1`` the range is the union over each group of that many
    consecutive projections, and the array has one row per group.
    The span is read back with one ``.item()``.
    """
    mat = mat.to(torch.float64)
    dev = mat.device
    ti = torch.arange(ni // BI, device=dev)
    tj = torch.arange(nj // BJ, device=dev)
    m = mat[None, None]                                  # (1, 1, ns, 3, 4)
    xs = []
    for ic in (ti * BI, ti * BI + (BI - 1)):
        for jc in (tj * BJ, tj * BJ + (BJ - 1)):
            i = ic[:, None, None]                        # (Ti, 1, 1)
            j = jc[None, :, None]                        # (1, Tj, 1)
            z = m[..., 2, 0] * i + m[..., 2, 1] * j + m[..., 2, 3]
            x = ((m[..., 0, 0] * i + m[..., 0, 1] * j + m[..., 0, 3])
                 / torch.clamp(z, min=1e-6))
            xs.append(x)                                 # (Ti, Tj, ns)
    xs = torch.stack(xs)                                 # (4, Ti, Tj, ns)
    xmin = torch.clamp(xs.amin(0), 0, nw - 1)
    xmax = torch.clamp(xs.amax(0), 0, nw - 1)
    if group > 1:
        t_i, t_j, ns = xmin.shape
        if ns % group:
            raise ValueError(f"group={group} does not divide {ns} "
                             f"projections")
        xmin = xmin.reshape(t_i, t_j, ns // group, group).amin(-1)
        xmax = xmax.reshape(t_i, t_j, ns // group, group).amax(-1)
    span = float((xmax - xmin).max().item()) + 2.0
    band = torch.clamp(torch.div(xmin, bw, rounding_mode="floor")
                       .to(torch.int32), 0, n_bands - 1)
    return band.permute(2, 0, 1).contiguous(), span


def backproject_banded_plain(img_b: torch.Tensor, mat: torch.Tensor,
                             band: torch.Tensor, vol_shape_xyz: Sequence[int],
                             *, block, bw: int, nw: int,
                             group: int = 1) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the sub-line plain version
    with stage 1 reading each line's columns from band
    ``band[s // group, i // BI, j // BJ]`` of ``img_b`` (np, n_bands,
    2*bw, nh), at ``rel = ixc - band*bw``. A line whose ``rel`` misses
    ``[0, 2*bw-2]`` adds nothing for that projection; validity is decided
    against the true width ``nw``."""
    ni, nj, nz = (int(v) for v in vol_shape_xyz)
    BI, BJ = (int(v) for v in block)
    dev = img_b.device
    i, j = ks._line_grid(ni, nj, dev)
    ti = (i.long() // BI)
    tj = (j.long() // BJ)
    vol = torch.zeros((ni * nj, nz), dtype=torch.float32, device=dev)
    for s in range(img_b.shape[0]):
        m = mat[s]
        ok, f, ixc, dx = ks._line_scalars(m, i, j, nw)
        b = band[s // group][ti, tj].long()
        rel = ixc - b * bw
        ok = ok & (rel >= 0) & (rel <= 2 * bw - 2)
        rel = torch.where(ok, rel, 0)
        dx = torch.where(ok, dx, 0.0)
        cols = img_b[s][b, rel]                            # stage 1
        sm = (cols * (1.0 - dx)[:, None]
              + img_b[s][b, rel + 1] * dx[:, None])
        ks._accumulate(vol, sm, m, i, j, f, torch.where(ok, f * f, 0.0))
    return vol.reshape(ni, nj, nz)


def _check_banded(img_b, mat, band, vol_shape_xyz, block, bw, nw, group):
    """Validate a banded call; return the volume shape as three ints."""
    if not isinstance(band, torch.Tensor) or band.dtype != torch.int32:
        raise TypeError("band must be an int32 tensor")
    if img_b.dim() != 4 or not img_b.is_contiguous():
        raise ValueError(f"img_b must be a contiguous (np, n_bands, 2*bw, "
                         f"nh) tensor, got {tuple(img_b.shape)}")
    n_proj, n_bands, two_bw, nh = img_b.shape
    shape = ks._check(img_b.reshape(n_proj, n_bands * two_bw, nh), mat,
                      vol_shape_xyz, block)
    ni, nj, _ = shape
    BI, BJ = (int(v) for v in block)
    if two_bw != 2 * bw or nw < 2 or n_bands != max(1, -(-nw // bw)):
        raise ValueError(f"img_b {tuple(img_b.shape)} is not a band layout "
                         f"of width bw={bw} for nw={nw}")
    if ni % BI or nj % BJ:
        raise ValueError(f"volume {shape} is not a whole number of "
                         f"{block} tiles")
    if group < 1 or n_proj % group:
        raise ValueError(f"the fused kernel needs nb >= 1 dividing "
                         f"n_proj={n_proj}, got nb={group}")
    want = (n_proj // group, ni // BI, nj // BJ)
    if tuple(band.shape) != want or band.device != img_b.device \
            or not band.is_contiguous():
        raise ValueError(f"band must be a contiguous {want} tensor on "
                         f"{img_b.device}, got {tuple(band.shape)} on "
                         f"{band.device}")
    return shape


def _check_banded_lanes(img_bb, mat, band, vol_shape_xyz, block, bw, nw,
                        group):
    """Validate an rb-lane banded call (``img_bb`` (rb, np, n_bands, 2*bw,
    nh), each lane contiguous); return the volume shape."""
    if not isinstance(img_bb, torch.Tensor) or img_bb.dim() != 5 \
            or not 1 <= img_bb.shape[0] <= 65535:
        raise ValueError(f"img_b must be an (rb, np, n_bands, 2*bw, nh) "
                         f"tensor with 1 <= rb <= 65535, got "
                         f"{getattr(img_bb, 'shape', type(img_bb))}")
    return _check_banded(img_bb[0], mat, band, vol_shape_xyz, block, bw, nw,
                         group)


def _launch_lanes(img_bb, mat, band, shape, block, bw, nw, group):
    """One launch of the tiled kernel's banded instance over the rb lanes
    of ``img_bb`` under K1's launch plan; returns (rb,) + shape and raises
    if the launch fails."""
    lib = _lib()
    ni, nj, nz = shape
    rb, n_proj, n_bands, _, nh = img_bb.shape
    plan = ks.launch_plan(shape, nh, ks.plane_rows(mat, shape))
    out = torch.empty((rb,) + tuple(shape), dtype=torch.float32,
                      device=img_bb.device)
    with torch.cuda.device(img_bb.device):
        stream = torch.cuda.current_stream(img_bb.device).cuda_stream
        err = lib.bp_tile_launch_banded_lanes(
            img_bb.data_ptr(), mat.data_ptr(), band.data_ptr(),
            out.data_ptr(), rb, ks.lane_stride(img_bb), ks.lane_stride(out),
            n_proj, nw, nh, ni, nj, nz, plan.kpt, plan.win_rows, bw,
            n_bands, int(block[0]), int(block[1]), group, stream)
    if err != 0:
        raise ks.launch_error("backproject_banded", lib, err)
    return out


def _launch(img_b, mat, band, shape, block, bw, nw, group):
    """One launch on one input (the one-lane :func:`_launch_lanes`)."""
    return _launch_lanes(img_b[None], mat, band, shape, block, bw, nw,
                         group)[0]


def backproject_banded_kernel(img_b: torch.Tensor, mat: torch.Tensor,
                              band: torch.Tensor, vol_shape_xyz, *,
                              block=(4, 8), bw: int, nw: int) -> torch.Tensor:
    """K5: one band per (projection, tile). ``img_b`` from
    :func:`band_layout`, ``band`` from :func:`tile_bands` with
    ``group=1``; ``nw`` is the true detector width. The volume must be
    whole (BI, BJ) tiles; any nz."""
    shape = _check_banded(img_b, mat, band, vol_shape_xyz, block, bw, nw, 1)
    if img_b.device.type == "cpu":
        return backproject_banded_plain(img_b, mat, band, shape, block=block,
                                        bw=bw, nw=nw)
    out = _launch(img_b, mat, band, shape, block, bw, nw, 1)
    LAUNCHES["backproject_banded_kernel"] += 1
    return out


def backproject_banded_fused(img_b: torch.Tensor, mat: torch.Tensor,
                             band: torch.Tensor, vol_shape_xyz, *,
                             block=(4, 8), bw: int, nw: int,
                             nb: int = 8) -> torch.Tensor:
    """K6: K5 with one band per group of ``nb`` projections (``band``
    from :func:`tile_bands` with ``group=nb``): the same launch, reading
    each view's band from its group. Requires ``n_proj % nb == 0``."""
    nb = int(nb)
    shape = _check_banded(img_b, mat, band, vol_shape_xyz, block, bw, nw, nb)
    if img_b.device.type == "cpu":
        return backproject_banded_plain(img_b, mat, band, shape, block=block,
                                        bw=bw, nw=nw, group=nb)
    out = _launch(img_b, mat, band, shape, block, bw, nw, nb)
    LAUNCHES["backproject_banded_fused"] += 1
    return out


def band_search(mat: torch.Tensor, nw: int, vol_shape_xyz, *, block,
                bw: int, group: int):
    """The reference driver's band search: double ``bw`` until every
    tile's x-span + 2 fits it (or bw >= nw). It reads the matrices only.
    Returns ``(band, bw)``."""
    ni, nj, _ = vol_shape_xyz
    BI, BJ = block
    while True:
        n_bands = max(1, -(-nw // bw))
        band, span = tile_bands(mat, ni, nj, BI, BJ, bw, n_bands, nw,
                                group=group)
        if span <= bw or bw >= nw:
            return band, bw
        bw *= 2


def band_schedule(img_t: torch.Tensor, mat: torch.Tensor, vol_shape_xyz, *,
                  block, bw: int, group: int):
    """:func:`band_search`, then the projections laid out in bands.
    Returns ``(img_b, band, bw)``."""
    band, bw = band_search(mat, img_t.shape[1], vol_shape_xyz, block=block,
                           bw=bw, group=group)
    img_b, _ = band_layout(img_t, bw)
    return img_b, band, bw


def band_layout_lanes(img_b: torch.Tensor, bw: int) -> torch.Tensor:
    """:func:`band_layout` of every lane of ``img_b`` (rb, np, nw, nh):
    (rb, np, n_bands, 2*bw, nh), each lane the layout of that lane."""
    rb, n_proj, nw, nh = img_b.shape
    lay, _ = band_layout(img_b.reshape(rb * n_proj, nw, nh), bw)
    return lay.reshape((rb, n_proj) + tuple(lay.shape[1:]))


def backproject_banded(img_t: torch.Tensor, mat: torch.Tensor,
                       vol_shape_xyz, *, block=(4, 8), bw: int = 32,
                       nb: int = 0, proj_loop: bool = False) -> torch.Tensor:
    """Banded back-projection. img_t (np, nw, nh); returns (ni, nj, nz),
    which must be whole (BI, BJ) tiles.

    Picks the band width as the reference does (doubling ``bw`` until
    the span check holds), then runs K5, or with ``proj_loop`` and an
    nb-divisible projection count K6, whose band covers each nb-group's
    x-range union (which may force a larger bw).
    """
    fused = ks.fused_batch_ok(img_t.shape[0], nb, proj_loop)
    shape = tuple(int(v) for v in vol_shape_xyz)
    img_b, band, bw = band_schedule(img_t, mat, shape, block=tuple(block),
                                    bw=int(bw), group=nb if fused else 1)
    nw = img_t.shape[1]
    if fused:
        return backproject_banded_fused(img_b, mat, band, shape, block=block,
                                        bw=bw, nw=nw, nb=nb)
    return backproject_banded_kernel(img_b, mat, band, shape, block=block,
                                     bw=bw, nw=nw)


def backproject_banded_lanes_plain(img_bb: torch.Tensor, mat: torch.Tensor,
                                   band: torch.Tensor, vol_shape_xyz, *,
                                   block, bw: int, nw: int,
                                   group: int = 1) -> torch.Tensor:
    """The lane wrappers' plain version: :func:`backproject_banded_plain`
    once per lane, stacked to (rb, ni, nj, nz)."""
    return torch.stack([backproject_banded_plain(
        img_bb[r], mat, band, vol_shape_xyz, block=block, bw=bw, nw=nw,
        group=group) for r in range(img_bb.shape[0])])


def backproject_banded_kernel_lanes(img_bb: torch.Tensor, mat: torch.Tensor,
                                    band: torch.Tensor, vol_shape_xyz, *,
                                    block=(4, 8), bw: int,
                                    nw: int) -> torch.Tensor:
    """K5 on rb lanes: ``img_bb`` (rb, np, n_bands, 2*bw, nh) from
    :func:`band_layout_lanes`, one ``band`` and ``mat`` -> (rb, ni, nj,
    nz), one launch; lane r equals :func:`backproject_banded_kernel` on
    ``img_bb[r]`` bit for bit."""
    shape = _check_banded_lanes(img_bb, mat, band, vol_shape_xyz, block, bw,
                                nw, 1)
    if img_bb.device.type == "cpu":
        return backproject_banded_lanes_plain(img_bb, mat, band, shape,
                                              block=block, bw=bw, nw=nw)
    out = _launch_lanes(img_bb, mat, band, shape, block, bw, nw, 1)
    LAUNCHES["backproject_banded_kernel_lanes"] += 1
    return out


def backproject_banded_fused_lanes(img_bb: torch.Tensor, mat: torch.Tensor,
                                   band: torch.Tensor, vol_shape_xyz, *,
                                   block=(4, 8), bw: int, nw: int,
                                   nb: int = 8) -> torch.Tensor:
    """K6 on rb lanes: K5's lane launch with one band per group of ``nb``
    projections. Requires ``n_proj % nb == 0``."""
    nb = int(nb)
    shape = _check_banded_lanes(img_bb, mat, band, vol_shape_xyz, block, bw,
                                nw, nb)
    if img_bb.device.type == "cpu":
        return backproject_banded_lanes_plain(img_bb, mat, band, shape,
                                              block=block, bw=bw, nw=nw,
                                              group=nb)
    out = _launch_lanes(img_bb, mat, band, shape, block, bw, nw, nb)
    LAUNCHES["backproject_banded_fused_lanes"] += 1
    return out


def backproject_banded_lanes(img_b: torch.Tensor, mat: torch.Tensor,
                             vol_shape_xyz, *, block=(4, 8), bw: int = 32,
                             nb: int = 0,
                             proj_loop: bool = False) -> torch.Tensor:
    """:func:`backproject_banded` on rb lanes: ``img_b`` (rb, np, nw, nh)
    against one ``mat`` -> (rb, ni, nj, nz). The band search runs once
    (it reads only the matrices), each lane is laid out in bands, and K5
    (or K6) runs once over all lanes."""
    if img_b.dim() != 4:
        raise ValueError(f"img_b must be (rb, np, nw, nh), got "
                         f"{tuple(img_b.shape)}")
    fused = ks.fused_batch_ok(img_b.shape[1], nb, proj_loop)
    shape = tuple(int(v) for v in vol_shape_xyz)
    nw = img_b.shape[2]
    band, bw = band_search(mat, nw, shape, block=tuple(block), bw=int(bw),
                           group=nb if fused else 1)
    img_bb = band_layout_lanes(img_b, bw)
    if fused:
        return backproject_banded_fused_lanes(img_bb, mat, band, shape,
                                              block=block, bw=bw, nw=nw,
                                              nb=nb)
    return backproject_banded_kernel_lanes(img_bb, mat, band, shape,
                                           block=block, bw=bw, nw=nw)
