"""Volume tiling / slab decomposition shared by the engine and the mesh.

The paper's locality story (§3.1) is about bounding the *working set*:
transposed layouts make a voxel line's detector footprint contiguous,
sub-line buffers shrink the per-line image traffic, and nb-batching cuts
volume write traffic. This module supplies the geometric substrate that
lets any back-projection variant run on a *sub-box* of the volume with
unchanged kernels, which is what makes O(tile) working sets (and
larger-than-memory volumes) possible:

  * ``translate_matrices`` — shifting the voxel-index origin by
    ``(i0, j0, k0)`` folds into the constant column of the 3x4 projection
    matrix, so a kernel handed the translated matrix reconstructs the
    sub-box exactly (the iFDK slab trick, arXiv:1909.02724, extended to
    all three axes);
  * ``make_tiles`` / ``plan_z_units`` — remainder-aware decompositions of
    the volume into (i, j)-tiles x Z-slabs. Z-slabs are planned in
    *mirror pairs* about the volume center so the detector-row symmetry
    (paper O3: ``y' = (nh-1) - y`` pairs voxel ``k`` with ``nz-1-k``)
    stays exact for symmetry-carrying variants;
  * ``pick_tile_shape`` — a tile-size auto-picker from a byte budget,
    modeling the batched temporaries of the reference's plain ladder;
  * ``pad_projection_batch`` — tail-batch padding (zero images + repeated
    matrices) so nb-batched variants accept any projection count.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch


def translate_matrices(mat: torch.Tensor, i0, j0, k0=0.0) -> torch.Tensor:
    """Shift voxel-index origin by (i0, j0, k0): fold into the const col.

    mat: (..., 3, 4). Projection of (i+i0, j+j0, k+k0, 1) under M equals
    projection of (i, j, k, 1) under M' where
    M'[:, 3] += i0*M[:, 0] + j0*M[:, 1] + k0*M[:, 2].

    The structural facts the optimizations rely on (M[0][2] == M[2][2]
    == 0) are preserved — only the constant column changes — so hoisting
    (O2) stays exact on any translated sub-box. Detector-row symmetry
    (O3) is a property of the *full* volume center: see ``plan_z_units``.
    """
    const = (mat[..., 3] + i0 * mat[..., 0] + j0 * mat[..., 1]
             + k0 * mat[..., 2])
    return torch.cat([mat[..., :3], const[..., None]], dim=-1)


@dataclasses.dataclass(frozen=True)
class TileSpec:
    """One sub-box of the volume: origin (i0, j0, k0), size (ni, nj, nk)."""

    i0: int
    j0: int
    k0: int
    ni: int
    nj: int
    nk: int

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.ni, self.nj, self.nk)

    @property
    def slices(self) -> Tuple[slice, slice, slice]:
        return (slice(self.i0, self.i0 + self.ni),
                slice(self.j0, self.j0 + self.nj),
                slice(self.k0, self.k0 + self.nk))


@dataclasses.dataclass(frozen=True)
class ZUnit:
    """One Z-scheduling unit: a slab [k0, k0+nk), optionally *paired*.

    A paired unit covers BOTH [k0, k0+nk) and its mirror slab
    [nz-k0-nk, nz-k0): a symmetry-carrying variant called with virtual
    shape (ni, nj, 2*nk) and k-translation k0 computes the direct half
    into local k in [0, nk) and the O3-mirrored half into [nk, 2*nk),
    which after the variant's own flip corresponds exactly to the mirror
    slab (the pairing k <-> nz-1-k is the global one by construction).
    """

    k0: int
    nk: int
    paired: bool
    nz: int

    @property
    def mirror_k0(self) -> int:
        return self.nz - self.k0 - self.nk

    @property
    def centered(self) -> bool:
        """A non-paired unit symmetric about the volume Z-center."""
        return (not self.paired) and (2 * self.k0 + self.nk == self.nz)


def _axis_splits(n: int, t: int) -> List[Tuple[int, int]]:
    """[(origin, size), ...] covering [0, n) in steps of t (tail smaller)."""
    t = max(1, min(int(t), n))
    return [(o, min(t, n - o)) for o in range(0, n, t)]


def make_tiles(vol_shape_xyz: Sequence[int],
               tile_shape_xyz: Sequence[int]) -> List[TileSpec]:
    """Decompose the volume into sub-boxes of (at most) ``tile_shape_xyz``.

    Remainder-aware: tile shapes need not divide the volume; edge tiles
    shrink. The result is a disjoint exact cover of the volume.
    """
    nx, ny, nz = (int(v) for v in vol_shape_xyz)
    ti, tj, tk = (int(v) for v in tile_shape_xyz)
    return [TileSpec(i0, j0, k0, ni, nj, nk)
            for (i0, ni) in _axis_splits(nx, ti)
            for (j0, nj) in _axis_splits(ny, tj)
            for (k0, nk) in _axis_splits(nz, tk)]


def plan_z_units(nz: int, tk: int) -> List[ZUnit]:
    """Mirror-paired Z-slab plan: pairs of width ``tk`` taken from both
    ends inward, plus one centered middle slab for the remainder.

    Every unit is either *paired* (exact for symmetry variants via the
    virtual-2*nk trick, see ZUnit) or *centered* (exact directly, odd
    width allowed). The union covers [0, nz) disjointly.
    """
    nz, tk = int(nz), max(1, int(tk))
    units: List[ZUnit] = []
    lo = 0
    while nz - 2 * lo >= 2 * tk:
        units.append(ZUnit(lo, tk, True, nz))
        lo += tk
    if nz - 2 * lo > 0:
        units.append(ZUnit(lo, nz - 2 * lo, False, nz))
    return units


def plan_z_slabs(nz: int, tk: int) -> List[ZUnit]:
    """Plain (unpaired) Z-slab plan: disjoint cover with depth <= tk.

    The schedule for symmetry-FREE variants: no mirror pairing is
    needed for exactness, and unlike ``plan_z_units`` (whose centered
    middle slab may be up to ``2*tk - 1`` deep) every call is bounded
    by the requested tile depth.
    """
    nz = int(nz)
    return [ZUnit(o, s, False, nz) for o, s in _axis_splits(nz, tk)]


def tile_working_set_bytes(tile_shape_xyz: Sequence[int],
                           det_shape_wh: Sequence[int],
                           nb: int = 8, dtype_bytes: int = 4) -> int:
    """Estimated peak working set of one nb-batched variant call on a tile.

    Model (the JAX package's plain Algorithm 1, the worst case of its
    ladder): the in-batch vmap materializes nb copies of the (ni, nj, nh)
    sub-line buffer and the (ni, nj, nk) per-projection contribution,
    plus the tile accumulator and the resident projection batch. Kept
    as is so that plans equal the JAX package's.
    """
    ni, nj, nk = (int(v) for v in tile_shape_xyz)
    nw, nh = (int(v) for v in det_shape_wh)
    acc = ni * nj * nk
    temps = nb * ni * nj * (nk + nh)
    batch = nb * nw * nh
    return dtype_bytes * (acc + temps + batch)


def pick_tile_shape(vol_shape_xyz: Sequence[int],
                    det_shape_wh: Sequence[int],
                    budget_bytes: int, *, nb: int = 8,
                    pair_z: bool = False) -> Tuple[int, int, int]:
    """Choose the largest tile shape whose working set fits the budget.

    Strategy (paper §3.1 priorities): keep the full Z extent as long as
    possible (full-Z tiles keep the O3 symmetry free and the voxel-line
    streaming contiguous), halving the larger of (ti, tj) first; only
    when the (i, j) footprint is exhausted start halving the Z slab.

    ``pair_z``: model the mirror-paired slab schedule of symmetry
    variants — a Z-slab of tk < nz is executed as ONE variant call of
    virtual depth 2*tk, so that is the depth the
    budget must fit.
    """
    ni, nj, nk = (int(v) for v in vol_shape_xyz)
    ti, tj, tk = ni, nj, nk

    def cost(ti_, tj_, tk_):
        eff = min(2 * tk_, nk) if (pair_z and tk_ < nk) else tk_
        return tile_working_set_bytes((ti_, tj_, eff), det_shape_wh,
                                      nb=nb)

    while cost(ti, tj, tk) > budget_bytes:
        if ti == tj == tk == 1:
            break  # budget below the floor: return the minimal tile
        if max(ti, tj) > 1:
            if ti >= tj:
                ti = max(1, ti // 2)
            else:
                tj = max(1, tj // 2)
        else:
            tk = max(1, tk // 2)
    return (ti, tj, tk)


def plan_proj_chunks(n_proj: int, nb: int,
                     proj_batch: int | None = None
                     ) -> Tuple[int, int, List[Tuple[int, int]]]:
    """Projection-chunk schedule: (n_padded, chunk_size, [(s0, s1), ...]).

    The projection axis is padded up to a multiple of ``nb`` (see
    ``pad_projection_batch`` for the zero-image/repeated-matrix padding
    that makes this exact) and covered by disjoint chunks of
    ``proj_batch`` rounded UP to an nb multiple (``None`` = one chunk).
    Every chunk size is an nb multiple, so nb-batched variants accept
    any chunk without re-padding — the pad happens once, globally.
    """
    n_proj, nb = int(n_proj), max(1, int(nb))
    n_pad = -(-n_proj // nb) * nb
    if proj_batch is None:
        chunk = n_pad
    else:
        proj_batch = int(proj_batch)
        if proj_batch < 1:
            raise ValueError(f"proj_batch must be >= 1, got {proj_batch}")
        chunk = min(n_pad, -(-proj_batch // nb) * nb)
    return n_pad, chunk, [(s0, min(s0 + chunk, n_pad))
                          for s0 in range(0, n_pad, chunk)]


def pad_projection_batch(img_t: torch.Tensor, mat: torch.Tensor,
                         multiple: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad (np, nw, nh) projections + (np, 3, 4) matrices to a multiple.

    Padding images are ZERO (back-projection is linear, so they add
    nothing); padding matrices REPEAT the last real matrix (a valid
    geometry, so no 1/z poles or NaN x 0 can leak into the volume).
    """
    n_proj = img_t.shape[0]
    multiple = max(1, int(multiple))
    rem = n_proj % multiple
    if rem == 0:
        return img_t, mat
    pad = multiple - rem
    img_pad = torch.cat(
        [img_t, img_t.new_zeros((pad,) + tuple(img_t.shape[1:]))], dim=0)
    mat_pad = torch.cat([mat, mat[-1:].expand(pad, 3, 4)], dim=0)
    return img_pad, mat_pad
