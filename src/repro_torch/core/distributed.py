"""Multi-device back-projection: the mesh and the reconstruction fleet.

Mesh-sharded back-projection (:func:`make_distributed_bp`,
:func:`distributed_backproject`; iFDK-style scale-out):

  * the volume is sharded over the mesh: x -> "data", y -> "model" (each
    entry owns an (nx/nd, ny/nm, nz) voxel slab);
  * a projection batch of nb images is replicated within a pod and
    sharded over the "pod" axis (each pod back-projects a disjoint,
    contiguous block of views), and the pods' partial slabs are summed
    in pod order;
  * each entry back-projects its slab with *translated* projection
    matrices (``core.tiling.translate_matrices``), so the single-device
    plain ladder runs unchanged on every slab.

The JAX package runs this as one ``shard_map`` over a
``jax.sharding.Mesh``. The port's mesh (``launch.mesh.Mesh``) is a
tuple of torch devices in one process, an entry may repeat, and one
thread drives every entry: launches are asynchronous, so the loop over
mesh coordinates overlaps distinct cards. Each batch's rows are copied
once to each distinct device, and every slab once to the mesh's first
entry, where the volume is assembled.

:func:`make_fleet_bp` builds the program each worker of the fleet
(``runtime.executor.PlanExecutor.execute_fleet``) runs for one step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .backproject import bp_subline_symmetry_batch, bp_subline_symmetry_scan
from .tiling import pad_projection_batch, plan_proj_chunks, \
    translate_matrices

_MESH_AXES = ("pod", "data", "model")


def make_fleet_bp(variant: str, call_shape: Tuple[int, int, int], *,
                  nb: int, n_chunks: int, chunk_size: int,
                  options=(), interpret: bool = True,
                  rb: Optional[int] = None):
    """Per-device step program for the reconstruction fleet.

    ``prog(img_s, mat_s, origin) -> vol_t(call_shape)`` where ``img_s`` /
    ``mat_s`` are the stacked chunk grids ``(n_chunks, chunk_size, ...)``
    on the worker's device and ``origin`` is the step's sub-box origin
    ``(i0, j0, k_off)``. ``rb`` adds a leading request axis: ``prog(img_b,
    mat_s, origin) -> vol_b((rb,) + call_shape)`` over ``img_b`` of shape
    ``(rb, n_chunks, chunk_size, ...)``, one lane launch a chunk, each
    lane bit-identical to the ``rb=None`` program on that request.

    The body is the single-device step-major program
    (``ProgramCache.scan_program``, or its lane form); the origin folds
    into the matrices' constant column at call time, on the worker's
    device, through the fold the single-device walk makes
    (``runtime.executor.fold_origin``). So ONE program per (variant,
    call_shape, chunk grid) serves every same-shape step on any device,
    a stolen or failed-over step builds nothing, and a fleet step equals
    the same step of the single-device walk bit for bit. ``chunk_size``
    is part of the program's identity only (the grid carries it).
    The fleet runs float32 programs only.
    """
    from repro_torch.runtime.executor import _step_program, fold_origin

    scan = _step_program(variant, call_shape, nb, "float32", interpret,
                         tuple(options), n_chunks, rb=rb)

    def prog(img_s, mat_s, origin):
        return scan(img_s, fold_origin(mat_s, origin))
    return prog


def _pad_up(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def _mesh_input(x, device: torch.device) -> torch.Tensor:
    """A float32 tensor: numpy arrays go to ``device`` (the mesh's first
    entry), tensors stay where they are until each batch is copied to
    the mesh's devices."""
    if isinstance(x, np.ndarray):
        from repro_torch.convert import tensor_from_numpy
        return tensor_from_numpy(x, device)
    return x.to(torch.float32)


def make_distributed_bp(geom, mesh, *, nb: int = 32, variant: str = "scan",
                        inner_nb: int = 8, vol_shape_xyz=None):
    """Build ``(fn, (img_spec, mat_spec, origin_spec, out_spec))`` for one
    projection batch on ``mesh`` (a ``launch.mesh.Mesh`` over any of the
    axes "pod", "data" and "model").

    ``fn(img_t_batch (nb, nw, nh), mat_batch (nb, 3, 4), origin (2,))``
    returns the partial volume ``(nx_pad, ny_pad, nz)`` on the mesh's
    first entry; call it over batches and accumulate (the caller owns
    the sum and the final unpad). Pod ``p`` takes the contiguous rows
    ``[p*nb/npod, (p+1)*nb/npod)``; ``ValueError`` where npod does not
    divide the batch.

    ``vol_shape_xyz`` reconstructs a sub-box of the volume; ``origin`` is
    its origin in global voxel indices, given at CALL time, so one
    program serves every tile of one shape. Entry ``(di, dj)`` takes the
    slab origin ``origin + (di*bi, dj*bj)`` in float32, as the
    reference's traced adds do, and runs the plain ladder on ``(bi, bj,
    nz)``: ``variant="scan"`` the per-view
    :func:`~repro_torch.core.backproject.bp_subline_symmetry_scan`,
    ``"batch"`` :func:`~repro_torch.core.backproject
    .bp_subline_symmetry_batch` with ``min(inner_nb, local batch)``.
    The specs are the reference's partition specs as plain tuples.
    """
    if variant not in ("scan", "batch"):
        raise ValueError(f"variant must be 'scan' or 'batch', got "
                         f"{variant!r}")
    unknown = set(mesh.axis_names) - set(_MESH_AXES)
    if unknown:
        raise ValueError(f"mesh axes must be among {_MESH_AXES}, got "
                         f"{mesh.axis_names}")
    nd = mesh.axis_size("data")
    nm = mesh.axis_size("model")
    npod = mesh.axis_size("pod")
    has_pod = "pod" in mesh.axis_names
    if nb % npod:
        raise ValueError(f"nb={nb} does not divide over pod={npod}")
    ni, nj, nz = (geom.nx, geom.ny, geom.nz) if vol_shape_xyz is None \
        else tuple(int(v) for v in vol_shape_xyz)
    nx_pad = _pad_up(ni, nd)
    ny_pad = _pad_up(nj, nm)
    bi, bj = nx_pad // nd, ny_pad // nm
    slab = (bi, bj, nz)
    home = mesh.devices[0]

    in_spec = ("pod" if has_pod else None, None, None)
    specs = (in_spec, in_spec, (None,), ("data", "model", None))

    def ladder(img, mat):
        if variant == "scan":
            return bp_subline_symmetry_scan(img, mat, slab)
        return bp_subline_symmetry_batch(img, mat, slab,
                                         nb=min(inner_nb, img.shape[0]))

    def fn(img_t, mats, origin):
        n = int(img_t.shape[0])
        if n % npod:
            raise ValueError(f"a batch of {n} views does not divide over "
                             f"pod={npod}")
        per = n // npod
        o = np.asarray([float(v) for v in origin], np.float32)
        vol = torch.empty((nx_pad, ny_pad, nz), dtype=torch.float32,
                          device=home)
        for p in range(npod):
            rows = slice(p * per, (p + 1) * per)
            local = {}       # this pod's rows, once per distinct device
            for di in range(nd):
                i0 = float(o[0] + np.float32(di * bi))
                for dj in range(nm):
                    j0 = float(o[1] + np.float32(dj * bj))
                    dev = mesh.device_at(pod=p, data=di, model=dj)
                    if dev not in local:
                        local[dev] = (img_t[rows].to(dev),
                                      mats[rows].to(dev))
                    img_l, mat_l = local[dev]
                    part = ladder(img_l, translate_matrices(mat_l, i0, j0))
                    box = vol[di * bi:(di + 1) * bi, dj * bj:(dj + 1) * bj]
                    if p == 0:
                        box.copy_(part)
                    else:
                        box += part.to(home)
        return vol

    return fn, specs


def distributed_backproject(projections_t, mats, geom, mesh, *,
                            nb: int = 32, variant: str = "scan"):
    """Full distributed reconstruction loop over projection batches.

    projections_t: (np, nw, nh) transposed filtered projections (a tensor
    or numpy). Returns the volume (nx, ny, nz), unpadded, on the mesh's
    first entry. ``n_proj`` need not divide ``nb``: the tail batch is
    padded with zero images and repeated matrices, which add nothing.

    The batches are the planner's exactly-nb chunks
    (``tiling.plan_proj_chunks``) and the program is kept in the shared
    ``ProgramCache`` under ``("dist", variant, shape, nb, geom, mesh)``,
    so repeated calls on one geometry and mesh build it once.
    """
    from repro_torch.runtime.executor import default_program_cache

    home = mesh.devices[0]
    projections_t, mats = pad_projection_batch(
        _mesh_input(projections_t, home), _mesh_input(mats, home), nb)
    _, _, chunks = plan_proj_chunks(projections_t.shape[0], nb, nb)
    fn = default_program_cache().get_or_build(
        ("dist", variant, geom.volume_shape_xyz, nb, geom, mesh),
        lambda: make_distributed_bp(geom, mesh, nb=nb, variant=variant)[0])
    origin = (0.0, 0.0)
    vol = None
    for s0, s1 in chunks:
        part = fn(projections_t[s0:s1], mats[s0:s1], origin)
        vol = part if vol is None else vol + part
    return vol[:geom.nx, :geom.ny]
