"""Tiled streaming reconstruction: the plan/compile/execute façade.

Every entry point is a thin façade over the same three stages:

  1. **plan**: ``runtime.planner.plan_reconstruction`` builds a pure
     :class:`~repro_torch.runtime.planner.ReconPlan`: the (i, j)-tile x
     Z-slab schedule (mirror-paired for O3 symmetry variants,
     depth-bounded plain slabs otherwise), per-step variant resolution
     against the ``KernelSpec`` registry, matrix-translation offsets, the
     projection-chunk schedule and all option validation.
  2. **compile**: ``runtime.executor.ProgramCache`` maps ``(variant,
     call_shape, nb, dtype, interpret)`` keys to programs. Interior tiles
     share shapes, so a plan with many steps builds a handful of them.
  3. **execute**: ``runtime.executor.PlanExecutor`` walks the plan:
     projections stream through in chunks with FDK pre-weighting + ramp
     filtering fused into the chunk loop, and the host flush of one step
     can overlap the next step's kernels (``pipeline="async"``).

Why tiles: the paper's locality discipline (§3.1) applied at volume
granularity. (i, j)-tiles x Z-slabs with *translated* projection matrices
(``core.tiling``) give every registered variant an O(tile) working set,
and a host accumulator lets the volume exceed the card's memory. The O3
detector-row symmetry pairs voxel ``k`` with ``nz-1-k`` about the FULL
volume's Z midplane, so symmetry variants run on mirror-paired slab calls
of virtual depth ``2*tk`` (both slabs filled by one call) and fall back
to their ``KernelSpec.slab_safe_fallback`` on slabs that pair with none.

Usage::

    from repro_torch.runtime.engine import TiledReconstructor

    eng = TiledReconstructor(geom, variant="subline_pl",
                             tile_shape=(256, 256, 96), proj_batch=128)
    vol = eng.reconstruct(projections)   # filtered FDK, (nz, ny, nx)

    eng.recon_plan        # the ReconPlan (steps, chunks, program keys)
    eng.cache_stats()     # program cache hits/misses

    # or pick the tile shape from a byte budget:
    eng = TiledReconstructor(geom, memory_budget=16 << 30)
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from repro_torch.core.geometry import CTGeometry
from repro_torch.core.tiling import (TileSpec, make_tiles, plan_z_slabs,
                                     plan_z_units)
from repro_torch.core.variants import get_spec
from repro_torch.runtime.executor import PlanExecutor, ProgramCache
from repro_torch.runtime.planner import ReconPlan, plan_reconstruction


class TiledReconstructor:
    """Streaming tile/slab back-projection around any registered variant.

    A façade: the constructor builds a :class:`ReconPlan` (all validation
    happens there) and an executor over the shared program cache.

    Parameters
    ----------
    geom : CTGeometry
    variant : registry name (``core.variants.REGISTRY``).
    tile_shape : (ti, tj, tk) maximum tile size in voxels; ``None`` picks
        it from ``memory_budget`` (or uses the full volume if neither is
        given, which degenerates to the untiled call).
    memory_budget : byte budget for one tile's working set (see
        ``core.tiling.tile_working_set_bytes``).
    nb : in-batch projection count handed to the variant (paper O5).
    proj_batch : how many projections stream through per variant call
        (rounded up to a multiple of ``nb``); ``None`` = all at once.
    out : "host" (numpy accumulator, the card holds one tile's output at
        a time) | "device".
    interpret : carried for option parity; selects nothing.
    schedule : "step" | "chunk" | None (the planner resolves it: "chunk"
        when a ``memory_budget`` bounds device bytes, "step" otherwise).
    pipeline : "sync" | "async" (host flushes on a side stream and a
        flusher thread; bit-identical output).
    cache : optional private ProgramCache (default: process-shared).
    device : the torch device (``None`` -> the CUDA card).
    """

    def __init__(self, geom: CTGeometry, variant: str = "algorithm1_mp", *,
                 tile_shape: Optional[Sequence[int]] = None,
                 memory_budget: Optional[int] = None,
                 nb: int = 8, proj_batch: Optional[int] = None,
                 out: str = "host", interpret: bool = True,
                 schedule: Optional[str] = None,
                 pipeline: str = "sync",
                 cache: Optional[ProgramCache] = None,
                 device=None,
                 **kernel_options):
        self.geom = geom
        self.recon_plan: ReconPlan = plan_reconstruction(
            geom, variant, tile_shape=tile_shape,
            memory_budget=memory_budget, nb=nb, proj_batch=proj_batch,
            out=out, interpret=interpret, schedule=schedule, device=device,
            **kernel_options)
        # variant="auto" resolves through the tuning cache of this
        # device's fingerprint in the planner; record the resolved name
        self.variant = self.recon_plan.variant
        self._executor = PlanExecutor(geom, self.recon_plan, cache=cache,
                                      pipeline=pipeline, device=device)

    # ---- introspection ---------------------------------------------------

    @property
    def tile_shape(self) -> Tuple[int, int, int]:
        return self.recon_plan.tile_shape

    @property
    def nb(self) -> int:
        return self.recon_plan.nb

    @property
    def working_set_bytes(self) -> int:
        """Peak modeled working set over planned calls (the O(tile) bound;
        mirror-paired slabs are billed at their virtual 2*bk depth)."""
        return self.recon_plan.working_set_bytes

    def cache_stats(self) -> dict:
        """Program cache hits/misses/live programs."""
        return self._executor.cache.stats()

    def plan(self):
        """The raw decomposition: ((i0, j0, ni, nj) list, ZUnit list).

        The authoritative schedule is ``recon_plan.steps``, which also
        carries per-step variant resolution.
        """
        ti, tj, tk = self.recon_plan.tile_shape
        nx, ny, nz = self.geom.volume_shape_xyz
        ij = [(t.i0, t.j0, t.ni, t.nj)
              for t in make_tiles((nx, ny, 1), (ti, tj, 1))]
        z = (plan_z_units(nz, tk) if get_spec(self.variant).uses_symmetry
             else plan_z_slabs(nz, tk))
        return ij, z

    # ---- execution (delegates to the PlanExecutor) -----------------------

    def backproject(self, img_t, mats):
        """Full tiled back-projection of pre-filtered projections.

        img_t: (np, nw, nh) transposed projections; mats: (np, 3, 4).
        Returns vol_t (nx, ny, nz), numpy when ``out == "host"``.
        """
        return self._executor.backproject(img_t, mats)

    def backproject_tile(self, img_t, mats, tile: TileSpec):
        """Back-project one arbitrary sub-box; exact for every variant
        (non-centered boxes run the KernelSpec slab-safe fallback)."""
        return self._executor.backproject_tile(img_t, mats, tile)

    def reconstruct(self, projections):
        """Filtered FDK through the plan: (np, nh, nw) -> (nz, ny, nx),
        numpy when ``out == "host"``, else a tensor on the device."""
        return self._executor.reconstruct(projections)

    # ---- cluster composition (iFDK scale-out x tiles) --------------------

    def backproject_distributed(self, img_t, mats, mesh, *,
                                nb: Optional[int] = None,
                                dist_variant: str = "scan",
                                pipeline: Optional[str] = None):
        """Compose tiles with the pod/data/model mesh of
        ``core.distributed`` (a ``launch.mesh.Mesh``).

        Each (i, j)-tile (full Z: the mesh shards i and j, slabs stay
        whole) runs the mesh program with the tile origin as a call-time
        argument: ONE cached program per distinct tile shape. The walk is
        re-planned with ``nb = proj_batch = nb`` (the program's exactly-nb
        batches; tail padded) and a host volume. ``pipeline`` ("sync" |
        "async"; default: this engine's own) streams the tile flushes
        through the async flusher. Returns vol_t (nx, ny, nz) on the host.
        """
        nb = self.recon_plan.nb if nb is None else int(nb)
        plan = plan_reconstruction(
            self.geom, self.variant, tile_shape=self.recon_plan.tile_shape,
            nb=nb, proj_batch=nb, out="host",
            interpret=self.recon_plan.interpret, device=mesh.devices[0])
        ex = PlanExecutor(
            self.geom, plan, cache=self._executor.cache,
            pipeline=self._executor.pipeline if pipeline is None
            else pipeline,
            pipeline_depth=self._executor.pipeline_depth,
            device=mesh.devices[0])
        return ex.execute_distributed(img_t, mats, mesh,
                                      dist_variant=dist_variant)
