"""Reconstruction planning: a pure, declarative schedule for any entry point.

Stage 1 of the plan/compile/execute architecture. A :class:`ReconPlan` is
built once from geometry + request parameters by
:func:`plan_reconstruction`, with **no** array data in the loop, and then
consumed by ``runtime.executor``:

    plan     runtime.planner.plan_reconstruction  (this module, pure)
    compile  runtime.executor.ProgramCache        (keyed kernel programs)
    execute  runtime.executor.PlanExecutor        (chunk loops)

The plan owns every scheduling decision the paper ties performance to:

  * the (i, j)-tile x Z-slab decomposition, with the O3 mirror-pair
    schedule for symmetry-carrying variants (``core.tiling.plan_z_units``)
    and depth-bounded plain slabs for symmetry-free ones;
  * per-step variant resolution: a Z-slab that is neither volume-centered
    nor mirror-paired runs the variant's declarative
    ``KernelSpec.slab_safe_fallback`` instead (``core.variants.REGISTRY``);
  * per-step matrix translation offsets (``core.tiling.translate_matrices``
    folds the sub-box origin into the constant column, so the kernels run
    unchanged);
  * the projection-chunk schedule: chunk bounds over the *padded*
    projection count (tail batches padded to a multiple of ``nb`` with
    zero images + repeated matrices: exactly zero contribution), which
    is what lets the executor stream pre-weighting + ramp filtering
    through the chunk loop instead of filtering the whole set up front;
  * the loop ORDER: ``schedule="step"`` (default) is step-major:
    :class:`StepMajorSchedule` gives every step the full chunk work
    list, and the executor carries each step's accumulator across all
    chunks on the device; ``schedule="chunk"`` is the chunk-major loop;
  * option validation, in ONE place, for every entry point.

The plans equal the JAX package's field by field; its streamed, batched
and fleet schedules are planned here too, and the executor of this
package runs the untiled and tiled single-device plans (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.geometry import CTGeometry
from repro_torch.core.tiling import (
    TileSpec, make_tiles, pick_tile_shape, plan_proj_chunks, plan_z_slabs,
    plan_z_units, tile_working_set_bytes,
)
from repro_torch.core.variants import KernelSpec, get_spec
from repro_torch.runtime import telemetry


@dataclasses.dataclass(frozen=True)
class TileWrite:
    """How one contiguous Z-range of a kernel call's output lands in the
    volume: ``out[..., lo:hi]`` is written at global Z origin ``k0``."""

    k0: int
    lo: int
    hi: int

    @property
    def nk(self) -> int:
        return self.hi - self.lo


@dataclasses.dataclass(frozen=True)
class PlanStep:
    """One kernel invocation: a sub-box call plus its volume writes.

    A mirror-paired step calls the (symmetry-carrying) kernel once with
    virtual depth ``2*nk`` and scatters the two halves to the slab and
    its O3 mirror — two :class:`TileWrite` entries. Plain steps have one.
    ``variant`` is already resolved (slab-safe fallback applied), so the
    executor never consults the registry for scheduling decisions.
    """

    i0: int
    j0: int
    ni: int
    nj: int
    k_off: int                      # Z translation folded into the matrices
    call_nk: int                    # Z extent of the kernel call
    variant: str                    # resolved kernel name
    writes: Tuple[TileWrite, ...]

    @property
    def call_shape(self) -> Tuple[int, int, int]:
        return (self.ni, self.nj, self.call_nk)

    @property
    def paired(self) -> bool:
        return len(self.writes) > 1


@dataclasses.dataclass(frozen=True)
class ChunkWork:
    """One projection chunk as seen by a step-major schedule: chunk
    number ``index`` covering padded projection rows ``[s0, s1)``. The
    tail chunk may be smaller than the uniform scan slot (``size <
    chunk_size``); the difference is zero-image scan padding."""

    index: int
    s0: int
    s1: int

    @property
    def size(self) -> int:
        return self.s1 - self.s0


@dataclasses.dataclass(frozen=True)
class StepWork:
    """One step-major unit of work: a kernel step plus the full chunk
    list its device-resident accumulator is scanned over."""

    step: PlanStep
    chunks: Tuple[ChunkWork, ...]


@dataclasses.dataclass(frozen=True)
class ChunkFold:
    """One online-arrival unit of work: a completed projection chunk
    plus every tile step it must be folded into. The executor runs the
    steps in schedule order, adding each kernel output into that step's
    device-resident accumulator — the arrival-ordered dual of
    :class:`StepWork`."""

    chunk: ChunkWork
    steps: Tuple[PlanStep, ...]


@dataclasses.dataclass(frozen=True)
class StreamSchedule:
    """Arrival-ordered (chunk-major) view of a plan for online ingest.

    ``folds[c]`` becomes runnable the moment every raw view of chunk
    ``c`` has arrived; folds MUST be consumed in index order (the
    chunk-index fold order is what makes the online reduction
    bit-identical to the offline chunk-major loop — see
    the JAX package's docs/ARCHITECTURE.md). ``n_views`` is the raw view count a
    stream must deliver before it can close; rows past it inside the
    tail chunk are the usual zero-image nb padding and are never
    pushed.
    """

    n_chunks: int
    chunk_size: int
    n_views: int
    folds: Tuple[ChunkFold, ...]


@dataclasses.dataclass(frozen=True)
class StepMajorSchedule:
    """Step-major view of a plan: per-step chunk work lists + the scan
    grid shape.

    The executor's scan megaprogram consumes a uniform
    ``(n_chunks, chunk_size, ...)`` chunk stack; ``n_scan = n_chunks *
    chunk_size`` is the stacked projection extent (rows past the padded
    projection count are zero images + repeated matrices — exactly zero
    contribution, same trick as the nb tail pad). Every step scans the
    SAME chunk list, which is what lets the filtered-chunk producer run
    once and feed all steps.
    """

    n_chunks: int
    chunk_size: int
    n_scan: int
    steps: Tuple[StepWork, ...]

    def fleet(self, n_shards: int) -> "FleetSchedule":
        """Partition this schedule's steps into ``n_shards`` balanced
        per-device work queues (see :func:`partition_steps`)."""
        return partition_steps(tuple(w.step for w in self.steps),
                               n_shards)


@dataclasses.dataclass(frozen=True)
class FleetSchedule:
    """Per-device work queues over a step schedule — the multi-device
    fleet's partition of a :class:`StepMajorSchedule`.

    ``queues[d]`` holds the step INDICES (into the partitioned step
    sequence, in schedule order) device ``d`` owns at launch; ``loads``
    is the modeled voxel-work per device the LPT packing balanced.
    Because every step writes a DISJOINT box of the volume and is
    re-entrant (pure function of the filtered chunk stack + its origin),
    ownership is only the STARTING assignment: work stealing may migrate
    a queued step to any idle device, and failover may re-run a failed
    device's steps elsewhere, without changing the result.
    """

    n_shards: int
    queues: Tuple[Tuple[int, ...], ...]
    loads: Tuple[int, ...]

    @property
    def n_steps(self) -> int:
        return sum(len(q) for q in self.queues)


def step_cost(step: PlanStep) -> int:
    """Modeled per-chunk work of one step: the kernel call's voxel
    count. All steps of one schedule scan the same chunk list, so the
    chunk factor is constant and drops out of the balance."""
    return step.ni * step.nj * step.call_nk


def partition_steps(steps: Sequence[PlanStep],
                    n_shards: int) -> FleetSchedule:
    """Partition a step list into ``n_shards`` balanced work queues.

    Greedy LPT (longest-processing-time first): steps are assigned in
    decreasing :func:`step_cost` order to the least-loaded shard —
    within 4/3 of the optimal makespan, deterministic (ties break on
    the lower step index, then the lower shard index), and pure, so the
    partition is unit-testable without devices.
    Every index in ``range(len(steps))`` appears in exactly one queue;
    queues keep schedule order (interior tiles stay adjacent — the
    shared scan-program key stays warm within a queue).
    """
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    order = sorted(range(len(steps)),
                   key=lambda i: (-step_cost(steps[i]), i))
    loads = [0] * n_shards
    queues: Tuple[list, ...] = tuple([] for _ in range(n_shards))
    for i in order:
        d = min(range(n_shards), key=lambda s: (loads[s], s))
        queues[d].append(i)
        loads[d] += step_cost(steps[i])
    return FleetSchedule(
        n_shards=n_shards,
        queues=tuple(tuple(sorted(q)) for q in queues),
        loads=tuple(loads))


def build_step_major(steps: Sequence[PlanStep],
                     chunks: Sequence[Tuple[int, int]],
                     chunk_size: int) -> StepMajorSchedule:
    """Invert a (steps x chunks) schedule to step-major work lists.

    Shared by :attr:`ReconPlan.step_major` (the planned projection
    count) and the executor's data-dependent path (``backproject``
    accepts any view count, so its chunk list follows the input)."""
    work = tuple(ChunkWork(c, s0, s1) for c, (s0, s1) in enumerate(chunks))
    n_chunks = len(work)
    return StepMajorSchedule(
        n_chunks=n_chunks, chunk_size=int(chunk_size),
        n_scan=n_chunks * int(chunk_size),
        steps=tuple(StepWork(s, work) for s in steps))


@dataclasses.dataclass(frozen=True)
class ReconPlan:
    """Complete, immutable schedule for one reconstruction.

    ``steps`` covers the volume disjointly via their writes; ``chunks``
    covers ``[0, n_proj_padded)`` disjointly. ``schedule`` selects the
    executor's loop order: ``"step"`` (step-major — the tile accumulator
    is carried across all projection chunks on device by one scan
    program and crosses to the host once per step) or ``"chunk"`` (the
    chunk-major loop — one host crossing per step per chunk, kept
    for bounded-device-memory streaming and as the parity oracle).
    ``options`` holds the validated extra kernel options (already
    filtered to what the requested variant's KernelSpec accepts).

    The plan is hashable (a frozen dataclass of hashable fields), so it
    can key caches directly; :attr:`bucket_key` is the compact identity
    the serving layer buckets on.
    """

    vol_shape_xyz: Tuple[int, int, int]
    det_shape_wh: Tuple[int, int]
    variant: str
    tile_shape: Tuple[int, int, int]
    nb: int
    n_proj: int
    n_proj_padded: int
    chunk_size: int                       # projections per chunk (nb-multiple)
    out: str                              # "host" | "device"
    interpret: bool
    steps: Tuple[PlanStep, ...]
    options: Tuple[Tuple[str, object], ...] = ()
    schedule: str = "step"                # "step" | "chunk"
    # rb: how many same-bucket REQUESTS one execution carries as a
    # leading batch axis (cross-request batching — the service-level
    # second tier of the paper's nb in-batch trick). Deliberately NOT
    # part of bucket_key: same-bucket requests of any arrival order are
    # batchable, and the bucket identity must not fragment on how many
    # of them happened to coalesce. It DOES scale the working-set model
    # (every projection stack and accumulator is rb-deep).
    request_batch: int = 1
    # ingest: "offline" (all projections available up front, the
    # default) | "stream" (projections arrive while the plan
    # runs; the executor folds each view chunk the moment it
    # completes). Stream plans are always chunk-major — the arriving
    # unit IS the chunk — and ARE part of bucket_key: a stream session
    # holds per-step accumulators alive across pushes, so it must not
    # share an executor bucket with offline one-shot requests.
    ingest: str = "offline"
    # precision: "f32" (exact float32 everywhere) | "bf16" (reduced-
    # precision data path: projection samples are rounded to bfloat16
    # before entering a kernel — halving the streamed projection bytes,
    # the Treibig/Hofmann locality lever — while interpolation weights
    # and every accumulator stay float32). A numeric knob with the same
    # exactness-tolerance contract as variant="auto": parity with f32
    # holds at tolerance, never bit level. Part of bucket_key — bf16
    # and f32 traffic compile distinct program families and must not
    # share a bucket.
    precision: str = "f32"
    # solver: "none" (a single back-projection / FDK pass, the
    # default) | "sart" | "os_sart" | "cgls" | "fista_tv" (the
    # plan drives runtime.solvers.IterativeExecutor's plan-level
    # iteration loop). Part of bucket_key: solver buckets hold forward-
    # projection programs and normalizer volumes alive across requests,
    # so they must not share an executor bucket with one-shot FDK
    # traffic. For "os_sart" the projection-chunk schedule doubles as
    # the ordered-subset partition (chunk c == subset c).
    solver: str = "none"

    # ---- derived schedules / introspection --------------------------------

    @property
    def chunks(self) -> Tuple[Tuple[int, int], ...]:
        """[s0, s1) projection-chunk bounds over the padded count."""
        _, _, chunks = plan_proj_chunks(self.n_proj_padded, self.nb,
                                        self.chunk_size)
        return tuple(chunks)

    @property
    def streams_projections(self) -> bool:
        """Whether more than one chunk flows through the executor."""
        return self.chunk_size < self.n_proj_padded

    @property
    def step_major(self) -> StepMajorSchedule:
        """First-class step-major schedule over the planned projections."""
        return build_step_major(self.steps, self.chunks, self.chunk_size)

    @property
    def stream(self) -> StreamSchedule:
        """Arrival-ordered online schedule: one :class:`ChunkFold` per
        projection chunk, runnable as soon as that chunk's views have
        all arrived. Defined for any plan (the fold list is just the
        chunk-major loop transposed), but executed only by stream
        executors on ``ingest="stream"`` plans."""
        work = tuple(ChunkWork(c, s0, s1)
                     for c, (s0, s1) in enumerate(self.chunks))
        return StreamSchedule(
            n_chunks=len(work), chunk_size=self.chunk_size,
            n_views=self.n_proj,
            folds=tuple(ChunkFold(w, self.steps) for w in work))

    @property
    def subsets(self) -> Tuple[Tuple[int, int], ...]:
        """Ordered-subset view ranges: the projection-chunk schedule
        clipped to the REAL view count (the chunk grid's zero-image nb
        padding carries no data and is never a subset member). This is
        the partition OS-SART sweeps — one subset per chunk, so the
        tuner's existing ``proj_batch`` axis IS the subset-count axis.
        """
        out = []
        for s0, s1 in self.chunks:
            if s0 >= self.n_proj:
                break
            out.append((s0, min(s1, self.n_proj)))
        return tuple(out)

    @property
    def program_keys(self) -> Tuple[Tuple[str, Tuple[int, int, int]], ...]:
        """Distinct (variant, call_shape) pairs — the compile workload.

        Interior tiles share shapes, so this is typically much smaller
        than ``len(steps)``: the program cache compiles each key once.
        """
        seen: Dict[Tuple[str, Tuple[int, int, int]], None] = {}
        for s in self.steps:
            seen.setdefault((s.variant, s.call_shape))
        return tuple(seen)

    @property
    def bucket_key(self) -> Tuple:
        """Hashable request-shape identity for the serving layer.

        Two requests with equal bucket keys plan identical schedules
        and hit the same compiled programs, so ``runtime/service.py``
        buckets on ``(geometry, plan.bucket_key)``. The derived
        ``steps``/``chunks`` are deterministic functions of these
        fields, so they are deliberately excluded — the key stays a
        flat tuple of scalars/short tuples. ``request_batch`` is also
        excluded ON PURPOSE: rb is an execution multiplicity over the
        same compiled shape family, and batching only works if k
        same-bucket requests land in ONE bucket.
        """
        return (self.vol_shape_xyz, self.det_shape_wh, self.variant,
                self.tile_shape, self.nb, self.n_proj, self.n_proj_padded,
                self.chunk_size, self.out, self.interpret, self.options,
                self.schedule, self.ingest, self.precision, self.solver)

    @property
    def working_set_bytes(self) -> int:
        """Peak modeled working set over all planned kernel calls,
        scaled by ``request_batch``: an rb-batched execution carries rb
        projection stacks and rb accumulators through every call, so
        the memory-budget contract must bill all of them."""
        return self.request_batch * max(tile_working_set_bytes(
            s.call_shape, self.det_shape_wh, nb=self.nb)
            for s in self.steps)

    def batched(self, request_batch: int) -> "ReconPlan":
        """This plan with a ``request_batch`` leading axis of ``rb``
        requests (same ``bucket_key`` — see above). The schedule is
        unchanged: the executor's rb-batched programs vmap/stack the
        SAME step-major scan over the request axis."""
        rb = int(request_batch)
        if rb < 1:
            raise ValueError(f"request_batch must be >= 1, got {rb}")
        if rb == self.request_batch:
            return self
        return dataclasses.replace(self, request_batch=rb)

    def kernel_options(self) -> Dict:
        return dict(self.options)


# --------------------------------------------------------------------------
# Per-tile variant resolution (shared with the single-tile façade)
# --------------------------------------------------------------------------

def resolve_tile_variant(variant: str, tile: TileSpec, nz: int) -> str:
    """Kernel to run on one arbitrary sub-box: the requested variant when
    the box is Z-centered on the volume midplane (symmetry exact), its
    declarative slab-safe fallback otherwise."""
    spec = get_spec(variant)
    if not spec.uses_symmetry or 2 * tile.k0 + tile.nk == nz:
        return variant
    return spec.slab_safe_fallback


# --------------------------------------------------------------------------
# The planner
# --------------------------------------------------------------------------

def _plan_steps(vol_shape_xyz: Tuple[int, int, int],
                tile_shape: Tuple[int, int, int],
                spec: KernelSpec) -> Tuple[PlanStep, ...]:
    """Tile/slab schedule with per-step variant resolution.

    Symmetry variants get the mirror-paired Z schedule (one call of
    virtual depth 2*nk fills both slabs — the O3 flop saving survives
    tiling; the centered middle slab may be up to 2*tk-1 deep). Symmetry-
    free variants get plain slabs bounded at tk, since pairing buys them
    nothing.
    """
    nx, ny, nz = vol_shape_xyz
    ti, tj, tk = tile_shape
    z_units = (plan_z_units(nz, tk) if spec.uses_symmetry
               else plan_z_slabs(nz, tk))
    steps = []
    for t in make_tiles((nx, ny, 1), (ti, tj, 1)):
        for u in z_units:
            if u.paired and spec.uses_symmetry:
                steps.append(PlanStep(
                    t.i0, t.j0, t.ni, t.nj, k_off=u.k0, call_nk=2 * u.nk,
                    variant=spec.name,
                    writes=(TileWrite(u.k0, 0, u.nk),
                            TileWrite(u.mirror_k0, u.nk, 2 * u.nk))))
            else:
                sub = TileSpec(t.i0, t.j0, u.k0, t.ni, t.nj, u.nk)
                steps.append(PlanStep(
                    t.i0, t.j0, t.ni, t.nj, k_off=u.k0, call_nk=u.nk,
                    variant=resolve_tile_variant(spec.name, sub, nz),
                    writes=(TileWrite(u.k0, 0, u.nk),)))
    return tuple(steps)


def _plan_reconstruction_impl(geom: CTGeometry,
                              variant: str = "algorithm1_mp", *,
                              tile_shape: Optional[Sequence[int]] = None,
                              memory_budget: Optional[int] = None,
                              nb: int = 8,
                              proj_batch: Optional[int] = None,
                              out: str = "host",
                              interpret: bool = True,
                              schedule: Optional[str] = None,
                              request_batch: int = 1,
                              ingest: str = "offline",
                              precision: str = "f32",
                              solver: str = "none",
                              tuning=None,
                              device=None,
                              **kernel_options) -> ReconPlan:
    """Build the :class:`ReconPlan` every entry point executes.

    Parameters mirror the façades; validation for ALL of them lives here:

    tile_shape : (ti, tj, tk) max tile size; ``None`` picks it from
        ``memory_budget``, or uses the full volume if neither is given
        (the untiled plan: one step, one chunk — exactly the seed path).
    memory_budget : byte budget for one call's working set. Combined with
        an explicit ``tile_shape`` it validates instead of picking.
    nb : in-batch projection count (paper O5); must be >= 1.
    proj_batch : projections streamed per kernel call, rounded UP to a
        multiple of ``nb``; ``None`` = all at once (a single chunk).
    out : "host" (numpy accumulator, device holds one tile) | "device".
    interpret : carried for option parity with the JAX package; selects
        nothing here (only the tensors' device chooses a kernel's path).
    schedule : "step" (device-resident scanned accumulators, one host
        crossing per step) | "chunk" (the chunk-major loop;
        per-chunk host crossings, but also per-chunk — not whole-set —
        device residency of the filtered projections) | None (default:
        resolve it). Step-major stacks the whole filtered projection
        set on device as the scan input, so an explicit
        ``memory_budget`` — the caller's byte-bound contract — resolves
        to "chunk" (whose residency the per-call working-set model
        soundly describes); everything else resolves to "step".
    ingest : "offline" (default — the whole projection set is handed to
        the executor at once) | "stream" (projections are PUSHED as the
        scanner produces them; ``StreamingExecutor`` folds each view
        chunk the moment it completes). Stream plans are forced
        chunk-major — the completed chunk is the unit of arrival — so
        ``ingest="stream"`` with an explicit ``schedule="step"`` is an
        error, and ``schedule=None`` resolves to "chunk". Because a
        ``TunedConfig`` does not carry an ingest axis, stream plans
        always resolve heuristically: ``variant="auto"`` falls back to
        the default kernel and ``tuning`` is ignored.
    request_batch : rb, the cross-request batch width this plan is
        sized for (>= 1; default 1 = the single-request plan). rb is
        NOT part of the bucket identity, but it scales the working-set
        math: the tile auto-picker sees ``memory_budget // rb`` (rb
        accumulators + projection stacks must fit together) and the
        explicit-tile validation bills the rb-scaled working set, so
        the byte contract stays honest under batching.
    precision : "f32" (default — exact float32) | "bf16" (reduced-
        precision data path: bf16-rounded projection samples, f32
        interpolation weights + accumulators — see
        :attr:`ReconPlan.precision`). A numeric knob: output parity
        with f32 is at tolerance, like ``variant="auto"``.
    solver : "none" (default — one back-projection pass) | "sart" |
        "os_sart" | "cgls" | "fista_tv": marks the plan as the engine
        of an iterative loop (``runtime.solvers.IterativeExecutor``).
        Solver plans accumulate on device (the volume feeds the next
        forward projection), so ``out`` must stay "device"; for
        "os_sart" the chunk schedule is also the ordered-subset
        partition (:attr:`ReconPlan.subsets`).
    tuning : opt-in to the measured autotuner's persisted winners
        (``runtime.autotune``): a ``TuningCache``, a cache-file path,
        or None. With ``variant="auto"`` (or any non-None ``tuning``)
        the plan is resolved by LOOKUP against the tuning cache — a
        persisted winner for this hardware fingerprint x request shape
        replaces the heuristic knobs; a miss (or a missing/corrupt
        cache file) falls back to exactly the heuristic plan this
        function builds today. Planning never measures.
    device : the device whose hardware fingerprint keys that lookup
        (``None`` = the CUDA card, which raises without one; pass
        ``"cpu"`` for the CPU's winners). Only read with
        ``variant="auto"`` or ``tuning``: a plan itself is
        device-independent.
    kernel_options : extra per-variant knobs (e.g. ``block=``, ``bw=``),
        validated against the variant's ``KernelSpec.options``. The
        ``proj_loop`` fused in-kernel projection loop is resolved here
        per variant: defaulted ON for kernels whose KernelSpec
        advertises the capability, absent otherwise.
    """
    if ingest not in ("offline", "stream"):
        raise ValueError(
            f"ingest must be 'offline' or 'stream', got {ingest!r}")
    if ingest == "stream":
        # TunedConfig has no ingest axis; stream plans stay heuristic
        tuning = None
        if variant == "auto":
            variant = "algorithm1_mp"
    if variant == "auto" or tuning is not None:
        # lookup-only: the autotuner owns fingerprinting + the cache
        from repro_torch.runtime.autotune import resolve_plan
        return resolve_plan(
            geom, variant=variant, tuning=tuning, tile_shape=tile_shape,
            memory_budget=memory_budget, nb=nb, proj_batch=proj_batch,
            out=out, interpret=interpret, schedule=schedule,
            request_batch=request_batch, precision=precision,
            solver=solver, device=device, **kernel_options)
    spec = get_spec(variant)
    if precision not in ("f32", "bf16"):
        raise ValueError(
            f"precision must be 'f32' or 'bf16', got {precision!r}")
    if solver not in ("none", "sart", "os_sart", "cgls", "fista_tv"):
        raise ValueError(
            f"solver must be 'none', 'sart', 'os_sart', 'cgls' or "
            f"'fista_tv', got {solver!r}")
    if solver != "none":
        if out not in (None, "device"):
            raise ValueError(
                "solver plans accumulate on device (the volume feeds "
                "the next forward projection every iteration; host "
                "staging would add two full-volume round-trips per "
                f"sweep) — out must be 'device', got {out!r}")
        out = "device"
        if ingest == "stream":
            raise ValueError(
                "solver plans iterate over the COMPLETE projection set "
                "(every sweep revisits all views); ingest='stream' "
                "cannot compose with them — reconstruct online with "
                "solver='none' or wait for the scan to finish")
    request_batch = int(request_batch)
    if request_batch < 1:
        raise ValueError(
            f"request_batch must be >= 1, got {request_batch}")
    if out not in ("host", "device"):
        raise ValueError(f"out must be 'host' or 'device', got {out!r}")
    if schedule not in (None, "step", "chunk"):
        raise ValueError(
            f"schedule must be 'step', 'chunk' or None, got {schedule!r}")
    if ingest == "stream" and schedule == "step":
        raise ValueError(
            "ingest='stream' folds view chunks as they arrive, which is "
            "chunk-major by construction; schedule='step' scans a "
            "complete chunk stack and cannot start before the last view "
            "— use schedule='chunk' or leave it unset")
    if schedule is None:
        schedule = ("chunk" if (ingest == "stream"
                                or memory_budget is not None) else "step")
    nb = int(nb)
    if nb < 1:
        raise ValueError(f"nb must be >= 1, got {nb}")

    unknown = set(kernel_options) - set(spec.options) - {"nb", "interpret"}
    if unknown:
        raise ValueError(
            f"variant {variant!r} does not accept option(s) "
            f"{sorted(unknown)}; its KernelSpec allows "
            f"{sorted(spec.options)}")

    # proj_loop capability resolution (paper O1 loop order + O3 locality
    # carried INTO the kernel): on by default where the KernelSpec
    # advertises it; a registry-validated no-op everywhere else.
    if spec.proj_loop and "proj_loop" not in kernel_options:
        kernel_options["proj_loop"] = True

    nx, ny, nz = geom.volume_shape_xyz
    tile_given = tile_shape is not None
    if tile_shape is None:
        if memory_budget is not None:
            # rb batched executions carry rb working sets at once: the
            # auto-picker must size ONE against budget/rb so all rb
            # together honor the caller's byte contract
            tile_shape = pick_tile_shape(
                (nx, ny, nz), (geom.nw, geom.nh),
                max(1, int(memory_budget) // request_batch),
                nb=nb, pair_z=spec.uses_symmetry)
        else:
            tile_shape = (nx, ny, nz)
    ti, tj, tk = (int(v) for v in tile_shape)
    tile = (max(1, min(ti, nx)), max(1, min(tj, ny)), max(1, min(tk, nz)))

    steps = _plan_steps((nx, ny, nz), tile, spec)

    n_proj = int(geom.n_proj)
    n_pad, chunk, _ = plan_proj_chunks(n_proj, nb, proj_batch)

    plan = ReconPlan(
        vol_shape_xyz=(nx, ny, nz), det_shape_wh=(geom.nw, geom.nh),
        variant=variant, tile_shape=tile, nb=nb,
        n_proj=n_proj, n_proj_padded=n_pad, chunk_size=chunk,
        out=out, interpret=interpret, steps=steps,
        options=tuple(sorted(spec.resolve_options(kernel_options).items())),
        schedule=schedule, request_batch=request_batch, ingest=ingest,
        precision=precision, solver=solver)

    if tile_given and memory_budget is not None and \
            plan.working_set_bytes > int(memory_budget):
        raise ValueError(
            f"explicit tile_shape {tile} needs "
            f"{plan.working_set_bytes} B, over the memory_budget of "
            f"{int(memory_budget)} B — drop one of the two or enlarge "
            f"the budget")
    return plan


@functools.wraps(_plan_reconstruction_impl)
def plan_reconstruction(geom: CTGeometry, variant: str = "algorithm1_mp",
                        **kwargs) -> ReconPlan:
    # every plan build (heuristic or tuning lookup: the lookup re-enters
    # here for its heuristic base, which nests a second span) is one
    # "plan.build" span; the impl's knobs past ``variant`` are
    # keyword-only, so the pass-through is lossless
    with telemetry.span("plan.build", variant=str(variant)):
        return _plan_reconstruction_impl(geom, variant, **kwargs)


plan_reconstruction.__name__ = "plan_reconstruction"
plan_reconstruction.__qualname__ = "plan_reconstruction"
