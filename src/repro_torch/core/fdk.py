"""End-to-end FDK reconstruction pipeline (filter -> back-project).

This is the paper's application context: FDK calls back-projection once,
which is why the paper optimizes it. The entry point here is a thin
façade over the plan/compile/execute core (``runtime.planner`` /
``runtime.executor``): the planner owns scheduling and option
validation, the shared program cache owns the kernel programs, and the
executor streams projection chunks. :func:`sart_step`, one SART update,
is a façade over the iterative solvers (``runtime.solvers``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

from .geometry import CTGeometry


def _build_plan(geom: CTGeometry, variant: str, *, nb: int, interpret: bool,
                tiling, memory_budget: Optional[int],
                proj_batch: Optional[int], out: Optional[str],
                schedule: Optional[str] = None, ingest: str = "offline",
                precision: str = "f32", solver: str = "none",
                tuning=None, **kernel_options):
    """Shared façade-to-planner translation (tiling= conventions)."""
    from repro_torch.runtime.planner import plan_reconstruction

    tiled = tiling is not None or memory_budget is not None
    if tiling == "auto" and memory_budget is None:
        raise ValueError(
            "tiling='auto' needs a memory_budget (bytes) to pick the "
            "tile shape; pass one or give an explicit (ti, tj, tk)")
    tile_shape = None if tiling in (None, "auto") else tuple(tiling)
    if out is None:
        out = "host" if tiled and solver == "none" else "device"
    return plan_reconstruction(
        geom, variant, tile_shape=tile_shape, memory_budget=memory_budget,
        nb=nb, proj_batch=proj_batch, out=out, interpret=interpret,
        schedule=schedule, ingest=ingest, precision=precision,
        solver=solver, tuning=tuning, **kernel_options)


def fdk_reconstruct(projections, geom: CTGeometry,
                    variant: str = "algorithm1_mp", *,
                    nb: int = 8, interpret: bool = True,
                    tiling: Union[None, str, Sequence[int]] = None,
                    memory_budget: Optional[int] = None,
                    proj_batch: Optional[int] = None,
                    out: Optional[str] = None,
                    schedule: Optional[str] = None,
                    pipeline: Optional[str] = None,
                    precision: str = "f32",
                    tuning=None,
                    service=None,
                    devices=None,
                    device=None,
                    **kernel_options):
    """Reconstruct volume (nz, ny, nx) from raw projections (np, nh, nw).

    ``projections`` is a tensor on ``device`` or a numpy array (copied
    there); ``device=None`` means the CUDA card, and without one it
    raises: pass ``device="cpu"`` for the plain PyTorch path.

    ``proj_batch`` streams the projections through in chunks of that
    many views (rounded up to a multiple of ``nb``), with FDK
    pre-weighting + ramp filtering fused into the chunk pipeline.
    ``out`` selects the accumulator placement ("device", the default, or
    "host", which returns numpy). ``schedule`` selects the loop order:
    "step" (default: all chunks filtered once and stacked, one device
    accumulation) or "chunk" (chunk-major, one filtered chunk resident).
    ``interpret`` is carried for option parity with the JAX package and
    selects nothing: only the device chooses between a kernel and its
    plain version. All parameter validation happens in the planner.

    ``tiling`` ((ti, tj, tk), or "auto" with a ``memory_budget``) runs
    the plan's tile steps: (i, j)-tiles x Z-slabs with translated
    matrices, mirror-paired for the symmetry variants; ``memory_budget``
    (bytes) picks the tile shape and the chunk-major loop. A tiled plan
    accumulates on the host unless ``out="device"``. ``pipeline="async"``
    overlaps the host flush of one step with the next step's kernels
    (bit-identical to ``"sync"``).

    ``precision="bf16"`` rounds the projection samples to bfloat16 on
    their way into the back-projector; filtering, weights, accumulators
    and the output stay float32.

    ``variant="auto"`` (or an explicit ``tuning=`` cache or path)
    resolves the whole configuration, executor-level ``pipeline``
    included, from the measured autotuner's persisted winners for this
    device (``runtime.autotune``; a miss falls back to exactly the
    heuristic plan, and planning never measures: ``autotune`` populates
    the cache). An explicit ``pipeline`` overrides the cached one.

    ``service`` (a :class:`~repro_torch.runtime.service.ReconService`)
    routes the call through the service's shape buckets and its FIFO
    queue: the bucket's executor and programs are reused, and the result
    is the service's for the same options. The service owns the flush
    discipline and the devices, so ``pipeline=``, ``device=`` and
    ``devices=`` may not be passed with it.

    ``devices`` shards the step schedule across a reconstruction fleet
    (``PlanExecutor.execute_fleet``): ``"all"`` uses every CUDA device, an
    int N the first N, a sequence of devices (or a
    ``runtime.executor.FleetConfig``) exactly those entries, one worker
    each (``("cuda:0",) * 2``, or ``("cpu",) * 8`` on the CPU). Steps run
    with straggler-aware work stealing and per-step failover, and the
    output equals the single-device walk bit for bit (disjoint step
    boxes). ``out`` defaults to "host" (the fleet accumulates on the host)
    and ``schedule`` to "step". Filtering runs on ``device``, by default
    the fleet's first entry. Without a card, ``"all"`` and an int raise.
    A fleet's entries and ``device`` are all CUDA devices or all the CPU:
    a card's failed step never re-runs on the CPU.
    """
    from repro_torch.runtime import telemetry
    from repro_torch.runtime.executor import PlanExecutor, as_fleet_config

    if service is not None:
        for name, value in (("pipeline", pipeline), ("device", device),
                            ("devices", devices)):
            if value is not None:
                raise ValueError(
                    f"{name}= is owned by the service's bucket executors "
                    f"(ReconService({name}=...)); do not pass both "
                    f"service= and {name}=")
        return service.reconstruct(
            projections, geom, variant=variant, nb=nb, interpret=interpret,
            tiling=tiling, memory_budget=memory_budget,
            proj_batch=proj_batch, out=out, schedule=schedule,
            precision=precision, tuning=tuning, **kernel_options)
    with telemetry.span("recon.call"):
        fleet = as_fleet_config(devices)
        if fleet is not None:
            # the fleet accumulates each entry's step outputs into a host
            # volume over the step schedule; explicit contrary choices fail
            # in the executor's validation
            out = out or "host"
            schedule = schedule or "step"
            if device is None:
                device = fleet.resolve_devices()[0]
        if variant == "auto" or tuning is not None:
            # lookup-only tuned resolution: the config also carries the
            # executor-level pipeline knobs the plan cannot
            from repro_torch.runtime.autotune import resolve_config
            cfg = resolve_config(
                geom, variant, cache=tuning, device=device, nb=nb,
                interpret=interpret, tiling=tiling,
                memory_budget=memory_budget, proj_batch=proj_batch, out=out,
                schedule=schedule, precision=precision, **kernel_options)
            if pipeline is None and fleet is None:
                ex = PlanExecutor.from_config(geom, cfg, device=device)
            else:                     # an explicit override beats the cache
                ex = PlanExecutor(geom, cfg.build_plan(geom),
                                  pipeline=cfg.pipeline if pipeline is None
                                  else pipeline,
                                  pipeline_depth=cfg.pipeline_depth,
                                  tuned=cfg, fleet=fleet, device=device)
            return ex.reconstruct(projections)
        plan = _build_plan(geom, variant, nb=nb, interpret=interpret,
                           tiling=tiling, memory_budget=memory_budget,
                           proj_batch=proj_batch, out=out, schedule=schedule,
                           precision=precision, **kernel_options)
        return PlanExecutor(
            geom, plan, pipeline="sync" if pipeline is None else pipeline,
            fleet=fleet, device=device,
        ).reconstruct(projections)


def sart_step(vol_zyx, projections, geom: CTGeometry, *, relax: float = 0.25,
              variant: str = "algorithm1_mp", nb: int = 8,
              oversample: float = 1.0, interpret: bool = True,
              tiling: Union[None, str, Sequence[int]] = None,
              memory_budget: Optional[int] = None,
              proj_batch: Optional[int] = None,
              schedule: Optional[str] = None,
              precision: str = "f32", device=None,
              **kernel_options):
    """One SART update (the paper's iterative-reconstruction use).

    Standard SART (Andersen & Kak):

        x += relax * (1 / BP(1)) * BP( (P - FP(x)) / FP(1_vol) )

    FP(1_vol) are the per-ray intersection lengths (projection-domain
    row sums of the system matrix); BP(1) the voxel-domain column sums.

    Thin façade over ``runtime.solvers`` (``n_iters=1``): repeated calls
    with the same configuration land on the SAME persistent
    :class:`~repro_torch.runtime.solvers.IterativeExecutor`, so the
    normalizers are computed once and later calls build no program.
    ``tiling=`` / ``memory_budget=`` / ``proj_batch=`` bound the per-call
    working set as in :func:`fdk_reconstruct`; the volume stays on the
    device (``out="device"``), since the next forward projection needs
    it there. ``device=None`` means the CUDA card.
    """
    from repro_torch.runtime.solvers import solver_executor

    plan = _build_plan(geom, variant, nb=nb, interpret=interpret,
                       tiling=tiling, memory_budget=memory_budget,
                       proj_batch=proj_batch, out="device",
                       schedule=schedule, precision=precision,
                       solver="sart", **kernel_options)
    ex = solver_executor(geom, plan, oversample=oversample, device=device)
    vol, _report = ex.solve(projections, n_iters=1, relax=relax,
                            x0=vol_zyx)
    return vol
