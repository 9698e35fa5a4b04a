"""Iterative solvers as plan-level loops over a persistent executor.

The paper frames back-projection as the compute core that iterative
reconstruction multiplies by the iteration count (§2): a SART run is
N_iters x (forward + back) projections, so everything the engine
amortizes for one FDK call (programs, schedules, normalizer volumes) is
amortized across the WHOLE solve, not rebuilt per iteration. This module
supplies that loop level:

* :class:`IterativeExecutor` pairs the ray-driven forward projector
  (``core.forward``; on the card the kernel F1) with the back-projection
  engine (:class:`~repro_torch.runtime.executor.PlanExecutor`; on the card
  K1-K6) through one shared
  :class:`~repro_torch.runtime.executor.ProgramCache`. Forward programs
  and the TV prox join the cache under their own key families
  (``("forward", ...)`` / ``("tv_prox", ...)``), so
  ``cache.stats()["misses"]`` counts EVERY program a solve builds: the
  basis of the build-nothing-after-iteration-1 contract asserted in tests
  and reported per run in :class:`SolveReport`.
* Normalizer volumes are computed once per executor: ``FP(1)`` (per-ray
  intersection lengths) and ``BP(1)`` (voxel column sums), plus the
  per-subset ``BP_s(1)`` family OS-SART needs, all cached on the
  instance, never per call.
* The solvers themselves (SART, OS-SART, CGLS, FISTA-TV) are plain
  Python loops at plan level. OS-SART's ordered subsets ARE the plan's
  projection chunks (:attr:`ReconPlan.subsets`): the ``proj_batch`` axis
  doubles as the subset-count axis.

Precision rides the plan: ``precision="bf16"`` routes both projectors
through the reduced-precision data path (bf16-rounded samples, f32
accumulators): the forward program rounds the volume, the back-projection
programs the projections.

Each solve is one ``solve`` span with one ``solve.iter`` span per
iteration (``runtime.telemetry``), and :class:`SolveReport` has the
shared ``as_dict()``/``emit()`` report contract. ``runtime.service``
serves solver plans from its buckets through the duck-type surface
(``warm`` / ``reconstruct`` / ``pipeline`` / ``tuned`` /
``supports_request_batching``, and ``fleet`` / ``fleet_totals``, which
a solver bucket reports empty: solver requests run on one device, and a
fleet service refuses them).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.core import backproject as bp
from repro_torch.core.forward import (forward_project_kernel, march_params,
                                      view_frames)
from repro_torch.core.geometry import CTGeometry, projection_matrices

from . import telemetry
from .executor import PlanExecutor, ProgramCache, default_program_cache
from .planner import ReconPlan, plan_reconstruction

SOLVERS = ("sart", "os_sart", "cgls", "fista_tv")

_EPS_RAY = 1e-3     # floor for FP(1) ray lengths (matches sart_step)
_EPS_VOL = 1e-12    # floor for BP(1) voxel sums


# ---------------------------------------------------------------------------
# reports


@dataclass
class SolveReport(telemetry.EmitMixin):
    """What one solve did: convergence trace + program accounting.

    ``EmitMixin`` gives it the shared ``as_dict()``/``emit()`` contract
    of the runtime's reports."""

    method: str
    n_iters: int
    precision: str
    # projection-domain residual norm per iteration (OS-SART records the
    # norm seen while sweeping its subsets: Kaczmarz-style, each subset
    # measured at its visit)
    residuals: Tuple[float, ...] = ()
    # ProgramCache misses attributed to iteration 1 (includes the
    # normalizers and any warm-up) vs. iterations 2..N. The contract:
    # ``compiles_warm == 0``: warm iterations dispatch, never build.
    compiles_iter1: int = 0
    compiles_warm: int = 0
    wall_s: float = 0.0
    extras: Dict[str, float] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# TV prox (Chambolle dual iteration, 3-D)


def _grad3(u: torch.Tensor) -> torch.Tensor:
    """Forward differences per axis, Neumann (zero) at the far face."""
    g = torch.zeros((3,) + tuple(u.shape), dtype=u.dtype, device=u.device)
    g[0, :-1] = u[1:] - u[:-1]
    g[1, :, :-1] = u[:, 1:] - u[:, :-1]
    g[2, :, :, :-1] = u[:, :, 1:] - u[:, :, :-1]
    return g


def _div3(p: torch.Tensor) -> torch.Tensor:
    """Adjoint of ``-_grad3``: backward differences with the matching
    boundary rows (first slice passes through, last negates)."""
    def d(q, axis):
        n = q.shape[axis]
        first = q.narrow(axis, 0, 1)
        mid = q.narrow(axis, 1, n - 2) - q.narrow(axis, 0, n - 2)
        last = -q.narrow(axis, n - 2, 1)
        return torch.cat([first, mid, last], dim=axis)

    return d(p[0], 0) + d(p[1], 1) + d(p[2], 2)


def _build_tv_prox(shape: Tuple[int, int, int], n_inner: int):
    """Prox of ``lam * TV`` at unit step: Chambolle's dual fixed point,
    tau = 1/12 (the 3-D convergence bound). ``lam`` is a call argument,
    so one program serves every weight."""
    tau = 1.0 / 12.0

    def prox(x: torch.Tensor, lam) -> torch.Tensor:
        lam = torch.as_tensor(lam, dtype=torch.float32, device=x.device)
        rate = tau / lam
        p = torch.zeros((3,) + tuple(shape), dtype=torch.float32,
                        device=x.device)
        for _ in range(int(n_inner)):
            g = _grad3(x - lam * _div3(p))
            mag = torch.sqrt(torch.sum(g * g, dim=0, keepdim=True))
            p = (p - rate * g) / (1.0 + rate * mag)
        return x - lam * _div3(p)

    return prox


# ---------------------------------------------------------------------------
# the executor


class IterativeExecutor:
    """Persistent forward+back pairing for one solver plan on one device.

    Construct once per ``(geom, plan)``; every ``reconstruct`` call
    reuses the same programs and normalizer volumes. Duck-types the
    :class:`PlanExecutor` surface a serving layer expects from a bucket
    executor. ``device=None`` means the CUDA card. ``tuned`` is the
    ``runtime.autotune.TunedConfig`` the plan came from (provenance;
    None = heuristic knobs).
    """

    #: solver buckets never coalesce across requests: each solve is a
    #: stateful multi-pass loop, not one batched dispatch
    supports_request_batching = False

    def __init__(self, geom: CTGeometry, plan: ReconPlan,
                 cache: Optional[ProgramCache] = None, *,
                 oversample: float = 1.0,
                 pipeline: str = "sync", pipeline_depth: int = 2,
                 tuned=None, device=None):
        if plan.solver not in SOLVERS:
            raise ValueError(
                f"IterativeExecutor needs a solver plan; got "
                f"solver={plan.solver!r} (plan FDK runs with "
                f"PlanExecutor directly)")
        self.geom = geom
        self.plan = plan
        self.oversample = float(oversample)
        self.ex = PlanExecutor(geom, plan, cache=cache, pipeline=pipeline,
                               pipeline_depth=pipeline_depth, tuned=tuned,
                               device=device)
        self.device = self.ex.device
        self.cache = self.ex.cache
        self.last_report: Optional[SolveReport] = None
        # geometry-fixed inputs, uploaded once
        self._mats = projection_matrices(geom, self.device)
        self._frames = tuple(torch.from_numpy(a).to(self.device)
                             for a in view_frames(geom))
        # normalizers, lazily filled (keyed by the forward oversample so
        # one executor serves any request's march density): FP(1) rides
        # iteration 1's first forward program, BP(1)/BP_s(1) ride the BP
        # programs
        self._ray_len: Dict[float, torch.Tensor] = {}
        self._bp_ones: Dict[Tuple[int, int], torch.Tensor] = {}
        self._fista_L: Dict[float, float] = {}

    # -- PlanExecutor duck-type surface (serving layer) -------------------

    @property
    def pipeline(self):
        return self.ex.pipeline

    @property
    def tuned(self):
        return self.ex.tuned

    @property
    def fleet(self):
        return None

    @property
    def _fleet_lock(self):
        return self.ex._fleet_lock

    @property
    def fleet_totals(self):
        return self.ex.fleet_totals

    @property
    def _dtype(self):
        return self.ex._dtype

    def warm(self) -> Dict[str, int]:
        """Build every program + normalizer one solve needs; returns
        cache stats. After ``warm()`` a solve's iteration 1 builds
        nothing either."""
        self.ex.warm()
        self._normalizers()
        if self.plan.solver == "fista_tv":
            self._tv_prox(self._default_tv_inner)
        return self.cache.stats()

    def reconstruct(self, projections, **solver_kw) -> torch.Tensor:
        """Run ``plan.solver`` on raw projections (np, nh, nw); returns
        the (nz, ny, nx) volume on the device. Keyword knobs:
        ``n_iters``, ``relax``, ``x0``, ``tv_weight``, ``tv_inner``,
        ``oversample``."""
        vol, _report = self.solve(projections, **solver_kw)
        return vol

    # -- program access (everything counted by the shared cache) ----------

    def _forward_program(self, k: int, oversample: float):
        """Forward program for a k-view chunk of THIS geometry.

        Keyed in the shared cache under the ``"forward"`` family so
        solver programs are auditable next to BP programs, as in the JAX
        package (where a miss is an XLA compile). Like the BP programs,
        a program runs on the device its inputs lie on: it keeps the
        march constants of each device it has run on."""
        key = ("forward", self.geom, round(oversample, 6), int(k),
               self._dtype)
        geom = self.geom

        def build():
            consts: Dict[torch.device, tuple] = {}
            bf16 = self._dtype == "bfloat16"

            def prog(vol_zyx, srcs, origins, usteps, vsteps):
                dev = vol_zyx.device
                if dev not in consts:
                    consts[dev] = march_params(geom, oversample, dev)
                vo, ip, sl, tn, ns = consts[dev]
                if bf16:   # bf16 samples; the march's sum stays f32
                    vol_zyx = vol_zyx.to(torch.bfloat16).to(torch.float32)
                return forward_project_kernel(
                    vol_zyx.contiguous(), srcs, origins, usteps, vsteps, vo,
                    ip, ns, geom.nh, geom.nw, sl, tn)

            return prog

        return self.cache.get_or_build(key, build)

    _default_tv_inner = 10

    def _tv_prox(self, n_inner: int):
        nx, ny, nz = self.plan.vol_shape_xyz
        key = ("tv_prox", (nz, ny, nx), int(n_inner))
        return self.cache.get_or_build(
            key, lambda: _build_tv_prox((nz, ny, nx), int(n_inner)))

    # -- the two half-iterations ------------------------------------------

    def _fp(self, vol_zyx, s0: Optional[int] = None,
            s1: Optional[int] = None, *,
            oversample: Optional[float] = None) -> torch.Tensor:
        """Forward-project (all views, or the subset [s0, s1)). Walks
        the plan's projection chunks: the same bounded per-dispatch view
        set the back-projector promises."""
        ov = self.oversample if oversample is None else float(oversample)
        srcs, origins, usteps, vsteps = self._frames
        if s0 is not None:
            prog = self._forward_program(s1 - s0, ov)
            return prog(vol_zyx, srcs[s0:s1], origins[s0:s1],
                        usteps[s0:s1], vsteps[s0:s1])
        parts = []
        for c0, c1 in self.plan.subsets:
            prog = self._forward_program(c1 - c0, ov)
            parts.append(prog(vol_zyx, srcs[c0:c1], origins[c0:c1],
                              usteps[c0:c1], vsteps[c0:c1]))
        return parts[0] if len(parts) == 1 else torch.cat(parts, 0)

    def _bp(self, proj, s0: Optional[int] = None,
            s1: Optional[int] = None) -> torch.Tensor:
        """Back-project projection-domain rows into a (nz, ny, nx)
        volume through the plan's engine (any view count), unfiltered."""
        mats = self._mats if s0 is None else self._mats[s0:s1]
        vol_t = self.ex.backproject(bp.transpose_projections(proj), mats)
        return bp.volume_to_native(vol_t)

    # -- normalizers (computed once per executor) -------------------------

    def _zeros_vol(self) -> torch.Tensor:
        nx, ny, nz = self.plan.vol_shape_xyz
        return torch.zeros((nz, ny, nx), dtype=torch.float32,
                           device=self.device)

    def _normalizers(self, oversample: Optional[float] = None):
        """``FP(1)`` ray lengths + full-set ``BP(1)``; idempotent."""
        ov = self.oversample if oversample is None else float(oversample)
        ray_len = self._ray_len.get(ov)
        if ray_len is None:
            ones = torch.ones_like(self._zeros_vol())
            ray_len = torch.clamp(self._fp(ones, oversample=ov),
                                  min=_EPS_RAY)
            self._ray_len[ov] = ray_len
        self._bp_ones_for(None, None)
        return ray_len

    def _bp_ones_for(self, s0: Optional[int], s1: Optional[int]):
        key = (-1, -1) if s0 is None else (s0, s1)
        vol = self._bp_ones.get(key)
        if vol is None:
            g = self.geom
            k = g.n_proj if s0 is None else s1 - s0
            ones = torch.ones((k, g.nh, g.nw), dtype=torch.float32,
                              device=self.device)
            vol = torch.clamp(self._bp(ones, s0, s1), min=_EPS_VOL)
            self._bp_ones[key] = vol
        return vol

    # -- solve dispatch ----------------------------------------------------

    def solve(self, projections, *, n_iters: int = 10,
              relax: float = 0.9, x0=None, tv_weight: float = 0.005,
              tv_inner: Optional[int] = None,
              oversample: Optional[float] = None
              ) -> Tuple[torch.Tensor, SolveReport]:
        """Run the plan's solver; returns ``(volume_zyx, SolveReport)``.

        The report's program split is read off the shared cache: misses
        during iteration 1 (normalizers included) vs. misses after; the
        latter must be zero, warm iterations only dispatch.
        """
        method = self.plan.solver
        loops = {"sart": self._solve_sart, "os_sart": self._solve_os_sart,
                 "cgls": self._solve_cgls, "fista_tv": self._solve_fista_tv}
        if method not in loops:
            raise ValueError(f"unknown solver {method!r}")
        n_iters = int(n_iters)
        if n_iters < 1:
            raise ValueError(f"n_iters must be >= 1, got {n_iters}")
        projections = self.ex._as_input("projections", projections)
        g = self.geom
        if tuple(projections.shape) != (g.n_proj, g.nh, g.nw):
            raise ValueError(
                f"projections {tuple(projections.shape)} != geometry "
                f"{(g.n_proj, g.nh, g.nw)}")
        x = self._zeros_vol() if x0 is None else self.ex._as_input("x0", x0)

        stats0 = self.cache.stats()["misses"]
        t0 = time.perf_counter()
        marks: Dict[str, int] = {}   # loop writes misses-after-iter-1
        kw = dict(n_iters=n_iters, relax=float(relax),
                  tv_weight=float(tv_weight),
                  tv_inner=self._default_tv_inner if tv_inner is None
                  else int(tv_inner),
                  oversample=self.oversample if oversample is None
                  else float(oversample))
        with telemetry.span("solve", method=method, n_iters=n_iters,
                            precision=self.plan.precision):
            x, residuals, extras = loops[method](projections, x, kw, marks)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        stats1 = self.cache.stats()["misses"]
        after_iter1 = marks.get("after_iter1", stats1)
        report = SolveReport(
            method=method, n_iters=n_iters, precision=self.plan.precision,
            residuals=tuple(residuals),
            compiles_iter1=after_iter1 - stats0,
            compiles_warm=stats1 - after_iter1,
            wall_s=wall, extras=extras)
        self.last_report = report
        return x, report

    # -- the loops ---------------------------------------------------------

    def _solve_sart(self, proj, x, kw, marks):
        """x += relax * BP((P - FP(x)) / FP(1)) / BP(1)"""
        ov = kw["oversample"]
        ray_len = self._normalizers(ov)
        norm = self._bp_ones_for(None, None)
        residuals = []
        for i in range(kw["n_iters"]):
            with telemetry.span("solve.iter", method="sart", i=i):
                est = self._fp(x, oversample=ov)
                resid = proj - est
                residuals.append(float(torch.linalg.vector_norm(resid)))
                x = x + kw["relax"] * self._bp(resid / ray_len) / norm
                if i == 0:
                    marks["after_iter1"] = self.cache.stats()["misses"]
        return x, residuals, {}

    def _solve_os_sart(self, proj, x, kw, marks):
        """SART restricted to each ordered subset in turn; the subsets
        are the plan's projection chunks, so the subset count is the
        ``proj_batch`` axis."""
        ov = kw["oversample"]
        ray_len = self._normalizers(ov)
        subsets = self.plan.subsets
        residuals = []
        for i in range(kw["n_iters"]):
            with telemetry.span("solve.iter", method="os_sart", i=i):
                sweep_sq = 0.0
                for s0, s1 in subsets:
                    est = self._fp(x, s0, s1, oversample=ov)
                    resid = proj[s0:s1] - est
                    sweep_sq += float(torch.sum(resid * resid))
                    upd = self._bp(resid / ray_len[s0:s1], s0, s1)
                    x = x + kw["relax"] * upd / self._bp_ones_for(s0, s1)
                residuals.append(math.sqrt(sweep_sq))
                if i == 0:
                    marks["after_iter1"] = self.cache.stats()["misses"]
        return x, residuals, {"subsets": float(len(subsets))}

    def _solve_cgls(self, proj, x, kw, marks):
        """CGLS-style conjugate directions on the normal equations.

        The FP/BP pair is the standard unmatched (ray-driven /
        voxel-driven) discretization AND the voxel kernel carries FDK's
        depth weighting, so BP is a badly *scaled* transpose: the
        textbook step ``gamma/||q||^2`` would be off by the weighting's
        square. Instead the exact line-search step ``<r, q>/||q||^2``
        (it minimizes ``||r - alpha q||`` outright, so the residual is
        monotone for ANY BP scaling), with the Fletcher-Reeves direction
        mix, where the scaling cancels."""
        ov = kw["oversample"]
        r = proj - self._fp(x, oversample=ov)
        s = self._bp(r)
        p = s
        gamma = torch.sum(s * s)
        residuals = []
        for i in range(kw["n_iters"]):
            with telemetry.span("solve.iter", method="cgls", i=i):
                q = self._fp(p, oversample=ov)
                alpha = torch.sum(r * q) / torch.clamp(torch.sum(q * q),
                                                       min=_EPS_VOL)
                x = x + alpha * p
                r = r - alpha * q
                residuals.append(float(torch.linalg.vector_norm(r)))
                s = self._bp(r)
                gamma_new = torch.sum(s * s)
                p = s + (gamma_new / torch.clamp(gamma, min=_EPS_VOL)) * p
                gamma = gamma_new
                if i == 0:
                    marks["after_iter1"] = self.cache.stats()["misses"]
        return x, residuals, {}

    def _solve_fista_tv(self, proj, x, kw, marks):
        """FISTA on 0.5||FP(x) - P||^2 + tv_weight * TV(x); the TV prox
        is Chambolle's dual iteration (a cached program). The gradient
        Lipschitz constant L = ||A^T A|| comes from a short power
        iteration on the FP/BP programs the loop uses, and is cached on
        the executor."""
        ov = kw["oversample"]
        self._normalizers(ov)
        prox = self._tv_prox(kw["tv_inner"])
        L = self._fista_L.get(ov)
        if L is None:
            v = self._bp(proj)
            nrm = float(torch.linalg.vector_norm(v))
            if nrm < _EPS_VOL:   # blank data: seed with ones
                v = torch.ones_like(x)
                nrm = float(torch.linalg.vector_norm(v))
            L = 1.0
            for _ in range(8):
                v = self._bp(self._fp(v / nrm, oversample=ov))
                L = float(torch.linalg.vector_norm(v))
                nrm = max(L, _EPS_VOL)
            L = max(L, _EPS_VOL)
            self._fista_L[ov] = L
        step = 1.0 / L
        lam = max(kw["tv_weight"] * step, _EPS_VOL)
        y, t = x, 1.0
        residuals = []
        for i in range(kw["n_iters"]):
            with telemetry.span("solve.iter", method="fista_tv", i=i):
                resid = self._fp(y, oversample=ov) - proj
                residuals.append(float(torch.linalg.vector_norm(resid)))
                x_new = prox(y - step * self._bp(resid), lam)
                t_new = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * t * t))
                y = x_new + ((t - 1.0) / t_new) * (x_new - x)
                x, t = x_new, t_new
                if i == 0:
                    marks["after_iter1"] = self.cache.stats()["misses"]
        return x, residuals, {"lipschitz": L}


# ---------------------------------------------------------------------------
# module-level executor reuse + the functional façade

_EXECUTORS: Dict[tuple, IterativeExecutor] = {}


def solver_executor(geom: CTGeometry, plan: ReconPlan,
                    cache: Optional[ProgramCache] = None, *,
                    oversample: float = 1.0,
                    pipeline: str = "sync",
                    device=None) -> IterativeExecutor:
    """Get-or-create the persistent executor for ``(geom, plan)``.

    Keyed by the plan's bucket key + the forward-pass oversampling +
    cache identity + the device, so repeated façade calls (``sart_step``
    once per outer iteration, say) land on the SAME executor:
    normalizers and programs built once, every later call warm."""
    c = cache if cache is not None else default_program_cache()
    dev = resolve_device(device)
    key = (geom, plan.bucket_key, oversample, pipeline, id(c), str(dev))
    ex = _EXECUTORS.get(key)
    if ex is None:
        ex = IterativeExecutor(geom, plan, c, oversample=oversample,
                               pipeline=pipeline, device=dev)
        _EXECUTORS[key] = ex
    return ex


def clear_solver_executors() -> None:
    """Drop the executor cache (tests: isolate program counting)."""
    _EXECUTORS.clear()


def solve(projections, geom: CTGeometry, method: str = "sart", *,
          n_iters: int = 10, relax: float = 0.9, x0=None,
          tv_weight: float = 0.005, tv_inner: Optional[int] = None,
          oversample: float = 1.0, variant: str = "algorithm1_mp",
          nb: int = 8, interpret: bool = True,
          proj_batch: Optional[int] = None, schedule: Optional[str] = None,
          precision: str = "f32", cache: Optional[ProgramCache] = None,
          tuning=None, device=None, **kernel_options
          ) -> Tuple[torch.Tensor, SolveReport]:
    """One-call iterative reconstruction: plan, reuse the persistent
    executor, run the loop. Returns ``(volume_zyx, SolveReport)``.
    ``device=None`` means the CUDA card; pass ``device="cpu"`` for the
    plain PyTorch path.

    ``variant="auto"`` or a ``tuning`` cache (a ``TuningCache`` or a
    path) resolves the plan by lookup of the autotuner's persisted
    winner for this device and request (``autotune(..., method=...)``
    stores it); a miss runs the heuristic plan."""
    if method not in SOLVERS:
        raise ValueError(f"method must be one of {SOLVERS}, got {method!r}")
    plan = plan_reconstruction(
        geom, variant, nb=nb, interpret=interpret, proj_batch=proj_batch,
        out="device", schedule=schedule, precision=precision,
        solver=method, tuning=tuning, device=device, **kernel_options)
    ex = solver_executor(geom, plan, cache, oversample=oversample,
                         device=device)
    return ex.solve(projections, n_iters=n_iters, relax=relax, x0=x0,
                    tv_weight=tv_weight, tv_inner=tv_inner)
