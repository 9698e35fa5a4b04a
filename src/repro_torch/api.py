"""The unified reconstruction API: one options object, one entry point.

* :class:`ReconOptions`: one frozen, hashable record of every knob a
  reconstruction can take, with the same fields as the JAX package's.
* :func:`reconstruct`: the top-level entry point,
  ``repro_torch.reconstruct(projections, geom, method="fdk",
  options=ReconOptions(...), device=None)``.

Legacy keyword spellings keep working: ``reconstruct(..., nb=4)`` is
accepted and folded into the options record by :func:`_coerce_options`.
Passing a legacy kwarg that CONFLICTS with an explicitly-set options
field raises a ``DeprecationWarning`` (the kwarg wins).

``ReconOptions.interpret`` defaults to True and is carried through the
planner and the program cache for parity with the JAX package, but it
selects nothing here: the device alone chooses between a CUDA kernel
(on the card) and its plain PyTorch version (on the CPU).
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple, Union

from repro_torch.core.geometry import CTGeometry

#: iterative methods (``method="fdk"`` is the analytic path)
ITERATIVE_METHODS = ("sart", "os_sart", "cgls", "fista_tv")


@dataclass(frozen=True)
class ReconOptions:
    """Every reconstruction knob, in one frozen record.

    Planner-owned fields (``variant`` .. ``precision``) mirror
    ``plan_reconstruction``; executor-owned fields (``pipeline``,
    ``devices``, ``service``, ``tuning``) mirror the façade extras;
    solver-owned fields (``n_iters`` .. ``x0``) only apply to iterative
    methods. ``kernel_options`` holds variant-specific extras and
    normalizes to a sorted tuple of pairs so the record stays hashable.
    """

    # -- planner-owned -----------------------------------------------------
    variant: str = "algorithm1_mp"
    nb: int = 8
    interpret: bool = True
    tiling: Union[None, str, Sequence[int]] = None
    memory_budget: Optional[int] = None
    proj_batch: Optional[int] = None
    out: Optional[str] = None
    schedule: Optional[str] = None
    precision: str = "f32"
    # -- executor / serving-owned -----------------------------------------
    pipeline: Optional[str] = None
    tuning: Any = None
    service: Any = None
    devices: Any = None
    # -- solver-owned (iterative methods only) ----------------------------
    n_iters: int = 10
    relax: float = 0.9
    tv_weight: float = 0.005
    tv_inner: Optional[int] = None
    oversample: float = 1.0
    x0: Any = None
    # -- variant-specific extras ------------------------------------------
    kernel_options: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self):
        ko = self.kernel_options
        if isinstance(ko, dict):
            object.__setattr__(self, "kernel_options",
                               tuple(sorted(ko.items())))
        elif not isinstance(ko, tuple):
            object.__setattr__(self, "kernel_options",
                               tuple(tuple(p) for p in ko))

    def kernel_options_dict(self) -> dict:
        return dict(self.kernel_options)


_FIELDS = {f.name: f.default for f in dataclasses.fields(ReconOptions)
           if f.name != "kernel_options"}


def _coerce_options(options: Optional[ReconOptions],
                    overrides: dict, caller: str) -> ReconOptions:
    """Fold legacy keyword spellings into one :class:`ReconOptions`.

    ``overrides`` (the legacy kwargs) win, but an override that disagrees
    with a field the caller ALSO set explicitly on ``options`` is a
    conflicting double spelling and raises ``DeprecationWarning``.
    Unknown keys are variant kernel options and merge into
    ``kernel_options``.
    """
    opts = options if options is not None else ReconOptions()
    if not isinstance(opts, ReconOptions):
        raise TypeError(
            f"{caller}: options must be a ReconOptions, got "
            f"{type(opts).__name__}")
    if not overrides:
        return opts
    updates: dict = {}
    extra_ko: dict = {}
    for name, value in overrides.items():
        if name not in _FIELDS:
            extra_ko[name] = value
            continue
        current = getattr(opts, name)
        if current != _FIELDS[name] and current != value:
            warnings.warn(
                f"{caller}: legacy kwarg {name}={value!r} conflicts with "
                f"options.{name}={current!r}; the kwarg wins. Set the "
                f"field on ReconOptions instead of spelling it twice.",
                DeprecationWarning, stacklevel=3)
        updates[name] = value
    if extra_ko:
        merged = dict(opts.kernel_options)
        merged.update(extra_ko)
        updates["kernel_options"] = tuple(sorted(merged.items()))
    return dataclasses.replace(opts, **updates)


def reconstruct(projections, geom: CTGeometry, method: str = "fdk",
                options: Optional[ReconOptions] = None, *, device=None,
                **overrides):
    """Reconstruct a (nz, ny, nx) volume from (np, nh, nw) projections.

    ``method`` selects the algorithm: ``"fdk"`` (analytic filter +
    back-project) or one of the iterative solvers ``"sart"`` /
    ``"os_sart"`` / ``"cgls"`` / ``"fista_tv"`` (plan-level loops over
    the persistent :class:`~repro_torch.runtime.solvers.IterativeExecutor`).
    ``device=None`` means the CUDA card; without one it raises, so pass
    ``device="cpu"`` for the plain PyTorch path. ``projections`` is a
    tensor on that device or a numpy array. ``options.tuning`` (and
    ``variant="auto"``) reach every method: the plan resolves by lookup
    of the autotuner's persisted winner for this device.
    ``options.service`` (a ``runtime.service.ReconService``) routes every
    method through the service's buckets, on the service's device.
    """
    o = _coerce_options(options, overrides, f"reconstruct(method={method!r})")
    if method == "fdk":
        from repro_torch.core.fdk import fdk_reconstruct
        return fdk_reconstruct(
            projections, geom, o.variant, nb=o.nb, interpret=o.interpret,
            tiling=o.tiling, memory_budget=o.memory_budget,
            proj_batch=o.proj_batch, out=o.out, schedule=o.schedule,
            pipeline=o.pipeline, tuning=o.tuning, service=o.service,
            devices=o.devices, precision=o.precision, device=device,
            **o.kernel_options_dict())
    if method not in ITERATIVE_METHODS:
        raise ValueError(
            f"method must be 'fdk' or one of {ITERATIVE_METHODS}, got "
            f"{method!r}")
    if o.devices is not None:
        raise ValueError(
            "iterative methods run single-device (the solver loop owns "
            "the volume); devices= applies to method='fdk' only")
    if o.service is not None:
        # solver requests ride the service's solver buckets
        if device is not None:
            raise ValueError(
                "device= is owned by the service's bucket executors "
                "(ReconService(device=...)); do not pass both service= "
                "and device=")
        return o.service.reconstruct(
            projections, geom, variant=o.variant, nb=o.nb,
            interpret=o.interpret, tiling=o.tiling,
            memory_budget=o.memory_budget, proj_batch=o.proj_batch,
            out=o.out, schedule=o.schedule, precision=o.precision,
            solver=method, n_iters=o.n_iters, relax=o.relax,
            tv_weight=o.tv_weight, tv_inner=o.tv_inner, x0=o.x0,
            oversample=o.oversample, **o.kernel_options_dict())
    from repro_torch.runtime.solvers import solve
    vol, _report = solve(
        projections, geom, method, n_iters=o.n_iters, relax=o.relax,
        x0=o.x0, tv_weight=o.tv_weight, tv_inner=o.tv_inner,
        oversample=o.oversample, variant=o.variant, nb=o.nb,
        interpret=o.interpret, proj_batch=o.proj_batch,
        schedule=o.schedule, precision=o.precision, tuning=o.tuning,
        device=device, **o.kernel_options_dict())
    return vol
