"""Performance-portability autotuner: measured per-hardware config search.

The paper's central claim is that its back-projection kernels are
*performance portable*, and its own Table 4 shows the winning (variant,
loop order, blocking) choice differs per machine. Everywhere else the
planner resolves its knobs (variant fallback, ``schedule``,
``proj_loop``, ``pipeline``, tile/chunk sizes) from static heuristics.
This module *measures* instead of guessing. It is the port of the JAX
package's ``runtime/autotune.py``, with the same search, the same
``TunedConfig`` fields and the same cache file format:

  * :func:`autotune`: given a request (the same façade options every
    entry point takes), enumerate the candidate configuration space and
    time each candidate on the device with warm
    :class:`~repro_torch.runtime.executor.ProgramCache` programs (the
    programs are built and a warm-up call runs outside the timed region;
    the median of ``iters`` timed calls inside), under a wall-clock
    search budget. The search is a greedy per-axis sweep: the variant
    ladder, ``KernelSpec.tuning_space`` options (``proj_loop`` on/off:
    K2/K4/K6 against K1/K3/K5 on the card), tile and projection-chunk
    candidates pruned by ``core.tiling.tile_working_set_bytes``,
    ``schedule`` "step"/"chunk", ``precision`` "f32"/"bf16", and
    ``pipeline`` "sync"/"async" with depths. The heuristic config is
    ALWAYS measured first, outside the budget, so any budget leaves a
    valid winner and the search proper gets the whole budget.
  * :class:`TunedConfig`: the resolved winner, every knob an executor
    needs, JSON-serializable (``PlanExecutor.from_config`` runs it).
  * :class:`TuningCache`: winners persist on disk (JSON under
    ``~/.cache/repro_torch/tuning.json``, or ``$REPRO_TORCH_TUNING_CACHE``,
    or any path), keyed by a hardware fingerprint x the request's
    ``ReconPlan.bucket_key``. A second process on the same machine
    resolves the same winner with ZERO measurements; another machine
    (fingerprint mismatch) re-tunes. Missing or corrupt cache files
    degrade to the heuristics, never to an error. An entry older than
    ``revalidate_s`` costs one heuristic-baseline probe on resolve and is
    re-tuned when the probe drifted beyond :data:`DRIFT_RATIO`.
  * :func:`resolve_config` / :func:`resolve_plan`: the LOOKUP-ONLY path
    of ``plan_reconstruction(variant="auto")``, ``fdk_reconstruct``, the
    solvers' ``solve`` and ``reconstruct``: a hit returns the tuned
    config, a miss today's heuristics. Measurement only ever happens
    inside :func:`autotune`.

Where the port departs from the JAX package, and why:

  * the fingerprint names the device it resolves for:
    ``("cuda", "<card name> sm_<major><minor>", cpu count, torch
    version)`` on a card, ``("cpu", machine, cpu count, torch version)``
    on the CPU. ``autotune``, ``resolve_config`` and ``resolve_plan``
    take that ``device`` (``None`` = the card, which raises without one);
  * its own default cache path: the cache's locks are per process and
    per package, so two packages writing one file could lose writes. The
    format is the JAX package's, so either package reads the other's
    file; the fingerprints keep the entries apart;
  * on a card the ladder puts the three CUDA variants first (the
    strongest up front, so an exhausted budget still leaves a good
    winner; on the CPU the plain variants are the strong ones), and the
    ladder's head is the heuristic base of ``variant="auto"``: untuned,
    "auto" runs ``subline_pl`` (a CUDA kernel) on a card and
    ``algorithm1_mp`` on the CPU, where plans and keys equal the JAX
    package's;
  * ``budget_s`` starts after the heuristic baseline's measurement: a
    slow base (a plain variant on the card, seconds a call) must not
    spend the whole budget before the first candidate;
  * a candidate that the planner refuses (``ValueError``) is skipped,
    while anything else it raises (a kernel that does not build or
    launch, a CUDA error) fails the search instead of handing the win
    to another variant;
  * the request-batch axis offers rb in (1, 2, 4, 8) on step-major plans
    and is measured amortized (one ``execute_batch`` of rb copies, wall /
    rb), as in the JAX package.

Exactness contract
------------------
The searched knobs split into two classes:

  * **order-only knobs**: ``schedule`` ("step"/"chunk" walk the same
    chunk grid in the same per-voxel addition order) and ``pipeline`` /
    ``pipeline_depth`` (the async flusher only moves WHEN host adds
    happen, never their order). Tuning these is bit-identical to the
    heuristic config by construction.
  * **numeric knobs**: ``variant``, ``proj_loop``, tile shape, chunk
    size, precision. These change float-op order; parity is at
    tolerance, not bit level.

``autotune(..., exact=True)``, the default whenever the caller names a
variant, searches only order-only knobs, so the tuned output is
bit-identical to the heuristic config. ``variant="auto"`` (or
``exact=False``) widens to the full space. An "auto" winner (which may
carry a different variant) is never resolved by an explicitly named
variant's request (:func:`request_key`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import platform
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.tiling import tile_working_set_bytes
from repro_torch.core.variants import REGISTRY, get_spec
from repro_torch.runtime import telemetry

# measurement priority for variant="auto": the strongest heuristics up
# front, so early budget exhaustion still leaves a good winner. On the
# CPU that is the plain ladder (the JAX package's order: the CUDA
# variants run their plain versions there); on a card it is the CUDA
# kernels. The head is also "auto"'s heuristic base (_auto_base).
_LADDER = ("algorithm1_mp", "symmetry_mp", "subline_batch_mp",
           "subline_mp", "share_mp", "transpose_mp",
           "subline_pl", "onehot_pl", "banded_pl")
_LADDER_CUDA = ("subline_pl", "onehot_pl", "banded_pl",
                "algorithm1_mp", "symmetry_mp", "subline_batch_mp",
                "subline_mp", "share_mp", "transpose_mp")

# cache self-maintenance: a resolved entry older than ``revalidate_s``
# gets ONE cheap heuristic-baseline probe; a probe/recorded-baseline
# ratio beyond DRIFT_RATIO (either direction) invalidates the entry and
# re-runs the search.
DRIFT_RATIO = 2.0


def _ladder(device: torch.device) -> Tuple[str, ...]:
    return _LADDER_CUDA if device.type == "cuda" else _LADDER


def _auto_base(device: torch.device) -> str:
    """The variant ``variant="auto"`` plans without a tuned winner."""
    return _ladder(device)[0]


# --------------------------------------------------------------------------
# Hardware fingerprint
# --------------------------------------------------------------------------

def hardware_fingerprint(device=None) -> Tuple[str, str, int, str]:
    """(backend, device kind, cpu count, torch version) of ``device``
    in THIS process (``None`` = the CUDA card).

    The tuple every cached winner is scoped to: a measured choice is
    only trusted on hardware indistinguishable under this key; any
    mismatch re-tunes rather than importing another machine's winner.
    """
    dev = resolve_device(device)
    cpus = int(os.cpu_count() or 1)
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        major, minor = torch.cuda.get_device_capability(idx)
        kind = f"{torch.cuda.get_device_name(idx)} sm_{major}{minor}"
        return ("cuda", kind, cpus, str(torch.__version__))
    return ("cpu", platform.machine(), cpus, str(torch.__version__))


def fingerprint_key(fp: Optional[Tuple] = None, device=None) -> str:
    """Flat string form of the fingerprint (the JSON cache's outer key);
    ``fp=None`` takes ``device``'s."""
    return "|".join(str(p) for p in (hardware_fingerprint(device)
                                     if fp is None else fp))


def _scope(variant) -> str:
    """Key namespace of a request: "auto" when the tuner may switch
    variants, "explicit" when the caller named one."""
    return "auto" if variant in (None, "auto") else "explicit"


def request_key(base_plan, scope: str = "explicit") -> str:
    """Stable identity of one request SHAPE: the heuristic base plan's
    ``bucket_key``, rendered with ``repr`` (scalars and short tuples
    only, so the string is deterministic across processes and equal to
    the JAX package's for the same request). ``scope`` ("auto" |
    "explicit", see :func:`_scope`) keeps the two request kinds apart:
    a ``variant="auto"`` winner may carry a DIFFERENT variant than the
    base plan's, and an explicitly named variant must never resolve it."""
    return f"{scope}|{base_plan.bucket_key!r}"


# --------------------------------------------------------------------------
# TunedConfig: one fully resolved configuration
# --------------------------------------------------------------------------

def _tupleize(v):
    """JSON round-trip repair: lists back to tuples (plan options and
    tile shapes must stay hashable: they sit inside bucket keys)."""
    if isinstance(v, list):
        return tuple(_tupleize(x) for x in v)
    return v


@dataclasses.dataclass(frozen=True)
class TunedConfig:
    """Every knob one reconstruction execution needs, fully resolved.

    Self-contained: ``build_plan(geom)`` re-plans it and
    ``PlanExecutor.from_config`` runs it. ``wall_us``/``baseline_us``
    record the measured winner and heuristic medians (for a solver: per
    iteration); ``source`` says where the config came from ("measured":
    this process timed it, "cache": a persisted winner, "heuristic": no
    tuning information) and ``trials`` how many candidates were measured
    (0 on a cache hit).
    """

    variant: str
    schedule: str                       # "step" | "chunk"
    pipeline: str                       # "sync" | "async"
    pipeline_depth: int
    tile_shape: Tuple[int, int, int]
    proj_batch: Optional[int]           # None = single chunk
    nb: int
    out: str                            # "host" | "device"
    interpret: bool
    options: Tuple[Tuple[str, object], ...] = ()
    # cross-request batch cap (the serving tier's rb); 1 until request
    # batching is ported
    max_batch: int = 1
    # numeric-precision data path: "f32" | "bf16", a tolerance-contract
    # knob searched only in the wide space
    precision: str = "f32"
    # iterative-solver family ("none" = plain FDK); solver winners are
    # measured on AMORTIZED per-iteration wall (see _measure_solver)
    solver: str = "none"
    wall_us: float = 0.0
    baseline_us: float = 0.0
    source: str = "heuristic"           # "measured" | "cache" | "heuristic"
    trials: int = 0
    # wall-clock stamp (time.time()) of the measurement that produced or
    # last revalidated this entry; files without it read as 0.0, always
    # stale
    tuned_at: float = 0.0

    @property
    def key(self) -> Tuple:
        """Knob identity (measurement/bookkeeping fields excluded)."""
        return (self.variant, self.schedule, self.pipeline,
                self.pipeline_depth, self.tile_shape, self.proj_batch,
                self.nb, self.out, self.interpret, self.options,
                self.max_batch, self.precision, self.solver)

    @property
    def speedup(self) -> float:
        """Measured heuristic/tuned wall ratio (>1 = tuning helped)."""
        return self.baseline_us / self.wall_us if self.wall_us else 1.0

    def build_plan(self, geom):
        """Re-plan this config (pure: the normal planner path)."""
        from repro_torch.runtime.planner import plan_reconstruction
        return plan_reconstruction(
            geom, self.variant, tile_shape=self.tile_shape, nb=self.nb,
            proj_batch=self.proj_batch, out=self.out,
            interpret=self.interpret, schedule=self.schedule,
            request_batch=self.max_batch, precision=self.precision,
            solver=self.solver, **dict(self.options))

    def to_json(self) -> Dict:
        doc = dataclasses.asdict(self)
        doc["options"] = [list(kv) for kv in self.options]
        doc["tile_shape"] = list(self.tile_shape)
        return doc

    @classmethod
    def from_json(cls, doc: Dict) -> "TunedConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in doc.items() if k in fields}
        kw["tile_shape"] = tuple(int(v) for v in doc["tile_shape"])
        kw["options"] = tuple(
            (str(k), _tupleize(v)) for k, v in doc.get("options", []))
        pb = doc.get("proj_batch")
        kw["proj_batch"] = None if pb is None else int(pb)
        kw["max_batch"] = int(doc.get("max_batch", 1))
        return cls(**kw)


def config_from_plan(plan, *, pipeline: str = "sync",
                     pipeline_depth: int = 2,
                     source: str = "heuristic") -> TunedConfig:
    """Snapshot a planned request as a :class:`TunedConfig` (the
    heuristic baseline every search starts from)."""
    return TunedConfig(
        variant=plan.variant, schedule=plan.schedule, pipeline=pipeline,
        pipeline_depth=int(pipeline_depth), tile_shape=plan.tile_shape,
        proj_batch=(plan.chunk_size if plan.streams_projections else None),
        nb=plan.nb, out=plan.out, interpret=plan.interpret,
        options=plan.options, source=source,
        max_batch=int(plan.request_batch), precision=plan.precision,
        solver=plan.solver)


# --------------------------------------------------------------------------
# TuningCache: persistent fingerprint-keyed winners
# --------------------------------------------------------------------------

def default_cache_path() -> str:
    """``$REPRO_TORCH_TUNING_CACHE`` if set, else
    ``~/.cache/repro_torch/tuning.json``."""
    env = os.environ.get("REPRO_TORCH_TUNING_CACHE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "tuning.json")


# one lock per cache PATH, process-wide: distinct TuningCache instances
# over the same file (as_tuning_cache builds one per call) must still
# serialize their read-modify-write cycles
_PATH_LOCKS: Dict[str, threading.Lock] = {}
_PATH_LOCKS_GUARD = threading.Lock()


def _path_lock(path: str) -> threading.Lock:
    key = os.path.abspath(path)
    with _PATH_LOCKS_GUARD:
        return _PATH_LOCKS.setdefault(key, threading.Lock())


# parsed-document memo keyed on (mtime_ns, size): every tuned resolve
# goes through lookup(), and the file only changes when a tuner stores a
# winner. Entries are treated as READ-ONLY by lookup().
_DOC_CACHE: Dict[str, Tuple[Tuple[int, int], Dict]] = {}
_DOC_CACHE_GUARD = threading.Lock()


class TuningCache:
    """On-disk JSON store of measured winners.

    Layout: ``{"version": 1, "fingerprints": {<fp>: {<request_key>:
    <TunedConfig doc>}}}``, the JAX package's. Reads are tolerant by
    design: a missing file, unreadable JSON, a wrong version, or a
    malformed entry all behave as a cache miss (the caller falls back to
    heuristics), never as an error. Writes are read-modify-write under a
    process-wide per-PATH lock with an atomic ``os.replace``, so
    concurrent tuners within one process never clobber each other's
    entries. Across PROCESSES the last writer wins for the load->replace
    window; the worst case is a just-stored entry dropping out, which
    costs one re-tune, never corruption.
    """

    VERSION = 1

    def __init__(self, path: Optional[str] = None):
        self.path = str(path) if path is not None else default_cache_path()
        self._lock = _path_lock(self.path)

    # ---- tolerant IO -----------------------------------------------------

    def _load(self, memo: bool = True) -> Dict:
        """Parse the cache file (tolerantly). ``memo=True`` (the lookup
        path) serves the parsed doc from the (mtime, size)-stamped memo
        when the file is unchanged; the doc is shared read-only, so
        writers must pass ``memo=False`` for a private copy."""
        empty = {"version": self.VERSION, "fingerprints": {}}
        key = os.path.abspath(self.path)
        try:
            st = os.stat(self.path)
            stamp = (st.st_mtime_ns, st.st_size)
        except OSError:
            return empty
        if memo:
            with _DOC_CACHE_GUARD:
                hit = _DOC_CACHE.get(key)
            if hit is not None and hit[0] == stamp:
                return hit[1]
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return empty
        except (OSError, ValueError, UnicodeDecodeError):
            return empty    # corrupt cache == no cache, never an error
        if (not isinstance(doc, dict) or doc.get("version") != self.VERSION
                or not isinstance(doc.get("fingerprints"), dict)):
            return empty
        if memo:
            with _DOC_CACHE_GUARD:
                _DOC_CACHE[key] = (stamp, doc)
        return doc

    def lookup(self, fp_key: str, req_key: str) -> Optional[TunedConfig]:
        """The persisted winner for (hardware, request shape), or None."""
        entry = self._load()["fingerprints"].get(fp_key, {}).get(req_key)
        if entry is None:
            return None
        try:
            return TunedConfig.from_json(entry)
        except (KeyError, TypeError, ValueError):
            return None     # malformed entry == miss

    def _write(self, doc: Dict) -> None:
        """Atomic write + memo refresh (call holding ``self._lock``)."""
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        os.replace(tmp, self.path)
        try:
            st = os.stat(self.path)
            with _DOC_CACHE_GUARD:
                _DOC_CACHE[os.path.abspath(self.path)] = \
                    ((st.st_mtime_ns, st.st_size), doc)
        except OSError:
            pass

    def store(self, fp_key: str, req_key: str, config: TunedConfig) -> None:
        with self._lock:
            doc = self._load(memo=False)   # private copy: mutated below
            doc["fingerprints"].setdefault(fp_key, {})[req_key] = \
                config.to_json()
            self._write(doc)

    def invalidate(self, fp_key: str, req_key: str) -> bool:
        """Drop one persisted winner (the self-maintenance path).
        Returns whether an entry was removed."""
        with self._lock:
            doc = self._load(memo=False)
            bucket = doc["fingerprints"].get(fp_key)
            if not bucket or req_key not in bucket:
                return False
            del bucket[req_key]
            if not bucket:
                del doc["fingerprints"][fp_key]
            self._write(doc)
            return True

    def entries(self) -> Dict[str, Dict[str, Dict]]:
        """Raw {fingerprint: {request_key: config doc}} view,
        READ-ONLY (may be the shared memoized document)."""
        return self._load()["fingerprints"]

    def __len__(self) -> int:
        return sum(len(v) for v in self.entries().values())


def default_tuning_cache() -> TuningCache:
    """Cache at the default path (env resolved at construction)."""
    return TuningCache()


def as_tuning_cache(obj) -> TuningCache:
    """Coerce a façade ``tuning=`` argument: a :class:`TuningCache`,
    a filesystem path, or None (the default cache)."""
    if isinstance(obj, TuningCache):
        return obj
    if obj is None:
        return default_tuning_cache()
    return TuningCache(os.fspath(obj))


# --------------------------------------------------------------------------
# Heuristic baseline + lookup-only resolution
# --------------------------------------------------------------------------

def _base_kernel_options(variant, kernel_options: Dict,
                         base: str) -> Dict:
    """Kernel options for the heuristic BASE plan.

    An "auto" request may carry options for variants other than the
    default the base plan is built with (e.g. ``proj_loop`` for the CUDA
    candidates): validate them against the WHOLE registry (a typo still
    fails fast), then filter to what the base variant accepts.
    Explicit-variant requests pass through untouched (the planner
    validates them as usual)."""
    if variant not in (None, "auto"):
        return dict(kernel_options)
    known = {"nb", "interpret"}
    for spec in REGISTRY.values():
        known |= set(spec.options)
    unknown = set(kernel_options) - known
    if unknown:
        raise ValueError(
            f"variant='auto' got option(s) {sorted(unknown)} accepted "
            f"by no registered variant")
    allowed = get_spec(base).options
    return {k: v for k, v in kernel_options.items() if k in allowed}


def _request_key(variant, base_plan, kernel_options: Dict) -> str:
    """Full cache key for one request. "auto" requests append the raw
    caller options: the base plan drops the cross-variant ones, and two
    auto requests differing only there must not collide."""
    key = request_key(base_plan, _scope(variant))
    if variant in (None, "auto") and kernel_options:
        key += f"|opts={tuple(sorted(kernel_options.items()))!r}"
    return key


def _heuristic_config(geom, variant="auto", *, device, nb=8,
                      interpret=True, tiling=None, memory_budget=None,
                      proj_batch=None, out=None, schedule=None,
                      precision="f32", solver="none", **kernel_options):
    """(heuristic TunedConfig, its base plan) for one façade request on
    ``device``: exactly what every entry point runs without tuning."""
    from repro_torch.core.fdk import _build_plan
    base = _auto_base(torch.device(device))
    name = base if variant in (None, "auto") else variant
    plan = _build_plan(geom, name, nb=nb, interpret=interpret,
                       tiling=tiling, memory_budget=memory_budget,
                       proj_batch=proj_batch, out=out, schedule=schedule,
                       precision=precision, solver=solver,
                       **_base_kernel_options(variant, kernel_options, base))
    return config_from_plan(plan), plan


def resolve_config(geom, variant: str = "auto", *, cache=None,
                   device=None, **request) -> TunedConfig:
    """LOOKUP-ONLY config resolution (never measures): the persisted
    winner for this (``device``'s fingerprint, request shape) if one
    exists (``source == "cache"``), today's heuristics otherwise
    (``source == "heuristic"``). ``request`` takes the façade options
    (``nb``/``tiling``/``memory_budget``/``proj_batch``/``out``/
    ``schedule``/``precision``/``solver``/kernel options)."""
    cache = as_tuning_cache(cache)
    dev = resolve_device(device)
    base_cfg, base_plan = _heuristic_config(geom, variant, device=dev,
                                            **request)
    extra = {k: v for k, v in request.items()
             if k not in ("nb", "interpret", "tiling", "memory_budget",
                          "proj_batch", "out", "schedule", "precision",
                          "solver")}
    hit = cache.lookup(fingerprint_key(device=dev),
                       _request_key(variant, base_plan, extra))
    if hit is not None:
        return dataclasses.replace(hit, source="cache", trials=0)
    return base_cfg


def resolve_plan(geom, *, variant="auto", tuning=None, tile_shape=None,
                 memory_budget=None, nb=8, proj_batch=None, out="host",
                 interpret=True, schedule=None, request_batch=1,
                 precision="f32", solver="none", device=None,
                 **kernel_options):
    """Planner-level twin of :func:`resolve_config` (planner argument
    conventions; returns the plan only). This is what
    ``plan_reconstruction(variant="auto" / tuning=...)`` delegates to.
    The caller's ``request_batch`` overrides a cached winner's
    ``max_batch`` on the returned plan."""
    from repro_torch.runtime.planner import plan_reconstruction
    cache = as_tuning_cache(tuning)
    dev = resolve_device(device)
    head = _auto_base(dev)
    name = head if variant in (None, "auto") else variant
    base = plan_reconstruction(
        geom, name, tile_shape=tile_shape, memory_budget=memory_budget,
        nb=nb, proj_batch=proj_batch, out=out, interpret=interpret,
        schedule=schedule, request_batch=request_batch,
        precision=precision, solver=solver,
        **_base_kernel_options(variant, kernel_options, head))
    hit = cache.lookup(fingerprint_key(device=dev),
                       _request_key(variant, base, kernel_options))
    if hit is None:
        return base
    return hit.build_plan(geom).batched(int(request_batch))


# --------------------------------------------------------------------------
# Measurement
# --------------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _median_wall(run, device: torch.device, iters: int, warmup: int) -> float:
    """Median host-clock seconds of ``run()`` over ``iters`` timed calls
    after ``warmup`` untimed ones, each ending in a device synchronize:
    the user waits for the whole call, launches and host work included."""
    for _ in range(int(warmup)):
        run()
        _sync(device)
    times = []
    for _ in range(max(1, int(iters))):
        t0 = time.perf_counter()
        run()
        _sync(device)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def _measure_config(geom, config: TunedConfig, projections,
                    program_cache, *, iters: int = 3,
                    warmup: int = 1, device=None) -> float:
    """Median wall seconds of one full ``reconstruct`` under ``config``.

    Programs are built via ``PlanExecutor.warm`` BEFORE the timed region
    (the cache makes repeat candidates nearly free), then ``warmup``
    untimed calls absorb first-call effects (a CUDA kernel's first launch
    loads its module) and the median of ``iters`` timed calls is
    returned.

    ``config.max_batch > 1`` measures the batched path: one
    ``execute_batch`` of max_batch copies of the projections (one lane
    launch per step and chunk), returning wall / max_batch, the amortized
    time a request, comparable with the unbatched candidates.
    """
    from repro_torch.runtime.executor import PlanExecutor
    ex = PlanExecutor.from_config(geom, config, cache=program_cache,
                                  device=device)
    ex.warm()
    rb = max(1, int(config.max_batch))
    if rb == 1:
        return _median_wall(lambda: ex.reconstruct(projections), ex.device,
                            iters, warmup)
    if not ex.supports_request_batching:
        raise ValueError("config cannot batch (chunk-major plan)")
    ex.warm_batch(rb)
    reqs = [projections] * rb
    return _median_wall(lambda: ex.execute_batch(reqs), ex.device, iters,
                        warmup) / rb


def _measure_solver(geom, config: TunedConfig, projections,
                    program_cache, *, iters_per_solve: int = 3,
                    warmup: int = 1, device=None) -> float:
    """Median AMORTIZED wall seconds per solver ITERATION under
    ``config`` (``config.solver`` names the method).

    Programs + normalizers are paid via ``IterativeExecutor.warm`` before
    the timed region: a deployment multiplies the warm per-iteration
    cost, not the one-time setup. Each timed sample runs a short
    ``iters_per_solve``-iteration solve and bills wall / iters_per_solve.
    """
    from repro_torch.runtime.solvers import IterativeExecutor
    ex = IterativeExecutor(geom, config.build_plan(geom),
                           cache=program_cache, device=device)
    ex.warm()
    k = max(1, int(iters_per_solve))
    wall = _median_wall(lambda: ex.solve(projections, n_iters=k),
                        ex.device, 3, warmup)
    return wall / k


# --------------------------------------------------------------------------
# Candidate axes (greedy per-axis sweep)
# --------------------------------------------------------------------------

def _fits_budget(tile, geom, nb: int, variant: str,
                 memory_budget: Optional[int]) -> bool:
    """Prune a tile candidate with the SAME working-set model the
    planner's auto-picker uses (mirror-paired slabs billed at their
    virtual 2*tk depth)."""
    if memory_budget is None:
        return True
    ti, tj, tk = tile
    nz = geom.volume_shape_xyz[2]
    eff = min(2 * tk, nz) if (get_spec(variant).uses_symmetry
                              and tk < nz) else tk
    ws = tile_working_set_bytes((ti, tj, eff), (geom.nw, geom.nh), nb=nb)
    return ws <= int(memory_budget)


def _variant_axis(cur: TunedConfig, requested: str, kernel_options: Dict,
                  ladder: Sequence[str] = _LADDER) -> List[TunedConfig]:
    if requested not in (None, "auto"):
        return []
    out = []
    for name in ladder:
        if name == cur.variant:
            continue
        spec = get_spec(name)
        if spec.backend == "reference":
            continue
        opts = spec.resolve_options(dict(kernel_options))
        if spec.proj_loop and "proj_loop" not in opts:
            # mirror the planner's default so the candidate's key
            # matches the plan it measures (else _option_axis would
            # re-measure the identical plan under a second key)
            opts["proj_loop"] = True
        out.append(dataclasses.replace(
            cur, variant=name, options=tuple(sorted(opts.items()))))
    return out


def _option_axis(cur: TunedConfig) -> List[TunedConfig]:
    """Flip each KernelSpec-advertised tuning option (e.g. proj_loop)."""
    spec = get_spec(cur.variant)
    have = dict(cur.options)
    out = []
    for name, values in spec.tuning_space:
        for v in values:
            if have.get(name) == v:
                continue
            opts = dict(have)
            opts[name] = v
            out.append(dataclasses.replace(
                cur, options=tuple(sorted(opts.items()))))
    return out


def _tile_axis(geom, cur: TunedConfig,
               memory_budget: Optional[int]) -> List[TunedConfig]:
    nx, ny, nz = geom.volume_shape_xyz
    ti, tj, tk = cur.tile_shape
    cands = [(nx, ny, nz),                                   # untiled
             (max(1, ti // 2), max(1, tj // 2), tk),         # finer (i, j)
             (max(1, ti // 2), max(1, tj // 2), max(1, tk // 2))]
    out = []
    for tile in cands:
        if tile == cur.tile_shape:
            continue
        if not _fits_budget(tile, geom, cur.nb, cur.variant, memory_budget):
            continue
        out.append(dataclasses.replace(cur, tile_shape=tile))
    return out


def _chunk_axis(geom, cur: TunedConfig,
                memory_budget: Optional[int]) -> List[TunedConfig]:
    nb = cur.nb
    n_pad = -(-int(geom.n_proj) // nb) * nb
    cands = {None}
    half = -(-(n_pad // 2) // nb) * nb
    if nb <= half < n_pad:
        cands.add(half)
    if nb < n_pad:
        cands.add(nb)
    if memory_budget is not None:
        # an explicit budget is the caller's device-byte contract and
        # the chunk bound is part of it: never offer a LARGER chunk
        cap = cur.proj_batch if cur.proj_batch is not None else n_pad
        cands = {pb for pb in cands if pb is not None and pb <= cap}
    out = []
    for pb in sorted(cands, key=lambda v: -1 if v is None else v):
        if pb == cur.proj_batch:
            continue
        out.append(dataclasses.replace(cur, proj_batch=pb))
    return out


def _schedule_axis(cur: TunedConfig, memory_budget: Optional[int],
                   pinned: Optional[str] = None) -> List[TunedConfig]:
    # a schedule the caller NAMED is a contract, so the tuner never
    # offers the other one (``pinned``); an explicit memory_budget is the
    # caller's device-byte contract, which only the chunk-major loop
    # honors (the step-major walk stacks the whole filtered set on the
    # device): do not offer "step"
    if pinned is not None:
        return []
    allowed = ("chunk",) if memory_budget is not None else ("step", "chunk")
    return [dataclasses.replace(cur, schedule=s)
            for s in allowed if s != cur.schedule]


def _batch_axis(cur: TunedConfig) -> List[TunedConfig]:
    """Cross-request batch cap candidates (the service's rb sweet spot):
    rb in (1, 2, 4, 8) on step-major plans, as in the JAX package. Each
    lane is bit-identical to the request alone, so the axis is searched
    in exact mode too; candidates are measured amortized
    (:func:`_measure_config`)."""
    if cur.schedule != "step":
        return []
    return [dataclasses.replace(cur, max_batch=rb)
            for rb in (1, 2, 4, 8) if rb != cur.max_batch]


def _precision_axis(cur: TunedConfig) -> List[TunedConfig]:
    """Flip the reduced-precision data path (bf16 samples / f32
    accumulators): a tolerance-contract knob like ``variant``, only
    offered in the wide (non-exact) search."""
    return [dataclasses.replace(cur, precision=p)
            for p in ("f32", "bf16") if p != cur.precision]


def _pipeline_axis(cur: TunedConfig) -> List[TunedConfig]:
    if cur.out != "host":
        return []    # the flush pipeline only exists for host placement
    combos = (("sync", 2), ("async", 2), ("async", 4))
    return [dataclasses.replace(cur, pipeline=p, pipeline_depth=d)
            for p, d in combos
            if (p, d) != (cur.pipeline, cur.pipeline_depth)]


def _plannable(geom, cfg: TunedConfig) -> bool:
    """Whether the planner accepts ``cfg``. A candidate it refuses
    (``ValueError``) is skipped; anything else a candidate raises (a
    kernel that does not build or launch) fails the search."""
    try:
        cfg.build_plan(geom)
    except ValueError:
        return False
    return True


# --------------------------------------------------------------------------
# The tuner
# --------------------------------------------------------------------------

def autotune(geom, variant: str = "auto", *, method: str = "fdk",
             nb: int = 8,
             interpret: bool = True, tiling=None,
             memory_budget: Optional[int] = None,
             proj_batch: Optional[int] = None, out: Optional[str] = None,
             schedule: Optional[str] = None, precision: str = "f32",
             budget_s: float = 20.0, iters: int = 3, warmup: int = 1,
             exact: Optional[bool] = None,
             variants: Optional[Sequence[str]] = None,
             cache=None, force: bool = False, projections=None,
             program_cache=None, revalidate_s: float = 3600.0,
             device=None, **kernel_options) -> TunedConfig:
    """Measured configuration search for one request shape on
    ``device`` (``None`` = the CUDA card, which raises without one).

    Returns the winning :class:`TunedConfig` and persists it in the
    :class:`TuningCache` (``cache``: a TuningCache, a path, or None for
    the default). A persisted winner for this (hardware fingerprint,
    request ``bucket_key``) short-circuits the search unless
    ``force=True``: the returned config then has ``source == "cache"``
    and ``trials == 0``.

    ``budget_s`` bounds the SEARCH wall clock: the heuristic baseline is
    always measured, outside the budget, then greedy per-axis candidates
    are measured in priority order until the budget is spent. ``exact``
    (default: True for an explicitly requested variant, False for
    ``variant="auto"``) restricts the search to the order-only knobs (``schedule``/
    ``pipeline``) whose output is bit-identical to the heuristic config;
    the wide space adds variant, KernelSpec ``tuning_space`` options,
    working-set-pruned tile/chunk candidates and precision (``variants``
    optionally restricts the ladder). ``projections`` supplies the
    measurement input (default: ``np.random.RandomState(0).rand`` of the
    geometry's shape, made on the device); ``program_cache`` shares
    programs with the caller.

    ``method`` widens the tuner beyond FDK: a solver method ("sart" /
    "os_sart" / "cgls" / "fista_tv") measures the AMORTIZED
    per-iteration wall of a short warm solve (:func:`_measure_solver`)
    and searches subset count (the ``proj_batch`` chunk axis), precision
    and the order-only ``schedule``. Solver winners persist under their
    own request keys (``solver`` sits in ``bucket_key``).

    The cache is SELF-MAINTAINING: a hit younger than ``revalidate_s``
    resolves with zero measurement; an older hit pays ONE heuristic
    baseline probe and is restamped when the probe lands within
    :data:`DRIFT_RATIO` of its recorded baseline, else invalidated and
    searched again.
    """
    dev = resolve_device(device)
    solver = "none" if method == "fdk" else method
    if method not in ("fdk", "sart", "os_sart", "cgls", "fista_tv"):
        raise ValueError(
            f"method must be 'fdk' or a solver "
            f"('sart'|'os_sart'|'cgls'|'fista_tv'), got {method!r}")
    from repro_torch.runtime.executor import ProgramCache

    def _measure(cfg, projs, pc, *, m_iters, m_warmup):
        # solver methods optimize the AMORTIZED per-iteration wall, the
        # cost a real N-iteration deployment multiplies
        if solver == "none":
            return _measure_config(geom, cfg, projs, pc, iters=m_iters,
                                   warmup=m_warmup, device=dev)
        return _measure_solver(geom, cfg, projs, pc,
                               iters_per_solve=m_iters, warmup=m_warmup,
                               device=dev)

    def _synthetic():
        rng = np.random.RandomState(0)
        return torch.from_numpy(rng.rand(
            geom.n_proj, geom.nh, geom.nw).astype(np.float32)).to(dev)

    tcache = as_tuning_cache(cache)
    base_cfg, base_plan = _heuristic_config(
        geom, variant, device=dev, nb=nb, interpret=interpret,
        tiling=tiling, memory_budget=memory_budget, proj_batch=proj_batch,
        out=out, schedule=schedule, precision=precision, solver=solver,
        **kernel_options)
    fp = fingerprint_key(device=dev)
    rkey = _request_key(variant, base_plan, kernel_options)
    if not force:
        hit = tcache.lookup(fp, rkey)
        if hit is not None:
            age = time.time() - float(hit.tuned_at)
            if age <= float(revalidate_s) or hit.baseline_us <= 0.0:
                # fresh (or unvalidatable: no recorded baseline to
                # compare against): the zero-measurement fast path
                return dataclasses.replace(hit, source="cache", trials=0)
            # stale: one cheap baseline probe decides keep vs re-tune
            if projections is None:
                projections = _synthetic()
            if program_cache is None:
                program_cache = ProgramCache()
            probe_us = _measure(base_cfg, projections, program_cache,
                                m_iters=1, m_warmup=1) * 1e6
            if probe_us > 0.0:
                drift = max(probe_us / hit.baseline_us,
                            hit.baseline_us / probe_us)
                if drift <= DRIFT_RATIO:
                    # still believable: refresh the stamp only (the
                    # recorded baseline is kept, so slow drift cannot
                    # creep under the threshold)
                    tcache.store(fp, rkey, dataclasses.replace(
                        hit, tuned_at=time.time()))
                    return dataclasses.replace(hit, source="cache",
                                               trials=0)
            tcache.invalidate(fp, rkey)
            # fall through to the full search (which re-stores)

    if exact is None:
        # solver tuning is inherently non-exact: subset count changes
        # the ITERATION (OS-SART) and precision the data path
        exact = variant not in (None, "auto") and solver == "none"
    if projections is None:
        projections = _synthetic()
    pcache = program_cache if program_cache is not None else ProgramCache()

    measured: Dict[Tuple, float] = {}

    def timed(cfg: TunedConfig) -> float:
        if cfg.key not in measured:
            # one span per *measured* candidate (cache hits are free)
            with telemetry.span("autotune.candidate", cat="autotune",
                                variant=cfg.variant,
                                key=repr(cfg.key)) as sp:
                measured[cfg.key] = _measure(cfg, projections, pcache,
                                             m_iters=iters,
                                             m_warmup=warmup)
                sp.set(wall_us=measured[cfg.key] * 1e6)
        return measured[cfg.key]

    best = base_cfg
    best_t = baseline_t = timed(base_cfg)
    t_start = time.perf_counter()       # the budget is the search's

    axes = []
    if solver != "none":
        # subset count (the plan's projection chunking IS the ordered-
        # subset structure) x precision x the order-only schedule knob;
        # no pipeline or batch axis (device-resident volume, stateful
        # loop)
        axes.append(lambda c: _chunk_axis(geom, c, memory_budget))
        if not exact:
            axes.append(_precision_axis)
        axes.append(lambda c: _schedule_axis(c, memory_budget,
                                             pinned=schedule))
    else:
        if not exact:
            axes.append(lambda c: _variant_axis(c, variant, kernel_options,
                                                _ladder(dev)))
            axes.append(_option_axis)
            axes.append(lambda c: _tile_axis(geom, c, memory_budget))
            axes.append(lambda c: _chunk_axis(geom, c, memory_budget))
            axes.append(_precision_axis)
        axes.append(lambda c: _schedule_axis(c, memory_budget,
                                             pinned=schedule))
        axes.append(_pipeline_axis)
        axes.append(_batch_axis)

    for axis in axes:
        for cand in axis(best):
            if variants is not None and cand.variant != best.variant \
                    and cand.variant not in variants:
                continue
            if time.perf_counter() - t_start > float(budget_s):
                break
            if not _plannable(geom, cand):
                continue
            t = timed(cand)
            if t < best_t:
                best, best_t = cand, t

    # normalize options through a real plan (e.g. the planner's
    # proj_loop default) so the persisted config re-plans IDENTICALLY
    best = config_from_plan(
        best.build_plan(geom), pipeline=best.pipeline,
        pipeline_depth=best.pipeline_depth)
    winner = dataclasses.replace(
        best, wall_us=best_t * 1e6, baseline_us=baseline_t * 1e6,
        source="measured", trials=len(measured), tuned_at=time.time())
    tcache.store(fp, rkey, winner)
    # tuner-outcome trajectory: one record per full search, keyed by
    # fingerprint, so the portability claim is a tracked number
    telemetry.record_tuning({
        "fingerprint": fp, "bucket_key": rkey,
        "heuristic_wall": winner.baseline_us,
        "tuned_wall": winner.wall_us, "ratio": winner.speedup,
        "tuned_at": winner.tuned_at})
    return winner
