"""Reconstruction serving: shape-bucketed requests over the
plan/compile/execute core, on one card.

:class:`ReconService` takes reconstruction requests from any number of
threads and serves them from executors it keeps per shape bucket:

  * **shape bucketing**: every request (geometry + projections + façade
    options) is planned (pure, microseconds) and bucketed on ``(geometry,
    plan.bucket_key)``. The first request into a bucket builds its
    :class:`~repro_torch.runtime.executor.PlanExecutor` and every program
    the plan needs (``PlanExecutor.warm``); later same-shape requests
    build nothing.
  * **warmup**: ``warmup(geometries, **options)`` runs the same bucket
    creation without data, so a deployment pays every build before its
    first request; ``tune=True`` runs the measured autotuner per bucket
    first (``runtime.autotune``), and each bucket's stats row says
    whether its configuration was tuned or heuristic (``source``).
  * **async step pipeline**: bucket executors default to
    ``pipeline="async"`` (``runtime.executor._AsyncFlushQueue``), with
    output bit-identical to the sync flush.
  * **bounded, fair execution**: requests enter ONE FIFO queue drained by
    ``max_inflight`` worker threads, each on the service's device.
  * **request batching**: a :class:`_BatchFormer` between the queue and
    the workers coalesces up to ``max_batch`` SAME-bucket requests (mixed
    buckets never share a batch) into one ``PlanExecutor.execute_batch``:
    one rb-lane launch of the kernel per step and chunk serves them all.
    Forming is deadline and priority aware: a partial batch waits at most
    ``max_wait_ms`` for peers, never past a member's deadline headroom,
    and a ``priority > 0`` request ships at once. Every result is
    bit-identical to the request served alone. Chunk-major buckets run a
    formed batch one request after another.
  * **streaming sessions**: ``open_stream(geom, ...)`` returns a
    :class:`StreamSession`; views are pushed as the scanner produces them
    and each complete view chunk is folded
    (``runtime.executor.StreamingExecutor``). One stream worker folds the
    same chunk of up to ``max_batch`` concurrent same-bucket sessions with
    one lane launch per step (``ProgramCache.batch_program``).
    ``close()`` is bit-identical to the chunk-major reconstruction.
  * **introspection**: ``stats()`` returns a :class:`ServiceStats`
    snapshot: per-bucket requests, hits, builds, batches and their fill,
    stream overlap, and p50/p99 latency (submit to volume) streamed into
    each bucket's histogram as requests finish; ``export_prometheus()``
    renders it.

Telemetry: ``request.submit`` and ``stream.open`` instants, the
``batch.form``, ``service.dispatch`` and ``service.stream_dispatch``
spans, and one ``request.queue`` span a request, from its submit to its
dispatch, recorded by the worker that dispatches it
(``runtime.telemetry``).

Usage::

    from repro_torch.runtime.service import ReconService

    svc = ReconService(max_inflight=2, max_batch=4)   # on the card
    svc.warmup([geom], variant="subline_pl")          # build now
    fut = svc.submit(projections, geom, variant="subline_pl")
    vol = fut.result()                                # (nz, ny, nx)
    print(svc.stats())
    svc.close()

``repro_torch.reconstruct(..., service=svc)`` and ``fdk_reconstruct(...,
service=svc)`` route through the same buckets.

``ReconService(devices=...)`` places every bucket on a reconstruction
fleet (``PlanExecutor.execute_fleet``): each request's steps, and a formed
batch's lane steps (``ProgramCache.batch_fleet_program``), are spread over
the fleet's entries with stealing and failover, and each bucket's stats
row reports the fleet's width, steals, failovers and retired entries.
Solver requests and stream sessions are refused on a fleet service.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch._device import device_scope, resolve_device
from repro_torch.core.fdk import _build_plan
from repro_torch.core.geometry import CTGeometry
from repro_torch.runtime import telemetry
from repro_torch.runtime.executor import (
    FleetConfig, PlanExecutor, ProgramCache, _one_device_type,
    as_fleet_config, default_program_cache)
from repro_torch.runtime.planner import ReconPlan


# --------------------------------------------------------------------------
# Streamed latency accounting and stats snapshots
# --------------------------------------------------------------------------

# one log-2 histogram type for the whole runtime (runtime/telemetry.py);
# the serving-layer name is an alias
LatencyHistogram = telemetry.Histogram


@dataclasses.dataclass(frozen=True)
class BucketStats(telemetry.EmitMixin):
    """One shape bucket's counters at snapshot time.

    ``misses`` is 1 for every live bucket (its creation); ``hits`` are the
    requests that reused it; ``programs_built`` is how many programs its
    warm-up built (0 when another bucket already built the same keys).
    ``source`` says how the configuration was chosen: "heuristic",
    "tuned-measured" (this process ran the autotuner) or "tuned-cache" (a
    persisted winner); ``pipeline`` is its flush discipline.
    ``completed``/``p50_ms``/``p99_ms``/``mean_ms`` stream from the
    bucket's :class:`LatencyHistogram` of each request's latency, from
    its ``submit`` to its volume: the queue, the batch former and the
    dispatch.

    Batching: ``dispatches`` counts executor calls (a batch of k requests
    is ONE), so ``mean_occupancy`` = completed requests / dispatches is
    the realized fill; ``batch_p50_ms`` streams the batches' walls and
    ``amortized_us_per_request`` divides the summed execution wall over
    the completed requests. ``max_batch`` is the bucket's cap.

    Fleet placement (all zero on a single-device service): ``devices`` is
    the entry count of the bucket's last fleet run; ``steals``,
    ``failovers`` (re-run steps) and ``dead_devices`` (retired entries)
    sum the bucket executor's ``fleet_totals`` over its lifetime.

    Streaming: ``streams`` opened, ``streams_closed`` finished; one
    stream dispatch per folded chunk batch, ``stream_mean_lanes`` its
    fill; ``stream_tail_ms`` is the mean wall from the last view to the
    volume and ``stream_hidden_fraction`` the mean share of fold wall
    hidden behind acquisition, over closed sessions.
    """

    variant: str
    vol_shape_xyz: Tuple[int, int, int]
    n_proj: int
    schedule: str
    requests: int
    hits: int
    misses: int
    programs_built: int
    source: str = "heuristic"
    pipeline: str = "async"
    completed: int = 0
    p50_ms: Optional[float] = None
    p99_ms: Optional[float] = None
    mean_ms: Optional[float] = None
    dispatches: int = 0
    mean_occupancy: Optional[float] = None
    batch_p50_ms: Optional[float] = None
    amortized_us_per_request: Optional[float] = None
    max_batch: int = 1
    devices: int = 0
    steals: int = 0
    failovers: int = 0
    dead_devices: int = 0
    streams: int = 0
    streams_closed: int = 0
    stream_dispatches: int = 0
    stream_mean_lanes: Optional[float] = None
    stream_tail_ms: Optional[float] = None
    stream_hidden_fraction: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class ServiceStats(telemetry.EmitMixin):
    """Whole-service snapshot: totals, per-bucket rows and the program
    cache's stats. ``p50_ms``/``p99_ms`` merge the buckets' histograms
    (bin counts, not an average of quantiles)."""

    requests: int
    bucket_hits: int
    bucket_misses: int
    buckets: Tuple[BucketStats, ...]
    cache: Dict[str, int]
    max_inflight: int
    queued: int
    p50_ms: Optional[float] = None
    p99_ms: Optional[float] = None
    max_batch: int = 1
    dispatches: int = 0
    mean_occupancy: Optional[float] = None
    streams: int = 0
    stream_tail_ms: Optional[float] = None
    stream_hidden_fraction: Optional[float] = None

    @property
    def hit_rate(self) -> float:
        total = self.bucket_hits + self.bucket_misses
        return self.bucket_hits / total if total else 0.0

    def export_prometheus(self) -> str:
        """This snapshot as Prometheus text exposition (version 0.0.4):
        service totals unlabeled, per-bucket rows labeled ``{variant,
        schedule, source, vol, n_proj}``; an empty quantile is NaN."""
        rows = [
            ("repro_requests_total", "counter",
             "requests admitted via submit()", [({}, self.requests)]),
            ("repro_bucket_hits_total", "counter",
             "requests that reused a live bucket",
             [({}, self.bucket_hits)]),
            ("repro_bucket_misses_total", "counter",
             "buckets created", [({}, self.bucket_misses)]),
            ("repro_hit_rate", "gauge", "bucket hit rate",
             [({}, self.hit_rate)]),
            ("repro_queued", "gauge", "requests waiting in the former",
             [({}, self.queued)]),
            ("repro_dispatches_total", "counter",
             "executor dispatches (a formed batch is one)",
             [({}, self.dispatches)]),
            ("repro_mean_occupancy", "gauge",
             "completed requests per dispatch",
             [({}, self.mean_occupancy)]),
            ("repro_latency_p50_ms", "gauge",
             "request latency p50, submit to volume (merged histograms)",
             [({}, self.p50_ms)]),
            ("repro_latency_p99_ms", "gauge",
             "request latency p99, submit to volume (merged histograms)",
             [({}, self.p99_ms)]),
            ("repro_streams_total", "counter",
             "streaming sessions opened", [({}, self.streams)]),
            ("repro_stream_tail_ms", "gauge",
             "mean last-view-to-volume tail over closed sessions",
             [({}, self.stream_tail_ms)]),
            ("repro_stream_hidden_fraction", "gauge",
             "mean fold wall hidden behind acquisition",
             [({}, self.stream_hidden_fraction)]),
            ("repro_program_cache_hits_total", "counter",
             "program cache hits", [({}, self.cache.get("hits", 0))]),
            ("repro_program_cache_misses_total", "counter",
             "program cache misses (== programs built)",
             [({}, self.cache.get("misses", 0))]),
        ]

        def lab(b: BucketStats) -> Dict[str, object]:
            return {"variant": b.variant, "schedule": b.schedule,
                    "source": b.source,
                    "vol": "x".join(str(v) for v in b.vol_shape_xyz),
                    "n_proj": b.n_proj}

        bs = self.buckets
        rows += [
            ("repro_bucket_requests", "counter", "per-bucket requests",
             [(lab(b), b.requests) for b in bs]),
            ("repro_bucket_completed", "counter",
             "per-bucket completed requests",
             [(lab(b), b.completed) for b in bs]),
            ("repro_bucket_dispatches", "counter",
             "per-bucket executor dispatches",
             [(lab(b), b.dispatches) for b in bs]),
            ("repro_bucket_p50_ms", "gauge", "per-bucket latency p50",
             [(lab(b), b.p50_ms) for b in bs]),
            ("repro_bucket_p99_ms", "gauge", "per-bucket latency p99",
             [(lab(b), b.p99_ms) for b in bs]),
            ("repro_bucket_programs_built", "counter",
             "programs built by this bucket's warm-up",
             [(lab(b), b.programs_built) for b in bs]),
        ]
        return telemetry.prom_render(rows)


def _ms(seconds: Optional[float]) -> Optional[float]:
    return None if seconds is None else round(seconds * 1e3, 3)


# --------------------------------------------------------------------------
# Requests and the batch former
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _Request:
    """One queued reconstruction with its batching identity.

    ``key`` is ``(geometry, plan.bucket_key)``: any k requests with one
    key may share a batch (``request_batch`` is not in ``bucket_key``).
    ``deadline_s`` is an ABSOLUTE ``time.perf_counter`` deadline (None =
    none); ``priority > 0`` marks a latency-critical request that never
    waits for peers. ``solver_kw`` carries an iterative request's loop
    knobs; ``trace_id`` links the dispatch span back to the request.
    ``submit_s`` is the ``time.perf_counter`` of its ``submit``: its
    latency and its ``request.queue`` span count from there."""

    fut: Future
    projections: object
    geom: Optional[CTGeometry]
    plan: Optional[ReconPlan]
    config: object
    key: tuple
    deadline_s: Optional[float] = None
    priority: int = 0
    solver_kw: Optional[Dict] = None
    trace_id: str = ""
    submit_s: float = 0.0


@dataclasses.dataclass
class _StreamWork:
    """One READY view chunk of one open stream session, in the
    :class:`_BatchFormer` item contract (``key``/``priority``/
    ``deadline_s``): ``key`` is the session's bucket key PLUS the chunk
    index, so the former coalesces the same rotation phase of concurrent
    same-bucket sessions and never mixes phases."""

    session: "StreamSession"
    chunk: int
    key: tuple
    deadline_s: Optional[float] = None
    priority: int = 0


class _BatchFormer:
    """The coalescing stage between ``submit``'s FIFO queue and the
    workers.

    ``take`` pops the FIFO head: its bucket DEFINES the batch, and
    requests of other buckets are never pulled in (their order is kept).
    It gathers queued same-bucket requests up to the head's cap
    (``cap_fn``). A still-partial batch may wait for late peers, bounded
    by the TIGHTEST of ``max_wait_s`` and each member's deadline headroom
    less the bucket's running latency estimate (``est_fn``; while there
    is none, a member with a deadline never waits). A ``priority > 0``
    member ships the batch at once. With ``cap == 1`` or ``max_wait_s ==
    0`` and nothing queued this is exactly a FIFO queue.

    ``put``/``close`` are atomic with respect to each other, so a request
    either raises (closed) or is guaranteed a consumer: workers drain the
    queue before they honor the close. ``cap_fn``/``est_fn`` run under the
    former's condition and must not take a lock a ``put`` caller holds.
    ``clock`` is the time source of the waits (``time.perf_counter``).
    """

    def __init__(self, *, max_wait_s: float, cap_fn, est_fn=None,
                 clock=time.perf_counter):
        self._dq: "collections.deque" = collections.deque()
        self._cond = threading.Condition()
        self._closed = False
        self._cap_fn = cap_fn
        self._est_fn = est_fn if est_fn is not None else (lambda r: None)
        self._clock = clock
        self.max_wait_s = float(max_wait_s)

    def put(self, req) -> None:
        with self._cond:
            if self._closed:
                raise RuntimeError("ReconService is closed")
            self._dq.append(req)
            self._cond.notify_all()

    def qsize(self) -> int:
        with self._cond:
            return len(self._dq)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def _gather(self, batch: List, cap: int) -> None:
        """Pull queued same-bucket requests into ``batch`` in FIFO order
        (under the condition); other buckets keep their positions."""
        key = batch[0].key
        if len(batch) >= cap:
            return
        keep: "collections.deque" = collections.deque()
        while self._dq and len(batch) < cap:
            r = self._dq.popleft()
            if r.key == key:
                batch.append(r)
            else:
                keep.append(r)
        keep.extend(self._dq)
        self._dq = keep

    def _wait_limit(self, batch: List, t0: float) -> float:
        """The clock time until which this batch may keep waiting."""
        limit = t0 + self.max_wait_s
        est = self._est_fn(batch[0])
        for r in batch:
            if r.priority > 0:
                return t0            # latency-critical: ship now
            if r.deadline_s is not None:
                if est is None:
                    # no estimate yet (cold bucket): the headroom is
                    # unknown, so a member with a deadline never waits
                    return t0
                limit = min(limit, r.deadline_s - est)
        return limit

    def take(self) -> Optional[List]:
        """The next formed batch, or None when closed AND drained."""
        with self._cond:
            while not self._dq:
                if self._closed:
                    return None
                self._cond.wait(0.05)
            # the forming window is a span (not the idle wait for a head):
            # its duration is the wait for peers, its args the fill
            with telemetry.span("batch.form") as sp:
                batch = [self._dq.popleft()]
                cap = max(1, int(self._cap_fn(batch[0])))
                self._gather(batch, cap)
                if len(batch) >= cap or self.max_wait_s <= 0.0:
                    sp.set(k=len(batch), cap=cap, waited=False)
                    return batch
                t0 = self._clock()
                while len(batch) < cap and not self._closed:
                    now = self._clock()
                    limit = self._wait_limit(batch, t0)
                    if now >= limit:
                        break
                    self._cond.wait(min(0.01, limit - now))
                    self._gather(batch, cap)
                sp.set(k=len(batch), cap=cap, waited=True)
                return batch


class _Bucket:
    """A cached (geometry, plan) pair: its executor and counters (mutated
    under the service lock)."""

    def __init__(self, geom: CTGeometry, plan: ReconPlan, executor,
                 programs_built: int, config=None,
                 source: str = "heuristic"):
        self.geom = geom
        self.plan = plan
        self.executor = executor
        self.programs_built = programs_built
        self.config = config          # TunedConfig provenance (or None)
        self.source = source
        self.latency = LatencyHistogram()
        self.requests = 0
        self.hits = 0
        self.cap = 1                  # effective max_batch
        self.dispatches = 0
        self.batched_requests = 0     # completed requests, all batches
        self.exec_total_s = 0.0       # wall summed once per dispatch
        self.batch_latency = LatencyHistogram()
        self.stream_sessions = 0
        self.stream_closed = 0
        self.stream_dispatches = 0
        self.stream_lanes = 0
        self.stream_tail_s = 0.0
        self.stream_hidden = 0.0

    def snapshot(self) -> BucketStats:
        with self.executor._fleet_lock:
            fleet = dict(self.executor.fleet_totals)
        return BucketStats(
            devices=fleet["devices"],
            steals=fleet["stolen"],
            failovers=fleet["retried"],
            dead_devices=fleet["dead_devices"],
            variant=self.plan.variant,
            vol_shape_xyz=self.plan.vol_shape_xyz,
            n_proj=self.plan.n_proj,
            schedule=self.plan.schedule,
            requests=self.requests,
            hits=self.hits,
            misses=1,
            programs_built=self.programs_built,
            source=self.source,
            pipeline=self.executor.pipeline,
            completed=self.latency.count,
            p50_ms=_ms(self.latency.quantile(0.50)),
            p99_ms=_ms(self.latency.quantile(0.99)),
            mean_ms=_ms(self.latency.mean()),
            dispatches=self.dispatches,
            mean_occupancy=(round(self.batched_requests / self.dispatches,
                                  3) if self.dispatches else None),
            batch_p50_ms=_ms(self.batch_latency.quantile(0.50)),
            amortized_us_per_request=(
                round(self.exec_total_s / self.batched_requests * 1e6, 1)
                if self.batched_requests else None),
            max_batch=self.cap,
            streams=self.stream_sessions,
            streams_closed=self.stream_closed,
            stream_dispatches=self.stream_dispatches,
            stream_mean_lanes=(round(self.stream_lanes /
                                     self.stream_dispatches, 3)
                               if self.stream_dispatches else None),
            stream_tail_ms=(_ms(self.stream_tail_s / self.stream_closed)
                            if self.stream_closed else None),
            stream_hidden_fraction=(round(self.stream_hidden /
                                          self.stream_closed, 3)
                                    if self.stream_closed else None))


# --------------------------------------------------------------------------
# The service
# --------------------------------------------------------------------------

class ReconService:
    """Shape-bucketed reconstruction server over the shared ProgramCache.

    Parameters
    ----------
    max_inflight : worker threads, the bound on reconstructions running
        at once. Requests beyond it wait in the FIFO queue.
    pipeline : flush discipline of bucket executors ("async" by default,
        "sync" for the in-thread double buffer).
    cache : a private :class:`ProgramCache`; default the process-wide one.
    tuning : the autotuner's store for ``warmup(tune=True)`` and
        ``variant="auto"`` requests: a ``runtime.autotune.TuningCache``,
        a path, or None (the default cache).
    max_batch : how many SAME-bucket queued requests one executor call
        may serve (``PlanExecutor.execute_batch``); 1 (the default) is a
        plain FIFO. A measured tuned config's ``max_batch`` caps its
        bucket lower.
    max_wait_ms : how long a PARTIAL batch may hold the queue head for
        peers; 0 (the default) only coalesces requests already queued
        together. Bounded by members' deadlines; ``priority > 0`` ships
        at once.
    device : where every bucket runs (``None``: the CUDA card, which
        raises without one; ``"cpu"`` for the plain PyTorch path). With
        ``devices``, where requests are filtered before the fleet takes
        their steps; it defaults to the fleet's first entry and must be
        of the entries' type.
    devices : multi-device placement for every bucket. ``None`` (the
        default) keeps single-device execution; ``"all"`` spreads each
        reconstruction's step schedule over every CUDA device, an int N
        over the first N; a sequence of devices (an entry may repeat:
        ``("cuda:0",) * 2``, ``("cpu",) * 8``) or a
        :class:`~repro_torch.runtime.executor.FleetConfig` is used as
        given. Fleet buckets plan ``out="host"`` / ``schedule="step"`` by
        default (the fleet's placement) and run with straggler-aware work
        stealing and per-step failover (``PlanExecutor.execute_fleet``);
        the totals surface per bucket in :class:`ServiceStats`. Solver
        requests and stream sessions are refused on a fleet service.
        Without a card, ``"all"`` and an int raise; so do entries of more
        than one device type (``("cuda:0", "cpu")``).
    fleet_max_retries : per-STEP failover budget of fleet buckets
        (``FleetConfig.max_retries_per_step``); ignored without
        ``devices``.
    """

    def __init__(self, *, max_inflight: int = 2, pipeline: str = "async",
                 cache: Optional[ProgramCache] = None, tuning=None,
                 max_batch: int = 1, max_wait_ms: float = 0.0,
                 device=None, devices=None, fleet_max_retries: int = 2):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        self.fleet: Optional[FleetConfig] = as_fleet_config(
            devices, max_retries_per_step=fleet_max_retries)
        if self.fleet is not None:
            entries = self.fleet.resolve_devices()   # raises without a card
            if device is None:
                device = entries[0]
        self.device = resolve_device(device)
        if self.fleet is not None:
            _one_device_type(entries, self.device)
        self.cache = cache if cache is not None else default_program_cache()
        self.pipeline = pipeline
        self.tuning = tuning
        self.max_inflight = int(max_inflight)
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self._buckets: Dict[tuple, _Bucket] = {}
        self._lock = threading.Lock()          # buckets + counters
        # cap_fn/est_fn run under the former's condition: lock-free
        # bucket reads only (append-only dict), never the service lock
        self._former = _BatchFormer(
            max_wait_s=self.max_wait_ms / 1e3,
            cap_fn=self._cap_for, est_fn=self._run_estimate)
        # streaming: a former and ONE worker, made by the first open_stream
        self._stream_former: Optional[_BatchFormer] = None
        self._stream_thread: Optional[threading.Thread] = None
        self._closed = False
        self._workers = [
            threading.Thread(target=self._worker, name=f"recon-serve-{i}",
                             daemon=True)
            for i in range(self.max_inflight)]
        for t in self._workers:
            t.start()

    # ---- batching policy -------------------------------------------------

    def _effective_cap(self, config) -> int:
        """Batch cap of a bucket with tuned provenance ``config``: the
        service's ``max_batch``, bounded by a MEASURED winner's
        ``max_batch`` (a heuristic config carries no measurement)."""
        cap = self.max_batch
        if cap > 1 and config is not None \
                and getattr(config, "source", "heuristic") != "heuristic":
            cap = min(cap, max(1, int(getattr(config, "max_batch", 1))))
        return cap

    def _cap_for(self, req) -> int:
        bucket = self._buckets.get(req.key)   # lock-free: see __init__
        if bucket is not None:
            return bucket.cap
        return self._effective_cap(req.config)

    def _run_estimate(self, req) -> Optional[float]:
        """Expected seconds of a dispatch of this bucket for the deadline
        headroom (the batches' service time, not the requests' latency,
        which counts the queue), or None while the bucket has no
        completed traffic."""
        bucket = self._buckets.get(req.key)   # lock-free: see __init__
        if bucket is None:
            return None
        return bucket.batch_latency.mean()    # None while empty

    # ---- bucketing -------------------------------------------------------

    def _tuning_cache(self, tuning=None):
        from repro_torch.runtime.autotune import as_tuning_cache
        return as_tuning_cache(tuning if tuning is not None
                               else self.tuning)

    def _plan(self, geom: CTGeometry, options: Dict):
        """Façade options -> (plan, TunedConfig or None, solver knobs);
        validation errors raise here, in the submitting thread.
        ``variant="auto"`` / ``tuning=`` resolve through the tuning cache
        (lookup only: a miss is the heuristic config)."""
        opts = dict(options)
        variant = opts.pop("variant", None)
        tuning = opts.pop("tuning", None)
        solver = opts.pop("solver", "none")
        precision = opts.pop("precision", "f32")
        # per-request loop knobs ride the request, not the bucket
        solver_kw = {k: opts.pop(k) for k in
                     ("n_iters", "relax", "x0", "tv_weight", "tv_inner",
                      "oversample") if k in opts}
        if tuning is None:
            # ONE read, under the lock warmup(tune=True) writes under
            with self._lock:
                tuning = self.tuning
        if variant is None:
            variant = "auto" if tuning is not None else "algorithm1_mp"
        kw = dict(
            nb=opts.pop("nb", 8), interpret=opts.pop("interpret", True),
            tiling=opts.pop("tiling", None),
            memory_budget=opts.pop("memory_budget", None),
            proj_batch=opts.pop("proj_batch", None),
            out=opts.pop("out", None), schedule=opts.pop("schedule", None),
            precision=precision)
        if solver != "none":
            # solver buckets own a device volume and resolve
            # heuristically (tuning is method-aware: autotune(method=))
            if self.fleet is not None:
                raise ValueError(
                    "iterative solver requests run single-device (the "
                    "solve loop owns the volume); they cannot ride a "
                    "fleet service (ReconService(devices=...))")
            if variant == "auto":
                variant = "algorithm1_mp"
            tuning = None
            kw["solver"] = solver
            kw["out"] = "device"
        ingest = opts.pop("ingest", "offline")
        if ingest != "offline":
            # stream plans resolve heuristically (TunedConfig has no
            # ingest axis) and are chunk-major by construction
            if variant == "auto":
                variant = "algorithm1_mp"
            tuning = None
            kw["ingest"] = ingest
        if self.fleet is not None:
            # the fleet accumulates on the host over the step schedule;
            # explicit contrary choices fail in PlanExecutor's validation
            kw["out"] = kw["out"] or "host"
            kw["schedule"] = kw["schedule"] or "step"
        if solver == "none" and solver_kw:
            raise ValueError(
                f"solver knobs {sorted(solver_kw)} need an iterative "
                f"request (pass solver='sart'|'os_sart'|'cgls'|"
                f"'fista_tv')")
        if variant == "auto" or tuning is not None:
            from repro_torch.runtime.autotune import resolve_config
            cfg = resolve_config(geom, variant,
                                 cache=self._tuning_cache(tuning),
                                 device=self.device, **kw, **opts)
            return cfg.build_plan(geom), cfg, None
        return (_build_plan(geom, variant, **kw, **opts), None,
                solver_kw or None)

    @staticmethod
    def _source_of(config) -> str:
        if config is None or config.source == "heuristic":
            return "heuristic"
        return "tuned-" + config.source      # "measured" | "cache"

    def _executor(self, geom: CTGeometry, plan: ReconPlan, config):
        """A warmed executor for a new bucket (or a tuned upgrade)."""
        tuned = config is not None and config.source != "heuristic"
        if plan.solver != "none":
            from repro_torch.runtime.solvers import IterativeExecutor
            ex = IterativeExecutor(geom, plan, self.cache,
                                   pipeline=self.pipeline,
                                   device=self.device)
        else:
            ex = PlanExecutor(
                geom, plan, cache=self.cache,
                pipeline=config.pipeline if tuned else self.pipeline,
                pipeline_depth=config.pipeline_depth if tuned else 2,
                tuned=config if tuned else None, fleet=self.fleet,
                device=self.device)
        ex.warm()
        cap = self._effective_cap(config)
        if cap > 1 and ex.supports_request_batching:
            # every batch size the former can ship, partial ones too, so
            # no formed batch builds a program (the reference warms only
            # rb = cap)
            for rb in range(2, cap + 1):
                ex.warm_batch(rb)
        return ex, cap

    def _bucket(self, geom: CTGeometry, plan: ReconPlan,
                config=None) -> _Bucket:
        """Find or create the bucket of ``(geom, plan.bucket_key)``.

        Creation runs under the service lock, so the program-cache miss
        delta across the warm-up is this bucket's ``programs_built``. A
        measured tuned config that lands on an existing heuristic bucket
        (it differs only in executor knobs outside ``bucket_key``)
        upgrades the bucket's executor in place."""
        key = (geom, plan.bucket_key)
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is not None:
                bucket.hits += 1
                if config is not None and config.source != "heuristic" \
                        and bucket.source == "heuristic":
                    bucket.executor, bucket.cap = self._executor(
                        geom, plan, config)
                    bucket.config = config
                    bucket.source = self._source_of(config)
                return bucket
            misses_before = self.cache.stats()["misses"]
            ex, cap = self._executor(geom, plan, config)
            built = self.cache.stats()["misses"] - misses_before
            bucket = _Bucket(geom, plan, ex, programs_built=built,
                             config=config, source=self._source_of(config))
            bucket.cap = cap
            self._buckets[key] = bucket
            return bucket

    def warmup(self, geometries: Iterable[CTGeometry], *,
               tune: bool = False, tune_budget_s: float = 20.0,
               **options) -> ServiceStats:
        """Build (and with ``tune=True`` first tune) the bucket of each
        geometry under ``options``, so the first real request of each
        warmed shape is a bucket hit that builds nothing.

        ``tune=True`` runs the measured autotuner per bucket: a persisted
        winner for this card resolves with no measurement (``source ==
        "tuned-cache"``), else the search runs under ``tune_budget_s``
        seconds and is persisted (``"tuned-measured"``)."""
        for geom in geometries:
            if tune:
                from repro_torch.runtime.autotune import autotune
                opts = dict(options)
                cache = self._tuning_cache(opts.pop("tuning", None))
                with self._lock:
                    if self.tuning is None:
                        # later requests resolve through the SAME cache
                        self.tuning = cache
                with device_scope(self.device):
                    cfg = autotune(geom, opts.pop("variant", "auto"),
                                   budget_s=tune_budget_s, cache=cache,
                                   program_cache=self.cache,
                                   device=self.device, **opts)
                self._bucket(geom, cfg.build_plan(geom), config=cfg)
            else:
                plan, cfg, _skw = self._plan(geom, options)
                self._bucket(geom, plan, config=cfg)
        return self.stats()

    # ---- request path ----------------------------------------------------

    def submit(self, projections, geom: CTGeometry, *,
               deadline_ms: Optional[float] = None, priority: int = 0,
               **options) -> Future:
        """Enqueue one reconstruction; returns a ``Future`` whose
        ``result()`` is the volume (the contract of ``fdk_reconstruct``,
        whose options these mirror). FIFO across callers.

        ``deadline_ms`` (from now) and ``priority`` shape batch forming
        only, never the FIFO order: a deadline caps how long a partial
        batch holding the request may wait for peers, and ``priority >
        0`` ships any batch it joins at once. Both do nothing when
        ``max_batch == 1``."""
        submit_s = time.perf_counter()
        plan, config, solver_kw = self._plan(geom, options)
        if deadline_ms is not None and deadline_ms < 0:
            raise ValueError(
                f"deadline_ms must be >= 0, got {deadline_ms}")
        key = (geom, plan.bucket_key)
        trace_id = telemetry.new_trace_id()
        telemetry.instant("request.submit", trace_id=trace_id,
                          variant=plan.variant, priority=int(priority))
        fut: Future = Future()
        fut.trace_id = trace_id      # for the caller's linkage
        req = _Request(
            fut=fut, projections=projections, geom=geom, plan=plan,
            config=config, key=key,
            deadline_s=(None if deadline_ms is None
                        else time.perf_counter() + deadline_ms / 1e3),
            priority=int(priority), solver_kw=solver_kw, trace_id=trace_id,
            submit_s=submit_s)
        # put() checks closed under the former's condition: a request
        # either raises here or is guaranteed a consumer
        self._former.put(req)
        return fut

    def reconstruct(self, projections, geom: CTGeometry, **options):
        """Synchronous request: ``submit(...).result()``."""
        return self.submit(projections, geom, **options).result()

    def _worker(self) -> None:
        with device_scope(self.device):
            while True:
                batch = self._former.take()
                if batch is None:
                    return
                live = [r for r in batch
                        if r.fut.set_running_or_notify_cancel()]
                if live:
                    self._serve(live)

    def _serve(self, live: List[_Request]) -> None:
        """Run one formed batch; every error reaches its futures."""
        try:
            head = live[0]
            bucket = self._bucket(head.geom, head.plan, config=head.config)
            k = len(live)
            with self._lock:
                bucket.requests += k
            t0 = time.perf_counter()
            if telemetry.enabled():
                # each member's wait, from its submit to this dispatch
                for r in live:
                    telemetry.interval("request.queue", r.submit_s, t0,
                                       trace_id=r.trace_id)
            # the dispatch span carries every member's trace id
            with telemetry.span("service.dispatch", k=k,
                                variant=bucket.plan.variant,
                                trace_ids=[r.trace_id for r in live]):
                ex = bucket.executor
                if k == 1:
                    results = [ex.reconstruct(head.projections,
                                              **(head.solver_kw or {}))]
                elif ex.supports_request_batching:
                    # one lane launch per step and chunk serves all k
                    results = ex.execute_batch([r.projections for r in live])
                else:
                    # chunk-major and solver buckets run the formed group
                    # back to back (each solve with its own knobs)
                    results = [ex.reconstruct(r.projections,
                                              **(r.solver_kw or {}))
                               for r in live]
                if self.device.type == "cuda":
                    # a request is served when its volume is computed
                    torch.cuda.current_stream(self.device).synchronize()
            done = time.perf_counter()
            wall = done - t0
            for r in live:
                bucket.latency.record(done - r.submit_s)
            bucket.batch_latency.record(wall)
            with self._lock:
                bucket.dispatches += 1
                bucket.batched_requests += k
                bucket.exec_total_s += wall
            for r, vol in zip(live, results):
                r.fut.set_result(vol)
        except Exception as exc:    # the worker keeps serving
            for r in live:
                if not r.fut.done():
                    r.fut.set_exception(exc)

    # ---- streaming sessions ----------------------------------------------

    def open_stream(self, geom: CTGeometry, *, priority: int = 0,
                    max_pending_chunks: int = 2,
                    **options) -> "StreamSession":
        """Open an online reconstruction session: push views as the
        scanner produces them; ``close()`` returns the volume,
        bit-identical to the offline chunk-major reconstruction.

        Sessions bucket on ``(geometry, plan.bucket_key)`` like requests
        (``ingest="stream"`` is part of the key). The stream worker folds
        the same ready chunk of up to ``max_batch`` same-bucket sessions
        with one lane launch per step. ``max_pending_chunks`` bounds the
        session's ready chunks (``push`` blocks beyond it); ``priority >
        0`` folds the session's chunks without waiting for peers.
        ``proj_batch`` defaults to ~n_proj/8 views a chunk. A fleet
        service (``devices=``) refuses: a stream folds chunks on one
        device."""
        if self.fleet is not None:
            raise ValueError(
                "streaming sessions do not compose with fleet execution; "
                "construct the service without devices=")
        opts = dict(options)
        opts["ingest"] = "stream"
        if opts.get("proj_batch") is None:
            # ~8 chunks a rotation, at least nb views each
            opts["proj_batch"] = max(int(opts.get("nb", 8)),
                                     geom.n_proj // 8)
        plan, config, _skw = self._plan(geom, opts)
        bucket = self._bucket(geom, plan, config=config)
        self._ensure_stream_worker()
        with self._lock:
            bucket.stream_sessions += 1
        return StreamSession(self, bucket, priority=int(priority),
                             max_pending_chunks=max_pending_chunks)

    def _ensure_stream_worker(self) -> None:
        with self._lock:
            if self._closed:
                raise RuntimeError("ReconService is closed")
            if self._stream_former is not None:
                return
            self._stream_former = _BatchFormer(
                max_wait_s=self.max_wait_ms / 1e3,
                cap_fn=lambda w: max(1, self.max_batch),
                est_fn=lambda w: None)   # chunk folds carry no deadlines
            self._stream_thread = threading.Thread(
                target=self._stream_worker, name="recon-stream",
                daemon=True)
            self._stream_thread.start()

    def _stream_worker(self) -> None:
        former = self._stream_former
        with device_scope(self.device):
            while True:
                batch = former.take()
                if batch is None:
                    return
                # the fold-order contract: chunk c of a session folds only
                # when it IS the session's next_fold; an earlier chunk's
                # arrival requeues the item (and wakes this worker)
                runnable: List[_StreamWork] = []
                for w in batch:
                    if w.session._core.next_fold == w.chunk:
                        runnable.append(w)
                    else:
                        try:
                            former.put(w)
                        except RuntimeError as exc:
                            w.session._core.fail(exc)
                if not runnable:
                    time.sleep(0.002)      # only deferred items are queued
                    continue
                try:
                    self._fold_stream_chunk(runnable)
                except Exception as exc:    # close() of each session raises
                    for w in runnable:
                        w.session._core.fail(exc)

    def _fold_stream_chunk(self, works: List[_StreamWork]) -> None:
        """Fold one ready view chunk of k same-bucket sessions."""
        c = works[0].chunk
        bucket = works[0].session._bucket
        cores = [w.session._core for w in works]
        # counted before the fold: the last fold finishes the sessions,
        # whose close() may read the stats at once
        with self._lock:
            bucket.stream_dispatches += 1
            bucket.stream_lanes += len(cores)
        with telemetry.span("service.stream_dispatch", chunk=c,
                            k=len(cores),
                            trace_ids=[w.session.trace_id for w in works]):
            self._fold_stream_chunk_inner(c, bucket, cores)

    def _fold_stream_chunk_inner(self, c, bucket, cores) -> None:
        """k == 1: the session's own ``fold``. k > 1: the k filtered
        chunks stacked on a lane axis and ONE rb-lane program per plan
        step (``ProgramCache.batch_program``); each lane equals the solo
        fold's part bit for bit, so each session's running sums do too."""
        if len(cores) == 1:
            cores[0].fold(c)
            return
        ex = bucket.executor
        plan = bucket.plan
        t0 = time.perf_counter()
        with telemetry.span("stream.fold", chunk=c, k=len(cores)):
            pairs = [core.filtered(c) for core in cores]
            for core in cores:
                core.prefilter(c + 1)
            img_b = torch.stack([img for img, _ in pairs])
            mat_c = pairs[0][1]        # same geometry: same matrices
            for i, step in enumerate(plan.steps):
                prog = self.cache.batch_program(
                    step.variant, step.call_shape, plan.nb, ex._dtype,
                    plan.interpret, plan.options, rb=len(cores))
                with ex._step_span(step, int(img_b.shape[1]),
                                   schedule="stream", rb=len(cores)):
                    out_b = prog(img_b, ex._translated(mat_c, step))
                for r, core in enumerate(cores):
                    core.accept_part(i, out_b[r])
            cores[0].sync()
        wall = time.perf_counter() - t0
        for core in cores:
            core.add_busy(wall)
            core.chunk_done(c)

    # ---- lifecycle / introspection ---------------------------------------

    def stats(self) -> ServiceStats:
        with self._lock:
            live = list(self._buckets.values())
            buckets = tuple(b.snapshot() for b in live)
            s_open = sum(b.stream_sessions for b in live)
            s_closed = sum(b.stream_closed for b in live)
            s_tail = sum(b.stream_tail_s for b in live)
            s_hidden = sum(b.stream_hidden for b in live)
        overall = LatencyHistogram.merged(b.latency for b in live)
        dispatches = sum(b.dispatches for b in buckets)
        completed = sum(b.completed for b in buckets)
        return ServiceStats(
            requests=sum(b.requests for b in buckets),
            bucket_hits=sum(b.hits for b in buckets),
            bucket_misses=len(buckets),
            buckets=buckets,
            cache=self.cache.stats(),
            max_inflight=self.max_inflight,
            queued=self._former.qsize(),
            p50_ms=_ms(overall.quantile(0.50)),
            p99_ms=_ms(overall.quantile(0.99)),
            max_batch=self.max_batch,
            dispatches=dispatches,
            mean_occupancy=(round(completed / dispatches, 3)
                            if dispatches else None),
            streams=s_open,
            stream_tail_ms=(_ms(s_tail / s_closed) if s_closed else None),
            stream_hidden_fraction=(round(s_hidden / s_closed, 3)
                                    if s_closed else None))

    def close(self, wait: bool = True) -> None:
        """Stop accepting requests and drain the workers (idempotent):
        requests already queued complete first."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        # outside the service lock: forming workers take the former's
        # condition and read buckets (lock order)
        self._former.close()
        if self._stream_former is not None:
            self._stream_former.close()
        if wait:
            for t in self._workers:
                t.join()
            if self._stream_thread is not None:
                self._stream_thread.join()

    def __enter__(self) -> "ReconService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class StreamSession:
    """One open projection stream bound to a service bucket.

    ``push(views)`` hands view rows to the session's
    :class:`~repro_torch.runtime.executor.StreamingExecutor`; each
    complete view chunk queues a :class:`_StreamWork` to the service's
    stream worker. ``close()`` waits for the last folds and returns the
    volume; the session's ``StreamReport`` then joins the bucket's
    overlap counters."""

    def __init__(self, service: ReconService, bucket: _Bucket, *,
                 priority: int = 0, max_pending_chunks: int = 2):
        self._service = service
        self._bucket = bucket
        self._priority = int(priority)
        self._key_base = (bucket.geom, bucket.plan.bucket_key)
        # carried by every chunk dispatch the session joins
        self.trace_id = telemetry.new_trace_id("stream")
        telemetry.instant("stream.open", trace_id=self.trace_id,
                          variant=bucket.plan.variant)
        self._core = bucket.executor.open_stream(
            max_pending_chunks=max_pending_chunks, on_ready=self._ready)

    def _ready(self, chunk: int) -> None:
        """StreamingExecutor callback (its condition released): queue the
        chunk's fold."""
        work = _StreamWork(session=self, chunk=chunk,
                           key=self._key_base + (chunk,),
                           priority=self._priority)
        try:
            self._service._stream_former.put(work)
        except RuntimeError as exc:      # service closed mid-stream
            self._core.fail(exc)

    def push(self, views, start: Optional[int] = None) -> None:
        """Deliver view rows (blocks only on backpressure)."""
        self._core.push(views, start=start)

    @property
    def report(self):
        """The core's ``StreamReport`` (None until closed)."""
        return self._core.report

    def close(self):
        """Finish the stream and return the volume (nz, ny, nx)."""
        vol = self._core.close()
        rep = self._core.report
        with self._service._lock:
            self._bucket.stream_closed += 1
            if rep is not None:
                self._bucket.stream_tail_s += rep.tail_s
                self._bucket.stream_hidden += rep.hidden_fraction
        return vol

    def __enter__(self) -> "StreamSession":
        return self

    def __exit__(self, *exc) -> None:
        if exc and exc[0] is not None:
            self._core.fail(exc[1])
        elif not self._core._ingest_closed:   # an explicit close() is fine
            self.close()
