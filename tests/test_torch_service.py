"""repro_torch's serving layer against the JAX package, on the CPU.

The port of ``tests/test_service.py``: ``ReconService`` buckets and their
program reuse, warm-up, the façade's ``service=`` routing, the async step
pipeline, FIFO fairness with bounded in-flight work, errors reaching the
caller's future, and the streamed latency stats (from submit, the queue
included). The same numpy requests
go through the JAX package and the port: the port's served volumes are
held against the JAX package's at rel-RMSE 1e-5 and against the port's
own solo ``reconstruct`` bit for bit. Beyond the JAX tests: the
Prometheus export, ``warmup(tune=True)``, a solver request, the service's
telemetry spans (one ``request.queue`` a request) and the card-only
default device. The JAX package's
``test_clinical_size_overlap_measurement`` (``slow``, a benchmark) has no
counterpart here.
"""

import dataclasses
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import fdk_reconstruct as j_fdk
from repro.core import standard_geometry as j_geom
from repro.runtime.planner import plan_reconstruction as j_plan

import repro_torch
from repro_torch import convert
from repro_torch.core.backproject import transpose_projections
from repro_torch.core.fdk import fdk_reconstruct
from repro_torch.core.geometry import projection_matrices
from repro_torch.runtime import telemetry
from repro_torch.runtime.autotune import TuningCache
from repro_torch.runtime.executor import PlanExecutor, ProgramCache
from repro_torch.runtime.planner import plan_reconstruction
from repro_torch.runtime.service import LatencyHistogram, ReconService

from conftest import rel_rmse

BAR = 1e-5
OPTS = dict(variant="subline_batch_mp", nb=2, tiling=(8, 8, 16),
            proj_batch=4)


def _geoms(n=16, n_det=24, n_proj=6):
    g = j_geom(n=n, n_det=n_det, n_proj=n_proj)
    return g, convert.geometry_from_reference(dataclasses.asdict(g))


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.fixture(scope="module")
def setup():
    g, t = _geoms()
    projs = np.random.RandomState(3).rand(g.n_proj, g.nh,
                                          g.nw).astype(np.float32)
    return g, t, projs


def _svc(**kw):
    kw.setdefault("max_inflight", 1)
    kw.setdefault("cache", ProgramCache())
    return ReconService(device="cpu", **kw)


# ---- bucket_key -----------------------------------------------------------

def test_plan_is_hashable_bucket_key(setup):
    g, t, _ = setup
    a = plan_reconstruction(t, "algorithm1_mp", nb=2, proj_batch=4)
    b = plan_reconstruction(t, "algorithm1_mp", nb=2, proj_batch=4)
    assert a == b and hash(a) == hash(b)          # plan itself is a key
    assert a.bucket_key == b.bucket_key
    assert a.bucket_key == j_plan(g, "algorithm1_mp", nb=2,
                                  proj_batch=4).bucket_key
    c = plan_reconstruction(t, "algorithm1_mp", nb=2, proj_batch=2)
    assert c.bucket_key != a.bucket_key           # chunk grid differs
    d = plan_reconstruction(t, "share_mp", nb=2, proj_batch=4)
    assert d.bucket_key != a.bucket_key           # variant differs


# ---- cross-request ProgramCache reuse -------------------------------------

def test_same_shape_requests_compile_once(setup):
    """Two same-shape requests: miss then hit; the second request builds
    no program."""
    g, t, projs = setup
    with _svc() as svc:
        v1 = svc.reconstruct(projs, t, **OPTS)
        after_first = svc.stats()
        assert after_first.bucket_misses == 1
        assert after_first.cache["misses"] > 0    # the cold builds
        v2 = svc.reconstruct(projs, t, **OPTS)
        after_second = svc.stats()
    assert after_second.cache["misses"] == after_first.cache["misses"]
    assert after_second.bucket_hits == 1
    assert after_second.cache["hits"] > after_first.cache["hits"]
    assert np.array_equal(_np(v1), _np(v2))
    assert rel_rmse(_np(v1), np.asarray(
        j_fdk(jnp.asarray(projs), g, **OPTS))) < BAR


def test_warmup_precompiles_everything(setup):
    """After warmup(geometries) the first REAL request is a bucket hit
    that builds no program."""
    _, t, projs = setup
    with _svc() as svc:
        stats = svc.warmup([t], **OPTS)
        assert stats.bucket_misses == 1 and stats.cache["misses"] > 0
        warmed = stats.cache["misses"]
        svc.reconstruct(projs, t, **OPTS)
        stats = svc.stats()
        assert stats.cache["misses"] == warmed    # no build on request
        assert stats.bucket_hits == 1
        b = stats.buckets[0]
        assert (b.requests, b.hits, b.programs_built) == (1, 1, warmed)


def test_warmup_builds_every_partial_batch(setup):
    """After warmup, a formed batch smaller than ``max_batch`` builds no
    program: the service warms every rb in 2..cap (the reference warms
    only cap). Three requests wait for a fourth until the third, of
    priority 1, ships the batch of three; its volumes equal solo runs."""
    _, t, projs = setup
    reqs = [projs * (1.0 + 0.5 * i) for i in range(3)]
    with _svc(max_batch=4, max_wait_ms=3_600_000.0) as svc:
        warmed = svc.warmup([t], **OPTS).cache["misses"]
        bucket = next(iter(svc._buckets.values()))
        assert bucket.executor.supports_request_batching
        futs = [svc.submit(p, t, **OPTS) for p in reqs[:2]]
        futs.append(svc.submit(reqs[2], t, priority=1, **OPTS))
        out = [_np(f.result(timeout=120)) for f in futs]
        stats = svc.stats()
    assert stats.cache["misses"] == warmed       # no build in the burst
    b = stats.buckets[0]
    assert (b.dispatches, b.completed, b.programs_built) == (1, 3, warmed)
    solo = PlanExecutor(t, bucket.plan, device="cpu")
    for got, p in zip(out, reqs):
        assert np.array_equal(got, _np(solo.reconstruct(p)))


def test_mixed_shapes_do_not_evict(setup):
    """Interleaved shape classes keep their buckets AND their programs:
    re-requesting the first shape builds nothing."""
    _, t, projs_a = setup
    gb, tb = _geoms(n=8, n_det=12, n_proj=6)
    projs_b = np.random.RandomState(4).rand(6, 12, 12).astype(np.float32)
    with _svc() as svc:
        svc.reconstruct(projs_a, t, **OPTS)
        svc.reconstruct(projs_b, tb, **OPTS)
        both_cold = svc.stats().cache["misses"]
        svc.reconstruct(projs_a, t, **OPTS)       # back to shape A
        vb = svc.reconstruct(projs_b, tb, **OPTS)  # and shape B again
        stats = svc.stats()
    assert stats.cache["misses"] == both_cold
    assert stats.bucket_misses == 2 and stats.bucket_hits == 2
    assert {b.vol_shape_xyz for b in stats.buckets} == \
        {(16, 16, 16), (8, 8, 8)}
    assert rel_rmse(_np(vb), np.asarray(
        j_fdk(jnp.asarray(projs_b), gb, **OPTS))) < BAR


def test_facade_service_routing(setup):
    """fdk_reconstruct(service=...) and reconstruct(service=...) land in
    the service's buckets and give the one-shot façade's volume."""
    g, t, projs = setup
    ref = _np(fdk_reconstruct(projs, t, device="cpu", **OPTS))
    with _svc() as svc:
        via = _np(fdk_reconstruct(projs, t, service=svc, **OPTS))
        assert svc.stats().bucket_misses == 1
        top = _np(repro_torch.reconstruct(
            projs, t, options=repro_torch.ReconOptions(service=svc, **OPTS)))
        assert svc.stats().bucket_hits == 1
        # the service owns the flush discipline and the device
        with pytest.raises(ValueError, match="pipeline"):
            fdk_reconstruct(projs, t, service=svc, pipeline="sync", **OPTS)
        with pytest.raises(ValueError, match="device"):
            fdk_reconstruct(projs, t, service=svc, device="cpu", **OPTS)
    assert np.array_equal(via, ref) and np.array_equal(top, ref)
    assert rel_rmse(via, np.asarray(
        j_fdk(jnp.asarray(projs), g, **OPTS))) < BAR


# ---- async pipeline parity ------------------------------------------------

@pytest.mark.parametrize("variant",
                         ["algorithm1_mp", "subline_batch_mp", "share_mp",
                          "symmetry_mp"])
def test_async_pipeline_bit_identical(setup, variant):
    """pipeline="async" only moves WHEN host adds happen, never their
    order: bit-identical to the sync step-major executor."""
    g, t, projs = setup
    plan = plan_reconstruction(t, variant, nb=2, tile_shape=(8, 8, 16),
                               proj_batch=4, out="host")
    cache = ProgramCache()
    seq = PlanExecutor(t, plan, cache=cache, pipeline="sync",
                       device="cpu").reconstruct(projs)
    pip = PlanExecutor(t, plan, cache=cache, pipeline="async",
                       device="cpu").reconstruct(projs)
    assert np.array_equal(seq, pip), variant
    want = np.asarray(j_fdk(jnp.asarray(projs), g, variant, nb=2,
                            tiling=(8, 8, 16), proj_batch=4, out="host"))
    assert rel_rmse(pip, want) < BAR


@pytest.mark.parametrize("variant", ["algorithm1_mp", "share_mp"])
def test_async_chunk_major_parity(setup, variant):
    """The async flush covers the chunk-major loop: the enqueue order is
    the sync flush order, so the output stays bit-identical although
    chunks re-add into the same volume regions."""
    _, t, projs = setup
    plan = plan_reconstruction(t, variant, nb=2, tile_shape=(8, 8, 16),
                               proj_batch=2, out="host", schedule="chunk")
    cache = ProgramCache()
    seq = PlanExecutor(t, plan, cache=cache, pipeline="sync",
                       device="cpu").reconstruct(projs)
    pip = PlanExecutor(t, plan, cache=cache, pipeline="async",
                       device="cpu").reconstruct(projs)
    assert np.array_equal(seq, pip), variant
    # and the raw backproject chunk loop
    img_t = transpose_projections(torch.from_numpy(projs))
    mats = projection_matrices(t, device="cpu")
    seq = PlanExecutor(t, plan, cache=cache, pipeline="sync",
                       device="cpu").backproject(img_t, mats)
    pip = PlanExecutor(t, plan, cache=cache, pipeline="async",
                       device="cpu").backproject(img_t, mats)
    assert np.array_equal(seq, pip), variant


def test_async_backproject_parity(setup):
    """The raw backproject path pipelines too (data-dependent chunks)."""
    _, t, projs = setup
    img_t = transpose_projections(torch.from_numpy(projs))
    mats = projection_matrices(t, device="cpu")
    plan = plan_reconstruction(t, "algorithm1_mp", nb=2,
                               tile_shape=(8, 8, 16), proj_batch=2,
                               out="host")
    cache = ProgramCache()
    seq = PlanExecutor(t, plan, cache=cache, pipeline="sync",
                       device="cpu").backproject(img_t, mats)
    pip = PlanExecutor(t, plan, cache=cache, pipeline="async",
                       device="cpu").backproject(img_t, mats)
    assert np.array_equal(seq, pip)


def test_pipeline_validation(setup):
    _, t, _ = setup
    plan = plan_reconstruction(t, "algorithm1_mp")
    with pytest.raises(ValueError, match="pipeline"):
        PlanExecutor(t, plan, pipeline="turbo", device="cpu")


# ---- FIFO fairness + bounded concurrency ----------------------------------

def test_fifo_order_and_bounded_inflight(setup, monkeypatch):
    """With max_inflight=1, requests START in submission order (FIFO
    across shapes) and at most one runs at a time. The order is spied on
    the worker side (PlanExecutor)."""
    _, t, projs_a = setup
    _, tb = _geoms(n=8, n_det=12, n_proj=6)
    projs_b = np.random.RandomState(5).rand(6, 12, 12).astype(np.float32)
    order, running, peak = [], [0], [0]
    real = PlanExecutor.reconstruct

    def spy(self, projections):
        order.append(id(projections))
        running[0] += 1
        peak[0] = max(peak[0], running[0])
        try:
            return real(self, projections)
        finally:
            running[0] -= 1

    monkeypatch.setattr(PlanExecutor, "reconstruct", spy)
    with _svc() as svc:
        svc.warmup([t, tb], **OPTS)
        inputs, futs = [], []
        for i in range(6):
            geom, p = ((t, projs_a) if i % 2 == 0 else (tb, projs_b))
            p = p + 0          # a distinct array per request tags it
            inputs.append(p)
            futs.append(svc.submit(p, geom, **OPTS))
        for f in futs:
            f.result()
    assert order == [id(p) for p in inputs]
    assert peak[0] == 1


def test_submit_validates_in_caller(setup):
    """Bad options raise AT SUBMIT (planner validation), not in a worker
    thread via the future."""
    _, t, projs = setup
    with _svc() as svc:
        with pytest.raises(ValueError, match="does not accept"):
            svc.submit(projs, t, variant="share_mp", bogus_option=1)
        with pytest.raises(ValueError):
            svc.submit(projs, t, out="sideways")
        with pytest.raises(ValueError, match="solver knobs"):
            svc.submit(projs, t, n_iters=3)


def test_worker_errors_surface_via_future(setup):
    """Execution errors (wrong projection count) land in the future, and
    the service keeps serving afterwards."""
    _, t, projs = setup
    with _svc() as svc:
        bad = svc.submit(projs[:3], t, **OPTS)
        with pytest.raises(ValueError, match="full scan"):
            bad.result()
        good = svc.submit(projs, t, **OPTS)      # still alive
        assert good.result().shape == (16, 16, 16)


def test_closed_service_rejects(setup):
    _, t, projs = setup
    svc = _svc()
    svc.close()
    svc.close()                                  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(projs, t, **OPTS)


# ---- streamed latency accounting ------------------------------------------

def test_latency_histogram_quantiles():
    h = LatencyHistogram()
    assert h.quantile(0.5) is None and h.mean() is None
    for ms in (1, 1, 1, 1, 1, 1, 1, 1, 1, 1000):   # 9 fast + 1 slow
        h.record(ms * 1e-3)
    assert h.count == 10
    p50, p99 = h.quantile(0.50), h.quantile(0.99)
    # log-2 bins: estimates within a bin width of the truth, ordered
    assert 0.4e-3 < p50 < 3e-3
    assert 0.5 < p99 < 2.0
    assert p50 <= p99
    assert h.mean() == pytest.approx(100.9e-3, rel=1e-6)
    merged = LatencyHistogram.merged([h, h])
    assert merged.count == 20 and merged.quantile(0.5) == p50


def test_bucket_stats_stream_latency(setup):
    """Every COMPLETED request lands in its bucket's histogram as it
    finishes: counts and quantiles are live after each request, and the
    service's p50/p99 merge the bucket histograms."""
    _, t, projs = setup
    with _svc() as svc:
        svc.warmup([t], **OPTS)
        assert svc.stats().buckets[0].completed == 0   # warmup != traffic
        for i in range(3):
            svc.reconstruct(projs, t, **OPTS)
            b = svc.stats().buckets[0]
            assert b.completed == i + 1               # streams per request
        stats = svc.stats()
        b = stats.buckets[0]
        assert b.p50_ms is not None and b.p99_ms is not None
        assert b.p50_ms <= b.p99_ms and b.mean_ms > 0
        assert stats.p50_ms == b.p50_ms               # single bucket merge
        assert b.source == "heuristic" and b.pipeline == "async"
        text = stats.export_prometheus()
    assert "repro_requests_total 3.0" in text
    row = next(line for line in text.splitlines()
               if line.startswith("repro_bucket_completed{"))
    assert 'variant="subline_batch_mp"' in row and row.endswith(" 3.0")
    assert stats.as_dict()["buckets"][0]["completed"] == 3


def test_latency_counts_from_submit(setup, monkeypatch):
    """A request's latency runs from its submit to its volume, so the
    queue behind a busy worker is in it; the batch former's deadline
    estimate stays the dispatches' service time."""
    _, t, projs = setup
    real = PlanExecutor.reconstruct

    def slow(self, projections):
        time.sleep(0.1)
        return real(self, projections)

    with _svc() as svc:
        svc.warmup([t], **OPTS)
        monkeypatch.setattr(PlanExecutor, "reconstruct", slow)
        futs = [svc.submit(projs, t, **OPTS) for _ in range(4)]
        for f in futs:
            f.result()
        b = svc.stats().buckets[0]
        bucket = next(iter(svc._buckets.values()))
        key = next(iter(svc._buckets))
        est = svc._run_estimate(types.SimpleNamespace(key=key))
    # one at a time: the i-th request waits for the i - 1 before it
    assert b.completed == 4 and b.mean_ms >= 1e3 * 0.1 * (1 + 2 + 3 + 4) / 4
    assert b.mean_ms >= 2 * b.amortized_us_per_request / 1e3
    assert est == bucket.batch_latency.mean()
    assert 0.1 <= est < b.mean_ms / 1e3


def test_request_queue_spans(setup):
    """One request.queue span a served request, on the lane of the
    worker that dispatched it, from at or after its submit to at or
    before the start of the service.dispatch span carrying its id."""
    _, t, projs = setup
    opts = dict(variant="algorithm1_mp", nb=2, proj_batch=4)
    with telemetry.tracing():
        with _svc(max_batch=2) as svc:
            svc.warmup([t], **opts)
            sent, futs = [], []
            for _ in range(4):
                sent.append(time.perf_counter() * 1e6)
                futs.append(svc.submit(projs, t, **opts))
            for f in futs:
                f.result()
        evs = [e for e in telemetry.events() if e.get("ph") == "X"]
    queue = {e["args"]["trace_id"]: e for e in evs
             if e["name"] == "request.queue"}
    assert len(queue) == sum(e["name"] == "request.queue" for e in evs)
    assert set(queue) == {f.trace_id for f in futs}
    dispatch = {tid: e for e in evs if e["name"] == "service.dispatch"
                for tid in e["args"]["trace_ids"]}
    for t_sent, f in zip(sent, futs):
        q, d = queue[f.trace_id], dispatch[f.trace_id]
        assert q["ts"] >= t_sent and q["dur"] >= 0
        assert q["ts"] + q["dur"] <= d["ts"]
        assert q["tid"] == d["tid"] and q["args"]["parent_id"] is None


# ---- beyond the JAX tests ---------------------------------------------------

def test_warmup_tune_resolves_tuned_buckets(setup, tmp_path):
    """warmup(tune=True) tunes each bucket (source "tuned-measured"),
    later requests land in it and build nothing; a second service on the
    same store resolves with no measurement ("tuned-cache")."""
    _, t, projs = setup
    path = str(tmp_path / "tuning.json")
    opts = dict(variant="algorithm1_mp", nb=2, proj_batch=4)
    with _svc(max_batch=2) as svc:
        stats = svc.warmup([t], tune=True, tune_budget_s=5.0,
                           tuning=path, **opts)
        b = stats.buckets[0]
        assert b.source == "tuned-measured"
        built = stats.cache["misses"]
        vol = svc.reconstruct(projs, t, **opts)
        assert svc.stats().cache["misses"] == built
        cfg = next(iter(svc._buckets.values())).config
    want = PlanExecutor.from_config(t, cfg, device="cpu").reconstruct(projs)
    assert np.array_equal(_np(vol), _np(want))
    with _svc(tuning=TuningCache(path)) as again:
        stats = again.warmup([t], tune=True, **opts)
        assert stats.buckets[0].source == "tuned-cache"


def test_solver_request_through_service(setup):
    """An iterative request rides a solver bucket with its own knobs and
    gives the direct solve's volume bit for bit."""
    _, t, projs = setup
    kw = dict(variant="algorithm1_mp", nb=2)
    want = repro_torch.reconstruct(projs, t, method="sart", device="cpu",
                                   n_iters=2, **kw)
    with _svc(max_batch=4) as svc:
        futs = [svc.submit(projs, t, solver="sart", n_iters=2, **kw)
                for _ in range(2)]
        got = [f.result() for f in futs]
        assert not next(iter(svc._buckets.values())) \
            .executor.supports_request_batching
    for v in got:
        assert torch.equal(v, want)


def test_service_spans(setup):
    """request.submit and stream.open instants, batch.form,
    service.dispatch and service.stream_dispatch spans, each dispatch
    carrying its requests' trace ids."""
    _, t, projs = setup
    opts = dict(variant="algorithm1_mp", nb=2, proj_batch=4)
    with telemetry.tracing():
        with _svc(max_batch=2) as svc:
            svc.warmup([t], **opts)
            futs = [svc.submit(projs, t, **opts) for _ in range(2)]
            for f in futs:
                f.result()
            with svc.open_stream(t, nb=2, proj_batch=2) as sess:
                sess.push(projs)
                sess.close()
        evs = telemetry.events()
    names = [e["name"] for e in evs]
    for name in ("request.submit", "batch.form", "service.dispatch",
                 "stream.open", "stream.push", "service.stream_dispatch",
                 "stream.fold", "stream.tail", "compile"):
        assert name in names, name
    ids = {f.trace_id for f in futs}
    dispatched = set()
    for e in evs:
        if e["name"] == "service.dispatch":
            dispatched |= set(e["args"]["trace_ids"])
    assert ids <= dispatched


def test_service_without_card_raises_here():
    """No silent CPU: the service's default device is the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ReconService()
