"""repro_torch's online (streaming) ingest against the JAX package, on the
CPU.

The port of ``tests/test_streaming.py``: pushing views as they arrive
and folding each view chunk once it is complete gives a volume
BIT-IDENTICAL to the port's offline chunk-major reconstruction of the
same views, and within rel-RMSE 1e-5 of the JAX package's stream of the
same numpy views (its ``subline_pl`` runs its Pallas kernel in interpret
mode, as its own tests run it). The cases: the plan's ingest axis,
arrival-order permutations within a chunk, a ragged tail chunk, a slow
and a fast producer (the bounded arrival queue), six variants, the
service's sessions (concurrent same-bucket sessions folded as one lane
launch per step), and an error in a fold reaching ``close()``.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core.geometry import standard_geometry as j_geom
from repro.runtime.executor import PlanExecutor as JExecutor
from repro.runtime.executor import ProgramCache as JCache
from repro.runtime.planner import plan_reconstruction as j_plan

from repro_torch import convert
from repro_torch.runtime.executor import PlanExecutor, ProgramCache
from repro_torch.runtime.planner import plan_reconstruction
from repro_torch.runtime.service import ReconService

from conftest import rel_rmse

BAR = 1e-5
# shared across the module: streaming must reuse, not rebuild
_PCACHE = ProgramCache()
_JCACHE = JCache()

G = j_geom(n=16, n_det=24, n_proj=8)
GEOM = convert.geometry_from_reference(dataclasses.asdict(G))
PROJS = np.random.default_rng(11).normal(
    size=(GEOM.n_proj, GEOM.nh, GEOM.nw)).astype(np.float32)


def _stream_plan(geom=GEOM, variant="algorithm1_mp", *, nb=2,
                 proj_batch=2, **kw):
    return plan_reconstruction(geom, variant, nb=nb, proj_batch=proj_batch,
                               ingest="stream", **kw)


def _push_all(se, projs, order=None, group=1, dt=0.0):
    """Feed rows one by one (or ``group`` at a time) in ``order``."""
    n = projs.shape[0]
    order = list(range(n)) if order is None else list(order)
    for i in range(0, n, group):
        rows = order[i:i + group]
        for r in rows:
            se.push(projs[r], start=r)
        if dt:
            time.sleep(dt)


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _jax_stream(variant, projs=PROJS, g=G, *, nb=2, proj_batch=2, **kw):
    """The JAX package's stream of the same views."""
    plan = j_plan(g, variant, nb=nb, proj_batch=proj_batch, ingest="stream",
                  **kw)
    se = JExecutor(g, plan, cache=_JCACHE).open_stream()
    _push_all(se, projs)
    return np.asarray(se.close())


# ---------------------------------------------------------------------------
# plan-level: the ingest axis
# ---------------------------------------------------------------------------

def test_stream_plan_is_chunk_major_and_bucketed_apart():
    plan = _stream_plan()
    off = plan_reconstruction(GEOM, "algorithm1_mp", nb=2, proj_batch=2,
                              schedule="chunk")
    assert plan.ingest == "stream" and plan.schedule == "chunk"
    assert off.ingest == "offline"
    # same chunk partition (the exactness precondition), the JAX one ...
    assert plan.chunks == off.chunks == j_plan(
        G, "algorithm1_mp", nb=2, proj_batch=2, ingest="stream").chunks
    # ... but stream sessions never share a bucket with requests
    assert plan.bucket_key != off.bucket_key


def test_stream_plan_rejects_step_schedule():
    with pytest.raises(ValueError, match="stream"):
        plan_reconstruction(GEOM, "algorithm1_mp", nb=2, proj_batch=2,
                            ingest="stream", schedule="step")
    with pytest.raises(ValueError, match="ingest"):
        plan_reconstruction(GEOM, "algorithm1_mp", ingest="bogus")
    step = plan_reconstruction(GEOM, "algorithm1_mp", nb=2, proj_batch=2)
    with pytest.raises(ValueError, match="chunk-major"):
        PlanExecutor(GEOM, step, cache=_PCACHE, device="cpu").open_stream()


def test_stream_schedule_lists_per_chunk_work():
    plan = _stream_plan(proj_batch=2)   # 8 views / chunk_size 2
    s = plan.stream
    assert s.n_views == GEOM.n_proj
    assert s.n_chunks == len(plan.chunks) == 4
    assert [f.chunk.index for f in s.folds] == [0, 1, 2, 3]
    assert all(f.steps == plan.steps for f in s.folds)


# ---------------------------------------------------------------------------
# executor-level parity: streamed == offline, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant,jax_variant", [
    ("algorithm1_mp", "algorithm1_mp"),
    ("subline_batch_mp", "subline_batch_mp"),
    ("symmetry_mp", "symmetry_mp"),
    ("subline_pl", "subline_pl"),           # K1/K2 plain (JAX: interpret)
    ("onehot_pl", "algorithm1_mp"),         # K3/K4 plain
    ("banded_pl", "algorithm1_mp"),         # K5/K6 plain
])
def test_stream_parity_across_variants(variant, jax_variant):
    plan = _stream_plan(variant=variant)
    ex = PlanExecutor(GEOM, plan, cache=_PCACHE, device="cpu")
    ref = _np(ex.reconstruct(PROJS))
    se = ex.open_stream()
    _push_all(se, PROJS)
    got = _np(se.close())
    assert np.array_equal(got, ref)
    assert rel_rmse(got, _jax_stream(jax_variant)) < BAR


def test_stream_parity_tiled_async_host_out():
    plan = _stream_plan(tile_shape=(8, 8, 16), out="host")
    ex = PlanExecutor(GEOM, plan, cache=_PCACHE, pipeline="async",
                      device="cpu")
    ref = _np(ex.reconstruct(PROJS))
    se = ex.open_stream()
    _push_all(se, PROJS, group=3)       # pushes need not align to chunks
    got = se.close()
    assert isinstance(got, np.ndarray)
    assert np.array_equal(got, ref)
    assert rel_rmse(got, _jax_stream("algorithm1_mp", tile_shape=(8, 8, 16),
                                     out="host")) < BAR


def test_stream_parity_device_out():
    plan = _stream_plan(out="device", tile_shape=(8, 8, 8))
    ex = PlanExecutor(GEOM, plan, cache=_PCACHE, device="cpu")
    ref = _np(ex.reconstruct(PROJS))
    se = ex.open_stream()
    _push_all(se, PROJS)
    got = se.close()
    assert isinstance(got, torch.Tensor)
    assert np.array_equal(_np(got), ref)
    assert rel_rmse(_np(got), _jax_stream("algorithm1_mp")) < BAR


def test_stream_parity_under_within_chunk_permutation():
    # arrival order inside a chunk must not matter: the chunk buffer is
    # assembled by row index, and filtering and folding only start once
    # the chunk is COMPLETE
    plan = _stream_plan(proj_batch=4)   # chunks of 4 views
    ex = PlanExecutor(GEOM, plan, cache=_PCACHE, device="cpu")
    ref = _np(ex.reconstruct(PROJS))
    order = [2, 0, 3, 1, 6, 5, 4, 7]    # permuted within each chunk
    se = ex.open_stream()
    _push_all(se, PROJS, order=order)
    assert np.array_equal(_np(se.close()), ref)


def test_stream_parity_ragged_tail_chunk():
    g = j_geom(n=16, n_det=24, n_proj=10)
    geom = convert.geometry_from_reference(dataclasses.asdict(g))
    projs = np.random.default_rng(5).normal(
        size=(10, geom.nh, geom.nw)).astype(np.float32)
    # chunk_size 8 over n_proj_padded -> the tail chunk holds 2 raw views
    plan = plan_reconstruction(geom, "algorithm1_mp", nb=4, proj_batch=8,
                               ingest="stream")
    assert plan.chunks[-1][1] > geom.n_proj  # the tail IS ragged
    ex = PlanExecutor(geom, plan, cache=_PCACHE, device="cpu")
    ref = _np(ex.reconstruct(projs))
    se = ex.open_stream()
    _push_all(se, projs, group=3)       # 3 never divides either chunk
    got = _np(se.close())
    assert np.array_equal(got, ref)
    assert rel_rmse(got, _jax_stream("algorithm1_mp", projs, g, nb=4,
                                     proj_batch=8)) < BAR


def test_stream_slow_producer_starves_folder():
    # the folder idles between arrivals; every chunk still folds in order
    plan = _stream_plan(proj_batch=2)
    ex = PlanExecutor(GEOM, plan, cache=_PCACHE, device="cpu")
    ref = _np(ex.reconstruct(PROJS))
    se = ex.open_stream()
    _push_all(se, PROJS, dt=0.01)
    assert np.array_equal(_np(se.close()), ref)
    rep = se.report
    assert rep.n_chunks == 4 and rep.n_views == 8
    assert rep.acquire_s > 0.0 and 0.0 <= rep.hidden_fraction <= 1.0


def test_stream_fast_producer_hits_backpressure():
    # a producer faster than the folder blocks on the bounded arrival
    # queue instead of buffering the whole scan
    plan = _stream_plan(proj_batch=2)
    ex = PlanExecutor(GEOM, plan, cache=_PCACHE, device="cpu")
    ref = _np(ex.reconstruct(PROJS))
    se = ex.open_stream(max_pending_chunks=1)
    _push_all(se, PROJS)                # as fast as push() admits
    assert np.array_equal(_np(se.close()), ref)
    assert se.max_pending_seen <= 1
    with pytest.raises(ValueError, match="max_pending_chunks"):
        ex.open_stream(max_pending_chunks=0)


def test_stream_push_errors():
    ex = PlanExecutor(GEOM, _stream_plan(), cache=_PCACHE, device="cpu")
    se = ex.open_stream()
    se.push(PROJS[0], start=0)
    with pytest.raises(ValueError, match="twice"):
        se.push(PROJS[0], start=0)
    with pytest.raises(ValueError):
        se.push(PROJS[0], start=GEOM.n_proj + 3)
    with pytest.raises(ValueError, match="detector shape"):
        se.push(PROJS[1][:, :-1], start=1)
    with pytest.raises(RuntimeError, match="closed"):
        se.close()                      # 1 of 8 views delivered
    with pytest.raises(RuntimeError):
        se.push(PROJS[1], start=1)      # stream already failed/closed


def test_stream_fold_error_reaches_close(monkeypatch):
    """Nothing is swallowed: a kernel error in the folder thread poisons
    the stream, and push/close raise it."""
    plan = _stream_plan(proj_batch=2)
    ex = PlanExecutor(GEOM, plan, cache=ProgramCache(), device="cpu")

    def boom(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(ex, "_program", lambda *a, **k: boom)
    se = ex.open_stream()
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        _push_all(se, PROJS)
        se.close()


# ---------------------------------------------------------------------------
# service sessions
# ---------------------------------------------------------------------------

def test_service_stream_session_parity_and_stats():
    projs2 = np.random.default_rng(7).normal(
        size=PROJS.shape).astype(np.float32)
    svc = ReconService(max_inflight=1, max_batch=2, max_wait_ms=150.0,
                       cache=_PCACHE, device="cpu")
    try:
        s1 = svc.open_stream(GEOM, nb=2, proj_batch=2)
        s2 = svc.open_stream(GEOM, nb=2, proj_batch=2)
        for v in range(GEOM.n_proj):    # lockstep: same rotation phase
            s1.push(PROJS[v], start=v)
            s2.push(projs2[v], start=v)
        v1, v2 = _np(s1.close()), _np(s2.close())
        bucket = next(b for b in svc._buckets.values()
                      if b.plan.ingest == "stream")
        oracle = PlanExecutor(GEOM, bucket.plan, cache=_PCACHE,
                              device="cpu")
        assert np.array_equal(v1, _np(oracle.reconstruct(PROJS)))
        assert np.array_equal(v2, _np(oracle.reconstruct(projs2)))
        assert rel_rmse(v1, _jax_stream("algorithm1_mp")) < BAR
        assert rel_rmse(v2, _jax_stream("algorithm1_mp", projs2)) < BAR
        st = svc.stats()
        assert st.streams == 2
        assert st.stream_tail_ms is not None
        assert st.stream_hidden_fraction is not None
        row = next(b for b in st.buckets if b.streams)
        assert row.streams == 2 and row.streams_closed == 2
        # 4 chunks a session: fully batched = 4 dispatches, worst case 8
        assert 4 <= row.stream_dispatches <= 8
        assert row.stream_mean_lanes >= 1.0
    finally:
        svc.close()


def test_service_stream_defaults_single_session():
    svc = ReconService(cache=_PCACHE, device="cpu")
    try:
        with svc.open_stream(GEOM) as sess:
            _push_all(sess, PROJS)
            vol = sess.close()
        bucket = next(b for b in svc._buckets.values()
                      if b.plan.ingest == "stream")
        assert bucket.plan.chunk_size == 8   # max(nb, n_proj // 8)
        ref = PlanExecutor(GEOM, bucket.plan, cache=_PCACHE,
                           device="cpu").reconstruct(PROJS)
        assert np.array_equal(_np(vol), _np(ref))
        assert sess.report is not None
        assert 0.0 <= sess.report.hidden_fraction <= 1.0
    finally:
        svc.close()


def test_service_stream_rejects_fleet():
    """The JAX service refuses a stream on a fleet, and so does the port's
    (a stream folds its chunks on one device)."""
    with ReconService(cache=_PCACHE, devices=("cpu",) * 2) as fleet_svc:
        with pytest.raises(ValueError, match="without devices="):
            fleet_svc.open_stream(GEOM)
    svc = ReconService(cache=_PCACHE, device="cpu")
    svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.open_stream(GEOM)


def test_service_stream_concurrent_feeders():
    # two producer threads at different paces; the shared stream worker
    # respects each session's own fold order
    projs2 = np.random.default_rng(3).normal(
        size=PROJS.shape).astype(np.float32)
    svc = ReconService(max_inflight=1, max_batch=2, max_wait_ms=20.0,
                       cache=_PCACHE, device="cpu")
    try:
        s1 = svc.open_stream(GEOM, nb=2, proj_batch=2)
        s2 = svc.open_stream(GEOM, nb=2, proj_batch=2)
        t1 = threading.Thread(target=_push_all, args=(s1, PROJS),
                              kwargs=dict(dt=0.005))
        t2 = threading.Thread(target=_push_all, args=(s2, projs2,
                                                      [1, 0, 3, 2, 5, 4,
                                                       7, 6]))
        t1.start()
        t2.start()
        t1.join()
        t2.join()
        v1, v2 = _np(s1.close()), _np(s2.close())
        bucket = next(b for b in svc._buckets.values()
                      if b.plan.ingest == "stream")
        oracle = PlanExecutor(GEOM, bucket.plan, cache=_PCACHE,
                              device="cpu")
        assert np.array_equal(v1, _np(oracle.reconstruct(PROJS)))
        assert np.array_equal(v2, _np(oracle.reconstruct(projs2)))
    finally:
        svc.close()


def test_stream_lane_fold_equals_solo_fold():
    """The service's lane fold of one chunk of two sessions (one
    ``batch_program`` launch per step) hands each session the part its
    solo fold computes, bit for bit."""
    plan = _stream_plan(tile_shape=(8, 8, 8), variant="subline_pl")
    ex = PlanExecutor(GEOM, plan, cache=_PCACHE, device="cpu")
    # no folder: every chunk may wait ready (no backpressure)
    a, b = (ex.open_stream(max_pending_chunks=4, on_ready=lambda c: None)
            for _ in range(2))
    _push_all(a, PROJS)
    _push_all(b, PROJS[::-1].copy())
    (ia, ma), (ib, _) = a.filtered(0), b.filtered(0)
    step = plan.steps[0]
    mat = ex._translated(ma, step)
    lanes = _PCACHE.batch_program(step.variant, step.call_shape, plan.nb,
                                  ex._dtype, plan.interpret, plan.options,
                                  rb=2)(torch.stack([ia, ib]), mat)
    solo = ex._program(step.variant, step.call_shape)
    assert torch.equal(lanes[0], solo(ia, mat))
    assert torch.equal(lanes[1], solo(ib, mat))
