"""repro_torch's request batching against the JAX package, on the CPU.

The port of ``tests/test_batching.py``: ``PlanExecutor.execute_batch``,
the rb axis of the plans, the ``_BatchFormer``, the service's batched
dispatch and the autotuner's ``max_batch``. The same numpy requests go
through the JAX package and the port: every batched volume of the port
is held against the JAX package's batched volume at rel-RMSE 1e-5 (its
``subline_pl`` and ``banded_pl`` run their Pallas kernels in interpret
mode, as its own tests run them), and against the port's solo
``reconstruct`` bit for bit. The former's waits run on an injected clock
and events, never on races of a few milliseconds.
"""

import dataclasses
import threading
from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import standard_geometry as j_geom
from repro.runtime.executor import PlanExecutor as JExecutor
from repro.runtime.executor import ProgramCache as JCache
from repro.runtime.planner import plan_reconstruction as j_plan

from repro_torch import convert
from repro_torch.kernels import backproject_banded as kb
from repro_torch.kernels import backproject_onehot as ko
from repro_torch.kernels import backproject_subline as ks
from repro_torch.runtime import autotune as at
from repro_torch.runtime.executor import (FleetConfig, PlanExecutor,
                                          ProgramCache)
from repro_torch.runtime.planner import plan_reconstruction
from repro_torch.runtime.service import ReconService, _BatchFormer, _Request

from conftest import rel_rmse

BAR = 1e-5
OPTS = dict(variant="algorithm1_mp", nb=2, proj_batch=4)
_JREF = {}


def _geoms(n=16, n_det=24, n_proj=6):
    g = j_geom(n=n, n_det=n_det, n_proj=n_proj)
    return g, convert.geometry_from_reference(dataclasses.asdict(g))


@pytest.fixture(scope="module")
def setup():
    g, t = _geoms()
    rng = np.random.RandomState(7)
    reqs = [rng.rand(g.n_proj, g.nh, g.nw).astype(np.float32)
            for _ in range(3)]
    return g, t, reqs


@pytest.fixture(autouse=True)
def _no_launches():
    """Everything here runs on CPU tensors: no kernel is ever launched."""
    for mod in (ks, ko, kb):
        mod.reset_launches()
    yield
    for mod in (ks, ko, kb):
        assert sum(mod.LAUNCHES.values()) == 0, mod.LAUNCHES


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_bit_identical(seq, bat):
    assert len(seq) == len(bat)
    for a, b in zip(seq, bat):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape
        assert np.array_equal(a, b)


def _jax_batch(setup, variant, **kw):
    """The JAX package's execute_batch of the three requests."""
    key = (variant, tuple(sorted(kw.items())))
    if key not in _JREF:
        g, _, reqs = setup
        plan = j_plan(g, variant, nb=2, proj_batch=4, **kw)
        ex = JExecutor(g, plan, cache=JCache(), pipeline="async")
        _JREF[key] = [np.asarray(v) for v in
                      ex.execute_batch([jnp.asarray(p) for p in reqs])]
    return _JREF[key]


# ---- executor: batched vs sequential bit-parity ---------------------------

@pytest.mark.parametrize("variant,kw,jax_variant", [
    ("algorithm1_mp", {}, "algorithm1_mp"),             # untiled plain
    ("subline_batch_mp", dict(tile_shape=(8, 8, 16)),   # tiled
     "subline_batch_mp"),
    ("share_mp", dict(tile_shape=(8, 8, 8)), "share_mp"),  # paired slabs
    ("subline_pl", {}, "subline_pl"),        # K1/K2 plain (JAX: interpret)
    ("banded_pl", {}, "banded_pl"),          # K5/K6 plain, one band search
    ("onehot_pl", dict(tile_shape=(8, 8, 8)), "algorithm1_mp"),  # K3/K4
])
def test_execute_batch_bit_identical(setup, variant, kw, jax_variant):
    g, t, reqs = setup
    plan = plan_reconstruction(t, variant, nb=2, proj_batch=4, **kw)
    ex = PlanExecutor(t, plan, cache=ProgramCache(), pipeline="async",
                      device="cpu")
    seq = [ex.reconstruct(p) for p in reqs]
    bat = ex.execute_batch(reqs)
    _assert_bit_identical(seq, bat)
    jkw = kw if jax_variant == variant else {}
    for got, want in zip(bat, _jax_batch(setup, jax_variant, **jkw)):
        assert rel_rmse(_np(got), want) < BAR


def test_execute_batch_device_out(setup):
    g, t, reqs = setup
    plan = plan_reconstruction(t, "algorithm1_mp", nb=2, proj_batch=4,
                               out="device")
    ex = PlanExecutor(t, plan, cache=ProgramCache(), device="cpu")
    seq = [ex.reconstruct(p) for p in reqs]
    bat = ex.execute_batch(reqs)
    assert all(isinstance(v, torch.Tensor) for v in bat)
    _assert_bit_identical(seq, bat)
    for got, want in zip(bat, _jax_batch(setup, "algorithm1_mp")):
        assert rel_rmse(_np(got), want) < BAR


def test_execute_batch_fleet(setup):
    """As in the JAX package, a batch runs under a fleet: one rb-lane
    fleet program a step (``batch_fleet_program``), every lane equal to
    the request's solo reconstruct bit for bit and to the JAX package's
    batched volume. Without a card, a fleet of CUDA devices raises
    (tests/test_torch_fleet.py has the rest of the fleet)."""
    _, t, reqs = setup
    plan = plan_reconstruction(t, "algorithm1_mp", nb=2, proj_batch=4,
                               tile_shape=(8, 8, 16), out="host")
    cache = ProgramCache()
    ex = PlanExecutor(t, plan, cache=cache,
                      fleet=FleetConfig(devices=("cpu",) * 3))
    seq = [ex.reconstruct(p) for p in reqs]
    ex.warm_batch(len(reqs))
    assert any(k[0] == "batch_fleet" for k in cache._programs)
    bat = ex.execute_batch(reqs)
    _assert_bit_identical(seq, bat)
    assert ex.last_fleet_report.n_devices == 3
    for got, want in zip(bat, _jax_batch(setup, "algorithm1_mp",
                                         tile_shape=(8, 8, 16),
                                         out="host")):
        assert rel_rmse(_np(got), want) < BAR
    prog = cache.batch_fleet_program("algorithm1_mp", (16, 16, 16), 2,
                                     "float32", True, n_chunks=2,
                                     chunk_size=4, rb=2)
    assert callable(prog)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ReconService(devices=1, device="cpu")


def test_execute_batch_edges(setup):
    _, t, reqs = setup
    plan = plan_reconstruction(t, "algorithm1_mp", nb=2, proj_batch=4)
    ex = PlanExecutor(t, plan, cache=ProgramCache(), device="cpu")
    assert ex.execute_batch([]) == []
    one = ex.execute_batch(reqs[:1])                 # delegates
    _assert_bit_identical([ex.reconstruct(reqs[0])], one)
    with pytest.raises(ValueError, match="projections"):
        ex.execute_batch([reqs[0], reqs[1][:3]])     # wrong view count
    chunk = plan_reconstruction(t, "algorithm1_mp", nb=2, proj_batch=4,
                                schedule="chunk")
    cex = PlanExecutor(t, chunk, cache=ProgramCache(), device="cpu")
    assert not cex.supports_request_batching
    with pytest.raises(ValueError, match="step"):
        cex.execute_batch(reqs)
    assert ex.supports_request_batching


def test_warm_batch_precompiles(setup):
    _, t, _ = setup
    plan = plan_reconstruction(t, "algorithm1_mp", nb=2, proj_batch=4)
    cache = ProgramCache()
    ex = PlanExecutor(t, plan, cache=cache, device="cpu")
    ex.warm()
    before = cache.stats()["misses"]
    ex.warm_batch(3)
    assert cache.stats()["misses"] == before + 1     # the rb=3 program
    ex.warm_batch(3)                                 # idempotent: a hit
    assert cache.stats()["misses"] == before + 1
    ex.warm_batch(1)                                 # rb < 2: nothing
    assert cache.stats()["misses"] == before + 1


# ---- planner: the rb axis -------------------------------------------------

def test_request_batch_not_in_bucket_key(setup):
    g, t, reqs = setup
    a = plan_reconstruction(t, "algorithm1_mp", nb=2, proj_batch=4)
    b = plan_reconstruction(t, "algorithm1_mp", nb=2, proj_batch=4,
                            request_batch=4)
    assert b.request_batch == 4
    assert a.bucket_key == b.bucket_key      # rb is NOT bucket identity
    assert b.working_set_bytes == 4 * a.working_set_bytes
    assert b.working_set_bytes == j_plan(g, "algorithm1_mp", nb=2,
                                         proj_batch=4,
                                         request_batch=4).working_set_bytes
    assert a.batched(4) == b
    assert b.batched(4) is b
    with pytest.raises(ValueError, match="request_batch"):
        a.batched(0)
    with pytest.raises(ValueError, match="request_batch"):
        plan_reconstruction(t, "algorithm1_mp", request_batch=0)
    # an executor runs the batched plan as the solo one
    ex_a = PlanExecutor(t, a, cache=ProgramCache(), device="cpu")
    ex_b = PlanExecutor(t, b, cache=ProgramCache(), device="cpu")
    _assert_bit_identical(ex_a.execute_batch(reqs), ex_b.execute_batch(reqs))


def test_request_batch_scales_tile_budget(setup):
    g, t, _ = setup
    budget = 1 << 20
    solo = plan_reconstruction(t, "algorithm1_mp", nb=2,
                               memory_budget=budget)
    batched = plan_reconstruction(t, "algorithm1_mp", nb=2,
                                  memory_budget=budget, request_batch=8)
    # rb working sets must fit TOGETHER: the auto-picked tile shrinks
    # (or stays) and the rb-scaled working set honors the byte contract
    assert np.prod(batched.tile_shape) <= np.prod(solo.tile_shape)
    assert batched.working_set_bytes <= budget
    assert batched.tile_shape == j_plan(g, "algorithm1_mp", nb=2,
                                        memory_budget=budget,
                                        request_batch=8).tile_shape


# ---- BatchFormer semantics ------------------------------------------------

class _Clock:
    """A clock that advances ``step`` seconds at every read."""

    def __init__(self, step: float):
        self.t = 100.0
        self.step = step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def _req(key, deadline_s=None, priority=0):
    return _Request(fut=Future(), projections=None, geom=None, plan=None,
                    config=None, key=key, deadline_s=deadline_s,
                    priority=priority)


def test_former_cap1_is_fifo():
    f = _BatchFormer(max_wait_s=0.0, cap_fn=lambda r: 1)
    for key in ("a", "b", "a"):
        f.put(_req(key))
    assert [f.take()[0].key for _ in range(3)] == ["a", "b", "a"]
    f.close()
    assert f.take() is None


def test_former_gathers_same_bucket_only():
    f = _BatchFormer(max_wait_s=0.0, cap_fn=lambda r: 4)
    for key in ("a", "b", "a", "c", "a", "b"):
        f.put(_req(key))
    batch = f.take()
    assert [r.key for r in batch] == ["a", "a", "a"]   # never cross-batch
    # other buckets keep their relative FIFO order
    assert [r.key for r in f.take()] == ["b", "b"]
    assert [r.key for r in f.take()] == ["c"]


def test_former_tail_batch_respects_cap():
    f = _BatchFormer(max_wait_s=0.0, cap_fn=lambda r: 4)
    for _ in range(6):
        f.put(_req("a"))
    assert len(f.take()) == 4
    assert len(f.take()) == 2                # the tail, k % cap != 0


def test_former_waits_for_late_peer():
    """The late peer is put only once the head was taken (an event set by
    ``cap_fn``); the clock never advances, so nothing but the peer can
    end the wait: no race with a sleep."""
    headed = threading.Event()

    def cap(r):
        headed.set()
        return 2

    f = _BatchFormer(max_wait_s=5.0, cap_fn=cap, clock=lambda: 0.0)
    out = []
    t = threading.Thread(target=lambda: out.append(f.take()))
    f.put(_req("a"))
    t.start()
    assert headed.wait(30.0)
    f.put(_req("b"))                         # another bucket: no peer
    f.put(_req("a"))                         # the late peer
    t.join(timeout=30.0)
    assert not t.is_alive()
    assert [r.key for r in out[0]] == ["a", "a"]   # coalesced
    f.close()                    # a closed former ships partial batches
    assert [r.key for r in f.take()] == ["b"]
    assert f.take() is None


def test_former_deadline_bypass():
    # the deadline is 0.05 s of clock ahead and the clock moves 1 s a
    # read: the batch ships instead of waiting out the 30 s max_wait
    clock = _Clock(1.0)
    f = _BatchFormer(max_wait_s=30.0, cap_fn=lambda r: 4,
                     est_fn=lambda r: 0.0, clock=clock)
    f.put(_req("a", deadline_s=clock.t + 0.05))
    t0 = clock.t
    batch = f.take()
    assert len(batch) == 1
    assert clock.t - t0 < 5.0                # a few reads, not 30 s


def test_former_priority_never_waits():
    clock = _Clock(0.0)                      # time stands still
    f = _BatchFormer(max_wait_s=30.0, cap_fn=lambda r: 4, clock=clock)
    f.put(_req("a", priority=1))
    assert len(f.take()) == 1


def test_former_est_consumes_deadline_headroom():
    # headroom 10 s but the bucket's running estimate is 9.99 s: the
    # wait budget is ~0.01 s of a clock that moves 1 ms a read, so the
    # bound ends the wait after a few reads, not max_wait's 30 s
    clock = _Clock(0.001)
    f = _BatchFormer(max_wait_s=30.0, cap_fn=lambda r: 4,
                     est_fn=lambda r: 9.99, clock=clock)
    f.put(_req("a", deadline_s=clock.t + 10.0))
    t0 = clock.t
    assert len(f.take()) == 1
    assert clock.t - t0 < 1.0


def test_former_put_after_close_raises():
    f = _BatchFormer(max_wait_s=0.0, cap_fn=lambda r: 1)
    f.close()
    with pytest.raises(RuntimeError, match="closed"):
        f.put(_req("a"))


# ---- service integration --------------------------------------------------

def _jax_solo(g, reqs, **opts):
    from repro.core import fdk_reconstruct
    return [np.asarray(fdk_reconstruct(jnp.asarray(p), g, **opts))
            for p in reqs]


def test_service_batched_burst_bit_identical(setup):
    g, t, reqs = setup
    ref_svc = ReconService(max_inflight=1, cache=ProgramCache(),
                           device="cpu")
    ref = [_np(ref_svc.reconstruct(p, t, **OPTS)) for p in reqs]
    ref_svc.close()

    svc = ReconService(max_inflight=1, max_batch=4, cache=ProgramCache(),
                       device="cpu")
    svc.warmup([t], **OPTS)
    futs = [svc.submit(p, t, **OPTS) for p in reqs + reqs]  # k=6
    out = [_np(f.result()) for f in futs]
    _assert_bit_identical(ref + ref, out)
    for got, want in zip(out, _jax_solo(g, reqs + reqs, **OPTS)):
        assert rel_rmse(got, want) < BAR
    st = svc.stats()
    b = st.buckets[0]
    assert b.completed == 6
    # 6 = 4 + 2 under cap 4 (the first take may catch fewer if the burst
    # was still enqueueing, so bound rather than pin the count)
    assert b.dispatches < 6
    assert b.max_batch == 4
    assert b.mean_occupancy > 1.0
    assert b.amortized_us_per_request is not None
    assert b.batch_p50_ms is not None
    assert st.mean_occupancy == b.mean_occupancy
    svc.close()


def test_service_mixed_buckets_never_cross_batch(setup):
    g, t, reqs = setup
    gb, tb = _geoms(n=8, n_det=12, n_proj=6)
    rng = np.random.RandomState(11)
    reqs_b = [rng.rand(6, 12, 12).astype(np.float32) for _ in range(3)]
    ref_svc = ReconService(max_inflight=1, cache=ProgramCache(),
                           device="cpu")
    ref_a = [_np(ref_svc.reconstruct(p, t, **OPTS)) for p in reqs]
    ref_b = [_np(ref_svc.reconstruct(p, tb, **OPTS)) for p in reqs_b]
    ref_svc.close()

    svc = ReconService(max_inflight=1, max_batch=4, cache=ProgramCache(),
                       device="cpu")
    svc.warmup([t, tb], **OPTS)
    futs = []
    for pa, pb in zip(reqs, reqs_b):         # interleaved A B A B A B
        futs.append((svc.submit(pa, t, **OPTS), "a"))
        futs.append((svc.submit(pb, tb, **OPTS), "b"))
    out_a = [_np(f.result()) for f, tag in futs if tag == "a"]
    out_b = [_np(f.result()) for f, tag in futs if tag == "b"]
    # volumes of two shapes through one interleaved burst, each equal to
    # its own bucket's solo run: no batch ever mixed buckets
    _assert_bit_identical(ref_a, out_a)
    _assert_bit_identical(ref_b, out_b)
    for got, want in zip(out_b, _jax_solo(gb, reqs_b, **OPTS)):
        assert rel_rmse(got, want) < BAR
    st = svc.stats()
    assert len(st.buckets) == 2
    assert all(b.completed == 3 for b in st.buckets)
    svc.close()


def test_service_deadline_and_priority_bypass(setup):
    """max_wait is an hour: only the bypass paths let these finish (a
    cold bucket's deadline ships at once, priority ships at once)."""
    _, t, reqs = setup
    svc = ReconService(max_inflight=1, max_batch=4,
                       max_wait_ms=3_600_000.0, cache=ProgramCache(),
                       device="cpu")
    svc.warmup([t], **OPTS)
    a = svc.submit(reqs[0], t, deadline_ms=50.0, **OPTS).result(timeout=120)
    b = svc.submit(reqs[1], t, priority=1, **OPTS).result(timeout=120)
    plan = next(iter(svc._buckets.values())).plan
    _assert_bit_identical([a, b], [PlanExecutor(t, plan, device="cpu")
                                   .reconstruct(p) for p in reqs[:2]])
    with pytest.raises(ValueError, match="deadline_ms"):
        svc.submit(reqs[0], t, deadline_ms=-1.0, **OPTS)
    svc.close()


def test_service_chunk_major_falls_back_sequential(setup):
    g, t, reqs = setup
    opts = dict(OPTS, schedule="chunk")
    ref_svc = ReconService(max_inflight=1, cache=ProgramCache(),
                           device="cpu")
    ref = [_np(ref_svc.reconstruct(p, t, **opts)) for p in reqs]
    ref_svc.close()
    svc = ReconService(max_inflight=1, max_batch=4, cache=ProgramCache(),
                       device="cpu")
    svc.warmup([t], **opts)
    assert not next(iter(svc._buckets.values())) \
        .executor.supports_request_batching
    futs = [svc.submit(p, t, **opts) for p in reqs]
    out = [_np(f.result()) for f in futs]
    _assert_bit_identical(ref, out)          # formed, then run one by one
    for got, want in zip(out, _jax_solo(g, reqs, **opts)):
        assert rel_rmse(got, want) < BAR
    svc.close()


def test_service_validates_batch_knobs():
    with pytest.raises(ValueError, match="max_batch"):
        ReconService(max_batch=0, device="cpu")
    with pytest.raises(ValueError, match="max_wait_ms"):
        ReconService(max_wait_ms=-1.0, device="cpu")
    with pytest.raises(ValueError, match="max_inflight"):
        ReconService(max_inflight=0, device="cpu")


def _measured(**kw):
    base = dict(variant="algorithm1_mp", schedule="step", pipeline="async",
                pipeline_depth=2, tile_shape=(16, 16, 16), proj_batch=4,
                nb=2, out="host", interpret=True, max_batch=2,
                source="measured")
    base.update(kw)
    return at.TunedConfig(**base)


def test_tuned_max_batch_caps_bucket():
    svc = ReconService(max_inflight=1, max_batch=8, cache=ProgramCache(),
                       device="cpu")
    measured = _measured()
    heur = dataclasses.replace(measured, source="heuristic", max_batch=1)
    assert svc._effective_cap(measured) == 2     # measured winner caps
    assert svc._effective_cap(heur) == 8         # heuristic: default cap
    assert svc._effective_cap(None) == 8
    svc.close()
    one = ReconService(max_inflight=1, max_batch=1, cache=ProgramCache(),
                       device="cpu")
    assert one._effective_cap(measured) == 1     # batching disabled
    one.close()


# ---- TunedConfig.max_batch round-trip -------------------------------------

def test_tuned_config_max_batch_roundtrip(setup):
    from repro.runtime.autotune import TunedConfig as JTuned
    from repro.runtime.autotune import _batch_axis as j_batch_axis
    g, t, reqs = setup
    cfg = _measured(max_batch=4, source="heuristic")
    back = at.TunedConfig.from_json(cfg.to_json())
    assert back == cfg and back.max_batch == 4
    assert cfg.key != dataclasses.replace(cfg, max_batch=1).key
    # pre-batching cache documents (no max_batch field) default to 1
    doc = cfg.to_json()
    del doc["max_batch"]
    assert at.TunedConfig.from_json(doc).max_batch == 1
    # the tuner's batch axis: step-major only, candidates exclude cur,
    # the JAX package's
    cands = at._batch_axis(cfg)
    assert sorted(c.max_batch for c in cands) == [1, 2, 8]
    jcfg = JTuned.from_json(cfg.to_json())
    assert sorted(c.max_batch for c in j_batch_axis(jcfg)) == [1, 2, 8]
    assert at._batch_axis(dataclasses.replace(cfg, schedule="chunk")) == []
    # the config re-plans with its rb baked into the working-set model,
    # and the measurement times the batched walk, amortized per request
    plan = cfg.build_plan(t)
    assert plan.request_batch == 4
    wall = at._measure_config(t, cfg, reqs[0], ProgramCache(), iters=1,
                              warmup=0, device="cpu")
    assert wall > 0.0


# ---- cold-start wait policy (no estimate -> no deadline wait) --------------

def test_former_cold_start_deadline_ships_immediately():
    """Before a bucket has ANY completed traffic its latency estimate is
    None; a partial batch with a deadline ships at once instead of
    waiting out its deadline against a fictitious estimate of 0."""
    clock = _Clock(0.0)                      # time stands still
    f = _BatchFormer(max_wait_s=30.0, cap_fn=lambda r: 4, clock=clock)
    f.put(_req("a", deadline_s=clock.t + 25.0))
    batch = f.take()
    assert [r.key for r in batch] == ["a"]


def test_service_estimate_none_until_traffic(setup):
    _, t, reqs = setup
    svc = ReconService(max_inflight=1, cache=ProgramCache(), device="cpu")
    try:
        plan, cfg, _skw = svc._plan(t, dict(OPTS))
        probe = _Request(fut=Future(), projections=None, geom=t,
                         plan=plan, config=cfg, key=(t, plan.bucket_key))
        assert svc._run_estimate(probe) is None      # cold start
        svc.reconstruct(reqs[0], t, **OPTS)
        assert svc._run_estimate(probe) is not None  # traffic -> estimate
    finally:
        svc.close()
