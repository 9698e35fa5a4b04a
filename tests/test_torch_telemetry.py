"""repro_torch's telemetry against the JAX package's, on the CPU.

The metrics and exporters (``Histogram`` quantiles, the registry's
Prometheus text, ``prom_name``/``prom_render``, ``EmitMixin``) give the
JAX module's output for the same samples; the span machinery keeps its
contracts on the port's paths: a closed span tree on the sync and async
walks with ``flush`` on the flusher lane, ``compile`` spans equal to the
program cache's misses, ``step.dispatch`` args equal to the JAX
package's for the same plan (variant, call shape, loop order, views),
the host path's spans (``recon.call`` over ``plan.build``,
``geometry.matrices``, ``filter.chunk``, ``filter.stack``, ``ingest``)
with their ``record_function`` ranges on the host clock, ``solve.iter``
per iteration under one ``solve``, Chrome trace JSON, the tuner trajectory,
and ``record_function`` ranges under ``REPRO_TRACE_NVTX=1``."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core.geometry import standard_geometry as j_geom
from repro.runtime import solvers as jsolvers
from repro.runtime import telemetry as jtel
from repro.runtime.executor import PlanExecutor as JExecutor
from repro.runtime.executor import ProgramCache as JCache
from repro.runtime.planner import plan_reconstruction as j_plan

import repro_torch
from repro_torch import convert
from repro_torch.runtime import executor, solvers
from repro_torch.runtime import telemetry
from repro_torch.runtime.executor import PlanExecutor, ProgramCache
from repro_torch.runtime.planner import plan_reconstruction
from repro_torch.runtime.service import ReconService

ROOT = Path(__file__).resolve().parents[1]
SAMPLES = [0.0, 3e-5, 1e-4, 7.5e-4, 0.002, 0.01, 0.01, 0.3, 2.5, 90.0]


@pytest.fixture(scope="module")
def setup():
    g = j_geom(n=16, n_det=24, n_proj=8)
    t = convert.geometry_from_reference(dataclasses.asdict(g))
    rng = np.random.RandomState(0)
    p = rng.rand(g.n_proj, g.nh, g.nw).astype(np.float32)
    return g, t, p


@pytest.fixture(autouse=True)
def _tracing_off():
    telemetry.disable()
    telemetry.clear()
    yield
    telemetry.disable()
    telemetry.clear()


def _x_events(events=None):
    evs = telemetry.events() if events is None else events
    return [e for e in evs if e.get("ph") == "X"]


def _check_span_tree():
    """Every span closed, every parent recorded, parent and child on one
    lane, the parent bracketing its children in time."""
    assert telemetry.open_span_count() == 0
    spans = {e["args"]["span_id"]: e for e in _x_events()}
    assert spans, "no spans recorded"
    for e in spans.values():
        pid = e["args"]["parent_id"]
        if pid is None:
            continue
        parent = spans[pid]
        assert parent["tid"] == e["tid"]
        assert parent["ts"] <= e["ts"] + 1.0
        assert parent["ts"] + parent["dur"] >= e["ts"] + e["dur"] - 1.0
    return spans


# ---------------------------------------------------------------------------
# metrics and exporters: the JAX module's output for the same samples


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 0.99, 1.0])
def test_histogram_quantiles_equal_jax(q):
    mine, ref = telemetry.Histogram("lat"), jtel.Histogram("lat")
    for s in SAMPLES:
        mine.record(s)
        ref.record(s)
    assert mine.quantile(q) == ref.quantile(q)
    assert mine.counts() == ref.counts() and mine.count == ref.count
    assert mine.mean() == ref.mean()
    both = telemetry.Histogram.merged([mine, mine])
    assert both.counts() == jtel.Histogram.merged([ref, ref]).counts()
    assert telemetry.Histogram().quantile(q) is None


def _fill(mod):
    reg = mod.MetricsRegistry()
    reg.counter("reqs").inc()
    reg.counter("reqs").inc(2)
    reg.gauge("queue.depth").set(3.5)
    for s in SAMPLES:
        reg.histogram("lat-s").record(s)
    return reg


def test_registry_prometheus_and_as_dict_equal_jax():
    mine, ref = _fill(telemetry), _fill(jtel)
    assert mine.prometheus() == ref.prometheus()
    assert mine.prometheus(prefix="svc") == ref.prometheus(prefix="svc")
    assert mine.as_dict() == ref.as_dict()
    with pytest.raises(TypeError):
        mine.gauge("reqs")
    mine.clear()
    assert mine.as_dict() == {}


@pytest.mark.parametrize("name", ["repro_reqs", "a.b-c d", "9lives",
                                  "ok:name_1", "ünï"])
def test_prom_name_equals_jax(name):
    assert telemetry.prom_name(name) == jtel.prom_name(name)


def test_prom_render_equals_jax():
    rows = [("repro_bucket_requests", "counter", "requests per bucket",
             [({"bucket": 'a"b\\c\nd', "variant": "subline_pl"}, 3),
              ({}, None)]),
            ("9gauge", "gauge", "g", [({}, 2.5)])]
    assert telemetry.prom_render(rows) == jtel.prom_render(rows)


def test_emit_mixin_equals_jax():
    def report(mixin):
        @dataclasses.dataclass
        class Report(mixin):
            requests: int = 4
            busy: float = 0.25
            ok: bool = True
            per: dict = dataclasses.field(
                default_factory=lambda: {"a": 1, "b": "x"})
            names: tuple = ("a",)

            @property
            def rate(self):
                return self.busy * 2
        return Report()

    mine, ref = report(telemetry.EmitMixin), report(jtel.EmitMixin)
    assert mine.as_dict() == ref.as_dict()
    assert mine.as_dict()["rate"] == 0.5           # @property included
    reg_m = mine.emit(telemetry.MetricsRegistry(), prefix="r")
    reg_r = ref.emit(jtel.MetricsRegistry(), prefix="r")
    assert reg_m.as_dict() == reg_r.as_dict()
    assert reg_m.prometheus() == reg_r.prometheus()


@pytest.mark.parametrize("method", ["sart", "cgls"])
def test_solve_report_contract_equals_jax(method):
    kw = dict(method=method, n_iters=2, precision="f32",
              residuals=(2.0, 1.0), compiles_iter1=2, compiles_warm=0,
              wall_s=0.5, extras={"lipschitz": 3.0})
    mine, ref = solvers.SolveReport(**kw), jsolvers.SolveReport(**kw)
    assert isinstance(mine, telemetry.EmitMixin)
    assert mine.as_dict() == ref.as_dict()
    assert mine.emit(telemetry.MetricsRegistry()).as_dict() == \
        ref.emit(jtel.MetricsRegistry()).as_dict()


# ---------------------------------------------------------------------------
# span machinery


def test_disabled_span_is_the_shared_noop():
    s1, s2 = telemetry.span("a", x=1), telemetry.span("b", nvtx=True)
    assert s1 is s2 and not s1.live
    with s1:
        telemetry.instant("tick")
    assert telemetry.events() == [] and not telemetry.enabled()


def test_span_nesting_errors_and_restore():
    with pytest.raises(ValueError):
        with telemetry.tracing():
            with telemetry.span("outer"):
                with telemetry.span("inner"):
                    raise ValueError("x")
    assert not telemetry.enabled()
    spans = {e["name"]: e for e in _x_events()}
    assert spans["inner"]["args"]["parent_id"] == \
        spans["outer"]["args"]["span_id"]
    assert spans["inner"]["args"]["error"] == "ValueError"
    _check_span_tree()
    a, b = telemetry.new_trace_id(), telemetry.new_trace_id("stream")
    assert a != b and a.startswith("req-") and b.startswith("stream-")


@pytest.mark.parametrize("schedule", ["step", "chunk"])
@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_span_tree_on_sync_and_async_walks(setup, schedule, pipeline):
    _, t, p = setup
    plan = plan_reconstruction(t, "algorithm1_mp", nb=2,
                               tile_shape=(8, 8, 16), proj_batch=4,
                               out="host", schedule=schedule)
    ex = PlanExecutor(t, plan, ProgramCache(), pipeline=pipeline,
                      device="cpu")
    with telemetry.tracing():
        ex.reconstruct(p)
    spans = _check_span_tree()
    names = [e["name"] for e in spans.values()]
    steps = [e for e in spans.values() if e["name"] == "step.dispatch"]
    launches = len(plan.steps) * (len(plan.chunks)
                                  if schedule == "chunk" else 1)
    assert len(steps) == launches
    assert names.count("filter.chunk") == len(plan.chunks)
    flushes = [e for e in spans.values() if e["name"] == "flush"]
    if pipeline == "async":
        assert flushes and {e["tid"] for e in flushes} == {"recon-flush"}
        assert all(e["args"]["parent_id"] is None for e in flushes)
    else:
        assert not flushes
    assert all(e["tid"] == "MainThread" for e in steps)


HOST_PATH = ("plan.build", "geometry.matrices", "filter.chunk",
             "filter.stack", "step.dispatch")


def _ancestors(spans, e):
    """Names of the spans that enclose ``e``, innermost first."""
    out, pid = [], e["args"]["parent_id"]
    while pid is not None:
        out.append(spans[pid]["name"])
        pid = spans[pid]["args"]["parent_id"]
    return out


@pytest.mark.parametrize("as_numpy", [True, False],
                         ids=["numpy", "tensor"])
def test_recon_call_holds_the_host_path(setup, as_numpy):
    """One reconstruct is one recon.call span holding the plan, the
    matrices, the filter, the stack and the dispatch; ingest appears (in
    it) only for a numpy scan."""
    _, t, p = setup
    scan = p if as_numpy else torch.from_numpy(p)
    with telemetry.tracing():
        repro_torch.reconstruct(
            scan, t, options=repro_torch.ReconOptions(
                variant="algorithm1_mp", nb=2, proj_batch=4),
            device="cpu")
    spans = _check_span_tree()
    calls = [e for e in spans.values() if e["name"] == "recon.call"]
    assert len(calls) == 1 and calls[0]["args"]["parent_id"] is None
    names = [e["name"] for e in spans.values()]
    for name in HOST_PATH:
        assert name in names, name
    ingest = [e for e in spans.values() if e["name"] == "ingest"]
    assert len(ingest) == (1 if as_numpy else 0)
    for e in spans.values():
        if e is not calls[0]:
            assert _ancestors(spans, e)[-1] == "recon.call", e["name"]
    if as_numpy:
        assert ingest[0]["args"]["bytes"] == p.nbytes
    # the filter and the stack lie beside each other, never nested
    for e in spans.values():
        if e["name"].startswith("filter."):
            assert not any(a.startswith("filter.")
                           for a in _ancestors(spans, e))


def _walk(t, p, walk):
    """Run one ``walk`` of the executor on scan ``p``."""
    if walk == "open_stream":
        plan = plan_reconstruction(t, "algorithm1_mp", nb=2, proj_batch=4,
                                   ingest="stream")
        se = PlanExecutor(t, plan, ProgramCache(),
                          device="cpu").open_stream()
        se.push(p)
        se.close()
        return plan
    plan = plan_reconstruction(t, "algorithm1_mp", nb=2, proj_batch=4)
    ex = PlanExecutor(t, plan, ProgramCache(), device="cpu")
    if walk == "execute_batch":
        ex.execute_batch([p, p])
    else:
        ex.reconstruct(p)
    return plan


@pytest.mark.parametrize("walk", ["reconstruct", "execute_batch",
                                  "open_stream"])
def test_one_matrices_span_per_walk(setup, walk):
    """Each walk builds the geometry's matrices once, in one
    geometry.matrices span; host scans enter through ingest spans (one a
    request, one a streamed chunk)."""
    _, t, p = setup
    with telemetry.tracing():
        plan = _walk(t, p, walk)
    spans = _check_span_tree()
    mats = [e for e in spans.values() if e["name"] == "geometry.matrices"]
    assert len(mats) == 1 and mats[0]["args"]["n_proj"] == t.n_proj
    ingest = [e for e in spans.values() if e["name"] == "ingest"]
    want = {"reconstruct": 1, "execute_batch": 2,
            "open_stream": len(plan.chunks)}[walk]
    assert len(ingest) == want
    if walk == "open_stream":
        assert sum(e["args"]["bytes"] for e in ingest) == p.nbytes


@pytest.mark.parametrize("walk", ["facade", "reconstruct", "execute_batch",
                                  "open_stream", "service"])
def test_disabled_walks_record_nothing(setup, walk):
    """With tracing off every span of a walk is the shared no-op: no
    event is recorded and no span is left open."""
    _, t, p = setup
    assert not telemetry.enabled()
    if walk == "facade":
        repro_torch.reconstruct(p, t, options=repro_torch.ReconOptions(
            variant="algorithm1_mp", nb=2), device="cpu")
    elif walk == "service":
        with ReconService(device="cpu", cache=ProgramCache(),
                          max_batch=2) as svc:
            futs = [svc.submit(p, t, variant="algorithm1_mp", nb=2)
                    for _ in range(3)]
            for f in futs:
                f.result()
    else:
        _walk(t, p, walk)
    assert telemetry.events() == [] and telemetry.open_span_count() == 0


@pytest.mark.parametrize("device,n_views,path", [
    ("cpu", 8, "pageable"), ("cuda", 8, "pageable"),
    ("cuda", 4096, "pinned")], ids=["cpu", "card-small", "card-large"])
def test_ingest_span_carries_its_path(setup, monkeypatch, device, n_views,
                                      path):
    """A live ingest span says how the scan went to the device: through
    the thread's pinned stager (a card, a MiB or more) or a plain copy;
    off, it records nothing. The card's copies are stood in for on the
    CPU."""
    _, t, p = setup
    scan = np.resize(p, (n_views,) + p.shape[1:])
    plan = plan_reconstruction(t, "algorithm1_mp", nb=2)
    ex = PlanExecutor(t, plan, ProgramCache(), device="cpu")
    ex.device = torch.device(device)

    class Stager:
        def ingest(self, arr):
            return torch.from_numpy(arr.copy())

    monkeypatch.setattr(executor, "_thread_stager", lambda dev: Stager())
    monkeypatch.setattr(executor, "tensor_from_numpy",
                        lambda a, dev: convert.tensor_from_numpy(a, "cpu"))
    ex._as_input("projections", scan)
    assert telemetry.events() == [] and telemetry.open_span_count() == 0
    with telemetry.tracing():
        got = ex._as_input("projections", scan)
    spans = _check_span_tree()
    assert [e["name"] for e in spans.values()] == ["ingest"]
    (e,) = spans.values()
    assert e["args"]["path"] == path and e["args"]["bytes"] == scan.nbytes
    assert np.array_equal(got.numpy(), scan)


def test_compile_spans_equal_cache_misses(setup):
    _, t, p = setup
    cache = ProgramCache()
    plan = plan_reconstruction(t, "algorithm1_mp", nb=2,
                               tile_shape=(8, 8, 16), out="device")
    ex = PlanExecutor(t, plan, cache, device="cpu")
    with telemetry.tracing():
        ex.reconstruct(p)
        cold = sum(e["name"] == "compile" for e in _x_events())
        assert cold == cache.stats()["misses"] > 0
        ex.reconstruct(p)        # warm: no new program, no compile span
        warm = sum(e["name"] == "compile" for e in _x_events())
    assert warm == cold == cache.stats()["misses"]
    _check_span_tree()


def _jax_step_args(g, p, plan_kw):
    jtel.disable()
    jtel.clear()
    plan = j_plan(g, "algorithm1_mp", **plan_kw)
    with jtel.tracing():
        JExecutor(g, plan, JCache()).reconstruct(jnp.asarray(p))
    return [e["args"] for e in jtel.events()
            if e.get("ph") == "X" and e["name"] == "step.dispatch"]


ROOFLINE_PLANS = [
    dict(nb=2, out="device"),
    dict(nb=2, out="device", schedule="chunk", proj_batch=4),
    dict(nb=2, tile_shape=(8, 8, 5), out="host"),
    dict(nb=4, tile_shape=(8, 16, 16), proj_batch=4, out="host",
         schedule="chunk"),
]


@pytest.mark.parametrize("plan_kw", ROOFLINE_PLANS)
def test_step_dispatch_args_equal_jax(setup, plan_kw):
    """The args of every step launch equal the JAX package's for the
    same plan: the variant, call shape, loop order and views."""
    g, t, p = setup
    plan = plan_reconstruction(t, "algorithm1_mp", **plan_kw)
    with telemetry.tracing():
        PlanExecutor(t, plan, ProgramCache(), device="cpu").reconstruct(p)
    keys = ("variant", "call_shape", "schedule", "n_views")
    mine = [{k: e["args"][k] for k in keys} for e in _x_events()
            if e["name"] == "step.dispatch"]
    ref = [{k: a[k] for k in keys} for a in _jax_step_args(g, p, plan_kw)]
    assert mine == ref and mine


@pytest.mark.parametrize("method,kw", [("sart", {}),
                                       ("os_sart", {"proj_batch": 4}),
                                       ("cgls", {}), ("fista_tv", {})])
def test_solve_iter_spans_per_method(method, kw):
    t = convert.geometry_from_reference(dataclasses.asdict(
        j_geom(n=8, n_det=12, n_proj=8)))
    p = np.random.RandomState(1).rand(8, t.nh, t.nw).astype(np.float32)
    with telemetry.tracing():
        _, report = solvers.solve(p, t, method, n_iters=3, nb=2,
                                  tv_inner=2, cache=ProgramCache(),
                                  device="cpu", **kw)
    spans = _check_span_tree()
    top = [e for e in spans.values() if e["name"] == "solve"]
    iters = [e for e in spans.values() if e["name"] == "solve.iter"]
    assert len(top) == 1 and len(iters) == 3
    assert top[0]["args"]["method"] == method
    assert [e["args"]["i"] for e in iters] == [0, 1, 2]
    assert all(e["args"]["parent_id"] == top[0]["args"]["span_id"]
               and e["args"]["method"] == method for e in iters)
    assert report.as_dict()["n_iters"] == 3


def test_dump_trace_is_chrome_trace_json(setup, tmp_path):
    _, t, p = setup
    plan = plan_reconstruction(t, "algorithm1_mp", nb=2,
                               tile_shape=(8, 8, 16), out="host")
    path = tmp_path / "recon.trace.json"
    with telemetry.tracing(str(path)):
        PlanExecutor(t, plan, ProgramCache(), pipeline="async",
                     device="cpu").reconstruct(p)
    doc = json.loads(path.read_text())
    evs = doc["traceEvents"]
    lanes = {e["args"]["name"] for e in evs
             if e.get("ph") == "M" and e["name"] == "thread_name"}
    assert {"MainThread", "recon-flush"} <= lanes
    assert doc["otherData"]["dropped_events"] == 0
    for e in evs:
        if e.get("ph") == "X":
            assert isinstance(e["tid"], int)
            assert e["dur"] >= 0 and e["ts"] >= 0


def test_record_tuning_appends_and_mirrors(tmp_path, monkeypatch):
    path = tmp_path / "TUNE_TRAJECTORY.json"
    monkeypatch.setenv(telemetry.TUNE_TRAJECTORY_ENV, str(path))
    rec = dict(fingerprint="cpu|x", bucket_key="auto|...",
               heuristic_wall=120.0, tuned_wall=80.0, ratio=1.5,
               tuned_at=1700000000.0, shape=(1, 2))
    n0 = len(telemetry.tune_trajectory())
    telemetry.record_tuning(rec)
    telemetry.record_tuning(dict(rec, bucket_key="explicit|..."))
    doc = json.loads(path.read_text())
    assert doc["suite"] == "tune_trajectory" and len(doc["records"]) == 2
    assert doc["records"][0]["shape"] == [1, 2]     # JSON-safe copy
    assert len(telemetry.tune_trajectory()) == n0 + 2
    out = telemetry.dump_tune_trajectory(str(tmp_path / "all.json"))
    assert json.loads(Path(out).read_text())["records"][-1][
        "bucket_key"] == "explicit|..."


_NVTX_SCRIPT = r"""
import json
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.core.geometry import standard_geometry
from repro_torch.runtime import telemetry
from repro_torch.runtime.executor import PlanExecutor, ProgramCache
from repro_torch.runtime.planner import plan_reconstruction

g = standard_geometry(n=8, n_det=12, n_proj=4)
p = np.random.RandomState(0).rand(4, g.nh, g.nw).astype(np.float32)
plan = plan_reconstruction(g, "algorithm1_mp", nb=2, out="device")
ex = PlanExecutor(g, plan, ProgramCache(), device="cpu")
with profile(activities=[ProfilerActivity.CPU]) as prof:
    with telemetry.tracing():
        ex.reconstruct(p)
names = sorted({e.name for e in prof.events()})
steps = [e for e in telemetry.events() if e["name"] == "step.dispatch"]
print("RESULT:" + json.dumps({"names": names, "spans": len(steps)}))
"""


@pytest.mark.parametrize("flag,shown", [("1", True), ("0", False)])
def test_nvtx_ranges_in_profiler_trace(flag, shown):
    """With REPRO_TRACE_NVTX=1 (read at import, so in a fresh process)
    the step spans are record_function ranges in a CPU profile; without
    it the profile holds none, and the spans are recorded either way."""
    env = dict(os.environ, REPRO_TRACE_NVTX=flag,
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _NVTX_SCRIPT], env=env,
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("RESULT:")][-1]
    out = json.loads(line[len("RESULT:"):])
    assert out["spans"] == 1
    assert ("step.dispatch" in out["names"]) is shown


_CLOCK_SCRIPT = r"""
import json, os, tempfile
import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile
import repro_torch
from repro_torch.core.geometry import standard_geometry
from repro_torch.runtime import telemetry

torch.set_num_threads(1)
NVTX = ("ingest", "geometry.matrices", "filter.chunk", "filter.stack",
        "step.dispatch")
g = standard_geometry(n=8, n_det=12, n_proj=8)
p = np.random.RandomState(0).rand(8, g.nh, g.nw).astype(np.float32)
opts = repro_torch.ReconOptions(variant="algorithm1_mp", nb=2, proj_batch=2)
with profile(activities=[ProfilerActivity.CPU]) as prof:
    for _ in range(2):        # the first call opens the profile's first ranges
        with telemetry.tracing():
            repro_torch.reconstruct(p, g, options=opts, device="cpu")
spans = sorted((e["name"], e["ts"], e["ts"] + e["dur"])
               for e in telemetry.events()
               if e.get("ph") == "X" and e["name"] in NVTX)
fd, path = tempfile.mkstemp(suffix=".json")
os.close(fd)
prof.export_chrome_trace(path)
with open(path) as f:
    doc = json.load(f)
os.unlink(path)
ranges = sorted((e["name"], e["ts"], e["ts"] + e["dur"])
                for e in doc["traceEvents"]
                if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e["name"] in NVTX)
print("RESULT:" + json.dumps({"spans": spans, "ranges": ranges}))
"""


def test_nvtx_spans_share_the_profilers_clock():
    """Each nvtx span's interval on the host clock (time.perf_counter),
    moved by one offset, lies within 100 us of its record_function range
    on the profiler's timeline: the benchmark maps program spans onto
    the trace with one offset."""
    env = dict(os.environ, REPRO_TRACE_NVTX="1",
               PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _CLOCK_SCRIPT], env=env,
                         cwd=str(ROOT), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("RESULT:")][-1]
    out = json.loads(line[len("RESULT:"):])
    spans = sorted(out["spans"], key=lambda r: r[1])
    # the second call's ranges: the last ones on the timeline
    ranges = sorted(out["ranges"], key=lambda r: r[1])[-len(spans):]
    assert {n for n, _, _ in spans} == {
        "ingest", "geometry.matrices", "filter.chunk", "filter.stack",
        "step.dispatch"}
    assert [n for n, _, _ in ranges] == [n for n, _, _ in spans]
    offset = float(np.median([r[1] - s[1] for r, s in zip(ranges, spans)]))
    for (name, a, b), (_, ra, rb) in zip(spans, ranges):
        assert abs(ra - (a + offset)) <= 100.0, (name, ra - a - offset)
        assert abs(rb - (b + offset)) <= 100.0, (name, rb - b - offset)
