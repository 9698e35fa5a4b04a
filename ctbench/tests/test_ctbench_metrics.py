"""The metric readers' arithmetic on a small synthetic profiler trace."""

import math

import pytest

from ctbench.core import Run, _module, percentile
from ctbench.trace import Trace
from conftest import REPO

MAIN, WORKER = 100, 200
T0 = 5_000_000.0          # trace microseconds at the window's start
PERF0 = 42.0              # host clock (s) at the window's start


def ev(cat, name, ts, dur, tid=MAIN, corr=None, pid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": T0 + ts, "dur": dur,
         "pid": pid, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def kernel(name, ts, dur, corr, cat="kernel"):
    return ev(cat, name, ts, dur, tid=7, corr=corr, pid=0)


def launch(ts, corr, tid=MAIN):
    return ev("cuda_runtime", "cudaLaunchKernel", ts, 5, tid=tid, corr=corr)


def closed_loop_trace():
    """Two volumes: each a filter kernel and a copy outside
    step.dispatch, then a back-projection kernel inside it."""
    evs = [ev("user_annotation", "ctbench.window", 0, 1000)]
    for v, base in enumerate((0, 500)):
        evs += [ev("user_annotation", "ctbench.call", base + 10, 470),
                ev("user_annotation", "step.dispatch", base + 100, 20),
                launch(base + 20, 10 * v + 1), launch(base + 30, 10 * v + 2),
                launch(base + 105, 10 * v + 3),
                kernel("fft", base + 40, 50, 10 * v + 1),
                kernel("Memcpy HtoD", base + 90, 10, 10 * v + 2,
                       cat="gpu_memcpy"),
                kernel("tile_kernel", base + 110, 300, 10 * v + 3)]
    return {"traceEvents": evs}


def _run(config, **kw):
    r = Run(config=config, traffic={}, seed=1, seconds=1.0, device="cuda",
            traced=True, window_start=PERF0, **kw)
    return r


def read(name, run):
    return _module(REPO / "ctbench" / "metrics" / f"{name}.py").read(run)


P5 = {"volume": 512, "views": 512, "detector": 512}


def test_ctbench_trace_busy_idle_and_offset():
    t = Trace(closed_loop_trace(), PERF0)
    assert t.window_s == pytest.approx(1e-3)
    # busy: [40, 100) and [110, 410) in each volume
    assert t.busy_s() == pytest.approx(2 * 360e-6)
    assert t.to_trace(PERF0 + 1e-3) == pytest.approx(T0 + 1000)
    inside, rest = t.launched_inside("step.dispatch")
    assert [a.name for a in inside] == ["tile_kernel"] * 2
    assert len(rest) == 4
    assert [len(g) for g in t.by_call()] == [3, 3]
    assert t.top_device_ops(2) == [["tile_kernel", pytest.approx(600e-6)],
                                   ["fft", pytest.approx(100e-6)]]


def test_ctbench_batch_metrics():
    run = _run(P5, records=[{"done": 0.5}, {"done": 1.0}])
    run.trace = Trace(closed_loop_trace(), PERF0)
    least = 8 * 512 ** 4 / 67e12
    assert read("bp_roofline.batch", run) == pytest.approx(
        100 * 2 * least / 600e-6)
    assert read("prep_device_ms.batch", run) == pytest.approx(60e-3)
    # second volume's first activity at 540, first's last ends at 410
    assert read("host_gap_ms.batch", run) == pytest.approx(130e-3)
    assert read("device_idle_share.batch", run) == pytest.approx(
        1 - 720 / 1000)


def test_ctbench_roofline_count_is_the_algorithms():
    mod = _module(REPO / "ctbench" / "metrics" / "bp_roofline.batch.py")
    p10 = {"volume": 1300, "views": 512, "detector": 1024}
    assert mod.least_seconds(P5) == pytest.approx(8.205e-3, rel=1e-3)
    assert mod.least_seconds(p10) == pytest.approx(134.3e-3, rel=1e-3)
    tiny = {"volume": 4, "views": 1, "detector": 4096}
    # bytes bound: a scan much larger than the volume's updates
    assert mod.least_seconds(tiny) == pytest.approx(
        4 * (4096 ** 2 + 64) / 3.35e12)


def test_ctbench_served_metrics():
    evs = [ev("user_annotation", "ctbench.window", 0, 1000),
           launch(10, 1, tid=WORKER),
           kernel("Memcpy HtoD (Pageable -> Device)", 20, 100, 1,
                  cat="gpu_memcpy"),
           kernel("tile_kernel", 200, 400, 2)]
    records = [{"due": 0.0, "ok": True, "trace_id": "a", "latency": 0.3},
               {"due": 0.1, "ok": True, "trace_id": "b", "latency": 0.2},
               {"due": 0.2, "ok": False, "trace_id": "c",
                "latency": math.inf}]
    spans = [{"ph": "X", "name": "service.dispatch",
              "ts": (PERF0 + 0.15) * 1e6, "dur": 1000.0,
              "args": {"trace_ids": ["a", "b"]}}]
    run = _run(P5, records=records, spans=spans,
               counters={"dispatches": 2, "completed": 3})
    run.trace = Trace({"traceEvents": evs}, PERF0)
    assert read("h2d_ms.served", run) == pytest.approx(0.1 / 2)
    assert read("batch_occupancy.served", run) == pytest.approx(1.5)
    assert read("device_idle_share.served", run) == pytest.approx(0.5)
    # waits 150 ms, 50 ms and never: the tail is infinite
    assert read("wait_p95_ms.served", run) == math.inf
    run.records = records[:2]
    assert read("wait_p95_ms.served", run) == pytest.approx(
        1e3 * percentile([0.15, 0.05], 95))
    assert read("request_p95_ms.served", run) == pytest.approx(
        1e3 * (0.2 + 0.95 * 0.1))
    run.window_s = 4.0
    assert read("served_req_per_s", run) == pytest.approx(2 / 4.0)


def test_ctbench_idle_split_by_host():
    t = Trace(closed_loop_trace(), PERF0)
    spans = [{"ph": "X", "name": "filter.chunk",
              "ts": (PERF0 + 15e-6) * 1e6, "dur": 20.0}]
    split = dict(t.idle_by_host(spans))
    assert split["span:filter.chunk"] == pytest.approx(20e-6)
    assert sum(split.values()) == pytest.approx(1e-3 - 720e-6)


def test_ctbench_percentile():
    assert percentile([1, 2, 3, 4], 50) == pytest.approx(2.5)
    assert percentile([1.0, math.inf], 95) == math.inf
    assert percentile([1.0, 2.0, math.inf], 40) == pytest.approx(1.8)
