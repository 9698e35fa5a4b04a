"""The readers of the program's host-path, filter, ingest and queue
spans, on a small synthetic profiler trace and span list; each returns
None where the program records nothing for it to read."""

import math

import pytest

from ctbench.core import percentile
from ctbench.trace import Trace
from test_ctbench_metrics import P5, PERF0, _run, ev, kernel, launch, read

PREP = ("filter_device_ms.batch", "stack_device_ms.batch")


def span(name, t_s, dur_us, **args):
    """A program span starting ``t_s`` seconds into the window."""
    return {"ph": "X", "name": name, "ts": (PERF0 + t_s) * 1e6,
            "dur": float(dur_us), "tid": "MainThread", "args": args}


def filtered_trace(ranges=True):
    """Two volumes: each a filter kernel inside ``filter.chunk``, a
    memset and a copy inside ``filter.stack``, the matrices' copy
    outside both, and a back-projection inside ``step.dispatch``."""
    evs = [ev("user_annotation", "ctbench.window", 0, 1000)]
    for v, base in enumerate((0, 500)):
        c = 10 * v
        if ranges:
            evs += [ev("user_annotation", "filter.chunk", base + 20, 20),
                    ev("user_annotation", "filter.stack", base + 50, 30)]
        evs += [ev("user_annotation", "step.dispatch", base + 100, 20),
                launch(base + 10, c + 1), launch(base + 25, c + 2),
                launch(base + 55, c + 3), launch(base + 65, c + 4),
                launch(base + 105, c + 5),
                kernel("Memcpy HtoD", base + 12, 2, c + 1,
                       cat="gpu_memcpy"),
                kernel("fft", base + 40, 50, c + 2),
                kernel("Memset", base + 90, 4, c + 3, cat="gpu_memset"),
                kernel("Memcpy DtoD", base + 94, 10, c + 4,
                       cat="gpu_memcpy"),
                kernel("tile_kernel", base + 110, 300, c + 5)]
    return {"traceEvents": evs}


def test_ctbench_filter_and_stack_device_time():
    run = _run(P5, records=[{"done": 0.5}, {"done": 1.0}])
    run.trace = Trace(filtered_trace(), PERF0)
    assert read("filter_device_ms.batch", run) == pytest.approx(50e-3)
    assert read("stack_device_ms.batch", run) == pytest.approx(14e-3)
    # beside each other, and a part of what step.dispatch leaves out
    prep = read("prep_device_ms.batch", run)
    assert prep == pytest.approx((50 + 14 + 2) * 1e-3)
    assert sum(read(m, run) for m in PREP) <= prep


@pytest.mark.parametrize("name", PREP)
def test_ctbench_filter_readers_without_ranges(name):
    """A program with no filter ranges (or no trace, or no volume) has
    nothing to read: None, not 0."""
    run = _run(P5, records=[{"done": 0.5}])
    run.trace = Trace(filtered_trace(ranges=False), PERF0)
    assert read(name, run) is None
    run.trace = None
    assert read(name, run) is None
    run.trace, run.records = Trace(filtered_trace(), PERF0), []
    assert read(name, run) is None


def test_ctbench_matrices_ms_reads_the_window():
    spans = [span("geometry.matrices", -0.5, 999.0),    # set-up
             span("geometry.matrices", 0.1, 9000.0),
             span("filter.chunk", 0.2, 5000.0),
             span("geometry.matrices", 0.6, 11000.0),
             span("geometry.matrices", 1.5, 999.0)]     # after it
    run = _run(P5, records=[{"done": 0.5}, {"done": 1.0}], spans=spans,
               window_s=1.0)
    assert read("matrices_ms.batch", run) == pytest.approx(10.0)
    run.spans = [s for s in spans if s["name"] != "geometry.matrices"]
    assert read("matrices_ms.batch", run) is None
    run.spans = None
    assert read("matrices_ms.batch", run) is None


def served_run(spans):
    records = [{"due": 0.0, "ok": True, "trace_id": "a"},
               {"due": 0.1, "ok": True, "trace_id": "b"},
               {"due": 0.2, "ok": False, "trace_id": "c"}]
    return _run(P5, records=records, spans=spans, window_s=2.0)


def test_ctbench_ingest_ms_per_completed_request():
    spans = [span("ingest", -1.0, 5e5, bytes=4),        # warm-up
             span("ingest", 0.01, 90e3, bytes=4),
             span("ingest", 0.12, 110e3, bytes=4),
             span("service.dispatch", 0.2, 3e5)]
    run = served_run(spans)
    # two requests completed; the failed one's copy still counts
    assert read("ingest_ms.served", run) == pytest.approx(200.0 / 2)
    run.spans = spans[3:]
    assert read("ingest_ms.served", run) is None
    run.spans = spans
    for r in run.records:
        r["ok"] = False
    assert read("ingest_ms.served", run) is None


def test_ctbench_queue_p95_from_the_programs_spans():
    queue = [span("request.queue", 0.0, 150e3, trace_id="a"),
             span("request.queue", 0.1, 50e3, trace_id="b")]
    run = served_run(queue)
    # "c" never reached a dispatch: the tail is infinite
    assert read("queue_p95_ms.served", run) == math.inf
    run.spans = queue + [span("request.queue", 0.2, 70e3, trace_id="c")]
    assert read("queue_p95_ms.served", run) == pytest.approx(
        1e3 * percentile([0.15, 0.05, 0.07], 95.0))
    run.spans = [span("service.dispatch", 0.2, 1e3, trace_ids=["a"])]
    assert read("queue_p95_ms.served", run) is None
    run.spans = None
    assert read("queue_p95_ms.served", run) is None
