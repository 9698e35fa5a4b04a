"""The reader of the share of the window's ``geometry.matrices`` spans
that the program's matrix cache served, on a small synthetic span list:
all cached, none cached (the spans of a program without the cache carry
no ``cached`` arg), spans outside the window left out, and None where
the window holds no such span."""

import pytest

from test_ctbench_metrics import P5, _run, read
from test_ctbench_span_metrics import span

NAME = "matrices_hit_share.batch"


def batch_run(spans):
    return _run(P5, records=[{"done": 0.5}, {"done": 1.0}], spans=spans,
                window_s=2.0)


def test_ctbench_matrices_all_cached_read_one():
    run = batch_run([span("geometry.matrices", 0.1, 20.0, cached=True),
                     span("step.dispatch", 0.2, 9e4),
                     span("geometry.matrices", 0.6, 25.0, cached=True)])
    assert read(NAME, run) == 1.0


@pytest.mark.parametrize("args", [{"cached": False}, {}],
                         ids=["false", "without-arg"])
def test_ctbench_matrices_none_cached_read_zero(args):
    run = batch_run([span("geometry.matrices", 0.1, 9000.0, **args),
                     span("geometry.matrices", 0.6, 11000.0, **args)])
    assert read(NAME, run) == 0.0


def test_ctbench_matrices_hit_share_reads_the_window():
    run = batch_run([
        span("geometry.matrices", -0.5, 9000.0, cached=False),   # warm-up
        span("geometry.matrices", 0.1, 20.0, cached=True),
        span("geometry.matrices", 0.6, 9000.0, cached=False),
        span("geometry.matrices", 1.2, 20.0, cached=True),
        span("geometry.matrices", 1.5, 20.0, cached=True),
        span("geometry.matrices", 2.5, 9000.0, cached=False)])   # after it
    assert read(NAME, run) == pytest.approx(0.75)


def test_ctbench_matrices_hit_share_without_spans():
    run = batch_run([span("step.dispatch", 0.2, 9e4)])
    assert read(NAME, run) is None
    run.spans = [span("geometry.matrices", -1.0, 20.0, cached=True),
                 span("geometry.matrices", 2.1, 20.0, cached=True)]
    assert read(NAME, run) is None
    run.spans = None
    assert read(NAME, run) is None
