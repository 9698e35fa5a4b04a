"""The reader of the share of ingested bytes that went through pinned
staging, on a small synthetic span list: spans weighted by their bytes,
a span without ``path`` counted as pageable, spans outside the window
left out, and None where the program records no ``ingest`` span."""

import pytest

from test_ctbench_metrics import read
from test_ctbench_span_metrics import served_run, span

NAME = "ingest_pinned_share.served"


def test_ctbench_ingest_pinned_spans_read_one():
    run = served_run([span("ingest", 0.01, 20e3, bytes=8, path="pinned"),
                      span("ingest", 0.3, 25e3, bytes=8, path="pinned")])
    assert read(NAME, run) == 1.0


def test_ctbench_ingest_without_path_reads_zero():
    """The parent's spans carry no path: their copies were pageable."""
    run = served_run([span("ingest", 0.01, 90e3, bytes=8),
                      span("ingest", 0.3, 95e3, bytes=8)])
    assert read(NAME, run) == 0.0


def test_ctbench_ingest_share_weighs_bytes():
    run = served_run([span("ingest", 0.01, 20e3, bytes=600, path="pinned"),
                      span("ingest", 0.1, 1e3, bytes=100, path="pageable"),
                      span("ingest", 0.2, 1e3, bytes=300),
                      span("service.dispatch", 0.3, 3e5)])
    assert read(NAME, run) == pytest.approx(0.6)


def test_ctbench_ingest_share_reads_the_window():
    run = served_run([span("ingest", -1.0, 5e5, bytes=900),       # warm-up
                      span("ingest", 0.5, 20e3, bytes=100, path="pinned"),
                      span("ingest", 2.5, 9e4, bytes=900)])        # after it
    assert read(NAME, run) == 1.0


def test_ctbench_ingest_share_without_spans():
    run = served_run([span("service.dispatch", 0.2, 3e5)])
    assert read(NAME, run) is None
    run.spans = [span("ingest", -1.0, 5e5, bytes=900, path="pinned")]
    assert read(NAME, run) is None
    run.spans = None
    assert read(NAME, run) is None
