"""Process-wide telemetry: spans, metrics, trace IDs, exporters.

The port's own copy of the JAX package's telemetry layer, with the same
API and the same Chrome trace and Prometheus output. Four pieces:

* **Spans**: nestable wall-clock intervals on the monotonic clock
  (``time.perf_counter``), recorded per OS thread so the runtime's
  named worker threads (``recon-flush``, ``recon-fleet-{d}``,
  ``recon-serve-{i}``, ``recon-stream``) become distinct lanes in the
  exported trace. Tracing is OFF by default; :func:`span`/:func:`instant`
  then return a shared no-op singleton without allocating, so
  instrumented hot paths cost one attribute load + truth test. Enable
  with ``REPRO_TRACE=1`` in the environment or the :func:`tracing`
  context manager.

* **Metrics registry**: named counters / gauges / :class:`Histogram`
  (the streamed log-2 latency histogram). :class:`EmitMixin` gives every
  report dataclass (``ServiceStats``, ``FleetReport``, ``StreamReport``,
  ``SolveReport``) one shared ``as_dict()``/``emit()`` contract.

* **Trace IDs**: :func:`new_trace_id` mints per-request IDs.

* **Exporters**: :func:`dump_trace` writes Chrome trace-event JSON
  (load in Perfetto / ``chrome://tracing``; ``ph:"X"`` complete events
  with per-thread ``tid`` lanes + ``ph:"M"`` thread-name metadata),
  :func:`prom_render` renders Prometheus text exposition, and
  :func:`record_tuning` appends autotune outcomes to the
  ``TUNE_TRAJECTORY.json`` artifact (``$REPRO_TUNE_TRAJECTORY``).

What a span measures: HOST time. A CUDA launch returns before its kernel
runs, so ``step.dispatch`` measures the enqueue of a step's launches, not
the kernels; a span that ends in a host read of device data (a ``.cpu()``
copy, a ``.item()``) includes the wait for it. No span synchronizes the
device: that would change the walk and the device idle share the spans
are there to explain. The device side is read from the profiler: a span
opened with ``nvtx=True`` also opens ``torch.profiler.record_function``
(its name) when ``REPRO_TRACE_NVTX=1`` is set before this module is
imported, so the range shows in a ``torch.profiler`` trace on the CPU and
on the card, and under ``torch.autograd.profiler.emit_nvtx()`` it becomes
an NVTX range for Nsight. A span reads the clock just before its range
opens and just before it closes, so one offset maps its interval onto
the range's on the profiler's timeline (within tens of microseconds on
the CPU), the offset a reader takes from a range of its own opened the
same way.

This module imports nothing from ``repro_torch`` (every runtime layer
may import it without cycles) and imports ``torch`` only for the
``record_function`` ranges, when the first one opens.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import re
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "enabled", "enable", "disable", "tracing", "span", "instant",
    "interval", "events", "clear", "dump_trace", "open_span_count",
    "new_trace_id", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "REGISTRY", "EmitMixin", "prom_name", "prom_render",
    "record_tuning", "tune_trajectory", "dump_tune_trajectory",
]

# --------------------------------------------------------------------------
# Enablement — the no-op fast path
# --------------------------------------------------------------------------

# Checked FIRST by span()/instant(); everything else is behind it. A
# plain module global read is the cheapest gate Python offers, and the
# disabled path allocates nothing (shared _NULL singleton).
_enabled: bool = os.environ.get("REPRO_TRACE", "") not in ("", "0")

_lock = threading.Lock()
_events: List[Dict[str, Any]] = []
_dropped = 0
_MAX_EVENTS = 1_000_000          # hard cap; beyond it events are counted, not kept
_open_spans: set = set()         # span ids entered but not yet exited
_span_ids = itertools.count(1)
_tls = threading.local()         # per-thread span stack (nesting / parents)


def enabled() -> bool:
    """True when spans/instants are being recorded."""
    return _enabled


def enable(clear_events: bool = False) -> None:
    global _enabled
    if clear_events:
        clear()
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


@contextmanager
def tracing(path: Optional[str] = None, clear_events: bool = True):
    """Enable tracing for a ``with`` block; optionally dump on exit.

        with telemetry.tracing("trace.json"):
            executor.reconstruct(projections)

    Restores the previous enabled state on exit (nesting-safe), then
    writes the Chrome trace to ``path`` when given.
    """
    global _enabled
    prev = _enabled
    enable(clear_events=clear_events)
    try:
        yield
    finally:
        _enabled = prev
        if path is not None:
            dump_trace(path)


def _record(ev: Dict[str, Any]) -> None:
    global _dropped
    with _lock:
        if len(_events) < _MAX_EVENTS:
            _events.append(ev)
        else:
            _dropped += 1


def events() -> List[Dict[str, Any]]:
    """Snapshot of recorded events (internal schema, pre-export)."""
    with _lock:
        return list(_events)


def clear() -> None:
    global _dropped
    with _lock:
        _events.clear()
        _dropped = 0
        _open_spans.clear()


def open_span_count() -> int:
    """Spans entered but not yet exited (0 == every span closed)."""
    with _lock:
        return len(_open_spans)


# --------------------------------------------------------------------------
# Spans
# --------------------------------------------------------------------------

class _NullSpan:
    """Shared do-nothing span — the disabled path. ``live`` lets call
    sites skip computing their args."""

    __slots__ = ()
    live = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):
        return self


_NULL = _NullSpan()

# torch.profiler.record_function is resolved lazily, so importing
# telemetry loads no torch and spans cost nothing while
# REPRO_TRACE_NVTX is unset.
_NVTX_ANNOTATE = os.environ.get("REPRO_TRACE_NVTX", "") not in ("", "0")


def _nvtx_annotation(name: str):
    from torch.profiler import record_function
    return record_function(name)


class Span:
    """One live span. Use via ``with telemetry.span(...) as sp:``;
    ``sp.set(k=v)`` attaches args any time before exit."""

    __slots__ = ("name", "cat", "args", "id", "parent", "_t0", "_ann")
    live = True

    def __init__(self, name: str, cat: str, args: Dict[str, Any],
                 ann=None):
        self.name = name
        self.cat = cat
        self.args = args
        self.id = 0
        self.parent = None
        self._t0 = 0.0
        self._ann = ann

    def set(self, **args) -> "Span":
        self.args.update(args)
        return self

    def __enter__(self) -> "Span":
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self.parent = stack[-1].id if stack else None
        self.id = next(_span_ids)
        stack.append(self)
        with _lock:
            _open_spans.add(self.id)
        self._t0 = time.perf_counter()
        if self._ann is not None:
            self._ann.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        args = dict(self.args)
        args["span_id"] = self.id
        args["parent_id"] = self.parent
        if exc_type is not None:
            args["error"] = exc_type.__name__
        with _lock:
            _open_spans.discard(self.id)
        _record({"ph": "X", "name": self.name, "cat": self.cat,
                 "ts": self._t0 * 1e6, "dur": (t1 - self._t0) * 1e6,
                 "tid": threading.current_thread().name, "args": args})
        return False


def span(name: str, cat: str = "recon", nvtx: bool = False, **args):
    """A nestable span on the calling thread's lane; no-op when
    tracing is disabled. ``nvtx=True`` additionally wraps the interval
    in ``torch.profiler.record_function`` when ``REPRO_TRACE_NVTX=1``."""
    if not _enabled:
        return _NULL
    ann = _nvtx_annotation(name) if (nvtx and _NVTX_ANNOTATE) else None
    return Span(name, cat, args, ann)


def instant(name: str, cat: str = "recon", **args) -> None:
    """A zero-duration marker (steal / failover / submit / ...)."""
    if not _enabled:
        return
    _record({"ph": "i", "name": name, "cat": cat, "s": "t",
             "ts": time.perf_counter() * 1e6,
             "tid": threading.current_thread().name, "args": args})


def interval(name: str, t0: float, t1: float, cat: str = "recon",
             **args) -> None:
    """A finished span from ``t0`` to ``t1`` (``time.perf_counter``
    seconds), recorded on the calling thread's lane with no parent: an
    interval that starts on one thread and ends on another (a request's
    wait in the queue). No-op when tracing is disabled."""
    if not _enabled:
        return
    args["span_id"] = next(_span_ids)
    args["parent_id"] = None
    _record({"ph": "X", "name": name, "cat": cat, "ts": t0 * 1e6,
             "dur": (t1 - t0) * 1e6,
             "tid": threading.current_thread().name, "args": args})


# --------------------------------------------------------------------------
# Trace IDs
# --------------------------------------------------------------------------

_trace_counter = itertools.count(1)


def new_trace_id(prefix: str = "req") -> str:
    """Process-unique request/stream ID (cheap; minted even when
    tracing is off so callers can hold one unconditionally)."""
    return f"{prefix}-{os.getpid():x}-{next(_trace_counter):06d}"


# --------------------------------------------------------------------------
# Chrome trace-event exporter
# --------------------------------------------------------------------------

def dump_trace(path: str) -> str:
    """Write recorded events as Chrome trace-event JSON.

    Loadable in Perfetto (ui.perfetto.dev) or ``chrome://tracing``.
    Every distinct thread name becomes its own ``tid`` lane with a
    ``ph:"M"`` thread_name metadata event, so the flusher, each fleet
    worker (``recon-fleet-{d}``), the serving workers and the stream
    worker render as separate rows under one process. The process name
    and the lanes are the JAX package's, so both packages' traces load
    side by side.
    """
    with _lock:
        evs = list(_events)
        dropped = _dropped
    pid = os.getpid()
    lanes: Dict[str, int] = {}
    out: List[Dict[str, Any]] = []
    for name in sorted({e["tid"] for e in evs}):
        lanes[name] = len(lanes)
        out.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": lanes[name], "args": {"name": name}})
    out.append({"ph": "M", "name": "process_name", "pid": pid,
                "args": {"name": "repro-runtime"}})
    for e in evs:
        ce = dict(e)
        ce["pid"] = pid
        ce["tid"] = lanes[ce["tid"]]
        out.append(ce)
    doc = {"traceEvents": out, "displayTimeUnit": "ms",
           "otherData": {"dropped_events": dropped}}
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


# --------------------------------------------------------------------------
# Metrics registry
# --------------------------------------------------------------------------

class Counter:
    """Monotonic counter (thread-safe)."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Gauge:
    """Last-write-wins scalar (thread-safe)."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._v


class Histogram:
    """Streamed log-2 latency histogram (O(1) memory).

    The JAX package's serving layer calls it ``LatencyHistogram``.
    Every completed request is recorded as it finishes — the histogram
    IS the stream, not a poll-time sample — into geometric bins
    ``[BASE_S * 2**i, BASE_S * 2**(i+1))``. Quantiles are read from the
    cumulative counts with the bin's geometric center as the estimate
    (resolution ~±41%, the standard trade for a fixed-size streamed
    histogram). Thread-safe: workers record concurrently.
    """

    BASE_S = 50e-6          # bin 0 also absorbs anything faster
    NBINS = 40              # 50 µs .. ~15 hours

    def __init__(self, name: str = ""):
        self.name = name
        self._counts = [0] * self.NBINS
        self._count = 0
        self._total_s = 0.0
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        s = max(float(seconds), 0.0)
        b = 0 if s < 2 * self.BASE_S else min(
            self.NBINS - 1, int(math.log2(s / self.BASE_S)))
        with self._lock:
            self._counts[b] += 1
            self._count += 1
            self._total_s += s

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def counts(self) -> List[int]:
        with self._lock:
            return list(self._counts)

    def mean(self) -> Optional[float]:
        with self._lock:
            return self._total_s / self._count if self._count else None

    def quantile(self, q: float) -> Optional[float]:
        """Approximate q-quantile in seconds (None while empty)."""
        with self._lock:
            if not self._count:
                return None
            target = max(1.0, q * self._count)
            cum = 0
            for i, c in enumerate(self._counts):
                cum += c
                if cum >= target:
                    return self.BASE_S * (2.0 ** i) * math.sqrt(2.0)
            return self.BASE_S * (2.0 ** (self.NBINS - 1))

    @staticmethod
    def merged(hists: Iterable["Histogram"]) -> "Histogram":
        out = Histogram()
        for h in hists:
            with h._lock:
                for i, c in enumerate(h._counts):
                    out._counts[i] += c
                out._count += h._count
                out._total_s += h._total_s
        return out


class MetricsRegistry:
    """Named metric store: get-or-create semantics per metric kind.

    ``REGISTRY`` is the process default; report ``emit()`` targets it
    unless handed another instance (tests use private registries).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def as_dict(self) -> Dict[str, Any]:
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, Any] = {}
        for name, m in items:
            if isinstance(m, Histogram):
                out[name] = {"count": m.count, "mean_s": m.mean(),
                             "p50_s": m.quantile(0.5),
                             "p99_s": m.quantile(0.99)}
            else:
                out[name] = m.value
        return out

    def prometheus(self, prefix: str = "repro") -> str:
        rows = []
        with self._lock:
            items = sorted(self._metrics.items())
        for name, m in items:
            mname = prom_name(f"{prefix}_{name}")
            if isinstance(m, Counter):
                rows.append((mname + "_total", "counter", name,
                             [({}, m.value)]))
            elif isinstance(m, Gauge):
                rows.append((mname, "gauge", name, [({}, m.value)]))
            else:
                rows.append((mname + "_count", "counter", name,
                             [({}, m.count)]))
        return prom_render(rows)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


REGISTRY = MetricsRegistry()


# --------------------------------------------------------------------------
# Shared report contract
# --------------------------------------------------------------------------

class EmitMixin:
    """One ``as_dict()``/``emit()`` contract for report dataclasses.

    ``as_dict()`` is ``dataclasses.asdict`` plus the class's computed
    ``@property`` values (``hit_rate``, ``hidden_fraction``, ...), so
    exporters see one flat schema.
    ``emit()`` pushes every numeric leaf into a metrics registry as a
    gauge named ``<prefix>.<field>``.
    """

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)          # type: ignore[call-overload]
        for klass in type(self).__mro__:
            for k, v in vars(klass).items():
                if isinstance(v, property) and k not in d:
                    try:
                        d[k] = getattr(self, k)
                    except Exception:
                        pass
        return d

    def emit(self, registry: Optional[MetricsRegistry] = None,
             prefix: Optional[str] = None) -> MetricsRegistry:
        reg = REGISTRY if registry is None else registry
        pfx = prefix if prefix is not None else type(self).__name__.lower()
        for key, v in _numeric_leaves(pfx, self.as_dict()):
            reg.gauge(key).set(v)
        return reg


def _numeric_leaves(prefix: str, obj: Any):
    if isinstance(obj, bool):
        yield prefix, float(obj)
    elif isinstance(obj, (int, float)):
        yield prefix, float(obj)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _numeric_leaves(f"{prefix}.{k}", v)
    # tuples/lists/str/None: not emitted as metrics


# --------------------------------------------------------------------------
# Prometheus text exposition
# --------------------------------------------------------------------------

_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def prom_name(name: str) -> str:
    """Sanitize to the Prometheus metric-name charset."""
    out = _PROM_BAD.sub("_", name)
    return "_" + out if out[:1].isdigit() else out


def _prom_value(v: Any) -> str:
    if v is None:
        return "NaN"
    return repr(float(v))


def prom_render(
    rows: Iterable[Tuple[str, str, str, List[Tuple[Dict[str, Any], Any]]]],
) -> str:
    """Render ``(name, type, help, [(labels, value), ...])`` rows as
    Prometheus text exposition format (version 0.0.4)."""
    lines: List[str] = []
    for name, mtype, help_, samples in rows:
        name = prom_name(name)
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {mtype}")
        for labels, value in samples:
            if labels:
                lab = ",".join(
                    f'{prom_name(str(k))}="{_prom_escape(v)}"'
                    for k, v in sorted(labels.items()))
                lines.append(f"{name}{{{lab}}} {_prom_value(value)}")
            else:
                lines.append(f"{name} {_prom_value(value)}")
    return "\n".join(lines) + "\n"


def _prom_escape(v: Any) -> str:
    return str(v).replace("\\", r"\\").replace('"', r"\"").replace(
        "\n", r"\n")


# --------------------------------------------------------------------------
# Tuner-outcome trajectory: the portability claim as a tracked number
# --------------------------------------------------------------------------

TUNE_TRAJECTORY_ENV = "REPRO_TUNE_TRAJECTORY"

_tune_records: List[Dict[str, Any]] = []


def record_tuning(record: Dict[str, Any]) -> None:
    """Append one autotune outcome; mirrors to the JSON artifact at
    ``$REPRO_TUNE_TRAJECTORY`` when set. Never raises: the trajectory
    is evidence, not a gate."""
    rec = _jsonable(dict(record))
    with _lock:
        _tune_records.append(rec)
    path = os.environ.get(TUNE_TRAJECTORY_ENV)
    if path:
        try:
            _append_json_record(path, rec)
        except (OSError, ValueError):       # pragma: no cover - disk race
            pass


def tune_trajectory() -> List[Dict[str, Any]]:
    with _lock:
        return list(_tune_records)


def dump_tune_trajectory(path: str) -> str:
    with _lock:
        recs = list(_tune_records)
    _write_json_records(path, recs)
    return path


def _append_json_record(path: str, rec: Dict[str, Any]) -> None:
    recs: List[Dict[str, Any]] = []
    try:
        with open(path) as f:
            doc = json.load(f)
        recs = list(doc.get("records", [])) if isinstance(doc, dict) \
            else list(doc)
    except (OSError, ValueError):
        recs = []
    recs.append(rec)
    _write_json_records(path, recs)


def _write_json_records(path: str, recs: List[Dict[str, Any]]) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump({"suite": "tune_trajectory", "records": recs}, f,
                  indent=1)
    os.replace(tmp, path)


def _jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return str(obj)
