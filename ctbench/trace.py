"""The profiler's trace, reduced to what the per-layer metrics read.

A traced run wraps its window in ``torch.profiler.profile`` (CPU and
CUDA activities) and exports the Chrome trace that the profiler writes.
This module reads that trace:

* device activities: kernels, copies and memsets, each with the host
  thread and time of the call that launched it (matched through the
  profiler's ``correlation`` id);
* host ranges: ``record_function`` ranges (``user_annotation``), the
  benchmark's own (``ctbench.window``, ``ctbench.call``) and the
  program's (``step.dispatch``, opened when ``REPRO_TRACE_NVTX=1``);
* the offset that puts the host clock (``time.perf_counter``, in which
  the program's telemetry spans and the benchmark's records are kept)
  on the trace's timeline, read from the ``ctbench.window`` range whose
  start the benchmark noted on the host clock.

Nothing here depends on a kernel's name: a metric that wants kernels of
one layer asks for those launched inside a host range.
"""

from __future__ import annotations

import bisect
import json
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "ctbench.window"
CALL = "ctbench.call"


def union(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    """Sorted, merged intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Activity:
    """One device activity (times in trace microseconds)."""

    __slots__ = ("name", "cat", "start", "end", "launch_ts", "launch_tid")

    def __init__(self, name, cat, start, end, launch_ts, launch_tid):
        self.name = name
        self.cat = cat
        self.start = start
        self.end = end
        self.launch_ts = launch_ts
        self.launch_tid = launch_tid

    @property
    def dur(self) -> float:
        return self.end - self.start


class Trace:
    """A parsed profiler trace of one window.

    ``window_start_perf`` is the host clock (seconds) at which the
    benchmark opened its ``ctbench.window`` range.
    """

    def __init__(self, doc: dict, window_start_perf: float):
        events = doc.get("traceEvents", [])
        launches: Dict[int, Tuple[float, object]] = {}
        self.ranges: List[Tuple[str, float, float, object]] = []
        self.host_ops: List[Tuple[str, float, float, object]] = []
        raw_device = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts = float(e.get("ts", 0.0))
            end = ts + float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                raw_device.append(e)
            elif cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = (ts, e.get("tid"))
            elif cat == "user_annotation":
                self.ranges.append((e.get("name", ""), ts, end, e.get("tid")))
            elif cat == "cpu_op":
                self.host_ops.append((e.get("name", ""), ts, end,
                                      e.get("tid")))
        self.activities: List[Activity] = []
        for e in raw_device:
            ts = float(e["ts"])
            corr = e.get("args", {}).get("correlation")
            lts, ltid = launches.get(corr, (None, None))
            self.activities.append(Activity(
                e.get("name", ""), e.get("cat", ""), ts,
                ts + float(e.get("dur", 0.0)), lts, ltid))
        self.activities.sort(key=lambda a: a.start)
        wins = [r for r in self.ranges if r[0] == WINDOW]
        if not wins:
            raise ValueError(f"the trace holds no {WINDOW!r} range")
        _, self.w0, self.w1, self.main_tid = wins[0]
        #: trace microseconds = host perf_counter microseconds + offset
        self.offset = self.w0 - window_start_perf * 1e6

    # ---- windows and clocks ----------------------------------------------

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e6

    def to_trace(self, perf_s: float) -> float:
        return perf_s * 1e6 + self.offset

    def has_device(self) -> bool:
        """Whether any device activity was recorded in the window."""
        return bool(self.in_window())

    def in_window(self) -> List[Activity]:
        return [a for a in self.activities
                if a.end > self.w0 and a.start < self.w1]

    # ---- device time ------------------------------------------------------

    def busy(self, acts: Optional[List[Activity]] = None) -> List[List[float]]:
        """Merged busy intervals inside the window."""
        acts = self.in_window() if acts is None else acts
        return union((max(a.start, self.w0), min(a.end, self.w1))
                     for a in acts)

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """Intervals of the window with nothing on the device."""
        gaps, t = [], self.w0
        for a, b in self.busy():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if t < self.w1:
            gaps.append((t, self.w1))
        return gaps

    def range_intervals(self, name: str) -> Dict[object, List[Tuple]]:
        """Host intervals of the ranges called ``name``, by thread,
        sorted by start."""
        by_tid: Dict[object, List[Tuple]] = {}
        for n, a, b, tid in self.ranges:
            if n == name:
                by_tid.setdefault(tid, []).append((a, b))
        for v in by_tid.values():
            v.sort()
        return by_tid

    def launched_inside(self, name: str,
                        acts: Optional[List[Activity]] = None
                        ) -> Tuple[List[Activity], List[Activity]]:
        """Split device activities into (launched inside a host range
        called ``name`` on the launching thread, the rest). An activity
        whose launch the trace does not hold counts as the rest."""
        acts = self.in_window() if acts is None else acts
        spans = self.range_intervals(name)
        starts = {tid: [s for s, _ in v] for tid, v in spans.items()}
        inside, rest = [], []
        for a in acts:
            hit = False
            if a.launch_ts is not None and a.launch_tid in spans:
                v = spans[a.launch_tid]
                i = bisect.bisect_right(starts[a.launch_tid], a.launch_ts) - 1
                hit = i >= 0 and v[i][0] <= a.launch_ts <= v[i][1]
            (inside if hit else rest).append(a)
        return inside, rest

    def by_call(self) -> List[List[Activity]]:
        """Device activities grouped by the ``ctbench.call`` range (one
        volume of a closed loop) that launched them, in call order."""
        calls = self.range_intervals(CALL).get(self.main_tid, [])
        starts = [a for a, _ in calls]
        groups: List[List[Activity]] = [[] for _ in calls]
        for a in self.activities:
            if a.launch_ts is None or a.launch_tid != self.main_tid:
                continue
            i = bisect.bisect_right(starts, a.launch_ts) - 1
            if i >= 0 and calls[i][0] <= a.launch_ts <= calls[i][1]:
                groups[i].append(a)
        return groups

    # ---- breakdown ---------------------------------------------------------

    def top_device_ops(self, n: int = 10) -> List[List]:
        """The device operations that took most time in the window."""
        tot: Dict[str, float] = {}
        for a in self.in_window():
            dur = min(a.end, self.w1) - max(a.start, self.w0)
            tot[a.name] = tot.get(a.name, 0.0) + dur / 1e6
        return [[k, v] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def idle_by_host(self, spans: Optional[List[dict]],
                     n: int = 10) -> List[List]:
        """The device's idle time, split by what the host was doing: the
        innermost program span open then (on any thread, the latest
        opened), else the outermost host operation or range on the
        benchmark's thread, else ``"host: no span or op"``. The ``n``
        largest shares, in seconds. One sweep over every boundary."""
        marks = []          # (time, order, kind, key, start, label)
        key = 0
        for e in spans or ():
            if e.get("ph") == "X":
                a = self.to_trace(e["ts"] / 1e6)
                marks += [(a, 1, "span", key, a, "span:" + e["name"]),
                          (a + e["dur"], 0, "span", key, a, None)]
                key += 1
        for nm, a, b, tid in self.host_ops + self.ranges:
            if tid == self.main_tid and nm not in (WINDOW, CALL):
                marks += [(a, 1, "op", key, a, "host:" + nm),
                          (b, 0, "op", key, a, None)]
                key += 1
        for g0, g1 in self.idle_gaps():
            marks += [(g0, 1, "gap", -1, g0, None),
                      (g1, 0, "gap", -1, g0, None)]
        marks.sort(key=lambda m: (m[0], m[1]))
        open_ = {"span": {}, "op": {}}
        in_gap, t_prev = False, None
        split: Dict[str, float] = {}
        for t, order, kind, k, a, label in marks:
            if in_gap and t > t_prev:
                if open_["span"]:
                    name = max(open_["span"].values())[1]
                elif open_["op"]:
                    name = min(open_["op"].values())[1]
                else:
                    name = "host: no span or op"
                split[name] = split.get(name, 0.0) + (t - t_prev) / 1e6
            t_prev = t
            if kind == "gap":
                in_gap = order == 1
            elif order == 1:
                open_[kind][k] = (a, label)
            else:
                open_[kind].pop(k, None)
        return [[k, v] for k, v in
                sorted(split.items(), key=lambda kv: -kv[1])[:n]]


def load(path: str, window_start_perf: float) -> Trace:
    with open(path) as f:
        return Trace(json.load(f), window_start_perf)
