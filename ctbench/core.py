"""One run of one benchmark cell: load, warm up, measure, check, report.

Everything a cell is made of is found by name, so that a later change
adds a configuration, a traffic mix or a metric as files of its own:

* ``BENCHMARK.json`` names the cell: its configuration, its traffic mix
  and its metrics;
* the configuration is the file the entry names (``configs/<name>.json``);
* the traffic mix is ``traffic/<traffic>.json``, a file of parameters
  whose ``generator`` names the load generator, ``generators/<g>.py``;
* each metric is read by ``metrics/<name>.py``, whose ``read(run)``
  returns a number or None (nothing to read: the metric is left out).

``run_cell`` does the work; ``run.py`` is its command line.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

#: top-level modules that may not be loaded when a run reports
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


# --------------------------------------------------------------------------
# Finding the pieces by name
# --------------------------------------------------------------------------

def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _module(path: Path):
    """Import the file ``path`` as a module of its own (a metric's name
    may hold dots, so these are loaded by path, not by import name)."""
    name = "ctbench_piece_" + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its pieces loaded."""

    root: Path
    entry: dict
    config: dict
    traffic: dict
    generator: Any
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, workload: str,
              overrides: Optional[dict] = None) -> Cell:
    """The cell ``workload`` of the benchmark at ``root``; ``overrides``
    replace keys of its configuration (the control's precision)."""
    root = Path(root)
    bench = load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    with open(root / conf["file"]) as f:
        config = json.load(f)
    config.update(overrides or {})
    with open(root / "ctbench" / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    gen = _module(root / "ctbench" / "generators"
                  / f"{traffic['generator']}.py")
    return Cell(root=root, entry=entry, config=config, traffic=traffic,
                generator=gen,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, workload)])


def read_metrics(root: Path, metrics: List[dict], run) -> Dict[str, dict]:
    """Each metric's reader applied to the run; a reader that finds
    nothing to read returns None and its metric is left out."""
    out = {}
    for m in metrics:
        value = _module(Path(root) / "ctbench" / "metrics"
                        / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


# --------------------------------------------------------------------------
# What a run hands to its generator and to the metric readers
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Run:
    """The record of one run. The generator fills the window's fields;
    the metric readers read them."""

    config: dict
    traffic: dict
    seed: int
    seconds: float
    device: str
    traced: bool
    setup_s: float = 0.0
    window_start: float = 0.0        # host clock (perf_counter, s)
    window_s: float = 0.0
    #: closed loops: one record per volume; open loops: per request
    records: List[dict] = dataclasses.field(default_factory=list)
    #: program counters read over the window (deltas)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: the profiler's trace (``trace.Trace``) and the program's spans
    trace: Any = None
    spans: Optional[List[dict]] = None
    attempted: int = 0
    failed: int = 0
    notes: List[str] = dataclasses.field(default_factory=list)

    def geometry(self):
        """The program's geometry object, from the configuration's
        numbers."""
        from repro_torch.core.geometry import CTGeometry
        c = self.config
        n, nd = c["volume"], c["detector"]
        vox = c["volume_extent"] / n
        du = c["volume_extent"] * c["sdd"] / c["sad"] * c["detector_pad"] / nd
        return CTGeometry(nx=n, ny=n, nz=n, nw=nd, nh=nd,
                          n_proj=c["views"], sad=c["sad"], sdd=c["sdd"],
                          voxel_size=(vox, vox, vox), det_spacing=(du, du))

    @property
    def updates_per_volume(self) -> int:
        return self.config["volume"] ** 3 * self.config["views"]

    def range(self, name: str):
        """A profiler range on the host thread (a no-op untraced)."""
        if not self.traced:
            import contextlib
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)


# --------------------------------------------------------------------------
# Devices, clocks and the import guard
# --------------------------------------------------------------------------

def require_cards(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} cards, the machine has "
                       f"{torch.cuda.device_count()}")


def sync(device: str) -> None:
    import torch
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def forbidden_modules(names=None) -> List[str]:
    """Top-level names of loaded modules (or of ``names``) that a run
    may not load, compared whole (``repro_torch`` is not ``repro``)."""
    names = list(sys.modules) if names is None else names
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(tops & set(FORBIDDEN))


def card_info(device: str) -> dict:
    import torch
    if not device.startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        info["power_limit_w"] = None
    return info


# --------------------------------------------------------------------------
# The profiler around the window
# --------------------------------------------------------------------------

class Profiler:
    """``torch.profiler`` over the window (CPU and CUDA activities), its
    trace exported to a temporary file and parsed into a
    ``trace.Trace``."""

    def __init__(self, device: str):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        return False

    def parse(self, window_start: float):
        from ctbench import trace
        fd, path = tempfile.mkstemp(suffix=".trace.json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            return trace.load(path, window_start)
        finally:
            os.unlink(path)


# --------------------------------------------------------------------------
# One run
# --------------------------------------------------------------------------

def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, *, device: str = "cuda",
             t_start: Optional[float] = None,
             overrides: Optional[dict] = None) -> dict:
    """Run the cell once and return the result line's object.

    ``device="cpu"`` skips the look for a card and runs the program's
    CPU path (the tests' smoke configurations); ``t_start`` is the host
    clock at process start, from which set-up is counted."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = load_cell(Path(root), workload, overrides)
    if device.startswith("cuda"):
        require_cards(cell.entry["chips"])
    if trace:
        # read by the program's telemetry when it is first imported
        os.environ["REPRO_TRACE"] = "1"
        os.environ["REPRO_TRACE_NVTX"] = "1"
    import torch
    from repro_torch.runtime import telemetry
    if trace:
        telemetry.enable(clear_events=True)
    run = Run(config=cell.config, traffic=cell.traffic, seed=int(seed),
              seconds=float(seconds), device=device, traced=bool(trace))
    from ctbench.check import Sampler
    sampler = Sampler(cell.config, cell.traffic, run.seed, device)
    gen = cell.generator.Generator(run, sampler)
    gen.setup()
    sync(device)
    prof = Profiler(device) if trace else None
    if prof is not None:
        prof.__enter__()
        telemetry.clear()
    run.window_start = time.perf_counter()
    run.setup_s = run.window_start - t_start
    with run.range("ctbench.window"):
        gen.window()
        sync(device)
    if prof is not None:
        prof.__exit__(None, None, None)
        run.spans = telemetry.events()
        run.trace = prof.parse(run.window_start)
    gen.finish()
    dev_info = card_info(device)
    if device.startswith("cuda"):
        dev_info["count"] = int(cell.entry["chips"])
    if trace:
        dev_info["busy_s"] = run.trace.busy_s()
        dev_info["window_s"] = run.trace.window_s
    metrics = read_metrics(root, cell.per_layer if trace else cell.end_to_end,
                           run)
    breakdown = None
    if trace:
        breakdown = {"device_ops": [[short(n), v] for n, v in
                                    run.trace.top_device_ops()],
                     "idle_gaps": run.trace.idle_by_host(run.spans)}
        run.trace = None
    # the program's state is gone; the reference runs now
    gen.release()
    del gen
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    check = sampler.judge()
    run.notes.append(f"check: {len(sampler.kept)} of {sampler.offered} "
                     f"volumes against the reference in "
                     f"{sampler.seconds!r} s")
    for note in run.notes:
        print(note, file=sys.stderr)
    for name, c in check["numbers"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    result = {"correct": bool(check["correct"] and run.failed == 0),
              "attempted": int(run.attempted), "failed": int(run.failed),
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = check["numbers"]
    return result


def short(name: str, width: int = 96) -> str:
    """A device operation's name cut to ``width`` characters (kernel
    names carry whole template argument lists)."""
    return name if len(name) <= width else name[:width - 3] + "..."


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    order statistics (numpy's default), with ``inf`` for failures."""
    xs = sorted(values)
    if not xs:
        return float("nan")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == float("inf"):
        return float("inf") if pos > lo or xs[lo] == float("inf") else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
