"""Build the CUDA sources of this package at first use and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with
a plain C interface, which ``ctypes`` loads. The library lands in
``kernels/build/<name>-<hash>/`` (ignored by git), keyed by a hash of the
source, every shared header ``csrc/*.cuh`` and the flags, so a changed
source or header builds anew and an unchanged one is reused. Nothing here runs at import time: this module is imported
on machines without ``nvcc``, where only a build attempt fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: per source: seconds the last build took in this process and the
#: compiler's resource report (``-Xptxas -v``); empty for a reused build
build_log: Dict[str, dict] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels of repro_torch cannot be built")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_ROOT / f"{name}-{digest}" / f"lib{name}.so"


def _start(name: str):
    """Start nvcc for one source into a temporary file; None if the
    library for this exact source already exists."""
    out = _target(name)
    if out.is_file():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def build(names: Iterable[str]) -> None:
    """Build every named source that is not built yet, all nvcc processes
    started together. Raises ``RuntimeError`` on a failed build."""
    started = {n: _start(n) for n in names}
    failed = []
    for name, job in started.items():
        if job is None:
            build_log.setdefault(name, {"seconds": 0.0, "log": ""})
            continue
        proc, tmp, out, t0 = job
        log, _ = proc.communicate()
        build_log[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)   # atomic: concurrent builders never see a
        #                        half-written library
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            _loaded[name] = lib
        return lib
