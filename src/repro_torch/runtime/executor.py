"""Compile + execute stages of the plan/compile/execute architecture.

``runtime.planner`` produces a pure :class:`~repro_torch.runtime.planner
.ReconPlan`; this module turns it into tensors on one device:

  * :class:`ProgramCache`: the **compile** stage. One program per
    ``(variant, call_shape, nb, dtype, interpret, options)`` key, and a
    second key family for the step-major walk that adds the chunk-loop
    shape ``(n_chunks, chunk_size)``. PyTorch runs eagerly, so a program
    is a plain callable with its options bound; repeated ``reconstruct``
    calls still hit the same entries, and hits and misses are
    introspectable (``cache.stats()``). A module-level default cache
    persists across executors.

  * :class:`PlanExecutor`: the **execute** stage, for the untiled plan on
    one device. Under ``schedule="step"`` (the default) every chunk is
    filtered once, the filtered chunks are stacked on the device, and one
    loop over the chunks accumulates the volume there: one kernel launch
    per chunk, one host crossing at most. ``schedule="chunk"`` filters and
    back-projects chunk by chunk, so only one filtered chunk is resident;
    with ``out="host"`` each chunk's contribution crosses to a host
    accumulator.

The tiled walks, the async flush pipeline, request batching, streaming
ingest and the multi-device fleet wait in ROADMAP.md and raise
``NotImplementedError`` here.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import check_on_device, resolve_device
from repro_torch.convert import tensor_from_numpy
from repro_torch.core import backproject as bp
from repro_torch.core.filtering import fdk_filter_chunk
from repro_torch.core.geometry import CTGeometry, projection_matrices
from repro_torch.core.tiling import pad_projection_batch, plan_proj_chunks
from repro_torch.core.variants import get_spec
from repro_torch.runtime.planner import (
    ReconPlan, StepMajorSchedule, build_step_major,
)


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md queue 1 "
        f"item {item})")


# --------------------------------------------------------------------------
# Compile: the keyed program cache
# --------------------------------------------------------------------------

def _plan_dtype(plan: ReconPlan) -> str:
    """ProgramCache dtype key of a plan's precision axis."""
    if plan.precision != "f32":
        raise _unported(f"precision={plan.precision!r}", "8")
    return "float32"


class ProgramCache:
    """Keyed cache of back-projection programs.

    Kernel programs are keyed ``(variant, call_shape, nb, dtype,
    interpret, options)``; step-major programs add the chunk-loop shape.
    The cache is thread-safe and introspectable: ``stats()`` reports
    hits, misses (== programs built), and the live key count.
    """

    def __init__(self):
        self._programs: Dict[tuple, Callable] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get_or_build(self, key: tuple, builder: Callable[[], Callable]):
        with self._lock:
            prog = self._programs.get(key)
            if prog is not None:
                self.hits += 1
                return prog
        prog = builder()
        with self._lock:
            self._programs.setdefault(key, prog)
            self.misses += 1
            return self._programs[key]

    def program(self, variant: str, call_shape: Tuple[int, int, int],
                nb: int, dtype: str, interpret: bool,
                options: Tuple = ()) -> Callable:
        """``prog(img_t_chunk, mats_chunk) -> vol_t(call_shape)``."""
        key = ("kernel", variant, tuple(call_shape), int(nb), str(dtype),
               bool(interpret), tuple(options))

        def build():
            spec = get_spec(variant)
            opts = spec.resolve_options(
                {**dict(options), "nb": int(nb), "interpret": bool(interpret)})
            shape = tuple(call_shape)
            return lambda img, mat: spec.fn(img, mat, shape, **opts)

        return self.get_or_build(key, build)

    def scan_program(self, variant: str, call_shape: Tuple[int, int, int],
                     nb: int, dtype: str, interpret: bool,
                     options: Tuple = (), *, n_chunks: int,
                     chunk_size: int) -> Callable:
        """Step-major program: ``prog(img_chunks, mat_chunks) ->
        vol_t(call_shape)`` where the inputs are the STACKED chunk axes
        ``(n_chunks, chunk_size, ...)``.

        A loop over the chunks carries the call-shape accumulator on the
        device: one kernel launch per chunk, summed in chunk order (in
        place, so the accumulator is the first chunk's output buffer).
        """
        key = ("scan", variant, tuple(call_shape), int(nb), str(dtype),
               bool(interpret), tuple(options), int(n_chunks),
               int(chunk_size))

        def build():
            spec = get_spec(variant)
            opts = spec.resolve_options(
                {**dict(options), "nb": int(nb), "interpret": bool(interpret)})
            shape = tuple(call_shape)

            def prog(img_s, mat_s):
                acc = spec.fn(img_s[0], mat_s[0], shape, **opts)
                for c in range(1, int(n_chunks)):
                    acc += spec.fn(img_s[c], mat_s[c], shape, **opts)
                return acc
            return prog

        return self.get_or_build(key, build)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "programs": len(self._programs)}


_DEFAULT_CACHE = ProgramCache()


def default_program_cache() -> ProgramCache:
    """The process-wide cache shared by every executor (and entry point)."""
    return _DEFAULT_CACHE


# --------------------------------------------------------------------------
# Execute: padding and the filtered-chunk producer
# --------------------------------------------------------------------------

def _pad_mats(mats: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Pad (np, 3, 4) matrices to n_pad rows by repeating the last one
    (a valid geometry: no 1/z poles; pairs with zero-image padding)."""
    pad = int(n_pad) - mats.shape[0]
    if pad <= 0:
        return mats
    return torch.cat([mats, mats[-1:].expand(pad, 3, 4)], dim=0)


def _pad_rows(img: torch.Tensor, mat: torch.Tensor, n_rows: int):
    """Pad projections + matrices to ``n_rows`` leading rows: zero
    images (back-projection is linear: they add nothing) paired with
    :func:`_pad_mats`' repeated-last-matrix padding."""
    pad = int(n_rows) - img.shape[0]
    if pad <= 0:
        return img, mat
    img = torch.cat([img, img.new_zeros((pad,) + tuple(img.shape[1:]))],
                    dim=0)
    return img, _pad_mats(mat, int(n_rows))


def _stack_chunks(img_p: torch.Tensor, mat_p: torch.Tensor,
                  sched: StepMajorSchedule):
    """Reshape padded projections to the chunk grid ``(n_chunks,
    chunk_size, ...)``, zero-padding the tail chunk's slack rows."""
    img_p, mat_p = _pad_rows(img_p, mat_p, sched.n_scan)
    img_s = img_p.reshape((sched.n_chunks, sched.chunk_size)
                          + tuple(img_p.shape[1:]))
    mat_s = mat_p.reshape(sched.n_chunks, sched.chunk_size, 3, 4)
    return img_s, mat_s


class _FilteredChunkProducer:
    """Filter-once projection-chunk source for ``reconstruct``.

    Memoizes the filtered + transposed chunks of ``plan.chunks`` so each
    chunk is filtered once. ``stacked`` fills the step-major chunk grid,
    every chunk filtered exactly once, straight into one preallocated
    tensor (no second copy of the filtered set). ``drop`` releases a
    consumed chunk in the chunk-major loop so one filtered chunk stays
    resident. Kernels and filters run in order on one stream, so there
    is no filtering to prefetch ahead of the back-projection.
    """

    def __init__(self, ex: "PlanExecutor", projections: torch.Tensor,
                 mat_p: torch.Tensor):
        self._ex = ex
        self._projections = projections
        self._mat_p = mat_p
        self._chunks = ex.plan.chunks
        self._memo: Dict[int, tuple] = {}

    def get(self, c: int):
        """Filtered ``(img_c, mat_c)`` of chunk ``c`` (memoized)."""
        if c not in self._memo:
            s0, s1 = self._chunks[c]
            self._memo[c] = self._ex._chunk_inputs(
                self._projections, self._mat_p, s0, s1)
        return self._memo[c]

    def drop(self, c: int) -> None:
        self._memo.pop(c, None)

    def stacked(self, sched: StepMajorSchedule):
        """All chunks, filtered once each, as the chunk grid stack."""
        geom = self._ex.geom
        dev = self._mat_p.device
        img_s = torch.zeros((sched.n_chunks, sched.chunk_size, geom.nw,
                             geom.nh), dtype=torch.float32, device=dev)
        mat_s = torch.empty((sched.n_chunks, sched.chunk_size, 3, 4),
                            dtype=torch.float32, device=dev)
        for c in range(sched.n_chunks):
            img_c, mat_c = self.get(c)
            self.drop(c)   # the stack is the only remaining consumer
            n = img_c.shape[0]
            img_s[c, :n] = img_c
            # tail chunk -> uniform slot: zero images, repeated matrices
            mat_s[c] = _pad_mats(mat_c, sched.chunk_size)
        return img_s, mat_s


# --------------------------------------------------------------------------
# The executor
# --------------------------------------------------------------------------

class PlanExecutor:
    """Executes the untiled :class:`ReconPlan` on one device.

    One executor serves any number of calls; programs come from the
    (shared) :class:`ProgramCache`. The loop ORDER follows
    ``plan.schedule``: step-major (filter every chunk once, stack, one
    device-resident accumulation over the chunks) by default, chunk-major
    on request. ``device=None`` means the CUDA card; without one, pass
    ``device="cpu"`` to run the plain PyTorch path.
    """

    def __init__(self, geom: CTGeometry, plan: ReconPlan,
                 cache: Optional[ProgramCache] = None, *,
                 pipeline: str = "sync", fleet=None, device=None):
        if pipeline not in ("sync", "async"):
            raise ValueError(
                f"pipeline must be 'sync' or 'async', got {pipeline!r}")
        if pipeline == "async":
            raise _unported("pipeline='async'", "7")
        if fleet is not None:
            raise _unported("fleet execution", "11")
        self.device = resolve_device(device)
        self.geom = geom
        self.plan = plan
        self._dtype = _plan_dtype(plan)
        if not self._single_full_call():
            raise _unported("a tiled plan", "7")
        if plan.ingest != "offline":
            raise _unported("ingest='stream'", "10")
        if plan.solver != "none":
            raise _unported(f"solver={plan.solver!r}", "8")
        if plan.request_batch != 1:
            raise _unported("request batching", "10")
        self.cache = cache if cache is not None else default_program_cache()

    # ---- compile-stage access -------------------------------------------

    def _program(self, variant: str, call_shape) -> Callable:
        return self.cache.program(variant, call_shape, self.plan.nb,
                                  self._dtype, self.plan.interpret,
                                  self.plan.options)

    def _scan_program(self, variant: str, call_shape,
                      sched: StepMajorSchedule) -> Callable:
        return self.cache.scan_program(variant, call_shape, self.plan.nb,
                                       self._dtype, self.plan.interpret,
                                       self.plan.options,
                                       n_chunks=sched.n_chunks,
                                       chunk_size=sched.chunk_size)

    def warm(self) -> Dict[str, int]:
        """Build every distinct program the plan needs; return stats."""
        if self.plan.schedule == "step":
            sched = self.plan.step_major
            for variant, shape in self.plan.program_keys:
                self._scan_program(variant, shape, sched)
        else:
            for variant, shape in self.plan.program_keys:
                self._program(variant, shape)
        return self.cache.stats()

    # ---- execute-stage helpers ------------------------------------------

    def _single_full_call(self) -> bool:
        """One unpaired step covering the whole volume (the untiled plan)."""
        steps = self.plan.steps
        return (len(steps) == 1 and not steps[0].paired
                and steps[0].call_shape == self.plan.vol_shape_xyz
                and (steps[0].i0, steps[0].j0, steps[0].k_off) == (0, 0, 0))

    def _chunks_for(self, n_padded: int):
        """Chunk schedule for the ACTUAL (padded) projection count.

        ``backproject`` accepts any (np, nw, nh) input, not just
        ``geom.n_proj`` views (the plan's count): the plan contributes
        the streaming *policy* (chunk size, or all-at-once), the data
        contributes the extent."""
        plan = self.plan
        _, _, chunks = plan_proj_chunks(
            n_padded, plan.nb,
            plan.chunk_size if plan.streams_projections else None)
        return chunks

    def _as_input(self, name: str, x) -> torch.Tensor:
        """A float32 tensor on this executor's device: numpy arrays are
        copied there, tensors must already lie there."""
        if isinstance(x, np.ndarray):
            return tensor_from_numpy(x, self.device)
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor or numpy array, got "
                            f"{type(x).__name__}")
        check_on_device(name, x, self.device)
        return x.to(torch.float32)

    def _chunk_inputs(self, projections: torch.Tensor, mat_p: torch.Tensor,
                      s0: int, s1: int):
        """Filter + transpose the raw rows of one padded chunk [s0, s1)."""
        plan = self.plan
        raw = projections[s0:min(s1, plan.n_proj)]
        img_c = bp.transpose_projections(
            fdk_filter_chunk(raw, self.geom, plan.n_proj))
        # tail chunk: zero images pair with the repeated matrices
        return _pad_rows(img_c, mat_p[s0:s1], s1 - s0)

    def _run_chunks(self, chunk_inputs, n_chunks: int):
        """Chunk-major: one program call per chunk, accumulated on the
        device (``out="device"``) or, chunk by chunk, on the host."""
        step = self.plan.steps[0]
        prog = self._program(step.variant, step.call_shape)
        host = self.plan.out == "host"
        acc = (np.zeros(self.plan.vol_shape_xyz, np.float32) if host
               else None)
        for c in range(n_chunks):
            part = prog(*chunk_inputs(c))
            if host:
                acc += part.cpu().numpy()
            elif acc is None:
                acc = part
            else:
                acc += part
        return acc

    def _run_stacked(self, img_s, mat_s, sched: StepMajorSchedule):
        """Step-major: the chunk loop on the device, one host crossing
        at most."""
        step = self.plan.steps[0]
        acc = self._scan_program(step.variant, step.call_shape,
                                 sched)(img_s, mat_s)
        return acc.cpu().numpy() if self.plan.out == "host" else acc

    # ---- full-volume drivers --------------------------------------------

    def backproject(self, img_t, mats):
        """Back-project pre-filtered transposed projections.

        img_t: (np, nw, nh); mats: (np, 3, 4), on this executor's device.
        Returns vol_t (nx, ny, nz): a tensor, or numpy when ``plan.out ==
        "host"``. The tail batch is padded ONCE here.
        """
        img_t = self._as_input("img_t", img_t)
        mats = self._as_input("mats", mats)
        img_p, mat_p = pad_projection_batch(img_t, mats, self.plan.nb)
        chunks = self._chunks_for(img_p.shape[0])
        if self.plan.schedule == "step":
            sched = build_step_major(self.plan.steps, chunks,
                                     chunks[0][1] - chunks[0][0])
            return self._run_stacked(*_stack_chunks(img_p, mat_p, sched),
                                     sched)
        return self._run_chunks(
            lambda c: (img_p[chunks[c][0]:chunks[c][1]],
                       mat_p[chunks[c][0]:chunks[c][1]]), len(chunks))

    def reconstruct(self, projections):
        """Filtered FDK: (np, nh, nw) raw -> (nz, ny, nx) volume.

        Pre-weighting + ramp filtering run inside the projection-chunk
        pipeline, each chunk filtered exactly once. Under the default
        step-major schedule the filtered chunk stack rides on the device;
        ``schedule="chunk"`` keeps one filtered chunk resident. Returns a
        tensor view in native layout, or numpy when ``plan.out ==
        "host"`` (a transposed view of the host accumulator).
        """
        plan = self.plan
        projections = self._as_input("projections", projections)
        if projections.shape[0] != plan.n_proj:
            raise ValueError(
                f"reconstruct expects the geometry's full scan of "
                f"{plan.n_proj} projections (the FDK angular weighting "
                f"assumes it), got {projections.shape[0]}; for arbitrary "
                f"view subsets filter upstream and call backproject()")
        mat_p = _pad_mats(projection_matrices(self.geom, self.device),
                          plan.n_proj_padded)
        producer = _FilteredChunkProducer(self, projections, mat_p)
        if plan.schedule == "step":
            sched = plan.step_major
            vol = self._run_stacked(*producer.stacked(sched), sched)
        else:
            def chunk_inputs(c):
                inputs = producer.get(c)
                producer.drop(c)
                return inputs
            vol = self._run_chunks(chunk_inputs, len(plan.chunks))
        if isinstance(vol, np.ndarray):
            return np.transpose(vol, (2, 1, 0))
        return bp.volume_to_native(vol)

    # ---- not ported yet ---------------------------------------------------

    def open_stream(self, **_):
        raise _unported("open_stream (online ingest)", "10")

    def execute_batch(self, projections_seq):
        raise _unported("execute_batch (request batching)", "10")

    def execute_distributed(self, img_t, mats, mesh, **_):
        raise _unported("execute_distributed", "11")
