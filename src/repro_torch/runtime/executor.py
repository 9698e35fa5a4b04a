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
    persists across executors. Beside it, :class:`MatrixCache` keeps
    each ``(geometry, device, padding)``'s per-view matrices on the
    device, built once a process and shared read-only by every walk.

  * :class:`PlanExecutor`: the **execute** stage, on one device. It walks
    the plan's tile steps (sub-boxes of the volume with translated
    matrices; mirror-paired Z-slabs run at virtual depth ``2*tk`` and
    write two slabs). Under ``schedule="step"`` (the default) every
    chunk is filtered once, the filtered chunks are stacked on the
    device, and per step one loop over the chunks carries the step's
    accumulator there: one kernel launch per step and chunk, one host
    crossing per step. ``schedule="chunk"`` filters and back-projects
    chunk by chunk, so only one filtered chunk is resident, and adds
    every step's piece of every chunk into the volume. ``out="device"``
    adds the pieces into a volume on the card in place; ``out="host"``
    into a numpy volume, so the volume may exceed the card's memory.
    ``pipeline="async"`` moves the host adds onto a flusher thread
    (:class:`_AsyncFlushQueue`): a side stream copies each step's pieces
    into pinned host buffers while the next step runs. The way in mirrors
    it: a host scan of a MiB or more reaches a card through the calling
    thread's :class:`_HostStager` (two pinned slots, a copy stream of the
    thread's own, an event before the caller's stream uses it), so its
    copy neither takes the pageable path nor holds the kernels' stream.

  * Request batching: :meth:`PlanExecutor.execute_batch` reconstructs
    rb same-bucket requests with one launch per step and chunk. The
    ``batch_*`` programs call each variant's lane form
    (``core.variants.KernelSpec.lanes``: one rb-lane launch of the CUDA
    kernel, whose lanes each equal the solo launch bit for bit), so every
    request's volume is bit-identical to ``reconstruct`` on it alone.

  * :class:`StreamingExecutor`: online ingest (``open_stream`` on an
    ``ingest="stream"`` plan). Views are pushed as the scanner produces
    them into host chunk buffers; each complete chunk goes to the device,
    is filtered and folded into per-step accumulators in chunk order, so
    ``close()`` is bit-identical to the chunk-major ``reconstruct``.

Precision rides the plan: ``precision="bf16"`` wraps every program so
that projection samples enter the kernel rounded to bfloat16 while the
matrices, weights, accumulators and the output stay float32
(:func:`_precision_adapter`). Solver plans run here too, driven by
``runtime.solvers.IterativeExecutor``. Telemetry spans (``compile``,
``ingest``, ``geometry.matrices``, ``filter.chunk``, ``filter.stack``,
``step.dispatch``, ``flush`` on the flusher thread, ``stream.fold`` and
``stream.tail``) ride every walk (``runtime.telemetry``); those with a
``record_function`` range under ``REPRO_TRACE_NVTX=1`` (``ingest``,
``geometry.matrices``, ``filter.*``, ``step.dispatch``) let a profiler
trace assign the device work they launch.

  * The reconstruction fleet: :meth:`PlanExecutor.execute_fleet` (an
    executor built with ``fleet=``, a :class:`FleetConfig`) spreads the
    step-major walk over a tuple of torch devices, one dispatcher thread
    per entry (an entry may repeat: ``("cuda:0",) * 2`` runs two workers
    on one card, ``("cpu",) * 8`` eight on the CPU). Steps start on LPT
    queues (``runtime.planner.partition_steps``); an idle worker steals,
    stragglers first (``runtime.straggler.FleetStragglerBoard``), and a
    failed step re-runs elsewhere under a per-step retry budget. Each
    step runs the origin-taking step program
    (:meth:`ProgramCache.fleet_program`), which folds the origin exactly
    as the single-device walk does, and writes a disjoint box of the
    host volume, so the fleet's volume equals the single-device walk's
    bit for bit. ``fleet.steal``, ``fleet.failover`` and ``fleet.retire``
    instants mark what the fleet did; each worker is its own thread lane
    (``recon-fleet-{d}``).

  * The mesh: :meth:`PlanExecutor.execute_distributed` composes full-Z
    (i, j)-tiles with a pod/data/model mesh (``launch.mesh.Mesh``), one
    program of ``core.distributed.make_distributed_bp`` per tile shape,
    into a zeroed host volume (through the async flusher with
    ``pipeline="async"``, bit for bit equal to sync).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import check_on_device, device_scope, resolve_device
from repro_torch.convert import host_float32, tensor_from_numpy
from repro_torch.core import backproject as bp
from repro_torch.core.filtering import fdk_filter_chunk
from repro_torch.core.geometry import CTGeometry, projection_matrices
from repro_torch.core.tiling import (
    TileSpec, make_tiles, pad_projection_batch, plan_proj_chunks,
    translate_matrices,
)
from repro_torch.core.variants import get_spec
from repro_torch.runtime import telemetry
from repro_torch.runtime.planner import (
    PlanStep, ReconPlan, StepMajorSchedule, build_step_major,
    partition_steps, resolve_tile_variant,
)
from repro_torch.runtime.straggler import FleetStragglerBoard


# --------------------------------------------------------------------------
# Compile: the keyed program cache
# --------------------------------------------------------------------------

def _plan_dtype(plan: ReconPlan) -> str:
    """ProgramCache dtype key of a plan's precision axis."""
    return "bfloat16" if plan.precision == "bf16" else "float32"


def _precision_adapter(dtype: str):
    """Input-side precision transform for one kernel program, or None.

    ``dtype == "bfloat16"`` implements the plan-level ``precision=
    "bf16"`` contract: projection samples are rounded to bfloat16 on the
    way into the kernel, while the per-view matrices, the interpolation
    weights derived from them and every accumulator stay float32. Every
    variant, CUDA kernel or plain PyTorch, receives the bf16-rounded
    values upcast back to float32. The JAX package hands its pure-JAX
    variants the bf16 array itself and relies on JAX promoting it to
    float32 at the first product; torch does not promote a 0-dim float32
    tensor times a bf16 tensor, so the port rounds and upcasts for every
    variant (the same rounding, and the kernels stay float32 kernels).
    """
    if str(dtype) == "float32":
        return None
    if str(dtype) != "bfloat16":
        raise ValueError(
            f"unsupported program dtype {dtype!r}: 'float32' or "
            f"'bfloat16'")
    return lambda img: img.to(torch.bfloat16).to(torch.float32)


def _with_precision(fn, dtype: str):
    """Wrap a kernel fn with the precision adapter (f32 = pass-through)."""
    cast = _precision_adapter(dtype)
    if cast is None:
        return fn

    def wrapped(img, mat, shape, **opts):
        return fn(cast(img), mat, shape, **opts)

    return wrapped


def _step_program(variant: str, call_shape: Tuple[int, int, int], nb: int,
                  dtype: str, interpret: bool, options: Tuple,
                  n_chunks: int, rb: Optional[int] = None) -> Callable:
    """The step-major program: ``prog(img_s, mat_s) -> vol_t(call_shape)``
    over the STACKED chunk axes ``(n_chunks, chunk_size, ...)``, one kernel
    launch per chunk summed in chunk order in place (the accumulator is
    the first chunk's output buffer). ``rb`` lanes: ``prog(img_b, mat_s)
    -> vol_b((rb,) + call_shape)`` with ``img_b`` ``(rb, n_chunks,
    chunk_size, ...)`` and ONE lane launch per chunk (``KernelSpec.
    lanes``), each lane's sum in the same order as the solo program."""
    spec = get_spec(variant)
    opts = spec.resolve_options(
        {**dict(options), "nb": int(nb), "interpret": bool(interpret)})
    shape = tuple(call_shape)
    if rb is None:
        fn = _with_precision(spec.fn, dtype)

        def prog(img_s, mat_s):
            acc = fn(img_s[0], mat_s[0], shape, **opts)
            for c in range(1, int(n_chunks)):
                acc += fn(img_s[c], mat_s[c], shape, **opts)
            return acc
        return prog
    lanes = _with_precision(spec.lanes, dtype)

    def prog_lanes(img_b, mat_s):
        acc = lanes(img_b[:, 0], mat_s[0], shape, **opts)
        for c in range(1, int(n_chunks)):
            acc += lanes(img_b[:, c], mat_s[c], shape, **opts)
        return acc
    return prog_lanes


def fold_origin(mats: torch.Tensor, origin) -> torch.Tensor:
    """``mats`` with a step's voxel origin ``(i0, j0, k_off)`` folded into
    the constant column (``core.tiling.translate_matrices``); the origin
    ``(0, 0, 0)`` returns ``mats`` itself. The single-device walk and the
    fleet's step program both fold through here, on the device that runs
    the step, so a step's matrices carry the same bits on either path."""
    i0, j0, k_off = origin
    if (i0, j0, k_off) == (0, 0, 0):
        return mats
    return translate_matrices(mats, float(i0), float(j0), float(k_off))


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
        # the span wraps builder() and nothing else, so the "compile"
        # span count equals self.misses exactly
        with telemetry.span("compile", cat="compile", key=repr(key)):
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
            fn = _with_precision(spec.fn, dtype)
            return lambda img, mat: fn(img, mat, shape, **opts)

        return self.get_or_build(key, build)

    def batch_program(self, variant: str, call_shape: Tuple[int, int, int],
                      nb: int, dtype: str, interpret: bool,
                      options: Tuple = (), *, rb: int) -> Callable:
        """rb-lane program: ``prog(img_b, mat) -> vol_b((rb,) +
        call_shape)`` where ``img_b`` stacks rb filtered projection chunks
        ``(rb, chunk, nw, nh)`` over ONE shared matrix chunk: one lane
        launch of the variant's kernel (``KernelSpec.lanes``). The
        streaming service folds the same view chunk of rb same-bucket
        sessions with it; each lane is bit-identical to :meth:`program`
        on that lane's input."""
        key = ("batch_kernel", variant, tuple(call_shape), int(nb),
               str(dtype), bool(interpret), tuple(options), int(rb))

        def build():
            spec = get_spec(variant)
            opts = spec.resolve_options(
                {**dict(options), "nb": int(nb), "interpret": bool(interpret)})
            shape = tuple(call_shape)
            lanes = _with_precision(spec.lanes, dtype)
            return lambda img_b, mat: lanes(img_b, mat, shape, **opts)

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
        return self.get_or_build(key, lambda: _step_program(
            variant, call_shape, nb, dtype, interpret, options, n_chunks))

    def batch_scan_program(self, variant: str,
                           call_shape: Tuple[int, int, int],
                           nb: int, dtype: str, interpret: bool,
                           options: Tuple = (), *, n_chunks: int,
                           chunk_size: int, rb: int) -> Callable:
        """rb-lane step-major program: ``prog(img_b, mat_s) ->
        vol_b((rb,) + call_shape)`` where ``img_b`` stacks rb requests'
        chunk grids ``(rb, n_chunks, chunk_size, ...)`` and ``mat_s`` is
        the SHARED chunk-stacked matrix grid (same-bucket requests share
        the geometry). Per chunk, ONE lane launch serves every request;
        each lane's sum runs over the chunks in the order of
        :meth:`scan_program`, so every lane is bit-identical to the solo
        program on that request."""
        key = ("batch_scan", variant, tuple(call_shape), int(nb),
               str(dtype), bool(interpret), tuple(options), int(n_chunks),
               int(chunk_size), int(rb))
        return self.get_or_build(key, lambda: _step_program(
            variant, call_shape, nb, dtype, interpret, options, n_chunks,
            rb=int(rb)))

    def fleet_program(self, variant: str, call_shape: Tuple[int, int, int],
                      nb: int, dtype: str, interpret: bool,
                      options: Tuple = (), *, n_chunks: int,
                      chunk_size: int) -> Callable:
        """Fleet step program: ``prog(img_s, mat_s, origin) ->
        vol_t(call_shape)``: :meth:`scan_program` with the step origin
        ``(i0, j0, k_off)`` as a call-time argument
        (``core.distributed.make_fleet_bp``), so one key serves every
        same-shape step on every device: work stealing and failover never
        add a key."""
        key = ("fleet", variant, tuple(call_shape), int(nb), str(dtype),
               bool(interpret), tuple(options), int(n_chunks),
               int(chunk_size))

        def build():
            from repro_torch.core.distributed import make_fleet_bp
            return make_fleet_bp(
                variant, tuple(call_shape), nb=int(nb),
                n_chunks=int(n_chunks), chunk_size=int(chunk_size),
                options=tuple(options), interpret=bool(interpret))

        return self.get_or_build(key, build)

    def batch_fleet_program(self, variant: str,
                            call_shape: Tuple[int, int, int],
                            nb: int, dtype: str, interpret: bool,
                            options: Tuple = (), *, n_chunks: int,
                            chunk_size: int, rb: int) -> Callable:
        """rb-lane fleet step program: ``prog(img_b, mat_s, origin) ->
        vol_b((rb,) + call_shape)``: :meth:`fleet_program`'s origin
        argument over :meth:`batch_scan_program`'s lanes, so a fleet runs
        k batched requests' steps with one lane launch per (entry, step,
        chunk), and stealing and failover still build nothing."""
        key = ("batch_fleet", variant, tuple(call_shape), int(nb),
               str(dtype), bool(interpret), tuple(options), int(n_chunks),
               int(chunk_size), int(rb))

        def build():
            from repro_torch.core.distributed import make_fleet_bp
            return make_fleet_bp(
                variant, tuple(call_shape), nb=int(nb),
                n_chunks=int(n_chunks), chunk_size=int(chunk_size),
                options=tuple(options), interpret=bool(interpret),
                rb=int(rb))

        return self.get_or_build(key, build)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "programs": len(self._programs)}


_DEFAULT_CACHE = ProgramCache()


def default_program_cache() -> ProgramCache:
    """The process-wide cache shared by every executor (and entry point)."""
    return _DEFAULT_CACHE


def _device_key(device: torch.device) -> torch.device:
    """``device`` with its index: an unindexed ``cuda`` is the calling
    thread's current card, where an upload to it lands."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _stream_id(device: torch.device) -> int:
    """The id of the calling thread's current stream on card ``device``
    (indexed), without building a ``torch.cuda.Stream``: a lookup's hit
    path reads it every call."""
    return torch._C._cuda_getCurrentStream(device.index)[0]


class MatrixCache:
    """Process-wide LRU cache of padded per-view projection matrices.

    Keyed ``(geometry, device, n_pad)``: ``CTGeometry`` is a frozen
    dataclass and hashes by value, the device carries its index. A miss
    builds ``_pad_mats(projection_matrices(geom, device), n_pad)`` and,
    on a card, waits for the build before it publishes the tensor, so a
    thread on another stream reads finished values; a hit on a stream
    other than the build's marks that stream as a user of the tensor, so
    an evicted entry's memory is not reused while a launch there still
    reads it. At most ``max_entries`` entries (a P10 entry is 24 KB).
    The same bits go to the kernels on a hit as on a miss. ``stats()``
    reports hits, misses and entries.
    """

    def __init__(self, max_entries: int = 32):
        self.max_entries = int(max_entries)
        # key -> (matrices, id of the stream they were built on or None)
        self._mats: "collections.OrderedDict[tuple, tuple]" = (
            collections.OrderedDict())
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _build(geom: CTGeometry, device: torch.device,
               n_pad: int) -> torch.Tensor:
        mats = _pad_mats(projection_matrices(geom, device), n_pad)
        if mats.is_cuda:
            torch.cuda.current_stream(mats.device).synchronize()
        return mats

    def lookup(self, geom: CTGeometry, device: torch.device,
               n_pad: int) -> Tuple[torch.Tensor, bool]:
        """``(matrices, hit)`` for ``geom`` on ``device`` padded to
        ``n_pad`` rows. Callers share the tensor: they may reshape,
        index, ``cat`` or copy it, never write into it."""
        device = _device_key(device)
        key = (geom, device, int(n_pad))
        try:
            hash(key)
        except TypeError:       # a geometry built with list fields
            return self._build(geom, device, n_pad), False
        with self._lock:
            entry = self._mats.get(key)
            hit = entry is not None
            if hit:
                self._mats.move_to_end(key)
                self.hits += 1
            else:
                # built under the lock: one build a key, however many
                # threads ask for it at once
                mats = self._build(geom, device, n_pad)
                entry = self._mats[key] = (
                    mats, _stream_id(device) if mats.is_cuda else None)
                self.misses += 1
                while len(self._mats) > self.max_entries:
                    self._mats.popitem(last=False)
        mats, built_on = entry
        if hit and built_on is not None and _stream_id(device) != built_on:
            mats.record_stream(torch.cuda.current_stream(device))
        return mats, hit

    def clear(self) -> None:
        with self._lock:
            self._mats.clear()
            self.hits = self.misses = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "entries": len(self._mats)}


_MATRIX_CACHE = MatrixCache()


def default_matrix_cache() -> MatrixCache:
    """The process-wide matrix cache behind every executor's walks."""
    return _MATRIX_CACHE


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


def _add_host(vol: np.ndarray, sl, piece: torch.Tensor) -> None:
    """``vol[sl] += piece`` for a CPU tensor ``piece``, on torch's CPU
    threads: float32 adds, the same bits as numpy's one-thread add."""
    torch.from_numpy(vol)[sl].add_(piece)


def _as_triple(vol, w) -> tuple:
    """A ``(slices, piece)`` write into ``vol`` as ``(vol, slices,
    piece)``; a ``(target, slices, piece)`` write as it is."""
    return w if len(w) == 3 else (vol, w[0], w[1])


class _AsyncFlushQueue:
    """Depth-bounded device->host flush pipeline: step N's host adds
    overlap step N+1's kernels.

    The dispatching thread hands over one step's ``(volume slices,
    device piece)`` writes into the constructor's volume, or ``(target
    volume, slices, piece)`` triples (the rb-lane walk fans one step out
    to rb request volumes through one queue, with ``vol=None``), right
    after launching the step and moves on.
    For CUDA pieces, :meth:`put` records an event on the compute stream
    after the step's launch; a side stream waits on it, copies each piece
    into a pinned host buffer (``non_blocking``) and records its own
    event. Each piece is marked as used by the side stream
    (``record_stream``), so the caching allocator does not hand its
    memory to a later step while the copy still reads it. A single
    flusher thread dequeues in FIFO order, waits on the copy's event,
    the only place the pipeline waits on the card, and adds into the
    host volume. ``depth`` bounds how many steps may be queued; a full
    queue holds back the dispatcher. One thread writes the host volume,
    in the order the sync walk adds, so the result is bit-identical.
    """

    def __init__(self, vol: Optional[np.ndarray], device: torch.device,
                 depth: int = 2):
        self._vol = vol
        self._device = device
        self._copy = (torch.cuda.Stream(device) if device.type == "cuda"
                      else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(depth)))
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._drain, name="recon-flush", daemon=True)
        self._thread.start()

    def _stage(self, writes):
        """Start the host copies of one step's writes; returns the host
        writes and the event that marks them done (None on the CPU,
        where the pieces are host memory already)."""
        writes = tuple(_as_triple(self._vol, w) for w in writes)
        if self._copy is None:
            return writes, None
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self._device))
        staged = []
        with torch.cuda.stream(self._copy):
            self._copy.wait_event(ready)
            for tgt, sl, piece in writes:
                host = torch.empty(tuple(piece.shape), dtype=piece.dtype,
                                   pin_memory=True)
                host.copy_(piece, non_blocking=True)
                piece.record_stream(self._copy)
                staged.append((tgt, sl, host))
            copied = torch.cuda.Event()
            copied.record(self._copy)
        return tuple(staged), copied

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                if self._error is None:   # keep consuming after a failure
                    writes, copied = item
                    with telemetry.span("flush", n_writes=len(writes)):
                        if copied is not None:
                            copied.synchronize()
                        for tgt, sl, host in writes:
                            _add_host(tgt, sl, host)
            except BaseException as exc:   # surfaced at put()/close()
                self._error = exc
            finally:
                self._q.task_done()

    def put(self, writes) -> None:
        """Enqueue one step's writes; blocks only when ``depth`` steps
        are already queued (backpressure, not a device sync)."""
        if self._error is not None:
            raise self._error
        self._q.put(self._stage(writes))

    def close(self) -> None:
        """Drain the queue, join the flusher, re-raise any failure."""
        self._q.put(None)
        self._thread.join()
        if self._error is not None:
            raise self._error


# the host->device staging ring: two pinned slots of this size a thread
# and card, and the smallest array that goes through it (a smaller one,
# e.g. the matrices, takes a plain copy: there is nothing to overlap)
_STAGE_SLOT_BYTES = 64 << 20
_STAGE_MIN_BYTES = 1 << 20


def _ingest_path(a: np.ndarray, device: torch.device) -> str:
    """How host array ``a`` reaches ``device``: ``"pinned"`` (through the
    thread's :class:`_HostStager`) for a card and at least
    ``_STAGE_MIN_BYTES`` of float32, else ``"pageable"`` (a plain
    ``.to``)."""
    if device.type == "cuda" and a.size * 4 >= _STAGE_MIN_BYTES:
        return "pinned"
    return "pageable"


def _stage_pieces(nbytes: int, slot_bytes: int = _STAGE_SLOT_BYTES):
    """The ``(start, stop)`` byte ranges, in order, in which ``nbytes``
    bytes pass through slots of ``slot_bytes``."""
    return [(o, min(o + slot_bytes, nbytes))
            for o in range(0, nbytes, slot_bytes)]


class _HostStager:
    """Host->device mirror of :class:`_AsyncFlushQueue`'s staging: one
    thread's copies of host arrays to one card, through two pinned slots
    on a copy stream of its own, so that they neither take the pageable
    path nor queue on the stream the kernels run on.

    :meth:`ingest` walks the array slot by slot: it waits (on the host)
    for the slot's last copy to end, copies the next piece into it (a
    host memcpy, with the interpreter lock released) and issues the
    piece's ``non_blocking`` copy to the card on the copy stream, so
    that the memcpy into one slot overlaps the copy out of the other. It
    returns once every byte has been read into the slots: the caller may
    overwrite its array then. The caller's stream waits on the last copy
    (an event), so its work sees the whole array. The device tensor is
    allocated on the copy stream, which writes it, and marked as used by
    the caller's stream (``record_stream``): the caching allocator thus
    never hands its memory to a copy while the caller's kernels still
    read it, and the copy stream need not wait for the caller's stream.
    """

    def __init__(self, device: torch.device):
        self._device = device
        self._copy = torch.cuda.Stream(device)
        self._slots = [torch.empty(_STAGE_SLOT_BYTES // 4,
                                   dtype=torch.float32, pin_memory=True)
                       for _ in range(2)]
        self._copied = [torch.cuda.Event() for _ in range(2)]

    def ingest(self, arr: np.ndarray) -> torch.Tensor:
        """A float32 tensor on the card holding C-contiguous float32
        host array ``arr``, ordered before the caller's stream's next
        work."""
        src = torch.from_numpy(arr).view(-1)
        with torch.cuda.stream(self._copy):
            out = torch.empty(arr.shape, dtype=torch.float32,
                              device=self._device)
        dst = out.view(-1)
        last = None
        for i, (b0, b1) in enumerate(_stage_pieces(arr.nbytes)):
            last = self._copied[i % 2]
            slot = self._slots[i % 2][:(b1 - b0) // 4]
            last.synchronize()        # the slot's previous copy has ended
            slot.copy_(src[b0 // 4:b1 // 4])
            with torch.cuda.stream(self._copy):
                dst[b0 // 4:b1 // 4].copy_(slot, non_blocking=True)
                last.record(self._copy)
        if last is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(last)
            out.record_stream(consumer)
        return out


# each thread's stagers, by card: a thread ingests one array at a time,
# so one ring a thread and card serves every executor it drives
_STAGERS = threading.local()


def _thread_stager(device: torch.device) -> _HostStager:
    """The calling thread's :class:`_HostStager` for ``device``, made on
    its first ingest there."""
    by_device = getattr(_STAGERS, "by_device", None)
    if by_device is None:
        by_device = _STAGERS.by_device = {}
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    stager = by_device.get(index)
    if stager is None:
        stager = by_device[index] = _HostStager(torch.device("cuda", index))
    return stager


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
            with telemetry.span("filter.chunk", nvtx=True) as sp:
                if sp.live:
                    sp.set(chunk=c, n_views=int(s1 - s0))
                self._memo[c] = self._ex._chunk_inputs(
                    self._projections, self._mat_p, s0, s1)
        return self._memo[c]

    def drop(self, c: int) -> None:
        self._memo.pop(c, None)

    def stacked(self, sched: StepMajorSchedule,
                img_s: Optional[torch.Tensor] = None):
        """All chunks, filtered once each, as the chunk grid stack,
        written into ``img_s`` (a zeroed grid: one lane of a batch) or a
        new one. The grid's allocation and each chunk's copy into it are
        ``filter.stack`` spans, beside (not around) the chunks'
        ``filter.chunk`` spans."""
        geom = self._ex.geom
        dev = self._mat_p.device
        with telemetry.span("filter.stack", nvtx=True):
            if img_s is None:
                img_s = torch.zeros((sched.n_chunks, sched.chunk_size,
                                     geom.nw, geom.nh),
                                    dtype=torch.float32, device=dev)
            mat_s = torch.empty((sched.n_chunks, sched.chunk_size, 3, 4),
                                dtype=torch.float32, device=dev)
        for c in range(sched.n_chunks):
            img_c, mat_c = self.get(c)
            self.drop(c)   # the stack is the only remaining consumer
            n = img_c.shape[0]
            with telemetry.span("filter.stack", nvtx=True):
                img_s[c, :n] = img_c
                # tail chunk -> uniform slot: zero images, repeated matrices
                mat_s[c] = _pad_mats(mat_c, sched.chunk_size)
        return img_s, mat_s


# --------------------------------------------------------------------------
# Fleet execution: the step schedule over several devices
# --------------------------------------------------------------------------

def _fleet_device(dev) -> torch.device:
    """One fleet entry as a torch device with its index (``"cuda"`` is the
    current card); a CUDA entry raises without a card, as
    ``resolve_device`` does, and past the last card."""
    d = resolve_device(dev)
    if d.type == "cuda":
        count = torch.cuda.device_count()
        d = torch.device("cuda", torch.cuda.current_device()
                         if d.index is None else d.index)
        if d.index >= count:
            raise ValueError(f"fleet entry {d} but {count} CUDA devices "
                             f"are available")
    return d


def _one_device_type(devs: Tuple[torch.device, ...],
                     device: Optional[torch.device] = None
                     ) -> Tuple[torch.device, ...]:
    """Refuse a fleet whose entries are not all of one device type, or not
    of the type of ``device`` (where the inputs are filtered): a failed
    card step could otherwise re-run on a CPU entry, through the plain
    version. Returns ``devs``."""
    types = {d.type for d in devs}
    if device is not None:
        types.add(device.type)
    if len(types) > 1:
        raise ValueError(
            f"a fleet runs on one device type: entries {list(map(str, devs))}"
            + (f" with inputs filtered on {device}" if device is not None
               else "")
            + "; name only CUDA devices or only the CPU")
    return devs


def _cuda_fleet(n: Optional[int] = None) -> Tuple[torch.device, ...]:
    """The first ``n`` CUDA devices (all of them for None); raises without
    a card: a fleet never runs on the CPU unless the caller names it."""
    resolve_device("cuda")
    count = torch.cuda.device_count()
    n = count if n is None else int(n)
    if not 1 <= n <= count:
        raise ValueError(
            f"devices={n} but {count} CUDA devices are available")
    return tuple(torch.device("cuda", i) for i in range(n))


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """How a :class:`PlanExecutor` spreads a step-major plan across
    devices (``execute_fleet``).

    devices : the fleet's entries, torch devices or their names; one
        worker thread runs per entry, and an entry may repeat
        (``("cuda:0",) * 2`` is two workers on one card, ``("cpu",) * 8``
        eight on the CPU). ``None`` resolves to every CUDA device at run
        time and raises without a card. The entries are all CUDA devices
        or all the CPU: a mix raises, so a card's failed step never
        re-runs on the CPU through the plain version.
    max_retries_per_step : failover budget PER STEP INDEX — the
        :class:`~repro_torch.runtime.fault_tolerance.FaultTolerantLoop`
        retry contract: counted per index, never reset by successes
        elsewhere. A step that fails more than this many times across the
        whole fleet aborts the run (a poison step; skipping it would leave
        a hole in the volume, unlike a training batch).
    device_strikes : step failures charged to one entry before it is
        RETIRED: its worker exits, its unclaimed queue is drained by the
        surviving entries through the normal stealing path, and its
        already-failed steps re-run elsewhere (disjoint output boxes, so
        re-running a step is idempotent).
    straggler_window / straggler_ratio : the
        :class:`~repro_torch.runtime.straggler.FleetStragglerBoard` knobs:
        an entry whose recent median step time exceeds ``ratio`` x the
        fleet median is flagged, and idle entries steal from flagged
        queues first.
    step_hook : test seam called as ``hook(entry_index, step_index)``
        before a step's program runs: raise to inject a device fault,
        sleep to simulate a straggler. ``None`` in production.
    """

    devices: Optional[Tuple] = None
    max_retries_per_step: int = 2
    device_strikes: int = 2
    straggler_window: int = 32
    straggler_ratio: float = 1.5
    step_hook: Optional[Callable[[int, int], None]] = None

    def resolve_devices(self) -> Tuple[torch.device, ...]:
        """The entries as torch devices; raises where they mix device
        types (``_one_device_type``) or ask for a card there is not."""
        return (_one_device_type(tuple(_fleet_device(d)
                                       for d in self.devices))
                if self.devices else _cuda_fleet())


@dataclasses.dataclass(frozen=True)
class FleetReport(telemetry.EmitMixin):
    """What one ``execute_fleet`` run did: per-entry completion counts,
    how many steps migrated (``stolen``), how many re-ran after a failure
    (``retried``), which entries were retired (``dead_devices``) and which
    the straggler board flagged (``flagged_devices``). ``as_dict()`` /
    ``emit()`` follow the shared :class:`~repro_torch.runtime.telemetry.
    EmitMixin` report contract."""

    n_devices: int
    n_steps: int
    steps_by_device: Tuple[int, ...]
    stolen: int
    retried: int
    dead_devices: Tuple[int, ...]
    flagged_devices: Tuple[int, ...]


def as_fleet_config(devices, *, max_retries_per_step: int = 2,
                    step_hook=None) -> Optional[FleetConfig]:
    """Normalize an entry point's ``devices=`` argument.

    ``None`` -> no fleet (single-device walks); ``"all"`` -> every CUDA
    device, resolved at run time; an ``int`` N -> the first N CUDA devices
    (resolved now); a sequence of devices (or their names) -> exactly
    those entries; an existing :class:`FleetConfig` passes through.
    Without a card, ``"all"`` and an int raise (``resolve_device``'s
    error): there is no silent CPU fleet.
    """
    if devices is None:
        return None
    if isinstance(devices, FleetConfig):
        return devices
    if isinstance(devices, str) and devices == "all":
        devs = None
    elif isinstance(devices, int) and not isinstance(devices, bool):
        devs = _cuda_fleet(devices)
    elif isinstance(devices, (str, torch.device)):
        raise ValueError(
            f"devices= takes 'all', an int or a sequence of devices, got "
            f"{devices!r}; for one entry pass ({devices!r},)")
    else:
        devs = _one_device_type(tuple(_fleet_device(d) for d in devices))
        if not devs:
            raise ValueError("devices sequence must be non-empty")
    return FleetConfig(devices=devs,
                       max_retries_per_step=max_retries_per_step,
                       step_hook=step_hook)


class _Replicas:
    """The filtered chunk grid on each distinct device of a fleet.

    The grid lies where it was filtered (the executor's device); another
    device gets its copy once, lazily, under a lock, the first time one of
    its workers takes a step: a repeated entry shares its device's copy,
    and a spare that never takes work pays none. On a card, the stream of
    the worker that asks waits for the grid: for the stream that filled
    it (an event recorded before any worker started) or for the copy."""

    def __init__(self, img_s: torch.Tensor, mat_s: torch.Tensor):
        self._lock = threading.Lock()
        self._grid = (img_s, mat_s)
        self._filled = self._event(img_s.device)
        self._by_device = {img_s.device: (img_s, mat_s, self._filled)}

    @staticmethod
    def _event(dev: torch.device):
        """An event recorded on ``dev``'s current stream (None off a card)."""
        if dev.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        return ev

    def get(self, dev: torch.device):
        """``(img_s, mat_s)`` on ``dev``, ready for the calling worker's
        current stream."""
        with self._lock:
            got = self._by_device.get(dev)
            if got is None:
                img_s, mat_s = self._grid
                if self._filled is not None:
                    if dev.type == "cuda":
                        torch.cuda.current_stream(dev).wait_event(
                            self._filled)
                    else:
                        self._filled.synchronize()
                got = (img_s.to(dev), mat_s.to(dev), self._event(dev))
                self._by_device[dev] = got
        img, mat, ready = got
        if ready is not None:
            torch.cuda.current_stream(dev).wait_event(ready)
        return img, mat


def _worker_stream(dev: torch.device):
    """A stream of its own for a fleet worker on a card (so one worker's
    host copy does not wait for another worker's kernels); on the CPU a
    no-op. Returns ``(context, stream or None)``."""
    if dev.type != "cuda":
        return contextlib.nullcontext(), None
    stream = torch.cuda.Stream(dev)
    return torch.cuda.stream(stream), stream


# --------------------------------------------------------------------------
# The executor
# --------------------------------------------------------------------------

class PlanExecutor:
    """Executes a :class:`ReconPlan` on one device.

    One executor serves any number of calls; programs come from the
    (shared) :class:`ProgramCache`. The loop ORDER follows
    ``plan.schedule``: step-major (filter every chunk once, stack, one
    device-resident accumulation per step over the chunks) by default,
    chunk-major on request. ``device=None`` means the CUDA card; without
    one, pass ``device="cpu"`` to run the plain PyTorch path.

    ``pipeline`` selects the host flush: ``"sync"`` (in the dispatching
    thread, step N-1's pieces after step N's launch) or ``"async"`` (an
    :class:`_AsyncFlushQueue`: a side stream and a flusher thread, at
    most ``pipeline_depth`` steps queued). Async changes only WHEN the
    host adds happen, never their order, so the output is bit-identical;
    it engages where the plan accumulates on the host.

    The executor can also be built straight from an autotuned winner:
    :meth:`from_config` takes a ``runtime.autotune.TunedConfig`` and
    keeps it as ``.tuned`` (provenance; None = heuristic knobs).

    ``fleet`` (a :class:`FleetConfig`) runs every reconstruction through
    :meth:`execute_fleet`. The
    inputs are filtered on ``device``, which under a fleet defaults to the
    fleet's first entry; the workers take the filtered grid from there.
    The entries and ``device`` must be of one device type, all CUDA or
    all CPU (``ValueError`` otherwise).
    """

    def __init__(self, geom: CTGeometry, plan: ReconPlan,
                 cache: Optional[ProgramCache] = None, *,
                 pipeline: str = "sync", pipeline_depth: int = 2,
                 tuned=None, fleet=None, device=None):
        if pipeline not in ("sync", "async"):
            raise ValueError(
                f"pipeline must be 'sync' or 'async', got {pipeline!r}")
        if fleet is not None:
            if plan.schedule != "step":
                raise ValueError(
                    "fleet execution shards the STEP schedule (disjoint "
                    "output boxes are the shard axis); plan with "
                    f"schedule='step', got {plan.schedule!r}")
            if plan.out != "host":
                raise ValueError(
                    "fleet execution accumulates each entry's step outputs "
                    "into a host volume; plan with out='host', got "
                    f"{plan.out!r}")
            if plan.precision != "f32":
                raise ValueError(
                    "fleet execution does not support the reduced-"
                    "precision data path (the fleet's step programs are "
                    "f32-only); plan with precision='f32', got "
                    f"{plan.precision!r}")
            entries = fleet.resolve_devices()   # raises without a card
            if device is None:
                device = entries[0]
        self.device = resolve_device(device)
        if fleet is not None:
            _one_device_type(entries, self.device)
        self.geom = geom
        self.plan = plan
        self._dtype = _plan_dtype(plan)
        self.cache = cache if cache is not None else default_program_cache()
        self.pipeline = pipeline
        self.pipeline_depth = int(pipeline_depth)
        self.tuned = tuned    # TunedConfig provenance, None = heuristic
        self.fleet = fleet    # FleetConfig, None = single-device walks
        self.last_fleet_report: Optional[FleetReport] = None
        self._fleet_lock = threading.Lock()
        # summed over runs (the service snapshots these: per-run reports
        # of a bucket executor shared by workers would race)
        self.fleet_totals: Dict[str, int] = {
            "runs": 0, "devices": 0, "stolen": 0, "retried": 0,
            "dead_devices": 0}

    @classmethod
    def from_config(cls, geom: CTGeometry, config,
                    cache: Optional[ProgramCache] = None, *,
                    device=None) -> "PlanExecutor":
        """Executor for a resolved ``runtime.autotune.TunedConfig``: the
        config plans itself (pure) and carries the executor-level knobs
        (``pipeline``/``pipeline_depth``) the plan cannot."""
        return cls(geom, config.build_plan(geom), cache=cache,
                   pipeline=config.pipeline,
                   pipeline_depth=config.pipeline_depth, tuned=config,
                   device=device)

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

    def _batch_scan_program(self, variant: str, call_shape,
                            sched: StepMajorSchedule, rb: int) -> Callable:
        return self.cache.batch_scan_program(
            variant, call_shape, self.plan.nb, self._dtype,
            self.plan.interpret, self.plan.options,
            n_chunks=sched.n_chunks, chunk_size=sched.chunk_size, rb=rb)

    def _fleet_programs(self, devices, sched: StepMajorSchedule,
                        rb: Optional[int] = None) -> Dict[tuple, Callable]:
        """Every fleet step program the schedule's steps call, by
        ``(variant, call_shape)``, built before any worker starts; on a
        fleet with a card, the CUDA variants' kernels are built and loaded
        here too (``KernelSpec.load_fn``). A build failure thus raises in
        the caller's thread and is never counted as a step fault."""
        progs: Dict[tuple, Callable] = {}
        for work in sched.steps:
            key = (work.step.variant, tuple(work.step.call_shape))
            if key not in progs:
                progs[key] = (
                    self.cache.fleet_program(
                        *key, self.plan.nb, self._dtype, self.plan.interpret,
                        self.plan.options, n_chunks=sched.n_chunks,
                        chunk_size=sched.chunk_size)
                    if rb is None else self.cache.batch_fleet_program(
                        *key, self.plan.nb, self._dtype, self.plan.interpret,
                        self.plan.options, n_chunks=sched.n_chunks,
                        chunk_size=sched.chunk_size, rb=rb))
        if any(d.type == "cuda" for d in devices):
            for variant in {v for v, _ in progs}:
                load = get_spec(variant).load_fn
                if load is not None:
                    load()
        return progs

    def warm(self) -> Dict[str, int]:
        """Build every distinct program the plan needs; return stats.
        Under a fleet: the fleet step programs, and the kernels of the
        fleet's cards."""
        if self.fleet is not None:
            self._fleet_programs(self.fleet.resolve_devices(),
                                 self.plan.step_major)
        elif self.plan.schedule == "step":
            sched = self.plan.step_major
            for variant, shape in self.plan.program_keys:
                self._scan_program(variant, shape, sched)
        else:
            for variant, shape in self.plan.program_keys:
                self._program(variant, shape)
        return self.cache.stats()

    @property
    def supports_request_batching(self) -> bool:
        """Whether :meth:`execute_batch` can serve k requests with one
        launch per step and chunk: step-major plans. Chunk-major plans
        run the requests one after another in the service."""
        return self.plan.schedule == "step"

    def warm_batch(self, rb: int) -> Dict[str, int]:
        """Build the rb-lane program of every (variant, shape) so the
        first formed batch of ``rb`` requests builds nothing. A no-op for
        rb < 2 or a plan that does not batch."""
        if rb < 2 or not self.supports_request_batching:
            return self.cache.stats()
        sched = self.plan.step_major
        if self.fleet is not None:
            self._fleet_programs(self.fleet.resolve_devices(), sched, rb)
            return self.cache.stats()
        for variant, shape in self.plan.program_keys:
            self._batch_scan_program(variant, shape, sched, rb)
        return self.cache.stats()

    # ---- execute-stage helpers ------------------------------------------

    def _alloc(self):
        """A zero volume accumulator: numpy for ``out="host"``, else a
        tensor on this executor's device."""
        shape = self.plan.vol_shape_xyz
        if self.plan.out == "host":
            return np.zeros(shape, np.float32)
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    @staticmethod
    def _translated(mats: torch.Tensor, step: PlanStep) -> torch.Tensor:
        return fold_origin(mats, (step.i0, step.j0, step.k_off))

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

    def _data_step_major(self, chunks) -> StepMajorSchedule:
        """Step-major schedule over a DATA-dependent chunk list (the
        plan contributes the steps, the input contributes the extent)."""
        return build_step_major(self.plan.steps, chunks,
                                chunks[0][1] - chunks[0][0])

    def _as_input(self, name: str, x) -> torch.Tensor:
        """A float32 tensor on this executor's device: numpy arrays are
        copied there (an ``ingest`` span, whose ``path`` says how:
        :func:`_ingest_path`), tensors must already lie there."""
        if isinstance(x, np.ndarray):
            path = _ingest_path(x, self.device)
            with telemetry.span("ingest", nvtx=True) as sp:
                if sp.live:
                    sp.set(bytes=int(x.nbytes), path=path)
                if path == "pinned":
                    return _thread_stager(self.device).ingest(
                        host_float32(x))
                return tensor_from_numpy(x, self.device)
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor or numpy array, got "
                            f"{type(x).__name__}")
        check_on_device(name, x, self.device)
        return x.to(torch.float32)

    @staticmethod
    def _step_writes(step: PlanStep, out: torch.Tensor):
        """(volume slices, device piece) pairs of one step's output."""
        isl = slice(step.i0, step.i0 + step.ni)
        jsl = slice(step.j0, step.j0 + step.nj)
        return tuple(((isl, jsl, slice(w.k0, w.k0 + w.nk)),
                      out[..., w.lo:w.hi]) for w in step.writes)

    def _open_flush(self, vol) -> Optional[_AsyncFlushQueue]:
        """The async flusher when this walk pipelines host flushes
        (``pipeline="async"`` + host placement), else None."""
        if self.pipeline == "async" and self.plan.out == "host":
            return _AsyncFlushQueue(vol, self.device,
                                    depth=self.pipeline_depth)
        return None

    def _step_span(self, step: PlanStep, n_views: int, **extra):
        """Telemetry span for one step's launches (args computed only
        when tracing is live). It measures the enqueue on the host, and
        names a ``record_function`` range on the profiler's timeline."""
        sp = telemetry.span("step.dispatch", nvtx=True)
        if sp.live:
            sp.set(variant=step.variant, call_shape=list(step.call_shape),
                   n_views=int(n_views), **extra)
        return sp

    def _padded_matrices(self) -> torch.Tensor:
        """The geometry's per-view matrices on this executor's device,
        padded to the plan's ``n_proj_padded`` rows, from the
        process-wide :class:`MatrixCache` (a ``geometry.matrices`` span
        around the lookup; ``cached`` is True on a hit).

        The tensor is shared with every other caller of the same key, so
        nothing here writes into it: ``reconstruct`` and
        ``execute_batch`` slice it per chunk and ``_FilteredChunkProducer.
        stacked`` copies the slices into a new grid; the chunk-major walk
        and ``StreamingExecutor`` hand slices to ``_filtered_rows``, whose
        ``_pad_rows`` returns them or a new ``cat``; the kernels read
        them; tiled walks fold origins through ``translate_matrices``,
        which builds a new tensor."""
        with telemetry.span("geometry.matrices", nvtx=True) as sp:
            mats, hit = _MATRIX_CACHE.lookup(self.geom, self.device,
                                             self.plan.n_proj_padded)
            if sp.live:
                sp.set(n_proj=int(self.geom.n_proj), cached=hit)
            return mats

    @staticmethod
    def _flush_host(vol: Optional[np.ndarray], writes) -> None:
        for w in writes:
            tgt, sl, piece = _as_triple(vol, w)
            _add_host(tgt, sl, piece.cpu())

    def _place(self, vol, writes, flush, pending):
        """Land one step's writes (pairs into ``vol``, or the batch's
        ``(target, slices, piece)`` triples with ``vol=None``); returns
        the writes still pending.

        On the card the pieces add into the device volume in place. On
        the host they go to the async flusher, or (sync) the previous
        step's pieces are added now, after this step's launch."""
        if self.plan.out == "device":
            for w in writes:
                tgt, (i_s, j_s, k_s), piece = _as_triple(vol, w)
                tgt[i_s, j_s, k_s] += piece
            return ()
        if flush is not None:
            flush.put(writes)
            return ()
        self._flush_host(vol, pending)
        return writes

    def _backproject_chunk(self, vol, img_c: torch.Tensor,
                           mat_c: torch.Tensor,
                           flush: Optional[_AsyncFlushQueue] = None):
        """Chunk-major: accumulate ONE projection chunk, all steps.

        ``flush`` (an open :class:`_AsyncFlushQueue` spanning the whole
        chunk loop) moves the host adds onto the flusher thread in the
        sequential flush order, so the output stays bit-identical.
        """
        pending = ()
        n_views = int(img_c.shape[0])
        for step in self.plan.steps:
            prog = self._program(step.variant, step.call_shape)
            with self._step_span(step, n_views, schedule="chunk"):
                out = prog(img_c, self._translated(mat_c, step))
            pending = self._place(vol, self._step_writes(step, out), flush,
                                  pending)
        if self.plan.out == "host":
            self._flush_host(vol, pending)
        return vol

    def _execute_step_major(self, vol, img_s: torch.Tensor,
                            mat_s: torch.Tensor, sched: StepMajorSchedule):
        """Step-major: per step, ONE device-resident accumulator across
        all chunks, ONE host emission.

        ``img_s``/``mat_s`` are the stacked chunk grids ``(n_chunks,
        chunk_size, ...)``. Every voxel crosses to the host once, and
        host flushes follow ``self.pipeline``.
        """
        flush = self._open_flush(vol)
        pending = ()
        try:
            for work in sched.steps:
                step = work.step
                prog = self._scan_program(step.variant, step.call_shape,
                                          sched)
                with self._step_span(step, sched.n_scan, schedule="step"):
                    out = prog(img_s, self._translated(mat_s, step))
                pending = self._place(vol, self._step_writes(step, out),
                                      flush, pending)
        finally:
            if flush is not None:
                flush.close()
        if self.plan.out == "host":
            self._flush_host(vol, pending)
        return vol

    def _execute_step_major_batch(self, vols, img_b: torch.Tensor,
                                  mat_s: torch.Tensor,
                                  sched: StepMajorSchedule):
        """:meth:`_execute_step_major` for rb requests: per step ONE
        rb-lane program fills the step's box of every request's volume.

        ``img_b`` stacks the rb chunk grids ``(rb, n_chunks, chunk_size,
        ...)``; ``mat_s`` is shared. Each step's writes fan out to the rb
        volumes as ``(target, slices, piece)`` triples through the same
        placement as the solo walk (in place on the card; the async
        flusher or the sync double buffer on the host), so every volume
        receives its adds in the solo walk's order: bit-identical."""
        rb = len(vols)

        def fanout(step, out_b):
            return tuple((vols[r], sl, piece) for r in range(rb)
                         for sl, piece in self._step_writes(step, out_b[r]))

        flush = self._open_flush(None)
        pending = ()
        try:
            for work in sched.steps:
                step = work.step
                prog = self._batch_scan_program(step.variant,
                                                step.call_shape, sched, rb)
                with self._step_span(step, sched.n_scan, schedule="step",
                                     rb=rb):
                    out = prog(img_b, self._translated(mat_s, step))
                pending = self._place(None, fanout(step, out), flush,
                                      pending)
        finally:
            if flush is not None:
                flush.close()
        if self.plan.out == "host":
            self._flush_host(None, pending)
        return vols

    def _walk_chunks(self, chunk_inputs, n_chunks: int):
        """The chunk-major walk over ``n_chunks`` chunks of
        ``chunk_inputs(c) -> (img_c, mat_c)``: the untiled device plan
        sums the program's outputs, every other plan goes through
        :meth:`_backproject_chunk`."""
        if self._single_full_call() and self.plan.out == "device":
            step = self.plan.steps[0]
            prog = self._program(step.variant, step.call_shape)
            acc = None
            for c in range(n_chunks):
                img_c, mat_c = chunk_inputs(c)
                with self._step_span(step, int(img_c.shape[0]),
                                     schedule="chunk"):
                    part = prog(img_c, mat_c)
                acc = part if acc is None else acc.add_(part)
            return acc
        vol = self._alloc()
        flush = self._open_flush(vol)
        try:
            for c in range(n_chunks):
                vol = self._backproject_chunk(vol, *chunk_inputs(c),
                                              flush=flush)
        finally:
            if flush is not None:
                flush.close()
        return vol

    def _walk_steps(self, img_s, mat_s, sched: StepMajorSchedule):
        """The step-major walk: the untiled device plan returns its one
        program's output, every other plan goes through
        :meth:`_execute_step_major`."""
        if self._single_full_call() and self.plan.out == "device":
            step = self.plan.steps[0]
            prog = self._scan_program(step.variant, step.call_shape, sched)
            with self._step_span(step, sched.n_scan, schedule="step"):
                return prog(img_s, mat_s)
        return self._execute_step_major(self._alloc(), img_s, mat_s, sched)

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
            sched = self._data_step_major(chunks)
            img_s, mat_s = _stack_chunks(img_p, mat_p, sched)
            if self.fleet is not None:
                return self.execute_fleet(self._alloc(), img_s, mat_s, sched)
            return self._walk_steps(img_s, mat_s, sched)
        return self._walk_chunks(
            lambda c: (img_p[chunks[c][0]:chunks[c][1]],
                       mat_p[chunks[c][0]:chunks[c][1]]), len(chunks))

    def backproject_tile(self, img_t, mats, tile: TileSpec):
        """Back-project one arbitrary sub-box; exact for every variant
        (a symmetry variant on a box that is not Z-centered on the
        volume runs its slab-safe fallback). Returns vol_t of
        ``tile.shape`` on this executor's device."""
        plan = self.plan
        name = resolve_tile_variant(plan.variant, tile, plan.vol_shape_xyz[2])
        img_t = self._as_input("img_t", img_t)
        mats = self._as_input("mats", mats)
        img_p, mat_p = pad_projection_batch(img_t, mats, plan.nb)
        mat_p = translate_matrices(mat_p, float(tile.i0), float(tile.j0),
                                   float(tile.k0))
        chunks = self._chunks_for(img_p.shape[0])
        if plan.schedule == "step":
            sched = self._data_step_major(chunks)
            return self._scan_program(name, tile.shape, sched)(
                *_stack_chunks(img_p, mat_p, sched))
        prog = self._program(name, tile.shape)
        acc = None
        for s0, s1 in chunks:
            part = prog(img_p[s0:s1], mat_p[s0:s1])
            acc = part if acc is None else acc.add_(part)
        return acc

    def _chunk_inputs(self, projections: torch.Tensor, mat_p: torch.Tensor,
                      s0: int, s1: int):
        """Filter + transpose the raw rows of one padded chunk [s0, s1)."""
        raw = projections[s0:min(s1, self.plan.n_proj)]
        return self._filtered_rows(raw, mat_p[s0:s1], s1 - s0)

    def _filtered_rows(self, raw: torch.Tensor, mat_c: torch.Tensor,
                       n_rows: int):
        """Filter + transpose the raw views ``raw`` of one chunk and pad
        them to its ``n_rows`` (the one filtering path of the offline
        and the streamed walks)."""
        img_c = bp.transpose_projections(
            fdk_filter_chunk(raw, self.geom, self.plan.n_proj))
        # tail chunk: zero images pair with the repeated matrices
        return _pad_rows(img_c, mat_c, n_rows)

    def reconstruct(self, projections):
        """Filtered FDK: (np, nh, nw) raw -> (nz, ny, nx) volume.

        Pre-weighting + ramp filtering run inside the projection-chunk
        pipeline, each chunk filtered exactly once (the filtered chunks
        feed every tile step). Under the default step-major schedule the
        filtered chunk stack rides on the device; ``schedule="chunk"``
        keeps one filtered chunk resident. Returns a tensor view in
        native layout, or numpy when ``plan.out == "host"`` (a transposed
        view of the host accumulator, which may exceed the card's
        memory).
        """
        plan = self.plan
        projections = self._as_input("projections", projections)
        if projections.shape[0] != plan.n_proj:
            raise ValueError(
                f"reconstruct expects the geometry's full scan of "
                f"{plan.n_proj} projections (the FDK angular weighting "
                f"assumes it), got {projections.shape[0]}; for arbitrary "
                f"view subsets filter upstream and call backproject()")
        producer = _FilteredChunkProducer(self, projections,
                                          self._padded_matrices())
        if plan.schedule == "step":
            sched = plan.step_major
            img_s, mat_s = producer.stacked(sched)
            vol = (self.execute_fleet(self._alloc(), img_s, mat_s, sched)
                   if self.fleet is not None
                   else self._walk_steps(img_s, mat_s, sched))
        else:
            def chunk_inputs(c):
                inputs = producer.get(c)
                producer.drop(c)
                return inputs
            vol = self._walk_chunks(chunk_inputs, len(plan.chunks))
        if isinstance(vol, np.ndarray):
            return np.transpose(vol, (2, 1, 0))
        return bp.volume_to_native(vol)

    def execute_batch(self, projections_seq: Sequence):
        """Reconstruct k same-bucket requests with one launch per step and
        chunk.

        ``projections_seq`` holds k raw projection stacks, each what
        :meth:`reconstruct` takes. Each request is filtered as
        :meth:`reconstruct` filters it, into its lane of one stacked
        chunk grid ``(k, n_chunks, chunk_size, nw, nh)`` on the device;
        the matrices are shared (same bucket, same geometry). Every step
        then runs the rb-lane program (:meth:`ProgramCache.
        batch_scan_program`): one lane launch per chunk serves all k
        requests. Returns k volumes, each bit-identical to
        :meth:`reconstruct` on that request alone.

        Requires a step-major plan (``supports_request_batching``);
        k == 1 just delegates to :meth:`reconstruct`.
        """
        reqs = list(projections_seq)
        k = len(reqs)
        if k == 0:
            return []
        if k == 1:
            return [self.reconstruct(reqs[0])]
        plan = self.plan
        if not self.supports_request_batching:
            raise ValueError(
                "execute_batch serves k requests per launch of the "
                "step-major walk; plan with schedule='step', got "
                f"{plan.schedule!r} (callers check supports_request_"
                "batching and fall back to sequential reconstruct calls)")
        reqs = [self._as_input("projections", p) for p in reqs]
        for p in reqs:
            if p.shape[0] != plan.n_proj:
                raise ValueError(
                    f"execute_batch expects {plan.n_proj} projections "
                    f"per request (the plan's full scan), got "
                    f"{p.shape[0]}")
        mat_p = self._padded_matrices()
        sched = plan.step_major
        with telemetry.span("filter.stack", nvtx=True):
            img_b = torch.zeros((k, sched.n_chunks, sched.chunk_size,
                                 self.geom.nw, self.geom.nh),
                                dtype=torch.float32, device=self.device)
        for r, p in enumerate(reqs):
            _, mat_s = _FilteredChunkProducer(self, p, mat_p).stacked(
                sched, img_b[r])
        if self.fleet is not None:
            vols = self.execute_fleet([self._alloc() for _ in range(k)],
                                      img_b, mat_s, sched)
            return [np.transpose(v, (2, 1, 0)) for v in vols]
        if self._single_full_call() and plan.out == "device":
            step = plan.steps[0]
            prog = self._batch_scan_program(step.variant, step.call_shape,
                                            sched, k)
            with self._step_span(step, sched.n_scan, schedule="step", rb=k):
                acc = prog(img_b, mat_s)
            return [bp.volume_to_native(acc[r]) for r in range(k)]
        vols = self._execute_step_major_batch(
            [self._alloc() for _ in range(k)], img_b, mat_s, sched)
        if isinstance(vols[0], np.ndarray):
            return [np.transpose(v, (2, 1, 0)) for v in vols]
        return [bp.volume_to_native(v) for v in vols]

    def open_stream(self, *, max_pending_chunks: int = 2,
                    on_ready: Optional[Callable[[int], None]] = None
                    ) -> "StreamingExecutor":
        """Open an online (push-driven) reconstruction on this executor:
        views are pushed as the scanner produces them, each view chunk is
        filtered and back-projected once it is complete, and ``close()``
        returns the volume bit-identical to :meth:`reconstruct` on the
        assembled scan. Needs a chunk-major plan (``ingest="stream"``).
        See :class:`StreamingExecutor`."""
        return StreamingExecutor(self, max_pending_chunks=max_pending_chunks,
                                 on_ready=on_ready)

    # ---- the fleet ------------------------------------------------------

    def _fleet_writes(self, step: PlanStep, out: torch.Tensor, vol, vols):
        """One step's writes as ``(target, slices, host piece)`` triples:
        into ``vol``, or with ``vols`` (the rb-lane walk) lane r into
        ``vols[r]``. On a card the pieces are copied into pinned host
        buffers (PyTorch's caching host allocator reuses them step after
        step) on the worker's stream, which is then synchronized: that
        waits for this worker's kernels only."""
        writes = ([(vol, sl, piece)
                   for sl, piece in self._step_writes(step, out)]
                  if vols is None else
                  [(vols[r], sl, piece) for r in range(len(vols))
                   for sl, piece in self._step_writes(step, out[r])])
        if out.device.type != "cuda":
            return writes
        staged = []
        for tgt, sl, piece in writes:
            host = torch.empty(tuple(piece.shape), dtype=piece.dtype,
                               pin_memory=True)
            host.copy_(piece, non_blocking=True)
            staged.append((tgt, sl, host))
        torch.cuda.current_stream(out.device).synchronize()
        return staged

    def execute_fleet(self, vol, img_s: torch.Tensor, mat_s: torch.Tensor,
                      sched: StepMajorSchedule, *,
                      fleet: Optional[FleetConfig] = None):
        """Shard a step-major schedule across a fleet of devices.

        The steps start on per-entry queues (``runtime.planner.
        partition_steps``: LPT-balanced on modeled voxel work). One
        dispatcher thread per entry (``recon-fleet-{d}``) enters the
        entry's device and, on a card, a stream of its own, and drains its
        queue through the origin-taking step program
        (:meth:`ProgramCache.fleet_program`, built with every kernel
        before the threads start). The filtered chunk grid is copied once
        to each distinct device that takes work (:class:`_Replicas`). Each
        step's output crosses to the host and lands in its disjoint boxes
        of the zeroed host volume under one lock, so the order in which
        steps complete changes nothing: the result equals the
        single-device step-major walk bit for bit.

        **Work stealing**: an idle entry first drains the fleet retry
        queue, then steals from the tail of another entry's queue,
        preferring entries the :class:`FleetStragglerBoard` has flagged as
        slow, then the longest backlog.

        **Failover**: a failed step is requeued fleet-wide and re-run by
        whichever entry takes it, with the same kernel on a device the
        caller named (never on the CPU, never through a plain version):
        the step's writes were never flushed, so re-running it is
        idempotent. Failures are budgeted PER STEP INDEX
        (``max_retries_per_step``, the FaultTolerantLoop contract); past
        it the run raises a ``RuntimeError`` chained to the step's error
        (a poison step would leave a hole in the volume). An entry that
        reaches ``device_strikes`` failures is retired and its queue
        drains to the survivors; losing every entry raises. A sticky CUDA
        error (an illegal address) poisons the card's context: every retry
        on that card fails too, and the run ends as a poison step with
        the CUDA error chained. Nothing tries to recover from that.

        ``vol`` may be a LIST of rb host volumes (the batched path):
        ``img_s`` then carries a leading request axis, each step is one
        rb-lane program (:meth:`ProgramCache.batch_fleet_program`), and
        its output fans out to every lane's boxes.
        """
        cfg = fleet if fleet is not None else (self.fleet or FleetConfig())
        vols = list(vol) if isinstance(vol, (list, tuple)) else None
        rb = len(vols) if vols is not None else None
        devices = _one_device_type(cfg.resolve_devices(), img_s.device)
        n_dev = len(devices)
        steps = tuple(w.step for w in sched.steps)
        n_steps = len(steps)
        if n_steps == 0:
            self._record_fleet(FleetReport(n_dev, 0, (0,) * n_dev,
                                           0, 0, (), ()))
            return vol
        progs = self._fleet_programs(devices, sched, rb)
        fs = partition_steps(steps, n_dev)
        board = FleetStragglerBoard(n_dev, window=cfg.straggler_window,
                                    ratio=cfg.straggler_ratio)
        replicas = _Replicas(img_s, mat_s)

        cond = threading.Condition()
        deques = [collections.deque(q) for q in fs.queues]
        retry: collections.deque = collections.deque()
        counts = {"outstanding": 0, "stolen": 0, "retried": 0, "done": 0}
        failures: collections.Counter = collections.Counter()  # per index
        strikes: collections.Counter = collections.Counter()   # per entry
        dead: set = set()
        done_by_device = [0] * n_dev
        fatal: list = []                 # [(step index, exception)]
        broken: list = []                # a worker's own fault (the flush)
        flush_lock = threading.Lock()
        streams: list = []

        def take(d: int):
            """Next step index for entry ``d`` (call under ``cond``): own
            queue in schedule order, then the fleet retry queue, then
            steal from the tail of the neediest victim: flagged
            (straggling) entries first, longest backlog next."""
            if deques[d]:
                return deques[d].popleft()
            if retry:
                return retry.popleft()
            flagged = set(board.flagged)
            victims = [v for v in range(n_dev) if v != d and deques[v]]
            if not victims:
                return None
            victims.sort(key=lambda v: (v not in flagged,
                                        -len(deques[v]), v))
            counts["stolen"] += 1
            telemetry.instant("fleet.steal", thief=d, victim=victims[0])
            return deques[victims[0]].pop()

        def run(d: int, dev: torch.device) -> None:
            while True:
                with cond:
                    while True:
                        if fatal or broken or d in dead:
                            return
                        idx = take(d)
                        if idx is not None:
                            counts["outstanding"] += 1
                            break
                        if counts["outstanding"] == 0 and not retry \
                                and not any(deques):
                            return      # fleet drained
                        cond.wait(0.05)
                step = steps[idx]
                t0 = time.perf_counter()
                try:
                    if cfg.step_hook is not None:
                        cfg.step_hook(d, idx)
                    img_d, mat_d = replicas.get(dev)
                    prog = progs[(step.variant, tuple(step.call_shape))]
                    with self._step_span(step, sched.n_scan,
                                         schedule="fleet", device=d,
                                         step_index=idx):
                        out = prog(img_d, mat_d,
                                   (step.i0, step.j0, step.k_off))
                    writes = self._fleet_writes(step, out, vol, vols)
                except Exception as exc:  # noqa: BLE001 — any step fault
                    with cond:
                        counts["outstanding"] -= 1
                        failures[idx] += 1
                        strikes[d] += 1
                        if failures[idx] > cfg.max_retries_per_step:
                            fatal.append((idx, exc))
                        else:
                            retry.append(idx)
                            counts["retried"] += 1
                            telemetry.instant("fleet.failover", device=d,
                                              step_index=idx,
                                              retries=failures[idx])
                        if strikes[d] >= cfg.device_strikes:
                            dead.add(d)
                            telemetry.instant("fleet.retire", device=d,
                                              strikes=strikes[d])
                        cond.notify_all()
                    continue
                dur = time.perf_counter() - t0
                # disjoint boxes of a zeroed volume: the order of the
                # steps' adds changes no bit
                with flush_lock:
                    for tgt, sl, host in writes:
                        _add_host(tgt, sl, host)
                board.record(d, idx, dur)
                with cond:
                    counts["outstanding"] -= 1
                    done_by_device[d] += 1
                    counts["done"] += 1
                    cond.notify_all()

        def worker(d: int) -> None:
            dev = devices[d]
            with device_scope(dev):
                ctx, stream = _worker_stream(dev)
                if stream is not None:
                    with flush_lock:
                        streams.append(stream)
                with ctx:
                    try:
                        run(d, dev)
                    except BaseException as exc:  # the others stop too
                        with cond:
                            broken.append(exc)
                            cond.notify_all()

        threads = [threading.Thread(target=worker, args=(d,),
                                    name=f"recon-fleet-{d}", daemon=True)
                   for d in range(n_dev)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if broken:
            raise broken[0]
        if fatal:
            idx, exc = fatal[0]
            raise RuntimeError(
                f"fleet step {idx} failed more than "
                f"max_retries_per_step={cfg.max_retries_per_step} times "
                f"across devices — poison step, volume would be "
                f"incomplete") from exc
        if counts["done"] < n_steps:
            raise RuntimeError(
                f"fleet lost all devices with {n_steps - counts['done']} "
                f"of {n_steps} steps unfinished "
                f"(retired devices: {sorted(dead)})")
        for stream in streams:
            # a retried step's launches may outlive its failure: nothing
            # may still read the grid when the caller frees it
            stream.synchronize()
        self._record_fleet(FleetReport(
            n_devices=n_dev, n_steps=n_steps,
            steps_by_device=tuple(done_by_device),
            stolen=counts["stolen"], retried=counts["retried"],
            dead_devices=tuple(sorted(dead)),
            flagged_devices=board.flagged))
        return vol

    def _record_fleet(self, report: FleetReport) -> None:
        with self._fleet_lock:
            self.last_fleet_report = report
            t = self.fleet_totals
            t["runs"] += 1
            t["devices"] = report.n_devices
            t["stolen"] += report.stolen
            t["retried"] += report.retried
            t["dead_devices"] += len(report.dead_devices)

    # ---- cluster composition (iFDK scale-out x tiles) --------------------

    def execute_distributed(self, img_t, mats, mesh, *,
                            dist_variant: str = "scan") -> np.ndarray:
        """Compose (i, j)-tiles with the pod/data/model mesh.

        Each full-Z tile is reconstructed by the mesh program of
        ``core.distributed.make_distributed_bp`` with the tile origin as
        a call-time argument: ONE program per distinct tile shape, kept
        in the shared ProgramCache, so interior tiles and repeated calls
        build nothing. Projections go through in exactly-nb batches of
        the padded view count. ``pipeline="async"`` hands each tile's
        slab to the :class:`_AsyncFlushQueue` (its copy on a side stream
        on a card) while the next tile's programs run; tiles write
        disjoint boxes of the zeroed host volume, so the flusher's add
        equals the sequential assignment bit for bit.
        Returns vol_t (nx, ny, nz) on the host.
        """
        from repro_torch.core.distributed import (_mesh_input,
                                                  make_distributed_bp)

        plan = self.plan
        nb = plan.nb
        home = mesh.devices[0]
        img_p, mat_p = pad_projection_batch(_mesh_input(img_t, home),
                                            _mesh_input(mats, home), nb)
        _, _, chunks = plan_proj_chunks(img_p.shape[0], nb, nb)
        nx, ny, nz = plan.vol_shape_xyz
        ti, tj, _ = plan.tile_shape
        vol = np.zeros((nx, ny, nz), np.float32)
        flush = (_AsyncFlushQueue(vol, home, depth=self.pipeline_depth)
                 if self.pipeline == "async" else None)
        try:
            for tile in make_tiles((nx, ny, nz), (ti, tj, nz)):
                # geom and mesh are hashable: equal setups share a program
                key = ("dist", dist_variant, tile.shape, nb, self.geom,
                       mesh)
                prog = self.cache.get_or_build(
                    key, lambda shape=tile.shape: make_distributed_bp(
                        self.geom, mesh, nb=nb, variant=dist_variant,
                        vol_shape_xyz=shape)[0])
                origin = (float(tile.i0), float(tile.j0))
                acc = None
                for s0, s1 in chunks:
                    part = prog(img_p[s0:s1], mat_p[s0:s1], origin)
                    acc = part if acc is None else acc + part
                piece = acc[:tile.ni, :tile.nj]
                if flush is not None:
                    flush.put(((tile.slices, piece),))
                else:
                    vol[tile.slices] = piece.cpu().numpy()
        finally:
            if flush is not None:
                flush.close()
        return vol


# --------------------------------------------------------------------------
# Online (streaming) execution: fold view chunks as they arrive
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StreamReport(telemetry.EmitMixin):
    """What one closed stream did, in overlap terms.

    ``acquire_s`` is the wall from the first view's arrival to the last
    one's (the scanner's rotation), ``compute_s`` the summed fold and
    finish wall, and ``tail_s`` the wall from the LAST view's arrival to
    the finished volume: what streaming adds to acquisition.
    ``hidden_fraction`` is the share of compute that ran during
    acquisition instead of after it.
    """

    n_views: int
    n_chunks: int
    acquire_s: float
    compute_s: float
    tail_s: float

    @property
    def hidden_fraction(self) -> float:
        if self.compute_s <= 0.0:
            return 1.0
        return max(0.0, min(1.0, 1.0 - self.tail_s / self.compute_s))


class StreamingExecutor:
    """Online reconstruction: push projections as they arrive, fold each
    view chunk the moment it is complete.

    The arrival contract:

      * ``push(views, start=None)`` takes one or more raw views (numpy or
        a CPU tensor), by default the next rows in order; an explicit
        ``start`` allows ANY arrival order within a chunk (each view
        lands in its chunk's host buffer by row). Each view arrives
        exactly once.
      * Chunk ``c`` is *ready* once all its raw rows are present. Ready
        chunks fold strictly in chunk order, the order of the offline
        chunk-major walk (``PlanExecutor._walk_chunks``): per step the
        device-side running sum ``((p0 + p1) + p2)...`` over the chunk
        parts is the same left-associated float32 sum, each chunk is
        filtered by the offline walk's own ``_filtered_rows``, and the
        final placement adds each step's sum into a zero volume, so
        ``close()`` is bit-identical to ``reconstruct`` on the scan.
      * At most ``max_pending_chunks`` ready, unfolded chunks may exist:
        a producer faster than the folds blocks in ``push`` (bounded
        buffering). ``max_pending_seen`` is the high-water mark.
      * ``close()`` needs every view; it waits for the last fold and
        the placement and returns the volume; ``report`` then holds the
        overlap metrics.

    A ready chunk's host buffer (pinned on a card) is copied to the
    device with ``non_blocking``, filtered there and folded. Two drive
    modes: by default a folder thread of this executor folds ready
    chunks (it enters the executor's device); with ``on_ready=`` each
    ready chunk is reported to the callback instead and an external
    driver (the service's stream worker, which folds the same chunk of
    several sessions in one lane launch) calls ``filtered`` /
    ``accept_part`` / ``chunk_done`` itself. An error in a fold poisons
    the stream: ``push`` and ``close`` raise it.
    """

    def __init__(self, ex: PlanExecutor, *, max_pending_chunks: int = 2,
                 on_ready: Optional[Callable[[int], None]] = None):
        plan = ex.plan
        if plan.schedule != "chunk":
            raise ValueError(
                "streaming folds view chunks as they arrive (chunk-major "
                "by construction); plan with ingest='stream' (or "
                f"schedule='chunk'), got schedule={plan.schedule!r}")
        if max_pending_chunks < 1:
            raise ValueError(
                f"max_pending_chunks must be >= 1, got {max_pending_chunks}")
        self._ex = ex
        self.geom = ex.geom
        self._plan = plan
        self._chunk_bounds = plan.chunks
        self._n_chunks = len(self._chunk_bounds)
        self._n_views = plan.n_proj
        self._chunk_size = plan.chunk_size
        self._max_pending = int(max_pending_chunks)
        self._on_ready = on_ready
        self._mat_p = ex._padded_matrices()

        self._cond = threading.Condition()
        self._buffers: Dict[int, torch.Tensor] = {}
        self._missing = {c: self._raw_rows(c) for c in range(self._n_chunks)}
        self._seen = np.zeros(self._n_views, bool)
        self._filtered_memo: Dict[int, tuple] = {}
        self._complete: set = set()
        self._accs: list = [None] * len(plan.steps)
        self._next_fold = 0
        self._next_row = 0
        self._rows = 0
        self._ingest_closed = False
        self._error: Optional[BaseException] = None
        self._result = None
        self._finished = threading.Event()
        self.max_pending_seen = 0

        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._t_done: Optional[float] = None
        self._busy = 0.0

        self._thread: Optional[threading.Thread] = None
        if on_ready is None:
            self._thread = threading.Thread(
                target=self._drive, name="recon-stream-fold", daemon=True)
            self._thread.start()

    # ---- ingest side ------------------------------------------------------

    def _raw_rows(self, c: int) -> int:
        """Raw (un-padded) views chunk ``c`` must receive."""
        s0, s1 = self._chunk_bounds[c]
        return min(s1, self._n_views) - s0

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            raise self._error

    def _host_buffer(self, c: int) -> torch.Tensor:
        """Chunk ``c``'s host buffer: pinned where the device is a card,
        so its copy there runs without a staging copy."""
        shape = (self._raw_rows(c), self.geom.nh, self.geom.nw)
        return torch.zeros(shape, dtype=torch.float32,
                           pin_memory=self._ex.device.type == "cuda")

    def push(self, views, start: Optional[int] = None) -> None:
        """Deliver view rows ``[start, start + k)`` (default: the next
        rows in order). Blocks only for backpressure, when
        ``max_pending_chunks`` ready chunks are already waiting."""
        if isinstance(views, torch.Tensor):
            views = views.detach().cpu().numpy()
        views = np.asarray(views, np.float32)
        if views.ndim == 2:
            views = views[None]
        if views.ndim != 3 or views.shape[1:] != (self.geom.nh,
                                                  self.geom.nw):
            raise ValueError(
                f"push expects (k, nh, nw) or (nh, nw) views of detector "
                f"shape ({self.geom.nh}, {self.geom.nw}), got "
                f"{tuple(views.shape)}")
        k = views.shape[0]
        with self._cond:
            self._raise_if_failed()
            if self._ingest_closed:
                raise RuntimeError("push() after close()")
            first = self._next_row if start is None else int(start)
            if first < 0 or first + k > self._n_views:
                raise ValueError(
                    f"views [{first}, {first + k}) outside the stream's "
                    f"[0, {self._n_views}) scan")
            if self._t_first is None:
                self._t_first = time.perf_counter()
            for off in range(k):
                r = first + off
                if self._seen[r]:
                    raise ValueError(f"view {r} pushed twice")
                c = r // self._chunk_size
                s0, _ = self._chunk_bounds[c]
                buf = self._buffers.get(c)
                if buf is None:
                    buf = self._buffers[c] = self._host_buffer(c)
                buf.numpy()[r - s0] = views[off]
                self._seen[r] = True
                self._rows += 1
                self._missing[c] -= 1
                if self._missing[c] == 0:
                    self._admit_ready(c)
            self._next_row = max(self._next_row, first + k)
            self._t_last = time.perf_counter()
            telemetry.instant("stream.push", first=first, k=k,
                              rows=self._rows)
            self._cond.notify_all()

    def _admit_ready(self, c: int) -> None:
        """Mark chunk ``c`` ready (under ``_cond``): backpressure first,
        then hand it to the folder (thread or ``on_ready`` callback)."""
        while (len(self._complete) >= self._max_pending
               and self._error is None):
            self._cond.wait(0.05)
        self._raise_if_failed()
        self._complete.add(c)
        self.max_pending_seen = max(self.max_pending_seen,
                                    len(self._complete))
        self._cond.notify_all()
        if self._on_ready is not None:
            # deliver OUTSIDE the lock: the callback may take locks of
            # its own (the service's former)
            self._cond.release()
            try:
                self._on_ready(c)
            finally:
                self._cond.acquire()

    def close(self):
        """Finish the stream: needs every view delivered; waits for the
        remaining folds and the placement, returns the volume."""
        with self._cond:
            if self._ingest_closed:
                raise RuntimeError("stream already closed")
            self._ingest_closed = True
            if self._error is None and self._rows < self._n_views:
                self._error = RuntimeError(
                    f"stream closed after {self._rows} of "
                    f"{self._n_views} views: every view must be pushed "
                    f"before close()")
                self._finished.set()
            self._cond.notify_all()
        self._finished.wait()
        if self._thread is not None:
            # the folder finishes inside its stream.fold / stream.tail
            # spans: let it leave them before the caller reads the trace
            self._thread.join()
        with self._cond:
            self._raise_if_failed()
            return self._result

    def fail(self, exc: BaseException) -> None:
        """Poison the stream (external drivers report fold errors here);
        ``push``/``close`` re-raise it."""
        with self._cond:
            if self._error is None:
                self._error = exc
            self._finished.set()
            self._cond.notify_all()

    # ---- fold side (the folder thread, or the service's stream worker) ----

    @property
    def next_fold(self) -> int:
        """Index of the next chunk that must fold (the order contract)."""
        with self._cond:
            return self._next_fold

    def _filter_pair(self, buf: torch.Tensor, c: int):
        """Copy one ready chunk to the device, filter and transpose it:
        ``PlanExecutor._filtered_rows``, the offline walk's own path."""
        s0, s1 = self._chunk_bounds[c]
        with telemetry.span("ingest", nvtx=True) as sp:
            if sp.live:
                sp.set(bytes=int(buf.nelement() * buf.element_size()),
                       path=("pinned" if self._ex.device.type == "cuda"
                             else "pageable"))   # see _host_buffer
            raw = buf.to(self._ex.device, non_blocking=True)
        with telemetry.span("filter.chunk", nvtx=True) as sp:
            if sp.live:
                sp.set(chunk=c, n_views=int(s1 - s0))
            return self._ex._filtered_rows(raw, self._mat_p[s0:s1], s1 - s0)

    def filtered(self, c: int):
        """Filtered ``(img_c, mat_c)`` of ready chunk ``c``."""
        with self._cond:
            pair = self._filtered_memo.pop(c, None)
            if pair is not None:
                return pair
            if c not in self._complete:
                raise RuntimeError(f"chunk {c} is not ready")
            buf = self._buffers[c]
        return self._filter_pair(buf, c)

    def prefilter(self, c: int) -> None:
        """Filter chunk ``c`` now if it is ready (its kernels queue behind
        the current fold's on the device)."""
        with self._cond:
            if (c >= self._n_chunks or c in self._filtered_memo
                    or c not in self._complete):
                return
            buf = self._buffers[c]
        pair = self._filter_pair(buf, c)
        with self._cond:
            self._filtered_memo.setdefault(c, pair)

    def accept_part(self, i: int, part: torch.Tensor) -> None:
        """Fold one kernel output into step ``i``'s device accumulator
        (in place: the running sum in chunk order)."""
        acc = self._accs[i]
        self._accs[i] = part if acc is None else acc.add_(part)

    def sync(self) -> None:
        """Wait for the kernels this thread queued on the card: a fold is
        done, and its wall counted, when its kernels are."""
        if self._ex.device.type == "cuda":
            torch.cuda.current_stream(self._ex.device).synchronize()

    def add_busy(self, seconds: float) -> None:
        with self._cond:
            self._busy += max(0.0, seconds)

    def fold(self, c: int) -> None:
        """Fold ready chunk ``c`` into every step accumulator (one lane;
        the service's lane path drives ``filtered`` / ``accept_part`` /
        ``chunk_done`` itself)."""
        t0 = time.perf_counter()
        with telemetry.span("stream.fold", chunk=c):
            img_c, mat_c = self.filtered(c)
            self.prefilter(c + 1)
            ex = self._ex
            for i, step in enumerate(self._plan.steps):
                prog = ex._program(step.variant, step.call_shape)
                with ex._step_span(step, int(img_c.shape[0]),
                                   schedule="stream"):
                    part = prog(img_c, ex._translated(mat_c, step))
                self.accept_part(i, part)
            self.sync()
            self.add_busy(time.perf_counter() - t0)
            self.chunk_done(c)

    def chunk_done(self, c: int) -> None:
        """Retire folded chunk ``c``; the LAST chunk triggers the
        placement of the step accumulators into the volume."""
        with self._cond:
            if c != self._next_fold:
                raise RuntimeError(
                    f"chunk {c} folded out of order (expected "
                    f"{self._next_fold}): the chunk-order fold is the "
                    f"exactness contract")
            self._complete.discard(c)
            self._buffers.pop(c, None)
            self._next_fold = c + 1
            finish = self._next_fold == self._n_chunks
            self._cond.notify_all()
        if finish:
            with telemetry.span("stream.tail", n_chunks=self._n_chunks):
                self._finish()

    def _finish(self) -> None:
        """Place every step accumulator into a zero volume, as the
        offline chunk-major walk places its pieces (in place on the
        card; on the host through the executor's flush). Its wall counts
        as compute."""
        t0 = time.perf_counter()
        ex = self._ex
        plan = self._plan
        if plan.out == "device":
            if ex._single_full_call():
                vol_t = self._accs[0]
            else:
                vol_t = ex._alloc()
                for step, acc in zip(plan.steps, self._accs):
                    ex._place(vol_t, ex._step_writes(step, acc), None, ())
            result = bp.volume_to_native(vol_t)
        else:
            vol = ex._alloc()
            flush = ex._open_flush(vol)
            try:
                for step, acc in zip(plan.steps, self._accs):
                    writes = ex._step_writes(step, acc)
                    if flush is not None:
                        flush.put(writes)
                    else:
                        ex._flush_host(vol, writes)
            finally:
                if flush is not None:
                    flush.close()
            result = np.transpose(vol, (2, 1, 0))
        self.sync()
        with self._cond:
            self._accs = [None] * len(plan.steps)
            self._result = result
            self._t_done = time.perf_counter()
            self._busy += self._t_done - t0
            self._finished.set()
            self._cond.notify_all()

    def _drive(self) -> None:
        """The folder thread: fold ready chunks in index order."""
        try:
            with device_scope(self._ex.device):
                for c in range(self._n_chunks):
                    with self._cond:
                        while c not in self._complete and \
                                self._error is None:
                            self._cond.wait(0.1)
                        if self._error is not None:
                            return
                    self.fold(c)
        except Exception as exc:  # surfaced at push()/close()
            self.fail(exc)

    # ---- introspection ----------------------------------------------------

    @property
    def report(self) -> Optional[StreamReport]:
        """Overlap metrics once the stream finished, else None."""
        with self._cond:
            if self._t_done is None:
                return None
            t_first = self._t_first if self._t_first is not None else 0.0
            t_last = (self._t_last if self._t_last is not None
                      else self._t_done)
            return StreamReport(
                n_views=self._n_views, n_chunks=self._n_chunks,
                acquire_s=max(0.0, t_last - t_first),
                compute_s=self._busy,
                tail_s=max(0.0, self._t_done - t_last))
