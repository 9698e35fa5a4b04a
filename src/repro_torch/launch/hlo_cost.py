"""Cost analysis of an eager step: FLOPs, bytes and collectives.

The JAX package's module of this name walks compiled HLO and multiplies
every ``while`` body by its trip count (``compiled.cost_analysis()``
counts a scanned layer stack once). PyTorch has no HLO: the port counts
the aten ops a step dispatches, with :class:`OpCounter` (a
``TorchDispatchMode``, which also runs on ``meta`` tensors, so a dry run
costs a full-width step without storage). Eager execution runs every
iteration of every loop, so the log counts them directly and there is no
trip count to find.

The model (the reference's, applied to aten ops; ``analyze``):
  * flops: 2 * prod(result) * prod(contracted) for mm, bmm, addmm,
    baddbmm, mv and dot (and convolution); 1 an element of the result for
    elementwise arithmetic; for transcendentals 1 an element, also
    counted under ``trans`` (the reference's sets); a reduction 1 an
    element of its input;
  * bytes: operands plus results of every op that is not a view (nor an
    allocation without data, ``empty``). Eager PyTorch fuses nothing, so
    this is an upper bound on the reference's fused-boundary traffic;
  * collectives: the result bytes, per kind, of the in-process mesh's
    collectives (``launch.sharding.COLLECTIVES``), whose own copies are
    left out of flops and bytes.

The counter also tracks memory: every storage an op allocates stays live
until PyTorch frees it (a finalizer on the storage), charged to the
mesh entry the op ran for (``sharding.on_entry``); ``peak_bytes`` is the
largest entry's peak of live bytes.
"""

from __future__ import annotations

import collections
import math
import weakref
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.launch import sharding as shd

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}
_TORCH_DTYPES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
    torch.int16: "s16", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}

# the reference's sets, by aten name (in-place forms share them)
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "where",
    "bitwise_and", "bitwise_or", "bitwise_xor", "logical_and",
    "logical_or", "logical_xor", "logical_not", "bitwise_not", "neg",
    "abs", "floor", "ceil", "round", "clamp", "clamp_min", "clamp_max",
    "eq", "ne", "lt", "le", "gt", "ge", "sign", "remainder", "fmod",
}
_TRANSCENDENTAL = {"exp", "log", "tanh", "rsqrt", "sqrt", "pow", "cos",
                   "sin", "sigmoid", "expm1", "log1p", "atan2", "erf",
                   "cbrt", "exp2", "log2", "reciprocal"}
# composite activations: a transcendental and an arithmetic op an element
_ACTIVATIONS = {"silu", "gelu", "softplus", "_softmax", "_log_softmax",
                "logsumexp"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "var",
           "std", "argmax", "argmin", "cumsum", "any", "all", "norm",
           "linalg_vector_norm", "var_mean"}
_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "dot",
           "addmv"}
# the matrix operand whose last dim is contracted, by op
_LHS = {"mm": 0, "bmm": 0, "mv": 0, "dot": 0, "addmm": 1, "baddbmm": 1,
        "addbmm": 1, "addmv": 1}
# ops that allocate without touching data, or only reinterpret it
_NO_DATA = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "_unsafe_view", "lift_fresh", "detach",
            "alias", "_local_scalar_dense", "sym_size", "sym_stride",
            "sym_numel", "is_same_size", "resize_"}

COLLECTIVE_KINDS = shd.COLLECTIVE_KINDS


def _spec(t: torch.Tensor) -> tuple:
    return (tuple(t.shape), _TORCH_DTYPES.get(t.dtype, "f32"))


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in rets)


def _base_name(name: str) -> str:
    """``aten.add_.Tensor`` -> ``add``."""
    op = name.split(".")[1] if name.startswith("aten.") else name
    return op[:-1] if op.endswith("_") and not op.startswith("_") else op


class OpCounter(TorchDispatchMode):
    """Logs every aten op dispatched inside it, by (name, operand and
    result shapes and dtypes), with counts; tracks the live bytes of the
    storages the ops allocate, by mesh entry. Ops inside a collective of
    the in-process mesh are not logged (their result bytes are the
    collective's); the collectives' counters are read on exit.
    """

    def __init__(self):
        super().__init__()
        self.ops: Dict[tuple, int] = collections.Counter()
        self.n_ops = 0
        self._live: Dict[int, weakref.finalize] = {}
        self._live_bytes: Dict[int, int] = collections.defaultdict(int)
        self.peak: Dict[int, int] = collections.defaultdict(int)
        self._coll0 = None
        self.coll = None

    def __enter__(self):
        self._coll0 = shd.collective_snapshot()
        return super().__enter__()

    def __exit__(self, *exc):
        for fin in list(self._live.values()):
            fin.detach()          # storages that outlive the count
        self._live.clear()
        now = shd.collective_snapshot()
        self.coll = {part: {k: now[part][k] - self._coll0[part][k]
                            for k in COLLECTIVE_KINDS}
                     for part in ("bytes", "counts")}
        return super().__exit__(*exc)

    def _freed(self, key: int, nbytes: int, entry: int) -> None:
        self._live.pop(key, None)
        self._live_bytes[entry] -= nbytes

    def _track(self, outs, inputs) -> None:
        entry = shd.CONTEXT.entry or 0
        ins = {t.untyped_storage()._cdata for t in inputs}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in ins or key in self._live:
                continue       # an input's storage, or one tracked already
            nbytes = st.nbytes()
            # a storage's Python object lives as long as the storage does
            # (PyTorch preserves it), so the finalizer runs when PyTorch
            # frees the storage, autograd's saved tensors included
            self._live[key] = weakref.finalize(st, self._freed, key, nbytes,
                                               entry)
            self._live_bytes[entry] += nbytes
        if self._live_bytes[entry] > self.peak[entry]:
            self.peak[entry] = self._live_bytes[entry]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if shd.CONTEXT.collective:
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        view = _is_view(func)
        key = (str(func), tuple(_spec(t) for t in ins),
               tuple(_spec(t) for t in outs), view)
        self.ops[key] += 1
        self.n_ops += 1
        if not view:
            self._track(outs, ins)
        return out

    def peak_bytes(self) -> int:
        """The largest entry's peak of live allocated bytes."""
        return max(self.peak.values(), default=0)

    def log(self) -> dict:
        """The op log: JSON-ready, what :func:`analyze` reads."""
        return {"ops": [[name, [[list(sh), dt] for sh, dt in ins],
                         [[list(sh), dt] for sh, dt in outs], view, n]
                        for (name, ins, outs, view), n in self.ops.items()],
                "coll": self.coll or {
                    "bytes": {k: 0 for k in COLLECTIVE_KINDS},
                    "counts": {k: 0 for k in COLLECTIVE_KINDS}},
                "n_ops": self.n_ops}


def _elems_bytes(specs) -> Tuple[int, int]:
    elems = nbytes = 0
    for shape, dt in specs:
        n = math.prod(shape)
        elems += n
        nbytes += n * _DTYPE_BYTES.get(dt, 4)
    return elems, nbytes


def op_flops(name: str, ins, outs) -> Tuple[float, float]:
    """(flops, transcendentals) of one op, from its operand and result
    (shape, dtype) specs."""
    base = _base_name(name)
    out_elems = _elems_bytes(outs[:1])[0] if outs else 0
    if base in _MATMUL:
        lhs = ins[_LHS[base]][0]
        return 2.0 * out_elems * (lhs[-1] if lhs else 1), 0.0
    if base == "convolution":
        w = ins[1][0]
        return 2.0 * out_elems * math.prod(w[1:]), 0.0
    if base in _ELEMENTWISE:
        return float(out_elems), 0.0
    if base in _TRANSCENDENTAL:
        return float(out_elems), float(out_elems)
    if base in _ACTIVATIONS:
        return 2.0 * out_elems, float(out_elems)
    if base in _REDUCE and ins:
        return float(_elems_bytes(ins[:1])[0]), 0.0
    return 0.0, 0.0


def op_bytes(name: str, ins, outs, view: bool) -> float:
    """Operands plus results of an op that moves data (not a view)."""
    if view or _base_name(name) in _NO_DATA:
        return 0.0
    return float(_elems_bytes(ins)[1] + _elems_bytes(outs)[1])


def parse_computations(log: dict) -> Dict[str, List[dict]]:
    """The op log as the reference's computations: an eager step is one
    computation, ``"step"``, whose records are the logged ops (name,
    operands, results, view, count)."""
    return {"step": [{"opcode": name, "operands": ins, "results": outs,
                      "view": view, "count": n}
                     for name, ins, outs, view, n in log["ops"]]}


def analyze(log: dict) -> dict:
    """Totals of an op log: flops, trans, bytes, coll (result bytes by
    kind), coll_counts, total_collective_bytes (the reference's keys)."""
    tot = {"flops": 0.0, "trans": 0.0, "bytes": 0.0}
    for op in parse_computations(log)["step"]:
        f, tr = op_flops(op["opcode"], op["operands"], op["results"])
        n = op["count"]
        tot["flops"] += n * f
        tot["trans"] += n * tr
        tot["bytes"] += n * op_bytes(op["opcode"], op["operands"],
                                     op["results"], op["view"])
    coll = log["coll"]
    tot["coll"] = {k: float(coll["bytes"][k]) for k in COLLECTIVE_KINDS}
    tot["coll_counts"] = {k: float(coll["counts"][k])
                          for k in COLLECTIVE_KINDS}
    tot["total_collective_bytes"] = sum(tot["coll"].values())
    return tot
