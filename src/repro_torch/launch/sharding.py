"""Sharding rules and the in-process mesh's sharded tensors.

The rules are the JAX package's: parameter name -> partition spec,
divisibility-guarded. 2-D weight sharding: tensor parallel over "model"
on the contraction-exposed axis, FSDP over "data" on the other. Experts
are expert parallel over "model" (the ``"expert"`` pseudo-axis). The
"pod" axis never appears in a weight spec. Every candidate axis is
checked against the dim it would split and dropped (replicated) where it
does not divide, so every (arch x mesh) pair has a layout.

The port names a parameter ``layers.{i}.attn.wq`` and keeps one tensor a
layer where the reference stacks the layers on a leading axis
(``convert.STACKED``): a rule matches the reference's path of the name
(the layer index dropped, ``/`` between the parts), and a port spec is
the reference's spec without its leading stack entries. The MoE experts'
leading ``E`` axis stays on one tensor on both sides.

A spec is a :class:`P` (one entry a dim: ``None``, an axis name or a
tuple of names) and a :class:`NamedSharding` ties it to a
``launch.mesh.Mesh``. A :class:`ShardedTensor` is a tensor laid out on a
mesh: every entry of the mesh holds exactly its block, on its own device
(an entry may repeat a device, as in the fleet and the mesh of
back-projection; entries on one device still hold a block each). The
mesh's collectives are calls of this thread: :meth:`ShardedTensor.full`
and :meth:`ShardedTensor.gather_into` (all-gather),
:func:`reduce_scatter_add` (reduce-scatter) and
``optim.grad.compressed_psum`` (all-reduce). Each adds its result bytes
to :data:`COLLECTIVES`, which ``launch.hlo_cost`` reads.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import re
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.convert import STACKED

# (regex on the reference's path of the name, spec template applied to
# the tensor's dims). The JAX package's table, unchanged.
_MATRIX_RULES = [
    # --- embeddings / unembedding ----------------------------------------
    (r"(^|/)embed$",               ("model", "data")),    # (V, d)
    (r"(^|/)unembed$",             ("data", "model")),    # (d, V)
    # --- MoE (leading E dim handled structurally) -------------------------
    (r"/moe/router$",              ("data", None)),       # (d, E)
    (r"/moe/wi_(gate|up)$",        ("expert", "data", None)),  # (E,d,ff)
    (r"/moe/wo$",                  ("expert", None, "data")),  # (E,ff,d)
    (r"/moe/shared/wi_(gate|up)$", (None, "data", "model")),
    (r"/moe/shared/wo$",           (None, "model", "data")),
    # --- MLA ---------------------------------------------------------------
    (r"/attn/w_dkv$",              ("data", None)),
    (r"/attn/w_uk$",               (None, "model")),
    (r"/attn/w_uv$",               (None, "model")),
    (r"/attn/w_kr$",               ("data", None)),
    # --- attention (GQA + cross) -------------------------------------------
    (r"/(attn|cross)/wq$",         ("data", "model")),
    # wk/wv (+ biases): never model-shard the kv output dim (KVH * hd): the
    # guard checks divisibility, not whole-head alignment, and a split
    # inside head_dim lands in the RoPE halves (the reference measured the
    # GQA train step drift on a (2, 2) mesh)
    (r"/(attn|cross)/w[kv]$",      ("data", None)),
    (r"/(attn|cross)/wo$",         ("model", "data")),
    (r"/(attn|cross)/bq$",         ("model",)),
    (r"/(attn|cross)/b[kv]$",      (None,)),
    # --- MLPs ----------------------------------------------------------------
    (r"/mlp/wi(_gate|_up)?$",      ("data", "model")),
    (r"/mlp/wo$",                  ("model", "data")),
    # --- RG-LRU --------------------------------------------------------------
    (r"/rec/w_in_[xg]$",           ("data", "model")),
    (r"/rec/w_out$",               ("model", "data")),
    (r"/rec/w_[ax]$",              ("model", None, None)),  # (nh, bw, bw)
    (r"/rec/b_[ax]$",              ("model",)),
    (r"/rec/conv_w$",              (None, "model")),
    (r"/rec/conv_b$",              ("model",)),
    (r"/rec/lam$",                 ("model",)),
    # --- RWKV ------------------------------------------------------------------
    (r"/tm/w_[rkvg]$",             ("data", "model")),
    (r"/tm/w_o$",                  ("model", "data")),
    (r"/tm/maa_w1$",               ("data", None)),
    (r"/tm/maa_w2$",               (None, None, "data")),
    (r"/tm/decay_w1$",             ("data", None)),
    (r"/tm/decay_w2$",             (None, "data")),
    (r"/tm/bonus$",                (None, None)),
    (r"/cm/w_k$",                  ("data", "model")),
    (r"/cm/w_v$",                  ("model", "data")),
    (r"/cm/w_r$",                  ("data", "model")),
    # --- VLM projector -----------------------------------------------------------
    (r"/vlm/proj1$",               (None, "data")),
    (r"/vlm/proj2$",               ("data", "model")),
]


class P(tuple):
    """A partition spec: one entry a dim, ``None`` (replicated), a mesh
    axis name, or a tuple of names (the dim split over their product,
    row-major). Shorter than the tensor's rank, it replicates the rest."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(tuple(self))


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axis_size(mesh, name) -> int:
    """The size of axis ``name``; ``KeyError`` where the mesh lacks it
    (as the reference's lookup)."""
    if name not in mesh.axis_names:
        raise KeyError(name)
    return mesh.axis_size(name)


def _reference_path(name: str) -> str:
    """The JAX package's tree path of a port parameter name: the layer
    index after a stacked subtree dropped, ``/`` between the parts."""
    parts = name.split(".")
    if len(parts) > 2 and parts[0] in STACKED and parts[1].isdigit():
        parts = [parts[0]] + parts[2:]
    return "/".join(parts)


def spec_for_param(name: str, shape, mesh, *, attn_fsdp: bool = True) -> P:
    """The partition spec of one parameter of the port (``name`` as
    ``named_parameters`` gives it, ``shape`` its own, unstacked).

    ``attn_fsdp=False``: the square attention projections (wq, wo) are
    tensor parallel only (no "data" factor), trading their FSDP gathers
    for memory; pair it with ``optimizer_specs(zero1=True)``.
    """
    path = _reference_path(name)
    template = None
    for pat, tmpl in _MATRIX_RULES:
        if re.search(pat, path):
            template = list(tmpl)
            break
    if not attn_fsdp and re.search(r"/(attn|cross)/w[qo]$", path):
        template = [None if t == "data" else t for t in template]
    ndim = len(shape)
    if template is None:
        template = [None] * ndim
    # "expert" pseudo-axis = expert parallelism on the mesh model axis
    template = ["model" if t == "expert" else t for t in template]
    template = (template + [None] * ndim)[:ndim]
    spec = []
    for dim, ax in zip(shape, template):
        if ax is not None and ax in mesh.axis_names and \
                dim % _axis_size(mesh, ax) == 0:
            spec.append(ax)
        else:
            spec.append(None)   # divisibility fallback: replicate
    return P(*spec)


def _named(params_or_abstract) -> Dict[str, torch.Tensor]:
    if isinstance(params_or_abstract, torch.nn.Module):
        return dict(params_or_abstract.named_parameters())
    return dict(params_or_abstract)


def param_specs(params_or_abstract, mesh, *, attn_fsdp: bool = True
                ) -> Dict[str, P]:
    """Specs by name of a model's parameters: a module, or a mapping of
    name -> tensor (``models.model.abstract_params``'s ``meta`` tensors
    serve)."""
    return {n: spec_for_param(n, tuple(t.shape), mesh, attn_fsdp=attn_fsdp)
            for n, t in _named(params_or_abstract).items()}


def param_shardings(params_or_abstract, mesh) -> Dict[str, "NamedSharding"]:
    return {n: NamedSharding(mesh, s)
            for n, s in param_specs(params_or_abstract, mesh).items()}


# --------------------------------------------------------------------------
# batch / cache / optimizer specs
# --------------------------------------------------------------------------

def _tree_map(fn, tree):
    """``fn`` over the leaves of nested mappings (a dict keeps its keys)."""
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _batch_axes(mesh, dim: int):
    """Largest prefix of ('pod','data') whose product divides dim."""
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    chosen = []
    prod = 1
    for a in axes:
        if dim % (prod * _axis_size(mesh, a)) == 0:
            chosen.append(a)
            prod *= _axis_size(mesh, a)
    if not chosen:
        return None
    return tuple(chosen) if len(chosen) > 1 else chosen[0]


def batch_specs(batch_tree, mesh):
    """Shard the leading (global batch) dim of every batch leaf."""
    def spec(leaf):
        ax = _batch_axes(mesh, leaf.shape[0])
        return P(ax, *([None] * (len(leaf.shape) - 1)))
    return _tree_map(spec, batch_tree)


def cache_specs(cache_tree, mesh, cfg, *, strategy: str = "heads"):
    """Decode-state specs: batch (dim 1) on ('pod','data'), one trailing
    dim on 'model'. Leaf layouts are (L, B, ...).

    ``strategy="heads"`` (default) prefers the KV-heads dim (dim 3 of a
    5-D cache), then the time dim (2), then the last dims; ``"seq"``
    prefers the time dim; ``"feature"`` the last dim first. The first
    candidate that the model axis divides (and is no smaller than) is
    taken.
    """
    msize = _axis_size(mesh, "model")

    def spec(leaf):
        shape = leaf.shape
        out = [None, _batch_axes(mesh, shape[1])] + \
            [None] * (len(shape) - 2)
        if strategy == "seq":
            candidates = [2] + list(range(len(shape) - 1, 2, -1))
        elif strategy == "heads":
            candidates = ([3] if len(shape) == 5 else []) + \
                [2] + list(range(len(shape) - 1, 2, -1))
        else:
            candidates = list(range(len(shape) - 1, 1, -1))
        for i in candidates:
            if i < len(shape) and shape[i] % msize == 0 and \
                    shape[i] >= msize:
                out[i] = "model"
                break
        return P(*out)

    return _tree_map(spec, cache_tree)


def optimizer_specs(pspecs, params_or_abstract=None, mesh=None,
                    *, zero1: bool = False):
    """AdamW state specs (``optim.AdamWState`` of specs): the moments
    mirror the parameter specs.

    ``zero1=True`` (needs the parameters and the mesh) also shards the
    moments over "data" on the first replicated dim it divides where the
    parameter itself is not on "data" (ZeRO-1).
    """
    from repro_torch.optim import AdamWState

    if not zero1:
        mirror = dict(pspecs)
        return AdamWState(step=P(), m=mirror, v=mirror)
    dsize = _axis_size(mesh, "data")
    shapes = {n: tuple(t.shape) for n, t in _named(params_or_abstract)
              .items()}

    def z1(spec, shape):
        used = {a for entry in spec for a in _axes_of(entry)}
        if "data" in used:
            return spec
        out = list(spec)
        for i, (ax, dim) in enumerate(zip(spec, shape)):
            if ax is None and dim % dsize == 0 and dim >= dsize:
                out[i] = "data"
                return P(*out)
        return spec

    zspecs = {n: z1(s, shapes[n]) for n, s in pspecs.items()}
    return AdamWState(step=P(), m=zspecs, v=zspecs)


# --------------------------------------------------------------------------
# layouts on the in-process mesh
# --------------------------------------------------------------------------

def mesh_coords(mesh, entry: int) -> Dict[str, int]:
    """The axis coordinates of the mesh's ``entry`` (row-major)."""
    coords = {}
    for name, size in reversed(list(zip(mesh.axis_names, mesh.shape))):
        coords[name] = entry % size
        entry //= size
    return coords


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: which block of a tensor each entry holds."""

    mesh: object
    spec: P

    def _dims(self, ndim: int) -> List[Tuple[str, ...]]:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} is longer than rank {ndim}")
        dims = [_axes_of(e) for e in self.spec] + [()] * (ndim - len(
            self.spec))
        for axes in dims:
            for a in axes:
                _axis_size(self.mesh, a)
        return dims

    def block_index(self, ndim: int, entry: int) -> Tuple[int, ...]:
        """The entry's block, as its index along every dim."""
        coords = mesh_coords(self.mesh, entry)
        out = []
        for axes in self._dims(ndim):
            i = 0
            for a in axes:
                i = i * self.mesh.axis_size(a) + coords[a]
            out.append(i)
        return tuple(out)

    def block_slices(self, shape, entry: int) -> Tuple[slice, ...]:
        """The entry's block of a tensor of ``shape``; ``ValueError``
        where a dim does not divide over its axes."""
        return layout(self, tuple(shape)).slices[entry]

    def block_shape(self, shape) -> Tuple[int, ...]:
        return layout(self, tuple(shape)).block_shape

    def axes(self) -> set:
        """The mesh axes the spec names."""
        return {a for entry in self.spec for a in _axes_of(entry)}


@dataclasses.dataclass(frozen=True)
class _Layout:
    slices: Tuple[Tuple[slice, ...], ...]   # every entry's block
    index: Tuple[Tuple[int, ...], ...]      # every entry's block index
    reps: Tuple[int, ...]                   # one entry a distinct block
    block_shape: Tuple[int, ...]


@functools.lru_cache(maxsize=4096)
def layout(sharding: NamedSharding, shape: Tuple[int, ...]) -> _Layout:
    """Where every entry's block of a tensor of ``shape`` lies (cached:
    a mesh step reads it for every parameter and entry)."""
    dims = sharding._dims(len(shape))
    counts = [math.prod(sharding.mesh.axis_size(a) for a in axes)
              for axes in dims]
    for dim, n, axes in zip(shape, counts, dims):
        if dim % n:
            raise ValueError(f"dim {dim} does not divide over {axes} ({n}) "
                             f"in spec {sharding.spec}")
    bshape = tuple(dim // n for dim, n in zip(shape, counts))
    slices, index, reps, seen = [], [], [], set()
    for e in range(len(sharding.mesh.devices)):
        idx = sharding.block_index(len(shape), e)
        index.append(idx)
        slices.append(tuple(slice(i * b, (i + 1) * b)
                            for i, b in zip(idx, bshape)))
        if idx not in seen:
            seen.add(idx)
            reps.append(e)
    return _Layout(tuple(slices), tuple(index), tuple(reps), bshape)


class _Context:
    """What the calling thread does on the mesh now: the entry its tensor
    ops run for (``None`` outside a mesh step), and whether they belong to
    a collective. ``launch.hlo_cost`` reads both."""

    entry: Optional[int] = None
    collective: int = 0


CONTEXT = _Context()

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
# result bytes and calls of the mesh's collectives, by kind, since the
# last reset_collectives()
COLLECTIVES = {"bytes": {k: 0 for k in COLLECTIVE_KINDS},
               "counts": {k: 0 for k in COLLECTIVE_KINDS}}


def reset_collectives() -> None:
    for k in COLLECTIVE_KINDS:
        COLLECTIVES["bytes"][k] = 0
        COLLECTIVES["counts"][k] = 0


def collective_snapshot() -> dict:
    return {"bytes": dict(COLLECTIVES["bytes"]),
            "counts": dict(COLLECTIVES["counts"])}


@contextlib.contextmanager
def on_entry(entry: Optional[int]) -> Iterator[None]:
    """Attribute the tensor ops inside to the mesh's ``entry``."""
    old = CONTEXT.entry
    CONTEXT.entry = entry
    try:
        yield
    finally:
        CONTEXT.entry = old


@contextlib.contextmanager
def collective(kind: str, nbytes: int, count: bool = True
               ) -> Iterator[None]:
    """Run a collective's copies inside; add ``nbytes`` of result to
    ``kind`` (and a call, with ``count``)."""
    COLLECTIVES["bytes"][kind] += int(nbytes)
    COLLECTIVES["counts"][kind] += int(count)
    CONTEXT.collective += 1
    try:
        yield
    finally:
        CONTEXT.collective -= 1


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


class ShardedTensor:
    """A tensor laid out on a mesh: ``blocks[e]`` is entry ``e``'s block,
    on ``mesh.devices[e]``. Entries that hold the same block (a spec that
    leaves an axis out) hold copies, updated alike."""

    def __init__(self, blocks: Sequence[torch.Tensor], shape, dtype,
                 sharding: NamedSharding):
        self.blocks = list(blocks)
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.sharding = sharding
        self.layout = layout(sharding, tuple(self.shape))

    @property
    def mesh(self):
        return self.sharding.mesh

    @property
    def spec(self) -> P:
        return self.sharding.spec

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, dtype={self.dtype}"
                f", spec={self.spec}, mesh={dict(zip(self.mesh.axis_names, self.mesh.shape))})")

    @classmethod
    def scatter(cls, t: torch.Tensor, sharding: NamedSharding
                ) -> "ShardedTensor":
        """Lay ``t`` out: every entry gets a copy of its block on its
        device."""
        t = t.detach()
        lay = layout(sharding, tuple(t.shape))
        blocks = []
        for e, dev in enumerate(sharding.mesh.devices):
            with on_entry(e):
                blocks.append(t[lay.slices[e]].to(
                    dev, copy=True, memory_format=torch.contiguous_format))
        return cls(blocks, t.shape, t.dtype, sharding)

    @classmethod
    def zeros(cls, shape, dtype, sharding: NamedSharding) -> "ShardedTensor":
        bshape = sharding.block_shape(shape)
        blocks = []
        for e, dev in enumerate(sharding.mesh.devices):
            with on_entry(e):
                blocks.append(torch.zeros(bshape, dtype=dtype, device=dev))
        return cls(blocks, shape, dtype, sharding)

    def representatives(self) -> List[int]:
        """One entry for every distinct block, the first that holds it, in
        entry order."""
        return list(self.layout.reps)

    def gather_into(self, out: torch.Tensor, *, record: bool = True
                    ) -> torch.Tensor:
        """All-gather the blocks into ``out`` (a tensor of the full shape,
        on the receiving entry's device); returns ``out``."""
        nbytes = _nbytes(self.shape, self.dtype) if record else 0
        with collective("all-gather", nbytes, record), torch.no_grad():
            out.copy_(self._assemble(out.device))
        return out

    def _assemble(self, device) -> torch.Tensor:
        """The distinct blocks concatenated dim by dim, on ``device``."""
        by_index = {self.layout.index[e]: self.blocks[e]
                    for e in self.layout.reps}
        counts = [s // b for s, b in zip(self.shape, self.layout.block_shape)]

        def cat(prefix):
            dim = len(prefix)
            if dim == len(counts):
                return by_index[prefix].to(device)
            parts = [cat(prefix + (i,)) for i in range(counts[dim])]
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim)

        return cat(())

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first entry's),
        all-gathered."""
        dev = self.mesh.devices[0] if device is None else device
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        return self.gather_into(out)

    def region(self, entry: int, axes) -> Tuple[slice, ...]:
        """The part of the full tensor that ``entry``'s blocks cover along
        the mesh ``axes`` (the whole of every dim split over other
        axes)."""
        axes = set(axes)
        sl = self.layout.slices[entry]
        dims = self.sharding._dims(self.ndim)
        return tuple(s if d and set(d) <= axes else slice(0, n)
                     for s, d, n in zip(sl, dims, self.shape))

    def group(self, entry: int, axes) -> List[int]:
        return group(self.mesh, entry, axes)

    def gather_region(self, entry: int, axes) -> torch.Tensor:
        """All-gather, onto ``entry``'s device, the region its blocks
        cover along ``axes`` (``region``): the blocks of its group."""
        reg = self.region(entry, axes)
        shape = tuple(s.stop - s.start for s in reg)
        out = torch.empty(shape, dtype=self.dtype,
                          device=self.mesh.devices[entry])
        with collective("all-gather", _nbytes(shape, self.dtype)), \
                torch.no_grad():
            seen = set()
            for e in self.group(entry, axes):
                idx = self.layout.index[e]
                if idx in seen:
                    continue
                seen.add(idx)
                sl = self.layout.slices[e]
                rel = tuple(slice(s.start - r.start, s.stop - r.start)
                            for s, r in zip(sl, reg))
                out[rel].copy_(self.blocks[e])
        return out

    def write_region(self, entry: int, axes, value: torch.Tensor) -> None:
        """Copy ``value`` (``region(entry, axes)`` of the full tensor)
        into the blocks of ``entry``'s group: each entry keeps its own
        part, a local write."""
        reg = self.region(entry, axes)
        with torch.no_grad():
            for e in self.group(entry, axes):
                sl = self.layout.slices[e]
                rel = tuple(slice(s.start - r.start, s.stop - r.start)
                            for s, r in zip(sl, reg))
                self.blocks[e].copy_(value[rel])

    def nbytes_at(self, entry: int) -> int:
        return self.blocks[entry].numel() * self.blocks[entry].element_size()


def reduce_scatter_add(acc: ShardedTensor, full: torch.Tensor, *,
                       record: bool = True) -> ShardedTensor:
    """Add one member's contribution ``full`` (the whole tensor) into
    every entry's block of ``acc``, converted to its dtype: the
    reduce-scatter of a sum whose members arrive one at a time. Its
    result bytes (every entry's block) are counted where ``record`` (the
    first member's call)."""
    nbytes = sum(acc.nbytes_at(e) for e in range(len(acc.blocks))) \
        if record else 0
    with collective("reduce-scatter", nbytes, record), torch.no_grad():
        for e, b in enumerate(acc.blocks):
            sl = acc.layout.slices[e]
            b.add_(full[sl].to(device=b.device, dtype=b.dtype))
    return acc


def lay_out(t, sharding: NamedSharding) -> ShardedTensor:
    """``t`` laid out by ``sharding``: a tensor is scattered, a sharded
    tensor of the same layout kept, one of another layout gathered and
    re-split."""
    if isinstance(t, ShardedTensor):
        if t.sharding == sharding:
            return t
        t = t.full()
    return ShardedTensor.scatter(t, sharding)


def group(mesh, entry: int, axes) -> List[int]:
    """The entries that share ``entry``'s coordinates on ``axes``, in
    entry order."""
    want = {a: c for a, c in mesh_coords(mesh, entry).items()
            if a in set(axes)}
    return [e for e in range(len(mesh.devices))
            if all(mesh_coords(mesh, e)[a] == c for a, c in want.items())]


def replicas(mesh, axes) -> List[int]:
    """The first entry of every replica over the mesh ``axes`` (the
    entries at coordinate 0 on every other axis), in entry order."""
    axes = set(axes)
    return [e for e in range(len(mesh.devices))
            if all(c == 0 for a, c in mesh_coords(mesh, e).items()
                   if a not in axes)]


def entry_bytes(trees, mesh) -> List[int]:
    """Bytes of the blocks every entry holds over ``trees`` (nested
    mappings whose leaves are sharded tensors; other leaves are
    skipped)."""
    out = [0] * len(mesh.devices)

    def add(leaf):
        if isinstance(leaf, ShardedTensor):
            for e in range(len(out)):
                out[e] += leaf.nbytes_at(e)
        return leaf

    for tree in trees:
        _tree_map(add, tree)
    return out
