"""Declarative registry of the ported back-projection variants.

Each variant is a :class:`KernelSpec`: a capability record the planner
(``runtime.planner``) consumes to schedule work: which paper
optimizations the kernel carries, which call-time options it accepts,
and which symmetry-free member of the ladder substitutes for it on
Z-slabs that are not centered on the volume midplane (the O3 mirror pairs
voxel ``k`` with ``nk-1-k`` about the FULL volume's Z center).

Every kernel callable has the uniform signature

    fn(img_t, mat, vol_shape_xyz, **opts) -> vol_t (nx, ny, nz)

operating on transposed layouts, on the device its tensors lie on, and
a lane form (:attr:`KernelSpec.lanes`)

    lanes(img_b, mat, vol_shape_xyz, **opts) -> vol_b (rb, nx, ny, nz)

of rb stacked inputs ``img_b`` (rb, np, nw, nh) against one shared
``mat``, each lane equal bit for bit to ``fn`` on it: one lane launch of
the kernel for the CUDA variants, ``fn`` once per lane otherwise. The
RTK baseline is exposed through the same signature by transposing at the
edges. The variants (paper Table 2 naming; ``_mp`` = plain PyTorch,
``_pl`` = the hand-written CUDA kernel):

    baseline         RTK Listing 1 (native layouts inside)
    transpose_mp     O1
    share_mp         O1+O2
    symmetry_mp      O1+O2+O3
    subline_mp       O1+O2+O4
    subline_batch_mp O1+O2+O4+O5 (no O3: exact on any Z-slab; the
                     planner's slab-safe fallback)
    algorithm1_mp    O1..O5 (paper Algorithm 1; nb batching)
    subline_pl       CUDA: O1..O5, kernels/csrc/backproject_subline.cu
    onehot_pl        CUDA: subline_pl with stage 2 as a two-hot
                     contraction (its nonzero terms), the two-hot form
                     of kernels/csrc/backproject_subline.cu
    banded_pl        CUDA: subline_pl reading each tile's band of
                     detector columns, the banded instance of
                     kernels/csrc/backproject_subline.cu
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, FrozenSet, Mapping, Optional, Tuple

import torch

from . import backproject as bp
from . import baseline as bl


def _baseline_adapter(img_t, mat, vol_shape_xyz, **_):
    img = bp.transpose_projections(img_t)  # back to (np, nh, nw)
    ni, nj, nk = vol_shape_xyz
    vol = bl.backproject_rtk(img, mat, (nk, nj, ni))
    return bp.volume_to_transposed(vol).contiguous()


def _transpose(img_t, mat, vol_shape_xyz, **_):
    return bp.bp_transpose(img_t, mat, vol_shape_xyz)


def _share(img_t, mat, vol_shape_xyz, **_):
    return bp.bp_share(img_t, mat, vol_shape_xyz)


def _symmetry(img_t, mat, vol_shape_xyz, **_):
    return bp.bp_symmetry(img_t, mat, vol_shape_xyz)


def _subline(img_t, mat, vol_shape_xyz, **_):
    return bp.bp_subline(img_t, mat, vol_shape_xyz)


def _algorithm1(img_t, mat, vol_shape_xyz, nb: int = 8, **_):
    return bp.bp_subline_symmetry_batch(img_t, mat, vol_shape_xyz, nb=nb)


def _subline_batch(img_t, mat, vol_shape_xyz, nb: int = 8, **_):
    return bp.bp_subline_batch(img_t, mat, vol_shape_xyz, nb=nb)


def _subline_cuda(img_t, mat, vol_shape_xyz, nb: int = 8,
                  interpret: bool = True, block=(4, 8),
                  proj_loop: bool = False, **_):
    from repro_torch.kernels import ops
    return ops.backproject_subline(img_t, mat, vol_shape_xyz, nb=nb,
                                   block=block, interpret=interpret,
                                   proj_loop=proj_loop, device=img_t.device)


def _onehot_cuda(img_t, mat, vol_shape_xyz, nb: int = 8,
                 interpret: bool = True, block=(4, 8), k_chunk: int = 128,
                 proj_loop: bool = False, **_):
    from repro_torch.kernels import ops
    return ops.backproject_onehot(img_t, mat, vol_shape_xyz, nb=nb,
                                  block=block, k_chunk=k_chunk,
                                  interpret=interpret, proj_loop=proj_loop,
                                  device=img_t.device)


def _banded_cuda(img_t, mat, vol_shape_xyz, nb: int = 8,
                 interpret: bool = True, block=(4, 8), bw: int = 32,
                 proj_loop: bool = False, **_):
    from repro_torch.kernels import ops
    return ops.backproject_banded(img_t, mat, vol_shape_xyz, nb=nb,
                                  block=block, bw=bw, interpret=interpret,
                                  proj_loop=proj_loop, device=img_t.device)


def _subline_cuda_lanes(img_b, mat, vol_shape_xyz, nb: int = 8,
                        interpret: bool = True, block=(4, 8),
                        proj_loop: bool = False, **_):
    from repro_torch.kernels import ops
    return ops.backproject_subline_lanes(img_b, mat, vol_shape_xyz, nb=nb,
                                         block=block, interpret=interpret,
                                         proj_loop=proj_loop,
                                         device=img_b.device)


def _onehot_cuda_lanes(img_b, mat, vol_shape_xyz, nb: int = 8,
                       interpret: bool = True, block=(4, 8),
                       k_chunk: int = 128, proj_loop: bool = False, **_):
    from repro_torch.kernels import ops
    return ops.backproject_onehot_lanes(img_b, mat, vol_shape_xyz, nb=nb,
                                        block=block, k_chunk=k_chunk,
                                        interpret=interpret,
                                        proj_loop=proj_loop,
                                        device=img_b.device)


def _banded_cuda_lanes(img_b, mat, vol_shape_xyz, nb: int = 8,
                       interpret: bool = True, block=(4, 8), bw: int = 32,
                       proj_loop: bool = False, **_):
    from repro_torch.kernels import ops
    return ops.backproject_banded_lanes(img_b, mat, vol_shape_xyz, nb=nb,
                                        block=block, bw=bw,
                                        interpret=interpret,
                                        proj_loop=proj_loop,
                                        device=img_b.device)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Capability record for one back-projection kernel.

    Fields
    ------
    name : registry key (paper Table 2 naming).
    fn : kernel callable with the uniform transposed signature.
    optimizations : which paper optimizations the kernel carries
        (Table 2 columns; ``"symmetry"`` has scheduling consequences).
    options : call-time keyword options the kernel actually consumes.
        The planner filters resolved options through this set so kernels
        never see (and silently swallow) irrelevant knobs.
    slab_safe_fallback : name of the strongest symmetry-free variant with
        the same remaining optimizations: what the planner schedules on
        a Z-slab that is neither volume-centered nor mirror-paired.
        ``None`` for symmetry-free kernels (they are their own fallback).
    backend : "reference" (the RTK baseline) | "torch" (plain PyTorch) |
        "cuda" (a hand-written kernel; its wrapper runs the kernel's
        plain version on CPU tensors).
    proj_loop : whether the kernel supports the fused multi-batch mode:
        an in-kernel loop that stages ``nb`` projections per step. The
        planner defaults the ``proj_loop`` option ON for specs that
        advertise it.
    tuning_space : the option axes the autotuner (``runtime.autotune``)
        may flip when it searches this kernel's configuration space, as
        ``((option, (candidate values, ...)), ...)``. Every key must be
        in ``options``; heuristic defaults stay with the planner, this
        only widens the measured search.
    lanes_fn : the kernel's rb-lane form (one launch for all lanes), or
        None: :attr:`lanes` then runs ``fn`` once per lane.
    load_fn : builds (at first use) and loads the kernel's library, for a
        caller that must not build inside worker threads (the fleet
        builds before its workers start); None for plain variants.
    """

    name: str
    fn: Callable
    optimizations: Tuple[str, ...]
    options: FrozenSet[str] = frozenset()
    slab_safe_fallback: Optional[str] = None
    backend: str = "torch"
    proj_loop: bool = False
    tuning_space: Tuple[Tuple[str, Tuple], ...] = ()
    lanes_fn: Optional[Callable] = None
    load_fn: Optional[Callable] = None

    @property
    def lanes(self) -> Callable:
        """``lanes(img_b, mat, vol_shape_xyz, **opts) -> (rb, nx, ny,
        nz)``: ``lanes_fn``, or ``fn`` once per lane (exact by
        construction)."""
        if self.lanes_fn is not None:
            return self.lanes_fn
        fn = self.fn

        def per_lane(img_b, mat, vol_shape_xyz, **opts):
            return torch.stack([fn(img_b[r], mat, vol_shape_xyz, **opts)
                                for r in range(img_b.shape[0])])
        return per_lane

    @property
    def uses_symmetry(self) -> bool:
        """Whether the kernel's math assumes the volume-centered O3 mirror."""
        return "symmetry" in self.optimizations

    def resolve_options(self, opts: Mapping) -> Dict:
        """Filter caller options down to the ones this kernel accepts."""
        return {k: v for k, v in opts.items()
                if k in self.options and v is not None}


def _load_tile_kernel() -> None:
    """Build and load ``backproject_subline.cu``, the library of every
    CUDA variant (K1-K6), with the banded launch's bindings."""
    from repro_torch.kernels import backproject_banded as kb
    kb._lib()


_PL_OPTS = frozenset({"nb", "interpret", "block", "proj_loop"})

# the CUDA kernels expose the fused in-kernel projection loop (K2/K4/K6
# against K1/K3/K5) as a measured tuning axis: the planner defaults it
# ON, and whether it wins is what runtime.autotune measures
_PL_TUNING = (("proj_loop", (True, False)),)

REGISTRY: Dict[str, KernelSpec] = {s.name: s for s in (
    KernelSpec("baseline", _baseline_adapter, (), backend="reference"),
    KernelSpec("transpose_mp", _transpose, ("transpose",)),
    KernelSpec("share_mp", _share, ("transpose", "share")),
    KernelSpec("symmetry_mp", _symmetry,
               ("transpose", "share", "symmetry"),
               slab_safe_fallback="share_mp"),
    KernelSpec("subline_mp", _subline, ("transpose", "share", "subline")),
    KernelSpec("subline_batch_mp", _subline_batch,
               ("transpose", "share", "subline", "batch"),
               options=frozenset({"nb"})),
    KernelSpec("algorithm1_mp", _algorithm1,
               ("transpose", "share", "symmetry", "subline", "batch"),
               options=frozenset({"nb"}),
               slab_safe_fallback="subline_batch_mp"),
    KernelSpec("subline_pl", _subline_cuda,
               ("transpose", "share", "symmetry", "subline", "batch",
                "localmem", "prefetch"),
               options=_PL_OPTS,
               slab_safe_fallback="subline_batch_mp", backend="cuda",
               proj_loop=True, tuning_space=_PL_TUNING,
               lanes_fn=_subline_cuda_lanes, load_fn=_load_tile_kernel),
    KernelSpec("onehot_pl", _onehot_cuda,
               ("transpose", "share", "symmetry", "subline", "batch",
                "localmem", "prefetch", "mxu-interp"),
               options=_PL_OPTS | {"k_chunk"},
               slab_safe_fallback="subline_batch_mp", backend="cuda",
               proj_loop=True, tuning_space=_PL_TUNING,
               lanes_fn=_onehot_cuda_lanes, load_fn=_load_tile_kernel),
    # the band schedule is recomputed from the matrices on every call,
    # as in the reference
    KernelSpec("banded_pl", _banded_cuda,
               ("transpose", "share", "symmetry", "subline", "batch",
                "localmem", "prefetch", "banded-prefetch"),
               options=_PL_OPTS | {"bw"},
               slab_safe_fallback="subline_batch_mp", backend="cuda",
               proj_loop=True, tuning_space=_PL_TUNING,
               lanes_fn=_banded_cuda_lanes, load_fn=_load_tile_kernel),
)}

#: variants of the JAX package that this package does not carry yet
UNPORTED = ()


def _validate_registry() -> None:
    for spec in REGISTRY.values():
        if spec.uses_symmetry:
            fb = spec.slab_safe_fallback
            if fb is None or fb not in REGISTRY:
                raise ValueError(
                    f"symmetry variant {spec.name!r} needs a registered "
                    f"slab_safe_fallback, got {fb!r}")
            fspec = REGISTRY[fb]
            if fspec.uses_symmetry:
                raise ValueError(
                    f"{spec.name!r} fallback {fb!r} still uses symmetry")
            if not set(fspec.optimizations) <= set(spec.optimizations):
                raise ValueError(
                    f"{spec.name!r} fallback {fb!r} adds optimizations "
                    f"the primary does not carry")
        elif spec.slab_safe_fallback is not None:
            raise ValueError(
                f"symmetry-free variant {spec.name!r} must not declare a "
                f"slab_safe_fallback")
        if spec.proj_loop and "proj_loop" not in spec.options:
            raise ValueError(
                f"{spec.name!r} advertises proj_loop but does not accept "
                f"the 'proj_loop' call option")
        if spec.backend == "cuda" and spec.lanes_fn is None:
            raise ValueError(
                f"CUDA variant {spec.name!r} needs its kernel's lane form "
                f"(lanes_fn): a loop of solo launches is not a batch")
        bad = [k for k, _ in spec.tuning_space if k not in spec.options]
        if bad:
            raise ValueError(
                f"{spec.name!r} tuning_space keys {bad} are not accepted "
                f"call options (KernelSpec.options)")


_validate_registry()


#: the registry's kernel callables by name (the JAX package's lookup view)
VARIANTS: Dict[str, Callable] = {n: s.fn for n, s in REGISTRY.items()}


def get_spec(name: str) -> KernelSpec:
    if name not in REGISTRY:
        raise KeyError(f"unknown back-projection variant {name!r}; "
                       f"have {sorted(REGISTRY)}")
    return REGISTRY[name]


def get_variant(name: str) -> Callable:
    return get_spec(name).fn


def slab_safe_variant(name: str) -> str:
    """Variant to run on an arbitrary (non-centered) Z-slab."""
    spec = get_spec(name)
    return spec.slab_safe_fallback if spec.uses_symmetry else name
