"""Public wrappers for the CUDA back-projection kernels.

Handles arbitrary problem shapes by padding the volume's i/j line grid to
the block granularity (voxel lines outside the true volume compute values
that are sliced away; padding only costs compute, never correctness).

Only the tensors' device selects the path: a CPU tensor runs the plain
PyTorch version of each kernel, a CUDA tensor launches the kernel or
raises. The ``interpret`` option is accepted so the option sets match the
JAX package's registry, and selects nothing.

The ``*_lanes`` forms take rb stacked inputs ``img_b (rb, np, nw, nh)``
against one shared ``mat`` and return (rb, ni, nj, nz) from one launch of
the kernel's lane form; each lane equals the solo wrapper on it bit for
bit. They pad ``i`` and ``j`` per lane only.
"""

from __future__ import annotations

from repro_torch._device import check_on_device, resolve_device

from .backproject_banded import backproject_banded as _backproject_banded
from .backproject_banded import (backproject_banded_lanes as
                                 _backproject_banded_lanes)
from .backproject_onehot import (backproject_onehot_fused,
                                 backproject_onehot_fused_lanes,
                                 backproject_onehot_kernel,
                                 backproject_onehot_kernel_lanes)
from .backproject_subline import (backproject_subline_fused,
                                  backproject_subline_fused_lanes,
                                  backproject_subline_kernel,
                                  backproject_subline_kernel_lanes,
                                  fused_batch_ok)

# KernelSpec contract (core.variants.REGISTRY): the call-time options each
# public wrapper consumes. The registry's CUDA KernelSpecs must declare
# exactly these sets; tests cross-check the two layers so a new kernel
# knob cannot be added here without the planner (which filters options
# through KernelSpec.options) learning about it.
ACCEPTED_OPTIONS = {
    "backproject_subline": frozenset({"nb", "block", "proj_loop",
                                      "interpret"}),
    "backproject_onehot": frozenset({"nb", "block", "k_chunk", "proj_loop",
                                     "interpret"}),
    "backproject_banded": frozenset({"nb", "block", "bw", "proj_loop",
                                     "interpret"}),
}


def _pad_to(n: int, b: int) -> int:
    return ((n + b - 1) // b) * b


def _run_padded(fn, img_t, mat, vol_shape_xyz, block, **kw):
    # Only i/j may be padded: extra voxel LINES are masked by the kernel's
    # bounds checks. nz must never be padded: the symmetry pairing
    # k <-> nz-1-k is defined by the true volume center (the kernel
    # handles odd nz natively via an uneven half-split). A lane wrapper's
    # (rb, ni, nj, nz) output is cut per lane.
    ni, nj, nz = vol_shape_xyz
    BI, BJ = block
    nip = _pad_to(ni, BI)
    njp = _pad_to(nj, BJ)
    vol = fn(img_t, mat, (nip, njp, nz), block=block, **kw)
    if (nip, njp) != (ni, nj):
        vol = vol[..., :ni, :nj, :]
    return vol


def backproject_subline(img_t, mat, vol_shape_xyz, *, nb: int = 0,
                        block=(4, 8), proj_loop: bool = False,
                        interpret: bool = True, device=None):
    """Paper Algorithm 1 as a CUDA kernel (symmetry_pf analogue).

    ``img_t`` (np, nw, nh) and ``mat`` (np, 3, 4) must lie on ``device``
    (``None`` -> the CUDA card). With ``proj_loop`` and an nb-divisible
    projection count the fused kernel K2 runs and stages nb projections
    per step of its loop; otherwise K1 runs, one projection per step.
    ``interpret`` selects nothing (see the module docstring).
    """
    _on_device(img_t, mat, device)
    if fused_batch_ok(img_t.shape[0], nb, proj_loop):
        return _run_padded(backproject_subline_fused, img_t, mat,
                           tuple(vol_shape_xyz), block, nb=nb)
    return _run_padded(backproject_subline_kernel, img_t, mat,
                       tuple(vol_shape_xyz), block)


def backproject_onehot(img_t, mat, vol_shape_xyz, *, nb: int = 0,
                       block=(4, 8), k_chunk: int = 128,
                       proj_loop: bool = False, interpret: bool = True,
                       device=None):
    """The one-hot interpolation kernel (K3, or with ``proj_loop`` and an
    nb-divisible projection count the fused K4); the arguments are those
    of :func:`backproject_subline`, plus ``k_chunk``, the reference's k
    tile of the stage-2 contraction, which changes no bit."""
    _on_device(img_t, mat, device)
    if fused_batch_ok(img_t.shape[0], nb, proj_loop):
        return _run_padded(backproject_onehot_fused, img_t, mat,
                           tuple(vol_shape_xyz), block, k_chunk=k_chunk,
                           nb=nb)
    return _run_padded(backproject_onehot_kernel, img_t, mat,
                       tuple(vol_shape_xyz), block, k_chunk=k_chunk)


def backproject_banded(img_t, mat, vol_shape_xyz, *, nb: int = 0,
                       block=(4, 8), bw: int = 32, proj_loop: bool = False,
                       interpret: bool = True, device=None):
    """The banded kernel (K5, or with ``proj_loop`` and an nb-divisible
    projection count the fused K6, one band per nb-group); the arguments
    are those of :func:`backproject_subline`, plus ``bw``, the starting
    band width (doubled until every tile's span fits). i and j are padded
    to the block before the band schedule, as in the reference."""
    _on_device(img_t, mat, device)
    return _run_padded(_backproject_banded, img_t, mat, tuple(vol_shape_xyz),
                       block, bw=bw, nb=nb, proj_loop=proj_loop)


def _on_device(img_t, mat, device) -> None:
    dev = resolve_device(device)
    check_on_device("img_t", img_t, dev)
    check_on_device("mat", mat, dev)


def backproject_subline_lanes(img_b, mat, vol_shape_xyz, *, nb: int = 0,
                              block=(4, 8), proj_loop: bool = False,
                              interpret: bool = True, device=None):
    """:func:`backproject_subline` on rb lanes (K1's or K2's lane launch):
    ``img_b`` (rb, np, nw, nh) -> (rb, ni, nj, nz)."""
    _on_device(img_b, mat, device)
    if fused_batch_ok(img_b.shape[1], nb, proj_loop):
        return _run_padded(backproject_subline_fused_lanes, img_b, mat,
                                 tuple(vol_shape_xyz), block, nb=nb)
    return _run_padded(backproject_subline_kernel_lanes, img_b, mat,
                             tuple(vol_shape_xyz), block)


def backproject_onehot_lanes(img_b, mat, vol_shape_xyz, *, nb: int = 0,
                             block=(4, 8), k_chunk: int = 128,
                             proj_loop: bool = False, interpret: bool = True,
                             device=None):
    """:func:`backproject_onehot` on rb lanes (K3's or K4's lane
    launch)."""
    _on_device(img_b, mat, device)
    if fused_batch_ok(img_b.shape[1], nb, proj_loop):
        return _run_padded(backproject_onehot_fused_lanes, img_b, mat,
                                 tuple(vol_shape_xyz), block,
                                 k_chunk=k_chunk, nb=nb)
    return _run_padded(backproject_onehot_kernel_lanes, img_b, mat,
                             tuple(vol_shape_xyz), block, k_chunk=k_chunk)


def backproject_banded_lanes(img_b, mat, vol_shape_xyz, *, nb: int = 0,
                             block=(4, 8), bw: int = 32,
                             proj_loop: bool = False, interpret: bool = True,
                             device=None):
    """:func:`backproject_banded` on rb lanes: one band search, each lane
    in bands, K5's or K6's lane launch."""
    _on_device(img_b, mat, device)
    return _run_padded(_backproject_banded_lanes, img_b, mat,
                             tuple(vol_shape_xyz), block, bw=bw, nb=nb,
                             proj_loop=proj_loop)
