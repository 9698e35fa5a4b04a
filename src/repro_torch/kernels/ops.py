"""Public wrappers for the CUDA back-projection kernels.

Handles arbitrary problem shapes by padding the volume's i/j line grid to
the block granularity (voxel lines outside the true volume compute values
that are sliced away; padding only costs compute, never correctness).

Only the tensors' device selects the path: a CPU tensor runs the plain
PyTorch version of each kernel, a CUDA tensor launches the kernel or
raises. The ``interpret`` option is accepted so the option sets match the
JAX package's registry, and selects nothing.
"""

from __future__ import annotations

from repro_torch._device import check_on_device, resolve_device

from .backproject_subline import (backproject_subline_fused,
                                  backproject_subline_kernel,
                                  fused_batch_ok)

# KernelSpec contract (core.variants.REGISTRY): the call-time options each
# public wrapper consumes. The registry's CUDA KernelSpecs must declare
# exactly these sets; tests cross-check the two layers so a new kernel
# knob cannot be added here without the planner (which filters options
# through KernelSpec.options) learning about it.
ACCEPTED_OPTIONS = {
    "backproject_subline": frozenset({"nb", "block", "proj_loop",
                                      "interpret"}),
}


def _pad_to(n: int, b: int) -> int:
    return ((n + b - 1) // b) * b


def _run_padded(fn, img_t, mat, vol_shape_xyz, block, **kw):
    # Only i/j may be padded: extra voxel LINES are masked by the kernel's
    # bounds checks. nz must never be padded: the symmetry pairing
    # k <-> nz-1-k is defined by the true volume center (the kernel
    # handles odd nz natively via an uneven half-split).
    ni, nj, nz = vol_shape_xyz
    BI, BJ = block
    nip = _pad_to(ni, BI)
    njp = _pad_to(nj, BJ)
    vol = fn(img_t, mat, (nip, njp, nz), block=block, **kw)
    if (nip, njp) != (ni, nj):
        vol = vol[:ni, :nj]
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
    dev = resolve_device(device)
    check_on_device("img_t", img_t, dev)
    check_on_device("mat", mat, dev)
    if fused_batch_ok(img_t.shape[0], nb, proj_loop):
        return _run_padded(backproject_subline_fused, img_t, mat,
                           tuple(vol_shape_xyz), block, nb=nb)
    return _run_padded(backproject_subline_kernel, img_t, mat,
                       tuple(vol_shape_xyz), block)
