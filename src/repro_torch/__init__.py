"""Cone-beam back-projection and FDK reconstruction in PyTorch and CUDA.

The PyTorch port of the ``repro`` package, for an NVIDIA H100. Top level
of the public API:

    import repro_torch
    vol = repro_torch.reconstruct(projections, geom, method="fdk",
                                  options=repro_torch.ReconOptions(
                                      variant="subline_pl"))

Every entry point runs on the CUDA card unless the caller passes
``device="cpu"``; without a card and without that argument it raises.

Everything resolves lazily (PEP 562) so ``import repro_torch`` stays
cheap: torch and the kernel registry only load when a symbol is first
touched.
"""

from typing import TYPE_CHECKING

_LAZY = {
    "reconstruct": ("repro_torch.api", "reconstruct"),
    "ReconOptions": ("repro_torch.api", "ReconOptions"),
    "fdk_reconstruct": ("repro_torch.core.fdk", "fdk_reconstruct"),
    "sart_step": ("repro_torch.core.fdk", "sart_step"),
    "CTGeometry": ("repro_torch.core.geometry", "CTGeometry"),
    "standard_geometry": ("repro_torch.core.geometry", "standard_geometry"),
    "forward_project": ("repro_torch.core.forward", "forward_project"),
    "solve": ("repro_torch.runtime.solvers", "solve"),
    "SolveReport": ("repro_torch.runtime.solvers", "SolveReport"),
    "IterativeExecutor": ("repro_torch.runtime.solvers",
                          "IterativeExecutor"),
    "TiledReconstructor": ("repro_torch.runtime.engine",
                           "TiledReconstructor"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    try:
        module, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    value = getattr(importlib.import_module(module), attr)
    globals()[name] = value    # cache: next access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))


if TYPE_CHECKING:   # static importers see the real symbols
    from repro_torch.api import ReconOptions, reconstruct  # noqa: F401
    from repro_torch.core.fdk import fdk_reconstruct, sart_step  # noqa: F401
    from repro_torch.core.forward import forward_project  # noqa: F401
    from repro_torch.core.geometry import (  # noqa: F401
        CTGeometry, standard_geometry)
    from repro_torch.runtime.engine import TiledReconstructor  # noqa: F401
    from repro_torch.runtime.solvers import (  # noqa: F401
        IterativeExecutor, SolveReport, solve)
