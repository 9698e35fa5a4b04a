"""Multi-device back-projection: the reconstruction fleet's step program.

:func:`make_fleet_bp` builds the program each worker of the fleet
(``runtime.executor.PlanExecutor.execute_fleet``) runs for one step. The
JAX package's mesh-sharded back-projection (:func:`make_distributed_bp`,
:func:`distributed_backproject`, a ``shard_map`` over a ``(pod, data,
model)`` mesh) is not ported yet and raises.
"""

from __future__ import annotations

from typing import Optional, Tuple


def make_fleet_bp(variant: str, call_shape: Tuple[int, int, int], *,
                  nb: int, n_chunks: int, chunk_size: int,
                  options=(), interpret: bool = True,
                  rb: Optional[int] = None):
    """Per-device step program for the reconstruction fleet.

    ``prog(img_s, mat_s, origin) -> vol_t(call_shape)`` where ``img_s`` /
    ``mat_s`` are the stacked chunk grids ``(n_chunks, chunk_size, ...)``
    on the worker's device and ``origin`` is the step's sub-box origin
    ``(i0, j0, k_off)``. ``rb`` adds a leading request axis: ``prog(img_b,
    mat_s, origin) -> vol_b((rb,) + call_shape)`` over ``img_b`` of shape
    ``(rb, n_chunks, chunk_size, ...)``, one lane launch a chunk, each
    lane bit-identical to the ``rb=None`` program on that request.

    The body is the single-device step-major program
    (``ProgramCache.scan_program``, or its lane form); the origin folds
    into the matrices' constant column at call time, on the worker's
    device, through the fold the single-device walk makes
    (``runtime.executor.fold_origin``). So ONE program per (variant,
    call_shape, chunk grid) serves every same-shape step on any device,
    a stolen or failed-over step builds nothing, and a fleet step equals
    the same step of the single-device walk bit for bit. ``chunk_size``
    is part of the program's identity only (the grid carries it).
    The fleet runs float32 programs only.
    """
    from repro_torch.runtime.executor import _step_program, fold_origin

    scan = _step_program(variant, call_shape, nb, "float32", interpret,
                         tuple(options), n_chunks, rb=rb)

    def prog(img_s, mat_s, origin):
        return scan(img_s, fold_origin(mat_s, origin))
    return prog


def make_distributed_bp(geom, mesh, *, nb: int = 32, variant: str = "scan"):
    """The JAX package's mesh-sharded back-projection program."""
    from repro_torch.runtime.executor import _unported
    raise _unported("make_distributed_bp", "1c")


def distributed_backproject(projections_t, mats, geom, mesh, *,
                            nb: int = 32, variant: str = "scan"):
    """The JAX package's mesh-sharded reconstruction loop."""
    from repro_torch.runtime.executor import _unported
    raise _unported("distributed_backproject", "1c")
