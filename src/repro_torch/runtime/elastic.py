"""Elastic re-meshing: continue a run on a different device count.

The port carries the pure half of the JAX package's module:
:func:`remesh_plan` picks the ``(data, model)`` shape that fits a device
count. :func:`reshard_tree` places a language model's parameter tree on
a device mesh; it belongs to the LM's parallel layer (ROADMAP.md queue 1
step 2e), which is not ported yet, and raises.
"""

from __future__ import annotations

from typing import Tuple


def remesh_plan(n_devices: int, *, model_parallel: int) -> Tuple[int, ...]:
    """Largest (data, model) mesh fitting n_devices.

    Keeps the model axis fixed (param layouts keep working), shrinks or
    grows the data axis — the elastic dimension. Leftover devices idle
    (spares for the next failure). The reconstruction fleet uses the
    same contract at queue granularity: after a device retires, the
    NEXT run simply partitions the step schedule over the survivors
    (``runtime.planner.partition_steps`` — pure, any shard count).
    """
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if model_parallel < 1:
        raise ValueError(
            f"model_parallel must be >= 1, got {model_parallel}")
    if n_devices < model_parallel:
        # Degraded mode: shrink model axis to the largest power-of-two
        # divisor that fits; params must be re-laid-out from checkpoint.
        mp = 1
        while mp * 2 <= n_devices:
            mp *= 2
        return (n_devices // mp, mp)
    return (n_devices // model_parallel, model_parallel)


def reshard_tree(tree, mesh, spec_fn):
    """The JAX package's placement of an LM parameter tree on a mesh."""
    from repro_torch.runtime.executor import _unported
    raise _unported("reshard_tree (the LM's parallel layer)", "2e")
