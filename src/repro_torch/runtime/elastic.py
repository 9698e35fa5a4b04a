"""Elastic re-meshing: continue a run on a different device count.

Parameters are checkpointed as whole tensors (shard-agnostic), the
sharding rules are pure functions of (parameter name, mesh), and the
data pipeline's global batch does not depend on the device count, so a
restart on another mesh is: build the mesh, recompute the specs, lay the
restored tree out. :func:`remesh_plan` picks the new mesh shape;
:func:`reshard_tree` lays the tree out (``launch.sharding``'s
in-process sharded tensors).
"""

from __future__ import annotations

from typing import Tuple

from repro_torch.launch import sharding as shd


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
    """Lay every leaf of ``tree`` out on ``mesh`` by its spec.

    ``tree``: nested mappings whose leaves are tensors or
    ``launch.sharding.ShardedTensor``; ``spec_fn(path, leaf) -> P``, the
    path the keys joined by ``.`` (a parameter's name, as
    ``launch.sharding.spec_for_param`` takes it). Every entry of the mesh
    then holds exactly its block of each leaf, on its own device. A leaf
    already laid out on another mesh or spec is all-gathered onto its
    first entry's device and split anew. Works for a fresh placement and
    for re-placement after an elastic restart. Returns the tree with
    ``ShardedTensor`` leaves.
    """
    def place(prefix, node):
        if isinstance(node, dict):
            return {k: place(f"{prefix}{k}.", v) for k, v in node.items()}
        spec = spec_fn(prefix[:-1], node)
        return shd.lay_out(node, shd.NamedSharding(mesh, spec))

    return place("", tree)
