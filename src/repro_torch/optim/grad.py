"""Gradient machinery: microbatch accumulation and int8 compression.

Accumulation keeps one float32 buffer a parameter live across the
microbatches, so the gradient is reduced once an optimizer step (the
paper's O5, batching to cut write traffic, applied to the gradient
buffer). int8 error-feedback compression quantizes a gradient per
tensor and feeds the residual into the next step; ``compressed_psum``
all-reduces it over one axis of an in-process mesh
(``launch.sharding``).
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


def value_and_grad(loss_fn: Callable, params: Tensors, batch
                   ) -> Tuple[torch.Tensor, Tensors]:
    """``loss_fn(batch)`` (a scalar computed from the tensors of
    ``params``, which require grad) and its gradient by name; a
    parameter the loss does not reach gets zeros, as in JAX."""
    loss = loss_fn(batch)
    names = list(params)
    gs = torch.autograd.grad(loss, [params[n] for n in names],
                             allow_unused=True)
    return loss.detach(), {
        n: (torch.zeros_like(params[n]) if g is None else g)
        for n, g in zip(names, gs)}


def accumulate_gradients(loss_fn: Callable, params: Tensors,
                         batches: Mapping[str, torch.Tensor], *,
                         grad_shardings=None) -> Tuple[torch.Tensor,
                                                       Tensors]:
    """Mean loss and float32 mean gradients over the leading microbatch
    axis of ``batches`` (a dict whose tensors are (n_micro, micro_batch,
    ...)): one float32 accumulator a parameter, summed in microbatch
    order, then scaled by 1 / n_micro. ``loss_fn(batch)`` computes the
    loss from the tensors of ``params``.

    ``grad_shardings`` (parameter name -> ``launch.sharding.
    NamedSharding``) keeps the float32 accumulator laid out on a mesh:
    each microbatch's gradient is added into every entry's block
    (``reduce_scatter_add``), and the mean gradients come back as
    ``ShardedTensor``s. The sums run in the same order, so their values
    equal the unsharded accumulator's bit for bit. The gradients need not
    follow the parameters' own layout (ZeRO-1 keeps TP-only hot weights
    beside a fully sharded float32 buffer).
    """
    from repro_torch.launch import sharding as shd

    n_micro = next(iter(batches.values())).shape[0]
    if grad_shardings is None:
        acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in params.items()}
    else:
        acc = {n: shd.ShardedTensor.zeros(p.shape, torch.float32,
                                          grad_shardings[n])
               for n, p in params.items()}
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=next(iter(params.values())).device)
    for i in range(n_micro):
        loss, g = value_and_grad(loss_fn, params,
                                 {k: v[i] for k, v in batches.items()})
        loss_sum = loss_sum + loss
        for n, gi in g.items():
            if grad_shardings is None:
                acc[n].add_(gi.to(torch.float32))
            else:
                shd.reduce_scatter_add(acc[n], gi, record=i == 0)
        del g
    inv = 1.0 / n_micro
    if grad_shardings is not None:
        for a in acc.values():
            for b in a.blocks:
                b.mul_(inv)
        return loss_sum * inv, acc
    return loss_sum * inv, {n: a * inv for n, a in acc.items()}


# --------------------------------------------------------------------------
# int8 error-feedback compression
# --------------------------------------------------------------------------

def compress_int8(g: torch.Tensor, residual: Optional[torch.Tensor] = None):
    """Symmetric per-tensor int8 quantization with error feedback.

    Returns (q int8, scale float32 scalar, new residual float32).
    """
    gf = g.to(torch.float32)
    if residual is not None:
        gf = gf + residual
    amax = torch.max(torch.abs(gf))
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, gf - deq


def decompress_int8(q: torch.Tensor, scale) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(g: Mapping[int, torch.Tensor], mesh, axis_name: str,
                    residual: Optional[Mapping[int, torch.Tensor]] = None):
    """All-reduce an int8-compressed gradient along one mesh axis.

    The reference's call, ``compressed_psum(g, axis_name, residual)``
    inside a ``shard_map``, sees one member's ``g``; the port's mesh is
    driven by this thread, so ``g`` maps every entry of ``mesh`` (its
    flat index) to that member's tensor, and ``residual`` likewise (or
    None). Every member compresses with :func:`compress_int8`; the scale
    is the maximum over the members along ``axis_name``, the int8 values
    are summed in int32 in axis order, and every member gets the
    rescaled total, float32 on its device. Returns ``(total, new
    residual)``, each a mapping entry -> tensor; the residual is each
    member's own (against its own scale, as in the reference). The wire
    format is int8: 4x fewer bytes than float32.

    As in the reference, the total rescales every member's int8 values
    by the axis maximum: it is within n_members x scale / 2 of the exact
    sum where the members share their scale.
    """
    from repro_torch.launch import sharding as shd

    comp = {e: compress_int8(t, None if residual is None else residual[e])
            for e, t in g.items()}
    total, new_res = {}, {}
    others = [a for a in mesh.axis_names if a != axis_name]
    for e in shd.replicas(mesh, others):
        members = shd.group(mesh, e, others)
        dev = mesh.devices[members[0]]
        q0 = comp[members[0]][0]
        nbytes = q0.numel() * len(members)    # int8 on the wire
        with shd.collective("all-reduce", nbytes):
            scale = torch.stack([comp[m][1].to(dev) for m in members]).max()
            acc = torch.zeros(q0.shape, dtype=torch.int32, device=dev)
            for m in members:
                acc += comp[m][0].to(device=dev, dtype=torch.int32)
            tot = acc.to(torch.float32) * scale
        for m in members:
            total[m] = tot.to(mesh.devices[m], copy=True)
            new_res[m] = comp[m][2]
    return total, new_res
