"""Gradient machinery: microbatch accumulation and int8 compression.

Accumulation keeps one float32 buffer a parameter live across the
microbatches, so the gradient is reduced once an optimizer step (the
paper's O5, batching to cut write traffic, applied to the gradient
buffer). int8 error-feedback compression quantizes a gradient per
tensor and feeds the residual into the next step. Its all-reduce
(``compressed_psum``) belongs to the LM's parallel layer.
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

    ``grad_shardings`` places the accumulator on a mesh, which is the
    LM's parallel layer: anything but None raises.
    """
    if grad_shardings is not None:
        from repro_torch.runtime.executor import _unported
        raise _unported("accumulate_gradients(grad_shardings=) (the LM's "
                        "parallel layer)", "2e")
    n_micro = next(iter(batches.values())).shape[0]
    acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for n, p in params.items()}
    loss_sum = torch.zeros((), dtype=torch.float32,
                           device=next(iter(params.values())).device)
    for i in range(n_micro):
        loss, g = value_and_grad(loss_fn, params,
                                 {k: v[i] for k, v in batches.items()})
        loss_sum = loss_sum + loss
        for n, gi in g.items():
            acc[n].add_(gi.to(torch.float32))
    inv = 1.0 / n_micro
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


def compressed_psum(g: torch.Tensor, axis_name: str,
                    residual: Optional[torch.Tensor] = None):
    """The JAX package's int8 all-reduce along a mesh axis."""
    from repro_torch.runtime.executor import _unported
    raise _unported("compressed_psum (the LM's parallel layer)", "2e")
