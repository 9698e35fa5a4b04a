"""AdamW (decoupled weight decay) over parameters keyed by name.

The state is float32 whatever the parameters' dtype (the mixed-precision
discipline of the JAX package), keyed by the module's parameter names
(``named_parameters()``), so a checkpoint names every leaf. Updates run
in place under ``no_grad``: the parameters, ``m`` and ``v`` keep their
storage (a bf16 model's 12.4 GB of moments are not copied each step).
``torch.optim.AdamW`` is not used: it keeps its moments in the
parameter's dtype, decays every tensor and rounds in another order.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor        # int32 scalar on the parameters' device
    m: Tensors
    v: Tensors


def adamw_init(params: Tensors) -> AdamWState:
    """Zero float32 moments beside each parameter, step 0."""
    dev = next(iter(params.values())).device
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros, v={n: z.clone() for n, z in zeros.items()})


@torch.no_grad()
def adamw_update(params: Tensors, grads: Tensors, state: AdamWState, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 decay: Optional[Mapping[str, bool]] = None
                 ) -> Tuple[Tensors, AdamWState]:
    """One AdamW step, in place. ``lr`` may be a tensor (the schedule's).

    Per parameter, in float32 and the reference's order: ``m = b1 m +
    (1-b1) g``, ``v = b2 v + (1-b2) g^2``, ``delta = mhat / (sqrt(vhat) +
    eps)``, plus ``weight_decay * p`` where ``decay[name]`` holds (by
    default, for tensors of ``ndim >= 2``: no decay on norms and biases),
    then ``p - lr delta`` cast back to the parameter's dtype. Returns
    ``(params, new state)``: the same tensors, updated, and the state
    with ``step + 1``.
    """
    step = state.step + 1
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)
    for name, p in params.items():
        gf = grads[name].to(torch.float32)
        m, v = state.m[name], state.v[name]
        m.copy_(b1 * m + (1.0 - b1) * gf)
        v.copy_(b2 * v + (1.0 - b2) * gf * gf)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        pf = p.to(torch.float32)
        if (p.ndim >= 2) if decay is None else decay[name]:
            delta = delta + weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))
    return params, AdamWState(step=step, m=state.m, v=state.v)


@torch.no_grad()
def clip_by_global_norm(grads: Tensors, max_norm: float
                        ) -> Tuple[Tensors, torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / global norm)``, in
    place (each rounded back to its dtype). Returns (grads, the global
    norm, a float32 scalar tensor)."""
    sq = torch.zeros((), dtype=torch.float32,
                     device=next(iter(grads.values())).device)
    for g in grads.values():
        sq = sq + torch.sum(g.to(torch.float32) ** 2)
    gn = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    for g in grads.values():
        g.copy_((g.to(torch.float32) * scale).to(g.dtype))
    return grads, gn


@torch.no_grad()
def sgd_update(params: Tensors, grads: Tensors, *, lr) -> Tensors:
    """``p - lr g`` in float32, cast back, in place."""
    for name, p in params.items():
        p.copy_((p.to(torch.float32)
                 - lr * grads[name].to(torch.float32)).to(p.dtype))
    return params
