"""Mixture-of-Experts: top-k routing with capacity-based dispatch.

The JAX package's GShard/Switch formulation, kept as it is: tokens are
routed in fixed-size groups, each expert takes at most ``capacity``
assignments a group, and dispatch and combine are dense contractions
over ``(G, Sg, E, C)``. So the same assignments are dropped as in the
reference, and every expert's weights are read on every call (a gathered
dispatch is performance work, ROADMAP.md queue 2).

Shared experts (DeepSeek-V2) are always-on MLPs added to the routed
output. The Switch load-balance auxiliary loss is returned as the
reference returns it (the trainer reads it, step 2c).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from .layers import _param, dense_init


class SharedExperts(nn.Module):
    """``num_shared`` SwiGLU MLPs stacked on a leading axis."""

    def __init__(self, n: int, d: int, ff: int, dtype, device=None):
        super().__init__()
        self.wi_gate = _param((n, d, ff), dtype, device)
        self.wi_up = _param((n, d, ff), dtype, device)
        self.wo = _param((n, ff, d), dtype, device)


class MoE(nn.Module):
    """The routed experts ``wi_gate``/``wi_up`` (E, d, ff), ``wo``
    (E, ff, d), the ``router`` (d, E) and, with ``num_shared``, the
    ``shared`` experts."""

    def __init__(self, cfg, device=None):
        super().__init__()
        m = cfg.moe
        d, ff, E, dt = cfg.d_model, m.d_ff_expert, m.num_experts, \
            cfg.np_dtype
        self.router = _param((d, E), dt, device)
        self.wi_gate = _param((E, d, ff), dt, device)
        self.wi_up = _param((E, d, ff), dt, device)
        self.wo = _param((E, ff, d), dt, device)
        if m.num_shared:
            self.shared = SharedExperts(m.num_shared, d,
                                        m.d_ff_shared or ff, dt, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """One draw an expert matrix, in the reference's order."""
        with torch.no_grad():
            self.router.copy_(dense_init(gen, *self.router.shape,
                                         self.router.dtype, scale=0.02))
            mods = [self] + ([self.shared] if hasattr(self, "shared")
                             else [])
            for mod in mods:
                for name in ("wi_gate", "wi_up", "wo"):
                    w = getattr(mod, name)
                    for e in range(w.shape[0]):
                        w[e].copy_(dense_init(gen, w.shape[1], w.shape[2],
                                              w.dtype))


def init_moe(gen: Optional[torch.Generator], cfg, device=None) -> MoE:
    p = MoE(cfg, device)
    if gen is not None:
        p.reset_parameters(gen)
    return p


def _top_k(probs: torch.Tensor, k: int):
    """The k largest of the last axis and their indices, largest first;
    equal values keep the lower index first, as the reference's
    ``lax.top_k`` does (the zero rows that pad a group tie on every
    expert, and ``torch.topk`` orders ties otherwise)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _routing(logits: torch.Tensor, top_k: int, capacity: int):
    """(combine, dispatch, aux) of router logits (..., T, E).

    combine: (..., T, E, C) float32 routing weights; dispatch: the same
    shape, boolean. An assignment's place in its expert's queue counts
    the earlier assignments in token-major, then k, order; one past the
    capacity is dropped. aux is the Switch loss, one per leading index.
    """
    *lead, T, E = logits.shape
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    top_p, top_i = _top_k(probs, top_k)                      # (..., T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    onehot = F.one_hot(top_i, E).to(torch.float32)           # (..., T, k, E)
    flat = onehot.reshape(*lead, T * top_k, E)
    pos = torch.cumsum(flat, dim=-2) - 1.0
    pos_in_e = (pos * flat).sum(-1).reshape(*lead, T, top_k)
    keep = pos_in_e < capacity

    pos_c = torch.clamp(pos_in_e, 0, capacity - 1).to(torch.int64)
    cap_oh = F.one_hot(pos_c, capacity).to(torch.float32)   # (..., T, k, C)
    w = ((top_p * keep)[..., None, None] * onehot[..., None]
         * cap_oh[..., None, :])                             # (..., T,k,E,C)
    combine = w.sum(dim=-3)                                  # (..., T, E, C)
    dispatch = combine > 0

    me = probs.mean(dim=-2)                                  # (..., E)
    ce = onehot.sum(dim=-2).mean(dim=-2)                     # (..., E)
    aux = E * torch.sum(me * ce, dim=-1) / top_k
    return combine, dispatch, aux


def _expert_mlp(wi_gate, wi_up, wo, xin):
    """xin: (..., E, C, d) -> (..., E, C, d), per-expert SwiGLU."""
    g = F.silu(torch.einsum("...ecd,edf->...ecf", xin, wi_gate))
    u = torch.einsum("...ecd,edf->...ecf", xin, wi_up)
    return torch.einsum("...ecf,efd->...ecd", g * u, wo)


def group_capacity(cfg, n_tokens: int) -> Tuple[int, int]:
    """(group size, per-group capacity) of a call on ``n_tokens``."""
    m = cfg.moe
    group = min(getattr(m, "group_size", 4096) or 4096, n_tokens)
    return group, max(1, int(m.capacity_factor * group * m.top_k
                             / m.num_experts))


def moe_mlp(p: MoE, x: torch.Tensor, cfg, *, stats: Optional[dict] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss, a float32 scalar).

    ``stats``, when given, gains the call's routed assignments
    (``"assigned"``, T * k) and those the capacity dropped
    (``"dropped"``), as tensors on x's device.
    """
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    group, capacity = group_capacity(cfg, T)
    pad = (-T) % group
    if pad:
        xt = torch.cat([xt, xt.new_zeros((pad, d))], dim=0)
    G = xt.shape[0] // group
    xg = xt.reshape(G, group, d)
    logits = xg @ p.router                                   # (G, Sg, E)
    combine, dispatch, aux = _routing(logits, m.top_k, capacity)
    aux = aux.mean()
    if stats is not None:
        kept = dispatch.reshape(G * group, -1)[:T].sum()
        stats["assigned"] = stats.get("assigned", 0) + T * m.top_k
        stats["dropped"] = stats.get("dropped", 0) + (T * m.top_k - kept)
    xin = torch.einsum("gsec,gsd->gecd", dispatch.to(xg.dtype), xg)
    out_e = _expert_mlp(p.wi_gate, p.wi_up, p.wo, xin)
    out = torch.einsum("gsec,gecd->gsd", combine.to(xg.dtype), out_e)
    out = out.reshape(-1, d)
    if m.num_shared:
        sh = p.shared
        g = F.silu(torch.einsum("td,ndf->ntf", xt, sh.wi_gate))
        u = torch.einsum("td,ndf->ntf", xt, sh.wi_up)
        out = out + torch.einsum("ntf,nfd->td", g * u, sh.wo)
    if pad:
        out = out[:T]
    return out.reshape(B, S, d), aux
