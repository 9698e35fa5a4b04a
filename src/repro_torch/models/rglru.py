"""RG-LRU recurrent blocks (Griffin / RecurrentGemma, arXiv:2402.19427).

Recurrence:  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
with a_t = exp(-c * softplus(Lambda) * r_t), c = 8, and per-channel gates
r_t, i_t produced by block-diagonal projections (num_heads blocks).

The reference evaluates the sequence with a log-depth associative scan;
the port runs the recurrence step by step in float32 (the same products,
summed in time order: within 1e-5 of the reference at the test sizes).
Decode is a single step carrying (h, conv tail). A short causal
depthwise conv (width 4) completes the temporal-mixing block.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from .layers import _gelu, _param, dense_init

_C = 8.0


class RGLRU(nn.Module):
    """``w_in_x``/``w_in_g`` (d, W), ``conv_w`` (cw, W), ``conv_b``,
    block-diagonal gates ``w_a``/``w_x`` (heads, bw, bw) with ``b_a``/
    ``b_x``, ``lam`` (W) and ``w_out`` (W, d)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, w, nh, dt = cfg.d_model, cfg.lru_width, cfg.n_heads, cfg.np_dtype
        bw = w // nh
        self.w_in_x = _param((d, w), dt, device)
        self.w_in_g = _param((d, w), dt, device)
        self.conv_w = _param((cfg.conv_width, w), dt, device)
        self.conv_b = _param((w,), dt, device)
        self.w_a = _param((nh, bw, bw), dt, device)
        self.b_a = _param((w,), dt, device)
        self.w_x = _param((nh, bw, bw), dt, device)
        self.b_x = _param((w,), dt, device)
        self.lam = _param((w,), dt, device)
        self.w_out = _param((w, d), dt, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The reference's order and distributions: ``conv_w`` N(0, 0.1),
        ``lam`` linspace(2, 6) (a ~ U(0.9, 0.999) at init), zero biases."""
        def dense(w):
            w.copy_(dense_init(gen, w.shape[0], w.shape[1], w.dtype))

        with torch.no_grad():
            dense(self.w_in_x)
            dense(self.w_in_g)
            self.conv_w.copy_(torch.randn(
                self.conv_w.shape, generator=gen, device=gen.device,
                dtype=torch.float32) * 0.1)
            self.conv_b.zero_()
            for name in ("w_a", "w_x"):
                for h in getattr(self, name):
                    dense(h)
            self.b_a.zero_()
            self.b_x.zero_()
            self.lam.copy_(torch.linspace(2.0, 6.0, self.lam.shape[0],
                                          device=self.lam.device))
            dense(self.w_out)


def init_rglru(gen: Optional[torch.Generator], cfg, device=None) -> RGLRU:
    p = RGLRU(cfg, device)
    if gen is not None:
        p.reset_parameters(gen)
    return p


def _block_diag(x, w, nh):
    """x (..., W) @ blockdiag(w): w (nh, bw, bw)."""
    shp = x.shape
    xb = x.reshape(*shp[:-1], nh, shp[-1] // nh)
    return torch.einsum("...nb,nbc->...nc", xb, w).reshape(shp)


def _gates(p: RGLRU, x, nh):
    r = torch.sigmoid(_block_diag(x, p.w_a, nh) + p.b_a)
    i = torch.sigmoid(_block_diag(x, p.w_x, nh) + p.b_x)
    log_a = -_C * F.softplus(p.lam.to(torch.float32)) * r.to(torch.float32)
    a = torch.exp(log_a)
    # multiplier on the input branch; a^2 from log-space for stability
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta, i.to(torch.float32)


def rglru_scan(p: RGLRU, x: torch.Tensor, cfg, h0=None):
    """x: (B, S, W). Returns (y (B,S,W) in x.dtype, h_last (B,W) float32).

    ``h0`` (B, W) float32 is the carried state (None: zeros).
    """
    B, S, W = x.shape
    a, beta, i = _gates(p, x, cfg.n_heads)
    b = beta * i * x.to(torch.float32)
    h = (torch.zeros((B, W), dtype=torch.float32, device=x.device)
         if h0 is None else h0.to(torch.float32))
    hs = []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype), h


def rglru_step(p: RGLRU, x_t: torch.Tensor, h: torch.Tensor, cfg):
    """Single decode step. x_t: (B, W); h: (B, W) float32."""
    a, beta, i = _gates(p, x_t[:, None], cfg.n_heads)
    a, beta, i = a[:, 0], beta[:, 0], i[:, 0]
    h_new = a * h + beta * i * x_t.to(torch.float32)
    return h_new.to(x_t.dtype), h_new


def causal_conv(p: RGLRU, x: torch.Tensor, tail=None):
    """Depthwise causal conv, width cw. x: (B,S,W); tail: (B,cw-1,W).

    Returns (y (B,S,W), new_tail (B,cw-1,W)).
    """
    cw = p.conv_w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], cw - 1, x.shape[2]))
    xp = torch.cat([tail.to(x.dtype), x], dim=1)         # (B, S+cw-1, W)
    S = x.shape[1]
    y = sum(xp[:, k:k + S] * p.conv_w[k] for k in range(cw))
    y = y + p.conv_b
    return y.to(x.dtype), xp[:, -(cw - 1):]


def recurrent_block_seq(p: RGLRU, x: torch.Tensor, cfg, state=None):
    """The Griffin recurrent temporal block, sequence mode.

    x: (B, S, d_model). state: None or {"h": (B,W), "conv": (B,cw-1,W)}.
    Returns (out (B,S,d_model), new_state).
    """
    gate = _gelu(x @ p.w_in_g)
    xb = x @ p.w_in_x
    xb, tail = causal_conv(p, xb, state["conv"] if state else None)
    h, h_last = rglru_scan(p, xb, cfg, h0=state["h"] if state else None)
    out = (h * gate) @ p.w_out
    return out, {"h": h_last, "conv": tail}


def recurrent_block_step(p: RGLRU, x_t: torch.Tensor, cfg, state):
    """Decode step. x_t: (B, 1, d_model). Returns (out (B,1,d), state)."""
    xt = x_t[:, 0]
    gate = _gelu(xt @ p.w_in_g)
    xb = xt @ p.w_in_x
    cw = p.conv_w.shape[0]
    xcat = torch.cat([state["conv"].to(xb.dtype), xb[:, None]], dim=1)
    y = sum(xcat[:, k] * p.conv_w[k] for k in range(cw)) + p.conv_b
    h_out, h_new = rglru_step(p, y.to(xb.dtype), state["h"], cfg)
    out = (h_out * gate) @ p.w_out
    return out[:, None], {"h": h_new, "conv": xcat[:, 1:]}
