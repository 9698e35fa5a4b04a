"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free time-mix with
data-dependent decay, plus squared-ReLU channel-mix.

Time-mix core (per head, head_size hd):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T          (state: hd x hd, float32)
    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

with w_t = exp(-exp(decay_t)) data-dependent per channel, u the "bonus"
for the current token, and the v6 ddlerp token-shift (a LoRA on the
interpolation between x_t and x_{t-1}) producing the five mix inputs.
Sequence mode loops over time carrying S; decode is the same body on a
single step.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils import checkpoint as _ckpt

from .layers import _param, dense_init

_MAA = ("maa_x", "maa_w", "maa_k", "maa_v", "maa_r", "maa_g")


def _u01(gen, shape, device):
    return torch.rand(shape, generator=gen, device=device,
                      dtype=torch.float32) * 0.5 + 0.25


def _normal(gen, shape, device, scale, shift=0.0):
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32) * scale + shift


class TimeMix(nn.Module):
    """The time mix's weights, under the reference's names."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, hd, dt = cfg.d_model, cfg.rwkv_head_size, cfg.np_dtype
        dd, wd = cfg.rwkv_ddlora, cfg.rwkv_decay_lora
        for name in _MAA:
            setattr(self, name, _param((d,), dt, device))
        self.maa_w1 = _param((d, 5 * dd), dt, device)
        self.maa_w2 = _param((5, dd, d), dt, device)
        self.decay = _param((d,), dt, device)
        self.decay_w1 = _param((d, wd), dt, device)
        self.decay_w2 = _param((wd, d), dt, device)
        self.bonus = _param((d // hd, hd), dt, device)
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, _param((d, d), dt, device))
        self.ln_x_scale = _param((d,), dt, device)
        self.ln_x_bias = _param((d,), dt, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        dev = gen.device

        def dense(w, scale=None):
            w.copy_(dense_init(gen, w.shape[0], w.shape[1], w.dtype, scale))

        with torch.no_grad():
            for name in _MAA:
                w = getattr(self, name)
                w.copy_(_u01(gen, w.shape, dev))
            dense(self.maa_w1, 0.01)
            self.maa_w2.copy_(_normal(gen, self.maa_w2.shape, dev, 0.01))
            self.decay.copy_(_normal(gen, self.decay.shape, dev, 0.5, -4.0))
            dense(self.decay_w1, 0.01)
            dense(self.decay_w2, 0.01)
            self.bonus.copy_(_normal(gen, self.bonus.shape, dev, 0.1))
            for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
                dense(getattr(self, name))
            self.ln_x_scale.fill_(1.0)
            self.ln_x_bias.zero_()


class ChannelMix(nn.Module):
    """``maa_k``, ``maa_r``, ``w_k`` (d, ff), ``w_v`` (ff, d), ``w_r``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, ff, dt = cfg.d_model, cfg.d_ff, cfg.np_dtype
        self.maa_k = _param((d,), dt, device)
        self.maa_r = _param((d,), dt, device)
        self.w_k = _param((d, ff), dt, device)
        self.w_v = _param((ff, d), dt, device)
        self.w_r = _param((d, d), dt, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            for name in ("maa_k", "maa_r"):
                w = getattr(self, name)
                w.copy_(_u01(gen, w.shape, gen.device))
            for name in ("w_k", "w_v", "w_r"):
                w = getattr(self, name)
                w.copy_(dense_init(gen, w.shape[0], w.shape[1], w.dtype))


def init_time_mix(gen: Optional[torch.Generator], cfg,
                  device=None) -> TimeMix:
    p = TimeMix(cfg, device)
    if gen is not None:
        p.reset_parameters(gen)
    return p


def init_channel_mix(gen: Optional[torch.Generator], cfg,
                     device=None) -> ChannelMix:
    p = ChannelMix(cfg, device)
    if gen is not None:
        p.reset_parameters(gen)
    return p


def _ddlerp(p: TimeMix, x, sx):
    """v6 data-dependent token-shift: five mixed variants of x.

    x, sx: (B, T, d) with sx = x_{t-1} - x_t. Returns (xw,xk,xv,xr,xg).
    """
    xxx = x + sx * p.maa_x
    a = torch.tanh(xxx @ p.maa_w1)                       # (B,T,5*dd)
    B_, T_, _ = a.shape
    a = a.reshape(B_, T_, 5, p.maa_w2.shape[1])
    m = torch.einsum("btfd,fdo->btfo", a, p.maa_w2)     # (B,T,5,d)
    return tuple(x + sx * (getattr(p, name) + m[:, :, i])
                 for i, name in enumerate(_MAA[1:]))


def _group_norm(p: TimeMix, y, H, hd):
    """Per-head LayerNorm of the wkv output. y: (B,T,H,hd); float32."""
    yf = y.to(torch.float32)
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, unbiased=False)
    yn = (yf - mu) * torch.rsqrt(var + 64e-5)
    yn = yn.reshape(*y.shape[:-2], H * hd)
    return yn * p.ln_x_scale.to(torch.float32) + \
        p.ln_x_bias.to(torch.float32)


def _wkv6_steps(S, rf, kf, vf, wf, uf):
    """The recurrence over the steps of rf..wf (B,T,H,hd) from state S."""
    ys = []
    for t in range(rf.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]    # (B,H,hd,hd)
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, t], S + uf * kv))
        S = wf[:, t, :, :, None] * S + kv
    return torch.stack(ys, dim=1), S


def wkv6_scan(r, k, v, w, u, S0=None, *, chunk: int = 128):
    """The WKV-6 recurrence over a sequence, stepped in time order.

    r,k,v,w: (B,T,H,hd); u: (H,hd); S0: (B,H,hd,hd) float32 or None.
    Returns (y (B,T,H,hd) float32, S_last). Under autograd, as in the
    reference, each chunk of ``chunk`` steps is rematerialized (a
    non-reentrant checkpoint) when ``chunk`` divides T, so backward keeps
    the chunks' boundary states, not one (B,H,hd,hd) state a step;
    forward, every chunking runs the same steps in the same order.
    """
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    B, T, H, hd = r.shape
    rf, kf, vf, wf = (t.to(torch.float32) for t in (r, k, v, w))
    uf = u.to(torch.float32)[None, :, :, None]
    S = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if S0 is None else S0.to(torch.float32))
    chunk = min(chunk, T)
    if not torch.is_grad_enabled() or T % chunk:
        return _wkv6_steps(S, rf, kf, vf, wf, uf)
    ys = []
    for c0 in range(0, T, chunk):
        y, S = _ckpt.checkpoint(
            _wkv6_steps, S, *(t[:, c0:c0 + chunk] for t in (rf, kf, vf, wf)),
            uf, use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=1), S


def _shifted(x, prev):
    """x_{t-1} for every t: ``prev`` (B, d) or zeros before the first."""
    B, _, d = x.shape
    first = prev[:, None].to(x.dtype) if prev is not None \
        else x.new_zeros((B, 1, d))
    return torch.cat([first, x[:, :-1]], dim=1)


def time_mix_seq(p: TimeMix, x: torch.Tensor, cfg, state=None):
    """x: (B,T,d). state: None or {"S": (B,H,hd,hd), "x_tm": (B,d)}.

    Returns (out (B,T,d), {"S": S_last, "x_tm": the last x}).
    """
    B, T, d = x.shape
    hd = cfg.rwkv_head_size
    H = d // hd
    sx = _shifted(x, state["x_tm"] if state else None) - x
    xw, xk, xv, xr, xg = _ddlerp(p, x, sx)
    r = (xr @ p.w_r).reshape(B, T, H, hd)
    k = (xk @ p.w_k).reshape(B, T, H, hd)
    v = (xv @ p.w_v).reshape(B, T, H, hd)
    g = F.silu(xg @ p.w_g)
    decay = p.decay.to(torch.float32) + \
        (torch.tanh(xw @ p.decay_w1) @ p.decay_w2).to(torch.float32)
    wt = torch.exp(-torch.exp(decay)).reshape(B, T, H, hd)
    y, S_last = wkv6_scan(r, k, v, wt, p.bonus.to(torch.float32),
                          state["S"] if state else None)
    y = _group_norm(p, y, H, hd).to(x.dtype)
    out = (y * g) @ p.w_o
    return out, {"S": S_last, "x_tm": x[:, -1]}


def channel_mix_seq(p: ChannelMix, x: torch.Tensor, state=None):
    """Squared-ReLU channel mix. state: {"x_cm": (B,d)} or None."""
    sx = _shifted(x, state["x_cm"] if state else None) - x
    xk = x + sx * p.maa_k
    xr = x + sx * p.maa_r
    kk = torch.square(torch.relu(xk @ p.w_k))
    out = torch.sigmoid(xr @ p.w_r) * (kk @ p.w_v)
    return out, {"x_cm": x[:, -1]}
