"""Shared neural-net building blocks, losses and rematerialization.

Conventions (the JAX package's):
  * weights are stored ``(d_in, d_out)`` so ``x @ w`` contracts the minor
    axis of ``x``; a module holds them as plain parameters, so a JAX
    parameter tree carries across without a transpose (``convert``);
  * activations flow in ``cfg.dtype``; normalization statistics, RoPE
    angles and the unembedding run in float32 and cast back;
  * random draws come from an explicit ``torch.Generator`` on the
    parameters' device (the JAX package's ``KeyGen``), in float32, and
    are cast to the parameter dtype;
  * parameters are built with ``requires_grad=False``, so serving records
    no autograd graph; the trainer turns gradients on
    (``launch.train.init_state``).

Training: the losses run in float32 (``cross_entropy``, and
``chunked_cross_entropy``, whose sequence chunks recompute their logits
in backward), and ``remat`` wraps a layer in activation checkpointing
under ``cfg.remat`` (the reference's ``jax.checkpoint`` with
``remat_policy``).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils import checkpoint as _ckpt


def generator(seed: int, device) -> torch.Generator:
    """A seeded generator on ``device`` (CUDA draws need a CUDA one)."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (torch.randn((d_in, d_out), generator=gen, device=gen.device,
                        dtype=torch.float32) * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d_model: int,
               dtype) -> torch.Tensor:
    return (torch.randn((vocab, d_model), generator=gen, device=gen.device,
                        dtype=torch.float32) * 0.02).to(dtype)


def _param(shape, dtype, device) -> nn.Parameter:
    """An uninitialized parameter (``reset_parameters`` fills it), built
    without gradients (training turns them on)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


# --------------------------------------------------------------------------
# normalization
# --------------------------------------------------------------------------

def rms_norm(scale: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def layer_norm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * scale.to(torch.float32) + bias.to(torch.float32)
    return y.to(x.dtype)


class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale``, ``bias``)."""

    def __init__(self, kind: str, d: int, dtype, device=None):
        super().__init__()
        self.kind = kind
        self.scale = _param((d,), dtype, device)
        if kind != "rmsnorm":
            self.bias = _param((d,), dtype, device)

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            if self.kind != "rmsnorm":
                self.bias.zero_()


def apply_norm(kind: str, norm: Norm, x: torch.Tensor) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(norm.scale, x)
    return layer_norm(norm.scale, norm.bias, x)


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim//2,), float32."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x[..., :half], x[..., half:]), NEOX style.

    x: (..., S, n_heads, head_dim); positions: (..., S) integer. The
    angle table is float32; callers compute ``inv_freq`` once a call and
    reuse it in every layer.
    """
    half = inv_freq.shape[0]
    ang = positions[..., None].to(torch.float32) * inv_freq
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.cat([r1, r2], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

class MLP(nn.Module):
    """Gated (``wi_gate``, ``wi_up``, ``wo``: swiglu, geglu) or plain
    (``wi``, ``wo``: gelu) feed-forward block."""

    def __init__(self, d_model: int, d_ff: int, dtype,
                 activation: str = "swiglu", device=None):
        super().__init__()
        self.activation = activation
        if activation in ("swiglu", "geglu"):
            self.wi_gate = _param((d_model, d_ff), dtype, device)
            self.wi_up = _param((d_model, d_ff), dtype, device)
        else:
            self.wi = _param((d_model, d_ff), dtype, device)
        self.wo = _param((d_ff, d_model), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            for name in ("wi_gate", "wi_up", "wi", "wo"):
                w = getattr(self, name, None)
                if w is not None:
                    w.copy_(dense_init(gen, w.shape[0], w.shape[1], w.dtype))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp(params: MLP, x: torch.Tensor, activation: str = "swiglu"):
    from . import pshint
    if activation in ("swiglu", "geglu"):
        act = F.silu if activation == "swiglu" else _gelu
        g = act(pshint.constrain(x @ params.wi_gate, "ffn"))
        u = pshint.constrain(x @ params.wi_up, "ffn")
        return (g * u) @ params.wo
    return _gelu(pshint.constrain(x @ params.wi, "ffn")) @ params.wo


# --------------------------------------------------------------------------
# embeddings / unembedding
# --------------------------------------------------------------------------

def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(table_or_head: torch.Tensor, x: torch.Tensor,
            *, tied: bool) -> torch.Tensor:
    """Logits in float32."""
    w = table_or_head.to(torch.float32)
    xf = x.to(torch.float32)
    if tied:
        return xf @ w.T
    return xf @ w


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def _ce_chunk(hb, table_or_head, lb, tied: bool, softcap: float):
    """(summed NLL, valid count) of one sequence chunk, float32."""
    logits = unembed(table_or_head, hb, tied=tied)      # (B, chunk, V)
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    valid = lb >= 0
    safe = torch.clamp(lb, min=0)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, logz - ll, 0.0)
    return nll.sum(), valid.sum(dtype=torch.float32)


def chunked_cross_entropy(hidden: torch.Tensor, table_or_head: torch.Tensor,
                          labels: torch.Tensor, *, tied: bool,
                          chunk: int = 512,
                          softcap: float = 0.0) -> torch.Tensor:
    """Mean token cross-entropy without the full (B, S, V) logits.

    The sequence runs in chunks of ``chunk``; under autograd each chunk
    runs in a non-reentrant ``torch.utils.checkpoint``, so its (B, chunk,
    V) float32 logits are recomputed in backward rather than kept: the
    peak is O(B chunk V), not O(B S V). Labels of -1 are ignored;
    ``softcap`` caps the logits with ``softcap * tanh(logits / softcap)``.
    """
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, S, chunk):
        args = (hidden[:, c0:c0 + chunk], table_or_head,
                labels[:, c0:c0 + chunk], tied, softcap)
        if torch.is_grad_enabled():
            nll, n = _ckpt.checkpoint(_ce_chunk, *args, use_reentrant=False)
        else:
            nll, n = _ce_chunk(*args)
        nll_sum = nll_sum + nll
        cnt = cnt + n
    return nll_sum / torch.clamp(cnt, min=1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in float32. labels: integer, -1 = ignore;
    ``mask`` > 0 keeps a token."""
    logits = logits.to(torch.float32)
    valid = labels >= 0
    if mask is not None:
        valid = valid & (mask > 0)
    safe = torch.clamp(labels, min=0)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (logz - ll) * valid
    return nll.sum() / torch.clamp(valid.sum(), min=1)


# --------------------------------------------------------------------------
# rematerialization
# --------------------------------------------------------------------------

def remat_policy(cfg) -> Callable:
    """The ``context_fn`` of ``cfg.remat_policy`` for a non-reentrant
    checkpoint: for ``"nothing"`` none (save the layer's inputs only,
    recompute everything: least memory), for ``"dots"`` a selective
    checkpoint that saves the ``mm``/``bmm``/``addmm`` outputs (the
    backward recomputes the elementwise work only)."""
    if getattr(cfg, "remat_policy", "nothing") == "dots":
        aten = torch.ops.aten
        return functools.partial(
            _ckpt.create_selective_checkpoint_contexts,
            [aten.mm.default, aten.bmm.default, aten.addmm.default])
    return _ckpt.noop_context_fn


def remat(cfg, fn: Callable, *args, for_train: bool = True):
    """``fn(*args)``, as a rematerialized layer when ``cfg.remat`` and
    ``for_train`` hold and autograd records: a non-reentrant
    ``torch.utils.checkpoint`` that keeps ``args`` and recomputes the
    layer's activations in backward, under ``remat_policy(cfg)``."""
    if not (cfg.remat and for_train and torch.is_grad_enabled()):
        return fn(*args)
    return _ckpt.checkpoint(fn, *args, use_reentrant=False,
                            context_fn=remat_policy(cfg))
