"""Decoder-only transformer assembly: the dense family.

The stack is an ``nn.ModuleList`` of :class:`Block`; parameters keep the
JAX package's names (``embed``, ``ln_f``, ``layers.{l}.attn.wq``, ...,
``unembed``) with the layer index where the reference stacks a leading
layer axis, so its parameter tree carries across
(``repro_torch.convert.lm_params_from_reference``). The layer-invariant
RoPE table is computed once a call and shared by every layer. The JAX
package's sharding hints (``pshint.constrain``) are no-ops on one device
and have no counterpart here; the LM's parallel layer is ROADMAP.md
queue 1 step 2e. MoE layers and MLA attention are step 2a.

The parameters do not require gradients, so nothing here records an
autograd graph: the training half (loss, rematerialization, backward) is
step 2c.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import attention as attn
from .layers import (MLP, Norm, _param, apply_norm, dense_init, embed,
                     embed_init, mlp, rope_freqs, unembed)


def _refuse_moe_mla(cfg) -> None:
    if cfg.moe is not None or cfg.mla is not None:
        from repro_torch.runtime.executor import _unported
        raise _unported(f"{cfg.name}: MoE layers and MLA attention", "2a")


# --------------------------------------------------------------------------
# modules and init
# --------------------------------------------------------------------------

class Block(nn.Module):
    """One decoder layer: pre-norm GQA attention, then a pre-norm MLP."""

    def __init__(self, cfg, device=None):
        super().__init__()
        _refuse_moe_mla(cfg)
        dt = cfg.np_dtype
        self.ln_attn = Norm(cfg.norm, cfg.d_model, dt, device)
        self.ln_mlp = Norm(cfg.norm, cfg.d_model, dt, device)
        self.attn = attn.GQA(cfg, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, cfg.activation, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.ln_attn.reset_parameters()
        self.ln_mlp.reset_parameters()
        self.attn.reset_parameters(gen)
        self.mlp.reset_parameters(gen)


class TransformerLM(nn.Module):
    """The dense stack's parameters: ``embed`` (V, d), ``ln_f``,
    ``layers`` and, untied, ``unembed`` (d, V)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        _refuse_moe_mla(cfg)
        self.cfg = cfg
        dt = cfg.np_dtype
        self.embed = _param((cfg.vocab_size, cfg.d_model), dt, device)
        self.ln_f = Norm(cfg.norm, cfg.d_model, dt, device)
        self.layers = nn.ModuleList(
            [Block(cfg, device) for _ in range(cfg.n_layers)])
        if not cfg.tie_embeddings:
            self.unembed = _param((cfg.d_model, cfg.vocab_size), dt, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Draw every weight from ``gen`` (on the parameters' device), in
        the JAX package's order and distributions."""
        cfg = self.cfg
        with torch.no_grad():
            self.embed.copy_(embed_init(gen, cfg.vocab_size, cfg.d_model,
                                        self.embed.dtype))
            self.ln_f.reset_parameters()
            for block in self.layers:
                block.reset_parameters(gen)
            if not cfg.tie_embeddings:
                self.unembed.copy_(dense_init(
                    gen, cfg.d_model, cfg.vocab_size, self.unembed.dtype,
                    scale=0.02))


def init_block(gen: Optional[torch.Generator], cfg, *,
               use_moe: bool = False, device=None) -> Block:
    if use_moe:
        from repro_torch.runtime.executor import _unported
        raise _unported("MoE layers", "2a")
    block = Block(cfg, device)
    if gen is not None:
        block.reset_parameters(gen)
    return block


def init_lm(gen: Optional[torch.Generator], cfg,
            device=None) -> TransformerLM:
    """The dense stack on ``device``, drawn from ``gen`` (None leaves the
    parameters unset: the ``meta`` device's abstract model)."""
    lm = TransformerLM(cfg, device)
    if gen is not None:
        lm.reset_parameters(gen)
    return lm


# --------------------------------------------------------------------------
# sequence mode (forward / prefill)
# --------------------------------------------------------------------------

def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device).expand(B, S)


def forward_embeds(params: TransformerLM, x: torch.Tensor, cfg, positions,
                   *, collect_cache: bool = False):
    """Run the layer stack on embedded inputs x (B, S, d).

    Returns (hidden, aux_loss, caches|None). Collected caches are
    ``(None, (k, v))`` with k, v stacked on a leading layer axis
    ``(L, B, S, KVH, hd)`` (the reference's ``(lead, stack)`` pair; the
    dense family has no lead layers).
    """
    inv_freq = rope_freqs(cfg.head_dim_, cfg.rope_theta, x.device)
    ks, vs = [], []
    for block in params.layers:
        h = apply_norm(cfg.norm, block.ln_attn, x)
        out, (k, v) = attn.gqa_prefill(block.attn, h, cfg, positions,
                                       inv_freq)
        x = x + out
        h = apply_norm(cfg.norm, block.ln_mlp, x)
        x = x + mlp(block.mlp, h, cfg.activation)
        if collect_cache:
            ks.append(k)
            vs.append(v)
    x = apply_norm(cfg.norm, params.ln_f, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if collect_cache:
        return x, aux, (None, (torch.stack(ks), torch.stack(vs)))
    return x, aux, None


def logits_from_hidden(params: TransformerLM, x: torch.Tensor,
                       cfg) -> torch.Tensor:
    if cfg.tie_embeddings:
        return unembed(params.embed, x, tied=True)
    return unembed(params.unembed, x, tied=False)


def lm_forward(params: TransformerLM, tokens: torch.Tensor, cfg):
    """tokens (B, S) -> (logits (B,S,V) float32, aux_loss)."""
    B, S = tokens.shape
    x = embed(params.embed, tokens)
    x, aux, _ = forward_embeds(params, x, cfg,
                               _positions(B, S, tokens.device))
    return logits_from_hidden(params, x, cfg), aux


def lm_prefill(params: TransformerLM, tokens: torch.Tensor, cfg,
               max_len: int):
    """Prefill: returns (last-position logits, cache dict, pos)."""
    B, S = tokens.shape
    x = embed(params.embed, tokens)
    x, _, caches = forward_embeds(params, x, cfg,
                                  _positions(B, S, tokens.device),
                                  collect_cache=True)
    lead_caches, stack_caches = caches
    cache = _caches_to_struct(cfg, stack_caches, lead_caches, B, S, max_len)
    return logits_from_hidden(params, x[:, -1:], cfg), cache, S


def _caches_to_struct(cfg, stack_caches, lead_caches, B, S, max_len):
    """Zero-pad the collected per-layer (k, v) to ``max_len`` along time
    (axis 2 of the stacked layout)."""
    _refuse_moe_mla(cfg)
    if lead_caches is not None:
        from repro_torch.runtime.executor import _unported
        raise _unported("lead dense layers (DeepSeek-V2)", "2a")

    def pad_time(a):
        pad = max_len - a.shape[2]
        return torch.cat(
            [a, a.new_zeros(a.shape[:2] + (pad,) + a.shape[3:])], dim=2)

    k, v = stack_caches
    return {"k": pad_time(k), "v": pad_time(v)}


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def lm_decode_step(params: TransformerLM, cache: dict, token: torch.Tensor,
                   pos, cfg):
    """token (B, 1) integer; pos an int. Writes the token's K/V into the
    cache IN PLACE and returns (logits, cache)."""
    pos = int(pos)
    x = embed(params.embed, token)
    inv_freq = rope_freqs(cfg.head_dim_, cfg.rope_theta, x.device)
    for l, block in enumerate(params.layers):
        h = apply_norm(cfg.norm, block.ln_attn, x)
        out, _ = attn.gqa_decode(block.attn, h, cfg, pos, cache["k"][l],
                                 cache["v"][l], inv_freq)
        x = x + out
        h = apply_norm(cfg.norm, block.ln_mlp, x)
        x = x + mlp(block.mlp, h, cfg.activation)
    x = apply_norm(cfg.norm, params.ln_f, x)
    return logits_from_hidden(params, x, cfg), cache
