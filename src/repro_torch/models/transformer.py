"""Decoder-only transformer assembly: the dense, MoE and MLA families.

The stack is an ``nn.ModuleList`` of :class:`Block`; parameters keep the
JAX package's names (``embed``, ``ln_f``, ``layers.{l}.attn.wq``, ...,
``unembed``, and DeepSeek-V2's dense ``lead_layers.{l}...``) with the
layer index where the reference stacks a leading layer axis, so its
parameter tree carries across (``repro_torch.convert.
lm_params_from_reference``). The layer-invariant RoPE table is computed
once a call and shared by every layer. The JAX package's sharding hints
(``pshint.constrain``) are no-ops on one device and have no counterpart
here; the LM's parallel layer is ROADMAP.md queue 1 step 2e.

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
from .moe import MoE, moe_mlp


# --------------------------------------------------------------------------
# modules and init
# --------------------------------------------------------------------------

class Block(nn.Module):
    """One decoder layer: pre-norm attention (GQA, or MLA with
    ``cfg.mla``), then a pre-norm MLP (``mlp``, of width ``d_ff``, or the
    routed experts ``moe`` with ``use_moe``)."""

    def __init__(self, cfg, device=None, *, use_moe: bool = False,
                 d_ff: Optional[int] = None):
        super().__init__()
        dt = cfg.np_dtype
        self.use_moe = use_moe
        self.ln_attn = Norm(cfg.norm, cfg.d_model, dt, device)
        self.ln_mlp = Norm(cfg.norm, cfg.d_model, dt, device)
        self.attn = (attn.MLA(cfg, device) if cfg.mla is not None
                     else attn.GQA(cfg, device))
        if use_moe:
            self.moe = MoE(cfg, device)
        else:
            self.mlp = MLP(cfg.d_model, d_ff or cfg.d_ff, dt,
                           cfg.activation, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.ln_attn.reset_parameters()
        self.ln_mlp.reset_parameters()
        self.attn.reset_parameters(gen)
        (self.moe if self.use_moe else self.mlp).reset_parameters(gen)


def _n_lead(cfg) -> int:
    return cfg.moe.first_dense_layers if cfg.moe is not None else 0


class TransformerLM(nn.Module):
    """The stack's parameters: ``embed`` (V, d), ``ln_f``, ``layers``
    (MoE blocks with ``cfg.moe``), ``lead_layers`` (DeepSeek-V2's dense
    blocks of width ``first_dense_d_ff``, which run first) and, untied,
    ``unembed`` (d, V)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.np_dtype
        m, n_lead = cfg.moe, _n_lead(cfg)
        self.embed = _param((cfg.vocab_size, cfg.d_model), dt, device)
        self.ln_f = Norm(cfg.norm, cfg.d_model, dt, device)
        self.layers = nn.ModuleList(
            [Block(cfg, device, use_moe=m is not None)
             for _ in range(cfg.n_layers - n_lead)])
        if n_lead:
            self.lead_layers = nn.ModuleList(
                [Block(cfg, device, d_ff=m.first_dense_d_ff or cfg.d_ff)
                 for _ in range(n_lead)])
        if not cfg.tie_embeddings:
            self.unembed = _param((cfg.d_model, cfg.vocab_size), dt, device)

    def blocks(self):
        """Every block in the order the stack runs them (the lead layers
        first): the order of the cache's layer axis."""
        lead = list(self.lead_layers) if hasattr(self, "lead_layers") \
            else []
        return lead + list(self.layers)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Draw every weight from ``gen`` (on the parameters' device), in
        the JAX package's order and distributions."""
        cfg = self.cfg
        with torch.no_grad():
            self.embed.copy_(embed_init(gen, cfg.vocab_size, cfg.d_model,
                                        self.embed.dtype))
            self.ln_f.reset_parameters()
            # the reference draws the stack, then the lead layers
            n_lead = _n_lead(cfg)
            for block in self.blocks()[n_lead:] + self.blocks()[:n_lead]:
                block.reset_parameters(gen)
            if not cfg.tie_embeddings:
                self.unembed.copy_(dense_init(
                    gen, cfg.d_model, cfg.vocab_size, self.unembed.dtype,
                    scale=0.02))


def init_block(gen: Optional[torch.Generator], cfg, *,
               use_moe: bool = False, device=None) -> Block:
    block = Block(cfg, device, use_moe=use_moe)
    if gen is not None:
        block.reset_parameters(gen)
    return block


def init_lm(gen: Optional[torch.Generator], cfg,
            device=None) -> TransformerLM:
    """The stack on ``device``, drawn from ``gen`` (None leaves the
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


def _rope_dim(cfg) -> int:
    return cfg.mla.qk_rope_dim if cfg.mla is not None else cfg.head_dim_


def _attn_seq(block: Block, x, cfg, positions, inv_freq):
    h = apply_norm(cfg.norm, block.ln_attn, x)
    if cfg.mla is not None:
        out, cache = attn.mla_prefill(block.attn, h, cfg, positions,
                                      inv_freq)
    else:
        out, cache = attn.gqa_prefill(block.attn, h, cfg, positions,
                                      inv_freq)
    return x + out, cache


def _mlp_block(block: Block, x, cfg, moe_stats=None):
    h = apply_norm(cfg.norm, block.ln_mlp, x)
    if block.use_moe:
        out, aux = moe_mlp(block.moe, h, cfg, stats=moe_stats)
    else:
        out = mlp(block.mlp, h, cfg.activation)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + out, aux


def forward_embeds(params: TransformerLM, x: torch.Tensor, cfg, positions,
                   *, collect_cache: bool = False):
    """Run the layer stack on embedded inputs x (B, S, d).

    Returns (hidden, aux_loss, caches|None). Collected caches are the
    reference's ``(lead, stack)`` pair, each None or a pair of tensors
    stacked on a leading layer axis: ``(k, v)`` ``(L, B, S, KVH, hd)``,
    or with MLA ``(c, kr)`` ``(L, B, S, kv_lora)`` and ``(L, B, S, dr)``.
    """
    inv_freq = rope_freqs(_rope_dim(cfg), cfg.rope_theta, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    n_lead = _n_lead(cfg)
    collected = []
    for block in params.blocks():
        x, cache = _attn_seq(block, x, cfg, positions, inv_freq)
        x, a = _mlp_block(block, x, cfg)
        aux = aux + a
        if collect_cache:
            collected.append(cache)
    x = apply_norm(cfg.norm, params.ln_f, x)
    if not collect_cache:
        return x, aux, None

    def stacked(caches):
        if not caches:
            return None
        return tuple(torch.stack(parts) for parts in zip(*caches))
    return x, aux, (stacked(collected[:n_lead]), stacked(collected[n_lead:]))


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
    """Zero-pad the collected per-layer (k, v), or with MLA (c, kr), to
    ``max_len`` along time (axis 2 of the stacked layout), the lead
    layers' first on the layer axis."""
    def pad_time(a):
        pad = max_len - a.shape[2]
        return torch.cat(
            [a, a.new_zeros(a.shape[:2] + (pad,) + a.shape[3:])], dim=2)

    def cat(i):
        parts = ([lead_caches[i]] if lead_caches else []) + \
            [stack_caches[i]]
        return pad_time(torch.cat(parts, dim=0))

    if cfg.mla is not None:
        return {"c": cat(0), "kr": cat(1)}
    return {"k": cat(0), "v": cat(1)}


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def lm_decode_step(params: TransformerLM, cache: dict, token: torch.Tensor,
                   pos, cfg, *, moe_stats: Optional[dict] = None):
    """token (B, 1) integer; pos an int. Writes the token's K/V (or, with
    MLA, its latent and rope key) into the cache IN PLACE and returns
    (logits, cache). ``moe_stats`` gathers the routed layers' assignment
    and drop counts (``moe.moe_mlp``)."""
    pos = int(pos)
    x = embed(params.embed, token)
    inv_freq = rope_freqs(_rope_dim(cfg), cfg.rope_theta, x.device)
    for l, block in enumerate(params.blocks()):
        h = apply_norm(cfg.norm, block.ln_attn, x)
        if cfg.mla is not None:
            out, _ = attn.mla_decode(block.attn, h, cfg, pos,
                                     cache["c"][l], cache["kr"][l],
                                     inv_freq)
        else:
            out, _ = attn.gqa_decode(block.attn, h, cfg, pos,
                                     cache["k"][l], cache["v"][l],
                                     inv_freq)
        x, _ = _mlp_block(block, x + out, cfg, moe_stats)
    x = apply_norm(cfg.norm, params.ln_f, x)
    return logits_from_hidden(params, x, cfg), cache
