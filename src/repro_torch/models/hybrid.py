"""Hybrid recurrent/attention assembly (RecurrentGemma-style, 1:2 pattern).

Layer pattern: repeating macro-units of (rec, rec, local-attn), each layer
being temporal-mix + MLP with pre-norm residuals. Layers that do not fill
a macro-unit form the trailing layers, all of the pattern's first kind.
Parameters keep the JAX package's tree: ``units.{u}.{rec1,rec2,attn1}``
(the unit index where the reference stacks a leading axis) and
``trail.{i}.layer``.

Decode state per layer: RG-LRU hidden + conv tail for "rec", a
window-sized ring-buffer KV cache for "attn", in the reference's layout
(``init_hybrid_state``: ``units`` by key, ``trail``, each leaf with the
layer axis first and the batch axis second), updated in place.

Training (``hybrid_loss``: tied, logits soft-capped at 30) rematerializes
each macro-unit under ``cfg.remat``, as the reference checkpoints its
unit scan body (the trailing layers are not rematerialized there
either); autograd differentiates the sequential RG-LRU scan.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from . import attention as attn
from . import pshint, rglru
from .kvcache import recurrent_state, window_cache
from .layers import MLP, Norm, _param, apply_norm, chunked_cross_entropy, \
    embed, mlp, remat, rope_freqs, unembed


def n_units(cfg):
    """(full macro-units, trailing layers, pattern)."""
    pat = cfg.block_pattern or ("rec", "rec", "attn")
    full = cfg.n_layers // len(pat)
    return full, cfg.n_layers - full * len(pat), pat


def _unit_keys(pat):
    keys, counts = [], {}
    for kind in pat:
        counts[kind] = counts.get(kind, 0) + 1
        keys.append(f"{kind}{counts[kind]}")
    return keys


class HybridLayer(nn.Module):
    """``ln_t``, ``ln_m``, ``mlp`` and the temporal mix: ``rec`` (RG-LRU)
    or ``attn`` (local GQA)."""

    def __init__(self, cfg, kind: str, device=None):
        super().__init__()
        dt = cfg.np_dtype
        self.kind = kind
        self.ln_t = Norm(cfg.norm, cfg.d_model, dt, device)
        self.ln_m = Norm(cfg.norm, cfg.d_model, dt, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, cfg.activation, device)
        if kind == "rec":
            self.rec = rglru.RGLRU(cfg, device)
        else:
            self.attn = attn.GQA(cfg, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.ln_t.reset_parameters()
        self.ln_m.reset_parameters()
        self.mlp.reset_parameters(gen)
        (self.rec if self.kind == "rec" else self.attn).reset_parameters(gen)


class HybridLM(nn.Module):
    """``embed`` (V, d, tied), ``ln_f``, ``units`` and ``trail``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        full, trail, pat = n_units(cfg)
        if len({pat[i % len(pat)] for i in range(trail)}) > 1:
            raise ValueError("trailing layers must share a kind")
        keys = _unit_keys(pat)
        self.embed = _param((cfg.vocab_size, cfg.d_model), cfg.np_dtype,
                            device)
        self.ln_f = Norm(cfg.norm, cfg.d_model, cfg.np_dtype, device)
        self.units = nn.ModuleList(
            [nn.ModuleDict({k: HybridLayer(cfg, kind, device)
                            for k, kind in zip(keys, pat)})
             for _ in range(full)])
        self.trail = nn.ModuleList(
            [nn.ModuleDict({"layer": HybridLayer(cfg, pat[0], device)})
             for _ in range(trail)])

    def reset_parameters(self, gen: torch.Generator) -> None:
        cfg = self.cfg
        with torch.no_grad():
            for unit in self.units:
                for layer in unit.values():
                    layer.reset_parameters(gen)
            self.embed.copy_(torch.randn(
                self.embed.shape, generator=gen, device=gen.device,
                dtype=torch.float32) * 0.02)
            self.ln_f.reset_parameters()
            for t in self.trail:
                t["layer"].reset_parameters(gen)

    def layers(self):
        """Every layer in stack order: ``units`` key by key, then
        ``trail``."""
        return ([layer for unit in self.units for layer in unit.values()]
                + [t["layer"] for t in self.trail])


def init_hybrid(gen: Optional[torch.Generator], cfg,
                device=None) -> HybridLM:
    lm = HybridLM(cfg, device)
    if gen is not None:
        lm.reset_parameters(gen)
    return lm


def _embed(params: HybridLM, tokens, cfg):
    scale = torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32)
    return embed(params.embed, tokens) * scale.to(cfg.np_dtype).item()


def _ring(a, W):
    """The last ``W`` steps of a (B, S, ...) in ring-buffer layout: slot
    w holds absolute position p with p % W == w (zero-padded if S < W)."""
    S = a.shape[1]
    if S >= W:
        return torch.roll(a[:, S - W:], (S - W) % W, dims=1)
    return torch.cat([a, a.new_zeros((a.shape[0], W - S) + a.shape[2:])],
                     dim=1)


def _layer_seq(p: HybridLayer, x, cfg, positions, inv_freq,
               collect_state=False):
    h = apply_norm(cfg.norm, p.ln_t, x)
    new_state = None
    if p.kind == "rec":
        out, new_state = rglru.recurrent_block_seq(p.rec, h, cfg)
    else:
        out, (k, v) = attn.gqa_prefill(p.attn, h, cfg, positions, inv_freq,
                                       window=cfg.window)
        if collect_state:
            new_state = {"k": _ring(k, cfg.window), "v": _ring(v, cfg.window)}
    x = x + out
    h = apply_norm(cfg.norm, p.ln_m, x)
    return x + mlp(p.mlp, h, cfg.activation), new_state


def _softcap(logits):
    return 30.0 * torch.tanh(logits / 30.0)    # gemma-style soft cap


def _unit_train(unit: nn.ModuleDict, x, cfg, positions, inv_freq):
    for layer in unit.values():
        x, _ = _layer_seq(layer, x, cfg, positions, inv_freq)
    return pshint.constrain(x, "residual")


def hybrid_forward(params: HybridLM, tokens: torch.Tensor, cfg,
                   *, for_train: bool = False, collect_state: bool = False,
                   return_hidden: bool = False):
    """tokens (B, S) -> (logits (B,S,V) float32, aux 0.0), or with
    ``collect_state`` (logits, (unit states, trail states)): each layer's
    state stacked on a leading axis in ``init_hybrid_state``'s layout.
    ``return_hidden`` returns the final hidden states in the logits'
    place; ``for_train`` rematerializes each unit under ``cfg.remat``."""
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, device=x.device).expand(B, S)
    inv_freq = rope_freqs(cfg.head_dim_, cfg.rope_theta, x.device)
    states = []
    if collect_state:
        per_unit = len(n_units(cfg)[2])
        for i, layer in enumerate(params.layers()):
            x, st = _layer_seq(layer, x, cfg, positions, inv_freq,
                               collect_state=True)
            if i < per_unit * len(params.units) and (i + 1) % per_unit == 0:
                x = pshint.constrain(x, "residual")   # a unit's end
            states.append(st)
    else:
        for unit in params.units:
            x = remat(cfg, _unit_train, unit, x, cfg, positions, inv_freq,
                      for_train=for_train)
        for t in params.trail:
            x, _ = _layer_seq(t["layer"], x, cfg, positions, inv_freq)
    x = apply_norm(cfg.norm, params.ln_f, x)
    out = x if return_hidden else _softcap(unembed(params.embed, x,
                                                   tied=True))
    if not collect_state:
        return out, torch.zeros((), dtype=torch.float32, device=x.device)
    return out, _stack_states(params, states)


def hybrid_loss(params: HybridLM, batch: dict, cfg) -> torch.Tensor:
    """Chunked cross-entropy over the tied embedding, logits soft-capped
    at 30 (the reference's ``model.loss`` of the hybrid family)."""
    h, _ = hybrid_forward(params, batch["tokens"], cfg, for_train=True,
                          return_hidden=True)
    return chunked_cross_entropy(h, params.embed, batch["labels"],
                                 tied=True, softcap=30.0)


def _stack_states(params: HybridLM, states):
    full, trail, pat = n_units(params.cfg)
    keys = _unit_keys(pat)

    def stack(sts):
        return {k: torch.stack([s[k] for s in sts]) for k in sts[0]}

    unit = {key: stack(states[i:len(keys) * full:len(keys)])
            for i, key in enumerate(keys)} if full else {}
    tail = stack(states[len(keys) * full:]) if trail else None
    return unit, tail


def init_hybrid_state(cfg, batch, device=None):
    """Decode state matching the parameters' units and trail."""
    full, trail, pat = n_units(cfg)

    def one_layer_state(kind, n):
        if kind == "rec":
            return recurrent_state(n, batch, cfg.lru_width, cfg.conv_width,
                                   cfg.np_dtype, device)
        return window_cache(n, batch, cfg.window, cfg.n_kv_heads,
                            cfg.head_dim_, cfg.np_dtype, device)

    state = {"units": {k: one_layer_state(kind, full)
                       for k, kind in zip(_unit_keys(pat), pat)}}
    if trail:
        state["trail"] = one_layer_state(pat[0], trail)
    return state


def _layer_step(p: HybridLayer, x, cfg, pos, st, inv_freq):
    """One layer of the decode step; ``st`` (this layer's slices of the
    state) is updated in place."""
    h = apply_norm(cfg.norm, p.ln_t, x)
    if p.kind == "rec":
        out, new = rglru.recurrent_block_step(p.rec, h, cfg, st)
        st["h"].copy_(new["h"])
        st["conv"].copy_(new["conv"])
    else:
        out, _ = attn.gqa_decode(p.attn, h, cfg, pos, st["k"], st["v"],
                                 inv_freq, window=cfg.window)
    x = x + out
    h = apply_norm(cfg.norm, p.ln_m, x)
    return x + mlp(p.mlp, h, cfg.activation)


def hybrid_decode_step(params: HybridLM, state: dict, token: torch.Tensor,
                       pos, cfg):
    """token (B,1); state from ``init_hybrid_state`` (or a prefill),
    updated IN PLACE. Returns (logits, state)."""
    full, trail, pat = n_units(cfg)
    keys = _unit_keys(pat)
    x = _embed(params, token, cfg)
    inv_freq = rope_freqs(cfg.head_dim_, cfg.rope_theta, x.device)
    for u, unit in enumerate(params.units):
        for key in keys:
            st = {k: a[u] for k, a in state["units"][key].items()}
            x = _layer_step(unit[key], x, cfg, pos, st, inv_freq)
    for i, t in enumerate(params.trail):
        st = {k: a[i] for k, a in state["trail"].items()}
        x = _layer_step(t["layer"], x, cfg, pos, st, inv_freq)
    x = apply_norm(cfg.norm, params.ln_f, x)
    return _softcap(unembed(params.embed, x, tied=True)), state
