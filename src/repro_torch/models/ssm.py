"""RWKV-6 LM assembly: an attention-free stack of time and channel mixes.

Parameters keep the JAX package's names (``embed``, ``ln_in``, ``ln_f``,
``layers.{l}.{ln_t,ln_c,tm,cm}...``, ``unembed``); the decode state is
``kvcache.rwkv_state``'s, updated in place.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import rwkv
from .kvcache import rwkv_state
from .layers import Norm, _param, apply_norm, embed, embed_init, unembed


class RwkvLayer(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln_t = Norm("layernorm", cfg.d_model, cfg.np_dtype, device)
        self.ln_c = Norm("layernorm", cfg.d_model, cfg.np_dtype, device)
        self.tm = rwkv.TimeMix(cfg, device)
        self.cm = rwkv.ChannelMix(cfg, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.ln_t.reset_parameters()
        self.ln_c.reset_parameters()
        self.tm.reset_parameters(gen)
        self.cm.reset_parameters(gen)


class RwkvLM(nn.Module):
    """``embed`` (V, d), ``ln_in``, ``ln_f``, ``layers``, ``unembed``
    (d, V)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.d_model, cfg.np_dtype
        self.embed = _param((cfg.vocab_size, d), dt, device)
        self.ln_in = Norm("layernorm", d, dt, device)
        self.ln_f = Norm("layernorm", d, dt, device)
        self.layers = nn.ModuleList(
            [RwkvLayer(cfg, device) for _ in range(cfg.n_layers)])
        self.unembed = _param((d, cfg.vocab_size), dt, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        cfg = self.cfg
        with torch.no_grad():
            self.embed.copy_(embed_init(gen, cfg.vocab_size, cfg.d_model,
                                        self.embed.dtype))
            self.ln_in.reset_parameters()
            self.ln_f.reset_parameters()
            for layer in self.layers:
                layer.reset_parameters(gen)
            self.unembed.copy_(torch.randn(
                self.unembed.shape, generator=gen, device=gen.device,
                dtype=torch.float32) * 0.02)


def init_rwkv_lm(gen: Optional[torch.Generator], cfg, device=None) -> RwkvLM:
    lm = RwkvLM(cfg, device)
    if gen is not None:
        lm.reset_parameters(gen)
    return lm


def _layer(lp: RwkvLayer, h, cfg, st=None):
    hn = apply_norm("layernorm", lp.ln_t, h)
    out, tm_state = rwkv.time_mix_seq(
        lp.tm, hn, cfg, None if st is None else
        {"S": st["S"], "x_tm": st["x_tm"]})
    h = h + out
    hn = apply_norm("layernorm", lp.ln_c, h)
    out, cm_state = rwkv.channel_mix_seq(
        lp.cm, hn, None if st is None else {"x_cm": st["x_cm"]})
    return h + out, {"S": tm_state["S"], "x_tm": tm_state["x_tm"],
                     "x_cm": cm_state["x_cm"]}


def _hidden(params: RwkvLM, tokens, cfg, state=None):
    """The stack's final hidden states and each layer's new state."""
    x = apply_norm("layernorm", params.ln_in, embed(params.embed, tokens))
    states = []
    for l, lp in enumerate(params.layers):
        st = None if state is None else {k: a[l] for k, a in state.items()}
        x, new = _layer(lp, x, cfg, st)
        states.append(new)
    return apply_norm("layernorm", params.ln_f, x), states


def rwkv_forward(params: RwkvLM, tokens: torch.Tensor, cfg):
    """tokens (B, S) -> (logits (B,S,V) float32, aux 0.0)."""
    x, _ = _hidden(params, tokens, cfg)
    return (unembed(params.unembed, x, tied=False),
            torch.zeros((), dtype=torch.float32, device=x.device))


def init_rwkv_state(cfg, batch, device=None):
    hd = cfg.rwkv_head_size
    return rwkv_state(cfg.n_layers, batch, cfg.d_model // hd, hd,
                      cfg.d_model, cfg.np_dtype, device)


def rwkv_prefill(params: RwkvLM, tokens: torch.Tensor, cfg):
    """Run the sequence and return (last logits, state, pos)."""
    x, states = _hidden(params, tokens, cfg)
    state = {k: torch.stack([s[k] for s in states])
             for k in ("S", "x_tm", "x_cm")}
    logits = unembed(params.unembed, x[:, -1:], tied=False)
    return logits, state, tokens.shape[1]


def rwkv_decode_step(params: RwkvLM, state: dict, token: torch.Tensor, pos,
                     cfg):
    """One token through the stack; the state is updated IN PLACE. The
    state carries every position, so ``pos`` is not read."""
    del pos
    x, states = _hidden(params, token, cfg, state)
    for l, new in enumerate(states):
        for k, a in new.items():
            state[k][l].copy_(a)
    return unembed(params.unembed, x, tied=False), state
