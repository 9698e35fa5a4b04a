"""Encoder-decoder transformer (SeamlessM4T-medium backbone).

As in the JAX package, the audio frontend is a stub: the encoder takes
precomputed frame embeddings (B, S_enc, d_model). The text decoder is a
causal stack with cross attention; decode serves with a self-attention
KV cache, updated in place, plus the cross K/V computed at prefill.
Parameters keep the reference's names (``embed``, ``enc_layers``,
``dec_layers`` with ``ln_cross`` and ``cross``, ``ln_enc``, ``ln_dec``,
``unembed``). Training (``encdec_loss``) rematerializes each encoder and
decoder layer under ``cfg.remat``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import attention as attn
from . import pshint
from .layers import (MLP, Norm, _param, apply_norm, chunked_cross_entropy,
                     embed, embed_init, mlp, remat, rope_freqs, unembed)


class EncLayer(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
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


class DecLayer(EncLayer):
    """An encoder layer plus ``ln_cross`` and the ``cross`` attention."""

    def __init__(self, cfg, device=None):
        super().__init__(cfg, device)
        self.ln_cross = Norm(cfg.norm, cfg.d_model, cfg.np_dtype, device)
        self.cross = attn.Cross(cfg, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        super().reset_parameters(gen)
        self.ln_cross.reset_parameters()
        self.cross.reset_parameters(gen)


class EncDecLM(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        d, dt = cfg.d_model, cfg.np_dtype
        self.embed = _param((cfg.vocab_size, d), dt, device)
        self.enc_layers = nn.ModuleList(
            [EncLayer(cfg, device) for _ in range(cfg.n_enc_layers)])
        self.dec_layers = nn.ModuleList(
            [DecLayer(cfg, device) for _ in range(cfg.n_layers)])
        self.ln_enc = Norm(cfg.norm, d, dt, device)
        self.ln_dec = Norm(cfg.norm, d, dt, device)
        self.unembed = _param((d, cfg.vocab_size), dt, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        cfg = self.cfg
        with torch.no_grad():
            self.embed.copy_(embed_init(gen, cfg.vocab_size, cfg.d_model,
                                        self.embed.dtype))
            for layer in list(self.enc_layers) + list(self.dec_layers):
                layer.reset_parameters(gen)
            self.ln_enc.reset_parameters()
            self.ln_dec.reset_parameters()
            self.unembed.copy_(torch.randn(
                self.unembed.shape, generator=gen, device=gen.device,
                dtype=torch.float32) * 0.02)


def init_encdec(gen: Optional[torch.Generator], cfg,
                device=None) -> EncDecLM:
    lm = EncDecLM(cfg, device)
    if gen is not None:
        lm.reset_parameters(gen)
    return lm


def _positions(B, S, device):
    return torch.arange(S, device=device).expand(B, S)


def _enc_layer(lp: EncLayer, h, cfg, positions, inv_freq):
    B, S, _ = h.shape
    hn = apply_norm(cfg.norm, lp.ln_attn, h)
    q, k, v = attn.gqa_qkv(lp.attn, hn, cfg, positions, inv_freq)
    o = attn.flash_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    h = h + o.reshape(B, S, -1) @ lp.attn.wo
    hn = apply_norm(cfg.norm, lp.ln_mlp, h)
    return h + mlp(lp.mlp, hn, cfg.activation)


def encode(params: EncDecLM, frames: torch.Tensor, cfg, *,
           for_train: bool = False) -> torch.Tensor:
    """frames: (B, S_enc, d_model) stub embeddings -> encoder output."""
    B, S, _ = frames.shape
    h = frames.to(cfg.np_dtype)
    positions = _positions(B, S, h.device)
    inv_freq = rope_freqs(cfg.head_dim_, cfg.rope_theta, h.device)
    for lp in params.enc_layers:
        h = remat(cfg, _enc_layer, lp, h, cfg, positions, inv_freq,
                  for_train=for_train)
    return apply_norm(cfg.norm, params.ln_enc, h)


def _dec_layer(lp: DecLayer, x, enc_out, cfg, positions, inv_freq):
    """One decoder layer: (x, self (k, v), cross (ck, cv))."""
    hn = apply_norm(cfg.norm, lp.ln_attn, x)
    out, kv = attn.gqa_prefill(lp.attn, hn, cfg, positions, inv_freq)
    x = x + out
    hn = apply_norm(cfg.norm, lp.ln_cross, x)
    ck, cv = attn.cross_kv(lp.cross, enc_out, cfg)
    x = x + attn.cross_attention(lp.cross, hn, ck, cv, cfg)
    hn = apply_norm(cfg.norm, lp.ln_mlp, x)
    x = pshint.constrain(x + mlp(lp.mlp, hn, cfg.activation), "residual")
    return x, kv, (ck, cv)


def decode_seq(params: EncDecLM, tokens: torch.Tensor, enc_out, cfg,
               *, for_train: bool = False, collect_cache: bool = False,
               return_hidden: bool = False):
    """Teacher-forced decoder pass. tokens (B, S_dec). Returns (logits,
    or with ``return_hidden`` the final hidden states, and caches|None):
    with ``collect_cache``, ((k, v), (ck, cv)) stacked on a leading layer
    axis."""
    B, S = tokens.shape
    x = embed(params.embed, tokens)
    positions = _positions(B, S, x.device)
    inv_freq = rope_freqs(cfg.head_dim_, cfg.rope_theta, x.device)
    self_kv, cross_kv = [], []
    for lp in params.dec_layers:
        x, kv, ckv = remat(cfg, _dec_layer, lp, x, enc_out, cfg, positions,
                           inv_freq, for_train=for_train)
        if collect_cache:
            self_kv.append(kv)
            cross_kv.append(ckv)
    x = apply_norm(cfg.norm, params.ln_dec, x)
    out = x if return_hidden else unembed(params.unembed, x, tied=False)
    if not collect_cache:
        return out, None

    def stacked(pairs):
        return tuple(torch.stack(parts) for parts in zip(*pairs))
    return out, (stacked(self_kv), stacked(cross_kv))


def encdec_loss(params: EncDecLM, batch: dict, cfg) -> torch.Tensor:
    """Chunked cross-entropy of the decoder's next tokens, the encoder
    reading ``batch["frames"]``."""
    enc_out = encode(params, batch["frames"], cfg, for_train=True)
    h, _ = decode_seq(params, batch["tokens"], enc_out, cfg,
                      for_train=True, return_hidden=True)
    return chunked_cross_entropy(h, params.unembed, batch["labels"],
                                 tied=False)


def encdec_prefill(params: EncDecLM, frames: torch.Tensor,
                   tokens: torch.Tensor, cfg, max_len: int):
    """Encode + teacher-forced decoder prefill; returns (last logits,
    cache {"k", "v" padded to max_len, "ck", "cv"}, pos)."""
    enc_out = encode(params, frames, cfg)
    logits, ((k, v), (ck, cv)) = decode_seq(params, tokens, enc_out, cfg,
                                            collect_cache=True)
    S = tokens.shape[1]

    def pad_time(a):
        return torch.cat(
            [a, a.new_zeros(a.shape[:2] + (max_len - S,) + a.shape[3:])],
            dim=2)
    cache = {"k": pad_time(k), "v": pad_time(v), "ck": ck, "cv": cv}
    return logits[:, -1:], cache, S


def encdec_decode_step(params: EncDecLM, cache: dict, token: torch.Tensor,
                       pos, cfg):
    """One decoder token; the self-attention cache is written IN PLACE."""
    B = token.shape[0]
    x = embed(params.embed, token)
    inv_freq = rope_freqs(cfg.head_dim_, cfg.rope_theta, x.device)
    for l, lp in enumerate(params.dec_layers):
        hn = apply_norm(cfg.norm, lp.ln_attn, x)
        out, _ = attn.gqa_decode(lp.attn, hn, cfg, pos, cache["k"][l],
                                 cache["v"][l], inv_freq)
        x = x + out
        hn = apply_norm(cfg.norm, lp.ln_cross, x)
        q = (hn @ lp.cross.wq).reshape(B, 1, cfg.n_heads, cfg.head_dim_)
        o = attn.flash_attention(q, cache["ck"][l], cache["cv"][l],
                                 causal=False, chunk=cfg.attn_chunk)
        x = x + o.reshape(B, 1, -1) @ lp.cross.wo
        hn = apply_norm(cfg.norm, lp.ln_mlp, x)
        x = x + mlp(lp.mlp, hn, cfg.activation)
    x = apply_norm(cfg.norm, params.ln_dec, x)
    return unembed(params.unembed, x, tied=False), cache
