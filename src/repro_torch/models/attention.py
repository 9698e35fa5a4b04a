"""Attention: GQA (full and sliding window), cross attention and MLA,
prefill and decode paths.

Prefill runs a flash-style chunked attention: a loop over KV chunks with
an online softmax, so the S^2 score matrix is never materialized. It is
written as plain tensor code that follows the JAX package's chunking and
float32 accumulation step for step (``scaled_dot_product_attention``
accumulates in another order). Decode is one read over the cache (full)
or over a ring buffer (sliding window); the cache is contracted with
float32 results, by upcasting both operands: a bf16 x bf16 product is
exact in float32, so this is the reference's ``preferred_element_type``
contraction. MLA decode keeps DeepSeek's weight absorption: attention
runs in the kv_lora latent space and the cache holds only (c_kv, k_rope).

Training differentiates the flash attention through its own backward
(``_Flash``, the reference's ``custom_vjp``): the forward keeps only q,
k, v, the output and the log-sum-exp, and the backward recomputes each
KV chunk's probabilities (FlashAttention-2's schedule), so neither pass
holds the S^2 scores. GQA, cross attention and MLA prefill train
through it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .layers import Norm, _param, apply_rope, dense_init, rms_norm

NEG_INF = -1e30


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


# --------------------------------------------------------------------------
# reference (S^2) attention: the oracle
# --------------------------------------------------------------------------

def attention_ref(q, k, v, *, causal=True, window=None, q_offset=0):
    """q: (B,Sq,H,D); k,v: (B,Skv,KVH,D). Returns (B,Sq,H,Dv)."""
    B, Sq, H, D = q.shape
    KVH = k.shape[2]
    G = H // KVH
    qf = _f32(q).reshape(B, Sq, KVH, G, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, _f32(k)) / math.sqrt(D)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, _f32(v))
    return out.reshape(B, Sq, H, -1).to(q.dtype)


# --------------------------------------------------------------------------
# flash-style chunked attention (prefill), forward
# --------------------------------------------------------------------------

def _chunk_kv(k, v, chunk):
    B, Skv, KVH, D = k.shape
    Dv = v.shape[3]
    n_chunks = (Skv + chunk - 1) // chunk
    pad = n_chunks * chunk - Skv
    if pad:
        k = torch.cat([k, k.new_zeros((B, pad, KVH, D))], dim=1)
        v = torch.cat([v, v.new_zeros((B, pad, KVH, Dv))], dim=1)
    kc = k.reshape(B, n_chunks, chunk, KVH, D).transpose(0, 1)
    vc = v.reshape(B, n_chunks, chunk, KVH, Dv).transpose(0, 1)
    return kc, vc, n_chunks


def _chunk_mask(kpos, qpos, Skv, causal, window):
    mask = kpos < Skv
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def _flash_fwd_impl(q, k, v, causal, window, chunk, q_offset):
    """The chunked forward: (out (B,Sq,H,Dv) in q.dtype, lse (B,Sq,KVH,G)
    float32). The running output, maximum and normalizer are float32;
    the last chunk is zero-padded and masked."""
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    Dv = v.shape[3]
    G = H // KVH
    chunk = min(chunk, Skv)
    kc, vc, n_chunks = _chunk_kv(k, v, chunk)
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    qf = (_f32(q) * scale).reshape(B, Sq, KVH, G, D)
    qpos = (q_offset + torch.arange(Sq, device=dev))[:, None]
    o = torch.zeros((B, Sq, KVH, G, Dv), dtype=torch.float32, device=dev)
    m = torch.full((B, Sq, KVH, G), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, Sq, KVH, G), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        kpos = c * chunk + torch.arange(chunk, device=dev)[None, :]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, _f32(kc[c]))
        mask = _chunk_mask(kpos, qpos, Skv, causal, window)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "bqhgk,bkhd->bqhgd", p, _f32(vc[c]))
        m = m_new
    l_safe = torch.clamp(l, min=1e-30)
    out = o / l_safe[..., None]
    lse = m + torch.log(l_safe)
    return out.reshape(B, Sq, H, Dv).to(q.dtype), lse


def _flash_bwd(q, k, v, out, lse, dout, causal, window, chunk, q_offset):
    """The reference's ``_flash_bwd``: (dq, dk, dv) in the inputs' dtypes.

    ``delta = sum(dout * out)``; per KV chunk, ``p = exp(s - lse)`` under
    the forward's mask, ``dv = p^T dout``, ``dp = dout v^T``, ``ds = p (dp
    - delta)``, ``dq += ds k scale`` (a float32 accumulator), ``dk = ds^T
    q scale``; all in float32, grouped as the forward groups GQA."""
    B, Sq, H, D = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    Dv = v.shape[3]
    G = H // KVH
    chunk = min(chunk, Skv)
    kc, vc, n_chunks = _chunk_kv(k, v, chunk)
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    qf = _f32(q).reshape(B, Sq, KVH, G, D)
    dof = _f32(dout).reshape(B, Sq, KVH, G, Dv)
    of = _f32(out).reshape(B, Sq, KVH, G, Dv)
    delta = torch.sum(dof * of, dim=-1)                  # (B,Sq,KVH,G)
    qpos = (q_offset + torch.arange(Sq, device=dev))[:, None]
    dq = torch.zeros((B, Sq, KVH, G, D), dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for c in range(n_chunks):
        kbf, vbf = _f32(kc[c]), _f32(vc[c])
        kpos = c * chunk + torch.arange(chunk, device=dev)[None, :]
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kbf) * scale
        mask = _chunk_mask(kpos, qpos, Skv, causal, window)
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        p = torch.exp(s - lse[..., None])                # normalized probs
        dvs.append(torch.einsum("bqhgk,bqhgd->bkhd", p, dof))
        dp = torch.einsum("bqhgd,bkhd->bqhgk", dof, vbf)
        ds = p * (dp - delta[..., None])
        dq = dq + torch.einsum("bqhgk,bkhd->bqhgd", ds, kbf) * scale
        dks.append(torch.einsum("bqhgk,bqhgd->bkhd", ds, qf) * scale)
    dk = torch.cat(dks, dim=1)[:, :Skv]
    dv = torch.cat(dvs, dim=1)[:, :Skv]
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _Flash(torch.autograd.Function):
    """Flash attention with the reference's custom backward; ``causal``,
    ``window``, ``chunk`` and ``q_offset`` are not differentiated."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk, q_offset):
        out, lse = _flash_fwd_impl(q, k, v, causal, window, chunk,
                                   q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.static = (causal, window, chunk, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout, *ctx.static)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal=True, window=None, chunk=1024,
                    q_offset=0):
    """Online-softmax attention over KV chunks of ``chunk``, O(chunk)
    memory in forward and backward.

    q: (B,Sq,H,D); k,v: (B,Skv,KVH,Dk/Dv). Returns (B,Sq,H,Dv) in
    q.dtype. Where autograd records and an input requires grad, the
    call runs through ``_Flash`` (the reference's custom VJP); else the
    plain chunked forward runs.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Flash.apply(q, k, v, causal, window, chunk, q_offset)
    return _flash_fwd_impl(q, k, v, causal, window, chunk, q_offset)[0]


# --------------------------------------------------------------------------
# decode attention over caches
# --------------------------------------------------------------------------

def decode_attention(q, k_cache, v_cache, pos):
    """One-token attention over a full cache.

    q: (B,1,H,D); k_cache/v_cache: (B,S,KVH,D); pos: the current index
    (the cache holds valid entries at [0, pos]). The query is rounded to
    the cache's dtype, as in the reference; products are float32.
    """
    B, _, H, D = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    qf = (_f32(q) / math.sqrt(D)).to(k_cache.dtype).reshape(B, KVH, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", _f32(qf), _f32(k_cache))
    valid = torch.arange(S, device=q.device)[None, None, None, :] <= int(pos)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", _f32(p.to(v_cache.dtype)),
                       _f32(v_cache))
    return out.reshape(B, 1, H, -1).to(q.dtype)


def decode_attention_window(q, k_ring, v_ring, pos, window):
    """One-token attention over a ring-buffer cache (sliding window).

    k_ring/v_ring: (B,W,KVH,D); slot w holds absolute position
    p_w = pos - ((pos - w) mod W); valid iff p_w >= 0 and within the
    window (RoPE was applied at write time, at the absolute position).
    """
    B, W, KVH, D = k_ring.shape
    H = q.shape[2]
    G = H // KVH
    pos = int(pos)
    qf = (_f32(q) / math.sqrt(D)).to(k_ring.dtype).reshape(B, KVH, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", _f32(qf), _f32(k_ring))
    w_idx = torch.arange(W, device=q.device)
    slot_pos = pos - torch.remainder(pos - w_idx, W)
    valid = (slot_pos >= 0) & (slot_pos > pos - window)
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", _f32(p.to(v_ring.dtype)),
                       _f32(v_ring))
    return out.reshape(B, 1, H, -1).to(q.dtype)


# --------------------------------------------------------------------------
# GQA attention block (params + apply)
# --------------------------------------------------------------------------

class GQA(nn.Module):
    """Grouped-query attention weights: ``wq``, ``wk``, ``wv``, ``wo``
    (``(d_in, d_out)``), and ``bq``, ``bk``, ``bv`` with ``qkv_bias``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
            cfg.head_dim_
        dt = cfg.np_dtype
        self.wq = _param((d, H * hd), dt, device)
        self.wk = _param((d, KVH * hd), dt, device)
        self.wv = _param((d, KVH * hd), dt, device)
        self.wo = _param((H * hd, d), dt, device)
        self.qkv_bias = bool(cfg.qkv_bias)
        if self.qkv_bias:
            self.bq = _param((H * hd,), dt, device)
            self.bk = _param((KVH * hd,), dt, device)
            self.bv = _param((KVH * hd,), dt, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            for name in ("wq", "wk", "wv", "wo"):
                w = getattr(self, name)
                w.copy_(dense_init(gen, w.shape[0], w.shape[1], w.dtype))
            if self.qkv_bias:
                for name in ("bq", "bk", "bv"):
                    getattr(self, name).zero_()


def init_gqa(gen: Optional[torch.Generator], cfg, device=None) -> GQA:
    p = GQA(cfg, device)
    if gen is not None:
        p.reset_parameters(gen)
    return p


def gqa_qkv(p: GQA, x: torch.Tensor, cfg, positions, inv_freq):
    """Project + rope. x: (B,S,d). Returns q (B,S,H,hd), k/v (B,S,KVH,hd)."""
    B, S, _ = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    from . import pshint
    q = pshint.constrain(q.reshape(B, S, H, hd), "heads")
    k = pshint.constrain(k.reshape(B, S, KVH, hd), "heads")
    v = pshint.constrain(v.reshape(B, S, KVH, hd), "heads")
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)
    return q, k, v


def gqa_prefill(p: GQA, x, cfg, positions, inv_freq, *, window=None):
    q, k, v = gqa_qkv(p, x, cfg, positions, inv_freq)
    o = flash_attention(q, k, v, causal=True, window=window,
                        chunk=cfg.attn_chunk)
    B, S = x.shape[:2]
    out = o.reshape(B, S, -1) @ p.wo
    return out, (k, v)


def gqa_decode(p: GQA, x, cfg, pos, k_cache, v_cache, inv_freq,
               *, window=None):
    """x: (B,1,d). Writes this token's K/V into the cache at ``pos`` (a
    full cache, (B,S,KVH,hd)) or at slot ``pos % W`` (a ring, (B,W,KVH,
    hd)), IN PLACE, and attends. Returns (out, (k_cache, v_cache))."""
    B = x.shape[0]
    pos = int(pos)
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = gqa_qkv(p, x, cfg, positions, inv_freq)
    slot = pos if window is None else pos % k_cache.shape[1]
    k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
    v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
    if window is None:
        o = decode_attention(q, k_cache, v_cache, pos)
    else:
        o = decode_attention_window(q, k_cache, v_cache, pos, window)
    out = o.reshape(B, 1, -1) @ p.wo
    return out, (k_cache, v_cache)


# --------------------------------------------------------------------------
# cross attention (encoder-decoder)
# --------------------------------------------------------------------------

class Cross(nn.Module):
    """Cross-attention weights ``wq``, ``wk``, ``wv``, ``wo``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
            cfg.head_dim_
        dt = cfg.np_dtype
        self.wq = _param((d, H * hd), dt, device)
        self.wk = _param((d, KVH * hd), dt, device)
        self.wv = _param((d, KVH * hd), dt, device)
        self.wo = _param((H * hd, d), dt, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            for name in ("wq", "wk", "wv", "wo"):
                w = getattr(self, name)
                w.copy_(dense_init(gen, w.shape[0], w.shape[1], w.dtype))


def init_cross(gen: Optional[torch.Generator], cfg, device=None) -> Cross:
    p = Cross(cfg, device)
    if gen is not None:
        p.reset_parameters(gen)
    return p


def cross_attention(p: Cross, x, enc_k, enc_v, cfg):
    """x: (B,Sd,d); enc_k/enc_v: (B,Se,KVH,hd) from ``cross_kv``."""
    B, Sd, _ = x.shape
    q = (x @ p.wq).reshape(B, Sd, cfg.n_heads, cfg.head_dim_)
    o = flash_attention(q, enc_k, enc_v, causal=False, chunk=cfg.attn_chunk)
    return o.reshape(B, Sd, -1) @ p.wo


def cross_kv(p: Cross, enc_out, cfg):
    B, Se, _ = enc_out.shape
    KVH, hd = cfg.n_kv_heads, cfg.head_dim_
    k = (enc_out @ p.wk).reshape(B, Se, KVH, hd)
    v = (enc_out @ p.wv).reshape(B, Se, KVH, hd)
    return k, v


# --------------------------------------------------------------------------
# MLA: Multi-head Latent Attention (DeepSeek-V2)
# --------------------------------------------------------------------------

class MLA(nn.Module):
    """Latent-attention weights: ``wq`` (d, H (dn + dr)), ``w_dkv``
    (d, L), ``kv_norm`` (RMSNorm over L), ``w_uk`` (L, H dn), ``w_uv``
    (L, H dv), ``w_kr`` (d, dr), ``wo`` (H dv, d)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        m = cfg.mla
        d, H, dt = cfg.d_model, cfg.n_heads, cfg.np_dtype
        dn, dr, dv, L = m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim, \
            m.kv_lora_rank
        self.wq = _param((d, H * (dn + dr)), dt, device)
        self.w_dkv = _param((d, L), dt, device)
        self.kv_norm = Norm("rmsnorm", L, dt, device)
        self.w_uk = _param((L, H * dn), dt, device)
        self.w_uv = _param((L, H * dv), dt, device)
        self.w_kr = _param((d, dr), dt, device)
        self.wo = _param((H * dv, d), dt, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            for name in ("wq", "w_dkv", "w_uk", "w_uv", "w_kr", "wo"):
                w = getattr(self, name)
                w.copy_(dense_init(gen, w.shape[0], w.shape[1], w.dtype))
            self.kv_norm.reset_parameters()


def init_mla(gen: Optional[torch.Generator], cfg, device=None) -> MLA:
    p = MLA(cfg, device)
    if gen is not None:
        p.reset_parameters(gen)
    return p


def _mla_q(p: MLA, x, cfg, positions, inv_freq_r):
    m = cfg.mla
    B, S, _ = x.shape
    dn, dr = m.qk_nope_dim, m.qk_rope_dim
    q = (x @ p.wq).reshape(B, S, cfg.n_heads, dn + dr)
    return q[..., :dn], apply_rope(q[..., dn:], positions, inv_freq_r)


def mla_prefill(p: MLA, x, cfg, positions, inv_freq_r):
    """Returns (out, cache=(c_kv (B,S,L), k_rope (B,S,dr))): the latent
    cache."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim
    q_nope, q_rope = _mla_q(p, x, cfg, positions, inv_freq_r)
    c = rms_norm(p.kv_norm.scale, x @ p.w_dkv)               # (B,S,L)
    k_nope = (c @ p.w_uk).reshape(B, S, H, dn)
    vv = (c @ p.w_uv).reshape(B, S, H, dv)
    k_r = apply_rope((x @ p.w_kr).reshape(B, S, 1, dr), positions,
                     inv_freq_r)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_r.expand(B, S, H, dr)], dim=-1)
    o = flash_attention(q, k, vv, causal=True, chunk=cfg.attn_chunk)
    out = o.reshape(B, S, -1) @ p.wo
    return out, (c, k_r[:, :, 0, :])


def mla_decode(p: MLA, x, cfg, pos, c_cache, kr_cache, inv_freq_r):
    """Weight-absorbed MLA decode: attention in the latent space.

    x: (B,1,d); c_cache: (B,S,L); kr_cache: (B,S,dr). Writes this
    token's latent and rope key at ``pos`` IN PLACE. Score_t = q_abs .
    c_t + q_r . kr_t, with q_abs = q_nope absorbed through w_uk; the
    output is re-expanded through w_uv. Cache contractions round their
    query operand to the cache's dtype and run in float32, as the
    reference's ``preferred_element_type`` ones.
    """
    m = cfg.mla
    B = x.shape[0]
    H = cfg.n_heads
    dn, dr, dv, L = m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim, \
        m.kv_lora_rank
    pos = int(pos)
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, positions, inv_freq_r)  # (B,1,H,*)
    c_new = rms_norm(p.kv_norm.scale, x @ p.w_dkv)             # (B,1,L)
    kr_new = apply_rope((x @ p.w_kr).reshape(B, 1, 1, dr), positions,
                        inv_freq_r)[:, :, 0, :]
    c_cache[:, pos] = c_new[:, 0].to(c_cache.dtype)
    kr_cache[:, pos] = kr_new[:, 0].to(kr_cache.dtype)
    w_uk = p.w_uk.reshape(L, H, dn)
    q_abs = torch.einsum("bhd,lhd->bhl", _f32(q_nope[:, 0]), _f32(w_uk))
    scale = 1.0 / math.sqrt(dn + dr)
    s_lat = torch.einsum("bhl,bsl->bhs", _f32(q_abs.to(c_cache.dtype)),
                         _f32(c_cache))
    s_rope = torch.einsum("bhd,bsd->bhs",
                          _f32(q_rope[:, 0].to(kr_cache.dtype)),
                          _f32(kr_cache))
    s = (s_lat + s_rope) * scale
    S = c_cache.shape[1]
    valid = torch.arange(S, device=x.device)[None, None, :] <= pos
    s = torch.where(valid, s, NEG_INF)
    att = torch.softmax(s, dim=-1)
    z = torch.einsum("bhs,bsl->bhl", _f32(att.to(c_cache.dtype)),
                     _f32(c_cache))
    w_uv = _f32(p.w_uv.reshape(L, H, dv))
    o = torch.einsum("bhl,lhd->bhd", z, w_uv)                  # (B,H,dv)
    out = o.reshape(B, 1, H * dv).to(x.dtype) @ p.wo
    return out, (c_cache, kr_cache)
