"""repro_torch's attention vs the JAX package, on the CPU.

The forward cases of ``tests/test_attention.py``: the chunked online-
softmax prefill against the S^2 oracle at chunks 4/7/16/64, windows
1/4/9, non-causal and with a query offset; decode over a full cache
against a prefill row; the ring-buffer window cache; bf16 inputs with
float32 accumulation. Every port function takes the same seeded numpy
inputs as its JAX counterpart and is held to it at max-abs 1e-5 in
float32, and at the reference test's own bar in bf16. The flash
backward (``_Flash``) against ``jax.grad`` of the JAX ``flash_attention``
(its ``custom_vjp``): causal chunk 4, window 3, non-causal, GQA, a KV
length no chunk divides and a query offset, at the reference test's 5e-5
in float32, and a bf16 case.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.models import attention as ja
from repro.models.layers import rope_freqs as j_rope_freqs

from repro_torch.models import attention as ta
from repro_torch.models.layers import rope_freqs

BAR = 1e-5          # port against the JAX function, float32
REF_BAR = 2e-5      # tests/test_attention.py: flash against the oracle
BF16_BAR = 3e-2     # tests/test_attention.py: bf16 against float32


def _qkv(B=2, Sq=16, Skv=16, H=4, KVH=2, D=8, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Sq, H, D).astype(np.float32),
            rng.randn(B, Skv, KVH, D).astype(np.float32),
            rng.randn(B, Skv, KVH, D).astype(np.float32))


def _j(*arrs, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrs]


def _t(*arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def _close(got, want, bar=BAR):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    err = float(np.abs(np.asarray(got, np.float32)
                       - np.asarray(want, np.float32)).max())
    assert err < bar, err


@pytest.mark.parametrize("chunk", [4, 7, 16, 64])
def test_flash_matches_jax_causal(chunk):
    q, k, v = _qkv()
    want = ja.flash_attention(*_j(q, k, v), causal=True, chunk=chunk)
    got = ta.flash_attention(*_t(q, k, v), causal=True, chunk=chunk)
    _close(got, want)
    _close(got, ta.attention_ref(*_t(q, k, v), causal=True), REF_BAR)


@pytest.mark.parametrize("window", [1, 4, 9])
def test_flash_matches_jax_window(window):
    q, k, v = _qkv(seed=1)
    want = ja.flash_attention(*_j(q, k, v), causal=True, window=window,
                              chunk=8)
    got = ta.flash_attention(*_t(q, k, v), causal=True, window=window,
                             chunk=8)
    _close(got, want)
    _close(got, ta.attention_ref(*_t(q, k, v), causal=True, window=window),
           REF_BAR)


def test_flash_noncausal():
    q, k, v = _qkv(Sq=8, Skv=24, seed=2)
    want = ja.flash_attention(*_j(q, k, v), causal=False, chunk=8)
    got = ta.flash_attention(*_t(q, k, v), causal=False, chunk=8)
    _close(got, want)
    _close(got, ta.attention_ref(*_t(q, k, v), causal=False), REF_BAR)


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, None, 0), (True, 5, 0), (False, None, 0), (True, None, 6),
    (True, 3, 6)])
def test_attention_ref_matches_jax(causal, window, q_offset):
    q, k, v = _qkv(Sq=6, Skv=12, seed=8)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    _close(ta.attention_ref(*_t(q, k, v), **kw),
           ja.attention_ref(*_j(q, k, v), **kw))
    _close(ta.flash_attention(*_t(q, k, v), chunk=5, **kw),
           ja.flash_attention(*_j(q, k, v), chunk=5, **kw))


def test_decode_attention_matches_prefill_row():
    """Decoding position p over a cache equals row p of full attention."""
    B, S, H, KVH, D = 2, 12, 4, 2, 8
    q, k, v = _qkv(B=B, Sq=S, Skv=S, H=H, KVH=KVH, D=D, seed=5)
    p = 7
    tq, tk, tv = _t(q, k, v)
    jq, jk, jv = _j(q, k, v)
    got = ta.decode_attention(tq[:, p:p + 1], tk, tv, p)
    _close(got, ja.decode_attention(jq[:, p:p + 1], jk, jv, jnp.int32(p)))
    full = ta.attention_ref(tq, tk, tv, causal=True)
    _close(got[:, 0], full[:, p].numpy(), REF_BAR)


def test_decode_window_ring_buffer():
    """Ring-buffer decode equals windowed attention at the same position."""
    B, S, H, KVH, D, W = 1, 20, 2, 1, 4, 8
    q, k, v = _qkv(B=B, Sq=S, Skv=S, H=H, KVH=KVH, D=D, seed=6)
    pos = 13
    k_ring = np.zeros((B, W, KVH, D), np.float32)
    v_ring = np.zeros((B, W, KVH, D), np.float32)
    for p in range(pos + 1):
        k_ring[:, p % W] = k[:, p]
        v_ring[:, p % W] = v[:, p]
    got = ta.decode_attention_window(_t(q)[0][:, pos:pos + 1],
                                     *_t(k_ring, v_ring), pos, W)
    _close(got, ja.decode_attention_window(
        _j(q)[0][:, pos:pos + 1], *_j(k_ring, v_ring), jnp.int32(pos), W))
    full = ta.attention_ref(*_t(q, k, v), causal=True, window=W)
    _close(got[:, 0], full[:, pos].numpy(), REF_BAR)


def test_flash_bf16_accumulates_fp32():
    q, k, v = _qkv(seed=7)
    got = ta.flash_attention(*_t(q, k, v, dtype=torch.bfloat16),
                             causal=True, chunk=8)
    assert got.dtype == torch.bfloat16
    want = ja.flash_attention(*_j(q, k, v, dtype=jnp.bfloat16), causal=True,
                              chunk=8)
    ref = ja.attention_ref(*_j(np.asarray(_j(q, dtype=jnp.bfloat16)[0],
                                          np.float32),
                               np.asarray(_j(k, dtype=jnp.bfloat16)[0],
                                          np.float32),
                               np.asarray(_j(v, dtype=jnp.bfloat16)[0],
                                          np.float32)), causal=True)
    _close(got, np.asarray(want, np.float32), BF16_BAR)
    _close(got, ref, BF16_BAR)


@pytest.mark.parametrize("window", [None, 5])
def test_decode_bf16_cache_contracts_in_f32(window):
    """A bf16 cache is contracted with float32 results (the reference's
    ``preferred_element_type``; the port upcasts both operands)."""
    B, S, H, KVH, D = 2, 10, 4, 2, 8
    q, k, v = _qkv(B=B, Sq=1, Skv=S, H=H, KVH=KVH, D=D, seed=9)
    pos = 6
    tq = _t(q, dtype=torch.bfloat16)[0]
    jq = _j(q, dtype=jnp.bfloat16)[0]
    if window is None:
        got = ta.decode_attention(tq, *_t(k, v, dtype=torch.bfloat16), pos)
        want = ja.decode_attention(jq, *_j(k, v, dtype=jnp.bfloat16),
                                   jnp.int32(pos))
    else:
        got = ta.decode_attention_window(
            tq, *_t(k, v, dtype=torch.bfloat16), pos, window)
        want = ja.decode_attention_window(
            jq, *_j(k, v, dtype=jnp.bfloat16), jnp.int32(pos), window)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(want, np.float32), BF16_BAR)


def _gqa_params(cfg, seed):
    rng = np.random.RandomState(seed)
    d, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    shapes = {"wq": (d, H * hd), "wk": (d, KVH * hd), "wv": (d, KVH * hd),
              "wo": (H * hd, d), "bq": (H * hd,), "bk": (KVH * hd,),
              "bv": (KVH * hd,)}
    return {n: (rng.randn(*s) * 0.2).astype(np.float32)
            for n, s in shapes.items()}


@pytest.mark.parametrize("window", [None, 4])
def test_gqa_prefill_and_decode_match_jax(window):
    """The GQA block: projections, biases and RoPE, prefill through the
    chunked attention, and decode writing the cache at ``pos`` (a ring
    slot with a window)."""
    cfg = types.SimpleNamespace(d_model=16, n_heads=4, n_kv_heads=2,
                                head_dim_=8, qkv_bias=True, attn_chunk=3)
    params = _gqa_params(cfg, 11)
    tp = ta.GQA(types.SimpleNamespace(np_dtype=torch.float32, **vars(cfg)),
                "cpu")
    for n, a in params.items():
        getattr(tp, n).data.copy_(torch.from_numpy(a))
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    B, S = 2, 7
    x = np.random.RandomState(12).randn(B, S, 16).astype(np.float32)
    pos_np = np.broadcast_to(np.arange(S), (B, S))
    inv, jinv = rope_freqs(8, 1e4), j_rope_freqs(8, 1e4)
    _close(inv, jinv)
    got, (k, v) = ta.gqa_prefill(tp, torch.from_numpy(x), cfg,
                                 torch.from_numpy(pos_np.copy()), inv,
                                 window=window)
    want, (jk, jv) = ja.gqa_prefill(jp, jnp.asarray(x), cfg,
                                    jnp.asarray(pos_np), jinv, window=window)
    _close(got, want)
    _close(k, jk)
    _close(v, jv)
    W = 4 if window else 12
    cache_k = np.zeros((B, W, 2, 8), np.float32)
    cache_v = np.zeros((B, W, 2, 8), np.float32)
    tk, tv = _t(cache_k, cache_v)
    jk, jv = _j(cache_k, cache_v)
    for pos in range(6):
        xt = np.random.RandomState(20 + pos).randn(B, 1, 16).astype(
            np.float32)
        got, (tk, tv) = ta.gqa_decode(tp, torch.from_numpy(xt), cfg, pos,
                                      tk, tv, inv, window=window)
        want, (jk, jv) = ja.gqa_decode(jp, jnp.asarray(xt), cfg,
                                       jnp.int32(pos), jk, jv, jinv,
                                       window=window)
        _close(got, want)
        _close(tk, jk)
        _close(tv, jv)


# --------------------------------------------------------------------------
# the flash backward
# --------------------------------------------------------------------------

GRAD_BAR = 5e-5     # tests/test_attention.py: custom VJP against autodiff
GRAD_CASES = {
    "causal-chunk4": dict(shape=dict(B=1, Sq=8, Skv=8, H=2, KVH=1, D=4),
                          kw=dict(causal=True, chunk=4)),
    "window3": dict(shape=dict(B=1, Sq=10, Skv=10, H=2, KVH=2, D=4),
                    kw=dict(causal=True, window=3, chunk=4)),
    "noncausal": dict(shape=dict(B=2, Sq=8, Skv=24, H=4, KVH=2, D=8),
                      kw=dict(causal=False, chunk=8)),
    "gqa": dict(shape=dict(B=2, Sq=12, Skv=12, H=8, KVH=2, D=8),
                kw=dict(causal=True, chunk=4)),
    "skv-not-multiple": dict(shape=dict(B=2, Sq=13, Skv=13, H=4, KVH=2,
                                        D=8),
                             kw=dict(causal=True, chunk=5)),
    "q-offset": dict(shape=dict(B=2, Sq=5, Skv=13, H=4, KVH=2, D=8),
                     kw=dict(causal=True, chunk=4, q_offset=8)),
}


def _flash_grads_jax(q, k, v, dtype, kw):
    def loss(q, k, v):
        out = ja.flash_attention(q, k, v, **kw)
        return jnp.sum(out.astype(jnp.float32) ** 2)
    return jax.grad(loss, argnums=(0, 1, 2))(*_j(q, k, v, dtype=dtype))


def _flash_grads_port(q, k, v, dtype, kw):
    ts = [t.requires_grad_(True) for t in _t(q, k, v, dtype=dtype)]
    out = ta.flash_attention(*ts, **kw)
    return torch.autograd.grad((out.float() ** 2).sum(), ts)


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_flash_grads_match_jax(case):
    c = GRAD_CASES[case]
    q, k, v = _qkv(seed=3, **c["shape"])
    want = _flash_grads_jax(q, k, v, jnp.float32, c["kw"])
    got = _flash_grads_port(q, k, v, torch.float32, c["kw"])
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        _close(g, w, GRAD_BAR)


def test_flash_grads_match_autograd_through_ref():
    """The backward equals autograd through the S^2 oracle (the
    reference's own check, on the port alone)."""
    q, k, v = _qkv(B=1, Sq=8, Skv=8, H=2, KVH=1, D=4, seed=3)
    got = _flash_grads_port(q, k, v, torch.float32,
                            dict(causal=True, chunk=4))
    ts = [t.requires_grad_(True) for t in _t(q, k, v)]
    ref = torch.autograd.grad(
        (ta.attention_ref(*ts, causal=True) ** 2).sum(), ts)
    for g, r in zip(got, ref):
        _close(g, r.detach().numpy(), GRAD_BAR)


def test_flash_grads_bf16():
    """bf16 inputs: gradients in bf16, within the bf16 bar of JAX's."""
    q, k, v = _qkv(B=2, Sq=12, Skv=12, H=4, KVH=2, D=8, seed=5)
    kw = dict(causal=True, chunk=4)
    want = _flash_grads_jax(q, k, v, jnp.bfloat16, kw)
    got = _flash_grads_port(q, k, v, torch.bfloat16, kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        scale = float(np.abs(np.asarray(w, np.float32)).max())
        _close(g, w, BF16_BAR * scale)


def test_flash_without_grad_records_no_graph():
    """Inputs that do not require grad take the plain forward."""
    q, k, v = _t(*_qkv(seed=1))
    out = ta.flash_attention(q, k, v, causal=True, chunk=4)
    assert out.grad_fn is None
