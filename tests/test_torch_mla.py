"""repro_torch's MLA and cross attention vs the JAX package, on the CPU.

The JAX ``init_mla``/``init_cross`` trees carried into the port's
modules, the same seeded inputs through both: ``mla_prefill``'s output
and latent cache, and each weight-absorbed ``mla_decode`` step (output
and the cache it writes) within max-abs 1e-5 of JAX; decode against the
prefill's row at its position (absorption changes the contraction
order only); ``cross_kv`` and ``cross_attention`` within 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.configs import MLASettings as JMLASettings
from repro.configs import ModelConfig as JModelConfig
from repro.models import attention as ja
from repro.models.layers import KeyGen
from repro.models.layers import rope_freqs as j_rope_freqs

from repro_torch.configs import MLASettings, ModelConfig
from repro_torch.models import attention as ta
from repro_torch.models.layers import rope_freqs

BAR = 1e-5
B, S = 2, 12


def _cfg(jax_side=False, chunk=4):
    kw = dict(name="t", family="moe", n_layers=1, d_model=48, n_heads=4,
              n_kv_heads=4, d_ff=64, vocab_size=64, dtype="float32",
              attn_chunk=chunk)
    if jax_side:
        return JModelConfig(mla=JMLASettings(kv_lora_rank=24, qk_nope_dim=8,
                                             qk_rope_dim=6, v_head_dim=10),
                            **kw)
    return ModelConfig(mla=MLASettings(kv_lora_rank=24, qk_nope_dim=8,
                                       qk_rope_dim=6, v_head_dim=10), **kw)


def _load(module, tree):
    with torch.no_grad():
        for name, t in module.named_parameters():
            leaf = tree
            for part in name.split("."):
                leaf = leaf[part]
            t.copy_(torch.from_numpy(np.array(leaf)))
    return module


def _close(got, want, bar=BAR):
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    assert err < bar, err


@pytest.fixture(scope="module")
def mla():
    jcfg, cfg = _cfg(True), _cfg()
    jp = ja.init_mla(KeyGen(0), jcfg)
    p = _load(ta.init_mla(None, cfg, device="cpu"), jp)
    x = np.random.RandomState(0).randn(B, S, cfg.d_model).astype(np.float32)
    return jcfg, cfg, jp, p, x


def _positions(S0, S1):
    pos = np.broadcast_to(np.arange(S0, S1), (B, S1 - S0))
    return jnp.asarray(pos, jnp.int32), torch.from_numpy(pos.astype(np.int64))


@pytest.mark.parametrize("chunk", [4, 5, 64])
def test_mla_prefill_matches_jax(mla, chunk):
    jcfg, cfg, jp, p, x = mla
    jcfg, cfg = _cfg(True, chunk), _cfg(chunk=chunk)
    jpos, tpos = _positions(0, S)
    dr = cfg.mla.qk_rope_dim
    jout, (jc, jkr) = ja.mla_prefill(jp, jnp.asarray(x), jcfg, jpos,
                                     j_rope_freqs(dr, jcfg.rope_theta))
    out, (c, kr) = ta.mla_prefill(p, torch.from_numpy(x), cfg, tpos,
                                  rope_freqs(dr, cfg.rope_theta))
    _close(out, jout)
    _close(c, jc)
    _close(kr, jkr)
    assert tuple(c.shape) == (B, S, cfg.mla.kv_lora_rank)
    assert tuple(kr.shape) == (B, S, dr)


def test_mla_decode_matches_jax_and_prefill(mla):
    """Prefill 8 tokens, then decode the rest one at a time into a cache
    of 16: each step within 1e-5 of JAX's decode and of the full
    prefill's row; the caches agree."""
    jcfg, cfg, jp, p, x = mla
    dr, S0, max_len = cfg.mla.qk_rope_dim, 8, 16
    jinv, tinv = j_rope_freqs(dr, jcfg.rope_theta), rope_freqs(
        dr, cfg.rope_theta)
    jpos, tpos = _positions(0, S)
    full, _ = ta.mla_prefill(p, torch.from_numpy(x), cfg, tpos, tinv)
    _, (c, kr) = ta.mla_prefill(p, torch.from_numpy(x[:, :S0]), cfg,
                                tpos[:, :S0], tinv)
    c_cache = torch.zeros((B, max_len, cfg.mla.kv_lora_rank))
    kr_cache = torch.zeros((B, max_len, dr))
    c_cache[:, :S0], kr_cache[:, :S0] = c, kr
    jc_cache, jkr_cache = jnp.asarray(c_cache.numpy()), jnp.asarray(
        kr_cache.numpy())
    for t in range(S0, S):
        jout, (jc_cache, jkr_cache) = ja.mla_decode(
            jp, jnp.asarray(x[:, t:t + 1]), jcfg, jnp.int32(t), jc_cache,
            jkr_cache, jinv)
        out, (c2, kr2) = ta.mla_decode(p, torch.from_numpy(x[:, t:t + 1]),
                                       cfg, t, c_cache, kr_cache, tinv)
        assert c2 is c_cache and kr2 is kr_cache      # written in place
        _close(out, jout)
        _close(out[:, 0], full[:, t].numpy())
    _close(c_cache, jc_cache)
    _close(kr_cache, jkr_cache)


def test_mla_param_shapes_equal_the_reference_tree(mla):
    _, _, jp, p, _ = mla
    want = {"wq", "w_dkv", "w_uk", "w_uv", "w_kr", "wo", "kv_norm.scale"}
    assert {n for n, _ in p.named_parameters()} == want
    for name, t in p.named_parameters():
        leaf = jp
        for part in name.split("."):
            leaf = leaf[part]
        assert tuple(t.shape) == tuple(leaf.shape), name


def test_cross_attention_matches_jax():
    kw = dict(name="t", family="encdec", n_layers=1, d_model=32, n_heads=4,
              n_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32",
              attn_chunk=5)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    jp = ja.init_cross(KeyGen(1), jcfg)
    p = _load(ta.init_cross(None, cfg, device="cpu"), jp)
    rng = np.random.RandomState(1)
    x = rng.randn(B, 6, 32).astype(np.float32)
    enc = rng.randn(B, 11, 32).astype(np.float32)
    jk, jv = ja.cross_kv(jp, jnp.asarray(enc), jcfg)
    k, v = ta.cross_kv(p, torch.from_numpy(enc), cfg)
    _close(k, jk)
    _close(v, jv)
    _close(ta.cross_attention(p, torch.from_numpy(x), k, v, cfg),
           ja.cross_attention(jp, jnp.asarray(x), jk, jv, jcfg))
