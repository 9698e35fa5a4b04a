"""repro_torch's RWKV-6 and RG-LRU recurrences vs the JAX package, on
the CPU.

The inference cases of ``tests/test_recurrent.py`` run on the port: the
WKV-6 scan against a naive float64 loop, chunk invariance, the RG-LRU
scan against the sequential decode step, the state carry, the decay in
(0, 1), the causal conv against numpy. Then the port against the JAX
functions on the same weights (the JAX trees carried across) and inputs,
within max-abs 1e-5: ``wkv6_scan`` (the port steps where the reference
scans in chunks), ``rglru_scan`` (sequential where the reference runs an
associative scan), ``recurrent_block_seq`` and ``recurrent_block_step``,
``time_mix_seq`` and ``channel_mix_seq`` with and without a carried
state. The gradient case waits for the training half (ROADMAP.md queue 1
step 2c).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.configs import ModelConfig as JModelConfig
from repro.models import rglru as jrg
from repro.models import rwkv as jrw
from repro.models.layers import KeyGen

from repro_torch.configs import ModelConfig
from repro_torch.models import rglru, rwkv
from repro_torch.models.layers import generator

BAR = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _close(got, want, bar=BAR):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    err = float(np.abs(got - np.asarray(want, np.float64)).max())
    assert err < bar, err


def _load(module, tree):
    with torch.no_grad():
        for name, t in module.named_parameters():
            leaf = tree
            for part in name.split("."):
                leaf = leaf[part]
            t.copy_(torch.from_numpy(np.array(leaf)))
    return module


def _naive_wkv(r, k, v, w, u):
    B, T, H, hd = r.shape
    S = np.zeros((B, H, hd, hd), np.float64)
    ys = np.zeros((B, T, H, hd), np.float64)
    for t in range(T):
        for b in range(B):
            for h in range(H):
                kv = np.outer(k[b, t, h], v[b, t, h])
                ys[b, t, h] = r[b, t, h] @ (S[b, h] + u[h][:, None] * kv)
                S[b, h] = w[b, t, h][:, None] * S[b, h] + kv
    return ys, S


def _wkv_inputs(seed, B=2, T=12, H=2, hd=4):
    rng = np.random.RandomState(seed)
    r, k, v = (rng.randn(B, T, H, hd).astype(np.float32) for _ in range(3))
    w = rng.rand(B, T, H, hd).astype(np.float32) * 0.5 + 0.4
    u = rng.randn(H, hd).astype(np.float32)
    return r, k, v, w, u


# ---- tests/test_recurrent.py on the port ----------------------------------

def test_wkv6_scan_matches_naive_loop():
    r, k, v, w, u = _wkv_inputs(0)
    ys, S = rwkv.wkv6_scan(*map(_t, (r, k, v, w, u)))
    ys_n, S_n = _naive_wkv(r, k, v, w, u)
    np.testing.assert_allclose(ys.numpy(), ys_n, atol=1e-4)
    np.testing.assert_allclose(S.numpy(), S_n, atol=1e-4)


@pytest.mark.parametrize("chunk", [1, 3, 4, 12, 128])
def test_wkv6_chunking_invariance(chunk):
    r, k, v, w, u = _wkv_inputs(1, B=1)
    args = list(map(_t, (r, k, v, w, u)))
    y1, S1 = rwkv.wkv6_scan(*args, chunk=chunk)
    y2, S2 = rwkv.wkv6_scan(*args, chunk=12)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-5)
    np.testing.assert_allclose(S1.numpy(), S2.numpy(), atol=1e-5)
    # and the reference's chunked scan at the same chunk
    jy, jS = jrw.wkv6_scan(*map(jnp.asarray, (r, k, v, w, u)), chunk=chunk)
    _close(y1, jy)
    _close(S1, jS)


def test_wkv6_refuses_a_chunk_below_one():
    with pytest.raises(ValueError, match="chunk"):
        rwkv.wkv6_scan(*map(_t, _wkv_inputs(2)), chunk=0)


def _rg_cfg(jax_side=False):
    return (JModelConfig if jax_side else ModelConfig)(
        name="t", family="hybrid", n_layers=3, d_model=16, n_heads=2,
        n_kv_heads=1, d_ff=32, vocab_size=64, dtype="float32",
        block_pattern=("rec", "rec", "attn"), window=8, lru_width=16,
        conv_width=4)


def _rg(seed):
    """The JAX RG-LRU tree of ``seed`` and the port's module holding it."""
    jp = jrg.init_rglru(KeyGen(seed), _rg_cfg(True))
    return jp, _load(rglru.init_rglru(None, _rg_cfg(), device="cpu"), jp)


def test_rglru_scan_matches_sequential():
    cfg = _rg_cfg()
    p = rglru.init_rglru(generator(0, "cpu"), cfg, device="cpu")
    x = _t(np.random.RandomState(3).randn(2, 10, cfg.lru_width))
    y_scan, h_last = rglru.rglru_scan(p, x, cfg)
    h = torch.zeros((2, cfg.lru_width))
    outs = []
    for t in range(10):
        o, h = rglru.rglru_step(p, x[:, t], h, cfg)
        outs.append(o.numpy())
    np.testing.assert_allclose(y_scan.numpy(), np.stack(outs, axis=1),
                               atol=1e-5)
    np.testing.assert_allclose(h_last.numpy(), h.numpy(), atol=1e-5)


def test_rglru_state_carry_equals_concatenation():
    cfg = _rg_cfg()
    p = rglru.init_rglru(generator(1, "cpu"), cfg, device="cpu")
    x = _t(np.random.RandomState(4).randn(1, 12, cfg.lru_width))
    y_full, _ = rglru.rglru_scan(p, x, cfg)
    _, h1 = rglru.rglru_scan(p, x[:, :5], cfg)
    y2, _ = rglru.rglru_scan(p, x[:, 5:], cfg, h0=h1)
    np.testing.assert_allclose(y_full[:, 5:].numpy(), y2.numpy(), atol=1e-5)


def test_rglru_decay_in_unit_interval():
    cfg = _rg_cfg()
    p = rglru.init_rglru(generator(2, "cpu"), cfg, device="cpu")
    x = _t(np.random.RandomState(5).randn(1, 4, cfg.lru_width))
    a, beta, _ = rglru._gates(p, x, cfg.n_heads)
    assert float(a.min()) > 0.0 and float(a.max()) < 1.0
    np.testing.assert_allclose((a ** 2 + beta ** 2).numpy(), 1.0, atol=1e-5)


def test_causal_conv_matches_numpy():
    cfg = _rg_cfg()
    p = rglru.init_rglru(generator(3, "cpu"), cfg, device="cpu")
    x = np.random.RandomState(6).randn(1, 7, cfg.lru_width).astype(
        np.float32)
    y, tail = rglru.causal_conv(p, _t(x))
    w = p.conv_w.numpy()
    xp = np.concatenate([np.zeros((1, 3, cfg.lru_width), np.float32), x],
                        axis=1)
    expect = sum(xp[:, k:k + 7] * w[k] for k in range(4)) + p.conv_b.numpy()
    np.testing.assert_allclose(y.numpy(), expect, atol=1e-5)
    np.testing.assert_allclose(tail.numpy(), xp[:, -3:], atol=1e-6)


# ---- the port against the JAX functions -----------------------------------

def test_rglru_scan_matches_jax():
    """The sequential scan against the reference's associative scan, from
    zeros and from a carried state."""
    jp, p = _rg(7)
    cfg, jcfg = _rg_cfg(), _rg_cfg(True)
    rng = np.random.RandomState(7)
    x = rng.randn(2, 10, 16).astype(np.float32)
    h0 = rng.randn(2, 16).astype(np.float32)
    for carried in (None, h0):
        jy, jh = jrg.rglru_scan(jp, jnp.asarray(x), jcfg,
                                h0=None if carried is None
                                else jnp.asarray(carried))
        y, h = rglru.rglru_scan(p, _t(x), cfg,
                                h0=None if carried is None else _t(carried))
        _close(y, jy)
        _close(h, jh)


def test_recurrent_block_matches_jax():
    """``recurrent_block_seq`` over 6 steps then ``recurrent_block_step``
    over 3, carrying the state, against the reference's."""
    jp, p = _rg(8)
    cfg, jcfg = _rg_cfg(), _rg_cfg(True)
    x = np.random.RandomState(8).randn(2, 9, 16).astype(np.float32)
    jout, jst = jrg.recurrent_block_seq(jp, jnp.asarray(x[:, :6]), jcfg)
    out, st = rglru.recurrent_block_seq(p, _t(x[:, :6]), cfg)
    _close(out, jout)
    for t in range(6, 9):
        jout, jst = jrg.recurrent_block_step(jp, jnp.asarray(x[:, t:t + 1]),
                                             jcfg, jst)
        out, st = rglru.recurrent_block_step(p, _t(x[:, t:t + 1]), cfg, st)
        _close(out, jout)
    _close(st["h"], jst["h"])
    _close(st["conv"], jst["conv"])
    # a carried state through the sequence form
    jout, _ = jrg.recurrent_block_seq(jp, jnp.asarray(x[:, 6:]), jcfg, jst)
    out, _ = rglru.recurrent_block_seq(p, _t(x[:, 6:]), cfg, st)
    _close(out, jout)


def test_wkv6_scan_matches_jax_with_a_carried_state():
    r, k, v, w, u = _wkv_inputs(9)
    S0 = np.random.RandomState(9).randn(2, 2, 4, 4).astype(np.float32)
    jy, jS = jrw.wkv6_scan(*map(jnp.asarray, (r, k, v, w, u)),
                           S0=jnp.asarray(S0), chunk=4)
    y, S = rwkv.wkv6_scan(*map(_t, (r, k, v, w, u)), S0=_t(S0), chunk=4)
    _close(y, jy)
    _close(S, jS)


def _rwkv_cfg(jax_side=False):
    return (JModelConfig if jax_side else ModelConfig)(
        name="t", family="ssm", n_layers=1, d_model=32, n_heads=4,
        n_kv_heads=4, d_ff=64, vocab_size=64, dtype="float32",
        rwkv_head_size=8, rwkv_ddlora=8, rwkv_decay_lora=8)


def test_time_and_channel_mix_match_jax():
    """Sequence mode over 7 steps, then one step from the carried state
    (the decode form), for the time mix and the channel mix."""
    cfg, jcfg = _rwkv_cfg(), _rwkv_cfg(True)
    jtm = jrw.init_time_mix(KeyGen(10), jcfg)
    jcm = jrw.init_channel_mix(KeyGen(11), jcfg)
    tm = _load(rwkv.init_time_mix(None, cfg, device="cpu"), jtm)
    cm = _load(rwkv.init_channel_mix(None, cfg, device="cpu"), jcm)
    x = np.random.RandomState(10).randn(2, 8, 32).astype(np.float32)
    jout, jst = jrw.time_mix_seq(jtm, jnp.asarray(x[:, :7]), jcfg)
    out, st = rwkv.time_mix_seq(tm, _t(x[:, :7]), cfg)
    _close(out, jout)
    jout, jst2 = jrw.time_mix_seq(jtm, jnp.asarray(x[:, 7:]), jcfg, jst)
    out, st2 = rwkv.time_mix_seq(tm, _t(x[:, 7:]), cfg, st)
    _close(out, jout)
    _close(st2["S"], jst2["S"])
    _close(st2["x_tm"], jst2["x_tm"])
    jout, jst = jrw.channel_mix_seq(jcm, jnp.asarray(x[:, :7]))
    out, st = rwkv.channel_mix_seq(cm, _t(x[:, :7]))
    _close(out, jout)
    jout, _ = jrw.channel_mix_seq(jcm, jnp.asarray(x[:, 7:]), jst)
    out, _ = rwkv.channel_mix_seq(cm, _t(x[:, 7:]), st)
    _close(out, jout)


def test_mix_param_shapes_equal_the_reference_tree():
    cfg, jcfg = _rwkv_cfg(), _rwkv_cfg(True)
    for jtree, mod in ((jrw.init_time_mix(KeyGen(0), jcfg),
                        rwkv.init_time_mix(generator(0, "cpu"), cfg, "cpu")),
                       (jrw.init_channel_mix(KeyGen(0), jcfg),
                        rwkv.init_channel_mix(generator(0, "cpu"), cfg,
                                              "cpu")),
                       (jrg.init_rglru(KeyGen(0), _rg_cfg(True)),
                        rglru.init_rglru(generator(0, "cpu"), _rg_cfg(),
                                         "cpu"))):
        got = {n: tuple(t.shape) for n, t in mod.named_parameters()}
        assert got == {k: tuple(a.shape) for k, a in jtree.items()}
        assert all(bool(torch.isfinite(t).all()) for t in mod.parameters())
