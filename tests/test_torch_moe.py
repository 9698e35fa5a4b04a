"""repro_torch's MoE layer vs the JAX package, on the CPU.

The six cases of ``tests/test_moe.py`` run on the port (routing weights
normalized and capacity respected, no drops with generous capacity, the
dispatched layer equal to the per-token sum of its top-k experts, group
size invariance, shared experts always on, the aux loss preferring
balance). Then the port against the JAX functions on the same weights
(the JAX ``init_moe`` tree carried across): ``_routing``'s top-k
indices, combine and boolean dispatch, and ``moe_mlp``'s output and aux
loss within 1e-5, also at capacity factors 1.0 and 0.5, where tokens are
dropped and the dispatch must equal JAX's exactly (combine within 1e-6).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import MoESettings as JMoESettings
from repro.configs import ModelConfig as JModelConfig
from repro.models.layers import KeyGen
from repro.models import moe as jmoe

from repro_torch.configs import MoESettings, ModelConfig
from repro_torch.models import moe as tmoe
from repro_torch.models.layers import generator

BAR = 1e-5
COMBINE_BAR = 1e-6


def _cfg(E=4, k=2, cf=8.0, group=64, shared=0, jax_side=False):
    settings = (JMoESettings if jax_side else MoESettings)(
        num_experts=E, top_k=k, d_ff_expert=48, num_shared=shared,
        capacity_factor=cf, group_size=group)
    return (JModelConfig if jax_side else ModelConfig)(
        name="t", family="moe", n_layers=1, d_model=32, n_heads=4,
        n_kv_heads=4, d_ff=48, vocab_size=64, dtype="float32",
        moe=settings)


def _port_moe(jp, cfg):
    """The port's MoE module holding the JAX tree ``jp``'s weights."""
    p = tmoe.init_moe(None, cfg, device="cpu")
    with torch.no_grad():
        for name, t in p.named_parameters():
            leaf = jp
            for part in name.split("."):
                leaf = leaf[part]
            t.copy_(torch.from_numpy(np.array(leaf)))
    return p


def _own_moe(cfg, seed=0):
    return tmoe.init_moe(generator(seed, "cpu"), cfg, device="cpu")


# ---- tests/test_moe.py on the port ----------------------------------------

def test_routing_weights_normalized_and_capacity_respected():
    rng = np.random.RandomState(0)
    T, E, k, C = 32, 4, 2, 8
    logits = torch.from_numpy(rng.randn(T, E).astype(np.float32))
    combine, dispatch, aux = tmoe._routing(logits, k, C)
    assert tuple(combine.shape) == (T, E, C)
    assert int(dispatch.sum(dim=0).max()) <= 1
    w = combine.sum(dim=(1, 2))
    assert bool((w <= 1.0 + 1e-5).all())
    assert float(aux) > 0


def test_no_drops_with_generous_capacity():
    rng = np.random.RandomState(1)
    T, E, k = 16, 4, 2
    logits = torch.from_numpy(rng.randn(T, E).astype(np.float32))
    combine, _, _ = tmoe._routing(logits, k, capacity=T)
    np.testing.assert_allclose(combine.sum(dim=(1, 2)).numpy(), 1.0,
                               atol=1e-5)


def test_moe_equals_dense_expert_sum_when_no_drops():
    """With capacity >= tokens, the dispatched computation equals the
    explicit per-token weighted sum over the top-k experts."""
    cfg = _cfg()
    m = cfg.moe
    p = _own_moe(cfg)
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, 8, cfg.d_model).astype(np.float32))
    out, _ = tmoe.moe_mlp(p, x, cfg)

    xt = x.numpy().reshape(-1, cfg.d_model)
    logits = xt @ p.router.numpy()
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    top_i = np.argsort(-probs, axis=-1)[:, :m.top_k]
    expected = np.zeros_like(xt)
    for t in range(xt.shape[0]):
        ws = probs[t, top_i[t]]
        ws = ws / ws.sum()
        for w, e in zip(ws, top_i[t]):
            g = xt[t] @ p.wi_gate[e].numpy()
            u = xt[t] @ p.wi_up[e].numpy()
            h = (g / (1 + np.exp(-g))) * u
            expected[t] += w * (h @ p.wo[e].numpy())
    np.testing.assert_allclose(out.numpy().reshape(-1, cfg.d_model),
                               expected, atol=2e-4)


def test_grouping_invariance():
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 32, 32).astype(np.float32))
    outs = [tmoe.moe_mlp(_own_moe(_cfg(group=group)), x,
                         _cfg(group=group))[0].numpy()
            for group in (16, 32, 64)]
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-5)
    np.testing.assert_allclose(outs[0], outs[2], atol=1e-5)


def test_shared_experts_always_active():
    cfg = _cfg(shared=2)
    p = _own_moe(cfg)
    with torch.no_grad():
        p.wo.zero_()                  # the ROUTED experts output nothing
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(1, 8, 32).astype(np.float32))
    out, _ = tmoe.moe_mlp(p, x, cfg)
    assert float(out.abs().max()) > 0


def test_aux_loss_prefers_balance():
    T, E, k, C = 64, 4, 1, 64
    uniform = torch.zeros((T, E))
    collapsed = torch.zeros((T, E))
    collapsed[:, 0] = 10.0
    _, _, aux_u = tmoe._routing(uniform, k, C)
    _, _, aux_c = tmoe._routing(collapsed, k, C)
    assert float(aux_u) < float(aux_c)


# ---- the port against the JAX functions ------------------------------------

@pytest.mark.parametrize("T,E,k,C", [(32, 4, 2, 8), (24, 8, 3, 4),
                                     (16, 64, 6, 1)])
def test_routing_matches_jax(T, E, k, C):
    """top-k indices (ties too: they set the queue order), combine and
    dispatch against ``_routing``, with and without drops."""
    rng = np.random.RandomState(T + E)
    logits = rng.randn(T, E).astype(np.float32)
    jc, jd, ja = jmoe._routing(jnp.asarray(logits), k, C)
    tc, td, ta = tmoe._routing(torch.from_numpy(logits), k, C)
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    probs[0] = 1.0 / E                      # a padded row: every expert ties
    _, j_top = jax.lax.top_k(jnp.asarray(probs), k)
    _, t_top = tmoe._top_k(torch.from_numpy(probs), k)
    assert np.array_equal(t_top.numpy(), np.asarray(j_top))
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert float(np.abs(tc.numpy() - np.asarray(jc)).max()) < COMBINE_BAR
    assert abs(float(ta) - float(ja)) < BAR


@pytest.mark.parametrize("cf", [8.0, 1.0, 0.5])
@pytest.mark.parametrize("shared", [0, 2])
def test_moe_mlp_matches_jax(cf, shared):
    """out and aux within 1e-5 of ``moe_mlp`` on the same weights; at
    capacity factors that drop tokens the per-group dispatch is JAX's
    exactly (three groups of 16 over 2 x 24 tokens)."""
    jcfg = _cfg(E=8, k=2, cf=cf, group=16, shared=shared, jax_side=True)
    cfg = _cfg(E=8, k=2, cf=cf, group=16, shared=shared)
    jp = jmoe.init_moe(KeyGen(0), jcfg)
    p = _port_moe(jp, cfg)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 24, 32).astype(np.float32)
    jout, jaux = jmoe.moe_mlp(jp, jnp.asarray(x), jcfg)
    stats = {}
    out, aux = tmoe.moe_mlp(p, torch.from_numpy(x), cfg, stats=stats)
    assert float(np.abs(out.numpy() - np.asarray(jout)).max()) < BAR
    assert abs(float(aux) - float(jaux)) < BAR

    group, capacity = tmoe.group_capacity(cfg, 48)
    logits = x.reshape(3, group, 32) @ np.asarray(jp["router"])
    jc, jd, _ = jax.vmap(lambda lg: jmoe._routing(lg, 2, capacity))(
        jnp.asarray(logits))
    tc, td, _ = tmoe._routing(torch.from_numpy(logits), 2, capacity)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert float(np.abs(tc.numpy() - np.asarray(jc)).max()) < COMBINE_BAR
    dropped = 48 * 2 - int(np.asarray(jd).sum())
    assert int(stats["dropped"]) == dropped
    assert stats["assigned"] == 96
    assert (dropped > 0) == (cf < 8.0)


def test_padded_group_matches_jax():
    """T not a multiple of the group: padded rows route too (as in the
    reference) and are cut from the output."""
    jcfg = _cfg(E=4, k=2, cf=1.0, group=16, jax_side=True)
    cfg = _cfg(E=4, k=2, cf=1.0, group=16)
    jp = jmoe.init_moe(KeyGen(1), jcfg)
    p = _port_moe(jp, cfg)
    x = np.random.RandomState(6).randn(3, 7, 32).astype(np.float32)
    jout, jaux = jmoe.moe_mlp(jp, jnp.asarray(x), jcfg)
    out, aux = tmoe.moe_mlp(p, torch.from_numpy(x), cfg)
    assert float(np.abs(out.numpy() - np.asarray(jout)).max()) < BAR
    assert abs(float(aux) - float(jaux)) < BAR


def test_init_moe_shapes_equal_the_reference_tree():
    for shared in (0, 2):
        jp = jmoe.init_moe(KeyGen(0), _cfg(shared=shared, jax_side=True))
        want = {"/".join(str(getattr(k, "key", k)) for k in path): a.shape
                for path, a in jax.tree_util.tree_flatten_with_path(jp)[0]}
        p = _own_moe(_cfg(shared=shared))
        got = {n.replace(".", "/"): tuple(t.shape)
               for n, t in p.named_parameters()}
        assert got == {k: tuple(v) for k, v in want.items()}
        for t in p.parameters():
            assert bool(torch.isfinite(t).all())


@pytest.mark.parametrize("shared", [0, 1])
def test_aux_and_output_gradients_match_jax(shared):
    """Training through the routed layer: the aux loss's gradient reaches
    the router through the stable top-k and the dispatch (nothing
    detaches it), and every weight's gradient of ``sum(out * w) + aux``
    matches JAX's. T = 18 tokens in groups of 8 pads 6 zero rows, which
    tie on every expert."""
    jcfg = _cfg(shared=shared, group=8, cf=1.0, jax_side=True)
    cfg = _cfg(shared=shared, group=8, cf=1.0)
    jp = jmoe.init_moe(KeyGen(3), jcfg)
    rng = np.random.RandomState(4)
    x = rng.randn(2, 9, 32).astype(np.float32)
    w = rng.randn(2, 9, 32).astype(np.float32)

    def jloss(p, aux_only):
        out, aux = jmoe.moe_mlp(p, jnp.asarray(x), jcfg)
        return aux if aux_only else jnp.sum(out * w) + aux

    p = _port_moe(jp, cfg)
    params = dict(p.named_parameters())
    for t in params.values():
        t.requires_grad_(True)
    for aux_only in (True, False):
        jg = jax.grad(jloss)(jp, aux_only)
        out, aux = tmoe.moe_mlp(p, torch.from_numpy(x), cfg)
        loss = aux if aux_only else (out * torch.from_numpy(w)).sum() + aux
        gs = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()), allow_unused=True)))
        if aux_only:
            assert float(gs["router"].abs().max()) > 0
        for name, g in gs.items():
            want = jg
            for part in name.split("."):
                want = want[part]
            want = np.asarray(want)
            g = np.zeros_like(want) if g is None else g.numpy()
            scale = max(float(np.abs(want).max()), 1e-30)
            assert float(np.abs(g - want).max()) <= 1e-4 * scale, \
                (aux_only, name)
