"""repro_torch's parallel layer vs the JAX package, on the CPU.

Meshes are the port's in-process ``Mesh`` over ``("cpu",) * 8``. The
reshard round trip (4, 2) -> (2, 4) is bit for bit, as
``tests/test_distributed.py`` checks the reference's; the sharded train
step (smoke qwen, seq 16, batch 4) is within 1e-4 of the JAX single step
from a carried state and of the port's own single step (equal bit for
bit with one batch replica); ``accumulate_gradients(grad_shardings=)``
equals the unsharded accumulator bit for bit; ``compressed_psum`` against
the reference's under ``jax.vmap(axis_name=)``; sharded decode logits
against unsharded ones; the activation hints (``pshint``) against the
reference's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.launch import train as jtrain
from repro.models import build_model as j_build
from repro.models import pshint as jpshint
from repro.optim import grad as jgrad

from repro_torch import convert, optim
from repro_torch.configs import RunConfig, get_smoke_config
from repro_torch.launch import serve as tserve
from repro_torch.launch import sharding as shd
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model, pshint
from repro_torch.models.model import abstract_params
from repro_torch.runtime import reshard_tree

SMOKE = "qwen2.5-3b"
STEP_BAR = 1e-4          # tests/test_distributed.py's sharded-step bar


def _mesh(shape, names=("data", "model")):
    return make_mesh(shape, names, devices=("cpu",) * 8)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# --------------------------------------------------------------------------
# reshard
# --------------------------------------------------------------------------

def test_reshard_round_trip_bit_for_bit():
    tree = {"layers": {str(i): {"mlp": {"wi_gate": torch.arange(
        8 * 16, dtype=torch.float32).reshape(8, 16) * (i + 1) + 0.25}}
        for i in range(4)}, "ln_f": {"scale": torch.linspace(0, 1, 16)}}
    mesh_a, mesh_b = _mesh((4, 2)), _mesh((2, 4))

    def spec_fn_for(mesh):
        return lambda path, leaf: shd.spec_for_param(path, leaf.shape, mesh)

    t_a = reshard_tree(tree, mesh_a, spec_fn_for(mesh_a))
    t_b = reshard_tree(t_a, mesh_b, spec_fn_for(mesh_b))
    leaf = t_b["layers"]["2"]["mlp"]["wi_gate"]
    assert isinstance(leaf, shd.ShardedTensor)
    assert "model" in tuple(leaf.spec) and leaf.mesh is mesh_b
    for i in range(4):
        want = tree["layers"][str(i)]["mlp"]["wi_gate"]
        got = t_b["layers"][str(i)]["mlp"]["wi_gate"]
        assert torch.equal(got.full(), want)
        for e, b in enumerate(got.blocks):
            assert torch.equal(b, want[got.sharding.block_slices(
                want.shape, e)])
            assert b.device == mesh_b.devices[e]
    assert torch.equal(t_b["ln_f"]["scale"].full(), tree["ln_f"]["scale"])
    assert t_b["ln_f"]["scale"].spec == shd.P(None)


# --------------------------------------------------------------------------
# the sharded train step
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def carried():
    """The JAX qwen smoke model 2 steps into training, a batch, and the
    reference's single step's metrics from there."""
    jcfg = jconfigs.get_smoke_config(SMOKE)
    jm = j_build(jcfg)
    run = jconfigs.RunConfig(seed=0, warmup_steps=1)
    state = jtrain.init_state(jm, run)
    step = jax.jit(jtrain.make_train_step(jm, run, total_steps=100))
    for s in range(2):
        state, _ = step(state, jm.dummy_batch(
            jconfigs.ShapeConfig("t", "train", 16, 4), seed=10 + s))
    batch = jm.dummy_batch(jconfigs.ShapeConfig("t", "train", 16, 4), seed=3)
    _, metrics = step(state, batch)
    return dict(state=_np(state), batch=_np(batch), metrics=_np(metrics))


def _port(carried):
    model = build_model(get_smoke_config(SMOKE), device="cpu")
    return model, convert.train_state_from_reference(model, carried["state"])


@pytest.mark.parametrize("shape", [(4, 2), (1, 8)])
def test_sharded_train_step_matches_single(carried, shape):
    run = RunConfig(seed=0, warmup_steps=1)
    model, state = _port(carried)
    step = ttrain.make_train_step(model, run, total_steps=100)
    _, single = step(state, carried["batch"])
    model, state = _port(carried)
    step = ttrain.make_train_step(model, run, total_steps=100)
    sstep, shardings = ttrain.shard_train_step(
        step, model, _mesh(shape), abstract_params(model.cfg),
        carried["batch"])
    new, metrics = sstep(state, carried["batch"])
    want = float(carried["metrics"]["loss"])
    for key in ("loss", "gnorm"):
        ref = float(carried["metrics"][key])
        assert abs(float(metrics[key]) - ref) <= STEP_BAR * abs(ref), key
        assert abs(float(metrics[key]) - float(single[key])) <= \
            STEP_BAR * abs(float(single[key])), key
    assert abs(float(metrics["loss"]) - want) <= STEP_BAR * want
    if shape == (1, 8):        # one batch replica: the same computation
        assert float(metrics["loss"]) == float(single["loss"])
    assert int(new.opt.step) == 3
    assert set(new.params) == set(shardings.params)
    for name, st in new.params.items():
        assert st.sharding == shardings.params[name]
        assert new.opt.m[name].sharding == shardings.opt.m[name]
    # the updated blocks equal the single step's parameters
    model2, state2 = _port(carried)
    new2, _ = ttrain.make_train_step(model2, run, total_steps=100)(
        state2, carried["batch"])
    for name, st in new.params.items():
        err = float((st.full() - new2.params[name].detach()).abs().max())
        assert err <= 1e-5, name


def test_sharded_step_takes_a_laid_out_state_twice(carried):
    """Two steps from one state: the second takes the first's laid-out
    state, and both stay within the bar of the single steps."""
    run = RunConfig(seed=0, warmup_steps=1)
    mesh = _mesh((4, 2))
    model, state = _port(carried)
    step = ttrain.make_train_step(model, run, total_steps=100)
    sstep, shardings = ttrain.shard_train_step(
        step, model, mesh, abstract_params(model.cfg), carried["batch"])
    s1 = ttrain.shard_state(state, shardings, donate=True)
    assert not state.opt.m          # donated
    s1, a = sstep(s1, carried["batch"])
    _, b = sstep(s1, carried["batch"])
    model, state = _port(carried)
    step = ttrain.make_train_step(model, run, total_steps=100)
    u1, c = step(state, carried["batch"])
    _, d = step(u1, carried["batch"])
    for got, want in ((a, c), (b, d)):
        for key in ("loss", "gnorm"):
            assert abs(float(got[key]) - float(want[key])) <= \
                STEP_BAR * abs(float(want[key]))


def test_accumulate_gradients_sharded_equals_unsharded(carried):
    model, state = _port(carried)
    mesh = _mesh((4, 2))
    shardings = shd.param_shardings(state.params, mesh)
    batch = {k: torch.from_numpy(v.astype(np.int64)).reshape(2, 2, -1)
             for k, v in carried["batch"].items()}
    loss, grads = optim.accumulate_gradients(model.loss, state.params, batch,
                                             grad_shardings=shardings)
    uloss, ugrads = optim.accumulate_gradients(model.loss, state.params,
                                               batch)
    assert float(loss) == float(uloss)
    for name, g in ugrads.items():
        got = grads[name]
        assert isinstance(got, shd.ShardedTensor)
        assert got.dtype == torch.float32 and got.sharding == shardings[name]
        assert torch.equal(got.full(), g), name


# --------------------------------------------------------------------------
# int8 all-reduce
# --------------------------------------------------------------------------

@pytest.mark.parametrize("with_residual", [False, True])
def test_compressed_psum_matches_reference(with_residual):
    mesh = _mesh((4, 2))
    rng = np.random.RandomState(7)
    g = rng.randn(4, 2, 33, 5).astype(np.float32)
    r = (rng.randn(4, 2, 33, 5).astype(np.float32) * 0.01
         if with_residual else None)
    entry = {(d, m): 2 * d + m for d in range(4) for m in range(2)}
    tg = {e: torch.from_numpy(g[d, m]) for (d, m), e in entry.items()}
    tr = None if r is None else {e: torch.from_numpy(r[d, m])
                                 for (d, m), e in entry.items()}
    total, res = optim.grad.compressed_psum(tg, mesh, "data", tr)
    for m in range(2):
        if r is None:
            jt, jr = jax.vmap(lambda x: jgrad.compressed_psum(x, "i"),
                              axis_name="i")(jnp.asarray(g[:, m]))
        else:
            jt, jr = jax.vmap(lambda x, y: jgrad.compressed_psum(x, "i", y),
                              axis_name="i")(jnp.asarray(g[:, m]),
                                             jnp.asarray(r[:, m]))
        for d in range(4):
            e = entry[(d, m)]
            q, _, _ = optim.compress_int8(tg[e], None if tr is None
                                          else tr[e])
            jq, _, _ = jgrad.compress_int8(
                jnp.asarray(g[d, m]),
                None if r is None else jnp.asarray(r[d, m]))
            np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(res[e].numpy(), np.asarray(jr[d]))
            want = np.asarray(jt[d])
            assert np.abs(total[e].numpy() - want).max() <= \
                1e-6 * np.abs(want).max()


# --------------------------------------------------------------------------
# sharded decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2.5-3b", "rwkv6-3b",
                                  "recurrentgemma-9b"])
@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 1, 8)])
def test_sharded_decode_logits_equal_unsharded(arch, shape):
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu")
    mesh = _mesh(shape, ("pod", "data", "model"))
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (4, 6)).astype(np.int64))
    fn, like, cspecs = tserve.shard_decode_step(model, mesh,
                                                abstract_params(cfg), 4, 16)
    _, cache, pos = model.prefill({"tokens": tokens}, 16)
    got, cache = fn(cache, tokens[:, -1:], pos)       # plain, in place
    _, ucache, _ = model.prefill({"tokens": tokens}, 16)
    want, ucache = tserve.make_decode_fn(model)(ucache, tokens[:, -1:], pos)
    scale = float(want.abs().max())
    if shape == (1, 1, 8):   # one batch replica: the same computation
        assert torch.equal(got, want)
    assert float((got - want).abs().max()) <= 1e-6 * scale
    # the laid-out form: a second step from the sharded state
    scache = tserve._tree_map(
        lambda c, s: shd.ShardedTensor.scatter(c, shd.NamedSharding(mesh, s)),
        cache, cspecs)
    got2, scache = fn(scache, tokens[:, :1], pos + 1)
    want2, _ = tserve.make_decode_fn(model)(ucache, tokens[:, :1], pos + 1)
    assert float((got2 - want2).abs().max()) <= 1e-6 * float(
        want2.abs().max())
    leaf = next(iter(tserve._leaves(scache)))
    assert isinstance(leaf, shd.ShardedTensor)


def test_server_decodes_through_the_sharded_step():
    """``BatchedServer`` with the sharded step as its decode function
    gives the unsharded server's tokens."""
    cfg = get_smoke_config(SMOKE)
    model = build_model(cfg, device="cpu")
    prompts = [np.arange(3, 9, dtype=np.int32), np.arange(20, 24,
                                                          dtype=np.int32)]
    out = []
    for sharded in (False, True):
        server = tserve.BatchedServer(cfg, model, slots=2, max_len=32)
        if sharded:
            server._decode = tserve.shard_decode_step(
                model, _mesh((2, 4)), abstract_params(cfg), 2, 32)[0]
        reqs = [tserve.Request(p, 6) for p in prompts]
        for req in reqs:
            server.submit(req)
        server.run_until_drained()
        out.append([r.out for r in reqs])
    assert out[0] == out[1]


# --------------------------------------------------------------------------
# activation hints
# --------------------------------------------------------------------------

def test_policy_context_restores():
    mesh = _mesh((2, 4))
    sh = shd.NamedSharding(mesh, shd.P("data", "model", None))
    assert pshint._POLICY == {}
    with pshint.activation_policy({"residual": sh}):
        assert pshint._POLICY["residual"] is sh
        with pshint.activation_policy({}):
            assert pshint._POLICY == {}
        assert pshint._POLICY["residual"] is sh
    assert pshint._POLICY == {}


def test_constrain_leaves_values_and_falls_through():
    mesh = _mesh((2, 4))
    x = torch.randn(4, 8, 6)
    assert pshint.constrain(x, "residual") is x          # no policy
    cases = {"residual": shd.NamedSharding(mesh, shd.P("data", "model",
                                                       None)),
             "ffn": shd.NamedSharding(mesh, shd.P(None, None, "model")),
             "heads": shd.P("data", None)}
    with pshint.activation_policy(cases):
        for kind in cases:                   # divisible, not, other rank
            y = pshint.constrain(x, kind)
            assert y is x and torch.equal(y, x.clone())
        odd = torch.randn(3, 5, 7)
        assert pshint.constrain(odd, "residual") is odd


FAMILIES = ["qwen2.5-3b", "granite-moe-1b-a400m", "recurrentgemma-9b",
            "rwkv6-3b", "seamless-m4t-medium", "internvl2-1b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_hint_sites_reach_the_reference_kinds(arch, monkeypatch):
    """Both packages' models call ``constrain`` with the same kinds on a
    forward pass (the calls recorded by monkeypatching), and a policy
    changes no logit."""
    seen = {"ref": set(), "port": set()}

    def recorder(tag, orig):
        def fn(x, kind="residual"):
            seen[tag].add(kind)
            return orig(x, kind)
        return fn

    monkeypatch.setattr(jpshint, "constrain",
                        recorder("ref", jpshint.constrain))
    monkeypatch.setattr(pshint, "constrain", recorder("port", pshint.constrain))
    jcfg = jconfigs.get_smoke_config(arch)
    jm = j_build(jcfg)
    shape = jconfigs.ShapeConfig("t", "train", 8, 2)
    jparams = jm.init(0)
    jm.forward(jparams, jm.dummy_batch(shape))
    model = build_model(get_smoke_config(arch), device="cpu")
    batch = model.dummy_batch(shape)
    plain, _ = model(batch)
    assert seen["port"] == seen["ref"] and seen["ref"], seen
    mesh = _mesh((2, 4))
    policy = {"residual": shd.NamedSharding(mesh, shd.P("data", "model",
                                                        None)),
              "ffn": shd.NamedSharding(mesh, shd.P("data", None, "model"))}
    with pshint.activation_policy(policy):
        hinted, _ = model(batch)
    assert torch.equal(hinted, plain)
