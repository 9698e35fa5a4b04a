"""repro_torch's training substrate vs the JAX package, on the CPU.

Each case feeds the same seeded numpy inputs to ``repro`` and
``repro_torch``: ``TokenPipeline`` bit for bit (seeds, steps, shards,
prefetch, seek); ``cosine_warmup`` (1e-7); ``adamw_update`` over float32,
bf16 and 1-D leaves (1e-6, bf16 leaves to their rounding);
``clip_by_global_norm``; ``accumulate_gradients`` against JAX's and
against the full batch; ``compress_int8`` (q bit for bit, scale 1e-7);
the six checkpoint tests of ``tests/test_substrate.py`` with a bf16 leaf
and a ``TrainState`` round trip; its three fault-tolerance-loop tests
with the real checkpointer and pipeline; one ``make_train_step`` from a
JAX ``TrainState`` carried across (``convert.train_state_from_
reference``); ``train()`` as ``tests/test_train_integration.py`` drives
it (loss falls, resume equals straight through, microbatches equal the
full batch); the mesh paths run (the sharded step, the laid-out
accumulator, the int8 all-reduce); a model served after training records
no graph.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro import optim as joptim
from repro.data import TokenPipeline as JPipeline
from repro.launch import train as jtrain
from repro.models import build_model as j_build

from repro_torch import convert
from repro_torch import optim
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import RunConfig, ShapeConfig, get_smoke_config
from repro_torch.data import TokenPipeline
from repro_torch.launch import train as ttrain
from repro_torch.models import build_model
from repro_torch.runtime import FaultTolerantLoop

STEP_BAR = 1e-5          # a train step from a carried JAX state: params
#                          (abs), metrics and moments (rel)
MICRO_BAR = 1e-4         # tests/test_train_integration.py


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _f32(t):
    return t.detach().to(torch.float32).numpy()


# --------------------------------------------------------------------------
# data pipeline
# --------------------------------------------------------------------------

PIPE_KW = [dict(vocab_size=97, seq_len=8, global_batch=4, seed=0),
           dict(vocab_size=151936, seq_len=16, global_batch=8, seed=3,
                shard_index=2, num_shards=4)]


@pytest.mark.parametrize("kw", PIPE_KW, ids=["seed0", "seed3-shard2of4"])
def test_pipeline_batches_equal_reference_bit_for_bit(kw):
    want, got = JPipeline(**kw), TokenPipeline(**kw)
    for step in range(6):
        a, b = want.batch_at(step), got.batch_at(step)
        for key in ("tokens", "labels"):
            assert b[key].dtype == a[key].dtype == np.int32
            np.testing.assert_array_equal(b[key], a[key])


@pytest.mark.parametrize("kw", PIPE_KW, ids=["seed0", "seed3-shard2of4"])
def test_pipeline_prefetch_equals_sync_and_seeks(kw):
    sync, pre = TokenPipeline(**kw), TokenPipeline(**kw)
    pre.start_prefetch()
    try:
        for step in range(6):
            a, b = next(sync), next(pre)
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
            assert pre.step == sync.step == step + 1
        pre.seek(2)                  # while the prefetch thread runs
        np.testing.assert_array_equal(next(pre)["tokens"],
                                      sync.batch_at(2)["tokens"])
        assert pre.step == 3
    finally:
        pre.stop_prefetch()
    sync.seek(4)
    np.testing.assert_array_equal(next(sync)["labels"],
                                  JPipeline(**kw).batch_at(4)["labels"])


def test_pipeline_shards_concatenate_to_the_global_batch():
    kw = dict(vocab_size=50, seq_len=6, global_batch=8, seed=1)
    whole = TokenPipeline(**kw).batch_at(3)["tokens"]
    parts = [TokenPipeline(shard_index=i, num_shards=4, **kw)
             .batch_at(3)["tokens"] for i in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), whole)
    with pytest.raises(ValueError):
        TokenPipeline(vocab_size=50, seq_len=6, global_batch=6,
                      num_shards=4)


# --------------------------------------------------------------------------
# schedule and optimizer
# --------------------------------------------------------------------------

def test_cosine_warmup_matches_jax():
    kw = dict(base_lr=3e-4, warmup_steps=10, total_steps=100)
    for step in range(121):
        want = float(joptim.cosine_warmup(step, **kw))
        got = optim.cosine_warmup(torch.tensor(step, dtype=torch.int32),
                                  **kw)
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-7, step


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(3, 4).astype(np.float32),
            "wb": rng.randn(4, 5).astype(np.float32),
            "b": rng.randn(4).astype(np.float32)}


DTYPES = {"w": (jnp.float32, torch.float32),
          "wb": (jnp.bfloat16, torch.bfloat16),
          "b": (jnp.float32, torch.float32)}


def _jtree(tree):
    return {k: jnp.asarray(v, DTYPES[k][0]) for k, v in tree.items()}


def _ttree(tree):
    return {k: torch.from_numpy(v).to(DTYPES[k][1]) for k, v in tree.items()}


def test_adamw_update_matches_jax():
    """Three steps over float32, bf16 and 1-D leaves: moments in
    float32 within 1e-6, parameters within 1e-6 (bf16 ones within one
    rounding of their value)."""
    p0 = _tree(0)
    jp, tp = _jtree(p0), _ttree(p0)
    jst, tst = joptim.adamw_init(jp), optim.adamw_init(tp)
    assert all(m.dtype == torch.float32 for m in tst.m.values())
    for step in range(3):
        g = _tree(10 + step)
        lr = 1e-2 * (step + 1)
        jp, jst = joptim.adamw_update(jp, _jtree(g), jst, lr=lr)
        tp, tst = optim.adamw_update(tp, _ttree(g), tst,
                                     lr=torch.tensor(lr))
    assert int(tst.step) == int(jst.step) == 3
    for k in p0:
        assert tp[k].dtype == DTYPES[k][1]
        bar = 1e-6 if k != "wb" else 8e-3 * float(np.abs(p0[k]).max())
        assert np.abs(_f32(tp[k]) - np.asarray(jp[k], np.float32)).max() \
            <= bar, k
        for tm, jm in ((tst.m, jst.m), (tst.v, jst.v)):
            assert np.abs(_f32(tm[k]) - np.asarray(jm[k])).max() <= 1e-6, k


def test_adamw_decays_matrices_only():
    p = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    g = {"w": torch.zeros(2, 2), "b": torch.zeros(2)}
    p, _ = optim.adamw_update(p, g, optim.adamw_init(p), lr=0.5,
                              weight_decay=0.1)
    assert float(p["w"][0, 0]) == pytest.approx(0.95)
    assert float(p["b"][0]) == 1.0


@pytest.mark.parametrize("max_norm", [0.5, 1e3], ids=["clips", "keeps"])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(4)
    jg, jn = joptim.clip_by_global_norm(_jtree(g), max_norm)
    tg, tn = optim.clip_by_global_norm(_ttree(g), max_norm)
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    for k in g:
        assert tg[k].dtype == DTYPES[k][1]
        bar = 1e-6 if k != "wb" else 8e-3 * float(np.abs(g[k]).max())
        assert np.abs(_f32(tg[k]) - np.asarray(jg[k], np.float32)).max() \
            <= bar, k


def test_sgd_update_matches_jax():
    p, g = _tree(1), _tree(2)
    want = joptim.optimizer.sgd_update(_jtree(p), _jtree(g), lr=0.1)
    got = optim.sgd_update(_ttree(p), _ttree(g), lr=0.1)
    for k in p:
        np.testing.assert_array_equal(_f32(got[k]),
                                      np.asarray(want[k], np.float32))


@pytest.mark.parametrize("with_residual", [False, True])
def test_compress_int8_matches_jax(with_residual):
    rng = np.random.RandomState(7)
    g = rng.randn(64, 33).astype(np.float32)
    r = (rng.randn(64, 33).astype(np.float32) * 0.01
         if with_residual else None)
    jq, js, jr = joptim.compress_int8(
        jnp.asarray(g), None if r is None else jnp.asarray(r))
    tq, ts, tr = optim.compress_int8(
        torch.from_numpy(g), None if r is None else torch.from_numpy(r))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert abs(float(ts) - float(js)) <= 1e-7 * float(js)
    assert np.abs(tr.numpy() - np.asarray(jr)).max() <= 1e-6
    deq = optim.decompress_int8(tq, ts)
    assert np.abs(deq.numpy() + tr.numpy()
                  - (g if r is None else g + r)).max() <= 1e-6


# --------------------------------------------------------------------------
# gradients: accumulation, one train step from a carried JAX state
# --------------------------------------------------------------------------

SMOKE = "qwen2.5-3b"


@pytest.fixture(scope="module")
def carried():
    """The JAX qwen smoke model, a state 2 steps into training, a batch,
    and the reference's next step's state and metrics (computed once)."""
    jcfg = jconfigs.get_smoke_config(SMOKE)
    jm = j_build(jcfg)
    run = jconfigs.RunConfig(seed=0, warmup_steps=1)
    state = jtrain.init_state(jm, run)
    step = jax.jit(jtrain.make_train_step(jm, run, total_steps=100))
    for s in range(2):
        state, _ = step(state, jm.dummy_batch(
            jconfigs.ShapeConfig("t", "train", 16, 4), seed=10 + s))
    batch = jm.dummy_batch(jconfigs.ShapeConfig("t", "train", 16, 4), seed=3)
    new, metrics = step(state, batch)
    return dict(jm=jm, run=run, state=_np(state), batch=_np(batch),
                new=_np(new), metrics=_np(metrics))


def _port_state(carried):
    model = build_model(get_smoke_config(SMOKE), device="cpu")
    return model, convert.train_state_from_reference(model,
                                                     carried["state"])


def test_train_step_from_carried_jax_state(carried):
    model, state = _port_state(carried)
    run = RunConfig(seed=0, warmup_steps=1)
    assert int(state.opt.step) == 2
    step = ttrain.make_train_step(model, run, total_steps=100)
    new, metrics = step(state, carried["batch"])
    want = carried["metrics"]
    for key in ("loss", "gnorm", "lr"):
        assert metrics[key].dtype == torch.float32
        assert abs(float(metrics[key]) - float(want[key])) <= \
            STEP_BAR * abs(float(want[key])), key
    assert int(new.opt.step) == 3
    assert new.params["embed"] is dict(model.named_parameters())["embed"]
    ref = convert.tree_by_name(carried["new"].params)
    for name, t in new.params.items():
        assert float(np.abs(_f32(t) - ref[name]).max()) <= STEP_BAR, name
    for tree, ref in ((new.opt.m, carried["new"].opt.m),
                      (new.opt.v, carried["new"].opt.v)):
        ref = convert.tree_by_name(ref)
        for name, t in tree.items():
            err = float(np.abs(_f32(t) - ref[name]).max())
            assert err <= STEP_BAR * float(np.abs(ref[name]).max()), name


def test_accumulate_gradients_matches_jax_and_full_batch(carried):
    model, state = _port_state(carried)
    jb = carried["batch"]
    micro = {k: v.reshape(2, 2, *v.shape[1:]) for k, v in jb.items()}
    jloss, jgrads = joptim.accumulate_gradients(
        carried["jm"].loss, carried["state"].params, micro)
    tmicro = {k: torch.from_numpy(v.astype(np.int64))
              for k, v in micro.items()}
    loss, grads = optim.accumulate_gradients(model.loss, state.params,
                                             tmicro)
    floss, fgrads = optim.grad.value_and_grad(
        model.loss, state.params,
        {k: torch.from_numpy(v.astype(np.int64)) for k, v in jb.items()})
    assert abs(float(loss) - float(jloss)) <= 1e-5 * float(jloss)
    assert abs(float(loss) - float(floss)) <= MICRO_BAR * float(floss)
    jg = convert.tree_by_name(_np(jgrads))
    for name, g in grads.items():
        assert g.dtype == torch.float32
        scale = float(np.abs(jg[name]).max())
        assert float(np.abs(g.numpy() - jg[name]).max()) <= 1e-4 * scale
        assert float((g - fgrads[name]).abs().max()) <= MICRO_BAR * scale


def test_mesh_paths_raise_naming_2e(carried):
    """The paths that raised before the parallel layer was ported now run
    on a (2, 2) mesh of the CPU (their parity with the reference is in
    tests/test_torch_parallel.py): the sharded step's loss equals the
    single step's, the laid-out accumulator's mean equals the unsharded
    one, the int8 all-reduce returns a total for every entry."""
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import abstract_params

    model, state = _port_state(carried)
    cfg = get_smoke_config(SMOKE)
    mesh = make_mesh((2, 2), ("data", "model"), devices=("cpu",) * 4)
    run = RunConfig(seed=0, warmup_steps=1)
    step = ttrain.make_train_step(model, run, total_steps=100)
    sstep, shardings = ttrain.shard_train_step(
        step, model, mesh, abstract_params(cfg), carried["batch"])
    _, metrics = sstep(state, carried["batch"])
    want = float(carried["metrics"]["loss"])
    assert abs(float(metrics["loss"]) - want) <= 1e-4 * want
    batch = {k: torch.from_numpy(v.astype(np.int64)).reshape(2, 2, -1)
             for k, v in carried["batch"].items()}
    loss, grads = optim.accumulate_gradients(
        model.loss, state.params, batch, grad_shardings=shardings.params)
    uloss, ugrads = optim.accumulate_gradients(model.loss, state.params,
                                               batch)
    assert float(loss) == float(uloss)
    assert all(torch.equal(grads[n].full(), ugrads[n]) for n in ugrads)
    g = {e: torch.full((3,), float(e)) for e in range(4)}
    total, _ = optim.grad.compressed_psum(g, mesh, "data")
    assert sorted(total) == [0, 1, 2, 3]
    assert isinstance(grads["embed"], shd.ShardedTensor)


def test_served_after_training_records_no_graph(carried):
    model, state = _port_state(carried)
    assert all(p.requires_grad for p in state.params.values())
    tokens = torch.from_numpy(carried["batch"]["tokens"][:, :8]
                              .astype(np.int64))
    logits, cache, pos = model.prefill({"tokens": tokens}, 12)
    assert not logits.requires_grad and logits.grad_fn is None
    assert not any(t.requires_grad for t in cache.values())
    logits, _ = model.decode_step(cache, tokens[:, :1], pos)
    assert not logits.requires_grad
    specs = model.input_specs(ShapeConfig("t", "train", 16, 4))
    assert {k: (tuple(v.shape), v.device.type) for k, v in specs.items()} \
        == {"tokens": ((4, 16), "meta"), "labels": ((4, 16), "meta")}


# --------------------------------------------------------------------------
# checkpointing (tests/test_substrate.py)
# --------------------------------------------------------------------------

def _ck_tree():
    return {"params": {"w": torch.arange(6, dtype=torch.float32)
                       .reshape(2, 3),
                       "b": torch.tensor([1.5, -2.25, 3.0],
                                         dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _zeros_like(tree):
    return {"params": {k: torch.zeros_like(v)
                       for k, v in tree["params"].items()},
            "step": torch.zeros_like(tree["step"])}


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _ck_tree()
    ck.save(3, t, blocking=True)
    like = _zeros_like(t)
    step, restored = ck.restore_latest(like)
    assert step == 3
    np.testing.assert_array_equal(restored["params"]["w"].numpy(),
                                  t["params"]["w"].numpy())
    assert restored["params"]["b"].dtype == torch.bfloat16
    assert torch.equal(restored["params"]["b"], t["params"]["b"])
    assert int(restored["step"]) == 7
    # tensor leaves are filled in place
    assert restored["params"]["w"] is like["params"]["w"]


def test_checkpoint_bf16_leaf_layout(tmp_path):
    """A bf16 leaf is stored as a uint16 view with logical dtype
    "bfloat16", as the JAX package stores ml_dtypes leaves."""
    import json
    ck = Checkpointer(str(tmp_path))
    t = _ck_tree()
    ck.save(1, t, blocking=True)
    d = os.path.join(str(tmp_path), "step_00000001")
    leaves = {leaf["name"]: leaf
              for leaf in json.load(open(os.path.join(d, "manifest.json")))
              ["leaves"]}
    assert leaves["params/b"]["dtype"] == "bfloat16"
    assert leaves["params/w"]["dtype"] == "float32"
    assert leaves["step"]["shape"] == []
    raw = np.load(os.path.join(d, leaves["params/b"]["file"]))
    assert raw.dtype == np.uint16
    np.testing.assert_array_equal(
        raw, t["params"]["b"].view(torch.int16).numpy().view(np.uint16))


def test_checkpoint_async_then_wait(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _ck_tree(), blocking=False)
    ck.wait()
    assert ck.latest_step() == 1


def test_checkpoint_keeps_latest_k(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _ck_tree(), blocking=True)
    assert ck.all_steps() == [3, 4]


def test_checkpoint_ignores_partial_tmp(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, _ck_tree(), blocking=True)
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp-123"))
    assert ck.latest_step() == 5


def test_checkpoint_crc_detects_corruption(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _ck_tree()
    ck.save(2, t, blocking=True)
    d = os.path.join(str(tmp_path), "step_00000002")
    victim = [f for f in os.listdir(d) if f.endswith(".npy")][0]
    arr = np.load(os.path.join(d, victim)).copy()
    flat = arr.reshape(-1).view(np.uint8)
    if flat.size:
        flat[0] ^= 0xFF
    np.save(os.path.join(d, victim), arr)
    like = _zeros_like(t)
    with pytest.raises(IOError):
        ck.restore(2, like)
    # nothing was written before the check failed
    assert float(like["params"]["w"].abs().sum()) == 0.0


def test_checkpoint_shape_mismatch_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.zeros((2, 2))}, blocking=True)
    with pytest.raises(ValueError):
        ck.restore(1, {"w": torch.zeros((3, 3))})


def test_checkpoint_train_state_roundtrip(tmp_path, carried):
    """A TrainState (parameters and AdamW state by name) round-trips into
    another model's own parameters and optimizer state."""
    model, state = _port_state(carried)
    ck = Checkpointer(str(tmp_path))
    ck.save(2, state, blocking=True)
    other = build_model(get_smoke_config(SMOKE), seed=5, device="cpu")
    like = ttrain.init_state(other, RunConfig(seed=5))
    step, restored = ck.restore_latest(like)
    assert step == 2 and isinstance(restored, ttrain.TrainState)
    own = dict(other.named_parameters())
    assert int(restored.opt.step) == 2
    for name, p in state.params.items():
        assert restored.params[name] is own[name]
        assert torch.equal(own[name], p)
        assert torch.equal(restored.opt.m[name], state.opt.m[name])
        assert torch.equal(restored.opt.v[name], state.opt.v[name])


# --------------------------------------------------------------------------
# the fault-tolerant loop with the real checkpointer and pipeline
# --------------------------------------------------------------------------

def _pipe():
    return TokenPipeline(vocab_size=50, seq_len=4, global_batch=2, seed=0)


def test_ft_loop_recovers_from_transient_failure(tmp_path):
    loop = FaultTolerantLoop(checkpointer=Checkpointer(str(tmp_path)),
                             pipeline=_pipe(), save_every=2,
                             max_retries_per_step=3)
    state = {"w": torch.zeros(()), "n": torch.tensor(0, dtype=torch.int32)}
    fail_once = {"armed": True}

    def step_fn(state, batch):
        if fail_once["armed"] and int(state["n"]) == 3:
            fail_once["armed"] = False
            raise RuntimeError("injected device failure")
        return {"w": state["w"] + 1.0, "n": state["n"] + 1}, {"loss": 1.0}

    end, final = loop.run(state, step_fn, start_step=0, num_steps=6)
    assert loop.recoveries == 1
    assert end == 6 and int(final["n"]) == 6


def test_ft_loop_skips_poison_step(tmp_path):
    pipeline = _pipe()
    loop = FaultTolerantLoop(checkpointer=Checkpointer(str(tmp_path)),
                             pipeline=pipeline, save_every=100,
                             max_retries_per_step=1)

    def step_fn(state, batch):
        if np.array_equal(batch["tokens"], pipeline.batch_at(1)["tokens"]):
            raise RuntimeError("poison batch")
        return state, {"loss": 0.5}

    end, _ = loop.run({"x": torch.zeros(())}, step_fn, start_step=0,
                      num_steps=4)
    assert end >= 4
    assert loop.failures >= 1


def test_ft_nan_guard(tmp_path):
    loop = FaultTolerantLoop(checkpointer=Checkpointer(str(tmp_path)),
                             pipeline=_pipe(), save_every=100,
                             max_retries_per_step=0)

    def step_fn(state, batch):
        return state, {"loss": torch.tensor(float("nan"))}

    loop.run({"x": torch.zeros(())}, step_fn, start_step=0, num_steps=2)
    assert loop.failures >= 1   # NaN treated as a fault and skipped


# --------------------------------------------------------------------------
# the trainer (tests/test_train_integration.py)
# --------------------------------------------------------------------------

def test_training_reduces_loss(tmp_path):
    cfg = get_smoke_config("qwen2.5-3b")
    run = RunConfig(steps=30, lr=3e-3, warmup_steps=5,
                    checkpoint_dir=str(tmp_path), checkpoint_every=10)
    _, info = ttrain.train(cfg, run, shape=ShapeConfig("toy", "train", 32, 4),
                           quiet=True, device="cpu")
    first = np.mean(info["losses"][:5])
    last = np.mean(info["losses"][-5:])
    assert last < first - 0.05, (first, last)
    assert info["end_step"] == 30 and info["recoveries"] == 0


def test_training_resumes_from_checkpoint(tmp_path):
    cfg = get_smoke_config("stablelm-3b")
    shape = ShapeConfig("toy", "train", 16, 2)

    def run(name, steps):
        return RunConfig(steps=steps, lr=1e-3, checkpoint_every=10, seed=3,
                         schedule_horizon=20,
                         checkpoint_dir=str(tmp_path / name))

    state_a, _ = ttrain.train(cfg, run("a", 20), shape=shape, quiet=True,
                              device="cpu")
    ttrain.train(cfg, run("b", 10), shape=shape, quiet=True, device="cpu")
    state_b, info_b = ttrain.train(cfg, run("b", 10), shape=shape,
                                   quiet=True, device="cpu")
    assert info_b["end_step"] == 20 and int(state_b.opt.step) == 20
    for name, a in state_a.params.items():
        np.testing.assert_allclose(_f32(state_b.params[name]), _f32(a),
                                   atol=2e-5)


def test_microbatched_step_matches_full_batch():
    cfg = get_smoke_config("deepseek-67b")
    batch = None
    losses = {}
    for micro in (0, 2):
        model = build_model(cfg, device="cpu")
        state = ttrain.init_state(model, RunConfig(seed=0))
        if batch is None:
            batch = model.dummy_batch(ShapeConfig("t", "train", 16, 4))
        b = batch if not micro else {
            k: v.reshape(2, 2, *v.shape[1:]) for k, v in batch.items()}
        step = ttrain.make_train_step(model, RunConfig(microbatch=micro),
                                      total_steps=100)
        _, metrics = step(state, b)
        losses[micro] = float(metrics["loss"])
    assert losses[2] == pytest.approx(losses[0], rel=MICRO_BAR)


def test_train_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_smoke_config("qwen2.5-3b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train(cfg, RunConfig(steps=1))


def test_reference_decay_spares_top_level_norms_only():
    """AdamW decays what the JAX tree holds at ndim >= 2: every stacked
    per-layer parameter (norm scales and biases too), not ``ln_f``."""
    model = build_model(get_smoke_config("qwen2.5-3b"), device="meta")
    decay = ttrain.reference_decay(model)
    assert decay["embed"] and decay["layers.0.attn.wq"]
    assert decay["layers.0.ln_attn.scale"] and decay["layers.1.attn.bq"]
    assert not decay["ln_f.scale"]
    assert set(decay) == {n for n, _ in model.named_parameters()}


def test_train_example_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    import pathlib
    import runpy
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "train_lm_torch.py"
    monkeypatch.setattr("sys.argv", [str(path), "--device", "cpu",
                                     "--smoke", "--steps", "3",
                                     "--ckpt-dir", str(tmp_path)])
    runpy.run_path(str(path), run_name="__main__")
    assert "steps=3" in capsys.readouterr().out
    assert Checkpointer(str(tmp_path)).latest_step() == 3
