"""repro_torch's LM families vs the JAX package, on the CPU.

For each of the ten smoke configs (dense, moe with MLA and lead dense
layers, encdec, hybrid, ssm, vlm), the JAX ``init_params(cfg, 0)`` tree
is carried into the port's model (``convert.lm_params_from_reference``)
and both packages run the same batch (tokens, and the stub frames or
patches): teacher-forced logits within max-abs 1e-4 of the JAX logits;
prefill and each decode step within 5e-5 of the port's own
teacher-forced logits (``tests/test_models_smoke.py``'s bar) and within
1e-4 of the JAX serving path's, every leaf of the decode state too. Also
the config registry against the JAX one, the reference's config checks,
and every full config's abstract model against the JAX tree's size.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import build_model as j_build

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.models import abstract_params, build_model, init_params
from repro_torch.models.model import count_params_analytic

DENSE = ["stablelm-3b", "qwen1.5-110b", "deepseek-67b", "qwen2.5-3b"]
ARCHS = jconfigs.list_archs()
LOGIT_BAR = 1e-4
DECODE_BAR = 5e-5       # tests/test_models_smoke.py
SHAPE = ("smoke", "train", 12, 2)
S_PRE = 8


def _as_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, prefix=""):
    """Path -> leaf of nested dicts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v).astype(
        np.int64 if np.issubdtype(np.asarray(v).dtype, np.integer)
        else np.float32)) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """One smoke config: the JAX model, its params and batch, and the
    port's model carrying those params."""
    arch = request.param
    jcfg = jconfigs.get_smoke_config(arch)
    jm = j_build(jcfg)
    jp = jm.init(0)
    batch = jm.dummy_batch(jconfigs.ShapeConfig(*SHAPE))
    cfg = tconfigs.get_smoke_config(arch)
    model = convert.lm_params_from_reference(
        build_model(cfg, device="cpu"), _as_numpy(jp))
    tb = _torch_batch(batch)
    return dict(arch=arch, jm=jm, jp=jp, jbatch=batch, jtok=batch["tokens"],
                model=model, batch=tb, tokens=tb["tokens"],
                off=cfg.frontend_tokens if cfg.family == "vlm" else 0)


def _maxabs(a, b) -> float:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return float(np.abs(a - np.asarray(b)).max())


def _prefix(batch, n):
    """The batch with its tokens cut to the first ``n``."""
    return dict(batch, tokens=batch["tokens"][:, :n])


def test_forward_matches_jax(pair):
    want, jaux = pair["jm"].forward(pair["jp"], pair["jbatch"])
    got, aux = pair["model"](pair["batch"])
    assert got.dtype == torch.float32
    assert tuple(got.shape) == tuple(want.shape)
    assert abs(float(aux) - float(jaux)) < LOGIT_BAR
    if pair["model"].cfg.moe is None:
        assert float(aux) == 0.0
    assert _maxabs(got, want) < LOGIT_BAR


def test_prefill_decode_matches_teacher_forcing(pair):
    """Serving path: prefill then token-by-token decode reproduce the
    port's own teacher-forced logits, and the JAX serving path's; every
    leaf of the decode state equals JAX's within 1e-4."""
    model, tokens, off = pair["model"], pair["tokens"], pair["off"]
    max_len = off + 16
    full, _ = model(pair["batch"])
    logits, cache, pos = model.prefill(_prefix(pair["batch"], S_PRE),
                                       max_len)
    jlogits, jcache, _ = pair["jm"].prefill(
        pair["jp"], _prefix(pair["jbatch"], S_PRE), max_len)
    assert pos == off + S_PRE
    assert _maxabs(logits[:, -1], full[:, off + S_PRE - 1]) < DECODE_BAR
    assert _maxabs(logits, jlogits) < LOGIT_BAR
    jl = _leaves(jcache)
    assert {k: tuple(a.shape) for k, a in _leaves(cache).items()} == {
        k: tuple(a.shape) for k, a in jl.items()}
    for name, a in _leaves(cache).items():
        assert _maxabs(a, jl[name]) < LOGIT_BAR, name
    for t in range(S_PRE, SHAPE[2]):
        logits, cache = model.decode_step(cache, tokens[:, t:t + 1],
                                          off + t)
        jlogits, jcache = pair["jm"].decode_step(
            pair["jp"], jcache, pair["jtok"][:, t:t + 1],
            jnp.int32(off + t))
        assert _maxabs(logits[:, -1], full[:, off + t]) < DECODE_BAR, t
        assert _maxabs(logits, jlogits) < LOGIT_BAR, t
    jl = _leaves(jcache)
    for name, a in _leaves(cache).items():
        assert _maxabs(a, jl[name]) < LOGIT_BAR, name


def test_parameters_match_the_reference_tree(pair):
    """Every leaf of the JAX tree has a parameter of its shape (the layer
    axis unstacked), and the port's own init draws the same shapes."""
    leaves = jax.tree_util.tree_leaves(pair["jp"])
    own = init_params(pair["model"].cfg, seed=1, device="cpu")
    assert sum(int(np.prod(a.shape)) for a in leaves) == sum(
        t.numel() for t in own.values())
    assert own.keys() == pair["model"].state_dict().keys()
    for name, t in own.items():
        assert torch.isfinite(t).all(), name


def test_port_init_serves(pair):
    """A model drawn by the port's own seeded generator: finite logits of
    the right shape, prefill and decode agreeing with teacher forcing,
    and the same seed drawing the same weights."""
    cfg, off = pair["model"].cfg, pair["off"]
    model = build_model(cfg, seed=3, device="cpu")
    again = build_model(cfg, seed=3, device="cpu")
    for (n, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), n
    batch = model.dummy_batch(tconfigs.ShapeConfig(*SHAPE), seed=2)
    assert torch.equal(batch["tokens"], batch["labels"])
    full, _ = model(batch)
    assert torch.isfinite(full).all()
    assert tuple(full.shape) == (SHAPE[3], off + SHAPE[2], cfg.vocab_size)
    logits, cache, _ = model.prefill(_prefix(batch, S_PRE), off + SHAPE[2])
    assert _maxabs(logits[:, -1], full[:, off + S_PRE - 1]) < DECODE_BAR
    logits, _ = model.decode_step(cache, batch["tokens"][:, S_PRE:S_PRE + 1],
                                  off + S_PRE)
    assert _maxabs(logits[:, -1], full[:, off + S_PRE]) < DECODE_BAR


def test_init_decode_state_matches_jax(pair):
    """``init_decode_state``'s tree: the reference's leaves, shapes and
    dtypes, all zero."""
    jstate = pair["jm"].init_decode_state(3, 20)
    state = pair["model"].init_decode_state(3, 20)
    jl = _leaves(jstate)
    got = _leaves(state)
    assert got.keys() == jl.keys()
    for name, a in got.items():
        assert tuple(a.shape) == tuple(jl[name].shape), name
        assert str(a.dtype).split(".")[-1] == str(jl[name].dtype), name
        assert not bool(a.any()), name
    meta = _leaves(pair["model"].init_decode_state(3, 20, device="meta"))
    assert all(a.device.type == "meta" for a in meta.values())


def test_convert_refuses_a_mismatched_tree(pair):
    tree = _as_numpy(pair["jp"])
    model = build_model(pair["model"].cfg, device="cpu")
    norm = "ln_f" if "ln_f" in tree else "ln_dec"
    missing = dict(tree)
    del missing[norm]
    with pytest.raises(ValueError, match=f"missing.*{norm}"):
        convert.lm_params_from_reference(model, missing)
    extra = dict(tree, bogus=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="unknown.*bogus"):
        convert.lm_params_from_reference(model, extra)
    wrong = dict(tree, embed=tree["embed"][:-1])
    with pytest.raises(ValueError, match="embed: shape"):
        convert.lm_params_from_reference(model, wrong)


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_configs_match_reference(arch):
    """Every architecture's full and smoke config equals the JAX one field
    for field; the dtype names a torch dtype."""
    assert tconfigs.list_archs() == jconfigs.list_archs()
    for get in ("get_config", "get_smoke_config"):
        got = getattr(tconfigs, get)(arch)
        want = getattr(jconfigs, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.np_dtype == getattr(torch, got.dtype)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()


def test_full_configs_match_pool_dims():
    """The FULL configs carry the exact dims assigned in the pool."""
    expect = {
        "stablelm-3b": (32, 2560, 32, 32, 6912, 50304),
        "qwen1.5-110b": (80, 8192, 64, 8, 49152, 152064),
        "deepseek-67b": (95, 8192, 64, 8, 22016, 102400),
        "qwen2.5-3b": (36, 2048, 16, 2, 11008, 151936),
        "granite-moe-1b-a400m": (24, 1024, 16, 8, 512, 49155),
        "deepseek-v2-lite-16b": (27, 2048, 16, 16, 1408, 102400),
        "seamless-m4t-medium": (12, 1024, 16, 16, 4096, 256206),
        "recurrentgemma-9b": (38, 4096, 16, 1, 12288, 256000),
        "internvl2-1b": (24, 896, 14, 2, 4864, 151655),
        "rwkv6-3b": (32, 2560, 40, 40, 8960, 65536),
    }
    for arch, (L, d, H, KVH, ff, V) in expect.items():
        cfg = tconfigs.get_config(arch)
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                cfg.d_ff, cfg.vocab_size) == (L, d, H, KVH, ff, V), arch


def test_moe_configs():
    g = tconfigs.get_config("granite-moe-1b-a400m")
    assert g.moe.num_experts == 32 and g.moe.top_k == 8
    d = tconfigs.get_config("deepseek-v2-lite-16b")
    assert d.moe.num_experts == 64 and d.moe.top_k == 6
    assert d.moe.num_shared == 2
    assert d.mla.kv_lora_rank == 512


def test_param_counts_in_expected_range():
    """Analytic parameter counts should be near the advertised sizes."""
    cases = {
        "qwen1.5-110b": (90e9, 130e9),
        "deepseek-67b": (55e9, 75e9),
        "qwen2.5-3b": (2.2e9, 4.2e9),
        "granite-moe-1b-a400m": (0.8e9, 1.8e9),
        "deepseek-v2-lite-16b": (12e9, 20e9),
        "rwkv6-3b": (2.2e9, 4.5e9),
        "recurrentgemma-9b": (6e9, 11e9),
    }
    for arch, (lo, hi) in cases.items():
        n = tconfigs.get_config(arch).param_count()
        assert lo < n < hi, f"{arch}: {n/1e9:.2f}B not in [{lo/1e9},{hi/1e9}]"


def test_active_params_less_than_total_for_moe():
    for arch in ("granite-moe-1b-a400m", "deepseek-v2-lite-16b"):
        cfg = tconfigs.get_config(arch)
        assert cfg.active_param_count() < cfg.param_count()
    cfg = tconfigs.get_config("qwen2.5-3b")
    assert cfg.active_param_count() == cfg.param_count()


def test_full_width_qwen_abstract_params():
    """qwen2.5-3b at full width on the ``meta`` device: no storage, the
    analytic count less the final norm's absent bias."""
    cfg = tconfigs.get_config("qwen2.5-3b")
    shapes = abstract_params(cfg)
    assert all(t.device.type == "meta" for t in shapes.values())
    assert shapes["embed"].shape == (151936, 2048)
    assert shapes["layers.35.attn.wk"].shape == (2048, 256)
    assert "unembed" not in shapes   # tied embeddings
    n = sum(t.numel() for t in shapes.values())
    assert n == count_params_analytic(cfg) - cfg.d_model
    assert shapes["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_abstract_model_matches_jax(arch):
    """Every full config builds on the ``meta`` device (no storage) with
    exactly the JAX tree's parameter count; the analytic count differs
    from it only by what its formula leaves out or adds (a bias-free
    final RMSNorm counted as 2 d, GeGLU counted as two matrices, ...), so
    it is held against the tree only where the formula is exact."""
    cfg = tconfigs.get_config(arch)
    shapes = abstract_params(cfg)
    assert all(t.device.type == "meta" for t in shapes.values())
    n = sum(t.numel() for t in shapes.values())
    jtree = jax.eval_shape(lambda: j_build(jconfigs.get_config(arch))
                           .init(0))
    assert n == sum(int(np.prod(a.shape))
                    for a in jax.tree_util.tree_leaves(jtree))
    if cfg.family in ("moe", "dense", "vlm") and cfg.norm == "rmsnorm":
        vlm = 2 * cfg.d_model if cfg.family == "vlm" else 0
        assert n == count_params_analytic(cfg) - cfg.d_model - vlm


def test_deepseek_v2_lite_full_width_counts():
    """The numbers the card's [moe] phase prints: every parameter and the
    ones a token reads (top-6 of 64 experts)."""
    cfg = tconfigs.get_config("deepseek-v2-lite-16b")
    assert count_params_analytic(cfg) == 15_706_486_272
    assert count_params_analytic(cfg, active_only=True) == 2_661_152_256
    shapes = abstract_params(cfg)
    assert shapes["layers.25.moe.wi_gate"].shape == (64, 2048, 1408)
    assert shapes["layers.0.moe.shared.wo"].shape == (2, 1408, 2048)
    assert shapes["lead_layers.0.mlp.wi_up"].shape == (2048, 10944)
    assert shapes["layers.0.attn.w_dkv"].shape == (2048, 512)
    assert "layers.26.attn.wq" not in shapes      # 1 lead + 26 MoE layers


def test_build_model_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(tconfigs.get_smoke_config("qwen2.5-3b"))
