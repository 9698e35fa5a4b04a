"""repro_torch's sharding rules vs the JAX package, on the CPU.

The 14 tests of ``tests/test_sharding.py`` on the port's names (one
tensor a layer: a stacked reference leaf ``layers/attn/wq`` (L, d, d) is
the port's ``layers.{i}.attn.wq`` (d, d)) and a port ``Mesh`` over
``("cpu",) * n``; then every parameter's spec equals the reference's
minus its stack axes, for the ten smoke configs and full-width
qwen2.5-3b and deepseek-v2-lite-16b (abstract on both sides), on the
(16, 16) and (2, 16, 16) meshes; ``cache_specs`` (three strategies) and
``optimizer_specs`` (with and without ``zero1``) equal the reference's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
from jax.sharding import PartitionSpec as JP

from repro import configs as jconfigs
from repro.launch import sharding as jshd
from repro.models import build_model as j_build

from repro_torch import configs as tconfigs
from repro_torch.convert import STACKED
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.serve import decode_state_like
from repro_torch.models import abstract_params, build_model
from repro_torch.optim import AdamWState

P = shd.P


def _mesh(shape, names):
    import math
    return make_mesh(shape, names, devices=("cpu",) * math.prod(shape))


MESH = _mesh((16, 16), ("data", "model"))
MESH_POD = _mesh((2, 16, 16), ("pod", "data", "model"))


class _FakeMesh:
    """The reference's duck-typed mesh (axis names + shape only)."""

    def __init__(self, mesh):
        self.axis_names = mesh.axis_names
        self.devices = np.empty(mesh.shape)


# --------------------------------------------------------------------------
# tests/test_sharding.py, on the port's names
# --------------------------------------------------------------------------

def test_attention_weight_specs():
    s = shd.spec_for_param("layers.0.attn.wq", (8192, 8192), MESH)
    assert s == P("data", "model")
    s = shd.spec_for_param("layers.79.attn.wo", (8192, 8192), MESH)
    assert s == P("model", "data")


def test_mlp_weight_specs():
    s = shd.spec_for_param("layers.3.mlp.wi_gate", (8192, 49152), MESH)
    assert s == P("data", "model")
    s = shd.spec_for_param("layers.3.mlp.wo", (49152, 8192), MESH)
    assert s == P("model", "data")


def test_embed_specs_with_divisibility_fallback():
    assert shd.spec_for_param("embed", (152064, 8192), MESH) == \
        P("model", "data")
    assert shd.spec_for_param("embed", (49155, 1024), MESH) == \
        P(None, "data")


def test_moe_expert_parallel_specs():
    s = shd.spec_for_param("layers.1.moe.wi_gate", (32, 1024, 512), MESH)
    assert s == P("model", "data", None)
    s = shd.spec_for_param("layers.1.moe.wo", (32, 512, 1024), MESH)
    assert s == P("model", None, "data")


def test_norms_replicated():
    assert shd.spec_for_param("layers.0.ln_attn.scale", (8192,), MESH) \
        == P(None)
    assert shd.spec_for_param("ln_f.scale", (8192,), MESH) == P(None)


def test_pod_axis_never_in_weight_specs():
    for name, shape in [("layers.0.attn.wq", (8192, 8192)),
                        ("embed", (152064, 8192)),
                        ("layers.0.moe.wi_gate", (32, 1024, 512))]:
        s = shd.spec_for_param(name, shape, MESH_POD)
        assert "pod" not in tuple(s), (name, s)


def test_batch_axes_divisibility():
    assert shd._batch_axes(MESH, 256) == "data"
    assert shd._batch_axes(MESH_POD, 256) == ("pod", "data")
    assert shd._batch_axes(MESH_POD, 2) == "pod"
    assert shd._batch_axes(MESH_POD, 1) is None


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_cache_specs_prefer_time_axis():
    specs = shd.cache_specs({"k": _meta(32, 128, 32768, 8, 128)}, MESH,
                            None)
    assert specs["k"] == P(None, "data", "model", None, None)


def test_rwkv_state_spec_falls_back():
    cache = {"S": _meta(32, 128, 40, 64, 64, dtype=torch.float32)}
    specs = shd.cache_specs(cache, MESH, None)
    assert specs["S"] == P(None, "data", None, "model", None)
    specs = shd.cache_specs(cache, MESH, None, strategy="feature")
    assert specs["S"] == P(None, "data", None, None, "model")


def test_cache_specs_heads_strategy_prefers_kv_heads():
    specs = shd.cache_specs({"k": _meta(32, 128, 32768, 32, 80)}, MESH,
                            None)
    assert specs["k"] == P(None, "data", None, "model", None)


def test_attn_fsdp_toggle():
    s = shd.spec_for_param("layers.0.attn.wq", (8192, 8192), MESH,
                           attn_fsdp=False)
    assert s == P(None, "model")
    s = shd.spec_for_param("layers.0.attn.wk", (8192, 1024), MESH,
                           attn_fsdp=False)
    assert s == P("data", None)


def test_kv_projections_never_model_sharded():
    for name in ("wk", "wv"):
        s = shd.spec_for_param(f"layers.0.attn.{name}", (8192, 1024), MESH)
        assert s == P("data", None), name
    for name in ("bk", "bv"):
        s = shd.spec_for_param(f"layers.0.attn.{name}", (1024,), MESH)
        assert s == P(None), name


def test_zero1_optimizer_specs():
    params = {"w": _meta(8192, 512)}
    ospecs = shd.optimizer_specs({"w": P(None, "model")}, params, MESH,
                                 zero1=True)
    assert isinstance(ospecs, AdamWState)
    assert ospecs.m["w"] == P("data", "model") == ospecs.v["w"]
    assert ospecs.step == P()


def test_param_specs_cover_every_leaf():
    for arch in tconfigs.list_archs():
        aparams = abstract_params(tconfigs.get_smoke_config(arch))
        specs = shd.param_specs(aparams, MESH)
        assert set(specs) == set(aparams)
        for name, leaf in aparams.items():
            assert len(specs[name]) == leaf.ndim, (arch, name)


# --------------------------------------------------------------------------
# parity with the reference's specs, stack axes dropped
# --------------------------------------------------------------------------

def _key_str(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in kp)


def _ref_by_path(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return {_key_str(kp): leaf for kp, leaf in flat}


def _ref_path(name):
    """(reference path, stack axes) of a port parameter name."""
    parts = name.split(".")
    if parts[0] in STACKED:
        return "/".join([parts[0]] + parts[2:]), 1
    return "/".join(parts), 0


CONFIGS = [("smoke", a) for a in tconfigs.list_archs()] + \
    [("full", "qwen2.5-3b"), ("full", "deepseek-v2-lite-16b")]


def _configs(kind, arch):
    if kind == "smoke":
        return jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    return jconfigs.get_config(arch), tconfigs.get_config(arch)


def _ref_abstract(jcfg):
    jm = j_build(jcfg)
    return jm, jax.eval_shape(lambda: jm.init(0))


@pytest.mark.parametrize("kind, arch", CONFIGS,
                         ids=[f"{k}-{a}" for k, a in CONFIGS])
def test_param_specs_equal_reference_minus_stack_axes(kind, arch):
    jcfg, tcfg = _configs(kind, arch)
    _, jparams = _ref_abstract(jcfg)
    aparams = abstract_params(tcfg)
    for mesh in (MESH, MESH_POD):
        want = _ref_by_path(jshd.param_specs(jparams, _FakeMesh(mesh)))
        got = shd.param_specs(aparams, mesh)
        seen = set()
        for name, spec in got.items():
            path, n_stack = _ref_path(name)
            seen.add(path)
            assert tuple(spec) == tuple(want[path])[n_stack:], \
                (arch, name, spec, want[path])
        assert seen == set(want), (arch, set(want) - seen)


@pytest.mark.parametrize("kind, arch", CONFIGS,
                         ids=[f"{k}-{a}" for k, a in CONFIGS])
def test_optimizer_specs_equal_reference(kind, arch):
    jcfg, tcfg = _configs(kind, arch)
    _, jparams = _ref_abstract(jcfg)
    aparams = abstract_params(tcfg)
    fake = _FakeMesh(MESH)
    jp = jshd.param_specs(jparams, fake)
    tp = shd.param_specs(aparams, MESH)
    for zero1 in (False, True):
        want = jshd.optimizer_specs(jp, jparams, fake, zero1=zero1)
        got = shd.optimizer_specs(tp, aparams, MESH, zero1=zero1)
        assert tuple(got.step) == tuple(want.step) == ()
        for tree, ref in ((got.m, want.m), (got.v, want.v)):
            ref = _ref_by_path(ref)
            for name, spec in tree.items():
                path, n_stack = _ref_path(name)
                assert tuple(spec) == tuple(ref[path])[n_stack:], \
                    (arch, zero1, name)


DECODE_ARCHS = [("smoke", a) for a in tconfigs.list_archs()] + \
    [("full", "qwen2.5-3b")]


@pytest.mark.parametrize("strategy", ["heads", "seq", "feature"])
@pytest.mark.parametrize("kind, arch", DECODE_ARCHS,
                         ids=[f"{k}-{a}" for k, a in DECODE_ARCHS])
def test_cache_specs_equal_reference(kind, arch, strategy):
    jcfg, tcfg = _configs(kind, arch)
    jm = j_build(jcfg)
    B, S = 32, 64
    jcache = jax.eval_shape(lambda: jm.init_decode_state(B, S))
    tcache = decode_state_like(build_model(tcfg, device="meta"), B, S)
    for mesh in (MESH, MESH_POD):
        want = _ref_by_path(jshd.cache_specs(jcache, _FakeMesh(mesh), jcfg,
                                             strategy=strategy))
        got = shd.cache_specs(tcache, mesh, tcfg, strategy=strategy)
        flat = {}

        def walk(t, prefix=""):
            for k, v in t.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}/")
                else:
                    flat[prefix + k] = v
        walk(got)
        assert set(flat) == set(want)
        for path, spec in flat.items():
            assert tuple(spec) == tuple(want[path]), (arch, path)


def test_batch_specs_equal_reference():
    batch = {"tokens": _meta(256, 4096, dtype=torch.int64),
             "patches": _meta(6, 16, 32, dtype=torch.float32)}
    jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.float32)
              for k, v in batch.items()}
    for mesh in (MESH, MESH_POD):
        want = jshd.batch_specs(jbatch, _FakeMesh(mesh))
        got = shd.batch_specs(batch, mesh)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}


def test_named_sharding_blocks_tile_the_tensor():
    """Every element lies in the block of exactly the entries the spec
    says, and the distinct blocks tile the tensor once."""
    mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
    sh = shd.NamedSharding(mesh, P(("pod", "data"), "model"))
    t = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    st = shd.ShardedTensor.scatter(t, sh)
    for e, b in enumerate(st.blocks):
        c = shd.mesh_coords(mesh, e)
        i = 2 * c["pod"] + c["data"]
        assert torch.equal(b, t[2 * i:2 * i + 2, 3 * c["model"]:
                                3 * c["model"] + 3])
    assert len(st.representatives()) == 8
    assert torch.equal(st.full(), t)
    with pytest.raises(ValueError, match="divide"):
        shd.ShardedTensor.scatter(torch.zeros(5, 6), sh)
