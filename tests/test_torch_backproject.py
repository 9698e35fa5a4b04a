"""repro_torch back-projectors vs the JAX package on the CPU.

The port is held against the JAX oracle (``kernels/ref.py::
backproject_ref``) and the pure-JAX ``algorithm1_mp``, never against the
JAX Pallas kernels (which are off in the odd-nz middle plane). On CPU
tensors the CUDA kernel wrappers run their plain PyTorch versions, so
these tests cover the K1/K2 routing, padding and option handling; the
kernels themselves are held against the same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import backproject as jbp
from repro.core import projection_matrices as j_mats
from repro.core import standard_geometry as j_geom
from repro.core import variants as jvar
from repro.kernels import backproject_ref
from repro.kernels import ops as j_ops
from repro.kernels.ref import subline_blend_ref as j_blend

from repro_torch import convert
from repro_torch.core import backproject as tbp
from repro_torch.core import variants as tvar
from repro_torch.core.geometry import projection_matrices as t_mats
from repro_torch.kernels import backproject_subline as ks
from repro_torch.kernels import ops
from repro_torch.kernels.ref import backproject_ref as t_ref
from repro_torch.kernels.ref import subline_blend_ref as t_blend

from conftest import rel_rmse

BAR = 1e-5
j_ref = jax.jit(backproject_ref, static_argnums=2)
SWEEP = [(16, 24, 6), (16, 16, 4), (13, 17, 5), (8, 32, 3), (20, 12, 7)]


@dataclasses.dataclass
class Case:
    shape: tuple
    j_img_t: object
    j_mats: object
    img_t: torch.Tensor
    mats: torch.Tensor
    ref: np.ndarray


_CASES = {}


def _case(n, det, nproj, seed=0) -> Case:
    key = (n, det, nproj, seed)
    if key not in _CASES:
        g = j_geom(n=n, n_det=det, n_proj=nproj)
        t = convert.geometry_from_reference(dataclasses.asdict(g))
        img = np.random.RandomState(seed).rand(
            nproj, g.nh, g.nw).astype(np.float32)
        ji = jbp.transpose_projections(jnp.asarray(img))
        jm = j_mats(g)
        _CASES[key] = Case(
            g.volume_shape_xyz, ji, jm,
            tbp.transpose_projections(torch.from_numpy(img)),
            t_mats(t, device="cpu"),
            np.asarray(j_ref(ji, jm, g.volume_shape_xyz)))
    return _CASES[key]


@pytest.fixture(autouse=True)
def _no_launches():
    """Every test here runs on CPU tensors: no kernel is ever launched."""
    ks.reset_launches()
    yield
    assert sum(ks.LAUNCHES.values()) == 0, ks.LAUNCHES


# ---- plain back-projectors vs the JAX package --------------------------------

@pytest.mark.parametrize("n,det,nproj", SWEEP)
def test_oracle_matches_jax(n, det, nproj):
    c = _case(n, det, nproj)
    assert rel_rmse(t_ref(c.img_t, c.mats, c.shape).numpy(), c.ref) < BAR


@pytest.mark.parametrize("n,det,nproj", SWEEP)
@pytest.mark.parametrize("variant", ["algorithm1_mp", "subline_batch_mp"])
def test_plain_variants_match_jax(n, det, nproj, variant):
    c = _case(n, det, nproj)
    out = tvar.get_spec(variant).fn(c.img_t, c.mats, c.shape, nb=1)
    jout = jvar.get_spec(variant).fn(c.j_img_t, c.j_mats, c.shape, nb=1)
    assert rel_rmse(out.numpy(), np.asarray(jout)) < BAR
    assert rel_rmse(out.numpy(), c.ref) < BAR


@pytest.mark.parametrize("nb", [2, 3])
def test_batched_variants_match_jax(nb):
    c = _case(16, 24, 6, seed=3)
    for fn, jfn in ((tbp.bp_subline_symmetry_batch,
                     jbp.bp_subline_symmetry_batch),
                    (tbp.bp_subline_batch, jbp.bp_subline_batch)):
        out = fn(c.img_t, c.mats, c.shape, nb=nb)
        jout = jfn(c.j_img_t, c.j_mats, c.shape, nb=nb)
        assert rel_rmse(out.numpy(), np.asarray(jout)) < BAR


def test_batched_variant_rejects_indivisible_count():
    c = _case(13, 17, 5)
    with pytest.raises(ValueError, match="not divisible"):
        tbp.bp_subline_symmetry_batch(c.img_t, c.mats, c.shape, nb=2)


@pytest.mark.parametrize("n,det,nproj", SWEEP)
def test_kernel_plain_version_matches_oracle(n, det, nproj):
    c = _case(n, det, nproj)
    out = ks.backproject_subline_plain(c.img_t, c.mats, c.shape)
    assert rel_rmse(out.numpy(), c.ref) < BAR


def test_subline_blend_stage_matches_jax():
    rng = np.random.RandomState(1)
    img_ts = rng.rand(12, 9).astype(np.float32)
    x = np.asarray([0.25, 3.75, 10.999, 0.0, 11.0], np.float32)
    out = t_blend(torch.from_numpy(img_ts), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        out, np.asarray(j_blend(jnp.asarray(img_ts), jnp.asarray(x))),
        rtol=1e-6)


# ---- the kernel routing (ops) on CPU tensors vs the JAX oracle --------------

@pytest.mark.parametrize("block", [(1, 8), (2, 8), (4, 8), (4, 16)])
@pytest.mark.parametrize("nb,proj_loop", [(1, True), (2, True), (3, True),
                                          (4, True), (2, False)])
def test_ops_routes_match_oracle(block, nb, proj_loop):
    # 6 views: nb 2 and 3 run the fused (K2) route, nb 4 does not divide
    # the count and nb 1 never fuses, so both run the K1 route
    c = _case(16, 24, 6)
    out = ops.backproject_subline(c.img_t, c.mats, c.shape, nb=nb,
                                  block=block, proj_loop=proj_loop,
                                  device="cpu")
    assert tuple(out.shape) == c.shape
    assert rel_rmse(out.numpy(), c.ref) < BAR


@pytest.mark.parametrize("n,det,nproj", SWEEP)
@pytest.mark.parametrize("block", [(4, 8), (4, 16)])
def test_ops_sweep_matches_oracle(n, det, nproj, block):
    c = _case(n, det, nproj)
    out = ops.backproject_subline(c.img_t, c.mats, c.shape, nb=nproj,
                                  block=block, proj_loop=True, device="cpu")
    assert rel_rmse(out.numpy(), c.ref) < BAR


def test_fused_batch_rule_matches_jax():
    from repro.kernels.backproject_subline import fused_batch_ok as j_ok
    for n_proj in (1, 4, 5, 6, 8, 9):
        for nb in (0, 1, 2, 3, 4, 8):
            for loop in (False, True):
                assert ks.fused_batch_ok(n_proj, nb, loop) == \
                    j_ok(n_proj, nb, loop)


def test_kernel_wrappers_direct():
    c = _case(16, 24, 6)
    k1 = ks.backproject_subline_kernel(c.img_t, c.mats, c.shape)
    k2 = ks.backproject_subline_fused(c.img_t, c.mats, c.shape, nb=3)
    assert rel_rmse(k1.numpy(), c.ref) < BAR
    assert rel_rmse(k2.numpy(), c.ref) < BAR
    with pytest.raises(ValueError, match="dividing"):
        ks.backproject_subline_fused(c.img_t, c.mats, c.shape, nb=4)


@pytest.mark.parametrize("n,det,nproj", [(13, 17, 5), (15, 20, 6),
                                         (9, 12, 3)])
def test_odd_nz_middle_plane(n, det, nproj):
    """The self-mirrored plane k = nz//2 is computed directly (the
    uneven half-split), where the reference's Pallas kernel is off."""
    c = _case(n, det, nproj)
    mid = n // 2
    outs = {
        "K1": ks.backproject_subline_kernel(c.img_t, c.mats, c.shape),
        "K2": ks.backproject_subline_fused(c.img_t, c.mats, c.shape,
                                           nb=nproj),
        "algorithm1_mp": tbp.bp_subline_symmetry_batch(c.img_t, c.mats,
                                                       c.shape, nb=1),
    }
    for name, out in outs.items():
        plane = out.numpy()[..., mid]
        assert np.abs(plane).max() > 0, name
        assert rel_rmse(plane, c.ref[..., mid]) < BAR, name


@pytest.mark.parametrize("bad", [
    lambda c: (c.img_t.double(), c.mats, c.shape, (4, 8)),
    lambda c: (c.img_t.transpose(1, 2), c.mats, c.shape, (4, 8)),
    lambda c: (c.img_t, c.mats[:-1], c.shape, (4, 8)),
    lambda c: (c.img_t, c.mats, (16, 16), (4, 8)),
    lambda c: (c.img_t, c.mats, c.shape, (4, 12)),
    lambda c: (c.img_t[0], c.mats, c.shape, (4, 8)),
])
def test_kernel_wrapper_rejects_what_it_does_not_take(bad):
    c = _case(16, 24, 6)
    img_t, mats, shape, block = bad(c)
    with pytest.raises((TypeError, ValueError)):
        ks.backproject_subline_kernel(img_t, mats, shape, block=block)


def test_ops_default_device_is_the_card():
    c = _case(16, 24, 6)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="lies on cpu"):
            ops.backproject_subline(c.img_t, c.mats, c.shape)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ops.backproject_subline(c.img_t, c.mats, c.shape)


# ---- registry contract ----------------------------------------------------------

def test_cuda_spec_matches_ops_accepted_options():
    """KernelSpec.options must agree with what kernels.ops consumes, and
    both with the JAX package's contract for the same wrapper."""
    assert ops.ACCEPTED_OPTIONS == j_ops.ACCEPTED_OPTIONS
    for variant, wrapper in (("subline_pl", "backproject_subline"),
                             ("onehot_pl", "backproject_onehot"),
                             ("banded_pl", "backproject_banded")):
        assert tvar.REGISTRY[variant].options == \
            ops.ACCEPTED_OPTIONS[wrapper]
        assert tvar.REGISTRY[variant].backend == "cuda"


@pytest.mark.parametrize("name", sorted(tvar.REGISTRY))
def test_registry_matches_jax(name):
    t, j = tvar.REGISTRY[name], jvar.REGISTRY[name]
    assert t.optimizations == j.optimizations
    assert t.options == j.options
    assert t.slab_safe_fallback == j.slab_safe_fallback
    assert t.proj_loop == j.proj_loop
    assert tvar.slab_safe_variant(name) == jvar.slab_safe_variant(name)
    assert t.resolve_options({"nb": 4, "interpret": False, "bw": 9}) == \
        j.resolve_options({"nb": 4, "interpret": False, "bw": 9})


def test_registry_lookups():
    assert tvar.get_spec("subline_pl").backend == "cuda"
    assert set(tvar.REGISTRY) | set(tvar.UNPORTED) == set(jvar.REGISTRY)
    for name in tvar.UNPORTED:
        with pytest.raises(KeyError, match="ROADMAP.md"):
            tvar.get_spec(name)
    with pytest.raises(KeyError, match="unknown"):
        tvar.get_spec("nope")
    tvar._validate_registry()
