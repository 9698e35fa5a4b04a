"""repro_torch's bf16 precision contract vs the JAX package, on the CPU.

``precision="bf16"`` rounds the projection samples to bfloat16 on their
way into a back-projector (and the volume on its way into the forward
projector of a solve); matrices, weights, accumulators and the output stay
float32. The port rounds and upcasts for every variant, where the JAX
package hands its pure-JAX variants the bf16 array itself: the same
rounding. Held here against the JAX bf16 results at rel-RMSE 1e-4
(measured: at most 3.4e-7 for FDK, 3.9e-6 for the solvers), the JAX
Pallas kernels in interpret mode as its own tests run them."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import repro
from repro.core.forward import forward_project as j_forward
from repro.core.geometry import standard_geometry as j_geom
from repro.core.phantom import shepp_logan_3d
from repro.runtime import solvers as jsolvers
from repro.runtime.executor import ProgramCache as JCache

import repro_torch
from repro_torch import convert
from repro_torch.runtime import solvers
from repro_torch.runtime.executor import (PlanExecutor, ProgramCache,
                                          _plan_dtype, _precision_adapter)
from repro_torch.runtime.planner import plan_reconstruction

from conftest import rel_rmse

BAR = 1e-4
BF16_CONTRACT = 2e-2        # tests/test_solvers.py: bf16 against f32
_FDK = {}


def _smoke():
    """(JAX geometry, port geometry, projections, JAX f32 FDK) of the
    smoke problem (16^3, 24^2 detector, 8 views)."""
    if not _FDK:
        g = j_geom(n=16, n_det=24, n_proj=8)
        t = convert.geometry_from_reference(dataclasses.asdict(g))
        p = np.random.RandomState(16).rand(8, g.nh, g.nw).astype(np.float32)
        f32 = np.asarray(repro.reconstruct(jnp.asarray(p), g, nb=4))
        _FDK.update(g=g, t=t, p=p, f32=f32)
    return _FDK["g"], _FDK["t"], _FDK["p"], _FDK["f32"]


@pytest.fixture(scope="module")
def solver_setup():
    g = j_geom(n=16, n_det=24, n_proj=12)
    t = convert.geometry_from_reference(dataclasses.asdict(g))
    projs = np.array(j_forward(jnp.asarray(shepp_logan_3d(16)), g,
                               oversample=1.0))
    return g, t, projs


@pytest.mark.parametrize("variant", ["algorithm1_mp", "subline_pl",
                                     "onehot_pl", "banded_pl"])
def test_bf16_fdk_matches_jax(variant):
    g, t, p, f32 = _smoke()
    want = np.asarray(repro.reconstruct(
        jnp.asarray(p), g, options=repro.ReconOptions(
            variant=variant, nb=4, precision="bf16")))
    got = repro_torch.reconstruct(
        p, t, options=repro_torch.ReconOptions(variant=variant, nb=4,
                                               precision="bf16"),
        device="cpu")
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    assert rel_rmse(got.numpy(), want) < BAR
    r = rel_rmse(got.numpy(), f32)
    assert 0.0 < r < BF16_CONTRACT


@pytest.mark.parametrize("schedule", ["step", "chunk"])
@pytest.mark.parametrize("out", ["device", "host"])
def test_bf16_tiled_fdk_matches_jax(schedule, out):
    g, t, p, _ = _smoke()
    kw = dict(variant="algorithm1_mp", nb=4, precision="bf16",
              tiling=(8, 8, 8), schedule=schedule, out=out, proj_batch=4)
    want = np.asarray(repro.reconstruct(jnp.asarray(p), g,
                                        options=repro.ReconOptions(**kw)))
    got = repro_torch.reconstruct(p, t, options=repro_torch.ReconOptions(
        **kw), device="cpu")
    got = got if isinstance(got, np.ndarray) else got.numpy()
    assert got.dtype == np.float32
    assert rel_rmse(got, want) < BAR


def test_precision_adapter_rounds_and_upcasts():
    x = torch.from_numpy(np.random.RandomState(0).rand(4, 5, 6).astype(
        np.float32))
    assert _precision_adapter("float32") is None
    y = _precision_adapter("bfloat16")(x)
    assert y.dtype == torch.float32
    assert torch.equal(y, x.to(torch.bfloat16).float())
    assert not torch.equal(y, x)
    with pytest.raises(ValueError, match="dtype"):
        _precision_adapter("float16")


def test_bf16_plans_get_their_own_programs():
    _, t, p, _ = _smoke()
    cache = ProgramCache()
    for precision in ("f32", "bf16"):
        plan = plan_reconstruction(t, "subline_pl", out="device", nb=4,
                                   precision=precision)
        ex = PlanExecutor(t, plan, cache, device="cpu")
        assert ex._dtype == _plan_dtype(plan)
        ex.reconstruct(p)
    assert {k[4] for k in cache._programs} == {"float32", "bfloat16"}
    assert cache.stats()["misses"] == 2


@pytest.mark.parametrize("method,kw", [("sart", {}),
                                       ("os_sart", {"proj_batch": 4}),
                                       ("cgls", {}), ("fista_tv", {})])
def test_bf16_solve_matches_jax(solver_setup, method, kw):
    g, t, projs = solver_setup
    want, jrep = jsolvers.solve(jnp.asarray(projs), g, method, n_iters=3,
                                oversample=1.0, nb=4, precision="bf16",
                                cache=JCache(), **kw)
    got, rep = solvers.solve(projs, t, method, n_iters=3, oversample=1.0,
                             nb=4, precision="bf16", cache=ProgramCache(),
                             device="cpu", **kw)
    assert rep.precision == "bf16" and got.dtype == torch.float32
    assert rel_rmse(got.numpy(), np.asarray(want)) < BAR
    for a, b in zip(rep.residuals, jrep.residuals):
        assert abs(a - b) <= BAR * abs(b), (rep.residuals, jrep.residuals)


def test_bf16_within_tolerance_of_f32(solver_setup):
    _, t, projs = solver_setup
    x32, r32 = solvers.solve(projs, t, "sart", n_iters=3, oversample=1.0,
                             nb=4, precision="f32", cache=ProgramCache(),
                             device="cpu")
    x16, r16 = solvers.solve(projs, t, "sart", n_iters=3, oversample=1.0,
                             nb=4, precision="bf16", cache=ProgramCache(),
                             device="cpu")
    assert r16.precision == "bf16"
    assert rel_rmse(x16.numpy(), x32.numpy()) < BF16_CONTRACT
    for a, b in zip(r16.residuals, r16.residuals[1:]):
        assert b < a * 1.001


def test_bf16_is_not_f32(solver_setup):
    """The reduced-precision path must reduce precision (guards against
    the adapter silently being a no-op), in the forward program too."""
    _, t, projs = solver_setup
    x32, _ = solvers.solve(projs, t, "sart", n_iters=2, oversample=1.0,
                           nb=4, precision="f32", cache=ProgramCache(),
                           device="cpu")
    x16, _ = solvers.solve(projs, t, "sart", n_iters=2, oversample=1.0,
                           nb=4, precision="bf16", cache=ProgramCache(),
                           device="cpu")
    assert float((x16 - x32).abs().max()) > 0.0
    plan = plan_reconstruction(t, "algorithm1_mp", out="device", nb=4,
                               precision="bf16", solver="sart")
    ex = solvers.IterativeExecutor(t, plan, ProgramCache(), device="cpu")
    vol = torch.from_numpy(np.random.RandomState(1).rand(16, 16, 16).astype(
        np.float32))
    fp16 = ex._fp(vol)
    fp_rounded = ex._fp(vol.to(torch.bfloat16).float())
    assert torch.equal(fp16, fp_rounded)
    assert not torch.equal(fp16, repro_torch.forward_project(
        vol, t, oversample=1.0))


def test_precision_in_bucket_key():
    _, t, _, _ = _smoke()
    a = plan_reconstruction(t, "algorithm1_mp", out="device")
    b = plan_reconstruction(t, "algorithm1_mp", out="device",
                            precision="bf16")
    c = plan_reconstruction(t, "algorithm1_mp", out="device", solver="sart")
    assert a.bucket_key != b.bucket_key
    assert a.bucket_key != c.bucket_key
    with pytest.raises(ValueError):
        plan_reconstruction(t, "algorithm1_mp", out="device",
                            precision="f64")
