"""repro_torch's iterative solvers vs the JAX package, on the CPU.

The same numpy projections (the JAX forward projection of the 16^3
Shepp-Logan phantom of ``tests/test_solvers.py``) go through the JAX
``solve`` and the port's for each method; the volumes are held at
rel-RMSE 1e-4 and the residual traces at 1e-4 relative (measured:
at most 1.2e-6 and 2e-6). The properties of ``tests/test_solvers.py``
are carried over: falling residuals, OS-SART ahead of SART per pass,
FISTA-TV ahead of SART in PSNR on sparse noisy views, and no program
built after iteration 1."""

import dataclasses
import math

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
from repro_torch.core.forward import forward_project
from repro_torch.kernels import backproject_banded as kb
from repro_torch.kernels import backproject_onehot as ko
from repro_torch.kernels import backproject_subline as ks
from repro_torch.kernels import forward_project as kf
from repro_torch.runtime import solvers
from repro_torch.runtime.executor import PlanExecutor, ProgramCache
from repro_torch.runtime.planner import plan_reconstruction

from conftest import rel_rmse

VOL_BAR = 1e-4
RESID_BAR = 1e-4
METHODS = [("sart", {}), ("os_sart", {"proj_batch": 4}), ("cgls", {}),
           ("fista_tv", {})]
_JAX = {}


@pytest.fixture(autouse=True)
def _no_launches():
    mods = (ks, ko, kb, kf)
    for mod in mods:
        mod.reset_launches()
    yield
    for mod in mods:
        assert sum(mod.LAUNCHES.values()) == 0, mod.LAUNCHES


@pytest.fixture(scope="module")
def setup():
    n = 16
    g = j_geom(n=n, n_det=24, n_proj=12)
    t = convert.geometry_from_reference(dataclasses.asdict(g))
    phantom = shepp_logan_3d(n)
    projs = np.array(j_forward(jnp.asarray(phantom), g, oversample=1.0))
    return g, t, phantom, projs


def _jax_solve(setup, method, **kw):
    """The JAX package's solve on the fixture, computed once per call."""
    key = (method, tuple(sorted(kw.items())))
    if key not in _JAX:
        g, _, _, projs = setup
        vol, rep = jsolvers.solve(jnp.asarray(projs), g, method, n_iters=3,
                                  oversample=1.0, nb=4, cache=JCache(), **kw)
        _JAX[key] = (np.asarray(vol), rep)
    return _JAX[key]


def _psnr(x, ref):
    x = np.asarray(x, np.float64)
    ref = np.asarray(ref, np.float64)
    mse = np.mean((x - ref) ** 2)
    peak = ref.max() - ref.min()
    return 10.0 * math.log10(peak * peak / max(mse, 1e-30))


def _close_traces(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert abs(a - b) <= RESID_BAR * abs(b), (got, want)


# ---------------------------------------------------------------------------
# parity with the JAX package


@pytest.mark.parametrize("method,kw", METHODS)
def test_solve_matches_jax(setup, method, kw):
    _, t, _, projs = setup
    want, jrep = _jax_solve(setup, method, **kw)
    vol, rep = solvers.solve(projs, t, method, n_iters=3, oversample=1.0,
                             nb=4, cache=ProgramCache(), device="cpu", **kw)
    assert isinstance(vol, torch.Tensor) and vol.device.type == "cpu"
    assert tuple(vol.shape) == want.shape and vol.dtype == torch.float32
    assert rel_rmse(vol.numpy(), want) < VOL_BAR
    _close_traces(rep.residuals, jrep.residuals)
    assert (rep.compiles_iter1, rep.compiles_warm) == \
        (jrep.compiles_iter1, jrep.compiles_warm)
    assert rep.extras.keys() == jrep.extras.keys()
    for name, value in jrep.extras.items():
        assert rep.extras[name] == pytest.approx(value, rel=RESID_BAR)


def test_fista_lipschitz_matches_jax(setup):
    _, t, _, projs = setup
    _, jrep = _jax_solve(setup, "fista_tv")
    _, rep = solvers.solve(projs, t, "fista_tv", n_iters=1, oversample=1.0,
                           nb=4, cache=ProgramCache(), device="cpu")
    assert rep.extras["lipschitz"] == pytest.approx(
        jrep.extras["lipschitz"], rel=RESID_BAR)


@pytest.mark.parametrize("shape,n_inner", [((6, 7, 8), 10), ((5, 4, 9), 3)])
def test_tv_prox_matches_jax(shape, n_inner):
    rng = np.random.RandomState(sum(shape))
    x = rng.rand(*shape).astype(np.float32)
    lam = np.float32(0.05)
    want = np.asarray(jsolvers._build_tv_prox(shape, n_inner)(
        jnp.asarray(x), jnp.float32(lam)))
    got = solvers._build_tv_prox(shape, n_inner)(torch.from_numpy(x),
                                                 float(lam))
    assert rel_rmse(got.numpy(), want) < 1e-5


def test_grad_and_div_match_jax():
    x = np.random.RandomState(3).rand(4, 5, 6).astype(np.float32)
    g = solvers._grad3(torch.from_numpy(x))
    assert np.array_equal(g.numpy(), np.asarray(jsolvers._grad3(
        jnp.asarray(x))))
    p = np.random.RandomState(4).rand(3, 4, 5, 6).astype(np.float32)
    assert np.allclose(solvers._div3(torch.from_numpy(p)).numpy(),
                       np.asarray(jsolvers._div3(jnp.asarray(p))),
                       rtol=0, atol=1e-6)


def test_sart_step_matches_jax(setup):
    from repro.core.fdk import sart_step as j_sart_step
    g, t, _, projs = setup
    x0 = np.random.RandomState(5).rand(16, 16, 16).astype(np.float32) * 0.1
    want = np.asarray(j_sart_step(jnp.asarray(x0), jnp.asarray(projs), g,
                                  nb=4, oversample=1.0))
    got = repro_torch.sart_step(x0, projs, t, nb=4, oversample=1.0,
                                device="cpu")
    assert rel_rmse(got.numpy(), want) < VOL_BAR


# ---------------------------------------------------------------------------
# properties carried over from tests/test_solvers.py


@pytest.mark.parametrize("method,kw", METHODS[:3])
def test_monotone_residual(setup, method, kw):
    _, t, _, projs = setup
    _, rep = solvers.solve(projs, t, method, n_iters=5, oversample=1.0,
                           nb=4, cache=ProgramCache(), device="cpu", **kw)
    assert len(rep.residuals) == 5
    for a, b in zip(rep.residuals, rep.residuals[1:]):
        assert b < a * 1.001, rep.residuals
    assert rep.residuals[-1] < 0.5 * rep.residuals[0]


def test_os_sart_converges_faster_per_pass(setup):
    _, t, _, projs = setup
    _, sart = solvers.solve(projs, t, "sart", n_iters=4, oversample=1.0,
                            nb=4, cache=ProgramCache(), device="cpu")
    _, ossart = solvers.solve(projs, t, "os_sart", n_iters=4,
                              oversample=1.0, nb=4, proj_batch=4,
                              cache=ProgramCache(), device="cpu")
    assert ossart.residuals[-1] < sart.residuals[-1]
    assert ossart.extras["subsets"] == 3.0      # 12 views / 4


def test_fista_tv_beats_sart_psnr_sparse_view():
    n = 16
    g = j_geom(n=n, n_det=24, n_proj=8)           # sparse views
    t = convert.geometry_from_reference(dataclasses.asdict(g))
    phantom = shepp_logan_3d(n)
    projs = forward_project(torch.from_numpy(phantom), t, oversample=1.0)
    rng = np.random.RandomState(7)
    noisy = projs + torch.from_numpy(
        (0.02 * float(projs.abs().max())
         * rng.randn(*projs.shape)).astype(np.float32))
    vol_sart, _ = solvers.solve(noisy, t, "sart", n_iters=8,
                                oversample=1.0, nb=4, cache=ProgramCache(),
                                device="cpu")
    vol_tv, _ = solvers.solve(noisy, t, "fista_tv", n_iters=8,
                              oversample=1.0, nb=4, tv_weight=0.01,
                              cache=ProgramCache(), device="cpu")
    assert _psnr(vol_tv.numpy(), phantom) > _psnr(vol_sart.numpy(), phantom)


@pytest.mark.parametrize("method,kw", METHODS)
def test_compile_flat_after_iter1(setup, method, kw):
    """Every program a solve needs is built in iteration 1 (normalizers
    included); iterations 2..N and a second solve build nothing."""
    _, t, _, projs = setup
    cache = ProgramCache()
    _, rep = solvers.solve(projs, t, method, n_iters=4, oversample=1.0,
                           nb=4, cache=cache, device="cpu", **kw)
    assert rep.compiles_iter1 > 0
    assert rep.compiles_warm == 0, (method, rep)
    m0 = cache.stats()["misses"]
    _, rep2 = solvers.solve(projs, t, method, n_iters=2, oversample=1.0,
                            nb=4, cache=cache, device="cpu", **kw)
    assert cache.stats()["misses"] == m0
    assert rep2.compiles_iter1 == 0 and rep2.compiles_warm == 0
    forward = [k for k in cache._programs if k[0] == "forward"]
    assert forward and all(k[3] in (4, 12) for k in forward)


def test_warm_builds_everything_a_solve_needs(setup):
    _, t, _, projs = setup
    cache = ProgramCache()
    plan = plan_reconstruction(t, "algorithm1_mp", out="device", nb=4,
                               solver="fista_tv")
    ex = solvers.IterativeExecutor(t, plan, cache, device="cpu")
    stats = ex.warm()
    assert stats["misses"] > 0
    _, rep = ex.solve(projs, n_iters=2)
    assert rep.compiles_iter1 == 0 and rep.compiles_warm == 0
    assert ("tv_prox", (16, 16, 16), 10) in cache._programs


def test_subsets_clip_to_n_proj(setup):
    _, t, _, _ = setup
    plan = plan_reconstruction(t, "algorithm1_mp", out="device", nb=8,
                               proj_batch=8, solver="os_sart")
    assert plan.n_proj == 12
    subs = plan.subsets
    assert subs[-1][1] == 12                      # clipped, not padded
    assert all(s1 > s0 for s0, s1 in subs)


def test_solver_plan_validation(setup):
    _, t, _, _ = setup
    with pytest.raises(ValueError):
        plan_reconstruction(t, "algorithm1_mp", solver="sart", out="host")
    with pytest.raises(ValueError):
        plan_reconstruction(t, "algorithm1_mp", solver="nope", out="device")
    with pytest.raises(ValueError):
        plan_reconstruction(t, "algorithm1_mp", solver="sart", out="device",
                            ingest="stream")
    fdk = plan_reconstruction(t, "algorithm1_mp", out="device")
    with pytest.raises(ValueError, match="solver plan"):
        solvers.IterativeExecutor(t, fdk, device="cpu")
    sart = plan_reconstruction(t, "algorithm1_mp", out="device",
                               solver="sart")
    tuned = object()    # provenance only: the plan carries the knobs
    assert solvers.IterativeExecutor(t, sart, tuned=tuned,
                                     device="cpu").tuned is tuned
    # a solver plan runs on the plain executor too: one BP pass
    assert PlanExecutor(t, sart, device="cpu").plan.solver == "sart"


def test_solve_validates_its_inputs(setup):
    _, t, _, projs = setup
    with pytest.raises(ValueError, match="method"):
        solvers.solve(projs, t, "nope", device="cpu")
    with pytest.raises(ValueError, match="n_iters"):
        solvers.solve(projs, t, "sart", n_iters=0, device="cpu")
    with pytest.raises(ValueError, match="geometry"):
        solvers.solve(projs[:-1], t, "sart", n_iters=1, device="cpu")
    with pytest.raises(TypeError):
        solvers.solve(projs.tolist(), t, "sart", n_iters=1, device="cpu")


def test_executor_reuse_and_duck_type(setup):
    """solver_executor returns the SAME executor for the same request
    and device, and the executor exposes the PlanExecutor surface a
    serving layer's buckets rely on."""
    _, t, _, projs = setup
    cache = ProgramCache()
    plan = plan_reconstruction(t, "algorithm1_mp", out="device",
                               solver="sart")
    a = solvers.solver_executor(t, plan, cache, oversample=1.0,
                                device="cpu")
    b = solvers.solver_executor(t, plan, cache, oversample=1.0,
                                device="cpu")
    assert a is b
    assert a.supports_request_batching is False
    assert a.pipeline in ("sync", "async")
    assert a.tuned is None and a._dtype == "float32"
    vol = a.reconstruct(projs, n_iters=1, oversample=1.0)
    assert tuple(vol.shape) == (16, 16, 16)
    report = a.last_report.as_dict()
    assert report["method"] == "sart" and len(report["residuals"]) == 1
    solvers.clear_solver_executors()
    assert solvers.solver_executor(t, plan, cache, oversample=1.0,
                                   device="cpu") is not a


def test_sart_step_facade_delegates(setup):
    """The one-step façade rides the persistent executor: the second
    call builds nothing, and the update moves toward the data."""
    from repro_torch.runtime.executor import default_program_cache
    _, t, _, projs = setup
    x = torch.zeros((16, 16, 16))
    x1 = repro_torch.sart_step(x, projs, t, nb=4, oversample=1.0,
                               device="cpu")
    m0 = default_program_cache().stats()["misses"]
    x2 = repro_torch.sart_step(x1, projs, t, nb=4, oversample=1.0,
                               device="cpu")
    assert default_program_cache().stats()["misses"] == m0
    p = torch.from_numpy(projs)
    r0 = float(torch.linalg.vector_norm(
        p - forward_project(x, t, oversample=1.0)))
    r2 = float(torch.linalg.vector_norm(
        p - forward_project(x2, t, oversample=1.0)))
    assert r2 < r0


def test_lazy_table_matches_jax():
    for name in ("sart_step", "solve", "SolveReport", "IterativeExecutor"):
        assert name in repro_torch.__all__ and name in repro.__all__
    assert repro_torch.solve is solvers.solve
    assert [f.name for f in dataclasses.fields(repro_torch.SolveReport)] == \
        [f.name for f in dataclasses.fields(repro.SolveReport)]


def test_solve_without_device_raises_here(setup):
    """No silent CPU: the default device is the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, t, _, projs = setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solvers.solve(projs, t, "sart", n_iters=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.sart_step(np.zeros((16, 16, 16), np.float32), projs, t)


def test_phantom_sampled_on_a_slab_equals_the_whole():
    """chip_smoke.py samples the 512^3 phantom slab by slab through
    shepp_logan_at: the same values as the whole grid, and as the JAX
    package's phantom."""
    from repro.core.phantom import shepp_logan_3d as j_phantom
    from repro_torch.core.phantom import shepp_logan_at
    n = 20
    whole = shepp_logan_3d(n)
    assert np.array_equal(whole, j_phantom(n))
    axis = np.linspace(-1.0, 1.0, n, dtype=np.float64)
    Z, Y, X = np.meshgrid(axis[7:13], axis, axis, indexing="ij")
    assert np.array_equal(shepp_logan_at(X, Y, Z).astype(np.float32),
                          whole[7:13])
