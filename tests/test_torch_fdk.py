"""repro_torch FDK end to end vs the JAX package, on the CPU.

The port's ``subline_pl`` and ``algorithm1_mp`` are both held against the
JAX package's ``algorithm1_mp`` reconstruction (never its Pallas kernel,
which is off in the odd-nz middle plane)."""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import repro
from repro.api import _coerce_options as j_coerce
from repro.core import standard_geometry as j_geom

import repro_torch
from repro_torch import convert
from repro_torch.api import ReconOptions, _coerce_options
from repro_torch.core.fdk import _build_plan
from repro_torch.kernels import backproject_banded as kb
from repro_torch.kernels import backproject_onehot as ko
from repro_torch.kernels import backproject_subline as ks
from repro_torch.runtime.executor import (FleetConfig, PlanExecutor,
                                          ProgramCache)

from conftest import rel_rmse

BAR = 1e-5
# smoke_problem (P5-smoke: det 24, 8 views, vol 16) and the odd shape
SIZES = {"smoke": (16, 24, 8), "odd": (13, 17, 5)}
_REF = {}


def _problem(size):
    """(JAX geometry, port geometry, projections, JAX algorithm1_mp
    reconstruction) for one size, computed once."""
    if size not in _REF:
        n, det, nproj = SIZES[size]
        g = j_geom(n=n, n_det=det, n_proj=nproj)
        t = convert.geometry_from_reference(dataclasses.asdict(g))
        p = np.random.RandomState(n).rand(nproj, g.nh, g.nw).astype(
            np.float32)
        ref = np.asarray(repro.reconstruct(
            jnp.asarray(p), g, options=repro.ReconOptions(nb=4)))
        _REF[size] = (g, t, p, ref)
    return _REF[size]


@pytest.fixture(autouse=True)
def _no_launches():
    for mod in (ks, ko, kb):
        mod.reset_launches()
    yield
    for mod in (ks, ko, kb):
        assert sum(mod.LAUNCHES.values()) == 0, mod.LAUNCHES


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("variant", ["algorithm1_mp", "subline_pl",
                                     "onehot_pl", "banded_pl"])
@pytest.mark.parametrize("schedule", ["step", "chunk"])
@pytest.mark.parametrize("proj_batch", [None, 3])
@pytest.mark.parametrize("out", ["device", "host"])
def test_reconstruct_matches_jax(size, variant, schedule, proj_batch, out):
    g, t, p, ref = _problem(size)
    vol = repro_torch.reconstruct(
        p, t, options=ReconOptions(variant=variant, nb=4, schedule=schedule,
                                   proj_batch=proj_batch, out=out),
        device="cpu")
    if out == "host":
        assert isinstance(vol, np.ndarray)
    else:
        assert isinstance(vol, torch.Tensor) and vol.device.type == "cpu"
        vol = vol.numpy()
    assert vol.shape == g.volume_shape_zyx
    assert rel_rmse(vol, ref) < BAR


@pytest.mark.parametrize("nb", [1, 2, 8])
def test_subline_pl_nb_routes_match_jax(nb):
    """nb 1 runs the per-projection (K1) route, nb > 1 the fused one."""
    g, t, p, ref = _problem("odd")
    vol = repro_torch.reconstruct(p, t, variant="subline_pl", nb=nb,
                                  device="cpu")
    assert rel_rmse(vol.numpy(), ref) < BAR


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("variant,nb,knobs", [
    ("onehot_pl", 8, {}), ("onehot_pl", 1, {"k_chunk": 3}),
    ("banded_pl", 8, {}), ("banded_pl", 1, {"bw": 8}),
])
def test_cuda_variants_match_jax(size, variant, nb, knobs):
    """onehot_pl and banded_pl through the whole path, default (fused,
    nb=8) and per-projection routes, against the JAX algorithm1_mp."""
    g, t, p, ref = _problem(size)
    vol = repro_torch.reconstruct(
        p, t, options=ReconOptions(variant=variant, nb=nb,
                                   kernel_options=knobs), device="cpu")
    assert vol.shape == g.volume_shape_zyx
    assert rel_rmse(vol.numpy(), ref) < BAR


def test_reconstruct_shepp_logan_matches_jax():
    from repro.core.forward import forward_project
    from repro.core.phantom import shepp_logan_3d
    g = j_geom(n=16, n_det=24, n_proj=12)
    projs = np.asarray(forward_project(jnp.asarray(shepp_logan_3d(16)), g,
                                       oversample=1.0))
    ref = np.asarray(repro.reconstruct(jnp.asarray(projs), g, nb=4))
    t = convert.geometry_from_reference(dataclasses.asdict(g))
    vol = repro_torch.fdk_reconstruct(projs, t, "subline_pl", nb=4,
                                      device="cpu")
    assert rel_rmse(vol.numpy(), ref) < BAR


@pytest.mark.parametrize("schedule", ["step", "chunk"])
def test_backproject_matches_oracle(schedule):
    from repro.core import projection_matrices, transpose_projections
    from repro.kernels import backproject_ref
    g, t, _, _ = _problem("odd")
    img = np.random.RandomState(2).rand(7, g.nh, g.nw).astype(np.float32)
    img_t = np.asarray(transpose_projections(jnp.asarray(img)))
    mats = np.repeat(np.asarray(projection_matrices(g)), 2, axis=0)[:7]
    ref = np.asarray(backproject_ref(jnp.asarray(img_t), jnp.asarray(mats),
                                     g.volume_shape_xyz))
    plan = _build_plan(t, "subline_pl", nb=4, interpret=True, tiling=None,
                       memory_budget=None, proj_batch=4, out="device",
                       schedule=schedule)
    ex = PlanExecutor(t, plan, ProgramCache(), device="cpu")
    vol = ex.backproject(img_t, convert.tensor_from_numpy(mats, "cpu"))
    assert rel_rmse(vol.numpy(), ref) < BAR


def test_program_cache_hits_on_repeat():
    _, t, p, _ = _problem("smoke")
    cache = ProgramCache()
    plan = _build_plan(t, "subline_pl", nb=4, interpret=True, tiling=None,
                       memory_budget=None, proj_batch=None, out="device")
    ex = PlanExecutor(t, plan, cache, device="cpu")
    assert ex.warm() == {"hits": 0, "misses": 1, "programs": 1}
    a = ex.reconstruct(p)
    b = PlanExecutor(t, plan, cache, device="cpu").reconstruct(p)
    assert cache.stats() == {"hits": 2, "misses": 1, "programs": 1}
    assert torch.equal(a, b)


def test_default_cache_hits_on_repeated_facade_call():
    from repro_torch.runtime.executor import default_program_cache
    _, t, p, _ = _problem("smoke")
    repro_torch.reconstruct(p, t, nb=2, device="cpu")
    before = default_program_cache().stats()
    repro_torch.reconstruct(p, t, nb=2, device="cpu")
    after = default_program_cache().stats()
    assert after["hits"] == before["hits"] + 1
    assert after["misses"] == before["misses"]


def test_interpret_selects_nothing():
    _, t, p, _ = _problem("smoke")
    a = repro_torch.reconstruct(p, t, variant="subline_pl", interpret=True,
                                device="cpu")
    b = repro_torch.reconstruct(p, t, variant="subline_pl", interpret=False,
                                device="cpu")
    assert torch.equal(a, b)


_COERCE_CASES = [
    (None, {}),
    (None, {"nb": 4, "interpret": True}),
    ("nb8", {"nb": 4}),        # conflicting double spelling: warns
    ("nb8", {"nb": 8}),        # agreeing double spelling: silent
    ("nb8", {"unroll": 2, "nb": 8}),
    ("variant", {"variant": "algorithm1_mp", "schedule": "chunk"}),
]


def _opts(pkg, which):
    return {None: None,
            "nb8": pkg.ReconOptions(nb=2),
            "variant": pkg.ReconOptions(variant="subline_pl")}[which]


@pytest.mark.parametrize("which,overrides", _COERCE_CASES)
def test_coerce_options_parity(which, overrides):
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        jo = j_coerce(_opts(repro, which), dict(overrides), "t")
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        to = _coerce_options(_opts(repro_torch, which), dict(overrides), "t")
    assert dataclasses.asdict(to) == dataclasses.asdict(jo)
    assert [(w.category, str(w.message)) for w in tw] == \
        [(w.category, str(w.message)) for w in jw]


def test_coerce_conflict_warns_and_rejects_non_options():
    with pytest.warns(DeprecationWarning, match="nb=4 conflicts"):
        assert _coerce_options(ReconOptions(nb=2), {"nb": 4}, "t").nb == 4
    with pytest.raises(TypeError):
        _coerce_options({"nb": 4}, {}, "t")


def test_options_fields_match_jax():
    assert [f.name for f in dataclasses.fields(ReconOptions)] == \
        [f.name for f in dataclasses.fields(repro.ReconOptions)]
    assert dataclasses.asdict(ReconOptions()) == \
        dataclasses.asdict(repro.ReconOptions())


# precision="bf16" is ported: its two cases (kw0, kw6) became unported
# combinations that still name bf16 and run in test_bf16_options_run;
# variant="auto" and tuning= are ported too: their cases (kw0, kw1, kw2,
# kw7) became combinations with service= or devices=, and the options
# alone run in tests/test_torch_autotune.py; service= is ported: its
# cases (kw0, kw2, kw3) became combinations with devices=, and service=
# runs in tests/test_torch_service.py; devices= is ported as well (the
# fleet, tests/test_torch_fleet.py): every case still raises, for asking
# for two cards or for pairing devices= with service=
@pytest.mark.parametrize("kw", [
    dict(tiling=(8, 8, 8), precision="bf16", variant="auto", devices=2),
    dict(memory_budget=1 << 20, tuning="cache.json", devices=2),
    dict(tuning="cache.json", service=object(), devices=2),
    dict(service=object(), devices=2),
    dict(devices=2), dict(pipeline="async", devices=2),
    dict(precision="bf16", devices=2), dict(variant="auto", devices=2),
])
def test_unported_options_raise(kw):
    """devices= is ported too (tests/test_torch_fleet.py runs the fleet on
    the CPU); these combinations still raise: ``devices=2`` asks for two
    cards (there is no silent CPU fleet), and a service owns its devices,
    so ``service=`` with ``devices=`` is refused."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("two CUDA devices are present")
    _, t, p, _ = _problem("smoke")
    device = "cpu"
    if "service" in kw:
        device = None             # the service owns the device too
        err, match = ValueError, "do not pass both service= and devices="
    elif torch.cuda.is_available():
        err, match = ValueError, "CUDA devices are available"
    else:
        err, match = RuntimeError, "no CUDA device"
    with pytest.raises(err, match=match):
        repro_torch.reconstruct(p, t, options=ReconOptions(**kw),
                                device=device)


@pytest.mark.parametrize("kw", [dict(tiling=(8, 8, 8), precision="bf16"),
                                dict(precision="bf16")])
def test_bf16_options_run(kw):
    """The two bf16 calls that raised before precision was ported now run
    and match the JAX package's bf16 reconstruction."""
    g, t, p, _ = _problem("smoke")
    want = np.asarray(repro.reconstruct(
        jnp.asarray(p), g, options=repro.ReconOptions(nb=4, **kw)))
    got = repro_torch.reconstruct(p, t, options=ReconOptions(nb=4, **kw),
                                  device="cpu")
    got = got if isinstance(got, np.ndarray) else got.numpy()
    assert got.dtype == np.float32
    assert rel_rmse(got, want) < 1e-4


@pytest.mark.parametrize("method", ["sart", "os_sart", "cgls", "fista_tv"])
def test_iterative_methods_raise(method):
    """The iterative methods run through reconstruct and match the JAX
    package at 1e-4 (tests/test_torch_solvers.py); what still raises is
    what the JAX package refuses (devices=) and service= with device=
    (the service owns the device). service= routes the solve through a
    solver bucket and gives the direct solve's volume bit for bit."""
    g, t, p, _ = _problem("smoke")
    kw = dict(n_iters=3, nb=4, proj_batch=4 if method == "os_sart" else None)
    want = np.asarray(repro.reconstruct(jnp.asarray(p), g, method=method,
                                        options=repro.ReconOptions(**kw)))
    got = repro_torch.reconstruct(p, t, method=method,
                                  options=ReconOptions(**kw), device="cpu")
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert rel_rmse(got.numpy(), want) < 1e-4
    with pytest.raises(ValueError, match="devices="):
        repro_torch.reconstruct(p, t, method=method, devices=2,
                                device="cpu")
    from repro_torch.runtime.service import ReconService
    with ReconService(max_inflight=1, device="cpu") as svc:
        with pytest.raises(ValueError, match="device="):
            repro_torch.reconstruct(p, t, method=method, service=svc,
                                    device="cpu")
        via = repro_torch.reconstruct(
            p, t, method=method, options=ReconOptions(service=svc, **kw))
        assert svc.stats().buckets[0].completed == 1
    assert torch.equal(via, got)


def test_unported_variant_and_executor_paths_raise():
    """The fleet refuses a device-volume plan, as the JAX package does;
    the stream and batched plans, ``open_stream`` and ``execute_batch``
    run (tests/test_torch_streaming.py, tests/test_torch_batching.py), and
    so does ``execute_distributed`` (tests/test_torch_distributed.py)."""
    from repro_torch.runtime.planner import plan_reconstruction
    _, t, p, _ = _problem("smoke")
    stream = plan_reconstruction(t, "algorithm1_mp", ingest="stream")
    se = PlanExecutor(t, stream, device="cpu").open_stream()
    se.push(p)
    assert np.array_equal(
        se.close(), PlanExecutor(t, stream, device="cpu").reconstruct(p))
    batched = plan_reconstruction(t, "algorithm1_mp",
                                  tile_shape=(8, 8, 8)).batched(2)
    bex = PlanExecutor(t, batched, device="cpu")
    for got, want in zip(bex.execute_batch([p, p]),
                         [bex.reconstruct(p)] * 2):
        assert np.array_equal(got, want)
    plan = plan_reconstruction(t, "algorithm1_mp", out="device")
    with pytest.raises(ValueError, match="out='host'"):
        PlanExecutor(t, plan, fleet=FleetConfig(devices=("cpu",) * 2))
    ex = PlanExecutor(t, plan, device="cpu")
    with pytest.raises(ValueError, match="chunk-major"):
        ex.open_stream()
    with pytest.raises(ValueError, match="full scan"):
        ex.reconstruct(p[:-1])
    with pytest.raises(TypeError):
        ex.reconstruct(p.tolist())
    with pytest.raises(ValueError, match="method"):
        repro_torch.reconstruct(p, t, method="bogus", device="cpu")


def test_reconstruct_without_device_raises_here():
    """No silent CPU: the default device is the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, t, p, _ = _problem("smoke")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.reconstruct(p, t)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.fdk_reconstruct(p, t, "subline_pl")
    plan = _build_plan(t, "subline_pl", nb=4, interpret=True, tiling=None,
                       memory_budget=None, proj_batch=None, out=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PlanExecutor(t, plan)
