"""repro_torch's mesh-sharded back-projection vs the JAX package, on the CPU.

The JAX ``tests/test_distributed.py`` runs ``shard_map`` over 8 forced
host devices in a subprocess; the port's mesh is a tuple of torch
devices in one process, so a ``("cpu",) * 8`` mesh runs here directly.
The JAX side is single-device: the port's mesh walk is held to the JAX
``bp_subline_symmetry_scan`` at rel-max 1e-5 (the reference test's bar)
and to the oracle ``backproject_ref`` at rel-RMSE 1e-5; the tiled
composition's async flush equals its sync walk bit for bit. Also here:
the CT projection source against the JAX one.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import projection_matrices as j_mats
from repro.core import standard_geometry as j_geom
from repro.core import transpose_projections as j_transpose
from repro.core.backproject import bp_subline_symmetry_batch as j_batch
from repro.core.backproject import bp_subline_symmetry_scan as j_scan
from repro.data import CTProjectionSource as JSource
from repro.kernels import backproject_ref

from repro_torch import convert
from repro_torch.core import distributed as tdist
from repro_torch.data import CTProjectionSource
from repro_torch.launch import mesh as tmesh
from repro_torch.runtime import executor as tex
from repro_torch.runtime.engine import TiledReconstructor

from conftest import rel_rmse

BAR = 1e-5
POD = ("pod", "data", "model")


def _rel_max(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def case():
    """The reference test's problem: n=16, a 24 x 24 detector, 8 views."""
    g = j_geom(n=16, n_det=24, n_proj=8)
    rng = np.random.RandomState(0)
    img = rng.rand(g.n_proj, g.nh, g.nw).astype(np.float32)
    img_t = np.array(j_transpose(jnp.asarray(img)))
    mats = np.array(j_mats(g))
    scan = np.asarray(j_scan(jnp.asarray(img_t), jnp.asarray(mats),
                             g.volume_shape_xyz))
    oracle = np.asarray(backproject_ref(jnp.asarray(img_t),
                                        jnp.asarray(mats),
                                        g.volume_shape_xyz))
    t = convert.geometry_from_reference(dataclasses.asdict(g))
    return dict(g=g, t=t, img_t=img_t, mats=mats, scan=scan, oracle=oracle)


def _mesh(shape=(2, 2, 2), names=POD):
    return tmesh.make_mesh(shape, names, ("cpu",) * int(np.prod(shape)))


def test_distributed_bp_matches_single_device(case):
    """nb=6 does not divide the 8 views: the tail batch is padded (and 6
    still divides over pod=2)."""
    vol = tdist.distributed_backproject(
        torch.from_numpy(case["img_t"]), torch.from_numpy(case["mats"]),
        case["t"], _mesh(), nb=6)
    assert isinstance(vol, torch.Tensor) and vol.device.type == "cpu"
    assert tuple(vol.shape) == case["t"].volume_shape_xyz
    assert _rel_max(vol, case["scan"]) < BAR
    assert rel_rmse(vol.numpy(), case["oracle"]) < BAR


@pytest.mark.parametrize("shape,names", [((2, 2, 2), POD),
                                         ((4, 2), ("data", "model")),
                                         ((1, 1, 1), POD)])
@pytest.mark.parametrize("variant", ["scan", "batch"])
def test_distributed_variants_and_meshes(case, shape, names, variant):
    """Both ladders, with and without a "pod" axis; numpy input."""
    vol = tdist.distributed_backproject(case["img_t"], case["mats"],
                                        case["t"], _mesh(shape, names),
                                        nb=4, variant=variant)
    assert _rel_max(vol, case["scan"]) < BAR
    if variant == "batch":
        want = np.asarray(j_batch(jnp.asarray(case["img_t"]),
                                  jnp.asarray(case["mats"]),
                                  case["g"].volume_shape_xyz, nb=4))
        assert _rel_max(vol, want) < BAR


def test_tiled_engine_composes_with_mesh(case):
    """(i, j)-tiles through the mesh program (5 x 7 tiles divide nothing
    in 16), each unpadded into its box of the host volume."""
    eng = TiledReconstructor(case["t"], tile_shape=(5, 7, case["t"].nz),
                             nb=4, device="cpu")
    vol = eng.backproject_distributed(case["img_t"], case["mats"], _mesh(),
                                      nb=4)
    assert isinstance(vol, np.ndarray)
    assert _rel_max(vol, case["scan"]) < BAR
    assert rel_rmse(vol, case["oracle"]) < BAR


def test_distributed_async_flush_bit_identical(case):
    """Tiles write disjoint boxes of the zeroed volume, so the flusher
    thread's add equals the sequential assignment bit for bit."""
    eng = TiledReconstructor(case["t"], tile_shape=(5, 7, case["t"].nz),
                             nb=4, device="cpu")
    sync = eng.backproject_distributed(case["img_t"], case["mats"], _mesh(),
                                       nb=4)
    via_async = eng.backproject_distributed(
        case["img_t"], case["mats"], _mesh(), nb=4, pipeline="async")
    assert np.array_equal(sync, via_async)
    eng_async = TiledReconstructor(case["t"], tile_shape=(5, 7, 16), nb=4,
                                   pipeline="async", device="cpu")
    assert np.array_equal(sync, eng_async.backproject_distributed(
        case["img_t"], case["mats"], _mesh(), nb=4))


def test_one_program_per_tile_shape(case):
    """16 = 5+5+5+1 by 7+7+2: four tile shapes, four mesh programs, and a
    second walk builds nothing."""
    cache = tex.ProgramCache()
    eng = TiledReconstructor(case["t"], tile_shape=(5, 7, 16), nb=4,
                             cache=cache, device="cpu")
    base = cache.stats()["misses"]
    eng.backproject_distributed(case["img_t"], case["mats"], _mesh(), nb=4)
    dist = [k for k in cache._programs if k[0] == "dist"]
    assert sorted(k[2] for k in dist) == [(1, 2, 16), (1, 7, 16),
                                          (5, 2, 16), (5, 7, 16)]
    assert cache.stats()["misses"] == base + 4
    eng.backproject_distributed(case["img_t"], case["mats"], _mesh(), nb=4)
    assert cache.stats()["misses"] == base + 4


def test_distributed_backproject_caches_its_program(case):
    cache = tex.default_program_cache()
    mesh = _mesh()
    tdist.distributed_backproject(case["img_t"], case["mats"], case["t"],
                                  mesh, nb=2)
    misses = cache.stats()["misses"]
    tdist.distributed_backproject(case["img_t"], case["mats"], case["t"],
                                  mesh, nb=2)
    assert cache.stats()["misses"] == misses
    key = ("dist", "scan", case["t"].volume_shape_xyz, 2, case["t"], mesh)
    assert key in cache._programs


def test_make_distributed_bp_contract(case):
    """The partial volume of one batch is padded to the mesh; a sub-box
    takes its origin at call time; the specs are the reference's."""
    t = case["t"]
    mesh = _mesh((2, 2, 2))
    fn, specs = tdist.make_distributed_bp(t, mesh, nb=4,
                                          vol_shape_xyz=(5, 7, t.nz))
    assert specs == (("pod", None, None), ("pod", None, None), (None,),
                     ("data", "model", None))
    img = torch.from_numpy(case["img_t"][:4])
    mats = torch.from_numpy(case["mats"][:4])
    part = fn(img, mats, (5.0, 7.0))
    assert tuple(part.shape) == (6, 8, t.nz)
    full = tdist.make_distributed_bp(t, _mesh((1, 1, 1)), nb=4)[0](
        img, mats, (0.0, 0.0))
    assert _rel_max(part[:5, :7], full[5:10, 7:14]) < BAR
    _, specs = tdist.make_distributed_bp(t, _mesh((4, 2), ("data",
                                                           "model")), nb=4)
    assert specs[0] == (None, None, None)


def test_distributed_refusals(case, monkeypatch):
    """nb must divide over "pod"; a mesh needs exactly prod(shape)
    entries of one device type (no card here: ``devices=None`` sees 0)."""
    t = case["t"]
    with pytest.raises(ValueError, match="pod=2"):
        tdist.make_distributed_bp(t, _mesh(), nb=5)
    with pytest.raises(ValueError, match="pod=2"):
        tdist.distributed_backproject(case["img_t"], case["mats"], t,
                                      _mesh(), nb=5)
    fn, _ = tdist.make_distributed_bp(t, _mesh(), nb=4)
    with pytest.raises(ValueError, match="pod=2"):
        fn(torch.from_numpy(case["img_t"][:3]),
           torch.from_numpy(case["mats"][:3]), (0.0, 0.0))
    with pytest.raises(ValueError, match="scan"):
        tdist.make_distributed_bp(t, _mesh(), nb=4, variant="bogus")
    with pytest.raises(ValueError, match="mesh axes"):
        tdist.make_distributed_bp(
            t, tmesh.make_mesh((2,), ("x",), ("cpu",) * 2), nb=4)
    with pytest.raises(ValueError, match="needs 8 devices, got 4"):
        tmesh.make_mesh((2, 2, 2), POD, ("cpu",) * 4)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA devices are visible"):
            tmesh.make_mesh((2, 2, 2), POD)
        with pytest.raises(ValueError, match="CUDA devices are visible"):
            tmesh.make_production_mesh()
        with pytest.raises(ValueError, match="CUDA devices are visible"):
            tmesh.make_production_mesh(multi_pod=True)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_host_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh((2,), ("data",), ("cuda:0", "cuda:0"))
    with pytest.raises(ValueError, match="one distinct name"):
        tmesh.make_mesh((2, 2), ("data",), ("cpu",) * 4)
    # a card's names resolved without one (nothing runs)
    monkeypatch.setattr(tex, "_fleet_device", torch.device)
    for devices in (("cuda:0", "cpu"), ("cpu", "cuda:0")):
        with pytest.raises(ValueError, match="one device type"):
            tmesh.make_mesh((2,), ("data",), devices)
    assert tmesh.make_mesh((2,), ("data",), ("cuda:0",) * 2).devices == (
        torch.device("cuda:0"),) * 2


def test_mesh_record():
    m = tmesh.make_mesh((2, 2, 2), POD, ("cpu",) * 8)
    assert m == tmesh.make_mesh((2, 2, 2), POD, ["cpu"] * 8)
    assert hash(m) == hash(tmesh.make_mesh((2, 2, 2), POD, ("cpu",) * 8))
    assert (m.axis_size("pod"), m.axis_size("data"), m.axis_size("x")) == \
        (2, 2, 1)
    assert m.device_at(pod=1, data=1, model=1) == torch.device("cpu")
    assert tmesh.data_axes(m) == ("pod", "data")
    assert tmesh.data_axes(tmesh.make_mesh((3, 1), ("data", "model"),
                                           ("cpu",) * 3)) == ("data",)


@pytest.mark.parametrize("phantom", ["shepp", "ball"])
def test_ct_projection_source_matches_jax(phantom):
    """The same phantom forward-projected by both packages (the plain
    march here), served in angle-contiguous batches of nb with their
    view indices."""
    g = j_geom(n=16, n_det=24, n_proj=8)
    t = convert.geometry_from_reference(dataclasses.asdict(g))
    want = JSource(g, nb=3, phantom=phantom)
    got = CTProjectionSource(t, nb=3, phantom=phantom, device="cpu")
    assert np.array_equal(got.volume, want.volume)
    assert isinstance(got.projections, np.ndarray)
    assert got.projections.shape == want.projections.shape
    assert rel_rmse(got.projections, want.projections) < BAR
    batches = list(got)
    assert [idx.tolist() for _, idx in batches] == [
        idx.tolist() for _, idx in want]
    assert [b.shape[0] for b, _ in batches] == [3, 3, 2]
    assert np.array_equal(np.concatenate([b for b, _ in batches]),
                          got.projections)


def test_ct_projection_source_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    t = convert.geometry_from_reference(dataclasses.asdict(
        j_geom(n=8, n_det=12, n_proj=2)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CTProjectionSource(t, nb=2)
