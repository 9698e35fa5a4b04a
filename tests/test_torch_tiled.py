"""repro_torch's tiled, out-of-core execution vs the JAX package, on the CPU.

The port's ``TiledReconstructor`` and ``fdk_reconstruct(tiling=,
memory_budget=)`` take the same numpy inputs as the JAX
``TiledReconstructor``: every one of the ten variants is held against the
JAX oracle ``backproject_ref`` (the ``_pl`` variants run their kernels'
plain versions here), and the pure variants against the JAX tiled engine
itself, at tile shapes that divide nothing (ragged (i, j)-tiles, paired,
centered and odd Z-slabs). The walks are held against each other:
step-major against chunk-major, host against device placement, and the
async flush against the sync one, bit for bit. The JAX side runs its pure
variants only, never Pallas.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro
from repro.core import backproject as jbp
from repro.core import projection_matrices as j_mats
from repro.core import standard_geometry as j_geom
from repro.kernels import backproject_ref
from repro.runtime.engine import TiledReconstructor as JTiled

import repro_torch
from repro_torch import convert
from repro_torch.core import backproject as tbp
from repro_torch.core import variants as tvar
from repro_torch.core.geometry import projection_matrices as t_mats
from repro_torch.core.tiling import (TileSpec, make_tiles, pick_tile_shape,
                                     plan_z_units, tile_working_set_bytes)
from repro_torch.kernels import backproject_banded as kb
from repro_torch.kernels import backproject_onehot as ko
from repro_torch.kernels import backproject_subline as ks
from repro_torch.runtime import executor as tex
from repro_torch.runtime.engine import TiledReconstructor
from repro_torch.runtime.planner import resolve_tile_variant

from conftest import rel_rmse

BAR = 1e-5
j_ref = jax.jit(backproject_ref, static_argnums=2)
VARIANTS = sorted(tvar.REGISTRY)
PURE = [v for v in VARIANTS if tvar.REGISTRY[v].backend != "cuda"]
# nothing divides 16^3 evenly: ragged (i, j)-tiles, paired slabs plus a
# centered middle slab; (16, 16, 3) isolates the Z schedule at full (i, j)
TILES = [(5, 7, 16), (5, 7, 5), (16, 16, 3)]
# (n, det, views, tile) of the odd volume: six mirror pairs of 2 planes
# and an odd 1-plane centered middle slab on nz = 13
ODD = (13, 17, 5, (5, 7, 2))
_CASES = {}


@dataclasses.dataclass
class Case:
    g: object             # JAX geometry
    t: object             # port geometry
    img: np.ndarray       # raw projections (np, nh, nw)
    img_t: torch.Tensor   # transposed, port
    mats: torch.Tensor    # port matrices
    j_img_t: object
    j_mats: object
    ref: np.ndarray       # JAX oracle vol_t


def _case(n=16, det=24, nproj=6, seed=0) -> Case:
    key = (n, det, nproj, seed)
    if key not in _CASES:
        g = j_geom(n=n, n_det=det, n_proj=nproj)
        t = convert.geometry_from_reference(dataclasses.asdict(g))
        img = np.random.RandomState(seed).rand(
            nproj, g.nh, g.nw).astype(np.float32)
        ji = jbp.transpose_projections(jnp.asarray(img))
        jm = j_mats(g)
        _CASES[key] = Case(
            g, t, img, tbp.transpose_projections(torch.from_numpy(img)),
            t_mats(t, device="cpu"), ji, jm,
            np.asarray(j_ref(ji, jm, g.volume_shape_xyz)))
    return _CASES[key]


def _np(vol):
    return vol.numpy() if isinstance(vol, torch.Tensor) else np.asarray(vol)


@pytest.fixture(autouse=True)
def _no_launches():
    """Everything here runs on CPU tensors: no kernel is ever launched."""
    for mod in (ks, ko, kb):
        mod.reset_launches()
    yield
    for mod in (ks, ko, kb):
        assert sum(mod.LAUNCHES.values()) == 0, mod.LAUNCHES


def _engine(c, variant, tile, **kw):
    kw.setdefault("nb", 2)
    return TiledReconstructor(c.t, variant, tile_shape=tile, device="cpu",
                              **kw)


# ---- parity: every variant x non-divisible tiles ---------------------------

@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("tile", TILES[:2])
def test_tiled_matches_oracle(variant, tile):
    c = _case()
    out = _engine(c, variant, tile).backproject(c.img_t, c.mats)
    assert isinstance(out, np.ndarray)
    assert rel_rmse(out, c.ref) < BAR, (variant, tile)


@pytest.mark.parametrize("variant", PURE)
def test_tiled_matches_jax_engine(variant):
    c = _case()
    tile = TILES[1]
    want = np.asarray(JTiled(c.g, variant, tile_shape=tile, nb=2)
                      .backproject(c.j_img_t, c.j_mats))
    got = _engine(c, variant, tile).backproject(c.img_t, c.mats)
    assert rel_rmse(got, want) < BAR


@pytest.mark.parametrize("variant", ["algorithm1_mp", "symmetry_mp",
                                     "subline_pl", "onehot_pl", "banded_pl"])
def test_odd_volume_odd_middle_slab(variant):
    """nz = 13 at tk = 2: mirror pairs and a 1-plane centered slab."""
    n, det, nproj, tile = ODD
    c = _case(n, det, nproj)
    eng = _engine(c, variant, tile, nb=1)
    calls = sorted({s.call_nk for s in eng.recon_plan.steps})
    assert calls == [1, 4]         # odd middle slab, paired slabs
    out = eng.backproject(c.img_t, c.mats)
    assert rel_rmse(out, c.ref) < BAR
    mid = n // 2
    assert rel_rmse(out[..., mid], c.ref[..., mid]) < BAR


@pytest.mark.parametrize("variant", ["algorithm1_mp", "subline_pl",
                                     "banded_pl"])
def test_tiled_full_ij_odd_slabs(variant):
    c = _case()
    out = _engine(c, variant, TILES[2]).backproject(c.img_t, c.mats)
    assert rel_rmse(out, c.ref) < BAR


@pytest.mark.parametrize("variant", ["symmetry_mp", "algorithm1_mp",
                                     "subline_pl", "onehot_pl", "banded_pl",
                                     "share_mp"])
def test_backproject_tile_uncentered_box_runs_the_fallback(variant):
    c = _case()
    eng = _engine(c, variant, None)
    tile = TileSpec(2, 3, 3, 9, 11, 6)                 # 2*3+6 != 16
    name = resolve_tile_variant(variant, tile, 16)
    assert name == tvar.slab_safe_variant(variant)
    out = eng.backproject_tile(c.img_t, c.mats, tile)
    assert tuple(out.shape) == tile.shape
    assert rel_rmse(_np(out), c.ref[tile.slices]) < BAR
    centered = TileSpec(0, 0, 4, 16, 16, 8)
    assert resolve_tile_variant(variant, centered, 16) == variant
    out = eng.backproject_tile(c.img_t, c.mats, centered)
    assert rel_rmse(_np(out), c.ref[centered.slices]) < BAR


# ---- the walks against each other ------------------------------------------

@pytest.mark.parametrize("variant", ["algorithm1_mp", "subline_pl",
                                     "banded_pl", "subline_mp"])
@pytest.mark.parametrize("out", ["host", "device"])
def test_step_major_matches_chunk_major(variant, out):
    c = _case()
    kw = dict(nb=2, proj_batch=4, out=out)
    step = _engine(c, variant, TILES[1], schedule="step", **kw)
    chunk = _engine(c, variant, TILES[1], schedule="chunk", **kw)
    a = _np(step.backproject(c.img_t, c.mats))
    b = _np(chunk.backproject(c.img_t, c.mats))
    assert rel_rmse(a, b) < BAR
    assert rel_rmse(a, c.ref) < BAR


@pytest.mark.parametrize("schedule", ["step", "chunk"])
def test_host_and_device_placement_agree(schedule):
    c = _case()
    kw = dict(proj_batch=4, schedule=schedule)
    host = _engine(c, "subline_pl", TILES[1], out="host", **kw)
    dev = _engine(c, "subline_pl", TILES[1], out="device", **kw)
    a = host.backproject(c.img_t, c.mats)
    b = dev.backproject(c.img_t, c.mats)
    assert isinstance(a, np.ndarray) and isinstance(b, torch.Tensor)
    assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("schedule", ["step", "chunk"])
@pytest.mark.parametrize("variant", ["algorithm1_mp", "subline_pl",
                                     "onehot_pl", "banded_pl"])
def test_async_equals_sync_bit_for_bit(schedule, variant):
    c = _case()
    kw = dict(proj_batch=4, schedule=schedule, out="host")
    sync = _engine(c, variant, TILES[1], pipeline="sync", **kw)
    asy = _engine(c, variant, TILES[1], pipeline="async", **kw)
    assert np.array_equal(sync.backproject(c.img_t, c.mats),
                          asy.backproject(c.img_t, c.mats))
    assert np.array_equal(sync.reconstruct(c.img), asy.reconstruct(c.img))


def test_async_flush_surfaces_a_failure():
    vol = np.zeros((2, 2, 2), np.float32)
    q = tex._AsyncFlushQueue(vol, torch.device("cpu"))
    q.put((((slice(0, 2), slice(0, 2), slice(0, 2)),
            torch.ones((2, 2, 3))),))           # shape mismatch: fails
    with pytest.raises(RuntimeError, match="size"):
        q.close()
    q = tex._AsyncFlushQueue(vol, torch.device("cpu"), depth=1)
    q.put((((slice(0, 1), slice(0, 2), slice(0, 2)),
            torch.ones((1, 2, 2))),))
    q.close()
    assert vol.sum() == 4.0


# ---- end to end: fdk_reconstruct(tiling=, memory_budget=) -------------------

_FDK = {}


def _jax_fdk(variant, **kw):
    key = (variant, tuple(sorted(kw.items())))
    if key not in _FDK:
        c = _case()
        _FDK[key] = np.asarray(repro.core.fdk_reconstruct(
            jnp.asarray(c.img), c.g, variant=variant, nb=2, **kw))
    return _FDK[key]


@pytest.mark.parametrize("variant", ["algorithm1_mp", "subline_pl",
                                     "onehot_pl", "banded_pl"])
@pytest.mark.parametrize("kw", [dict(tiling=(5, 7, 5)),
                                dict(tiling=(8, 8, 3), proj_batch=4,
                                     schedule="chunk"),
                                dict(memory_budget=64 << 10),
                                dict(tiling="auto", memory_budget=64 << 10,
                                     pipeline="async")])
def test_fdk_tiled_matches_jax(variant, kw):
    c = _case()
    want = _jax_fdk("algorithm1_mp")
    tiled = _jax_fdk("algorithm1_mp", **{k: v for k, v in kw.items()
                                        if k != "pipeline"})
    assert rel_rmse(tiled, want) < BAR
    got = repro_torch.fdk_reconstruct(c.img, c.t, variant, nb=2,
                                      device="cpu", **kw)
    assert isinstance(got, np.ndarray)     # a tiled plan lands on the host
    assert got.shape == c.g.volume_shape_zyx
    assert rel_rmse(got, tiled) < BAR


@pytest.mark.parametrize("pipeline", ["sync", "async"])
def test_reconstruct_api_tiling_reaches_the_plan(pipeline):
    c = _case()
    opts = repro_torch.ReconOptions(variant="subline_pl", nb=2,
                                    tiling=(8, 16, 5), out="device",
                                    pipeline=pipeline)
    got = repro_torch.reconstruct(c.img, c.t, options=opts, device="cpu")
    assert isinstance(got, torch.Tensor)
    assert rel_rmse(got.numpy(), _jax_fdk("algorithm1_mp")) < BAR


def test_engine_reconstruct_matches_jax_engine():
    c = _case()
    want = np.asarray(JTiled(c.g, "algorithm1_mp", tile_shape=(5, 7, 5),
                             nb=2, proj_batch=4).reconstruct(
                                 jnp.asarray(c.img)))
    got = _engine(c, "algorithm1_mp", (5, 7, 5), proj_batch=4).reconstruct(
        c.img)
    assert rel_rmse(got, want) < BAR


# ---- properties of the decomposition (test_tiled_engine/test_step_major) ---

@pytest.mark.parametrize("tile", [(1, 16, 16), (16, 1, 7), (3, 5, 11),
                                  (4, 4, 4), (16, 16, 16)])
def test_any_tile_partition_is_exact_cover(tile):
    shape = (16, 16, 16)
    count = np.zeros(shape, np.int32)
    for t in make_tiles(shape, tile):
        assert t.shape == tuple(s.stop - s.start for s in t.slices)
        count[t.slices] += 1
    assert (count == 1).all()


@pytest.mark.parametrize("variant", ["algorithm1_mp", "subline_batch_mp"])
@pytest.mark.parametrize("tile", [(5, 7, 5), (16, 16, 3), (3, 16, 7)])
def test_plan_writes_cover_the_volume_once(variant, tile):
    c = _case()
    count = np.zeros(c.g.volume_shape_xyz, np.int32)
    for s in _engine(c, variant, tile).recon_plan.steps:
        for w in s.writes:
            count[s.i0:s.i0 + s.ni, s.j0:s.j0 + s.nj,
                  w.k0:w.k0 + w.nk] += 1
    assert (count == 1).all()


def test_z_plan_covers_disjointly():
    for nz, tk in [(16, 3), (16, 16), (17, 4), (15, 15), (16, 5), (1, 8)]:
        cover = np.zeros(nz, np.int32)
        for u in plan_z_units(nz, tk):
            cover[u.k0:u.k0 + u.nk] += 1
            if u.paired:
                cover[u.mirror_k0:u.mirror_k0 + u.nk] += 1
                assert u.k0 + u.nk <= u.mirror_k0
            else:
                assert u.centered
        assert (cover == 1).all(), (nz, tk)


def test_pick_tile_shape_fits_budget():
    vol, det = (64, 64, 64), (96, 96)
    budget = 2 << 20
    tile = pick_tile_shape(vol, det, budget, nb=8)
    assert tile_working_set_bytes(tile, det, nb=8) <= budget
    assert pick_tile_shape(vol, det, 1 << 40, nb=8) == vol
    assert pick_tile_shape(vol, det, 0, nb=8) == (1, 1, 1)


def test_engine_budget_parity():
    c = _case()
    budget = 64 << 10
    eng = TiledReconstructor(c.t, "algorithm1_mp", memory_budget=budget,
                             nb=4, device="cpu")
    assert eng.working_set_bytes <= budget
    assert eng.tile_shape != c.g.volume_shape_xyz
    assert eng.recon_plan.schedule == "chunk"
    assert eng.tile_shape == JTiled(c.g, "algorithm1_mp",
                                    memory_budget=budget, nb=4).tile_shape
    assert rel_rmse(eng.backproject(c.img_t, c.mats), c.ref) < BAR


def test_explicit_tile_over_budget_raises():
    c = _case()
    with pytest.raises(ValueError, match="memory_budget"):
        TiledReconstructor(c.t, "algorithm1_mp", tile_shape=(16, 16, 16),
                           memory_budget=1024, nb=4, device="cpu")


@pytest.mark.parametrize("schedule", ["step", "chunk"])
def test_interior_tiles_build_one_program(schedule):
    c = _case()
    cache = tex.ProgramCache()
    eng = TiledReconstructor(c.t, "subline_pl", tile_shape=(8, 8, 4), nb=2,
                             proj_batch=4, schedule=schedule, cache=cache,
                             device="cpu")
    keys = eng.recon_plan.program_keys
    assert len(eng.recon_plan.steps) == 8 and len(keys) == 1
    assert eng.cache_stats()["misses"] == 0
    eng.backproject(c.img_t, c.mats)
    first = eng.cache_stats()
    assert first["misses"] == 1 and first["programs"] == 1
    eng.backproject(c.img_t, c.mats)
    assert eng.cache_stats()["misses"] == 1


def test_engine_plan_view_matches_jax():
    c = _case()
    for variant, tile in (("algorithm1_mp", (5, 7, 5)),
                          ("subline_batch_mp", (16, 16, 9))):
        t_ij, t_z = _engine(c, variant, tile).plan()
        j_ij, j_z = JTiled(c.g, variant, tile_shape=tile, nb=2).plan()
        assert t_ij == j_ij
        assert [dataclasses.astuple(u) for u in t_z] == \
            [dataclasses.astuple(u) for u in j_z]


def test_distributed_still_raises():
    """The engine's mesh composition runs (tests/test_torch_distributed.py
    holds it to the JAX scan); what still raises is a batch that does not
    divide over the mesh's "pod" axis."""
    from repro_torch.launch.mesh import make_mesh
    c = _case()
    eng = _engine(c, "algorithm1_mp", TILES[0])
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), ("cpu",) * 4)
    vol = eng.backproject_distributed(c.img_t, c.mats, mesh, nb=2)
    assert rel_rmse(vol, c.ref) < BAR
    with pytest.raises(ValueError, match="pod=2"):
        eng.backproject_distributed(c.img_t, c.mats, mesh, nb=3)
