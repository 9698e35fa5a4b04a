"""repro_torch's ladder of plain back-projectors, the RTK baseline and the
geometry helpers vs the JAX package, on the CPU.

Each of the five variants the registry gained (``baseline``,
``transpose_mp``, ``share_mp``, ``symmetry_mp``, ``subline_mp``) takes
the same numpy inputs as its JAX twin and is held against the twin and
against the JAX oracle ``backproject_ref`` at the repo's bar, on
``tests/test_kernels.py::SWEEP`` (the odd ``(13, 17, 5)`` included).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import backproject as jbp
from repro.core import baseline as jbl
from repro.core import geometry as jgeo
from repro.core import projection_matrices as j_mats
from repro.core import standard_geometry as j_geom
from repro.core import variants as jvar
from repro.kernels import backproject_ref

from repro_torch import convert
from repro_torch.core import backproject as tbp
from repro_torch.core import baseline as tbl
from repro_torch.core import geometry as tgeo
from repro_torch.core import variants as tvar
from repro_torch.core.geometry import projection_matrices as t_mats

from conftest import rel_rmse

BAR = 1e-5
j_ref = jax.jit(backproject_ref, static_argnums=2)
# tests/test_kernels.py::SWEEP, its slow cases included
SWEEP = [(16, 24, 6), (16, 16, 4), (13, 17, 5), (8, 32, 3), (20, 12, 7)]
NEW_VARIANTS = ["baseline", "transpose_mp", "share_mp", "symmetry_mp",
                "subline_mp"]
_CASES = {}


def _case(n, det, nproj, seed=0):
    """(JAX geometry, port geometry, transposed projections for both,
    matrices for both, JAX oracle volume), computed once."""
    key = (n, det, nproj, seed)
    if key not in _CASES:
        g = j_geom(n=n, n_det=det, n_proj=nproj)
        t = convert.geometry_from_reference(dataclasses.asdict(g))
        img = np.random.RandomState(seed).rand(
            nproj, g.nh, g.nw).astype(np.float32)
        ji = jbp.transpose_projections(jnp.asarray(img))
        jm = j_mats(g)
        _CASES[key] = (g, t, ji, jm,
                       tbp.transpose_projections(torch.from_numpy(img)),
                       t_mats(t, device="cpu"),
                       np.asarray(j_ref(ji, jm, g.volume_shape_xyz)))
    return _CASES[key]


@pytest.mark.parametrize("n,det,nproj", SWEEP)
@pytest.mark.parametrize("variant", NEW_VARIANTS)
def test_new_variants_match_jax_and_oracle(n, det, nproj, variant):
    g, _, ji, jm, ti, tm, ref = _case(n, det, nproj)
    shape = g.volume_shape_xyz
    got = tvar.get_spec(variant).fn(ti, tm, shape).numpy()
    want = np.asarray(jvar.get_spec(variant).fn(ji, jm, shape))
    assert got.shape == shape
    assert rel_rmse(got, want) < BAR
    assert rel_rmse(got, ref) < BAR
    if shape[2] % 2:        # the odd middle plane on its own
        mid = shape[2] // 2
        assert rel_rmse(got[..., mid], ref[..., mid]) < BAR


@pytest.mark.parametrize("n,det,nproj", SWEEP)
def test_subline_symmetry_scan_matches_batch(n, det, nproj):
    g, _, ji, jm, ti, tm, ref = _case(n, det, nproj)
    shape = g.volume_shape_xyz
    scan = tbp.bp_subline_symmetry_scan(ti, tm, shape).numpy()
    nb = 1 if nproj % 2 else 2
    batch = tbp.bp_subline_symmetry_batch(ti, tm, shape, nb=nb).numpy()
    assert rel_rmse(scan, batch) < BAR
    assert rel_rmse(scan, np.asarray(
        jbp.bp_subline_symmetry_scan(ji, jm, shape))) < BAR
    assert rel_rmse(scan, ref) < BAR


def test_symmetry_single_both_forms_match_jax():
    """_bp_symmetry_single with and without the sub-line buffer on one
    projection of the odd case, against the JAX function."""
    g, _, ji, jm, ti, tm, _ = _case(13, 17, 5)
    shape = g.volume_shape_xyz
    for use_subline in (True, False):
        got = tbp._bp_symmetry_single(ti[2], tm[2], shape,
                                      use_subline=use_subline).numpy()
        want = np.asarray(jbp._bp_symmetry_single(
            ji[2], jm[2], shape, use_subline=use_subline))
        assert rel_rmse(got, want) < BAR


def test_baseline_functions_match_jax():
    g, _, _, jm, ti, tm, _ = _case(13, 17, 5)
    img = tbp.transpose_projections(ti)
    jimg = jnp.asarray(img.numpy())
    zyx = g.volume_shape_zyx
    single = tbl.backproject_single(img[1], tm[1], zyx).numpy()
    assert rel_rmse(single, np.asarray(
        jbl.backproject_single(jimg[1], jm[1], zyx))) < BAR
    full = tbl.backproject_rtk(img, tm, zyx).numpy()
    assert rel_rmse(full, np.asarray(jbl.backproject_rtk(jimg, jm, zyx))) \
        < BAR
    rng = np.random.RandomState(3)
    x = (rng.rand(40) * 24 - 3).astype(np.float32)
    y = (rng.rand(40) * 20 - 3).astype(np.float32)
    val, valid = tbl.bilinear_gather(img[0], torch.from_numpy(x),
                                     torch.from_numpy(y))
    jval, jvalid = jbl.bilinear_gather(jimg[0], jnp.asarray(x),
                                       jnp.asarray(y))
    assert np.array_equal(valid.numpy(), np.asarray(jvalid))
    v = valid.numpy()
    assert np.allclose(val.numpy()[v], np.asarray(jval)[v], rtol=1e-6,
                       atol=1e-7)
    grid = [a.numpy() for a in tbl._voxel_index_grid(3, 4, 5)]
    jgrid = [np.asarray(a) for a in jbl._voxel_index_grid(3, 4, 5)]
    for a, b in zip(grid, jgrid):
        assert np.array_equal(a, b)


def test_volume_layout_round_trip():
    vol = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    vt = tbp.volume_to_transposed(vol)
    assert tuple(vt.shape) == (4, 3, 2)
    assert np.array_equal(vt.numpy(), np.asarray(
        jbp.volume_to_transposed(jnp.asarray(vol.numpy()))))
    assert torch.equal(tbp.volume_to_native(vt), vol)


@pytest.mark.parametrize("kw", [dict(n=16, n_det=24, n_proj=8),
                                dict(n=13, n_det=17, n_proj=5),
                                dict(n=20, n_det=12, n_proj=7, sad=700.0)])
def test_geometry_helpers_equal_jax(kw):
    g = j_geom(**kw)
    t = convert.geometry_from_reference(dataclasses.asdict(g))
    assert np.array_equal(tgeo.source_positions(t), jgeo.source_positions(g))
    for theta in list(g.angles[:3]) + [0.3]:
        for a, b in zip(tgeo.detector_frame(t, float(theta)),
                        jgeo.detector_frame(g, float(theta))):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(tgeo.voxel_world_coords(t), jgeo.voxel_world_coords(g)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_registry_equals_jax_registry():
    assert tvar.UNPORTED == ()
    assert sorted(tvar.REGISTRY) == sorted(jvar.REGISTRY)
    assert tvar.get_spec("symmetry_mp").slab_safe_fallback == "share_mp"
    assert tvar.get_spec("baseline").backend == "reference"
    for name in NEW_VARIANTS:
        t, j = tvar.REGISTRY[name], jvar.REGISTRY[name]
        assert (t.optimizations, t.options, t.slab_safe_fallback,
                t.proj_loop) == (j.optimizations, j.options,
                                 j.slab_safe_fallback, j.proj_loop)
    tvar._validate_registry()
