"""repro_torch geometry, phantom, configs and state conversion vs the JAX
package: the matrices every later parity test depends on are bitwise
equal."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ct_paper as j_ct
from repro.core import geometry as jg
from repro.core.phantom import shepp_logan_3d as j_shepp

from repro_torch import convert
from repro_torch.configs import ct_paper as t_ct
from repro_torch.core import geometry as tg
from repro_torch.core.phantom import shepp_logan_3d as t_shepp

GEOMS = [(16, 24, 6), (16, 16, 4), (13, 17, 5), (8, 32, 3), (20, 12, 7)]


def _pair(**kw):
    g = jg.CTGeometry(**kw)
    return g, convert.geometry_from_reference(dataclasses.asdict(g))


@pytest.mark.parametrize("n,det,nproj", GEOMS)
def test_projection_matrices_bitwise(n, det, nproj):
    g = jg.standard_geometry(n=n, n_det=det, n_proj=nproj)
    t = tg.standard_geometry(n=n, n_det=det, n_proj=nproj)
    assert dataclasses.asdict(t) == dataclasses.asdict(g)
    out = tg.projection_matrices(t, device="cpu")
    assert out.dtype == torch.float32 and out.device.type == "cpu"
    assert tuple(out.shape) == (nproj, 3, 4)
    assert np.array_equal(out.numpy(), np.asarray(jg.projection_matrices(g)))


@pytest.mark.parametrize("kw", [
    dict(nx=12, ny=9, nz=7, nw=20, nh=11, n_proj=5, sad=800.0, sdd=1200.0,
         voxel_size=(1.5, 2.0, 0.75), det_spacing=(1.1, 0.9)),
    dict(nx=8, ny=8, nz=10, nw=16, nh=16, n_proj=3, sad=500.0, sdd=900.0,
         voxel_size=(2.0, 2.0, 2.0), det_spacing=(1.5, 1.5)),
])
def test_projection_matrices_bitwise_anisotropic(kw):
    g, t = _pair(**kw)
    for theta in (0.0, 0.3, 2.0, 5.5):
        assert np.array_equal(tg.projection_matrix(t, theta),
                              jg.projection_matrix(g, theta))
    assert np.array_equal(tg.projection_matrices(t, "cpu").numpy(),
                          np.asarray(jg.projection_matrices(g)))


def test_geometry_round_trip_and_hashable():
    g = jg.standard_geometry(n=13, n_det=17, n_proj=5)
    t = convert.geometry_from_reference(dataclasses.asdict(g))
    assert dataclasses.asdict(t) == dataclasses.asdict(g)
    assert t == tg.standard_geometry(n=13, n_det=17, n_proj=5)
    assert hash(t) == hash(tg.standard_geometry(n=13, n_det=17, n_proj=5))
    with pytest.raises(dataclasses.FrozenInstanceError):
        t.nx = 3
    assert t.volume_shape_xyz == g.volume_shape_xyz
    assert t.proj_shape_wh == g.proj_shape_wh
    assert t.voxel_updates() == g.voxel_updates()
    assert np.array_equal(t.angles, g.angles)


def test_geometry_from_reference_rejects_bad_fields():
    fields = dataclasses.asdict(jg.standard_geometry(n=8))
    with pytest.raises(ValueError, match="missing"):
        convert.geometry_from_reference(
            {k: v for k, v in fields.items() if k != "sad"})
    with pytest.raises(ValueError, match="unknown"):
        convert.geometry_from_reference({**fields, "bogus": 1})


def test_tensor_from_numpy():
    a = np.random.RandomState(0).rand(3, 4, 5)
    t = convert.tensor_from_numpy(a, device="cpu")
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    assert np.array_equal(t.numpy(), a.astype(np.float32))


@pytest.mark.parametrize("shape", [(16,), (13, 17, 5), (8, 6, 10)])
def test_phantom_equal(shape):
    assert np.array_equal(t_shepp(*shape), j_shepp(*shape))


def test_problem_table_matches_reference():
    assert [dataclasses.astuple(p) for p in t_ct.PROBLEMS] == \
        [dataclasses.astuple(p) for p in j_ct.PROBLEMS]
    p5 = t_ct.get_problem("P5")
    assert p5.updates == j_ct.get_problem("P5").updates
    assert dataclasses.asdict(p5.geometry()) == \
        dataclasses.asdict(j_ct.get_problem("P5").geometry())
    assert dataclasses.astuple(t_ct.smoke_problem()) == \
        dataclasses.astuple(j_ct.smoke_problem())


def test_default_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.projection_matrices(tg.standard_geometry(n=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.tensor_from_numpy(np.zeros(3))
