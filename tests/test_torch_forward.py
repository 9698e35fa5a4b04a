"""repro_torch's ray-driven forward projector vs the JAX package, on the
CPU: the same numpy volume through both ``forward_project`` functions,
whole scans, view chunks (``proj_batch=``) and view subsets (``views=``),
held at the repo's bar; plus the ball line-integral check of
``tests/test_fdk.py``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import forward as jfw
from repro.core import standard_geometry as j_geom
from repro.core.phantom import ball_phantom as j_ball

import repro_torch
from repro_torch import convert
from repro_torch.core import forward as tfw
from repro_torch.core.phantom import ball_phantom, shepp_logan_3d

from conftest import rel_rmse

BAR = 1e-5


def _geoms(n, det, nproj):
    g = j_geom(n=n, n_det=det, n_proj=nproj)
    return g, convert.geometry_from_reference(dataclasses.asdict(g))


@pytest.mark.parametrize("n,det,nproj,oversample", [(12, 16, 5, 1.0),
                                                    (13, 17, 4, 2.0)])
@pytest.mark.parametrize("proj_batch,views", [
    (None, None), (2, None), (3, slice(1, None, 2)), (None, [4, 0, 2]),
])
def test_forward_project_matches_jax(n, det, nproj, oversample, proj_batch,
                                     views):
    g, t = _geoms(n, det, nproj)
    vol = shepp_logan_3d(n) + np.random.RandomState(n).rand(
        n, n, n).astype(np.float32) * 0.1
    views = [v for v in views if v < nproj] if isinstance(views, list) \
        else views
    want = np.asarray(jfw.forward_project(jnp.asarray(vol), g, oversample,
                                          proj_batch=proj_batch, views=views))
    got = tfw.forward_project(torch.from_numpy(vol), t, oversample,
                              proj_batch=proj_batch, views=views)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape
    assert rel_rmse(got.numpy(), want) < BAR


def test_forward_project_ball_line_integral():
    """Central ray through a ball of radius r has line integral ~ 2r."""
    n = 24
    _, t = _geoms(n, 32, 2)
    assert np.array_equal(ball_phantom(n, radius=0.5), j_ball(n, radius=0.5))
    projs = repro_torch.forward_project(
        torch.from_numpy(ball_phantom(n, radius=0.5)), t, oversample=4.0)
    world_diameter = 0.5 * 256.0
    center = float(projs[0, t.nh // 2, t.nw // 2])
    assert center == pytest.approx(world_diameter, rel=0.1)


def test_march_constants_and_frames_match_jax():
    g, t = _geoms(13, 17, 5)
    j_org, j_inv, j_len, j_near, j_n = jfw.march_params(g, 2.0)
    t_org, t_inv, t_len, t_near, t_n = tfw.march_params(t, 2.0, "cpu")
    assert np.array_equal(t_org.numpy(), np.asarray(j_org))
    assert np.array_equal(t_inv.numpy(), np.asarray(j_inv))
    assert (t_len, t_near, t_n) == (j_len, j_near, j_n)
    for a, b in zip(tfw.view_frames(t), jfw.view_frames(g)):
        assert np.array_equal(a, b)


def test_project_view_single_and_batched_agree():
    """One view's frame (3,) and the same view inside a (k, 3) chunk give
    the same image, and the JAX per-view program agrees."""
    g, t = _geoms(12, 16, 4)
    vol = shepp_logan_3d(12)
    org, inv, step, near, n_steps = tfw.march_params(t, 1.0, "cpu")
    frames = [torch.from_numpy(f) for f in tfw.view_frames(t)]
    tv = torch.from_numpy(vol)
    one = tfw._project_view_impl(tv, *(f[1] for f in frames), org, inv,
                                 n_steps, t.nh, t.nw, step, near)
    many = tfw._project_view_impl(tv, *frames, org, inv, n_steps, t.nh,
                                  t.nw, step, near)
    assert torch.equal(one, many[1])
    j_org, j_inv, *_ = jfw.march_params(g, 1.0)
    jf = jfw.view_frames(g)
    want = jfw._project_view(jnp.asarray(vol), *(jnp.asarray(f[1])
                                                 for f in jf),
                             j_org, j_inv, n_steps, g.nh, g.nw,
                             jnp.float32(step), jnp.float32(near))
    assert rel_rmse(one.numpy(), np.asarray(want)) < BAR


def test_trilinear_sample_matches_jax():
    vol = np.random.RandomState(1).rand(5, 6, 7).astype(np.float32)
    rng = np.random.RandomState(2)
    pts = [(rng.rand(50) * 9 - 1).astype(np.float32) for _ in range(3)]
    origin = np.zeros(3, np.float32)
    inv = np.ones(3, np.float32)
    got = tfw.trilinear_sample(torch.from_numpy(vol),
                               *(torch.from_numpy(p) for p in pts),
                               torch.from_numpy(origin),
                               torch.from_numpy(inv))
    want = jfw.trilinear_sample(jnp.asarray(vol), *(jnp.asarray(p)
                                                    for p in pts),
                                jnp.asarray(origin), jnp.asarray(inv))
    assert np.allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_forward_project_numpy_input_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, t = _geoms(8, 12, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfw.forward_project(shepp_logan_3d(8), t)
    out = tfw.forward_project(shepp_logan_3d(8), t, device="cpu")
    assert tuple(out.shape) == (2, 12, 12)
