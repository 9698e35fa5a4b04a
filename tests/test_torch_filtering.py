"""repro_torch FDK filtering vs the JAX package (pocketfft in torch and
XLA's FFT differ near 1e-7, so the bar is the repo's rel-RMSE 1e-5)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import standard_geometry as j_geom
from repro.core.filtering import fdk_filter_chunk as j_filter
from repro.core.filtering import ramlak_kernel_spatial as j_ramlak

from repro_torch.core.filtering import fdk_filter_chunk, ramlak_kernel_spatial
from repro_torch.core.geometry import standard_geometry

from conftest import rel_rmse

BAR = 1e-5


@pytest.mark.parametrize("n,det,nproj", [(16, 24, 8), (13, 17, 5),
                                         (16, 64, 4)])
def test_filter_matches_jax(n, det, nproj):
    g = j_geom(n=n, n_det=det, n_proj=nproj)
    p = np.random.RandomState(n).rand(nproj, g.nh, g.nw).astype(np.float32)
    ref = np.asarray(j_filter(jnp.asarray(p), g, nproj))
    out = fdk_filter_chunk(torch.from_numpy(p),
                           standard_geometry(n=n, n_det=det, n_proj=nproj),
                           nproj)
    assert out.dtype == torch.float32 and tuple(out.shape) == p.shape
    assert rel_rmse(out.numpy(), ref) < BAR


@pytest.mark.parametrize("bounds", [[(0, 3), (3, 6), (6, 8)],
                                    [(0, 1), (1, 8)]])
def test_chunked_equals_whole(bounds):
    """Row-wise and per-projection: any chunking equals the whole set,
    given the explicit n_proj_total angular step."""
    g = standard_geometry(n=16, n_det=24, n_proj=8)
    p = torch.from_numpy(
        np.random.RandomState(0).rand(8, g.nh, g.nw).astype(np.float32))
    whole = fdk_filter_chunk(p, g, 8)
    chunks = torch.cat([fdk_filter_chunk(p[a:b], g, 8) for a, b in bounds])
    assert torch.equal(chunks, whole)
    # the chunk's own length would mis-scale it
    a, b = bounds[0]
    assert not torch.allclose(fdk_filter_chunk(p[a:b], g, b - a), whole[a:b])


def test_ramlak_kernel_matches_jax():
    assert np.array_equal(ramlak_kernel_spatial(8, 2.0), j_ramlak(8, 2.0))
    assert np.array_equal(ramlak_kernel_spatial(31, 0.37),
                          j_ramlak(31, 0.37))


def test_filter_kills_dc():
    g = standard_geometry(n=16, n_det=64, n_proj=4)
    filt = fdk_filter_chunk(torch.ones(4, g.nh, g.nw), g, 4).numpy()
    interior = filt[:, :, 16:-16]
    assert np.abs(interior).max() < 0.15 * np.abs(filt).max() + 1e-3


@pytest.mark.parametrize("n,det,nproj", [(16, 24, 8), (13, 17, 5)])
def test_whole_set_filter_matches_jax(n, det, nproj):
    """``fdk_preweight_and_filter``, the whole-set form: the reference's
    on the same projections, and the chunk form with every view."""
    from repro.core.filtering import fdk_preweight_and_filter as j_whole
    from repro_torch.core.filtering import fdk_preweight_and_filter
    g = j_geom(n=n, n_det=det, n_proj=nproj)
    p = np.random.RandomState(n + 1).rand(nproj, g.nh, g.nw).astype(
        np.float32)
    geom = standard_geometry(n=n, n_det=det, n_proj=nproj)
    out = fdk_preweight_and_filter(torch.from_numpy(p), geom)
    assert rel_rmse(out.numpy(), np.asarray(j_whole(jnp.asarray(p), g))) \
        < BAR
    assert torch.equal(out, fdk_filter_chunk(torch.from_numpy(p), geom,
                                             nproj))
