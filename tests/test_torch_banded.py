"""repro_torch banded back-projector (K5/K6) vs the JAX package on the CPU.

The band schedule is the reference's function run where the data lies:
``band_layout`` equals the JAX one, and ``tile_bands`` gives the same
int32 band array and span, for group 1 and nb and at the band width the
doubling loop settles on. On CPU tensors the kernel wrappers run the
plain PyTorch version; the port is held against the JAX oracle
``backproject_ref`` at the sweep shapes, odd nz included (where the JAX
package's own banded kernel is off in the middle plane), and at one even
case against that Pallas kernel in interpret mode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as j_ops
from repro.kernels.backproject_banded import band_layout as j_band_layout
from repro.kernels.backproject_banded import tile_bands as j_tile_bands

from repro_torch.kernels import backproject_banded as kb
from repro_torch.kernels import backproject_onehot as ko
from repro_torch.kernels import backproject_subline as ks
from repro_torch.kernels import ops

from conftest import rel_rmse
from test_torch_backproject import SWEEP, _case

BAR = 1e-5


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors only: no kernel is ever launched."""
    for mod in (ks, ko, kb):
        mod.reset_launches()
    yield
    for mod in (ks, ko, kb):
        assert sum(mod.LAUNCHES.values()) == 0, mod.LAUNCHES


def _pad(n, b):
    return -(-n // b) * b


def _jax_bw(mats, ni, nj, block, bw, nw, group):
    """The JAX driver's doubling loop (backproject_banded.py l.236-242)."""
    while True:
        n_bands = max(1, -(-nw // bw))
        band, span = j_tile_bands(mats, ni, nj, *block, bw, n_bands, nw,
                                  group=group)
        if span <= bw or bw >= nw:
            return band, span, bw
        bw *= 2


@pytest.mark.parametrize("n,det,nproj", SWEEP + [(16, 48, 4)])
@pytest.mark.parametrize("bw", [8, 16, 32])
def test_band_layout_matches_jax(n, det, nproj, bw):
    c = _case(n, det, nproj)
    jb, jn = j_band_layout(c.j_img_t, bw)
    tb, tn = kb.band_layout(c.img_t, bw)
    assert tn == jn
    assert tb.is_contiguous()
    assert np.array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("n,det,nproj", SWEEP + [(16, 48, 4)])
@pytest.mark.parametrize("block", [(1, 8), (4, 8), (4, 16)])
def test_tile_bands_match_jax(n, det, nproj, block):
    c = _case(n, det, nproj)
    ni, nj = _pad(n, block[0]), _pad(n, block[1])
    nw = c.img_t.shape[1]
    j_mats = np.asarray(c.j_mats)
    for group in (1, nproj):
        for bw0 in (8, 16, 32):
            for bw in (bw0, _jax_bw(j_mats, ni, nj, block, bw0, nw,
                                    group)[2]):
                n_bands = max(1, -(-nw // bw))
                jband, jspan = j_tile_bands(j_mats, ni, nj, *block, bw,
                                            n_bands, nw, group=group)
                tband, tspan = kb.tile_bands(c.mats, ni, nj, *block, bw,
                                             n_bands, nw, group=group)
                assert tband.dtype == torch.int32
                assert np.array_equal(tband.numpy(), jband), (group, bw)
                assert tspan == jspan


@pytest.mark.parametrize("n,det,nproj", SWEEP + [(16, 48, 4)])
def test_band_search_settles_where_jax_does(n, det, nproj):
    c = _case(n, det, nproj)
    j_mats = np.asarray(c.j_mats)
    nw = c.img_t.shape[1]
    widened = 0
    for block in ((1, 8), (4, 8)):
        shape = (_pad(n, block[0]), _pad(n, block[1]), n)
        for group in (1, nproj):
            for bw0 in (8, 16):
                jband, _, jbw = _jax_bw(j_mats, *shape[:2], block, bw0, nw,
                                        group)
                img_b, band, bw = kb.band_schedule(
                    c.img_t, c.mats, shape, block=block, bw=bw0, group=group)
                assert bw == jbw
                assert np.array_equal(band.numpy(), jband)
                assert tuple(img_b.shape[2:]) == (2 * bw, c.img_t.shape[2])
                widened += bw != bw0
    if (n, det) == (16, 48):
        assert widened       # a wide detector forces the doubling loop


@pytest.mark.parametrize("n,det,nproj", SWEEP + [(16, 48, 4)])
@pytest.mark.parametrize("bw", [8, 16])
def test_ops_sweep_matches_oracle(n, det, nproj, bw):
    c = _case(n, det, nproj)
    for block in ((1, 8), (4, 8), (4, 16)):
        for nb in (1, nproj):
            out = ops.backproject_banded(c.img_t, c.mats, c.shape, nb=nb,
                                         block=block, bw=bw, proj_loop=True,
                                         device="cpu")
            assert tuple(out.shape) == c.shape
            assert rel_rmse(out.numpy(), c.ref) < BAR, (block, nb)


@pytest.mark.parametrize("nb,proj_loop", [(1, True), (2, True), (3, True),
                                          (4, True), (2, False)])
def test_ops_routes_match_oracle(nb, proj_loop):
    # 6 views: nb 2 and 3 take the fused (K6) route, one band per group;
    # nb 4 does not divide the count and nb 1 never fuses (K5)
    c = _case(16, 24, 6)
    out = ops.backproject_banded(c.img_t, c.mats, c.shape, nb=nb,
                                 block=(2, 8), bw=8, proj_loop=proj_loop,
                                 device="cpu")
    assert rel_rmse(out.numpy(), c.ref) < BAR


@pytest.mark.parametrize("n,det,nproj", [(13, 17, 5), (15, 20, 6),
                                         (9, 12, 3)])
def test_odd_nz_middle_plane(n, det, nproj):
    """The plane k = nz//2, where the reference's Pallas kernel is off."""
    c = _case(n, det, nproj)
    mid = n // 2
    for nb in (1, nproj):
        out = ops.backproject_banded(c.img_t, c.mats, c.shape, nb=nb,
                                     block=(4, 8), bw=8, proj_loop=True,
                                     device="cpu")
        plane = out.numpy()[..., mid]
        assert np.abs(plane).max() > 0
        assert rel_rmse(plane, c.ref[..., mid]) < BAR


def test_plain_drops_lines_the_band_misses():
    """A band one window too far right drops every line that reads a
    column left of it; the rest is the sub-line result."""
    c = _case(16, 24, 6)
    img_b, band, bw = kb.band_schedule(c.img_t, c.mats, c.shape,
                                       block=(4, 8), bw=8, group=1)
    full = kb.backproject_banded_kernel(img_b, c.mats, band, c.shape,
                                        block=(4, 8), bw=bw, nw=24)
    assert rel_rmse(full.numpy(), c.ref) < BAR
    n_bands = img_b.shape[1]
    shifted = torch.clamp(band + 1, max=n_bands - 1)
    part = kb.backproject_banded_kernel(img_b, c.mats, shifted, c.shape,
                                        block=(4, 8), bw=bw, nw=24)
    assert np.abs(part.numpy()).sum() < np.abs(full.numpy()).sum()


def test_matches_jax_pallas_kernel_even_case():
    """The JAX package's own banded kernel, in interpret mode, at an even
    nz where it is right."""
    c = _case(16, 24, 6)
    jout = np.asarray(j_ops.backproject_banded(
        c.j_img_t, c.j_mats, c.shape, nb=3, block=(4, 8), bw=8,
        proj_loop=True, interpret=True))
    out = ops.backproject_banded(c.img_t, c.mats, c.shape, nb=3,
                                 block=(4, 8), bw=8, proj_loop=True,
                                 device="cpu")
    assert rel_rmse(out.numpy(), jout) < BAR
    assert rel_rmse(jout, c.ref) < BAR


def test_wrappers_reject_what_they_do_not_take():
    c = _case(16, 24, 6)
    img_b, band, bw = kb.band_schedule(c.img_t, c.mats, c.shape,
                                       block=(4, 8), bw=8, group=1)
    kw = dict(block=(4, 8), bw=bw, nw=24)
    with pytest.raises(ValueError, match="dividing"):
        kb.backproject_banded_fused(img_b, c.mats, band, c.shape, nb=4, **kw)
    with pytest.raises(ValueError, match="band must be"):
        kb.backproject_banded_fused(img_b, c.mats, band, c.shape, nb=2, **kw)
    with pytest.raises(TypeError, match="int32"):
        kb.backproject_banded_kernel(img_b, c.mats, band.long(), c.shape,
                                     **kw)
    with pytest.raises(ValueError, match="band layout"):
        kb.backproject_banded_kernel(img_b, c.mats, band, c.shape,
                                     block=(4, 8), bw=bw * 2, nw=24)
    with pytest.raises(ValueError, match="tiles"):
        kb.backproject_banded_kernel(img_b, c.mats, band, (16, 12, 16), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        kb.backproject_banded_kernel(img_b.transpose(2, 3), c.mats, band,
                                     c.shape, **kw)


def test_ops_default_device_is_the_card():
    c = _case(16, 24, 6)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="lies on cpu"):
            ops.backproject_banded(c.img_t, c.mats, c.shape)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ops.backproject_banded(c.img_t, c.mats, c.shape)
