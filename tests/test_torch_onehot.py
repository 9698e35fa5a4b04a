"""repro_torch one-hot back-projector (K3/K4) vs the JAX package on the CPU.

On CPU tensors the kernel wrappers run the plain PyTorch version, the
two-hot contraction, so these tests cover its arithmetic, the K3/K4
routing, the k_chunk tiling and the padding. The port is held against
the JAX oracle ``backproject_ref`` at the sweep shapes, odd nz included;
one even case is also held against the JAX package's own Pallas kernel,
run in interpret mode as its tests run it. The CUDA kernel is held
against the same plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as j_ops

from repro_torch.kernels import backproject_banded as kb
from repro_torch.kernels import backproject_onehot as ko
from repro_torch.kernels import backproject_subline as ks
from repro_torch.kernels import ops

from conftest import rel_rmse
from test_torch_backproject import SWEEP, _case

BAR = 1e-5
K1_BAR = 1e-6        # tests/test_kernels.py::test_kernels_agree_with_each_other


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors only: no kernel is ever launched."""
    for mod in (ks, ko, kb):
        mod.reset_launches()
    yield
    for mod in (ks, ko, kb):
        assert sum(mod.LAUNCHES.values()) == 0, mod.LAUNCHES


@pytest.mark.parametrize("n,det,nproj", SWEEP)
@pytest.mark.parametrize("k_chunk", [4, 8, 128])
def test_ops_sweep_matches_oracle(n, det, nproj, k_chunk):
    c = _case(n, det, nproj)
    for block in ((1, 8), (4, 8), (4, 16)):
        out = ops.backproject_onehot(c.img_t, c.mats, c.shape, nb=nproj,
                                     block=block, k_chunk=k_chunk,
                                     proj_loop=True, device="cpu")
        assert tuple(out.shape) == c.shape
        assert rel_rmse(out.numpy(), c.ref) < BAR, block


@pytest.mark.parametrize("nb,proj_loop", [(1, True), (2, True), (3, True),
                                          (4, True), (2, False)])
def test_ops_routes_match_oracle(nb, proj_loop):
    # 6 views: nb 2 and 3 take the fused (K4) route; nb 4 does not divide
    # the count and nb 1 never fuses, so both take the K3 route
    c = _case(16, 24, 6)
    out = ops.backproject_onehot(c.img_t, c.mats, c.shape, nb=nb,
                                 block=(2, 8), k_chunk=3,
                                 proj_loop=proj_loop, device="cpu")
    assert rel_rmse(out.numpy(), c.ref) < BAR


@pytest.mark.parametrize("n,det,nproj", [(13, 17, 5), (15, 20, 6),
                                         (9, 12, 3)])
def test_odd_nz_middle_plane(n, det, nproj):
    """The self-mirrored plane k = nz//2 comes from the direct half."""
    c = _case(n, det, nproj)
    mid = n // 2
    for out in (ko.backproject_onehot_kernel(c.img_t, c.mats, c.shape,
                                             k_chunk=4),
                ko.backproject_onehot_fused(c.img_t, c.mats, c.shape,
                                            k_chunk=2, nb=nproj)):
        plane = out.numpy()[..., mid]
        assert np.abs(plane).max() > 0
        assert rel_rmse(plane, c.ref[..., mid]) < BAR


@pytest.mark.parametrize("n,det,nproj", SWEEP)
def test_k3_matches_subline(n, det, nproj):
    c = _case(n, det, nproj)
    k1 = ops.backproject_subline(c.img_t, c.mats, c.shape, device="cpu")
    k3 = ops.backproject_onehot(c.img_t, c.mats, c.shape, k_chunk=4,
                                device="cpu")
    assert rel_rmse(k3.numpy(), k1.numpy()) < K1_BAR


def test_k_chunk_changes_no_result():
    c = _case(20, 12, 7)
    base = ko.backproject_onehot_kernel(c.img_t, c.mats, c.shape,
                                        k_chunk=128).numpy()
    for kc in (1, 3, 4, 7):       # 3 and 4 do not divide khp = 10
        out = ko.backproject_onehot_kernel(c.img_t, c.mats, c.shape,
                                           k_chunk=kc).numpy()
        np.testing.assert_allclose(out, base, rtol=1e-6,
                                   atol=1e-7 * np.abs(base).max())


@pytest.mark.parametrize("k_chunk,nz,want", [(128, 16, 8), (4, 16, 4),
                                             (128, 13, 7), (7, 13, 7),
                                             (8, 1, 1)])
def test_k_chunk_clip_matches_reference(k_chunk, nz, want):
    assert ko.clip_k_chunk(k_chunk, nz) == want == min(k_chunk,
                                                       nz - nz // 2)


def test_plain_contraction_chunks_lines(monkeypatch):
    """A tiny block cap forces the plain version to chunk its lines."""
    c = _case(16, 24, 6)
    base = ko.backproject_onehot_plain(c.img_t, c.mats, c.shape, k_chunk=4)
    monkeypatch.setattr(ko, "PLAIN_BLOCK_BYTES", 4 * 4 * 24 * 5)  # 5 lines
    out = ko.backproject_onehot_plain(c.img_t, c.mats, c.shape, k_chunk=4)
    assert torch.equal(out, base)


def test_plain_box_is_the_volume_at_its_origin():
    """``origin`` computes a box of lines of the same volume, with the same
    arithmetic per line (the P5 check on the card relies on it)."""
    c = _case(13, 17, 5)
    whole = ko.backproject_onehot_plain(c.img_t, c.mats, c.shape).numpy()
    box = ko.backproject_onehot_plain(c.img_t, c.mats, (4, 8, 13),
                                      origin=(5, 3)).numpy()
    np.testing.assert_allclose(box, whole[5:9, 3:11], rtol=1e-6,
                               atol=1e-7 * np.abs(whole).max())


def test_matches_jax_pallas_kernel_even_case():
    """The JAX package's own one-hot kernel, in interpret mode, at an
    even nz where it is right."""
    c = _case(16, 24, 6)
    jout = np.asarray(j_ops.backproject_onehot(
        c.j_img_t, c.j_mats, c.shape, nb=3, block=(4, 8), k_chunk=8,
        proj_loop=True, interpret=True))
    out = ops.backproject_onehot(c.img_t, c.mats, c.shape, nb=3,
                                 block=(4, 8), k_chunk=8, proj_loop=True,
                                 device="cpu")
    assert rel_rmse(out.numpy(), jout) < BAR
    assert rel_rmse(jout, c.ref) < BAR


def test_wrappers_reject_what_they_do_not_take():
    c = _case(16, 24, 6)
    with pytest.raises(ValueError, match="dividing"):
        ko.backproject_onehot_fused(c.img_t, c.mats, c.shape, nb=4)
    with pytest.raises(ValueError, match="k_chunk"):
        ko.backproject_onehot_kernel(c.img_t, c.mats, c.shape, k_chunk=0)
    with pytest.raises(TypeError):
        ko.backproject_onehot_kernel(c.img_t.double(), c.mats, c.shape)
    with pytest.raises(ValueError, match="block"):
        ko.backproject_onehot_kernel(c.img_t, c.mats, c.shape, block=(4, 12))


def test_ops_default_device_is_the_card():
    c = _case(16, 24, 6)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="lies on cpu"):
            ops.backproject_onehot(c.img_t, c.mats, c.shape)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ops.backproject_onehot(c.img_t, c.mats, c.shape)
