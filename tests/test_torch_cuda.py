"""repro_torch CUDA kernels on the card (marker ``cuda``; skipped without
a GPU). Imports nothing of JAX, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version and the port's
oracle on the same inputs, at the repo's rel-RMSE bar of 1e-5.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.backproject import transpose_projections
from repro_torch.core.geometry import projection_matrices, standard_geometry
from repro_torch.kernels import backproject_subline as ks
from repro_torch.kernels import ops
from repro_torch.kernels.ref import backproject_ref

from conftest import rel_rmse

pytestmark = pytest.mark.cuda

BAR = 1e-5
SWEEP = [(16, 24, 6), (16, 16, 4), (13, 17, 5), (8, 32, 3), (20, 12, 7),
         (15, 20, 6)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ks.reset_launches()
    return torch.device("cuda")


def _case(n, det, nproj, dev, seed=0, lines=None):
    g = standard_geometry(n=n, n_det=det, n_proj=nproj)
    if lines is not None:       # a deep column of lines x lines voxel lines
        g = dataclasses.replace(g, nx=lines, ny=lines)
    img = np.random.RandomState(seed).rand(nproj, g.nh, g.nw).astype(
        np.float32)
    img_t = transpose_projections(torch.from_numpy(img).to(dev))
    return img_t, projection_matrices(g, dev), g.volume_shape_xyz


def _cpu(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("n,det,nproj", SWEEP)
@pytest.mark.parametrize("block", [(1, 8), (4, 8), (4, 16)])
def test_kernels_match_plain_and_oracle(cuda, n, det, nproj, block):
    img_t, mats, shape = _case(n, det, nproj, cuda)
    plain = _cpu(ks.backproject_subline_plain(img_t, mats, shape))
    ref = _cpu(backproject_ref(img_t, mats, shape))
    outs = {"K1": ops._run_padded(ks.backproject_subline_kernel, img_t,
                                  mats, shape, block),
            "K2": ops._run_padded(ks.backproject_subline_fused, img_t, mats,
                                  shape, block, nb=nproj)}
    for name, out in outs.items():
        out = _cpu(out)
        assert rel_rmse(out, plain) < BAR, name
        assert rel_rmse(out, ref) < BAR, name
        if n % 2:
            mid = n // 2
            assert rel_rmse(out[..., mid], ref[..., mid]) < BAR, name
    assert ks.LAUNCHES == {"backproject_subline_kernel": 1,
                           "backproject_subline_fused": 1}


@pytest.mark.parametrize("nz,det,nproj", [(70, 64, 4), (200, 128, 4),
                                          (1000, 512, 4), (1301, 1024, 8)])
def test_deep_columns_match_plain(cuda, nz, det, nproj):
    """Every k-per-lane instance of the kernel, and at nh=1024 the
    staging depth capped by shared memory."""
    img_t, mats, shape = _case(nz, det, nproj, cuda, lines=16)
    plain = _cpu(ks.backproject_subline_plain(img_t, mats, shape))
    for out in (ks.backproject_subline_kernel(img_t, mats, shape),
                ks.backproject_subline_fused(img_t, mats, shape, nb=nproj)):
        assert rel_rmse(_cpu(out), plain) < BAR


@pytest.mark.parametrize("nb", [1, 2, 3, 6])
def test_staging_depth_changes_no_bit(cuda, nb):
    img_t, mats, shape = _case(15, 20, 6, cuda, seed=4)
    k1 = ks.backproject_subline_kernel(img_t, mats, shape)
    k2 = ks.backproject_subline_fused(img_t, mats, shape, nb=nb)
    assert torch.equal(k1, k2)


def test_cuda_tensors_never_reach_the_plain_version(cuda, monkeypatch):
    img_t, mats, shape = _case(16, 24, 6, cuda)

    def refuse(*_):
        raise AssertionError("plain version called on CUDA tensors")

    monkeypatch.setattr(ks, "backproject_subline_plain", refuse)
    for nb, loop in ((1, True), (2, True), (3, False)):
        ops.backproject_subline(img_t, mats, shape, nb=nb, proj_loop=loop)
    assert ks.LAUNCHES == {"backproject_subline_kernel": 2,
                           "backproject_subline_fused": 1}


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    img_t, mats, _ = _case(8, 16, 2, cuda)
    with pytest.raises(ValueError, match="largest depth"):
        ks.backproject_subline_kernel(img_t, mats, (8, 8, 4098))
    with pytest.raises(ValueError, match="contiguous"):
        ks.backproject_subline_kernel(img_t.transpose(1, 2).contiguous()
                                      .transpose(1, 2), mats, (8, 8, 8))
    assert sum(ks.LAUNCHES.values()) == 0


def test_reconstruct_on_card_matches_plain_path(cuda):
    import repro_torch
    g = standard_geometry(n=16, n_det=24, n_proj=8)
    p = np.random.RandomState(1).rand(8, g.nh, g.nw).astype(np.float32)
    vol = repro_torch.reconstruct(p, g, variant="subline_pl")
    assert ks.LAUNCHES["backproject_subline_fused"] == 1
    plain = repro_torch.reconstruct(p, g, variant="algorithm1_mp")
    cpu = repro_torch.reconstruct(p, g, variant="subline_pl", device="cpu")
    assert vol.device.type == "cuda"
    assert rel_rmse(_cpu(vol), _cpu(plain)) < BAR
    assert rel_rmse(_cpu(vol), _cpu(cpu)) < BAR
