"""repro_torch CUDA kernels on the card (marker ``cuda``; skipped without
a GPU). Imports nothing of JAX, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel (K1-K6) is held against its plain PyTorch version and the
port's oracle on the same inputs, at the repo's rel-RMSE bar of 1e-5; the
forward projector F1 against its plain version, and the iterative solvers
on the card against the same solves on the CPU.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.backproject import transpose_projections
from repro_torch.core.geometry import projection_matrices, standard_geometry
from repro_torch.kernels import backproject_banded as kb
from repro_torch.kernels import backproject_onehot as ko
from repro_torch.kernels import backproject_subline as ks
from repro_torch.kernels import forward_project as kf
from repro_torch.kernels import ops
from repro_torch.kernels.ref import backproject_ref

from conftest import rel_rmse

pytestmark = pytest.mark.cuda

BAR = 1e-5
SWEEP = [(16, 24, 6), (16, 16, 4), (13, 17, 5), (8, 32, 3), (20, 12, 7),
         (15, 20, 6)]
ONEHOT_PLAIN_BAR = 4e-8     # K3/K4 against their plain version
ONEHOT_K1_BAR = 1e-6        # tests/test_kernels.py, K3 against K1
# (nz, detector, views, lines) where the tiled kernel's two-hot form runs
# each path of its stage 2 (tests/test_torch_onehot_tiles.py checks it on
# the CPU): a deep column (full k chunks, every sample on the detector:
# no checks), a magnified one (nh = 2 nz, as P4: shorter k chunks, the
# columns from global memory) and a 900-row detector on 100 planes
# (windows taller than their slot: line by line at full height)
TWO_HOT_PATHS = [(1000, 512, 4, 16), (128, 256, 4, 16), (100, 900, 4, 16)]
# the tiled kernel's instances: (form, banded)
INSTANCES = [(ks.LINEAR, 0), (ks.TWO_HOT, 0), (ks.LINEAR, 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for mod in (ks, ko, kb, kf):
        mod.reset_launches()
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
                           "backproject_subline_fused": 1,
                           "backproject_subline_kernel_lanes": 0,
                           "backproject_subline_fused_lanes": 0}


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
                           "backproject_subline_fused": 1,
                           "backproject_subline_kernel_lanes": 0,
                           "backproject_subline_fused_lanes": 0}


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    img_t, mats, _ = _case(8, 16, 2, cuda)
    # every kernel takes any nz now (test_banded_kernels_past_the_old_depth_
    # limit, test_tiled_kernel_past_the_old_depth_limit)
    with pytest.raises(ValueError, match="contiguous"):
        ks.backproject_subline_kernel(img_t.transpose(1, 2).contiguous()
                                      .transpose(1, 2), mats, (8, 8, 8))
    assert sum(ks.LAUNCHES.values()) == 0
    assert sum(kb.LAUNCHES.values()) == 0


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


def _check(out, plain, ref, odd_nz, name):
    out = _cpu(out)
    assert rel_rmse(out, plain) < BAR, name
    assert rel_rmse(out, ref) < BAR, name
    if odd_nz:
        mid = out.shape[2] // 2
        assert rel_rmse(out[..., mid], ref[..., mid]) < BAR, name


@pytest.mark.parametrize("n,det,nproj", SWEEP)
@pytest.mark.parametrize("block", [(1, 8), (4, 8), (4, 16)])
@pytest.mark.parametrize("k_chunk", [4, 8, 128])
def test_onehot_kernels_match_plain_and_oracle(cuda, n, det, nproj, block,
                                               k_chunk):
    img_t, mats, shape = _case(n, det, nproj, cuda)
    plain = _cpu(ko.backproject_onehot_plain(img_t, mats, shape))
    ref = _cpu(backproject_ref(img_t, mats, shape))
    k3 = ops._run_padded(ko.backproject_onehot_kernel, img_t, mats, shape,
                         block, k_chunk=k_chunk)
    k4 = ops._run_padded(ko.backproject_onehot_fused, img_t, mats, shape,
                         block, k_chunk=k_chunk, nb=nproj)
    _check(k3, plain, ref, n % 2, "K3")
    _check(k4, plain, ref, n % 2, "K4")
    assert rel_rmse(_cpu(k3), plain) < ONEHOT_PLAIN_BAR
    assert torch.equal(k3, k4)
    k1 = ks.backproject_subline_kernel(img_t, mats, shape)
    assert rel_rmse(_cpu(k3), _cpu(k1)) < ONEHOT_K1_BAR
    assert ko.LAUNCHES == {"backproject_onehot_kernel": 1,
                           "backproject_onehot_fused": 1,
                           "backproject_onehot_kernel_lanes": 0,
                           "backproject_onehot_fused_lanes": 0}


@pytest.mark.parametrize("n,det,nproj", SWEEP + [(16, 48, 4)])
@pytest.mark.parametrize("block", [(1, 8), (4, 8), (4, 16)])
@pytest.mark.parametrize("bw", [8, 16, 32])
def test_banded_kernels_match_plain_and_oracle(cuda, n, det, nproj, block,
                                               bw):
    img_t, mats, shape = _case(n, det, nproj, cuda)
    ref = _cpu(backproject_ref(img_t, mats, shape))
    ni, nj = shape[:2]
    pshape = (-(-ni // block[0]) * block[0], -(-nj // block[1]) * block[1],
              shape[2])
    for group in (1, nproj):
        img_b, band, bw_used = kb.band_schedule(img_t, mats, pshape,
                                                block=block, bw=bw,
                                                group=group)
        cpu_band, _ = kb.tile_bands(mats.cpu(), *pshape[:2], *block, bw_used,
                                    img_b.shape[1], det, group=group)
        assert torch.equal(band.cpu(), cpu_band)
        kw = dict(block=block, bw=bw_used, nw=det)
        plain = _cpu(kb.backproject_banded_plain(img_b, mats, band, pshape,
                                                 group=group, **kw))
        if group == 1:
            out = kb.backproject_banded_kernel(img_b, mats, band, pshape,
                                               **kw)
        else:
            out = kb.backproject_banded_fused(img_b, mats, band, pshape,
                                              nb=group, **kw)
        _check(out[:ni, :nj], plain[:ni, :nj], ref, n % 2, f"group={group}")
    assert kb.LAUNCHES == {"backproject_banded_kernel": 1,
                           "backproject_banded_fused": 1,
                           "backproject_banded_kernel_lanes": 0,
                           "backproject_banded_fused_lanes": 0}


@pytest.mark.parametrize("nz,det,nproj", [(70, 64, 4), (1000, 512, 4),
                                          (1301, 1024, 8)])
def test_onehot_and_banded_deep_columns_match_plain(cuda, nz, det, nproj):
    img_t, mats, shape = _case(nz, det, nproj, cuda, lines=16)
    plain = _cpu(ko.backproject_onehot_plain(img_t, mats, shape))
    for out in (ko.backproject_onehot_kernel(img_t, mats, shape),
                ko.backproject_onehot_fused(img_t, mats, shape, nb=nproj)):
        assert rel_rmse(_cpu(out), plain) < BAR
    for group in (1, nproj):
        img_b, band, bw = kb.band_schedule(img_t, mats, shape, block=(4, 8),
                                           bw=32, group=group)
        kw = dict(block=(4, 8), bw=bw, nw=det)
        plain = _cpu(kb.backproject_banded_plain(img_b, mats, band, shape,
                                                 group=group, **kw))
        out = (kb.backproject_banded_kernel(img_b, mats, band, shape, **kw)
               if group == 1 else
               kb.backproject_banded_fused(img_b, mats, band, shape,
                                           nb=group, **kw))
        assert rel_rmse(_cpu(out), plain) < BAR


@pytest.mark.parametrize("nz,det,nproj,lines", TWO_HOT_PATHS)
def test_two_hot_form_on_every_stage2_path(cuda, nz, det, nproj, lines):
    """K3/K4 through the check-free, the checked and the line-by-line
    stage 2: within 4e-8 of their plain version, 1e-6 of K1, and K4 (at
    every nb) bit for bit K3."""
    img_t, mats, shape = _case(nz, det, nproj, cuda, seed=6, lines=lines)
    plain = _cpu(ko.backproject_onehot_plain(img_t, mats, shape))
    ref = _cpu(backproject_ref(img_t, mats, shape))
    k3 = ko.backproject_onehot_kernel(img_t, mats, shape)
    _check(k3, plain, ref, nz % 2, "K3")
    assert rel_rmse(_cpu(k3), plain) < ONEHOT_PLAIN_BAR
    k1 = ks.backproject_subline_kernel(img_t, mats, shape)
    assert rel_rmse(_cpu(k3), _cpu(k1)) < ONEHOT_K1_BAR
    for nb in (1, 2, 4):
        assert torch.equal(
            ko.backproject_onehot_fused(img_t, mats, shape, nb=nb), k3), nb
    assert ko.LAUNCHES == {"backproject_onehot_kernel": 1,
                           "backproject_onehot_fused": 3,
                           "backproject_onehot_kernel_lanes": 0,
                           "backproject_onehot_fused_lanes": 0}


def test_k_chunk_and_bands_change_no_bit(cuda):
    """K3's k tiles and K5/K6's bands change where the work is read, not
    its arithmetic: K3 is the same at any k_chunk, and K5/K6 read the
    sub-line kernel's very columns."""
    img_t, mats, shape = _case(15, 20, 6, cuda, seed=4)
    base = ko.backproject_onehot_kernel(img_t, mats, shape, k_chunk=128)
    for kc in (1, 3, 5, 33):
        assert torch.equal(
            ko.backproject_onehot_kernel(img_t, mats, shape, k_chunk=kc),
            base)
    k1 = ks.backproject_subline_kernel(img_t, mats, shape)
    for nb in (1, 2, 3, 6):
        out = ops.backproject_banded(img_t, mats, shape, nb=nb, bw=8,
                                     block=(4, 8), proj_loop=True)
        assert torch.equal(out, k1), nb


def test_cuda_tensors_never_reach_the_new_plain_versions(cuda, monkeypatch):
    img_t, mats, shape = _case(16, 24, 6, cuda)

    def refuse(*_, **__):
        raise AssertionError("plain version called on CUDA tensors")

    monkeypatch.setattr(ko, "backproject_onehot_plain", refuse)
    monkeypatch.setattr(kb, "backproject_banded_plain", refuse)
    for nb, loop in ((1, True), (2, True), (3, False)):
        ops.backproject_onehot(img_t, mats, shape, nb=nb, proj_loop=loop)
        ops.backproject_banded(img_t, mats, shape, nb=nb, proj_loop=loop)
    assert ko.LAUNCHES == {"backproject_onehot_kernel": 2,
                           "backproject_onehot_fused": 1,
                           "backproject_onehot_kernel_lanes": 0,
                           "backproject_onehot_fused_lanes": 0}
    assert kb.LAUNCHES == {"backproject_banded_kernel": 2,
                           "backproject_banded_fused": 1,
                           "backproject_banded_kernel_lanes": 0,
                           "backproject_banded_fused_lanes": 0}


@pytest.mark.parametrize("variant,kernel", [
    ("onehot_pl", "backproject_onehot_fused"),
    ("banded_pl", "backproject_banded_fused"),
])
def test_new_variants_on_card_match_plain_path(cuda, variant, kernel):
    import repro_torch
    g = standard_geometry(n=16, n_det=24, n_proj=8)
    p = np.random.RandomState(1).rand(8, g.nh, g.nw).astype(np.float32)
    vol = repro_torch.reconstruct(p, g, variant=variant)
    assert {**ko.LAUNCHES, **kb.LAUNCHES}[kernel] == 1
    plain = repro_torch.reconstruct(p, g, variant="algorithm1_mp")
    cpu = repro_torch.reconstruct(p, g, variant=variant, device="cpu")
    assert vol.device.type == "cuda"
    assert rel_rmse(_cpu(vol), _cpu(plain)) < BAR
    assert rel_rmse(_cpu(vol), _cpu(cpu)) < BAR


def _banded_pair(img_t, mats, pshape, block, nproj, bw0=32):
    """K5 and K6 (nb = every view) on ``pshape`` under their own band
    schedules, each with its plain version."""
    outs = []
    for group in (1, nproj):
        img_b, band, bw = kb.band_schedule(img_t, mats, pshape, block=block,
                                           bw=bw0, group=group)
        kw = dict(block=block, bw=bw, nw=img_t.shape[1])
        plain = kb.backproject_banded_plain(img_b, mats, band, pshape,
                                            group=group, **kw)
        out = (kb.backproject_banded_kernel(img_b, mats, band, pshape, **kw)
               if group == 1 else
               kb.backproject_banded_fused(img_b, mats, band, pshape,
                                           nb=group, **kw))
        outs.append((out, plain))
    return outs


@pytest.mark.parametrize("nz,det,nproj", [(2049, 1024, 4), (4098, 1024, 4)])
def test_banded_kernels_past_the_old_depth_limit(cuda, nz, det, nproj):
    """K5/K6 past the 2048 planes of the kernel they ran on before the
    tiled one (which refused nz = 4098): K1's volume bit for bit, and
    their plain version's within 1e-5."""
    img_t, mats, shape = _case(nz, det, nproj, cuda, lines=16)
    k1 = ks.backproject_subline_kernel(img_t, mats, shape)
    for out, plain in _banded_pair(img_t, mats, shape, (4, 8), nproj):
        assert torch.equal(out, k1)
        assert rel_rmse(_cpu(out), _cpu(plain)) < BAR
    assert kb.LAUNCHES == {"backproject_banded_kernel": 1,
                           "backproject_banded_fused": 1,
                           "backproject_banded_kernel_lanes": 0,
                           "backproject_banded_fused_lanes": 0}


@pytest.mark.parametrize("n,det,nproj", [(12, 16, 4), (20, 12, 7),
                                         (13, 17, 5)])
@pytest.mark.parametrize("block", [(4, 8), (8, 16)])
def test_banded_kernels_on_ragged_tiles(cuda, n, det, nproj, block):
    """Band tiles that leave the kernel's 8 x 8 tiles ragged (ni = 12 or 20
    with BI = 4): the warps and lanes past the volume read no band. K5/K6
    on the padded volume give unpadded K1's volume bit for bit."""
    img_t, mats, shape = _case(n, det, nproj, cuda, seed=7)
    pshape = (-(-n // block[0]) * block[0], -(-n // block[1]) * block[1], n)
    k1 = ks.backproject_subline_kernel(img_t, mats, shape)
    for out, plain in _banded_pair(img_t, mats, pshape, block, nproj, 8):
        assert torch.equal(out[:n, :n], k1)
        assert rel_rmse(_cpu(out), _cpu(plain)) < BAR


@pytest.mark.parametrize("group", [1, 3])
def test_banded_kernels_drop_the_lines_a_shifted_band_misses(cuda, group):
    """Bands of 8 columns moved one place right (tests/test_torch_banded_
    tiles.py builds the same case): the lines left of their band are
    dropped, as in the plain version."""
    img_t, mats, shape = _case(16, 24, 6, cuda)
    block, bw = (4, 8), 8
    img_b, n_bands = kb.band_layout(img_t, bw)
    band, _ = kb.tile_bands(mats, *shape[:2], *block, bw, n_bands, 24,
                            group=group)
    band = torch.clamp(band + 1, max=n_bands - 1)
    kw = dict(block=block, bw=bw, nw=24)
    plain = _cpu(kb.backproject_banded_plain(img_b, mats, band, shape,
                                             group=group, **kw))
    out = (kb.backproject_banded_kernel(img_b, mats, band, shape, **kw)
           if group == 1 else
           kb.backproject_banded_fused(img_b, mats, band, shape, nb=group,
                                       **kw))
    assert rel_rmse(_cpu(out), plain) < BAR
    k1 = _cpu(ks.backproject_subline_kernel(img_t, mats, shape))
    assert rel_rmse(_cpu(out), k1) > BAR      # lines were dropped


# ---- the tiled K1/K2 kernel ----------------------------------------------


@pytest.mark.parametrize("n,det,nproj", [(13, 17, 5), (20, 12, 7),
                                         (15, 20, 6)])
def test_tiled_kernel_on_ragged_tiles(cuda, n, det, nproj):
    """Volumes that are no whole number of 8 x 8 line tiles, unpadded."""
    img_t, mats, shape = _case(n, det, nproj, cuda, seed=2)
    plain = _cpu(ks.backproject_subline_plain(img_t, mats, shape))
    ref = _cpu(backproject_ref(img_t, mats, shape))
    k1 = ks.backproject_subline_kernel(img_t, mats, shape)
    _check(k1, plain, ref, n % 2, "K1")
    assert rel_rmse(_cpu(k1), plain) < 1e-7
    assert torch.equal(ks.backproject_subline_fused(img_t, mats, shape,
                                                    nb=nproj), k1)


@pytest.mark.parametrize("n,det,nproj,lines", [(16, 48, 4, None),
                                               (8, 32, 3, None),
                                               (300, 900, 4, 16),
                                               (100, 900, 4, 16)])
def test_tiled_kernel_global_read_path(cuda, n, det, nproj, lines):
    """Detectors so fine that a tile's window overflows its 16 columns
    (tests/test_torch_subline_tiles.py names these cases): those views
    read the columns from global memory; at 900 rows for 100 planes the
    windows overflow their rows too and run line by line at full height.
    The same result either way."""
    img_t, mats, shape = _case(n, det, nproj, cuda, seed=3, lines=lines)
    plain = _cpu(ks.backproject_subline_plain(img_t, mats, shape))
    ref = _cpu(backproject_ref(img_t, mats, shape))
    k1 = ks.backproject_subline_kernel(img_t, mats, shape)
    _check(k1, plain, ref, n % 2, "K1")
    assert rel_rmse(_cpu(k1), plain) < 1e-7
    out = ops.backproject_banded(img_t, mats, shape, nb=1, bw=8,
                                 block=(8, 8), proj_loop=False)
    assert torch.equal(out, k1)


@pytest.mark.parametrize("nz,det,nproj", [(1301, 1024, 8), (2049, 1024, 4),
                                          (2600, 1024, 4), (8192, 256, 2)])
def test_tiled_kernel_past_the_old_depth_limit(cuda, nz, det, nproj):
    """Deep columns: several k chunks, and nz past the 2048 planes of the
    kernel it replaced (8192: 32 chunks, four times that limit)."""
    img_t, mats, shape = _case(nz, det, nproj, cuda, lines=16)
    plain = _cpu(ks.backproject_subline_plain(img_t, mats, shape))
    ref = _cpu(backproject_ref(img_t, mats, shape))
    k1 = ks.backproject_subline_kernel(img_t, mats, shape)
    _check(k1, plain, ref, nz % 2, "K1")
    assert rel_rmse(_cpu(k1), plain) < 1e-7
    k2 = ks.backproject_subline_fused(img_t, mats, shape, nb=nproj)
    assert torch.equal(k2, k1)


def test_k2_at_every_nb_gives_k1_bit_for_bit(cuda):
    img_t, mats, shape = _case(70, 64, 24, cuda, seed=5, lines=12)
    k1 = ks.backproject_subline_kernel(img_t, mats, shape)
    for nb in (1, 2, 3, 6, 8):
        assert torch.equal(
            ks.backproject_subline_fused(img_t, mats, shape, nb=nb), k1), nb
    assert ks.LAUNCHES == {"backproject_subline_kernel": 1,
                           "backproject_subline_fused": 5,
                           "backproject_subline_kernel_lanes": 0,
                           "backproject_subline_fused_lanes": 0}


def test_tiled_kernel_layout_and_occupancy(cuda):
    """The kernel's shared-memory layout equals the mirror the CPU tests
    plan with, and the card holds at least 2 blocks per SM at every plan
    those tests check, in every instance (K1/K2 linear, K3/K4 two-hot,
    K5/K6 linear from the bands); a detector too tall for one block is
    refused."""
    import ctypes
    from test_torch_subline_tiles import _plan_cases, smem_bytes
    lib = ks._lib()
    for shape, nh in _plan_cases():
        plan = ks.launch_plan(shape, nh)
        assert lib.bp_tile_smem_bytes(nh, plan.win_rows) \
            == smem_bytes(nh, plan.win_rows), (shape, nh)
        for form, banded in INSTANCES:
            blocks, regs, local = (ctypes.c_int(), ctypes.c_int(),
                                   ctypes.c_int())
            assert lib.bp_tile_occupancy(
                plan.kpt, form, banded, nh, plan.win_rows,
                ctypes.byref(blocks), ctypes.byref(regs),
                ctypes.byref(local)) == 0
            assert blocks.value >= 2, (shape, nh, form, banded)
    blocks, regs, local = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    assert lib.bp_tile_occupancy(4, ks.TWO_HOT, 1, 512, 272,
                                 ctypes.byref(blocks), ctypes.byref(regs),
                                 ctypes.byref(local)) != 0   # no such instance
    img_t = torch.zeros((1, 2, 8192), device=cuda)
    mats = torch.zeros((1, 3, 4), device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        ks.backproject_subline_kernel(img_t, mats, (8, 8, 8))
    assert sum(ks.LAUNCHES.values()) == 0


# ---- the tiled, out-of-core walks on the card -------------------------------

TILED_VARIANTS = [("subline_pl", "backproject_subline_fused"),
                  ("onehot_pl", "backproject_onehot_fused"),
                  ("banded_pl", "backproject_banded_fused")]


def _launch_counts():
    out = {}
    for mod in (ks, ko, kb):
        out.update(mod.LAUNCHES)
    return out


@pytest.mark.parametrize("n,det,nproj", SWEEP)
@pytest.mark.parametrize("variant,kernel", TILED_VARIANTS)
@pytest.mark.parametrize("tile", [(5, 7, 5), (9, 16, 2)])
def test_tiled_walk_on_card_matches_oracle(cuda, n, det, nproj, variant,
                                           kernel, tile):
    """Ragged tiles through the executor (the wrappers pad each tile's
    i/j to the block): one launch per step and chunk, no plain version,
    and the volume within the bar of the oracle."""
    from repro_torch.runtime.engine import TiledReconstructor
    img_t, mats, shape = _case(n, det, nproj, cuda, seed=n)
    g = standard_geometry(n=n, n_det=det, n_proj=nproj)
    eng = TiledReconstructor(g, variant, tile_shape=tile, nb=1,
                             proj_batch=2, out="device")
    plan = eng.recon_plan
    assert {s.variant for s in plan.steps} == {variant}
    out = eng.backproject(img_t, mats)
    torch.cuda.synchronize()
    n_chunks = -(-nproj // 2)
    kernel1 = kernel.replace("_fused", "_kernel")
    counts = _launch_counts()
    assert counts[kernel1] + counts[kernel] == len(plan.steps) * n_chunks
    assert sum(counts.values()) == len(plan.steps) * n_chunks
    ref = backproject_ref(img_t, mats, shape)
    assert rel_rmse(_cpu(out), _cpu(ref)) < BAR


@pytest.mark.parametrize("variant,kernel", TILED_VARIANTS)
@pytest.mark.parametrize("schedule", ["step", "chunk"])
def test_tiled_async_equals_sync_on_card(cuda, variant, kernel, schedule):
    import repro_torch
    g = standard_geometry(n=20, n_det=28, n_proj=8)
    p = np.random.RandomState(4).rand(8, g.nh, g.nw).astype(np.float32)
    kw = dict(variant=variant, nb=2, tiling=(7, 9, 3), proj_batch=4,
              schedule=schedule, out="host")
    sync = repro_torch.reconstruct(p, g, pipeline="sync", **kw)
    asy = repro_torch.reconstruct(p, g, pipeline="async", **kw)
    assert isinstance(asy, np.ndarray)
    assert np.array_equal(sync, asy)
    dev = repro_torch.reconstruct(p, g, pipeline="async",
                                  **dict(kw, out="device"))
    assert np.array_equal(sync, _cpu(dev))
    untiled = repro_torch.reconstruct(p, g, variant=variant, nb=2)
    assert rel_rmse(asy, _cpu(untiled)) < BAR
    assert _launch_counts()[kernel] > 0


def test_forward_project_on_card_matches_cpu(cuda):
    import repro_torch
    from repro_torch.core.phantom import shepp_logan_3d
    g = standard_geometry(n=16, n_det=20, n_proj=6)
    vol = shepp_logan_3d(16)
    card = repro_torch.forward_project(torch.from_numpy(vol).to(cuda), g,
                                       proj_batch=4)
    cpu = repro_torch.forward_project(torch.from_numpy(vol), g)
    assert card.device.type == "cuda"
    assert rel_rmse(_cpu(card), _cpu(cpu)) < BAR


# ---- F1, the forward projector, and the solvers on the card -----------------

# (nx, ny, nz, nw, nh, views, oversample): the sweep's odd shape with a
# 17 x 13 detector, a cube, and a flat box
FORWARD_SHAPES = [(13, 17, 5, 17, 13, 5, 1.0), (12, 12, 12, 16, 16, 4, 2.0),
                  (20, 12, 7, 24, 9, 6, 1.0)]


def _forward_geom(nx, ny, nz, nw, nh, nproj):
    g = standard_geometry(n=max(nx, ny, nz), n_det=max(nw, nh),
                          n_proj=nproj)
    return dataclasses.replace(g, nx=nx, ny=ny, nz=nz, nw=nw, nh=nh)


@pytest.mark.parametrize("nx,ny,nz,nw,nh,nproj,oversample", FORWARD_SHAPES)
@pytest.mark.parametrize("proj_batch,views", [
    (None, None), (2, None), (3, slice(1, None, 2)), (None, [4, 0, 2]),
])
def test_f1_matches_plain(cuda, nx, ny, nz, nw, nh, nproj, oversample,
                          proj_batch, views):
    """F1 through forward_project (one launch per chunk of views)
    against its plain version on the same card, on the selected views."""
    from repro_torch.core import forward as tfw
    g = _forward_geom(nx, ny, nz, nw, nh, nproj)
    views = [v for v in views if v < nproj] if isinstance(views, list) \
        else views
    vol = torch.from_numpy(np.random.RandomState(nz).rand(nz, ny, nx).astype(
        np.float32)).to(cuda)
    out = tfw.forward_project(vol, g, oversample, proj_batch=proj_batch,
                              views=views)
    idx = np.arange(nproj)[views] if views is not None else np.arange(nproj)
    k = len(idx)
    chunk = k if proj_batch is None else min(proj_batch, k)
    assert kf.LAUNCHES["forward_project_kernel"] == -(-k // chunk)
    org, inv, step, near, n_steps = tfw.march_params(g, oversample, cuda)
    frames = [torch.from_numpy(np.ascontiguousarray(f[idx])).to(cuda)
              for f in tfw.view_frames(g)]
    plain = kf.forward_project_plain(vol, *frames, org, inv, n_steps, nh,
                                     nw, step, near)
    assert out.device.type == "cuda" and tuple(out.shape) == (k, nh, nw)
    assert rel_rmse(_cpu(out), _cpu(plain)) < BAR
    cpu = tfw.forward_project(vol.cpu(), g, oversample, views=views)
    assert rel_rmse(_cpu(out), _cpu(cpu)) < BAR


def test_f1_bf16_route_matches_plain_on_rounded_volume(cuda):
    """A bf16 solver's forward program rounds the volume to bf16 and
    marches it in f32: the plain version on the rounded volume."""
    from repro_torch.core import forward as tfw
    from repro_torch.runtime.planner import plan_reconstruction
    from repro_torch.runtime.solvers import IterativeExecutor
    g = standard_geometry(n=13, n_det=17, n_proj=5)
    vol = torch.from_numpy(np.random.RandomState(2).rand(13, 13, 13).astype(
        np.float32)).to(cuda)
    plan = plan_reconstruction(g, "subline_pl", out="device", nb=1,
                               precision="bf16", solver="sart")
    ex = IterativeExecutor(g, plan, oversample=1.0)
    got = ex._fp(vol)
    org, inv, step, near, n_steps = tfw.march_params(g, 1.0, cuda)
    frames = [torch.from_numpy(f).to(cuda) for f in tfw.view_frames(g)]
    want = kf.forward_project_plain(vol.to(torch.bfloat16).float(), *frames,
                                    org, inv, n_steps, g.nh, g.nw, step,
                                    near)
    assert rel_rmse(_cpu(got), _cpu(want)) < BAR
    assert kf.LAUNCHES["forward_project_kernel"] == 1


def test_cuda_volumes_never_reach_the_plain_march(cuda, monkeypatch):
    import repro_torch
    from repro_torch.core.phantom import shepp_logan_3d

    def refuse(*_):
        raise AssertionError("plain march called on a CUDA volume")

    monkeypatch.setattr(kf, "forward_project_plain", refuse)
    g = standard_geometry(n=12, n_det=16, n_proj=4)
    out = repro_torch.forward_project(shepp_logan_3d(12), g, device="cuda")
    assert out.device.type == "cuda"
    assert kf.LAUNCHES["forward_project_kernel"] == 1


def test_f1_rejects_what_it_does_not_take(cuda):
    from repro_torch.core import forward as tfw
    g = standard_geometry(n=8, n_det=12, n_proj=2)
    org, inv, step, near, n_steps = tfw.march_params(g, 1.0, cuda)
    frames = [torch.from_numpy(f).to(cuda) for f in tfw.view_frames(g)]
    vol = torch.zeros((8, 8, 8), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        kf.forward_project_kernel(vol.double(), *frames, org, inv, n_steps,
                                  g.nh, g.nw, step, near)
    with pytest.raises(ValueError, match="device"):
        kf.forward_project_kernel(vol, *(f.cpu() for f in frames), org, inv,
                                  n_steps, g.nh, g.nw, step, near)
    with pytest.raises(ValueError, match="frames"):
        kf.forward_project_kernel(vol, frames[0][:1], *frames[1:], org, inv,
                                  n_steps, g.nh, g.nw, step, near)
    assert kf.LAUNCHES["forward_project_kernel"] == 0


@pytest.mark.parametrize("method,kw", [("sart", {}),
                                       ("os_sart", {"proj_batch": 8}),
                                       ("cgls", {}), ("fista_tv", {})])
def test_solvers_on_card_match_cpu(cuda, method, kw):
    """Each solver with subline_pl on the card (F1 and K2) against the same
    solve on the CPU (plain versions), at the CPU parity tests' 1e-4."""
    from repro_torch.runtime.executor import ProgramCache
    from repro_torch.runtime.solvers import solve
    g = standard_geometry(n=24, n_det=32, n_proj=16)
    projs = np.random.RandomState(3).rand(16, g.nh, g.nw).astype(np.float32)
    card, rep = solve(projs, g, method, n_iters=3, variant="subline_pl",
                      cache=ProgramCache(), **kw)
    cpu, rep_cpu = solve(projs, g, method, n_iters=3, variant="subline_pl",
                         cache=ProgramCache(), device="cpu", **kw)
    assert card.device.type == "cuda"
    assert rel_rmse(_cpu(card), _cpu(cpu)) < 1e-4
    for a, b in zip(rep.residuals, rep_cpu.residuals):
        assert abs(a - b) <= 1e-4 * abs(b)
    assert rep.compiles_warm == 0
    counts = _launch_counts()
    assert counts["backproject_subline_fused"] > 0
    assert kf.LAUNCHES["forward_project_kernel"] > 0


def test_sart_step_and_reconstruct_on_card(cuda):
    import repro_torch
    g = standard_geometry(n=16, n_det=24, n_proj=8)
    projs = np.random.RandomState(5).rand(8, g.nh, g.nw).astype(np.float32)
    x = repro_torch.sart_step(np.zeros((16, 16, 16), np.float32), projs, g,
                              variant="subline_pl", nb=4)
    cpu = repro_torch.sart_step(np.zeros((16, 16, 16), np.float32), projs, g,
                                variant="subline_pl", nb=4, device="cpu")
    assert x.device.type == "cuda"
    assert rel_rmse(_cpu(x), _cpu(cpu)) < 1e-4
    vol = repro_torch.reconstruct(projs, g, method="sart",
                                  variant="subline_pl", n_iters=2,
                                  precision="bf16")
    assert vol.device.type == "cuda" and bool(torch.isfinite(vol).all())


def test_autotune_auto_measures_the_cuda_variants(cuda, tmp_path):
    """variant="auto" on the card plans subline_pl untuned, measures the
    three CUDA variants (the ladder's first three there) with the default
    budget and persists a winner that reconstruct resolves; its volume is within 1e-5 of algorithm1_mp (or within the
    bf16 contract of 2e-2 where the search picked precision="bf16")."""
    import repro_torch
    from repro_torch.runtime import autotune as at
    from repro_torch.runtime import telemetry
    g = standard_geometry(n=32, n_det=48, n_proj=16)
    projs = np.random.RandomState(7).rand(16, g.nh, g.nw).astype(np.float32)
    p = torch.from_numpy(projs).cuda()
    path = str(tmp_path / "tuning.json")
    untuned = at.resolve_config(g, "auto", cache=path)
    assert (untuned.source, untuned.variant) == ("heuristic", "subline_pl")
    with telemetry.tracing():
        cfg = at.autotune(g, "auto", cache=path, projections=p, iters=1,
                          variants=("subline_pl", "onehot_pl", "banded_pl"))
    measured = [e["args"]["variant"] for e in telemetry.events()
                if e["name"] == "autotune.candidate"]
    telemetry.clear()
    assert measured[0] == "subline_pl"        # the card's base: a kernel
    assert {"subline_pl", "onehot_pl", "banded_pl"} <= set(measured)
    counts = _launch_counts()
    for kernel in ("backproject_subline_fused", "backproject_onehot_fused",
                   "backproject_banded_fused"):
        assert counts[kernel] > 0, counts
    assert at.hardware_fingerprint()[0] == "cuda"
    assert at.resolve_config(g, "auto", cache=path).source == "cache"
    vol = repro_torch.reconstruct(p, g, variant="auto", tuning=path)
    ref = repro_torch.reconstruct(p, g, variant="algorithm1_mp")
    bar = BAR if cfg.precision == "f32" else 2e-2
    assert rel_rmse(_cpu(vol), _cpu(ref)) < bar


# ---- rb-lane launches (request batching) -----------------------------------

LANE_SWEEP = [(16, 24, 6), (13, 17, 5), (20, 12, 7)]
# (family, solo ops wrapper, lane ops wrapper, bar against the plain version)
LANE_FAMILIES = [("subline", ops.backproject_subline,
                  ops.backproject_subline_lanes, BAR),
                 ("onehot", ops.backproject_onehot,
                  ops.backproject_onehot_lanes, ONEHOT_PLAIN_BAR),
                 ("banded", ops.backproject_banded,
                  ops.backproject_banded_lanes, BAR)]


def _lanes_case(n, det, nproj, rb, dev, seed=0):
    g = standard_geometry(n=n, n_det=det, n_proj=nproj)
    img = np.random.RandomState(seed).rand(rb, nproj, g.nh, g.nw).astype(
        np.float32)
    img_b = torch.stack([transpose_projections(torch.from_numpy(x).to(dev))
                         for x in img])
    return img_b, projection_matrices(g, dev), g.volume_shape_xyz


def _lane_counts():
    out = {}
    for mod in (ks, ko, kb):
        out.update({k: v for k, v in mod.LAUNCHES.items()
                    if k.endswith("_lanes")})
    return out


@pytest.mark.parametrize("rb", [1, 3, 8])
@pytest.mark.parametrize("n,det,nproj", LANE_SWEEP)
@pytest.mark.parametrize("family,solo,lanes,bar", LANE_FAMILIES,
                         ids=[f[0] for f in LANE_FAMILIES])
def test_lane_launches_equal_solo_and_plain(cuda, rb, n, det, nproj, family,
                                            solo, lanes, bar):
    """Each lane of one rb-lane launch (K1/K3/K5 at nb=1, K2/K4/K6 with
    the nb loop) equals the solo launch on that lane bit for bit, and
    the plain version within the sweep bar; one launch serves all
    lanes."""
    img_b, mats, shape = _lanes_case(n, det, nproj, rb, cuda)
    for nb, loop in ((1, False), (nproj, True)):
        before = sum(_lane_counts().values())
        out = lanes(img_b, mats, shape, nb=nb, proj_loop=loop)
        assert sum(_lane_counts().values()) == before + 1
        assert out.shape == (rb,) + tuple(shape)
        for r in range(rb):
            one = solo(img_b[r], mats, shape, nb=nb, proj_loop=loop)
            assert torch.equal(out[r], one), (family, nb, r)
            plain = solo(img_b[r].cpu(), mats.cpu(), shape, nb=nb,
                         proj_loop=loop, device="cpu")
            assert rel_rmse(_cpu(out[r]), _cpu(plain)) < bar, (family, nb)
    fused = f"backproject_{family}_fused_lanes"
    assert _lane_counts()[fused] == 1
    assert _lane_counts()[f"backproject_{family}_kernel_lanes"] == 1


def test_lane_launch_on_strided_lanes(cuda):
    """The batch programs hand the kernel one chunk of every request's
    stacked grid: lanes far apart, each lane contiguous."""
    img_b, mats, shape = _lanes_case(16, 24, 4, 6, cuda)
    grid = img_b.reshape(3, 2, 4, *img_b.shape[2:])    # (rb, chunks, ...)
    for c in range(2):
        out = ops.backproject_subline_lanes(grid[:, c], mats, shape)
        for r in range(3):
            assert torch.equal(out[r], ops.backproject_subline(
                grid[r, c].contiguous(), mats, shape))


def test_failed_lane_launch_raises_and_does_not_fall_back(cuda,
                                                          monkeypatch):
    """Lanes that overlap (a lane stride of 0) are refused by the kernel's
    entry: the wrapper raises, launches nothing else and never runs a
    plain version or a loop of solo launches."""
    img_b, mats, shape = _lanes_case(16, 24, 6, 1, cuda)
    overlapping = img_b.expand(3, -1, -1, -1)

    def refuse(*_, **__):
        raise AssertionError("fell back after a failed lane launch")

    for mod, name in ((ks, "backproject_subline_plain"),
                      (ko, "backproject_onehot_plain"),
                      (kb, "backproject_banded_plain"),
                      (ks, "launch_tile")):
        monkeypatch.setattr(mod, name, refuse)
    with pytest.raises(RuntimeError, match="launch failed"):
        ks.backproject_subline_kernel_lanes(overlapping, mats, shape)
    with pytest.raises(RuntimeError, match="launch failed"):
        ko.backproject_onehot_fused_lanes(overlapping, mats, shape, nb=2)
    img_bb, band, bw = kb.band_schedule(img_b[0], mats, shape, block=(4, 8),
                                        bw=32, group=1)
    with pytest.raises(RuntimeError, match="launch failed"):
        kb.backproject_banded_kernel_lanes(
            img_bb[None].expand(3, -1, -1, -1, -1), mats, band, shape,
            bw=bw, nw=24)
    assert sum(_lane_counts().values()) == 0


def test_execute_batch_on_card_equals_solo(cuda):
    """execute_batch through each CUDA variant: every request's volume is
    its solo reconstruct bit for bit, with one lane launch per chunk."""
    from repro_torch.runtime.executor import PlanExecutor, ProgramCache
    from repro_torch.runtime.planner import plan_reconstruction
    g = standard_geometry(n=32, n_det=48, n_proj=16)
    rng = np.random.RandomState(2)
    reqs = [rng.rand(16, g.nh, g.nw).astype(np.float32) for _ in range(3)]
    for variant, fused in (("subline_pl", "backproject_subline_fused_lanes"),
                           ("onehot_pl", "backproject_onehot_fused_lanes"),
                           ("banded_pl", "backproject_banded_fused_lanes")):
        plan = plan_reconstruction(g, variant, nb=4, proj_batch=8,
                                   out="device")
        ex = PlanExecutor(g, plan, cache=ProgramCache(), device=cuda)
        solo = [ex.reconstruct(p) for p in reqs]
        before = _lane_counts()[fused]
        bat = ex.execute_batch(reqs)
        assert _lane_counts()[fused] - before == 2     # two chunks
        for a, b in zip(solo, bat):
            assert torch.equal(a, b), variant


FLEET_FUSED = (("subline_pl", ks, "backproject_subline_fused"),
               ("onehot_pl", ko, "backproject_onehot_fused"),
               ("banded_pl", kb, "backproject_banded_fused"))


def _fleet_case():
    from repro_torch.runtime.planner import plan_reconstruction
    g = standard_geometry(n=32, n_det=48, n_proj=16)
    projs = np.random.RandomState(4).rand(16, g.nh, g.nw).astype(np.float32)
    return g, projs, lambda variant: plan_reconstruction(
        g, variant, nb=4, tile_shape=(16, 16, 8), proj_batch=8, out="host")


@pytest.mark.parametrize("variant,mod,fused", FLEET_FUSED,
                         ids=[v for v, _, _ in FLEET_FUSED])
def test_fleet_on_card_equals_single_walk(cuda, variant, mod, fused):
    """Two workers on one card (``("cuda:0",) * 2``): the volume equals
    the single-device step-major walk bit for bit, through the variant's
    kernel, one launch per step and chunk."""
    from repro_torch.runtime.executor import (FleetConfig, PlanExecutor,
                                              ProgramCache)
    g, projs, plan_of = _fleet_case()
    plan = plan_of(variant)
    cache = ProgramCache()
    single = PlanExecutor(g, plan, cache=cache, device=cuda).reconstruct(
        projs)
    ex = PlanExecutor(g, plan, cache=cache,
                      fleet=FleetConfig(devices=("cuda:0",) * 2))
    before = mod.LAUNCHES[fused]
    vol = ex.reconstruct(projs)
    assert np.array_equal(vol, single)
    assert mod.LAUNCHES[fused] - before == len(plan.steps) * len(plan.chunks)
    assert sum(ex.last_fleet_report.steps_by_device) == len(plan.steps)


@pytest.mark.parametrize("variant,mod,fused", FLEET_FUSED,
                         ids=[v for v, _, _ in FLEET_FUSED])
def test_fleet_batch_on_card_equals_solo_walks(cuda, variant, mod, fused):
    """``execute_batch`` of two requests on ``("cuda:0",) * 2``: one
    rb-lane launch per step and chunk, and each lane's volume equals its
    request's single-device walk bit for bit."""
    from repro_torch.runtime.executor import (FleetConfig, PlanExecutor,
                                              ProgramCache)
    g, projs, plan_of = _fleet_case()
    projs2 = np.random.RandomState(5).rand(*projs.shape).astype(np.float32)
    plan = plan_of(variant)
    cache = ProgramCache()
    solo = [PlanExecutor(g, plan, cache=cache, device=cuda).reconstruct(x)
            for x in (projs, projs2)]
    ex = PlanExecutor(g, plan, cache=cache,
                      fleet=FleetConfig(devices=("cuda:0",) * 2))
    ex.warm_batch(2)
    before = dict(mod.LAUNCHES)
    got = ex.execute_batch([projs, projs2])
    assert all(np.array_equal(a, b) for a, b in zip(got, solo))
    n = {k: v - before[k] for k, v in mod.LAUNCHES.items()}
    assert n[f"{fused}_lanes"] == len(plan.steps) * len(plan.chunks)
    assert sum(n.values()) == n[f"{fused}_lanes"]


def test_fleet_refuses_mixed_device_types_on_card(cuda):
    """With a card present, a fleet of CUDA and CPU entries, or CPU
    entries under inputs filtered on the card, raises: no failed card
    step can re-run on the CPU through the plain version."""
    from repro_torch.core.fdk import fdk_reconstruct
    from repro_torch.runtime.executor import (FleetConfig, PlanExecutor,
                                              as_fleet_config)
    from repro_torch.runtime.service import ReconService
    g, projs, plan_of = _fleet_case()
    for devices in (("cuda:0", "cpu"), ("cpu", "cuda")):
        with pytest.raises(ValueError, match="one device type"):
            as_fleet_config(devices)
        with pytest.raises(ValueError, match="one device type"):
            FleetConfig(devices=devices).resolve_devices()
        with pytest.raises(ValueError, match="one device type"):
            fdk_reconstruct(projs, g, tiling=(16, 16, 8), proj_batch=8,
                            devices=devices)
        with pytest.raises(ValueError, match="one device type"):
            ReconService(devices=devices)
    with pytest.raises(ValueError, match="filtered on cuda"):
        PlanExecutor(g, plan_of("subline_pl"), device=cuda,
                     fleet=FleetConfig(devices=("cpu",) * 2))
    with pytest.raises(ValueError, match="filtered on cuda"):
        ReconService(devices=("cpu",) * 2, device=cuda)


def test_fleet_failover_on_card(cuda):
    """Entry 1 faults on every step: it is retired with 0 steps, entry 0
    re-runs its steps with the same kernel, and the volume is the single
    walk's bit for bit; a step failing everywhere aborts the run."""
    from repro_torch.runtime.executor import (FleetConfig, PlanExecutor,
                                              ProgramCache)
    g, projs, plan_of = _fleet_case()
    plan = plan_of("subline_pl")
    cache = ProgramCache()
    single = PlanExecutor(g, plan, cache=cache, device=cuda).reconstruct(
        projs)

    def fail_entry1(entry, step):
        if entry == 1:
            raise RuntimeError("injected device fault")

    ex = PlanExecutor(g, plan, cache=cache, fleet=FleetConfig(
        devices=("cuda:0",) * 2, step_hook=fail_entry1))
    vol = ex.reconstruct(projs)
    rep = ex.last_fleet_report
    assert np.array_equal(vol, single)
    assert rep.dead_devices == (1,) and rep.steps_by_device[1] == 0
    assert rep.retried >= 1

    def poison(entry, step):
        if step == 0:
            raise RuntimeError("injected poison step")

    ex = PlanExecutor(g, plan, cache=cache, fleet=FleetConfig(
        devices=("cuda:0",) * 2, step_hook=poison))
    with pytest.raises(RuntimeError, match="max_retries_per_step"):
        ex.reconstruct(projs)


def test_mesh_on_card_matches_single_device_scan(cuda):
    """The (2, 2, 2) pod/data/model mesh on ("cuda:0",) * 8 and the tiled
    composition (async = sync bit for bit) against the card's
    single-device scan; the CT projection source's F1 launch."""
    from repro_torch.core.backproject import bp_subline_symmetry_scan
    from repro_torch.core.distributed import distributed_backproject
    from repro_torch.data import CTProjectionSource
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.engine import TiledReconstructor
    geom = standard_geometry(n=16, n_det=24, n_proj=8)
    src = CTProjectionSource(geom, nb=4)
    assert kf.LAUNCHES["forward_project_kernel"] == 1
    img_t = transpose_projections(torch.from_numpy(src.projections).cuda())
    mats = projection_matrices(geom)
    want = bp_subline_symmetry_scan(img_t, mats, geom.volume_shape_xyz)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), ("cuda:0",) * 8)
    got = distributed_backproject(img_t, mats, geom, mesh, nb=6)
    assert got.device.type == "cuda"
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) / scale < BAR
    eng = TiledReconstructor(geom, tile_shape=(5, 7, geom.nz), nb=4)
    sync = eng.backproject_distributed(img_t, mats, mesh, nb=4)
    assert np.abs(sync - want.cpu().numpy()).max() / scale < BAR
    assert np.array_equal(sync, eng.backproject_distributed(
        img_t, mats, mesh, nb=4, pipeline="async"))
    assert all(v == 0 for mod in (ks, ko, kb)
               for v in mod.LAUNCHES.values())


def test_dense_lm_on_card_matches_cpu(cuda):
    """A dense smoke model drawn on the CPU and copied to the card: the
    card's teacher-forced logits, prefill and decode steps against the
    CPU's (float32)."""
    from repro_torch.configs import ShapeConfig, get_smoke_config
    from repro_torch.models import build_model
    cfg = get_smoke_config("qwen2.5-3b")
    cpu_model = build_model(cfg, seed=0, device="cpu")
    card_model = build_model(cfg, seed=1, device="cuda")
    card_model.load_state_dict(cpu_model.state_dict())
    batch = cpu_model.dummy_batch(ShapeConfig("s", "train", 12, 2))
    want, _ = cpu_model(batch)
    got, _ = card_model({k: v.cuda() for k, v in batch.items()})
    assert float((got.cpu() - want).abs().max()) < 1e-4
    logits, cache, _ = card_model.prefill(
        {"tokens": batch["tokens"][:, :8].cuda()}, 12)
    for t in range(8, 12):
        logits, cache = card_model.decode_step(
            cache, batch["tokens"][:, t:t + 1].cuda(), t)
        assert float((logits[:, -1].cpu() - want[:, t]).abs().max()) < 1e-4


def test_reshard_on_card_round_trips(cuda):
    """``reshard_tree`` of a smoke model's parameters from (4, 2) to
    (2, 4) on ``("cuda:0",) * 8``: bit for bit, every block on the
    card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.runtime import reshard_tree
    model = build_model(get_smoke_config("qwen2.5-3b"), seed=0, device="cuda")
    tree = {n: p.detach() for n, p in model.named_parameters()}
    meshes = [make_mesh(s, ("data", "model"), ("cuda:0",) * 8)
              for s in ((4, 2), (2, 4))]

    def spec_fn(mesh):
        return lambda path, leaf: shd.spec_for_param(path, leaf.shape, mesh)

    t_b = reshard_tree(reshard_tree(tree, meshes[0], spec_fn(meshes[0])),
                       meshes[1], spec_fn(meshes[1]))
    for name, t in tree.items():
        assert torch.equal(t_b[name].full(), t)
        assert all(b.device.type == "cuda" for b in t_b[name].blocks)


def test_sharded_train_step_on_card_matches_cpu(cuda):
    """The sharded step of a smoke model on ``("cuda:0",) * 4`` against
    the same step on ``("cpu",) * 4`` from the same state (loss and
    gnorm, rel 1e-4, two steps)."""
    from repro_torch.configs import RunConfig, ShapeConfig, get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import (TrainState, init_state,
                                          make_train_step, shard_train_step)
    from repro_torch.models import build_model
    from repro_torch.models.model import abstract_params
    from repro_torch.optim import adamw_init
    cfg = get_smoke_config("qwen2.5-3b")
    run = RunConfig(seed=0, warmup_steps=0)
    cpu_model = build_model(cfg, seed=0, device="cpu")
    init_state(cpu_model, run)
    batch = {k: v for k, v in cpu_model.dummy_batch(
        ShapeConfig("t", "train", 16, 4)).items()}
    card_model = build_model(cfg, seed=1, device="cuda")
    card_model.load_state_dict(cpu_model.state_dict())
    out = {}
    for dev, model in (("cpu", cpu_model), ("cuda:0", card_model)):
        params = dict(model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        state = TrainState(params=params, opt=adamw_init(params))
        step = make_train_step(model, run, total_steps=100)
        mesh = make_mesh((2, 2), ("data", "model"), (dev,) * 4)
        sstep, _ = shard_train_step(step, model, mesh, abstract_params(cfg),
                                    batch)
        s1, m1 = sstep(state, batch)
        _, m2 = sstep(s1, batch)
        out[dev] = [(float(m["loss"]), float(m["gnorm"])) for m in (m1, m2)]
    for (a, b), (c, d) in zip(out["cpu"], out["cuda:0"]):
        assert abs(a - c) <= 1e-4 * abs(a) and abs(b - d) <= 1e-4 * abs(b)
