"""The plain FDK of the benchmark against the program's CPU path, at
smoke sizes: float32 agrees to rounding, the bf16 path does not."""

import pytest
import torch

from ctbench.reference.fdk import fdk_columns
from ctbench.scans import make_scans

SIZES = [(16, 24, 8), (20, 32, 16), (33, 40, 24)]


def _cfg(n, det, views):
    return {"volume": n, "detector": det, "views": views, "sad": 1000.0,
            "sdd": 1536.0, "volume_extent": 256.0, "detector_pad": 1.25}


def _program(scan, cfg, precision):
    import repro_torch
    from repro_torch.core.geometry import standard_geometry
    geom = standard_geometry(n=cfg["volume"], n_det=cfg["detector"],
                             n_proj=cfg["views"])
    return repro_torch.reconstruct(
        scan, geom, method="fdk",
        options=repro_torch.ReconOptions(variant="subline_pl", nb=8,
                                         precision=precision),
        device="cpu")


@pytest.mark.parametrize("size", SIZES, ids=str)
def test_ctbench_reference_matches_program(size):
    cfg = _cfg(*size)
    n = cfg["volume"]
    scan = make_scans(cfg, 2 ** 31 + 5, 1, "cpu")[0]
    ii, jj = torch.meshgrid(torch.arange(n), torch.arange(n), indexing="ij")
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    ref = fdk_columns(scan, cfg, ii, jj, view_block=3)
    errs = {}
    for precision in ("f32", "bf16"):
        vol = _program(scan, cfg, precision)
        got = vol.permute(2, 1, 0)[ii, jj, :].double()
        errs[precision] = float((got - ref).norm() / ref.norm())
    assert errs["f32"] < 2e-6, errs
    assert errs["bf16"] > 1e-4, errs


def test_ctbench_reference_view_blocks_agree():
    cfg = _cfg(12, 16, 8)
    scan = make_scans(cfg, 7, 1, "cpu")[0]
    ii = torch.tensor([0, 3, 11, 5])
    jj = torch.tensor([1, 3, 0, 11])
    a = fdk_columns(scan, cfg, ii, jj, view_block=1)
    b = fdk_columns(scan, cfg, ii, jj, view_block=8)
    assert torch.allclose(a, b, rtol=1e-12, atol=1e-15)


def test_ctbench_scans_repeat_from_the_seed():
    cfg = _cfg(8, 16, 8)
    a = make_scans(cfg, 2 ** 33 + 1, 3, "cpu")
    b = make_scans(cfg, 2 ** 33 + 1, 2, "cpu")
    c = make_scans(cfg, 2 ** 33 + 2, 1, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (8, 16, 16) and a[0].dtype == torch.float32
