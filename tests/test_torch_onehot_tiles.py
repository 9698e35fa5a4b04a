"""The one-hot K3/K4 on the tiled kernel, on the CPU.

K3/K4 run the tiled K1/K2 kernel (``tile_kernel`` in
``csrc/backproject_subline.cu``) with stage 2 in its two-hot form: the
nonzero terms of the reference's contraction over all nh rows, two a
sample. The kernel runs only on the card; what it rests on is checked
here:

- a test-local mirror of that form, ``(1 - dy) * row[iyc]`` then
  ``+ dy * row[iyc + 1]``, equals the dense contraction of the plain
  version (``backproject_onehot._interp_onehot``) within 1e-7 on the edge
  rows of the detector, with exact zeros wherever the dense form gives
  zero; a non-finite row value is where the two forms differ;
- the two rows each valid sample's row of ``A`` touches lie inside the
  rows of its tile's window, as the CPU model of the windows
  (``tests/test_torch_subline_tiles.py``) computes them, at the sweep
  shapes and at P4, P5, P7 and P8: the windows that K1's linear form
  reads serve the two-hot form unchanged;
- the card tests' shapes for the two-hot form
  (``tests/test_torch_cuda.py::TWO_HOT_PATHS``) run each of stage 2's
  paths: the check-free one, the checked one and the line-by-line
  global one.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.ct_paper import get_problem
from repro_torch.core.geometry import projection_matrices, standard_geometry
from repro_torch.kernels import backproject_onehot as ko
from repro_torch.kernels import backproject_subline as ks

from test_torch_cuda import TWO_HOT_PATHS
from test_torch_subline_tiles import WINDOW_CASES, _tiles, _window

NH = 16
ROW_BAR = 1e-7
# row coordinates at the detector's edges, each with whether the sample is
# on the detector (floor(y) in [0, nh-2])
EPS = float(np.spacing(np.float32(NH - 1)))
EDGE_ROWS = {
    "integer": ([0.0, 3.0, 7.0, 12.0], True),
    "last_pair": ([NH - 2.0, NH - 2.0 + 0.25, NH - 2.0 + 0.5], True),
    "just_below_top": ([NH - 1.0 - EPS, NH - 1.0 - 2 * EPS], True),
    "top": ([NH - 1.0, NH - 1.0 + 0.5, NH + 3.0], False),
    "negative": ([-EPS, -0.5, -1.0, -7.25], False),
    "interior": ([0.5, 1.75, 6.125, 9.999], True),
}


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors only: no kernel is ever launched. The tensors here are
    small, so one thread (a pool's wake-up costs more than the work)."""
    ks.reset_launches()
    ko.reset_launches()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    assert sum(ks.LAUNCHES.values()) + sum(ko.LAUNCHES.values()) == 0


def _twohot_sparse(sm, y, nh):
    """The two-hot form as the kernel takes it: the two nonzero terms of
    the dense row, (1 - dy) * row[iyc] rounded, then + dy * row[iyc + 1];
    iyc = 0 and the value 0 off the detector (a NaN y included)."""
    y0 = torch.floor(y)
    dy = y - y0
    ok = (y0 >= 0) & (y0 <= nh - 2)
    iyc = torch.where(ok, y0, 0.0).long()
    v = (1.0 - dy) * torch.gather(sm, 1, iyc) + dy * torch.gather(sm, 1,
                                                                  iyc + 1)
    return torch.where(ok, v, 0.0)


def _rows_and_y(kind, lines=8, seed=0):
    rng = np.random.RandomState(seed)
    sm = torch.from_numpy((rng.rand(lines, NH) * 2 - 1).astype(np.float32))
    ys, _ = EDGE_ROWS[kind]
    return sm, torch.tensor(ys, dtype=torch.float32).repeat(lines, 1)


@pytest.mark.parametrize("kind", sorted(EDGE_ROWS))
def test_sparse_two_hot_equals_dense_contraction_on_edge_rows(kind):
    sm, y = _rows_and_y(kind)
    _, on_detector = EDGE_ROWS[kind]
    for k_chunk in (1, 2, 128):
        dense = ko._interp_onehot(sm, y, NH, k_chunk)
        sparse = _twohot_sparse(sm, y, NH)
        assert bool(torch.isfinite(dense).all())
        assert bool((sparse[dense == 0] == 0).all())
        assert float((sparse - dense).abs().max()) <= ROW_BAR
        assert bool((dense != 0).any()) == on_detector


def test_invalid_line_adds_an_exact_zero():
    """The tiled kernel gives an invalid line y = NaN on its checked
    path; the two-hot form takes it as off the detector and gives an
    exact 0 (no row index is taken from it), which the accumulation
    ``fma(0, w, acc)`` adds without a bit of change. The dense form takes
    no NaN y (0 * NaN = NaN): the plain version weights an invalid line by
    w = 0 and the replaced kernel skipped it, an exact zero either way."""
    sm, y = _rows_and_y("interior")
    nan = torch.full_like(y, float("nan"))
    assert torch.equal(_twohot_sparse(sm, nan, NH), torch.zeros_like(y))
    assert torch.equal(ko._interp_onehot(sm, y, NH, 4) * 0.0,
                       torch.zeros_like(y))


def test_sparse_two_hot_equals_dense_on_random_rows():
    """Every row pair of the detector, y drawn across [-2, nh + 1)."""
    rng = np.random.RandomState(1)
    sm = torch.from_numpy((rng.rand(64, NH) * 2 - 1).astype(np.float32))
    y = torch.from_numpy((rng.rand(64, 40) * (NH + 3) - 2).astype(
        np.float32))
    dense = ko._interp_onehot(sm, y, NH, 8)
    sparse = _twohot_sparse(sm, y, NH)
    assert bool((sparse[dense == 0] == 0).all())
    assert float((sparse - dense).abs().max()) <= ROW_BAR
    on = (torch.floor(y) >= 0) & (torch.floor(y) <= NH - 2)
    assert bool(on.any()) and bool((~on).any())


def test_non_finite_row_is_where_the_forms_differ():
    """The one input where dropping the zero terms changes the function:
    the dense form spreads an inf in the sub-line to every plane of the
    line (0 * inf = NaN where the plane does not sample it); the two-hot
    form, like the oracle, keeps it to the planes that sample it."""
    sm = torch.ones((1, NH))
    sm[0, 9] = float("inf")
    y = torch.tensor([[2.5, 8.5, 9.0, 12.5]])
    dense = ko._interp_onehot(sm, y, NH, 4)
    sparse = _twohot_sparse(sm, y, NH)
    assert bool(torch.isnan(dense[0, [0, 3]]).all())
    assert torch.equal(sparse[0, [0, 3]], torch.ones(2))
    assert bool(torch.isinf(dense[0, 1:3]).all())
    assert bool(torch.isinf(sparse[0, 1:3]).all())


# ---------------------------------------------------------------------------
# the rows of A inside the tile windows
# ---------------------------------------------------------------------------

def _two_hot_rows(y, line_ok, nh):
    """The columns of each sample's row of the dense ``A``: iyc and
    iyc + 1 for the samples whose row is not zero (the line valid and
    floor(y) in [0, nh-2]), as ``_interp_onehot`` builds them."""
    y0 = torch.floor(y)
    ok = line_ok[:, None] & (y0 >= 0) & (y0 <= nh - 2)
    iyc = torch.where(ok, y0, 0.0).long()
    return iyc[ok], iyc[ok] + 1


def _check_tile_windows(img_shape, mat, shape, views, tiles):
    """For every k chunk of the plan, tile of ``tiles`` and view of
    ``views``: the rows of A of the chunk's direct samples lie in the
    window's direct rows [d0, d0 + nd), those of its mirrored samples in
    the mirrored rows [m0, m0 + nm) (in the direct ones where the two
    segments merged). Returns how many samples were checked."""
    ni, nj, nz = shape
    _, nw, nh = img_shape
    plan = ks.launch_plan(shape, nh, ks.plane_rows(mat, shape))
    kh, khp = nz // 2, nz - nz // 2
    checked = 0
    for k0 in range(0, khp, plan.k_chunk):
        kd1, km1 = min(k0 + plan.k_chunk, khp), min(k0 + plan.k_chunk, kh)
        kd = torch.arange(k0, kd1, dtype=torch.float32)
        for i0, j0, ti, tj in tiles:
            i, j = ks._line_grid(ti, tj, "cpu", origin=(i0, j0))
            for s in views:
                m = mat[s]
                ok, f, ixc, dx = ks._line_scalars(m, i, j, nw)
                a = (m[1, 0] * i + m[1, 1] * j + m[1, 3]) * f
                b = m[1, 2] * f
                _, nc, segs, _ = _window(ok, ixc, a, b, k0, kd1, km1, nh,
                                         plan.win_rows, nh % 4 == 0)
                (d0, nd), (m0, nm) = segs
                y = a[:, None] + b[:, None] * kd
                lo, hi = _two_hot_rows(y, ok, nh)
                assert bool(((lo >= d0) & (hi < d0 + nd)).all()), \
                    (k0, i0, j0, s)
                checked += lo.numel()
                if km1 > k0:
                    y_m = (nh - 1.0) - y[:, :km1 - k0]
                    lo, hi = _two_hot_rows(y_m, ok, nh)
                    r0, n_r = (m0, nm) if nm else (d0, nd)
                    assert bool(((lo >= r0) & (hi < r0 + n_r)).all()), \
                        (k0, i0, j0, s, "mirror")
                    checked += lo.numel()
                if nc == 0:
                    assert not bool(ok.any())
    return checked


@pytest.mark.parametrize("n,det,nproj", WINDOW_CASES)
def test_two_hot_rows_lie_in_the_tile_windows_at_the_sweep(n, det, nproj):
    g = standard_geometry(n=n, n_det=det, n_proj=nproj)
    mats = projection_matrices(g, device="cpu")
    shape = g.volume_shape_xyz
    checked = _check_tile_windows((nproj, g.nw, g.nh), mats, shape,
                                  range(nproj), list(_tiles(*shape[:2])))
    assert checked > 0


@pytest.mark.parametrize("label", ["P4", "P5", "P7", "P8"])
def test_two_hot_rows_lie_in_the_tile_windows_at_paper_problems(label):
    """At the paper's sizes, on five tiles (the four corners and the
    centre) and every 4th view: the magnified P4, P7, P8 take shorter k
    chunks and, for their columns, the global-read path; the rows are
    windowed all the same."""
    geom = get_problem(label).geometry()
    mats = projection_matrices(geom, device="cpu")
    ni, nj, nz = geom.volume_shape_xyz
    ti, tj = ks.TILE
    corners = [(0, 0), (0, nj - tj), (ni - ti, 0), (ni - ti, nj - tj),
               ((ni // 2) // ti * ti, (nj // 2) // tj * tj)]
    tiles = [(i0, j0, ti, tj) for i0, j0 in corners]
    checked = _check_tile_windows((geom.n_proj, geom.nw, geom.nh), mats,
                                  (ni, nj, nz), range(0, geom.n_proj, 4),
                                  tiles)
    assert checked > 0


# ---------------------------------------------------------------------------
# the card tests' shapes run every path of stage 2
# ---------------------------------------------------------------------------

def _stage2_paths(nz, det, nproj, lines):
    """The stage-2 paths the tiled kernel takes at a card test's shape,
    by (tile, view, k chunk, warp): "inside" (every plane of the chunk
    full and every sample of the warp's 8 lines on the detector: no
    checks), "checked", or "rows" (a window taller than its slot, line by
    line at full height)."""
    g = dataclasses.replace(standard_geometry(n=nz, n_det=det,
                                              n_proj=nproj),
                            nx=lines, ny=lines)
    mats = projection_matrices(g, device="cpu")
    ni, nj, _ = g.volume_shape_xyz
    nh = g.nh
    plan = ks.launch_plan(g.volume_shape_xyz, nh,
                          ks.plane_rows(mats, g.volume_shape_xyz))
    kh, khp = nz // 2, nz - nz // 2
    paths = set()
    for k0 in range(0, khp, plan.k_chunk):
        kd1, km1 = min(k0 + plan.k_chunk, khp), min(k0 + plan.k_chunk, kh)
        full = k0 + plan.k_chunk <= kh
        ends = torch.tensor([k0, kd1 - 1], dtype=torch.float32)
        for i0, j0, ti, tj in _tiles(ni, nj):
            i, j = ks._line_grid(ti, tj, "cpu", origin=(i0, j0))
            for s in range(nproj):
                m = mats[s]
                ok, f, ixc, dx = ks._line_scalars(m, i, j, g.nw)
                a = (m[1, 0] * i + m[1, 1] * j + m[1, 3]) * f
                b = m[1, 2] * f
                _, _, _, path = _window(ok, ixc, a, b, k0, kd1, km1, nh,
                                        plan.win_rows, nh % 4 == 0)
                if path == "rows":
                    paths.add("rows")
                    continue
                y = a[:, None] + b[:, None] * ends
                y0 = torch.floor(torch.cat([y, (nh - 1.0) - y], 1))
                on = ok & ((y0 >= 0) & (y0 <= nh - 2)).all(1)
                for w in range(ti):       # warp w: the tile's line row w
                    inside = full and bool(on[w * tj:(w + 1) * tj].all()) \
                        and tj == ks.TILE[1]
                    paths.add("inside" if inside else "checked")
    return paths


def test_card_shapes_run_every_stage2_path_of_the_two_hot_form():
    paths = {}
    for nz, det, nproj, lines in TWO_HOT_PATHS:
        paths[(nz, det)] = _stage2_paths(nz, det, nproj, lines)
    assert set().union(*paths.values()) == {"inside", "checked", "rows"}, \
        paths
