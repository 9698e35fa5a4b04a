"""The tiled K1/K2 kernel's launch plan and window arithmetic, on the CPU.

The CUDA kernel (``csrc/backproject_subline.cu``, ``tile_kernel``) runs
only on the card; what surrounds it is checked here:

- the launch plan of ``backproject_subline.launch_plan``, with the rows
  a plane spans read from the launch's matrices (``plane_rows``), so the
  Z-slabs of a tiled walk take the plan of the volume they belong to, and
  the kernel's shared-memory layout mirrored here (``tests/test_torch_cuda.py``
  holds the mirror against the kernel's own on the card), fits a block's
  227 KB and leaves at least two blocks per SM at every deep column that
  ``chip_smoke.py`` runs and at P1-P10;
- each (tile, view, k chunk) window, computed as the kernel computes it,
  fits the plan's window slot, except in the cases named below, which take
  the kernel's global-read path;
- a plain PyTorch mirror of the kernel's window-relative indexing, kept
  here and not in the package, equals ``backproject_subline_plain`` bit
  for bit and the JAX oracle within 1e-5. The mirror asserts that every
  valid sample reads inside its window's rows, and its full-height path
  leaves the other rows NaN, so a sample that read past them would show.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.ct_paper import PROBLEMS
from repro_torch.core.geometry import projection_matrices, standard_geometry
from repro_torch.kernels import backproject_subline as ks

from conftest import rel_rmse
from test_torch_backproject import SWEEP, _case

BAR = 1e-5
# chip_smoke.py's deep columns (nz, detector, views) on 16 x 16 lines, with
# its K1/K2-only ones: past the banded kernel's nz=2048, and fine detectors
DEPTHS = [(70, 64, 4), (129, 96, 5), (200, 128, 4), (500, 256, 3),
          (1000, 512, 4), (1301, 1024, 8), (2049, 1024, 4),
          (2600, 1024, 4), (300, 900, 4), (100, 900, 4)]
WINDOW_CASES = SWEEP + [(15, 20, 6), (16, 48, 4)]
# (n, det, views) whose windows overflow the slot on some (tile, view):
# a detector pixel far finer than a voxel, so an 8 x 8 tile spans more
# than 16 columns (31 and 21). Those views take the global-read path.
GLOBAL_READ = {(8, 32, 3), (16, 48, 4)}
# P1-P10 whose windows (from the tile corners) overflow the slot's 16
# columns: twice or four times as many detector pixels as voxels across
# (P4, P7, P8). Their views blend the window rows of each line's two
# columns from global memory; their rows fit at every problem.
GLOBAL_READ_P = {"P4", "P7", "P8"}


# the tiled kernel's shared memory (``tiled::smem_bytes``): per warp the
# window rows of its 8 lines or one detector column, whichever is larger;
# a ring of 2 window slots of WIN_COLS columns, with an 8-int descriptor
# each; 3 slots of 64
# lines x 5 words of scalars and 8 warps' flags; 2 x 8 warps x 6 ints of
# window bounds. And what one SM of an H100 holds: 228 KB of shared
# memory, 1 KB of it reserved for each resident block, 2048 threads.
WIN_COLS, RING, PAR_SLOTS = 16, 2, 3
SMEM_PER_SM, SMEM_RESERVED, BLOCKS_BY_THREADS = 233472, 1024, 2048 // 256


def smem_bytes(nh, win_rows):
    ti, tj = ks.TILE
    warp = max(tj * win_rows, (nh + 3) & ~3)
    return 4 * (ti * warp + RING * (WIN_COLS * win_rows + 8)
                + PAR_SLOTS * (ti * tj * 5 + ti) + 2 * ti * 6)


def blocks_by_smem(smem):
    return min(BLOCKS_BY_THREADS, SMEM_PER_SM // (smem + SMEM_RESERVED))


@pytest.fixture(autouse=True)
def _no_launches():
    ks.reset_launches()
    yield
    assert sum(ks.LAUNCHES.values()) == 0


def _plan_cases():
    cases = [((16, 16, nz), det) for nz, det, _ in DEPTHS]
    cases += [((p.vol,) * 3, p.det) for p in PROBLEMS]
    return cases


@pytest.mark.parametrize("shape,nh", _plan_cases())
def test_launch_plan_fits_and_keeps_blocks_per_sm(shape, nh):
    plan = ks.launch_plan(shape, nh)
    smem = smem_bytes(nh, plan.win_rows)
    assert smem <= ks.SMEM_PER_BLOCK
    assert blocks_by_smem(smem) >= 2
    assert plan.win_rows % 4 == 0
    ni, nj, nz = shape
    khp = nz - nz // 2
    assert plan.k_chunk == 32 * plan.kpt
    assert plan.grid == (-(-ni // 8) * -(-nj // 8), -(-khp // plan.k_chunk))
    assert (plan.grid[1] - 1) * plan.k_chunk < khp
    # the smallest chunk that holds the direct half (128 planes past it),
    # halved only while it spans more than 128 detector rows at the
    # m = ceil(nh / nz) rows a plane of a detector that frames the volume;
    # a slot holds the chunk's rows at that rate
    whole = 1 if khp <= 32 else 2 if khp <= 64 else 4
    m = -(-nh // nz)
    assert plan.kpt in (1, 2, 4) and plan.kpt <= whole
    assert plan.k_chunk * m <= 128 or plan.kpt == 1
    assert plan.kpt == whole or 2 * plan.k_chunk * m > 128
    assert plan.win_rows == 2 * plan.k_chunk * min(m, 4) + 16


def test_launch_plan_takes_any_nz_a_grid_holds():
    # past the banded kernel's 2048 planes
    assert ks.launch_plan((8, 8, 100_000), 64).grid == (1, 391)
    assert ks.launch_plan((8, 8, 2 * 128 * 65535), 64).grid == (1, 65535)
    with pytest.raises(ValueError, match="k chunks"):
        ks.launch_plan((8, 8, 2 * 128 * 65535 + 2), 64)
    # a detector too tall for one block's column buffers: the kernel's
    # launch refuses it (on the card, tests/test_torch_cuda.py)
    plan = ks.launch_plan((8, 8, 8), 8192)
    assert smem_bytes(8192, plan.win_rows) \
        > ks.SMEM_PER_BLOCK


# ---------------------------------------------------------------------------
# the kernel's window arithmetic, mirrored in PyTorch
# ---------------------------------------------------------------------------

def _seg(lo, hi1, nh, vec):
    """tiled::seg_len: rows [lo, hi1) widened to whole 16-byte copies."""
    if hi1 <= lo:
        return lo, 0
    if vec:
        lo &= ~3
        hi1 = min((hi1 + 3) & ~3, nh)
    return lo, hi1 - lo


def _touch(y_first, y_last, nh):
    """tiled::touch_rows per line: the rows [lo, hi] the samples between
    two monotone ends reach, or None."""
    lo = torch.clamp(torch.floor(torch.minimum(y_first, y_last)), min=0.0)
    hi = torch.clamp(torch.floor(torch.maximum(y_first, y_last)),
                     max=float(nh - 2))
    return lo, hi + 1, lo <= hi


def _window(ok, ixc, a, b, k0, kd1, km1, nh, win_rows, vec):
    """The descriptor ``issue_window`` writes for one tile, view and k
    chunk: (c_lo, nc, ((d0, nd), (m0, nm)), path), the path "window",
    "cols" (too many columns: the rows are read from the image) or "rows"
    (too many rows: line by line, full height)."""
    if not bool(ok.any()):
        return 0, 0, ((0, 0), (0, 0)), "window"
    c_lo = int(ixc[ok].min())
    nc = int(ixc[ok].max()) + 2 - c_lo
    segs = []
    ends = [(a + b * k0, a + b * (kd1 - 1), kd1 > k0)]
    ytop = nh - 1.0
    ends.append((ytop - (a + b * k0), ytop - (a + b * (km1 - 1)), km1 > k0))
    for y_first, y_last, any_k in ends:
        lo, hi1, has = _touch(y_first, y_last, nh)
        has = has & ok
        if any_k and bool(has.any()):
            segs.append(_seg(int(lo[has].min()), int(hi1[has].max()) + 1,
                             nh, vec))
        else:
            segs.append((0, 0))
    (d0, nd), (m0, nm) = segs
    if nd and nm and m0 <= d0 + nd and d0 <= m0 + nm:
        r1 = max(d0 + nd, m0 + nm)
        d0 = min(d0, m0)
        nd, nm = r1 - d0, 0
    path = ("rows" if nd + nm > win_rows else
            "cols" if nc > WIN_COLS else "window")
    return c_lo, nc, ((d0, nd), (m0, nm)), path


def _tiles(ni, nj):
    ti, tj = ks.TILE
    for i0 in range(0, ni, ti):
        for j0 in range(0, nj, tj):
            yield i0, j0, min(ti, ni - i0), min(tj, nj - j0)


def _interp_at(sm, y, nh, base, n_seg):
    """``ks._interp`` of detector rows y from a buffer whose column c holds
    detector row base + c, as the kernel addresses a line's window rows
    through ``row - d0`` (direct) and ``row + nd - m0`` (mirrored). Every
    valid sample must fall inside its segment [base, base + n_seg)."""
    y0 = torch.floor(y)
    dy = y - y0
    valid = (y0 >= 0) & (y0 <= nh - 2)
    iy = torch.where(valid, y0, float(base)).long() - base
    assert bool(((iy >= 0) & (iy + 1 < n_seg))[valid].all()), \
        "a sample reads past its window"
    iy = torch.clamp(iy, 0, max(sm.shape[1] - 2, 0))
    v = (torch.gather(sm, 1, iy) * (1.0 - dy)
         + torch.gather(sm, 1, iy + 1) * dy)
    return torch.where(valid, v, 0.0)


class ImageColumns:
    """Where K1-K4 read an image column: in ``img_t`` itself. The banded
    K5/K6 read through their band layout instead
    (``tests/test_torch_banded_tiles.py``)."""

    def __init__(self, img_t):
        self.img_t = img_t

    def drop(self, s, i, j, ok, ixc):
        """The lines of view ``s`` that stay valid: all of them."""
        return ok

    def window(self, s, c_lo, nc):
        """The columns [c_lo, c_lo + nc) that ``issue_window`` copies."""
        return self.img_t[s, c_lo:c_lo + nc]

    def columns(self, s, ixc):
        """Each line's two columns, as the global-read paths read them."""
        return self.img_t[s][ixc], self.img_t[s][ixc + 1]


def _mirror(img_t, mat, shape, windows=None, win_rows=None, source=None):
    """K1/K2 as the tiled kernel computes them: per k chunk, tile and
    view, each line's window rows of its two columns (read from the
    window, or from the image where the window has too many columns)
    blended into the line's buffer, addressed by detector row in stage 2
    over the chunk's direct planes and their mirrors. A view whose window
    has too many rows runs line by line on a full-height sub-line whose
    other rows are NaN. An invalid line samples y = NaN, as in the kernel.
    Records each window in ``windows``; ``win_rows`` replaces the plan's
    window height; ``source`` says where the columns are read and which
    lines are dropped (by default :class:`ImageColumns`)."""
    ni, nj, nz = shape
    n_proj, nw, nh = img_t.shape
    source = source or ImageColumns(img_t)
    plan = ks.launch_plan(shape, nh, ks.plane_rows(mat, shape))
    win_rows = win_rows or plan.win_rows
    vec = nh % 4 == 0
    kh, khp = nz // 2, nz - nz // 2
    vol = torch.zeros(shape, dtype=torch.float32)
    for k0 in range(0, khp, plan.k_chunk):
        kd1, km1 = min(k0 + plan.k_chunk, khp), min(k0 + plan.k_chunk, kh)
        kd = torch.arange(k0, kd1, dtype=torch.float32)
        for i0, j0, ti, tj in _tiles(ni, nj):
            i, j = ks._line_grid(ti, tj, "cpu", origin=(i0, j0))
            acc = torch.zeros((ti * tj, nz), dtype=torch.float32)
            for s in range(n_proj):
                m = mat[s]
                ok, f, ixc, dx = ks._line_scalars(m, i, j, nw)
                ok = source.drop(s, i, j, ok, ixc)
                a = torch.where(ok, (m[1, 0] * i + m[1, 1] * j + m[1, 3]) * f,
                                float("nan"))
                b = m[1, 2] * f
                c_lo, nc, segs, path = _window(ok, ixc, a, b, k0, kd1, km1,
                                               nh, win_rows, vec)
                (d0, nd), (m0, nm) = segs
                if windows is not None:
                    windows.append((nc, nd + nm, path))
                if nc == 0:
                    continue
                rows = torch.tensor(list(range(d0, d0 + nd))
                                    + list(range(m0, m0 + nm)),
                                    dtype=torch.long)
                if path == "window":
                    win = source.window(s, c_lo, nc)[:, rows]
                    col = torch.where(ok, ixc - c_lo, 0)
                    c0, c1 = win[col], win[col + 1]
                else:               # each line's columns, from the image
                    c0, c1 = source.columns(s, torch.where(ok, ixc, 0))
                    c0, c1 = c0[:, rows], c1[:, rows]
                sm = c0 * (1.0 - dx)[:, None] + c1 * dx[:, None]  # stage 1
                if path == "rows":  # full height, NaN off the window rows
                    full = torch.full((ti * tj, nh), float("nan"))
                    full[:, rows] = sm
                    sm, base_d, base_m, n_d, n_m = full, 0, 0, nh, nh
                else:
                    base_d, n_d = d0, nd
                    base_m, n_m = (m0 - nd, nd + nm) if nm else (d0, nd)
                w = torch.where(ok, f * f, 0.0)[:, None]
                y = a[:, None] + b[:, None] * kd              # stage 2
                acc[:, k0:kd1] += _interp_at(sm, y, nh, base_d, n_d) * w
                if km1 > k0:
                    y_m = (nh - 1.0) - y[:, :km1 - k0]
                    acc[:, nz - km1:nz - k0] += (_interp_at(
                        sm, y_m, nh, base_m, n_m) * w).flip(1)
            acc = acc.reshape(ti, tj, nz)
            vol[i0:i0 + ti, j0:j0 + tj, k0:kd1] = acc[..., k0:kd1]
            if km1 > k0:
                vol[i0:i0 + ti, j0:j0 + tj, nz - km1:nz - k0] = \
                    acc[..., nz - km1:nz - k0]
    return vol


@pytest.mark.parametrize("n,det,nproj", WINDOW_CASES)
def test_mirror_of_window_indexing_equals_plain_and_oracle(n, det, nproj):
    c = _case(n, det, nproj)
    plain = ks.backproject_subline_plain(c.img_t, c.mats, c.shape)
    mirror = _mirror(c.img_t, c.mats, c.shape)
    assert torch.equal(mirror, plain)
    assert rel_rmse(mirror.numpy(), c.ref) < BAR
    if n % 2:
        mid = n // 2
        assert rel_rmse(mirror[..., mid].numpy(), c.ref[..., mid]) < BAR


@pytest.mark.parametrize("n,det,nproj", [(16, 24, 6), (13, 17, 5)])
def test_mirror_of_the_full_height_path(n, det, nproj):
    """Windows too tall for their slot (a slot of 12 rows here) run line
    by line on a full-height sub-line: the same volume bit for bit."""
    c = _case(n, det, nproj)
    windows = []
    mirror = _mirror(c.img_t, c.mats, c.shape, windows=windows, win_rows=12)
    assert any(path == "rows" for _, _, path in windows)
    assert torch.equal(
        mirror, ks.backproject_subline_plain(c.img_t, c.mats, c.shape))


@pytest.mark.parametrize("lines,nz,det,paths", [
    ((9, 17), 300, 96, {"window"}),
    ((8, 8), 520, 130, {"window"}),
    ((16, 16), 300, 900, {"cols"}),
    ((16, 16), 100, 900, {"cols", "rows"}),
])
def test_mirror_across_k_chunks_and_unaligned_rows(lines, nz, det, paths):
    """Several k chunks, ragged tiles, a detector height that is no
    multiple of 4 (4-byte copies, unaligned rows), and detectors of 2.4
    and 7.2 pixels a voxel: the windows overflow their columns, and at 7.2
    (more rows a plane than a slot holds, 4) their rows too (the two
    global-read paths, as the card runs them in chip_smoke.py)."""
    import dataclasses
    g = dataclasses.replace(standard_geometry(n=nz, n_det=det, n_proj=4),
                            nx=lines[0], ny=lines[1])
    img = np.random.RandomState(3).rand(4, g.nh, g.nw).astype(np.float32)
    img_t = torch.from_numpy(img).transpose(1, 2).contiguous()
    mats = projection_matrices(g, device="cpu")
    shape = g.volume_shape_xyz
    assert ks.launch_plan(shape, g.nh).grid[1] > 1
    windows = []
    assert torch.equal(_mirror(img_t, mats, shape, windows=windows),
                       ks.backproject_subline_plain(img_t, mats, shape))
    assert {path for nc, _, path in windows if nc} == paths


@pytest.mark.parametrize("n,det,nproj", WINDOW_CASES)
def test_every_window_fits_unless_named(n, det, nproj):
    """The exact window of every tile, view and k chunk at the sweep
    geometries: it fits the slot, or the case is named in GLOBAL_READ."""
    c = _case(n, det, nproj)
    windows = []
    _mirror(c.img_t, c.mats, c.shape, windows=windows)
    n_global = sum(path != "window" for _, _, path in windows)
    if (n, det, nproj) in GLOBAL_READ:
        assert n_global > 0
    else:
        assert n_global == 0, max(windows)
    plan = ks.launch_plan(c.shape, det, ks.plane_rows(c.mats, c.shape))
    for nc, n_rows, path in windows:
        assert (path == "window") == (nc <= WIN_COLS
                                      and n_rows <= plan.win_rows)


def _corner_windows(prob, every=16):
    """Columns and rows of each (tile, k chunk, view) window at the paper's
    problem, from the tile corners in float64 as ``tile_bands`` takes
    them (x and y are linear-fractional in i, j, so their extremes over a
    tile sit at its corners; y is monotone in k). Returns the largest
    column count and row count, with the plan."""
    geom = prob.geometry()
    ni, nj, nz = geom.volume_shape_xyz
    nh = geom.nh
    plan = ks.launch_plan((ni, nj, nz), nh)
    mat = projection_matrices(geom, device="cpu")[::every].double()
    ti, tj = ks.TILE
    i = torch.arange(0, ni, ti, dtype=torch.float64)
    j = torch.arange(0, nj, tj, dtype=torch.float64)
    corners = [(i, j), (i, torch.clamp(j + tj - 1, max=nj - 1)),
               (torch.clamp(i + ti - 1, max=ni - 1), j),
               (torch.clamp(i + ti - 1, max=ni - 1),
                torch.clamp(j + tj - 1, max=nj - 1))]
    m = mat[:, None, None]                                   # (v, 1, 1, 3, 4)
    xs, zs, ys = [], [], []
    for ci, cj in corners:
        ci, cj = ci[None, :, None], cj[None, None, :]
        z = m[..., 2, 0] * ci + m[..., 2, 1] * cj + m[..., 2, 3]
        xs.append((m[..., 0, 0] * ci + m[..., 0, 1] * cj + m[..., 0, 3]) / z)
        zs.append(z)
        ys.append((m[..., 1, 0] * ci + m[..., 1, 1] * cj + m[..., 1, 3], z))
    x = torch.stack(xs)
    cols = (torch.floor(x.amax(0)) - torch.floor(x.amin(0)) + 2).max()
    kh, khp = nz // 2, nz - nz // 2
    worst_rows = 0
    for k0 in range(0, khp, plan.k_chunk):
        kd1, km1 = min(k0 + plan.k_chunk, khp), min(k0 + plan.k_chunk, kh)
        n_rows = 0
        segs = []
        for k_lo, k_hi, mirror in ((k0, kd1 - 1, False),
                                   (k0, km1 - 1, True)):
            if k_hi < k_lo:
                continue
            yk = torch.stack([(num + m[..., 1, 2] * k) / z
                              for num, z in ys for k in (k_lo, k_hi)])
            if mirror:
                yk = (nh - 1.0) - yk
            lo = torch.clamp(torch.floor(yk.amin(0)), min=0)
            hi = torch.clamp(torch.floor(yk.amax(0)), max=nh - 2) + 2
            segs.append((torch.div(lo, 4, rounding_mode="floor") * 4,
                         torch.clamp(torch.ceil(hi / 4) * 4, max=nh)))
        rows = sum(torch.clamp(h - l, min=0) for l, h in segs)
        if len(segs) == 2:       # merged where the two segments meet
            (l0, h0), (l1, h1) = segs
            meet = (l1 <= h0) & (l0 <= h1)
            rows = torch.where(meet, torch.maximum(h0, h1)
                               - torch.minimum(l0, l1), rows)
        n_rows = int(rows.max())
        worst_rows = max(worst_rows, n_rows)
    return int(cols), worst_rows, plan


@pytest.mark.parametrize("prob", PROBLEMS, ids=[p.label for p in PROBLEMS])
def test_paper_problem_windows_fit_unless_named(prob):
    cols, rows, plan = _corner_windows(prob)
    assert rows <= plan.win_rows, (cols, rows)    # never line by line
    assert (cols <= WIN_COLS) == (prob.label not in GLOBAL_READ_P), cols


def test_p5_samples_lie_on_the_detector_rows():
    """At P5 the whole volume projects inside rows [0, nh-2] in every view
    (y is linear-fractional in i, j and monotone in k, so the volume's
    corners bound it), so every full k chunk takes the kernel's stage 2
    without range checks."""
    geom = [p for p in PROBLEMS if p.label == "P5"][0].geometry()
    m = projection_matrices(geom, device="cpu").double()
    n = geom.nx - 1
    for i in (0, n):
        for j in (0, n):
            z = m[:, 2, 0] * i + m[:, 2, 1] * j + m[:, 2, 3]
            assert bool((z > 0).all())
            for k in (0, geom.nz - 1):
                y = (m[:, 1, 0] * i + m[:, 1, 1] * j + m[:, 1, 2] * k
                     + m[:, 1, 3]) / z
                assert float(torch.floor(y).min()) >= 1
                assert float(torch.floor(y).max()) <= geom.nh - 3


# ---------------------------------------------------------------------------
# the plan of a Z-slab: rows a plane spans read from the matrices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prob", PROBLEMS, ids=[p.label for p in PROBLEMS])
def test_plane_rows_plan_equals_the_depth_rule_untiled(prob):
    """On the paper's problems the rows read from the matrices give the
    plan that m = ceil(nh / nz) gives: the untiled launches keep theirs."""
    g = prob.geometry()
    mats = projection_matrices(g, device="cpu")
    shape = g.volume_shape_xyz
    assert ks.launch_plan(shape, g.nh, ks.plane_rows(mats, shape)) == \
        ks.launch_plan(shape, g.nh)


# (problem, tiling, proj_batch, {padded call shape: (kpt, k chunks) of
# the matrices' plan, and kpt of the depth rule m = ceil(nh / call nz)})
SLABS = [("P5", (256, 256, 96), 128, {(256, 256, 192): (4, 1, 1),
                                      (256, 256, 128): (2, 1, 1)}),
         ("P10", (650, 650, 325), None, {(652, 656, 650): (4, 3, 2)})]


@pytest.mark.parametrize("label,tile,proj_batch,want", SLABS,
                         ids=[c[0] for c in SLABS])
def test_slab_calls_take_the_plan_of_their_volume(label, tile, proj_batch,
                                                  want):
    """Every step and chunk of the tiled walks chip_smoke.py runs: the
    paired calls (virtual depth 2 tk) and the centered slab get the
    smallest chunk that holds their direct half, as the untiled volume
    does, where the depth rule would read 3-4 rows a plane and cut the
    chunk (P5 kpt 1, P10 kpt 2)."""
    from repro_torch.configs.ct_paper import get_problem
    from repro_torch.core.tiling import translate_matrices
    from repro_torch.runtime.planner import plan_reconstruction
    g = get_problem(label).geometry()
    mats = projection_matrices(g, device="cpu")
    plan = plan_reconstruction(g, "subline_pl", tile_shape=tile,
                               proj_batch=proj_batch)
    seen = set()
    for step in plan.steps:
        ni, nj, nz = step.call_shape
        shape = (-(-ni // 4) * 4, -(-nj // 8) * 8, nz)     # ops pads i/j
        mt = translate_matrices(mats, float(step.i0), float(step.j0),
                                float(step.k_off))
        for s0, s1 in plan.chunks:
            lp = ks.launch_plan(shape, g.nh, ks.plane_rows(mt[s0:s1], shape))
            kpt, n_chunks, depth_kpt = want[shape]
            assert (lp.kpt, lp.grid[1]) == (kpt, n_chunks), (shape, lp)
            assert ks.launch_plan(shape, g.nh).kpt == depth_kpt
            seen.add(shape)
    assert seen == set(want)


def test_plane_rows_does_not_read_the_call_depth():
    g = standard_geometry(n=64, n_det=64, n_proj=8)
    mats = projection_matrices(g, device="cpu")
    assert ks.plane_rows(mats, (16, 24, 7)) == ks.plane_rows(mats,
                                                             (16, 24, 300))
    # the magnification of standard_geometry's detector: 0.8 nh / nz at
    # the rotation axis, more nearer the source
    assert ks.plane_rows(mats, g.volume_shape_xyz) == pytest.approx(0.8,
                                                                    rel=1e-5)


def test_mirror_of_a_paired_slab_call_fits_its_windows():
    """A mirror-paired call of a tiled walk (translated matrices, virtual
    depth 2 tk = 96 of a 256-plane volume): the matrices' plan (kpt 2,
    where the depth rule gives kpt 1) keeps every window in its slot, and
    the kernel's indexing gives the plain version's volume bit for bit."""
    from repro_torch.core.tiling import translate_matrices
    g = standard_geometry(n=256, n_det=256, n_proj=4)
    img = np.random.RandomState(5).rand(4, g.nh, g.nw).astype(np.float32)
    img_t = torch.from_numpy(img).transpose(1, 2).contiguous()
    mt = translate_matrices(projection_matrices(g, device="cpu"), 64.0,
                            96.0, 40.0)
    shape = (16, 16, 96)
    assert ks.launch_plan(shape, g.nh, ks.plane_rows(mt, shape)).kpt == 2
    assert ks.launch_plan(shape, g.nh).kpt == 1
    windows = []
    mirror = _mirror(img_t, mt, shape, windows=windows)
    assert {path for nc, _, path in windows if nc} == {"window"}
    assert torch.equal(mirror, ks.backproject_subline_plain(img_t, mt, shape))
