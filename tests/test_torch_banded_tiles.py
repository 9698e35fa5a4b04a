"""The banded K5/K6 on the tiled kernel, on the CPU.

K5/K6 run the tiled K1/K2 kernel (``tile_kernel`` in
``csrc/backproject_subline.cu``) under K1's launch plan, with the band
layout ``img_b (np, n_bands, 2*bw, nh)`` as its column source. The kernel
runs only on the card; what it rests on is checked here, with a plain
PyTorch mirror of its banded indexing kept in this file
(:class:`BandColumns`, a column source for the tile mirror of
``tests/test_torch_subline_tiles.py``):

- ``line_params`` drops a line of band tile (i // BI, j // BJ) for view
  ``s`` where ``rel = floor(x) - b*bw`` misses ``[0, 2*bw-2]``, ``b`` the
  band of the view's group;
- ``issue_window`` copies image column ``c`` from band ``c // bw`` at
  ``c % bw``, and the global-read paths read a line's two columns there
  too: every such column lies inside its band and holds ``img_t``'s value;
- those divisions (by the group, the band tile and bw) are multiply-shifts
  (``bp::FastDiv``), mirrored here and exact over [0, 2^31).

The mirror equals ``backproject_banded_plain`` bit for bit and the JAX
oracle within 1e-5 at the sweep shapes, (13, 17, 5) included, for bands
of (4, 8) and (8, 16) lines, for K5's and K6's band arrays; with a band
shifted one place right, which drops lines, it still equals the plain
version bit for bit, and the plain version equals the JAX package's own
``_banded_call`` / ``_banded_call_fused`` in interpret mode within 1e-5
(at an even nz, where those kernels are right).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.backproject_banded import _banded_call, _banded_call_fused

from repro_torch.kernels import backproject_banded as kb
from repro_torch.kernels import backproject_subline as ks

from conftest import rel_rmse
from test_torch_backproject import SWEEP, _case
from test_torch_subline_tiles import _mirror

BAR = 1e-5
BLOCKS = [(4, 8), (8, 16)]


class BandColumns:
    """Where K5/K6 read an image column, and which lines they drop: the
    kernel's banded indexing, on the CPU."""

    def __init__(self, img_t, img_b, band, block, bw, group):
        self.img_t, self.img_b, self.band = img_t, img_b, band
        self.block, self.bw, self.group = block, bw, group
        self.flat = img_b.reshape(img_b.shape[0], -1, img_b.shape[3])

    def drop(self, s, i, j, ok, ixc):
        """``line_params``: a line whose tile's band misses its columns
        is dropped for view ``s``."""
        bi, bj = self.block
        b = self.band[s // self.group][i.long() // bi, j.long() // bj].long()
        rel = ixc - b * self.bw
        return ok & (rel >= 0) & (rel <= 2 * self.bw - 2)

    def _src(self, c):
        """``src_col``: the column of the band layout that holds image
        column c (band c // bw at c % bw)."""
        band, rel = c // self.bw, c % self.bw
        assert bool(((rel >= 0) & (rel + 1 < 2 * self.bw)
                     & (band < self.img_b.shape[1])).all())
        return band * 2 * self.bw + rel

    def window(self, s, c_lo, nc):
        """``issue_window``'s copy of columns [c_lo, c_lo + nc)."""
        cols = self.flat[s][self._src(torch.arange(c_lo, c_lo + nc))]
        assert torch.equal(cols, self.img_t[s, c_lo:c_lo + nc])
        return cols

    def columns(self, s, ixc):
        """The global-read paths: each line's column and the one beside
        it in the band layout."""
        src = self._src(ixc)
        c0, c1 = self.flat[s][src], self.flat[s][src + 1]
        assert torch.equal(c0, self.img_t[s][ixc])
        assert torch.equal(c1, self.img_t[s][ixc + 1])
        return c0, c1


@pytest.fixture(autouse=True)
def _no_launches():
    """CPU tensors only: no kernel is ever launched."""
    ks.reset_launches()
    kb.reset_launches()
    yield
    assert sum(ks.LAUNCHES.values()) + sum(kb.LAUNCHES.values()) == 0


def _padded(shape, block):
    ni, nj, nz = shape
    return (-(-ni // block[0]) * block[0], -(-nj // block[1]) * block[1], nz)


def _banded(c, block, group, bw0=8):
    """K5's (group 1) or K6's band schedule on the block-padded volume."""
    pshape = _padded(c.shape, block)
    img_b, band, bw = kb.band_schedule(c.img_t, c.mats, pshape, block=block,
                                       bw=bw0, group=group)
    return pshape, img_b, band, bw


@pytest.mark.parametrize("n,det,nproj", SWEEP)
@pytest.mark.parametrize("block", BLOCKS)
def test_mirror_of_banded_indexing_equals_plain_and_oracle(n, det, nproj,
                                                           block):
    c = _case(n, det, nproj)
    for group in (1, nproj):
        pshape, img_b, band, bw = _banded(c, block, group)
        src = BandColumns(c.img_t, img_b, band, block, bw, group)
        mirror = _mirror(c.img_t, c.mats, pshape, source=src)
        plain = kb.backproject_banded_plain(img_b, c.mats, band, pshape,
                                            block=block, bw=bw, nw=det,
                                            group=group)
        assert torch.equal(mirror, plain), group
        out = mirror[:n, :n].numpy()
        assert rel_rmse(out, c.ref) < BAR, group
        if n % 2:
            mid = n // 2
            assert rel_rmse(out[..., mid], c.ref[..., mid]) < BAR, group


@pytest.mark.parametrize("n,det,nproj", [(16, 24, 6), (13, 17, 5)])
def test_mirror_of_the_global_paths_reads_the_bands(n, det, nproj):
    """Slots too short for the windows (12 rows): the views run line by
    line on full-height sub-lines read from the band layout, and give the
    plain version's volume bit for bit."""
    c = _case(n, det, nproj)
    block = (4, 8)
    pshape, img_b, band, bw = _banded(c, block, 1)
    windows = []
    mirror = _mirror(c.img_t, c.mats, pshape, windows=windows, win_rows=12,
                     source=BandColumns(c.img_t, img_b, band, block, bw, 1))
    assert any(path == "rows" for _, _, path in windows)
    assert torch.equal(mirror, kb.backproject_banded_plain(
        img_b, c.mats, band, pshape, block=block, bw=bw, nw=det))


def _shifted(c, block, group, bw=8):
    """Bands of ``bw`` columns (no band search: for a group of views they
    may be too narrow for the group's spread) from ``tile_bands``, each
    moved one place to the right (the last one kept), so that lines left
    of their band are dropped."""
    pshape = _padded(c.shape, block)
    nw = c.img_t.shape[1]
    img_b, n_bands = kb.band_layout(c.img_t, bw)
    band, _ = kb.tile_bands(c.mats, *pshape[:2], *block, bw, n_bands, nw,
                            group=group)
    return pshape, img_b, torch.clamp(band + 1, max=n_bands - 1), bw


@pytest.mark.parametrize("group", [1, 3])
def test_mirror_drops_the_lines_a_shifted_band_misses(group):
    c = _case(16, 24, 6)
    block = (4, 8)
    pshape, img_b, band, bw = _shifted(c, block, group)
    src = BandColumns(c.img_t, img_b, band, block, bw, group)
    mirror = _mirror(c.img_t, c.mats, pshape, source=src)
    plain = kb.backproject_banded_plain(img_b, c.mats, band, pshape,
                                        block=block, bw=bw, nw=24,
                                        group=group)
    assert torch.equal(mirror, plain)
    full = ks.backproject_subline_plain(c.img_t, c.mats, pshape)
    assert bool((mirror != full).any())
    assert float(mirror.abs().sum()) < float(full.abs().sum())


@pytest.mark.parametrize("group", [1, 3])
def test_plain_drops_lines_as_the_jax_kernel_does(group):
    """The port's plain version against the JAX package's own banded
    kernel (interpret mode) on the same band layout and shifted band."""
    c = _case(16, 24, 6)
    block = (4, 8)
    pshape, img_b, band, bw = _shifted(c, block, group)
    plain = kb.backproject_banded_plain(img_b, c.mats, band, pshape,
                                        block=block, bw=bw, nw=24,
                                        group=group)
    args = (jnp.asarray(img_b.numpy()), c.j_mats, jnp.asarray(band.numpy()),
            pshape)
    if group == 1:
        jout = _banded_call(*args, block=block, bw=bw, nw=24, interpret=True)
    else:
        jout = _banded_call_fused(*args, block=block, bw=bw, nw=24,
                                  nb=group, interpret=True)
    jout = np.asarray(jout)
    assert rel_rmse(plain.numpy(), jout) < BAR
    assert rel_rmse(jout, c.ref) > BAR      # lines were dropped


def _fast_div(n, d):
    """``bp::FastDiv`` of ``csrc/backproject_common.cuh`` in 32-bit
    unsigned arithmetic: the multiplier and shift its constructor picks,
    then (umulhi(n, mul) + n) >> shift."""
    shift = 0
    while (1 << shift) < d:
        shift += 1
    mul = (((1 << 32) * ((1 << shift) - d)) // d + 1) & 0xFFFFFFFF
    return (((n * mul) >> 32) + n) >> shift


@pytest.mark.parametrize("d", [1, 2, 3, 4, 7, 8, 16, 24, 32, 48, 64, 96,
                               127, 512, 1000, 4097, 65535, 2**30 + 3,
                               2**31 - 1])
def test_kernel_division_by_multiply_and_shift_is_exact(d):
    """The kernel divides views by the group, lines by the band tile and
    columns by bw with ``bp::FastDiv``: exact over [0, 2^31)."""
    rng = np.random.RandomState(d % 1000)
    ns = list(range(0, 4096)) + [d - 1, d, d + 1, 2 * d - 1, 2 * d,
                                 2**31 - 1, 2**31 - d]
    ns += rng.randint(0, 2**31 - 1, size=2000).tolist()
    for n in ns:
        if 0 <= n < 2**31:
            assert _fast_div(n, d) == n // d, (n, d)
