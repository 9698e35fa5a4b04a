#!/usr/bin/env python3
"""On-card smoke test of repro_torch, the PyTorch + CUDA port.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed N]

It builds the CUDA kernels (K1-K6, all instances of one tiled kernel)
from the source in the checkout, prints the tiled kernel's launch plan
with the card's occupancy, registers and spills for each instance
(linear: K1/K2; two-hot: K3/K4; linear from the band layout: K5/K6),
holds each kernel against its plain PyTorch version and the oracle at
the sweep shapes, the deep columns (past nz = 2048) and the main path's
shape (K1, K2, K5 and K6 against each other, and K3 against K4, bit for
bit), and K5/K6 with bands that drop lines against their plain version,
drives the FDK main path at
the paper's P5 size (512^3 voxels, 512 views, 512x512 detector) through
``repro_torch.reconstruct`` with each CUDA variant (``subline_pl``,
``onehot_pl``, ``banded_pl``, each at nb=8 and nb=1), checks that each
path launched its kernel and agrees with the ``subline_pl`` and plain
``algorithm1_mp`` paths on the card, and times the kernels, their plain
versions, the band schedule, the filter and the whole reconstructions
with CUDA events (median of 3 after a warm-up; a single timed run for a
plain version that takes over 5 s).

Then the tiled, out-of-core path: P5 through ``reconstruct(tiling=(256,
256, 96), proj_batch=128)`` (12 steps: 4 tiles x 2 mirror-paired units
and a centered slab; 4 chunks) with each CUDA variant, step- and
chunk-major, ``out="device"`` and ``"host"``, ``pipeline="sync"`` and
``"async"``, each within 1e-5 of the untiled run on the card and async
equal to sync bit for bit; P10 (1300^3 voxels, 8.8 GB) through
``tiling=(650, 650, 325)`` with a host volume and the async flush, and
through ``memory_budget=16 GiB``, each held against float64 on line
boxes as closely as the untiled run is. For each tiled run the launch
counters must show one launch of the variant's kernel per step and chunk
and no plain version; the launch plans of every call are printed, with a
profile of the tiled walk (device idle share, sync against async). Last,
the forward projector at a reduced 128^3: phantom -> ``forward_project``
-> tiled FDK, against the untiled FDK of the same projections.

Every phase is a hard failure. The last line of standard output is
``{"ok": true, "device": {...}}``; it is printed only when every phase
passed. Without a CUDA device, or without the rest of the repository
beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BAR = 1e-5                        # tests/test_kernels.py BAR
SWEEP = [(16, 24, 6), (16, 16, 4), (13, 17, 5), (8, 32, 3), (20, 12, 7),
         (15, 20, 6)]             # + an odd-nz case the fused kernel takes
# Deep 16x16-line columns (nz, detector, views): every k-per-lane
# instance of the kernel and several k chunks, at detectors up to 1024
# rows.
DEPTHS = [(70, 64, 4), (129, 96, 5), (200, 128, 4), (500, 256, 3),
          (1000, 512, 4), (1301, 1024, 8)]
BLOCKS = [(1, 8), (2, 8), (4, 8), (4, 16)]
# On 16 x 16 lines, through _deep_tiled: past the 2048 planes that the
# kernel K1-K6 ran on before the tiled one took, and detectors so fine that
# the windows overflow their columns (2.4 pixels a voxel) and their rows
# too (7.2: both global-read paths)
DEEP_SUBLINE = [(2049, 1024, 4), (2600, 1024, 4), (300, 900, 4),
                (100, 900, 4)]
SUBLINE_PLAIN_BAR = 1e-7          # K1/K2 against their plain version
ONEHOT_PLAIN_BAR = 4e-8           # K3/K4 against their plain version
K2_NBS = [1, 2, 4, 8]             # K2 timed at P5 at each nb
NBS = [2, 3, 8]
K_CHUNKS = [4, 8, 128]            # one-hot k tiles (4 divides no khp here)
BWS = [8, 16, 32]                 # banded starting band widths
BANDED = [(16, 48, 4, 16), (13, 17, 5, 8)]   # tests/test_kernels.py cases
SHIFT_BW = 8                      # bands of the line-dropping (shifted) case
ONEHOT_K1_BAR = 1e-6              # tests/test_kernels.py, K3 against K1
FLOPS_PER_UPDATE = 8.0            # the repo's ct-backproject cost model
PEAK_FP32_FLOPS = 67e12           # H100 SXM, non-tensor FP32
PEAK_BYTES = 3.35e12              # H100 SXM HBM3
LONG_RUN_MS = 5000.0              # above this, one timed run
SRC = "src/repro_torch/kernels/csrc/backproject_subline.cu"
# launch counter -> (label: the wrapper and the CUDA kernel it launches,
# TPU kernel it replaces)
KERNELS = {
    "backproject_subline_kernel": (
        "K1 backproject_subline_kernel (tile_kernel, linear form)",
        "src/repro/kernels/backproject_subline.py:204"),
    "backproject_subline_fused": (
        "K2 backproject_subline_fused (tile_kernel, linear form)",
        "src/repro/kernels/backproject_subline.py:240"),
    "backproject_onehot_kernel": (
        "K3 backproject_onehot_kernel (tile_kernel, two-hot form)",
        "src/repro/kernels/backproject_onehot.py:144"),
    "backproject_onehot_fused": (
        "K4 backproject_onehot_fused (tile_kernel, two-hot form)",
        "src/repro/kernels/backproject_onehot.py:175"),
    "backproject_banded_kernel": (
        "K5 backproject_banded_kernel (tile_kernel, linear form, banded)",
        "src/repro/kernels/backproject_banded.py:148"),
    "backproject_banded_fused": (
        "K6 backproject_banded_fused (tile_kernel, linear form, banded)",
        "src/repro/kernels/backproject_banded.py:186"),
}
SOURCES = ["backproject_subline"]
# the tiled kernel's instances: (name, form, banded)
INSTANCES = (("linear", 0, 0), ("two-hot", 1, 0), ("banded", 0, 1))


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {msg}")


def rel_rmse(a, b) -> float:
    """tests/conftest.py::rel_rmse, on tensors, in float64."""
    a = a.double()
    b = b.double()
    scale = max(float(b.abs().max()), 1e-12)
    return float(((a - b) ** 2).mean().sqrt()) / scale


def timed(fn, reps: int = 3) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs after one
    warm-up, each bracketed by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def timed_long(fn) -> tuple:
    """``timed(fn)``, or where one run takes over LONG_RUN_MS (the plain
    versions at P5), that single run. Returns (ms, how)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    if ms > LONG_RUN_MS:
        return ms, "one timed run (a run exceeds 5 s)"
    return timed(fn), "median of 3 after a warm-up"


def launch_modules():
    from repro_torch.kernels import backproject_banded as kb
    from repro_torch.kernels import backproject_onehot as ko
    from repro_torch.kernels import backproject_subline as ks
    return ks, ko, kb


def reset_launches() -> None:
    for mod in launch_modules():
        mod.reset_launches()


def launches() -> dict:
    out = {}
    for mod in launch_modules():
        out.update(mod.LAUNCHES)
    return out


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device() -> str:
    import torch
    from repro_torch.kernels import _build
    nvcc = subprocess.run([_build._nvcc(), "--version"], check=True,
                          capture_output=True, text=True, timeout=60)
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    print(f"[device] python {sys.version.split()[0]}, torch "
          f"{torch.__version__} (CUDA {torch.version.cuda}), nvcc "
          f"{nvcc.stdout.strip().splitlines()[-1]}")
    return card


def phase_build() -> None:
    """All sources at once: one nvcc each, started together. The
    compiler's report names each instance (tile_kernel<kpt, form>)."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build(SOURCES)
    print(f"[build] {len(SOURCES)} sources in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in SOURCES:
        print(f"[build] {name}.cu: nvcc "
              f"{_build.build_log[name]['seconds']:.2f} s")
        for line in _build.build_log[name]["log"].splitlines():
            if "registers" in line or "spill" in line or \
                    "Compiling" in line:
                print(f"[build]   {line.strip()}")


def _sweep_case(geom, seed, errs, blocks, k_chunks, bws) -> tuple:
    """K1-K6 against their plain versions and the oracle on one geometry;
    returns how many banded cases the band search widened and how many
    shifted-band cases dropped lines."""
    import numpy as np
    import torch
    from repro_torch.core.backproject import transpose_projections
    from repro_torch.core.geometry import projection_matrices
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import backproject_ref
    ks, ko, kb = launch_modules()

    npj = geom.n_proj
    rng = np.random.RandomState(seed)
    img = torch.from_numpy(
        rng.rand(npj, geom.nh, geom.nw).astype(np.float32)).cuda()
    img_t = transpose_projections(img)
    mats = projection_matrices(geom)
    shape = geom.volume_shape_xyz
    ni, nj, nz = shape
    nw = geom.nw
    ref = backproject_ref(img_t, mats, shape)
    mid = nz // 2 if nz % 2 else None
    fused_nbs = [nb for nb in NBS + [npj] if npj % nb == 0]
    lines = {"subline": [], "onehot": [], "banded": []}

    def check(family, label, kernel, out, plain):
        torch.cuda.synchronize()
        r_plain, r_ref = rel_rmse(out, plain), rel_rmse(out, ref)
        errs[kernel] = max(errs[kernel], float((out - plain).abs().max()))
        msg = f"{label} vs plain {r_plain:.2e} vs oracle {r_ref:.2e}"
        require(r_plain < BAR and r_ref < BAR, msg)
        bar = {"subline": SUBLINE_PLAIN_BAR,
               "onehot": ONEHOT_PLAIN_BAR}.get(family)
        if bar is not None:
            require(r_plain < bar,
                    f"{msg} (bar {bar} against the plain version)")
        if mid is not None:
            r_mid = rel_rmse(out[..., mid], ref[..., mid])
            msg += f" middle plane {r_mid:.2e}"
            require(r_mid < BAR, msg)
        lines[family].append((max(r_plain, r_ref), msg))

    # K1/K2: the tiled sub-line kernel, on the ragged volume and padded to
    # each block; every call gives K1's volume bit for bit
    sub_plain = ks.backproject_subline_plain(img_t, mats, shape)
    k1 = ks.backproject_subline_kernel(img_t, mats, shape)
    check("subline", "K1 unpadded", "backproject_subline_kernel", k1,
          sub_plain)

    def same_as_k1(label, out):
        require(torch.equal(out, k1), f"{label} is not bitwise equal to K1")
        return out

    for block in blocks:
        check("subline", f"K1 block={block}", "backproject_subline_kernel",
              same_as_k1(f"K1 block={block}", ops._run_padded(
                  ks.backproject_subline_kernel, img_t, mats, shape, block)),
              sub_plain)
        for nb in fused_nbs:
            check("subline", f"K2 block={block} nb={nb}",
                  "backproject_subline_fused",
                  same_as_k1(f"K2 block={block} nb={nb}", ops._run_padded(
                      ks.backproject_subline_fused, img_t, mats, shape,
                      block, nb=nb)), sub_plain)
        for nb in NBS:      # the routed wrapper: K2 when nb | np, else K1
            out = same_as_k1(f"ops block={block} nb={nb}",
                             ops.backproject_subline(img_t, mats, shape,
                                                     nb=nb, block=block,
                                                     proj_loop=True))
            check("subline", f"ops block={block} nb={nb}",
                  "backproject_subline_kernel" if npj % nb
                  else "backproject_subline_fused", out, sub_plain)

    # K3/K4: the tiled kernel's two-hot form; every call gives unpadded
    # K3's volume bit for bit (k_chunk and nb change no bit), within 1e-6
    # of K1
    plain = ko.backproject_onehot_plain(img_t, mats, shape, k_chunk=8)
    k3 = ko.backproject_onehot_kernel(img_t, mats, shape)
    check("onehot", "K3 unpadded", "backproject_onehot_kernel", k3, plain)
    r = rel_rmse(k3, k1)
    require(r < ONEHOT_K1_BAR, f"K3 is {r:.2e} from K1 (bar {ONEHOT_K1_BAR})")

    def same_as_k3(label, out):
        require(torch.equal(out, k3), f"{label} is not bitwise equal to K3")
        return out

    for block in blocks:
        for kc in k_chunks:
            check("onehot", f"K3 block={block} k_chunk={kc}",
                  "backproject_onehot_kernel",
                  same_as_k3(f"K3 block={block} k_chunk={kc}",
                             ops._run_padded(ko.backproject_onehot_kernel,
                                             img_t, mats, shape, block,
                                             k_chunk=kc)), plain)
            for nb in fused_nbs:
                label = f"K4 block={block} k_chunk={kc} nb={nb}"
                check("onehot", label, "backproject_onehot_fused",
                      same_as_k3(label, ops._run_padded(
                          ko.backproject_onehot_fused, img_t, mats, shape,
                          block, k_chunk=kc, nb=nb)), plain)
        for nb in NBS:
            out = same_as_k3(f"ops block={block} nb={nb}",
                             ops.backproject_onehot(
                                 img_t, mats, shape, nb=nb, block=block,
                                 k_chunk=k_chunks[0], proj_loop=True))
            check("onehot", f"ops block={block} nb={nb}",
                  "backproject_onehot_kernel" if npj % nb
                  else "backproject_onehot_fused", out, plain)

    # K5/K6: the banded kernel, on the block-padded volume; the device band
    # schedule equals the same function run on the CPU
    widened = dropped = 0
    for block in blocks:
        bi, bj = block
        pshape = (-(-ni // bi) * bi, -(-nj // bj) * bj, nz)
        for bw0 in bws:
            for group in [1] + fused_nbs:
                img_b, band, bw = kb.band_schedule(
                    img_t, mats, pshape, block=block, bw=bw0, group=group)
                widened += bw != bw0
                n_bands = img_b.shape[1]
                dev_band, dev_span = kb.tile_bands(
                    mats, pshape[0], pshape[1], bi, bj, bw, n_bands, nw,
                    group=group)
                cpu_band, cpu_span = kb.tile_bands(
                    mats.cpu(), pshape[0], pshape[1], bi, bj, bw, n_bands,
                    nw, group=group)
                require(torch.equal(dev_band.cpu(), cpu_band)
                        and torch.equal(band, dev_band)
                        and dev_span == cpu_span,
                        f"device tile_bands differs from the CPU's at "
                        f"block={block} bw={bw} group={group}")
                plain = kb.backproject_banded_plain(
                    img_b, mats, band, pshape, block=block, bw=bw, nw=nw,
                    group=group)[:ni, :nj]
                if group == 1:
                    out = kb.backproject_banded_kernel(
                        img_b, mats, band, pshape, block=block, bw=bw, nw=nw)
                    kernel, label = "backproject_banded_kernel", "K5"
                else:
                    out = kb.backproject_banded_fused(
                        img_b, mats, band, pshape, block=block, bw=bw, nw=nw,
                        nb=group)
                    kernel, label = "backproject_banded_fused", \
                        f"K6 nb={group}"
                check("banded", f"{label} block={block} bw={bw0}->{bw}",
                      kernel, same_as_k1(f"{label} block={block} bw={bw}",
                                         out[:ni, :nj]), plain)
        for nb in NBS:
            out = ops.backproject_banded(img_t, mats, shape, nb=nb,
                                         block=block, bw=bws[0],
                                         proj_loop=True)
            check("banded", f"ops block={block} nb={nb}",
                  "backproject_banded_kernel" if npj % nb
                  else "backproject_banded_fused", out, sub_plain)
        dropped += _shifted_bands(img_t, mats, pshape, block, nw, npj, errs,
                                  lines["banded"])
    for family, results in lines.items():
        print(f"[kernels] {family}: volume {shape}, detector "
              f"{geom.nw}x{geom.nh}, {npj} views: {len(results)} cases "
              f"pass; worst: {max(results)[1]}")
    return widened, dropped


def _shifted_bands(img_t, mats, pshape, block, nw, npj, errs, lines) -> int:
    """K5, and K6 at nb = every view, on bands of SHIFT_BW columns moved one
    place right (no band search): the lines left of their band are dropped,
    and each kernel must agree with its plain version within BAR. Returns
    how many of the two dropped lines (differ from K1)."""
    import torch
    ks, _, kb = launch_modules()
    img_b, n_bands = kb.band_layout(img_t, SHIFT_BW)
    k1 = ks.backproject_subline_kernel(img_t, mats, pshape)
    dropped = 0
    for group in (1, npj):
        band, _ = kb.tile_bands(mats, *pshape[:2], *block, SHIFT_BW,
                                n_bands, nw, group=group)
        band = torch.clamp(band + 1, max=n_bands - 1)
        kw = dict(block=block, bw=SHIFT_BW, nw=nw)
        plain = kb.backproject_banded_plain(img_b, mats, band, pshape,
                                            group=group, **kw)
        if group == 1:
            kernel, label = "backproject_banded_kernel", "K5"
            out = kb.backproject_banded_kernel(img_b, mats, band, pshape, **kw)
        else:
            kernel, label = "backproject_banded_fused", f"K6 nb={group}"
            out = kb.backproject_banded_fused(img_b, mats, band, pshape,
                                              nb=group, **kw)
        torch.cuda.synchronize()
        r = rel_rmse(out, plain)
        errs[kernel] = max(errs[kernel], float((out - plain).abs().max()))
        differs = not torch.equal(out, k1)
        dropped += differs
        msg = (f"{label} block={block} shifted bands (bw={SHIFT_BW}) vs plain "
               f"{r:.2e}, lines dropped: {differs}")
        require(r < BAR, msg)
        lines.append((r, msg))
    return dropped


def phase_kernels_sweep(seed: int) -> dict:
    import dataclasses
    from repro_torch.core.geometry import standard_geometry
    errs = {name: 0.0 for name in KERNELS}
    cases = [(standard_geometry(n=n, n_det=det, n_proj=npj), BLOCKS,
              K_CHUNKS, BWS) for n, det, npj in SWEEP]
    cases += [(standard_geometry(n=n, n_det=det, n_proj=npj), BLOCKS,
               K_CHUNKS, [bw]) for n, det, npj, bw in BANDED]
    cases += [(dataclasses.replace(standard_geometry(n=nz, n_det=det,
                                                     n_proj=npj),
                                   nx=16, ny=16), BLOCKS, [128], [32])
              for nz, det, npj in DEPTHS]
    widened = dropped = 0
    for i, case in enumerate(cases):
        w, d = _sweep_case(case[0], seed + i, errs, *case[1:])
        widened += w
        dropped += d
    print(f"[kernels] the band search widened bw in {widened} banded cases; "
          f"the shifted bands dropped lines in {dropped} cases")
    require(widened > 0, "no banded case ran the band-width doubling loop")
    require(dropped > 0, "no shifted-band case dropped a line")
    _deep_tiled(seed + len(cases), errs)
    return errs


def _deep_tiled(seed, errs) -> None:
    """The tiled kernel at DEEP_SUBLINE, in every instance: K1 and K3
    against their plain versions and the oracle, K3 within 1e-6 of K1, K2
    (K4) at every nb bitwise equal to K1 (K3), and K5 and K6 (at every nb,
    each under its own band schedule) bitwise equal to K1. The 900-row
    detectors run the global-read paths, the deep columns the check-free
    stage 2."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.backproject import transpose_projections
    from repro_torch.core.geometry import (projection_matrices,
                                           standard_geometry)
    from repro_torch.kernels.ref import backproject_ref
    ks, ko, kb = launch_modules()
    for nz, det, npj in DEEP_SUBLINE:
        geom = dataclasses.replace(standard_geometry(n=nz, n_det=det,
                                                     n_proj=npj), nx=16,
                                   ny=16)
        img = torch.from_numpy(np.random.RandomState(seed).rand(
            npj, geom.nh, geom.nw).astype(np.float32)).cuda()
        img_t = transpose_projections(img)
        mats = projection_matrices(geom)
        shape = geom.volume_shape_xyz
        plain = ks.backproject_subline_plain(img_t, mats, shape)
        ref = backproject_ref(img_t, mats, shape)
        k1 = ks.backproject_subline_kernel(img_t, mats, shape)
        torch.cuda.synchronize()
        r_plain, r_ref = rel_rmse(k1, plain), rel_rmse(k1, ref)
        errs["backproject_subline_kernel"] = max(
            errs["backproject_subline_kernel"],
            float((k1 - plain).abs().max()))
        msg = (f"K1/K2 at volume {shape}, detector {det}, {npj} views: vs "
               f"plain {r_plain:.2e}, vs oracle {r_ref:.2e}")
        require(r_plain < SUBLINE_PLAIN_BAR and r_ref < BAR, msg)
        if nz % 2:          # the direct half's odd middle plane
            r_mid = rel_rmse(k1[..., nz // 2], ref[..., nz // 2])
            msg += f", middle plane {r_mid:.2e}"
            require(r_mid < BAR, msg)
        k3 = ko.backproject_onehot_kernel(img_t, mats, shape)
        oh_plain = ko.backproject_onehot_plain(img_t, mats, shape)
        torch.cuda.synchronize()
        r3, r31 = rel_rmse(k3, oh_plain), rel_rmse(k3, k1)
        errs["backproject_onehot_kernel"] = max(
            errs["backproject_onehot_kernel"],
            float((k3 - oh_plain).abs().max()))
        msg += f"; K3 vs its plain {r3:.2e}, vs K1 {r31:.2e}"
        require(r3 < ONEHOT_PLAIN_BAR and r31 < ONEHOT_K1_BAR, msg)
        for nb in [nb for nb in K2_NBS if npj % nb == 0]:
            k2 = ks.backproject_subline_fused(img_t, mats, shape, nb=nb)
            require(torch.equal(k2, k1), f"K2 nb={nb} at nz={nz} is not "
                    f"bitwise equal to K1")
            k4 = ko.backproject_onehot_fused(img_t, mats, shape, nb=nb)
            require(torch.equal(k4, k3), f"K4 nb={nb} at nz={nz} is not "
                    f"bitwise equal to K3")
            img_b, band, bw = kb.band_schedule(img_t, mats, shape,
                                               block=(4, 8), bw=32, group=nb)
            kw = dict(block=(4, 8), bw=bw, nw=det)
            if nb == 1:
                label = "K5"
                out = kb.backproject_banded_kernel(img_b, mats, band, shape,
                                                   **kw)
            else:
                label = f"K6 nb={nb}"
                out = kb.backproject_banded_fused(img_b, mats, band, shape,
                                                  nb=nb, **kw)
            require(torch.equal(out, k1), f"{label} (bw={bw}) at nz={nz} is "
                    f"not bitwise equal to K1")
        print(f"[kernels] {msg}; K2 = K1, K4 = K3 and K5 = K6 = K1 bit for "
              f"bit")


def phase_plan(shapes) -> None:
    """The tiled kernel's launch plan at each (volume, nh), with what the
    card says of it for each instance (linear: K1/K2; two-hot: K3/K4;
    banded: K5/K6): blocks per SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers and local
    (spill) bytes per thread. K1-K6 launch the same plan."""
    import ctypes
    ks = launch_modules()[0]
    lib = ks._lib()
    for shape, nh in shapes:
        plan = ks.launch_plan(shape, nh)
        smem = lib.bp_tile_smem_bytes(nh, plan.win_rows)
        forms = []
        for name, form, banded in INSTANCES:
            blocks, regs, local = (ctypes.c_int(), ctypes.c_int(),
                                   ctypes.c_int())
            err = lib.bp_tile_occupancy(plan.kpt, form, banded, nh,
                                        plan.win_rows, ctypes.byref(blocks),
                                        ctypes.byref(regs),
                                        ctypes.byref(local))
            require(err == 0, f"bp_tile_occupancy failed: CUDA error {err}")
            require(blocks.value >= 2, f"fewer than 2 blocks per SM at "
                    f"{shape} in the {name} instance")
            forms.append(f"{name} {blocks.value} blocks/SM, "
                         f"{regs.value} registers, {local.value} B local "
                         f"per thread")
        print(f"[plan] volume {shape} nh={nh}: tile {ks.TILE}, k chunk "
              f"{plan.k_chunk} planes (kpt {plan.kpt}) + mirrors, grid "
              f"{plan.grid}, a ring of 2 windows of {plan.win_rows} "
              f"rows, shared {smem} B; on the card: {'; '.join(forms)}")


# (volume, nh) where the tiled kernel's launch plan is printed: P5, P4
# (kpt 2), and the deep columns of DEPTHS and DEEP_SUBLINE
PLAN_SHAPES = ([((512, 512, 512), 512), ((256, 256, 256), 512)]
               + [((16, 16, nz), det)
                  for nz, det, _ in DEPTHS + DEEP_SUBLINE])
MAIN_RUNS = (
    ("subline_pl nb=8", dict(variant="subline_pl"),
     "backproject_subline_fused"),
    ("subline_pl nb=1", dict(variant="subline_pl", nb=1),
     "backproject_subline_kernel"),
    ("onehot_pl nb=8", dict(variant="onehot_pl"),
     "backproject_onehot_fused"),
    ("onehot_pl nb=1", dict(variant="onehot_pl", nb=1),
     "backproject_onehot_kernel"),
    ("banded_pl nb=8", dict(variant="banded_pl"),
     "backproject_banded_fused"),
    ("banded_pl nb=1", dict(variant="banded_pl", nb=1),
     "backproject_banded_kernel"),
)
# line boxes (i0, j0) of the P5 volume where K3/K4 are held against the
# plain one-hot version (the whole volume would take the plain version
# minutes per projection): a corner, the centre, an edge. Each box's
# rel-RMSE is scaled by the box's own largest value, and the bar there is
# the one K1 is held to against its plain version, SUBLINE_PLAIN_BAR; K1's
# own rel-RMSE against its plain version on each box is printed beside.
ONEHOT_BOXES = ((0, 0), (252, 252), (504, 0))
BOX = 8


def phase_p5(seed: int, errs: dict) -> dict:
    import numpy as np
    import torch
    import repro_torch
    from repro_torch import ReconOptions
    from repro_torch.configs.ct_paper import get_problem
    from repro_torch.core.backproject import transpose_projections
    from repro_torch.core.filtering import fdk_filter_chunk
    from repro_torch.core.geometry import projection_matrices
    from repro_torch.kernels.ref import backproject_ref
    ks, ko, kb = launch_modules()

    prob = get_problem("P5")
    geom = prob.geometry()
    shape = geom.volume_shape_xyz
    rng = np.random.default_rng(seed)
    p_host = rng.random(geom.proj_shape_hw, dtype=np.float32)
    p = torch.from_numpy(p_host).cuda()
    print(f"[P5] {prob}: projections {tuple(p.shape)} from seed {seed}, "
          f"{prob.updates:.3e} voxel-view updates")

    # ---- the main path, driven through the public entry point -------------
    main_launches = {}
    vols = {}
    for label, opts, kernel in MAIN_RUNS:
        reset_launches()
        t0 = time.perf_counter()
        vols[label] = repro_torch.reconstruct(p_host, geom,
                                              options=ReconOptions(**opts))
        torch.cuda.synchronize()
        n = launches()
        main_launches[kernel] = n[kernel]
        print(f"[P5] reconstruct {label}: {time.perf_counter() - t0:.3f} s "
              f"(host clock, input from the host), launches "
              f"{ {k: v for k, v in n.items() if v} }")
        require(n[kernel] > 0,
                f"the main path ({label}) never launched {kernel}")
        require(sum(n.values()) == n[kernel],
                f"the main path ({label}) launched other kernels: {n}")
    reset_launches()
    plain_vol = repro_torch.reconstruct(
        p, geom, options=ReconOptions(variant="algorithm1_mp"))
    torch.cuda.synchronize()
    require(sum(launches().values()) == 0,
            "the algorithm1_mp path launched a kernel")
    main = vols["subline_pl nb=8"]
    for label, vol in vols.items():
        require(tuple(vol.shape) == geom.volume_shape_zyx
                and bool(torch.isfinite(vol).all()),
                f"{label}: non-finite values or wrong shape")
        r = rel_rmse(vol, plain_vol)
        r_main = rel_rmse(vol, main)
        print(f"[P5] {label}: rel_rmse {r:.3e} vs algorithm1_mp, "
              f"{r_main:.3e} vs subline_pl nb=8 on the card; bitwise equal "
              f"to it: {bool(torch.equal(vol, main))}")
        require(r < BAR and r_main < BAR,
                f"{label} disagrees with algorithm1_mp or subline_pl")
    require(torch.equal(vols["subline_pl nb=8"], vols["subline_pl nb=1"]),
            "K1 and K2 main paths are not bitwise equal")
    for nb in (8, 1):
        require(torch.equal(vols[f"banded_pl nb={nb}"],
                            vols[f"subline_pl nb={nb}"]),
                f"banded_pl and subline_pl at nb={nb} are not bitwise equal")
    del vols, main, plain_vol

    # ---- each kernel at the main path's shape against its plain version ---
    img_t = transpose_projections(fdk_filter_chunk(p, geom, geom.n_proj))
    mats = projection_matrices(geom)
    block = (4, 8)
    bands = {}
    for kernel, group in (("backproject_banded_kernel", 1),
                          ("backproject_banded_fused", 8)):
        img_b, band, bw = kb.band_schedule(img_t, mats, shape, block=block,
                                           bw=32, group=group)
        bands[kernel] = (img_b, band, bw, group)
        print(f"[P5] band schedule group={group}: bw 32 -> {bw}, img_b "
              f"{tuple(img_b.shape)} ({img_b.numel() * 4 / 1e9:.3f} GB), "
              f"band {tuple(band.shape)}")

    def banded(kernel):
        img_b, band, bw, group = bands[kernel]
        if group == 1:
            return lambda: kb.backproject_banded_kernel(
                img_b, mats, band, shape, block=block, bw=bw, nw=geom.nw)
        return lambda: kb.backproject_banded_fused(
            img_b, mats, band, shape, block=block, bw=bw, nw=geom.nw,
            nb=group)

    calls = {
        "backproject_subline_kernel":
            lambda: ks.backproject_subline_kernel(img_t, mats, shape),
        "backproject_subline_fused":
            lambda: ks.backproject_subline_fused(img_t, mats, shape, nb=8),
        "backproject_onehot_kernel":
            lambda: ko.backproject_onehot_kernel(img_t, mats, shape),
        "backproject_onehot_fused":
            lambda: ko.backproject_onehot_fused(img_t, mats, shape, nb=8),
        "backproject_banded_kernel": banded("backproject_banded_kernel"),
        "backproject_banded_fused": banded("backproject_banded_fused"),
    }
    plain = ks.backproject_subline_plain(img_t, mats, shape)
    ref = backproject_ref(img_t, mats, shape)
    r = rel_rmse(plain, ref)
    print(f"[P5] sub-line plain version vs oracle: rel_rmse {r:.3e}")
    require(r < BAR, "the plain version disagrees with the oracle at P5")
    del ref
    plains = {"backproject_subline_kernel": plain,
              "backproject_subline_fused": plain}
    for kernel, (img_b, band, bw, group) in bands.items():
        plains[kernel] = kb.backproject_banded_plain(
            img_b, mats, band, shape, block=block, bw=bw, nw=geom.nw,
            group=group)
        r = rel_rmse(plains[kernel], plain)
        print(f"[P5] banded plain version (group={group}) vs sub-line "
              f"plain: rel_rmse {r:.3e}")
        require(r < BAR, "the banded plain version disagrees at P5")
    outs = {}
    for name, call in calls.items():
        out = call()
        torch.cuda.synchronize()
        if name.startswith("backproject_onehot"):
            # the whole volume against the sub-line plain version (the same
            # function), line boxes against the one-hot plain version
            r = rel_rmse(out, plain)
            r_boxes = []
            for i0, j0 in ONEHOT_BOXES:
                box = ko.backproject_onehot_plain(
                    img_t, mats, (BOX, BOX, geom.nz), origin=(i0, j0))
                got = out[i0:i0 + BOX, j0:j0 + BOX]
                r_box = rel_rmse(got, box)
                errs[name] = max(errs[name], float((got - box).abs().max()))
                require(r_box < SUBLINE_PLAIN_BAR, f"{name} disagrees with "
                        f"the one-hot plain version on lines ({i0}, {j0}): "
                        f"{r_box:.3e} (bar {SUBLINE_PLAIN_BAR})")
                r_k1 = rel_rmse(outs["backproject_subline_kernel"][
                    i0:i0 + BOX, j0:j0 + BOX], plain[i0:i0 + BOX,
                                                     j0:j0 + BOX])
                r_boxes.append(f"({i0}, {j0}) {r_box:.3e} (K1 vs its plain "
                               f"{r_k1:.3e})")
            what = (f"vs sub-line plain {r:.3e}; vs one-hot plain on "
                    f"{BOX}x{BOX}-line boxes: {', '.join(r_boxes)}; max abs "
                    f"{errs[name]:.3e}")
        else:
            r = rel_rmse(out, plains[name])
            errs[name] = max(errs[name],
                             float((out - plains[name]).abs().max()))
            what = f"vs plain: rel_rmse {r:.3e}, max abs {errs[name]:.3e}"
        print(f"[P5] {KERNELS[name][0]} {what} (max |plain| "
              f"{float(plain.abs().max()):.3e})")
        require(r < BAR, f"{name} disagrees with its plain version at P5")
        outs[name] = out
    # K1 against K5 (the same launch reading the bands) and K2 against K6,
    # bit for bit
    for a, b in (("backproject_subline_kernel", "backproject_banded_kernel"),
                 ("backproject_subline_fused", "backproject_banded_fused"),
                 ("backproject_subline_kernel", "backproject_subline_fused")):
        require(torch.equal(outs[a], outs[b]),
                f"{a} and {b} are not bitwise equal at P5")
    print("[P5] K1 = K5, K2 = K6 and K1 = K2 bit for bit")
    r = rel_rmse(outs["backproject_subline_kernel"], plain)
    require(r < SUBLINE_PLAIN_BAR, f"K1 is {r:.3e} from its plain version "
            f"at P5 (bar {SUBLINE_PLAIN_BAR})")
    require(torch.equal(outs["backproject_onehot_kernel"],
                        outs["backproject_onehot_fused"]),
            "K3 and K4 are not bitwise equal at P5")
    print("[P5] K3 = K4 bit for bit")
    r = rel_rmse(outs["backproject_onehot_kernel"],
                 outs["backproject_subline_kernel"])
    print(f"[P5] K3 vs K1: rel_rmse {r:.3e}")
    require(r < ONEHOT_K1_BAR, f"K3 is {r:.3e} from K1 at P5 (bar "
            f"{ONEHOT_K1_BAR})")
    del outs
    del plains, out

    # ---- times --------------------------------------------------------------
    flops = FLOPS_PER_UPDATE * prob.updates
    vol_bytes = 4 * geom.nx * geom.ny * geom.nz
    in_bytes = {name: 4 * (img_t.numel() + mats.numel())
                for name in calls}
    for kernel, (img_b, band, _, _) in bands.items():
        in_bytes[kernel] = 4 * (img_b.numel() + mats.numel() + band.numel())
    bounds = {}
    for name in calls:
        n_bytes = in_bytes[name] + vol_bytes
        t_op, t_b = flops / PEAK_FP32_FLOPS, n_bytes / PEAK_BYTES
        bounds[name] = (max(t_op, t_b) * 1e3,
                        "operations" if t_op > t_b else "bytes")
        print(f"[P5] bound {KERNELS[name][0]}: {flops:.3e} FLOP / 67 TFLOP/s "
              f"= {t_op * 1e3:.3f} ms, {n_bytes:.3e} B / 3.35 TB/s = "
              f"{t_b * 1e3:.3f} ms -> {bounds[name][0]:.3f} ms "
              f"({bounds[name][1]})")
    times = {}
    for name, call in calls.items():
        times[name] = timed(call)
        print(f"[P5] {KERNELS[name][0]}: {times[name]:.3f} ms (median of 3 "
              f"after a warm-up), {prob.updates / times[name] / 1e6:.1f} "
              f"GUPS, {bounds[name][0] / times[name]:.4f} of the bound")
    for nb in K2_NBS:        # nb changes no launch: the same plan as K1
        ms = timed(lambda: ks.backproject_subline_fused(img_t, mats, shape,
                                                        nb=nb))
        print(f"[P5] K2 at nb={nb}: {ms:.3f} ms, "
              f"{bounds['backproject_subline_fused'][0] / ms:.4f} of the "
              f"bound")
    plain_ms = {}
    ms, how = timed_long(lambda: ks.backproject_subline_plain(img_t, mats,
                                                              shape))
    plain_ms["backproject_subline_kernel"] = \
        plain_ms["backproject_subline_fused"] = ms
    print(f"[P5] sub-line plain version: {ms:.3f} ms ({how})")
    for kernel, (img_b, band, bw, group) in bands.items():
        plain_ms[kernel], how = timed_long(
            lambda: kb.backproject_banded_plain(
                img_b, mats, band, shape, block=block, bw=bw, nw=geom.nw,
                group=group))
        print(f"[P5] banded plain version (group={group}): "
              f"{plain_ms[kernel]:.3f} ms ({how})")
    print("[P5] one-hot plain version: not run at P5. It builds the "
          "two-hot matrix A for every (line, plane, row): 6.9e10 entries "
          "per projection, 3.5e13 in all, in blocks of "
          f"{ko.PLAIN_BLOCK_BYTES >> 20} MiB, which would take the card "
          "minutes per projection. It is held against the kernel on line "
          "boxes above; its time stays not measured.")
    plain_ms["backproject_onehot_kernel"] = None
    plain_ms["backproject_onehot_fused"] = None
    for group in (1, 8):
        ms = timed(lambda: kb.band_schedule(img_t, mats, shape, block=block,
                                            bw=32, group=group))
        bw = bands["backproject_banded_kernel" if group == 1
                   else "backproject_banded_fused"][2]
        ms_layout = timed(lambda: kb.band_layout(img_t, bw))
        print(f"[P5] band schedule group={group} (tile_bands search + "
              f"band_layout, bw -> {bw}): {ms:.3f} ms per call, of which "
              f"band_layout {ms_layout:.3f} ms")
    filter_ms = timed(lambda: fdk_filter_chunk(p, geom, geom.n_proj))
    print(f"[P5] filter (fdk_filter_chunk, whole set): {filter_ms:.3f} ms")
    for label, opts, _ in MAIN_RUNS:
        ms = timed(lambda: repro_torch.reconstruct(
            p, geom, options=ReconOptions(**opts)))
        print(f"[P5] reconstruct {label} from device projections: "
              f"{ms:.3f} ms (median of 3 after a warm-up), "
              f"{prob.updates / ms / 1e6:.1f} GUPS")
    for variant in ("subline_pl", "onehot_pl", "banded_pl"):
        profile_reconstruct(p, geom, variant)
    return {name: {"name": KERNELS[name][0], "route": "cuda",
                   "source": SRC, "replaces": KERNELS[name][1],
                   "launches": main_launches[name],
                   "max_abs_err": errs[name], "ms": times[name],
                   "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
                   "bound_by": bounds[name][1], "library_ms": None}
            for name in KERNELS}


def profile_reconstruct(p, geom, variant: str) -> None:
    """Where the time of one warm P5 reconstruction goes on the card:
    device time by kernel from torch.profiler, and the device's idle
    share of the host-clock wall."""
    import torch
    import repro_torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        return repro_torch.reconstruct(p, geom, variant=variant)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.device_time_total / 1e3
    busy_ms = sum(by_name.values())
    if busy_ms == 0.0:
        print(f"[profile] {variant}: the profiler recorded no device time: "
              f"device breakdown not measured")
        return
    print(f"[profile] reconstruct {variant} at P5: wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms, idle share "
          f"{1.0 - busy_ms / wall_ms:.4f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile]   {ms:10.3f} ms  {ms / busy_ms:.4f}  {name[:90]}")


# --------------------------------------------------------------------------
# the tiled, out-of-core path
# --------------------------------------------------------------------------

# P5 through reconstruct(tiling=...): 4 (i, j)-tiles x (2 mirror-paired
# units of 96 planes + a centered 128-plane slab) = 12 steps, 4 chunks of
# 128 views; every combination of loop order, placement and flush
TILED_P5 = dict(tiling=(256, 256, 96), proj_batch=128)
TILED_P5_STEPS = 12
TILED_RUNS = [(schedule, out, pipeline) for schedule in ("step", "chunk")
              for out in ("device", "host") for pipeline in ("sync", "async")]
# P10: 4 tiles x 2 paired units of 325 planes = 8 steps; and a memory
# budget, which the planner turns into chunk-major with a host volume
TILED_P10 = (("tiling=(650, 650, 325) out=host async",
              dict(tiling=(650, 650, 325), out="host", pipeline="async")),
             ("memory_budget=16 GiB", dict(memory_budget=16 << 30)))
FUSED = {"subline_pl": "backproject_subline_fused",
         "onehot_pl": "backproject_onehot_fused",
         "banded_pl": "backproject_banded_fused"}
FORWARD_N = 128                   # the forward projector's reduced size
# line boxes (i0, j0) of P10 held against float64: a corner, the centre,
# an edge (ONEHOT_BOXES scaled to 1300 lines)
P10_BOXES = ((0, 0), (646, 646), (1292, 0))
# a tiled volume's rel-RMSE from float64 on a box, at most this many times
# the untiled volume's: as exact as the main path (float32 rounds the
# detector row y to ~1e-4 rows at 1024 rows; on ramp-filtered white noise
# either path is ~2e-5 from float64 at P10, PERF.md §6)
EXACT_RATIO = 1.25
DEVICE = "cuda"


class PlainCalls:
    """Counts calls of the plain versions a tile step could fall back to
    (the kernels' plain versions and the slab-safe ``subline_batch_mp``),
    by wrapping them where their callers look them up."""

    def __init__(self):
        from repro_torch.core import backproject as bp
        ks, ko, kb = launch_modules()
        self.calls = 0
        for mod, name in ((ks, "backproject_subline_plain"),
                          (ko, "backproject_onehot_plain"),
                          (kb, "backproject_banded_plain"),
                          (bp, "bp_subline_batch")):
            setattr(mod, name, self._counted(getattr(mod, name)))

    def _counted(self, fn):
        def wrapped(*args, **kw):
            self.calls += 1
            return fn(*args, **kw)
        return wrapped


def rel_rmse_chunked(a, b) -> float:
    """rel_rmse of a host (numpy) or device volume ``a`` against the
    device volume ``b``, a few planes at a time on the card, in float64."""
    import numpy as np
    import torch
    scale = max(float(b.abs().max()), 1e-12)
    sq, n = 0.0, 0
    for k0 in range(0, b.shape[0], 64):
        bk = b[k0:k0 + 64].double()
        ak = a[k0:k0 + 64]
        ak = (torch.from_numpy(np.ascontiguousarray(ak)).cuda()
              if isinstance(ak, np.ndarray) else ak).double()
        sq += float(((ak - bk) ** 2).sum())
        n += bk.numel()
    return (sq / n) ** 0.5 / scale


def box_f64(img_t, mats, origin, nz: int):
    """The back-projection of a BOX x BOX-line box at ``origin`` (global
    i, j) over all ``nz`` planes in float64, without the O3 mirror: the
    exact answer the float32 paths round differently. (i, j, k) order."""
    import torch
    ks = launch_modules()[0]
    _, nw, nh = img_t.shape
    i, j = ks._line_grid(BOX, BOX, img_t.device, origin)
    i, j = i.double(), j.double()
    k = torch.arange(nz, dtype=torch.float64, device=img_t.device)
    vol = torch.zeros((BOX * BOX, nz), dtype=torch.float64,
                      device=img_t.device)
    for s in range(img_t.shape[0]):
        m = mats[s].double()
        ok, f, ixc, dx = ks._line_scalars(m, i, j, nw)
        sm = (img_t[s][ixc].double() * (1.0 - dx)[:, None]
              + img_t[s][ixc + 1].double() * dx[:, None])
        y = (((m[1, 0] * i + m[1, 1] * j + m[1, 3]) * f)[:, None]
             + (m[1, 2] * f)[:, None] * k)
        vol += ks._interp(sm, y, nh) * torch.where(ok, f * f, 0.0)[:, None]
    return vol.reshape(BOX, BOX, nz)


def box_of(vol, origin):
    """The BOX x BOX-line box at ``origin`` of a native (nz, ny, nx)
    volume (tensor or numpy), as an (i, j, k) float64 tensor on the card."""
    import numpy as np
    import torch
    i0, j0 = origin
    box = vol[:, j0:j0 + BOX, i0:i0 + BOX]
    if isinstance(box, np.ndarray):
        box = torch.from_numpy(np.ascontiguousarray(box)).cuda()
    return box.permute(2, 1, 0).double()


class ExactBoxes:
    """Line boxes of one problem in float64 (:func:`box_f64`), and the
    untiled volume's rel-RMSE from them: a tiled volume must come as close
    to the exact answer as the untiled one does, within EXACT_RATIO."""

    def __init__(self, p, geom, origins, untiled):
        from repro_torch.core.backproject import transpose_projections
        from repro_torch.core.filtering import fdk_filter_chunk
        from repro_torch.core.geometry import projection_matrices
        img_t = transpose_projections(fdk_filter_chunk(p, geom, geom.n_proj))
        mats = projection_matrices(geom)
        self.origins = origins
        self.exact = [box_f64(img_t, mats, o, geom.nz) for o in origins]
        self.untiled = [rel_rmse(box_of(untiled, o), e)
                        for o, e in zip(origins, self.exact)]

    def check(self, label, vol) -> str:
        out = []
        for o, e, r_u in zip(self.origins, self.exact, self.untiled):
            r = rel_rmse(box_of(vol, o), e)
            require(r <= EXACT_RATIO * r_u, f"{label}: {r:.3e} from float64 "
                    f"on lines {o}, the untiled volume {r_u:.3e}")
            out.append(f"{o} {r:.3e} (untiled {r_u:.3e})")
        return "vs float64 on 8x8-line boxes: " + ", ".join(out)


class PlanLog:
    """Records the launch plan of every launch of the tiled kernel (K1-K6
    take theirs from ``backproject_subline.launch_plan``), by wrapping
    that function where the launches look it up."""

    def __init__(self):
        ks = launch_modules()[0]
        self.seen = {}
        plan_fn = ks.launch_plan

        def logged(shape, *args, **kw):
            lp = plan_fn(shape, *args, **kw)
            key = (tuple(shape), lp.kpt, lp.k_chunk, lp.grid, lp.win_rows)
            self.seen[key] = self.seen.get(key, 0) + 1
            return lp
        ks.launch_plan = logged

    def report(self) -> str:
        """The plans launched since the last report, with their counts."""
        out = [f"{n} x call {shape}: k chunk {k_chunk} (kpt {kpt}), grid "
               f"{grid}, slot {rows} rows"
               for (shape, kpt, k_chunk, grid, rows), n in self.seen.items()]
        self.seen = {}
        return "; ".join(out)


def _tiled_run(label, run, plan, kernel, plain, n_chunks):
    """One tiled run: the launches of ``kernel`` must be one per step and
    chunk, no other kernel and no plain version may run."""
    import torch
    reset_launches()
    plain.calls = 0
    vol = run()
    torch.cuda.synchronize()
    n = launches()
    want = len(plan.steps) * n_chunks
    require(n[kernel] == want and sum(n.values()) == want,
            f"{label}: launches {n}, want {want} of {kernel} (steps "
            f"{len(plan.steps)} x chunks {n_chunks})")
    require(plain.calls == 0, f"{label}: a plain version ran "
            f"{plain.calls} times")
    require(all(s.variant == plan.variant for s in plan.steps),
            f"{label}: a step runs a fallback variant")
    return vol, want


def phase_tiled_p5(seed: int, plain, plans) -> dict:
    """P5 through the tiled walks, each variant against its untiled run
    on the card; async against sync bit for bit. Returns the P5 walls."""
    import numpy as np
    import torch
    import repro_torch
    from repro_torch import ReconOptions
    from repro_torch.configs.ct_paper import get_problem
    from repro_torch.core.fdk import _build_plan

    geom = get_problem("P5").geometry()
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(rng.random(geom.proj_shape_hw,
                                    dtype=np.float32)).cuda()
    walls = {}
    for variant, kernel in FUSED.items():
        untiled = repro_torch.reconstruct(p, geom, variant=variant)
        exact = (ExactBoxes(p, geom, ONEHOT_BOXES, untiled)
                 if variant == "subline_pl" else None)
        walls[(variant, "untiled")] = ms = timed(
            lambda: repro_torch.reconstruct(p, geom, variant=variant))
        print(f"[tiled] P5 {variant} untiled: {ms:.3f} ms (median of 3 "
              f"after a warm-up)")
        print(f"[plan] P5 untiled {variant}: {plans.report()}")
        vols = {}
        for schedule, out, pipeline in TILED_RUNS:
            opts = ReconOptions(variant=variant, schedule=schedule, out=out,
                                pipeline=pipeline, **TILED_P5)
            plan = _build_plan(geom, variant, nb=8, interpret=True,
                               tiling=TILED_P5["tiling"], memory_budget=None,
                               proj_batch=TILED_P5["proj_batch"], out=out,
                               schedule=schedule)
            require(len(plan.steps) == TILED_P5_STEPS,
                    f"P5 tiled plan has {len(plan.steps)} steps")
            label = f"P5 {variant} {schedule} out={out} {pipeline}"

            def run():
                return repro_torch.reconstruct(p, geom, options=opts)
            vol, n = _tiled_run(label, run, plan, kernel, plain,
                                len(plan.chunks))
            require(isinstance(vol, np.ndarray) == (out == "host"),
                    f"{label}: wrong output type {type(vol).__name__}")
            r = rel_rmse_chunked(vol, untiled)
            require(r < BAR, f"{label}: rel_rmse {r:.3e} vs untiled")
            if exact is not None:
                print(f"[tiled] {label}: {exact.check(label, vol)}")
            vol = vol if isinstance(vol, np.ndarray) else vol.cpu().numpy()
            key = (schedule, out)
            same = ""
            if pipeline == "async":
                require(np.array_equal(vol, vols[key]),
                        f"{label} is not bitwise equal to sync")
                same = ", bitwise equal to sync"
            vols[key] = vol
            walls[(variant, schedule, out, pipeline)] = ms = timed(run)
            print(f"[tiled] {label}: {ms:.3f} ms (median of 3 after a "
                  f"warm-up), {ms / walls[(variant, 'untiled')]:.3f} x "
                  f"untiled; {n} launches of {kernel} = "
                  f"{len(plan.steps)} steps x {len(plan.chunks)} chunks; "
                  f"rel_rmse {r:.3e} vs untiled{same}")
        print(f"[plan] P5 tiled {variant}: {plans.report()}")
        if variant == "banded_pl":
            band_schedule_share(p, geom, plan, walls)
        del vols, untiled, exact
    return walls


def band_schedule_share(p, geom, plan, walls) -> None:
    """banded_pl recomputes its band schedule on every call of the tiled
    walk, as the reference does: the time of one call's schedule (a
    paired step's first chunk) and that times the walk's calls, against
    the step-major out="device" sync wall."""
    from repro_torch.core.backproject import transpose_projections
    from repro_torch.core.filtering import fdk_filter_chunk
    from repro_torch.core.geometry import projection_matrices
    from repro_torch.core.tiling import translate_matrices
    kb = launch_modules()[2]
    step = plan.steps[0]
    s0, s1 = plan.chunks[0]
    img_c = transpose_projections(fdk_filter_chunk(p[s0:s1], geom,
                                                   geom.n_proj))
    mt = translate_matrices(projection_matrices(geom)[s0:s1],
                            float(step.i0), float(step.j0),
                            float(step.k_off))
    ms = timed(lambda: kb.band_schedule(img_c, mt, step.call_shape,
                                        block=(4, 8), bw=32, group=8))
    n = len(plan.steps) * len(plan.chunks)
    wall = walls[("banded_pl", "step", "device", "sync")]
    print(f"[tiled] P5 banded_pl band schedule: {ms:.3f} ms for a call "
          f"{step.call_shape} of {s1 - s0} views (median of 3 after a "
          f"warm-up); x {n} calls = {n * ms:.3f} ms, {n * ms / wall:.4f} "
          f"of the step-major out=device sync wall {wall:.3f} ms")


def phase_tiled_p10(seed: int, plain, plans) -> None:
    """P10 (8.8 GB of volume) through the tiled walks with a host volume,
    against the untiled run on the card."""
    import gc
    import torch
    import repro_torch
    from repro_torch.configs.ct_paper import get_problem
    from repro_torch.core.fdk import _build_plan

    prob = get_problem("P10")
    geom = prob.geometry()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    p = torch.rand(geom.proj_shape_hw, generator=gen, device=DEVICE)
    kernel = FUSED["subline_pl"]
    print(f"[tiled] {prob}: projections {tuple(p.shape)} from seed {seed} "
          f"(on the card)")
    repro_torch.reconstruct(p, geom, variant="subline_pl")   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    untiled = repro_torch.reconstruct(p, geom, variant="subline_pl")
    torch.cuda.synchronize()
    ms_untiled = (time.perf_counter() - t0) * 1e3
    print(f"[tiled] P10 subline_pl untiled: {ms_untiled:.3f} ms (one timed "
          f"run after a warm-up)")
    exact = ExactBoxes(p, geom, P10_BOXES, untiled)
    print(f"[plan] P10 untiled subline_pl: {plans.report()}")
    for label, kw in TILED_P10:
        plan = _build_plan(geom, "subline_pl", nb=8, interpret=True,
                           tiling=kw.get("tiling"),
                           memory_budget=kw.get("memory_budget"),
                           proj_batch=None, out=kw.get("out"))
        label = f"P10 subline_pl {label}"

        def run():
            return repro_torch.reconstruct(p, geom, variant="subline_pl",
                                           **kw)
        vol, n = _tiled_run(label, run, plan, kernel, plain,
                            len(plan.chunks))
        del vol
        gc.collect()
        t0 = time.perf_counter()
        vol = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        r = rel_rmse_chunked(vol, untiled)
        print(f"[tiled] {label}: tile {plan.tile_shape}, schedule "
              f"{plan.schedule}, out={plan.out}; {ms:.3f} ms (one timed "
              f"run after a warm-up), {ms / ms_untiled:.3f} x untiled; {n} "
              f"launches of {kernel} = {len(plan.steps)} steps x "
              f"{len(plan.chunks)} chunks; rel_rmse {r:.3e} vs untiled; "
              f"{exact.check(label, vol)}")
        print(f"[plan] {label}: {plans.report()}")
        del vol
        gc.collect()
    del untiled, p, exact
    gc.collect()
    torch.cuda.empty_cache()


def profile_tiled(seed: int, walls: dict) -> None:
    """Where the time of the tiled P5 subline_pl walk goes: the device's
    idle share (busy = the union of the device's intervals) sync against
    async with out="host", and the host placement's share of the wall
    (what out="host" adds over out="device" in the same walk)."""
    import numpy as np
    import torch
    import repro_torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.ct_paper import get_problem

    geom = get_problem("P5").geometry()
    p = torch.from_numpy(np.random.default_rng(seed).random(
        geom.proj_shape_hw, dtype=np.float32)).cuda()
    for pipeline in ("sync", "async"):
        def run():
            return repro_torch.reconstruct(p, geom, variant="subline_pl",
                                           out="host", pipeline=pipeline,
                                           **TILED_P5)
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        busy_us, end = 0.0, None
        for a, b in spans:
            if end is None or a > end:
                busy_us += b - a
                end = b
            elif b > end:
                busy_us += b - end
                end = b
        busy_ms = busy_us / 1e3
        dev_ms = walls[("subline_pl", "step", "device", "sync")]
        host_ms = walls[("subline_pl", "step", "host", pipeline)]
        if busy_ms == 0.0:
            print(f"[profile] tiled P5 subline_pl out=host {pipeline}: the "
                  f"profiler recorded no device time: idle share not "
                  f"measured")
        else:
            print(f"[profile] tiled P5 subline_pl out=host {pipeline}: wall "
                  f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle "
                  f"share {1.0 - busy_ms / wall_ms:.4f}")
        print(f"[profile] tiled P5 subline_pl {pipeline}: host placement "
              f"share of the wall {(host_ms - dev_ms) / host_ms:.4f} "
              f"(out=host {host_ms:.3f} ms against out=device {dev_ms:.3f} "
              f"ms, step-major, medians above)")


def phase_forward() -> None:
    """Phantom -> forward_project -> tiled FDK at FORWARD_N^3 (FORWARD_N
    views, FORWARD_N^2 detector), against the untiled FDK of the same
    projections."""
    import torch
    import repro_torch
    from repro_torch.core.geometry import standard_geometry
    from repro_torch.core.phantom import shepp_logan_3d

    n = FORWARD_N
    geom = standard_geometry(n=n, n_det=n, n_proj=n)
    t0 = time.perf_counter()
    vol = torch.from_numpy(shepp_logan_3d(n)).cuda()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    projs = repro_torch.forward_project(vol, geom, proj_batch=32)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    tiled = repro_torch.reconstruct(projs, geom, variant="subline_pl",
                                    tiling=(64, 64, 32), out="device")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    untiled = repro_torch.reconstruct(projs, geom, variant="subline_pl")
    torch.cuda.synchronize()
    require(bool(torch.isfinite(projs).all()) and tuple(projs.shape)
            == (n, n, n), "forward_project: non-finite or wrong shape")
    r = rel_rmse(tiled, untiled)
    sl = slice(n // 4, 3 * n // 4)
    corr = float(torch.corrcoef(torch.stack([
        tiled[sl, sl, sl].flatten(), vol[sl, sl, sl].flatten()]))[0, 1])
    print(f"[forward] {n}^3 Shepp-Logan phantom, {n} views, {n}x{n} "
          f"detector: phantom {1e3 * (t1 - t0):.1f} ms, forward_project {1e3 * (t2 - t1):.1f} ms, tiled FDK "
          f"{1e3 * (t3 - t2):.1f} ms (host clock, first calls); tiled vs "
          f"untiled FDK rel_rmse {r:.3e}, interior correlation with the "
          f"phantom {corr:.3f}")
    require(r < BAR, "the tiled FDK of forward projections disagrees with "
            "the untiled one")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    phase_plan(PLAN_SHAPES)
    errs = phase_kernels_sweep(args.seed)
    rows = phase_p5(args.seed, errs)
    plain, plans = PlainCalls(), PlanLog()
    walls = phase_tiled_p5(args.seed, plain, plans)
    profile_tiled(args.seed, walls)
    plans.report()
    phase_tiled_p10(args.seed, plain, plans)
    phase_forward()
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
