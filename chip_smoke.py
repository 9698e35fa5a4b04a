#!/usr/bin/env python3
"""On-card smoke test of repro_torch, the PyTorch + CUDA port.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--seed N]

It builds the CUDA kernels from the sources in the checkout, holds each
kernel against its plain PyTorch version and the oracle at the sweep
shapes and at the main path's shape, drives the FDK main path at the
paper's P5 size (512^3 voxels, 512 views, 512x512 detector) through
``repro_torch.reconstruct``, checks that the path launched the kernels and
agrees with the plain ``algorithm1_mp`` path on the card, and times the
kernels, their plain versions, the filter and the whole reconstruction
with CUDA events (median of 3 after a warm-up).

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
# instance of the kernel (nz up to 2048) and, at nh=1024, the staging
# depth capped by shared memory.
DEPTHS = [(70, 64, 4), (129, 96, 5), (200, 128, 4), (500, 256, 3),
          (1000, 512, 4), (1301, 1024, 8)]
BLOCKS = [(1, 8), (2, 8), (4, 8), (4, 16)]
NBS = [2, 3, 8]
FLOPS_PER_UPDATE = 8.0            # the repo's ct-backproject cost model
PEAK_FP32_FLOPS = 67e12           # H100 SXM, non-tensor FP32
PEAK_BYTES = 3.35e12              # H100 SXM HBM3
KERNELS = {
    "backproject_subline_kernel": ("K1 backproject_subline_kernel",
                                   "src/repro/kernels/backproject_subline.py:204"),
    "backproject_subline_fused": ("K2 backproject_subline_fused",
                                  "src/repro/kernels/backproject_subline.py:240"),
}
SOURCE = "src/repro_torch/kernels/csrc/backproject_subline.cu"


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
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build(["backproject_subline"])
    print(f"[build] backproject_subline.cu in "
          f"{time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.build_log['backproject_subline']['seconds']:.2f} s)")
    for line in _build.build_log["backproject_subline"]["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[build]   {line.strip()}")


def _sweep_case(geom, seed, errs):
    import numpy as np
    import torch
    from repro_torch.core.backproject import transpose_projections
    from repro_torch.core.geometry import projection_matrices
    from repro_torch.kernels import ops
    from repro_torch.kernels.backproject_subline import (
        backproject_subline_fused, backproject_subline_kernel,
        backproject_subline_plain)
    from repro_torch.kernels.ref import backproject_ref

    npj = geom.n_proj
    rng = np.random.RandomState(seed)
    img = torch.from_numpy(
        rng.rand(npj, geom.nh, geom.nw).astype(np.float32)).cuda()
    img_t = transpose_projections(img)
    mats = projection_matrices(geom)
    shape = geom.volume_shape_xyz
    plain = backproject_subline_plain(img_t, mats, shape)
    ref = backproject_ref(img_t, mats, shape)
    mid = geom.nz // 2 if geom.nz % 2 else None

    def check(label, kernel, out):
        torch.cuda.synchronize()
        r_plain, r_ref = rel_rmse(out, plain), rel_rmse(out, ref)
        errs[kernel] = max(errs[kernel], float((out - plain).abs().max()))
        msg = f"{label} vs plain {r_plain:.2e} vs oracle {r_ref:.2e}"
        require(r_plain < BAR and r_ref < BAR, msg)
        if mid is not None:
            r_mid = rel_rmse(out[..., mid], ref[..., mid])
            msg += f" middle plane {r_mid:.2e}"
            require(r_mid < BAR, msg)
        return max(r_plain, r_ref), msg

    lines = []
    for block in BLOCKS:
        lines.append(check(f"K1 block={block}", "backproject_subline_kernel",
                           ops._run_padded(backproject_subline_kernel, img_t,
                                           mats, shape, block)))
        for nb in NBS + [npj]:
            if npj % nb == 0:
                lines.append(check(
                    f"K2 block={block} nb={nb}", "backproject_subline_fused",
                    ops._run_padded(backproject_subline_fused, img_t, mats,
                                    shape, block, nb=nb)))
        for nb in NBS:      # the routed wrapper: K2 when nb | np, else K1
            out = ops.backproject_subline(img_t, mats, shape, nb=nb,
                                          block=block, proj_loop=True)
            lines.append(check(f"ops block={block} nb={nb}",
                               "backproject_subline_kernel" if npj % nb
                               else "backproject_subline_fused", out))
    print(f"[kernels] volume {shape}, detector {geom.nw}x{geom.nh}, {npj} "
          f"views: {len(lines)} cases pass; worst: {max(lines)[1]}")


def phase_kernels_sweep(seed: int) -> dict:
    import dataclasses
    from repro_torch.core.geometry import standard_geometry
    errs = {name: 0.0 for name in KERNELS}
    geoms = [standard_geometry(n=n, n_det=det, n_proj=npj)
             for n, det, npj in SWEEP]
    geoms += [dataclasses.replace(standard_geometry(n=nz, n_det=det,
                                                    n_proj=npj), nx=16, ny=16)
              for nz, det, npj in DEPTHS]
    for i, geom in enumerate(geoms):
        _sweep_case(geom, seed + i, errs)
    return errs


def phase_p5(seed: int, errs: dict) -> dict:
    import numpy as np
    import torch
    import repro_torch
    from repro_torch import ReconOptions
    from repro_torch.configs.ct_paper import get_problem
    from repro_torch.core.backproject import transpose_projections
    from repro_torch.core.filtering import fdk_filter_chunk
    from repro_torch.core.geometry import projection_matrices
    from repro_torch.kernels import backproject_subline as ks
    from repro_torch.kernels.ref import backproject_ref

    prob = get_problem("P5")
    geom = prob.geometry()
    shape = geom.volume_shape_xyz
    rng = np.random.default_rng(seed)
    p_host = rng.random(geom.proj_shape_hw, dtype=np.float32)
    p = torch.from_numpy(p_host).cuda()
    print(f"[P5] {prob}: projections {tuple(p.shape)} from seed {seed}, "
          f"{prob.updates:.3e} voxel-view updates")

    # ---- the main path, driven through the public entry point -------------
    launches = {}
    vols = {}
    for label, opts, kernel in (
            ("subline_pl nb=8", ReconOptions(variant="subline_pl"),
             "backproject_subline_fused"),
            ("subline_pl nb=1", ReconOptions(variant="subline_pl", nb=1),
             "backproject_subline_kernel")):
        ks.reset_launches()
        vols[label] = repro_torch.reconstruct(p_host, geom, options=opts)
        torch.cuda.synchronize()
        launches[kernel] = ks.LAUNCHES[kernel]
        print(f"[P5] reconstruct {label}: launches {dict(ks.LAUNCHES)}")
        require(ks.LAUNCHES[kernel] > 0,
                f"the main path ({label}) never launched {kernel}")
    ks.reset_launches()
    plain_vol = repro_torch.reconstruct(
        p, geom, options=ReconOptions(variant="algorithm1_mp"))
    torch.cuda.synchronize()
    require(sum(ks.LAUNCHES.values()) == 0,
            "the algorithm1_mp path launched a kernel")
    for label, vol in vols.items():
        require(tuple(vol.shape) == geom.volume_shape_zyx
                and bool(torch.isfinite(vol).all()),
                f"{label}: non-finite values or wrong shape")
        r = rel_rmse(vol, plain_vol)
        print(f"[P5] {label} vs algorithm1_mp on the card: rel_rmse {r:.3e}")
        require(r < BAR, f"{label} disagrees with algorithm1_mp: {r:.3e}")
    require(torch.equal(vols["subline_pl nb=8"], vols["subline_pl nb=1"]),
            "K1 and K2 main paths are not bitwise equal")
    del vols, plain_vol

    # ---- each kernel at the main path's shape against its plain version ---
    img_t = transpose_projections(fdk_filter_chunk(p, geom, geom.n_proj))
    mats = projection_matrices(geom)
    calls = {
        "backproject_subline_kernel":
            lambda: ks.backproject_subline_kernel(img_t, mats, shape),
        "backproject_subline_fused":
            lambda: ks.backproject_subline_fused(img_t, mats, shape, nb=8),
    }
    plain = ks.backproject_subline_plain(img_t, mats, shape)
    ref = backproject_ref(img_t, mats, shape)
    r = rel_rmse(plain, ref)
    print(f"[P5] plain version vs oracle: rel_rmse {r:.3e}")
    require(r < BAR, "the plain version disagrees with the oracle at P5")
    for name, call in calls.items():
        out = call()
        torch.cuda.synchronize()
        r = rel_rmse(out, plain)
        errs[name] = max(errs[name], float((out - plain).abs().max()))
        print(f"[P5] {KERNELS[name][0]} vs plain: rel_rmse {r:.3e}, max abs "
              f"{errs[name]:.3e} (max |plain| {float(plain.abs().max()):.3e})")
        require(r < BAR, f"{name} disagrees with its plain version at P5")
    del plain, ref

    # ---- times --------------------------------------------------------------
    n_bytes = 4 * (img_t.numel() + mats.numel() + geom.nx * geom.ny * geom.nz)
    flops = FLOPS_PER_UPDATE * prob.updates
    bound_ms = max(flops / PEAK_FP32_FLOPS, n_bytes / PEAK_BYTES) * 1e3
    bound_by = ("operations" if flops / PEAK_FP32_FLOPS > n_bytes / PEAK_BYTES
                else "bytes")
    print(f"[P5] bound: {flops:.3e} FLOP / 67 TFLOP/s = "
          f"{flops / PEAK_FP32_FLOPS * 1e3:.3f} ms, {n_bytes:.3e} B / "
          f"3.35 TB/s = {n_bytes / PEAK_BYTES * 1e3:.3f} ms -> "
          f"{bound_ms:.3f} ms ({bound_by})")
    times = {name: timed(call) for name, call in calls.items()}
    plain_ms = timed(lambda: ks.backproject_subline_plain(img_t, mats, shape))
    for name, ms in times.items():
        print(f"[P5] {KERNELS[name][0]}: {ms:.3f} ms, "
              f"{prob.updates / ms / 1e6:.1f} GUPS, {bound_ms / ms:.3f} of "
              f"the bound")
    for nb in (2, 4):        # K2's staging depth: nb projections per step
        ms = timed(lambda: ks.backproject_subline_fused(img_t, mats, shape,
                                                        nb=nb))
        print(f"[P5] K2 at nb={nb}: {ms:.3f} ms")
    print(f"[P5] plain version: {plain_ms:.3f} ms")
    filter_ms = timed(lambda: fdk_filter_chunk(p, geom, geom.n_proj))
    print(f"[P5] filter (fdk_filter_chunk, whole set): {filter_ms:.3f} ms")
    recon_ms = timed(lambda: repro_torch.reconstruct(
        p, geom, options=ReconOptions(variant="subline_pl")))
    print(f"[P5] reconstruct subline_pl (nb=8) from device projections: "
          f"{recon_ms:.3f} ms, {prob.updates / recon_ms / 1e6:.1f} GUPS")
    profile_reconstruct(p, geom)
    return {name: {"name": KERNELS[name][0], "route": "cuda",
                   "source": SOURCE, "replaces": KERNELS[name][1],
                   "launches": launches[name], "max_abs_err": errs[name],
                   "ms": times[name], "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None}
            for name in KERNELS}


def profile_reconstruct(p, geom) -> None:
    """Where the time of one warm P5 reconstruction goes on the card:
    device time by kernel from torch.profiler, and the device's idle
    share of the host-clock wall."""
    import torch
    import repro_torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        return repro_torch.reconstruct(p, geom, variant="subline_pl")

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
        print("[profile] the profiler recorded no device time: device "
              "breakdown not measured")
        return
    print(f"[profile] reconstruct subline_pl at P5: wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms, idle share "
          f"{1.0 - busy_ms / wall_ms:.4f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"[profile]   {ms:10.3f} ms  {ms / busy_ms:.4f}  {name[:90]}")


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
    errs = phase_kernels_sweep(args.seed)
    rows = phase_p5(args.seed, errs)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
