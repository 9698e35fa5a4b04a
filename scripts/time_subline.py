#!/usr/bin/env python3
"""Time the sub-line back-projector of ``repro_torch`` on one CUDA card:
K1, K2 (nb=8) and ``reconstruct`` with ``subline_pl``, at problems of the
paper's Table 3.

    python3 scripts/time_subline.py [--src DIR] [--problems P4 P5 P8]
                                    [--plans] [--tag NAME] [--seed N]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), so that two trees can be timed in turn in one
call (parent, change, change, parent); it uses only the kernel wrappers
and ``reconstruct``, which every tree of the port has. Each time is the
median of 3 CUDA-event timings after one warm-up. The projections are
uniform random numbers from ``--seed``: the kernels' work does not depend
on them. ``--plans`` also times K1 of this checkout under each launch plan
of ``PLANS`` and requires each to give the default plan's volume bit for
bit. Every line starts with ``--tag``; the first names the card and its
power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (kpt, win_rows): k chunks of 32*kpt planes, window slots of win_rows rows
PLANS = [(4, 272), (2, 272), (1, 272), (1, 208), (1, 144)]


def timed(fn, reps: int = 3) -> float:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--problems", nargs="+", default=["P4", "P5", "P8"])
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch import ReconOptions
    from repro_torch.configs.ct_paper import get_problem
    from repro_torch.core.backproject import transpose_projections
    from repro_torch.core.geometry import projection_matrices
    from repro_torch.kernels import backproject_subline as ks

    tag = args.tag
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[{tag}] {args.src}: {card.strip()}", flush=True)
    for label in args.problems:
        prob = get_problem(label)
        geom = prob.geometry()
        shape = geom.volume_shape_xyz
        rng = np.random.default_rng(args.seed)
        p = torch.from_numpy(rng.random(geom.proj_shape_hw,
                                        dtype=np.float32)).cuda()
        img_t = transpose_projections(p)
        mats = projection_matrices(geom)
        k1 = ks.backproject_subline_kernel(img_t, mats, shape)
        k2 = ks.backproject_subline_fused(img_t, mats, shape, nb=8)
        torch.cuda.synchronize()
        if not torch.equal(k1, k2):
            print(f"[{tag}] {label}: K1 and K2 differ", file=sys.stderr)
            return 1
        ms1 = timed(lambda: ks.backproject_subline_kernel(img_t, mats,
                                                          shape))
        ms2 = timed(lambda: ks.backproject_subline_fused(img_t, mats, shape,
                                                         nb=8))
        msr = timed(lambda: repro_torch.reconstruct(
            p, geom, options=ReconOptions(variant="subline_pl")))
        print(f"[{tag}] {label} ({prob.det}^2 detector, {prob.vol}^3 "
              f"volume, {prob.n_proj} views): K1 {ms1:.3f} ms, K2 (nb=8) "
              f"{ms2:.3f} ms, reconstruct subline_pl {msr:.3f} ms; K1 sum "
              f"{float(k1.double().sum()):.9e}", flush=True)
        if args.plans:
            time_plans(tag, label, ks, img_t, mats, shape, geom.nh, k1)
        del p, img_t, k1, k2
        torch.cuda.empty_cache()
    return 0


def time_plans(tag, label, ks, img_t, mats, shape, nh, k1) -> None:
    """K1 under each plan of PLANS, with the card's occupancy of it."""
    import ctypes
    import torch
    lib = ks._lib()
    default_plan = ks.launch_plan
    default = default_plan(shape, nh)
    khp = shape[2] - shape[2] // 2
    try:
        for kpt, win_rows in PLANS:
            plan = dataclasses.replace(
                default, kpt=kpt, k_chunk=32 * kpt,
                grid=(default.grid[0], -(-khp // (32 * kpt))),
                win_rows=win_rows)
            blocks, regs, local = (ctypes.c_int(), ctypes.c_int(),
                                   ctypes.c_int())
            err = lib.bp_tile_occupancy(kpt, nh, win_rows,
                                        ctypes.byref(blocks),
                                        ctypes.byref(regs),
                                        ctypes.byref(local))
            smem = lib.bp_tile_smem_bytes(nh, win_rows)
            ks.launch_plan = lambda *a, plan=plan: plan
            out = ks.backproject_subline_kernel(img_t, mats, shape)
            same = bool(torch.equal(out, k1))
            ms = timed(lambda: ks.backproject_subline_kernel(img_t, mats,
                                                             shape))
            print(f"[{tag}] {label} plan kpt {kpt}, window rows "
                  f"{win_rows}: K1 {ms:.3f} ms; {smem} B shared, "
                  f"{blocks.value} blocks/SM (error {err}); bitwise equal "
                  f"to the default plan: {same}", flush=True)
            if not same:
                raise SystemExit(f"plan {plan} changed the volume")
    finally:
        ks.launch_plan = default_plan


if __name__ == "__main__":
    sys.exit(main())
