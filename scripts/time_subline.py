#!/usr/bin/env python3
"""Time the back-projectors of ``repro_torch`` on one CUDA card, at
problems of the paper's Table 3:

- ``subline``: K1, K2 (nb=8) and ``reconstruct`` with ``subline_pl``;
- ``onehot``: K3, K4 (nb=8) and ``reconstruct`` with ``onehot_pl``;
- ``banded``: K5, K6 (nb=8, bands from ``band_schedule``) and
  ``reconstruct`` with ``banded_pl``.

    python3 scripts/time_subline.py [--src DIR] [--problems P4 P5 P8]
        [--kernels subline onehot banded] [--plans] [--tiled]
        [--volumes DIR] [--tag NAME] [--seed N]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), so that two trees can be timed in turn in one
call (parent, change, change, parent); it uses only the kernel wrappers
and ``reconstruct``, which every tree of the port has. Each time is the
median of 3 CUDA-event timings after one warm-up. The projections are
uniform random numbers from ``--seed``: the kernels' work does not depend
on them. ``--plans`` also times K1 under each launch plan of ``PLANS``
and requires each to give the default plan's volume bit for bit; it
needs a tree whose ``bp_tile_occupancy`` takes the instance as kpt, form
and source, as this checkout's does. ``--tiled`` times the tiled
``reconstruct`` with ``subline_pl`` (``out="device"``, step-major) at
the tilings of ``TILINGS`` under two rules for the rows a plane spans in
``launch_plan``: the call's depth (``ceil(nh / nz)``) and the launch's
matrices (``plane_rows``, the default), in the order depth, matrices,
matrices, depth, and requires the same volume bit for bit; it needs a
tree with the tiled path. ``--volumes DIR`` saves this run's
K3 volume at each problem as ``DIR/k3-<problem>-<tag>.pt`` and compares
it with every other tag's saved there: bit for bit, and by rel-RMSE and
max abs difference, so a run of the change after one of the parent says
whether the two trees' K3 give the same volume. Every line starts with ``--tag``; the first
names the card and its power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GROUPS = ("subline", "onehot", "banded")
# (kpt, win_rows): k chunks of 32*kpt planes, window slots of win_rows rows
PLANS = [(4, 272), (2, 272), (1, 272), (1, 208), (1, 144)]
# problem -> [(tiling, proj_batch)] of --tiled: chip_smoke.py's tiled
# runs, and at P5 slabs whose paired calls hold one full k chunk
TILINGS = {"P5": [((256, 256, 96), 128), ((256, 256, 128), 128)],
           "P10": [((650, 650, 325), None)]}


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


def rel_rmse(a, b) -> float:
    """tests/conftest.py::rel_rmse, on tensors, in float64."""
    a = a.double()
    b = b.double()
    scale = max(float(b.abs().max()), 1e-12)
    return float(((a - b) ** 2).mean().sqrt()) / scale


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--problems", nargs="+", default=["P4", "P5", "P8"])
    ap.add_argument("--kernels", nargs="+", choices=GROUPS,
                    default=["subline"])
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--tiled", action="store_true")
    ap.add_argument("--volumes", default=None)
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
    from repro_torch.kernels import backproject_banded as kb
    from repro_torch.kernels import backproject_onehot as ko
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
        what = f"({prob.det}^2 detector, {prob.vol}^3 volume, " \
               f"{prob.n_proj} views)"
        bands = {}
        for group in (1, 8) if "banded" in args.kernels else ():
            img_b, band, bw = kb.band_schedule(img_t, mats, shape,
                                               block=(4, 8), bw=32,
                                               group=group)
            bands[group] = dict(img_b=img_b, band=band, bw=bw)
        # group -> (names, the single-view kernel, the fused one at nb=8,
        # the reconstruct variant)
        calls = {
            "subline": (("K1", "K2"),
                        lambda: ks.backproject_subline_kernel(img_t, mats,
                                                              shape),
                        lambda: ks.backproject_subline_fused(
                            img_t, mats, shape, nb=8), "subline_pl"),
            "onehot": (("K3", "K4"),
                       lambda: ko.backproject_onehot_kernel(img_t, mats,
                                                            shape),
                       lambda: ko.backproject_onehot_fused(
                           img_t, mats, shape, nb=8), "onehot_pl"),
            "banded": (("K5", "K6"),
                       lambda: kb.backproject_banded_kernel(
                           bands[1]["img_b"], mats, bands[1]["band"], shape,
                           bw=bands[1]["bw"], nw=geom.nw),
                       lambda: kb.backproject_banded_fused(
                           bands[8]["img_b"], mats, bands[8]["band"], shape,
                           bw=bands[8]["bw"], nw=geom.nw, nb=8),
                       "banded_pl"),
        }
        for group in args.kernels:
            (n1, n2), one, fused, variant = calls[group]
            v1, v2 = one(), fused()
            torch.cuda.synchronize()
            if not torch.equal(v1, v2):
                print(f"[{tag}] {label}: {n1} and {n2} differ",
                      file=sys.stderr)
                return 1
            ms1, ms2 = timed(one), timed(fused)
            msr = timed(lambda: repro_torch.reconstruct(
                p, geom, options=ReconOptions(variant=variant)))
            print(f"[{tag}] {label} {what}: {n1} {ms1:.3f} ms, {n2} (nb=8) "
                  f"{ms2:.3f} ms, reconstruct {variant} {msr:.3f} ms; {n1} "
                  f"sum {float(v1.double().sum()):.9e}", flush=True)
            if group == "subline" and args.plans:
                time_plans(tag, label, ks, img_t, mats, shape, geom.nh, v1)
            if group == "subline" and args.tiled:
                for tiling, proj_batch in TILINGS.get(label, ()):
                    time_tiled_rules(tag, label, ks, p, geom, tiling,
                                     proj_batch)
            if group == "onehot" and args.volumes:
                compare_volumes(tag, label, Path(args.volumes), v1)
            del v1, v2
        del p, img_t, bands
        torch.cuda.empty_cache()
    return 0


def compare_volumes(tag, label, where: Path, k3) -> None:
    """Save this tree's K3 volume under ``where`` and compare it with the
    other tags' saved there."""
    import torch
    where.mkdir(parents=True, exist_ok=True)
    torch.save(k3.cpu(), where / f"k3-{label}-{tag}.pt")
    for other in sorted(where.glob(f"k3-{label}-*.pt")):
        other_tag = other.stem[len(f"k3-{label}-"):]
        if other_tag == tag:
            continue
        ref = torch.load(other).to(k3.device)
        diff = (k3 - ref).abs()
        print(f"[{tag}] {label} K3 against {other_tag}'s: bitwise equal "
              f"{bool(torch.equal(k3, ref))}, rel_rmse "
              f"{rel_rmse(k3, ref):.3e}, max abs {float(diff.max()):.3e}, "
              f"voxels that differ {int((k3 != ref).sum())}", flush=True)


def time_tiled_rules(tag, label, ks, p, geom, tiling, proj_batch) -> None:
    """The tiled reconstruct under the depth rule and the matrices rule
    for the rows a plane spans (depth, matrices, matrices, depth)."""
    import torch
    import repro_torch
    default_plan = ks.launch_plan

    def depth_rule(shape, nh, rows=None):
        return default_plan(shape, nh)

    def run():
        return repro_torch.reconstruct(p, geom, variant="subline_pl",
                                       tiling=tiling, proj_batch=proj_batch,
                                       out="device")
    vols = {}
    try:
        for rule in ("depth", "matrices", "matrices", "depth"):
            ks.launch_plan = depth_rule if rule == "depth" else default_plan
            vols.setdefault(rule, run())
            ms = timed(run)
            print(f"[{tag}] {label} tiled reconstruct subline_pl tiling="
                  f"{tiling} proj_batch={proj_batch} out=device, rows a "
                  f"plane from the {rule}: {ms:.3f} ms", flush=True)
    finally:
        ks.launch_plan = default_plan
    torch.cuda.synchronize()
    if not torch.equal(vols["depth"], vols["matrices"]):
        raise SystemExit("the two rules gave different volumes")
    print(f"[{tag}] {label} tiled: both rules give the same volume bit for "
          f"bit", flush=True)


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
            err = lib.bp_tile_occupancy(kpt, ks.LINEAR, 0, nh, win_rows,
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
