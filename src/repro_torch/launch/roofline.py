"""Three-term roofline analysis over dry-run records.

    compute term    = FLOPs_per_device / peak_FLOPs
    memory term     = bytes_per_device / HBM_bw
    collective term = collective_bytes_per_device / link_bw

Hardware constants: the NVIDIA H100 SXM at its 700 W power limit, from
its published figures: 989 TFLOP/s dense bf16, 3.35 TB/s HBM3, 450 GB/s
NVLink each way. ``launch.dryrun`` writes the records from the port's op
counts (``launch.hlo_cost``).

Also derives MODEL_FLOPS (6*N*D train / 2*N*D inference, N = active
params for MoE) and the usefulness ratio MODEL_FLOPS / FLOPs_global,
which catches remat recompute and padding waste.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline --dir artifacts/dryrun
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Optional

PEAK_FLOPS = 989e12        # bf16 dense / card (H100 SXM, 700 W)
HBM_BW = 3.35e12           # bytes/s / card (HBM3)
LINK_BW = 450e9            # bytes/s / card, each way (NVLink)


def model_flops(arch: str, shape_name: str) -> Optional[float]:
    """6*N*D (train) or 2*N*D (prefill/decode), N active params."""
    if arch == "ct-backproject":
        from repro_torch.configs.ct_paper import get_problem
        prob = get_problem(shape_name)
        # per dry-run step: one nb=32 batch; ~8 useful flops per voxel
        # update (2-mix subline interpolation + weighting + accumulate)
        nb = 32
        return 8.0 * prob.vol ** 3 * nb
    from repro_torch.configs import get_config, get_shape
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    n = cfg.active_param_count()
    d = shape.tokens_per_step
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * d


def terms_for(rec: dict) -> Optional[dict]:
    if rec.get("status") != "ok":
        return None
    chips = rec["chips"]
    flops_dev = rec["cost"]["flops_per_device"] or 0.0
    bytes_dev = rec["cost"]["bytes_per_device"] or 0.0
    coll_dev = rec["collectives"]["total_bytes"]
    t_comp = flops_dev / PEAK_FLOPS
    t_mem = bytes_dev / HBM_BW
    t_coll = coll_dev / LINK_BW
    dominant = max((t_comp, "compute"), (t_mem, "memory"),
                   (t_coll, "collective"))[1]
    mf = model_flops(rec["arch"], rec["shape"])
    hlo_global = flops_dev * chips
    useful = (mf / hlo_global) if (mf and hlo_global) else None
    bound = max(t_comp, t_mem, t_coll)
    roofline_frac = (t_comp / bound) if bound else 0.0
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "chips": chips,
        "t_compute_s": t_comp, "t_memory_s": t_mem,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops": mf, "hlo_flops_global": hlo_global,
        "useful_ratio": useful,
        "roofline_fraction": roofline_frac,
        "peak_mem_gb": rec["memory"]["peak_est_bytes"] / 1e9,
    }


def load_dir(d: str):
    recs = []
    for fn in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(fn) as f:
            recs.append(json.load(f))
    return recs


def markdown_table(rows, *, mesh_filter: Optional[str] = None) -> str:
    hdr = ("| arch | shape | t_compute | t_memory | t_collective | "
           "dominant | useful | roofline-frac | peak GB/dev |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in rows:
        if r is None or (mesh_filter and r["mesh"] != mesh_filter):
            continue
        useful = (f"{r['useful_ratio']:.2f}"
                  if r["useful_ratio"] is not None else "-")
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.2e} "
            f"| {r['t_memory_s']:.2e} | {r['t_collective_s']:.2e} "
            f"| {r['dominant']} | {useful} "
            f"| {r['roofline_fraction']:.2f} | {r['peak_mem_gb']:.1f} |\n")
    return "".join(out)


def pick_hillclimb_cells(rows):
    """Three targets: the worst roofline fraction, the most
    collective-bound cell, and the paper's own kernel cell."""
    ok = [r for r in rows if r and r["mesh"] == "pod16x16"
          and r["arch"] != "ct-backproject"]
    worst = min(ok, key=lambda r: r["roofline_fraction"], default=None)
    coll = max(ok, key=lambda r: r["t_collective_s"]
               / max(r["t_compute_s"], 1e-12), default=None)
    ct = [r for r in rows if r and r["arch"] == "ct-backproject"
          and r["mesh"] == "pod16x16"]
    ct_cell = max(ct, key=lambda r: r["t_compute_s"], default=None)
    return worst, coll, ct_cell


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun")
    ap.add_argument("--mesh", default="pod16x16")
    args = ap.parse_args(argv)
    rows = [terms_for(r) for r in load_dir(args.dir)]
    print(markdown_table(rows, mesh_filter=args.mesh))
    worst, coll, ct = pick_hillclimb_cells(rows)
    print("\nhillclimb candidates:")
    for label, r in (("worst-fraction", worst),
                     ("most-collective-bound", coll),
                     ("paper-kernel", ct)):
        if r:
            print(f"  {label}: {r['arch']} x {r['shape']} "
                  f"(dominant={r['dominant']})")


if __name__ == "__main__":
    main()
