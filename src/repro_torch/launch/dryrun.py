"""Dry run: one step of every (arch x shape x mesh) cell, on ``meta``.

The JAX package lowers and compiles each cell for 512 placeholder host
devices and reads the compiled executable's memory and cost analyses.
The port runs the cell's step eagerly on an abstract mesh
(``launch.mesh.make_abstract_mesh``: every entry the ``meta`` device)
at full width, under ``launch.hlo_cost.OpCounter``. Per cell this
produces (and prints):

  * memory, per device: ``argument_bytes``, the largest entry's blocks
    of parameters, AdamW moments and batch (or decode state), from the
    specs; ``temp_bytes``, the largest entry's peak of live
    intermediates, tracked on ``meta`` by storage lifetime, plus the
    parameters a batch replica gathers on its first entry;
    ``output_bytes`` the step's new results (inside ``temp`` too, so
    ``alias_bytes`` takes them out of ``peak_est_bytes`` again);
  * cost: the counted FLOPs, bytes and transcendentals over the mesh's
    entries (an even split of the step's totals, which ``roofline``
    multiplies back by the chip count), and the totals;
  * collectives: the in-process mesh's result bytes by kind, split alike.

The port's mesh computes each batch replica whole on one entry
(``launch.sharding``), so the per-device figures are the step's cost
spread over a deployment's cards, not what one entry of this process
did. Records keep the reference's keys (``memory``, ``cost``,
``collectives``, ``status``), so ``roofline.load_dir`` reads them; the
op log is saved beside each record (``.ops.json.gz``) for
:func:`reanalyze`.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
      --shape decode_32k [--multi-pod] [--out artifacts/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch ct-backproject \\
      --shape P5 [--multi-pod]
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.launch import hlo_cost
from repro_torch.launch import sharding as shd

_COLLECTIVES = shd.COLLECTIVE_KINDS


def collective_bytes(log: dict) -> dict:
    """Result bytes and calls per collective kind of an op log (totals
    over the mesh's entries)."""
    out = {k: int(log["coll"]["bytes"][k]) for k in _COLLECTIVES}
    counts = {k: int(log["coll"]["counts"][k]) for k in _COLLECTIVES}
    return {"bytes": out, "counts": counts,
            "total_bytes": sum(out.values())}


# --------------------------------------------------------------------------
# cell construction: each returns (run, info), run() performs the step
# --------------------------------------------------------------------------

def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def _lm_cell(arch: str, shape_name: str, mesh):
    from repro_torch.configs import RunConfig, get_config, get_shape
    from repro_torch.launch import train as trn
    from repro_torch.launch.serve import shard_decode_step
    from repro_torch.models import build_model
    from repro_torch.models.pshint import activation_policy

    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if shape.kind == "decode" and shape.seq_len >= 100_000 and \
            not cfg.sub_quadratic:
        return None, {"status": "skipped",
                      "reason": "full attention at 512k decode"}
    model = build_model(cfg, device="meta")
    aparams = dict(model.named_parameters())
    pspecs = shd.param_specs(aparams, mesh)
    msize = mesh.axis_size("model")

    def make_policy(batch_dim: int):
        """Sequence-parallel residuals and a TP ffn hidden (no "heads"
        hint, as the reference)."""
        bx = shd._batch_axes(mesh, batch_dim)
        pol = {"ffn": shd.NamedSharding(mesh, shd.P(bx, None, "model"))}
        if shape.kind != "decode" and shape.seq_len % msize == 0:
            pol["residual"] = shd.NamedSharding(mesh,
                                                shd.P(bx, "model", None))
        return pol

    def nshard(specs):
        return {k: shd.NamedSharding(mesh, s) for k, s in specs.items()}

    gathered = _param_bytes(model)
    if shape.kind == "train":
        # microbatch accumulation: 8 microbatches where they divide
        n_micro = 8 if shape.global_batch % (8 * 8) == 0 else 1
        micro = shape.global_batch // n_micro
        specs = model.input_specs(shape)
        batch = {k: _meta((n_micro, micro) + tuple(s.shape[1:]), s.dtype)
                 for k, s in specs.items()}
        ospecs = shd.optimizer_specs(pspecs)
        mb_axes = shd._batch_axes(mesh, micro)
        bspecs = {k: shd.P(None, mb_axes, *([None] * (v.ndim - 2)))
                  for k, v in batch.items()}
        step_fn = trn.make_train_step(model, RunConfig(microbatch=n_micro),
                                      total_steps=1000)
        step, state_sh = trn.sharded_step(step_fn, model, mesh, pspecs,
                                          ospecs, bspecs)
        from repro_torch.optim import AdamWState
        state = trn.TrainState(
            params={n: shd.ShardedTensor.scatter(p, state_sh.params[n])
                    for n, p in aparams.items()},
            opt=AdamWState(
                step=_meta((), torch.int32),
                m={n: shd.ShardedTensor.zeros(p.shape, torch.float32,
                                              state_sh.opt.m[n])
                   for n, p in aparams.items()},
                v={n: shd.ShardedTensor.zeros(p.shape, torch.float32,
                                              state_sh.opt.v[n])
                   for n, p in aparams.items()}))
        sbatch = {k: shd.ShardedTensor.scatter(v, shd.NamedSharding(
            mesh, bspecs[k])) for k, v in batch.items()}
        policy = make_policy(micro)

        def run():
            with activation_policy(policy):
                return step(state, sbatch)[1]
        args = (state.params, state.opt.m, state.opt.v, sbatch)
        return (run, args, gathered), {"kind": "train", "n_micro": n_micro}

    if shape.kind == "prefill":
        specs = model.input_specs(shape)
        bshard = nshard(shd.batch_specs(specs, mesh))
        params = {n: shd.ShardedTensor.scatter(p, shd.NamedSharding(
            mesh, pspecs[n])) for n, p in aparams.items()}
        sbatch = {k: shd.ShardedTensor.scatter(v, bshard[k])
                  for k, v in specs.items()}
        axes = set().union(*(s.axes() for s in bshard.values()))
        policy = make_policy(shape.global_batch)

        def run():
            outs = []
            with activation_policy(policy):
                for first in shd.replicas(mesh, axes):
                    with shd.on_entry(first):
                        for n, st in params.items():
                            st.gather_into(aparams[n].data)
                        share = {k: v.blocks[first]
                                 for k, v in sbatch.items()}
                        logits, _, _ = model.prefill(share, shape.seq_len)
                    outs.append(logits)
            return outs
        return (run, (params, sbatch), gathered), {"kind": "prefill"}

    # decode: one new token against a seq_len-deep cache
    B = shape.global_batch
    fn, cache_like, cspecs = shard_decode_step(model, mesh, aparams, B,
                                               shape.seq_len)
    scache = _lay_out_tree(cache_like, cspecs, mesh)
    token = _meta((B, 1), torch.int64)

    def run():
        return fn(scache, token, shape.seq_len - 1)[0]
    return (run, (scache,), gathered), {"kind": "decode"}


def _lay_out_tree(tree, specs, mesh):
    if isinstance(tree, dict):
        return {k: _lay_out_tree(v, specs[k], mesh) for k, v in tree.items()}
    return shd.ShardedTensor.scatter(tree, shd.NamedSharding(mesh, specs))


def _ct_cell(problem_label: str, mesh):
    """Mesh-sharded back-projection of one nb=32 batch (the plain
    ladder)."""
    from repro_torch.configs.ct_paper import get_problem
    from repro_torch.core.distributed import make_distributed_bp

    prob = get_problem(problem_label)
    geom = prob.geometry()
    nb = 32
    fn, _ = make_distributed_bp(geom, mesh, nb=nb)
    img = _meta((nb, geom.nw, geom.nh))
    mats = _meta((nb, 3, 4))

    def run():
        return fn(img, mats, (0.0, 0.0))
    arg = 4 * (nb * geom.nw * geom.nh + nb * 12)
    return (run, arg, 0), {"kind": "ct-backproject", "nb": nb}


def _argument_bytes(args, mesh) -> int:
    if isinstance(args, int):
        return args
    return max(shd.entry_bytes(args, mesh))


def _out_bytes(out) -> int:
    leaves = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (list, tuple)) else [out])
    return sum(t.numel() * t.element_size() for t in leaves
               if isinstance(t, torch.Tensor))


def _cost_fields(la: dict, chips: int) -> tuple:
    cost = {"flops_per_device": la["flops"] / chips,
            "bytes_per_device": la["bytes"] / chips,
            "transcendentals": la["trans"] / chips,
            "flops_total": la["flops"], "bytes_total": la["bytes"]}
    coll = {"bytes": {k: v / chips for k, v in la["coll"].items()},
            "counts": la["coll_counts"],
            "total_bytes": la["total_collective_bytes"] / chips,
            "total_bytes_all_entries": la["total_collective_bytes"]}
    return cost, coll


# --------------------------------------------------------------------------
# cell runner
# --------------------------------------------------------------------------

def _mesh_for(multi_pod: bool):
    from repro_torch.launch.mesh import make_abstract_mesh
    if multi_pod:
        return make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_abstract_mesh((16, 16), ("data", "model"))


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: str | None = None, verbose: bool = True) -> dict:
    """Run one cell's step on the abstract production mesh ((16, 16), or
    (2, 16, 16) with ``multi_pod``) and return its record; with
    ``out_dir``, write it as ``{arch}__{shape}__{mesh}.json`` beside the
    op log (``.ops.json.gz``)."""
    t0 = time.time()
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    n_chips = 512 if multi_pod else 256
    mesh = _mesh_for(multi_pod)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "chips": n_chips}
    log = None
    try:
        if arch == "ct-backproject":
            cell, info = _ct_cell(shape_name, mesh)
        else:
            cell, info = _lm_cell(arch, shape_name, mesh)
        rec.update(info)
        if cell is None:              # skipped cell
            rec["status"] = rec.get("status", "skipped")
        else:
            run, args, gathered = cell
            counter = hlo_cost.OpCounter()
            with counter:
                out = run()
            log = counter.log()
            la = hlo_cost.analyze(log)
            arg_b = _argument_bytes(args, mesh)
            out_b = _out_bytes(out)
            temp_b = counter.peak_bytes() + gathered
            cost, coll = _cost_fields(la, n_chips)
            rec.update({
                "status": "ok",
                "run_s": round(time.time() - t0, 1),
                "ops_dispatched": log["n_ops"],
                "memory": {
                    "argument_bytes": arg_b,
                    "output_bytes": out_b,
                    "temp_bytes": temp_b,
                    "alias_bytes": out_b,
                    "gathered_param_bytes": gathered,
                    "peak_est_bytes": arg_b + temp_b,
                },
                "cost": cost,
                "collectives": coll,
            })
            if verbose:
                print(f"[{arch} x {shape_name} x {mesh_name}] ran in "
                      f"{rec['run_s']}s, {log['n_ops']} ops")
                print(f"  memory/dev: arguments {arg_b / 1e9:.3f} GB, "
                      f"temp {temp_b / 1e9:.3f} GB")
                print(f"  cost: flops/dev={cost['flops_per_device']:.3e} "
                      f"bytes/dev={cost['bytes_per_device']:.3e}")
                print(f"  collectives: "
                      f"{ {k: int(v) for k, v in la['coll_counts'].items() if v} } "
                      f"total {coll['total_bytes'] / 1e6:.1f} MB/dev")
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[{arch} x {shape_name} x {mesh_name}] FAILED: "
                  f"{rec['error']}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fn = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1)
        if rec["status"] == "ok" and log is not None:
            with gzip.open(fn.replace(".json", ".ops.json.gz"), "wt") as f:
                json.dump(log, f)
    return rec


def reanalyze(out_dir: str) -> int:
    """Recompute the cost and collective fields from the saved op logs
    (no step is run) after a change to ``hlo_cost``'s model."""
    import glob

    n = 0
    for fn in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        path = fn.replace(".json", ".ops.json.gz")
        if not os.path.exists(path):
            continue
        with open(fn) as f:
            rec = json.load(f)
        if rec.get("status") != "ok":
            continue
        with gzip.open(path, "rt") as f:
            log = json.load(f)
        rec["cost"], rec["collectives"] = _cost_fields(
            hlo_cost.analyze(log), rec["chips"])
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1)
        n += 1
    return n


LM_SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
CT_SHAPE_NAMES = ("P1", "P5", "P9", "P10")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--reanalyze", action="store_true",
                    help="recompute cost fields from the saved op logs")
    args = ap.parse_args(argv)

    if args.reanalyze:
        n = reanalyze(args.out)
        print(f"reanalyzed {n} cells")
        sys.exit(0)

    from repro_torch.configs import list_archs

    cells = []
    if args.all:
        for arch in list_archs():
            for shape in LM_SHAPE_NAMES:
                cells.append((arch, shape))
        for shape in CT_SHAPE_NAMES:
            cells.append(("ct-backproject", shape))
    else:
        cells.append((args.arch, args.shape))

    meshes = [args.multi_pod]
    if args.both_meshes:
        meshes = [False, True]

    failures = 0
    for multi_pod in meshes:
        for arch, shape in cells:
            mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
            out_fn = os.path.join(
                args.out, f"{arch}__{shape}__{mesh_name}.json")
            if args.skip_existing and os.path.exists(out_fn):
                with open(out_fn) as f:
                    prev = json.load(f)
                if prev.get("status") in ("ok", "skipped"):
                    print(f"[{arch} x {shape} x {mesh_name}] cached "
                          f"({prev['status']})")
                    continue
            rec = run_cell(arch, shape, multi_pod=multi_pod,
                           out_dir=args.out)
            if rec["status"] == "error":
                failures += 1
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
