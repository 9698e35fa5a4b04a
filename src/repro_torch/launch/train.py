"""The LM trainer: the train step, its state, and the fault-tolerant
loop that drives it.

``make_train_step`` builds ``step(state, batch) -> (state, metrics)`` in
the reference's order: the learning rate from the schedule, the loss and
its gradients (or their mean over microbatches), clipping by the global
norm, then AdamW. The state's parameters are the module's own, updated
in place under ``no_grad``, and the AdamW state is keyed by their names.
``train`` wires ``TokenPipeline``, ``Checkpointer``, ``FaultTolerantLoop``
and ``StragglerMonitor`` into a runnable trainer
(``examples/train_lm_torch.py``). ``shard_train_step`` runs the step on
an in-process mesh (``launch.sharding``): parameters, AdamW moments and
the batch laid out by the reference's rules.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --smoke --device cpu --steps 20
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile
import time
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import (RunConfig, ShapeConfig, get_config,
                                 get_smoke_config)
from repro_torch.convert import STACKED
from repro_torch.launch import sharding as shd
from repro_torch.models import build_model
from repro_torch.models.layers import generator
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               cosine_warmup)
from repro_torch.optim.grad import accumulate_gradients, value_and_grad

log = logging.getLogger("repro_torch.train")


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]   # the module's parameters, by name
    opt: Any                          # optim.AdamWState


def _on_device(batch, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors on ``device``: integer leaves as
    int64 (token ids), others float32."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v))               # a writable copy of a host batch
        dt = torch.int64 if not t.is_floating_point() else torch.float32
        out[k] = t.to(device=device, dtype=dt)
    return out


def reference_decay(model) -> Dict[str, bool]:
    """Which parameters AdamW decays: those whose leaf in the JAX
    package's tree has ``ndim >= 2``. The reference stacks every layer's
    parameters on a leading axis (``convert.STACKED``), so a per-layer
    norm scale or bias is 2-D there and decays; only the top-level norms
    are spared."""
    return {name: p.ndim + (name.split(".")[0] in STACKED) >= 2
            for name, p in model.named_parameters()}


def make_train_step(model, run: RunConfig, total_steps: int):
    """``step(state, batch) -> (state, {"loss", "gnorm", "lr"})`` of
    ``model`` (from ``models.build_model``), the metrics float32 scalar
    tensors on its device. With ``run.microbatch`` the batch's leaves
    carry a leading microbatch axis, (n_micro, micro_batch, ...), and
    the gradients are their float32 mean. Weight decay follows the
    reference's tree (``reference_decay``)."""
    decay = reference_decay(model)

    def step(state: TrainState, batch) -> Tuple[TrainState, dict]:
        batch = _on_device(batch, model.device)
        lr = cosine_warmup(state.opt.step, base_lr=run.lr,
                           warmup_steps=run.warmup_steps,
                           total_steps=total_steps)
        if run.microbatch:
            loss, grads = accumulate_gradients(model.loss, state.params,
                                               batch)
        else:
            loss, grads = value_and_grad(model.loss, state.params, batch)
        grads, gnorm = clip_by_global_norm(grads, run.grad_clip)
        params, opt = adamw_update(state.params, grads, state.opt, lr=lr,
                                   weight_decay=run.weight_decay,
                                   decay=decay)
        return TrainState(params, opt), {"loss": loss, "gnorm": gnorm,
                                         "lr": lr}

    # what shard_train_step reads to build the same step on a mesh
    step.run, step.total_steps, step.decay = run, total_steps, decay
    return step


def shard_train_step(step_fn, model, mesh, abstract_params, batch_like):
    """The step of ``step_fn`` (from :func:`make_train_step`, whose run
    config, horizon and decay it reads) on ``mesh``. Returns ``(step,
    state_shardings)`` as the reference does: parameters laid out by
    ``sharding.param_specs(abstract_params)``, the AdamW moments by
    ``optimizer_specs`` (mirroring them), the batch by ``batch_specs``
    (its leading dim over ``("pod", "data")``); the metrics are
    replicated scalars on the mesh's first entry.

    ``step(state, batch) -> (state, metrics)`` takes a state laid out by
    ``state_shardings`` (``shard_state``) or a plain one, which it lays
    out first (as a jitted step's ``in_shardings`` would), and returns the
    state laid out. Each batch replica (the entries at one coordinate of
    the batch's axes) all-gathers the parameters into ``model`` on its
    first entry, which must lie on ``model``'s device, runs the unsharded
    loss and gradients on its share of the
    batch, and reduce-scatters the gradients into every entry's float32
    block; the loss and gradients are the replicas' mean. The global norm
    is the sum of the distinct blocks' squares; the clip and AdamW, which
    work element by element, update every entry's blocks. ``model``'s own
    parameters are the gather's target: after a step they hold the
    pre-update values, not the state's.

    This shards storage and the batch, not the model's compute: a
    replica computes on one entry, so one card shows no tensor-parallel
    scaling. ``abstract_params`` is ``models.model.abstract_params``'s
    (``meta`` tensors), the counterpart of ``jax.eval_shape(model.init)``.
    """
    pspecs = shd.param_specs(abstract_params, mesh)
    return sharded_step(step_fn, model, mesh, pspecs,
                        shd.optimizer_specs(pspecs),
                        shd.batch_specs(batch_like, mesh))


def _check_replicas(model, mesh, firsts) -> None:
    """Every batch replica computes in ``model`` (the gather's target), so
    its first entry must lie on ``model``'s device."""
    off = [str(mesh.devices[e]) for e in firsts
           if mesh.devices[e] != model.device]
    if off:
        raise ValueError(f"batch replicas start on {off}, the model lies on "
                         f"{model.device}: a replica computes in the model")


def sharded_step(step_fn, model, mesh, pspecs, ospecs, bspecs):
    """:func:`shard_train_step` with its specs given: ``pspecs`` by
    parameter name, ``ospecs`` an ``AdamWState`` of specs, ``bspecs`` by
    batch key (the dry run shards a microbatched batch on its second
    dim)."""
    from repro_torch.optim import AdamWState

    def nshard(specs):
        return {k: shd.NamedSharding(mesh, s) for k, s in specs.items()}

    state_shardings = TrainState(
        params=nshard(pspecs),
        opt=AdamWState(step=shd.NamedSharding(mesh, shd.P()),
                       m=nshard(ospecs.m), v=nshard(ospecs.v)))
    bshard = nshard(bspecs)
    batch_axes = set().union(*(s.axes() for s in bshard.values()))
    firsts = shd.replicas(mesh, batch_axes)
    _check_replicas(model, mesh, firsts)
    run, total_steps, decay = step_fn.run, step_fn.total_steps, step_fn.decay
    home = mesh.devices[0]
    tparams = dict(model.named_parameters())

    def step(state, batch):
        state = shard_state(state, state_shardings)
        plain = _on_device({k: v for k, v in batch.items()
                            if not isinstance(v, shd.ShardedTensor)}, home)
        batch = {k: shd.lay_out(plain.get(k, v), bshard[k])
                 for k, v in batch.items()}
        lr = cosine_warmup(state.opt.step, base_lr=run.lr,
                           warmup_steps=run.warmup_steps,
                           total_steps=total_steps)
        grads = {n: shd.ShardedTensor.zeros(st.shape, torch.float32,
                                            st.sharding)
                 for n, st in state.params.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=home)
        for r, first in enumerate(firsts):
            with shd.on_entry(first):
                for n, st in state.params.items():
                    st.gather_into(tparams[n].data)
                    tparams[n].requires_grad_(True)
                share = {k: v.blocks[first] for k, v in batch.items()}
                if run.microbatch:
                    loss, g = accumulate_gradients(model.loss, tparams,
                                                   share)
                else:
                    loss, g = value_and_grad(model.loss, tparams, share)
            for n in tparams:
                shd.reduce_scatter_add(grads[n], g.pop(n), record=r == 0)
            loss_sum = loss_sum + loss.to(home)
        inv = 1.0 / len(firsts)
        loss = loss_sum * inv
        with torch.no_grad():
            if len(firsts) > 1:
                for gs in grads.values():
                    for b in gs.blocks:
                        b.mul_(inv)
            gnorm = _clip_blocks(grads, run.grad_clip, home)
            opt = _adamw_blocks(state, grads, lr, run, decay)
        return TrainState(state.params, opt), {"loss": loss,
                                               "gnorm": gnorm, "lr": lr}

    return step, state_shardings


def _clip_blocks(grads: dict, max_norm: float, home) -> torch.Tensor:
    """``optim.clip_by_global_norm`` over laid-out float32 gradients: the
    norm from every distinct block once, the scale applied to every
    entry's block. Returns the norm (on ``home``)."""
    sq = torch.zeros((), dtype=torch.float32, device=home)
    for gs in grads.values():
        for e in gs.representatives():
            sq = sq + torch.sum(gs.blocks[e] ** 2).to(home)
    gn = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    for gs in grads.values():
        for b in gs.blocks:
            b.mul_(scale.to(b.device))
    return gn


def _adamw_blocks(state: TrainState, grads: dict, lr, run, decay):
    """``optim.adamw_update`` on every entry's blocks, in place, one call
    a device; returns the new ``AdamWState`` (its step on the state's
    device)."""
    from repro_torch.optim import AdamWState

    by_dev: dict = {}
    for n, st in state.params.items():
        for e, b in enumerate(st.blocks):
            key = f"{n}@{e}"
            d = by_dev.setdefault(b.device, ({}, {}, {}, {}, {}))
            d[0][key] = b
            d[1][key] = grads[n].blocks[e]
            d[2][key] = state.opt.m[n].blocks[e]
            d[3][key] = state.opt.v[n].blocks[e]
            d[4][key] = decay[n]
    for dev, (p, g, m, v, dec) in by_dev.items():
        adamw_update(p, g, AdamWState(step=state.opt.step.to(dev), m=m, v=v),
                     lr=lr.to(dev), weight_decay=run.weight_decay,
                     decay=dec)
    return AdamWState(step=state.opt.step + 1, m=state.opt.m, v=state.opt.v)


def shard_state(state: TrainState, state_shardings: TrainState, *,
                donate: bool = False) -> TrainState:
    """``state`` laid out by ``state_shardings`` (``shard_train_step``'s):
    each leaf scattered (or kept, where it is laid out so already), the
    step on the mesh's first entry. With ``donate`` the plain leaves are
    removed from ``state``'s dicts as they are laid out, so a moment's
    whole tensor is freed before the next is copied (the reference's
    ``donate_argnums``); ``state`` is then emptied."""
    from repro_torch.optim import AdamWState

    def place(tree, shardings):
        out = {}
        for n in list(shardings):
            leaf = tree.pop(n) if donate else tree[n]
            out[n] = shd.lay_out(leaf, shardings[n])
            del leaf
        return out

    home = state_shardings.opt.step.mesh.devices[0]
    return TrainState(
        params=place(state.params, state_shardings.params),
        opt=AdamWState(step=state.opt.step.to(home),
                       m=place(state.opt.m, state_shardings.opt.m),
                       v=place(state.opt.v, state_shardings.opt.v)))


def init_state(model, run: RunConfig) -> TrainState:
    """The model's parameters drawn afresh from ``run.seed`` (on the
    model's device, as ``build_model`` draws them), with gradients on,
    and a zero AdamW state beside them."""
    resolve_device(model.device)
    model.reset_parameters(generator(run.seed, model.device))
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    return TrainState(params=params, opt=adamw_init(params))


# --------------------------------------------------------------------------
# runnable trainer (host scale)
# --------------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(cfg, run: RunConfig, *, shape=None, pipeline=None,
          quiet: bool = False, device=None):
    """Train ``cfg`` for ``run.steps`` steps on ``device`` (``None`` ->
    the CUDA card), resuming from ``run.checkpoint_dir``'s latest
    checkpoint (restored in place into the model's parameters and
    optimizer state), checkpointing every ``run.checkpoint_every`` steps
    and at the end. Returns (state, {"losses", "end_step",
    "recoveries", "median_step_s"}); a step's time is the host clock
    around the step, synchronized with the device."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import TokenPipeline
    from repro_torch.runtime import FaultTolerantLoop, StragglerMonitor

    dev = resolve_device(device)
    model = build_model(cfg, seed=run.seed, device=dev)
    if shape is None:
        shape = ShapeConfig("toy", "train", 64, 4)
    if pipeline is None:
        pipeline = TokenPipeline(vocab_size=cfg.vocab_size,
                                 seq_len=shape.seq_len,
                                 global_batch=shape.global_batch,
                                 seed=run.seed)
    ckpt = Checkpointer(run.checkpoint_dir)
    loop = FaultTolerantLoop(checkpointer=ckpt, pipeline=pipeline,
                             save_every=run.checkpoint_every)
    monitor = StragglerMonitor()
    step_fn = make_train_step(
        model, run, total_steps=run.schedule_horizon or run.steps)

    start, state = loop.resume_or_init(lambda: init_state(model, run))
    losses = []

    def on_metrics(step, metrics):
        losses.append(float(metrics["loss"]))
        if not quiet and step % run.log_every == 0:
            log.info("step %d loss %.4f gnorm %.3f", step,
                     float(metrics["loss"]), float(metrics["gnorm"]))

    def timed_step(state, batch):
        if run.microbatch:
            batch = {k: v.reshape(run.microbatch, -1, *v.shape[1:])
                     for k, v in batch.items()}
        _sync(dev)
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        _sync(dev)
        monitor.record(pipeline.step, time.perf_counter() - t0)
        return out

    end_step, state = loop.run(state, timed_step, start_step=start,
                               num_steps=run.steps, on_metrics=on_metrics)
    return state, {"losses": losses, "end_step": end_step,
                   "recoveries": loop.recoveries,
                   "median_step_s": monitor.median}


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train an LM of the registry.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(
        args.arch)
    shape = ShapeConfig("cli", "train", args.seq, args.batch)
    run = RunConfig(steps=args.steps, checkpoint_dir=args.ckpt_dir)
    _, info = train(cfg, run, shape=shape, device=args.device)
    print(f"final loss: {info['losses'][-1]:.4f} "
          f"(first {info['losses'][0]:.4f}), steps={info['end_step']}")


if __name__ == "__main__":
    main()
