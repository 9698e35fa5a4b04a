"""The LM trainer: the train step, its state, and the fault-tolerant
loop that drives it.

``make_train_step`` builds ``step(state, batch) -> (state, metrics)`` in
the reference's order: the learning rate from the schedule, the loss and
its gradients (or their mean over microbatches), clipping by the global
norm, then AdamW. The state's parameters are the module's own, updated
in place under ``no_grad``, and the AdamW state is keyed by their names.
``train`` wires ``TokenPipeline``, ``Checkpointer``, ``FaultTolerantLoop``
and ``StragglerMonitor`` into a runnable trainer
(``examples/train_lm_torch.py``). The sharded step of a mesh
(``shard_train_step``) belongs to the LM's parallel layer.

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

    return step


def shard_train_step(step_fn, model, mesh, abstract_params, batch_like):
    """The JAX package's step, jitted with explicit shardings on a
    mesh."""
    from repro_torch.runtime.executor import _unported
    raise _unported("shard_train_step (the LM's parallel layer)", "2e")


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
