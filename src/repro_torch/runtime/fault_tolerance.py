"""Fault-tolerant training loop wrapper (the port's copy of the JAX
package's module, pure Python, same behaviour).

Posture for 1000+ nodes (what runs here is the single-process realization
of the same contract; on a real cluster the heartbeat transport is the
coordinator's key-value store):

  * every step is re-entrant: state = (params, opt_state, data_step), all
    derivable from (checkpoint, pipeline.seek);
  * failures surface as exceptions from the step (device loss,
    NaN-guard, preemption signal) -> the loop restores the last
    checkpoint, reseeks the pipeline and continues;
  * repeated failure at the SAME step (poison batch / systematic fault)
    triggers skip-ahead of one step after `max_retries_per_step`;
  * heartbeats timestamp progress so an external supervisor can detect a
    hung host (see Heartbeat.stale).
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Any, Callable, Dict, Optional

log = logging.getLogger("repro_torch.runtime")


class Heartbeat:
    """Progress timestamps for an external supervisor.

    ``stale`` is gated on the first completed step (``step >= 0``): the
    gap between construction and the first beat includes the warm-up of
    the first step (its kernel builds), which can legitimately exceed
    ``timeout_s`` — a supervisor must not shoot a host that is still
    compiling. Once any
    step has beaten, a silent gap longer than ``timeout_s`` means hung.
    """

    def __init__(self, timeout_s: float = 300.0):
        self.timeout_s = timeout_s
        self.last_beat = time.monotonic()
        self.step = -1

    def beat(self, step: int) -> None:
        self.step = step
        self.last_beat = time.monotonic()

    @property
    def stale(self) -> bool:
        if self.step < 0:        # warmup: no step has completed yet
            return False
        return (time.monotonic() - self.last_beat) > self.timeout_s


class FaultTolerantLoop:
    """Drives `step_fn(state, batch) -> (state, metrics)` with recovery."""

    def __init__(self, *, checkpointer, pipeline, save_every: int = 50,
                 max_retries_per_step: int = 2, heartbeat: Heartbeat = None,
                 nan_guard: bool = True):
        self.ckpt = checkpointer
        self.pipeline = pipeline
        self.save_every = save_every
        self.max_retries = max_retries_per_step
        self.heartbeat = heartbeat or Heartbeat()
        self.nan_guard = nan_guard
        self.failures = 0
        self.recoveries = 0

    def resume_or_init(self, init_state_fn: Callable[[], Any]):
        """Restore the latest checkpoint or build fresh state."""
        like = init_state_fn()
        step, state = self.ckpt.restore_latest(like)
        if step is None:
            return 0, like
        self.pipeline.seek(step)
        log.info("resumed from checkpoint step %d", step)
        return step, state

    def run(self, state, step_fn: Callable, *, start_step: int,
            num_steps: int, on_metrics: Optional[Callable] = None):
        step = start_step
        # Failures are counted PER STEP INDEX, never reset by successes:
        # when a checkpoint precedes a deterministic poison step, the
        # restore rewinds to ck_step and the replayed steps all succeed —
        # a consecutive-attempt counter (the old `retries_here`) would
        # reset on each of them and the loop would recover forever. The
        # per-index count survives the replay, so the poison step's
        # budget is exceeded after max_retries+1 failures no matter how
        # many checkpoint rewinds happen in between.
        fail_counts: Dict[int, int] = collections.Counter()
        while step < start_step + num_steps:
            if fail_counts[step] > self.max_retries:
                log.warning("skipping poisoned step %d", step)
                step += 1          # poison skip-ahead (re-entrant steps)
                continue
            batch = self.pipeline.batch_at(step)
            try:
                state, metrics = step_fn(state, batch)
                if self.nan_guard and _has_nan(metrics):
                    raise FloatingPointError(
                        f"non-finite loss at step {step}: {metrics}")
            except Exception as e:  # noqa: BLE001 — any step fault recovers
                self.failures += 1
                fail_counts[step] += 1
                log.warning("step %d failed (%s); recovering", step, e)
                ck_step, restored = self.ckpt.restore_latest(state)
                if restored is not None:
                    state = restored
                    step = ck_step
                self.recoveries += 1
                continue
            self.heartbeat.beat(step)
            if on_metrics:
                on_metrics(step, metrics)
            step += 1
            if step % self.save_every == 0:
                self.ckpt.save(step, state)
        self.ckpt.save(step, state, blocking=True)
        return step, state


def _has_nan(metrics) -> bool:
    import math
    loss = metrics.get("loss") if isinstance(metrics, dict) else None
    if loss is None:
        return False
    try:
        v = float(loss)
    except TypeError:
        return False
    return math.isnan(v) or math.isinf(v)
