"""repro_torch's failover helpers against the JAX package's, on the CPU.

The port of ``tests/test_fault_tolerance.py``: ``FaultTolerantLoop``'s
per-step-index failure accounting, ``Heartbeat``'s warm-up gate,
``StragglerMonitor``'s relative outlier floor, ``FleetStragglerBoard``'s
cross-device flagging and ``remesh_plan``'s shapes and validation. Every
case drives the JAX package's object and the port's through the same
sequences and fakes and asserts the same flags, counts and shapes, and
the contract the JAX test asserts on top. These helpers carry no kernel.
"""

import time

import pytest

from repro.runtime import (FaultTolerantLoop as JLoop,
                           FleetStragglerBoard as JBoard,
                           Heartbeat as JHeartbeat,
                           StragglerMonitor as JMonitor,
                           remesh_plan as j_remesh)

from repro_torch.runtime import (FaultTolerantLoop, FleetStragglerBoard,
                                 Heartbeat, StragglerMonitor, remesh_plan)

PAIRS = {"loop": (JLoop, FaultTolerantLoop),
         "heartbeat": (JHeartbeat, Heartbeat),
         "monitor": (JMonitor, StragglerMonitor),
         "board": (JBoard, FleetStragglerBoard),
         "remesh": (j_remesh, remesh_plan)}


def both(kind):
    """The JAX package's object and the port's, in that order."""
    return PAIRS[kind]


class FakePipeline:
    """batch_at(step) == step: pure, seekable, trivially re-entrant."""

    def batch_at(self, step):
        return step

    def seek(self, step):
        pass


class MemCheckpointer:
    """In-memory checkpoint store with the Checkpointer API surface."""

    def __init__(self):
        self.saved = {}

    def save(self, step, state, blocking=False):
        self.saved[step] = state

    def restore_latest(self, like):
        if not self.saved:
            return None, None
        step = max(self.saved)
        return step, self.saved[step]


# --------------------------------------------------------------------------
# FaultTolerantLoop: per-step-index failure accounting
# --------------------------------------------------------------------------

def _poison_at(bad, log):
    def step_fn(state, batch):
        if batch == bad:
            raise RuntimeError("poison")
        log.append(batch)
        return state + 1, {"loss": 0.0}
    return step_fn


def _transient_at(bad, log):
    armed = {"on": True}

    def step_fn(state, batch):
        if armed["on"] and batch == bad:
            armed["on"] = False
            raise RuntimeError("transient")
        log.append(batch)
        return state + 1, {"loss": 0.0}
    return step_fn


# (save_every, step_fn factory, failing step, num_steps, failures,
#  recoveries or None, the completed batches or None)
LOOP_CASES = {
    # a deterministic poison step exhausts its per-index budget and is
    # skipped; every other step completes exactly once
    "poison_step_skipped_without_checkpoint":
        (100, _poison_at, 3, 6, 3, None, [0, 1, 2, 4, 5]),
    # THE regression: a checkpoint lands before the poison step, so every
    # failure rewinds to it and the replayed steps succeed; the per-index
    # count survives the rewinds and the run terminates
    "poison_step_after_checkpoint_terminates":
        (4, _poison_at, 5, 8, 3, 3, None),
    # one-shot faults keep the old behaviour: restore + replay, no skip
    "transient_failure_still_recovers":
        (2, _transient_at, 3, 6, 1, None, None),
}


@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_fault_tolerant_loop_matches_reference(case):
    save_every, make, bad, num, fails, recov, done = LOOP_CASES[case]
    runs = []
    for cls in both("loop"):
        ck, log = MemCheckpointer(), []
        loop = cls(checkpointer=ck, pipeline=FakePipeline(),
                   save_every=save_every, max_retries_per_step=2)
        end, final = loop.run(0, make(bad, log), start_step=0,
                              num_steps=num)
        runs.append((end, final, loop.failures, loop.recoveries, log,
                     sorted(ck.saved)))
    assert runs[1] == runs[0]
    end, final, failures, recoveries, log, saved = runs[1]
    assert end == num and failures == fails
    if recov is not None:
        assert recoveries == recov
        assert 4 in saved                # the checkpoint that rewound
    if done is not None:
        assert log == done and bad not in log
    if make is _transient_at:
        assert final >= 5                # no step silently skipped


# --------------------------------------------------------------------------
# Heartbeat: warm-up gate
# --------------------------------------------------------------------------

@pytest.mark.parametrize("beat_first", [False, True],
                         ids=["not_stale_during_first_compile",
                              "stale_after_first_beat"])
def test_heartbeat_matches_reference(beat_first):
    """Before any step beats, a long silent gap is warm-up (the first
    step's build), not a hang; after a beat, the same gap is stale."""
    beats = [cls(timeout_s=0.01) for cls in both("heartbeat")]
    if beat_first:
        for hb in beats:
            hb.beat(0)
        assert [hb.stale for hb in beats] == [False, False]
    time.sleep(0.05)
    assert [hb.stale for hb in beats] == [beat_first, beat_first]


# --------------------------------------------------------------------------
# StragglerMonitor: relative outlier floor
# --------------------------------------------------------------------------

# (warm-up durations, (step, duration) probe, flagged)
MONITOR_CASES = {
    # a near-constant window (MAD == 0) must not flag microsecond jitter
    "constant_window_ignores_jitter": ([1.0] * 10, (10, 1.0 + 1e-6), False),
    "constant_window_still_flags_real_straggler":
        ([1.0] * 10, (10, 2.0), True),
    "jittery_window_flags_outlier":
        ([1.0 + 0.01 * (i % 3) for i in range(12)], (12, 10.0), True),
}


@pytest.mark.parametrize("case", sorted(MONITOR_CASES))
def test_straggler_monitor_matches_reference(case):
    warm, (step, dur), flagged = MONITOR_CASES[case]
    seen = []
    for cls in both("monitor"):
        mon = cls(window=16, threshold=3.0)
        flags = [mon.record(i, d) for i, d in enumerate(warm)]
        flags.append(mon.record(step, dur))
        seen.append((flags, list(mon.flagged_steps), mon.median))
    assert seen[1] == seen[0]
    flags, steps, _ = seen[1]
    assert not any(flags[:-1]) and flags[-1] == flagged
    assert steps == ([step] if flagged else [])


# --------------------------------------------------------------------------
# FleetStragglerBoard: cross-device flagging
# --------------------------------------------------------------------------

def test_fleet_board_flags_slow_device():
    got = []
    for cls in both("board"):
        board = cls(4, ratio=1.5)
        flags = [board.record(d, s, 0.1) for s in range(4) for d in range(3)]
        flags.append(board.record(3, 0, 1.0))     # 10x the fleet median
        got.append((flags, board.flagged))
    assert got[1] == got[0]
    assert got[1][0][-1] and got[1][1] == (3,)


def test_fleet_board_unflags_recovered_device():
    got = []
    for cls in both("board"):
        board = cls(2, window=4, ratio=1.5)
        for s in range(4):
            board.record(0, s, 0.1)
        board.record(1, 0, 1.0)
        slow = board.flagged
        for s in range(1, 5):                     # caught back up
            board.record(1, s, 0.1)
        got.append((slow, board.flagged))
    assert got[1] == got[0] == ((1,), ())


def test_fleet_board_validates_device_count():
    for cls in both("board"):
        with pytest.raises(ValueError, match="n_devices"):
            cls(0)


# --------------------------------------------------------------------------
# remesh_plan: validation + degraded-mode shapes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n, want", [(8, (2, 4)), (6, (1, 4)),
                                     (3, (1, 2)), (1, (1, 1))])
def test_remesh_plan_shapes(n, want):
    j_fn, fn = both("remesh")
    assert fn(n, model_parallel=4) == j_fn(n, model_parallel=4) == want


def test_remesh_plan_rejects_empty_fleet():
    for fn in both("remesh"):
        with pytest.raises(ValueError, match="n_devices"):
            fn(0, model_parallel=4)
        with pytest.raises(ValueError, match="model_parallel"):
            fn(4, model_parallel=0)


def test_reshard_tree_waits_for_the_lm_substrate():
    """The tree placement (it raised until the LM's parallel layer was
    ported): after an elastic restart from 8 devices to 6,
    ``remesh_plan``'s (3, 2) mesh takes a tree laid out on (4, 2), bit
    for bit, every entry holding its block (the reference's parity case
    is in tests/test_torch_parallel.py)."""
    import torch
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.elastic import reshard_tree
    shape = remesh_plan(6, model_parallel=2)
    assert shape == j_remesh(6, model_parallel=2) == (3, 2)
    tree = {"layers": {"0": {"mlp": {"wo": torch.arange(
        72, dtype=torch.float32).reshape(12, 6)}}}}
    old = make_mesh((4, 2), ("data", "model"), devices=("cpu",) * 8)
    new = make_mesh(shape, ("data", "model"), devices=("cpu",) * 6)

    def spec_fn(mesh):
        return lambda path, leaf: shd.spec_for_param(path, leaf.shape, mesh)

    placed = reshard_tree(reshard_tree(tree, old, spec_fn(old)), new,
                          spec_fn(new))
    leaf = placed["layers"]["0"]["mlp"]["wo"]
    want = tree["layers"]["0"]["mlp"]["wo"]
    assert leaf.spec == shd.P("model", "data") and len(leaf.blocks) == 6
    assert torch.equal(leaf.full(), want)
    for e, b in enumerate(leaf.blocks):
        assert torch.equal(b, want[leaf.sharding.block_slices(want.shape,
                                                              e)])
