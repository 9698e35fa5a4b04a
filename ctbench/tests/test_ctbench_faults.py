"""The check fails what it must: the control (the program's own bf16
path, the nearest precision below the configuration's float32) and a
run with the timed path broken underneath, once for each fault a cell
can have. The runs skip the look for a card and drive everything else
of a run on the program's CPU path at smoke size."""

import json

import pytest
import torch

from conftest import run


@pytest.mark.parametrize("workload", ["p5_fdk_batch", "p10_fdk_batch",
                                      "p5_served_open"])
def test_ctbench_control_is_not_correct(smoke_root, workload):
    res = run(smoke_root, workload, seconds=0.4,
              overrides={"precision": "bf16"})
    assert not res["correct"], res
    c = res["check"]["rel_rmse"]
    assert c["value"] > 10 * c["limit"]


def _plant(monkeypatch, name, wrap):
    from repro_torch.runtime import executor
    orig = getattr(executor.PlanExecutor, name)
    monkeypatch.setattr(executor.PlanExecutor, name, wrap(orig))


def unchanged_state(orig):
    """The back-projection step returns its accumulator untouched."""
    def walk(self, img_s, mat_s, sched):
        return torch.zeros_like(orig(self, img_s, mat_s, sched))
    return walk


def half_the_views(orig):
    """Half of each chunk's views left out, the rest counted double."""
    def walk(self, img_s, mat_s, sched):
        img_s = img_s.clone()
        img_s[:, img_s.shape[1] // 2:] = 0
        return 2.0 * orig(self, img_s, mat_s, sched)
    return walk


def altered_answer(orig):
    """The volume altered where it is produced: its first eighth of
    planes zeroed."""
    def walk(self, img_s, mat_s, sched):
        vol = orig(self, img_s, mat_s, sched)
        vol[..., : max(1, vol.shape[-1] // 8)] = 0
        return vol
    return walk


def swapped_lanes(orig):
    """A formed batch hands each request the next request's volume."""
    def batch(self, projections_seq):
        vols = orig(self, projections_seq)
        return vols[1:] + vols[:1]
    return batch


@pytest.mark.parametrize("workload", ["p5_fdk_batch", "p10_fdk_batch",
                                      "p5_served_open"])
@pytest.mark.parametrize("fault", [unchanged_state, half_the_views,
                                   altered_answer], ids=lambda f: f.__name__)
def test_ctbench_fault_is_not_correct(smoke_root, monkeypatch, workload,
                                      fault):
    _plant(monkeypatch, "_walk_steps", fault)
    res = run(smoke_root, workload, seconds=0.4)
    assert not res["correct"], res


def test_ctbench_swapped_lanes_are_not_correct(smoke_root, monkeypatch):
    # a burst that forms batches, every volume kept by the check
    served = smoke_root / "ctbench" / "traffic" / "served_open.json"
    t = json.loads(served.read_text())
    t.update(rate_per_s=400.0, sample=10_000)
    served.write_text(json.dumps(t))
    formed = []

    def counting(orig):
        def batch(self, projections_seq):
            formed.append(len(projections_seq))
            return swapped_lanes(orig)(self, projections_seq)
        return batch
    _plant(monkeypatch, "execute_batch", counting)
    res = run(smoke_root, "p5_served_open", seconds=0.25)
    assert max(formed) > 1, formed
    assert not res["correct"], res


def test_ctbench_check_forgives_one_column_not_two():
    from ctbench.check import trimmed_rel_rmse
    g = torch.Generator().manual_seed(3)
    ref = torch.randn((64, 16), generator=g, dtype=torch.float64)
    got = ref * (1 + 1e-7)
    base = trimmed_rel_rmse(got, ref)
    assert base == pytest.approx(1e-7, rel=1e-3)
    one = got.clone()
    one[5] += 1.0                    # one view's contribution, one column
    assert trimmed_rel_rmse(one, ref) == pytest.approx(base, rel=0.1)
    two = one.clone()
    two[9] += 1.0
    assert trimmed_rel_rmse(two, ref) > 1e3 * base
