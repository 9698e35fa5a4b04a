"""Each traffic mix through a whole run on the program's CPU path, and
the open loop's schedule."""

import json

import numpy as np
import pytest

from conftest import run


@pytest.mark.parametrize("workload", ["p5_fdk_batch", "p10_fdk_batch",
                                      "p5_served_open"])
def test_ctbench_cell_runs_and_is_correct(smoke_root, workload):
    res = run(smoke_root, workload, seconds=0.6)
    assert res["correct"], res
    assert res["attempted"] > 0 and res["failed"] == 0
    names = set(res["metrics"])
    assert "setup_s" in names
    assert ("gups" if "batch" in workload else "served_req_per_s") in names
    assert res["check"]["rel_rmse"]["value"] < res["check"]["rel_rmse"][
        "limit"]
    json.dumps(res)


def test_ctbench_traced_run_reads_host_metrics(smoke_root):
    res = run(smoke_root, "p5_served_open", seconds=0.6, trace=True)
    assert res["correct"], res
    m = res["metrics"]
    # no card here: the device's metrics have nothing to read
    assert "device_idle_share.served" not in m and "h2d_ms.served" not in m
    assert m["batch_occupancy.served"]["value"] >= 1.0
    assert m["wait_p95_ms.served"]["value"] >= 0.0
    assert m["request_p95_ms.served"]["value"] >= m["wait_p95_ms.served"][
        "value"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0


def test_ctbench_closed_loop_holds_whole_volumes(smoke_root):
    import time
    from ctbench.check import Sampler
    from ctbench.core import Run, load_cell
    cell = load_cell(smoke_root, "p5_fdk_batch")
    run = Run(config=cell.config, traffic=cell.traffic, seed=9,
              seconds=0.3, device="cpu", traced=False)
    sampler = Sampler(cell.config, cell.traffic, 9, "cpu")
    gen = cell.generator.Generator(run, sampler)
    gen.setup()
    run.window_start = time.perf_counter()
    gen.window()
    # the window closes at the completion of the volume in flight
    assert run.window_s >= 0.3
    assert run.window_s == run.records[-1]["done"]
    assert run.attempted == len(run.records) == sampler.offered
    assert [r["scan"] for r in run.records[:4]] == [0, 1, 0, 1][
        :len(run.records)]
    assert len(sampler.kept) == min(2, len(run.records))


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 3, 2 ** 40 + 17])
def test_ctbench_open_loop_schedule_is_the_same_for_every_seed(seed):
    from ctbench.core import _module
    from conftest import REPO
    gen = _module(REPO / "ctbench" / "generators" / "open_loop.py")
    due, scans = gen.schedule(7.0, 30.0, 4, seed, 5, 27)
    due0, scans0 = gen.schedule(7.0, 30.0, 4, 12345, 5, 27)
    assert len(due) == 210 and due[0] == 0.0
    # the arrivals are the traffic mix's, the seed picks the scans
    assert np.array_equal(due, due0)
    assert np.all(np.bincount(scans, minlength=4) == np.bincount(
        scans0, minlength=4))
    assert not np.array_equal(scans, scans0)
    gaps = np.diff(np.append(due, 30.0))
    assert abs(gaps.sum() - 30.0) < 1e-9
    # every block of 5 arrivals holds the same set of gaps, the rate
    q = np.sort(gaps[:5])
    for b in range(0, 210, 5):
        assert np.allclose(np.sort(gaps[b:b + 5]), q)
    assert abs(q.sum() - 5 / 7.0) < 0.02
    other, _ = gen.schedule(7.0, 30.0, 4, seed, 5, 28)
    assert not np.array_equal(other, due)
