"""A later change adds a configuration, a traffic mix and a per-layer
metric as new files and new entries of BENCHMARK.json, and edits no
file of ctbench/ that is there."""

import hashlib
import json

from conftest import SMOKE, SMOKE_LIMIT, run


def _digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted((root / "ctbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_ctbench_adds_config_traffic_and_metric_from_new_files(smoke_root):
    before = _digest(smoke_root)
    base = smoke_root / "ctbench"
    # a configuration: P8 of the paper's Table 3, at smoke size here
    cfg = json.loads((base / "configs" / "ct_p5_smoke.json").read_text())
    cfg.update(SMOKE, name="ct_p8", volume=20,
               source="arXiv:2104.13248, Table 3, problem P8")
    cfg["check"] = {"columns": 64, "rel_rmse_limit": SMOKE_LIMIT}
    (base / "configs" / "ct_p8.json").write_text(json.dumps(cfg))
    # a traffic mix: the closed loop over a pool of three scans
    (base / "traffic" / "batch_closed3.json").write_text(json.dumps(
        {"generator": "closed_loop", "pool": 3, "sample": 3}))
    # a per-layer metric with a reader of its own
    (base / "metrics" / "volumes_done.batch.py").write_text(
        '"""volumes_done.batch: volumes the window completed."""\n\n\n'
        'def read(run):\n    return float(len(run.records)) or None\n')
    bench = json.loads((smoke_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ct_p8", "source":
                             "https://arxiv.org/abs/2104.13248",
                             "file": "ctbench/configs/ct_p8.json",
                             "reduced": [], "why": "P8"})
    bench["workloads"].append({"name": "p8_fdk_batch3", "config": "ct_p8",
                               "traffic": "batch_closed3", "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "gups":
            m["workloads"].append("p8_fdk_batch3")
    bench["per_layer"].append({"name": "volumes_done.batch", "unit":
                               "volumes", "better": "higher", "source":
                               "host_clock", "layer": "host path",
                               "moves": "gups",
                               "workloads": ["p8_fdk_batch3"]})
    (smoke_root / "BENCHMARK.json").write_text(json.dumps(bench))

    res = run(smoke_root, "p8_fdk_batch3", seconds=0.4)
    assert res["correct"], res
    assert set(res["metrics"]) == {"gups", "setup_s"}
    res = run(smoke_root, "p8_fdk_batch3", seconds=0.4, trace=True)
    assert res["correct"], res
    assert res["metrics"]["volumes_done.batch"]["value"] >= 1
    after = _digest(smoke_root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "ctbench/configs/ct_p8.json", "ctbench/traffic/batch_closed3.json",
        "ctbench/metrics/volumes_done.batch.py"}
