"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with
its configurations cut to smoke size, run through the program's CPU
path (the plain PyTorch versions of its kernels)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: smoke sizes: the P5 configuration's structure at a CPU test's size
SMOKE = {"volume": 16, "detector": 24, "views": 16}
#: a limit between the smoke size's float32 readings (4e-7 to 9e-7) and
#: its bf16 control's (3e-4 to 6e-4)
SMOKE_LIMIT = 1e-5


def make_root(tmp: Path, rate: float = 40.0) -> Path:
    """A benchmark root at ``tmp``: BENCHMARK.json and a copy of
    ctbench/ (without its tests), every configuration at smoke size
    under a file of its own, the open loop at ``rate``."""
    shutil.copytree(REPO / "ctbench", tmp / "ctbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg.update(SMOKE)
        cfg["check"] = {"columns": 64, "rel_rmse_limit": SMOKE_LIMIT}
        c["file"] = c["file"].replace(".json", "_smoke.json")
        (tmp / c["file"]).write_text(json.dumps(cfg))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    served = tmp / "ctbench" / "traffic" / "served_open.json"
    t = json.loads(served.read_text())
    t["rate_per_s"] = rate
    served.write_text(json.dumps(t))
    return tmp


@pytest.fixture
def smoke_root(tmp_path):
    return make_root(tmp_path)


def run(root, workload, seed=2 ** 31 + 11, seconds=1.0, trace=False,
        **kw):
    from ctbench.core import run_cell
    return run_cell(root, workload, seed, seconds, trace, device="cpu",
                    **kw)
