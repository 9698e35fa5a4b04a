"""On the card: a short P5 cell through the command line is correct, and
its control (the program's bf16 path) is not."""

import json
import subprocess
import sys

import pytest

from conftest import REPO


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run with -m cuda on the card")


@pytest.mark.cuda
def test_ctbench_p5_cell_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "ctbench/run.py", "--workload", "p5_fdk_batch",
         "--seed", str(2 ** 31 + 99), "--seconds", "2", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res
    assert res["device"]["platform"] == "gpu"
    assert res["metrics"]["gups"]["value"] > 0


@pytest.mark.cuda
def test_ctbench_p5_control_on_the_card(card):
    sys.path[:0] = [str(REPO), str(REPO / "src")]
    from ctbench.core import run_cell
    res = run_cell(REPO, "p5_fdk_batch", 2 ** 31 + 98, 1.0, False,
                   overrides={"precision": "bf16"})
    assert not res["correct"], res
