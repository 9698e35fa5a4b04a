"""repro_torch's dry-run tooling vs the JAX package, on the CPU.

``roofline``'s ``terms_for``, ``markdown_table`` and
``pick_hillclimb_cells`` equal the reference's on the same records (the
reference's three constants monkeypatched to the port's H100 figures);
``model_flops`` equals it for every (arch, shape) and CT problem;
``hlo_cost`` counts an (8, 16) @ (16, 16) matmul run 5 times as the dot
share of the reference's analysis of the compiled scan, and a loop-free
elementwise chain as the reference does (bytes at least the reference's,
eager PyTorch fusing nothing); ``dryrun.run_cell`` writes the reference's
record keys, ``reanalyze`` round-trips, and one full-width decode cell
finishes on the CPU.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.launch import hlo_cost as jhlo
from repro.launch import roofline as jroof

from repro_torch import configs as tconfigs
from repro_torch.configs import ct_paper
from repro_torch.launch import dryrun, hlo_cost, roofline

LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _record(arch, shape, mesh, flops, nbytes, coll, peak, status="ok"):
    chips = 512 if mesh == "pod2x16x16" else 256
    return {"arch": arch, "shape": shape, "mesh": mesh, "chips": chips,
            "status": status,
            "memory": {"peak_est_bytes": peak},
            "cost": {"flops_per_device": flops, "bytes_per_device": nbytes},
            "collectives": {"total_bytes": coll}}


RECORDS = [
    _record("qwen2.5-3b", "train_4k", "pod16x16", 3.1e13, 2.0e12, 4.0e10,
            3.3e10),
    _record("qwen2.5-3b", "decode_32k", "pod16x16", 7.9e9, 8.2e9, 9.9e8,
            1.8e10),
    _record("stablelm-3b", "prefill_32k", "pod16x16", 4.0e12, 6.0e11,
            2.0e9, 2.5e10),
    _record("rwkv6-3b", "long_500k", "pod2x16x16", 1.2e7, 1.9e7, 1.2e7,
            6.9e9),
    _record("ct-backproject", "P5", "pod16x16", 1.7e8, 2.0e9, 0.0, 4.0e8),
    _record("ct-backproject", "P1", "pod16x16", 4.4e7, 5.1e8, 0.0, 8.0e7),
    _record("qwen2.5-3b", "long_500k", "pod16x16", 0, 0, 0, 0,
            status="skipped"),
]


@pytest.fixture
def ref_constants(monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(jroof, name, getattr(roofline, name))


def test_constants_are_the_h100s():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == \
        (989e12, 3.35e12, 450e9)


def test_roofline_rows_equal_reference(ref_constants):
    got = [roofline.terms_for(r) for r in RECORDS]
    want = [jroof.terms_for(r) for r in RECORDS]
    assert got == want
    assert got[-1] is None and {r["dominant"] for r in got[:-1]} == {
        "memory", "collective"}
    for mesh in (None, "pod16x16", "pod2x16x16"):
        assert roofline.markdown_table(got, mesh_filter=mesh) == \
            jroof.markdown_table(want, mesh_filter=mesh)
    assert roofline.pick_hillclimb_cells(got) == \
        jroof.pick_hillclimb_cells(want)


def test_load_dir_reads_the_records(tmp_path, ref_constants):
    for i, rec in enumerate(RECORDS):
        (tmp_path / f"{i}.json").write_text(json.dumps(rec))
    (tmp_path / "0.ops.json.gz").write_bytes(b"")   # an op log is skipped
    assert roofline.load_dir(str(tmp_path)) == jroof.load_dir(str(tmp_path))
    assert len(roofline.load_dir(str(tmp_path))) == len(RECORDS)


CELLS = [(a, s) for a in tconfigs.list_archs() for s in LM_SHAPES] + \
    [("ct-backproject", p.label) for p in ct_paper.PROBLEMS]


def test_model_flops_equal_reference():
    for arch, shape in CELLS:
        assert roofline.model_flops(arch, shape) == \
            jroof.model_flops(arch, shape), (arch, shape)


# --------------------------------------------------------------------------
# op counting against the reference's HLO walk
# --------------------------------------------------------------------------

def _ref_dot_share(hlo, monkeypatch):
    orig = jhlo._op_flops
    monkeypatch.setattr(jhlo, "_op_flops", lambda op, comp: orig(op, comp)
                        if op["opcode"] == "dot" else (0.0, 0.0))
    return jhlo.analyze(hlo)["flops"]


def test_scanned_matmul_flops_equal_reference_dot_share(monkeypatch):
    rng = np.random.RandomState(0)
    x = rng.randn(8, 16).astype(np.float32)
    w = rng.randn(16, 16).astype(np.float32)

    def f(x, w):
        def body(h, _):
            return h @ w, None
        return jax.lax.scan(body, x, None, length=5)[0]

    hlo = jax.jit(f).lower(jnp.asarray(x), jnp.asarray(w)).compile()\
        .as_text()
    total = jhlo.analyze(hlo)["flops"]
    dots = _ref_dot_share(hlo, monkeypatch)
    with hlo_cost.OpCounter() as counter:
        h = torch.from_numpy(x)
        for _ in range(5):
            h = h @ torch.from_numpy(w)
    got = hlo_cost.analyze(counter.log())
    assert got["flops"] == dots == 2 * 8 * 16 * 16 * 5 == 20480
    assert total >= dots      # the reference also counts the loop counter
    np.testing.assert_allclose(h.numpy(), np.asarray(f(x, w)), rtol=1e-4)


def test_elementwise_chain_counts_equal_reference():
    y = np.random.RandomState(1).randn(64, 32).astype(np.float32)

    def g(y):
        return jnp.tanh(y * y + y) - jnp.exp(y)

    want = jhlo.analyze(jax.jit(g).lower(jnp.asarray(y)).compile().as_text())
    with hlo_cost.OpCounter() as counter:
        t = torch.from_numpy(y)
        torch.tanh(t * t + t) - torch.exp(t)
    got = hlo_cost.analyze(counter.log())
    assert got["flops"] == want["flops"] == 5 * 64 * 32
    assert got["trans"] == want["trans"] == 2 * 64 * 32
    assert got["bytes"] >= want["bytes"]
    assert set(got["coll"]) == set(want["coll"])


def test_counter_skips_views_and_tracks_the_peak():
    x = torch.randn(256, 64)
    with hlo_cost.OpCounter() as counter:
        a = x * 2.0                 # 64 KiB
        b = (a.t(), a.view(-1))     # views of a: no bytes moved
        c = a + 1.0                 # a second 64 KiB
        del a, b, c
        d = x - 1.0                 # reuses the freed room
        del d
    log = counter.log()
    ops = {name: view for name, _, _, view, _ in log["ops"]}
    assert ops["aten.t.default"] and not ops["aten.mul.Tensor"]
    got = hlo_cost.analyze(log)
    assert got["bytes"] == 3 * 2 * 256 * 64 * 4
    assert counter.peak_bytes() == 2 * 256 * 64 * 4


# --------------------------------------------------------------------------
# run_cell and reanalyze
# --------------------------------------------------------------------------

REF_MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
                   "alias_bytes", "peak_est_bytes"}


def test_full_width_decode_cell_runs_and_reanalyzes(tmp_path):
    rec = dryrun.run_cell("rwkv6-3b", "long_500k", multi_pod=False,
                          out_dir=str(tmp_path), verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    assert {"arch", "shape", "mesh", "chips", "kind", "status", "memory",
            "cost", "collectives"} <= set(rec)
    assert REF_MEMORY_KEYS <= set(rec["memory"])
    assert {"flops_per_device", "bytes_per_device", "transcendentals"} <= \
        set(rec["cost"])
    assert {"bytes", "counts", "total_bytes"} <= set(rec["collectives"])
    assert rec["chips"] == 256 and rec["kind"] == "decode"
    assert rec["cost"]["flops_per_device"] > 0
    assert rec["collectives"]["bytes"]["all-gather"] > 0
    assert rec["memory"]["argument_bytes"] > 0
    row = roofline.terms_for(rec)
    assert row["useful_ratio"] > 0
    fn = tmp_path / "rwkv6-3b__long_500k__pod16x16.json"
    assert json.loads(fn.read_text()) == json.loads(json.dumps(rec))
    assert os.path.exists(str(fn).replace(".json", ".ops.json.gz"))
    saved = json.loads(fn.read_text())
    spoiled = dict(saved, cost=dict(saved["cost"], flops_per_device=0.0),
                   collectives=dict(saved["collectives"], total_bytes=0))
    fn.write_text(json.dumps(spoiled))
    assert dryrun.reanalyze(str(tmp_path)) == 1
    assert json.loads(fn.read_text()) == saved
    assert roofline.load_dir(str(tmp_path)) == [saved]


def test_512k_decode_of_full_attention_is_skipped():
    rec = dryrun.run_cell("qwen2.5-3b", "long_500k", multi_pod=True,
                          verbose=False)
    assert rec["status"] == "skipped" and rec["mesh"] == "pod2x16x16"
    assert roofline.terms_for(rec) is None


def test_collective_bytes_of_a_log():
    log = {"coll": {"bytes": dict.fromkeys(hlo_cost.COLLECTIVE_KINDS, 0),
                    "counts": dict.fromkeys(hlo_cost.COLLECTIVE_KINDS, 0)}}
    log["coll"]["bytes"]["all-gather"] = 96
    log["coll"]["counts"]["all-gather"] = 2
    got = dryrun.collective_bytes(log)
    assert got["total_bytes"] == 96 and got["counts"]["all-gather"] == 2
    assert dryrun.LM_SHAPE_NAMES == LM_SHAPES
    assert dryrun.CT_SHAPE_NAMES == ("P1", "P5", "P9", "P10")
