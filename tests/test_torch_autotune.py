"""repro_torch's autotuner against the JAX package's, on the CPU.

The contracts of ``tests/test_autotune.py`` that need no service, on the
port: the fingerprint (with the device in it), request keys equal string
for string to the JAX package's, the tolerant JSON cache (and its format,
shared with the JAX package, whose entries never resolve here: the
fingerprints differ), measure-then-hit, exact-mode tuning bit for bit
equal to the heuristic for the plain variants and for each CUDA variant's
plain path, scoped auto/explicit keys, the façade's ``variant="auto"``,
self-maintaining entries, a second process's cache hit, and
``method="sart"`` tuning. Wherever a test checks the volume of a WIDE
search, a fixed cost table stands in for the measurement, so no timing
race picks the knob the test checks; volumes are held against the JAX
package's output at rel-RMSE 1e-5, and bit for bit where the JAX package
asserts bit identity."""

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

import repro
from repro.core.geometry import standard_geometry as j_geom
from repro.runtime import autotune as jat
from repro.runtime import solvers as jsolvers

import repro_torch
from repro_torch import ReconOptions, convert
from repro_torch.core.fdk import fdk_reconstruct
from repro_torch.kernels import backproject_banded as kb
from repro_torch.kernels import backproject_onehot as ko
from repro_torch.kernels import backproject_subline as ks
from repro_torch.kernels import forward_project as kf
from repro_torch.runtime import autotune as at
from repro_torch.runtime import solvers, telemetry
from repro_torch.runtime.autotune import (TunedConfig, TuningCache,
                                          autotune, fingerprint_key,
                                          request_key, resolve_config)
from repro_torch.runtime.executor import PlanExecutor, ProgramCache
from repro_torch.runtime.planner import plan_reconstruction

from conftest import rel_rmse

ROOT = Path(__file__).resolve().parents[1]
BAR = 1e-5
OPTS = dict(nb=2, tiling=(8, 8, 16), proj_batch=4)
CPU = dict(device="cpu")
# one program cache for the module: candidates repeat across tests
_PCACHE = ProgramCache()


@pytest.fixture(scope="module")
def setup():
    g = j_geom(n=16, n_det=24, n_proj=6)
    t = convert.geometry_from_reference(dataclasses.asdict(g))
    rng = np.random.RandomState(3)
    p = rng.rand(g.n_proj, g.nh, g.nw).astype(np.float32)
    ref = np.asarray(repro.reconstruct(
        jnp.asarray(p), g, options=repro.ReconOptions(
            variant="algorithm1_mp", **OPTS)))
    return g, t, p, ref


@pytest.fixture(autouse=True)
def _no_launches():
    """The CPU never reaches a CUDA kernel: every variant runs its plain
    version on CPU tensors."""
    mods = (ks, ko, kb, kf)
    for mod in mods:
        mod.reset_launches()
    yield
    for mod in mods:
        assert sum(mod.LAUNCHES.values()) == 0, mod.LAUNCHES


def _tune(t, p, variant, cache, **kw):
    kw.setdefault("budget_s", 30.0)
    kw.setdefault("iters", 1)
    opts = {**OPTS, **kw.pop("opts", {})}
    return autotune(t, variant, **opts, cache=cache, program_cache=_PCACHE,
                    projections=p, device="cpu", **kw)


def _np(vol):
    return vol if isinstance(vol, np.ndarray) else vol.numpy()


def _cost_table(monkeypatch, costs, name="_measure_config"):
    """Stand a fixed cost table in for the measurement: a candidate's
    seconds are the first matching entry of ``costs`` (a predicate on the
    config, seconds), else 1.0. Returns the list of measured configs."""
    seen = []

    def fake(geom, cfg, *a, **k):
        seen.append(cfg)
        for match, sec in costs:
            if match(cfg):
                return sec
        return 1.0

    monkeypatch.setattr(at, name, fake)
    return seen


# ---- fingerprint + request key --------------------------------------------

def test_fingerprint_shape_and_stability():
    a, b = at.hardware_fingerprint("cpu"), at.hardware_fingerprint("cpu")
    assert a == b and len(a) == 4 and a[0] == "cpu"
    assert a[3] == torch.__version__
    assert fingerprint_key(a) == fingerprint_key(device="cpu")
    assert fingerprint_key(a).count("|") == 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            at.hardware_fingerprint()
    else:
        fp = at.hardware_fingerprint()
        assert fp[0] == "cuda" and " sm_" in fp[1]


REQUESTS = [
    ("algorithm1_mp", dict(nb=2)),
    ("subline_pl", dict(nb=2, tiling=(8, 8, 16), proj_batch=4)),
    ("banded_pl", dict(nb=4, out="host", schedule="chunk")),
    ("onehot_pl", dict(nb=2, precision="bf16", k_chunk=4)),
    ("auto", dict(nb=2, tiling=(8, 8, 16), proj_batch=4)),
    ("auto", dict(nb=2, proj_loop=False)),
    ("subline_pl", dict(nb=2, solver="sart")),
    ("share_mp", dict(memory_budget=1 << 16, nb=2)),
]


@pytest.mark.parametrize("variant,kw", REQUESTS)
def test_request_key_equals_jax(setup, variant, kw):
    g, t, _, _ = setup
    base = {k: v for k, v in kw.items() if k in
            ("nb", "tiling", "memory_budget", "proj_batch", "out",
             "schedule", "precision", "solver")}
    extra = {k: v for k, v in kw.items() if k not in base}
    _, tplan = at._heuristic_config(t, variant, **CPU, **kw)
    _, jplan = jat._heuristic_config(g, variant, **kw)
    assert at._request_key(variant, tplan, extra) == \
        jat._request_key(variant, jplan, extra)
    assert request_key(tplan, "auto") == jat.request_key(jplan, "auto")


# ---- TuningCache robustness -----------------------------------------------

def test_cache_roundtrip_restores_tuples(setup, tmp_path):
    _, t, _, _ = setup
    cache = TuningCache(str(tmp_path / "t.json"))
    plan = plan_reconstruction(t, "subline_pl", nb=2, tile_shape=(8, 8, 16),
                               proj_batch=4, block=(4, 8))
    cfg = at.config_from_plan(plan, pipeline="async", pipeline_depth=4)
    cache.store("fp", "rk", cfg)
    back = cache.lookup("fp", "rk")
    assert back is not None and back.key == cfg.key
    assert dict(back.options)["block"] == (4, 8)
    assert isinstance(back.tile_shape, tuple)
    hash(back.build_plan(t).bucket_key)


def test_missing_cache_file_is_heuristic_fallback(setup, tmp_path):
    _, t, _, _ = setup
    missing = str(tmp_path / "nope" / "t.json")
    assert TuningCache(missing).lookup("fp", "rk") is None
    cfg = resolve_config(t, "subline_batch_mp", cache=TuningCache(missing),
                         **CPU, **OPTS)
    assert cfg.source == "heuristic"
    kw = dict(nb=2, tile_shape=(8, 8, 16), proj_batch=4)
    assert plan_reconstruction(t, "subline_batch_mp", tuning=missing,
                               **CPU, **kw) == \
        plan_reconstruction(t, "subline_batch_mp", **kw)


def test_corrupt_cache_file_is_heuristic_fallback(setup, tmp_path):
    _, t, _, _ = setup
    bad = tmp_path / "t.json"
    for garbage in ("{not json", '{"version": 99}', "[1, 2]", ""):
        bad.write_text(garbage)
        cache = TuningCache(str(bad))
        assert cache.lookup("fp", "rk") is None
        assert resolve_config(t, "subline_batch_mp", cache=cache, **CPU,
                              **OPTS).source == "heuristic"
    bad.write_text("{not json")
    cache = TuningCache(str(bad))
    plan = plan_reconstruction(t, "subline_batch_mp", nb=2)
    cache.store("fp", "rk", at.config_from_plan(plan))
    assert cache.lookup("fp", "rk") is not None
    json.loads(bad.read_text())


def test_malformed_entry_is_a_miss(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"version": 1, "fingerprints": {
        "fp": {"rk": {"variant": "algorithm1_mp"}}}}))
    assert TuningCache(str(p)).lookup("fp", "rk") is None


def test_default_cache_path_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_TORCH_TUNING_CACHE", raising=False)
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "jax.json"))
    path = at.default_cache_path()
    assert path.endswith(os.path.join("repro_torch", "tuning.json"))
    assert path != jat.default_cache_path()
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", str(tmp_path / "t.json"))
    assert at.default_tuning_cache().path == str(tmp_path / "t.json")


def test_jax_cache_file_is_read_but_never_resolves(setup, tmp_path):
    """Both packages write one format: the port reads the JAX package's
    entry field for field, and the JAX package the port's, but neither
    resolves the other's winner (the fingerprints differ)."""
    g, t, _, _ = setup
    path = str(tmp_path / "shared.json")
    jcfg, jplan = jat._heuristic_config(g, "subline_batch_mp", **OPTS)
    jfp = jat.fingerprint_key()
    jkey = jat._request_key("subline_batch_mp", jplan, {})
    jat.TuningCache(path).store(jfp, jkey, dataclasses.replace(
        jcfg, wall_us=5.0, baseline_us=9.0, source="measured", trials=3))
    back = TuningCache(path).lookup(jfp, jkey)
    assert back is not None and back.key == jcfg.key
    assert (back.wall_us, back.trials) == (5.0, 3)
    assert resolve_config(t, "subline_batch_mp", cache=path, **CPU,
                          **OPTS).source == "heuristic"
    tcfg, tplan = at._heuristic_config(t, "subline_batch_mp", **CPU, **OPTS)
    tkey = at._request_key("subline_batch_mp", tplan, {})
    assert tkey == jkey
    tfp = fingerprint_key(device="cpu")
    assert tfp != jfp
    TuningCache(path).store(tfp, tkey, tcfg)
    assert jat.TuningCache(path).lookup(tfp, tkey).key == tcfg.key
    assert jat.resolve_config(g, "subline_batch_mp", cache=path,
                              **OPTS).source == "cache"   # its own entry
    assert len(TuningCache(path)) == 2


# ---- measured search + persistence ----------------------------------------

def test_autotune_measures_then_hits_cache(setup, tmp_path, monkeypatch):
    _, t, p, _ = setup
    cache = TuningCache(str(tmp_path / "t.json"))
    cfg = _tune(t, p, "subline_batch_mp", cache)
    assert cfg.source == "measured" and cfg.trials > 0
    assert cfg.baseline_us > 0 and cfg.wall_us > 0
    assert len(cache) == 1

    def boom(*a, **k):
        raise AssertionError("cache hit must not re-measure")

    monkeypatch.setattr(at, "_measure_config", boom)
    again = _tune(t, p, "subline_batch_mp", cache)
    assert again.source == "cache" and again.trials == 0
    assert again.key == cfg.key


def test_fingerprint_mismatch_retunes(setup, tmp_path, monkeypatch):
    _, t, p, _ = setup
    cache = TuningCache(str(tmp_path / "t.json"))
    _tune(t, p, "subline_batch_mp", cache)
    monkeypatch.setattr(at, "hardware_fingerprint",
                        lambda device=None: ("cpu", "other", 128, "9.9"))
    cfg = _tune(t, p, "subline_batch_mp", cache)
    assert cfg.source == "measured" and cfg.trials > 0
    assert len(cache) == 2


def test_candidate_spans_and_trajectory(setup, tmp_path):
    _, t, p, _ = setup
    telemetry.clear()
    n0 = len(telemetry.tune_trajectory())
    with telemetry.tracing():
        cfg = _tune(t, p, "subline_batch_mp",
                    TuningCache(str(tmp_path / "t.json")))
    spans = [e for e in telemetry.events()
             if e["name"] == "autotune.candidate"]
    assert len(spans) == cfg.trials
    assert all(e["args"]["wall_us"] > 0 for e in spans)
    rec = telemetry.tune_trajectory()[n0:]
    assert len(rec) == 1 and rec[0]["tuned_wall"] == cfg.wall_us
    telemetry.clear()


# ---- exactness contract ----------------------------------------------------

@pytest.mark.parametrize("variant", ["algorithm1_mp", "subline_batch_mp",
                                     "share_mp", "symmetry_mp",
                                     "subline_pl", "onehot_pl", "banded_pl"])
def test_tuned_config_bit_identical(setup, tmp_path, variant):
    """Exact tuning searches only schedule/pipeline/depth: the tuned
    volume equals the heuristic's bit for bit, for the plain variants
    and for each CUDA variant's plain path, and the JAX package's
    algorithm1_mp within 1e-5."""
    _, t, p, ref = setup
    cfg = _tune(t, p, variant, TuningCache(str(tmp_path / "t.json")))
    assert cfg.variant == variant and cfg.trials > 1
    heur = _np(fdk_reconstruct(p, t, variant=variant, **OPTS, **CPU))
    tuned = _np(PlanExecutor.from_config(t, cfg, cache=_PCACHE,
                                         **CPU).reconstruct(p))
    assert np.array_equal(heur, tuned), cfg
    assert rel_rmse(tuned, ref) < BAR


def test_explicit_request_never_resolves_auto_winner(setup, tmp_path,
                                                     monkeypatch):
    _, t, p, _ = setup
    cache = TuningCache(str(tmp_path / "t.json"))
    _cost_table(monkeypatch, [(lambda c: c.variant == "subline_mp", 0.1)])
    cfg = _tune(t, p, "auto", cache)
    assert cfg.variant == "subline_mp"
    assert resolve_config(t, "auto", cache=cache, **CPU,
                          **OPTS).source == "cache"
    explicit = resolve_config(t, "algorithm1_mp", cache=cache, **CPU,
                              **OPTS)
    assert explicit.source == "heuristic"
    assert explicit.variant == "algorithm1_mp"
    _tune(t, p, "algorithm1_mp", cache)
    explicit = resolve_config(t, "algorithm1_mp", cache=cache, **CPU,
                              **OPTS)
    assert explicit.source == "cache" and explicit.variant == "algorithm1_mp"


def test_planner_and_engine_resolve_the_winner(setup, tmp_path,
                                               monkeypatch):
    """plan_reconstruction(variant="auto") and TiledReconstructor("auto")
    resolve the persisted winner of their device's fingerprint by
    lookup, and equal the winner's own plan."""
    from repro_torch.runtime.engine import TiledReconstructor
    _, t, p, ref = setup
    path = str(tmp_path / "t.json")
    _cost_table(monkeypatch, [(lambda c: c.variant == "subline_mp"
                               and c.precision == "f32", 0.1)])
    cfg = _tune(t, p, "auto", TuningCache(path))
    kw = dict(nb=2, tile_shape=(8, 8, 16), proj_batch=4)
    plan = plan_reconstruction(t, "auto", tuning=path, **CPU, **kw)
    assert plan == cfg.build_plan(t) and plan.variant == "subline_mp"
    eng = TiledReconstructor(t, "auto", tuning=path, **CPU, **kw)
    assert eng.variant == "subline_mp"
    assert rel_rmse(_np(eng.reconstruct(p)), ref) < BAR


def test_facade_auto_uses_persisted_winner(setup, tmp_path):
    """An exact auto search keeps algorithm1_mp: reconstruct(variant=
    "auto", tuning=path) resolves it and equals the heuristic bit for
    bit (and the JAX package within 1e-5)."""
    _, t, p, ref = setup
    path = str(tmp_path / "t.json")
    cfg = _tune(t, p, "auto", TuningCache(path), exact=True)
    resolved = resolve_config(t, "auto", cache=path, **CPU, **OPTS)
    assert resolved.source == "cache" and resolved.key == cfg.key
    heur = _np(fdk_reconstruct(p, t, variant="algorithm1_mp", **OPTS, **CPU))
    via = _np(repro_torch.reconstruct(
        p, t, options=ReconOptions(variant="auto", tuning=path, **OPTS),
        **CPU))
    assert np.array_equal(heur, via)
    assert rel_rmse(via, ref) < BAR


@pytest.mark.parametrize("winner", [
    dict(variant="subline_pl", options=(("proj_loop", False),)),
    dict(variant="onehot_pl", options=(("proj_loop", True),)),
    dict(variant="banded_pl", tile_shape=(4, 4, 8)),
    dict(variant="symmetry_mp", proj_batch=2, schedule="chunk"),
])
def test_wide_search_volume_under_a_cost_table(setup, tmp_path, monkeypatch,
                                               winner):
    """A wide search whose measurement is a fixed cost table picks the
    cheapest candidate; the façade's variant="auto" runs it, and its
    volume is the JAX package's for the same knobs within 1e-5."""
    g, t, p, ref = setup
    path = str(tmp_path / "t.json")

    def hits(c):
        return sum(getattr(c, k) == v if k != "options"
                   else set(v) <= set(c.options) for k, v in winner.items())

    # partial credit: the greedy sweep reaches the winner field by field
    monkeypatch.setattr(at, "_measure_config", lambda geom, c, *a, **k:
                        9.0 if c.precision == "bf16" else 1.0 / (1 + hits(c)))
    cfg = _tune(t, p, "auto", TuningCache(path))
    assert hits(cfg) == len(winner) and cfg.precision == "f32"
    assert cfg.speedup == pytest.approx(1 + len(winner))
    via = _np(repro_torch.reconstruct(
        p, t, options=ReconOptions(variant="auto", tuning=path, **OPTS),
        **CPU))
    assert rel_rmse(via, ref) < BAR
    plan_kw = dict(cfg.options, nb=cfg.nb, proj_batch=cfg.proj_batch,
                   tiling=cfg.tile_shape, schedule=cfg.schedule,
                   out=cfg.out)
    if cfg.variant in ("subline_mp", "symmetry_mp"):
        jvol = np.asarray(repro.reconstruct(
            jnp.asarray(p), g, options=repro.ReconOptions(
                variant=cfg.variant, **plan_kw)))
        assert rel_rmse(via, jvol) < BAR


def test_auto_accepts_cross_variant_options(setup, tmp_path):
    _, t, p, _ = setup
    path = str(tmp_path / "t.json")
    cache = TuningCache(path)
    assert resolve_config(t, "auto", cache=cache, proj_loop=False, **CPU,
                          **OPTS).source == "heuristic"
    v = fdk_reconstruct(p, t, variant="auto", tuning=path, proj_loop=False,
                        **OPTS, **CPU)
    assert _np(v).shape == (16, 16, 16)
    with pytest.raises(ValueError, match="no registered variant"):
        resolve_config(t, "auto", cache=cache, bogus_knob=1, **CPU, **OPTS)
    _tune(t, p, "auto", cache, exact=True, proj_loop=False)
    assert resolve_config(t, "auto", cache=cache, proj_loop=False, **CPU,
                          **OPTS).source == "cache"
    assert resolve_config(t, "auto", cache=cache, **CPU,
                          **OPTS).source == "heuristic"


def test_explicit_schedule_is_pinned(setup, tmp_path):
    _, t, p, _ = setup
    cfg = _tune(t, p, "subline_batch_mp",
                TuningCache(str(tmp_path / "t.json")), schedule="chunk")
    assert cfg.schedule == "chunk"
    assert cfg.trials > 1                     # the pipeline axis still ran


def test_batch_axis_is_empty_until_batching_is_ported(setup):
    """Request batching is ported: the batch axis is the JAX package's,
    rb in (1, 2, 4, 8) but the current one on a step-major plan, and
    empty on a chunk-major one."""
    _, t, _, _ = setup
    cfg, _ = at._heuristic_config(t, "algorithm1_mp", **CPU, **OPTS)
    assert cfg.schedule == "step"
    jcfg, _ = jat._heuristic_config(setup[0], "algorithm1_mp", **OPTS)
    assert [c.max_batch for c in at._batch_axis(cfg)] == \
        [c.max_batch for c in jat._batch_axis(jcfg)] == [2, 4, 8]
    assert at._batch_axis(dataclasses.replace(cfg, schedule="chunk")) == []


def test_ladder_puts_the_cuda_variants_first_on_a_card():
    assert at._ladder(torch.device("cpu")) == jat._LADDER
    cuda = at._ladder(torch.device("cuda"))
    assert cuda[:3] == ("subline_pl", "onehot_pl", "banded_pl")
    assert sorted(cuda) == sorted(jat._LADDER)


def test_auto_base_is_the_ladder_head(setup):
    """Untuned, "auto" plans the ladder's head: a CUDA kernel on a card,
    and on the CPU the JAX package's base (so keys stay equal)."""
    _, t, _, _ = setup
    assert at._auto_base(torch.device("cpu")) == "algorithm1_mp"
    assert at._auto_base(torch.device("cuda")) == "subline_pl"
    for dev, name in (("cpu", "algorithm1_mp"), ("cuda", "subline_pl")):
        cfg, plan = at._heuristic_config(t, "auto", device=dev, nb=2,
                                         proj_loop=False)
        assert cfg.variant == plan.variant == name
        assert ("proj_loop" in dict(cfg.options)) == (name == "subline_pl")


def test_slow_base_leaves_the_search_its_budget(setup, tmp_path,
                                                 monkeypatch):
    """The heuristic baseline is measured outside ``budget_s``: a base
    that alone takes longer than the budget (a plain variant on a card)
    still leaves the CUDA ladder's head candidates measured."""
    _, t, p, _ = setup
    # the card's ladder with the plain base it would have without
    # _auto_base: the slowest base there is
    monkeypatch.setattr(at, "_ladder", lambda dev: at._LADDER_CUDA)
    monkeypatch.setattr(at, "_auto_base", lambda dev: "algorithm1_mp")
    budget = 1.0
    seen = []

    def fake(geom, cfg, *a, **k):
        seen.append(cfg.variant)
        if cfg.variant == "algorithm1_mp":
            time.sleep(budget + 0.5)
            return 6.0
        return 0.09

    monkeypatch.setattr(at, "_measure_config", fake)
    cfg = _tune(t, p, "auto", TuningCache(str(tmp_path / "t.json")),
                budget_s=budget)
    assert seen[0] == "algorithm1_mp"         # the base, measured first
    assert {"subline_pl", "onehot_pl", "banded_pl"} <= set(seen[1:4])
    assert cfg.variant == "subline_pl" and cfg.speedup > 1.0


def test_planner_refused_candidate_is_skipped(setup, tmp_path, monkeypatch):
    """A candidate the planner refuses (ValueError) is skipped, and the
    search goes on."""
    _, t, p, _ = setup
    real = at._option_axis
    bogus = []

    def with_bogus(cur):
        cand = dataclasses.replace(cur, options=(("bogus_knob", 1),))
        bogus.append(cand)
        return [cand] + real(cur)

    monkeypatch.setattr(at, "_option_axis", with_bogus)
    seen = _cost_table(monkeypatch, [])
    cfg = _tune(t, p, "auto", TuningCache(str(tmp_path / "t.json")),
                variants=("algorithm1_mp",))
    assert bogus and all(c.key != b.key for c in seen for b in bogus)
    assert cfg.trials == len(seen) > 1


def test_candidate_that_raises_fails_the_search(setup, tmp_path,
                                                monkeypatch):
    """A candidate whose run raises anything but the planner's refusal
    (a kernel that does not build or launch) fails the tune instead of
    losing it to another variant."""
    _, t, p, _ = setup
    real = at._measure_config

    def broken(geom, cfg, *a, **k):
        if cfg.variant == "subline_pl":
            raise RuntimeError("kernel launch failed")
        return real(geom, cfg, *a, **k)

    monkeypatch.setattr(at, "_measure_config", broken)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        _tune(t, p, "auto", TuningCache(str(tmp_path / "t.json")),
              variants=("subline_pl",))


# ---- TunedConfig mechanics + self-maintenance ------------------------------

def test_config_speedup_and_replace(setup):
    _, t, _, _ = setup
    plan = plan_reconstruction(t, "algorithm1_mp", nb=2)
    cfg = dataclasses.replace(at.config_from_plan(plan), wall_us=50.0,
                              baseline_us=100.0)
    assert cfg.speedup == pytest.approx(2.0)
    assert at.config_from_plan(plan).speedup == 1.0
    for variant, kw in REQUESTS:
        assert at._heuristic_config(t, variant, **CPU, **kw)[0].to_json() == \
            jat._heuristic_config(setup[0], variant, **kw)[0].to_json()


def _entry_key(cache):
    fp = list(cache.entries())[0]
    return fp, list(cache.entries()[fp])[0]


def test_stale_drifted_entry_invalidates_and_retunes(setup, tmp_path):
    _, t, p, _ = setup
    cache = TuningCache(str(tmp_path / "t.json"))
    cfg = _tune(t, p, "algorithm1_mp", cache)
    fp, rkey = _entry_key(cache)
    cache.store(fp, rkey, dataclasses.replace(
        cfg, baseline_us=cfg.baseline_us / 1000.0,
        tuned_at=time.time() - 7 * 86400))
    redo = _tune(t, p, "algorithm1_mp", cache)
    assert redo.source == "measured" and redo.trials > 0
    assert cache.lookup(fp, rkey).tuned_at > time.time() - 600


def test_stale_consistent_entry_restamps_without_retune(setup, tmp_path,
                                                        monkeypatch):
    _, t, p, _ = setup
    cache = TuningCache(str(tmp_path / "t.json"))
    _cost_table(monkeypatch, [])          # every probe: 1.0 s
    cfg = _tune(t, p, "algorithm1_mp", cache)
    fp, rkey = _entry_key(cache)
    old = dataclasses.replace(cfg, tuned_at=time.time() - 7 * 86400)
    cache.store(fp, rkey, old)
    hit = _tune(t, p, "algorithm1_mp", cache)
    assert hit.source == "cache" and hit.trials == 0
    restamped = cache.lookup(fp, rkey)
    assert restamped.tuned_at > time.time() - 600
    assert restamped.baseline_us == old.baseline_us


def test_invalidate_and_legacy_staleness(setup, tmp_path):
    _, t, p, _ = setup
    cache = TuningCache(str(tmp_path / "t.json"))
    cfg = _tune(t, p, "algorithm1_mp", cache)
    fp, rkey = _entry_key(cache)
    doc = cfg.to_json()
    del doc["tuned_at"]
    assert TunedConfig.from_json(doc).tuned_at == 0.0
    assert cache.invalidate(fp, "missing-key") is False
    assert cache.invalidate(fp, rkey) is True
    assert cache.lookup(fp, rkey) is None


def test_autotune_without_a_device_needs_a_card(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, t, p, _ = setup
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune(t, "auto", cache=str(tmp_path / "t.json"), projections=p)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_config(t, "auto", cache=str(tmp_path / "t.json"))


# ---- second process --------------------------------------------------------

_SECOND = r"""
import json, sys
import numpy as np
from repro_torch.core.geometry import standard_geometry
from repro_torch.runtime import autotune as at

calls = []
orig = at._measure_config
def spy(*a, **k):
    calls.append(1)
    return orig(*a, **k)
at._measure_config = spy

g = standard_geometry(n=16, n_det=24, n_proj=6)
kw = dict(nb=2, tiling=(8, 8, 16), proj_batch=4)
cfg = at.autotune(g, "subline_batch_mp", cache=PATH, device="cpu",
                  budget_s=20.0, iters=1, **kw)
res = at.resolve_config(g, "subline_batch_mp", cache=PATH, device="cpu",
                        **kw)
print("RESULT:" + json.dumps({"measured": len(calls), "source": cfg.source,
                              "trials": cfg.trials, "key": repr(cfg.key),
                              "resolved": res.source,
                              "resolved_key": repr(res.key)}))
"""


def test_second_process_cache_hit(tmp_path):
    """Process 1 tunes on a fresh cache; process 2 resolves the persisted
    winner through autotune and resolve_config with zero measurements."""
    script = _SECOND.replace("PATH", repr(str(tmp_path / "t.json")))

    def run_once():
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        res = subprocess.run([sys.executable, "-c", script], env=env,
                             cwd=str(ROOT), capture_output=True, text=True,
                             timeout=600)
        assert res.returncode == 0, res.stderr[-3000:]
        line = [ln for ln in res.stdout.splitlines()
                if ln.startswith("RESULT:")][-1]
        return json.loads(line[len("RESULT:"):])

    first = run_once()
    assert first["measured"] > 0 and first["source"] == "measured"
    second = run_once()
    assert second["measured"] == 0 and second["trials"] == 0
    assert second["source"] == "cache" and second["resolved"] == "cache"
    assert second["key"] == first["key"] == second["resolved_key"]


# ---- solver methods --------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    g = j_geom(n=8, n_det=12, n_proj=8)
    t = convert.geometry_from_reference(dataclasses.asdict(g))
    p = np.random.RandomState(5).rand(8, t.nh, t.nw).astype(np.float32)
    return g, t, p


@pytest.mark.parametrize("method", ["fdk", "sart", "os_sart", "cgls",
                                    "fista_tv"])
def test_autotune_each_method(small, tmp_path, method):
    """Every method tunes on the CPU: solver winners carry their solver
    and live under their own keys; a tuned FDK winner is an FDK one."""
    _, t, p = small
    path = str(tmp_path / "t.json")
    cfg = autotune(t, "subline_pl", method=method, nb=2, cache=path,
                   projections=p, iters=1, budget_s=20.0, device="cpu",
                   program_cache=_PCACHE)
    assert cfg.source == "measured" and cfg.trials > 1
    assert cfg.solver == ("none" if method == "fdk" else method)
    assert cfg.variant == "subline_pl"
    again = autotune(t, "subline_pl", method=method, nb=2, cache=path,
                     projections=p, device="cpu")
    assert again.source == "cache" and again.key == cfg.key


def test_sart_tuning_resolves_in_solve(small, tmp_path, monkeypatch):
    """method="sart" tuning under a cost table: solve(tuning=path) and
    reconstruct(method="sart", tuning=path) run the winner (the
    executor keyed by its plan), equal to the explicit solve with its
    knobs, and the JAX package's solve with the same knobs within 1e-5."""
    g, t, p = small
    path = str(tmp_path / "t.json")
    _cost_table(monkeypatch, [(lambda c: c.precision == "bf16", 9.0),
                              (lambda c: c.proj_batch == 4
                               and c.schedule == "chunk", 0.1),
                              (lambda c: c.proj_batch == 4, 0.5)],
                name="_measure_solver")
    cfg = autotune(t, "subline_pl", method="sart", nb=2, cache=path,
                   projections=p, budget_s=20.0, device="cpu")
    assert (cfg.solver, cfg.proj_batch, cfg.schedule, cfg.precision) == \
        ("sart", 4, "chunk", "f32")
    kw = dict(n_iters=3, nb=2, variant="subline_pl", device="cpu")
    vol, report = solvers.solve(p, t, "sart", tuning=path, **kw)
    assert resolve_config(t, "subline_pl", cache=path, device="cpu", nb=2,
                          out="device", solver="sart").key == cfg.key
    ex = solvers.solver_executor(t, cfg.build_plan(t), device="cpu")
    assert ex.last_report is report           # the executor solve ran
    assert ex.plan.chunk_size == 4 and ex.plan.schedule == "chunk"
    want, _ = solvers.solve(p, t, "sart", proj_batch=4, schedule="chunk",
                            **kw)
    assert torch.equal(vol, want)
    via = repro_torch.reconstruct(p, t, method="sart", options=ReconOptions(
        variant="subline_pl", nb=2, n_iters=3, tuning=path), device="cpu")
    assert torch.equal(via, want)
    jvol, _ = jsolvers.solve(jnp.asarray(p), g, "sart", n_iters=3, nb=2,
                             variant="algorithm1_mp", proj_batch=4,
                             schedule="chunk")
    assert rel_rmse(vol.numpy(), np.asarray(jvol)) < BAR
