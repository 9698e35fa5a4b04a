"""repro_torch's reconstruction fleet against the JAX package, on the CPU.

The port of ``tests/test_fleet.py``. The JAX test forces 8 host devices in
a subprocess; torch has one CPU device, so the port's fleet runs eight
workers on it in this process (``devices=("cpu",) * 8``, an entry per
worker) and shards the same step schedule: the reference's geometry,
``(8, 8, nz)`` tiles and ``proj_batch=8``, 16 steps. The contracts:

  * **parity**: the fleet's volume equals the port's single-device
    step-major walk BIT FOR BIT (the fleet folds each step's origin
    through the walk's own fold), and is within the JAX test's 1e-5
    (max-abs over scale) of the JAX ``fdk_reconstruct``;
  * **failover**: with one entry's steps forced to fail, the run
    completes bit-identically, the entry is retired with 0 steps;
  * **work stealing**: a straggling entry's unclaimed steps migrate,
    output still bit-identical;
  * **poison step**: a step failing on every entry aborts, naming
    ``max_retries_per_step``;
  * **serving**: ``ReconService(devices=...)`` buckets run on the fleet,
    report its width and give repeat-identical volumes.

Beyond the JAX tests: the step boxes the fleet relies on are disjoint
(here and at the card's P5 tiling), request batching under the fleet,
the refusals the JAX package makes (chunk-major, ``out="device"``, bf16,
solver requests, stream sessions) and the port's own (no silent CPU
fleet), the config and report fields against the JAX package's, and the
fleet's telemetry. The JAX fleet itself is not run: the port is held to
the JAX package's oracle, not to its fleet.
"""

import dataclasses
import itertools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import standard_geometry as j_geom
from repro.core.fdk import fdk_reconstruct as j_fdk
from repro.runtime.executor import FleetConfig as JFleetConfig
from repro.runtime.executor import FleetReport as JFleetReport

import repro_torch
from repro_torch import ReconOptions, convert
from repro_torch.configs.ct_paper import get_problem
from repro_torch.core.fdk import _build_plan, fdk_reconstruct
from repro_torch.runtime import telemetry
from repro_torch.runtime.executor import (FleetConfig, FleetReport,
                                          PlanExecutor, ProgramCache,
                                          as_fleet_config)
from repro_torch.runtime.planner import plan_reconstruction
from repro_torch.runtime.service import ReconService

FLEET = ("cpu",) * 8
BAR = 1e-5                                # tests/test_fleet.py


@pytest.fixture(scope="module")
def setup():
    g = j_geom(n=32, n_det=48, n_proj=16)
    t = convert.geometry_from_reference(dataclasses.asdict(g))
    projs = np.random.RandomState(0).rand(g.n_proj, g.nh,
                                          g.nw).astype(np.float32)
    kw = dict(nb=8, interpret=True, tiling=(8, 8, g.nz), memory_budget=None,
              proj_batch=8, out="host", schedule="step")
    plan = _build_plan(t, "algorithm1_mp", **kw)
    cache = ProgramCache()
    single = PlanExecutor(t, plan, cache=cache, device="cpu").reconstruct(
        projs)
    want = np.asarray(j_fdk(jnp.asarray(projs), g, tiling=(8, 8, g.nz),
                            proj_batch=8, out="host"))
    return dict(g=g, t=t, projs=projs, plan=plan, cache=cache,
                single=single, want=want)


def _fleet_run(s, **cfg):
    ex = PlanExecutor(s["t"], s["plan"], cache=s["cache"],
                      fleet=FleetConfig(devices=FLEET, **cfg))
    return ex.reconstruct(s["projs"]), ex.last_fleet_report


def _rel_err(got, want) -> float:
    scale = float(np.max(np.abs(want))) or 1.0
    return float(np.max(np.abs(got - want))) / scale


def test_fleet_runs_on_eight_devices(setup):
    assert len(setup["plan"].steps) == 16
    vol, rep = _fleet_run(setup)
    assert rep.n_devices == 8 and rep.n_steps == 16
    assert sum(rep.steps_by_device) == 16
    assert rep.dead_devices == () and rep.retried == 0


def test_fleet_matches_single_device(setup):
    """16 steps over 8 entries reconstruct the single-device step-major
    walk's volume bit for bit, and the JAX oracle's within 1e-5; so do
    ``fdk_reconstruct(devices=)`` and ``reconstruct(options=devices)``."""
    vol, _ = _fleet_run(setup)
    assert np.array_equal(vol, setup["single"])
    assert _rel_err(vol, setup["want"]) < BAR
    t, p = setup["t"], setup["projs"]
    via_fdk = fdk_reconstruct(p, t, tiling=(8, 8, t.nz), proj_batch=8,
                              devices=FLEET)
    assert np.array_equal(via_fdk, setup["single"])
    via_api = repro_torch.reconstruct(p, t, options=ReconOptions(
        tiling=(8, 8, t.nz), proj_batch=8, devices=FLEET))
    assert np.array_equal(via_api, setup["single"])


def test_fleet_failover_bit_identical(setup):
    """An entry whose every step faults is retired after its strike
    budget; its steps re-run on the survivors, bit-identically."""
    def fail_dev3(device, step):
        if device == 3:
            raise RuntimeError("injected device fault")

    vol, rep = _fleet_run(setup, step_hook=fail_dev3)
    assert np.array_equal(vol, setup["single"])
    assert 3 in rep.dead_devices
    assert rep.retried >= 1
    assert rep.steps_by_device[3] == 0
    assert sum(rep.steps_by_device) == 16


def test_fleet_steals_from_straggler(setup):
    """An idle entry steals the straggler's unclaimed steps; migration
    never changes the output."""
    def slow_dev0(device, step):
        if device == 0:
            time.sleep(1.0)

    vol, rep = _fleet_run(setup, step_hook=slow_dev0)
    assert rep.stolen >= 1
    assert np.array_equal(vol, setup["single"])


def test_fleet_poison_step_aborts(setup):
    """A step failing on EVERY entry exhausts max_retries_per_step and
    raises, chained to the step's error: never a partial volume."""
    def poison_step0(device, step):
        if step == 0:
            raise RuntimeError("injected poison step")

    with pytest.raises(RuntimeError, match="max_retries_per_step") as err:
        _fleet_run(setup, step_hook=poison_step0, max_retries_per_step=2)
    assert "injected poison step" in str(err.value.__cause__)


def test_fleet_loses_every_device(setup):
    """Every entry retired before the budget of any one step is spent:
    the run raises instead of returning a partial volume."""
    def all_fail(device, step):
        raise RuntimeError("injected device fault")

    with pytest.raises(RuntimeError, match="lost all devices"):
        _fleet_run(setup, step_hook=all_fail, max_retries_per_step=100,
                   device_strikes=1)


def test_fleet_flush_fault_stops_every_worker(setup, monkeypatch):
    """A fault in a worker's host add is no step fault (the volume may be
    half-written): every worker stops and the run raises it, never
    hangs and never re-runs the step."""
    from repro_torch.runtime import executor as ex_mod
    calls = []

    def broken_add(vol, sl, piece):
        calls.append(1)
        raise MemoryError("injected flush fault")

    monkeypatch.setattr(ex_mod, "_add_host", broken_add)
    with pytest.raises(MemoryError, match="injected flush fault"):
        _fleet_run(setup)
    assert 1 <= len(calls) <= 8          # one a worker at most


def test_service_places_buckets_across_fleet(setup):
    """ReconService(devices=...) runs its buckets on the fleet: correct
    volumes, repeat-identical, and the bucket reports the fleet width."""
    t, p = setup["t"], setup["projs"]
    with ReconService(max_inflight=2, devices=FLEET) as svc:
        h1 = svc.submit(p, t, tiling=(8, 8, t.nz), proj_batch=8)
        h2 = svc.submit(p, t, tiling=(8, 8, t.nz), proj_batch=8)
        v1, v2 = h1.result(), h2.result()
        stats = svc.stats()
    assert _rel_err(v1, setup["want"]) < BAR
    assert np.array_equal(v1, v2) and np.array_equal(v1, setup["single"])
    assert stats.buckets[0].devices == 8
    assert stats.requests == 2
    assert stats.buckets[0].dead_devices == 0


def test_fleet_request_batch(setup):
    """A formed batch under the fleet runs one rb-lane fleet program a
    step; every request's volume equals its solo walk bit for bit, in the
    service and through ``execute_batch``."""
    t, p = setup["t"], setup["projs"]
    p2 = np.random.RandomState(1).rand(*p.shape).astype(np.float32)
    ex = PlanExecutor(t, setup["plan"], cache=setup["cache"],
                      fleet=FleetConfig(devices=FLEET))
    solo = [ex.reconstruct(x) for x in (p, p2)]
    ex.warm_batch(2)
    misses = setup["cache"].stats()["misses"]
    got = ex.execute_batch([p, p2])
    assert setup["cache"].stats()["misses"] == misses   # warmed
    assert all(np.array_equal(a, b) for a, b in zip(got, solo))
    assert ex.last_fleet_report.n_steps == 16
    with ReconService(max_inflight=1, max_batch=2, max_wait_ms=200.0,
                      cache=setup["cache"], devices=FLEET) as svc:
        futs = [svc.submit(x, t, tiling=(8, 8, t.nz), proj_batch=8)
                for x in (p, p2)]
        served = [f.result() for f in futs]
        stats = svc.stats()
    assert all(np.array_equal(a, b) for a, b in zip(served, solo))
    assert stats.buckets[0].devices == 8


def _boxes(plan):
    return [((s.i0, s.i0 + s.ni), (s.j0, s.j0 + s.nj), (w.k0, w.k0 + w.nk))
            for s in plan.steps for w in s.writes]


def _overlap(a, b) -> bool:
    return all(lo1 < hi2 and lo2 < hi1
               for (lo1, hi1), (lo2, hi2) in zip(a, b))


@pytest.mark.parametrize("case", ["cpu-fleet", "P5-subline_pl",
                                  "P5-onehot_pl", "P5-banded_pl"])
def test_step_write_boxes_are_disjoint(setup, case):
    """Bit identity under any completion order rests on this: no two
    steps' write boxes overlap, and together they cover the volume once
    (so every voxel is one add into zero). Checked for this file's plan
    and for the P5 tiling the card's ``[fleet]`` phase runs."""
    if case == "cpu-fleet":
        plan = setup["plan"]
    else:
        geom = get_problem("P5").geometry()
        plan = plan_reconstruction(geom, case.split("-")[1], nb=8,
                                   tile_shape=(256, 256, 96),
                                   proj_batch=128, out="host")
        assert len(plan.steps) == 12
    boxes = _boxes(plan)
    for a, b in itertools.combinations(boxes, 2):
        assert not _overlap(a, b), (a, b)
    covered = sum((i1 - i0) * (j1 - j0) * (k1 - k0)
                  for (i0, i1), (j0, j1), (k0, k1) in boxes)
    assert covered == int(np.prod(plan.vol_shape_xyz))


def _refusal(setup, what):
    t, p, plan = setup["t"], setup["projs"], setup["plan"]
    if what == "chunk-major":
        chunk = plan_reconstruction(t, "algorithm1_mp", nb=8,
                                    tile_shape=(8, 8, t.nz), proj_batch=8,
                                    out="host", schedule="chunk")
        PlanExecutor(t, chunk, fleet=FleetConfig(devices=FLEET))
    elif what == "out-device":
        fdk_reconstruct(p, t, tiling=(8, 8, t.nz), proj_batch=8,
                        out="device", devices=FLEET)
    elif what == "bf16":
        fdk_reconstruct(p, t, tiling=(8, 8, t.nz), proj_batch=8,
                        precision="bf16", devices=FLEET)
    elif what == "solver":
        with ReconService(devices=FLEET) as svc:
            svc.submit(p, t, solver="sart", n_iters=1)
    elif what == "stream":
        with ReconService(devices=FLEET) as svc:
            svc.open_stream(t)
    elif what == "service+devices":
        fdk_reconstruct(p, t, service=object(), devices=FLEET)


@pytest.mark.parametrize("what, match", [
    ("chunk-major", "schedule='step'"), ("out-device", "out='host'"),
    ("bf16", "precision='f32'"), ("solver", "fleet service"),
    ("stream", "without devices="), ("service+devices", "devices=")])
def test_fleet_refusals(setup, what, match):
    """What the JAX package refuses on a fleet, the port refuses too."""
    with pytest.raises(ValueError, match=match):
        _refusal(setup, what)


@pytest.mark.parametrize("devices", ["all", 2, ("cuda:0",), ("cpu", "cuda")])
def test_fleet_without_card_raises(setup, devices):
    """No silent CPU fleet: a fleet that asks for a card (every CUDA
    device, the first N, or a named one) raises without one, in the
    executor, the entry point and the service alike."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    t, p = setup["t"], setup["projs"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PlanExecutor(t, setup["plan"], fleet=as_fleet_config(devices),
                     device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fdk_reconstruct(p, t, tiling=(8, 8, t.nz), proj_batch=8,
                        devices=devices, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReconService(devices=devices, device="cpu")


def test_fleet_refuses_mixed_device_types(setup, monkeypatch):
    """A fleet is all CUDA devices or all the CPU, and inputs are filtered
    on a device of its type: else a card's failed step could re-run on a
    CPU entry through the plain version. The card is stood in for by
    resolving names without one (nothing runs)."""
    from repro_torch.runtime import executor, service
    monkeypatch.setattr(executor, "_fleet_device", torch.device)
    monkeypatch.setattr(executor, "resolve_device", torch.device)
    monkeypatch.setattr(service, "resolve_device", torch.device)
    for devices in (("cuda:0", "cpu"), ("cpu", "cuda:0", "cpu")):
        with pytest.raises(ValueError, match="one device type"):
            as_fleet_config(devices)
        with pytest.raises(ValueError, match="one device type"):
            FleetConfig(devices=devices).resolve_devices()
        with pytest.raises(ValueError, match="one device type"):
            ReconService(devices=devices)
    with pytest.raises(ValueError, match="filtered on cuda:0"):
        PlanExecutor(setup["t"], setup["plan"], device="cuda:0",
                     fleet=FleetConfig(devices=("cpu",) * 2))
    with pytest.raises(ValueError, match="filtered on cuda:0"):
        ReconService(devices=("cpu",) * 2, device="cuda:0")
    assert as_fleet_config(("cuda:0",) * 2).resolve_devices() == (
        torch.device("cuda:0"),) * 2


def test_fleet_config_and_report_match_reference():
    """FleetConfig and FleetReport carry the JAX package's fields and
    defaults, so one dict sets both sides."""
    names = [f.name for f in dataclasses.fields(JFleetConfig)]
    assert [f.name for f in dataclasses.fields(FleetConfig)] == names
    assert dataclasses.asdict(FleetConfig()) == dataclasses.asdict(
        JFleetConfig())
    knobs = dict(max_retries_per_step=5, device_strikes=3,
                 straggler_window=7, straggler_ratio=2.5)
    assert dataclasses.asdict(FleetConfig(**knobs)) == dataclasses.asdict(
        JFleetConfig(**knobs))
    rep = dict(n_devices=2, n_steps=12, steps_by_device=(7, 5), stolen=1,
               retried=2, dead_devices=(1,), flagged_devices=(0,))
    assert FleetReport(**rep).as_dict() == JFleetReport(**rep).as_dict()
    assert as_fleet_config(None) is None
    cfg = FleetConfig(devices=FLEET)
    assert as_fleet_config(cfg) is cfg
    one = as_fleet_config(["cpu"], max_retries_per_step=4)
    assert one.resolve_devices() == (torch.device("cpu"),)
    assert one.max_retries_per_step == 4
    with pytest.raises(ValueError, match="non-empty"):
        as_fleet_config(())
    with pytest.raises(ValueError, match="sequence of devices"):
        as_fleet_config("cpu")


def test_fleet_telemetry(setup):
    """Each worker is its own lane (``recon-fleet-{d}``) of
    ``step.dispatch`` spans tagged ``schedule="fleet"`` with its entry and
    step; a failover, a retirement and a steal leave their instants; the
    executor's totals sum the runs."""
    def fail_dev3(device, step):
        if device == 3:
            raise RuntimeError("injected device fault")

    ex = PlanExecutor(setup["t"], setup["plan"], cache=setup["cache"],
                      fleet=FleetConfig(devices=FLEET, step_hook=fail_dev3))
    ex.warm()
    misses = setup["cache"].stats()["misses"]
    with telemetry.tracing():
        ex.reconstruct(setup["projs"])
        evs = telemetry.events()
    assert setup["cache"].stats()["misses"] == misses
    steps = [e for e in evs if e["name"] == "step.dispatch"]
    assert {e["args"]["schedule"] for e in steps} == {"fleet"}
    done = [e for e in steps if "error" not in e["args"]]
    assert sorted(e["args"]["step_index"] for e in done) == list(range(16))
    assert all(e["tid"] == f"recon-fleet-{e['args']['device']}"
               for e in steps)
    names = [e["name"] for e in evs]
    assert "fleet.failover" in names and "fleet.retire" in names
    retire = next(e for e in evs if e["name"] == "fleet.retire")
    assert retire["args"]["device"] == 3 and retire["tid"] == "recon-fleet-3"
    steals = [e for e in evs if e["name"] == "fleet.steal"]
    assert len(steals) == ex.last_fleet_report.stolen
    totals = ex.fleet_totals
    assert totals["runs"] == 1 and totals["devices"] == 8
    assert totals["dead_devices"] == 1
    assert totals["retried"] == ex.last_fleet_report.retried >= 1
