"""repro_torch planning vs the JAX package: the same request plans the
same schedule, field by field."""

import dataclasses

import pytest

pytest.importorskip("torch")

from repro.core import standard_geometry as j_geom
from repro.runtime.planner import plan_reconstruction as j_plan

from repro_torch import convert
from repro_torch.core import tiling as t_tiling
from repro_torch.core.fdk import _build_plan
from repro_torch.runtime.planner import plan_reconstruction as t_plan

from repro.core import tiling as j_tiling

GEOMS = [(16, 24, 8), (13, 17, 5)]


def _geoms(n, det, nproj):
    g = j_geom(n=n, n_det=det, n_proj=nproj)
    return g, convert.geometry_from_reference(dataclasses.asdict(g))


def _fields(plan) -> dict:
    return {
        "fields": {f.name: getattr(plan, f.name)
                   for f in dataclasses.fields(plan) if f.name != "steps"},
        "steps": [dataclasses.asdict(s) for s in plan.steps],
        "chunks": plan.chunks,
        "subsets": plan.subsets,
        "program_keys": plan.program_keys,
        "bucket_key": plan.bucket_key,
        "step_major": dataclasses.asdict(plan.step_major),
        "working_set_bytes": plan.working_set_bytes,
    }


@pytest.mark.parametrize("n,det,nproj", GEOMS)
@pytest.mark.parametrize("variant", ["algorithm1_mp", "subline_pl",
                                     "subline_batch_mp", "onehot_pl",
                                     "banded_pl"])
@pytest.mark.parametrize("proj_batch", [None, 3])
@pytest.mark.parametrize("schedule", ["step", "chunk"])
@pytest.mark.parametrize("nb", [1, 4])
def test_untiled_plans_equal_jax(n, det, nproj, variant, proj_batch,
                                 schedule, nb):
    g, t = _geoms(n, det, nproj)
    kw = dict(nb=nb, proj_batch=proj_batch, schedule=schedule,
              out="device")
    jp, tp = j_plan(g, variant, **kw), t_plan(t, variant, **kw)
    assert _fields(tp) == _fields(jp)
    assert tp.n_proj_padded == jp.n_proj_padded


@pytest.mark.parametrize("variant,tile", [
    ("algorithm1_mp", (5, 7, 5)),      # symmetry: mirror pairs + middle
    ("subline_batch_mp", (5, 7, 5)),   # symmetry-free: plain slabs
    ("subline_pl", (4, 4, 16)),
    ("algorithm1_mp", (16, 16, 3)),
    ("onehot_pl", (8, 8, 5)),
    ("banded_pl", (8, 16, 16)),
])
def test_tiled_plans_equal_jax(variant, tile):
    """The planner is ported whole: tiled schedules plan identically even
    though only the untiled plan executes in this package yet."""
    g, t = _geoms(16, 24, 8)
    kw = dict(tile_shape=tile, nb=4, out="host")
    assert _fields(t_plan(t, variant, **kw)) == \
        _fields(j_plan(g, variant, **kw))


@pytest.mark.parametrize("kw", [
    dict(out="host"), dict(out=None), dict(proj_batch=5, out="host"),
    dict(block=(2, 8)), dict(proj_loop=False), dict(interpret=False),
])
def test_facade_plans_equal_jax(kw):
    from repro.core.fdk import _build_plan as j_build
    g, t = _geoms(16, 24, 8)
    base = dict(nb=4, interpret=True, tiling=None, memory_budget=None,
                proj_batch=None, out=None)
    args = {**base, **kw}
    assert _fields(_build_plan(t, "subline_pl", **args)) == \
        _fields(j_build(g, "subline_pl", **args))


@pytest.mark.parametrize("variant,kw", [
    ("onehot_pl", dict(k_chunk=16)), ("onehot_pl", dict(k_chunk=3, nb=1)),
    ("banded_pl", dict(bw=16)), ("banded_pl", dict(bw=8, proj_loop=False)),
])
def test_kernel_option_plans_equal_jax(variant, kw):
    """The variants' own knobs (k_chunk, bw) reach the plan's program
    options as in the JAX package."""
    from repro.core.fdk import _build_plan as j_build
    g, t = _geoms(13, 17, 5)
    args = {**dict(nb=4, interpret=True, tiling=None, memory_budget=None,
                   proj_batch=None, out=None), **kw}
    assert _fields(_build_plan(t, variant, **args)) == \
        _fields(j_build(g, variant, **args))


@pytest.mark.parametrize("kw", [
    dict(variant="auto"), dict(tuning="cache.json"),
])
def test_autotune_entry_raises(kw, tmp_path):
    """The autotune entry resolves by lookup now (a miss plans the JAX
    package's heuristic plan); it still raises where it must: on the
    card's fingerprint without a card, and on an option no variant
    takes."""
    g, t = _geoms(16, 24, 8)
    variant = kw.pop("variant", "algorithm1_mp")
    if "tuning" in kw:
        kw["tuning"] = str(tmp_path / kw["tuning"])
    assert _fields(t_plan(t, variant, device="cpu", **kw)) == \
        _fields(j_plan(g, variant, **kw))
    with pytest.raises(ValueError):
        t_plan(t, variant, device="cpu", bogus_knob=1, **kw)
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_plan(t, variant, **kw)


@pytest.mark.parametrize("variant,kw", [
    ("algorithm1_mp", dict(out="bogus")),
    ("algorithm1_mp", dict(schedule="bogus")),
    ("algorithm1_mp", dict(nb=0)),
    ("algorithm1_mp", dict(proj_batch=0)),
    ("algorithm1_mp", dict(block=(4, 8))),     # not an option it takes
    ("subline_pl", dict(bw=8)),
    ("onehot_pl", dict(bw=8)),
    ("banded_pl", dict(k_chunk=8)),
    ("algorithm1_mp", dict(precision="f16")),
    ("algorithm1_mp", dict(ingest="stream", schedule="step")),
])
def test_validation_matches_jax(variant, kw):
    g, t = _geoms(16, 24, 8)
    with pytest.raises(ValueError):
        j_plan(g, variant, **kw)
    with pytest.raises(ValueError):
        t_plan(t, variant, **kw)


@pytest.mark.parametrize("n,b,pb", [(8, 1, None), (5, 4, None), (13, 4, 3),
                                    (7, 2, 5), (9, 8, 100)])
def test_proj_chunks_match_jax(n, b, pb):
    assert t_tiling.plan_proj_chunks(n, b, pb) == \
        j_tiling.plan_proj_chunks(n, b, pb)


@pytest.mark.parametrize("nz,tk", [(16, 16), (13, 13), (16, 3), (13, 4)])
def test_z_units_match_jax(nz, tk):
    assert [dataclasses.asdict(u) for u in t_tiling.plan_z_units(nz, tk)] \
        == [dataclasses.asdict(u) for u in j_tiling.plan_z_units(nz, tk)]
    assert [dataclasses.asdict(u) for u in t_tiling.plan_z_slabs(nz, tk)] \
        == [dataclasses.asdict(u) for u in j_tiling.plan_z_slabs(nz, tk)]


def test_pad_and_translate_match_jax():
    import numpy as np
    import jax.numpy as jnp
    import torch
    rng = np.random.RandomState(0)
    img = rng.rand(5, 4, 3).astype(np.float32)
    mat = rng.rand(5, 3, 4).astype(np.float32)
    ti, tm = t_tiling.pad_projection_batch(torch.from_numpy(img),
                                           torch.from_numpy(mat), 4)
    ji, jm = j_tiling.pad_projection_batch(jnp.asarray(img),
                                           jnp.asarray(mat), 4)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    tt = t_tiling.translate_matrices(torch.from_numpy(mat), 2.0, 3.0, 1.0)
    jt = j_tiling.translate_matrices(jnp.asarray(mat), 2.0, 3.0, 1.0)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6)
    assert t_tiling.pick_tile_shape((16, 16, 16), (24, 24), 1 << 16) == \
        j_tiling.pick_tile_shape((16, 16, 16), (24, 24), 1 << 16)
