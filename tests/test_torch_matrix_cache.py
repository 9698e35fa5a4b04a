"""The process-wide cache of padded projection matrices, on the CPU.

Every walk of ``PlanExecutor`` takes its matrices from
``executor.MatrixCache``: one build for each (geometry, device, padding),
shared read-only. These tests hold the cache to its contract: a hit is
the stored tensor, bit for bit a fresh build; every field of the key
separates entries; the LRU bound holds; concurrent lookups of one key
build once; the ``geometry.matrices`` span says hit or miss; volumes do
not change with the cache; and no walk writes into the shared tensor.
"""

import dataclasses
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.geometry import projection_matrices, standard_geometry
from repro_torch.runtime import executor, telemetry
from repro_torch.runtime.executor import (MatrixCache, PlanExecutor,
                                          ProgramCache, _pad_mats)
from repro_torch.runtime.planner import plan_reconstruction

CPU = torch.device("cpu")
GEOM = standard_geometry(n=16, n_det=24, n_proj=8)
PROJS = np.random.default_rng(32).normal(
    size=(GEOM.n_proj, GEOM.nh, GEOM.nw)).astype(np.float32)
#: one changed value for each field of the geometry
CHANGED = {"nx": 12, "ny": 12, "nz": 12, "nw": 20, "nh": 20, "n_proj": 6,
           "sad": 900.0, "sdd": 1400.0, "voxel_size": (15.0, 16.0, 16.0),
           "det_spacing": (18.0, 20.0)}
#: plan keywords of the walks that take the matrices
WALKS = {
    "step": {},
    "chunk": {"schedule": "chunk"},
    "tiled": {"tile_shape": (8, 8, 16), "out": "device"},
}


@pytest.fixture(autouse=True)
def _fresh():
    executor.default_matrix_cache().clear()
    telemetry.disable()
    telemetry.clear()
    yield
    executor.default_matrix_cache().clear()
    telemetry.disable()
    telemetry.clear()


def _fresh_build(geom, n_pad):
    return _pad_mats(projection_matrices(geom, CPU), n_pad)


def _executor(geom=GEOM, **plan_kw):
    plan = plan_reconstruction(geom, "algorithm1_mp", nb=2, proj_batch=4,
                               **plan_kw)
    return PlanExecutor(geom, plan, ProgramCache(), device="cpu")


def _volume(ex, projs=PROJS):
    vol = ex.reconstruct(projs)
    return np.asarray(vol).copy() if isinstance(vol, np.ndarray) \
        else vol.numpy().copy()


def test_field_table_covers_the_geometry():
    assert set(CHANGED) == {f.name for f in dataclasses.fields(GEOM)}


@pytest.mark.parametrize("n_pad", [8, 10, 16])
def test_hit_returns_the_stored_bits(n_pad):
    cache = MatrixCache()
    first, hit0 = cache.lookup(GEOM, CPU, n_pad)
    again, hit1 = cache.lookup(GEOM, CPU, n_pad)
    assert (hit0, hit1) == (False, True)
    assert again is first
    fresh = _fresh_build(GEOM, n_pad)
    assert again.shape == (n_pad, 3, 4) and again.dtype == torch.float32
    assert torch.equal(again, fresh)
    assert cache.stats() == {"hits": 1, "misses": 1, "entries": 1}


@pytest.mark.parametrize("field", sorted(CHANGED))
def test_each_geometry_field_keys_its_own_entry(field):
    other = dataclasses.replace(GEOM, **{field: CHANGED[field]})
    cache = MatrixCache()
    a, _ = cache.lookup(GEOM, CPU, 8)
    b, hit = cache.lookup(other, CPU, 8)
    assert not hit and b is not a
    assert torch.equal(b, _fresh_build(other, 8))
    assert cache.stats() == {"hits": 0, "misses": 2, "entries": 2}
    # an equal geometry built anew is the same key
    same, hit = cache.lookup(dataclasses.replace(GEOM), CPU, 8)
    assert hit and same is a


def test_padding_keys_its_own_entry():
    cache = MatrixCache()
    a, _ = cache.lookup(GEOM, CPU, 8)
    b, hit = cache.lookup(GEOM, CPU, 12)
    assert not hit and b.shape[0] == 12 and a.shape[0] == 8
    assert torch.equal(b[:8], a) and torch.equal(b[8:], a[-1:].expand(4, 3, 4))
    assert cache.stats()["entries"] == 2


def test_device_keys_its_own_entry(monkeypatch):
    """Each card index is a key of its own, and an unindexed ``cuda`` is
    the thread's current card. The build is stood in for on the CPU."""
    built = []

    def build(geom, device, n_pad):
        built.append(device)
        return _fresh_build(geom, n_pad)

    cache = MatrixCache()
    monkeypatch.setattr(cache, "_build", build)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    for dev in ("cpu", "cuda:0", "cuda:1", "cuda"):
        cache.lookup(GEOM, torch.device(dev), 8)
    assert built == [CPU, torch.device("cuda", 0), torch.device("cuda", 1)]
    assert cache.stats() == {"hits": 1, "misses": 3, "entries": 3}
    assert executor._device_key(torch.device("cuda")) == torch.device(
        "cuda", 1)
    assert executor._device_key(CPU) == CPU


def test_lru_bound_holds():
    cache = MatrixCache(max_entries=3)
    geoms = [dataclasses.replace(GEOM, n_proj=n) for n in (4, 5, 6, 7)]
    for g in geoms[:3]:
        cache.lookup(g, CPU, 8)
    cache.lookup(geoms[0], CPU, 8)          # the oldest, used again
    cache.lookup(geoms[3], CPU, 8)          # evicts geoms[1]
    assert cache.stats() == {"hits": 1, "misses": 4, "entries": 3}
    assert cache.lookup(geoms[0], CPU, 8)[1]
    assert not cache.lookup(geoms[1], CPU, 8)[1]
    for n in range(20):
        cache.lookup(dataclasses.replace(GEOM, nx=n + 1), CPU, 8)
    assert cache.stats()["entries"] == 3


def test_default_cache_is_bounded():
    assert 0 < executor.default_matrix_cache().max_entries <= 64


def test_concurrent_lookups_build_once(monkeypatch):
    cache = MatrixCache()
    slow = cache._build

    def build(*args):
        time.sleep(0.05)     # both threads are inside lookup by now
        return slow(*args)

    monkeypatch.setattr(cache, "_build", build)
    barrier = threading.Barrier(2)
    got = [None, None]

    def look(i):
        barrier.wait()
        got[i] = cache.lookup(GEOM, CPU, 8)[0]

    threads = [threading.Thread(target=look, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    assert torch.equal(got[0], got[1]) and got[0] is got[1]
    assert cache.stats() == {"hits": 1, "misses": 1, "entries": 1}


def test_many_threads_keep_the_counts():
    """More threads than cores over a few keys, switching often: every
    lookup is counted once, each key is built once, and every thread
    gets that key's one tensor."""
    cache = MatrixCache()
    keys = [dataclasses.replace(GEOM, n_proj=n) for n in (5, 6, 7, 8)]
    n_threads, rounds = 32, 25
    got = [[] for _ in range(n_threads)]

    def look(i):
        for r in range(rounds):
            g = keys[(i + r) % len(keys)]
            got[i].append((g, cache.lookup(g, CPU, 8)[0]))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=look, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert cache.stats() == {"hits": n_threads * rounds - len(keys),
                             "misses": len(keys), "entries": len(keys)}
    for g in keys:
        one = {id(m) for pairs in got for k, m in pairs if k == g}
        assert len(one) == 1


def test_unhashable_geometry_builds_uncached():
    geom = dataclasses.replace(GEOM, voxel_size=[16.0, 16.0, 16.0])
    cache = MatrixCache()
    mats, hit = cache.lookup(geom, CPU, 8)
    assert not hit and torch.equal(mats, _fresh_build(GEOM, 8))
    assert cache.stats()["entries"] == 0


def test_matrices_span_says_hit_or_miss():
    ex = _executor()
    with telemetry.tracing():
        ex.reconstruct(PROJS)
        ex.reconstruct(PROJS)
    spans = [e for e in telemetry.events()
             if e.get("ph") == "X" and e["name"] == "geometry.matrices"]
    assert [e["args"]["cached"] for e in spans] == [False, True]
    assert all(e["args"]["n_proj"] == GEOM.n_proj for e in spans)
    assert executor.default_matrix_cache().stats() == {
        "hits": 1, "misses": 1, "entries": 1}


@pytest.mark.parametrize("walk", sorted(WALKS))
def test_volumes_do_not_change_with_the_cache(walk):
    ex = _executor(**WALKS[walk])
    warm = [_volume(ex), _volume(ex)]
    cold = []
    for _ in range(2):
        executor.default_matrix_cache().clear()
        cold.append(_volume(ex))
    assert executor.default_matrix_cache().stats()["hits"] == 0
    for v in warm[1:] + cold:
        assert np.array_equal(v, warm[0])


def _cached(ex):
    return executor.default_matrix_cache().lookup(
        ex.geom, ex.device, ex.plan.n_proj_padded)[0]


@pytest.mark.parametrize("walk", ["reconstruct", "execute_batch",
                                  "open_stream", "chunk", "tiled"])
def test_walks_leave_the_cached_tensor_unchanged(walk):
    if walk == "open_stream":
        ex = _executor(ingest="stream")
    else:
        ex = _executor(**WALKS.get(walk, {}))
    mats = _cached(ex)
    before, version = mats.clone(), mats._version
    for _ in range(2):
        if walk == "execute_batch":
            ex.execute_batch([PROJS, PROJS[::-1].copy()])
        elif walk == "open_stream":
            se = ex.open_stream()
            se.push(PROJS)
            se.close()
        else:
            ex.reconstruct(PROJS)
    assert _cached(ex) is mats
    assert mats._version == version and torch.equal(mats, before)
    assert torch.equal(mats, _fresh_build(ex.geom, ex.plan.n_proj_padded))


# ---- on the card ----------------------------------------------------------
#
#     PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_matrix_cache.py

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_card_hit_equals_a_fresh_build(cuda):
    geom = standard_geometry(n=64, n_proj=100)
    cache = MatrixCache()
    first, _ = cache.lookup(geom, torch.device("cuda"), 104)
    again, hit = cache.lookup(geom, cuda, 104)
    assert hit and again is first and again.device == cuda
    fresh = _pad_mats(projection_matrices(geom, cuda), 104)
    assert torch.equal(again, fresh)


@pytest.mark.cuda
def test_card_threads_on_their_own_streams(cuda):
    """Two threads, each on a stream of its own, share one cached tensor
    built on a third: every volume equals the one built with the cache
    cleared, and the tensor keeps its values."""
    geom = standard_geometry(n=64, n_proj=64)
    projs = np.random.default_rng(7).normal(
        size=(geom.n_proj, geom.nh, geom.nw)).astype(np.float32)
    plan = plan_reconstruction(geom, "subline_pl", nb=8, out="device")
    ex = PlanExecutor(geom, plan, ProgramCache(), device=cuda)
    want = ex.reconstruct(projs).cpu()
    executor.default_matrix_cache().clear()
    mats = _cached(ex)
    before = mats.clone()
    got = {}

    def run(i):
        with torch.cuda.stream(torch.cuda.Stream(cuda)):
            vols = [ex.reconstruct(projs) for _ in range(3)]
            torch.cuda.current_stream(cuda).synchronize()
            got[i] = [v.cpu() for v in vols]

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert all(torch.equal(v, want) for vols in got.values() for v in vols)
    assert len(got) == 2 and torch.equal(mats, before)
    assert executor.default_matrix_cache().stats()["misses"] == 1
