"""How host arrays reach the device in ``PlanExecutor._as_input``.

On the CPU, and for arrays of less than a MiB of float32, the copy is
``convert.tensor_from_numpy``'s, bit for bit; a larger array bound for a
card goes through the calling thread's pinned staging ring
(``executor._HostStager``), whose slot walk covers every byte once. The
tests marked ``cuda`` hold the ring on the card against a plain ``.to``
(skipped without one):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ingest.py

Imports nothing of JAX.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import host_float32, tensor_from_numpy
from repro_torch.core.fdk import fdk_reconstruct
from repro_torch.core.geometry import standard_geometry
from repro_torch.runtime import executor, telemetry
from repro_torch.runtime.executor import PlanExecutor, ProgramCache
from repro_torch.runtime.planner import plan_reconstruction
from repro_torch.runtime.service import ReconService

SLOT = executor._STAGE_SLOT_BYTES
MIB = executor._STAGE_MIN_BYTES
# byte counts around the slot size, and a ring walked nine times over
STAGE_BYTES = [0, SLOT - 4, SLOT, SLOT + 4, int(9.3 * SLOT) // 4 * 4]


def _executor(device="cpu"):
    g = standard_geometry(n=8, n_det=12, n_proj=4)
    plan = plan_reconstruction(g, "algorithm1_mp", nb=2)
    return PlanExecutor(g, plan, ProgramCache(), device=device)


def _host(kind, n_bytes, seed=0):
    """A host array of ``n_bytes`` float32 bytes in one of the forms a
    caller may hand over."""
    n = n_bytes // 4
    rng = np.random.RandomState(seed)
    if kind == "float32":
        return rng.rand(n).astype(np.float32).reshape(-1, 4)
    if kind == "float64":
        return rng.rand(n // 4, 4)
    if kind == "strided":
        return rng.rand(n // 2, 4).astype(np.float32)[::2]
    if kind == "transposed":
        return rng.rand(4, n // 4).astype(np.float32).T
    if kind == "read_only":
        a = rng.rand(n // 4, 4).astype(np.float32)
        v = a[:]
        v.flags.writeable = False
        return v
    raise ValueError(kind)


KINDS = ["float32", "float64", "strided", "transposed", "read_only"]


@pytest.mark.parametrize("n_bytes", [4096, 2 * MIB], ids=["small", "large"])
@pytest.mark.parametrize("kind", KINDS)
def test_as_input_on_the_cpu_equals_tensor_from_numpy(kind, n_bytes):
    """On a CPU executor every array keeps the plain copy, whatever its
    size, dtype or layout, with tensor_from_numpy's bits."""
    a = _host(kind, n_bytes)
    assert executor._ingest_path(a, torch.device("cpu")) == "pageable"
    got = _executor()._as_input("projections", a)
    want = tensor_from_numpy(a, "cpu")
    assert got.dtype == torch.float32 and got.shape == a.shape
    assert torch.equal(got, want)
    assert np.array_equal(got.numpy(), a.astype(np.float32))


class _Recorder:
    """Stands in for the thread's stager on a machine without a card."""

    def __init__(self):
        self.arrays = []

    def ingest(self, arr):
        self.arrays.append(arr)
        return torch.from_numpy(arr.copy())


@pytest.fixture
def card_executor(monkeypatch):
    """A CPU executor that takes its device for a card: the copies it
    would make are recorded, and made on the CPU."""
    ex = _executor()
    ex.device = torch.device("cuda")
    plain, staged = [], _Recorder()

    def to_device(a, device=None):
        plain.append(a)
        return tensor_from_numpy(a, "cpu")

    monkeypatch.setattr(executor, "tensor_from_numpy", to_device)
    monkeypatch.setattr(executor, "_thread_stager", lambda device: staged)
    return ex, plain, staged


@pytest.mark.parametrize("kind", KINDS)
def test_arrays_under_a_mib_keep_the_plain_copy_on_a_card(card_executor,
                                                          kind):
    ex, plain, staged = card_executor
    a = _host(kind, MIB - 64)
    assert executor._ingest_path(a, ex.device) == "pageable"
    got = ex._as_input("projections", a)
    assert len(plain) == 1 and plain[0] is a and not staged.arrays
    assert torch.equal(got, tensor_from_numpy(a, "cpu"))


@pytest.mark.parametrize("kind", KINDS)
def test_arrays_of_a_mib_or_more_are_staged_on_a_card(card_executor, kind):
    """The stager receives the array converted as tensor_from_numpy
    converts it: C-contiguous, writable float32 with the same values."""
    ex, plain, staged = card_executor
    a = _host(kind, 2 * MIB)
    assert executor._ingest_path(a, ex.device) == "pinned"
    got = ex._as_input("projections", a)
    assert not plain and len(staged.arrays) == 1
    arr = staged.arrays[0]
    assert arr.dtype == np.float32 and arr.flags.c_contiguous
    assert arr.flags.writeable
    assert np.array_equal(arr, host_float32(a))
    assert torch.equal(got, tensor_from_numpy(a, "cpu"))


@pytest.mark.parametrize("n_bytes,dtype,path", [
    (MIB - 4, np.float32, "pageable"), (MIB, np.float32, "pinned"),
    (MIB, np.float64, "pageable"), (2 * MIB, np.float64, "pinned"),
    (0, np.float32, "pageable")])
def test_the_path_follows_the_float32_size(n_bytes, dtype, path):
    a = np.zeros(n_bytes // np.dtype(dtype).itemsize, dtype)
    assert executor._ingest_path(a, torch.device("cuda")) == path
    assert executor._ingest_path(a, torch.device("cuda", 0)) == path
    assert executor._ingest_path(a, torch.device("cpu")) == "pageable"


@pytest.mark.parametrize("n_bytes", STAGE_BYTES,
                         ids=["0", "slot-4", "slot", "slot+4", "9.3slots"])
def test_stage_pieces_cover_every_byte_once(n_bytes):
    pieces = executor._stage_pieces(n_bytes)
    assert len(pieces) == -(-n_bytes // SLOT)
    at = 0
    for b0, b1 in pieces:
        assert b0 == at and 0 < b1 - b0 <= SLOT
        assert b0 % 4 == 0 and b1 % 4 == 0    # whole float32 samples
        at = b1
    assert at == n_bytes
    # a smaller slot: pieces of it, the last one the remainder
    assert executor._stage_pieces(n_bytes, 4096) == [
        (o, min(o + 4096, n_bytes)) for o in range(0, n_bytes, 4096)]


# ---- on the card ----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _random(n_bytes, seed):
    return np.random.default_rng(seed).random(n_bytes // 4,
                                              dtype=np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("n_bytes", STAGE_BYTES,
                         ids=["0", "slot-4", "slot", "slot+4", "9.3slots"])
def test_staged_ingest_equals_a_plain_copy(cuda, n_bytes):
    a = _random(n_bytes, n_bytes % 1000)
    want = torch.from_numpy(a).to(cuda)
    got = executor._thread_stager(cuda).ingest(a)
    assert got.device == cuda and torch.equal(got, want)
    if executor._ingest_path(a, cuda) == "pinned":
        got = _executor(cuda)._as_input("projections", a.reshape(1, -1))
        assert torch.equal(got.view(-1), want)


@pytest.mark.cuda
def test_overwriting_the_array_after_ingest_changes_nothing(cuda):
    a = _random(int(2.5 * SLOT) // 4 * 4, 11)
    want = a.copy()
    got = executor._thread_stager(cuda).ingest(a)
    a[:] = -1.0     # the call has read every byte: the caller may reuse it
    torch.cuda.synchronize(cuda)
    assert torch.equal(got.cpu(), torch.from_numpy(want))


@pytest.mark.cuda
def test_two_threads_ingest_at_once_through_their_own_stagers(cuda):
    arrays = [[_random(int(2.5 * SLOT) // 4 * 4, 20 + 3 * t + i)
               for i in range(3)] for t in range(2)]
    start = threading.Barrier(2, timeout=60)
    stagers, results, errors = {}, {}, []

    def run(t):
        try:
            with torch.cuda.device(cuda):
                start.wait()
                got = []
                for a in arrays[t]:
                    st = executor._thread_stager(cuda)
                    stagers.setdefault(t, set()).add(id(st))
                    got.append(st.ingest(a))
                torch.cuda.current_stream(cuda).synchronize()
                results[t] = got
        except BaseException as exc:   # reported by the main thread
            errors.append(exc)
            raise

    threads = [threading.Thread(target=run, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    assert not errors
    assert all(len(stagers[t]) == 1 for t in range(2))
    assert stagers[0] != stagers[1]
    for t in range(2):
        for a, got in zip(arrays[t], results[t]):
            assert torch.equal(got.cpu(), torch.from_numpy(a))


@pytest.mark.cuda
def test_service_fed_host_scans_equals_scans_on_the_card(cuda):
    """ReconService(max_inflight=2, max_batch=4) serving host scans of a
    MiB or more (each ingested through its worker's stager) returns the
    volumes of reconstruct on the same scans placed on the card first,
    bit for bit."""
    g = standard_geometry(n=32, n_det=96, n_proj=64)
    rng = np.random.RandomState(5)
    scans = [rng.rand(g.n_proj, g.nh, g.nw).astype(np.float32)
             for _ in range(8)]
    assert executor._ingest_path(scans[0], cuda) == "pinned"
    opts = dict(variant="subline_pl", nb=4)
    want = [fdk_reconstruct(torch.from_numpy(p).to(cuda), g, **opts)
            for p in scans]
    with telemetry.tracing():
        with ReconService(device=cuda, max_inflight=2, max_batch=4,
                          cache=ProgramCache()) as svc:
            futs = [svc.submit(p, g, **opts) for p in scans]
            got = [f.result(timeout=300) for f in futs]
        ingest = [e for e in telemetry.events() if e["name"] == "ingest"]
    assert len(ingest) == len(scans)
    assert all(e["args"]["path"] == "pinned" for e in ingest)
    for a, b in zip(want, got):
        a = a.cpu() if isinstance(a, torch.Tensor) else torch.from_numpy(a)
        b = b.cpu() if isinstance(b, torch.Tensor) else torch.from_numpy(b)
        assert torch.equal(a, b)
