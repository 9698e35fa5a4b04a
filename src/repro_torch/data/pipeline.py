"""Input pipelines: the LM token pipeline and the CT projection source.

``TokenPipeline`` is the JAX package's, copied (it is numpy): a
deterministic, seekable, shardable synthetic token stream whose
``batch_at(step)`` equals the reference's bit for bit for every
``(seed, step, shard_index, num_shards)``. Fault-tolerance contract
(``runtime.fault_tolerance`` relies on all three properties):

  * **deterministic**: batch(step, shard) is a pure function of
    (seed, step, shard), so any host can regenerate any batch;
  * **seekable**: ``seek(step)`` is O(1), so restart and straggler
    skip-ahead never replay the stream;
  * **shardable**: hosts own disjoint shards of the global batch; the
    global batch of a step is the concatenation over shards, whatever
    the number of hosts.

The token source is a seeded integer hash with a Zipf-ish marginal (a
stand-in for a tokenized corpus). A background prefetch thread overlaps
host-side batch synthesis with device compute.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np


def _hash_u32(x: np.ndarray) -> np.ndarray:
    """Vectorized xxhash-flavoured integer mix (deterministic)."""
    x = x.astype(np.uint64)
    x = (x ^ (x >> 33)) * np.uint64(0xFF51AFD7ED558CCD)
    x = (x ^ (x >> 33)) * np.uint64(0xC4CEB9FE1A85EC53)
    return (x ^ (x >> 33)).astype(np.uint64)


class TokenPipeline:
    """Synthetic LM token pipeline with prefetch. Batches are dicts of
    numpy int32 ``"tokens"`` and ``"labels"`` (the tokens shifted by
    one), ``(shard_batch, seq_len)`` each."""

    def __init__(self, *, vocab_size: int, seq_len: int, global_batch: int,
                 shard_index: int = 0, num_shards: int = 1, seed: int = 0,
                 prefetch: int = 2):
        if global_batch % num_shards:
            raise ValueError(f"global_batch {global_batch} is not a "
                             f"multiple of num_shards {num_shards}")
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.shard_batch = global_batch // num_shards
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.seed = seed
        self._step = 0
        self._prefetch_n = prefetch
        self._q: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ---- deterministic batch synthesis ------------------------------------
    def _tokens_for(self, step: int) -> np.ndarray:
        """(shard_batch, seq_len+1) tokens for (seed, step, shard)."""
        b = self.shard_batch
        rows = (np.arange(b, dtype=np.uint64)
                + np.uint64(self.shard_index * b))
        cols = np.arange(self.seq_len + 1, dtype=np.uint64)
        with np.errstate(over="ignore"):   # modular u64 arithmetic
            base = (np.uint64(self.seed) * np.uint64(0x9E3779B97F4A7C15)
                    + np.uint64(step) * np.uint64(0x2545F4914F6CDD1D))
            grid = (base + rows[:, None] * np.uint64(1 << 20)
                    + cols[None, :])
            h = _hash_u32(grid)
        # Zipf-ish marginal: square a uniform to skew towards small ids.
        u = (h % np.uint64(1 << 30)).astype(np.float64) / float(1 << 30)
        toks = np.floor((u ** 2.0) * self.vocab_size).astype(np.int32)
        return np.clip(toks, 0, self.vocab_size - 1)

    def batch_at(self, step: int) -> dict:
        t = self._tokens_for(step)
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}

    # ---- iteration / seek --------------------------------------------------
    def seek(self, step: int) -> None:
        """O(1) repositioning (restart, straggler skip-ahead). With the
        prefetch thread running, it restarts at ``step``, so the next
        batch is ``step``'s (the reference drains its queue but lets its
        thread run on from where it was)."""
        self._step = step
        if self._thread is not None:
            self.stop_prefetch()
            self.start_prefetch()

    @property
    def step(self) -> int:
        return self._step

    def __next__(self) -> dict:
        if self._q is None:
            out = self.batch_at(self._step)
            self._step += 1
            return out
        item = self._q.get()
        self._step = item["_step"] + 1
        return {k: v for k, v in item.items() if not k.startswith("_")}

    def __iter__(self) -> Iterator[dict]:
        return self

    # ---- prefetch thread ---------------------------------------------------
    def start_prefetch(self) -> None:
        if self._thread is not None:
            return
        # a fresh queue and event per thread: a thread a seek stopped
        # never feeds its successor
        self._q = queue.Queue(maxsize=self._prefetch_n)
        self._stop = threading.Event()
        q, stop, start = self._q, self._stop, self._step

        def worker():
            s = start
            while not stop.is_set():
                item = self.batch_at(s)
                item["_step"] = s
                try:
                    q.put(item, timeout=0.2)
                    s += 1
                except queue.Full:
                    continue

        self._thread = threading.Thread(target=worker, daemon=True,
                                        name="token-prefetch")
        self._thread.start()

    def stop_prefetch(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._drain()
        self._thread.join(timeout=2.0)
        self._thread = None
        self._q = None

    def _drain(self):
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


class CTProjectionSource:
    """Streams CT projection batches.

    Projections are synthesized once by forward-projecting a phantom
    (``core.forward.forward_project``: the kernel F1 on the card, its
    plain march on the CPU) and then served in angle-contiguous numpy
    batches of ``nb`` (the paper's batch number, the unit the
    back-projection kernels consume) with their view indices. ``device``
    is where the phantom is projected (``None`` -> the CUDA card).
    """

    def __init__(self, geom, *, nb: int = 8, phantom: str = "shepp",
                 device=None):
        from repro_torch.core.forward import forward_project
        from repro_torch.core.phantom import ball_phantom, shepp_logan_3d

        self.geom = geom
        self.nb = nb
        vol = (shepp_logan_3d(geom.nx, geom.ny, geom.nz)
               if phantom == "shepp" else ball_phantom(geom.nx))
        self.volume = vol
        self.projections = forward_project(vol, geom,
                                           device=device).cpu().numpy()

    def __iter__(self):
        n = self.geom.n_proj
        for s0 in range(0, n, self.nb):
            yield self.projections[s0:s0 + self.nb], np.arange(
                s0, min(s0 + self.nb, n))
