"""Open loop: requests arrive on a fixed schedule at ``ReconService``.

Parameters (the traffic file): ``rate_per_s``, the mean arrival rate;
``block`` and ``order_seed``, the arrival pattern's (below);
``pool``, the number of distinct scans, made on the device at set-up and
handed over as host numpy arrays; ``max_inflight`` and ``max_batch``,
the service's; ``drain_s``, how long after the last arrival requests are
waited for; ``sample``, how many volumes the check keeps.

The schedule is Poisson-like and the same for every seed: ``N = rate *
seconds`` requests in blocks of ``block``, the gaps of each block the
``block`` quantiles of an exponential distribution of mean ``1 / rate``
(all gaps scaled to sum to ``seconds``), ordered inside each block by
the traffic file's ``order_seed``. The run's seed draws the scans'
contents and which scan each request carries (each equally often). An
order drawn from the run's seed moved the tail by up to 30% from seed to
seed, far more than two runs of one seed differ, so the arrival pattern
is part of the traffic mix, as its rate is.
Each request is timed from its due
time to the resolution of its future; the service synchronizes its
stream before it resolves one. Arrivals stop at ``--seconds``; every
request is waited for, and one that fails or does not finish within
``drain_s`` counts as failed, with an infinite latency.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ctbench.core import sync
from ctbench.scans import make_scans


def schedule(rate: float, seconds: float, pool: int, seed: int,
             block: int, order_seed: int):
    """(due times in seconds from the window's start, scan of each)."""
    n = max(1, int(round(rate * seconds)))
    order = np.random.default_rng([int(order_seed), 3])
    parts = []
    for b0 in range(0, n, block):
        m = min(block, n - b0)
        parts.append(order.permutation(-np.log1p(-(np.arange(m) + 0.5) / m)))
    gaps = np.concatenate(parts)
    gaps *= seconds / gaps.sum()
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    pick = np.random.default_rng([int(seed) & (2 ** 64 - 1), 4])
    return due, pick.permutation(np.arange(n) % pool)


class Generator:
    def __init__(self, run, sampler):
        self.run = run
        self.sampler = sampler
        t = run.traffic
        self.pool = int(t["pool"])
        self.rate = float(t["rate_per_s"])
        self.drain_s = float(t.get("drain_s", 60.0))
        self.svc_args = dict(max_inflight=int(t["max_inflight"]),
                             max_batch=int(t["max_batch"]))
        self._cond = threading.Condition()
        self._pending = 0

    def _options(self):
        c = self.run.config
        return dict(variant=c["variant"], nb=c["nb"],
                    precision=c["precision"])

    def setup(self) -> None:
        from repro_torch.runtime.service import ReconService
        run = self.run
        self.geom = run.geometry()
        scans = make_scans(run.config, run.seed, self.pool, run.device)
        self.host = [s.cpu().numpy() for s in scans]
        del scans
        self.svc = ReconService(device=run.device, **self.svc_args)
        self.svc.warmup([self.geom], **self._options())
        # every batch size the former can ship, through the whole path
        for k in range(self.svc_args["max_batch"], 0, -1):
            futs = [self.svc.submit(self.host[i % self.pool], self.geom,
                                    **self._options()) for i in range(k)]
            for f in futs:
                f.result()
            del futs
        sync(run.device)
        self.due, self.scan_of = self.schedule(self.rate)
        self.base = self._counts()

    def schedule(self, rate: float):
        t = self.run.traffic
        return schedule(rate, self.run.seconds, self.pool, self.run.seed,
                        int(t["block"]), int(t["order_seed"]))

    def _counts(self) -> dict:
        st = self.svc.stats()
        return {"dispatches": sum(b.dispatches for b in st.buckets),
                "completed": sum(b.completed for b in st.buckets)}

    def _done(self, rec, fut) -> None:
        rec["done"] = time.perf_counter() - self.run.window_start
        exc = fut.exception()
        if exc is None:
            rec["ok"] = True
            self.sampler.offer(rec["scan"], fut.result())
        else:
            rec["ok"] = False
            rec["error"] = repr(exc)
        with self._cond:
            self._pending -= 1
            self._cond.notify_all()

    def window(self) -> None:
        run = self.run
        t0 = run.window_start
        opts = self._options()
        for due, s in zip(self.due, self.scan_of):
            wait = t0 + due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            rec = {"due": float(due), "scan": int(s), "ok": False,
                   "done": None}
            rec["sent"] = time.perf_counter() - t0
            run.records.append(rec)
            run.attempted += 1
            with self._cond:
                self._pending += 1
            try:
                fut = self.svc.submit(self.host[s], self.geom, **opts)
            except Exception as exc:         # refused: a failed request
                rec["error"] = repr(exc)
                with self._cond:
                    self._pending -= 1
                continue
            rec["trace_id"] = getattr(fut, "trace_id", None)
            fut.add_done_callback(lambda f, r=rec: self._done(r, f))
            del fut
        limit = time.perf_counter() + self.drain_s
        with self._cond:
            while self._pending > 0:
                left = limit - time.perf_counter()
                if left <= 0:
                    break
                self._cond.wait(min(left, 0.5))
        run.window_s = time.perf_counter() - t0

    def finish(self) -> None:
        run = self.run
        now = self._counts()
        run.counters = {k: now[k] - self.base[k] for k in now}
        for rec in run.records:
            if not rec["ok"]:
                run.failed += 1
                rec["latency"] = float("inf")
            else:
                rec["latency"] = rec["done"] - rec["due"]
        late = [r["sent"] - r["due"] for r in run.records]
        run.notes.append(
            f"generator lateness: mean {1e3 * float(np.mean(late))!r} ms, "
            f"max {1e3 * float(np.max(late))!r} ms over {len(late)} "
            f"requests")

    def release(self) -> None:
        self.svc.close(wait=self._pending == 0)
        self.svc = None
        self.host = None
