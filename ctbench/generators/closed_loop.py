"""Closed loop: one client calls ``repro_torch.reconstruct`` back to back.

Parameters (the traffic file): ``pool``, the number of distinct scans,
made on the device at set-up and used in turns; ``sample``, how many
volumes the check keeps. Each call ends with its volume ready: the
client synchronizes before the next call. The window closes at the
completion of the volume in flight once ``--seconds`` have passed, so
it always holds whole volumes, and its length is the clock's reading
then.
"""

from __future__ import annotations

import time

from ctbench.core import sync
from ctbench.scans import make_scans


class Generator:
    def __init__(self, run, sampler):
        self.run = run
        self.sampler = sampler
        self.pool = int(run.traffic["pool"])

    def _call(self, scan):
        import repro_torch
        c = self.run.config
        return repro_torch.reconstruct(
            scan, self.geom, method="fdk",
            options=repro_torch.ReconOptions(
                variant=c["variant"], nb=c["nb"], precision=c["precision"]),
            device=self.run.device)

    def setup(self) -> None:
        run = self.run
        self.geom = run.geometry()
        self.scans = make_scans(run.config, run.seed, self.pool, run.device)
        for scan in self.scans:        # every shape the window uses
            vol = self._call(scan)
            sync(run.device)
            del vol

    def window(self) -> None:
        run = self.run
        t0 = run.window_start
        n = 0
        while True:
            i = n % self.pool
            run.attempted += 1
            with run.range("ctbench.call"):
                try:
                    vol = self._call(self.scans[i])
                    sync(run.device)
                except Exception as exc:     # a failed call is counted
                    run.failed += 1
                    run.notes.append(f"call {n} failed: {exc!r}")
                    vol = None
            t = time.perf_counter()
            if vol is not None:
                run.records.append({"done": t - t0, "scan": i})
                self.sampler.offer(i, vol)
                del vol
            n += 1
            if t - t0 >= run.seconds:
                break
        run.window_s = t - t0

    def finish(self) -> None:
        pass

    def release(self) -> None:
        self.scans = None
