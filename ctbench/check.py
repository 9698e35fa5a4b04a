"""What decides ``correct``: the program's volumes against the plain FDK.

During the window the generator offers every volume it receives to a
:class:`Sampler`, which keeps a reservoir sample of them, drawn from the
seed, uniform over all volumes of the window. Of a kept volume it keeps
only a set of whole voxel columns (every ``k`` at a set of ``(i, j)``,
drawn from the seed), copied out on the device when the volume is
offered, so holding a sample costs the program no memory.

After the window, with the program's state freed, ``judge`` makes each
sampled volume's scan again from the seed, runs the reference
(``reference/fdk.py``) at the sampled columns in float64, and compares:

* ``rel_rmse``: ``||program - reference|| / ||reference||`` over the
  sampled columns of one volume, less the 0.1% of them (at least one)
  whose error is largest; the worst volume is the number compared with
  the configuration's ``check.rel_rmse_limit``. The columns left out
  are for the float32 rounding at the detector's edge: a voxel whose
  projection falls a hair inside the last detector column in float64
  can fall on it in float32, where the interpolation rule drops the
  sample, and one view's whole contribution to that column is then
  missing (seen at P10 on one seed in twelve). Every fault the check is
  for spreads over many columns.

A volume that never came, or is not finite, fails.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ctbench.reference.fdk import fdk_columns
from ctbench.scans import make_scans


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


#: the share of sampled columns, those with the largest error, that the
#: comparison leaves out (at least one)
TRIM = 0.001


def trimmed_rel_rmse(got: torch.Tensor, ref: torch.Tensor) -> float:
    """``||got - ref|| / ||ref||`` over the columns ``(c, nz)`` less the
    ``TRIM`` share (at least one) whose error norm is largest."""
    err = (got - ref).norm(dim=1)
    drop = max(1, int(TRIM * err.numel()))
    keep = torch.argsort(err)[:err.numel() - drop]
    return float((got[keep] - ref[keep]).norm() / ref[keep].norm())


class Sampler:
    """A reservoir of ``traffic["sample"]`` volumes, each kept as its
    sampled columns. Thread-safe: a served cell offers from the
    service's worker threads."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        self.config = config
        self.seed = int(seed)
        self.device = device
        self.keep = int(traffic.get("sample", 2))
        n = config["volume"]
        cols = min(int(config["check"]["columns"]), n * n)
        flat = _rng(seed, 1).choice(n * n, size=cols, replace=False)
        self.ii = torch.as_tensor(flat // n, device=device)
        self.jj = torch.as_tensor(flat % n, device=device)
        self._pick = _rng(seed, 2)
        self._lock = threading.Lock()
        self.offered = 0
        self.kept: List[dict] = []
        self.seconds = 0.0        # the reference's time, once judged

    def columns(self, vol_zyx: torch.Tensor) -> torch.Tensor:
        """The sampled columns ``(c, nz)`` of a ``(nz, ny, nx)`` volume."""
        return vol_zyx.permute(2, 1, 0)[self.ii, self.jj, :].clone()

    def offer(self, scan: int, vol_zyx) -> None:
        """Offer the volume made from pool scan ``scan``."""
        with self._lock:
            self.offered += 1
            if len(self.kept) < self.keep:
                slot = len(self.kept)
                self.kept.append(None)
            else:
                slot = int(self._pick.integers(0, self.offered))
                if slot >= self.keep:
                    return
            if isinstance(vol_zyx, np.ndarray):
                vol_zyx = torch.from_numpy(vol_zyx).to(self.device)
            self.kept[slot] = {"scan": int(scan),
                               "columns": self.columns(vol_zyx)}

    def judge(self) -> dict:
        """Compare every kept volume with the reference, on the pool's
        scans made again from the seed as the generators make them."""
        cfg = self.config
        limit = cfg["check"].get("rel_rmse_limit")
        worst: Optional[float] = None
        t0 = time.perf_counter()
        if self.kept:
            pool = 1 + max(k["scan"] for k in self.kept)
            scans = make_scans(cfg, self.seed, pool, self.device)
            refs: Dict[int, torch.Tensor] = {}
            per = max(1, min(32, (1 << 24) // (self.ii.numel()
                                                * cfg["volume"])))
            for k in self.kept:
                s = k["scan"]
                if s not in refs:
                    refs[s] = fdk_columns(scans[s], cfg, self.ii, self.jj,
                                          view_block=per)
                got = k["columns"].to(torch.float64)
                if not bool(torch.isfinite(got).all()):
                    err = float("inf")
                else:
                    err = trimmed_rel_rmse(got, refs[s])
                worst = err if worst is None else max(worst, err)
        self.seconds = time.perf_counter() - t0
        numbers = {"rel_rmse": {"value": worst, "limit": limit}}
        ok = (worst is not None and limit is not None and worst <= limit)
        return {"correct": ok, "numbers": numbers}
