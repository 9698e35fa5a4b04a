"""Straggler detection and mitigation (the port's copy of the JAX
package's module, pure Python, same behaviour).

On a synchronous SPMD mesh the slowest host sets the step time. The
monitor tracks a robust (median + MAD) model of recent step durations and
flags outliers; mitigation relies on the data pipeline's determinism:

  * **skip-ahead**: a host that fell behind on input synthesis seeks the
    pipeline forward — it never needs to replay missed batches;
  * **backup-step** (cluster mode): the supervisor reassigns a flagged
    host's data shard to a hot spare for the next step — any host can
    synthesize any shard because batch_at(step, shard) is pure.

The reconstruction fleet (``runtime.executor.PlanExecutor.execute_fleet``)
uses the same model per fleet ENTRY (a torch device; an entry may
repeat): a :class:`FleetStragglerBoard` keeps one
monitor per fleet member and flags devices whose recent step times fall
behind the fleet-wide median — the signal the work-stealing victim
choice prefers, so a slow device's unclaimed ``StepWork`` migrates to
healthy ones.
"""

from __future__ import annotations

import collections
import statistics
import threading
from typing import Deque, Optional, Tuple


class StragglerMonitor:
    def __init__(self, window: int = 32, threshold: float = 3.0,
                 floor_frac: float = 0.01):
        self.durations: Deque[float] = collections.deque(maxlen=window)
        self.threshold = threshold
        self.floor_frac = floor_frac
        self.flagged_steps = []

    def record(self, step: int, duration_s: float) -> bool:
        """Returns True if this step is a straggler outlier."""
        is_out = False
        if len(self.durations) >= 8:
            med = statistics.median(self.durations)
            mad = statistics.median([abs(d - med) for d in self.durations])
            # A near-constant window has MAD ~ 0; the old `mad or 1e-9`
            # floor turned that into a ~nanosecond outlier scale, so any
            # step a microsecond over the median flagged. Floor the
            # scale at floor_frac of the median instead (plus a tiny
            # absolute epsilon for a degenerate all-zero window): only
            # steps slower by a real fraction of the median can flag.
            scale = max(1.4826 * mad, self.floor_frac * med, 1e-9)
            if (duration_s - med) / scale > self.threshold:
                is_out = True
                self.flagged_steps.append(step)
        self.durations.append(duration_s)
        return is_out

    @property
    def median(self) -> Optional[float]:
        if not self.durations:
            return None
        return statistics.median(self.durations)


class FleetStragglerBoard:
    """Cross-device straggler flagging for the reconstruction fleet.

    One :class:`StragglerMonitor` per device records that device's step
    durations (per-device jitter model); a device is FLAGGED when its
    recent median exceeds ``ratio`` x the fleet-wide median of the last
    recordings. Flagging is sticky only while the imbalance persists: a
    device that catches back up is unflagged on its next record.
    Thread-safe — fleet workers record concurrently.
    """

    def __init__(self, n_devices: int, *, window: int = 32,
                 ratio: float = 1.5, min_samples: int = 1):
        if n_devices < 1:
            raise ValueError(f"n_devices must be >= 1, got {n_devices}")
        self.monitors = [StragglerMonitor(window=window)
                         for _ in range(n_devices)]
        self.ratio = float(ratio)
        self.min_samples = int(min_samples)
        self._all: Deque[float] = collections.deque(
            maxlen=window * n_devices)
        self._flagged = set()
        self._lock = threading.Lock()

    def record(self, device: int, step: int, duration_s: float) -> bool:
        """Record one step's duration for ``device``; returns whether
        the device is flagged as a fleet straggler after this sample."""
        with self._lock:
            self.monitors[device].record(step, duration_s)
            self._all.append(float(duration_s))
            dev_med = self.monitors[device].median
            n_dev = len(self.monitors[device].durations)
            if n_dev >= self.min_samples and len(self._all) >= 4:
                fleet_med = statistics.median(self._all)
                if dev_med > self.ratio * max(fleet_med, 1e-12):
                    self._flagged.add(device)
                else:
                    self._flagged.discard(device)
            return device in self._flagged

    @property
    def flagged(self) -> Tuple[int, ...]:
        """Currently-flagged device indices (sorted)."""
        with self._lock:
            return tuple(sorted(self._flagged))
