"""The paper's own workload: cone-beam back-projection problems P1..P10
(paper Table 3)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.geometry import CTGeometry, standard_geometry


@dataclasses.dataclass(frozen=True)
class CTProblem:
    label: str
    det: int          # detector is det x det
    n_proj: int
    vol: int          # volume is vol^3

    def geometry(self) -> CTGeometry:
        return standard_geometry(n=self.vol, n_det=self.det,
                                 n_proj=self.n_proj)

    @property
    def updates(self) -> int:
        """GUPS numerator: nx*ny*nz*np."""
        return self.vol ** 3 * self.n_proj


# Paper Table 3. (P10's 1300^3 volume is ~8.8 GB in float32.)
PROBLEMS: Tuple[CTProblem, ...] = (
    CTProblem("P1", 256, 512, 256),
    CTProblem("P2", 256, 512, 512),
    CTProblem("P3", 256, 512, 1024),
    CTProblem("P4", 512, 512, 256),
    CTProblem("P5", 512, 512, 512),
    CTProblem("P6", 512, 512, 1024),
    CTProblem("P7", 1024, 512, 256),
    CTProblem("P8", 1024, 512, 512),
    CTProblem("P9", 1024, 512, 1024),
    CTProblem("P10", 1024, 512, 1300),
)


def get_problem(label: str) -> CTProblem:
    for p in PROBLEMS:
        if p.label == label:
            return p
    raise KeyError(label)


def smoke_problem() -> CTProblem:
    """Reduced problem for CPU tests (same structure as P5)."""
    return CTProblem("P5-smoke", 24, 8, 16)
