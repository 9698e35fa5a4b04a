"""CT projection source: the paper's input pipeline.

The LM token pipeline (``TokenPipeline``) comes with training (ROADMAP.md
queue 1 step 2c).
"""

from __future__ import annotations

import numpy as np


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
