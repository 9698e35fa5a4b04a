"""Learning-rate schedules (pure functions of the step)."""

from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, base_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_ratio * base_lr``.

    ``step`` is an integer or a tensor (the optimizer's step counter, on
    its device); the result is a float32 scalar tensor on that device,
    computed in float32 in the reference's order, with no host sync.
    """
    step = torch.as_tensor(step).to(torch.float32)
    warm = max(warmup_steps, 1)
    warm_lr = base_lr * step / warm
    t = torch.clamp((step - warmup_steps)
                    / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos_lr = base_lr * (min_ratio + (1 - min_ratio)
                        * 0.5 * (1.0 + torch.cos(math.pi * t)))
    return torch.where(step < warmup_steps, warm_lr, cos_lr)
