"""Device resolution shared by every entry point of the port.

``device=None`` means the CUDA card. There is no silent CPU: without a
card, the caller has to ask for ``device="cpu"`` itself.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on (``None`` -> ``"cuda"``).

    Raises ``RuntimeError`` for a CUDA device when no card is present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a CUDA or CPU device, got {dev}")
    return dev


def check_on_device(name: str, t: torch.Tensor, device: torch.device) -> None:
    """Raise unless tensor ``t`` lies on ``device`` (index-insensitive
    for an unindexed ``cuda`` request)."""
    if t.device.type != device.type or (
            device.index is not None and t.device.index != device.index):
        raise ValueError(
            f"{name} lies on {t.device}, the call runs on {device}; move "
            f"it there first")


def device_scope(device: torch.device):
    """``torch.cuda.device(device)`` for a CUDA device, else a no-op: what
    a worker thread that launches kernels enters first, so that its
    launches, allocations and current stream are the executor's card's."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
