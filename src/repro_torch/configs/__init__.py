"""Architecture registry: ``get_config(name)`` / ``get_smoke_config(name)``.

All ten assigned pool architectures (data only; which families build a
model is ``models.model.build_model``'s business) plus the paper's own CT
workload (``configs.ct_paper``).
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from .base import (  # noqa: F401
    LM_SHAPES,
    MeshConfig,
    MLASettings,
    ModelConfig,
    MoESettings,
    RunConfig,
    ShapeConfig,
    get_shape,
)

_ARCH_MODULES: Dict[str, str] = {
    "stablelm-3b": "stablelm_3b",
    "qwen1.5-110b": "qwen1_5_110b",
    "deepseek-67b": "deepseek_67b",
    "qwen2.5-3b": "qwen2_5_3b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "internvl2-1b": "internvl2_1b",
    "rwkv6-3b": "rwkv6_3b",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def _module(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; have {list_archs()} "
                       f"(+ 'ct-backproject' via configs.ct_paper)")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke()
