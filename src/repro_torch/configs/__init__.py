"""Architecture registry of the port: ``get_config`` / ``get_reduced`` /
``all_configs``, and the shape cells (``SHAPES``, ``applicable``).

Port of ``repro.configs``: every architecture id of the reference
resolves, full and reduced.  Unknown ids raise ``KeyError`` as in the
reference.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

from .shapes import SHAPES, ShapeCell, applicable  # re-export

_MODULES = {
    "qwen2-vl-2b": "qwen2_vl_2b",
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen3-14b": "qwen3_14b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "yi-9b": "yi_9b",
    "mamba2-130m": "mamba2_130m",
    "zamba2-2.7b": "zamba2_2_7b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}
# the ids the port serves: all of the reference's
PORTED = tuple(_MODULES)

ARCH_IDS: List[str] = list(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).FULL


def get_reduced(arch: str) -> ModelConfig:
    return _mod(arch).reduced()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
