"""Architecture registry of the port: ``get_config`` / ``get_reduced``.

Port of ``repro.configs``.  The registry knows every architecture id of
the reference, but only the families the port serves resolve: an id whose
family is not ported yet raises ``NotImplementedError`` naming the
ROADMAP.md item that brings it.  Unknown ids raise ``KeyError`` as in the
reference.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import NOT_YET, ModelConfig

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
PORTED = ("zamba2-2.7b", "qwen2-vl-2b", "qwen2-0.5b", "qwen3-14b",
          "deepseek-coder-33b", "yi-9b", "phi3.5-moe-42b-a6.6b",
          "deepseek-moe-16b")

ARCH_IDS: List[str] = list(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet ({NOT_YET}: "
            f"SSMModel, EncDecModel); "
            f"ported: {list(PORTED)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).FULL


def get_reduced(arch: str) -> ModelConfig:
    return _mod(arch).reduced()
