"""Kernel plane of the PyTorch port: the hand-written CUDA kernels
(``csrc/``), their plain PyTorch versions (``ref``), the wrappers
(``ops``) and the backend registry that routes every data-plane hot spot
through one resolved :class:`KernelConfig`.
"""
from .backend import (BACKENDS, KernelConfig, default_backend, resolve,
                      resolve_device, set_default_backend)
from .build import LAUNCHES, reset_launch_counts

__all__ = [
    "BACKENDS", "KernelConfig", "LAUNCHES", "default_backend",
    "reset_launch_counts", "resolve", "resolve_device",
    "set_default_backend",
]
