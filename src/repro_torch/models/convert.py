"""Carry a parameter tree, or an optimizer state, of the JAX package over
to the port.

``params_from_jax(cfg, tree)`` takes the reference model's parameter pytree
(nested dicts whose leaves are numpy arrays, or anything ``np.asarray``
reads) and returns the port's tree of tensors on ``device``, with the same
keys and the stacked ``[L, ...]`` leaves (``mamba`` / ``shared`` /
``embed`` / ``final_norm``).  Every leaf is checked against the port's
``param_specs`` and takes the spec's dtype, so a ``Server`` can be built
from either framework's weights.  ``opt_state_from_jax(cfg, state)`` does
the same for the reference's ``AdamWState`` (anything with ``step``, ``m``
and ``v``): the moments, checked against the same specs, in float32, and
the step as an int32 scalar.  No JAX is imported here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import resolve_device
from repro_torch.optim import AdamWState

from .config import ModelConfig
from .model import build
from .module import ParamSpec


def _from_jax(cfg: ModelConfig, tree, dev, name, dtype=None):
    """``tree`` checked against the model's specs, as tensors on ``dev`` in
    the spec's dtype (or ``dtype``)."""
    def walk(specs, sub, path):
        if isinstance(specs, ParamSpec):
            a = np.asarray(sub)
            if tuple(a.shape) != specs.shape:
                raise ValueError(f"{path}: shape {a.shape}, expected "
                                 f"{specs.shape}")
            return torch.as_tensor(a.astype(np.float32),
                                   device=dev).to(dtype or specs.dtype)
        if not isinstance(sub, dict) or set(sub) != set(specs):
            raise ValueError(f"{path}: keys {sorted(getattr(sub, 'keys', list)())}"
                             f", expected {sorted(specs)}")
        return {k: walk(specs[k], sub[k], f"{path}/{k}") for k in specs}

    return walk(build(cfg).param_specs(), tree, name)


def params_from_jax(cfg: ModelConfig, tree, device=None):
    return _from_jax(cfg, tree, resolve_device(device), "params")


def opt_state_from_jax(cfg: ModelConfig, state, device=None) -> AdamWState:
    dev = resolve_device(device)
    return AdamWState(
        torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                     device=dev),
        _from_jax(cfg, state.m, dev, "opt.m", torch.float32),
        _from_jax(cfg, state.v, dev, "opt.v", torch.float32))
