"""Minimal functional module system: parameter specs and their
materialization.

Port of ``repro.models.module``.  Models are described as nested dicts of
:class:`ParamSpec`; :func:`materialize` turns a spec tree into tensors on a
given device, drawn from a ``torch.Generator``.  Forward functions are plain
functions over the materialized tree (nested dicts of tensors), with the
reference's key names and stacked ``[L, ...]`` leaves, so that
``models.convert.params_from_jax`` can carry weights across unchanged.

:func:`abstract` is the reference's shape-only stand-in: the tree as
tensors on the ``meta`` device, which hold a shape and a dtype and no
memory.

Not ported, because one card has no mesh: the logical-axis rules and
``partition_spec`` / ``param_shardings``, ``shard_activation`` and
``fsdp_gather`` (GSPMD constraints that are no-ops without a mesh in the
reference too).  The ``axes`` field of a spec is kept as documentation.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: Any
    axes: Tuple[Optional[str], ...]   # one logical axis name (or None) per dim
    init: str = "normal"              # normal | zeros | ones
    scale: float = 1.0


def spec(shape, axes, dtype=torch.float32, init="normal",
         scale=None) -> ParamSpec:
    shape = tuple(int(s) for s in shape)
    assert len(shape) == len(axes), (shape, axes)
    if scale is None:
        # fan-in scaled normal by default
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    return ParamSpec(shape, dtype, tuple(axes), init, float(scale))


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in the reference's order (keys sorted, as
    ``jax.tree_util`` flattens dicts)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def materialize(specs, generator: torch.Generator, device=None):
    """Real parameter tensors on ``device`` (the generator's device by
    default), drawn leaf by leaf in :func:`tree_leaves` order from
    ``generator``: normal leaves are ``N(0, 1) * scale`` in float32, then
    cast to the spec's dtype."""
    device = generator.device if device is None else torch.device(device)

    def one(s: ParamSpec):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(s.scale).to(s.dtype)

    out = {}

    def walk(src, dst):
        for k in sorted(src):
            if isinstance(src[k], dict):
                dst[k] = {}
                walk(src[k], dst[k])
            else:
                dst[k] = one(src[k])
    walk(specs, out)
    return out



def abstract(specs):
    """The spec tree as tensors on the ``meta`` device (shape and dtype,
    no storage): the reference's ``ShapeDtypeStruct`` tree."""
    if isinstance(specs, ParamSpec):
        return torch.empty(specs.shape, dtype=specs.dtype, device="meta")
    return {k: abstract(specs[k]) for k in sorted(specs)}
