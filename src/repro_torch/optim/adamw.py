"""AdamW with decoupled weight decay and global-norm clipping (port of
``repro.optim.adamw``).

The moments live in float32 on the parameters' device.  The formula is the
reference's, step for step: the gradients are clipped to a global norm of
``max_norm``, the bias corrections are taken in float32, and the decay
sits inside the step (``delta = mhat / (sqrt(vhat) + eps) + wd * p``,
``p -= lr * delta``).  ``torch.optim.AdamW`` is not this: it decays ``p``
in a separate multiply, rounds in another order and has no global-norm
clip.

The update runs under ``torch.no_grad`` and writes ``params`` and the
moments IN PLACE (the reference's training loop donates both to the
jitted step, so nothing reads the old values); it returns them, with a new
step counter, as the reference returns its new trees.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.module import tree_leaves


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32 scalar
    m: Any                      # float32 tree shaped like the parameters
    v: Any


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def adamw_init(params) -> AdamWState:
    """Zero moments in float32 beside every parameter leaf, step 0."""
    dev = tree_leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                      _zeros_like_tree(params), _zeros_like_tree(params))


def _scale_tree(tree, scale):
    if isinstance(tree, dict):
        return {k: _scale_tree(v, scale) for k, v in tree.items()}
    return tree * scale.to(tree.dtype)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so that their global norm is at most ``max_norm``,
    the global norm before clipping, a float32 scalar tensor)."""
    gn = torch.stack([g.float().pow(2).sum()
                      for g in tree_leaves(grads)]).sum().sqrt()
    scale = torch.clamp(max_norm / gn.clamp_min(1e-9), max=1.0)
    return _scale_tree(grads, scale), gn


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_norm: float = 1.0):
    """One AdamW step over trees of the same keys.  Returns (params,
    AdamWState(step + 1, m, v), global norm of ``grads`` before clipping);
    ``params`` and the moments are the inputs, updated in place."""
    grads, gnorm = clip_by_global_norm(grads, max_norm)
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1) / ((v / bc2).sqrt() + eps) \
            + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, AdamWState(step, state.m, state.v), gnorm
