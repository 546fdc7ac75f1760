"""Train / prefill / decode step factories (port of
``repro.launch.train``).

``make_train_step`` / ``make_prefill_step`` / ``make_decode_step`` return
the model and a plain function over (params, opt_state, batch), (params,
batch) or (params, cache, batch); PyTorch runs eagerly, so there is
nothing to jit.  ``greedy_decode`` is the decode step over an already
built model, which ``Server`` uses.  ``abstract_train_state`` gives the
parameters and the optimizer state on the ``meta`` device.

The train step takes the gradient of ``model.loss`` with
``torch.autograd.grad`` over the parameter leaves and applies
``adamw_update``, which writes the parameters and the moments in place
(as the reference's loop donates them).  On the ``cuda`` route the
gradients of attention and of the SSD scan run hand-written backward
kernels (``FlashAttentionFn``, ``SsdScanFn``), so every family trains
there; what the port does not run yet is ``ROADMAP.md`` queue 1, item 1.2
(full-depth deepseek-coder-33b and phi3.5-moe).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build
from repro_torch.models.module import abstract, tree_leaves
from repro_torch.optim import adamw_init, adamw_update


def _detached(tree):
    """Leaves that share the parameters' storage and require a gradient."""
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach().requires_grad_(True)


def _like(tree, leaves):
    if isinstance(tree, dict):
        return {k: _like(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def loss_and_grads(model, params, batch):
    """(loss, metrics, gradients): ``model.loss`` of the batch and its
    gradient with respect to every parameter leaf, a tree shaped like
    ``params`` (``torch.autograd.grad``; ``params`` are left as they
    are)."""
    leaves = _detached(params)
    loss, metrics = model.loss(leaves, batch)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    return loss.detach(), metrics, _like(params, iter(grads))


def make_train_step(cfg: ModelConfig, lr: float = 3e-4,
                    weight_decay: float = 0.1, kernels=None):
    model = build(cfg, kernels)

    def train_step(params, opt_state, batch):
        """(params, opt_state, {"loss", "gnorm", "ce", ...}): one AdamW
        step on the gradient of the batch's loss; the metrics are scalar
        tensors on the parameters' device."""
        loss, metrics, grads = loss_and_grads(model, params, batch)
        params2, opt2, gnorm = adamw_update(params, grads, opt_state, lr,
                                            weight_decay=weight_decay)
        out = {"loss": loss, "gnorm": gnorm,
               **{k: v.detach() for k, v in metrics.items()}}
        return params2, opt2, out

    return model, train_step


def make_prefill_step(cfg: ModelConfig, kernels=None):
    model = build(cfg, kernels)
    return model, model.prefill


def greedy_decode(model, params, cache, batch):
    """One decode step and its greedy next token (the serving harness feeds
    it back)."""
    logits, cache2 = model.decode(params, cache, batch)
    nxt = logits[..., : model.cfg.vocab_size].argmax(dim=-1).int()
    return nxt, cache2


def make_decode_step(cfg: ModelConfig, kernels=None):
    model = build(cfg, kernels)
    return model, functools.partial(greedy_decode, model)


def abstract_train_state(cfg: ModelConfig, kernels=None):
    """(model, params, opt_state) as tensors on the ``meta`` device: the
    shapes and dtypes of a training state without allocating it."""
    model = build(cfg, kernels)
    params = abstract(model.param_specs())
    return model, params, adamw_init(params)
