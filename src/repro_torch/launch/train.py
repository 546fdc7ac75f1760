"""Prefill / decode step factories (port of ``repro.launch.train``).

``make_prefill_step`` / ``make_decode_step`` return the model and a plain
function over (params, batch) or (params, cache, batch); PyTorch runs
eagerly, so there is nothing to jit.  ``greedy_decode`` is the decode step
over an already built model, which ``Server`` uses.  ``make_train_step``
(the loss, ``adamw`` and the gradient path) comes with the training slice
of the port.
"""
from __future__ import annotations

import functools

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build


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
