"""Input batches for every architecture family (port of
``repro.launch.inputs``).

``input_specs(cfg, shape, mode)`` gives one shape cell's inputs as tensors
on the ``meta`` device (a shape and a dtype, no memory): the dry run
counts a step against them.

``make_batch(cfg, B, S, mode, rng)`` draws small real batches for tests
and examples from a numpy ``RandomState`` in the reference's order, so the
same seed gives the same batch in both packages: token ids and labels,
``[B, S, 3]`` text positions under ``mrope``, the encoder's frame
embeddings (``randn * 0.05``, float32) for ``encdec``; a decode batch is
one token a row and a cache of S filled positions with ``CACHE_PAD``
positions of room (an SSM cache, which does not grow, has none).
Modality frontends are stubs, as in the reference: the VLM batch feeds
token ids plus position ids, the audio batch precomputed frame embeddings.
The tensors land on ``device`` (the CUDA device unless the caller asks
for another).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build

__all__ = ["CACHE_PAD", "ENCDEC_DECODE_SRC", "input_specs", "make_batch"]

CACHE_PAD = 128          # decode batches: room after the prefilled cache
ENCDEC_DECODE_SRC = 4096  # encoder memory length for enc-dec decode batches


def _real_cache(cfg: ModelConfig, B: int, S: int, device=None):
    """A zero cache of a model of ``cfg`` with S positions counted as
    filled (on ``meta``: its shapes and dtypes)."""
    model = build(cfg)
    if cfg.family == "encdec":
        cache = model.init_cache(B, S + CACHE_PAD, min(S, ENCDEC_DECODE_SRC),
                                 device=device)
    elif cfg.family == "ssm":
        cache = model.init_cache(B, device=device)
    else:
        cache = model.init_cache(B, S + CACHE_PAD, device=device)
    cache["len"] = S
    return cache


def _meta_batch(cfg: ModelConfig, B: int, S: int) -> Dict:
    """A train / prefill batch of B rows of S positions on ``meta``."""
    meta = lambda shape, dtype=torch.int32: torch.empty(shape, dtype=dtype,
                                                        device="meta")
    batch = {"tokens": meta((B, S)), "labels": meta((B, S))}
    if cfg.mrope:
        batch["positions"] = meta((B, S, 3))
    if cfg.family == "encdec":
        batch["enc_embeds"] = meta((B, S, cfg.d_model), torch.float32)
    return batch


def input_specs(cfg: ModelConfig, shape, mode: str | None = None):
    """One shape cell's inputs on the ``meta`` device: ``(batch,)`` for
    ``train`` / ``prefill``, ``(batch, cache)`` for ``decode`` (a cache of
    ``shape.seq_len`` filled positions, ``cache["len"]`` that length, as
    :func:`make_batch` gives it).  ``mode`` defaults to the cell's kind."""
    mode = mode or shape.kind
    B, S = shape.global_batch, shape.seq_len
    if mode in ("train", "prefill"):
        return (_meta_batch(cfg, B, S),)
    if mode == "decode":
        batch = {"token": torch.empty((B, 1), dtype=torch.int32,
                                      device="meta")}
        return batch, _real_cache(cfg, B, S, torch.device("meta"))
    raise ValueError(mode)


def make_batch(cfg: ModelConfig, B: int, S: int, mode: str = "train",
               rng: np.random.RandomState | None = None, device=None):
    """A real batch for one (family, mode): ``train`` / ``prefill`` give a
    dict, ``decode`` gives (batch, cache)."""
    rng = rng or np.random.RandomState(0)
    dev = resolve_device(device)
    i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                    device=dev)
    if mode in ("train", "prefill"):
        batch: Dict = {
            "tokens": i32(rng.randint(0, cfg.vocab_size, (B, S))),
            "labels": i32(rng.randint(0, cfg.vocab_size, (B, S))),
        }
        if cfg.mrope:
            batch["positions"] = torch.arange(
                S, dtype=torch.int32, device=dev)[None, :, None] \
                .expand(B, S, 3)
        if cfg.family == "encdec":
            batch["enc_embeds"] = torch.as_tensor(
                rng.randn(B, S, cfg.d_model) * 0.05, dtype=torch.float32,
                device=dev)
        return batch
    if mode == "decode":
        batch = {"token": i32(rng.randint(0, cfg.vocab_size, (B, 1)))}
        return batch, _real_cache(cfg, B, S, dev)
    raise ValueError(mode)
