"""Real input batches for every architecture family (port of the
materialized half of ``repro.launch.inputs``).

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

Not ported here: ``input_specs``, the abstract half (shape-only stand-ins
for the dry-run tooling, ROADMAP.md queue 1, item 4).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build

__all__ = ["CACHE_PAD", "ENCDEC_DECODE_SRC", "make_batch"]

CACHE_PAD = 128          # decode batches: room after the prefilled cache
ENCDEC_DECODE_SRC = 4096  # encoder memory length for enc-dec decode batches


def _real_cache(cfg: ModelConfig, B: int, S: int, device=None):
    """A zero cache of a model of ``cfg`` with S positions counted as
    filled."""
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
