"""Deterministic, checkpointable synthetic token pipeline (port of
``repro.data.pipeline``).

Counter-based (Philox) generation: batch ``i`` is a pure function of
(seed, i, host_id), drawn with numpy exactly as the reference draws it, so

* restart/resume is exact: restoring ``state()`` replays from the same
  step,
* each host of a multi-host job draws a disjoint shard of the global batch
  (``host_id`` / ``host_count``) with no coordination,
* the two packages give bit-equal batches for the same arguments.

The batches are tensors on the stream's ``device`` (the CUDA device by
default).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import resolve_device
from repro_torch.models.config import ModelConfig


class TokenStream:
    def __init__(self, cfg: ModelConfig, global_batch: int, seq_len: int,
                 seed: int = 0, host_count: int = 1, host_id: int = 0,
                 device=None):
        assert global_batch % host_count == 0
        self.cfg = cfg
        self.global_batch = global_batch
        self.local_batch = global_batch // host_count
        self.seq_len = seq_len
        self.seed = seed
        self.host_count = host_count
        self.host_id = host_id
        self.device = resolve_device(device)
        self.step = 0

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(np.random.Philox(
            key=self.seed, counter=step * self.host_count + self.host_id))

    def next(self) -> Dict[str, torch.Tensor]:
        rng = self._rng(self.step)
        self.step += 1
        B, S = self.local_batch, self.seq_len
        # structured synthetic text: a noisy integer-sequence language so
        # the model has something learnable (next token ~ current + delta)
        V = self.cfg.vocab_size
        start = rng.integers(0, V, (B, 1))
        delta = rng.integers(1, 7, (B, 1))
        base = (start + delta * np.arange(S + 1)[None, :]) % V
        noise = rng.integers(0, V, (B, S + 1))
        mask = rng.random((B, S + 1)) < 0.05
        seq = np.where(mask, noise, base).astype(np.int32)
        to = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                       device=self.device)
        batch = {"tokens": to(seq[:, :-1]), "labels": to(seq[:, 1:])}
        if self.cfg.mrope:
            pos = np.broadcast_to(np.arange(S)[None, :, None], (B, S, 3))
            batch["positions"] = to(pos.astype(np.int32))
        if self.cfg.family == "encdec":
            emb = rng.standard_normal((B, S, self.cfg.d_model)) * 0.05
            batch["enc_embeds"] = to(emb.astype(np.float32))
        return batch

    # ---- checkpointable cursor -------------------------------------------
    def state(self) -> Dict:
        return {"step": self.step, "seed": self.seed,
                "host_id": self.host_id, "host_count": self.host_count}

    def restore(self, state: Dict) -> None:
        assert state["seed"] == self.seed
        self.step = int(state["step"])
