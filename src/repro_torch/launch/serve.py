"""Batched serving with PostSI-versioned live weight publishing.

Port of ``repro.launch.serve``.  Requests are grouped into fixed-size
batches, prefilled once and decoded step by step.  Weight versions are
parameter trees on the device; which version a batch uses is decided in a
PostSI store (``core.seq.SeqScheduler``, one key per parameter leaf): every
batch is a reader transaction, every publish a writer transaction, and
Consistent Visibility guarantees a batch never mixes two weight versions
(torn weights), with no version counter or lock.

Differences from the reference, none of them visible in what a batch
returns: the steps run eagerly (no jit, no buffer donation); the KV cache
is written in place into a buffer of ``S + cache_margin`` positions that
prefill allocates, instead of concatenating zeros after it; the generated
ids are gathered on the device and copied to the host once per batch.
Under ``mrope`` (vision-language) a batch carries the ``[B, S, 3]`` text
positions of the reference (0 ... S-1 in each section), made on the
server's device; an ``encdec`` batch carries the encoder's frame
embeddings (``enc_embeds`` [B, S_src, d_model], float32) on the server's
device.  An ``ssm`` model has no KV cache: prefill takes ``max_len`` and
ignores it, as the reference pads only the k/v it finds in the cache.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.seq import SeqScheduler
from repro_torch.kernels import resolve, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import build
from repro_torch.models.module import tree_leaves

from .train import greedy_decode


def prompt_batch(cfg: ModelConfig, tokens: torch.Tensor,
                 enc_embeds=None) -> Dict:
    """The prefill batch of a [B, S] prompt tensor: the tokens; under
    ``mrope`` their text positions ([B, S, 3], 0 ... S-1 in each of the
    three sections), made on the tokens' device; for ``encdec`` the
    encoder's frame embeddings ``enc_embeds`` ([B, S_src, d_model], any
    array), as float32 on the tokens' device."""
    batch = {"tokens": tokens}
    if cfg.mrope:
        B, S = tokens.shape
        batch["positions"] = torch.arange(
            S, dtype=torch.int32, device=tokens.device)[None, :, None] \
            .expand(B, S, 3)
    if cfg.family == "encdec":
        if enc_embeds is None:
            raise ValueError(f"{cfg.name} (encdec) needs enc_embeds "
                             f"[B, S_src, {cfg.d_model}]")
        batch["enc_embeds"] = torch.as_tensor(
            enc_embeds, dtype=torch.float32, device=tokens.device)
    return batch


@dataclasses.dataclass
class ServeStats:
    batches: int = 0
    tokens: int = 0
    publishes: int = 0
    versions_served: List[int] = dataclasses.field(default_factory=list)


class Server:
    def __init__(self, cfg: ModelConfig, params, batch_size: int = 4,
                 cache_margin: int = 128, kernels=None, device=None):
        self.cfg = cfg
        self.batch_size = batch_size
        self.cache_margin = cache_margin
        self.device = resolve_device(device)
        self.kernels = resolve(kernels, self.device)
        self.model = build(cfg, self.kernels)
        self.prefill = self.model.prefill
        self.decode = functools.partial(greedy_decode, self.model)
        # versioned weight store: one key per leaf
        self._versions = [params]
        n_leaves = len(tree_leaves(params))
        self._sched = SeqScheduler(n_leaves, mode="postsi")
        self._n_leaves = n_leaves
        t = self._sched.begin()
        for k in range(n_leaves):
            self._sched.write(t, k, 0)
        if not self._sched.commit(t):
            raise RuntimeError("the initial weight version did not commit")
        self.stats = ServeStats()

    # ------------------------------------------------------------- weights
    def publish(self, params) -> bool:
        """Writer transaction: install a new weight version atomically."""
        self._versions.append(params)
        vid = len(self._versions) - 1
        t = self._sched.begin()
        for k in range(self._n_leaves):
            self._sched.write(t, k, vid)
        ok = self._sched.commit(t)
        if ok:
            self.stats.publishes += 1
        return ok

    def _snapshot(self):
        """Reader transaction: an atomic weight version for one batch."""
        t = self._sched.begin()
        vids = {self._sched.read(t, k) for k in range(self._n_leaves)}
        if not self._sched.commit(t):
            raise AssertionError("a weight snapshot failed to commit")
        if len(vids) != 1:
            raise AssertionError(f"torn weight versions: {vids}")
        vid = vids.pop()
        return vid, self._versions[vid]

    # ------------------------------------------------------------- serving
    def serve_batch(self, tokens: np.ndarray, max_new_tokens: int = 8,
                    enc_embeds: Optional[np.ndarray] = None) -> Dict:
        """tokens: [B, S] int32 prompt batch (and, for ``encdec``,
        enc_embeds [B, S_src, d_model]) -> dict with generated ids."""
        B, S = tokens.shape
        if B != self.batch_size:
            raise ValueError(f"batch of {B} prompts, the server takes "
                             f"{self.batch_size}")
        vid, params = self._snapshot()
        batch = prompt_batch(self.cfg, torch.as_tensor(
            np.asarray(tokens), dtype=torch.int32, device=self.device),
            enc_embeds)
        # the cache has room for the new tokens
        logits, cache = self.prefill(params, batch,
                                     max_len=S + self.cache_margin)
        tok = logits[..., : self.cfg.vocab_size].argmax(dim=-1).int()
        out = [tok]
        for _ in range(max_new_tokens - 1):
            tok, cache = self.decode(params, cache, {"token": tok})
            out.append(tok)
        gen = torch.cat(out, dim=1).cpu().numpy()
        self.stats.batches += 1
        self.stats.tokens += int(gen.size)
        self.stats.versions_served.append(vid)
        return {"generated": gen, "weight_version": vid}
