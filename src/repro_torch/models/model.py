"""Model assembly of the port: the decoder (dense, MoE, VLM) and hybrid
(zamba2) families.

Port of ``repro.models.model`` for the families this port serves:

  dense / vlm -- decoder-only transformer (GQA, RoPE or M-RoPE, optional
                 qk-norm / qkv-bias), SwiGLU MLP;
  moe         -- the same backbone with a token-choice top-k MoE FFN
                 (+ shared experts);
  hybrid      -- Zamba2-style: a Mamba2 backbone with one *shared-weight*
                 attention+MLP block applied before every group of
                 ``attn_every`` layers (separate KV cache per application).

``DecoderLM`` and ``HybridModel`` expose ``param_specs`` / ``init`` /
``prefill`` / ``decode`` / ``init_cache`` as the reference does, over
parameter trees with the reference's keys and stacked ``[L, ...]`` leaves.
PyTorch runs eagerly, so the reference's ``lax.scan`` over layers is a
Python loop, and the caches are written in place: ``prefill`` into a buffer
of ``max_len`` positions (the serving margin included, instead of
concatenating zeros), ``decode`` at position ``cache["len"]`` (a Python
int), raising on a full cache where the reference clamps.  ``kernels`` (a
backend name or ``KernelConfig``, resolved against the tokens' device;
``+fused`` has no meaning here and is ignored) picks the route of
prefill's attention and SSD scan.

Not ported: ``SSMModel`` and ``EncDecModel`` (``build`` raises
``NotImplementedError`` for them), the training loss, ``remat`` (XLA
rematerialization) and the ``fsdp_gather`` / ``shard_activation``
constraints (GSPMD).
"""
from __future__ import annotations

import torch

from .config import NOT_YET, ModelConfig
from .layers import (attention, attn_out, attn_qkv, attn_specs,
                     decode_attention, embed, embed_specs, mlp, mlp_specs,
                     moe_ffn, moe_specs, rmsnorm, unembed)
from .module import materialize, spec
from .ssm import mamba2_decode_step, mamba2_forward, mamba2_specs


def default_positions(B: int, S: int, device=None):
    return torch.arange(S, device=device).expand(B, S)


def _layer(tree, l: int):
    """Slice ``l`` of every stacked ``[L, ...]`` leaf of ``tree`` (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


def _check_room(cache):
    if int(cache["len"]) >= cache["k"].shape[2]:
        raise ValueError(f"decode: the cache holds {cache['k'].shape[2]} "
                         f"positions, all filled")


class DecoderLM:
    """Decoder-only LM: ``n_layers`` blocks of attention and an MLP (or an
    MoE FFN), pre-norm, over one ``[L, ...]`` stack of layer weights."""

    def __init__(self, cfg: ModelConfig, kernels=None):
        self.cfg = cfg
        self.kernels = kernels

    def param_specs(self):
        cfg = self.cfg
        L, d = cfg.n_layers, cfg.d_model
        blocks = {
            "ln1": spec((L, d), ("layers", "embed"), dtype=cfg.param_dtype,
                        init="ones"),
            "ln2": spec((L, d), ("layers", "embed"), dtype=cfg.param_dtype,
                        init="ones"),
            "attn": attn_specs(cfg, layers=L),
        }
        if cfg.moe:
            blocks["moe"] = moe_specs(cfg, layers=L)
        else:
            blocks["mlp"] = mlp_specs(d, cfg.d_ff, layers=L,
                                      dtype=cfg.param_dtype)
        return {
            "embed": embed_specs(cfg),
            "blocks": blocks,
            "final_norm": spec((d,), ("embed",), dtype=cfg.param_dtype,
                               init="ones"),
        }

    def layer_specs(self):
        """The specs of one layer's slice of ``blocks``."""
        cfg = self.cfg
        d = cfg.d_model
        ls = {
            "ln1": spec((d,), ("embed",), dtype=cfg.param_dtype, init="ones"),
            "ln2": spec((d,), ("embed",), dtype=cfg.param_dtype, init="ones"),
            "attn": attn_specs(cfg),
        }
        if cfg.moe:
            ls["moe"] = moe_specs(cfg)
        else:
            ls["mlp"] = mlp_specs(d, cfg.d_ff)
        return ls

    def init(self, generator: torch.Generator, device=None):
        return materialize(self.param_specs(), generator, device)

    def _ffn(self, lp, h):
        cfg = self.cfg
        f_in = rmsnorm(h, lp["ln2"], cfg.norm_eps)
        if cfg.moe:
            y, _ = moe_ffn(lp["moe"], f_in, cfg)
            return h + y
        return h + mlp(lp["mlp"], f_in, cfg)

    def _positions(self, batch, B, S, device):
        if self.cfg.mrope:
            return batch["positions"]                            # [B,S,3]
        pos = batch.get("positions")
        return default_positions(B, S, device) if pos is None else pos

    def prefill(self, params, batch, max_len: int | None = None):
        """batch["tokens"]: [B, S] (and ``positions`` [B, S, 3] under
        ``mrope``) -> (logits [B, 1, V] of the last position, cache with
        k/v of ``max_len`` (default S) positions, S of them filled)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        dev = tokens.device
        positions = self._positions(batch, B, S, dev)
        cache = self.init_cache(B, max_len or S, device=dev)
        h = embed(params["embed"], tokens, cfg)
        for l in range(cfg.n_layers):
            lp = _layer(params["blocks"], l)
            a_in = rmsnorm(h, lp["ln1"], cfg.norm_eps)
            q, k, v = attn_qkv(lp["attn"], a_in, cfg, positions)
            o = attention(q, k, v, causal=True, kernels=self.kernels)
            h = self._ffn(lp, h + attn_out(lp["attn"], o, cfg))
            cache["k"][l, :, :S] = k
            cache["v"][l, :, :S] = v
        h = rmsnorm(h[:, -1:], params["final_norm"], cfg.norm_eps)
        cache["len"] = S
        return unembed(params["embed"], h, cfg), cache

    def decode(self, params, cache, batch):
        """batch["token"]: [B, 1] -> (logits [B, 1, V], cache) with the new
        position written in place and ``cache["len"]`` advanced."""
        cfg = self.cfg
        token = batch["token"]
        B = token.shape[0]
        _check_room(cache)
        pos = int(cache["len"])
        dev = token.device
        shape = (B, 1, 3) if cfg.mrope else (B, 1)
        positions = torch.full(shape, pos, dtype=torch.int32, device=dev)
        kv_len = torch.full((B,), pos, dtype=torch.int32, device=dev)
        h = embed(params["embed"], token, cfg)
        for l in range(cfg.n_layers):
            lp = _layer(params["blocks"], l)
            ck, cv = cache["k"][l], cache["v"][l]
            a_in = rmsnorm(h, lp["ln1"], cfg.norm_eps)
            q, k, v = attn_qkv(lp["attn"], a_in, cfg, positions)
            k, v = k.to(ck.dtype), v.to(cv.dtype)
            # the live prefix only: the stale tail would be masked anyway
            o = decode_attention(q, ck[:, :pos], cv[:, :pos], k, v, kv_len)
            h = self._ffn(lp, h + attn_out(lp["attn"], o, cfg))
            ck[:, pos] = k[:, 0]
            cv[:, pos] = v[:, 0]
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        cache["len"] = pos + 1
        return unembed(params["embed"], h, cfg), cache

    def init_cache(self, B: int, max_len: int, device=None):
        cfg = self.cfg
        shape = (cfg.n_layers, B, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=cfg.compute_dtype,
                                 device=device),
                "v": torch.zeros(shape, dtype=cfg.compute_dtype,
                                 device=device),
                "len": 0}


class HybridModel:
    def __init__(self, cfg: ModelConfig, kernels=None):
        assert cfg.n_layers % cfg.attn_every == 0
        self.cfg = cfg
        self.kernels = kernels
        self.n_groups = cfg.n_layers // cfg.attn_every

    def param_specs(self):
        cfg = self.cfg
        L, d = cfg.n_layers, cfg.d_model
        return {
            "embed": embed_specs(cfg),
            "mamba": {
                "ln": spec((L, d), ("layers", "embed"),
                           dtype=cfg.param_dtype, init="ones"),
                "mix": mamba2_specs(cfg, layers=L),
            },
            "shared": {
                "ln1": spec((d,), ("embed",), dtype=cfg.param_dtype,
                            init="ones"),
                "attn": attn_specs(cfg),
                "ln2": spec((d,), ("embed",), dtype=cfg.param_dtype,
                            init="ones"),
                "mlp": mlp_specs(d, cfg.d_ff, dtype=cfg.param_dtype),
            },
            "final_norm": spec((d,), ("embed",), dtype=cfg.param_dtype,
                               init="ones"),
        }

    def init(self, generator: torch.Generator, device=None):
        return materialize(self.param_specs(), generator, device)

    def _layer(self, params, l: int):
        """Layer ``l``'s slice of the stacked mamba leaves (views)."""
        return _layer(params["mamba"], l)

    def _shared_block(self, sp, h, o):
        cfg = self.cfg
        h = h + attn_out(sp["attn"], o, cfg)
        return h + mlp(sp["mlp"], rmsnorm(h, sp["ln2"], cfg.norm_eps), cfg)

    def prefill(self, params, batch, max_len: int | None = None):
        """batch["tokens"]: [B, S] -> (logits [B, 1, V] of the last position,
        cache with k/v of ``max_len`` (default S) positions, S of them
        filled)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        dev = tokens.device
        positions = default_positions(B, S, device=dev)
        cache = self.init_cache(B, max_len or S, device=dev)
        sp = params["shared"]
        h = embed(params["embed"], tokens, cfg)
        E = cfg.attn_every
        for g in range(self.n_groups):
            a_in = rmsnorm(h, sp["ln1"], cfg.norm_eps)
            q, k, v = attn_qkv(sp["attn"], a_in, cfg, positions)
            o = attention(q, k, v, causal=True, kernels=self.kernels)
            h = self._shared_block(sp, h, o)
            cache["k"][g, :, :S] = k
            cache["v"][g, :, :S] = v
            for l in range(g * E, (g + 1) * E):
                lp = self._layer(params, l)
                y, st, tail = mamba2_forward(
                    lp["mix"], rmsnorm(h, lp["ln"], cfg.norm_eps), cfg,
                    kernels=self.kernels)
                h = h + y
                cache["ssm"][l] = st
                cache["conv"][l] = tail
        h = rmsnorm(h[:, -1:], params["final_norm"], cfg.norm_eps)
        cache["len"] = S
        return unembed(params["embed"], h, cfg), cache

    def decode(self, params, cache, batch):
        """batch["token"]: [B, 1] -> (logits [B, 1, V], cache) with the new
        position written in place and ``cache["len"]`` advanced."""
        cfg = self.cfg
        token = batch["token"]
        B = token.shape[0]
        _check_room(cache)
        pos = int(cache["len"])
        dev = token.device
        positions = torch.full((B, 1), pos, dtype=torch.int32, device=dev)
        kv_len = torch.full((B,), pos, dtype=torch.int32, device=dev)
        sp = params["shared"]
        h = embed(params["embed"], token, cfg)
        E = cfg.attn_every
        for g in range(self.n_groups):
            ck, cv = cache["k"][g], cache["v"][g]
            a_in = rmsnorm(h, sp["ln1"], cfg.norm_eps)
            q, k, v = attn_qkv(sp["attn"], a_in, cfg, positions)
            k, v = k.to(ck.dtype), v.to(cv.dtype)
            # the live prefix only: the stale tail would be masked anyway
            o = decode_attention(q, ck[:, :pos], cv[:, :pos], k, v, kv_len)
            h = self._shared_block(sp, h, o)
            ck[:, pos] = k[:, 0]
            cv[:, pos] = v[:, 0]
            for l in range(g * E, (g + 1) * E):
                lp = self._layer(params, l)
                y, st, conv = mamba2_decode_step(
                    lp["mix"], rmsnorm(h, lp["ln"], cfg.norm_eps), cfg,
                    cache["ssm"][l], cache["conv"][l])
                h = h + y
                cache["ssm"][l] = st
                cache["conv"][l] = conv
        h = rmsnorm(h, params["final_norm"], cfg.norm_eps)
        cache["len"] = pos + 1
        return unembed(params["embed"], h, cfg), cache

    def init_cache(self, B: int, max_len: int, device=None):
        cfg = self.cfg
        G = self.n_groups
        convc = cfg.d_inner + 2 * cfg.d_state
        kv = (G, B, max_len, cfg.n_kv_heads, cfg.head_dim)
        z = lambda shape, dt: torch.zeros(shape, dtype=dt, device=device)
        return {
            "k": z(kv, cfg.compute_dtype),
            "v": z(kv, cfg.compute_dtype),
            "ssm": z((cfg.n_layers, B, cfg.ssm_heads, cfg.headdim,
                      cfg.d_state), torch.float32),
            "conv": z((cfg.n_layers, B, cfg.d_conv - 1, convc),
                      cfg.compute_dtype),
            "len": 0,
        }


def build(cfg: ModelConfig, kernels=None):
    if cfg.family in ("dense", "moe", "vlm"):
        return DecoderLM(cfg, kernels)
    if cfg.family == "hybrid":
        return HybridModel(cfg, kernels)
    if cfg.family in ("ssm", "encdec"):
        raise NotImplementedError(
            f"the {cfg.family!r} family is not ported to repro_torch yet "
            f"({NOT_YET})")
    raise ValueError(f"unknown family {cfg.family}")
