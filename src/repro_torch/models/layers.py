"""Core NN layers of the port: RMSNorm, RoPE, GQA attention, SwiGLU MLP,
embedding and head.

Port of the subset of ``repro.models.layers`` that the hybrid family
(zamba2) runs.  Layouts as in the reference: activations ``[B, S, D]``,
attention tensors ``[B, S, H, Dh]``.  Matrix products run in
``compute_dtype`` (bf16 by default), softmax and statistics in float32.

Prefill attention goes through ``kernels.ops.flash_attention``: the
hand-written CUDA kernel on the ``cuda`` route, the dense plain version on
the ``torch`` route.  That takes the place of the reference's chunked XLA
attention (``_chunked_attention`` / ``_tri_chunked_attention``), which
exists to bound XLA's memory; ``ModelConfig`` refuses an ``attn_chunk``
other than its default.
Not ported: LayerNorm, M-RoPE, qk-norm, qkv-bias, MoE and the
cross-entropy loss (the dense/MoE/encoder families and training), the
``cast_grad_bf16`` boundary (training) and every ``shard_activation`` /
``fsdp_gather`` constraint (GSPMD, no mesh on one card).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, resolve
from repro_torch.kernels.flash_attention import NEG_INF

from .config import NOT_YET, ModelConfig
from .module import spec


def _mm(x, w, cd):
    """``einsum("...d,dk->...k", x, w.astype(cd))``."""
    return torch.matmul(x.to(cd), w.to(cd))


def silu(x):
    """``jax.nn.silu`` as the reference computes it, ``x * sigmoid(x)``:
    in bf16 the sigmoid is rounded before the product (``F.silu`` rounds
    once), which keeps the two frameworks' bf16 logits closer."""
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def _rope_freqs(half: int, theta: float, device=None) -> torch.Tensor:
    return theta ** (-torch.arange(half, dtype=torch.float32, device=device)
                     / half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [B, S, H, D]; positions: [B, S] int."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(half, theta, x.device)
    ang = positions.float()[..., None] * freqs                   # [B,S,half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention(q, k, v, *, causal: bool = True, kernels=None):
    """Dispatch (reference ``layers.attention``): prefill self-attention
    through ``ops.flash_attention`` on the route of ``kernels`` (a backend
    name or ``KernelConfig``, resolved against q's device).  Decode, the
    reference's ``q_offset`` / ``kv_len`` calls, goes through
    :func:`decode_attention`."""
    return ops.flash_attention(
        q, k, v, causal=causal,
        use_kernel=resolve(kernels, q.device).use_kernel)


def decode_attention(q, K, V, k_new, v_new, kv_len):
    """One-token attention against a read-only cache plus the new token.

    q: [B,1,H,D]; K/V: [B,S,KH,D] (entries >= kv_len are stale);
    k_new/v_new: [B,1,KH,D]; kv_len: [B].  Plain PyTorch on every route:
    the reference leaves decode to XLA, no Pallas kernel."""
    B, _, H, D = q.shape
    KH = K.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, KH, G, D).float()
    s_old = torch.einsum("bkgd,bskd->bkgs", qg, K.float()) * scale
    valid = (torch.arange(K.shape[1], device=K.device)[None]
             < kv_len[:, None])                                  # [B,S]
    s_old = torch.where(valid[:, None, None], s_old, NEG_INF)
    s_new = torch.einsum("bkgd,bkd->bkg", qg,
                         k_new[:, 0].float())[..., None] * scale
    p = torch.softmax(torch.cat([s_old, s_new], dim=-1), dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p[..., :-1].to(V.dtype), V)
    o = o + p[..., -1:].to(V.dtype) * v_new[:, 0][:, :, None, :]
    return o.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# attention block (params + forward)
# ---------------------------------------------------------------------------

def _plain_attention_only(cfg: ModelConfig):
    for flag in ("qkv_bias", "qk_norm", "mrope"):
        if getattr(cfg, flag):
            raise NotImplementedError(
                f"{flag} attention is not ported to repro_torch yet "
                f"({NOT_YET})")


def attn_specs(cfg: ModelConfig, layers: Optional[int] = None):
    _plain_attention_only(cfg)
    d, hd = cfg.d_model, cfg.head_dim
    H, KH = cfg.n_heads, cfg.n_kv_heads
    dt = cfg.param_dtype
    L = (layers,) if layers else ()
    La = ("layers",) if layers else ()
    return {
        "wq": spec(L + (d, H * hd), La + ("embed", "heads"), dtype=dt),
        "wk": spec(L + (d, KH * hd), La + ("embed", "kv_heads"), dtype=dt),
        "wv": spec(L + (d, KH * hd), La + ("embed", "kv_heads"), dtype=dt),
        "wo": spec(L + (H * hd, d), La + ("heads", "embed"), dtype=dt),
    }


def attn_qkv(p, x, cfg: ModelConfig, positions=None):
    """Project to (q, k, v) with RoPE applied."""
    _plain_attention_only(cfg)
    B, S, _ = x.shape
    hd, cd = cfg.head_dim, cfg.compute_dtype
    q = _mm(x, p["wq"], cd).reshape(B, S, cfg.n_heads, hd)
    k = _mm(x, p["wk"], cd).reshape(B, S, cfg.n_kv_heads, hd)
    v = _mm(x, p["wv"], cd).reshape(B, S, cfg.n_kv_heads, hd)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(p, o, cfg: ModelConfig):
    B, S = o.shape[:2]
    o = o.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return _mm(o, p["wo"], cfg.compute_dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_specs(d: int, ff: int, layers: Optional[int] = None, dtype=None):
    dt = dtype if dtype is not None else torch.float32
    L = (layers,) if layers else ()
    La = ("layers",) if layers else ()
    return {
        "w1": spec(L + (d, ff), La + ("embed", "mlp"), dtype=dt),
        "w3": spec(L + (d, ff), La + ("embed", "mlp"), dtype=dt),
        "w2": spec(L + (ff, d), La + ("mlp", "embed"), dtype=dt),
    }


def mlp(p, x, cfg: ModelConfig):
    cd = cfg.compute_dtype
    h = silu(_mm(x, p["w1"], cd)) * _mm(x, p["w3"], cd)
    return _mm(h, p["w2"], cd)


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed_specs(cfg: ModelConfig):
    dt = cfg.param_dtype
    p = {"tok": spec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
                     dtype=dt, scale=0.02)}
    if not cfg.tie_embeddings:
        p["head"] = spec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
                         dtype=dt)
    return p


def embed(p, tokens, cfg: ModelConfig):
    """Rows of the table, cast after the gather (the same values as the
    reference's cast-then-gather, without casting the whole table)."""
    return p["tok"][tokens.long()].to(cfg.compute_dtype)


def unembed(p, x, cfg: ModelConfig):
    """float32 logits of ``compute_dtype`` operands (the reference's
    ``preferred_element_type=float32``): the bf16 values are exact in
    float32, so the product is taken there."""
    head = p.get("head", p["tok"])
    return torch.matmul(x.float(), head.to(cfg.compute_dtype).float().T)
