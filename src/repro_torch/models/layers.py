"""Core NN layers of the port: RMSNorm, RoPE and M-RoPE, GQA attention
(with the optional qkv bias and qk-norm), SwiGLU MLP, sort-based top-k MoE,
embedding and head.

Port of ``repro.models.layers`` for every model family.  Layouts as in the reference: activations ``[B, S, D]``,
attention tensors ``[B, S, H, Dh]``.  Matrix products run in
``compute_dtype`` (bf16 by default), softmax and statistics in float32.

Attention of a whole sequence (prefill self-attention, the encoder's,
cross-attention) goes through ``kernels.ops.flash_attention``: the
hand-written CUDA kernel on the ``cuda`` route, the dense plain version on
the ``torch`` route.  That takes the place of the reference's chunked XLA
attention (``_chunked_attention`` / ``_tri_chunked_attention``), which
exists to bound XLA's memory; ``ModelConfig`` refuses an ``attn_chunk``
other than its default.  ``layernorm`` is ported with the reference's
``layers`` API, though no model calls it (the encoder-decoder family uses
RMSNorm, as in the reference).  Training: ``cross_entropy`` (the masked
token mean over all ``padded_vocab`` columns) and ``cast_grad_bf16`` (an
autograd boundary that rounds a float32 cotangent through bf16), which,
as in the reference, no model calls.  Under a gradient, attention on the
``cuda`` route runs the hand-written backward kernels
(``kernels.flash_attention.FlashAttentionFn``); every other layer here is
differentiated by autograd.
Not ported: every ``shard_activation`` / ``fsdp_gather`` constraint
(GSPMD, no mesh on one card).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, resolve
from repro_torch.kernels.flash_attention import NEG_INF

from .config import ModelConfig
from .module import spec


class _CastGradBf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.bfloat16().to(g.dtype) if g.dtype == torch.float32 else g


def cast_grad_bf16(x):
    """Identity forward; on the way back a float32 cotangent is rounded
    through bf16 and keeps its dtype (the reference's ``_cg_bwd``, the one
    its ``defvjp`` registers).  A boundary for the unembed input, where the
    loss's float32 dlogits would otherwise flow down the residual stream in
    float32; no model calls it, as in the reference."""
    return _CastGradBf16.apply(x)


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


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5):
    """LayerNorm over the last dimension: mean and variance in float32,
    the result in x's dtype."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def _rope_freqs(half: int, theta: float, device=None) -> torch.Tensor:
    return theta ** (-torch.arange(half, dtype=torch.float32, device=device)
                     / half)


def _rotate(x: torch.Tensor, ang: torch.Tensor):
    """Rotate the two halves of x [B, S, H, D] by angles [B, S, D/2] (float32
    arithmetic, cast back to x's dtype)."""
    half = x.shape[-1] // 2
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [B, S, H, D]; positions: [B, S] int."""
    half = x.shape[-1] // 2
    freqs = _rope_freqs(half, theta, x.device)
    ang = positions.float()[..., None] * freqs                   # [B,S,half]
    return _rotate(x, ang)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections):
    """Qwen2-VL multimodal RoPE.  x: [B, S, H, D]; positions3: [B, S, 3]
    (t, h, w) ids.  The frequency slots fall into (t, h, w) sections of
    ``sections`` half-dims; each slot rotates by its section's id."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to "
                         f"half the head dim {half}")
    freqs = _rope_freqs(half, theta, x.device)
    slot = torch.arange(half, device=x.device)
    sec_id = ((slot >= sections[0]).long()
              + (slot >= sections[0] + sections[1]).long())      # [half]
    pos = positions3.float().index_select(-1, sec_id)            # [B,S,half]
    return _rotate(x, pos * freqs)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention(q, k, v, *, causal: bool = True, kernels=None):
    """Dispatch (reference ``layers.attention``): attention of q [B, Sq, H,
    D] over k/v [B, Sk, KH, D] through ``ops.flash_attention`` on the route
    of ``kernels`` (a backend name or ``KernelConfig``, resolved against q's
    device): prefill self-attention (Sq = Sk), and non-causal
    cross-attention at any Sq, one query row in decode included.  Decode
    self-attention, the reference's ``q_offset`` / ``kv_len`` calls, goes
    through :func:`decode_attention`."""
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

def attn_specs(cfg: ModelConfig, layers: Optional[int] = None):
    d, hd = cfg.d_model, cfg.head_dim
    H, KH = cfg.n_heads, cfg.n_kv_heads
    dt = cfg.param_dtype
    L = (layers,) if layers else ()
    La = ("layers",) if layers else ()
    p = {
        "wq": spec(L + (d, H * hd), La + ("embed", "heads"), dtype=dt),
        "wk": spec(L + (d, KH * hd), La + ("embed", "kv_heads"), dtype=dt),
        "wv": spec(L + (d, KH * hd), La + ("embed", "kv_heads"), dtype=dt),
        "wo": spec(L + (H * hd, d), La + ("heads", "embed"), dtype=dt),
    }
    if cfg.qkv_bias:
        p["bq"] = spec(L + (H * hd,), La + ("heads",), dtype=dt, init="zeros")
        p["bk"] = spec(L + (KH * hd,), La + ("kv_heads",), dtype=dt,
                       init="zeros")
        p["bv"] = spec(L + (KH * hd,), La + ("kv_heads",), dtype=dt,
                       init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = spec(L + (hd,), La + ("head_dim",), dtype=dt,
                           init="ones")
        p["k_norm"] = spec(L + (hd,), La + ("head_dim",), dtype=dt,
                           init="ones")
    return p


def attn_qkv(p, x, cfg: ModelConfig, positions=None):
    """Project to (q, k, v) with the qkv bias, qk-norm and RoPE / M-RoPE
    applied, in the reference's order: the bias added in ``compute_dtype``
    after each product, the per-head RMSNorm before the rotation.
    ``positions``: [B, S] ids, or [B, S, 3] under ``mrope``."""
    B, S, _ = x.shape
    hd, cd = cfg.head_dim, cfg.compute_dtype
    xq, xk, xv = (_mm(x, p[w], cd) for w in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        xq = xq + p["bq"].to(cd)
        xk = xk + p["bk"].to(cd)
        xv = xv + p["bv"].to(cd)
    q = xq.reshape(B, S, cfg.n_heads, hd)
    k = xk.reshape(B, S, cfg.n_kv_heads, hd)
    v = xv.reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if positions is not None:
        if cfg.mrope:
            q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
            k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        else:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(p, o, cfg: ModelConfig):
    B, S = o.shape[:2]
    o = o.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return _mm(o, p["wo"], cfg.compute_dtype)


# ---------------------------------------------------------------------------
# MLP / MoE
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


def moe_specs(cfg: ModelConfig, layers: Optional[int] = None):
    d, fe, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    L = (layers,) if layers else ()
    La = ("layers",) if layers else ()
    dt = cfg.param_dtype
    p = {
        "router": spec(L + (d, E), La + ("embed", None), dtype=dt,
                       scale=1.0 / math.sqrt(d)),
        "we1": spec(L + (E, d, fe), La + ("experts", "embed", "expert_mlp"),
                    dtype=dt),
        "we3": spec(L + (E, d, fe), La + ("experts", "embed", "expert_mlp"),
                    dtype=dt),
        "we2": spec(L + (E, fe, d), La + ("experts", "expert_mlp", "embed"),
                    dtype=dt),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_specs(d, cfg.n_shared_experts * fe, layers,
                                dtype=dt)
    return p


def moe_capacity(T: int, cfg: ModelConfig) -> int:
    """The reference's static expert capacity for T routed (token, choice)
    pairs a row: ``max(4, round_up(ceil(T / E * capacity_factor), 4))``."""
    C = int(math.ceil(T / cfg.n_experts * cfg.capacity_factor))
    return max(4, ((C + 3) // 4) * 4)


def moe_ffn(p, x, cfg: ModelConfig):
    """Token-choice top-k MoE with per-batch-row sort-based dispatch (the
    reference's ``moe_ffn``).  Each expert takes at most ``moe_capacity``
    pairs a row, in token order; the overflow is dropped through a scratch
    row past the ``E * C`` rows of the dispatch buffer, so every shape is
    static and nothing here waits on the device.  The expert products are
    plain batched matrix products, as in the reference.  Returns
    ``(out [B, S, D] in x's dtype, aux)``, ``aux`` the Switch-style load
    balance loss."""
    B, S, D = x.shape
    cd = cfg.compute_dtype
    E, K = cfg.n_experts, cfg.top_k
    T = S * K                                                    # per row
    dev = x.device

    logits = torch.matmul(x.float(), p["router"].float())        # [B,S,E]
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, K, dim=-1)                    # [B,S,K]
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balance aux loss (Switch-style), per row then averaged
    me = probs.mean(dim=1)                                       # [B,E]
    flat_e = topi.reshape(B, T)
    hot = torch.zeros((B, E), dtype=torch.float32, device=dev).scatter_add_(
        1, flat_e, torch.ones((B, T), dtype=torch.float32, device=dev)) / T
    aux = (E * (me * hot).sum(dim=-1)).mean()

    C = moe_capacity(T, cfg)
    order = torch.argsort(flat_e, dim=-1, stable=True)           # [B,T]
    sorted_e = torch.gather(flat_e, 1, order)
    rank = (torch.arange(T, device=dev)[None, :]
            - torch.searchsorted(sorted_e, sorted_e, side="left"))
    keep = rank < C
    dest = torch.where(keep, sorted_e * C + rank, E * C)        # E*C: drop
    src_tok = order // K                                         # [B,T]

    xs = torch.gather(x.to(cd), 1, src_tok[..., None].expand(B, T, D))
    buf = torch.zeros((B, E * C + 1, D), dtype=cd, device=dev)
    buf.scatter_(1, dest[..., None].expand(B, T, D), xs)
    buf = buf[:, :E * C].reshape(B, E, C, D)

    h = silu(torch.einsum("becd,edf->becf", buf, p["we1"].to(cd))) \
        * torch.einsum("becd,edf->becf", buf, p["we3"].to(cd))
    y = torch.einsum("becf,efd->becd", h, p["we2"].to(cd)).reshape(
        B, E * C, D)

    safe = dest.clamp_max(E * C - 1)
    contrib = torch.where(keep[..., None],
                          torch.gather(y, 1, safe[..., None].expand(B, T, D)),
                          0).float()
    w = torch.gather(topv.reshape(B, T), 1, order)
    out = torch.zeros((B, S, D), dtype=torch.float32, device=dev)
    out.scatter_add_(1, src_tok[..., None].expand(B, T, D),
                     contrib * w[..., None])

    if cfg.n_shared_experts:
        out = out + mlp(p["shared"], x, cfg).float()
    return out.to(x.dtype), aux


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


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int):
    """Masked token-mean cross entropy; labels < 0 are ignored.  logits:
    float32 [B, S, V] with V = ``padded_vocab``; the log-sum-exp runs over
    all V columns, as in the reference (``vocab`` is taken and unused, as
    there)."""
    mask = (labels >= 0).float()
    safe = labels.clamp_min(0).long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (lse - ll) * mask
    return nll.sum() / mask.sum().clamp_min(1.0)
