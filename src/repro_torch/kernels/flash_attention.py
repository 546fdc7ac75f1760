"""flash_attention: causal or full attention with an online softmax.

Port of ``repro.kernels.flash_attention.flash_attention_pallas``.  The CUDA
kernels (``csrc/flash_attention.cu``: bf16 at D = 64, 80 and 128 on
Hopper's wgmma fed by TMA, bf16 at the other head dims on ``mma.sync``,
float32 on the FMA units, chosen by dtype and head dim) take the model's
own layout, q
``[B, Sq, H, D]`` and k/v ``[B, Sk, KH, D]``, and reads the kv head of each
query head by index, so neither the reference wrapper's GQA repeat nor its
128-lane padding of D exists here; the scale is 1/sqrt(D).  Sequence lengths
need not be multiples of the tile: the kernel masks the tail.  Its plain
version (:func:`flash_attention_plain`, the port of the reference's
``layers._dense_attention``) sits beside it and serves CPU tensors and the
``torch`` route.

The gradient: the forward kernels also write, on request, the float32
log-sum-exp of each row's scaled scores (``lse [B, H, Sq]``), and two
backward kernels (``flash_attention_bwd_dq`` / ``_dkdv`` in the same
source) compute dq, dk and dv from q, k, v, o, lse and do with
FlashAttention-2's formulas.  The reference has no such kernel: it takes
this gradient by XLA's autodiff of its plain attention.
:class:`FlashAttentionFn` binds the two to autograd;
:func:`flash_attention_bwd_plain` writes the same formulas out in plain
PyTorch (not by autograd) as their oracle.
"""
from __future__ import annotations

import math

import torch

from .build import check_input, launch, stream_of

__all__ = ["NEG_INF", "FlashAttentionFn", "flash_attention",
           "flash_attention_bwd", "flash_attention_bwd_cuda",
           "flash_attention_bwd_dkdv_cuda", "flash_attention_bwd_dq_cuda",
           "flash_attention_bwd_plain", "flash_attention_cuda",
           "flash_attention_fwd", "flash_attention_plain"]

NEG_INF = -1.0e30
_DTYPES = (torch.float32, torch.bfloat16)


def _scores(q, k, causal):
    """float32 scaled scores [B, KH, G, Sq, Sk] of q [B,Sq,H,D] against k
    [B,Sk,KH,D], the causal mask (query i aligned with key i) at NEG_INF."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KH, H // KH, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) \
        * (1.0 / math.sqrt(D))
    if causal:
        qpos = torch.arange(Sq, device=q.device)
        kpos = torch.arange(Sk, device=q.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
    return s


def flash_attention_plain(q, k, v, causal: bool = True,
                          with_lse: bool = False):
    """Dense softmax attention, GQA by reshape.  q: [B,Sq,H,D]; k, v:
    [B,Sk,KH,D]; the causal mask aligns query i with key i, as the kernel
    does.  Scores and softmax in float32, the probabilities cast to v's
    dtype for the second product, as in the reference.  ``with_lse``:
    also the float32 log-sum-exp of each row's scores, [B, H, Sq]."""
    B, Sq, H, D = q.shape
    s = _scores(q, k, causal)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v).reshape(B, Sq, H, D)
    if not with_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(B, H, Sq)


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = True):
    """The backward kernels' formulas in plain PyTorch, all in float32:
    p = exp(s - lse), delta = rowsum(do * o), dp = do v^T,
    ds = p * (dp - delta), dq = scale ds k, dk = scale ds^T q (summed over
    the G query heads of a kv head), dv = p^T do.  Returns (dq, dk, dv) in
    the inputs' dtype."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    s = _scores(q, k, causal)                                # [B,KH,G,Sq,Sk]
    p = torch.exp(s - lse.float().reshape(B, KH, G, Sq, 1))
    dog = do.float().reshape(B, Sq, KH, G, D)
    delta = (dog * o.float().reshape(B, Sq, KH, G, D)).sum(-1)  # [B,Sq,KH,G]
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds,
                      q.float().reshape(B, Sq, KH, G, D)) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check_qkv(name, q, k, v):
    """The kernels' common input checks; returns (B, Sq, Sk, H, KH, D)."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    check_input(f"{name}.q", q, (B, Sq, H, D), _DTYPES)
    check_input(f"{name}.k", k, (B, Sk, KH, D), q.dtype)
    check_input(f"{name}.v", v, (B, Sk, KH, D), q.dtype)
    if D % 16 or not 16 <= D <= 128:
        raise ValueError(f"{name}: head dim {D} is not a multiple "
                         f"of 16 in [16, 128]")
    if H % KH:
        raise ValueError(f"{name}: {H} query heads do not group "
                         f"over {KH} kv heads")
    return B, Sq, Sk, H, KH, D


def flash_attention_cuda(q, k, v, causal: bool = True,
                         with_lse: bool = False):
    """CUDA kernel.  q: [B, Sq, H, D]; k, v: [B, Sk, KH, D]; contiguous, one
    dtype (bfloat16: the tensor-core kernels, 16-byte aligned; float32: the
    FMA kernel); D a multiple of 16 up to 128; H a multiple of KH.  Returns
    o [B, Sq, H, D] in q's dtype, and with ``with_lse`` also the float32
    lse [B, H, Sq] the backward reads.

    In bf16 at D = 64, 80 and 128 the Hopper kernel reads q, k, v and
    writes o through TMA tensor maps, which need a 16-byte aligned base and
    every stride a multiple of 16 bytes: contiguity and the alignment check
    below give both, since D is a multiple of 16 (a row of one head is
    2 D bytes, 160 at D = 80, and the head, sequence and batch strides are
    multiples of it)."""
    B, Sq, Sk, H, KH, D = _check_qkv("flash_attention", q, k, v)
    bf16 = q.dtype == torch.bfloat16
    if bf16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: bf16 tensors must be 16-byte "
                         "aligned (the kernel copies 16-byte rows)")
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if B and Sq and Sk and H:
        launch("flash_attention", "flash_attention_launch", q.data_ptr(),
               k.data_ptr(), v.data_ptr(), o.data_ptr(),
               None if lse is None else lse.data_ptr(), B, Sq, Sk, H, KH, D,
               int(bool(causal)), int(bf16), 1.0 / math.sqrt(D),
               stream_of(q))
    return (o, lse) if with_lse else o


def _check_bwd(q, k, v, o, do, lse):
    B, Sq, Sk, H, KH, D = _check_qkv("flash_attention_bwd", q, k, v)
    check_input("flash_attention_bwd.do", do, (B, Sq, H, D), q.dtype)
    check_input("flash_attention_bwd.lse", lse, (B, H, Sq), torch.float32)
    if o is not None:
        check_input("flash_attention_bwd.o", o, (B, Sq, H, D), q.dtype)
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in (q, k, v, o, do) if t is not None):
        raise ValueError("flash_attention_bwd: bf16 tensors must be 16-byte "
                         "aligned (the kernels copy 16-byte rows)")
    return B, Sq, Sk, H, KH, D


def _bwd_args(q, causal):
    return (int(bool(causal)), int(q.dtype == torch.bfloat16),
            1.0 / math.sqrt(q.shape[-1]), stream_of(q))


def flash_attention_bwd_dq_cuda(q, k, v, o, lse, do, causal: bool = True):
    """The first backward kernel: (dq in q's dtype, delta = rowsum(do * o)
    [B, H, Sq] float32, which the second reads)."""
    B, Sq, Sk, H, KH, D = _check_bwd(q, k, v, o, do, lse)
    dq = torch.empty_like(q)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if not (B and Sq and Sk and H):
        return dq.zero_(), delta.zero_()
    causal_i, bf16, scale, stream = _bwd_args(q, causal)
    launch("flash_attention_bwd_dq", "flash_attention_bwd_dq_launch",
           q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
           do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
           B, Sq, Sk, H, KH, D, causal_i, bf16, scale, stream)
    return dq, delta


def flash_attention_bwd_dkdv_cuda(q, k, v, do, lse, delta,
                                  causal: bool = True):
    """The second backward kernel, after the first: (dk, dv) in k's dtype,
    the sums over each kv head's G query heads taken in one block."""
    B, Sq, Sk, H, KH, D = _check_bwd(q, k, v, None, do, lse)
    check_input("flash_attention_bwd.delta", delta, (B, H, Sq),
                torch.float32)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if not (B and Sq and Sk and H):
        return dk.zero_(), dv.zero_()
    causal_i, bf16, scale, stream = _bwd_args(q, causal)
    launch("flash_attention_bwd_dkdv", "flash_attention_bwd_dkdv_launch",
           q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
           B, Sq, Sk, H, KH, D, causal_i, bf16, scale, stream)
    return dk, dv


def flash_attention_bwd_cuda(q, k, v, o, lse, do, causal: bool = True):
    """The two backward kernels: q, o, do [B, Sq, H, D] and k, v
    [B, Sk, KH, D], contiguous, one dtype (bfloat16: the tensor-core
    kernels, 16-byte aligned; float32: the FMA kernels); lse the forward's
    float32 [B, H, Sq].  Returns (dq, dk, dv) in the inputs' dtype."""
    dq, delta = flash_attention_bwd_dq_cuda(q, k, v, o, lse, do, causal)
    return (dq, *flash_attention_bwd_dkdv_cuda(q, k, v, do, lse, delta,
                                               causal))


def flash_attention(q, k, v, causal: bool = True):
    """The wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors (the kernel has no CPU form)."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal)
    return flash_attention_plain(q, k, v, causal)


def flash_attention_fwd(q, k, v, causal: bool = True):
    """(o, lse): the forward kernel with its lse for CUDA tensors, the
    plain version for CPU tensors."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal, with_lse=True)
    return flash_attention_plain(q, k, v, causal, with_lse=True)


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True):
    """(dq, dk, dv): the backward kernels for CUDA tensors, the plain
    version for CPU tensors."""
    if q.is_cuda:
        return flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    return flash_attention_bwd_plain(q, k, v, o, lse, do, causal)


class FlashAttentionFn(torch.autograd.Function):
    """Attention with its gradient through the wrappers above: the forward
    kernel (with lse) and the two backward kernels on CUDA tensors.  It
    saves q, k, v, o and lse; nothing of size Sq x Sk."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        q, k, v = (t.contiguous() for t in (q, k, v))
        o, lse = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal)
        return dq, dk, dv, None
