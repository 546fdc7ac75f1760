"""flash_attention: causal or full attention with an online softmax.

Port of ``repro.kernels.flash_attention.flash_attention_pallas``.  The CUDA
kernels (``csrc/flash_attention.cu``: bf16 on the tensor cores, float32 on
the FMA units, chosen by dtype) take the model's own layout, q
``[B, Sq, H, D]`` and k/v ``[B, Sk, KH, D]``, and reads the kv head of each
query head by index, so neither the reference wrapper's GQA repeat nor its
128-lane padding of D exists here; the scale is 1/sqrt(D).  Sequence lengths
need not be multiples of the tile: the kernel masks the tail.  Its plain
version (:func:`flash_attention_plain`, the port of the reference's
``layers._dense_attention``) sits beside it and serves CPU tensors and the
``torch`` route.
"""
from __future__ import annotations

import math

import torch

from .build import check_input, launch, stream_of

__all__ = ["NEG_INF", "flash_attention",
           "flash_attention_cuda", "flash_attention_plain"]

NEG_INF = -1.0e30
_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_plain(q, k, v, causal: bool = True):
    """Dense softmax attention, GQA by reshape.  q: [B,Sq,H,D]; k, v:
    [B,Sk,KH,D]; the causal mask aligns query i with key i, as the kernel
    does.  Scores and softmax in float32, the probabilities cast to v's
    dtype for the second product, as in the reference."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, KH, H // KH, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    if causal:
        qpos = torch.arange(Sq, device=q.device)
        kpos = torch.arange(Sk, device=q.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v)
    return o.reshape(B, Sq, H, D)


def flash_attention_cuda(q, k, v, causal: bool = True):
    """CUDA kernel.  q: [B, Sq, H, D]; k, v: [B, Sk, KH, D]; contiguous, one
    dtype (bfloat16: the tensor-core kernel, 16-byte aligned; float32: the
    FMA kernel); D a multiple of 16 up to 128; H a multiple of KH.  Returns
    o [B, Sq, H, D] in q's dtype."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    check_input("flash_attention.q", q, (B, Sq, H, D), _DTYPES)
    check_input("flash_attention.k", k, (B, Sk, KH, D), q.dtype)
    check_input("flash_attention.v", v, (B, Sk, KH, D), q.dtype)
    if D % 16 or not 16 <= D <= 128:
        raise ValueError(f"flash_attention: head dim {D} is not a multiple "
                         f"of 16 in [16, 128]")
    if H % KH:
        raise ValueError(f"flash_attention: {H} query heads do not group "
                         f"over {KH} kv heads")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: bf16 tensors must be 16-byte "
                         "aligned (the kernel copies 16-byte rows)")
    o = torch.empty_like(q)
    if B and Sq and Sk and H:
        launch("flash_attention", "flash_attention_launch", q.data_ptr(),
               k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq, Sk, H, KH, D,
               int(bool(causal)), int(bf16), 1.0 / math.sqrt(D),
               stream_of(q))
    return o


def flash_attention(q, k, v, causal: bool = True):
    """The wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors (the kernel has no CPU form)."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal)
    return flash_attention_plain(q, k, v, causal)
