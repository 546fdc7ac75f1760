"""int8 gradient compression with error feedback (port of
``repro.optim.compress``).

``compress_int8`` / ``decompress_int8`` quantize one tensor to int8 with a
per-tensor scale.  ``compressed_psum`` is the reference's quantized
all-reduce over a mesh axis, in two forms.  Over a ``torch.distributed``
group (``group=``) each rank holds its own shard and the collectives are
the reference's: ``all_reduce(MAX)`` of the largest |x| (its ``pmax``),
``all_reduce(SUM)`` of the int8 tensors in int32 (its ``psum``).  Without
one the axis is emulated on one device, as the node mesh emulates the
reference's ``("node",)`` mesh: the n shards are the leading dimension of
one stacked ``[n, ...]`` tensor, and the collectives are reductions over
it.  Both give the same bits.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist


def compress_int8(x: torch.Tensor, residual: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q int8, scale, new residual).  Error feedback: x' = x + residual."""
    xf = x.float()
    if residual is not None:
        xf = xf + residual
    scale = xf.abs().max().clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale, xf - q.float() * scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(x: torch.Tensor, residual: Optional[torch.Tensor] = None,
                    group=None):
    """Quantized all-reduce.  With ``group`` (a ``torch.distributed``
    group; a collective, every rank calls it) ``x`` is this rank's tensor
    (``residual`` likewise): it quantizes to int8 with the scale taken from
    the largest |x| over the ranks (``all_reduce(MAX)``, the reference's
    ``pmax``) and the int8 tensors are summed in int32
    (``all_reduce(SUM)``, its ``psum``).  Returns (the dequantized total,
    float32 shaped like ``x``; this rank's quantization error).

    Without ``group`` the axis is emulated: x [n, ...] holds shard i's
    tensor at x[i], and the total comes back broadcast over the n shards
    ([n, ...] float32) beside each shard's error ([n, ...])."""
    xf = x.float()
    if residual is not None:
        xf = xf + residual
    if group is None:
        amax = xf.reshape(xf.shape[0], -1).abs().amax(dim=1).clamp_min(1e-12)
        scale = amax.max() / 127.0
    else:
        amax = xf.abs().max().clamp_min(1e-12).reshape(1)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = amax[0] / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    err = xf - q.float() * scale
    if group is None:
        total = q.to(torch.int32).sum(dim=0)
        return (total.float() * scale).expand_as(xf), err
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.float() * scale, err
