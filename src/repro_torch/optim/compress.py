"""int8 gradient compression with error feedback (port of
``repro.optim.compress``).

``compress_int8`` / ``decompress_int8`` quantize one tensor to int8 with a
per-tensor scale.  ``compressed_psum`` is the reference's quantized
all-reduce over a mesh axis, run over the port's emulated axis: as the
node mesh emulates the reference's ``("node",)`` mesh on one device, the n
shards of the axis are the leading dimension of one stacked ``[n, ...]``
tensor, and the collectives (``pmax``, ``psum``) are reductions over it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


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


def compressed_psum(x: torch.Tensor, residual: Optional[torch.Tensor] = None):
    """Quantized all-reduce over the emulated axis: x [n, ...] holds shard
    i's tensor at x[i] (``residual`` likewise).  Every shard quantizes to
    int8 with the scale taken from the largest |x| over all shards (the
    reference's ``pmax``), the int8 tensors are summed in int32 (its
    ``psum``).  Returns (the dequantized total broadcast back over the n
    shards, [n, ...] float32; each shard's quantization error, [n, ...])."""
    xf = x.float()
    if residual is not None:
        xf = xf + residual
    amax = xf.reshape(xf.shape[0], -1).abs().amax(dim=1).clamp_min(1e-12)
    scale = amax.max() / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    err = xf - q.float() * scale
    total = q.to(torch.int32).sum(dim=0)
    return (total.float() * scale).expand_as(xf), err
