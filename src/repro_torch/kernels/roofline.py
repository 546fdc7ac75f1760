"""The H100's peak rates: the denominators of every bound and roofline of
the port.

NVIDIA's data sheet for the H100 SXM (dense rates, at the full 700 W power
limit): HBM at 3.35 TB/s and 80 GB, 989 TFLOP/s in bf16 on the tensor
cores, 67 TFLOP/s in float32 outside them (taken too for the engine
kernels' 32-bit integer compares).  A kernel's cost (``*_cost`` in each
kernel module) is counted in operations at the rate of its operands'
dtype (:func:`ops_rate`); :func:`bound` turns (bytes, operations) into
the least time the card could take.
"""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9
ALU_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

_TENSOR_CORE_DTYPES = (torch.bfloat16, torch.float16)


def ops_rate(dtype) -> float:
    """Operations a second for products in ``dtype``: the tensor cores'
    rate for bf16 and fp16, the float32 rate for every other dtype."""
    return BF16_FLOPS_PER_S if dtype in _TENSOR_CORE_DTYPES else ALU_OPS_PER_S


def bound(n_bytes: float, n_ops: float, ops_per_s: float = ALU_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over ``ops_per_s``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
