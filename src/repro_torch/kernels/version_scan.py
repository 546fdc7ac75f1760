"""version_scan: newest visible version per read request (paper §IV-B).

Port of ``repro.kernels.version_scan.version_scan_pallas``.  The CUDA
kernel (``csrc/version_scan.cu``) gathers each request's ring row straight
from the store tables by clipped key, so no ``[M, V]`` pre-gather and no
128-lane padding exist.  Each request takes a group of V lanes (V rounded
up to a power of two, at most 32, fixed at compile time): one round of
loads for the key and the ceiling, one for the ring's slots, and xor
shuffles over the group pick the first slot holding the newest visible
CID.  The C entry sizes the grid from M and V.  Its plain version
(``version_scan_ref``) sits beside it and serves CPU tensors.
"""
from __future__ import annotations

import torch

from .build import check_input, launch, stream_of
from .ref import version_scan_ref

__all__ = ["version_scan", "version_scan_cuda", "version_scan_plain",
           "version_scan_ref"]


def version_scan_plain(cids, tids, max_cid, keys=None):
    """Plain PyTorch version of :func:`version_scan_cuda` (same
    arguments): clip, gather the ring rows, scan.  ``keys=None`` takes
    pre-gathered rings (request m on row m), the reference's own form."""
    if keys is not None:
        k = keys.clamp(0, cids.shape[0] - 1).long()
        cids, tids = cids[k], tids[k]
    return version_scan_ref(cids, tids, max_cid)


def version_scan_cuda(cids, tids, max_cid, keys):
    """CUDA kernel.  cids/tids: [N, V] int32 store tables; keys: [M] int32
    rows (clipped into [0, N) in-kernel); max_cid: [M] int32.  Returns
    (slot [M], best [M]) int32."""
    N, V = cids.shape
    M = max_cid.shape[0]
    check_input("version_scan.cids", cids, (N, V), torch.int32)
    check_input("version_scan.tids", tids, (N, V), torch.int32)
    check_input("version_scan.max_cid", max_cid, (M,), torch.int32)
    check_input("version_scan.keys", keys, (M,), torch.int32)
    slot = torch.empty(M, dtype=torch.int32, device=cids.device)
    best = torch.empty(M, dtype=torch.int32, device=cids.device)
    if M:
        launch("version_scan", "version_scan_launch", cids.data_ptr(),
               tids.data_ptr(), keys.data_ptr(),
               max_cid.data_ptr(), slot.data_ptr(), best.data_ptr(), M, V, N,
               stream_of(cids))
    return slot, best


def version_scan(cids, tids, max_cid, keys=None):
    """The wrapper: the CUDA kernel for CUDA tensors (which needs ``keys``),
    the plain version for CPU tensors (the kernel has no CPU form)."""
    if cids.is_cuda:
        return version_scan_cuda(cids, tids, max_cid, keys)
    return version_scan_plain(cids, tids, max_cid, keys)
