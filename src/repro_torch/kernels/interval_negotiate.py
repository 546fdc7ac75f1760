"""potential_matrix: the wave's anti-dependency candidate matrix.

Port of ``repro.kernels.interval_negotiate.potential_matrix_pallas``:
``potential[i, j] = 1`` iff some read key of txn i equals some write key of
txn j (key >= 0, i != j) — the paper's CV rule 6 / PostSI rule 4 input.
The CUDA kernel (``csrc/interval_negotiate.cu``) tiles the [T, T] output
in 32 x 32 blocks with both key sets staged in shared memory; its plain
version (``potential_matrix_ref``) sits beside it and serves CPU tensors.
"""
from __future__ import annotations

import torch

from .build import check_input, launch, stream_of
from .ref import potential_matrix_ref

__all__ = ["potential_matrix", "potential_matrix_cuda",
           "potential_matrix_ref"]


def potential_matrix_cuda(read_key, write_key):
    """CUDA kernel.  read_key/write_key: [T, O] int32 (-1 = inactive op).
    Returns potential [T, T] int8."""
    T, O = read_key.shape
    check_input("potential_matrix.read_key", read_key, (T, O), torch.int32)
    check_input("potential_matrix.write_key", write_key, (T, O), torch.int32)
    pot = torch.empty((T, T), dtype=torch.int8, device=read_key.device)
    if T:
        launch("potential_matrix", "potential_matrix_launch",
               read_key.data_ptr(), write_key.data_ptr(), pot.data_ptr(), T,
               O, stream_of(read_key))
    return pot


def potential_matrix(read_key, write_key):
    """The wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if read_key.is_cuda:
        return potential_matrix_cuda(read_key, write_key)
    return potential_matrix_ref(read_key, write_key)
