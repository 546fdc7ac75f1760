"""potential_matrix: the wave's anti-dependency candidate matrix.

Port of ``repro.kernels.interval_negotiate.potential_matrix_pallas``:
``potential[i, j] = 1`` iff some read key of txn i equals some write key of
txn j (key >= 0, i != j) — the paper's CV rule 6 / PostSI rule 4 input.
The CUDA kernel (``csrc/interval_negotiate.cu``) runs a 1-D grid over the
flat [T, T] output, 16 bytes a thread, each block with the writer keys of
the columns it touches staged in shared memory (:func:`geometry` sizes the
launch); its plain version (``potential_matrix_ref``) sits beside it and
serves CPU tensors.
"""
from __future__ import annotations

import torch

from .build import (SMEM_LIMIT, check_input, kernel_wrapper, launch,
                    on_card, stream_of)
from .ref import potential_matrix_ref

__all__ = ["potential_matrix", "potential_matrix_cost",
           "potential_matrix_cuda", "potential_matrix_ref", "geometry"]

THREADS = 128     # threads a block
UNIT = 16         # bytes of the flat output a thread (csrc: POT_UNIT)


def geometry(T: int, O: int, threads: int = THREADS) -> tuple[int, int]:
    """(blocks, dynamic shared memory bytes) of the potential matrix on
    blocks of ``threads``: thread f writes bytes [16 f, 16 f + 16) of the
    flat [T, T] output, and a block stages the O writer keys of each column
    its 16 x ``threads`` bytes touch, at most min(T, 16 x ``threads``) of
    them, with 4 ints of padding after every 16 columns, then the O reader
    keys of each row they touch (csrc/common.cuh: potential_part).  Raises
    where T x T exceeds the kernel's 32-bit indices or the keys do not fit
    a block's shared memory."""
    if T * T >= 2 ** 31:
        raise ValueError(f"potential_matrix: T={T} gives more than 2^31 "
                         f"bytes of output")
    units = -(-T * T // UNIT)
    blocks = -(-units // threads)
    span = min(T * T, UNIT * threads)
    cols = min(T, span)
    rows = min(T, (span + T - 2) // T + 1)
    smem = (cols * O + 4 * -(-cols // 16) + rows * O) * 4
    if smem > SMEM_LIMIT:
        raise ValueError(f"potential_matrix: the writer keys of a block, "
                         f"{smem} bytes at T={T}, O={O}, exceed the "
                         f"{SMEM_LIMIT} bytes of shared memory a block has")
    return blocks, smem


def potential_matrix_cost(T: int, O: int,
                          live_reads: int | None = None) -> tuple[int, int]:
    """(operations, bytes) of one call over [T, O] keys.  Bytes: the two
    key sets read once, the [T, T] int8 output written once; operations:
    a compare and a select for each (reader key, writer key) pair of the
    ``live_reads`` reader keys >= 0 the data holds (inactive reader keys
    are skipped; None: all T O of them, what the shapes alone allow)."""
    R = T * O if live_reads is None else live_reads
    return 2 * T * O * R, 2 * T * O * 4 + T * T


@kernel_wrapper
def potential_matrix_cuda(read_key, write_key):
    """CUDA kernel.  read_key/write_key: [T, O] int32 (-1 = inactive op).
    Returns potential [T, T] int8."""
    T, O = read_key.shape
    check_input("potential_matrix.read_key", read_key, (T, O), torch.int32)
    check_input("potential_matrix.write_key", write_key, (T, O), torch.int32)
    blocks, smem = geometry(T, O)
    pot = torch.empty((T, T), dtype=torch.int8, device=read_key.device)
    if T:
        launch("potential_matrix", "potential_matrix_launch",
               read_key.data_ptr(), write_key.data_ptr(), pot.data_ptr(), T,
               O, THREADS, blocks, smem, stream_of(read_key), on=read_key,
               cost=potential_matrix_cost(T, O))
    return pot


def potential_matrix(read_key, write_key):
    """The wrapper: the CUDA kernel for CUDA (and meta) tensors, the plain
    version for CPU tensors."""
    if on_card(read_key):
        return potential_matrix_cuda(read_key, write_key)
    return potential_matrix_ref(read_key, write_key)
