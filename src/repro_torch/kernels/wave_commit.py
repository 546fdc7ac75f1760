"""wave_commit: the whole wave read phase in one launch.

Port of ``repro.kernels.wave_commit.wave_commit_pallas``: the version scan
of every op's ring, the ring fields at the chosen slot, the PostSI rule-3
seed ``s_lo0`` (as ``[T]``) and the potential matrix.  The CUDA kernel
(``csrc/wave_commit.cu``) gathers the rings from the store tables in-kernel,
V lanes an op, in read blocks of their own beside the potential matrix's
blocks (:func:`geometry` sizes the launch); its plain version
(``wave_commit_ref``, over pre-gathered rings) sits beside it and serves
CPU tensors; :func:`wave_commit_cost` counts a call's work.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import interval_negotiate
from .build import check_input, kernel_wrapper, launch, on_card, stream_of
from .ref import wave_commit_ref

__all__ = ["wave_commit", "wave_commit_cost", "wave_commit_cuda",
           "wave_commit_plain", "wave_commit_ref", "geometry", "Geometry"]


class Geometry(NamedTuple):
    """One launch of the kernel: a 1-D grid of ``read_blocks`` read-phase
    blocks, then ``pot_blocks`` potential-matrix blocks, ``threads`` each."""
    vg_log: int        # log2 of the lanes an op (V to a power of two, <= 32)
    txns: int          # txns a read block, each O x lanes-an-op adjacent lanes
    threads: int
    read_blocks: int
    pot_blocks: int
    smem: int          # dynamic shared memory bytes


def geometry(T: int, O: int, V: int) -> Geometry:
    """The launch for a wave of T txns of O ops over rings of V slots.  A
    txn's L = O x Vg lanes lie in one warp where L <= 32, 32 // L txns to a
    warp in blocks of 128 threads (its s_lo0 is then a warp reduction);
    otherwise as many whole txns as fit 128 threads, at least one (up to
    1,024 threads), with their seeds in shared memory.  The potential
    blocks take the same number of threads."""
    vg_log = 0
    while (1 << vg_log) < min(V, 32):
        vg_log += 1
    L = O << vg_log
    if L <= 32:
        threads = interval_negotiate.THREADS
        txns = 32 // L * (threads // 32)
    else:
        txns = max(1, interval_negotiate.THREADS // L)
        threads = -(-txns * L // 32) * 32
    if threads > 1024:
        raise ValueError(f"wave_commit: a txn of O={O} ops over V={V} slots "
                         f"takes {L} lanes, more than a block's 1,024")
    pot_blocks, smem = interval_negotiate.geometry(T, O, threads)
    if L > 32:
        smem = max(smem, txns * O * 4)
    return Geometry(vg_log, txns, threads, -(-T // txns), pot_blocks, smem)


def _rings(tables, keys):
    """[N, V] tables + [T, O] keys -> [T, O, V] gathered rings (clipped)."""
    k = keys.clamp(0, tables[0].shape[0] - 1).long()
    return [t[k] for t in tables]


def wave_commit_plain(cids, tids, sids, vals, max_cid, read_key, write_key,
                      rvalid, keys=None):
    """Plain PyTorch version of :func:`wave_commit_cuda` (same arguments).
    ``keys=None`` takes pre-gathered [T, O, V] rings, the reference's own
    form."""
    if keys is not None:
        cids, tids, sids, vals = _rings((cids, tids, sids, vals), keys)
    return wave_commit_ref(cids, tids, sids, vals, max_cid, read_key,
                           write_key, rvalid)


def wave_commit_cost(T: int, O: int, V: int,
                     live_reads: int | None = None) -> tuple[int, int]:
    """(operations, bytes) of one call over a [T, O] wave and rings of V
    slots.  Bytes: each input read once (keys, ceilings, reader and writer
    keys, rvalid; the ring row's cid and tid; val and sid at the chosen
    slot), each output written once (the five [T, O] fields, s_lo0, the
    [T, T] potential); operations: the version scan's, and the potential
    matrix's over the ``live_reads`` reader keys >= 0
    (:func:`interval_negotiate.potential_matrix_cost`)."""
    pairs = interval_negotiate.potential_matrix_cost(T, O, live_reads)[0]
    return (3 * T * O * V + pairs,
            T * O * (4 * 4 + 1 + 2 * 4 * V + 2 * 4 + 5 * 4) + T * 4 + T * T)


@kernel_wrapper
def wave_commit_cuda(cids, tids, sids, vals, max_cid, read_key, write_key,
                     rvalid, keys):
    """CUDA kernel.  cids/tids/sids/vals: the [N, V] int32 store tables;
    keys: [T, O] int32 store rows (clipped in-kernel);
    max_cid/read_key/write_key: [T, O] int32; rvalid: [T, O] bool.  Returns
    (slot, r_val, r_tid, r_cid, r_sid [T, O] int32, s_lo0 [T] int32,
    potential [T, T] int8)."""
    T, O = read_key.shape
    for name, a in (("keys", keys), ("max_cid", max_cid),
                    ("read_key", read_key), ("write_key", write_key)):
        check_input(f"wave_commit.{name}", a, (T, O), torch.int32)
    N, V = cids.shape
    for name, a in (("cids", cids), ("tids", tids), ("sids", sids),
                    ("vals", vals)):
        check_input(f"wave_commit.{name}", a, (N, V), torch.int32)
    check_input("wave_commit.rvalid", rvalid, (T, O), torch.bool)
    g = geometry(T, O, V)
    dev = read_key.device
    outs = [torch.empty((T, O), dtype=torch.int32, device=dev)
            for _ in range(5)]
    s_lo0 = torch.empty(T, dtype=torch.int32, device=dev)
    pot = torch.empty((T, T), dtype=torch.int8, device=dev)
    if T and O:
        launch("wave_commit", "wave_commit_launch", cids.data_ptr(),
               tids.data_ptr(), sids.data_ptr(), vals.data_ptr(),
               keys.data_ptr(), max_cid.data_ptr(),
               read_key.data_ptr(), write_key.data_ptr(), rvalid.data_ptr(),
               *(o.data_ptr() for o in outs), s_lo0.data_ptr(),
               pot.data_ptr(), T, O, V, N, *g, stream_of(read_key),
               on=read_key, cost=wave_commit_cost(T, O, V))
    return (*outs, s_lo0, pot)


def wave_commit(cids, tids, sids, vals, max_cid, read_key, write_key, rvalid,
                keys=None):
    """The wrapper: the CUDA kernel for CUDA (and meta) tensors (which
    needs ``keys``), the plain version for CPU tensors."""
    if on_card(read_key):
        return wave_commit_cuda(cids, tids, sids, vals, max_cid, read_key,
                                write_key, rvalid, keys)
    return wave_commit_plain(cids, tids, sids, vals, max_cid, read_key,
                             write_key, rvalid, keys)
