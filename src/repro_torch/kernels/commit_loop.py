"""commit_loop: the whole commit phase of one wave in one launch.

Port of the reference's commit loop, ``lax.fori_loop`` over ``commit_one``
(``repro.core.engine.run_wave_on``), which carries
``repro.kernels.version_scan.version_scan_pallas`` at every step.  The CUDA
kernel (``csrc/commit_loop.cu``) runs the T serially dependent steps in one
block, with the ring scan as a device function, the per-transaction
interval state in shared memory and the store tables updated in place.

Its plain version is the engine's own loop, ``engine._commit_loop_plain``
(the only Python copy of the rules), run over a ``torch`` substrate: CPU
tensors get it, and the kernel is held to it bit for bit on the card.
"""
from __future__ import annotations

import torch

from .build import SMEM_LIMIT, check_input, launch, stream_of

__all__ = ["commit_loop", "commit_loop_cuda", "commit_loop_plain",
           "commit_loop_smem_bytes", "SCHEDULER_CODES"]

# scheduler -> int code of the C entry point (engine.SCHEDULERS order)
SCHEDULER_CODES = {"postsi": 0, "cv": 1, "si": 2, "optimal": 3, "dsi": 4,
                   "clocksi": 5}
MAX_THREADS = 512          # csrc/commit_loop.cu: kMaxThreads


def commit_loop_plain(store, inputs, *, sched, n_nodes, gc_track, gc_block):
    """Plain version of :func:`commit_loop_cuda` (same arguments): the
    engine's Python loop over a ``torch`` substrate on the store's
    device."""
    from repro_torch.core.engine import _commit_loop_plain
    from repro_torch.core.store import MVStore
    from repro_torch.core.substrate import LocalSubstrate
    store = MVStore(*store)
    return _commit_loop_plain(LocalSubstrate("torch", store.device), store,
                              inputs, sched=sched, n_nodes=n_nodes,
                              gc_track=gc_track, gc_block=gc_block)


def commit_loop_smem_bytes(T: int, O: int) -> tuple[int, bool]:
    """(dynamic shared memory bytes, potential staged?) of one launch: four
    [T] int32 state arrays, [O] scratch and, where it fits, the [T, T]
    potential matrix with rows padded to an odd count of words (a column
    read by 32 threads hits 32 banks)."""
    base = 4 * 4 * T + 4 * O + 4 * 64
    staged = base + T * _pitch(T)
    return (staged, True) if staged <= SMEM_LIMIT else (base, False)


def _pitch(T: int) -> int:
    return (((T + 3) // 4) | 1) * 4


def commit_loop_cuda(store, inputs, *, sched, n_nodes, gc_track, gc_block):
    """CUDA kernel.  ``store``: the six tables (val, tid, cid, sid [N, V],
    head, wave [N] int32), updated in place; ``inputs``: the wave (kind,
    key, val, host, tid), pkeys, r_val, r_tid, r_cid, r_slot [T, O],
    s_lo0 [T], potential [T, T] bool or int8 and the int32 scalars
    wave_idx, clock, watermark (an ``engine.CommitInputs``).  Returns
    (status, s_arr, c_arr [T], wcid [T, O], clk, evicted) on the card,
    with no host sync."""
    if sched not in SCHEDULER_CODES:
        raise ValueError(f"commit_loop: unknown scheduler {sched!r}")
    val, tid, cid, sid, head, wave_tag = store
    ((kind, keys, op_val, host, txn_tid), pkeys, r_val, r_tid, r_cid, r_slot,
     s_lo0, potential, wave_idx, clock, watermark) = inputs
    N, V = val.shape
    T, O = kind.shape
    if T < 1 or O < 1:
        raise ValueError(f"commit_loop: empty wave [{T}, {O}]")
    if n_nodes < 1:
        raise ValueError(f"commit_loop: n_nodes={n_nodes}, expected >= 1")
    for name, a in (("val", val), ("tid", tid), ("cid", cid), ("sid", sid)):
        check_input(f"commit_loop.{name}", a, (N, V), torch.int32)
    for name, a in (("head", head), ("wave", wave_tag)):
        check_input(f"commit_loop.{name}", a, (N,), torch.int32)
    per_op = (("kind", kind), ("keys", keys), ("pkeys", pkeys),
              ("op_val", op_val), ("r_val", r_val), ("r_tid", r_tid),
              ("r_cid", r_cid), ("r_slot", r_slot))
    for name, a in per_op:
        check_input(f"commit_loop.{name}", a, (T, O), torch.int32)
    for name, a in (("host", host), ("tid", txn_tid), ("s_lo0", s_lo0)):
        check_input(f"commit_loop.{name}", a, (T,), torch.int32)
    if potential.dtype == torch.bool:
        potential = potential.view(torch.int8)
    check_input("commit_loop.potential", potential, (T, T), torch.int8)
    for name, a in (("wave_idx", wave_idx), ("clock", clock),
                    ("watermark", watermark)):
        check_input(f"commit_loop.{name}", a, (), torch.int32)
    smem, staged = commit_loop_smem_bytes(T, O)
    if smem > SMEM_LIMIT:
        raise ValueError(f"commit_loop: T={T}, O={O} needs {smem} bytes of "
                         f"shared memory, over the {SMEM_LIMIT} a block has")
    dev = kind.device
    i32 = dict(dtype=torch.int32, device=dev)
    status, s_arr, c_arr = (torch.empty(T, **i32) for _ in range(3))
    wcid = torch.empty((T, O), **i32)
    clk, evicted = torch.empty((), **i32), torch.empty((), **i32)
    threads = min(-(-T // 32) * 32, MAX_THREADS)
    launch("commit_loop", "commit_loop_launch",
           *(t.data_ptr() for t in (val, tid, cid, sid, head, wave_tag, kind,
                                    keys, pkeys, op_val, host, txn_tid, r_val,
                                    r_tid, r_cid, r_slot, s_lo0, potential,
                                    wave_idx, clock, watermark, status, s_arr,
                                    c_arr, wcid, clk, evicted)),
           T, O, V, N, SCHEDULER_CODES[sched], int(gc_track or gc_block),
           int(gc_block), n_nodes, threads, smem, int(staged), stream_of(kind))
    return status, s_arr, c_arr, wcid, clk, evicted


def commit_loop(store, inputs, *, sched, n_nodes, gc_track, gc_block):
    """The wrapper: the CUDA kernel for a store on the card, the plain
    version for a store on the CPU (the kernel has no CPU form)."""
    fn = commit_loop_cuda if store[0].is_cuda else commit_loop_plain
    return fn(store, inputs, sched=sched, n_nodes=n_nodes, gc_track=gc_track,
              gc_block=gc_block)
