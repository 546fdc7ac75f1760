"""commit_loop: the whole commit phase of one wave in one launch.

Port of the reference's commit loop, ``lax.fori_loop`` over ``commit_one``
(``repro.core.engine.run_wave_on``), which carries
``repro.kernels.version_scan.version_scan_pallas`` at every step.  The CUDA
kernel (``csrc/commit_loop.cu``) runs the T serially dependent steps in one
warp of one block, with the ring scan as a device function, ``potential``
as bit matrices and the per-transaction interval state in shared memory.
Two variants of it, picked here before the launch by
:func:`commit_loop_smem_bytes`:

* ``"staged"``: the rings and heads of every row the wave touches are
  copied into shared memory, the steps run on them there, and the rows
  that changed are written back at the end;
* ``"global"``, where those do not fit: the steps run on the store tables
  in device memory, with the bit matrices and op records in a scratch
  buffer.

Its plain version is the engine's own loop, ``engine._commit_loop_plain``
(the only Python copy of the rules), run over a ``torch`` substrate: CPU
tensors get it, and the kernel is held to it bit for bit on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .build import SMEM_LIMIT, check_input, launch, stream_of

__all__ = ["commit_loop", "commit_loop_cuda", "commit_loop_plain",
           "commit_loop_smem_bytes", "SCHEDULER_CODES", "VARIANTS"]

# scheduler -> int code of the C entry point (engine.SCHEDULERS order)
SCHEDULER_CODES = {"postsi": 0, "cv": 1, "si": 2, "optimal": 3, "dsi": 4,
                   "clocksi": 5}
VARIANTS = ("staged", "global")
FIELDS = 6                 # csrc/commit_loop.cu: kFields, ints per op record


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


def _round4(x: int) -> int:
    return (x + 3) // 4 * 4


class Layout(ctypes.Structure):
    """Where everything of one launch lives, in ints: ``struct Layout`` of
    csrc/commit_loop.cu, field for field, as its ``make_layout`` fills it
    (the launch entry refuses a launch whose two layouts differ).  Shared
    memory, both variants: the interval state s_lo, s_hi, c_lo and the txn
    tids [T] each, the committed bits [WP], the step's install scratch
    [6, O] and a counter; staged: the bit matrices P and P^T [T, WP], the op
    records [T, OPW], the staged rows' store rows [R] and one region (at
    ``uni``) that holds the prologue's hash (2 H ints) and then the staged
    rings, R x (3 V + 2) ints (tid, cid, sid, head, dirty); global: two step
    buffers of one step's records and bit rows.  ``total``: ints of shared
    memory; ``scratch``: ints of device scratch (global: P, P^T and the op
    records)."""
    _fields_ = [(name, ctypes.c_longlong) for name in (
        "W", "WP", "OPW", "R", "H", "slo", "shi", "clo", "ttid", "cmask",
        "dh", "misc", "P", "PT", "ops", "row_of", "uni", "step", "total",
        "scratch")]


@functools.lru_cache(maxsize=256)
def _layout(T: int, O: int, V: int, staged: bool) -> Layout:
    L = Layout()
    L.W = -(-T // 32)
    L.WP = _round4(L.W)
    L.OPW = FIELDS * O if staged else _round4(FIELDS * O)
    L.R = T * O + 1
    L.H = 2
    while L.H < 2 * L.R:
        L.H *= 2
    L.slo, L.shi, L.clo, L.ttid, L.cmask = 0, T, 2 * T, 3 * T, 4 * T
    L.dh = L.cmask + L.WP
    L.misc = L.dh + 6 * O
    base = _round4(L.misc + 1)
    if staged:
        L.P = base
        L.PT = L.P + T * L.WP
        L.ops = L.PT + T * L.WP
        L.row_of = L.ops + T * L.OPW
        L.uni = _round4(L.row_of + L.R)
        L.total = L.uni + max(L.R * (3 * V + 2), 2 * L.H)
    else:
        L.step = base
        L.total = base + 2 * (L.OPW + 2 * L.WP)
        L.scratch = 2 * T * L.WP + T * L.OPW
    return L


@functools.lru_cache(maxsize=256)
def commit_loop_smem_bytes(T: int, O: int, V: int,
                           variant: str | None = None) -> tuple[int, str]:
    """(dynamic shared memory bytes, variant) of one launch: ``"staged"``
    where its rows, bit matrices and op records fit the block's
    ``SMEM_LIMIT``, else ``"global"``; ``variant`` forces one."""
    if variant is None:
        staged = 4 * _layout(T, O, V, True).total <= SMEM_LIMIT
        variant = "staged" if staged else "global"
    if variant not in VARIANTS:
        raise ValueError(f"commit_loop: variant {variant!r}, expected one "
                         f"of {VARIANTS}")
    return 4 * _layout(T, O, V, variant == "staged").total, variant


def commit_loop_cuda(store, inputs, *, sched, n_nodes, gc_track, gc_block,
                     variant=None):
    """CUDA kernel.  ``store``: the six tables (val, tid, cid, sid [N, V],
    head, wave [N] int32), updated in place; ``inputs``: the wave (kind,
    key, val, host, tid), pkeys, r_val, r_tid, r_cid, r_slot [T, O],
    s_lo0 [T], potential [T, T] bool or int8 and the int32 scalars
    wave_idx, clock, watermark (an ``engine.CommitInputs``); ``variant``:
    None (:func:`commit_loop_smem_bytes` picks) or one of ``VARIANTS``.
    Returns (status, s_arr, c_arr [T], wcid [T, O], clk, evicted) on the
    card, views of one allocation, with no host sync."""
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
    smem, variant = commit_loop_smem_bytes(T, O, V, variant)
    if smem > SMEM_LIMIT:
        raise ValueError(f"commit_loop: T={T}, O={O}, V={V} needs {smem} "
                         f"bytes of shared memory ({variant} variant), over "
                         f"the {SMEM_LIMIT} a block has")
    if potential.data_ptr() % 16:      # the kernel reads it 16 bytes a load
        potential = potential.clone()
    layout = _layout(T, O, V, variant == "staged")
    n_out = 3 * T + T * O + 2
    off = _round4(n_out)               # the scratch starts 16-byte aligned
    buf = torch.empty(off + layout.scratch, dtype=torch.int32,
                      device=kind.device)
    status, s_arr, c_arr, wcid, clk, evicted, _ = buf.split(
        (T, T, T, T * O, 1, 1, buf.numel() - n_out))
    vec16 = all(t.data_ptr() % 16 == 0 for t in (tid, cid, sid))
    launch("commit_loop", "commit_loop_launch",
           *(t.data_ptr() for t in (val, tid, cid, sid, head, wave_tag, kind,
                                    keys, pkeys, op_val, host, txn_tid, r_val,
                                    r_tid, r_cid, r_slot, s_lo0, potential,
                                    wave_idx, clock, watermark, status, s_arr,
                                    c_arr, wcid, clk, evicted)),
           buf.data_ptr() + 4 * off, T, O, V, N, SCHEDULER_CODES[sched],
           int(gc_track or gc_block), int(gc_block), n_nodes, int(vec16),
           int(variant == "staged"), ctypes.byref(layout),
           ctypes.sizeof(layout), stream_of(kind))
    return (status, s_arr, c_arr, wcid.view(T, O), clk.view(()),
            evicted.view(()))


def commit_loop(store, inputs, *, sched, n_nodes, gc_track, gc_block):
    """The wrapper: the CUDA kernel for a store on the card, the plain
    version for a store on the CPU (the kernel has no CPU form)."""
    fn = commit_loop_cuda if store[0].is_cuda else commit_loop_plain
    return fn(store, inputs, sched=sched, n_nodes=n_nodes, gc_track=gc_track,
              gc_block=gc_block)
