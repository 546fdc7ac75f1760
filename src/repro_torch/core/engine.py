"""Wave-execution engine for all six schedulers (port of
``repro.core.engine``).

A wave is a batch of transactions whose lifespans all overlap: they read
the wave-start snapshot in parallel, keep write sets private and then
commit one by one in a deterministic order, which is where the paper's
rules fire:

  read phase   — CV rule 4 / PostSI §IV-B CID visibility + PostSI rule 3,
                 one ``sub.read_phase`` call (three kernel dispatches, or
                 one ``wave_commit`` launch on the ``+fused`` route);
  commit phase — CV rules 5-6 and PostSI rules 3/4/5 (``commit_phase``),
                 a Python loop of T steps of small tensor ops.

The commit loop is branch-free tensor arithmetic: no ``.item()``, no
``bool(tensor)`` and no ``if`` on device values, so the host never waits
on the device inside a wave.  Each step launches about 170 small kernels
for postsi (``version_scan`` once, through ``read_newest``; counted on an
H100 by ``chip_smoke.py``), so a wave of T transactions costs T times that
in launches and the host, not the device, sets its pace; CUDA graphs or a
commit-loop kernel are the way to cut them.

Unlike the JAX engine, the store is updated IN PLACE: ``run_wave`` and
every driver below mutate the store they are given (clone it first to
keep it).  Drivers: ``run_workload`` syncs every wave to the host;
``run_workload_fused`` runs all waves without a host sync and copies the
stacked outcomes once; ``run_block`` leaves a block's outcomes on the
device; ``step_wave``/``step_block`` sync them for the service.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.kernels import KernelConfig, resolve
from .commit_phase import (ABORTED, COMMITTED, NOP, READ, RMW, RUNNING,
                           WRITE, creator_slots, lost_update,
                           ongoing_readers_of, postsi_bounds, push_bounds,
                           rw_edge_to_creator)
from .store import (INF, MVStore, PlacementArrays, as_placement_arrays,
                    node_of_key)
from .substrate import LocalSubstrate

SCHEDULERS = ("postsi", "cv", "si", "optimal", "dsi", "clocksi")
MAX_NODES = 32             # node-id range of the message statistics


class Wave(NamedTuple):
    op_kind: torch.Tensor    # [T, O] int32
    op_key: torch.Tensor     # [T, O] int32
    op_val: torch.Tensor     # [T, O] int32
    host: torch.Tensor       # [T] int32 host node per txn
    tid: torch.Tensor        # [T] int32 global tids (unique, > 0)


class WaveOut(NamedTuple):
    status: torch.Tensor     # [T] RUNNING/COMMITTED/ABORTED
    s: torch.Tensor          # [T] final start time
    c: torch.Tensor          # [T] final commit time
    read_key: torch.Tensor   # [T, O] (-1 where not a read)
    read_cid: torch.Tensor   # [T, O]
    write_key: torch.Tensor  # [T, O] (-1 where not a write)
    write_cid: torch.Tensor  # [T, O] cid stamped on installed versions
    # stats (int32 scalars)
    msgs_cross: torch.Tensor   # cross-node data/negotiation messages
    msgs_coord: torch.Tensor   # messages through the central coordinator
    waits: torch.Tensor        # clock-si skew waits
    evicted_visible: torch.Tensor  # ring reuses of still-visible versions


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device)


def wave_from_numpy(wave, device=None) -> Wave:
    """A ``Wave`` of int32 tensors on ``device`` from any wave whose leaves
    are array-likes (numpy, the JAX package's waves, tensors)."""
    from repro_torch.kernels import resolve_device
    dev = resolve_device(device)
    return Wave(*(leaf.to(device=dev, dtype=torch.int32)
                  if isinstance(leaf, torch.Tensor)
                  else _i32(np.array(leaf, np.int32), dev)
                  for leaf in wave))


def wave_to_numpy(wave) -> Wave:
    """A ``Wave`` (or any tuple of tensors, e.g. ``WaveOut``) with numpy
    leaves."""
    return type(wave)(*(t.detach().cpu().numpy()
                        if isinstance(t, torch.Tensor) else np.asarray(t)
                        for t in wave))


def _out_to_numpy(out: WaveOut) -> WaveOut:
    return WaveOut(*(t.cpu().numpy() for t in out))


def run_wave_on(sub, store: MVStore, wave: Wave, wave_idx, clock,
                n_nodes=8, sched: str = "postsi", host_skew=None,
                watermark=None, gc_track: bool = False,
                gc_block: bool = False,
                placement: PlacementArrays | None = None,
                ) -> Tuple[MVStore, WaveOut, torch.Tensor]:
    """Execute one wave on a data-access substrate, updating ``store`` in
    place.  The ONLY copy of the concurrency-control rules for all six
    schedulers.  ``wave`` holds tensors on the store's device; ``wave_idx``
    and ``clock`` are ints or int32 scalars.  Returns (store, out, clock').

    ``placement`` translates logical keys once (``pkeys = slot[key]``, the
    store row every substrate access uses); locality (dsi remoteness,
    clocksi node skew, msgs_cross) stays the logical ``key % n_nodes``."""
    if sched not in SCHEDULERS:
        raise ValueError(f"unknown scheduler {sched!r}; expected one of "
                         f"{SCHEDULERS}")
    dev = store.device
    T, O = wave.op_kind.shape
    wave_idx = _i32(wave_idx, dev)
    clock = _i32(clock, dev)
    clock0 = clock          # wave-entry clock = snapshot time for clocked scheds
    track_gc = gc_track or gc_block
    wm = clock if watermark is None else _i32(watermark, dev)
    kind, keys, host = wave.op_kind, wave.op_key, wave.host
    is_read = (kind == READ) | (kind == RMW)
    is_write = (kind == WRITE) | (kind == RMW)
    if placement is None:
        pkeys = keys                                   # slot[k] == k
    else:
        kc = keys.clamp(0, placement.slot.shape[0] - 1).long()
        # negative NOP sentinels pass through untranslated
        pkeys = torch.where(keys >= 0, placement.slot[kc], keys)

    # ------------------------------------------------------------------ reads
    if sched == "clocksi":
        hs = (host_skew if host_skew is not None
              else torch.zeros(1, dtype=torch.int32, device=dev))
        my_skew = hs[host.clamp(0, hs.shape[0] - 1).long()]       # [T]
        cutoff_wave = wave_idx - my_skew                          # snapshot wave
        # visible: newest version whose wave tag < cutoff (stale snapshot)
        key_wave, head_cid = sub.key_staleness(store, pkeys)
        stale = key_wave >= cutoff_wave[:, None]
        max_cid = torch.where(stale, head_cid - 1, INF)
    else:
        max_cid = torch.full((T, O), INF, dtype=torch.int32, device=dev)

    (r_val, r_tid, r_cid, r_sid, r_slot, s_lo0,
     potential) = sub.read_phase(store, pkeys, max_cid, is_read, is_write)

    read_key = torch.where(is_read, keys, -1)
    read_cid = torch.where(is_read, r_cid, -1)

    # --------------------------------------------------------------- commits
    # deterministic commit order = wave-local index (tids ascend within wave)
    s_lo, c_lo = s_lo0, s_lo0
    s_hi = torch.full((T,), INF, dtype=torch.int32, device=dev)
    status = torch.full((T,), RUNNING, dtype=torch.int32, device=dev)
    s_arr = torch.full((T,), -1, dtype=torch.int32, device=dev)
    c_arr = torch.full((T,), -1, dtype=torch.int32, device=dev)
    wcid = torch.full((T, O), -1, dtype=torch.int32, device=dev)
    clk = clock
    evicted = torch.zeros((), dtype=torch.int32, device=dev)
    tid0 = wave.tid[0]
    for i in range(T):
        active = status[i] == RUNNING
        w_i, r_i, pk_i = is_write[i], is_read[i], pkeys[i]
        nv_val, nv_tid, nv_cid, nv_sid, nv_slot = sub.read_newest(store, pk_i)

        # map newest creators to wave-local ids (or -1 if older wave)
        local, creator_committed = creator_slots(nv_tid, tid0, T, status)
        # lost update: an RMW whose read version is no longer newest
        abort = lost_update(r_i, w_i, nv_cid, r_cid[i])
        if sched in ("postsi", "cv"):
            # CV rule 5(ii): cannot overwrite an invisible creator's version
            abort = abort | rw_edge_to_creator(w_i, local, creator_committed,
                                               potential[i])
        else:
            # first-committer-wins: any write over a same-wave commit aborts
            abort = abort | (w_i & (local >= 0) & creator_committed).any()
        if sched == "dsi":
            # incremental snapshot: a remote read whose key was meanwhile
            # overwritten implies a timestamp mismatch -> abort
            remote = node_of_key(keys[i], n_nodes) != host[i]
            abort = abort | (r_i & remote & (nv_cid != r_cid[i])).any()

        if sched == "postsi":
            # rules 3/4(a)/5; SIDs of read slots are re-gathered: peers may
            # have bumped them while we ran
            cur_sid = sub.read_sid(store, pk_i, r_slot[i])
            ongoing_reader = ongoing_readers_of(i, potential, status)
            s_i, c_i, iv_abort = postsi_bounds(
                s_lo[i], s_hi[i], c_lo[i], r_i, w_i, nv_cid, nv_sid, cur_sid,
                ongoing_reader, s_lo)
            abort = abort | iv_abort
        else:
            # clocked baselines: snapshot = wave-entry clock; commit = clock++
            s_i = clock0
            c_i = clk + 1

        # GC watermark consult: does any write reuse a ring slot whose
        # version is still visible above the watermark?
        if track_gc:
            evict_unsafe = w_i & sub.evicting_visible(store, pk_i, wm)
        if gc_block:
            abort = abort | evict_unsafe.any()

        commit = active & ~abort
        # COMMITTED + 1 == ABORTED
        new_status = torch.where(active, abort.to(torch.int32) + COMMITTED,
                                 status[i])

        # ---- install writes (masked scatter, in place)
        wmask = w_i & commit
        val_new = torch.where(kind[i] == RMW, r_val[i] + wave.op_val[i],
                              wave.op_val[i])
        sub.install(store, wmask, pk_i, val_new, wave.tid[i], c_i, wave_idx)
        wcid[i] = torch.where(wmask, c_i, -1)

        # ---- rule 4(c): bump SIDs of read versions to my start time,
        # guarded: skip if the ring slot was recycled since the read
        sub.bump_sid(store, r_i & commit, pk_i, r_slot[i], r_tid[i], s_i)

        # ---- rule 4(b): push bounds of conflicting ongoing transactions
        if sched == "postsi":
            s_lo, s_hi, c_lo = push_bounds(i, commit, s_i, c_i, potential,
                                           status, s_lo, s_hi, c_lo)

        status[i] = new_status
        s_arr[i] = torch.where(commit, s_i, -1)
        c_arr[i] = torch.where(commit, c_i, -1)
        clk = torch.where(commit, torch.maximum(clk, c_i), clk)
        if track_gc:
            evicted = evicted + torch.where(
                commit, evict_unsafe.sum().to(torch.int32), 0)

    write_key = torch.where(is_write & (status[:, None] == COMMITTED), keys,
                            -1)

    # ------------------------------------------------------------------ stats
    # work delegation batches per (txn, remote node) pair (paper §IV-A), so
    # cross-node messages count DISTINCT remote nodes touched, not raw ops
    count = lambda m: m.sum().to(torch.int32)
    op_node = node_of_key(keys, n_nodes)                               # [T,O]
    active_op = kind != NOP
    node_ids = torch.arange(MAX_NODES, dtype=torch.int32, device=dev)
    touch = (op_node[..., None] == node_ids) & active_op[..., None]
    remote_mask = node_ids[None, :] != host[:, None]                   # [T,MN]
    msgs_cross = count(touch.any(dim=1) & remote_mask)
    remote_op = (op_node != host[:, None]) & active_op
    committed = status == COMMITTED
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    msgs_coord = zero
    if sched in ("postsi", "cv"):
        # negotiation (postsi) / anti-dependency entries stored on both
        # endpoint hosts (cv): one message per DISTINCT peer host
        edge = potential & committed[None, :]
        peer_hosts = ((host[None, :, None] == node_ids)
                      & edge[:, :, None]).any(dim=1)                   # [T,MN]
        msgs_cross = msgs_cross + count(peer_hosts & remote_mask)
        if sched == "cv":
            # ... and reads consult the table on remote hosts (paper §V-D)
            read_touch = ((op_node[..., None] == node_ids)
                          & (is_read & active_op)[..., None])
            msgs_cross = msgs_cross + count(read_touch.any(dim=1)
                                            & remote_mask)
    elif sched == "si":
        msgs_coord = _i32(2 * T, dev)                  # begin + end, per txn
    elif sched == "dsi":
        msgs_coord = 2 * count(remote_op.any(dim=1))   # global txns pay

    waits = zero
    if sched == "clocksi" and host_skew is not None:
        # ahead-snapshot reads on behind remote nodes must wait (paper §II)
        last = host_skew.shape[0] - 1
        node_skew = host_skew[op_node.clamp(0, last).long()]
        my_skew = host_skew[host.clamp(0, last).long()][:, None]
        waits = torch.where(remote_op & is_read,
                            torch.clamp(node_skew - my_skew, min=0),
                            0).sum().to(torch.int32)

    out = WaveOut(status, s_arr, c_arr, read_key, read_cid, write_key, wcid,
                  msgs_cross, msgs_coord, waits, evicted)
    return store, out, clk


def _prepare(store: MVStore, kernels, host_skew, placement):
    """Resolve the substrate and move the wave-independent inputs onto the
    store's device."""
    dev = store.device
    hs = None if host_skew is None else _i32(np.array(host_skew), dev)
    return (LocalSubstrate(kernels, dev), hs,
            as_placement_arrays(placement, dev))


def run_wave(store: MVStore, wave: Wave, wave_idx, clock, n_nodes=8,
             sched: str = "postsi", host_skew=None,
             watermark=None, gc_track: bool = False, gc_block: bool = False,
             kernels: KernelConfig | str | None = None,
             placement=None) -> Tuple[MVStore, WaveOut, torch.Tensor]:
    """Execute one wave on the store's device, updating ``store`` IN
    PLACE.  Returns (store, out, clock') with device-resident ``out``.

    ``kernels`` picks the kernel backend (a ``KernelConfig``, ``"cuda"``,
    ``"torch"``, optionally ``"+fused"``, or ``None`` for the process
    default), resolved against the store's device: ``auto`` is ``cuda`` on
    the card, ``torch`` on the CPU, and ``cuda`` on a CPU store raises.

    ``watermark`` is the GC watermark (``None``: the wave-entry clock).
    With ``gc_track`` each install that would evict a version still visible
    above it is counted in ``WaveOut.evicted_visible``; with ``gc_block``
    the writer aborts instead."""
    sub, hs, pl = _prepare(store, kernels, host_skew, placement)
    return run_wave_on(sub, store, wave_from_numpy(wave, store.device),
                       wave_idx, clock, n_nodes,
                       sched=sched, host_skew=hs,
                       watermark=watermark, gc_track=gc_track,
                       gc_block=gc_block, placement=pl)


class RunStats(NamedTuple):
    committed: int
    aborted: int
    msgs_cross: int
    msgs_coord: int
    waits: int
    evicted_visible: int   # still-visible versions destroyed by ring reuse
    waves: int


def step_wave(store: MVStore, wave, wave_idx: int, clock,
              *, sched: str = "postsi", n_nodes: int = 8, host_skew=None,
              watermark=None, gc_track: bool = True, gc_block: bool = False,
              kernels: KernelConfig | str | None = None, placement=None):
    """Closed-loop step API: execute ONE wave (in place) and sync the
    per-txn outcomes to the host.  Returns ``(store, out_np, clock')``."""
    store, out, clock = run_wave(store, wave, wave_idx, clock, n_nodes,
                                 sched=sched, host_skew=host_skew,
                                 watermark=watermark, gc_track=gc_track,
                                 gc_block=gc_block, kernels=kernels,
                                 placement=placement)
    return store, _out_to_numpy(out), clock


def run_workload(store: MVStore, waves, sched: str = "postsi",
                 host_skew=None, n_nodes: int = 8, gc_track: bool = False,
                 gc_block: bool = False,
                 kernels: KernelConfig | str | None = None, placement=None):
    """Per-wave driver: one wave and one host sync at a time.  Returns
    (store, history, stats); history is a list of ``(tids, WaveOut)`` with
    numpy leaves."""
    clock = 1
    history = []
    for w_idx, wave in enumerate(waves):
        store, out, clock = run_wave(store, wave, w_idx + 1, clock, n_nodes,
                                     sched=sched,
                                     host_skew=host_skew, gc_track=gc_track,
                                     gc_block=gc_block, kernels=kernels,
                                     placement=placement)
        history.append((np.asarray(wave_to_numpy(wave).tid),
                        _out_to_numpy(out)))
    return store, history, _stats_of(history)


def _stats_of(history) -> RunStats:
    tot = dict(committed=0, aborted=0, msgs_cross=0, msgs_coord=0, waits=0,
               evicted_visible=0)
    for _, o in history:
        tot["committed"] += int((o.status == COMMITTED).sum())
        tot["aborted"] += int((o.status == ABORTED).sum())
        tot["msgs_cross"] += int(o.msgs_cross)
        tot["msgs_coord"] += int(o.msgs_coord)
        tot["waits"] += int(o.waits)
        tot["evicted_visible"] += int(o.evicted_visible)
    return RunStats(waves=len(history), **tot)


# ---------------------------------------------------------------------------
# multi-wave drivers without per-wave host syncs
# ---------------------------------------------------------------------------

def stack_waves(waves, device=None) -> Wave:
    """Stack per-wave [T, O] arrays into one [W, T, O] batch (leading axis =
    wave index).  ``device=None`` keeps tensors where they are and puts
    numpy waves on the CUDA device."""
    if device is None and isinstance(waves[0].op_kind, torch.Tensor):
        device = waves[0].op_kind.device
    ws = [wave_from_numpy(w, device) for w in waves]
    return Wave(*(torch.stack([getattr(w, f) for w in ws])
                  for f in Wave._fields))


def _run_stacked(sub, store, stacked: Wave, wave_idx0, clock, **kw):
    """Run the [B] waves of ``stacked`` back to back on the device (no host
    sync); returns (store, WaveOut with a leading [B] axis, clock')."""
    outs = []
    for b in range(stacked.op_kind.shape[0]):
        store, out, clock = run_wave_on(
            sub, store, Wave(*(f[b] for f in stacked)), wave_idx0 + b,
            clock, **kw)
        outs.append(out)
    return store, WaveOut(*(torch.stack(f) for f in zip(*outs))), clock


def run_workload_fused(store: MVStore, waves, sched: str = "postsi",
                       host_skew=None, n_nodes: int = 8,
                       gc_track: bool = False, gc_block: bool = False,
                       kernels: KernelConfig | str | None = None,
                       placement=None):
    """Fused driver: the whole workload with no host sync between waves
    and one copy of the stacked outcomes at the end.  Same (store, history,
    stats) contract as ``run_workload``, bit-identical history."""
    stacked = stack_waves(waves, store.device)
    sub, hs, pl = _prepare(store, kernels, host_skew, placement)
    store, outs, _ = _run_stacked(
        sub, store, stacked, 1, 1, n_nodes=n_nodes, sched=sched,
        host_skew=hs, gc_track=gc_track, gc_block=gc_block, placement=pl)
    outs = _out_to_numpy(outs)
    tids = stacked.tid.cpu().numpy()
    history = [(tids[i], WaveOut(*(f[i] for f in outs)))
               for i in range(len(waves))]
    return store, history, _stats_of(history)


def run_block(store: MVStore, stacked: Wave, wave_idx0: int, clock,
              *, sched: str = "postsi", n_nodes: int = 8, host_skew=None,
              watermark=None, gc_track: bool = True, gc_block: bool = False,
              kernels: KernelConfig | str | None = None, placement=None):
    """Run a block of B formed waves (``stacked`` has a leading [B] axis,
    from ``stack_waves``) back to back, in place, and return
    device-resident results ``(store, outs, clock')`` — ``outs`` is a
    ``WaveOut`` whose every leaf carries the [B] axis.  Nothing here waits
    on the device.  ``watermark`` (or ``None`` for the per-wave entry
    clock) applies to every wave of the block."""
    sub, hs, pl = _prepare(store, kernels, host_skew, placement)
    return _run_stacked(sub, store, wave_from_numpy(stacked, store.device),
                        wave_idx0, clock,
                        n_nodes=n_nodes, sched=sched,
                        host_skew=hs, watermark=watermark,
                        gc_track=gc_track, gc_block=gc_block, placement=pl)


def step_block(store: MVStore, stacked: Wave, wave_idx0: int, clock, **kw):
    """Synchronous block step: ``run_block`` + host sync of the per-wave
    outcomes.  Returns ``(store, outs_np, clock')``."""
    store, outs, clock = run_block(store, stacked, wave_idx0, clock, **kw)
    return store, _out_to_numpy(outs), clock
