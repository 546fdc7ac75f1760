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
                 one ``sub.commit_loop`` call over the T steps.

On the ``cuda`` routes the commit loop is ONE launch of the ``commit_loop``
kernel per wave (``kernels/csrc/commit_loop.cu``), as the reference runs
it as one ``lax.fori_loop``.  On the ``torch`` route it is
``_commit_loop_plain``, a Python loop of T steps of small tensor ops
(about 170 launches a step for postsi on the card), which holds the only
Python copy of the rules and is the oracle the kernel is held to.  Both
are branch-free on device values: no ``.item()``, no ``bool(tensor)``.
Their scalars (wave index, clock, watermark) are device tensors or fills on
the device, and host arrays reach the card through page-locked memory and
asynchronous copies (``stage_block``, ``_h2d``), so on a CUDA device the
host never waits on it while it dispatches a wave or a block: it waits
only where a driver reads the outcomes back.

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

from repro_torch.kernels import KernelConfig, resolve, resolve_device
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


def _scalar(x, device) -> torch.Tensor:
    """An int32 scalar on ``device``: a tensor as it is (cast and moved if
    need be), a Python or numpy int by a fill on the device.  Never a copy
    from pageable host memory: on a CUDA device that copy synchronizes the
    stream, so the host would wait for all work queued before it."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return torch.full((), int(x), dtype=torch.int32, device=device)


def _h2d(a, device) -> torch.Tensor:
    """An int32 copy of the host array-like ``a`` on ``device``.  On a
    CUDA device it goes through page-locked memory and an asynchronous
    copy, so the host does not wait (PyTorch's page-locked allocator keeps
    the buffer until the copy is done).  A tensor already on the device's
    kind is only cast (and moved, where need be)."""
    if isinstance(a, torch.Tensor):
        if a.device.type == device.type:
            return a.to(device=device, dtype=torch.int32)
        a = a.cpu()
    t = torch.tensor(np.asarray(a), dtype=torch.int32)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def wave_from_numpy(wave, device=None) -> Wave:
    """A ``Wave`` of int32 tensors on ``device`` from any wave whose leaves
    are array-likes (numpy, the JAX package's waves, tensors)."""
    dev = resolve_device(device)
    return Wave(*(_h2d(leaf, dev) for leaf in wave))


def wave_to_numpy(wave) -> Wave:
    """A ``Wave`` (or any tuple of tensors, e.g. ``WaveOut``) with numpy
    leaves."""
    return type(wave)(*(t.detach().cpu().numpy()
                        if isinstance(t, torch.Tensor) else np.asarray(t)
                        for t in wave))


def _out_to_numpy(out: WaveOut) -> WaveOut:
    return WaveOut(*(t.cpu().numpy() for t in out))


def _op_masks(kind):
    """(is_read, is_write) [T, O] of the op kinds: an RMW is both."""
    return (kind == READ) | (kind == RMW), (kind == WRITE) | (kind == RMW)


class CommitInputs(NamedTuple):
    """What one wave's commit loop reads besides the store: the wave, its
    store rows, the read phase's outputs and three int32 device scalars."""
    wave: Wave
    pkeys: torch.Tensor      # [T, O] store rows (placement-translated keys)
    r_val: torch.Tensor      # [T, O] read phase: value, creator TID, CID
    r_tid: torch.Tensor      #        and ring slot of each op's read
    r_cid: torch.Tensor
    r_slot: torch.Tensor
    s_lo0: torch.Tensor      # [T] PostSI rule-3 seed
    potential: torch.Tensor  # [T, T] bool anti-dependency candidates
    wave_idx: torch.Tensor   # int32 scalars: wave tag of installs,
    clock: torch.Tensor      # wave-entry clock,
    watermark: torch.Tensor  # GC watermark


def wave_read_phase(sub, store: MVStore, wave: Wave, wave_idx, clock, *,
                    sched: str = "postsi", host_skew=None, watermark=None,
                    placement: PlacementArrays | None = None
                    ) -> CommitInputs:
    """The read phase of one wave on ``sub``: translate keys, compute the
    clocksi stale-read ceilings and run ``sub.read_phase``.  Returns the
    commit loop's inputs.  Reads the store only."""
    dev = store.device
    T, O = wave.op_kind.shape
    wave_idx = _scalar(wave_idx, dev)
    clock = _scalar(clock, dev)
    wm = clock if watermark is None else _scalar(watermark, dev)
    kind, keys, host = wave.op_kind, wave.op_key, wave.host
    is_read, is_write = _op_masks(kind)
    if placement is None:
        pkeys = keys                                   # slot[k] == k
    else:
        kc = keys.clamp(0, placement.slot.shape[0] - 1).long()
        # negative NOP sentinels pass through untranslated
        pkeys = torch.where(keys >= 0, placement.slot[kc], keys)

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

    (r_val, r_tid, r_cid, _, r_slot, s_lo0,
     potential) = sub.read_phase(store, pkeys, max_cid, is_read, is_write)
    return CommitInputs(wave, pkeys, r_val, r_tid, r_cid, r_slot, s_lo0,
                        potential, wave_idx, clock, wm)


def _commit_loop_plain(sub, store: MVStore, inputs: CommitInputs, *,
                       sched: str, n_nodes: int, gc_track: bool,
                       gc_block: bool):
    """The commit loop of one wave as T Python steps over ``sub``, updating
    ``store`` in place: the only Python copy of the concurrency-control
    rules, and the plain version of the ``commit_loop`` kernel.  Returns
    ``(status, s_arr, c_arr [T], wcid [T, O], clk, evicted)``."""
    (wave, pkeys, r_val, r_tid, r_cid, r_slot, s_lo0, potential, wave_idx,
     clock, wm) = inputs
    dev = store.device
    T, O = wave.op_kind.shape
    track_gc = gc_track or gc_block
    kind, keys, host = wave.op_kind, wave.op_key, wave.host
    is_read, is_write = _op_masks(kind)
    clock0 = clock          # wave-entry clock = snapshot time for clocked scheds

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
    return status, s_arr, c_arr, wcid, clk, evicted


def run_wave_on(sub, store: MVStore, wave: Wave, wave_idx, clock,
                n_nodes=8, sched: str = "postsi", host_skew=None,
                watermark=None, gc_track: bool = False,
                gc_block: bool = False,
                placement: PlacementArrays | None = None,
                ) -> Tuple[MVStore, WaveOut, torch.Tensor]:
    """Execute one wave on a data-access substrate, updating ``store`` in
    place: the read phase (``wave_read_phase``), the commit loop
    (``sub.commit_loop``: the ``commit_loop`` kernel on the ``cuda``
    routes, ``_commit_loop_plain`` on ``torch``) and the statistics.
    ``wave`` holds tensors on the store's device; ``wave_idx`` and
    ``clock`` are ints or int32 scalars.  Returns (store, out, clock').

    ``placement`` translates logical keys once (``pkeys = slot[key]``, the
    store row every substrate access uses); locality (dsi remoteness,
    clocksi node skew, msgs_cross) stays the logical ``key % n_nodes``."""
    if sched not in SCHEDULERS:
        raise ValueError(f"unknown scheduler {sched!r}; expected one of "
                         f"{SCHEDULERS}")
    dev = store.device
    T = wave.op_kind.shape[0]
    inputs = wave_read_phase(sub, store, wave, wave_idx, clock, sched=sched,
                             host_skew=host_skew, watermark=watermark,
                             placement=placement)
    kind, keys, host = wave.op_kind, wave.op_key, wave.host
    is_read, is_write = _op_masks(kind)
    read_key = torch.where(is_read, keys, -1)
    read_cid = torch.where(is_read, inputs.r_cid, -1)

    status, s_arr, c_arr, wcid, clk, evicted = sub.commit_loop(
        store, inputs, sched=sched, n_nodes=n_nodes, gc_track=gc_track,
        gc_block=gc_block)

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
        edge = inputs.potential & committed[None, :]
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
        msgs_coord = torch.full((), 2 * T, dtype=torch.int32,
                                device=dev)            # begin + end, per txn
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
    hs = None if host_skew is None else _h2d(host_skew, dev)
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


class StagedBlock(NamedTuple):
    """A block of B waves on the store's device, put there without a host
    wait (``stage_block``)."""
    wave: Wave                     # [B, T, O] / [B, T] int32 fields
    wave_idx: torch.Tensor         # [B] int32 wave index of each wave
    watermark: torch.Tensor | None  # int32 scalar, None: each entry clock
    host: torch.Tensor | None      # the page-locked buffer copied from


_BLOCK_FIELDS = len(Wave._fields)


def _pad4(n: int) -> int:
    return -(-n // 4) * 4          # ints: every field starts 16-byte aligned


def _layout(shapes):
    """(offsets, sizes) of the fields of ``shapes`` in one staging buffer."""
    sizes = [int(np.prod(sh)) for sh in shapes]
    return np.cumsum([0] + [_pad4(n) for n in sizes]).tolist(), sizes


def staged_inputs(blk: StagedBlock) -> Wave:
    """The wave fields of a staged block as numpy int32 arrays in host
    memory, read from its page-locked buffer (``blk.host``) and never
    copied back from the device; on the CPU the block itself."""
    if blk.host is None:
        return Wave(*(f.numpy() for f in blk.wave))
    shapes = [tuple(f.shape) for f in blk.wave]
    offs, sizes = _layout(shapes)
    h = blk.host.numpy()
    return Wave(*(h[offs[k]:offs[k] + sizes[k]].reshape(shapes[k])
                  for k in range(_BLOCK_FIELDS)))


def stage_block(waves, wave_idx0: int, watermark=None,
                device=None) -> StagedBlock:
    """Put a block of B waves, their wave indices ``wave_idx0 ... +B-1``
    and the GC ``watermark`` (an int, or ``None``) on ``device``.

    ``waves`` is a list of B waves or one wave whose leaves carry a leading
    [B] axis.  Tensors on the device are stacked there.  Host
    arrays are written straight into one int32 buffer, the stacking
    included, and the buffer crosses to the device in one copy: on a CUDA
    device the buffer is page-locked and the copy asynchronous, so the host
    does not wait for the work queued before it.  The caller keeps the
    returned block, whose ``host`` is that buffer, until the block's
    outcomes are read.  On the CPU the buffer is the block itself."""
    dev = resolve_device(device)
    stacked = not isinstance(waves, list)
    first = waves if stacked else waves[0]
    if (isinstance(first[0], torch.Tensor)
            and first[0].device.type == dev.type):
        fields = (waves if stacked
                  else [torch.stack(f) for f in zip(*waves)])
        wave = Wave(*(f.to(device=dev, dtype=torch.int32) for f in fields))
        B = wave.op_kind.shape[0]
        wm = None if watermark is None else _scalar(watermark, dev)
        return StagedBlock(wave, torch.arange(
            wave_idx0, wave_idx0 + B, dtype=torch.int32, device=dev), wm,
            None)
    as_np = lambda a: np.asarray(a.cpu() if isinstance(a, torch.Tensor)
                                 else a)
    if stacked:
        fields = [[as_np(f)] for f in waves]
        B = fields[0][0].shape[0]
    else:
        fields = [[as_np(f)[None] for f in col] for col in zip(*waves)]
        B = len(waves)
    shapes = [(B, *col[0].shape[1:]) for col in fields] + [(B,), ()]
    offs, sizes = _layout(shapes)
    host = torch.empty(offs[-1], dtype=torch.int32,
                       pin_memory=dev.type == "cuda")
    h = host.numpy()

    def view(buf, k):
        return buf[offs[k]:offs[k] + sizes[k]].reshape(shapes[k])

    for k, col in enumerate(fields):
        np.concatenate(col, out=view(h, k), casting="unsafe")
    h[offs[_BLOCK_FIELDS]:offs[_BLOCK_FIELDS] + B] = np.arange(
        wave_idx0, wave_idx0 + B)
    h[offs[_BLOCK_FIELDS + 1]] = 0 if watermark is None else int(watermark)
    buf = host.to(dev, non_blocking=True) if dev.type == "cuda" else host
    return StagedBlock(
        Wave(*(view(buf, k) for k in range(_BLOCK_FIELDS))),
        view(buf, _BLOCK_FIELDS),
        None if watermark is None else view(buf, _BLOCK_FIELDS + 1),
        host if dev.type == "cuda" else None)


def _run_stacked(sub, store, blk: StagedBlock, clock, **kw):
    """Run the [B] waves of ``blk`` back to back on the device (no host
    sync); returns (store, WaveOut with a leading [B] axis, clock')."""
    outs = []
    for b in range(blk.wave.op_kind.shape[0]):
        store, out, clock = run_wave_on(
            sub, store, Wave(*(f[b] for f in blk.wave)), blk.wave_idx[b],
            clock, watermark=blk.watermark, **kw)
        outs.append(out)
    return store, WaveOut(*(torch.stack(f) for f in zip(*outs))), clock


def _run_fused(sub, store, blk: StagedBlock, **kw):
    """Every wave of ``blk`` from clock 1 with no host sync between them,
    then one copy of the stacked outcomes: (store, history, stats)."""
    store, outs, _ = _run_stacked(sub, store, blk, _scalar(1, store.device),
                                  **kw)
    outs = _out_to_numpy(outs)
    tids = blk.wave.tid.cpu().numpy()
    history = [(tids[i], WaveOut(*(f[i] for f in outs)))
               for i in range(tids.shape[0])]
    return store, history, _stats_of(history)


def run_workload_fused(store: MVStore, waves, sched: str = "postsi",
                       host_skew=None, n_nodes: int = 8,
                       gc_track: bool = False, gc_block: bool = False,
                       kernels: KernelConfig | str | None = None,
                       placement=None):
    """Fused driver: the whole workload with no host sync between waves
    and one copy of the stacked outcomes at the end.  Same (store, history,
    stats) contract as ``run_workload``, bit-identical history."""
    blk = stage_block(list(waves), 1, None, store.device)
    sub, hs, pl = _prepare(store, kernels, host_skew, placement)
    return _run_fused(sub, store, blk, n_nodes=n_nodes, sched=sched,
                      host_skew=hs, gc_track=gc_track, gc_block=gc_block,
                      placement=pl)


def _as_staged(store: MVStore, stacked, wave_idx0, watermark) -> StagedBlock:
    """``stacked`` if it is a ``StagedBlock`` (which carries its own wave
    indices and watermark), else staged on the store's device."""
    if isinstance(stacked, StagedBlock):
        if wave_idx0 is not None or watermark is not None:
            raise ValueError("a StagedBlock carries its own wave indices "
                             "and watermark")
        return stacked
    return stage_block(stacked, wave_idx0, watermark, store.device)


def run_block(store: MVStore, stacked, wave_idx0, clock,
              *, sched: str = "postsi", n_nodes: int = 8, host_skew=None,
              watermark=None, gc_track: bool = True, gc_block: bool = False,
              kernels: KernelConfig | str | None = None, placement=None):
    """Run a block of B formed waves back to back, in place, and return
    device-resident results ``(store, outs, clock')`` — ``outs`` is a
    ``WaveOut`` whose every leaf carries the [B] axis.

    ``stacked`` is a ``StagedBlock`` (``stage_block``), which carries its
    own wave indices and watermark (``wave_idx0`` and ``watermark`` are
    then ``None``), or anything ``stage_block`` takes, staged here with
    ``wave_idx0`` and ``watermark`` (``None``: each wave's entry clock,
    else one watermark for every wave of the block).  On a CUDA device
    nothing here waits on the device: the host arrays cross through
    page-locked memory and ``clock`` may be an int or a device scalar; a
    caller that passes host arrays keeps nothing alive, a caller that
    passes a ``StagedBlock`` keeps it until it reads ``outs``."""
    blk = _as_staged(store, stacked, wave_idx0, watermark)
    sub, hs, pl = _prepare(store, kernels, host_skew, placement)
    return _run_stacked(sub, store, blk, _scalar(clock, store.device),
                        n_nodes=n_nodes, sched=sched, host_skew=hs,
                        gc_track=gc_track, gc_block=gc_block, placement=pl)


def step_block(store: MVStore, stacked: Wave, wave_idx0: int, clock, **kw):
    """Synchronous block step: ``run_block`` + host sync of the per-wave
    outcomes.  Returns ``(store, outs_np, clock')``."""
    store, outs, clock = run_block(store, stacked, wave_idx0, clock, **kw)
    return store, _out_to_numpy(outs), clock
