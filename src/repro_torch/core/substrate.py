"""Data-access substrate: the engine/placement seam (port of
``repro.core.substrate``).

``engine._commit_loop_plain`` holds the only Python copy of the
concurrency-control rules; everything the rule arithmetic needs from the
data plane — the read phase, the commit-phase re-validation read, the
version install, the SID bump and the GC watermark consult — goes through
the interface below, and so does the whole commit loop of a wave
(``commit_loop``).

``LocalSubstrate`` keeps the whole key space in one store: every access is
direct indexing or a masked scatter, and the installs and SID bumps update
the store IN PLACE.  It carries a resolved ``KernelConfig`` and dispatches
the slot selection (``ops.version_scan``), the anti-dependency build
(``commit_phase.build_potential``), the fused read phase
(``ops.wave_commit``) and the commit loop (``ops.commit_loop``: one
kernel launch per wave on ``cuda``, the plain loop on ``torch``) through
the kernel plane.  A ``cuda`` config on a CPU store raises at
construction.

``MeshSubstrate`` is the paper's shared-nothing cluster on one device: the
reference's ``("node",)`` mesh axis becomes the leading dimension of a
``[N, n_local, ...]`` view of each store field, so node ``i``'s block is a
view into the one global store.  Every method maps global keys to local
rows and delegates to a ``LocalSubstrate`` on each block; reads keep the
owner's answer and merge by a sum over the node dimension (the reference's
``psum``), installs and SID bumps apply on the owner only.

``GroupMeshSubstrate`` is the same cluster across processes: one
``torch.distributed`` rank a node, each holding only its own block of the
store on its own device (``dist_engine.ProcessMesh``).  Its reads answer
from the block and merge by ``all_reduce`` (SUM for the owner-keeps
answers, MAX for the fused read phase's ``s_lo0``), the reference's
``psum`` and ``pmax``; there is no coordinator.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels import KernelConfig, ops, resolve, resolve_device
from .commit_phase import build_potential
from .store import INF, MVStore
from . import store as store_ops


def mesh_kernels(kernels: KernelConfig | str | None = None,
                 device=None) -> KernelConfig:
    """The config a ``MeshSubstrate`` runs: ``kernels`` resolved against
    ``device`` and checked to run there, as for ``LocalSubstrate``.  The
    reference degrades a compiled-kernel request to its plain route where
    the kernels cannot compile; the port never does: a ``cuda`` config
    over CPU tensors raises."""
    return resolve(kernels, resolve_device(device))


def effective_mesh_backend(kernels: KernelConfig | str | None = None,
                           device=None) -> str:
    """The route the mesh runs under this request: the resolved name,
    always, since nothing degrades (kept under the reference's name for
    the benchmarks that label their mesh rows with it)."""
    return mesh_kernels(kernels, device).name


def mesh_degrade_count() -> int:
    """Times the mesh served a kernel request by another route: 0, since
    the port raises instead (kept under the reference's name for the
    benchmarks that report it)."""
    return 0


def _step_parts(sub, store: MVStore, keys, slots, watermark):
    """``step_reads``' answers on one store as a tuple of int32 tensors
    shaped like ``keys``: the newest version's five fields, then the SIDs
    at ``slots`` and the eviction flags where asked for."""
    parts = list(sub.read_newest(store, keys))
    if slots is not None:
        parts.append(sub.read_sid(store, keys, slots))
    if watermark is not None:
        parts.append(sub.evicting_visible(store, keys, watermark).to(
            torch.int32))
    return tuple(parts)


def _step_split(parts, slots, watermark):
    """``_step_parts``' tuple back into ``step_reads``' answer."""
    return (tuple(parts[:5]), parts[5] if slots is not None else None,
            parts[-1].bool() if watermark is not None else None)


class LocalSubstrate:
    """Direct-indexing data plane: the whole key space lives in one store."""

    def __init__(self, kernels: KernelConfig | str | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.kernels = resolve(kernels, self.device)

    def read_visible(self, store: MVStore, keys, max_cid):
        """Latest version with CID <= max_cid per key (paper §IV-B read
        rule).  Returns (val, tid, cid, sid, slot), shaped like ``keys``.

        Slot selection runs through ``ops.version_scan``, which gathers the
        ring rows itself from the store tables; masked/NOP keys (possibly
        negative padding) are clamped so they can never wrap to the last
        key.  All-invisible rows report the raw fields of slot 0."""
        k = keys.clamp(0, store.n_keys - 1)
        mc = torch.broadcast_to(max_cid, k.shape).contiguous()
        slot, _ = ops.version_scan(store.cid, store.tid, mc.reshape(-1),
                                   keys=k.reshape(-1).contiguous(),
                                   use_kernel=self.kernels.use_kernel)
        slot = slot.reshape(k.shape)
        cell = k.long() * store.n_versions + slot
        return (store.val.take(cell), store.tid.take(cell),
                store.cid.take(cell), store.sid.take(cell), slot)

    def read_newest(self, store: MVStore, keys):
        """Newest committed version (PostSI reads start with s_hi = +inf):
        the plain commit loop's per-step read, one ``ops.version_scan``
        call.  The ``commit_loop`` kernel runs the same scan inside its
        launch."""
        return self.read_visible(store, keys, torch.full_like(keys, INF))

    def read_sid(self, store: MVStore, keys, slots):
        """Re-gather SIDs of previously read (key, slot) pairs — peers may
        have bumped them since the read phase (rule 4(a) input)."""
        return ops.sid_regather(store.sid, keys, slots)

    def key_staleness(self, store: MVStore, keys):
        """Per-key (last-commit wave tag, head CID) — the clocksi stale-read
        cutoff inputs.  NOP/padding keys are clamped."""
        k = keys.clamp(0, store.n_keys - 1).long()
        return (store.wave.take(k),
                store.cid.take(k * store.n_versions + store.head.take(k)))

    def evicting_visible(self, store: MVStore, keys, watermark):
        """Would installing into ``keys`` evict a version still visible
        above the GC watermark?  (``store.evicting_visible``)."""
        return store_ops.evicting_visible(store, keys, watermark)

    def step_reads(self, store: MVStore, keys, slots=None, watermark=None):
        """A commit step's reads of the store, all made before its
        installs, in one call: ``(read_newest, read_sid at slots,
        evicting_visible under watermark)``, the last two ``None`` where
        ``slots`` / ``watermark`` is ``None``.  A mesh merges them at
        once."""
        return (self.read_newest(store, keys),
                None if slots is None else self.read_sid(store, keys, slots),
                None if watermark is None
                else self.evicting_visible(store, keys, watermark))

    def install(self, store: MVStore, mask, keys, values, tid, cid,
                wave_idx):
        """Masked version install, in place (``ops.masked_install``)."""
        ops.masked_install(*store, mask=mask, keys=keys, values=values,
                           new_tid=tid, new_cid=cid, wave_idx=wave_idx)
        return store

    def bump_sid(self, store: MVStore, mask, keys, slots, expect_tid, s_val):
        """Rule 4(c) SID bump, in place (``ops.masked_sid_bump``)."""
        ops.masked_sid_bump(store.sid, store.tid, mask=mask, keys=keys,
                            slots=slots, expect_tid=expect_tid, s_val=s_val)
        return store

    def commit_loop(self, store: MVStore, inputs, *, sched: str,
                    n_nodes: int, gc_track: bool, gc_block: bool):
        """The commit loop of one wave, updating ``store`` in place
        (``inputs``: an ``engine.CommitInputs``).  On a ``cuda`` config ONE
        launch of the ``commit_loop`` kernel; on ``torch`` the plain loop
        (``engine._commit_loop_plain``).  Returns ``(status, s_arr, c_arr,
        wcid, clk, evicted)``, bit-identical either way."""
        return ops.commit_loop(store, inputs, sched=sched, n_nodes=n_nodes,
                               gc_track=gc_track, gc_block=gc_block,
                               use_kernel=self.kernels.use_kernel)

    def build_potential(self, keys, is_read, is_write):
        """Anti-dependency candidate matrix [T, T] bool."""
        return build_potential(keys, is_read, is_write, backend=self.kernels)

    def read_phase(self, store: MVStore, keys, max_cid, is_read, is_write):
        """The whole wave read phase: latest-visible slot selection, the
        PostSI rule-3 seed ``s_lo0`` and the anti-dependency build.
        Returns ``(r_val, r_tid, r_cid, r_sid, r_slot, s_lo0 [T],
        potential [T, T] bool)``.

        With ``kernels.fused`` this is ONE ``ops.wave_commit`` call over the
        store tables; otherwise three dispatches.  Bit-identical either
        way."""
        mc = torch.broadcast_to(max_cid, keys.shape).contiguous()
        if not self.kernels.fused:
            r_val, r_tid, r_cid, r_sid, r_slot = self.read_visible(
                store, keys, mc)
            s_lo0 = torch.where(is_read, r_cid, 0).max(dim=1).values
            pot = self.build_potential(keys, is_read, is_write)
            return r_val, r_tid, r_cid, r_sid, r_slot, s_lo0, pot
        k = keys.clamp(0, store.n_keys - 1).contiguous()
        slot, r_val, r_tid, r_cid, r_sid, s_lo0, pot = ops.wave_commit(
            store.cid, store.tid, store.sid, store.val, mc,
            torch.where(is_read, keys, -1), torch.where(is_write, keys, -1),
            is_read.contiguous(), keys=k, use_kernel=self.kernels.use_kernel)
        return r_val, r_tid, r_cid, r_sid, slot, s_lo0, pot.view(torch.bool)


class MeshSubstrate:
    """Peer-merge data plane for a store block-partitioned over ``n_nodes``
    emulated nodes (node = row // n_local, n_local = n_slots / n_nodes).

    The store keeps its global shape ``[n_slots, ...]``; node ``i``'s block
    is the view ``f.view(N, n_local, ...)[i]`` of each field, itself a
    complete ``MVStore`` with ``n_keys == n_local``.  All key arguments are
    GLOBAL rows.  There is no second copy of the data-plane logic: every
    method maps the keys to local rows (``lk = keys - i * n_local``,
    ``mine = 0 <= lk < n_local``, ``lk`` clamped) and delegates to a
    ``LocalSubstrate`` carrying the same ``KernelConfig`` on each block.
    Reads keep the owner's answer (others give 0) and merge by a sum over
    the node dimension, the reference's ``psum``; installs and SID bumps
    run on every block with ``mask & mine``, so only the owner writes, in
    place in the global store.  A key no node owns (a negative pad) reads
    0 and writes nothing.

    The read-phase kernels run on each node's block: ``version_scan`` once
    a node per read, ``wave_commit`` once a node per fused read phase.  The
    potential matrix depends on the GLOBAL keys only, so it is the same on
    every node: the unfused route builds it once, the fused route keeps
    node 0's copy of the ones every ``wave_commit`` launch computes.  The
    commit loop is the plain loop (``engine._commit_loop_plain``) over this
    substrate, as the reference runs ``commit_one`` steps with per-step
    merges; the ``commit_loop`` kernel is not used on the mesh."""

    def __init__(self, n_nodes: int, kernels: KernelConfig | str | None = None,
                 device=None):
        if n_nodes < 1:
            raise ValueError(f"MeshSubstrate: n_nodes={n_nodes} < 1")
        self.n_nodes = int(n_nodes)
        self.device = resolve_device(device)
        self.kernels = mesh_kernels(kernels, self.device)
        self._local_sub = LocalSubstrate(self.kernels, self.device)
        self._layout = None        # (store fields, blocks, bases, n_local)

    # ------------------------------------------------------------ helpers
    def _blocks(self, store: MVStore):
        """(per-node block stores, [N] int32 block bases, n_local), kept
        while the store's field tensors stay the same (they are updated in
        place)."""
        lay = self._layout
        if lay is None or any(a is not b for a, b in zip(lay[0], store)):
            N = self.n_nodes
            if store.n_keys % N:
                raise ValueError(f"MeshSubstrate: {store.n_keys} rows do not "
                                 f"divide over {N} nodes (shard_store pads)")
            n_local = store.n_keys // N
            views = [f.view(N, n_local, *f.shape[1:]) for f in store]
            blocks = [MVStore(*(v[i] for v in views)) for i in range(N)]
            bases = torch.arange(N, dtype=torch.int32,
                                 device=store.device) * n_local
            lay = self._layout = (tuple(store), blocks, bases, n_local)
        return lay[1:]

    def _local(self, store: MVStore, keys):
        """(blocks, lk [N, *keys.shape] clamped local rows, mine [N, ...]
        owner mask) for GLOBAL ``keys``: every node's view at once."""
        blocks, bases, n_local = self._blocks(store)
        lk = keys.unsqueeze(0) - bases.view(-1, *([1] * keys.dim()))
        mine = (lk >= 0) & (lk < n_local)
        return blocks, lk.clamp(0, n_local - 1), mine

    @staticmethod
    def _merge(mine, answers):
        """``answers[i]``: node i's tuple of int32 answers shaped like its
        keys.  The owner keeps its answer, the others give 0, and a sum
        over the node dimension merges them (the reference's psum)."""
        n_parts = len(answers[0])
        stacked = torch.stack([p for a in answers for p in a]).view(
            len(answers), n_parts, *mine.shape[1:])
        merged = torch.where(mine.unsqueeze(1), stacked, 0).sum(
            0, dtype=torch.int32)
        return tuple(merged.unbind(0))

    # -------------------------------------------------------------- reads
    def read_visible(self, store: MVStore, keys, max_cid):
        blocks, lk, mine = self._local(store, keys)
        return self._merge(mine, [
            self._local_sub.read_visible(b, lk[i], max_cid)
            for i, b in enumerate(blocks)])

    def read_newest(self, store: MVStore, keys):
        return self.read_visible(store, keys, torch.full_like(keys, INF))

    def read_sid(self, store: MVStore, keys, slots):
        blocks, lk, mine = self._local(store, keys)
        (sid,) = self._merge(mine, [
            (self._local_sub.read_sid(b, lk[i], slots),)
            for i, b in enumerate(blocks)])
        return sid

    def key_staleness(self, store: MVStore, keys):
        blocks, lk, mine = self._local(store, keys)
        return self._merge(mine, [self._local_sub.key_staleness(b, lk[i])
                                  for i, b in enumerate(blocks)])

    def evicting_visible(self, store: MVStore, keys, watermark):
        blocks, lk, mine = self._local(store, keys)
        (ev,) = self._merge(mine, [
            (self._local_sub.evicting_visible(b, lk[i], watermark).to(
                torch.int32),) for i, b in enumerate(blocks)])
        return ev.bool()

    def step_reads(self, store: MVStore, keys, slots=None, watermark=None):
        """A commit step's reads on every node, merged in one sum."""
        blocks, lk, mine = self._local(store, keys)
        return _step_split(self._merge(mine, [
            _step_parts(self._local_sub, b, lk[i], slots, watermark)
            for i, b in enumerate(blocks)]), slots, watermark)

    # ------------------------------------------------------------- writes
    def install(self, store: MVStore, mask, keys, values, tid, cid,
                wave_idx):
        blocks, lk, mine = self._local(store, keys)
        for i, b in enumerate(blocks):
            self._local_sub.install(b, mask & mine[i], lk[i], values, tid,
                                    cid, wave_idx)
        return store

    def bump_sid(self, store: MVStore, mask, keys, slots, expect_tid, s_val):
        blocks, lk, mine = self._local(store, keys)
        for i, b in enumerate(blocks):
            self._local_sub.bump_sid(b, mask & mine[i], lk[i], slots,
                                     expect_tid, s_val)
        return store

    def commit_loop(self, store: MVStore, inputs, *, sched: str,
                    n_nodes: int, gc_track: bool, gc_block: bool):
        """The plain commit loop over this substrate: every step's reads,
        installs and SID bumps go through the nodes' blocks (on ``cuda``
        one ``version_scan`` launch a node a step)."""
        from .engine import _commit_loop_plain
        return _commit_loop_plain(self, store, inputs, sched=sched,
                                  n_nodes=n_nodes, gc_track=gc_track,
                                  gc_block=gc_block)

    def build_potential(self, keys, is_read, is_write):
        """The [T, T] matrix from the GLOBAL keys: the same on every node,
        so built once."""
        return build_potential(keys, is_read, is_write, backend=self.kernels)

    def read_phase(self, store: MVStore, keys, max_cid, is_read, is_write):
        """Mesh twin of ``LocalSubstrate.read_phase``.  Fused route: each
        node runs ``ops.wave_commit`` over its block with ``rvalid =
        is_read & mine`` and the GLOBAL read and write keys; the slot
        fields merge by the owner-keeps sum and the per-node ``s_lo0``
        maxima by a max over nodes (every contribution is a CID >= 0).
        Every node computes the same potential matrix; node 0's is kept."""
        mc = torch.broadcast_to(max_cid, keys.shape).contiguous()
        if not self.kernels.fused:
            r_val, r_tid, r_cid, r_sid, r_slot = self.read_visible(
                store, keys, mc)
            s_lo0 = torch.where(is_read, r_cid, 0).max(dim=1).values
            pot = self.build_potential(keys, is_read, is_write)
            return r_val, r_tid, r_cid, r_sid, r_slot, s_lo0, pot
        blocks, lk, mine = self._local(store, keys)
        read_key = torch.where(is_read, keys, -1)
        write_key = torch.where(is_write, keys, -1)
        outs = [ops.wave_commit(b.cid, b.tid, b.sid, b.val, mc, read_key,
                                write_key, is_read & mine[i], keys=lk[i],
                                use_kernel=self.kernels.use_kernel)
                for i, b in enumerate(blocks)]
        slot, r_val, r_tid, r_cid, r_sid = self._merge(
            mine, [o[:5] for o in outs])
        s_lo0 = torch.stack([o[5] for o in outs]).max(dim=0).values
        return (r_val, r_tid, r_cid, r_sid, slot, s_lo0,
                outs[0][6].view(torch.bool))


class GroupMeshSubstrate:
    """Peer-merge data plane of ONE rank of a process-group node mesh
    (``dist_engine.ProcessMesh``): the counterpart of the reference's
    ``MeshSubstrate`` on real devices, where the emulated ``MeshSubstrate``
    above keeps every node on one device.

    The store it is handed is this rank's block of ``n_local`` rows, and
    its base row is ``rank * n_local``; all key arguments are GLOBAL rows.
    Every method maps the keys to local rows (``lk = keys - base``,
    ``mine = 0 <= lk < n_local``, ``lk`` clamped) and delegates to a
    ``LocalSubstrate`` on the block.  Reads give 0 for the rows the rank
    does not own, the parts are stacked into one int32 tensor and one
    ``all_reduce(SUM)`` over the mesh's group merges them (the reference's
    ``psum``); a key no rank owns (-1, a pad) reads 0.  Installs and SID
    bumps are masked to the owner and stay local.  The fused read phase
    runs ``ops.wave_commit`` on the block with ``rvalid = is_read & mine``;
    its slot fields merge as above and ``s_lo0`` by ``all_reduce(MAX)``
    (the reference's ``pmax``).  The potential matrix depends on the GLOBAL
    keys only: every rank builds it, as every reference node does, and it
    is not merged.  The commit loop is the plain loop
    (``engine._commit_loop_plain``) with a merge at every step; the
    ``commit_loop`` kernel is not used on a mesh.

    Every rank must make the same calls in the same order (the engine's
    drivers do: the transaction state is replicated), since each read is a
    collective."""

    def __init__(self, pmesh, kernels: KernelConfig | str | None = None):
        self.n_nodes = pmesh.n_nodes
        self.rank = pmesh.rank
        self.group = pmesh.group
        self.device = pmesh.device
        self.kernels = mesh_kernels(kernels, self.device)
        self._local_sub = LocalSubstrate(self.kernels, self.device)

    # ------------------------------------------------------------ helpers
    def _local(self, store: MVStore, keys):
        """(lk clamped local rows, mine owner mask) of GLOBAL ``keys`` on
        this rank's block."""
        n_local = store.n_keys
        lk = keys - self.rank * n_local
        mine = (lk >= 0) & (lk < n_local)
        return lk.clamp(0, n_local - 1), mine

    def _merge(self, mine, parts):
        """This rank's int32 answers, 0 where it does not own the row,
        stacked and summed over the ranks by one ``all_reduce``."""
        merged = torch.where(mine, torch.stack([p.to(torch.int32)
                                                for p in parts]), 0)
        dist.all_reduce(merged, op=dist.ReduceOp.SUM, group=self.group)
        return tuple(merged.unbind(0))

    # -------------------------------------------------------------- reads
    def read_visible(self, store: MVStore, keys, max_cid):
        lk, mine = self._local(store, keys)
        return self._merge(mine, self._local_sub.read_visible(store, lk,
                                                              max_cid))

    def read_newest(self, store: MVStore, keys):
        return self.read_visible(store, keys, torch.full_like(keys, INF))

    def read_sid(self, store: MVStore, keys, slots):
        lk, mine = self._local(store, keys)
        (sid,) = self._merge(mine, (self._local_sub.read_sid(store, lk,
                                                             slots),))
        return sid

    def key_staleness(self, store: MVStore, keys):
        lk, mine = self._local(store, keys)
        return self._merge(mine, self._local_sub.key_staleness(store, lk))

    def evicting_visible(self, store: MVStore, keys, watermark):
        lk, mine = self._local(store, keys)
        (ev,) = self._merge(mine, (self._local_sub.evicting_visible(
            store, lk, watermark),))
        return ev.bool()

    def step_reads(self, store: MVStore, keys, slots=None, watermark=None):
        """A commit step's reads, merged in ONE ``all_reduce``: a commit
        step costs one collective, whichever of its reads it makes."""
        lk, mine = self._local(store, keys)
        return _step_split(self._merge(mine, _step_parts(
            self._local_sub, store, lk, slots, watermark)), slots, watermark)

    # ------------------------------------------------------------- writes
    def install(self, store: MVStore, mask, keys, values, tid, cid,
                wave_idx):
        lk, mine = self._local(store, keys)
        return self._local_sub.install(store, mask & mine, lk, values, tid,
                                       cid, wave_idx)

    def bump_sid(self, store: MVStore, mask, keys, slots, expect_tid, s_val):
        lk, mine = self._local(store, keys)
        return self._local_sub.bump_sid(store, mask & mine, lk, slots,
                                        expect_tid, s_val)

    def commit_loop(self, store: MVStore, inputs, *, sched: str,
                    n_nodes: int, gc_track: bool, gc_block: bool):
        """The plain commit loop over this substrate: every step's reads
        merge across the ranks (on ``cuda`` one ``version_scan`` launch a
        rank a step)."""
        from .engine import _commit_loop_plain
        return _commit_loop_plain(self, store, inputs, sched=sched,
                                  n_nodes=n_nodes, gc_track=gc_track,
                                  gc_block=gc_block)

    def build_potential(self, keys, is_read, is_write):
        """The [T, T] matrix from the GLOBAL keys, built on every rank."""
        return build_potential(keys, is_read, is_write, backend=self.kernels)

    def read_phase(self, store: MVStore, keys, max_cid, is_read, is_write):
        """Twin of ``MeshSubstrate.read_phase`` for this rank's block: on
        the fused route one ``ops.wave_commit`` on the block, its slot
        fields merged by SUM and ``s_lo0`` by MAX (every contribution is a
        CID >= 0); the potential matrix is this rank's own."""
        mc = torch.broadcast_to(max_cid, keys.shape).contiguous()
        if not self.kernels.fused:
            r_val, r_tid, r_cid, r_sid, r_slot = self.read_visible(
                store, keys, mc)
            s_lo0 = torch.where(is_read, r_cid, 0).max(dim=1).values
            pot = self.build_potential(keys, is_read, is_write)
            return r_val, r_tid, r_cid, r_sid, r_slot, s_lo0, pot
        lk, mine = self._local(store, keys)
        out = ops.wave_commit(store.cid, store.tid, store.sid, store.val, mc,
                              torch.where(is_read, keys, -1),
                              torch.where(is_write, keys, -1),
                              is_read & mine, keys=lk,
                              use_kernel=self.kernels.use_kernel)
        slot, r_val, r_tid, r_cid, r_sid = self._merge(mine, out[:5])
        s_lo0 = out[5].clone()
        dist.all_reduce(s_lo0, op=dist.ReduceOp.MAX, group=self.group)
        return (r_val, r_tid, r_cid, r_sid, slot, s_lo0,
                out[6].view(torch.bool))
