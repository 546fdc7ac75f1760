"""Data-access substrate: the engine/placement seam (port of
``repro.core.substrate``, ``LocalSubstrate`` only).

``engine.run_wave_on`` holds the only copy of the concurrency-control
rules; everything the rule arithmetic needs from the data plane — the read
phase, the commit-phase re-validation read, the version install, the SID
bump and the GC watermark consult — goes through the interface below.

``LocalSubstrate`` keeps the whole key space in one store: every access is
direct indexing or a masked scatter, and the installs and SID bumps update
the store IN PLACE.  It carries a resolved ``KernelConfig`` and dispatches
the slot selection (``ops.version_scan``), the anti-dependency build
(``commit_phase.build_potential``) and the fused read phase
(``ops.wave_commit``) through the kernel plane.  A ``cuda`` config on a CPU
store raises at construction.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import KernelConfig, ops, resolve, resolve_device
from .commit_phase import build_potential
from .store import INF, MVStore
from . import store as store_ops


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
        """Newest committed version (PostSI reads start with s_hi = +inf)."""
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
        return r_val, r_tid, r_cid, r_sid, slot, s_lo0, pot.bool()
