"""History verifiers — the paper's correctness conditions, checked post-hoc
(a copy of ``repro.core.verify`` that also takes torch tensors: every array
leaf goes through ``.cpu().numpy()`` first).

The engine emits full histories (per-txn status, induced interval, read/write
sets with version CIDs).  We verify, in numpy on the host:

* ``verify_si`` — Definition 4 / Theorem 1: committed writers of the same key
  have pairwise-disjoint intervals, and every committed reader observed the
  snapshot at its start time (each read returned the newest committed version
  with CID <= s).
* ``verify_cv`` — Definition 5: atomic visibility (never partial) and no lost
  updates (every committed RMW read the version it overwrote).

These run over histories from *any* scheduler, so they double as differential
tests: postsi/si/dsi histories must pass verify_si; cv must pass verify_cv.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

COMMITTED = 1


def _np(a) -> np.ndarray:
    """A numpy view of a numpy array, a torch tensor on any device, or an
    array-like."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _collect(history, base_store=None):
    """Flatten wave outputs into per-txn records and per-key version lists.

    ``base_store`` seeds the version lists from a store's version rings —
    the committed-version set at a recovery snapshot boundary (DESIGN.md
    §9).  A post-restart history is a *suffix*: its reads may legally
    return versions committed before the snapshot, which the suffix alone
    cannot name.  The ring retains exactly the versions still readable at
    the boundary (anything evicted is below the GC watermark, which no
    later snapshot may take), so seeding makes the snapshot-read check
    sound on suffix histories."""
    txns = []        # (tid, s, c, reads[(k,cid)], writes[(k,cid)])
    versions = defaultdict(list)   # key -> [(cid, tid)]
    for tids, out in history:
        tids = _np(tids)
        if isinstance(out, tuple):     # a WaveOut of tensors; a sequential
            out = type(out)(*(_np(f) for f in out))   # history is numpy
        for i in range(len(tids)):
            if out.status[i] != COMMITTED:
                continue
            reads = [(int(k), int(c)) for k, c in zip(out.read_key[i], out.read_cid[i])
                     if k >= 0]
            writes = [(int(k), int(c)) for k, c in zip(out.write_key[i], out.write_cid[i])
                      if k >= 0]
            txns.append((int(tids[i]), int(out.s[i]), int(out.c[i]), reads, writes))
            for k, c in writes:
                versions[k].append((c, int(tids[i])))
    if base_store is not None:
        get = (base_store.get if isinstance(base_store, dict)
               else lambda f: getattr(base_store, f))
        cid = _np(get("cid"))
        tid = _np(get("tid"))
        for k, v in zip(*np.nonzero(cid > 0)):
            versions[int(k)].append((int(cid[k, v]), int(tid[k, v])))
    for k in versions:
        versions[k].sort()
        versions[k].insert(0, (0, 0))      # bootstrap version
    return txns, versions


def verify_si(history, base_store=None) -> List[str]:
    """Return a list of SI violations (empty == the schedule is SI).
    ``base_store`` makes suffix histories (post-recovery) checkable — see
    ``_collect``."""
    txns, versions = _collect(history, base_store)
    errors = []

    # (1) writers of the same key: pairwise-disjoint intervals
    by_key_writers = defaultdict(list)
    for tid, s, c, reads, writes in txns:
        for k, cid in writes:
            by_key_writers[k].append((c, s, tid))
    for k, ws in by_key_writers.items():
        ws.sort()
        for (c1, s1, t1), (c2, s2, t2) in zip(ws, ws[1:]):
            if s2 < c1:   # overlap: both modified k while concurrent
                errors.append(f"ww-overlap key={k}: t{t1}(s={s1},c={c1}) vs "
                              f"t{t2}(s={s2},c={c2})")

    # (2) snapshot reads: read(k) == newest committed version with cid <= s
    for tid, s, c, reads, writes in txns:
        own = dict(writes)
        for k, cid_ret in reads:
            cands = [cv for cv, ct in versions.get(k, [(0, 0)]) if cv <= s]
            expect = max(cands) if cands else 0
            if cid_ret != expect:
                # a txn may read a version it later overwrote; reads happen at
                # wave start, so own writes never appear in the read set
                errors.append(f"non-snapshot read t{tid} key={k}: got cid="
                              f"{cid_ret}, snapshot@s={s} expects {expect}")
    return errors


def verify_cv(history, base_store=None) -> List[str]:
    """Consistent Visibility: atomic visibility + no lost updates.
    ``base_store`` seeds pre-snapshot versions for suffix histories (the
    atomic-visibility pairing still only spans suffix writers — ring
    entries carry no write-sets)."""
    txns, versions = _collect(history, base_store)
    errors = []

    # no lost updates: a committed RMW must have read the version directly
    # below the one it installed
    for tid, s, c, reads, writes in txns:
        rk = dict(reads)
        for k, cid in writes:
            if k in rk:
                vs = [cv for cv, _ in versions[k] if cv < cid]
                below = max(vs) if vs else 0
                if rk[k] != below:
                    errors.append(f"lost-update t{tid} key={k}: read cid={rk[k]}"
                                  f" but overwrote cid={below}")

    # atomic visibility: for every writer i and reader j, j sees either all or
    # none of i's writes (among keys j read)
    writers = [(tid, dict(writes)) for tid, s, c, reads, writes in txns if writes]
    for tid_j, s, c, reads, writes in txns:
        if not reads:
            continue
        rd = dict(reads)
        for tid_i, wr in writers:
            if tid_i == tid_j:
                continue
            shared = [k for k in rd if k in wr]
            if len(shared) < 2:
                continue
            saw = [rd[k] >= wr[k] for k in shared]
            if any(saw) and not all(saw):
                errors.append(f"partial visibility: t{tid_i} -> t{tid_j} over "
                              f"keys {shared}")
    return errors


def final_values_ok(store, history, n_keys: int) -> List[str]:
    """Replay committed effects in commit order; compare with store state."""
    txns, versions = _collect(history)
    expect = np.zeros(n_keys, np.int64)
    # apply writes in cid order per key: newest value should match store head
    newest = {}
    for tid, s, c, reads, writes in txns:
        for k, cid in writes:
            if k not in newest or cid > newest[k][0]:
                newest[k] = (cid, tid)
    errors = []
    cid = _np(store.cid)
    head = _np(store.head)
    for k, (cmax, tid) in newest.items():
        got = cid[k, head[k]]
        if got != cmax:
            errors.append(f"store head key={k}: cid {got} != expected {cmax}")
    return errors
