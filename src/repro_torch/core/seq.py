"""Reference (sequential, pure-Python) CV and PostSI schedulers.

The port's own copy of ``repro.core.seq`` (pure Python, numpy only for
``history``): the model plane's ``launch.serve.Server`` runs its weight
publishes and batch snapshots as transactions here.  Kept line for line
with the reference; ``tests/test_torch_serve.py`` holds the two to the same
outcomes on random interleavings.

This is a line-by-line transcription of the paper's rules over *arbitrary
interleavings* — begin/read/write/commit events in any order — used as the
oracle for the vectorized wave engine and for reproducing the paper's worked
examples (Figure 1, Figure 3 Schedules III/IV/V, Figure 5).

CV scheduler (paper §III-C, rules 1-6):
  versions carry creator TID + visitor lists; an anti-dependency table holds
  rw edges among *ongoing* transactions; writes lock (here: private write
  sets, installed at commit per §IV-C) and validate rule 5.

PostSI scheduler (paper §III-D, complementary rules 1-5):
  per-txn bounds s_lo/s_hi/c_lo; rule 3 raises lower bounds on read/overwrite;
  rule 4(a) picks the interval, 4(b) pushes conflicting ongoing txns' bounds,
  4(c) stamps CIDs and bumps SIDs; rule 5 aborts when s_lo > s_hi.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

INF = 2 ** 30


@dataclasses.dataclass
class Version:
    value: int
    tid: int
    cid: int = 0
    sid: int = 0
    visitors: Set[int] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class Txn:
    tid: int
    status: str = "running"            # running | committed | aborted
    s_lo: int = 0
    s_hi: int = INF
    c_lo: int = 0
    s: Optional[int] = None
    c: Optional[int] = None
    reads: Dict[int, int] = dataclasses.field(default_factory=dict)   # key -> version idx
    writes: Dict[int, int] = dataclasses.field(default_factory=dict)  # key -> value (private)


class SeqScheduler:
    """mode='postsi' enforces SI; mode='cv' enforces Consistent Visibility."""

    def __init__(self, n_keys: int, mode: str = "postsi"):
        assert mode in ("postsi", "cv")
        self.mode = mode
        self.versions: Dict[int, List[Version]] = {
            k: [Version(0, 0, 0, 0)] for k in range(n_keys)}
        self.txns: Dict[int, Txn] = {}
        self.antidep: Set[Tuple[int, int]] = set()   # (i, j): t_i -rw-> t_j
        self._next_tid = 1

    # ------------------------------------------------------------------ API
    def begin(self, s_hi_pin: Optional[int] = None) -> int:
        """rule 1: s_lo=0, s_hi=inf, c_lo=0.  ``s_hi_pin`` implements the
        paper's §IV-B retry optimization: after an abort caused by a hot
        remote item, retry with the start-time upper bound pinned at the
        highest CID observed before the abort — the retried transaction then
        refuses versions newer than the pin instead of aborting again."""
        tid = self._next_tid
        self._next_tid += 1
        t = Txn(tid)
        if s_hi_pin is not None:
            t.s_hi = s_hi_pin
        self.txns[tid] = t
        return tid

    def max_observed_cid(self, tid: int) -> int:
        """Highest CID this transaction has encountered (for the retry pin)."""
        t = self.txns[tid]
        best = t.s_lo
        for key, idx in t.reads.items():
            best = max(best, self.versions[key][idx].cid)
        return best

    def read(self, tid: int, key: int) -> Optional[int]:
        """CV rule 4: read the latest *visible* version; PostSI §IV-B: a
        version is invisible if reading it would push s_lo past s_hi."""
        t = self.txns[tid]
        assert t.status == "running"
        if key in t.writes:                 # read-your-own-write
            return t.writes[key]
        chain = self.versions[key]
        for idx in range(len(chain) - 1, -1, -1):
            v = chain[idx]
            # CV rule 4: skip versions by creators I anti-depend on
            if (tid, v.tid) in self.antidep:
                continue
            if self.mode == "postsi" and v.cid > t.s_hi:
                continue                    # CID visibility rule (§IV-B)
            # found the latest visible version
            v.visitors.add(tid)             # visitor list insert (atomic)
            t.reads[key] = idx
            if self.mode == "postsi":       # rule 3: creator must be visible
                t.s_lo = max(t.s_lo, v.cid)
                t.c_lo = max(t.c_lo, v.cid)
                if t.s_lo > t.s_hi:         # rule 5
                    self.abort(tid)
                    return None
            return v.value
        self.abort(tid)                     # no visible version at all
        return None

    def write(self, tid: int, key: int, value: int) -> None:
        """Private write set (§IV-C); locks/validation at commit."""
        t = self.txns[tid]
        assert t.status == "running"
        t.writes[key] = value

    def abort(self, tid: int) -> None:
        t = self.txns[tid]
        t.status = "aborted"
        for key, idx in t.reads.items():
            self.versions[key][idx].visitors.discard(tid)
        self.antidep = {(a, b) for (a, b) in self.antidep if a != tid and b != tid}

    def commit(self, tid: int) -> bool:
        t = self.txns[tid]
        assert t.status == "running"

        # ---- CV rule 5 validation on the write set ----------------------
        for key in t.writes:
            newest = self.versions[key][-1]
            if key in t.reads and t.reads[key] != len(self.versions[key]) - 1:
                self.abort(tid)             # read version is no longer newest
                return False
            if (tid, newest.tid) in self.antidep:
                self.abort(tid)             # rule 5(ii)
                return False
            if self.mode == "postsi":       # rule 3 for overwrites
                t.s_lo = max(t.s_lo, newest.cid)
                t.c_lo = max(t.c_lo, newest.cid)
                # SID of the overwritten version: committed readers' start
                # times are passed to later writers through SIDs (§III-D)
                t.c_lo = max(t.c_lo, newest.sid)

        if self.mode == "postsi":
            if t.s_lo > t.s_hi:             # rule 5
                self.abort(tid)
                return False
            # ---- rule 4(a): determine own interval -----------------------
            t.s = t.s_lo
            for key, idx in t.reads.items():
                t.c_lo = max(t.c_lo, self.versions[key][idx].sid)
            for (i, j) in self.antidep:
                if j == tid and self.txns[i].status == "running":
                    t.c_lo = max(t.c_lo, self.txns[i].s_lo)
            t.c = max(t.c_lo, t.s) + 1
            # ---- rule 4(b): adjust conflicting ongoing transactions ------
            for (i, j) in list(self.antidep):
                if i == tid and self.txns[j].status == "running":
                    # tid -rw-> t_j : t_j invisible to me -> c_j > s_tid
                    self.txns[j].c_lo = max(self.txns[j].c_lo, t.s + 1)
                if j == tid and self.txns[i].status == "running":
                    # t_i -rw-> tid : tid invisible to t_i -> s_i < c_tid
                    self.txns[i].s_hi = min(self.txns[i].s_hi, t.c - 1)
        else:
            t.s, t.c = 0, 0                 # CV induces no timestamps

        # ---- install writes; CV rule 6: materialize rw edges -------------
        for key, value in t.writes.items():
            for reader in self.versions[key][-1].visitors:
                if reader != tid and self.txns[reader].status == "running":
                    self.antidep.add((reader, tid))
                    # rule 4(b) for readers of what I overwrite, applied at my
                    # commit: their start precedes my commit
                    if self.mode == "postsi":
                        self.txns[reader].s_hi = min(self.txns[reader].s_hi,
                                                     (t.c or 0) - 1)
            self.versions[key].append(Version(value, tid, t.c or 0))
        # ---- rule 4(c): bump SIDs of read versions -----------------------
        if self.mode == "postsi":
            for key, idx in t.reads.items():
                v = self.versions[key][idx]
                v.sid = max(v.sid, t.s)
        # ---- CV rule 6 cleanup -------------------------------------------
        for key, idx in t.reads.items():
            self.versions[key][idx].visitors.discard(tid)
        self.antidep = {(a, b) for (a, b) in self.antidep if b != tid and a != tid}
        t.status = "committed"
        return True

    # ------------------------------------------------------------- history
    def history(self):
        """In the wave-engine format, for verify_si / verify_cv."""
        import numpy as np
        txns = [t for t in self.txns.values()]
        T = len(txns)
        O = max([len(t.reads) + len(t.writes) for t in txns] + [1])

        class H:
            pass

        out = H()
        out.status = np.array([1 if t.status == "committed" else 2 for t in txns])
        out.s = np.array([t.s if t.s is not None else -1 for t in txns])
        out.c = np.array([t.c if t.c is not None else -1 for t in txns])
        out.read_key = np.full((T, O), -1)
        out.read_cid = np.full((T, O), -1)
        out.write_key = np.full((T, O), -1)
        out.write_cid = np.full((T, O), -1)
        for i, t in enumerate(txns):
            if t.status != "committed":
                continue
            for o, (k, idx) in enumerate(t.reads.items()):
                out.read_key[i, o] = k
                out.read_cid[i, o] = self.versions[k][idx].cid
            for o, k in enumerate(t.writes):
                out.write_key[i, o] = k
                # find the version this txn installed
                for v in self.versions[k]:
                    if v.tid == t.tid:
                        out.write_cid[i, o] = v.cid
        tids = np.array([t.tid for t in txns])
        return [(tids, out)]
