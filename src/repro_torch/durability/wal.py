"""Write-ahead log of retired blocks (a copy of ``repro.durability.wal``).

The streaming plane's **block-retire point is the durability boundary**: a
retired block is a committed, ordered unit — its outcomes have been copied
to the host and are about to be acknowledged to clients — so it is logged
ONCE, as one record, and replay is deterministic (``engine.run_block``
over the logged inputs reproduces the logged outcomes bit for bit;
recovery checks exactly that).  Nothing upstream of retirement is ever
durable: a block that was dispatched but not retired when the process
died is absent from the log, so after recovery it either replays (the
client re-submits) or drops — it can never double-commit.

Record framing, designed to survive a torn tail::

    MAGIC(4) | type(1) | payload_len(4, LE) | crc32(payload)(4, LE) | payload

The frames are the reference's byte for byte (pickle protocol 4), and a
record's fields are numpy int32 arrays, Python ints or ``None``, never a
tensor: each package scans the other's log, and the JAX package reads the
port's without torch.

``scan`` walks frames until the file ends cleanly or a frame is damaged —
incomplete header, truncated payload, CRC mismatch, bad magic — and
reports the prefix of intact records plus how many trailing bytes were
torn.  A writer re-opening the file truncates to the intact prefix, so a
crash mid-append costs at most the unflushed suffix, never the log.

Fsync batching (group commit): ``append`` buffers frames in host memory
and only writes + ``fsync``\\ s every ``fsync_every`` records (or on an
explicit ``sync``/``close``).  ``fsync_every=1`` is the durable-before-ack
configuration; larger values trade a bounded window of acked-but-lost
commits for append throughput.  A simulated crash (``drop_unsynced``)
discards the buffered frames without writing them — the honest model of
losing the page cache.

Payloads are pickled dicts; the CRC covers the payload bytes, so bit-rot
anywhere in a record is detected at scan time, not deep inside replay.  A
block record logged by a folding former carries an extra ``fold`` array
of per-row request multiplicities, which replay never consults.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

MAGIC = b"VWAL"
_HDR = struct.Struct("<4sBII")        # magic, rtype, payload_len, crc32
REC_CONFIG = 1
REC_BLOCK = 2
REC_MOVE = 3      # placement range move (DESIGN.md §11): explicit slot
                  # arrays, shares the block seq space so replay interleaves
                  # moves and blocks in the exact retire order


class WalError(RuntimeError):
    """Structural WAL failure that is NOT a tolerable torn tail (e.g. a
    config mismatch or a corrupt record in the *middle* of the log)."""


@dataclasses.dataclass
class WalScan:
    """Result of scanning a WAL file up to the first damaged frame."""
    config: Optional[Dict[str, Any]]      # the head CONFIG record, if intact
    blocks: List[Dict[str, Any]]          # intact BLOCK records, in order
    valid_bytes: int                      # offset of the intact prefix
    torn_bytes: int                       # damaged/incomplete trailing bytes
    # elastic placement plane (DESIGN.md §11): MOVE records, and the merged
    # (rtype, record) stream in file order — blocks and moves share ONE seq
    # space, so replay walks ``records`` to interleave them exactly
    moves: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    records: List[Tuple[int, Dict[str, Any]]] = \
        dataclasses.field(default_factory=list)


def _frame(rtype: int, payload: Dict[str, Any]) -> bytes:
    buf = pickle.dumps(payload, protocol=4)
    return _HDR.pack(MAGIC, rtype, len(buf), zlib.crc32(buf)) + buf


def scan(path: str) -> WalScan:
    """Read every intact record; tolerate (and measure) a torn tail.

    The first damaged frame ends the scan: everything before it is the
    durable prefix, everything after is counted as torn.  A missing file
    scans as empty.
    """
    if not os.path.exists(path):
        return WalScan(None, [], 0, 0)
    with open(path, "rb") as f:
        data = f.read()
    config: Optional[Dict[str, Any]] = None
    blocks: List[Dict[str, Any]] = []
    moves: List[Dict[str, Any]] = []
    records: List[Tuple[int, Dict[str, Any]]] = []
    off = 0
    while off + _HDR.size <= len(data):
        magic, rtype, ln, crc = _HDR.unpack_from(data, off)
        end = off + _HDR.size + ln
        if magic != MAGIC or end > len(data):
            break                                  # torn/garbage tail
        payload = data[off + _HDR.size:end]
        if zlib.crc32(payload) != crc:
            break                                  # bit-rot or partial write
        rec = pickle.loads(payload)
        if rtype == REC_CONFIG:
            if config is not None or records:
                raise WalError(f"{path}: CONFIG record not at log head "
                               f"(offset {off})")
            config = rec
        elif rtype == REC_BLOCK:
            blocks.append(rec)
            records.append((REC_BLOCK, rec))
        elif rtype == REC_MOVE:
            moves.append(rec)
            records.append((REC_MOVE, rec))
        else:
            raise WalError(f"{path}: unknown record type {rtype} at "
                           f"offset {off}")
        off = end
    # one seq space over blocks AND moves: position in the file IS the seq
    for i, (_, rec) in enumerate(records):
        if rec["seq"] != i:
            raise WalError(f"{path}: record seq {rec['seq']} at position {i} "
                           f"— the log is not a contiguous retire order")
    return WalScan(config, blocks, off, len(data) - off,
                   moves=moves, records=records)


class WalWriter:
    """Append-only writer over the intact prefix of a WAL file."""

    def __init__(self, path: str, fsync_every: int = 1,
                 valid_bytes: Optional[int] = None):
        if fsync_every < 1:
            raise ValueError(f"fsync_every must be >= 1, got {fsync_every}")
        self.path = path
        self.fsync_every = fsync_every
        self._pending: List[bytes] = []           # frames not yet in the OS
        self.synced_records = 0                   # frames made durable
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if valid_bytes is not None and os.path.exists(path):
            with open(path, "rb+") as f:
                f.truncate(valid_bytes)           # drop any torn tail
        self._f = open(path, "ab")
        # the fsync barrier: bytes at or before this offset survive any
        # crash; only the suffix beyond it is ever at risk of tearing
        self.synced_bytes = (os.path.getsize(path)
                             if os.path.exists(path) else 0)

    # ------------------------------------------------------------- append
    def append(self, rtype: int, payload: Dict[str, Any]) -> None:
        self._pending.append(_frame(rtype, payload))
        if len(self._pending) >= self.fsync_every:
            self.sync()

    def sync(self) -> None:
        """Write buffered frames and fsync — the group-commit point."""
        if not self._pending:
            return
        self._f.write(b"".join(self._pending))
        self._f.flush()
        os.fsync(self._f.fileno())
        self.synced_records += len(self._pending)
        self.synced_bytes = self._f.tell()
        self._pending.clear()

    @property
    def unsynced_records(self) -> int:
        return len(self._pending)

    # -------------------------------------------------------------- close
    def close(self) -> None:
        if not self._f.closed:
            self.sync()
            self._f.close()

    def drop_unsynced(self) -> int:
        """Simulated crash, page-cache-lost extreme: discard frames never
        handed to the OS.  Returns how many records were lost."""
        lost = len(self._pending)
        self._pending.clear()
        if not self._f.closed:
            self._f.close()
        return lost

    def simulate_crash(self) -> int:
        """Simulated kill honoring fsync semantics: pending group-commit
        frames are handed to the OS (written, flushed) but never fsynced —
        they are AT RISK, and a fault schedule's torn tail may destroy any
        suffix of them; everything at or before ``synced_bytes`` is behind
        the last fsync barrier and survives unconditionally.  Returns the
        number of at-risk records.  With ``fsync_every=1`` the pending
        buffer is empty at every service seam, so nothing is ever at risk
        — the durable-before-ack configuration."""
        at_risk = len(self._pending)
        if not self._f.closed:
            if self._pending:
                self._f.write(b"".join(self._pending))
                self._f.flush()
            self._f.close()
        self._pending.clear()
        return at_risk


def torn_tail(path: str, n_bytes: int) -> int:
    """Fault injection: tear ``n_bytes`` off the end of the WAL file (a
    partial final write).  Clamped to the file size; returns bytes torn.
    ``scan`` must absorb this by construction — the conformance suite and
    the chaos schedules call this between crash and recovery."""
    if n_bytes <= 0 or not os.path.exists(path):
        return 0
    size = os.path.getsize(path)
    n = min(n_bytes, size)
    with open(path, "rb+") as f:
        f.truncate(size - n)
    return n
