"""Durability & recovery plane of the PyTorch port: block-retire WAL,
PostSI-committed snapshots, snapshot+replay crash recovery (the
reference's formats, so each package recovers the other's directories)."""
from . import wal
from .recovery import (DurabilityManager, RecoveredState, RecoveryError,
                       recover, service_config, wal_path)
from .snapshot import SnapshotState, SnapshotStore
from .wal import WalError, WalScan, WalWriter, torn_tail

__all__ = [
    "wal", "wal_path", "WalError", "WalScan", "WalWriter", "torn_tail",
    "SnapshotState", "SnapshotStore",
    "DurabilityManager", "RecoveredState", "RecoveryError", "recover",
    "service_config",
]
