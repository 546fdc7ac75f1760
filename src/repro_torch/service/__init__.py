"""Closed-loop transaction service of the PyTorch port (single device):
the open-stream wave former, the abort-retry pipeline and the
visibility-based GC watermark around ``core.engine.step_wave``."""
from .former import TxnRequest, WaveFormer, fold_counts
from .gc import VisibilityGC, seq_watermark
from .retry import RetryPolicy
from .service import (ServiceReport, TxnService, rmw_txn_gen,
                      smallbank_txn_gen, tenant_txn_gen, ycsb_txn_gen)

__all__ = [
    "TxnRequest", "WaveFormer", "VisibilityGC", "RetryPolicy",
    "ServiceReport", "TxnService", "seq_watermark", "smallbank_txn_gen",
    "ycsb_txn_gen", "rmw_txn_gen", "tenant_txn_gen", "fold_counts",
]
