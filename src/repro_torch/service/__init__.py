"""Closed-loop transaction service of the PyTorch port (single device):
the open-stream wave former, the abort-retry pipeline, the
visibility-based GC watermark around ``core.engine.step_wave`` and the
pipelined streaming plane (K blocks in flight, contention-adaptive wave
sizing) around ``core.engine.run_block``."""
from .former import TxnRequest, WaveFormer, fold_counts
from .gc import VisibilityGC, seq_watermark
from .retry import RetryPolicy
from .service import (ServiceReport, TxnService, rmw_txn_gen,
                      smallbank_txn_gen, tenant_txn_gen, ycsb_txn_gen)
from .stream import AdaptiveWaveSizer, StreamingDriver

__all__ = [
    "TxnRequest", "WaveFormer", "VisibilityGC", "RetryPolicy",
    "ServiceReport", "TxnService", "seq_watermark", "smallbank_txn_gen",
    "ycsb_txn_gen", "rmw_txn_gen", "tenant_txn_gen", "fold_counts",
    "AdaptiveWaveSizer", "StreamingDriver",
]
