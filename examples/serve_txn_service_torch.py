"""Closed-loop transaction service quickstart on the PyTorch port.

The counterpart of ``examples/serve_txn_service.py`` for ``repro_torch``.
An open SmallBank request stream — bursty arrivals, a per-node hotspot —
served end to end by the decentralized PostSI wave engine: the wave former
admits and packs arrivals, aborted transactions retry with fresh TIDs
under exponential backoff, and the visibility watermark guards version
GC.  The served history is then verified post hoc: it must be
snapshot-isolated and the final store must match a serial replay of the
committed transactions.

The same stream is then served through the pipelined streaming plane
(blocks of B waves dispatched together, K blocks in flight): same closed
loop, same verifiers, one host wait a block in place of one a wave.

Run:  PYTHONPATH=src python examples/serve_txn_service_torch.py
      (on the CUDA device; ``--device cpu`` runs the plain PyTorch route)
"""
import argparse

import numpy as np

from repro_torch.core.workloads import bursty_arrivals
from repro_torch.service import RetryPolicy, TxnService, smallbank_txn_gen

N_NODES = 4
KEYS_PER_NODE = 50
T = 32          # wave capacity (txns per tick)
N_TICKS = 40
RATE = 20.0     # calm-state arrivals per tick (bursts spike to 6x)


def _service(device):
    return TxnService(n_keys=N_NODES * KEYS_PER_NODE, n_versions=8, T=T,
                      sched="postsi", n_nodes=N_NODES,
                      retry=RetryPolicy(max_attempts=6), seed=0,
                      device=device)


def _stream():
    gen = smallbank_txn_gen(np.random.RandomState(1), N_NODES, KEYS_PER_NODE,
                            dist_frac=0.3, hot_frac=0.5, hot_per_node=4)
    return bursty_arrivals(np.random.RandomState(2), RATE, N_TICKS), gen


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    device = ap.parse_args(argv).device

    svc = _service(device)
    arrivals, gen = _stream()
    print(f"offered: {int(arrivals.sum())} txns over {N_TICKS} ticks "
          f"(capacity {T}/tick, bursts up to {int(arrivals.max())}) on "
          f"{svc.device}, kernels {svc.kernels.name}")

    report = svc.run_stream(arrivals, gen)

    print(f"\ncommitted {report.committed}/{report.admitted} admitted "
          f"({report.rejected} shed at admission, {report.dropped} dropped "
          f"after {svc.retry.max_attempts} attempts)")
    print(f"retries: {report.retries} (rate {report.retry_rate:.2f}); "
          f"goodput {report.goodput_tps:.0f} txn/s, "
          f"sustained {report.txns_per_sec:.0f} exec/s over "
          f"{report.waves} waves")
    print(f"latency p50/p95/p99: {report.latency_p50:.0f}/"
          f"{report.latency_p95:.0f}/{report.latency_p99:.0f} ticks")
    print(f"GC: watermark {report.gc['watermark']}, "
          f"still-visible evictions {report.evicted_visible}")

    errors = svc.verify()
    assert not errors, errors[:3]
    print("\nhistory verified: snapshot-isolated, store == serial replay "
          f"({len(svc.history)} waves, 0 violations)")

    # the same stream through the pipelined streaming plane
    svc2 = _service(device)
    arrivals2, gen2 = _stream()
    rep2 = svc2.run_streaming(arrivals2, gen2, B=4, K=2)
    assert svc2.verify() == []
    print(f"\nstreaming (B=4, K=2): committed {rep2.committed}/"
          f"{rep2.admitted} over {rep2.waves} waves in {rep2.blocks} "
          f"blocks; goodput {rep2.goodput_tps:.0f} txn/s "
          f"(step loop: {report.goodput_tps:.0f})")


if __name__ == "__main__":
    main()
