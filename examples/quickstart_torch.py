"""Quickstart on the PyTorch port: the paper's decentralized MVCC in 60
seconds.

The counterpart of ``examples/quickstart.py`` for ``repro_torch``.

1. Walk through Figure 1 with the reference PostSI scheduler: a blind write
   over a committed-but-physically-overlapping peer COMMITS under PostSI
   (timestamps are induced, not measured) while first-committer-wins SI
   aborts it.
2. Run a SmallBank workload through the vectorized wave engine under PostSI
   and conventional SI, verify both histories satisfy snapshot isolation and
   compare coordination traffic.

Run:  PYTHONPATH=src python examples/quickstart_torch.py
      (on the CUDA device; ``--device cpu`` runs the plain PyTorch route)
"""
import argparse

import numpy as np

from repro_torch.core import make_store, run_workload, verify_si
from repro_torch.core.seq import SeqScheduler
from repro_torch.core.workloads import smallbank_waves

A, B = 0, 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    device = ap.parse_args(argv).device

    print("=== Paper Figure 1: posterior timestamps in action ===")
    s = SeqScheduler(2, mode="postsi")
    t1, t2, t3 = s.begin(), s.begin(), s.begin()
    s.read(t1, A)               # t1 overlaps everyone
    s.read(t2, A)
    s.write(t2, B, 20)
    assert s.commit(t2)
    print(f"t2 committed with interval ({s.txns[t2].s}, {s.txns[t2].c})")
    s.write(t3, B, 30)          # blind write over t2's version, overlapping
    ok = s.commit(t3)
    print(f"t3 blind-writes B after t2's commit -> "
          f"{'COMMIT' if ok else 'ABORT'} with interval "
          f"({s.txns[t3].s}, {s.txns[t3].c})   (conventional SI would abort)")
    assert not verify_si(s.history()), None
    print("history verifies as snapshot-isolated:",
          verify_si(s.history()) == [])

    print("\n=== Wave engine: SmallBank on 8 shared-nothing nodes ===")
    rng = np.random.RandomState(0)
    n_nodes, kpn = 8, 400
    waves = smallbank_waves(rng, 4, 64, n_nodes, kpn, dist_frac=0.3,
                            device=device)
    for sched in ("postsi", "cv", "si", "optimal"):
        _, hist, stats = run_workload(
            make_store(n_nodes * kpn, 8, device=device), waves, sched=sched,
            n_nodes=n_nodes)
        errs = verify_si(hist) if sched != "cv" else []
        print(f"{sched:8s} committed={stats.committed:4d} "
              f"aborted={stats.aborted:3d} cross-msgs={stats.msgs_cross:4d} "
              f"coordinator-msgs={stats.msgs_coord:4d} "
              f"SI-violations={len(errs)}")
    print("\nPostSI: zero coordinator messages — the paper's point.")


if __name__ == "__main__":
    main()
