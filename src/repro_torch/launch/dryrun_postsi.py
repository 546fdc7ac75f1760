"""Dry run of the paper's own technique: one PostSI wave of the node mesh
counted as a cell (port of ``repro.launch.dryrun_postsi``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun_postsi
        [--nodes 256] [--keys-per-node 65536] [--txns 2048] [--ops 8]
        [--device meta|cuda] [--out PATH]

The store of ``nodes x keys-per-node`` keys (V = 8) is sharded over
``make_cc_node_mesh(nodes)`` and one wave of ``micro_waves`` (60% reads,
30% distributed txns, the reference's mix) runs through
``core.dist_engine.run_wave_dist`` on the ``cuda`` route under
``launch.op_count.OpCounter``.
On ``meta`` (the default) nothing is allocated or computed; ``--device
cuda`` runs the wave on the card.  The record is the model cells'
(``launch.dryrun.record``): the counted FLOPs, bytes and kernel launches,
the memory, and the roofline against the H100's peaks, with no
collectives (the nodes are blocks of one card) and no MODEL_FLOPS.  At
the reference's defaults the wave makes some 2.4 million aten ops, a few
minutes under the counter.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from repro_torch.core import make_store, shard_store
from repro_torch.core.dist_engine import run_wave_dist
from repro_torch.core.workloads import micro_waves
from repro_torch.launch.dryrun import record, roofline
from repro_torch.launch.mesh import make_cc_node_mesh
from repro_torch.launch.op_count import count_call


def wave_cell(nodes: int, keys_per_node: int, txns: int, ops: int,
              device="meta", route: str = "cuda") -> dict:
    """The record of one postsi wave of ``txns`` txns of ``ops`` ops over
    ``nodes`` x ``keys_per_node`` keys on ``device``."""
    mesh = make_cc_node_mesh(nodes, device)
    wave = micro_waves(np.random.RandomState(0), 1, txns, nodes,
                       keys_per_node, n_ops=ops, read_ratio=0.6,
                       dist_frac=0.3, device=mesh.device)[0]
    store = shard_store(make_store(nodes * keys_per_node, 8,
                                   device=mesh.device), mesh)
    t0 = time.time()
    _, count = count_call(run_wave_dist, store, wave, 1, 1, mesh,
                          sched="postsi", kernels=route)
    rec = record(count, arch="postsi-db", shape=f"wave_T{txns}_O{ops}",
                 kind="txn-wave", route=route, device=str(mesh.device),
                 nodes=nodes, keys=nodes * keys_per_node,
                 count_s=round(time.time() - t0, 1))
    rec["roofline"] = roofline(count)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=256)
    ap.add_argument("--keys-per-node", type=int, default=65536)
    ap.add_argument("--txns", type=int, default=2048)
    ap.add_argument("--ops", type=int, default=8)
    ap.add_argument("--device", default="meta")
    ap.add_argument("--out",
                    default="experiments/dryrun_torch/postsi-db__wave__h100"
                            ".json")
    args = ap.parse_args()
    rec = wave_cell(args.nodes, args.keys_per_node, args.txns, args.ops,
                    args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    r = rec["roofline"]
    launches = {k: v["launches"] for k, v in rec["count"]["kernels"].items()}
    print(f"postsi-db wave on {args.nodes} nodes ({rec['device']}, "
          f"{rec['route']}): count={rec['count_s']}s dominant={r['dominant']} "
          f"c={r['compute_s']:.6f}s m={r['memory_s']:.6f}s "
          f"launches={launches} "
          f"({args.txns} txns x {args.ops} ops, "
          f"{args.nodes * args.keys_per_node / 1e6:.0f}M keys)")


if __name__ == "__main__":
    main()
