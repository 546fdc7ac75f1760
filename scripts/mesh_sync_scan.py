"""Does a block dispatch on the node mesh wait on the card?  One CUDA
device.

    python3 scripts/mesh_sync_scan.py

Dispatches one block of 3 YCSB waves (T=16, 4 nodes x 40 keys, V=4,
staged from host arrays, the clock a device scalar) through
``dist_engine.run_block_dist`` on ``make_node_mesh(4)`` for the schedulers
postsi, clocksi, dsi and si, the routes ``cuda``, ``cuda+fused`` and
``torch``, with the GC watermark free and pinned (``gc_block``), each
under ``torch.cuda.set_sync_debug_mode("warn")``.  Every synchronizing
operation is a warning; the script prints each distinct call stack once
and their count, with the card's name and power limit, and exits 1 if
there is any.  The mesh runs the plain commit loop, so this also scans
the loop's ``torch`` route on the card.  Nothing of the port imports this
script.
"""
from __future__ import annotations

import os
import subprocess
import sys
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("mesh_sync_scan: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch.core as tc
    from repro_torch.core import workloads as tw
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    sites = {}

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" not in str(message):
            return
        stack = "".join(traceback.format_stack(limit=16)[:-2])
        sites[stack] = sites.get(stack, 0) + 1

    warnings.showwarning = record
    warnings.simplefilter("always")
    mesh = tc.make_node_mesh(4, dev)
    waves = [tc.wave_to_numpy(w) for w in tw.ycsb_waves(
        np.random.RandomState(3), 3, 16, 4, 40, theta=0.9, read_frac=0.3,
        device="cpu")]
    runs = 0
    for sched in ("postsi", "clocksi", "dsi", "si"):
        hs = np.array([0, 1, 0, 2], np.int32) if sched == "clocksi" else None
        for route in ("cuda", "cuda+fused", "torch"):
            for gc_block in (False, True):
                store = tc.shard_store(tc.make_store(160, 4, device=dev),
                                       mesh)
                clock = torch.ones((), dtype=torch.int32, device=dev)
                blk = tc.stage_block(waves, 1, 1 if gc_block else None,
                                     device=dev)
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    tc.run_block_dist(store, blk, None, clock, mesh,
                                      sched=sched, host_skew=hs,
                                      gc_track=True, gc_block=gc_block,
                                      kernels=route)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                runs += 1
    for stack, n in sites.items():
        print(f"--- synchronizing operation, {n} times:\n{stack}")
    print(f"[mesh_sync_scan] {runs} mesh block dispatches, {len(sites)} "
          f"distinct synchronizing call sites ({card})", flush=True)
    return 1 if sites else 0


if __name__ == "__main__":
    sys.exit(main())
