"""Does the block dispatch of the checkout this file sits in wait on the
card, and what does a wait cost?  One CUDA device.

    python3 scripts/dispatch_wait.py [--reps N] [--B B]

On the streaming phase's shapes (SmallBank, 8 nodes x 125,000 accounts,
V=8, waves of T=64, postsi, blocks of ``--B`` waves from host arrays, the
clock a device scalar), for the ``cuda`` and ``cuda+fused`` routes:

* the check: ``torch.cuda.set_sync_debug_mode("error")`` must raise on a
  known blocking copy (a pageable numpy array to the card); then one
  ``engine.run_block`` under the same mode either raises (the dispatch
  waits on the card) or does not;
* the count: the synchronizing operations of one block dispatch, each a
  warning under ``set_sync_debug_mode("warn")``;
* the times: two blocks dispatched back to back, then one
  ``torch.cuda.synchronize()``: host ms of each dispatch and of the whole,
  and the device span of the two blocks (CUDA events recorded before the
  first and after the second: busy and idle time alike).  Where a
  dispatch waits, the second one carries what is left of the first
  block's device time;
* the host's share: 20 blocks dispatched back to back (host ms a
  dispatch, and to the sync after the last), and the staging of one
  block alone, host ms a call over 100 calls: ``engine.stage_block`` where
  the tree has it, else ``engine.wave_from_numpy`` (what the older
  ``run_block`` called).

Each timed run is repeated ``--reps`` times after one unrecorded warm-up;
every run and the median are printed with the card's name and power
limit.  To compare two trees, copy this file into the other checkout's
``scripts/`` and run the two in alternating processes (A, B, B, A): it
calls ``run_block`` with the arguments both trees take.  Nothing of the
port imports this script.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core import make_store, run_block  # noqa: E402
from repro_torch.core.engine import Wave, wave_to_numpy  # noqa: E402
from repro_torch.core.workloads import smallbank_waves  # noqa: E402

NODES, KPN, V, T = 8, 125_000, 8, 64


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def host_block(seed: int, B: int) -> Wave:
    """B SmallBank waves stacked into numpy [B, T, O] / [B, T] arrays."""
    waves = smallbank_waves(np.random.RandomState(seed), B, T, NODES, KPN,
                            dist_frac=0.2, tid0=1 + seed * B * T,
                            device="cpu")
    return Wave(*(np.stack(f) for f in zip(*map(wave_to_numpy, waves))))


def dispatch(store, blk, wave_idx0, clock, route):
    return run_block(store, blk, wave_idx0, clock, sched="postsi",
                     n_nodes=NODES, kernels=route)


def stage_ms(blk, dev, n=100) -> float:
    """Host ms a call of staging one block on ``dev``."""
    try:
        from repro_torch.core.engine import stage_block
        stage = lambda: stage_block(blk, 1, None, dev)
    except ImportError:                # an older tree
        from repro_torch.core.engine import wave_from_numpy
        stage = lambda: wave_from_numpy(blk, dev)
    stage()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        stage()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e3


def back_to_back(store, blocks, B, route, n=20) -> dict:
    """Host ms a dispatch of ``n`` blocks dispatched back to back, and ms
    from the first to the sync after the last."""
    clock = torch.ones((), dtype=torch.int32, device=store[0].device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        store, _, clock = dispatch(store, blocks[i % len(blocks)],
                                   1 + i * B, clock, route)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"b2b_dispatch_ms": (t1 - t0) / n * 1e3,
            "b2b_to_sync_ms": (t2 - t0) / n * 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--B", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dispatch_wait: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = card_line()
    tree = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    print(f"[card] {card}; tree {tree}", flush=True)
    blocks = [host_block(seed, args.B) for seed in range(4)]
    result = {"card": card, "B": args.B, "T": T}

    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.as_tensor(np.zeros(4, np.int32), device=dev)
        raise AssertionError("sync debug mode 'error' let a blocking copy "
                             "pass")
    except RuntimeError as exc:
        if "synchroniz" not in str(exc):
            raise
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("[check] sync debug mode 'error' fires on a blocking copy",
          flush=True)

    for route in ("cuda", "cuda+fused"):
        store = make_store(NODES * KPN, V, device=dev)
        clock = torch.ones((), dtype=torch.int32, device=dev)
        store, _, clock = dispatch(store, blocks[0], 1, clock, route)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            store, _, clock = dispatch(store, blocks[1], 1 + args.B, clock,
                                       route)
            waits = "none"
        except RuntimeError as exc:
            waits = str(exc).splitlines()[0]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                store, _, clock = dispatch(store, blocks[1], 1 + args.B,
                                           clock, route)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        n_sync = sum("synchroniz" in str(w.message) for w in caught)
        torch.cuda.synchronize()
        print(f"[check] {route}: run_block under sync debug 'error': "
              f"{'no host wait' if waits == 'none' else 'raised: ' + waits}"
              f"; synchronizing operations in one block dispatch: {n_sync}",
              flush=True)

        runs = []
        for rep in range(args.reps + 1):
            store = make_store(NODES * KPN, V, device=dev)
            clock = torch.ones((), dtype=torch.int32, device=dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            store, _, clock = dispatch(store, blocks[2], 1, clock, route)
            t1 = time.perf_counter()
            store, _, clock = dispatch(store, blocks[3], 1 + args.B, clock,
                                       route)
            end.record()
            t2 = time.perf_counter()
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            if rep:
                runs.append({"dispatch1_ms": (t1 - t0) * 1e3,
                             "dispatch2_ms": (t2 - t1) * 1e3,
                             "to_sync_ms": (t3 - t0) * 1e3,
                             "device_span_ms": start.elapsed_time(end),
                             "stage_ms": stage_ms(blocks[2], dev),
                             **back_to_back(store, blocks, args.B, route)})
        med = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        for r in runs:
            print(f"[time] {route}: " + " ".join(
                f"{k}={v:.4f}" for k, v in r.items()), flush=True)
        print(f"[time] {route} median of {args.reps}: " + " ".join(
            f"{k}={v:.4f}" for k, v in med.items()) + f"  ({card})",
            flush=True)
        result[route] = {"waits": waits, "sync_ops": n_sync,
                         "median": med, "runs": runs}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
