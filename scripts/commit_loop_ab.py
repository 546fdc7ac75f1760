"""Numbers that compare two trees' commit_loop path, for the checkout this
file sits in, on one CUDA device.

    python3 scripts/commit_loop_ab.py [--reps N]

* host time: ``commit_loop_cuda`` on one postsi SmallBank wave of T=1 over
  the 1,000,000-account store (V=8), ms a call over 200 calls with no
  sync between them; then the same with the C entry point swapped for a
  stub that returns at once (the Python around the launch), the C entry
  alone on the arguments the wrapper gave it, and ``build.stream_of``;
* device time: ``commit_loop_cuda`` on the path's wave (T=256, the same
  store), CUDA-event ms a call over 20 calls, in the variant the wrapper
  picks;
* goodput: ``TxnService.run_stream`` as ``chip_smoke.py``'s service phase
  runs it (SmallBank, 8 nodes x 125,000 accounts, V=8, T=64, 48 Poisson
  arrivals a tick for 32 ticks, seed 1), on the ``cuda`` and
  ``cuda+fused`` routes, a fresh service each time.

Each measurement runs once unrecorded (the warm-up), then ``--reps``
times; every run and the median are printed with the card's name and
power limit.  Host clocks on a shared host spread widely, so to compare
two trees copy this file into the other checkout's ``scripts/`` and run
the two in alternating processes (A, B, B, A, ...): the calls it makes
take the same arguments in both.  Nothing of the port imports this
script.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.core import LocalSubstrate, make_store  # noqa: E402
from repro_torch.core.engine import wave_read_phase  # noqa: E402
from repro_torch.core.workloads import (poisson_arrivals,  # noqa: E402
                                        smallbank_waves)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import commit_loop as cl  # noqa: E402
from repro_torch.service import TxnService, smallbank_txn_gen  # noqa: E402

NODES, KPN, V = 8, 125_000, 8


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def host_ms(fn, n=200) -> float:
    """Mean host ms a call over n calls with no sync between them."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return ms


def wave_call(store, T):
    """A call of commit_loop_cuda on a postsi SmallBank wave of T."""
    dev = store[0].device
    (wave,) = smallbank_waves(np.random.RandomState(2), 1, T, NODES, KPN,
                              dist_frac=0.2, device=dev)
    inputs = wave_read_phase(LocalSubstrate("torch", dev), store, wave, 1, 1,
                             sched="postsi")
    kw = dict(sched="postsi", n_nodes=NODES, gc_track=True, gc_block=False)
    return lambda: cl.commit_loop_cuda(store, inputs, **kw)


def device_ms(call, iters=20) -> float:
    """CUDA-event ms a call (each call installs again into its store)."""
    call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_times(store) -> dict:
    """ms a call: the wrapper, its Python alone, the C entry alone,
    stream_of."""
    call = wave_call(store, 1)
    for _ in range(20):
        call()
    out = {"wrapper": host_ms(call)}
    lib = build.library()
    entry = lib.commit_loop_launch
    kept = []

    def stub(*args):
        kept[:] = args
        return 0
    lib.commit_loop_launch = stub
    try:
        out["python"] = host_ms(call)
        outputs = call()    # kept allocated for the C entry's calls
    finally:
        lib.commit_loop_launch = entry
    out["C entry"] = host_ms(lambda: entry(*kept))
    del outputs
    out["stream_of"] = host_ms(lambda: build.stream_of(store[0]))
    return out


def measure(store, path_call) -> dict:
    out = {f"host ms a call, {k}": v for k, v in host_times(store).items()}
    out["device ms a call, T=256"] = device_ms(path_call)
    for kernels in ("cuda", "cuda+fused"):
        out[f"service goodput txn/s, {kernels}"] = goodput(store[0].device,
                                                           kernels)
    return out


def goodput(dev, kernels: str) -> float:
    rng = np.random.RandomState(1)
    arrivals = poisson_arrivals(rng, 48.0, 32)
    svc = TxnService(n_keys=NODES * KPN, n_versions=V, T=64, sched="postsi",
                     n_nodes=NODES, kernels=kernels, device=dev)
    rep = svc.run_stream(arrivals, smallbank_txn_gen(rng, NODES, KPN,
                                                     dist_frac=0.2))
    return rep.goodput_tps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    reps = ap.parse_args().reps
    if not torch.cuda.is_available():
        print("commit_loop_ab: no CUDA device", file=sys.stderr)
        return 2
    card, dev = card_line(), torch.device("cuda")
    store = make_store(NODES * KPN, V, device=dev)
    path_call = wave_call(store, 256)
    measure(store, path_call)                          # the warm-up
    runs: dict[str, list[float]] = {}
    for _ in range(reps):
        for name, x in measure(store, path_call).items():
            runs.setdefault(name, []).append(x)
    for name, xs in runs.items():
        print(f"{name}: median {statistics.median(xs):.4f} of "
              f"{' '.join(f'{x:.4f}' for x in xs)} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
