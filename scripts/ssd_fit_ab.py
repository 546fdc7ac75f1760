"""Device time of the float32 SSD kernel (``ssd_scan_fma_kernel``) at the
model plane's prefill shapes, for the checkout this file sits in, on one
CUDA device.

    python3 scripts/ssd_fit_ab.py [--reps N]

Shapes (batch 4, S = 1,024, chunk 128, x and dA as the views of the
model's [B, S, H, .] layout that ``models/ssm.py`` passes): zamba2-2.7b's
80 heads of P = 64 over N = 64, and mamba2-130m's 24 heads of P = 64 over
N = 128.  A tree whose kernel refuses a shape (the shared memory it asks
for is above what a block may use) prints the refusal.  Each shape is
timed by the profiler (kernel-only device ms a launch) and by CUDA events
(ms a wrapper call, 20 back to back), once unrecorded, then ``--reps``
times; every run and the median are printed with the card's name and
power limit.  To compare two trees copy this file and ``probes.py`` into
the other checkout's ``scripts/`` and run the two in alternating processes
(A, B, B, A): the wrapper takes the same arguments in both.  Nothing of
the port imports this script.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import probes  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_cuda  # noqa: E402

B, S, P, Q = 4, 1024, 64, 128
SHAPES = {"zamba2-2.7b": (80, 64), "mamba2-130m": (24, 128)}   # (H, N)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def call(dev, H, N, seed=0):
    """A float32 scan call at (H, N) on seeded inputs in the model's
    layout."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, S, H, P), generator=g, device=dev) * 0.5
    dA = -torch.rand((B, S, H), generator=g, device=dev) * 1.4
    Bm, Cm = (torch.randn((B, S, N), generator=g, device=dev) * 0.3
              for _ in range(2))
    xv, av = x.transpose(1, 2), dA.transpose(1, 2)
    return lambda: ssd_cuda(xv, av, Bm, Cm, H, Q)


def measure(dev) -> dict:
    """{shape: (device ms a launch, CUDA events ms a call)} or the
    refusal's text."""
    out = {}
    for name, (H, N) in SHAPES.items():
        fn = call(dev, H, N)
        try:
            fn()
        except ValueError as exc:
            out[name] = f"refused: {exc}"
            continue
        dev_ms = probes.profile_device_ms({name: (fn, "ssd_scan_")},
                                          iters=10)[name]
        out[name] = (dev_ms, probes.event_ms(fn, iters=20, warmup=3))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    reps = ap.parse_args(argv).reps
    if not torch.cuda.is_available():
        print("ssd_fit_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = card_line()
    tree = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    measure(dev)                                # unrecorded
    runs = [measure(dev) for _ in range(reps)]
    for name in SHAPES:
        H, N = SHAPES[name]
        got = [r[name] for r in runs]
        label = (f"[ssd_fit] {tree}: float32 ssd_scan at {name}'s prefill "
                 f"(B={B} S={S} H={H} P={P} N={N} chunk {Q})")
        if isinstance(got[0], str):
            print(f"{label}: {got[0]} [{card}]", flush=True)
            continue
        dms = [d for d, _ in got if d is not None]
        print(f"{label}: device ms "
              + ", ".join("not measured" if d is None else f"{d:.5f}"
                          for d, _ in got)
              + (f" (median {statistics.median(dms):.5f})" if dms else "")
              + "; events ms " + ", ".join(f"{e:.5f}" for _, e in got)
              + f" (median {statistics.median(e for _, e in got):.5f}) "
              f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
