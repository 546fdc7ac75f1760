"""Device time of the SSD scan kernels at the model plane's prefill shapes,
for the checkout this file sits in, on one CUDA device.

    python3 scripts/ssd_ab.py [--reps N]

Shapes (batch 4, S = 1,024, chunk 128, x and dA as the views of the
model's [B, S, H, .] layout that ``models/ssm.py`` passes): zamba2-2.7b's
80 heads of P = 64 over N = 64, and mamba2-130m's 24 heads of P = 64 over
N = 128.  At each: the bf16 scan as the path calls it (the kernel its
route table picks: ``ssd_scan_wgmma_kernel`` where the tree has it), the
``ssd_scan_mma_kernel`` at the same shape where the wrapper can be asked
for it (``kernel="mma"``), and the float32 gate (``ssd_scan_fma_kernel``),
each by the profiler (kernel-only device ms a launch); the bf16 call also
by the host clock (µs to enqueue one wrapper call, 200 back to back,
before the device is waited on); beside the byte bound of the bf16 call.
A tree whose kernel refuses a shape prints the refusal.  Everything once
unrecorded, then ``--reps`` times; every run and the median are printed
with the card's name and power limit.  To compare two trees copy this file
and ``probes.py`` into the other checkout's ``scripts/`` and run the two
in alternating processes (A, B, B, A).  Nothing of the port imports this
script.
"""
from __future__ import annotations

import argparse
import inspect
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import probes  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_cuda  # noqa: E402

B, S, P, Q = 4, 1024, 64, 128
SHAPES = {"zamba2-2.7b": (80, 64), "mamba2-130m": (24, 128)}   # (H, N)
BYTES_PER_S = 3.35e12
# the wrapper can be asked for the mma.sync kernel (trees with the Hopper
# kernel)
ASKS = "kernel" in inspect.signature(ssd_cuda).parameters
# the profiler's kernel name of each form
NAMES = {"bf16": "ssd_scan_", "mma": "ssd_scan_mma", "f32": "ssd_scan_fma"}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def calls(dev, H, N, seed=0) -> dict:
    """{form: wrapper call} at (H, N) on seeded inputs in the model's
    layout: "bf16" as routed, "mma" (where the wrapper takes it), "f32"."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, S, H, P), generator=g, device=dev) * 0.5
    dA = -torch.rand((B, S, H), generator=g, device=dev) * 1.4
    Bm, Cm = (torch.randn((B, S, N), generator=g, device=dev) * 0.3
              for _ in range(2))
    av = dA.transpose(1, 2)
    xb, bb, cb = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    out = {"bf16": lambda: ssd_cuda(xb.transpose(1, 2), av, bb, cb, H, Q)}
    if ASKS:
        out["mma"] = lambda: ssd_cuda(xb.transpose(1, 2), av, bb, cb, H, Q,
                                      kernel="mma")
    out["f32"] = lambda: ssd_cuda(x.transpose(1, 2), av, Bm, Cm, H, Q)
    return out


def bound_ms(H, N) -> float:
    """x, dA, B and C read once, y and h written once (bf16 x, B, C, y)."""
    BH = B * H
    n_bytes = (2 * BH * S * P * 2 + BH * S * 4 + 2 * B * S * N * 2
               + BH * N * P * 4)
    return n_bytes / BYTES_PER_S * 1e3


def host_us(fn, n=200) -> float:
    """µs of host time to enqueue one call, ``n`` back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def measure(dev) -> dict:
    """{shape: {metric: value or the refusal's text}} for one run."""
    out = {}
    for name, (H, N) in SHAPES.items():
        rec = {}
        for form, fn in calls(dev, H, N).items():
            try:
                fn()
            except ValueError as exc:
                rec[f"{form} device ms"] = f"refused: {exc}"
                continue
            # one form a profiler session: the forms share kernel names
            rec[f"{form} device ms"] = probes.profile_device_ms(
                {form: (fn, NAMES[form])}, iters=10)[form]
            if form == "bf16":
                rec["bf16 host us"] = host_us(fn)
        out[name] = rec
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    reps = ap.parse_args(argv).reps
    if not torch.cuda.is_available():
        print("ssd_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = card_line()
    tree = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    measure(dev)                                # unrecorded
    runs = [measure(dev) for _ in range(reps)]
    for name, (H, N) in SHAPES.items():
        label = (f"[ssd_ab] {tree}: {name}'s prefill (B={B} S={S} H={H} "
                 f"P={P} N={N} chunk {Q})")
        for metric in runs[0][name]:
            got = [r[name][metric] for r in runs]
            if isinstance(got[0], str):
                print(f"{label} {metric}: {got[0]} [{card}]", flush=True)
                continue
            vals = [v for v in got if v is not None]
            print(f"{label} {metric} "
                  + ", ".join("not measured" if v is None else f"{v:.5f}"
                              for v in got)
                  + (f" (median {statistics.median(vals):.5f})" if vals
                     else "") + f" [{card}]", flush=True)
        print(f"{label} bound ms {bound_ms(H, N):.5f} (bytes) [{card}]",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
