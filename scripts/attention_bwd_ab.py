"""Device time of the attention backward kernels (``flash_attention_bwd_dq``
and ``flash_attention_bwd_dkdv``, bf16) for the checkout this file sits in,
on one CUDA device.

    python3 scripts/attention_bwd_ab.py [--reps N]

Shapes, causal: qwen2-0.5b's training step (B=4, S=1,024, H=14, KH=2,
D=64), which phase 9 of ``chip_smoke.py`` runs 24 times a step, and
qwen3-14b's heads (B=4, S=1,024, H=40, KH=8, D=128).  Each shape is timed
by the profiler (kernel-only device ms a launch of each kernel), by CUDA
events (ms a wrapper call of each kernel and of the pair, 20 back to back)
and by the host clock (µs to enqueue one wrapper call, 200 back to back,
before the device is waited on); once unrecorded, then ``--reps`` times.
Every run and the median are printed with the card's name and power
limit.  To compare two trees copy this file and ``probes.py`` into the
other checkout's ``scripts/`` and run the two in alternating processes
(A, B, B, A): the wrappers take the same arguments in both.  Nothing of
the port imports this script.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import probes  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_cuda, flash_attention_bwd_dkdv_cuda,
    flash_attention_bwd_dq_cuda, flash_attention_cuda)

SHAPES = {"qwen2-0.5b": (4, 1024, 14, 2, 64),      # (B, S, H, KH, D)
          "qwen3-14b": (4, 1024, 40, 8, 128)}
KERNELS = ("flash_attention_bwd_dq", "flash_attention_bwd_dkdv")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def calls(dev, B, S, H, KH, D, seed=0):
    """{kernel: wrapper call} and the pair's call on seeded bf16 inputs,
    o and lse from the forward kernel."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda shape: (torch.randn(shape, generator=g, device=dev)
                        * 0.5).to(torch.bfloat16)
    q, do = rn((B, S, H, D)), rn((B, S, H, D))
    k, v = rn((B, S, KH, D)), rn((B, S, KH, D))
    o, lse = flash_attention_cuda(q, k, v, True, with_lse=True)
    _, delta = flash_attention_bwd_dq_cuda(q, k, v, o, lse, do, True)
    return ({"flash_attention_bwd_dq": lambda: flash_attention_bwd_dq_cuda(
                 q, k, v, o, lse, do, True),
             "flash_attention_bwd_dkdv":
                 lambda: flash_attention_bwd_dkdv_cuda(q, k, v, do, lse,
                                                       delta, True)},
            lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do, True))


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
    """{shape: {metric: value}} for one run."""
    out = {}
    for name, shape in SHAPES.items():
        fns, pair = calls(dev, *shape)
        dev_ms = probes.profile_device_ms(
            {k: (fn, k + "_") for k, fn in fns.items()}, iters=10)
        rec = {f"{k} device ms": dev_ms[k] for k in KERNELS}
        rec.update({f"{k} events ms": probes.event_ms(fn, iters=20,
                                                      warmup=3)
                    for k, fn in fns.items()})
        rec["pair events ms"] = probes.event_ms(pair, iters=20, warmup=3)
        rec.update({f"{k} host us": host_us(fn) for k, fn in fns.items()})
        out[name] = rec
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    reps = ap.parse_args(argv).reps
    if not torch.cuda.is_available():
        print("attention_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = card_line()
    tree = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    measure(dev)                                # unrecorded
    runs = [measure(dev) for _ in range(reps)]
    for name, (B, S, H, KH, D) in SHAPES.items():
        for metric in runs[0][name]:
            got = [r[name][metric] for r in runs]
            vals = [x for x in got if x is not None]
            print(f"[attention_bwd] {tree}: {name} (B={B} S={S} H={H} "
                  f"KH={KH} D={D} bf16 causal) {metric} "
                  + ", ".join("not measured" if x is None else f"{x:.5f}"
                              for x in got)
                  + (f" (median {statistics.median(vals):.5f})" if vals
                     else "") + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
