"""Device time of the attention kernels (``flash_attention`` forward and
the backward's ``flash_attention_bwd_dq`` and ``flash_attention_bwd_dkdv``,
bf16) for the checkout this file sits in, on one CUDA device.

    python3 scripts/attention_ab.py [--reps N] [--part fwd|bwd|all]

Forward shapes: zamba2's prefill (B=4, S=1,024, H=KH=32, D=80, causal),
qwen3-14b's (H=40, KH=8, D=128, causal), qwen2-0.5b's training step (H=14,
KH=2, D=64, causal) and seamless' cross-attention (Sq=128 over Sk=1,024,
H=KH=16, D=64, full).  Each is timed by the profiler (kernel-only device
ms a launch) and by the host clock (µs to enqueue one wrapper call, 200
back to back, before the device is waited on), beside SDPA
(``scaled_dot_product_attention`` on the same inputs, the device ms of its
kernels: the yardstick, never called by the port) and the bound.
Backward shapes, causal: qwen2-0.5b's training step, which phase 9 of
``chip_smoke.py`` runs 24 times a step, and qwen3-14b's heads; each timed
by the profiler (device ms a launch of each kernel), by CUDA events (ms a
wrapper call of each kernel and of the pair, 20 back to back) and by the
host clock as above.  Everything once unrecorded, then ``--reps`` times;
every run and the median are printed with the card's name and power
limit.  To compare two trees (the parent, or a copy with a kernel edited
to time a variant of it) copy this file and ``probes.py`` into the other
checkout's ``scripts/`` and run the two in alternating processes (A, B,
B, A): the wrappers take the same arguments in both.  Nothing of the port
imports this script.
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

# (B, Sq, Sk, H, KH, D, causal)
FWD_SHAPES = {"zamba2-2.7b": (4, 1024, 1024, 32, 32, 80, True),
              "qwen3-14b": (4, 1024, 1024, 40, 8, 128, True),
              "qwen2-0.5b": (4, 1024, 1024, 14, 2, 64, True),
              "seamless cross": (4, 128, 1024, 16, 16, 64, False)}
BWD_SHAPES = {"qwen2-0.5b": (4, 1024, 14, 2, 64),      # (B, S, H, KH, D)
              "qwen3-14b": (4, 1024, 40, 8, 128)}
KERNELS = ("flash_attention_bwd_dq", "flash_attention_bwd_dkdv")
BF16_FLOPS_PER_S, BYTES_PER_S = 989e12, 3.35e12


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def rn_bf16(dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return lambda shape: (torch.randn(shape, generator=g, device=dev)
                          * 0.5).to(torch.bfloat16)


def fwd_bound_ms(B, Sq, Sk, H, KH, D, causal) -> tuple:
    """(ms, "bytes" or "operations"): q, k, v read once and o written
    once, against the two products over the (query, key) pairs the mask
    keeps (the causal triangle, top-left, or all of Sq x Sk)."""
    pairs = B * H * sum(min(i + 1, Sk) if causal else Sk for i in range(Sq))
    t_bytes = (2 * H * Sq + 2 * KH * Sk) * B * D * 2 / BYTES_PER_S * 1e3
    t_ops = 4 * pairs * D / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_device_ms(q, k, v, H, KH, causal):
    """Device ms of one ``scaled_dot_product_attention`` call's kernels on
    the [B, heads, S, D] transposes of the inputs, from the profiler."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    fn = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                enable_gqa=H != KH)
    fn()
    torch.cuda.synchronize()
    iters = 10
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
    except Exception:                   # the profiler is optional here
        return None
    return total / 1e3 / iters if total > 0 else None


def measure_fwd(dev) -> dict:
    """{shape: {metric: value}} of the forward for one run."""
    out = {}
    for name, (B, Sq, Sk, H, KH, D, causal) in FWD_SHAPES.items():
        rn = rn_bf16(dev, Sq + Sk + H + D)
        q = rn((B, Sq, H, D))
        k, v = rn((B, Sk, KH, D)), rn((B, Sk, KH, D))
        fn = lambda: flash_attention_cuda(q, k, v, causal)
        rec = {"device ms": probes.profile_device_ms(
            {"fwd": (fn, "flash_attention_")}, iters=10)["fwd"],
               "host us": host_us(fn),
               "SDPA device ms": sdpa_device_ms(q, k, v, H, KH, causal),
               "bound ms": fwd_bound_ms(B, Sq, Sk, H, KH, D, causal)[0]}
        out[name] = rec
    return out


def bwd_calls(dev, B, S, H, KH, D, seed=0):
    """{kernel: wrapper call} and the pair's call on seeded bf16 inputs,
    o and lse from the forward kernel."""
    rn = rn_bf16(dev, seed)
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


def measure_bwd(dev) -> dict:
    """{shape: {metric: value}} of the backward for one run."""
    out = {}
    for name, shape in BWD_SHAPES.items():
        fns, pair = bwd_calls(dev, *shape)
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


def report(tag, tree, card, shapes, runs):
    for name, shape in shapes.items():
        for metric in runs[0][name]:
            got = [r[name][metric] for r in runs]
            vals = [x for x in got if x is not None]
            print(f"[{tag}] {tree}: {name} {shape} {metric} "
                  + ", ".join("not measured" if x is None else f"{x:.5f}"
                              for x in got)
                  + (f" (median {statistics.median(vals):.5f})" if vals
                     else "") + f" [{card}]", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--part", choices=("fwd", "bwd", "all"), default="all")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("attention_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = card_line()
    tree = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if args.part in ("fwd", "all"):
        measure_fwd(dev)                            # unrecorded
        runs = [measure_fwd(dev) for _ in range(args.reps)]
        shapes = {n: "(B={} Sq={} Sk={} H={} KH={} D={} bf16 causal={})"
                  .format(*s) for n, s in FWD_SHAPES.items()}
        report("attention_fwd", tree, card, shapes, runs)
        for n, s in FWD_SHAPES.items():
            print(f"[attention_fwd] {n}: bound by {fwd_bound_ms(*s)[1]}",
                  flush=True)
    if args.part in ("bwd", "all"):
        measure_bwd(dev)                            # unrecorded
        runs = [measure_bwd(dev) for _ in range(args.reps)]
        shapes = {n: "(B={} S={} H={} KH={} D={} bf16 causal)".format(*s)
                  for n, s in BWD_SHAPES.items()}
        report("attention_bwd", tree, card, shapes, runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
