"""Device time of the SSD scan's backward kernels at the training shapes,
for the checkout this file sits in, on one CUDA device.

    python3 scripts/ssd_bwd_ab.py [--reps N]

Shapes (batch 4, S = 1,024, chunk 128, bf16; x, dA and dy as the views of
the model's [B, S, H, .] layout that ``models/ssm.py`` passes):
zamba2-2.7b's 80 heads of P = 64 over N = 64, and mamba2-130m's 24 heads
of P = 64 over N = 128.  At each: the profiler's kernel-only device ms a
launch of ``ssd_scan_bwd_states``, ``ssd_scan_bwd_scan`` (which rewrites
its inputs in place: the same work at every call) and
``ssd_scan_bwd_grads``, one kernel a profiler session, and of the forward
kernel the path runs at that shape.  Everything once unrecorded, then
``--reps`` times; every run and the median are printed with the card's
name and power limit.  To compare two trees copy this file and
``probes.py`` into the other checkout's ``scripts/`` and run the two in
alternating processes (A, B, B, A).  Nothing of the port imports this
script.
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
from repro_torch.kernels import ssd_scan as ss  # noqa: E402

B, S, P, Q = 4, 1024, 64, 128
SHAPES = {"zamba2-2.7b": (80, 64), "mamba2-130m": (24, 128)}   # (H, N)
KERNELS = ("ssd_scan_bwd_states", "ssd_scan_bwd_scan", "ssd_scan_bwd_grads")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def calls(dev, H, N, seed=0) -> dict:
    """{kernel: (wrapper call, the profiler's kernel name)} at (H, N) on
    seeded inputs in the model's layout; the scan and grads kernels on
    the outputs of the kernels before them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device=dev)
    x, dy = ((rn(B, S, H, P) * 0.5).to(torch.bfloat16).transpose(1, 2)
             for _ in range(2))
    dA = (-torch.rand((B, S, H), generator=g, device=dev) * 1.4).transpose(
        1, 2)
    Bm, Cm = ((rn(B, S, N) * 0.3).to(torch.bfloat16) for _ in range(2))
    st, U, aL = ss.ssd_bwd_states_cuda(x, dA, Bm, Cm, dy, H, Q)
    hp, G, _, sc = ss.ssd_bwd_scan_cuda(st.clone(), U.clone(), aL)
    forward = f"ssd_scan_{ss.ssd_kernel(P, N, Q, S, torch.bfloat16)}_kernel"
    return {"ssd_scan_bwd_states": (lambda: ss.ssd_bwd_states_cuda(
                x, dA, Bm, Cm, dy, H, Q), "ssd_scan_bwd_states_kernel"),
            "ssd_scan_bwd_scan": (lambda: ss.ssd_bwd_scan_cuda(st, U, aL),
                                  "ssd_scan_bwd_scan_kernel"),
            "ssd_scan_bwd_grads": (lambda: ss.ssd_bwd_grads_cuda(
                x, dA, Bm, Cm, dy, hp, G, sc, H, Q),
                "ssd_scan_bwd_grads_kernel"),
            "forward": (lambda: ss.ssd_cuda(x, dA, Bm, Cm, H, Q), forward)}


def measure(dev) -> dict:
    """{shape: {kernel: device ms a launch, or None}} for one run."""
    out = {}
    for name, (H, N) in SHAPES.items():
        out[name] = {k: probes.profile_device_ms({k: call}, iters=10)[k]
                     for k, call in calls(dev, H, N).items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    reps = ap.parse_args(argv).reps
    if not torch.cuda.is_available():
        print("ssd_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = card_line()
    tree = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    measure(dev)                                # unrecorded
    runs = [measure(dev) for _ in range(reps)]
    for name, (H, N) in SHAPES.items():
        label = (f"[ssd_bwd_ab] {tree}: {name}'s training shape (B={B} "
                 f"S={S} H={H} P={P} N={N} chunk {Q} bf16)")
        for kernel in (*KERNELS, "forward"):
            got = [r[name][kernel] for r in runs]
            vals = [v for v in got if v is not None]
            print(f"{label} {kernel} device ms "
                  + ", ".join("not measured" if v is None else f"{v:.5f}"
                              for v in got)
                  + (f" (median {statistics.median(vals):.5f})" if vals
                     else "") + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
