"""Device time of the SSD scan's backward kernels at the training shapes,
for the checkout this file sits in, on one CUDA device.

    python3 scripts/ssd_bwd_ab.py [--reps N] [--cut [FORM]]

Shapes (batch 4, S = 1,024, chunk 128, bf16; x, dA and dy as the views of
the model's [B, S, H, .] layout that ``models/ssm.py`` passes):
zamba2-2.7b's 80 heads of P = 64 over N = 64, and mamba2-130m's 24 heads
of P = 64 over N = 128.  At each: the profiler's kernel-only device ms a
launch of ``ssd_scan_bwd_states``, ``ssd_scan_bwd_scan`` (which rewrites
its inputs in place: the same work at every call) and
``ssd_scan_bwd_grads`` in the form the route table names, one kernel a
profiler session, of the states and grads kernels' ``mma.sync`` forms
where the checkout can ask for them (``kernel="mma"``; labelled
``(mma)``), of ``ssd_scan_bwd_states_scan`` (the states and the scan as
one launch, where the checkout has it) beside the states kernel plus the
scan kernel of the same run, and of the forward kernel the path runs at
that shape.
Everything once unrecorded, then ``--reps`` times; every run and the
median are printed with the card's name and power limit.  To compare two
trees copy this file and ``probes.py`` into the other checkout's
``scripts/`` and run the two in alternating processes (A, B, B, A).

``--cut`` (all forms, or one of ``mma.sync``, ``Hopper``, ``fused``):
where the grads kernel's and the fused kernel's time goes, from builds of
``csrc/ssd_scan_bwd.cu`` alone: the ``mma.sync`` form with
``-DSB_CUT=<bits>`` (0: whole; 1: without the head sum of dB and dC, the
counter and the last block's reads; 3: also without each head's rows
written to the float32 scratch) and the Hopper form with
``-DSBW_CUT=<bits>`` (1: without the walks' mask and decay; 2: without
their fed-back products; 4: without their score products; 7: none of
the three), and the fused states and scan kernel with
``-DSBF_CUT=<bits>`` (1: without the scans; 2: without the stores of
hprev, G and dh0): device ms at both shapes, each build a profiler
session, the first round unrecorded.
Their outputs are wrong by design; only their
times are read.

``--clocks``: the Hopper grads kernel's phases in cycles, from a build
with ``-DSBW_CLOCKS=1`` (``clock_phases``).  Nothing of the port imports
this script.
"""
from __future__ import annotations

import argparse
import inspect
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
# the forms a checkout can ask for: this tree's wrappers take kernel=
FORMS = "kernel" in inspect.signature(ss.ssd_bwd_grads_cuda).parameters
# the states and the scan as one launch, where the checkout has it
FUSED = ("ssd_scan_bwd_states_scan"
         if hasattr(ss, "ssd_bwd_states_scan_cuda") else None)
CUTS = {"whole": 0, "without the head sum": 1,
        "without the head sum and the scratch writes": 3}
# SBW_CUT bits of the Hopper grads kernel's timing builds
HOPPER_CUTS = {"whole": 0, "without the walks' mask and decay": 1,
               "without the walks' fed-back products": 2,
               "without the walks' score products": 4,
               "without the walks' products, mask and decay": 7}
# SBF_CUT bits of the fused states and scan kernel's timing builds
FUSED_CUTS = {"whole": 0, "without the scans": 1,
              "without the stores of hprev, G and dh0": 2}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def kernel_name(name: str, form: str) -> str:
    """The profiler's name of ``name``'s CUDA function in ``form``."""
    return f"{name}_wgmma_kernel" if form == "wgmma" else f"{name}_kernel"


def calls(dev, H, N, seed=0) -> dict:
    """{label: (wrapper call, the profiler's kernel name)} at (H, N) on
    seeded inputs in the model's layout; the scan and grads kernels on
    the outputs of the kernels before them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device=dev)
    x, dy = ((rn(B, S, H, P) * 0.5).to(torch.bfloat16).transpose(1, 2)
             for _ in range(2))
    dA = (-torch.rand((B, S, H), generator=g, device=dev) * 1.4).transpose(
        1, 2)
    Bm, Cm = ((rn(B, S, N) * 0.3).to(torch.bfloat16) for _ in range(2))
    # the later kernels' inputs from the mma.sync form, where the tree has
    # a choice (the same values: only inputs)
    first = {"kernel": "mma"} if FORMS else {}
    st, U, aL = ss.ssd_bwd_states_cuda(x, dA, Bm, Cm, dy, H, Q, **first)
    hp, G, _, sc = ss.ssd_bwd_scan_cuda(st.clone(), U.clone(), aL)
    forward = f"ssd_scan_{ss.ssd_kernel(P, N, Q, S, torch.bfloat16)}_kernel"
    routed = (ss.ssd_bwd_kernel(P, N, Q, S, torch.bfloat16) if FORMS
              else "mma")
    out = {}
    for form in ((routed, "mma") if FORMS and routed != "mma" else (None,)):
        kw = {} if form is None else {"kernel": form}
        tag = "" if form in (None, routed) else f" ({form})"
        out[f"ssd_scan_bwd_states{tag}"] = (
            lambda kw=kw: ss.ssd_bwd_states_cuda(x, dA, Bm, Cm, dy, H, Q,
                                                 **kw),
            kernel_name("ssd_scan_bwd_states", form or routed))
        out[f"ssd_scan_bwd_grads{tag}"] = (
            lambda kw=kw: ss.ssd_bwd_grads_cuda(x, dA, Bm, Cm, dy, hp, G, sc,
                                                H, Q, **kw),
            kernel_name("ssd_scan_bwd_grads", form or routed))
    out["ssd_scan_bwd_scan"] = (lambda: ss.ssd_bwd_scan_cuda(st, U, aL),
                                "ssd_scan_bwd_scan_kernel")
    if FUSED and ss.ssd_bwd_fused(P, N, Q, S, torch.bfloat16):
        out[FUSED] = (lambda: ss.ssd_bwd_states_scan_cuda(x, dA, Bm, Cm, dy,
                                                          H, Q),
                      f"{FUSED}_wgmma_kernel")
    out["forward"] = (lambda: ss.ssd_cuda(x, dA, Bm, Cm, H, Q), forward)
    return out


def measure(dev) -> dict:
    """{shape: {label: device ms a launch, or None}} for one run."""
    out = {}
    for name, (H, N) in SHAPES.items():
        out[name] = {k: probes.profile_device_ms({k: call}, iters=10)[k]
                     for k, call in calls(dev, H, N).items()}
    return out


def cut_times(dev, card: str, only: str = "all") -> None:
    """The grads kernel's device ms from the timing builds: the mma.sync
    form's SB_CUT builds and, where the tree has them, the Hopper form's
    SBW_CUT builds and the fused states and scan kernel's SBF_CUT
    builds."""
    from concurrent.futures import ThreadPoolExecutor
    from kernel_variants import build_flagged
    from repro_torch.kernels import build
    grads = "ssd_scan_bwd_grads_launch"
    sets = [("mma.sync", "SB_CUT", CUTS,
             "ssd_scan_bwd_grads (mma)" if FORMS else "ssd_scan_bwd_grads",
             grads)]
    if FORMS:
        sets.append(("Hopper", "SBW_CUT", HOPPER_CUTS, "ssd_scan_bwd_grads",
                     grads))
    if FUSED:
        sets.append(("fused", "SBF_CUT", FUSED_CUTS, FUSED,
                     f"{FUSED}_launch"))
    sets = [t for t in sets if only in ("all", t[0])]
    jobs = [(form, macro, label, bits) for form, macro, cuts, *_ in sets
            for label, bits in cuts.items()]
    with ThreadPoolExecutor(len(jobs)) as pool:   # one nvcc each, together
        futs = {(form, label): pool.submit(build_flagged, "ssd_scan_bwd.cu",
                                           f"{macro}={bits}")
                for form, macro, label, bits in jobs}
        libs = {key: f.result() for key, f in futs.items()}
    lib = build.library()
    for name, (H, N) in SHAPES.items():
        for form, macro, cuts, key, entry in sets:
            call, kname = calls(dev, H, N)[key]
            full = getattr(lib, entry)
            got = {}
            try:
                for rep in range(2):
                    for label in cuts:
                        setattr(lib, entry, getattr(libs[form, label], entry))
                        got[label] = probes.profile_device_ms(
                            {label: (call, kname)}, iters=10)[label]
            finally:
                setattr(lib, entry, full)
            for label, ms in got.items():
                print(f"[ssd_bwd_ab] cut: {name}'s training shape (B={B} "
                      f"S={S} H={H} P={P} N={N} chunk {Q} bf16) {form} "
                      f"{key} {label} (-D{macro}="
                      f"{cuts[label]}): device ms "
                      + ("not measured" if ms is None else f"{ms:.5f}")
                      + f" [{card}]", flush=True)


PHASES = ("hprev and G to hi + lo", "the state products", "sync",
          "the column walk", "dx out", "the row walk", "sync",
          "dA, to the next head")


def clock_phases(dev, card: str) -> None:
    """The Hopper grads kernel's phases, from a build of
    ``csrc/ssd_scan_bwd.cu`` with ``-DSBW_CLOCKS=1``: clock64() cycles of
    each phase of a head in the first block of the grid (its heads after
    the first, mean; each warp group), and the cluster size the kernel
    takes there."""
    import ctypes
    from kernel_variants import build_flagged
    from repro_torch.kernels import build
    lib, entry = build.library(), "ssd_scan_bwd_grads_launch"
    marked = build_flagged("ssd_scan_bwd.cu", "SBW_CLOCKS=1")
    full = getattr(lib, entry)
    for name, (H, N) in SHAPES.items():
        call, kname = calls(dev, H, N)["ssd_scan_bwd_grads"]
        setattr(lib, entry, getattr(marked, entry))
        try:
            ms = probes.profile_device_ms({name: (call, kname)},
                                          iters=10)[name]
            call()
            torch.cuda.synchronize()
        finally:
            setattr(lib, entry, full)
        buf = (ctypes.c_longlong * (2 * 24 * 8))()
        csz = ctypes.c_int(0)
        err = marked.sbw_clocks_read(buf, N // 64, H, B * (S // Q),
                                     ctypes.byref(csz))
        if err:
            raise RuntimeError(f"sbw_clocks_read: cudaError {err}")
        heads = min(24, H // csz.value)   # block 0's
        t = [[[buf[(g * 24 + k) * 8 + m] for m in range(8)]
              for k in range(heads)] for g in range(2)]
        for g in range(2):
            per = []
            for m in range(8):
                d = [(t[g][k + 1][0] if m == 7 else t[g][k][m + 1])
                     - t[g][k][m] for k in range(1, heads - 1)]
                per.append(sum(d) / len(d))
            print(f"[ssd_bwd_ab] clocks: {name}'s training shape (H={H} "
                  f"N={N}), warp group {g}, cycles a head (mean of heads "
                  f"1..{heads - 2} of block 0): "
                  + ", ".join(f"{p} {c:.0f}" for p, c in zip(PHASES, per))
                  + f"; a head {sum(per):.0f}; device ms of the marked "
                  f"build {ms}; clusters of {csz.value} blocks "
                  f"[{card}]", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cut", nargs="?", const="all",
                    choices=("all", "mma.sync", "Hopper", "fused"))
    ap.add_argument("--clocks", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssd_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = card_line()
    if args.cut:
        cut_times(dev, card, args.cut)
        return 0
    if args.clocks:
        clock_phases(dev, card)
        return 0
    tree = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    measure(dev)                                # unrecorded
    runs = [measure(dev) for _ in range(args.reps)]
    for name, (H, N) in SHAPES.items():
        label = (f"[ssd_bwd_ab] {tree}: {name}'s training shape (B={B} "
                 f"S={S} H={H} P={P} N={N} chunk {Q} bf16)")
        for r in runs:
            pair = [r[name].get(k) for k in KERNELS[:2]]
            r[name]["states + scan"] = (None if None in pair
                                        else sum(pair))
        for kernel in runs[0][name]:
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
