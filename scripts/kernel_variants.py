"""Where the hand-written kernels spend their time, on one CUDA device.

    python3 scripts/kernel_variants.py

Four measurements, each printed as lines with the card's name and power
limit (``nvidia-smi``):

* ``flash_attention``: the kernel at the serve path's shape
  ([4, 1024, 32, 80] causal) and at longer and narrower ones, beside
  ``scaled_dot_product_attention`` as a yardstick;
* ``ssd_scan``: ``ssd_scan_mma_kernel`` (asked for: the route takes the
  Hopper kernel there) at the serve path's shape and layout (x / dA as
  views of [4, 1024, 80, .], N = P = 64, chunk 128), then builds of
  ``csrc/ssd_scan.cu`` with ``-DSSD_CUT=<bits>``, each cutting phases out
  of the chunk loop: the state product, the intra-chunk products, the
  whole y phase, or every product.  Their outputs are wrong by design;
  only their times are read;
* dependent-load latency: one thread chasing a random cycle of 128-byte
  lines with ``ld.global.cg``, over 8 MB (held in the 50 MB L2) and over
  2 GB (device memory, TLB misses included), and a random cycle of ints in
  16 KB of shared memory, in ns per load;
* ``commit_loop``: one postsi SmallBank wave over the 1,000,000-account
  store (V=8) at T = 1, 16, 64, 256 and 1024 in the variant the wrapper
  picks there, in ms per wave and us per step, beside T times the L2
  latency (the bound of T serially dependent steps on the store in L2)
  and one device-memory round trip plus T shared-memory loads (the same on
  rows staged in shared memory); at T=256 both variants on the same wave
  (``global`` forced through the wrapper's ``variant`` argument), each
  also from a build of ``csrc/commit_loop.cu`` with
  ``-DCOMMIT_LOOP_RUNTIME_SHAPE`` (no copy with O=4, V=8 fixed at compile
  time), and the clock cycles of each phase of a step from a build with
  ``-DCOMMIT_LOOP_CLOCKS``.

The wrapper's host time is ``scripts/commit_loop_ab.py``'s.

Times are CUDA-event means per call after a warm-up.  Nothing of the port
imports this script.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import probes  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_cuda  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_cuda  # noqa: E402

# SSD_CUT bits of csrc/ssd_scan.cu: 1 state product, 2 C B^T and its
# product with x, 4 the whole y phase
SSD_CUTS = {
    "without the state product": 1,
    "without C B^T and its product with x": 2,
    "without the y phase (C B^T, (.) x, C h)": 4,
    "loads, cumsum and barriers only": 5,
}
FA_SHAPES = [(4, 1024, 32, 32, 80), (4, 2048, 32, 32, 80),
             (2, 4096, 32, 32, 80), (1, 8192, 32, 8, 128),
             (2, 1024, 14, 2, 64), (1, 1024, 16, 16, 80)]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=40, warmup=5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def build_flagged(source: str, define: str):
    """csrc/``source`` built alone with ``-D<define>`` into its own library
    under build/kernels/variants/, its C entry points typed as the port's."""
    out = build.build_dir() / "variants" / define.lower().replace("=", "")
    out.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, f"-D{define}",
                    "-shared", str(build.CSRC / source), "-o",
                    str(out / "lib.so")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out / "lib.so"))
    for entry, argtypes in build.SIGNATURES.items():
        if hasattr(lib, entry):
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
    return lib


def time_with(entry: str, fn, call) -> float:
    """The time of ``call`` with the library's C entry point ``entry``
    replaced by ``fn``."""
    lib = build.library()
    full = getattr(lib, entry)
    setattr(lib, entry, fn)
    try:
        return cuda_ms(call)
    finally:
        setattr(lib, entry, full)


CLOCK_PHASES = ("prologue: state", "prologue: rows and bits",
                "prologue: op records", "prologue: gather",
                "(A) op reads", "(A) readers walk",
                "reductions + decision",
                "install scratch", "install", "bump + push_bounds + step end",
                "epilogue")
PER_LAUNCH = (0, 1, 2, 3, 10)          # the other phases run once a step


def phase_clocks(card, store, inputs, kw, launches=20):
    """commit_loop.cu built with -DCOMMIT_LOOP_CLOCKS: thread 0's clock64()
    cycles of each phase, per launch (prologue, epilogue) or per step, in
    both variants on one wave."""
    from repro_torch.kernels import commit_loop as cl
    flagged = build_flagged("commit_loop.cu", "COMMIT_LOOP_CLOCKS")
    flagged.commit_loop_clocks.argtypes = [ctypes.c_void_p]
    lib = build.library()
    full = lib.commit_loop_launch
    lib.commit_loop_launch = flagged.commit_loop_launch
    T = inputs.wave.op_kind.shape[0]
    try:
        for v in cl.VARIANTS:
            cl.commit_loop_cuda(store, inputs, variant=v, **kw)
            torch.cuda.synchronize()
            cyc = (ctypes.c_ulonglong * len(CLOCK_PHASES))()
            flagged.commit_loop_clocks(cyc)           # clears the sums
            for _ in range(launches):
                cl.commit_loop_cuda(store, inputs, variant=v, **kw)
            torch.cuda.synchronize()
            flagged.commit_loop_clocks(cyc)
            per = [c / launches / (1 if k in PER_LAUNCH else T)
                   for k, c in enumerate(cyc)]
            print(f"commit_loop T={T} {v} cycles (thread 0's clock64; "
                  f"prologue and epilogue a launch, the rest a step): "
                  + ", ".join(f"{n} {c:.0f}" for n, c in
                              zip(CLOCK_PHASES, per)) + f" [{card}]",
                  flush=True)
    finally:
        lib.commit_loop_launch = full


def commit_loop_steps(card, l2_ns, hbm_ns, smem_ns):
    """commit_loop per wave and per step at growing T in the variant the
    wrapper picks, beside T x L2 and one HBM round trip + T x shared
    memory; at T=256 both variants, each also with no compile-time shape,
    and the cycles of each phase."""
    import numpy as np
    from repro_torch.core import LocalSubstrate, make_store
    from repro_torch.core.engine import wave_read_phase
    from repro_torch.core.workloads import smallbank_waves
    from repro_torch.kernels import commit_loop as cl
    dev = torch.device("cuda")
    store = make_store(1_000_000, 8, device=dev)
    sub = LocalSubstrate("torch", dev)
    kw = dict(sched="postsi", n_nodes=8, gc_track=True, gc_block=False)
    runtime_shape = build_flagged("commit_loop.cu",
                                  "COMMIT_LOOP_RUNTIME_SHAPE")
    for T in (1, 16, 64, 256, 1024):
        (wave,) = smallbank_waves(np.random.RandomState(2), 1, T, 8,
                                  125_000, dist_frac=0.2, device=dev)
        inputs = wave_read_phase(sub, store, wave, 1, 1, sched="postsi")
        auto = cl.commit_loop_smem_bytes(T, 4, 8)[1]
        for v in (auto, "global") if T == 256 else (auto,):
            call = lambda: cl.commit_loop_cuda(store, inputs, variant=v,
                                               **kw)
            ms = cuda_ms(call, iters=20, warmup=2)
            print(f"commit_loop postsi SmallBank T={T} ({v} variant): "
                  f"{ms:.4f} ms/wave, {1e3 * ms / T:.3f} us/step; T x L2 "
                  f"latency {T * l2_ns * 1e-6:.4f} ms; HBM + T x "
                  f"shared-memory latency "
                  f"{(hbm_ns + T * smem_ns) * 1e-6:.4f} ms [{card}]",
                  flush=True)
            if T == 256:   # O, V fixed / read at run time, alternately
                rt = lambda: time_with("commit_loop_launch",
                                       runtime_shape.commit_loop_launch, call)
                fixed, rt1, rt2, fixed2 = (cuda_ms(call), rt(), rt(),
                                           cuda_ms(call))
                print(f"commit_loop postsi SmallBank T={T} ({v} variant), "
                      f"O=4 V=8 fixed at compile time / read at run time, "
                      f"alternately: {fixed:.4f} / {rt1:.4f} / {rt2:.4f} / "
                      f"{fixed2:.4f} ms/wave [{card}]", flush=True)
        if T == 256:
            phase_clocks(card, store, inputs, kw)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rn(shape, scale=0.5):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    build.library()
    model_kernels(card, rn, g, dev)
    lib = probes.build_probes()
    l2_ns = probes.chase_ns(lib, 8 << 20, 200_000, warm=True)
    hbm_ns = probes.chase_ns(lib, 2 << 30, 100_000, warm=False)
    smem_ns = probes.chase_smem_ns(lib, 200_000)
    print(f"dependent ld.global.cg latency: {l2_ns:.1f} ns over 8 MB (L2), "
          f"{hbm_ns:.1f} ns over 2 GB (device memory); dependent shared-"
          f"memory load: {smem_ns:.2f} ns [{card}]", flush=True)
    commit_loop_steps(card, l2_ns, hbm_ns, smem_ns)
    return 0


def model_kernels(card, rn, g, dev):
    """flash_attention beside SDPA; ssd_scan_mma_kernel and its SSD_CUT
    builds."""
    for B, S, H, KH, D in FA_SHAPES:
        q, k, v = rn((B, S, H, D)), rn((B, S, KH, D)), rn((B, S, KH, D))
        qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
        ms = cuda_ms(lambda: flash_attention_cuda(q, k, v))
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=KH != H))
        print(f"flash_attention B={B} S={S} H={H} KH={KH} D={D} causal: "
              f"{ms:.4f} ms, SDPA {sdpa:.4f} ms [{card}]", flush=True)
        del q, k, v, qt, kt, vt

    x = rn((4, 1024, 80, 64)).transpose(1, 2)
    dA = (-torch.rand((4, 1024, 80), generator=g, device=dev)
          * 1.4).transpose(1, 2)
    Bm, Cm = rn((4, 1024, 64), 0.3), rn((4, 1024, 64), 0.3)
    # SSD_CUT cuts phases of ssd_scan_mma_kernel, which this shape reaches
    # only when asked for (the route takes ssd_scan_wgmma_kernel)
    call = lambda: ssd_cuda(x, dA, Bm, Cm, 80, 128, kernel="mma")
    print(f"ssd_scan_mma_kernel x [4, 80, 1024, 64] (model layout), N=64, "
          f"chunk 128: {cuda_ms(call):.4f} ms [{card}]", flush=True)
    for name, bits in SSD_CUTS.items():
        cut = build_flagged("ssd_scan.cu", f"SSD_CUT={bits}")
        ms = time_with("ssd_scan_launch", cut.ssd_scan_launch, call)
        print(f"ssd_scan {name}: {ms:.4f} ms [{card}]", flush=True)


if __name__ == "__main__":
    sys.exit(main())
