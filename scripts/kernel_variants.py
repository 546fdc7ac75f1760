"""Where the hand-written kernels spend their time, on one CUDA device.

    python3 scripts/kernel_variants.py

Four measurements, each printed as lines with the card's name and power
limit (``nvidia-smi``):

* ``flash_attention``: the kernel at the serve path's shape
  ([4, 1024, 32, 80] causal) and at longer and narrower ones, beside
  ``scaled_dot_product_attention`` as a yardstick;
* ``ssd_scan``: the kernel at the serve path's shape and layout (x / dA as
  views of [4, 1024, 80, .], N = P = 64, chunk 128), then builds of
  ``csrc/ssd_scan.cu`` with ``-DSSD_CUT=<bits>``, each cutting phases out
  of the chunk loop: the state product, the intra-chunk products, the
  whole y phase, or every product.  Their outputs are wrong by design;
  only their times are read;
* dependent-load latency: one thread chasing a random cycle of 128-byte
  lines with ``ld.global.cg``, over 8 MB (held in the 50 MB L2) and over
  2 GB (device memory, TLB misses included), in ns per load;
* ``commit_loop``: one postsi SmallBank wave over the 1,000,000-account
  store (V=8) at T = 1, 16, 64, 256 and 1024, in ms per wave and us per
  step, beside T times the L2 latency (the bound of T serially dependent
  steps).

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

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention_cuda  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_cuda  # noqa: E402

# one thread chasing next[] (a random cycle over line-aligned ints), each
# load through L2 only; a tool of this script, never part of the port
CHASE_CU = r"""
#include <cuda_runtime.h>
__global__ void chase(const int* next, int steps, int* out) {
  int p = 0;
  for (int s = 0; s < steps; ++s) p = __ldcg(next + p);
  *out = p;
}
extern "C" int chase_launch(const void* next, int steps, void* out,
                            void* stream) {
  chase<<<1, 1, 0, (cudaStream_t)stream>>>((const int*)next, steps,
                                           (int*)out);
  return (int)cudaGetLastError();
}
"""
LINE_INTS = 32                       # 128-byte lines

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


def build_cut(bits: int):
    """ssd_scan.cu built alone with SSD_CUT=bits into its own library;
    returns its ssd_scan_launch."""
    out = build.build_dir() / "variants" / f"ssd_cut{bits}"
    out.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, f"-DSSD_CUT={bits}",
                    "-shared", str(build.CSRC / "ssd_scan.cu"), "-o",
                    str(out / "lib.so")], check=True, capture_output=True)
    fn = ctypes.CDLL(str(out / "lib.so")).ssd_scan_launch
    fn.argtypes = build.SIGNATURES["ssd_scan_launch"]
    fn.restype = ctypes.c_int
    return fn


def time_with(fn, call) -> float:
    """The time of ``call`` with ssd_scan_launch replaced by ``fn``."""
    lib = build.library()
    full = lib.ssd_scan_launch
    lib.ssd_scan_launch = fn
    try:
        return cuda_ms(call)
    finally:
        lib.ssd_scan_launch = full


def build_chase():
    out = build.build_dir() / "variants" / "chase"
    out.mkdir(parents=True, exist_ok=True)
    (out / "chase.cu").write_text(CHASE_CU)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
                    str(out / "chase.cu"), "-o", str(out / "lib.so")],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(out / "lib.so")).chase_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def chase_ns(fn, n_bytes: int, steps: int, warm: bool) -> float:
    """ns per dependent load over a random cycle of n_bytes / 128 lines;
    ``warm``: the cycle is walked once first and the chase timed three
    times (it stays in L2), else timed once from cold lines."""
    dev = torch.device("cuda")
    n = n_bytes // (4 * LINE_INTS)
    perm = torch.randperm(n, device=dev) * LINE_INTS
    nxt = torch.zeros(n * LINE_INTS, dtype=torch.int32, device=dev)
    nxt[perm] = torch.roll(perm, -1).to(torch.int32)
    out = torch.empty(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    call = lambda k: fn(nxt.data_ptr(), k, out.data_ptr(), stream)
    if warm:
        call(n)
    torch.cuda.synchronize()
    short = cuda_ms(lambda: call(1), iters=5, warmup=1)
    full = cuda_ms(lambda: call(steps), iters=3 if warm else 1, warmup=0)
    return (full - short) * 1e6 / (steps - 1)


def commit_loop_steps(card, l2_ns):
    """commit_loop per wave and per step at growing T, beside T x L2."""
    import numpy as np
    from repro_torch.core import LocalSubstrate, make_store
    from repro_torch.core.engine import wave_read_phase
    from repro_torch.core.workloads import smallbank_waves
    from repro_torch.kernels.commit_loop import commit_loop_cuda
    dev = torch.device("cuda")
    store = make_store(1_000_000, 8, device=dev)
    sub = LocalSubstrate("torch", dev)
    for T in (1, 16, 64, 256, 1024):
        (wave,) = smallbank_waves(np.random.RandomState(2), 1, T, 8,
                                  125_000, dist_frac=0.2, device=dev)
        inputs = wave_read_phase(sub, store, wave, 1, 1, sched="postsi")
        ms = cuda_ms(lambda: commit_loop_cuda(
            store, inputs, sched="postsi", n_nodes=8, gc_track=True,
            gc_block=False), iters=20, warmup=2)
        print(f"commit_loop postsi SmallBank T={T}: {ms:.4f} ms/wave, "
              f"{1e3 * ms / T:.3f} us/step; T x L2 latency "
              f"{T * l2_ns * 1e-6:.4f} ms [{card}]", flush=True)


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
    call = lambda: ssd_cuda(x, dA, Bm, Cm, 80, 128)
    print(f"ssd_scan x [4, 80, 1024, 64] (model layout), N=64, chunk 128: "
          f"{cuda_ms(call):.4f} ms [{card}]", flush=True)
    for name, bits in SSD_CUTS.items():
        print(f"ssd_scan {name}: {time_with(build_cut(bits), call):.4f} ms "
              f"[{card}]", flush=True)
    del x, dA, Bm, Cm

    chase = build_chase()
    l2_ns = chase_ns(chase, 8 << 20, 200_000, warm=True)
    hbm_ns = chase_ns(chase, 2 << 30, 100_000, warm=False)
    print(f"dependent ld.global.cg latency: {l2_ns:.1f} ns over 8 MB (L2), "
          f"{hbm_ns:.1f} ns over 2 GB (device memory) [{card}]", flush=True)
    commit_loop_steps(card, l2_ns)
    return 0


if __name__ == "__main__":
    sys.exit(main())
