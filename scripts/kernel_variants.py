"""Where the bf16 model kernels spend their time, on one CUDA device.

    python3 scripts/kernel_variants.py

Two measurements, each printed as one line with the card's name and power
limit (``nvidia-smi``):

* ``flash_attention``: the kernel at the serve path's shape
  ([4, 1024, 32, 80] causal) and at longer and narrower ones, beside
  ``scaled_dot_product_attention`` as a yardstick;
* ``ssd_scan``: the kernel at the serve path's shape and layout (x / dA as
  views of [4, 1024, 80, .], N = P = 64, chunk 128), then builds of
  ``csrc/ssd_scan.cu`` with ``-DSSD_CUT=<bits>``, each cutting phases out
  of the chunk loop: the state product, the intra-chunk products, the
  whole y phase, or every product.  Their outputs are wrong by design;
  only their times are read.

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
    return 0


if __name__ == "__main__":
    sys.exit(main())
