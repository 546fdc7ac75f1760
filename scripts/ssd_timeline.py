"""Timeline of ``ssd_scan_wgmma_kernel``'s blocks at the model plane's
prefill shapes, on one CUDA device.

    python3 scripts/ssd_timeline.py

Copies the port's ``kernels`` package into ``build/ssd_timeline/`` (which
``.gitignore`` lists), writes ``%globaltimer`` marks into the copy's
``csrc/ssd_scan.cu`` (thread 0 of each warp group, into a ``__device__``
buffer that an extra C entry reads back), builds the copy and runs the bf16
scan at zamba2-2.7b's and mamba2-130m's prefill shapes (batch 4, S =
1,024, P = 64, chunk 128, model layout; a cluster of 8 blocks a
batch*head).  Prints, for each rank of a cluster, the mean over the
clusters of each mark in µs from the block's start, beside the kernel's
span, the blocks' mean lifetime and when the clusters started, with the
card's name and power limit (the marks of the N = 64 scan and of the
N = 128 chain differ).  The marks cost a global store each, so the
times run a little above the unmarked kernel's.  The port never imports
this script; the marks exist only in the copy.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
COPY = ROOT / "build" / "ssd_timeline"
B, S, P, Q, CLUSTER = 4, 1024, 64, 128, 8
SHAPES = {"zamba2-2.7b": (80, 64), "mamba2-130m": (24, 128)}   # (H, N)

# (anchor in ssd_scan.cu, mark index, before or after it); group g's mark
# k lands at slot 16 g + k of the block's 32
MARKS = [
    ("  if (threadIdx.x == 0) {\n    mbar_init(tile_full, 1);", 0, "before"),
    ("    mbar_wait(tile_full, t & 1);\n", 1, "before"),
    ("    mbar_wait(tile_full, t & 1);\n", 2, "after"),
    ("      float ax = expf(total), ay = 1.f;", 3, "before"),
    ("          ay *= ar;\n          ax *= ar;\n        }\n", "8 + k", "after"),
    ("      // Y maps to h_j (rank 0: written above)", 4, "before"),
    ("      named_arrive(4, 256);   // h's operand ready for group 1\n", 6,
     "after"),
    ("      {   // the diagonal block of this group's rows, from group 1", 5,
     "before"),
    ("          yd[4 * i + 3] = v.w;\n        }\n      }\n", 11, "after"),
    ("        named_arrive(6, 256);\n      }\n", 5, "after"),
    ("      named_sync(4, 256);\n      sw_output", 3, "before"),
    ("    __syncthreads();   // the tiles, R / hin and the arrays are free "
     "here", 7, "before"),
    # the chain (N = 128)
    ("      sw_state(st, bs + wg * SW_BOX, xs, cs2, tid);\n", 3, "after"),
    ("      const float a = exp2f(cs2[SW_Q - 1]);", 4, "before"),
    ("      named_sync(8, 256);   // hin read by both groups", 5, "before"),
    ("      named_sync(8, 256);   // h's operand whole\n", 6, "after"),
]
# what each mark means, per warp group: N = 64 (the scan), N = 128 (the
# chain)
NAMES = {64: {0: {1: "cumsum", 2: "tiles", 3: "state", 8: "step0",
                  9: "step1", 10: "step2", 4: "scanned", 6: "h_operand",
                  5: "h_written", 11: "diag_in", 7: "y_out"},
              1: {1: "cumsum", 2: "tiles", 5: "diag_given", 3: "diag_own",
                  7: "y_out"}},
         128: {wg: {1: "cumsum", 2: "tiles", 3: "state", 4: "h_in",
                    5: "sent", 6: "h_operand", 7: "y_out"}
               for wg in (0, 1)}}
HEADER = r'''__device__ unsigned long long sw_clock_buf[1 << 18];
extern "C" int ssd_clock_read(void* dst, long long bytes) {
  return (int)cudaMemcpyFromSymbol(dst, sw_clock_buf, (size_t)bytes);
}
#define SW_MARK(k)                                                          \
  if (tid == 0) {                                                           \
    unsigned long long now;                                                 \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));                 \
    sw_clock_buf[((size_t)bh * csz + rank) * 32 + wg * 16 + (k)] = now;     \
  }

'''


def marked_copy() -> pathlib.Path:
    """The kernels package copied to COPY with the marks written in."""
    dst = COPY / "src" / "repro_torch" / "kernels"
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst.parent,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / "csrc" / "ssd_scan.cu"
    text = cu.read_text()
    anchor = "static constexpr int sw_smem_bytes(int NT) {"
    text = text.replace(anchor, HEADER + anchor, 1)
    for where, k, side in MARKS:
        if text.count(where) != 1:
            raise RuntimeError(f"ssd_timeline: anchor not found once: "
                               f"{where!r}")
        mark = f"SW_MARK({k});\n"
        if side == "before":
            indent = where[:len(where) - len(where.lstrip(" "))]
            text = text.replace(where, indent + mark + where, 1)
        else:
            indent = "    " if where.startswith("    mbar") else "      "
            text = text.replace(where, where + indent + mark, 1)
    cu.write_text(text)
    return COPY / "src"


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_timeline: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(marked_copy()))
    os.environ.pop("REPRO_TORCH_BUILD_DIR", None)
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import ssd_cuda
    lib = build.library()
    lib.ssd_clock_read.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    dev, card = torch.device("cuda:0"), card_line()
    for name, (H, N) in SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(0)
        x = (torch.randn((B, S, H, P), generator=g, device=dev)
             * 0.5).bfloat16()
        dA = -torch.rand((B, S, H), generator=g, device=dev) * 1.4
        Bm, Cm = ((torch.randn((B, S, N), generator=g, device=dev)
                   * 0.3).bfloat16() for _ in range(2))
        for _ in range(3):   # the last call's marks are read
            ssd_cuda(x.transpose(1, 2), dA.transpose(1, 2), Bm, Cm, H, Q)
        torch.cuda.synchronize()
        buf = np.zeros(B * H * CLUSTER * 32, np.uint64)
        if lib.ssd_clock_read(buf.ctypes.data, buf.nbytes) != 0:
            raise RuntimeError("ssd_timeline: reading the marks failed")
        t = buf.reshape(B * H, CLUSTER, 32).astype(np.int64)
        rel = (t - t[:, :, :1]) / 1e3
        span = (t[:, :, 7].max() - t[:, :, 0].min()) / 1e3
        print(f"[ssd_timeline] {name} (B={B} S={S} H={H} P={P} N={N} "
              f"chunk {Q}): kernel span {span:.2f} us, block lifetime "
              f"mean {rel[:, :, 7].mean():.2f} us [{card}]", flush=True)
        for r in range(CLUSTER):
            for wg, names in NAMES[N].items():
                marks = [f"{n}={rel[:, r, 16 * wg + k].mean():.2f}"
                         for k, n in names.items()
                         if not (8 <= k <= 10 and r < 1 << (k - 8))]
                print(f"[ssd_timeline]   rank {r} group {wg}: "
                      + " ".join(marks), flush=True)
        starts = np.sort(t[:, 0, 0] - t[:, 0, 0].min()) / 1e3
        print("[ssd_timeline]   cluster starts, us (0, 10, 25, 50, 75, 90, "
              "100%): " + ", ".join(f"{v:.2f}" for v in np.quantile(
                  starts, [0, .1, .25, .5, .75, .9, 1])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
