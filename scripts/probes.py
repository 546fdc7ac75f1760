"""Measurement probes of the card, shared by ``chip_smoke.py`` and the
scripts beside this file; a tool of measurement, never part of the port.

* a pointer chase: one thread following a random cycle of 128-byte lines
  with dependent ``ld.global.cg`` loads (the latency of one dependent load
  from L2, or from device memory where the cycle exceeds the 50 MB L2), or
  a random cycle of ints in shared memory;
* an empty kernel (``probe_empty_kernel``): the device time the profiler
  shows for a launch that does nothing, the floor under every kernel;
* :func:`profile_device_ms`: kernel-only device ms a launch, by kernel
  name, from one ``torch.profiler`` session.

The probes are built with nvcc, like the port's kernels, into
``build/kernels/probes/``.  Import this module only where torch has CUDA.
"""
from __future__ import annotations

import ctypes
import subprocess

import torch

from repro_torch.kernels import build

PROBES_CU = r"""
#include <cuda_runtime.h>
__global__ void chase(const int* next, int steps, int* out) {
  int p = 0;
  for (int s = 0; s < steps; ++s) p = __ldcg(next + p);
  *out = p;
}
__global__ void chase_smem(const int* next, int n, int steps, int* out) {
  extern __shared__ int cyc[];
  for (int k = 0; k < n; ++k) cyc[k] = next[k];
  volatile int* v = cyc;
  int p = 0;
  for (int s = 0; s < steps; ++s) p = v[p];
  *out = p;
}
__global__ void probe_empty_kernel() {}
extern "C" int chase_launch(const void* next, int steps, void* out,
                            void* stream) {
  chase<<<1, 1, 0, (cudaStream_t)stream>>>((const int*)next, steps,
                                           (int*)out);
  return (int)cudaGetLastError();
}
extern "C" int chase_smem_launch(const void* next, int n, int steps,
                                 void* out, void* stream) {
  chase_smem<<<1, 1, n * sizeof(int), (cudaStream_t)stream>>>(
      (const int*)next, n, steps, (int*)out);
  return (int)cudaGetLastError();
}
extern "C" int empty_launch(void* stream) {
  probe_empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""
SMEM_CYCLE = 4096                    # ints (16 KB) of shared memory
LINE_INTS = 32                       # 128-byte lines
EMPTY_KERNEL = "probe_empty_kernel"


def build_probes() -> ctypes.CDLL:
    """The probe library (chase_launch, chase_smem_launch, empty_launch)."""
    out = build.build_dir() / "probes"
    out.mkdir(parents=True, exist_ok=True)
    (out / "probes.cu").write_text(PROBES_CU)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-shared",
                    str(out / "probes.cu"), "-o", str(out / "lib.so")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(out / "lib.so"))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.chase_launch.argtypes = [P, I, P, P]
    lib.chase_smem_launch.argtypes = [P, I, I, P, P]
    lib.empty_launch.argtypes = [P]
    for fn in (lib.chase_launch, lib.chase_smem_launch, lib.empty_launch):
        fn.restype = I
    return lib


def event_ms(fn, iters=40, warmup=5) -> float:
    """Mean ms a call over ``iters`` back-to-back calls, CUDA events."""
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


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def chase_ns(lib, n_bytes: int, steps: int, warm: bool) -> float:
    """ns per dependent load over a random cycle of n_bytes / 128 lines;
    ``warm``: the cycle is walked once first and the chase timed three
    times (it stays in L2), else timed once from cold lines."""
    dev = torch.device("cuda")
    n = n_bytes // (4 * LINE_INTS)
    perm = torch.randperm(n, device=dev) * LINE_INTS
    nxt = torch.zeros(n * LINE_INTS, dtype=torch.int32, device=dev)
    nxt[perm] = torch.roll(perm, -1).to(torch.int32)
    out = torch.empty(1, dtype=torch.int32, device=dev)
    call = lambda k: lib.chase_launch(nxt.data_ptr(), k, out.data_ptr(),
                                      _stream())
    if warm:
        call(n)
    torch.cuda.synchronize()
    short = event_ms(lambda: call(1), iters=5, warmup=1)
    full = event_ms(lambda: call(steps), iters=3 if warm else 1, warmup=0)
    return (full - short) * 1e6 / (steps - 1)


def chase_smem_ns(lib, steps: int) -> float:
    """ns per dependent load over a random cycle of SMEM_CYCLE ints in
    shared memory (the copy in is the same in both timings)."""
    dev = torch.device("cuda")
    perm = torch.randperm(SMEM_CYCLE, device=dev)
    nxt = torch.zeros(SMEM_CYCLE, dtype=torch.int32, device=dev)
    nxt[perm] = torch.roll(perm, -1).to(torch.int32)
    out = torch.empty(1, dtype=torch.int32, device=dev)
    call = lambda k: lib.chase_smem_launch(nxt.data_ptr(), SMEM_CYCLE, k,
                                           out.data_ptr(), _stream())
    short = event_ms(lambda: call(1), iters=5, warmup=1)
    full = event_ms(lambda: call(steps), iters=3, warmup=1)
    return (full - short) * 1e6 / (steps - 1)


def empty_call(lib):
    """A call that launches the empty kernel on the current stream."""
    return lambda: lib.empty_launch(_stream())


def profile_device_ms(calls: dict, iters: int) -> dict:
    """{name: device ms a launch} of ``calls`` ({name: (fn, kernel)}): each
    fn is called ``iters`` times, in turns, under one profiler session, and
    its kernel's device time (profiler events whose name holds ``kernel``)
    is divided by its launches.  None for every name where the profiler
    cannot start or shows no device time.  Two calls must not launch kernels
    of one name."""
    from torch.profiler import ProfilerActivity, profile
    for fn, _ in calls.values():
        fn()
    torch.cuda.synchronize()
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    except Exception as exc:           # the profiler is optional here
        print(f"[probes] profiler unavailable: {exc!r}", flush=True)
        prof = None
    for _ in range(iters):
        for fn, _ in calls.values():
            fn()
    torch.cuda.synchronize()
    out = dict.fromkeys(calls)
    if prof is None:
        return out
    try:
        prof.stop()
        events = prof.key_averages()
    except Exception as exc:           # the profiler is optional here
        print(f"[probes] profiler unavailable: {exc!r}", flush=True)
        return out
    for name, (_, kernel) in calls.items():
        total = n = 0
        for evt in events:
            t = getattr(evt, "device_time_total",
                        getattr(evt, "cuda_time_total", 0))
            if kernel in evt.key and t > 0:
                total, n = total + t, n + evt.count
        out[name] = total / 1e3 / n if n else None
    return out
