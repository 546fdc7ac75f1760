"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` at first use, one
``nvcc -c`` per source, all started together, then linked into one shared
library with a plain C interface that ``ctypes`` loads.  The library lands
in ``build/kernels/<hash>/`` at the repository root (``.gitignore`` lists
``build/``), or under ``$REPRO_TORCH_BUILD_DIR``; the hash covers the
sources and the flags, so an edited source rebuilds.

Every C entry point takes its pointers and the CUDA stream as ``void*``
(``ctypes.c_void_p``) and returns ``cudaGetLastError()``; :func:`launch`
raises when that is not 0 and otherwise adds one to the kernel's launch
count (:data:`LAUNCHES`).  Nothing here runs at import: the tests import
every module on machines without ``nvcc``.

The kernel route also takes ``meta`` tensors (:func:`on_card`), which
hold a shape and a dtype and no memory: a wrapper then checks its inputs
and allocates its outputs as on the card, and :func:`launch` builds and
launches nothing.  On either device :func:`launch` tells each of
:data:`WATCHERS` (``launch.op_count.OpCounter`` while it counts) of the
call with the kernel's cost, and a wrapper marked :func:`kernel_wrapper`
tells them which aten ops are its own (its outputs' allocations and
scratch), so that the kernel is counted by its cost formula alone.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]
LIB_NAME = "librepro_torch_kernels.so"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# C entry point -> argtypes (pointers and the stream as void*, sizes as int,
# element strides as long long, the softmax scale as float)
SIGNATURES = {
    "version_scan_launch": [_P] * 6 + [_I] * 3 + [_P],
    "potential_matrix_launch": [_P] * 3 + [_I] * 5 + [_P],
    "wave_commit_launch": [_P] * 16 + [_I] * 10 + [_P],
    "flash_attention_launch": [_P] * 5 + [_I] * 8 + [_F, _P],
    "flash_attention_bwd_dq_launch": [_P] * 8 + [_I] * 8 + [_F, _P],
    "flash_attention_bwd_dkdv_launch": [_P] * 8 + [_I] * 8 + [_F, _P],
    "ssd_scan_launch": [_P] * 7 + [_I] * 7 + [_L] * 11 + [_P],
    "ssd_scan_bwd_states_launch": [_P] * 8 + [_I] * 7 + [_L] * 11 + [_P],
    "ssd_scan_bwd_scan_launch": [_P] * 7 + [_I] * 3 + [_P],
    "ssd_scan_bwd_states_scan_launch": [_P] * 11 + [_I] * 6 + [_L] * 11
    + [_P],
    "ssd_scan_bwd_grads_launch": [_P] * 14 + [_I] * 7 + [_L] * 17 + [_P],
    "commit_loop_launch": [_P] * 28 + [_I] * 10 + [_P, _I, _P],
}

# launches per kernel since the last reset_launch_counts()
LAUNCHES = {"version_scan": 0, "potential_matrix": 0, "wave_commit": 0,
            "commit_loop": 0, "flash_attention": 0, "ssd_scan": 0,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkdv": 0,
            "ssd_scan_bwd_states": 0, "ssd_scan_bwd_scan": 0,
            "ssd_scan_bwd_states_scan": 0, "ssd_scan_bwd_grads": 0}

# the counters told of every kernel call, on the card or on meta (objects
# with ``kernel(name, dtype, ops, n_bytes)``), and how many kernel
# wrappers are running (:func:`kernel_wrapper`)
WATCHERS: list = []
_WRAPPER_DEPTH = [0]

# shared memory one block may use on the H100 (bytes, dynamic)
SMEM_LIMIT = 232_448

_lib = None
_lock = threading.Lock()
build_info: dict = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR",
                               REPO_ROOT / "build" / "kernels"))


def nvcc_path() -> str:
    """The nvcc that builds the kernels (also for tools that build variants
    of them)."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from kernels/csrc at "
                       "first use")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


@contextlib.contextmanager
def _file_lock(path: Path):
    """Hold an exclusive lock on ``path`` between processes (the ranks of
    a process mesh load the library at once)."""
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _build() -> Path:
    """Compile and link the library unless this source hash is built; one
    process builds while the others wait on a lock file beside it."""
    sources, headers = _sources()
    out = build_dir() / _digest(sources + headers)
    lib = out / LIB_NAME
    if lib.exists():
        build_info.update(path=str(lib), seconds=0.0, cached=True)
        return lib
    out.mkdir(parents=True, exist_ok=True)
    with _file_lock(out / "build.lock"):
        if lib.exists():
            build_info.update(path=str(lib), seconds=0.0, cached=True)
            return lib
        return _compile(sources, out, lib)


def _compile(sources, out: Path, lib: Path) -> Path:
    """Compile every source into ``out`` and link them into ``lib``."""
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = [(src, subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(out / f"{src.stem}.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src in sources]
    logs, failed = [], []
    for src, p in procs:
        text, _ = p.communicate()
        logs.append(f"== {src.name}\n{text}")
        if p.returncode != 0:
            failed.append(src.name)
    (out / "nvcc.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = out / f"{LIB_NAME}.{os.getpid()}"
    subprocess.run([nvcc, *ARCH_FLAGS, "-shared",
                    *(str(out / f"{s.stem}.o") for s in sources),
                    "-o", str(tmp)], check=True, capture_output=True)
    os.replace(tmp, lib)
    build_info.update(path=str(lib), seconds=time.perf_counter() - t0,
                      cached=False, log="\n".join(logs))
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for fn, argtypes in SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _lib = lib
    return _lib


def on_card(t) -> bool:
    """Whether the kernel route takes tensor ``t``: a CUDA tensor, or a
    ``meta`` one (shapes only: the wrapper launches nothing)."""
    return t.is_cuda or t.is_meta


def launch(name: str, entry: str, *args, on, cost) -> None:
    """Call C entry point ``entry`` of kernel ``name`` for the tensors of
    ``on``'s device; raise on a refused launch, else count it.  ``cost``:
    (operations, bytes) of the call, from the kernel module's ``*_cost``,
    told with ``on``'s dtype to each of :data:`WATCHERS`.  On a meta
    tensor nothing is built or called and :data:`LAUNCHES` stays."""
    if not on.is_meta:
        err = getattr(library(), entry)(*args)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with cudaError "
                               f"{err}")
        LAUNCHES[name] += 1
    for w in WATCHERS:
        w.kernel(name, on.dtype, *cost)


def kernel_wrapper(fn):
    """Marks ``fn`` as a kernel's wrapper: the aten ops it makes while it
    runs belong to the kernel, whose launch reports its cost
    (:func:`wrapper_depth` is above 0 meanwhile)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        _WRAPPER_DEPTH[0] += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _WRAPPER_DEPTH[0] -= 1
    return wrapped


def wrapper_depth() -> int:
    """How many kernel wrappers are running (nested calls count each)."""
    return _WRAPPER_DEPTH[0]


def check_input(name: str, t, shape, dtype, strides="contiguous") -> None:
    """The kernels take CUDA (or meta) tensors of one dtype (or one of a
    tuple of dtypes) and shape; ``strides``: "contiguous", "rows" (any
    strides but a dense last dimension) or "any"."""
    if not (isinstance(t, torch.Tensor) and on_card(t)):
        raise ValueError(f"{name}: expected a CUDA tensor, got "
                         f"{getattr(t, 'device', type(t))}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if strides == "contiguous" and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if strides == "rows" and t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: expected a dense last dimension")


def stream_of(t) -> int | None:
    """The current CUDA stream of ``t``'s device, as the raw handle a C
    entry point takes (what ``torch.cuda.current_stream(...).cuda_stream``
    gives, without building a Stream object); None for a meta tensor,
    which has no stream."""
    if t.is_meta:
        return None
    index = t.device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)
