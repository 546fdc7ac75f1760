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
"""
from __future__ import annotations

import ctypes
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

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argtypes (pointers and the stream as void*, sizes as int)
SIGNATURES = {
    "version_scan_launch": [_P] * 6 + [_I] * 3 + [_P],
    "potential_matrix_launch": [_P] * 3 + [_I] * 2 + [_P],
    "wave_commit_launch": [_P] * 16 + [_I] * 4 + [_P],
}

# launches per kernel since the last reset_launch_counts()
LAUNCHES = {"version_scan": 0, "potential_matrix": 0, "wave_commit": 0}

_lib = None
_lock = threading.Lock()
build_info: dict = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR",
                               REPO_ROOT / "build" / "kernels"))


def _nvcc() -> str:
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


def _build() -> Path:
    """Compile and link the library unless this source hash is built."""
    sources, headers = _sources()
    out = build_dir() / _digest(sources + headers)
    lib = out / LIB_NAME
    if lib.exists():
        build_info.update(path=str(lib), seconds=0.0, cached=True)
        return lib
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
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


def launch(name: str, entry: str, *args) -> None:
    """Call C entry point ``entry`` of kernel ``name``; raise on a refused
    launch, else count it."""
    err = getattr(library(), entry)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    LAUNCHES[name] += 1


def check_input(name: str, t, shape, dtype) -> None:
    """The kernels take contiguous CUDA tensors of one dtype and shape."""
    if not (isinstance(t, torch.Tensor) and t.is_cuda):
        raise ValueError(f"{name}: expected a CUDA tensor, got "
                         f"{getattr(t, 'device', type(t))}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
