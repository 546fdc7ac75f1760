"""The kernel-backend plane: one resolved config for every data-plane op.

Counterpart of ``repro.kernels.backend``.  Every compute hot spot the
engine dispatches — the read-phase latest-visible-version selection
(``ops.version_scan``), the anti-dependency candidate build
(``ops.potential_matrix``), the fused read phase (``ops.wave_commit``) and
the commit loop (``ops.commit_loop``) — routes through a single :class:`KernelConfig` threaded as a field of the
data-access substrate (``core.substrate``).

Backends:

  ``cuda``   the hand-written CUDA kernels (``kernels/csrc/*.cu``), built
             with ``nvcc`` for ``sm_90a`` at first use.  Needs CUDA tensors:
             a ``cuda`` config used with CPU tensors raises — it is never
             served by the plain version (no silent degrade).
  ``torch``  the plain PyTorch versions (``kernels.ref``) on any device —
             the differential-test oracle on the card and the CPU route.
  ``auto``   resolves to ``cuda`` on a CUDA device and to ``torch`` on the
             CPU.  Only accepted as *input*; a resolved config never
             carries it.

Fusion: orthogonally to the backend, ``KernelConfig(fused=True)`` (or a
``"+fused"`` suffix on the name) routes the whole wave read phase through
the single-launch ``ops.wave_commit`` instead of three dispatches.

Process default: env ``REPRO_TORCH_KERNEL_BACKEND`` (default ``auto``) with
env ``REPRO_TORCH_KERNEL_FUSED=1`` forcing the fused route;
``set_default_backend`` switches it.  PyTorch runs eagerly, so there is no
trace cache to clear.

Devices: the port's entry points run on the card.  ``device=None`` means
``cuda``; with no CUDA device it raises instead of quietly running on the
CPU.  Pass ``device="cpu"`` to ask for the CPU.
"""
from __future__ import annotations

import dataclasses
import os

import torch

BACKENDS = ("cuda", "torch")
_INPUT_BACKENDS = BACKENDS + ("auto",)
_FUSED_SUFFIX = "+fused"


def resolve_device(device=None) -> torch.device:
    """``None`` -> the first CUDA device, raising when there is none;
    anything else -> ``torch.device(device)`` (a CUDA request is checked
    for a device too)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch route "
            "on the CPU")
    return dev


def _parse_spec(name: str):
    """Split an input spec into (base backend name, fused flag)."""
    fused = name.endswith(_FUSED_SUFFIX)
    return (name[:-len(_FUSED_SUFFIX)] if fused else name), fused


def _resolve_name(name: str, device=None) -> str:
    if name not in _INPUT_BACKENDS:
        raise ValueError(f"unknown kernel backend {name!r}; "
                         f"expected one of {_INPUT_BACKENDS}")
    if name != "auto":
        return name
    if device is None:
        return "cuda" if torch.cuda.is_available() else "torch"
    return "cuda" if torch.device(device).type == "cuda" else "torch"


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """Resolved kernel-backend choice for one substrate/engine instance.

    Frozen + hashable.  ``backend`` is always a member of :data:`BACKENDS`;
    ``"auto"`` given here resolves eagerly by whether CUDA is available
    (use :func:`resolve` with a ``device`` to resolve against the device a
    store lives on).  A ``"+fused"`` suffix on the name sets ``fused``.
    """
    backend: str = "auto"
    fused: bool = False

    def __post_init__(self):
        base, fused = _parse_spec(self.backend)
        object.__setattr__(self, "backend", _resolve_name(base))
        if fused:
            object.__setattr__(self, "fused", True)

    @property
    def use_kernel(self) -> bool:
        """The ``use_kernel`` flag of the ``kernels.ops`` wrappers."""
        return self.backend == "cuda"

    @property
    def name(self) -> str:
        """Round-trippable spec string (``resolve(cfg.name) == cfg``)."""
        return self.backend + (_FUSED_SUFFIX if self.fused else "")

    def check_device(self, device) -> None:
        """Raise if this config cannot run on ``device``: the CUDA kernels
        take CUDA tensors only and are never replaced by the plain
        version."""
        if self.use_kernel and torch.device(device).type != "cuda":
            raise ValueError(
                f"KernelConfig({self.name!r}) runs the CUDA kernels and "
                f"cannot serve tensors on {device}; use 'torch' (or 'auto') "
                f"for the plain PyTorch route")


def resolve(spec=None, device=None) -> KernelConfig:
    """Normalize ``None`` (process default) / backend name / config into a
    resolved :class:`KernelConfig`.  With ``device`` given, ``auto``
    resolves against it and the result is checked to run there."""
    if spec is None:
        spec = _default
    if isinstance(spec, KernelConfig):
        cfg = spec
    else:
        base, fused = _parse_spec(spec)
        cfg = KernelConfig(_resolve_name(base, device), fused)
    if device is not None:
        cfg.check_device(device)
    return cfg


# ---------------------------------------------------------------------------
# process default
# ---------------------------------------------------------------------------

_default = os.environ.get("REPRO_TORCH_KERNEL_BACKEND", "auto")
if os.environ.get("REPRO_TORCH_KERNEL_FUSED", "") not in ("", "0") \
        and not _default.endswith(_FUSED_SUFFIX):
    _default = _default + _FUSED_SUFFIX


def set_default_backend(name: str) -> None:
    """Switch the process-default backend (accepts ``auto`` and a
    ``"+fused"`` suffix)."""
    global _default
    base, _ = _parse_spec(name)
    if base not in _INPUT_BACKENDS:
        raise ValueError(f"unknown kernel backend {name!r}")
    _default = name


def default_backend() -> str:
    """The process-default spec, ``auto`` resolved by CUDA availability —
    the backend name plus an optional ``"+fused"`` suffix."""
    base, fused = _parse_spec(_default)
    return _resolve_name(base) + (_FUSED_SUFFIX if fused else "")
