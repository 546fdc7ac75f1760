"""What a call does, counted on any device: FLOPs, bytes, kernel launches
and live memory (the port's counterpart of ``repro.launch.hlo_analysis``).

The reference compiles a step with XLA and walks its HLO text: FLOPs of
every dot, operand plus result bytes of every top-level op, each times the
trip counts of its enclosing loops.  PyTorch runs eagerly, so the port
counts the ops as they run instead: :class:`OpCounter` is a
``TorchDispatchMode`` that sees every aten op a call makes, the backward
and per-layer recompute included, and counts

* FLOPs of the matrix products, by ``torch.utils.flop_counter``'s
  formulas, split by the dtype of their operands;
* bytes: operands plus result of every aten op that is not a view (the
  reference's convention of top-level operands plus result, without its
  fusion); an allocation that writes nothing (``empty``) moves none;
* each hand-written kernel by its own cost formula (the kernel modules'
  ``*_cost``, reported by ``kernels.build.launch``), not by the aten ops
  inside its wrapper: its launches, operations (in the dtype of its
  operands) and bytes;
* the peak of live tensor bytes during the call: the arguments plus every
  storage the call allocates, from its allocation to its release.

On the ``meta`` device nothing is computed and nothing is allocated, so a
full-size step counts on a machine with no card; the kernel route takes
meta tensors too and launches nothing (``kernels.build.on_card``).  A
call that reads a value on the host (``.item()``) cannot run on meta.

Not ported: the HLO parsing itself, its while-loop trip counts (every
op runs, so none is needed) and the collectives' traffic (one card has
none).
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import build
from repro_torch.kernels.roofline import ops_rate

__all__ = ["OpCounter", "count_call", "compute_seconds"]

_aten = torch.ops.aten
# ops that move no bytes: allocations that write nothing, and a view that
# is not marked as one
_NO_BYTES = {_aten.empty.memory_format, _aten.empty_strided.default,
             _aten.empty_like.default, _aten.new_empty.default,
             _aten.new_empty_strided.default, _aten._unsafe_view.default}


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _storages(tree) -> dict:
    """{storage key: bytes} of the distinct storages under ``tree``."""
    out = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def compute_seconds(flops_by_dtype: dict) -> float:
    """The least time the products take: each dtype's operations over the
    card's rate for it (``kernels.roofline.ops_rate``)."""
    return sum(n / ops_rate(getattr(torch, d))
               for d, n in flops_by_dtype.items())


class OpCounter(TorchDispatchMode):
    """Counts the aten ops and kernel launches of the code run under it
    (``with OpCounter() as c: ...``); :meth:`result` gives the totals.
    Arguments named by :meth:`arguments` count as live from the start and
    are never counted as allocated."""

    def __init__(self):
        super().__init__()
        self.flops_by_dtype: dict = defaultdict(int)
        self.bytes = 0
        self.aten_ops = 0
        self.kernels: dict = {}
        self.argument_bytes = 0
        self._arg_keys: set = set()
        self._alive: set = set()
        self._live = 0
        self._peak = 0

    # -- the watcher of kernels.build.launch ----------------------------
    def kernel(self, name, dtype, ops, n_bytes):
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0,
                                           "bytes": 0})
        k["launches"] += 1
        k["flops"] += ops
        k["bytes"] += n_bytes
        self.flops_by_dtype[str(dtype).replace("torch.", "")] += ops
        self.bytes += n_bytes

    def __enter__(self):
        build.WATCHERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        build.WATCHERS.remove(self)
        return super().__exit__(*exc)

    # -- live memory ----------------------------------------------------
    def arguments(self, tree) -> None:
        """Count the storages of ``tree`` as the call's arguments."""
        for key, n in _storages(tree).items():
            if key not in self._arg_keys:
                self._arg_keys.add(key)
                self.argument_bytes += n

    def _freed(self, key, n):
        self._alive.discard(key)
        self._live -= n

    def _allocated(self, out):
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._alive or key in self._arg_keys:
                continue
            n = st.nbytes()
            self._alive.add(key)
            self._live += n
            self._peak = max(self._peak, self._live)
            weakref.finalize(st, self._freed, key, n)

    # -- the ops ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._allocated(out)
        if build.wrapper_depth():
            return out              # the kernel's own: counted by its cost
        self.aten_ops += 1
        if not func.is_view and func not in _NO_BYTES:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            operand = next(t for t in _tensors(args) if t.dim() >= 2)
            self.flops_by_dtype[str(operand.dtype).replace("torch.", "")] \
                += int(formula(*args, **kwargs, out_val=out))
        return out

    def result(self, outputs=None) -> dict:
        """The totals: ``flops`` (and by dtype), ``bytes``, ``aten_ops``,
        ``kernels`` {name: launches, flops, bytes} and ``memory``
        (argument, output and peak-live bytes; ``outputs`` names the
        call's result, whose storages that are not arguments are its
        output bytes)."""
        out_keys = _storages(outputs)
        return {
            "flops": sum(self.flops_by_dtype.values()),
            "flops_by_dtype": dict(sorted(self.flops_by_dtype.items())),
            "bytes": self.bytes,
            "aten_ops": self.aten_ops,
            "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
            "memory": {
                "argument_bytes": self.argument_bytes,
                "output_bytes": sum(n for k, n in out_keys.items()
                                    if k not in self._arg_keys),
                "peak_live_bytes": self.argument_bytes + self._peak},
        }


def count_call(fn, *args, **kwargs):
    """(fn's result, :meth:`OpCounter.result`) of ``fn(*args, **kwargs)``
    run under a counter, its arguments counted as live from the start."""
    counter = OpCounter()
    counter.arguments((args, kwargs))
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.result(out)
