"""PostSI-committed checkpoints (port of ``repro.checkpoint.postsi_store``).

Every checkpoint *save* is a PostSI writer transaction over a versioned
object store: one logical key per leaf of a tree, the value being a file
handle.  Every *restore* is a read-only transaction: CID-based visibility
(paper §IV-B) guarantees it observes one atomic checkpoint, never a torn
mix of two, without a "latest step" counter or a manifest lock.  The
transactions run on the port's own ``core.seq.SeqScheduler``.

The directory is the reference's, byte for byte: ``<key>_<fid>.npy`` per
leaf and ``postsi_meta.pkl`` holding the scheduler, the next file id and
the leaf paths.  So each package restores the other's checkpoints:

* a leaf is named as ``jax.tree_util.keystr`` names it (``"['store']
  ['cid']"``) and the leaves are taken in the order JAX flattens a nested
  dict, by sorted keys.  The trees are nested dicts of arrays; anything
  that is not a dict is a leaf;
* the meta pickle names the scheduler's classes by the reference's module,
  ``repro.core.seq``.  Writing it takes no import of that module
  (``_MetaPickler``); reading maps it to ``repro_torch.core.seq`` and
  refuses every other class (``_MetaUnpickler``), so a meta file cannot
  import anything.

``restore`` puts the leaves on the device the caller names (the CUDA
device by default).  ``reshard_tree`` is the reference's elastic reshard,
a ``jax.device_put`` of every leaf onto a new mesh's sharding: on the
port's emulated node mesh a node's block is a view of one device's tensor,
so resharding is a move of every leaf to that device.
"""
from __future__ import annotations

import io
import os
import pickle
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import seq as _seq
from repro_torch.core.seq import SeqScheduler
from repro_torch.kernels import resolve_device

# the module the reference's meta pickle names the scheduler's classes by
_REF_SEQ = "repro.core.seq"
_SEQ_CLASSES = {c.__name__: c for c in (_seq.SeqScheduler, _seq.Version,
                                        _seq.Txn)}


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict, in JAX's flattening order
    (sorted keys) with ``jax.tree_util.keystr``'s path strings."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k in sorted(tree):
        out += _flatten(tree[k], f"{prefix}[{k!r}]")
    return out


def _unflatten(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` in flattening order."""
    if not isinstance(tree, dict):
        return next(leaves)
    return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}


def _leaf_paths(tree) -> List[str]:
    return [p for p, _ in _flatten(tree)]


def _path_mismatch(saved: List[str], given: List[str]) -> str:
    """Human-readable diff of two leaf-path lists for the errors below."""
    missing = [p for p in saved if p not in given]
    unexpected = [p for p in given if p not in saved]
    parts = []
    if missing:
        parts.append(f"missing from tree_example: {missing[:4]}")
    if unexpected:
        parts.append(f"not in checkpoint: {unexpected[:4]}")
    if not parts:          # same set, different order
        parts.append("leaf order differs")
    return "; ".join(parts)


class _MetaPickler(pickle._Pickler):
    """Pickles the scheduler's classes under the reference's module name,
    as the JAX package writes them, without importing that module."""

    def save_global(self, obj, name=None):
        if _SEQ_CLASSES.get(getattr(obj, "__qualname__", None)) is not obj:
            return super().save_global(obj, name)
        self.save(_REF_SEQ)
        self.save(obj.__qualname__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _MetaUnpickler(pickle.Unpickler):
    """Reads a meta pickle of either package: the scheduler's classes map
    to the port's copies; any other class is refused, never imported."""

    def find_class(self, module, name):
        if module in (_REF_SEQ, _seq.__name__) and name in _SEQ_CLASSES:
            return _SEQ_CLASSES[name]
        raise pickle.UnpicklingError(
            f"checkpoint meta names {module}.{name}, which is not a class "
            f"of the scheduler")


class PostSICheckpointer:
    """Directory layout: <dir>/<key_id>_<file_id>.npy + postsi_meta.pkl.

    The scheduler state (version chains of file handles) *is* the
    metadata; no manifest names "the" checkpoint — the latest consistent
    snapshot is induced from visibility, per the paper.
    """

    META = "postsi_meta.pkl"

    def __init__(self, directory: str, tree_example):
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self.paths = _leaf_paths(tree_example)
        self.key_of = {p: i for i, p in enumerate(self.paths)}
        self.meta_corrupt = False      # True when a damaged meta was ignored
        # +1 key: the step counter rides the same transaction
        meta = os.path.join(directory, self.META)
        saved = None
        if os.path.exists(meta):
            try:
                with open(meta, "rb") as f:
                    saved = _MetaUnpickler(f).load()
                if not isinstance(saved, dict) or \
                        {"sched", "next_file", "paths"} - saved.keys():
                    raise ValueError("meta missing required keys")
            except Exception:
                # a torn, bit-rotted or foreign meta degrades, never kills:
                # the directory holds no committed checkpoint (restore
                # returns (None, None) and durable recovery replays the
                # whole WAL); the next successful save rewrites a clean meta
                saved = None
                self.meta_corrupt = True
        if saved is not None:
            if saved["paths"] != self.paths:
                raise ValueError(
                    "PostSICheckpointer: checkpointed tree structure does "
                    "not match tree_example; "
                    + _path_mismatch(saved["paths"], self.paths))
            self.sched: SeqScheduler = saved["sched"]
            self._next_file = saved["next_file"]
        else:
            self.sched = SeqScheduler(len(self.paths) + 1, mode="postsi")
            self._next_file = 1

    def _persist_meta(self) -> None:
        buf = io.BytesIO()
        _MetaPickler(buf, pickle.DEFAULT_PROTOCOL).dump(
            {"sched": self.sched, "next_file": self._next_file,
             "paths": self.paths})
        with open(os.path.join(self.dir, self.META), "wb") as f:
            f.write(buf.getvalue())

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree) -> bool:
        """One writer transaction: write every leaf + the step key, commit.
        Leaves may be numpy arrays or tensors on any device."""
        leaves = _flatten(tree)
        tid = self.sched.begin()
        for pth, leaf in leaves:
            key = self.key_of[pth]
            fid = self._next_file
            self._next_file += 1
            if isinstance(leaf, torch.Tensor):
                leaf = leaf.detach().cpu().numpy()
            np.save(os.path.join(self.dir, f"{key}_{fid}.npy"),
                    np.asarray(leaf))
            self.sched.write(tid, key, fid)
        self.sched.write(tid, len(self.paths), step)
        ok = self.sched.commit(tid)
        if ok:
            self._persist_meta()
        return ok

    # --------------------------------------------------------------- restore
    def restore(self, tree_example, device=None) -> Tuple[Optional[int], Any]:
        """One reader transaction over all leaves: PostSI guarantees the
        file handles form one atomic checkpoint.  Returns (step, tree) with
        every leaf a tensor on ``device`` (``None``: the CUDA device) in
        its example's dtype, or (None, None) when no committed checkpoint
        exists.  ``tree_example`` must have the checkpointed tree's leaf
        paths; a mismatch raises a readable ``ValueError``."""
        paths = _leaf_paths(tree_example)
        if paths != self.paths:
            raise ValueError(
                "PostSICheckpointer.restore: tree_example leaf paths do not "
                "match the checkpointed tree; "
                + _path_mismatch(self.paths, paths))
        dev = resolve_device(device)
        tid = self.sched.begin()
        step = self.sched.read(tid, len(self.paths))
        if step is None or step == 0:
            self.sched.abort(tid)
            return None, None
        handles = {}
        for p in self.paths:
            key = self.key_of[p]
            fid = self.sched.read(tid, key)
            if fid is None or fid == 0:
                self.sched.abort(tid)
                return None, None
            handles[key] = fid
        if not self.sched.commit(tid):
            raise RuntimeError("PostSICheckpointer.restore: the read-only "
                               "transaction failed to commit")
        out = []
        for pth, ex in _flatten(tree_example):
            key = self.key_of[pth]
            arr = np.load(os.path.join(self.dir, f"{key}_{handles[key]}.npy"))
            if isinstance(ex, torch.Tensor):
                t = torch.from_numpy(arr).to(ex.dtype)
            else:
                t = torch.from_numpy(arr.astype(ex.dtype) if hasattr(
                    ex, "dtype") else arr)
            out.append(t.to(dev))
        return int(step), _unflatten(tree_example, iter(out))

    # ------------------------------------------------------------------- gc
    def gc(self, keep_latest: int = 2) -> int:
        """Drop files not reachable from the last ``keep_latest`` versions."""
        live = set()
        for key in range(len(self.paths)):
            chain = self.sched.versions[key]
            for v in chain[-keep_latest:]:
                live.add((key, v.value))
        removed = 0
        for fn in os.listdir(self.dir):
            if not fn.endswith(".npy"):
                continue
            key, fid = (int(x) for x in fn[:-4].split("_"))
            if (key, fid) not in live:
                os.remove(os.path.join(self.dir, fn))
                removed += 1
        return removed


def reshard_tree(tree, device):
    """Elastic reshard: every leaf of a nested dict of arrays on ``device``
    (a node mesh's ``.device``), as tensors."""
    if isinstance(tree, dict):
        return {k: reshard_tree(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree, device=torch.device(device))
