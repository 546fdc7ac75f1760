"""Public wrappers of the engine's data-plane ops (port of
``repro.kernels.ops``).

The three kernel ops take ``use_kernel``:

  use_kernel=True   the kernel wrapper: the hand-written CUDA kernel for
                    CUDA tensors, its plain version for CPU tensors;
  use_kernel=False  the plain PyTorch version on any device (the ``torch``
                    backend — the oracle the kernels are held to on the card).

None of the TPU alignment is carried over: V is not padded to 128 lanes, O
not to 8 sublanes, and no output is lane-broadcast.

The three commit-phase scatter/gather ops (``sid_regather``,
``masked_install``, ``masked_sid_bump``) are plain PyTorch, as the reference
left them to XLA.  They reproduce JAX's index semantics exactly: a gather
index is normalized (``k < 0 -> k + n``) and then clamped; a ``mode="drop"``
scatter normalizes and drops what is out of range or masked off.  The two
scatters update the store IN PLACE, and they do it without a host sync and
without a write race: masked-off rows still target a real cell but
contribute the identity of a min/max reduction, so no sentinel row is ever
written.
"""
from __future__ import annotations

import torch

from . import ref
from .interval_negotiate import potential_matrix as _potential_matrix
from .version_scan import version_scan as _version_scan
from .version_scan import version_scan_plain
from .wave_commit import wave_commit as _wave_commit
from .wave_commit import wave_commit_plain

I32_MIN, I32_MAX = -(2 ** 31), 2 ** 31 - 1


def version_scan(cids, tids, max_cid, *, keys=None, use_kernel=True):
    """cids/tids: [N, V] int32 tables; keys: [M] int32 rows (clipped) or
    None (request m reads row m of pre-gathered rings; plain version only);
    max_cid: [M].  Returns (slot, best) [M]."""
    if use_kernel:
        return _version_scan(cids, tids, max_cid, keys)
    return version_scan_plain(cids, tids, max_cid, keys)


def potential_matrix(read_key, write_key, *, use_kernel=True):
    """[T, O] read/write key sets -> [T, T] int8 anti-dependency
    candidates."""
    if use_kernel:
        return _potential_matrix(read_key, write_key)
    return ref.potential_matrix_ref(read_key, write_key)


def wave_commit(cids, tids, sids, vals, max_cid, read_key, write_key, rvalid,
                *, keys=None, use_kernel=True):
    """Fused wave read phase.  With ``keys`` ([T, O] store rows, clipped)
    the four ring arguments are the [N, V] store tables, else pre-gathered
    [T, O, V] rings (plain version only).  Returns (slot, r_val, r_tid, r_cid, r_sid [T, O],
    s_lo0 [T], potential [T, T] int8)."""
    if use_kernel:
        return _wave_commit(cids, tids, sids, vals, max_cid, read_key,
                            write_key, rvalid, keys)
    return wave_commit_plain(cids, tids, sids, vals, max_cid, read_key,
                             write_key, rvalid, keys)


# ---------------------------------------------------------------------------
# batched commit-phase data movement
# ---------------------------------------------------------------------------

def gather_rows(keys, n):
    """JAX gather index semantics: normalize negatives, then clamp."""
    return torch.where(keys < 0, keys + n, keys).clamp(0, n - 1).long()


def _drop_rows(keys, n, mask):
    """JAX ``mode="drop"`` scatter semantics: (live, rows) — ``live`` is the
    mask AND the normalized key in range; ``rows`` a valid row for every
    entry (dead entries target one but contribute nothing)."""
    kn = torch.where(keys < 0, keys + n, keys)
    live = mask & (kn >= 0) & (kn < n)
    return live, kn.clamp(0, n - 1).long()


def _put_(flat, idx, live, src, lo):
    """``flat[idx[live]] = src[live]`` in place.  Forcing live cells to the
    int32 minimum and then taking the max with ``src`` sets them exactly;
    dead entries contribute the identities (max for the min, min for the
    max), so duplicates between live and dead entries cannot race."""
    flat.scatter_reduce_(0, idx, lo, "amin")
    flat.scatter_reduce_(0, idx, torch.where(live, src, I32_MIN), "amax")


def _i32(x, like):
    return torch.as_tensor(x, dtype=torch.int32, device=like.device)


def sid_regather(sid, keys, slots):
    """Rule-4(a) input: re-gather the SIDs of previously read (key, slot)
    pairs — peers may have bumped them since the read phase.
    sid: [n_keys, V]; keys/slots: [...] -> [...]."""
    return sid[gather_rows(keys, sid.shape[0]), slots.long()]


def masked_install(val, tid, cid, sid, head, wave, *, mask, keys, values,
                   new_tid, new_cid, wave_idx):
    """Masked version install over a key batch (rule 4(c) CID stamping),
    IN PLACE.

    Pushes a new ring version for every key with ``mask`` set: the slot
    after ``head`` is overwritten, SID resets to 0, ``head``/``wave``
    advance.  Masked-off rows are dropped; masked/NOP keys (possibly
    negative padding) are clamped before the ``head`` gather so they never
    wrap to a real key.  Returns the six (updated) ring tensors."""
    n_keys, V = val.shape
    keys = keys.reshape(-1)
    live, rows = _drop_rows(keys, n_keys, mask.reshape(-1))
    h_new = (head[keys.clamp(0, n_keys - 1).long()] + 1) % V
    cells = rows * V + h_new
    lo = torch.where(live, I32_MIN, I32_MAX).to(torch.int32)
    src = lambda x: torch.broadcast_to(_i32(x, val), keys.shape)
    for flat, x in ((val, values), (tid, new_tid), (cid, new_cid),
                    (sid, 0)):
        _put_(flat.view(-1), cells, live, src(x), lo)
    _put_(head, rows, live, h_new, lo)
    _put_(wave, rows, live, src(wave_idx), lo)
    return val, tid, cid, sid, head, wave


def masked_sid_bump(sid, tid, *, mask, keys, slots, expect_tid, s_val):
    """Rule-4(c) SID bump over a key batch, IN PLACE: raise the SID of read
    versions to the reader's start time, guarded against ring slots
    recycled since the read (creator TID must still match).  A scatter-max
    over flat ``key * V + slot`` cells.  Returns the updated sid."""
    n_keys, V = sid.shape
    slots = slots.long()
    ok = mask & (tid[gather_rows(keys, n_keys), slots] == expect_tid)
    live, rows = _drop_rows(keys, n_keys, ok)
    src = torch.broadcast_to(_i32(s_val, sid), live.shape)
    sid.view(-1).scatter_reduce_(0, rows * V + slots,
                                 torch.where(live, src, I32_MIN), "amax")
    return sid
