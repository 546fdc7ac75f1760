"""Public wrappers of the kernel ops (port of ``repro.kernels.ops``).

The six kernel ops -- the engine's ``version_scan``, ``potential_matrix``,
``wave_commit`` and ``commit_loop`` and the model plane's
``flash_attention`` and ``ssd`` -- take ``use_kernel``
(``KernelConfig.use_kernel``: the ``cuda`` backend sets it, ``torch`` does
not):

  use_kernel=True   the kernel wrapper: the hand-written CUDA kernel for
                    CUDA tensors, its plain version for CPU tensors;
  use_kernel=False  the plain PyTorch version on any device (the ``torch``
                    backend — the oracle the kernels are held to on the card).

None of the TPU alignment is carried over: V is not padded to 128 lanes, O
not to 8 sublanes, no output is lane-broadcast, attention's head dim is
not padded to 128 and GQA's kv heads are not repeated.

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
from .commit_loop import commit_loop as _commit_loop
from .commit_loop import commit_loop_plain
from .flash_attention import FlashAttentionFn
from .flash_attention import flash_attention as _flash_attention
from .flash_attention import flash_attention_plain
from .interval_negotiate import potential_matrix as _potential_matrix
from .ssd_scan import SsdScanFn, ssd_plain
from .ssd_scan import ssd_scan as _ssd_scan
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


def commit_loop(store, inputs, *, sched, n_nodes, gc_track, gc_block,
                use_kernel=True):
    """The commit loop of one wave over the six store tables ``store``
    (updated in place); ``inputs``: an ``engine.CommitInputs``.  Returns
    (status, s_arr, c_arr [T], wcid [T, O], clk, evicted)."""
    fn = _commit_loop if use_kernel else commit_loop_plain
    return fn(store, inputs, sched=sched, n_nodes=n_nodes,
              gc_track=gc_track, gc_block=gc_block)


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def flash_attention(q, k, v, *, causal=True, use_kernel=True):
    """q: [B, Sq, H, D]; k, v: [B, Sk, KH, D] -> [B, Sq, H, D].  Under a
    gradient the kernel route goes through ``FlashAttentionFn`` (the
    forward kernel with its lse, the backward kernels); the plain route
    is differentiated by autograd."""
    if use_kernel and _wants_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, causal)
    if use_kernel:
        return _flash_attention(q, k, v, causal)
    return flash_attention_plain(q, k, v, causal)


def ssd(x, dA, Bm, Cm, *, n_heads_per_group, chunk=128, h0=None,
        use_kernel=True):
    """x: [BH, S, P] (or the [Bg, H, S, P] view of [Bg, S, H, P]); dA:
    [BH, S] (or [Bg, H, S]); Bm/Cm: [Bg, S, N]; h0: [BH, N, P] or None ->
    (y in x's shape, final state [BH, N, P]).  Under a gradient the kernel
    route goes through ``SsdScanFn`` (the forward kernel, then the three
    backward kernels); the plain route is differentiated by autograd."""
    if use_kernel and _wants_grad(x, dA, Bm, Cm, h0):
        return SsdScanFn.apply(x, dA, Bm, Cm, n_heads_per_group, chunk, h0)
    if use_kernel:
        return _ssd_scan(x, dA, Bm, Cm, n_heads_per_group, chunk, h0)
    return ssd_plain(x, dA, Bm, Cm, n_heads_per_group, chunk, h0)


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
    """``x`` as int32 on ``like``'s device; a Python int by a fill there,
    since a copy of a host scalar to the card makes the host wait."""
    if isinstance(x, int):
        return torch.full((), x, dtype=torch.int32, device=like.device)
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
