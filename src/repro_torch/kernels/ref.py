"""Plain PyTorch oracles of the kernels (counterparts of
``repro.kernels.ref``).

The wave engine's three (``version_scan_ref``, ``potential_matrix_ref``,
``wave_commit_ref``) are the CPU route of the ``kernels.ops`` wrappers, the
``torch`` backend on any device, and the yardstick each CUDA kernel is held
to bit for bit: all integer, results are exact.  The model plane's two
(``attention_ref``, ``ssd_ref``) are float oracles in the kernels' folded
layout, held to a tolerance; the plain routes of ``ops.flash_attention``
/ ``ops.ssd`` are the versions beside the kernels
(``flash_attention_plain``, ``ssd_plain``), which follow the reference
model's own functions.
"""
from __future__ import annotations

import math

import torch


def version_scan_ref(cids: torch.Tensor, tids: torch.Tensor,
                     max_cid: torch.Tensor):
    """cids/tids: [M, V] int32; max_cid: [M].  Returns (slot [M], best [M])
    int32: ``best`` is the newest visible CID (-1 when none is visible) and
    ``slot`` the FIRST slot attaining it (0 for an all-invisible row)."""
    V = cids.shape[-1]
    ok = (tids != -1) & (cids <= max_cid[:, None])
    masked = torch.where(ok, cids, -1)
    best = masked.max(dim=1).values
    lane = torch.arange(V, dtype=torch.int32, device=cids.device)
    slot = torch.where(masked == best[:, None], lane, V).min(dim=1).values
    return slot, best


def potential_matrix_ref(read_key: torch.Tensor,
                         write_key: torch.Tensor) -> torch.Tensor:
    """[T, O] x [T, O] -> [T, T] int8 rw-candidate matrix (diagonal zero).

    Distinct negative sentinels (-1 reads, -2 writes) keep masked/NOP ops —
    which may share a padding key — from ever matching each other."""
    rk = torch.where(read_key >= 0, read_key, -1)
    wk = torch.where(write_key >= 0, write_key, -2)
    eq = rk[:, None, :, None] == wk[None, :, None, :]
    pot = eq.flatten(2).any(dim=2)
    T = read_key.shape[0]
    eye = torch.eye(T, dtype=torch.bool, device=read_key.device)
    return (pot & ~eye).to(torch.int8)


def take_slot(a: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """``a[..., slot]`` per leading index: [..., V] x [...] -> [...]."""
    return torch.gather(a, -1, slot.long()[..., None])[..., 0]


def wave_commit_ref(cids, tids, sids, vals, max_cid, read_key, write_key,
                    rvalid):
    """Fused read-phase composition: ``version_scan_ref`` + slot gathers +
    the PostSI rule-3 seed + ``potential_matrix_ref``.

    cids/tids/sids/vals: [T, O, V] gathered rings; max_cid/read_key/
    write_key: [T, O]; rvalid: [T, O] bool (the s_lo0 seed mask).  Returns
    (slot, r_val, r_tid, r_cid, r_sid [T, O] int32, s_lo0 [T] int32,
    potential [T, T] int8)."""
    T, O, V = cids.shape
    slot, _ = version_scan_ref(cids.reshape(-1, V), tids.reshape(-1, V),
                               max_cid.reshape(-1))
    slot = slot.reshape(T, O)
    r_val, r_tid, r_cid, r_sid = (take_slot(a, slot)
                                  for a in (vals, tids, cids, sids))
    s_lo0 = torch.where(rvalid.bool(), r_cid, 0).max(dim=1).values
    pot = potential_matrix_ref(read_key, write_key)
    return slot, r_val, r_tid, r_cid, r_sid, s_lo0, pot


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """q, k, v: [BH, S, D] -- dense softmax attention in float32."""
    D = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(D)
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def ssd_ref(x: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor,
            Cm: torch.Tensor, n_heads_per_group: int):
    """The sequential SSD recurrence, vectorised over BH with one loop over
    S.  x: [BH, S, P]; dA: [BH, S]; Bm/Cm: [Bg, S, N].  Returns
    (y [BH, S, P] in x's dtype, h [BH, N, P] float32)."""
    BH, S, P = x.shape
    N = Bm.shape[-1]
    grp = torch.arange(BH, device=x.device) // n_heads_per_group
    Bh, Ch = Bm.float()[grp], Cm.float()[grp]                 # [BH, S, N]
    xf, a = x.float(), torch.exp(dA.float())
    h = torch.zeros((BH, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h = h * a[:, t, None, None] + Bh[:, t, :, None] * xf[:, t, None, :]
        ys.append(torch.einsum("bn,bnp->bp", Ch[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype), h
