"""Shared commit-phase rules + anti-dependency matrix build (port of
``repro.core.commit_phase``).

The paper's CV rules 5-6 and PostSI rules 3/4/5 as branch-free tensor
arithmetic: no ``.item()``, no ``bool(tensor)`` and no ``if`` on device
values, so the commit loop never waits on the device.  ``build_potential``
routes the anti-dependency build to the CUDA kernel or the plain version
per a resolved ``KernelConfig``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops, resolve

# op kinds (one code per wave-op slot)
NOP, READ, WRITE, RMW = 0, 1, 2, 3
# txn status
RUNNING, COMMITTED, ABORTED = 0, 1, 2


def build_potential(keys, is_read, is_write, backend=None):
    """Anti-dependency candidates for one wave: bool [T, T].

    keys: [T, O] int32 op keys; is_read / is_write: [T, O] bool op masks.
    ``backend`` is anything ``kernels.resolve`` accepts."""
    cfg = resolve(backend, keys.device)
    rk = torch.where(is_read, keys, -1)
    wk = torch.where(is_write, keys, -1)
    # 0/1 int8 from every version: viewed as bool, not copied
    return ops.potential_matrix(rk, wk,
                                use_kernel=cfg.use_kernel).view(torch.bool)


def creator_slots(nv_tid, tid0, n_txns, status):
    """Map newest-version creator TIDs to wave-local txn ids.

    Returns (local [O] int32, creator_committed [O] bool): local is -1 for
    creators from older waves."""
    local = nv_tid - tid0
    local = torch.where((local >= 0) & (local < n_txns), local, -1)
    committed = (local >= 0) & (status[local.clamp(min=0).long()]
                                == COMMITTED)
    return local, committed


def lost_update(r_i, w_i, nv_cid, r_cid_i):
    """CV rule 5(i): an RMW whose read version is no longer newest."""
    return (r_i & w_i & (nv_cid != r_cid_i)).any()


def rw_edge_to_creator(w_i, local, creator_committed, potential_row):
    """CV rule 5(ii): the newest creator of a key I write has an rw edge
    from me -> it is invisible to me -> I cannot overwrite its version."""
    return (w_i & (local >= 0) & creator_committed
            & potential_row[local.clamp(min=0).long()]).any()


def ongoing_readers_of(i, potential, status):
    """Mask of still-RUNNING txns that read a key txn i writes (self off)."""
    readers = potential[:, i] & (status == RUNNING)
    readers[i] = False
    return readers


def postsi_bounds(s_lo_i, s_hi_i, c_lo_i, r_i, w_i, nv_cid, nv_sid, cur_sid,
                  ongoing_reader, s_lo):
    """PostSI rules 3/4(a)/5 for the committing txn i.
    Returns (s_i, c_i, interval_abort)."""
    w_cid_max = torch.where(w_i, nv_cid, 0).max()
    # rule 3 for overwrites: creators of overwritten versions must be visible
    s_lo_i = torch.maximum(s_lo_i, w_cid_max)
    c_lo_i = torch.maximum(c_lo_i, w_cid_max)
    # rule 4(a): commit time above SIDs of read versions, of versions we
    # overwrite, and above s_lo of every ongoing reader of my write set
    c_lo_i = torch.maximum(c_lo_i, torch.where(r_i, cur_sid, 0).max())
    c_lo_i = torch.maximum(c_lo_i, torch.where(w_i, nv_sid, 0).max())
    c_lo_i = torch.maximum(c_lo_i, torch.where(ongoing_reader, s_lo, 0).max())
    # rule 5: no valid start time left
    interval_abort = s_lo_i > s_hi_i
    s_i = s_lo_i
    c_i = torch.maximum(c_lo_i, s_i) + 1
    return s_i, c_i, interval_abort


def push_bounds(i, commit, s_i, c_i, potential, status, s_lo, s_hi, c_lo):
    """PostSI rule 4(b): a committing txn pushes the interval bounds of
    every conflicting ongoing transaction.  Returns new (s_lo, s_hi, c_lo);
    the inputs are not modified."""
    running = status == RUNNING
    i_reads_them = potential[i, :] & running          # me -rw-> them
    c_lo = torch.where(commit & i_reads_them, torch.maximum(c_lo, s_i + 1),
                       c_lo)
    they_read_mine = potential[:, i] & running
    s_hi = torch.where(commit & they_read_mine,
                       torch.minimum(s_hi, c_i - 1), s_hi)
    s_lo = s_lo.clone()
    s_lo[i] = torch.where(commit, s_i, s_lo[i])
    return s_lo, s_hi, c_lo
