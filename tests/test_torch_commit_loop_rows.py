"""The rows a wave's ops reach, pinned on the CPU.

The ``commit_loop`` kernel stages the store rows a wave touches in shared
memory when they fit (its ``staged`` variant) and runs on the store in
device memory when they do not (``global``).  The corners of that mapping
are ``chip_smoke.py``'s commit-loop cases:

* live ops on negative and out-of-range rows, where the scans read
  ``clip_row`` and the SID re-gather, the installs and the bumps reach
  ``gather_row``;
* -1 and n - 1 written by one transaction: one row, two heads;
* V=1, where every install overwrites the slot its transaction read, so the
  SID bump's guard sees the transaction's own TID (the waves repeat TIDs);
* one hot key read and written by every transaction of a T=256 wave, so
  every op maps to one staged row and ``potential`` is dense;
* T=256, O=4 at the largest V that stages and at the next, which does not.

Each wave runs through the JAX package's ``run_wave`` (its ``jnp``
backend) and the port's ``run_wave`` on the ``torch`` route, whose commit
loop is ``engine._commit_loop_plain``, the kernel's plain version: every
``WaveOut`` field, the clock and the final store must be bit-identical.
The two-heads wave is left out of that comparison: which of a transaction's
two installs into one cell (or one head) wins the reference leaves to its
backend's scatter (its CPU backend takes the later op); the port takes the
largest, and the kernel is held to that.
``chip_smoke.py``'s checks must pass the plain loop on these cases and
catch one that skips the SID bump.  The kernel is held to the plain loop on
them on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as jc
import repro_torch.core as tc
from repro_torch.core.engine import _commit_loop_plain
from repro_torch.kernels.commit_loop import (commit_loop_plain,
                                             commit_loop_smem_bytes)

from test_torch_commit_loop import _NoBump, _chip_smoke, _run_both

CFG = dict(nodes=2, kpn=40, V=4, T=16)
# the cases the reference is compared on, then the one it is not
JAX_CASES = ("negative and out-of-range rows",
             "V=1, each install over the slot read", "one hot key, T=256",
             "the largest V that stages", "the smallest V that does not")
NEW = JAX_CASES + ("one row from two heads",)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The plain loop runs ~170 small tensor ops a step; on one intra-op
    thread they are as fast alone and do not stall when the other test
    workers load every core (a T=256 wave took 80x longer then)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cases():
    cs = _chip_smoke()
    cases = [c for c in cs.commit_loop_cases(np, cs.Config(**CFG))
             if c[0].endswith(NEW)]
    assert len(cases) == len(NEW)
    return cs, cases


def _case(which):
    return next(c for c in _cases()[1] if c[0].endswith(which))


def _stores(n_keys, V):
    """Identical JAX / port stores with three versions of every key."""
    js = jc.make_store(n_keys, V)
    ts = tc.make_store(n_keys, V, device="cpu")
    for v in range(3):
        js, _ = jc.store.install_version(
            js, jnp.arange(n_keys), jnp.full((n_keys,), v), jnp.int32(1),
            jnp.int32(v + 1), jnp.int32(0))
        ts, _ = tc.install_version(ts, np.arange(n_keys),
                                   np.full((n_keys,), v), 1, v + 1, 0)
    return js, ts


@pytest.mark.parametrize("which", JAX_CASES)
@pytest.mark.parametrize("sched", tc.SCHEDULERS)
def test_plain_loop_matches_jax_on_the_row_corners(sched, which):
    label, n_keys, V, n_nodes, waves, _, _ = _case(which)
    js, ts = _stores(n_keys, V)
    outs = _run_both(waves, js, ts, sched, clock=V + 2, watermark=2,
                     gc_track=True)
    if which == "one hot key, T=256":     # the wave really contends
        status = outs[0].status
        assert 0 < int((status == tc.COMMITTED).sum()) < len(status)


def test_row_corners_are_what_they_claim():
    """The negative rows reach two rows an op with one live install a row
    per txn; two heads install into one row; the hot wave touches one row,
    read and written once by every txn; the edge pair sits on both sides of
    the shared-memory budget."""
    _, cases = _cases()
    neg, heads, v1, hot, fits, over = cases
    assert v1[2] == 1 and all((w[4] == w[4][0] + np.arange(16)).all()
                              and w[4][0] == v1[4][0][4][0] for w in v1[4])
    n = neg[1]
    for kind, key, *_ in neg[4]:
        assert (kind > 0).all() and (key < 0).any() and (key >= n).any()
        assert ((kind[:, 0] == 2) & (key[:, 0] == -1)
                & (kind[:, 1] == 1) & (key[:, 1] == n - 1)).any()
        row = np.where(key < 0, key + n, key)
        live = (kind >= 2) & (row >= 0) & (row < n)
        for t in range(len(kind)):
            assert len(set(row[t, live[t]])) == live[t].sum()
    kind, key, *_ = heads[4][0]
    assert ((kind[:, :2] == 2).all() and (key[:, 0] == -1).all()
            and (key[:, 1] == n - 1).all())
    kind, key, *_ = hot[4][0]
    assert key.shape == (256, 4) and len(np.unique(key)) == 1
    assert (((kind == 2) | (kind == 3)).sum(1) == 1).all()
    assert ((kind == 1) | (kind == 3)).any(1).all()
    for (_, _, V, _, waves, _, _), variant in ((fits, "staged"),
                                               (over, "global")):
        assert waves[0][0].shape == (256, 4)
        assert commit_loop_smem_bytes(256, 4, V)[1] == variant
    assert over[2] == fits[2] + 1


@pytest.mark.parametrize("sched", ["postsi", "dsi"])
def test_smoke_checks_pass_the_plain_loop_on_the_row_corners(sched):
    cs, cases = _cases()
    for case in cases:
        for gc in ("none", "track", "block"):
            assert cs.check_commit_loop(torch, np, torch.device("cpu"), case,
                                        sched, gc, commit_loop_plain,
                                        commit_loop_plain) == 0


@pytest.mark.parametrize("which", NEW[:2] + NEW[-1:])
def test_smoke_checks_catch_a_skipped_sid_bump_on_the_row_corners(which):
    cs = _chip_smoke()

    def slipped(store, inputs, **kw):
        return _commit_loop_plain(_NoBump("torch", "cpu"), store, inputs,
                                  **kw)
    with pytest.raises(AssertionError, match="differs from the plain loop"):
        cs.check_commit_loop(torch, np, torch.device("cpu"), _case(which),
                             "postsi", "none", (commit_loop_plain, slipped),
                             commit_loop_plain)
