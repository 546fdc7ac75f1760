"""The attention backward of the port on the CPU: ``flash_attention_bwd_plain``
(the backward kernels' formulas written out in plain PyTorch) against
``torch.autograd.grad`` of ``flash_attention_plain`` and against ``jax.vjp``
of the reference's ``layers.attention``; ``FlashAttentionFn`` (the
``cuda`` route's autograd binding, here on CPU tensors, where its wrappers
take the plain versions) against autograd; the refusals of the kernel
wrappers on CPU tensors; and the SSD scan's kernel route under a gradient,
which runs ``SsdScanFn`` (``tests/test_torch_ssd_bwd.py`` holds it in
full).

Inputs are seeded numpy in float32.  Cases: causal with GQA (G = 1, 2, 7),
non-causal at Sq != Sk (cross-attention), Sq = 1, ragged lengths, and
S = 1,024, two of the reference's 512-row chunks, where ``layers.attention``
takes its chunked online-softmax path.  Tolerance: 1e-4 * scale (scale =
max(|reference|, 1)), float32 sums in another order.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention_bwd_cuda,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_cuda,
                                                 flash_attention_plain)

# (B, Sq, Sk, H, KH, D, causal)
CASES = [(2, 37, 37, 4, 2, 16, True),
         (1, 64, 64, 7, 1, 32, True),
         (2, 70, 70, 2, 2, 48, True),
         (2, 24, 100, 4, 4, 32, False),
         (2, 1, 50, 4, 2, 16, False),
         (1, 1024, 1024, 2, 1, 16, True)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small eager ops: on one intra-op thread they do not stall when the
    other test workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=1e-4, label=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (label, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (label, err, tol * scale)


def _inputs(B, Sq, Sk, H, KH, D, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, Sq, H, D) * 1.5
    k = rng.randn(B, Sk, KH, D) * 1.5
    v = rng.randn(B, Sk, KH, D)
    do = rng.randn(B, Sq, H, D)
    return [a.astype(np.float32) for a in (q, k, v, do)]


def _plain_bwd(q, k, v, do, causal):
    t = [torch.as_tensor(a) for a in (q, k, v, do)]
    o, lse = flash_attention_plain(*t[:3], causal, with_lse=True)
    return flash_attention_bwd_plain(*t[:3], o, lse, t[3], causal)


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_autograd(case):
    *shape, causal = case
    q, k, v, do = _inputs(*shape)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    o = flash_attention_plain(*leaves, causal)
    want = torch.autograd.grad(o, leaves, torch.as_tensor(do))
    for name, g, w in zip("qkv", _plain_bwd(q, k, v, do, causal), want):
        _close(g, w.numpy(), label=f"d{name}")


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_reference_vjp(case):
    """Against ``jax.vjp`` of the reference's ``layers.attention`` (the
    dense path, or the chunked one above 512 rows)."""
    *shape, causal = case
    q, k, v, do = _inputs(*shape, seed=1)
    o, vjp = jax.vjp(lambda a, b, c: jl.attention(a, b, c, causal=causal),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = _plain_bwd(q, k, v, do, causal)
    _close(flash_attention_plain(*(torch.as_tensor(x) for x in (q, k, v)),
                                 causal), np.asarray(o), label="o")
    for name, g, w in zip("qkv", got, want):
        _close(g, np.asarray(w), label=f"d{name}")


def test_lse_is_the_rows_logsumexp():
    q, k, v, _ = _inputs(2, 33, 33, 4, 2, 16)
    t = [torch.as_tensor(a) for a in (q, k, v)]
    o, lse = flash_attention_plain(*t, True, with_lse=True)
    assert lse.shape == (2, 4, 33) and lse.dtype == torch.float32
    s = torch.einsum("bqhd,bshd->bhqs", t[0],
                     t[1].repeat_interleave(2, dim=2)) / math.sqrt(16)
    s = s.masked_fill(torch.ones(33, 33, dtype=torch.bool).triu(1), -1e30)
    _close(lse, torch.logsumexp(s, -1).numpy(), 1e-5)
    _close(o, flash_attention_plain(*t, True).numpy(), 0.0)


@pytest.mark.parametrize("case", CASES[:5])
def test_autograd_function_on_the_kernel_route(case):
    """``ops.flash_attention`` with ``use_kernel`` under a gradient goes
    through ``FlashAttentionFn``; on CPU tensors its wrappers take the plain
    versions, so its gradient is autograd's of the plain version, and no
    kernel is launched."""
    *shape, causal = case
    q, k, v, do = _inputs(*shape, seed=2)
    before = dict(LAUNCHES)
    got, want = [], []
    for use_kernel, out in ((True, got), (False, want)):
        leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        o = ops.flash_attention(*leaves, causal=causal,
                                use_kernel=use_kernel)
        assert (o.grad_fn.name() == "FlashAttentionFnBackward") == use_kernel
        out += [o, *torch.autograd.grad(o, leaves, torch.as_tensor(do))]
    for a, b in zip(got, want):
        _close(a, b.detach().numpy())
    with torch.no_grad():
        o = ops.flash_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                                causal=causal)
    assert o.grad_fn is None
    assert LAUNCHES == before


def test_function_saves_no_score_matrix():
    """FlashAttentionFn keeps q, k, v, o and the [B, H, Sq] lse for the
    backward, nothing of size Sq x Sk."""
    q, k, v, _ = _inputs(1, 96, 96, 2, 1, 16)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    o = FlashAttentionFn.apply(*leaves, True)
    shapes = sorted(tuple(t.shape) for t in o.grad_fn.saved_tensors)
    assert shapes == sorted([(1, 96, 2, 16), (1, 96, 1, 16), (1, 96, 1, 16),
                             (1, 96, 2, 16), (1, 2, 96)])


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros((1, 8, 2, 16))
    lse = torch.zeros((1, 2, 8))
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_cuda(q, q, q, with_lse=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_bwd_cuda(q, q, q, q, lse, q)
    assert LAUNCHES == before


def test_ssd_kernel_route_refuses_a_gradient():
    """(Named for the refusal it replaced.)  ``ops.ssd`` on the kernel
    route under a gradient trains: it runs ``SsdScanFn`` (on CPU tensors
    its wrappers take the plain versions), whose gradient equals
    autograd's through the plain route within 1e-4 of scale; without a
    gradient it runs the forward alone, the plain route's bits."""
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(4, 32, 16).astype(np.float32),
                     requires_grad=True)
    dA = -torch.rand(4, 32)
    bm = torch.tensor(rng.randn(2, 32, 16).astype(np.float32))
    kw = dict(n_heads_per_group=2, chunk=16)
    before = dict(LAUNCHES)
    y, _ = ops.ssd(x, dA, bm, bm, use_kernel=True, **kw)
    assert type(y.grad_fn).__name__ == "SsdScanFnBackward"
    yp, _ = ops.ssd(x, dA, bm, bm, use_kernel=False, **kw)
    assert torch.equal(y.detach(), yp.detach())
    _close(torch.autograd.grad(y.sum(), x)[0],
           torch.autograd.grad(yp.sum(), x)[0].numpy())
    with torch.no_grad():
        y2, _ = ops.ssd(x, dA, bm, bm, use_kernel=True, **kw)
    assert y2.grad_fn is None and torch.equal(y2, yp.detach())
    assert LAUNCHES == before
