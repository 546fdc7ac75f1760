"""The port's model-plane kernels held against the JAX package's.

The plain versions beside the two CUDA kernels -- ``flash_attention_plain``
(and the ``ops.flash_attention`` wrapper that takes it for CPU tensors) and
``ssd_plain`` / ``ssd_chunked`` / ``ssd_ref`` -- get the same seeded numpy
inputs as ``repro.kernels.ops`` with its Pallas kernels in interpret mode,
the reference oracles ``repro.kernels.ref`` and the model functions
``repro.models.layers.attention`` / ``repro.models.ssm.ssd_chunked``.
Tolerances as in ``tests/test_kernels.py``: 2e-5 in float32 and 2e-2 in
bf16 for attention, 1e-3 for the SSD scan (fp32 sums in another order).
The CUDA kernels are held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.layers import attention as j_attention
from repro.models.ssm import ssd_chunked as j_ssd_chunked
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_plain
from repro_torch.models.layers import attention, decode_attention

T_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _qkv(seed, B, S, H, KH, D):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, S, h, D) * 0.3 for h in (H, KH, KH)]


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("S,D,dtype", [
    (128, 128, jnp.float32),
    (256, 128, jnp.float32),
    (512, 128, jnp.bfloat16),
    (256, 64, jnp.float32),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_vs_pallas(S, D, dtype, causal):
    """The cases of tests/test_kernels.py (GQA H=4, KH=2): the port's
    wrapper on CPU tensors against the Pallas kernel, interpreted."""
    q, k, v = _qkv(0, 2, S, 4, 2, D)
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    want = jops.flash_attention(jq, jk, jv, causal=causal, use_pallas=True,
                                interpret=True)
    tq, tk_, tv = (_t(a, T_DTYPE[dtype]) for a in (q, k, v))
    got = ops.flash_attention(tq, tk_, tv, causal=causal)
    assert got.dtype == T_DTYPE[dtype] and got.shape == tq.shape
    tol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    _close(got, want, tol)
    _close(ops.flash_attention(tq, tk_, tv, causal=causal, use_kernel=False),
           want, tol)


@pytest.mark.parametrize("S,H,KH,D,causal", [
    (128, 4, 2, 80, True),      # zamba2's head dim, GQA
    (100, 4, 2, 80, True),      # ragged S
    (100, 4, 4, 64, False),     # ragged, non-causal
    (96, 14, 2, 64, True),      # qwen2-0.5b's grouping
])
def test_flash_attention_plain_vs_oracles(S, H, KH, D, causal):
    """The head dims, groupings and ragged lengths the Pallas kernel cannot
    take (D=80, S % 128 != 0): against the oracle ``ref.attention_ref`` on
    the folded, repeated layout and against the model's
    ``layers.attention``."""
    q, k, v = _qkv(1, 2, S, H, KH, D)
    got = flash_attention_plain(_t(q), _t(k), _t(v), causal=causal)
    G = H // KH
    fold = lambda a, r: np.repeat(a.transpose(0, 2, 1, 3), r, 1).reshape(
        -1, S, D)
    folded = [fold(q, 1), fold(k, G), fold(v, G)]
    want = jref.attention_ref(*(jnp.asarray(a, jnp.float32) for a in folded),
                              causal=causal)
    # the port's own oracle, on the same folded layout
    _close(ref.attention_ref(*(_t(a) for a in folded), causal=causal), want,
           2e-5)
    _close(got, np.asarray(want).reshape(2, H, S, D).transpose(0, 2, 1, 3),
           2e-5)
    if causal:
        want_model = j_attention(jnp.asarray(q, jnp.float32),
                                 jnp.asarray(k, jnp.float32),
                                 jnp.asarray(v, jnp.float32), causal=True)
        _close(got, want_model, 2e-5)


def test_flash_attention_plain_cache_masks():
    """The cache masks of decode, which the port keeps out of the flash
    path: ``layers.decode_attention`` (a stale cache tail plus the new
    token) against the reference's dense attention with ``q_offset`` /
    ``kv_len`` over the cache with the new token written at ``kv_len``."""
    q, k, v = _qkv(2, 2, 24, 4, 2, 16)
    q1, k1, v1 = (a[:, -1:] for a in (q, k, v))
    kv_len = np.array([20, 23], np.int32)
    kc, vc = k.copy(), v.copy()
    for b, n in enumerate(kv_len):
        kc[b, n], vc[b, n] = k1[b, 0], v1[b, 0]
    want = j_attention(jnp.asarray(q1, jnp.float32),
                       jnp.asarray(kc, jnp.float32),
                       jnp.asarray(vc, jnp.float32), causal=True, q_offset=23,
                       kv_len=jnp.asarray(kv_len + 1))
    got = decode_attention(_t(q1), _t(k), _t(v), _t(k1), _t(v1),
                           torch.as_tensor(kv_len))
    _close(got, want, 2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_dispatch_uneven_lengths(causal):
    """``layers.attention`` with fewer queries than keys (the causal mask
    aligns query i with key i) goes through ``ops.flash_attention`` and
    matches the reference's dense attention."""
    q = _qkv(3, 2, 40, 4, 2, 32)[0]
    _, k, v = _qkv(4, 2, 64, 4, 2, 32)
    want = j_attention(*(jnp.asarray(a, jnp.float32) for a in (q, k, v)),
                       causal=causal)
    got = attention(_t(q), _t(k), _t(v), causal=causal, kernels="torch")
    _close(got, want, 2e-5)


# ---------------------------------------------------------------------- ssd
def _ssd_inputs(seed, Bg, H, S, P, N):
    rng = np.random.RandomState(seed)
    x = rng.randn(Bg * H, S, P) * 0.5
    dA = -np.abs(rng.rand(Bg * H, S)) * 0.3
    Bm = rng.randn(Bg, S, N) * 0.3
    Cm = rng.randn(Bg, S, N) * 0.3
    return x, dA, Bm, Cm


@pytest.mark.parametrize("S,P,N,chunk", [
    (256, 64, 128, 128),
    (256, 32, 64, 64),
    (512, 64, 128, 128),
])
def test_ssd_plain_vs_pallas(S, P, N, chunk):
    """The cases of tests/test_kernels.py (B=2, H=3): ``ops.ssd`` on CPU
    tensors and ``ssd_ref`` against the Pallas kernel, interpreted."""
    x, dA, Bm, Cm = _ssd_inputs(2, 2, 3, S, P, N)
    jy, jh = jops.ssd(*(jnp.asarray(a, jnp.float32) for a in (x, dA, Bm, Cm)),
                      n_heads_per_group=3, chunk=chunk, use_pallas=True,
                      interpret=True)
    args = [_t(a) for a in (x, dA, Bm, Cm)]
    for use_kernel in (True, False):
        y, h = ops.ssd(*args, n_heads_per_group=3, chunk=chunk,
                       use_kernel=use_kernel)
        _close(y, jy, 1e-3)
        _close(h, jh, 1e-3)
    y, h = ref.ssd_ref(*args, n_heads_per_group=3)
    _close(y, jy, 1e-3)
    _close(h, jh, 1e-3)


@pytest.mark.parametrize("S,chunk", [(100, 32), (64, 128), (77, 16)])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_vs_model_ragged_and_initial_state(S, chunk, with_state):
    """Ragged S (padded inside) and a non-zero initial state: the port's
    ``ssd_chunked`` against the reference model's, and the folded
    ``ssd_plain`` against ``ssd_ref`` continued from the same state."""
    B, H, P, N = 2, 4, 16, 8
    rng = np.random.RandomState(S + chunk)
    x = rng.randn(B, S, H, P) * 0.5
    dA = -np.abs(rng.rand(B, S, H)) * 0.3
    Bm = rng.randn(B, S, 1, N) * 0.3
    Cm = rng.randn(B, S, 1, N) * 0.3
    h0 = rng.randn(B, H, P, N) * 0.2 if with_state else None
    jy, jh = j_ssd_chunked(*(jnp.asarray(a, jnp.float32)
                             for a in (x, dA, Bm, Cm)), chunk=chunk,
                           init_state=None if h0 is None else
                           jnp.asarray(h0, jnp.float32))
    y, h = ssd_chunked(*(_t(a) for a in (x, dA, Bm, Cm)), chunk,
                       None if h0 is None else _t(h0))
    _close(y, jy, 1e-3)
    _close(h, jh, 1e-3)
    # folded layout, as the kernel takes it
    xf = x.transpose(0, 2, 1, 3).reshape(B * H, S, P)
    af = dA.transpose(0, 2, 1).reshape(B * H, S)
    hf = None if h0 is None else _t(h0.transpose(0, 1, 3, 2).reshape(
        B * H, N, P))
    yk, hk = ssd_plain(_t(xf), _t(af), _t(Bm[:, :, 0]), _t(Cm[:, :, 0]),
                       H, chunk, hf)
    _close(yk.reshape(B, H, S, P).transpose(1, 2), jy, 1e-3)
    _close(hk.reshape(B, H, N, P).transpose(-1, -2), jh, 1e-3)
    if h0 is None:
        yr, hr = ref.ssd_ref(_t(xf), _t(af), _t(Bm[:, :, 0]),
                             _t(Cm[:, :, 0]), H)
        _close(yr, yk.numpy(), 1e-3)
        _close(hr, hk.numpy(), 1e-3)


def test_ssd_bf16_inputs_keep_their_type():
    """The model path's types: x, B, C in bf16, dA in fp32; y comes back in
    x's type and the state in fp32, within bf16 rounding of the fp32 run."""
    x, dA, Bm, Cm = _ssd_inputs(5, 2, 2, 48, 16, 8)
    bf = torch.bfloat16
    y, h = ssd_plain(_t(x, bf), _t(dA), _t(Bm, bf), _t(Cm, bf), 2, 16)
    assert y.dtype == bf and h.dtype == torch.float32
    yf, hf = ssd_plain(_t(x, bf).float(), _t(dA), _t(Bm, bf).float(),
                       _t(Cm, bf).float(), 2, 16)
    _close(y, yf.numpy(), 2e-2)
    _close(h, hf.numpy(), 1e-5)
