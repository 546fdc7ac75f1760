"""The port's model plane held against the JAX package's, layer by layer
and end to end, on the reduced zamba2 configuration (4 layers, a shared
attention block every 2, d_model 64).

Weights come from the reference's own init and are carried across with
``params_from_jax``; inputs are seeded numpy.  The JAX side runs plain
``jit`` on the CPU.  Tolerances (``scale`` = max(|reference|, 1)):

* layers in float32: 1e-4 * scale (float32 sums in another order);
* ``HybridModel.prefill`` / ``decode`` with ``compute_dtype`` float32:
  logits and caches within 1e-3 * scale;
* with the default bf16: logits within 0.06 * scale, the bound of
  ``tests/test_models.py`` (bf16 rounds at other places in the two
  frameworks).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import layers as jl
from repro.models import ssm as jssm
from repro.models.model import build as j_build
from repro_torch.configs import get_reduced
from repro_torch.models import layers as tl
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build

ARCH = "zamba2-2.7b"


def _cfgs(fp32: bool, **kw):
    jc, tc = j_get_reduced(ARCH), get_reduced(ARCH)
    if fp32:
        jc = jc.replace(compute_dtype=jnp.float32)
        tc = tc.replace(compute_dtype=torch.float32)
    return jc.replace(**kw), tc.replace(**kw)


@pytest.fixture(scope="module")
def weights():
    jc, tc = _cfgs(True)
    jp = j_build(jc).init(jax.random.PRNGKey(0))
    return jp, params_from_jax(tc, jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)


def _close(got, want, tol, label=""):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (label, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (label, err, tol * scale)


def test_config_matches_reference():
    jc, tc = j_get_reduced(ARCH), get_reduced(ARCH)
    for f in ("n_layers", "attn_every", "d_model", "n_heads", "d_state",
              "headdim", "ssd_chunk", "vocab_size", "padded_vocab",
              "head_dim", "d_inner", "ssm_heads"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert tc.param_dtype == torch.float32
    assert tc.compute_dtype == torch.bfloat16
    from repro.configs import get_config as jfull
    from repro_torch.configs import get_config
    assert get_config(ARCH).param_count() == jfull(ARCH).param_count()


def test_params_from_jax_keeps_the_tree(weights):
    jp, tp = weights
    jl_ = jax.tree_util.tree_leaves_with_path(jp)
    from repro_torch.models.module import tree_leaves
    tleaves = tree_leaves(tp)
    assert len(tleaves) == len(jl_)
    for (_, a), b in zip(jl_, tleaves):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(_cfgs(True)[1], {"embed": {}}, device="cpu")


def test_rmsnorm_and_rope():
    rng = np.random.RandomState(0)
    x, w = rng.randn(2, 5, 64), rng.rand(64) + 0.5
    _close(tl.rmsnorm(_t(x), _t(w)), jl.rmsnorm(jnp.asarray(x, jnp.float32),
                                                jnp.asarray(w, jnp.float32)),
           1e-4)
    q = rng.randn(2, 5, 4, 16)
    pos = np.broadcast_to(np.arange(3, 8), (2, 5)).astype(np.int32)
    _close(tl.apply_rope(_t(q), torch.as_tensor(pos), 1e4),
           jl.apply_rope(jnp.asarray(q, jnp.float32), jnp.asarray(pos), 1e4),
           1e-4)


def test_attn_qkv_mlp_and_decode_attention(weights):
    jp, tp = weights
    jc, tc = _cfgs(True)
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 64) * 0.5
    pos = np.broadcast_to(np.arange(6), (2, 6)).astype(np.int32)
    jq = jl.attn_qkv(jp["shared"]["attn"], jnp.asarray(x, jnp.float32), jc,
                     jnp.asarray(pos))
    tq = tl.attn_qkv(tp["shared"]["attn"], _t(x), tc, torch.as_tensor(pos))
    for a, b in zip(tq, jq):
        _close(a, b, 1e-4)
    _close(tl.mlp(tp["shared"]["mlp"], _t(x), tc),
           jl.mlp(jp["shared"]["mlp"], jnp.asarray(x, jnp.float32), jc), 1e-4)
    _close(tl.attn_out(tp["shared"]["attn"], tq[0], tc),
           jl.attn_out(jp["shared"]["attn"], jq[0], jc), 1e-4)
    # one new token against a cache with a stale tail
    q1, kn, vn = (rng.randn(2, 1, h, 16) for h in (4, 4, 4))
    K, V = rng.randn(2, 9, 4, 16), rng.randn(2, 9, 4, 16)
    kv_len = np.array([6, 9], np.int32)
    want = jl.decode_attention(*(jnp.asarray(a, jnp.float32)
                                 for a in (q1, K, V, kn, vn)),
                               jnp.asarray(kv_len))
    got = tl.decode_attention(*(_t(a) for a in (q1, K, V, kn, vn)),
                              torch.as_tensor(kv_len))
    _close(got, want, 1e-4)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_forward_and_decode_step(weights, with_state):
    jp, tp = weights
    jc, tc = _cfgs(True)
    lj = jax.tree_util.tree_map(lambda a: a[1], jp["mamba"]["mix"])
    lt = {k: w[1] for k, w in tp["mamba"]["mix"].items()}
    rng = np.random.RandomState(2)
    x = rng.randn(2, 21, 64) * 0.5        # ragged against ssd_chunk=16
    H, P, N = tc.ssm_heads, tc.headdim, tc.d_state
    h0 = rng.randn(2, H, P, N) * 0.2 if with_state else None
    jy, jh, jtail = jssm.mamba2_forward(
        lj, jnp.asarray(x, jnp.float32), jc,
        None if h0 is None else jnp.asarray(h0, jnp.float32))
    ty, th, ttail = tssm.mamba2_forward(lt, _t(x), tc,
                                        None if h0 is None else _t(h0),
                                        kernels="torch")
    _close(ty, jy, 1e-4)
    _close(th, jh, 1e-4)
    _close(ttail, jtail, 1e-4)
    x1 = rng.randn(2, 1, 64) * 0.5
    jo = jssm.mamba2_decode_step(lj, jnp.asarray(x1, jnp.float32), jc, jh,
                                 jtail)
    to = tssm.mamba2_decode_step(lt, _t(x1), tc, th, ttail)
    for a, b in zip(to, jo):
        _close(a, b, 1e-4)


def _run_both(jc, tc, jp, tp, S=32, steps=3, seed=3):
    """Prefill S tokens, then ``steps`` decode steps on the same fed-back
    tokens, on both sides; yields (label, port tensor, JAX array)."""
    jm, tm = j_build(jc), build(tc, kernels="torch")
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, tc.vocab_size, (2, S + steps)).astype(np.int32)
    jlog, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks[:, :S])})
    tlog, tcache = tm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :S])},
                              max_len=S + steps)
    yield "prefill logits", tlog, jlog
    for kk in ("k", "v"):
        yield f"prefill {kk}", tcache[kk][:, :, :S], jcache[kk]
    for kk in ("ssm", "conv"):
        yield f"prefill {kk}", tcache[kk], jcache[kk]
    assert tcache["len"] == S == int(jcache["len"])
    for kk in ("k", "v"):
        pad = jnp.zeros(jcache[kk].shape[:2] + (steps,)
                        + jcache[kk].shape[3:], jcache[kk].dtype)
        jcache[kk] = jnp.concatenate([jcache[kk], pad], axis=2)
    jdec = jax.jit(jm.decode)
    for i in range(steps):
        tok = toks[:, S + i:S + i + 1]
        jlog, jcache = jdec(jp, jcache, {"token": jnp.asarray(tok)})
        tlog, tcache = tm.decode(tp, tcache, {"token": torch.as_tensor(tok)})
        yield f"decode {i} logits", tlog, jlog
    for kk in ("k", "v", "ssm", "conv"):
        yield f"decode {kk}", tcache[kk], jcache[kk]
    assert tcache["len"] == S + steps == int(jcache["len"])


@pytest.mark.parametrize("attn_chunk", [512, 16])
def test_hybrid_prefill_decode_fp32(weights, attn_chunk):
    """fp32: logits and caches within 1e-3 * scale.  attn_chunk=16 sends
    the reference's prefill through its chunked online-softmax attention
    (``layers._chunked_attention``); the port has no such knob (its config
    refuses it), its attention is the same function either way."""
    jp, tp = weights
    jc, tc = _cfgs(True)
    jc = jc.replace(attn_chunk=attn_chunk)
    for label, got, want in _run_both(jc, tc, jp, tp):
        _close(got, want, 1e-3, label)


def test_hybrid_prefill_decode_bf16(weights):
    """Default bf16 compute: logits within 0.06 * scale."""
    jp, tp = weights
    jc, tc = _cfgs(False)
    n = 0
    for label, got, want in _run_both(jc, tc, jp, tp):
        if "logits" in label:
            _close(got, want, 0.06, label)
            n += 1
    assert n == 4
