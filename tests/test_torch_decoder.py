"""The port's ``DecoderLM`` (dense and VLM families) held against the JAX
package's, layer by layer and end to end, on the reduced configurations.

Weights come from the reference's own init, with the zero qkv biases and
the unit norm weights replaced by seeded numpy noise (so that the bias,
the qk-norm and every RMSNorm scale carry weight), and are carried across
with ``params_from_jax``; inputs are seeded numpy.  The JAX side runs plain
``jit`` on the CPU, as ``tests/test_models.py`` runs it.  Tolerances
(``scale`` = max(|reference|, 1)):

* layers in float32: 1e-4 * scale (float32 sums in another order);
* ``DecoderLM.prefill`` / ``decode`` with ``compute_dtype`` float32:
  logits and caches within 1e-3 * scale;
* with the default bf16: logits within 0.06 * scale, the bound of
  ``tests/test_models.py`` (bf16 rounds at other places in the two
  frameworks).

The reference configurations of qwen2-0.5b, qwen3-14b, deepseek-coder-33b
and qwen2-vl-2b set ``attn_seq_shard=True``, a GSPMD context-parallel hint;
the port's copies leave it at its default (``REFERENCE_ONLY``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.models import layers as jl
from repro.models.model import build as j_build
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import layers as tl
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import DecoderLM, build
from repro_torch.models.module import tree_leaves

DENSE = ("qwen2-0.5b", "qwen3-14b", "yi-9b", "deepseek-coder-33b")
DECODER = DENSE + ("qwen2-vl-2b", "deepseek-moe-16b", "phi3.5-moe-42b-a6.6b")
# GSPMD-only: steers the reference's sharding, no counterpart on one card
GSPMD_ONLY = ("attn_seq_shard",)
BIASES = ("bq", "bk", "bv")
UNIT = ("q_norm", "k_norm", "ln1", "ln2", "final_norm")


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dtype)


def _close(got, want, tol, label=""):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (label, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (label, err, tol * scale)


def noisy_weights(jparams, seed=0):
    """The reference's init as a numpy tree, with the zero biases and the
    unit norm weights replaced by seeded noise."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            a = np.asarray(v, np.float32)
            if k in BIASES:
                a = (0.5 * rng.randn(*a.shape)).astype(np.float32)
            elif k in UNIT:
                a = (1.0 + 0.3 * rng.randn(*a.shape)).astype(np.float32)
            out[k] = a
        return out
    return walk(jparams)


def both(arch, fp32=True, seed=0, **kw):
    """(JAX config, port config, JAX params, port params) for the reduced
    ``arch`` on the same noisy weights."""
    jc, tc = j_get_reduced(arch).replace(**kw), get_reduced(arch).replace(**kw)
    if fp32:
        jc = jc.replace(compute_dtype=jnp.float32)
        tc = tc.replace(compute_dtype=torch.float32)
    npar = noisy_weights(j_build(jc).init(jax.random.PRNGKey(seed)), seed)
    jp = jax.tree_util.tree_map(jnp.asarray, npar)
    return jc, tc, jp, params_from_jax(tc, npar, device="cpu")


def positions3(B, S, seed=0):
    """Vision-language position ids: text runs (t = h = w) around an image
    patch grid (t fixed, h and w walking rows and columns)."""
    rng = np.random.RandomState(seed)
    pos = np.broadcast_to(np.arange(S)[None, :, None], (B, S, 3)).copy()
    g0 = int(rng.randint(1, S // 3))
    for i in range(S // 3):
        pos[:, g0 + i] = (g0, g0 + i // 3, g0 + i % 3)
    return pos.astype(np.int32)


@pytest.mark.parametrize("arch", DECODER)
def test_config_matches_reference(arch):
    for j, t in ((j_get_config(arch), get_config(arch)),
                 (j_get_reduced(arch), get_reduced(arch))):
        for f in dataclasses.fields(t):
            if f.name in GSPMD_ONLY:
                assert getattr(t, f.name) is False
                continue
            a, b = getattr(t, f.name), getattr(j, f.name)
            if f.name.endswith("dtype"):
                a, b = str(a).split(".")[-1], np.dtype(b).name
            assert a == b, (arch, f.name, a, b)
        assert t.param_count() == j.param_count()
        assert (t.head_dim, t.padded_vocab) == (j.head_dim, j.padded_vocab)
    assert isinstance(build(get_reduced(arch)), DecoderLM)


def test_apply_mrope():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 3, 32)
    pos = positions3(2, 9)
    for sections in ((4, 5, 7), (16, 0, 0), (0, 9, 7), (3, 13, 0)):
        _close(tl.apply_mrope(_t(x), torch.as_tensor(pos), 1e4, sections),
               jl.apply_mrope(jnp.asarray(x, jnp.float32), jnp.asarray(pos),
                              1e4, sections), 1e-4, sections)
    # equal sections of text positions are RoPE
    p1 = np.broadcast_to(np.arange(9), (2, 9)).astype(np.int32)
    p3 = np.repeat(p1[..., None], 3, -1)
    _close(tl.apply_mrope(_t(x), torch.as_tensor(p3), 1e4, (4, 6, 6)),
           tl.apply_rope(_t(x), torch.as_tensor(p1), 1e4).numpy(), 1e-6)
    with pytest.raises(ValueError, match="sections"):
        tl.apply_mrope(_t(x), torch.as_tensor(pos), 1e4, (4, 4, 4))


@pytest.mark.parametrize("mrope", [False, True])
def test_attn_qkv_with_bias_qk_norm_and_rope(mrope):
    """Every attention option at once: qkv bias, qk-norm, RoPE or M-RoPE."""
    kw = dict(qk_norm=True, d_head=32, mrope_sections=(3, 5, 8))
    if not mrope:
        kw["mrope"] = False
    jc, tc, jp, tp = both("qwen2-vl-2b", **kw)
    assert tc.qkv_bias and tc.qk_norm and tc.mrope == mrope
    rng = np.random.RandomState(1)
    x = rng.randn(2, 7, tc.d_model) * 0.5
    pos = positions3(2, 7) if mrope else np.broadcast_to(
        np.arange(2, 9), (2, 7)).astype(np.int32)
    ja = jax.tree_util.tree_map(lambda a: a[1], jp["blocks"]["attn"])
    ta = {k: w[1] for k, w in tp["blocks"]["attn"].items()}
    assert set(ta) == {"wq", "wk", "wv", "wo", "bq", "bk", "bv", "q_norm",
                       "k_norm"}
    want = jl.attn_qkv(ja, jnp.asarray(x, jnp.float32), jc, jnp.asarray(pos))
    got = tl.attn_qkv(ta, _t(x), tc, torch.as_tensor(pos))
    for name, a, b in zip("qkv", got, want):
        _close(a, b, 1e-4, name)
    _close(tl.attn_out(ta, got[0], tc), jl.attn_out(ja, want[0], jc), 1e-4)


def run_both(jc, tc, jp, tp, S=24, steps=3, B=2, seed=3):
    """Prefill S tokens, then ``steps`` decode steps on the same fed-back
    tokens, on both sides; yields (label, port tensor, JAX array)."""
    jm, tm = j_build(jc), build(tc, kernels="torch")
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, tc.vocab_size, (B, S + steps)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :S])}
    tb = {"tokens": torch.as_tensor(toks[:, :S])}
    if tc.mrope:
        pos = positions3(B, S, seed)
        jb["positions"] = jnp.asarray(pos)
        tb["positions"] = torch.as_tensor(pos)
    jlog, jcache = jax.jit(jm.prefill)(jp, jb)
    tlog, tcache = tm.prefill(tp, tb, max_len=S + steps)
    yield "prefill logits", tlog, jlog
    for kk in ("k", "v"):
        yield f"prefill {kk}", tcache[kk][:, :, :S], jcache[kk]
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
    for kk in ("k", "v"):
        yield f"decode {kk}", tcache[kk], jcache[kk]
    assert tcache["len"] == S + steps == int(jcache["len"])
    with pytest.raises(ValueError, match="filled"):
        tm.decode(tp, tcache, {"token": torch.as_tensor(tok)})


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", DENSE + ("qwen2-vl-2b",))
def test_decoder_prefill_decode(arch, fp32):
    """float32 compute: logits and caches within 1e-3 * scale; bf16:
    logits within 0.06 * scale."""
    jc, tc, jp, tp = both(arch, fp32)
    n = 0
    for label, got, want in run_both(jc, tc, jp, tp):
        if fp32 or "logits" in label:
            _close(got, want, 1e-3 if fp32 else 0.06, label)
            n += 1
    assert n == (8 if fp32 else 4)


def test_params_from_jax_on_a_tied_tree():
    """qwen2-0.5b ties its head to the embedding: the tree has no
    ``head``, every leaf (biases included) carries across bit for bit, and
    the logits are the embedding table's products."""
    jc, tc, jp, tp = both("qwen2-0.5b")
    assert tc.tie_embeddings and set(tp["embed"]) == {"tok"}
    jleaves = jax.tree_util.tree_leaves(jp)
    tleaves = tree_leaves(tp)
    assert len(tleaves) == len(jleaves) == len(
        tree_leaves(build(tc).param_specs()))
    for a, b in zip(jleaves, tleaves):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    x = np.random.RandomState(4).randn(2, 3, tc.d_model)
    _close(tl.unembed(tp["embed"], _t(x), tc),
           jl.unembed(jp["embed"], jnp.asarray(x, jnp.float32), jc), 1e-4)
    _close(tl.embed(tp["embed"], torch.tensor([[1, 5]]), tc),
           jl.embed(jp["embed"], jnp.asarray([[1, 5]]), jc), 0)
    bad = jax.tree_util.tree_map(np.asarray, jp)
    bad["embed"]["head"] = bad["embed"]["tok"]
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(tc, bad, device="cpu")
