"""The port's ``SSMModel`` (mamba2) held against the JAX package's, on the
reduced mamba2-130m (2 layers, d_model 64, 8 SSD heads of 16, N=16,
chunk 16, tied embeddings).

Weights come from the reference's own init with every constant leaf (the
norm weights, ``D``, ``A_log``, ``dt_bias``, ``conv_b``) replaced by
seeded numpy noise, so that each carries weight, and are carried across
with ``params_from_jax``; inputs are seeded numpy.  The JAX side runs
plain ``jit`` on the CPU.  Tolerances (``scale`` = max(|reference|, 1)):

* ``SSMModel.prefill`` and three ``decode`` steps with ``compute_dtype``
  float32: logits and the ``ssm`` / ``conv`` caches within 1e-3 * scale;
  with the default bf16 within 0.06 * scale, the bound of
  ``tests/test_models.py``;
* prompts of 32 tokens (two chunks) and 21 (a ragged last chunk);
* ``Server`` against ``repro.launch.serve.Server`` in float32 across a
  publish: the same ids, versions and ``ServeStats``;
* ``make_prefill_step`` / ``make_decode_step`` generate what ``Server``
  generates.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.launch.serve import Server as JServer
from repro.models.model import build as j_build
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch.serve import Server
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import SSMModel, build
from repro_torch.models.module import tree_leaves

ARCH = "mamba2-130m"
# constant leaves of the reference's init -> (offset, scale) of their noise
NOISE = {"ln": (1.0, 0.3), "ln1": (1.0, 0.3), "ln2": (1.0, 0.3),
         "ln3": (1.0, 0.3), "norm_w": (1.0, 0.3), "final_norm": (1.0, 0.3),
         "enc_norm": (1.0, 0.3), "D": (1.0, 0.3), "A_log": (0.0, 0.5),
         "dt_bias": (0.0, 0.5), "conv_b": (0.0, 0.1)}


def _close(got, want, tol, label=""):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (label, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (label, err, tol * scale)


def noisy(jparams, seed=0):
    """The reference's init as a numpy tree, its constant leaves (``NOISE``)
    replaced by seeded noise."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                out[k] = walk(tree[k])
                continue
            a = np.asarray(tree[k], np.float32)
            if k in NOISE:
                off, sc = NOISE[k]
                a = (off + sc * rng.randn(*a.shape)).astype(np.float32)
            out[k] = a
        return out
    return walk(jparams)


def both(arch, fp32=True, seed=0):
    """(JAX config, port config, JAX params, port params) for the reduced
    ``arch`` on the same noisy weights."""
    jc, tc = j_get_reduced(arch), get_reduced(arch)
    if fp32:
        jc = jc.replace(compute_dtype=jnp.float32)
        tc = tc.replace(compute_dtype=torch.float32)
    npar = noisy(j_build(jc).init(jax.random.PRNGKey(seed)), seed)
    jp = jax.tree_util.tree_map(jnp.asarray, npar)
    return jc, tc, jp, params_from_jax(tc, npar, device="cpu")


def test_config_matches_reference():
    for j, t in ((j_get_config(ARCH), get_config(ARCH)),
                 (j_get_reduced(ARCH), get_reduced(ARCH))):
        for f in dataclasses.fields(t):
            a, b = getattr(t, f.name), getattr(j, f.name)
            if f.name.endswith("dtype"):
                a, b = str(a).split(".")[-1], np.dtype(b).name
            assert a == b, (f.name, a, b)
        assert t.param_count() == j.param_count()
        assert (t.ssm_heads, t.d_inner, t.padded_vocab) == (
            j.ssm_heads, j.d_inner, j.padded_vocab)
    assert isinstance(build(get_reduced(ARCH)), SSMModel)
    assert get_config(ARCH).param_count() == 128_902_272


def test_params_from_jax_on_the_blocks_tree():
    """Every leaf of the ``blocks`` tree carries across bit for bit; the
    head is tied (no ``head``); a wrong tree raises."""
    jc, tc, jp, tp = both(ARCH)
    assert set(tp) == {"embed", "blocks", "final_norm"}
    assert set(tp["embed"]) == {"tok"}
    jleaves = jax.tree_util.tree_leaves(jp)
    assert len(tree_leaves(tp)) == len(jleaves) == len(
        tree_leaves(build(tc).param_specs()))
    for a, b in zip(jleaves, tree_leaves(tp)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    bad = jax.tree_util.tree_map(np.asarray, jp)
    bad["blocks"]["mix"]["extra"] = bad["blocks"]["mix"]["D"]
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(tc, bad, device="cpu")


def run_both(jc, tc, jp, tp, S, steps=3, B=2, seed=3):
    """Prefill S tokens, then ``steps`` decode steps on the same fed-back
    tokens, on both sides; yields (label, port tensor, JAX array)."""
    jm, tm = j_build(jc), build(tc, kernels="torch")
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, tc.vocab_size, (B, S + steps)).astype(np.int32)
    jlog, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks[:, :S])})
    # prefill takes the server's max_len and ignores it
    tlog, tcache = tm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :S])},
                              max_len=S + 128)
    assert set(tcache) == set(jcache) == {"ssm", "conv", "len"}
    yield "prefill logits", tlog, jlog
    for kk in ("ssm", "conv"):
        yield f"prefill {kk}", tcache[kk], jcache[kk]
    assert tcache["len"] == S == int(jcache["len"])
    jdec = jax.jit(jm.decode)
    for i in range(steps):
        tok = toks[:, S + i:S + i + 1]
        jlog, jcache = jdec(jp, jcache, {"token": jnp.asarray(tok)})
        tlog, tcache = tm.decode(tp, tcache, {"token": torch.as_tensor(tok)})
        yield f"decode {i} logits", tlog, jlog
    for kk in ("ssm", "conv"):
        yield f"decode {kk}", tcache[kk], jcache[kk]
    assert tcache["len"] == S + steps == int(jcache["len"])


@pytest.mark.parametrize("S", [32, 21], ids=["chunks", "ragged"])
@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
def test_ssm_prefill_decode(fp32, S):
    """float32: logits and caches within 1e-3 * scale; bf16 within
    0.06 * scale."""
    jc, tc, jp, tp = both(ARCH, fp32)
    assert S % tc.ssd_chunk == (0 if S == 32 else 5)
    n = 0
    for label, got, want in run_both(jc, tc, jp, tp, S):
        _close(got, want, 1e-3 if fp32 else 0.06, label)
        n += 1
    assert n == 8


def test_ssm_cache_has_no_kv_and_decode_never_fills():
    """No KV cache: the cache's size does not depend on ``max_len``, and
    decode runs past any margin (no ``_check_room``)."""
    tc = get_reduced(ARCH).replace(compute_dtype=torch.float32)
    model = build(tc, kernels="torch")
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    shapes = {k: tuple(v.shape) for k, v in model.init_cache(2).items()
              if k != "len"}
    assert shapes == {k: tuple(v.shape) for k, v in
                      model.init_cache(2, 999).items() if k != "len"}
    assert shapes == {"ssm": (2, 2, 8, 16, 16), "conv": (2, 2, 3, 160)}
    toks = torch.zeros((2, 5), dtype=torch.int32)
    _, cache = model.prefill(params, {"tokens": toks}, max_len=5)
    tok = toks[:, :1]
    for _ in range(8):
        logits, cache = model.decode(params, cache, {"token": tok})
    assert cache["len"] == 13 and logits.shape == (2, 1, tc.padded_vocab)


def test_server_matches_reference_across_a_publish():
    jc, tc, jp0, tp0 = both(ARCH, seed=0)
    _, _, jp1, tp1 = both(ARCH, seed=1)
    jsrv = JServer(jc, jp0, batch_size=2)
    tsrv = Server(tc, tp0, batch_size=2, device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, tc.vocab_size, (2, S)).astype(np.int32)
               for S in (32, 21)]
    for i, toks in enumerate(prompts):
        if i == 1:
            assert jsrv.publish(jp1) and tsrv.publish(tp1)
        jr = jsrv.serve_batch(toks, max_new_tokens=4)
        tr = tsrv.serve_batch(toks, max_new_tokens=4)
        assert tr["weight_version"] == jr["weight_version"] == i
        assert tr["generated"].dtype == np.int32
        np.testing.assert_array_equal(tr["generated"], jr["generated"])
    assert dataclasses.asdict(tsrv.stats) == dataclasses.asdict(jsrv.stats)
    assert tsrv.stats.versions_served == [0, 1]


def test_step_factories_serve_what_the_server_serves():
    from repro_torch.launch.train import make_decode_step, make_prefill_step
    tc = get_reduced(ARCH).replace(compute_dtype=torch.float32)
    model, prefill = make_prefill_step(tc, "torch")
    _, decode = make_decode_step(tc, "torch")
    assert isinstance(model, SSMModel)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.RandomState(1).randint(0, tc.vocab_size, (2, 19)).astype(
        np.int32)
    want = Server(tc, params, batch_size=2, device="cpu").serve_batch(
        toks, max_new_tokens=4)["generated"]
    logits, cache = prefill(params, {"tokens": torch.as_tensor(toks)})
    tok = logits[..., :tc.vocab_size].argmax(dim=-1).int()
    out = [tok]
    for _ in range(3):
        tok, cache = decode(params, cache, {"token": tok})
        out.append(tok)
    np.testing.assert_array_equal(torch.cat(out, dim=1).numpy(), want)
