"""The port's ``EncDecModel`` (the Seamless text path) held against the JAX
package's, on the reduced seamless-m4t-large-v2 (2 encoder and 2 decoder
layers, d_model 64, 4 heads of 16), plus ``layers.layernorm`` and
``launch.inputs.make_batch``.

Weights come from the reference's own init with the unit norm weights
replaced by seeded numpy noise (``test_torch_ssm_model.noisy``), carried
across with ``params_from_jax``; inputs are seeded numpy, with an encoder
memory of another length than the decoder prompt (S_src != S_tgt).  The
JAX side runs plain ``jit`` on the CPU.  Tolerances (``scale`` =
max(|reference|, 1)):

* ``encode``, ``prefill`` and three ``decode`` steps with
  ``compute_dtype`` float32: the encoder's output, logits and the caches
  (``k``, ``v``, ``ck``, ``cv``) within 1e-3 * scale; with the default
  bf16 within 0.06 * scale;
* ``Server`` with ``enc_embeds`` against ``repro.launch.serve.Server`` in
  float32 across a publish: the same ids, versions and ``ServeStats``;
* ``layernorm`` within 1e-5 * scale;
* ``make_batch`` equal to the reference's, array for array, for every
  architecture and mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.launch import inputs as j_inputs
from repro.launch.serve import Server as JServer
from repro.models import layers as jl
from repro.models.model import build as j_build
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.launch import inputs as t_inputs
from repro_torch.launch.serve import Server, prompt_batch
from repro_torch.models import layers as tl
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import EncDecModel, build
from repro_torch.models.module import tree_leaves
from test_torch_ssm_model import _close, both

ARCH = "seamless-m4t-large-v2"


def _enc(B, S, d, seed=5):
    return (np.random.RandomState(seed).randn(B, S, d) * 0.05).astype(
        np.float32)


def test_config_matches_reference():
    for j, t in ((j_get_config(ARCH), get_config(ARCH)),
                 (j_get_reduced(ARCH), get_reduced(ARCH))):
        for f in dataclasses.fields(t):
            a, b = getattr(t, f.name), getattr(j, f.name)
            if f.name.endswith("dtype"):
                a, b = str(a).split(".")[-1], np.dtype(b).name
            assert a == b, (f.name, a, b)
        assert t.param_count() == j.param_count()
        assert (t.head_dim, t.padded_vocab) == (j.head_dim, j.padded_vocab)
    assert isinstance(build(get_reduced(ARCH)), EncDecModel)
    full = get_config(ARCH)
    assert full.param_count() == 2_034_884_608
    assert (full.n_enc_layers, full.n_layers, full.padded_vocab) == (
        24, 24, 256_256)


def test_params_from_jax_on_the_enc_dec_trees():
    """Every leaf of the ``enc`` / ``dec`` trees carries across bit for
    bit, and a layer's specs are the stacked leaves without their layer
    axis."""
    jc, tc, jp, tp = both(ARCH)
    assert set(tp) == {"embed", "enc", "enc_norm", "dec", "final_norm"}
    assert set(tp["dec"]) == {"ln1", "ln2", "ln3", "attn", "xattn", "mlp"}
    jleaves = jax.tree_util.tree_leaves(jp)
    assert len(tree_leaves(tp)) == len(jleaves)
    for a, b in zip(jleaves, tree_leaves(tp)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    model = build(tc)
    for key, specs in (("enc", model.enc_layer_specs()),
                       ("dec", model.dec_layer_specs())):
        assert [s.shape for s in tree_leaves(specs)] == [
            s.shape[1:] for s in tree_leaves(model.param_specs()[key])]
    bad = jax.tree_util.tree_map(np.asarray, jp)
    del bad["dec"]["ln3"]
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(tc, bad, device="cpu")


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
def test_encode(fp32):
    jc, tc, jp, tp = both(ARCH, fp32)
    e = _enc(2, 27, tc.d_model)
    want = jax.jit(j_build(jc).encode)(jp, jnp.asarray(e))
    got = build(tc, kernels="torch").encode(tp, torch.as_tensor(e))
    assert got.dtype == tc.compute_dtype
    _close(got, want, 1e-3 if fp32 else 0.06)


def run_both(jc, tc, jp, tp, S=24, S_src=37, steps=3, B=2, seed=3):
    """Prefill S decoder tokens over S_src encoder frames, then ``steps``
    decode steps on the same fed-back tokens, on both sides; yields
    (label, port tensor, JAX array)."""
    jm, tm = j_build(jc), build(tc, kernels="torch")
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, tc.vocab_size, (B, S + steps)).astype(np.int32)
    e = _enc(B, S_src, tc.d_model, seed)
    jlog, jcache = jax.jit(jm.prefill)(jp, {
        "tokens": jnp.asarray(toks[:, :S]), "enc_embeds": jnp.asarray(e)})
    tlog, tcache = tm.prefill(tp, prompt_batch(
        tc, torch.as_tensor(toks[:, :S]), e), max_len=S + steps)
    yield "prefill logits", tlog, jlog
    for kk in ("k", "v"):
        yield f"prefill {kk}", tcache[kk][:, :, :S], jcache[kk]
    for kk in ("ck", "cv"):
        assert tcache[kk].shape[2] == S_src
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
    for kk in ("k", "v", "ck", "cv"):
        yield f"decode {kk}", tcache[kk], jcache[kk]
    assert tcache["len"] == S + steps == int(jcache["len"])
    with pytest.raises(ValueError, match="filled"):
        tm.decode(tp, tcache, {"token": torch.as_tensor(tok)})


@pytest.mark.parametrize("fp32", [True, False], ids=["fp32", "bf16"])
def test_encdec_prefill_decode(fp32):
    """float32: logits and caches within 1e-3 * scale; bf16 within
    0.06 * scale; S_src = 37 against a prompt of 24."""
    jc, tc, jp, tp = both(ARCH, fp32)
    n = 0
    for label, got, want in run_both(jc, tc, jp, tp):
        _close(got, want, 1e-3 if fp32 else 0.06, label)
        n += 1
    assert n == 12


def test_server_with_enc_embeds_matches_reference_across_a_publish():
    jc, tc, jp0, tp0 = both(ARCH, seed=0)
    _, _, jp1, tp1 = both(ARCH, seed=1)
    jsrv = JServer(jc, jp0, batch_size=2)
    tsrv = Server(tc, tp0, batch_size=2, device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, tc.vocab_size, (2, S)).astype(np.int32)
               for S in (16, 13)]
    frames = [_enc(2, S, tc.d_model, seed=S) for S in (30, 11)]
    for i, (toks, e) in enumerate(zip(prompts, frames)):
        if i == 1:
            assert jsrv.publish(jp1) and tsrv.publish(tp1)
        jr = jsrv.serve_batch(toks, max_new_tokens=4, enc_embeds=e)
        tr = tsrv.serve_batch(toks, max_new_tokens=4, enc_embeds=e)
        assert tr["weight_version"] == jr["weight_version"] == i
        np.testing.assert_array_equal(tr["generated"], jr["generated"])
    assert dataclasses.asdict(tsrv.stats) == dataclasses.asdict(jsrv.stats)
    assert tsrv.stats.versions_served == [0, 1]
    with pytest.raises(ValueError, match="enc_embeds"):
        tsrv.serve_batch(prompts[0], max_new_tokens=2)


def test_prompt_batch_enc_embeds():
    tc = get_reduced(ARCH)
    toks = torch.zeros((2, 5), dtype=torch.int32)
    e = _enc(2, 9, tc.d_model).astype(np.float64)
    batch = prompt_batch(tc, toks, e)
    assert set(batch) == {"tokens", "enc_embeds"}
    assert batch["enc_embeds"].dtype == torch.float32
    np.testing.assert_array_equal(batch["enc_embeds"].numpy(),
                                  e.astype(np.float32))
    # the other families ignore them, as the reference does
    assert set(prompt_batch(get_reduced("mamba2-130m"), toks, e)) == {
        "tokens"}


def test_step_factories_serve_what_the_server_serves():
    from repro_torch.launch.train import make_decode_step, make_prefill_step
    tc = get_reduced(ARCH).replace(compute_dtype=torch.float32)
    model, prefill = make_prefill_step(tc, "torch")
    _, decode = make_decode_step(tc, "torch")
    assert isinstance(model, EncDecModel)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.RandomState(1).randint(0, tc.vocab_size, (2, 11)).astype(
        np.int32)
    e = _enc(2, 17, tc.d_model)
    want = Server(tc, params, batch_size=2, device="cpu").serve_batch(
        toks, max_new_tokens=4, enc_embeds=e)["generated"]
    logits, cache = prefill(params, prompt_batch(tc, torch.as_tensor(toks), e),
                            toks.shape[1] + 8)
    tok = logits[..., :tc.vocab_size].argmax(dim=-1).int()
    out = [tok]
    for _ in range(3):
        tok, cache = decode(params, cache, {"token": tok})
        out.append(tok)
    np.testing.assert_array_equal(torch.cat(out, dim=1).numpy(), want)


def test_layernorm():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 64) * 3 + 1.5
    w, b = rng.rand(64) + 0.5, rng.randn(64)
    want = jl.layernorm(*(jnp.asarray(a, jnp.float32) for a in (x, w, b)))
    got = tl.layernorm(*(torch.as_tensor(a, dtype=torch.float32)
                         for a in (x, w, b)))
    _close(got, want, 1e-5)
    # bf16 in, bf16 out: statistics in float32
    xb = torch.as_tensor(x, dtype=torch.bfloat16)
    got = tl.layernorm(xb, torch.as_tensor(w), torch.as_tensor(b))
    assert got.dtype == torch.bfloat16
    want = jl.layernorm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                        jnp.asarray(b))
    _close(got, np.asarray(want, np.float32), 1e-2)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_make_batch_equals_reference(arch, mode):
    """The same seed gives the same batch (and, for decode, a zero cache of
    the same shapes, dtypes and fill count) in both packages."""
    jc, tc = j_get_reduced(arch), get_reduced(arch)
    want = j_inputs.make_batch(jc, 2, 11, mode, np.random.RandomState(7))
    got = t_inputs.make_batch(tc, 2, 11, mode, np.random.RandomState(7),
                              device="cpu")
    if mode == "decode":
        (want, jcache), (got, tcache) = want, got
        assert set(tcache) == set(jcache)
        assert tcache["len"] == int(jcache["len"]) == 11
        for k in set(jcache) - {"len"}:
            assert tuple(tcache[k].shape) == jcache[k].shape
            assert str(tcache[k].dtype).split(".")[-1] == np.dtype(
                jcache[k].dtype).name
            assert not bool(tcache[k].any())
    assert set(got) == set(want)
    for k in want:
        a = np.asarray(want[k])
        assert got[k].dtype == (torch.float32 if a.dtype == np.float32
                                else torch.int32)
        np.testing.assert_array_equal(got[k].numpy(), a)
    assert (t_inputs.CACHE_PAD, t_inputs.ENCDEC_DECODE_SRC) == (
        j_inputs.CACHE_PAD, j_inputs.ENCDEC_DECODE_SRC)
