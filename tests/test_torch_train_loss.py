"""The port's training loss and its gradient held against the JAX
package's ``jax.value_and_grad(model.loss)``, for every family, on the ten
reduced configurations.

Weights: the reference's own init with its constant leaves (zero qkv
biases, unit norm weights, the SSM's ``D`` / ``A_log`` / ``dt_bias`` /
``conv_b``) replaced by seeded numpy noise, so that each carries weight
and gets a gradient of its own; carried across with ``params_from_jax``.
Batches are seeded numpy, with a few labels at -1 (ignored by the loss),
M-RoPE positions for the VLM and frame embeddings for the encoder-decoder.
The port runs on the ``torch`` route (the CPU's), remat included (a
gradient is taken, so every layer runs under ``torch.utils.checkpoint``);
the reduced qwen2-vl-2b keeps its head dim of 24.  Tolerances, each
against the reference's own scale (``scale`` = max |reference| of that
loss or leaf):

* float32 compute: the loss, its metrics and every gradient leaf within
  1e-4 * scale (float32 sums in another order);
* bf16 compute (the dense, VLM, SSM, hybrid and encoder-decoder families):
  the loss within 0.06 * scale of the JAX package's bf16 loss, the band
  of ``tests/test_models.py``, and so is each gradient leaf, unless the
  JAX package's own bf16 leaf lies outside that band around its float32
  leaf: a gradient sums B * S products, each rounded to bf16 at other
  places in the two frameworks, and on the reduced SSM and hybrid models
  the reference's bf16 leaves stray up to 0.33 of scale from its float32
  ones.  Such a leaf is held, as ``test_moe_model_prefill_decode_bf16``
  holds a flipped routing, to the float32 reference: within 1.5 times the
  JAX package's own bf16-vs-float32 distance, the margin ``chip_smoke.py``
  gives the ``cuda`` route's bf16 logits over the ``torch`` route's.  The MoE family is held to float32
  only, as in ``tests/test_torch_moe.py``: in bf16 a near-tie between two
  experts' router probabilities can flip in one framework and not the
  other.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_reduced as j_get_reduced
from repro.models.model import AUX_COEF as J_AUX_COEF
from repro.models.model import build as j_build
from repro_torch.configs import get_reduced
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import AUX_COEF, build
from repro_torch.models.module import tree_leaves
from test_torch_decoder import positions3

# constant leaves of the reference's init -> (offset, scale) of their noise
NOISE = {"ln": (1.0, 0.3), "ln1": (1.0, 0.3), "ln2": (1.0, 0.3),
         "ln3": (1.0, 0.3), "norm_w": (1.0, 0.3), "final_norm": (1.0, 0.3),
         "enc_norm": (1.0, 0.3), "q_norm": (1.0, 0.3), "k_norm": (1.0, 0.3),
         "bq": (0.0, 0.5), "bk": (0.0, 0.5), "bv": (0.0, 0.5),
         "D": (1.0, 0.3), "A_log": (0.0, 0.5), "dt_bias": (0.0, 0.5),
         "conv_b": (0.0, 0.1)}
BF16 = ("qwen2-0.5b", "qwen2-vl-2b", "mamba2-130m", "zamba2-2.7b",
        "seamless-m4t-large-v2")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side runs many small eager ops: on one intra-op thread
    they do not stall when the other test workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def noisy(jparams, seed=0):
    """The reference's init as a numpy tree, its constant leaves
    (``NOISE``) replaced by seeded noise."""
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
    """(JAX config, port config, JAX params, port params, numpy params)
    for the reduced ``arch`` on the same noisy weights."""
    jc, tc = j_get_reduced(arch), get_reduced(arch)
    if fp32:
        jc = jc.replace(compute_dtype=jnp.float32)
        tc = tc.replace(compute_dtype=torch.float32)
    npar = noisy(j_build(jc).init(jax.random.PRNGKey(seed)), seed)
    jp = jax.tree_util.tree_map(jnp.asarray, npar)
    return jc, tc, jp, params_from_jax(tc, npar, device="cpu"), npar


def train_batch(cfg, B=2, S=32, seed=1):
    """A numpy training batch of ``cfg``'s family: tokens, labels (three
    of them -1), M-RoPE positions or encoder frames where the family
    takes them."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :2] = -1
    batch["labels"][-1, -1] = -1
    if cfg.mrope:
        batch["positions"] = positions3(B, S, seed)
    if cfg.family == "encdec":
        batch["enc_embeds"] = (rng.randn(B, S + 5, cfg.d_model)
                               * 0.05).astype(np.float32)
    return batch


def loss_and_grads(jc, tc, jp, tp, batch):
    """((JAX loss, metrics, grads as a numpy leaf list), (the port's))."""
    (jl, jm), jg = jax.jit(jax.value_and_grad(j_build(jc).loss,
                                              has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    leaves = jax.tree_util.tree_map(
        lambda t: t.detach().requires_grad_(True), tp)
    tl, tm = build(tc, "torch").loss(
        leaves, {k: torch.as_tensor(v) for k, v in batch.items()})
    tg = torch.autograd.grad(tl, tree_leaves(leaves))
    return ((float(jl), {k: float(v) for k, v in jm.items()},
             [np.asarray(g, np.float32) for g in
              jax.tree_util.tree_leaves(jg)]),
            (float(tl.detach()),
             {k: float(v.detach()) for k, v in tm.items()},
             [g.float().numpy() for g in tg]))


def _paths(tree):
    return [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def check(ref, got, paths, tol):
    (jl, jm, jg), (tl, tm, tg) = ref, got
    assert np.isfinite(tl)
    assert abs(tl - jl) <= tol * max(abs(jl), 1e-30), (tl, jl)
    assert set(tm) == set(jm)
    for k in jm:
        assert abs(tm[k] - jm[k]) <= tol * max(abs(jm[k]), 1e-30), (k, tm,
                                                                     jm)
    assert len(tg) == len(jg) == len(paths)
    for path, a, b in zip(paths, tg, jg):
        assert a.shape == b.shape, path
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max())
        assert err <= tol * scale, (path, err, tol * scale)


def test_aux_coefficient_is_the_reference():
    assert AUX_COEF == J_AUX_COEF


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_fp32(arch):
    jc, tc, jp, tp, npar = both(arch)
    ref, got = loss_and_grads(jc, tc, jp, tp, train_batch(tc))
    check(ref, got, _paths(npar), 1e-4)
    # every leaf carries a gradient of its own (no leaf dropped from the
    # graph), and the decoder family reports its aux loss
    assert all(np.abs(g).max() > 0 for g in got[2])
    if tc.family in ("dense", "moe", "vlm"):
        assert set(got[1]) == {"ce", "aux"}
        assert (got[1]["aux"] > 0) == tc.moe


@pytest.mark.parametrize("arch", BF16)
def test_loss_and_grads_bf16(arch):
    jc, tc, jp, tp, npar = both(arch, fp32=False)
    batch = train_batch(tc)
    (jl, _, jg), (tl, _, tg) = loss_and_grads(jc, tc, jp, tp, batch)
    (_, _, jg32), _ = loss_and_grads(*both(arch)[:4], batch)
    assert np.isfinite(tl) and abs(tl - jl) <= 0.06 * abs(jl), (tl, jl)
    for path, a, b, b32 in zip(_paths(npar), tg, jg, jg32):
        scale = float(np.abs(b32).max())
        if np.abs(a - b).max() <= 0.06 * scale:
            continue
        ref_dist = float(np.abs(b - b32).max())
        assert ref_dist > 0.06 * scale, (path, ref_dist / scale)
        assert np.abs(a - b32).max() <= 1.5 * ref_dist, path


def test_labels_below_zero_are_ignored():
    """A loss whose labels are all -1 but one is that one token's loss."""
    _, tc, _, tp, _ = both("qwen2-0.5b")
    batch = {k: torch.as_tensor(v) for k, v in train_batch(tc).items()}
    model = build(tc, "torch")
    one = batch["labels"].clone().fill_(-1)
    one[1, 5] = batch["labels"][1, 5]
    with torch.no_grad():
        loss, _ = model.loss(tp, {**batch, "labels": one})
        h, _ = model.hidden(tp, batch["tokens"], model._positions(
            batch, *batch["tokens"].shape, "cpu"))
        logits = (h[1, 5].float() @ tp["embed"]["tok"].float().T)
        want = torch.logsumexp(logits, -1) - logits[one[1, 5]]
    assert abs(float(loss) - float(want)) < 1e-4
