"""The port's ``moe_ffn`` and its two MoE models held against the JAX
package's, on the reduced deepseek-moe-16b and phi3.5-moe configurations.

Weights: the reference's own init with seeded noise on the norm weights
(``tests/test_torch_decoder.py``), carried across with ``params_from_jax``.
Inputs are seeded numpy.  Router logits are random float32, so ties
between expert probabilities have measure zero: the tests assume none,
and ``torch.topk`` and ``lax.top_k`` then pick the same experts in the
same order.  Tolerances (``scale`` = max(|reference|, 1)):

* ``moe_ffn`` in float32: out and aux within 1e-4 * scale, at the
  configurations' ``capacity_factor`` of 1.25 and at 0.25, where most
  routed pairs overflow their expert and are dropped;
* the models in float32: logits and caches within 1e-3 * scale; in bf16
  logits within 0.06 * scale (of the JAX package's float32 logits where
  its own bf16 rounding flips a routing near-tie: see
  ``test_moe_model_prefill_decode_bf16``).  Prefill is compared with prefill and decode
  with decode on identical inputs: the capacity drops of a batched prefill
  and of a one-token decode differ by construction
  (``tests/test_models.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl
from test_torch_decoder import _close, _t, both, run_both

MOE = ("deepseek-moe-16b", "phi3.5-moe-42b-a6.6b")


def _moe_layer(arch, **kw):
    jc, tc, jp, tp = both(arch, **kw)
    # layer 1's slice of each stacked leaf (torch tensors are leaves too)
    ja, ta = (jax.tree_util.tree_map(lambda a: a[1], p["blocks"]["moe"])
              for p in (jp, tp))
    return jc, tc, ja, ta


@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_matches_reference(arch, cf):
    jc, tc, ja, ta = _moe_layer(arch, capacity_factor=cf)
    x = np.random.RandomState(5).randn(3, 40, tc.d_model) * 0.7
    jo, jaux = jl.moe_ffn(ja, jnp.asarray(x, jnp.float32), jc)
    to, taux = tl.moe_ffn(ta, _t(x), tc)
    _close(to, jo, 1e-4, "out")
    _close(taux, jaux, 1e-4, "aux")
    T = 40 * tc.top_k
    C = tl.moe_capacity(T, tc)
    assert C == max(4, -(-int(np.ceil(T / tc.n_experts * cf)) // 4) * 4)
    if cf < 1:
        # the drop path carries weight: the dropless layer answers otherwise
        free, _ = tl.moe_ffn(ta, _t(x), tc.replace(capacity_factor=16.0))
        assert C * tc.n_experts < T
        assert float((free - to).abs().max()) > 0.1


def test_moe_specs_match_reference():
    for arch in MOE:
        jc, tc, ja, ta = _moe_layer(arch)
        flat = jax.tree_util.tree_flatten_with_path(ja)[0]
        assert len(flat) == len(jax.tree_util.tree_leaves(
            tl.moe_specs(tc), is_leaf=lambda s: hasattr(s, "shape")))
        for path, leaf in flat:
            keys = [p.key for p in path]
            t = ta
            for k in keys:
                t = t[k]
            assert tuple(t.shape) == leaf.shape, keys
        assert ("shared" in ta) == bool(tc.n_shared_experts)


@pytest.mark.parametrize("arch", MOE)
def test_moe_model_prefill_decode_fp32(arch):
    jc, tc, jp, tp = both(arch)
    n = 0
    for label, got, want in run_both(jc, tc, jp, tp):
        _close(got, want, 1e-3, label)
        n += 1
    assert n == 8


@pytest.mark.parametrize("arch", MOE)
def test_moe_model_prefill_decode_bf16(arch):
    """bf16 logits within 0.06 * scale of the JAX package's bf16 logits, or,
    at a step where the JAX package's own bf16 rounding flips a routing
    choice (its bf16 logits leave the 0.06 band around its float32 ones:
    a near-tie between two experts), within 0.06 * scale of its float32
    logits.  On deepseek-moe-16b-reduced its compiled prefill does flip one
    (0.42 of scale from its float32 run; 0.51 from its own op-by-op run,
    since XLA fuses the bf16 chains and rounds at other places), and so
    does its first decode step, which reads that prefill's cache; on
    phi3.5-moe-reduced its first decode step does (0.079; the two experts'
    probabilities 0.1011 and 0.1010)."""
    jc, tc, jp, tp = both(arch, fp32=False)
    ref32 = {label: np.asarray(want, np.float32) for label, _, want in
             run_both(*both(arch)) if "logits" in label}
    for label, got, want in run_both(jc, tc, jp, tp):
        if "logits" not in label:
            continue
        want = np.asarray(want, np.float32)
        scale = max(float(np.abs(ref32[label]).max()), 1.0)
        if np.abs(got.float().numpy() - want).max() > 0.06 * scale:
            assert np.abs(want - ref32[label]).max() > 0.06 * scale, label
            _close(got, ref32[label], 0.06, label + " vs float32")
    assert len(ref32) == 4


def test_moe_model_under_heavy_drops():
    """The whole model at capacity_factor 0.25, prefill and decode."""
    jc, tc, jp, tp = both("deepseek-moe-16b", capacity_factor=0.25)
    for label, got, want in run_both(jc, tc, jp, tp, S=32, steps=2):
        _close(got, want, 1e-3, label)
