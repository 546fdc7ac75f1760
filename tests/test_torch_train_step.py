"""The port's training step and its parts held against the JAX package on
the CPU: ``cross_entropy`` and ``cast_grad_bf16``; ``adamw_update`` fed the
same numpy gradients (to 1e-6 relative); int8 compression and
``compressed_psum`` over the emulated axis against the reference under
``jax.vmap(..., axis_name="pod")``; ``abstract_train_state`` against
``jax.eval_shape`` for all ten full configurations; and the reference's
own training tests (``test_adamw_converges_quadratic``,
``test_train_loss_decreases_reduced``) run on the port.  Inputs are
seeded numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.launch.train import abstract_train_state as j_abstract
from repro.models import layers as jl
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import compress as jc
from repro_torch.checkpoint.postsi_store import _flatten
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch.inputs import make_batch
from repro_torch.launch.train import abstract_train_state, make_train_step
from repro_torch.models import layers as tl
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               compress_int8, compressed_psum,
                               decompress_int8)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small eager ops: on one intra-op thread they do not stall when the
    other test workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want, tol, label=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(
        float(np.abs(want).max()), 1e-30), err_msg=label)


@pytest.mark.parametrize("masked", [0, 5, 48])
def test_cross_entropy_matches_reference(masked):
    """Over all padded-vocab columns; labels < 0 ignored (all of them:
    the loss is 0, as in the reference)."""
    rng = np.random.RandomState(masked)
    logits = (rng.randn(3, 16, 320) * 3).astype(np.float32)
    labels = rng.randint(0, 300, (3, 16)).astype(np.int32)
    labels.reshape(-1)[rng.permutation(48)[:masked]] = -1
    want = jl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 300)
    got = tl.cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels),
                           300)
    _rel(got, want, 1e-6)
    assert (float(got) == 0.0) == (masked == 48)
    if masked < 48:   # the padded columns take part in the log-sum-exp
        cut = tl.cross_entropy(torch.as_tensor(logits[..., :300]),
                               torch.as_tensor(labels), 300)
        assert float(cut) != float(got)


def test_cast_grad_bf16_matches_reference():
    x = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    g = (np.random.RandomState(1).randn(4, 8) * 1.37).astype(np.float32)
    y, vjp = jax.vjp(jl.cast_grad_bf16, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    yt = tl.cast_grad_bf16(xt)
    (got,) = torch.autograd.grad(yt, xt, torch.as_tensor(g))
    assert torch.equal(yt.detach(), xt.detach())
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got.numpy(), g)       # it did round
    # a bf16 cotangent passes unchanged
    xb = torch.tensor(x, dtype=torch.bfloat16, requires_grad=True)
    gb = torch.as_tensor(g).bfloat16()
    (got,) = torch.autograd.grad(tl.cast_grad_bf16(xb), xb, gb)
    assert torch.equal(got, gb)


def _tree(rng):
    return {"w": rng.randn(6, 5).astype(np.float32),
            "b": {"x": rng.randn(7).astype(np.float32),
                  "y": rng.randn(2, 3, 2).astype(np.float32)}}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree.detach() if isinstance(tree, torch.Tensor)
                      else tree, np.float32)


@pytest.mark.parametrize("gscale,wd", [(0.1, 0.1), (30.0, 0.1), (1.0, 0.0)])
def test_adamw_update_matches_reference(gscale, wd):
    """Five steps fed the same numpy gradients; clipping is active at the
    two larger gradient scales.  Parameters, moments, step and global norm
    within 1e-6 relative."""
    rng = np.random.RandomState(3)
    p0 = _tree(rng)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = jax.tree_util.tree_map(torch.tensor, p0)
    js, ts = j_adamw_init(jp), adamw_init(tp)
    assert isinstance(ts, AdamWState) and ts.step.dtype == torch.int32
    for i in range(5):
        g = jax.tree_util.tree_map(lambda a: a * gscale, _tree(rng))
        jp, js, jn = j_adamw_update(jp, jax.tree_util.tree_map(
            jnp.asarray, g), js, 3e-2, weight_decay=wd)
        tp, ts, tn = adamw_update(tp, jax.tree_util.tree_map(
            torch.tensor, g), ts, 3e-2, weight_decay=wd)
        _rel(tn, jn, 1e-6, "gnorm")
        assert int(ts.step) == int(js.step) == i + 1
        for name, a, b in (("params", tp, jp), ("m", ts.m, js.m),
                           ("v", ts.v, js.v)):
            for x, y in zip(jax.tree_util.tree_leaves(_np(a)),
                            jax.tree_util.tree_leaves(_np(b))):
                _rel(x, y, 1e-6, f"{name} step {i}")
    assert (float(jn) > 1.0) == (gscale >= 1.0)   # clipped, or not


def test_adamw_converges_quadratic():
    """The reference's ``test_adamw_converges_quadratic`` on the port."""
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}        # d/dw ||w||^2
        params, opt, _ = adamw_update(params, grads, opt, lr=5e-2,
                                      weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.05


def test_compress_int8_matches_reference():
    rng = np.random.RandomState(4)
    x = rng.randn(5, 9).astype(np.float32)
    r = (rng.randn(5, 9) * 0.01).astype(np.float32)
    want = jc.compress_int8(jnp.asarray(x), jnp.asarray(r))
    got = compress_int8(torch.as_tensor(x), torch.as_tensor(r))
    assert got[0].dtype == torch.int8
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _rel(got[1], want[1], 1e-7)
    _rel(got[2], want[2], 1e-6)
    _rel(decompress_int8(got[0], got[1]),
         jc.decompress_int8(want[0], want[1]), 1e-7)


@pytest.mark.parametrize("residual", [False, True])
def test_compressed_psum_matches_reference_vmap(residual):
    """Over 4 shards of the emulated axis, against the reference under
    ``jax.vmap(..., axis_name="pod")``: the total broadcast to every shard,
    each shard's error; shard 2 holds the largest |x|, so the scale is one
    shard's and the others quantize with it."""
    rng = np.random.RandomState(5)
    x = rng.randn(4, 3, 7).astype(np.float32)
    x[2] *= 10
    r = (rng.randn(4, 3, 7) * 0.05).astype(np.float32) if residual else None
    fn = jax.vmap(lambda a, b: jc.compressed_psum(a, "pod", b),
                  axis_name="pod", in_axes=(0, 0 if residual else None))
    want_tot, want_err = fn(jnp.asarray(x),
                            None if r is None else jnp.asarray(r))
    got_tot, got_err = compressed_psum(
        torch.as_tensor(x), None if r is None else torch.as_tensor(r))
    assert got_tot.shape == got_err.shape == x.shape
    _rel(got_tot, want_tot, 1e-6, "total")
    _rel(got_err, want_err, 1e-5, "err")
    assert torch.equal(got_tot[0], got_tot[3])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_train_state_matches_eval_shape(arch):
    """Parameters and optimizer state on the ``meta`` device with the
    reference's leaf paths, shapes and dtypes (``jax.eval_shape``)."""
    _, jparams, jopt = j_abstract(j_get_config(arch))
    _, params, opt = abstract_train_state(get_config(arch))
    want = [(jax.tree_util.keystr(p), tuple(a.shape), np.dtype(a.dtype).name)
            for p, a in jax.tree_util.tree_flatten_with_path(
                {"params": jparams, "opt": jopt})[0]]
    got = [(p, tuple(a.shape), str(a.dtype).split(".")[-1])
           for p, a in _flatten({"params": params, "opt": opt})]
    assert got == want
    assert all(a.device.type == "meta" for _, a in _flatten(
        {"params": params, "opt": opt}))


def test_train_loss_decreases_reduced():
    """The reference's ``test_train_loss_decreases_reduced`` on the port:
    30 steps on one batch cut the loss below 0.7 of its first value."""
    cfg = get_reduced("qwen2-0.5b")
    model, step = make_train_step(cfg, lr=3e-3, kernels="torch")
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    opt = adamw_init(params)
    batch = make_batch(cfg, 4, 32, "train", device="cpu")
    first = None
    for i in range(30):
        params, opt, m = step(params, opt, batch)
        if first is None:
            first = float(m["loss"])
    assert float(m["loss"]) < first * 0.7, (first, float(m["loss"]))
    assert set(m) == {"loss", "gnorm", "ce", "aux"}
    assert int(opt.step) == 30
