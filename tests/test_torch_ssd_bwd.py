"""The SSD scan's gradient on the CPU: the plain versions of its three
backward kernels (``ssd_bwd_states_plain``, ``ssd_bwd_scan_plain``,
``ssd_bwd_grads_plain``, chained by ``ssd_bwd_plain``: the kernels'
formulas written out in plain PyTorch) against ``torch.autograd.grad`` of
``ssd_plain``, stage by stage, and against ``jax.vjp`` of the reference's
``models/ssm.py`` ``ssd_chunked``; ``SsdScanFn`` (the ``cuda`` route's
autograd binding, here on CPU tensors, where its wrappers take the plain
versions) against autograd, and what it saves; the reduced mamba2-130m's
and zamba2-2.7b's loss and gradient on the ``cuda`` route (its device
check lifted, so every op takes the plain version of its kernel) against
the ``torch`` route and the JAX model; ``chip_smoke.py``'s SSD backward
cases, launch counts and disassembly check.

Inputs are seeded numpy in float32.  Cases: G = 1 and 2 groups of H = 1
and 3 heads; S = 1, S < Q, S % Q != 0 and S a multiple of Q; h0 and the
final state's gradient each given or None; x, dA and dy folded
(``[BH, S, .]``) and as the views of the model's ``[B, S, H, .]``; decays
dA ~ -U(0, 0.01) and -U(0, 1.4) (a_cum then reaches -179 in a chunk of
128 rows: a factored exponential would overflow).  Tolerance: 1e-4 *
scale (scale = max |reference|), float32 sums in another order.  The
kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 3).
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked as j_ssd_chunked
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.backend import KernelConfig
from repro_torch.models.model import build
from repro_torch.models.module import tree_leaves
from test_torch_train_loss import _paths, both, check, train_batch
from test_torch_train_loss import loss_and_grads as j_loss_and_grads

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-4

# (G groups, H heads a group, S, chunk, h0, dh_final, model layout, decay)
CASES = [(1, 1, 1, 16, False, False, False, 0.3),
         (1, 3, 10, 16, True, False, True, 1.4),
         (2, 3, 37, 16, False, True, False, 0.01),
         (2, 1, 50, 16, True, True, True, 1.4),
         (1, 3, 64, 16, True, True, False, 0.01),
         (2, 3, 100, 32, False, False, True, 1.4),
         (1, 2, 130, 128, True, True, True, 1.4),
         (2, 2, 45, 64, False, True, True, 0.01)]
B, P, N = 2, 16, 8


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small eager ops: on one intra-op thread they do not stall when the
    other test workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, label=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = (want.detach().float().numpy() if torch.is_tensor(want)
            else np.asarray(want, np.float32))
    assert got.shape == want.shape, (label, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= TOL * scale, (label, err, TOL * scale)


def _numpy_case(G, H, S, with_h0, with_dh, decay, seed):
    """Reference-layout numpy inputs: x [B, S, G H, P], dA [B, S, G H],
    Bm, Cm [B, S, G, N], h0 and dh [B, G H, P, N] (or None), dy like x."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    x = f(B, S, G * H, P) * 0.5
    dA = (-rng.rand(B, S, G * H) * decay).astype(np.float32)
    Bm, Cm = f(B, S, G, N) * 0.3, f(B, S, G, N) * 0.3
    h0 = f(B, G * H, P, N) * 0.2 if with_h0 else None
    dh = f(B, G * H, P, N) * 0.2 if with_dh else None
    return x, dA, Bm, Cm, h0, dh, f(B, S, G * H, P)


def _port(G, H, model, x, dA, Bm, Cm, h0, dh, dy):
    """The numpy inputs in the port's layout: x, dy [B G H, S, P] (or, with
    ``model``, the [B G, H, S, P] views of [B G, S, H, P]), dA likewise,
    Bm, Cm [B G, S, N], h0 and dh [B G H, N, P]."""
    S = x.shape[1]
    t = lambda a: torch.tensor(a)

    def heads(a):                       # [B, S, G H, ...] -> the port's
        a = t(a).reshape(B, S, G, H, *a.shape[3:])
        if model:
            v = a.permute(0, 2, 1, 3, *range(4, a.dim())).reshape(
                B * G, S, H, *a.shape[4:])
            return v.transpose(1, 2)
        return a.permute(0, 2, 3, 1, *range(4, a.dim())).reshape(
            B * G * H, S, *a.shape[4:]).contiguous()

    state = lambda a: None if a is None else t(a).reshape(
        B * G * H, P, N).transpose(1, 2).contiguous()
    group = lambda a: t(a).permute(0, 2, 1, 3).reshape(B * G, S, N) \
        .contiguous()
    return (heads(x), heads(dA), group(Bm), group(Cm), state(h0),
            state(dh), heads(dy))


def _from_port(G, H, S, dx, ddA, dB, dC, dh0):
    """The port's gradients in the reference's layout (numpy)."""
    n = lambda a: a.detach().float().numpy()
    x = n(dx.reshape(B, G, H, S, P)).transpose(0, 3, 1, 2, 4).reshape(
        B, S, G * H, P)
    a = n(ddA.reshape(B, G, H, S)).transpose(0, 3, 1, 2).reshape(
        B, S, G * H)
    group = lambda t: n(t.reshape(B, G, S, N)).transpose(0, 2, 1, 3)
    h = n(dh0.reshape(B, G * H, N, P)).transpose(0, 1, 3, 2)
    return x, a, group(dB), group(dC), h


def _leaves(*ts):
    return [None if t is None else t.detach().clone().requires_grad_(True)
            for t in ts]


def _autograd(H, Q, x, dA, Bm, Cm, h0, dh, dy):
    """torch.autograd.grad of ssd_plain: (dx, ddA, dB, dC, dh0 or None)."""
    lx, la, lb, lc, lh = _leaves(x, dA, Bm, Cm, h0)
    y, h = ss.ssd_plain(lx, la, lb, lc, H, Q, lh)
    loss = (y * dy).sum() + (0 if dh is None else (h * dh).sum())
    want = [t for t in (lx, la, lb, lc, lh) if t is not None]
    got = torch.autograd.grad(loss, want)
    return (*got[:4], got[4] if lh is not None else None)


@pytest.mark.parametrize("case", CASES)
def test_bwd_plain_equals_autograd_of_ssd_plain(case):
    G, H, S, Q, with_h0, with_dh, model, decay = case
    x, dA, Bm, Cm, h0, dh, dy = _port(G, H, model, *_numpy_case(
        G, H, S, with_h0, with_dh, decay, S))
    want = _autograd(H, Q, x, dA, Bm, Cm, h0, dh, dy)
    got = ss.ssd_bwd_plain(x, dA, Bm, Cm, dy, H, Q, h0, dh)
    for name, a, w in zip(("dx", "dA", "dB", "dC", "dh0"), got, want):
        assert a.shape == (x.shape if name == "dx" else
                           dA.shape if name == "dA" else
                           Bm.shape if name in ("dB", "dC") else
                           (B * G * H, N, P)), name
        if w is not None:
            _close(a, w, name)


def _span(t, lo, hi, last=False):
    """Positions lo .. hi - 1 of x, dy, B or C (the positions the second
    last dimension) or, with ``last``, of dA and its gradient."""
    return t[..., lo:hi] if last else t[..., lo:hi, :]


def _inputs_span(ts, lo, hi):
    x, dA, Bm, Cm = ts
    return [_span(x, lo, hi), _span(dA, lo, hi, True), _span(Bm, lo, hi),
            _span(Cm, lo, hi)]


@pytest.mark.parametrize("case", CASES)
def test_each_plain_stage_equals_autograd_of_ssd_plain(case):
    """Each stage against autograd of ssd_plain on pieces of the
    sequence: the states kernel's st_c is the final state of chunk c alone
    and U_c the gradient of <dy_c, y_c> at a zero initial state; the scan
    kernel's h_{c-1} is the final state of the chunks before c, G_c the
    gradient of the loss of the chunks after c at their initial state,
    dh0 the whole loss's gradient at h0; the grads kernel's rows of chunk
    c are the gradient of <dy_c, y_c> + <G_c, h_c> at the initial state
    h_{c-1}."""
    G, H, S, Q, with_h0, with_dh, model, decay = case
    x, dA, Bm, Cm, h0, dh, dy = _port(G, H, model, *_numpy_case(
        G, H, S, with_h0, with_dh, decay, S + 1))
    Q = min(Q, S)
    nc = -(-S // Q)
    BH = B * G * H
    st, U, aL = ss.ssd_bwd_states_plain(x, dA, Bm, Cm, dy, H, Q)
    hprev, Gc, dh0, sc = ss.ssd_bwd_scan_plain(st, U, aL, h0, dh)
    dx, ddA, dB, dC = ss.ssd_bwd_grads_plain(x, dA, Bm, Cm, dy, hprev, Gc,
                                             sc, H, Q)
    zero = torch.zeros((BH, N, P))
    ins = (x, dA, Bm, Cm)
    for c in range(nc):
        lo, hi = c * Q, min((c + 1) * Q, S)
        args = _inputs_span(ins, lo, hi)
        _close(st[:, c], ss.ssd_plain(*args, H, Q)[1], f"st {c}")
        (lz,) = _leaves(zero)
        y, _ = ss.ssd_plain(*args, H, Q, lz)
        _close(U[:, c], torch.autograd.grad((y * _span(dy, lo, hi)).sum(),
                                            lz)[0], f"U {c}")
        _close(aL[:, c], args[1].reshape(BH, -1).sum(-1), f"aL {c}")
        # the state entering chunk c, and the gradient leaving it
        h_in = (ss.ssd_plain(*_inputs_span(ins, 0, lo), H, Q, h0)[1] if c
                else (zero if h0 is None else h0))
        _close(hprev[:, c], h_in, f"hprev {c}")
        if c + 1 < nc:
            (lz,) = _leaves(zero)
            y, h = ss.ssd_plain(*_inputs_span(ins, hi, S), H, Q, lz)
            loss = (y * _span(dy, hi, S)).sum()
            if dh is not None:
                loss = loss + (h * dh).sum()
            g_out = torch.autograd.grad(loss, lz)[0]
        else:
            g_out = zero if dh is None else dh
        _close(Gc[:, c], g_out, f"G {c}")
        _close(sc[:, c], torch.exp(aL[:, c]) * (h_in * g_out).sum((-1, -2)),
               f"sc {c}")
        # chunk c's rows of dx, dA, dB, dC
        leaves = _leaves(*args)
        y, h = ss.ssd_plain(*leaves, H, Q, h_in)
        want = torch.autograd.grad((y * _span(dy, lo, hi)).sum()
                                   + (h * g_out).sum(), leaves)
        for name, a, w in zip(("dx", "dA", "dB", "dC"),
                              (dx, ddA, dB, dC), want):
            _close(_span(a, lo, hi, name == "dA"), w, f"{name} {c}")
    if h0 is not None:
        (lh,) = _leaves(h0)
        y, h = ss.ssd_plain(x, dA, Bm, Cm, H, Q, lh)
        loss = (y * dy).sum() + (0 if dh is None else (h * dh).sum())
        _close(dh0, torch.autograd.grad(loss, lh)[0], "dh0")


@pytest.mark.parametrize("case", CASES)
def test_bwd_plain_equals_jax_vjp_of_ssd_chunked(case):
    """ssd_bwd_plain in the port's layout against jax.vjp of the
    reference's ssd_chunked in its own ([B, S, G H, P], G groups)."""
    G, H, S, Q, with_h0, with_dh, model, decay = case
    x, dA, Bm, Cm, h0, dh, dy = _numpy_case(G, H, S, with_h0, with_dh,
                                            decay, 2 * S)
    args = [jnp.asarray(a) for a in (x, dA, Bm, Cm)] + (
        [] if h0 is None else [jnp.asarray(h0)])
    fwd = lambda *a: j_ssd_chunked(*a[:4], chunk=Q,
                                   init_state=a[4] if len(a) > 4 else None)

    @jax.jit
    def grads(args, dy, dh):
        out, vjp = jax.vjp(fwd, *args)
        return vjp((dy, jnp.zeros_like(out[1]) if dh is None else dh))
    want = grads(args, jnp.asarray(dy), None if dh is None else
                 jnp.asarray(dh))
    px, pa, pb, pc, ph0, pdh, pdy = _port(G, H, model, x, dA, Bm, Cm, h0,
                                          dh, dy)
    got = _from_port(G, H, S, *ss.ssd_bwd_plain(px, pa, pb, pc, pdy, H, Q,
                                                ph0, pdh))
    for name, a, w in zip(("dx", "dA", "dB", "dC", "dh0"), got, want):
        if name == "dh0" and h0 is None:
            continue
        _close(a, np.asarray(w), name)


@pytest.mark.parametrize("case", CASES[1:6])
def test_ssd_scan_fn_on_cpu_equals_autograd(case):
    """``ops.ssd`` on the kernel route under a gradient runs
    ``SsdScanFn`` (on CPU tensors its wrappers take the plain versions):
    the same y and final state as the plain route, gradients within 1e-4
    of autograd's through ``ssd_plain``, no kernel launched."""
    G, H, S, Q, with_h0, with_dh, model, decay = case
    x, dA, Bm, Cm, h0, dh, dy = _port(G, H, model, *_numpy_case(
        G, H, S, with_h0, with_dh, decay, 3 * S))
    before = dict(LAUNCHES)
    leaves = _leaves(x, dA, Bm, Cm, h0)
    y, h = ops.ssd(*leaves[:4], n_heads_per_group=H, chunk=Q, h0=leaves[4],
                   use_kernel=True)
    assert type(y.grad_fn).__name__ == "SsdScanFnBackward"
    yp, hp = ss.ssd_plain(x, dA, Bm, Cm, H, Q, h0)
    assert torch.equal(y.detach(), yp) and torch.equal(h.detach(), hp)
    loss = (y * dy).sum() + (0 if dh is None else (h * dh).sum())
    live = [t for t in leaves if t is not None]
    got = torch.autograd.grad(loss, live)
    want = [w for w in _autograd(H, Q, x, dA, Bm, Cm, h0, dh, dy)
            if w is not None]
    for a, w in zip(got, want):
        _close(a, w)
    assert LAUNCHES == before
    # a gradient of y alone (the final state unused: dh is None) and of a
    # subset of the inputs
    lx, = _leaves(x)
    y, _ = ss.SsdScanFn.apply(lx, dA, Bm, Cm, H, Q, h0)
    _close(torch.autograd.grad((y * dy).sum(), lx)[0],
           _autograd(H, Q, x, dA, Bm, Cm, h0, None, dy)[0])


def test_ssd_scan_fn_saves_only_its_inputs():
    """SsdScanFn keeps x, dA, B, C and h0 as given, the model layout's
    strided views included (no copies): nothing of size Q x Q and no
    per-chunk state."""
    G, H, S, Q = 2, 3, 100, 32
    x, dA, Bm, Cm, h0, _, _ = _port(G, H, True, *_numpy_case(
        G, H, S, True, False, 0.3, 0))
    bc = torch.randn(B * G, S, 3 * N)          # B and C: row-strided slices
    Bm, Cm = bc[..., N:2 * N], bc[..., 2 * N:]
    leaves = [t.requires_grad_(True) for t in (x, dA, Bm, Cm)]
    y, _ = ss.SsdScanFn.apply(*leaves, H, Q, h0)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 5
    for s, t in zip(saved, (x, dA, Bm, Cm, h0)):
        assert s.data_ptr() == t.data_ptr() and s.shape == t.shape
        assert s.stride() == t.stride()


def test_ssd_scan_fn_layouts_and_dtype():
    """The gradients come back in their inputs' shapes; in bf16, x's, B's
    and C's in bf16, dA's and h0's in float32, each within one bf16
    rounding of the float32 gradient on the same bf16 inputs."""
    G, H, S, Q = 1, 3, 50, 16
    x, dA, Bm, Cm, h0, dh, dy = _port(G, H, True, *_numpy_case(
        G, H, S, True, True, 0.3, 5))
    bf = [t.to(torch.bfloat16) for t in (x, Bm, Cm, dy)]
    got = ss.ssd_bwd_plain(bf[0], dA, bf[1], bf[2], bf[3], H, Q, h0, dh)
    want = ss.ssd_bwd_plain(bf[0].float(), dA, bf[1].float(), bf[2].float(),
                            bf[3].float(), H, Q, h0, dh)
    for a, w, like in zip(got, want, (bf[0], dA, bf[1], bf[2], h0)):
        assert a.shape == like.shape and a.dtype == like.dtype
        scale = float(w.abs().max())
        assert float((a.float() - w).abs().max()) <= 2 ** -8 * scale + 1e-6


def test_ssd_bwd_wrappers_take_cpu_tensors_by_the_plain_version():
    x, dA, Bm, Cm, h0, dh, dy = _port(1, 2, False, *_numpy_case(
        1, 2, 20, True, True, 0.3, 1))
    before = dict(LAUNCHES)
    got = ss.ssd_bwd(x, dA, Bm, Cm, dy, 2, 16, h0, dh)
    want = ss.ssd_bwd_plain(x, dA, Bm, Cm, dy, 2, 16, h0, dh)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert LAUNCHES == before
    for fn, args in ((ss.ssd_bwd_states_cuda, (x, dA, Bm, Cm, dy, 2)),
                     (ss.ssd_bwd_grads_cuda,
                      (x, dA, Bm, Cm, dy, x, x, dA, 2))):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(*args)
    st = torch.zeros((4, 2, N, P))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ss.ssd_bwd_scan_cuda(st, st, torch.zeros((4, 2)))
    assert LAUNCHES == before


# ------------------------------------------- the models on the cuda route
@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_model_gradient_on_the_cuda_route(arch, monkeypatch, chip_smoke):
    """The reduced model's float32 loss and gradient on the ``cuda``
    route, with the device check lifted so that every kernel op takes its
    plain version on these CPU tensors (the SSD scan through
    ``SsdScanFn``, attention through ``FlashAttentionFn``), against the
    ``torch`` route (autograd of the plain scan) and the JAX model's
    ``jax.value_and_grad``, each within 1e-4 of scale; ``SsdScanFn`` runs
    twice a layer (the forward, then its recomputation under remat) and
    its backward once, as ``chip_smoke.train_launches`` counts the
    launches on the card."""
    monkeypatch.setattr(KernelConfig, "check_device", lambda *a: None)
    calls = {"fwd": 0, "bwd": 0}
    orig_fwd, orig_bwd = ss.ssd_scan, ss.ssd_bwd

    def fwd(*a, **k):
        calls["fwd"] += 1
        return orig_fwd(*a, **k)

    def bwd(*a, **k):
        calls["bwd"] += 1
        return orig_bwd(*a, **k)
    monkeypatch.setattr(ss, "ssd_scan", fwd)
    monkeypatch.setattr(ss, "ssd_bwd", bwd)
    jc, tc, jp, tp, npar = both(arch)
    batch = train_batch(tc)
    ref, torch_route = j_loss_and_grads(jc, tc, jp, tp, batch)
    assert calls == {"fwd": 0, "bwd": 0}       # the torch route runs none
    leaves = jax.tree_util.tree_map(
        lambda t: t.detach().requires_grad_(True), tp)
    loss, metrics = build(tc, "cuda").loss(
        leaves, {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    got = (float(loss.detach()),
           {k: float(v.detach()) for k, v in metrics.items()},
           [g.float().numpy() for g in grads])
    want = chip_smoke.train_launches(tc)
    assert calls == {"fwd": want["ssd_scan"],
                     "bwd": want["ssd_scan_bwd_grads"]}
    assert want["ssd_scan"] == 2 * tc.n_layers
    check(ref, got, _paths(npar), TOL)
    check(torch_route, got, _paths(npar), TOL)


def test_chip_smoke_ssd_bwd_cases_reach_the_edges(chip_smoke):
    """Phase 3 holds the SSD backward's kernels to their plain versions at
    zamba2-2.7b's and mamba2-130m's training shapes in bf16 and float32
    and at the edges: a ragged tail (S = 1,000), S = 1, one chunk of
    S < 128, 16 chunks, h0 and dh_final given, the model's layout and the
    folded one, decays of 0.01 and 1.4; every case a shape the kernels
    take."""
    cases = chip_smoke.SSD_BWD_CASES
    for dt in ("bf16", "f32"):
        assert (4, 80, 1024, 64, 64, 128, dt) in [c[:7] for c in cases]
        assert (4, 24, 1024, 64, 128, 128, dt) in [c[:7] for c in cases]
    assert any(c[2] == 1000 for c in cases)
    assert any(c[2] == 1 for c in cases)
    assert any(1 < c[2] < 128 and c[5] >= c[2] for c in cases)
    assert any(-(-c[2] // c[5]) == 16 for c in cases)
    assert any(c[7] and c[8] for c in cases)
    assert any(c[10] for c in cases) and any(not c[10] for c in cases)
    assert any(c[9] <= 0.01 for c in cases) and any(c[9] >= 1.4
                                                   for c in cases)
    for c in cases:
        assert c[3] in ss.SSD_BWD_P and c[4] in ss.SSD_BWD_N
        assert min(c[5], c[2]) <= ss.SSD_BWD_MAX_CHUNK
    assert chip_smoke.SSD_BWD_KERNELS == tuple(
        n for n in chip_smoke.KERNELS if n.startswith("ssd_scan_bwd"))
    for name in chip_smoke.SSD_BWD_KERNELS:
        assert chip_smoke.KERNELS[name] == (
            "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
            "src/repro/models/ssm.py:70")


def test_train_launches_count_the_ssd_backward(chip_smoke):
    from repro_torch.configs import get_config
    m = chip_smoke.train_launches(get_config("mamba2-130m"))
    assert m == {"flash_attention": 0, "flash_attention_bwd_dq": 0,
                 "flash_attention_bwd_dkdv": 0, "ssd_scan": 48,
                 "ssd_scan_bwd_states": 0, "ssd_scan_bwd_scan": 0,
                 "ssd_scan_bwd_states_scan": 24, "ssd_scan_bwd_grads": 24}
    f = chip_smoke.train_launches(get_config("mamba2-130m").replace(
        compute_dtype=torch.float32))
    assert (f["ssd_scan_bwd_states"], f["ssd_scan_bwd_scan"],
            f["ssd_scan_bwd_states_scan"]) == (24, 24, 0)
    z = chip_smoke.train_launches(get_config("zamba2-2.7b").replace(
        n_layers=6))
    assert z["flash_attention"] == 2 and z["flash_attention_bwd_dq"] == 1
    assert z["ssd_scan"] == 12 and z["ssd_scan_bwd_grads"] == 6
    q = chip_smoke.train_launches(get_config("qwen2-0.5b"))
    assert q["ssd_scan"] == q["ssd_scan_bwd_states"] == 0
    step, arch, layers, b, s = chip_smoke.HYBRID_TRAIN_RUNS[0]
    assert layers % get_config(arch).attn_every == 0 and layers < 54


def _sass(drop=None):
    """A disassembly as ``cuobjdump -sass`` prints it: the SSD backward's
    states and grads kernels at every (P, N) in both forms, the bf16 ones
    with an HMMA instruction (but ``drop``), and its scan kernel."""
    lines = []
    for name, n in (("ssd_scan_bwd_states_kernel", 26),
                    ("ssd_scan_bwd_grads_kernel", 25)):
        for bf in (1, 0):
            for pt in (1, 2, 4):
                for nt in (1, 2, 4, 8):
                    fn = f"_Z{n}{name}ILb{bf}ELi{pt}ELi{nt}EEvPKN"
                    lines.append(f"Function : {fn}")
                    if bf and (name, pt, nt) != drop:
                        lines.append("  /*0a10*/  HMMA.16816.F32.BF16 R4, "
                                     "R8, R12, R4 ;")
                    lines.append("  /*0b00*/  FFMA R1, R2, R3, R1 ;")
    lines += ["Function : _Z24ssd_scan_bwd_scan_kernelILi16EEvPfS0_PKfS2_",
              "  /*0100*/  FFMA R1, R2, R3, R1 ;"]
    return "\n".join(lines)


@pytest.mark.parametrize("drop", [None, ("ssd_scan_bwd_grads_kernel", 4, 8),
                                  ("ssd_scan_bwd_states_kernel", 1, 1)])
def test_ssd_bwd_tensor_core_check(chip_smoke, monkeypatch, capsys, drop):
    """Phase 2 fails unless each of the 12 bf16 instantiations of the
    states and grads kernels runs tensor-core products."""
    class Done:
        stdout = _sass(drop)
    monkeypatch.setattr(chip_smoke.subprocess, "run", lambda *a, **k: Done)
    if drop is None:
        chip_smoke.ssd_bwd_tensor_core_check("lib.so", "/cuda/bin/nvcc")
        out = capsys.readouterr().out
        assert "ssd_scan_bwd_grads: bf16 12 instantiations, HMMA " \
            f"{[1] * 12}; float32 12, HMMA {[0] * 12}" in out
    else:
        with pytest.raises(AssertionError, match=f"{drop[0][:-7]}: expected "
                                                 f"12 bf16"):
            chip_smoke.ssd_bwd_tensor_core_check("lib.so", "/cuda/bin/nvcc")
