"""The port's training runtime held against the JAX package on the CPU:
``TokenStream`` batches bit-equal to the reference's (every family's
extras, several hosts, a restored cursor); ``StragglerPolicy`` on the
cases of ``tests/test_runtime.py``; ``TrainRunner`` through an injected
failure, the restart of ``tests/test_substrate.py``
(``test_runner_restart_after_failure``), its losses within 1e-4 (relative)
of the JAX runner's in float32 on the same weights and data; and training
checkpoints ``{"params", "opt": AdamWState, "data"}`` written by either
package's runner restored by the other, leaf for leaf.
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import PostSICheckpointer as JCheckpointer
from repro.configs import get_reduced as j_get_reduced
from repro.data import TokenStream as JTokenStream
from repro.launch.train import make_train_step as j_make_train_step
from repro.optim import adamw_init as j_adamw_init
from repro.runtime import FailureInjector as JFailureInjector
from repro.runtime import TrainRunner as JTrainRunner
from repro_torch.checkpoint import PostSICheckpointer
from repro_torch.configs import get_reduced
from repro_torch.data import TokenStream
from repro_torch.launch.train import make_train_step
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.models.module import tree_leaves
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.runtime import FailureInjector, StragglerPolicy, TrainRunner


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small eager ops: on one intra-op thread they do not stall when the
    other test workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ token stream
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-vl-2b",
                                  "seamless-m4t-large-v2"])
@pytest.mark.parametrize("hosts", [(1, 0), (4, 3)])
def test_token_stream_bit_equal(arch, hosts):
    n_hosts, host = hosts
    kw = dict(seed=7, host_count=n_hosts, host_id=host)
    js = JTokenStream(j_get_reduced(arch), 8, 24, **kw)
    ts = TokenStream(get_reduced(arch), 8, 24, device="cpu", **kw)
    for _ in range(3):
        want, got = js.next(), ts.next()
        assert set(got) == set(want)
        for k in want:
            w = np.asarray(want[k])
            assert got[k].device.type == "cpu"
            assert str(got[k].dtype).split(".")[-1] == w.dtype.name, k
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    assert ts.state() == js.state()
    # a restored cursor replays: batch 1 again
    ts.restore({**ts.state(), "step": 1})
    js.restore({**js.state(), "step": 1})
    np.testing.assert_array_equal(ts.next()["tokens"].numpy(),
                                  np.asarray(js.next()["tokens"]))


# -------------------------------------------------------------- straggler
class TestStragglerPolicy:
    """The cases of ``tests/test_runtime.py`` on the port's copy."""

    def test_no_flag_before_window_warms_up(self):
        p = StragglerPolicy()
        for step in range(7):
            assert not p.record(step, 1.0)
        assert not p.record(7, 100.0)

    def test_flags_outlier_after_warmup(self):
        p = StragglerPolicy(threshold=4.0)
        for step in range(8):
            p.record(step, 1.0 + 0.01 * (step % 3))
        assert p.record(8, 50.0, worker=0)
        assert p.flags and p.flags[-1][0] == 8 and p.flags[-1][1] == 0

    def test_threshold_scales_sensitivity(self):
        def flagged_at(threshold, dt):
            p = StragglerPolicy(threshold=threshold)
            for step in range(8):
                p.record(step, 1.0 + 0.05 * (step % 4))
            return p.record(8, dt)
        assert flagged_at(2.0, 1.6)
        assert not flagged_at(20.0, 1.6)

    def test_per_worker_isolation(self):
        p = StragglerPolicy()
        for step in range(10):
            p.record(step, 1.0, worker=0)
            p.record(step, 10.0, worker=1)
        assert not p.record(10, 10.0, worker=1)
        assert p.record(10, 3.0, worker=0)

    def test_window_forgets_old_regime(self):
        p = StragglerPolicy(window=8)
        for step in range(8):
            p.record(step, 1.0)
        for step in range(8, 24):
            p.record(step, 5.0 + 0.1 * (step % 4))
        assert not p.record(24, 5.2)

    def test_grad_scale_unbiased(self):
        p = StragglerPolicy(action="skip")
        assert p.grad_scale(8, 0) == 1.0
        assert p.grad_scale(8, 2) == pytest.approx(8 / 6)
        assert p.grad_scale(1, 1) == 1.0

    def test_rebalance_share_inverse_mean(self):
        p = StragglerPolicy(action="rebalance")
        for step in range(4):
            p.record(step, 1.0, worker=0)
            p.record(step, 3.0, worker=1)
        s0, s1 = p.share(0, 2), p.share(1, 2)
        assert s0 == pytest.approx(0.75) and s1 == pytest.approx(0.25)
        assert p.share(7, 2) == 0.5


# ----------------------------------------------------------------- runner
def _states(tmp_path):
    """Both packages' runs of ``test_runner_restart_after_failure`` (reduced
    qwen2-0.5b in float32, batch 2 x 16, lr 1e-3, a checkpoint every 4
    steps, a failure injected at step 6, 10 steps) on the same initial
    weights: (JAX result, port result, their checkpoint directories)."""
    jc = j_get_reduced("qwen2-0.5b").replace(compute_dtype=jnp.float32)
    tc = get_reduced("qwen2-0.5b").replace(compute_dtype=torch.float32)
    jmodel, jstep = j_make_train_step(jc, lr=1e-3)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jopt = j_adamw_init(jparams)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jck = JCheckpointer(str(jdir), {"params": jparams, "opt": jopt,
                                    "data": {"step": jnp.asarray(0)}})
    jout = JTrainRunner(jax.jit(jstep), JTokenStream(jc, 2, 16, seed=1),
                        jck, ckpt_every=4).run(
        jparams, jopt, 10, injector=JFailureInjector(fail_at=(6,)))

    npar = jax.tree_util.tree_map(np.asarray, jparams)
    params = params_from_jax(tc, npar, device="cpu")
    opt = opt_state_from_jax(tc, jax.tree_util.tree_map(np.asarray, jopt),
                             device="cpu")
    _, step = make_train_step(tc, lr=1e-3, kernels="torch")
    tck = PostSICheckpointer(str(tdir), _tree_ex(params, opt))
    tout = TrainRunner(step, TokenStream(tc, 2, 16, seed=1, device="cpu"),
                       tck, ckpt_every=4).run(
        params, opt, 10, injector=FailureInjector(fail_at=(6,)))
    return jout, tout, jdir, tdir


def _tree_ex(params, opt):
    return {"params": params, "opt": opt,
            "data": {"step": torch.tensor(0, dtype=torch.int32)}}


def test_runner_restart_matches_reference(tmp_path):
    jout, tout, _, _ = _states(tmp_path)
    assert tout["restarts"] == jout["restarts"] == 1
    assert tout["final_step"] == jout["final_step"] == 10
    # after the restore at step 4, steps 4..10 were run again: 10 + (6 - 4)
    assert len(tout["losses"]) == len(jout["losses"]) == 12
    assert all(np.isfinite(tout["losses"]))
    np.testing.assert_allclose(tout["losses"], jout["losses"], rtol=1e-4)
    # the replayed steps after the restore see the same batches: the loss
    # of step 4 (run once before the failure, once after) is the same
    assert tout["losses"][4] == pytest.approx(tout["losses"][6], abs=1e-6)
    assert isinstance(tout["state"]["opt"], AdamWState)
    assert int(tout["state"]["opt"].step) == 10


def test_training_checkpoints_restore_across_packages(tmp_path):
    """The JAX runner's directory restores in the port and the port's in
    the JAX package: the same step (8) and every leaf equal to the writing
    package's own restore, ``['opt'].step`` / ``['opt'].m[...]`` paths
    and the data cursor included."""
    jout, tout, jdir, tdir = _states(tmp_path)
    ex_t = _tree_ex(tout["state"]["params"], tout["state"]["opt"])
    ex_j = {"params": jout["state"]["params"], "opt": jout["state"]["opt"],
            "data": {"step": jnp.asarray(0)}}
    for d in (jdir, tdir):
        js, jtree = JCheckpointer(str(d), ex_j).restore(ex_j)
        ts, ttree = PostSICheckpointer(str(d), ex_t).restore(ex_t, "cpu")
        assert js == ts == 8
        assert isinstance(ttree["opt"], AdamWState)
        assert int(ttree["data"]["step"]) == 8 == int(ttree["opt"].step)
        jl = jax.tree_util.tree_leaves(jtree)
        tl = tree_leaves({k: ttree[k] for k in ("data", "params")})
        tl = (tl[:1] + [ttree["opt"].step] + tree_leaves(ttree["opt"].m)
              + tree_leaves(ttree["opt"].v) + tl[1:])
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            assert str(a.dtype).split(".")[-1] == np.dtype(b.dtype).name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------- chip_smoke phase 9
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "TRAIN_BATCH", 2)
    monkeypatch.setattr(chip_smoke, "TRAIN_SEQ", 32)
    monkeypatch.setattr(chip_smoke, "TRAIN_ENC_FRAMES", 20)
    monkeypatch.setattr(chip_smoke, "TRAIN_LR", 3e-3)
    return chip_smoke


def test_chip_smoke_train_phase_rehearses_on_cpu(chip_smoke, capsys):
    """Phase 9 at reduced size on the torch route: the runner through its
    injected failure with every gate (9a and, for the SSM family, 9d), the
    float32 gates, the two more families and the hybrid family's cut step
    (9e) and its step in the compute dtype (9f); no kernel launches off
    the card."""
    cfg = chip_smoke.parse_config([])
    moe = get_reduced("deepseek-moe-16b")
    enc = get_reduced("seamless-m4t-large-v2")
    hyb = get_reduced("zamba2-2.7b")
    runs = [("9b", moe.replace(n_layers=1), moe, 2, 24),
            ("9c", enc.replace(n_layers=1, n_enc_layers=1), enc, 2, 24)]
    counts = chip_smoke.train_phase(
        torch, torch.device("cpu"), cfg, "cpu",
        mcfg=get_reduced("qwen2-0.5b"), family_runs=runs, route="torch",
        ssm_mcfg=get_reduced("mamba2-130m"),
        hybrid_runs=[("9e", hyb.replace(n_layers=hyb.attn_every), hyb, 2,
                      24)])
    out = capsys.readouterr().out
    assert "9a qwen2-0.5b-reduced: restarts 1, final step 8, 10 losses" in out
    assert "9d mamba2-130m-reduced: restarts 1, final step 8, 10 losses" \
        in out
    assert out.count("float32 torch vs torch") == 5
    assert "9e mamba2-130m-reduced: float32 torch vs torch" in out
    assert "9e zamba2-2.7b-reduced: hybrid at full width, depth cut to 2 of " \
        "4 layers" in out
    assert "9f zamba2-2.7b-reduced: bfloat16 torch vs torch: loss" in out
    assert "depth cut to 1 + 1 of 2 + 2 layers" in out
    assert set(counts.values()) == {0}


def test_train_launches_count_the_remat_recompute(chip_smoke, monkeypatch):
    """``chip_smoke.train_launches``: under remat each layer's attention
    runs twice a loss and gradient (the forward, then the recomputation),
    its backward once; counted here on the CPU by the calls of the model's
    attention."""
    from repro_torch.models import model as tm
    calls = [0]
    orig = tm.attention

    def counted(*a, **k):
        calls[0] += 1
        return orig(*a, **k)
    monkeypatch.setattr(tm, "attention", counted)
    for arch in ("qwen2-0.5b", "deepseek-moe-16b",
                 "seamless-m4t-large-v2"):
        cfg = get_reduced(arch)
        model, step = make_train_step(cfg, kernels="torch")
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        calls[0] = 0
        step(params, adamw_init(params),
             TokenStream(cfg, 2, 16, device="cpu").next())
        want = chip_smoke.train_launches(cfg)
        assert calls[0] == want["flash_attention"], arch
        assert want["flash_attention_bwd_dq"] * 2 == calls[0]


def test_train_family_runs_resolve_at_full_width(chip_smoke):
    from repro_torch.configs import get_config
    assert get_config(chip_smoke.TRAIN_ARCH).n_layers == 24
    for step, arch, layers, enc_layers, b, s in chip_smoke.TRAIN_FAMILY_RUNS:
        full = get_config(arch)
        assert full.head_dim % 16 == 0 and full.head_dim <= 128
        assert layers < full.n_layers
        assert (enc_layers is None) == (full.family != "encdec")
    assert chip_smoke.KERNELS["flash_attention_bwd_dq"][1] == \
        "src/repro/models/layers.py:123"


def test_train_example_runs_on_cpu():
    """``examples/train_lm_torch.py`` on the CPU, cut to 30 steps with the
    failure at step 12: it trains through the restart."""
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_lm_torch.py"),
         "--device", "cpu", "--steps", "30", "--fail-at", "12",
         "--batch", "4", "--seq", "32"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr[-2000:]
    assert "steps=30 restarts=1" in res.stdout
    assert "OK: trained through an injected failure" in res.stdout


def test_tensor_core_counts_name_the_backward_kernels(chip_smoke):
    """``chip_smoke.tensor_core_counts`` counts the backward kernels'
    HMMA instructions under their own names, bf16 and float32 forms."""
    sass = "\n".join([
        "Function : _Z33flash_attention_bwd_dq_mma_kernelILi4EEvPK13__nv_b",
        "  /*0a10*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;",
        "Function : _Z35flash_attention_bwd_dkdv_mma_kernelILi4EEvPK13__nv",
        "  /*0a10*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;",
        "  /*0a20*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;",
        "Function : _Z33flash_attention_bwd_dq_fma_kernelILi4EEvPKfS1_S1_",
        "  /*0100*/  FFMA R1, R2, R3, R1 ;"])
    counts = chip_smoke.tensor_core_counts(sass)
    names = {f: chip_smoke.kernel_of(f) for f in counts}
    assert sorted(names.values()) == ["flash_attention_bwd_dkdv",
                                      "flash_attention_bwd_dq",
                                      "flash_attention_bwd_dq"]
    assert sorted(counts.values()) == [0, 1, 2]
