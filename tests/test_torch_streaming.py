"""The port's pipelined streaming plane held against its own step loop and
against the JAX package's streaming driver.

* ``run_streaming(B=1, K=1)`` is the step loop: for the six schedulers the
  port's streamed session equals its own ``run_stream`` in every request's
  fate, every history row and the report (but for the wall clock and the
  block count).
* At every (B, K) and sizer tested, the port's ``run_streaming`` equals
  the JAX ``run_streaming`` on the same seeds (``kernels="jnp"`` there,
  ``device="cpu"`` here) in every request's fate, every history row and
  the ``ServiceReport`` except its wall-clock fields: the driver's choices
  depend only on host state, so "commit-set-equal" would be too weak.
* ``AdaptiveWaveSizer`` takes the same decisions as the reference's on the
  same observations, alone and inside a session (``"auto"`` and an
  explicit ``adapt_B=True`` sizer).
* ``engine.stage_block`` stacks host waves into one buffer without
  changing a bit, and ``run_block`` on a staged block equals ``run_block``
  on the host arrays.
* ``examples/serve_txn_service_torch.py`` runs on the CPU.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.workloads import bursty_arrivals, poisson_arrivals
import repro.service as js
import repro_torch.core as tc
from repro_torch.core import workloads as tw
import repro_torch.service as ts

from test_torch_engine import assert_same_history
from test_torch_service import _fates

N_NODES, KPN, T = 4, 40, 16
WALL = ("wall_s", "txns_per_sec", "goodput_tps")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The plain commit loop runs ~170 small tensor ops a step; on one
    intra-op thread they do not stall when the other test workers load
    every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _session(pkg, mode, sched="postsi", B=1, K=1, sizer=None, theta=0.9,
             read_frac=0.5, max_attempts=6, n_ticks=10, rate=12.0, seed=3,
             skew=True, bursty=False, max_queue=None):
    """One served session of ``pkg`` (the JAX or the port's service) on the
    stream of ``tests/test_streaming.py``; ``mode`` picks the step loop or
    the streaming plane."""
    hs = (np.round(np.linspace(0, 2, N_NODES)).astype(np.int32)
          if sched == "clocksi" and skew else None)
    extra = (dict(kernels="jnp") if pkg is js
             else dict(kernels="torch", device="cpu"))
    svc = pkg.TxnService(n_keys=N_NODES * KPN, T=T, sched=sched,
                         n_nodes=N_NODES, max_queue=max_queue,
                         retry=pkg.RetryPolicy(max_attempts=max_attempts),
                         host_skew=hs, seed=seed, **extra)
    gen = pkg.ycsb_txn_gen(np.random.RandomState(seed + 100), N_NODES, KPN,
                           theta=theta, read_frac=read_frac, dist_frac=0.3)
    arr_rng = np.random.RandomState(seed + 200)
    arr = (bursty_arrivals(arr_rng, rate, n_ticks) if bursty
           else poisson_arrivals(arr_rng, rate, n_ticks))
    if mode == "step":
        return svc, svc.run_stream(arr, gen)
    if callable(sizer):
        sizer = sizer(pkg)
    return svc, svc.run_streaming(arr, gen, B=B, K=K, sizer=sizer)


def _assert_same_session(t, j, skip=WALL):
    (t_svc, t_rep), (j_svc, j_rep) = t, j
    assert _fates(t_svc) == _fates(j_svc)
    assert_same_history(t_svc.history, j_svc.history)
    td, jd = t_rep.as_dict(), j_rep.as_dict()
    for k in skip:
        td.pop(k), jd.pop(k)
    assert td == jd
    assert t_rep.committed > 0


# ---------------------------------------------- B=1 K=1 is the step loop
@pytest.mark.parametrize("sched", tc.SCHEDULERS)
def test_streaming_b1k1_equals_step_loop(sched):
    step = _session(ts, "step", sched)
    streamed = _session(ts, "stream", sched, B=1, K=1)
    _assert_same_session(streamed, step, skip=WALL + ("blocks",))
    assert streamed[1].blocks == streamed[1].waves
    assert step[0].verify() == streamed[0].verify()


# ------------------------------------------------ against the JAX driver
STREAM_CASES = {
    "postsi-b1k1": ("postsi", 1, 1), "postsi-b2k2": ("postsi", 2, 2),
    "postsi-b4k2": ("postsi", 4, 2), "postsi-b4k3": ("postsi", 4, 3),
    "si-b4k2": ("si", 4, 2), "cv-b4k2": ("cv", 4, 2),
    "clocksi-skew-b4k2": ("clocksi", 4, 2),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_streaming_matches_jax(case):
    sched, B, K = STREAM_CASES[case]
    t = _session(ts, "stream", sched, B=B, K=K)
    j = _session(js, "stream", sched, B=B, K=K)
    _assert_same_session(t, j)
    if B > 1:
        assert t[1].blocks < t[1].waves
    # host skew gives clocksi stale snapshots that verify_si rejects in the
    # reference too; the verdicts must still agree
    assert t[0].verify() == j[0].verify()
    if sched != "clocksi":
        assert t[0].verify() == []


def _traced(pkg, monkeypatch):
    """Record (T, B, increases, decreases) after every sizer observation
    of ``pkg``'s ``AdaptiveWaveSizer``."""
    trace = []
    cls = pkg.AdaptiveWaveSizer
    orig = cls.observe

    def observe(self, executed, aborted):
        orig(self, executed, aborted)
        trace.append((self.T, self.B, self.increases, self.decreases))
    monkeypatch.setattr(cls, "observe", observe)
    return trace


@pytest.mark.parametrize("sizer", ["auto", "explicit"])
def test_streaming_sizer_matches_jax(sizer, monkeypatch):
    """The contention-adaptive sizer on a write-heavy, skewed stream: the
    same T/B trace as the reference, and the same session."""
    make = ("auto" if sizer == "auto" else
            lambda pkg: pkg.AdaptiveWaveSizer(T0=T, B0=2, t_min=4,
                                              window=24, adapt_B=True))
    kw = dict(B=2, K=2, sizer=make, theta=1.2, read_frac=0.1,
              max_attempts=8, n_ticks=12, rate=14.0)
    t_trace, j_trace = _traced(ts, monkeypatch), _traced(js, monkeypatch)
    t = _session(ts, "stream", **kw)
    j = _session(js, "stream", **kw)
    assert t_trace == j_trace and t_trace
    if sizer == "explicit":
        assert t_trace[-1][3] >= 1           # contention was regulated
    _assert_same_session(t, j)
    assert t[0].verify() == []


def test_streaming_bursty_zipf_sheds_and_matches_jax():
    """Bursty arrivals x heavy zipf skew with a bounded admission queue:
    load is shed, retries happen, every admitted request commits or drops,
    and the session equals the reference's."""
    kw = dict(B=4, K=2, theta=1.2, read_frac=0.2, bursty=True, n_ticks=12,
              max_queue=24)
    t = _session(ts, "stream", **kw)
    j = _session(js, "stream", **kw)
    _assert_same_session(t, j)
    rep = t[1]
    assert rep.rejected > 0 and rep.retries > 0
    assert rep.offered == rep.admitted + rep.rejected
    assert rep.committed + rep.dropped == rep.admitted
    assert t[0].verify() == []


# ------------------------------------------------------------ sizer units
def _sizer_trace(pkg, kw, observations):
    s = pkg.AdaptiveWaveSizer(**kw)
    trace = [(s.T, s.B, s.increases, s.decreases)]
    for executed, aborted in observations:
        s.observe(executed, aborted)
        trace.append((s.T, s.B, s.increases, s.decreases,
                      round(s.abort_rate(), 12)))
    return trace


@pytest.mark.parametrize("kw", [
    dict(T0=64, t_min=8, window=10),
    dict(T0=32, B0=4, t_min=8, window=4, adapt_B=True),
    dict(T0=12, t_min=8, window=10),                  # off-quantum ceiling
    dict(T0=48, B0=8, t_min=4, quantum=8, window=16, adapt_B=True,
         b_min=2, high=0.5, low=0.2)],
    ids=["aimd", "adapt-B", "off-quantum", "quantum-b_min"])
def test_sizer_decisions_match_jax(kw):
    rng = np.random.RandomState(11)
    obs = [(int(n), int(rng.randint(0, n + 1)))
           for n in rng.randint(1, 20, 300)]
    obs += [(10, 10)] * 8 + [(10, 0)] * 40 + [(10, 2)] * 50 + [(10, 10)]
    assert _sizer_trace(ts, kw, obs) == _sizer_trace(js, kw, obs)


def test_sizer_off_quantum_ceiling_reachable():
    s = ts.AdaptiveWaveSizer(T0=12, t_min=8, window=10)
    assert s.T == 12                         # not floored to 8
    s.observe(10, 8)
    assert s.T == 8                          # MD onto the quantum rung
    s.observe(10, 0)
    assert s.T == 12                         # AI reaches the ceiling again


@pytest.mark.parametrize("kw", [dict(T0=32, high=0.1, low=0.5),
                                dict(T0=4, t_min=8)],
                         ids=["thresholds", "empty-ladder"])
def test_sizer_refuses_what_the_reference_refuses(kw):
    for pkg in (ts, js):
        with pytest.raises(ValueError):
            pkg.AdaptiveWaveSizer(**kw)


@pytest.mark.parametrize("B,K", [(0, 1), (2, 0)])
def test_driver_refuses_empty_pipeline(B, K):
    svc = ts.TxnService(N_NODES * KPN, T=T, n_nodes=N_NODES, device="cpu")
    with pytest.raises(ValueError):
        ts.StreamingDriver(svc, B=B, K=K)


# -------------------------------------------------------- block staging
def _host_waves(n, seed=5):
    waves = tw.ycsb_waves(np.random.RandomState(seed), n, T, N_NODES, KPN,
                          theta=0.9, read_frac=0.3, device="cpu")
    return [tc.wave_to_numpy(w) for w in waves]


@pytest.mark.parametrize("form", ["list", "stacked"])
def test_stage_block_keeps_every_bit(form):
    waves = _host_waves(3)
    stacked = tc.Wave(*(np.stack(f) for f in zip(*waves)))
    blk = tc.stage_block(waves if form == "list" else stacked, 7, 5,
                         device="cpu")
    for f, got, want in zip(tc.Wave._fields, blk.wave, stacked):
        assert got.dtype == torch.int32, f
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
    assert blk.wave_idx.tolist() == [7, 8, 9]
    assert int(blk.watermark) == 5 and blk.host is None
    assert tc.stage_block(waves, 1, None, device="cpu").watermark is None


@pytest.mark.parametrize("watermark", [None, 2])
def test_run_block_on_a_staged_block_equals_host_arrays(watermark):
    waves = _host_waves(4)
    stacked = tc.Wave(*(np.stack(f) for f in zip(*waves)))
    kw = dict(sched="postsi", n_nodes=N_NODES, kernels="torch")
    s1, o1, c1 = tc.step_block(tc.make_store(N_NODES * KPN, 4, device="cpu"),
                               stacked, 3, 1, watermark=watermark, **kw)
    blk = tc.stage_block(waves, 3, watermark, device="cpu")
    s2, o2, c2 = tc.step_block(tc.make_store(N_NODES * KPN, 4, device="cpu"),
                               blk, None, torch.ones((), dtype=torch.int32),
                               **kw)
    for f, a, b in zip(o1._fields, o1, o2):
        np.testing.assert_array_equal(a, b, err_msg=f)
    for a, b in zip(s1, s2):
        assert torch.equal(a, b)
    assert int(c1) == int(c2)
    with pytest.raises(ValueError, match="StagedBlock"):
        tc.run_block(s2, blk, 3, c2, **kw)


# ---------------------------------------------------------------- example
def test_example_serves_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "serve_txn_service_torch",
        ROOT / "examples" / "serve_txn_service_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "history verified" in out and "streaming (B=4, K=2)" in out
