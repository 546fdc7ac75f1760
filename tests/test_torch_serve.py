"""The port's ``Server`` and its PostSI ``SeqScheduler`` held against the
JAX package's.

* ``repro_torch.launch.serve.Server`` against ``repro.launch.serve.Server``
  on reduced zamba2 in float32, batch 2: two batches with a ``publish`` of
  a second weight version between them (the walk of
  ``tests/test_substrate.py``'s hot-swap test).  Same weights (carried with
  ``params_from_jax``), same prompts: the same ``weight_version``
  sequence, the same generated ids and equal ``ServeStats``.
* ``repro_torch.core.seq.SeqScheduler`` (the port's own copy) against
  ``repro.core.seq.SeqScheduler`` on seeded random interleavings of begin
  (some with an ``s_hi`` pin), read, write and commit, in both modes: the
  same values read, the same commit and abort outcomes, the same
  timestamps and the same history.
* ``chip_smoke.py``'s serve phase rehearsed on the CPU at a tiny size, so
  that a fault in it shows before a chip run.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.core.seq import SeqScheduler as JSeq
from repro.launch.serve import Server as JServer
from repro.models.model import build as j_build
from repro_torch.configs import get_reduced
from repro_torch.core.seq import SeqScheduler
from repro_torch.launch.serve import ServeStats, Server
from repro_torch.models.convert import params_from_jax

ARCH = "zamba2-2.7b"
ROOT = Path(__file__).resolve().parents[1]


def test_server_matches_reference_across_a_publish():
    jc = j_get_reduced(ARCH).replace(compute_dtype=jnp.float32)
    tc = get_reduced(ARCH).replace(compute_dtype=torch.float32)
    jm = j_build(jc)
    jps = [jm.init(jax.random.PRNGKey(s)) for s in (0, 1)]
    tps = [params_from_jax(tc, jax.tree_util.tree_map(np.asarray, p),
                           device="cpu") for p in jps]
    jsrv = JServer(jc, jps[0], batch_size=2)
    tsrv = Server(tc, tps[0], batch_size=2, device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, tc.vocab_size, (2, S)).astype(np.int32)
               for S in (16, 13)]
    for i, toks in enumerate(prompts):
        if i == 1:
            assert jsrv.publish(jps[1]) and tsrv.publish(tps[1])
        jr = jsrv.serve_batch(toks, max_new_tokens=4)
        tr = tsrv.serve_batch(toks, max_new_tokens=4)
        assert tr["weight_version"] == jr["weight_version"] == i
        assert tr["generated"].dtype == np.int32
        np.testing.assert_array_equal(tr["generated"], jr["generated"])
    assert isinstance(tsrv.stats, ServeStats)
    assert dataclasses.asdict(tsrv.stats) == dataclasses.asdict(jsrv.stats)
    assert tsrv.stats.versions_served == [0, 1]
    with pytest.raises(ValueError, match="batch"):
        tsrv.serve_batch(prompts[0][:1])


def test_step_factories_serve_what_the_server_serves():
    """``make_prefill_step`` / ``make_decode_step`` (the port of
    ``repro.launch.train``'s serve-step builders) generate the ids that
    ``Server`` generates for the same weights and prompt."""
    from repro_torch.launch.train import make_decode_step, make_prefill_step
    tc = get_reduced(ARCH).replace(compute_dtype=torch.float32)
    model, prefill = make_prefill_step(tc, "torch")
    _, decode = make_decode_step(tc, "torch")
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.RandomState(1).randint(0, tc.vocab_size, (2, 11)).astype(
        np.int32)
    want = Server(tc, params, batch_size=2, device="cpu").serve_batch(
        toks, max_new_tokens=4)["generated"]
    logits, cache = prefill(params, {"tokens": torch.as_tensor(toks)},
                            toks.shape[1] + 8)
    tok = logits[..., :tc.vocab_size].argmax(dim=-1).int()
    out = [tok]
    for _ in range(3):
        tok, cache = decode(params, cache, {"token": tok})
        out.append(tok)
    np.testing.assert_array_equal(torch.cat(out, dim=1).numpy(), want)


def _interleave(seed: int, mode: str, n_keys: int = 5, steps: int = 160):
    """Drive both schedulers through one random interleaving; return the
    trace of every call's result (reference, port)."""
    rng = np.random.RandomState(seed)
    ref, port = JSeq(n_keys, mode), SeqScheduler(n_keys, mode)
    trace_r, trace_p, live = [], [], []
    for _ in range(steps):
        op = rng.choice(["begin", "read", "read", "write", "commit"]
                        if live else ["begin"])
        if op == "begin" and len(live) < 4:
            pin = None
            if rng.rand() < 0.2:
                pin = int(rng.randint(0, 8))
            tids = ref.begin(pin), port.begin(pin)
            assert tids[0] == tids[1]
            live.append(tids[0])
            continue
        if not live:
            continue
        tid = live[rng.randint(len(live))]
        if op == "read":
            key = int(rng.randint(n_keys))
            trace_r.append(("read", tid, key, ref.read(tid, key)))
            trace_p.append(("read", tid, key, port.read(tid, key)))
        elif op == "write":
            key, val = int(rng.randint(n_keys)), int(rng.randint(100))
            ref.write(tid, key, val)
            port.write(tid, key, val)
        elif op == "commit":
            trace_r.append(("commit", tid, ref.commit(tid)))
            trace_p.append(("commit", tid, port.commit(tid)))
        trace_r.append(("max_cid", tid, ref.max_observed_cid(tid)))
        trace_p.append(("max_cid", tid, port.max_observed_cid(tid)))
        live = [t for t in live if ref.txns[t].status == "running"]
    return ref, port, trace_r, trace_p


@pytest.mark.parametrize("mode", ["postsi", "cv"])
@pytest.mark.parametrize("seed", range(6))
def test_seq_scheduler_matches_reference(mode, seed):
    ref, port, trace_r, trace_p = _interleave(seed, mode)
    assert trace_p == trace_r
    assert any(t[0] == "commit" and t[2] for t in trace_r)
    for tid, t in ref.txns.items():
        p = port.txns[tid]
        assert (p.status, p.s, p.c, p.s_lo, p.s_hi, p.c_lo) == (
            t.status, t.s, t.c, t.s_lo, t.s_hi, t.c_lo)
    for key, chain in ref.versions.items():
        assert [(v.value, v.tid, v.cid, v.sid) for v in port.versions[key]] \
            == [(v.value, v.tid, v.cid, v.sid) for v in chain]
    assert port.antidep == ref.antidep
    (tids_r, hr), = ref.history()
    (tids_p, hp), = port.history()
    np.testing.assert_array_equal(tids_p, tids_r)
    for f in ("status", "s", "c", "read_key", "read_cid", "write_key",
              "write_cid"):
        np.testing.assert_array_equal(getattr(hp, f), getattr(hr, f))


def test_chip_smoke_serve_phase_rehearses_on_cpu(monkeypatch, capsys):
    """The smoke run's serve phase, end to end on the CPU at a tiny size
    (reduced zamba2, the torch route, the card's clock calls stubbed): one
    weight version per batch, the in-situ and teacher-forced checks run,
    and no kernel launches off the card."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    for fn in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "SERVE_PROMPTS", (24, 24, 19))
    monkeypatch.setattr(chip_smoke, "SERVE_BATCH", 2)
    cfg = chip_smoke.parse_config(["--new-tokens", "3"])
    counts = chip_smoke.serve_phase(torch, torch.device("cpu"), cfg, "cpu",
                                    mcfg=get_reduced(ARCH), route="torch")
    out = capsys.readouterr().out
    assert "versions [0, 1, 1]" in out
    assert "[serve] in situ" in out and out.count("teacher-forced") == 3
    assert counts["flash_attention"] == counts["ssd_scan"] == 0
