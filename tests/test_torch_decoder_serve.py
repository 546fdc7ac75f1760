"""The port's ``Server`` serving ``DecoderLM``, held against the JAX
package's ``Server``, and ``chip_smoke.py``'s decoder phase rehearsed on
the CPU.

* qwen2-0.5b-reduced (qkv bias, tied embeddings) and qwen2-vl-2b-reduced
  (M-RoPE, ``[B, S, 3]`` positions made by the server) in float32, batch
  2: two batches with a ``publish`` of a second weight version between
  them.  Same weights (the reference's init with noisy biases and norms,
  carried with ``params_from_jax``), same prompts: the same
  ``weight_version`` sequence, the same generated ids and equal
  ``ServeStats``.
* ``make_prefill_step`` / ``make_decode_step`` generate what ``Server``
  generates for a decoder model.
* ``chip_smoke.decoder_phase`` (phase 7) end to end on the CPU at reduced
  size on the ``torch`` route, the card's clock calls stubbed: one weight
  version per batch, the in-situ and teacher-forced checks run, no kernel
  launches off the card; and ``DECODER_RUNS`` resolves to the full-width
  configurations with deepseek-moe-16b's depth cut.
"""
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.launch.serve import Server as JServer
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch.serve import Server, prompt_batch
from test_torch_decoder import both

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-vl-2b"])
def test_server_matches_reference_across_a_publish(arch):
    jc, tc, jp0, tp0 = both(arch, seed=0)
    _, _, jp1, tp1 = both(arch, seed=1)
    jsrv = JServer(jc, jp0, batch_size=2)
    tsrv = Server(tc, tp0, batch_size=2, device="cpu")
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, tc.vocab_size, (2, S)).astype(np.int32)
               for S in (16, 13)]
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


def test_prompt_batch_positions():
    toks = torch.zeros((2, 5), dtype=torch.int32)
    assert set(prompt_batch(get_reduced("qwen2-0.5b"), toks)) == {"tokens"}
    pos = prompt_batch(get_reduced("qwen2-vl-2b"), toks)["positions"]
    assert pos.shape == (2, 5, 3) and pos.dtype == torch.int32
    assert torch.equal(pos[1, :, 2], torch.arange(5, dtype=torch.int32))


def test_step_factories_serve_what_the_server_serves():
    from repro_torch.launch.train import make_decode_step, make_prefill_step
    tc = get_reduced("qwen3-14b").replace(compute_dtype=torch.float32)
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


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    for fn in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "SERVE_BATCH", 2)
    return chip_smoke


def test_chip_smoke_decoder_phase_rehearses_on_cpu(chip_smoke, capsys):
    """Phase 7 at reduced size on the torch route: qwen3-14b (qk-norm) with
    one version, qwen2-vl-2b (M-RoPE) with two and a publish, and
    deepseek-moe-16b with one; every check of ``serve_phase`` runs."""
    cfg = chip_smoke.parse_config(["--new-tokens", "3"])
    runs = [("7a", get_reduced("qwen3-14b"), 1, (24, 19), ""),
            ("7b", get_reduced("qwen2-vl-2b"), 2, (24, 24, 19), ""),
            ("7c", get_reduced("deepseek-moe-16b").replace(n_layers=1), 1,
             (24, 19), "depth cut from 2 to 1 layers")]
    counts = chip_smoke.decoder_phase(torch, torch.device("cpu"), cfg, "cpu",
                                      runs=runs, route="torch")
    out = capsys.readouterr().out
    assert "versions [0, 0]" in out and "versions [0, 1, 1]" in out
    assert out.count("[decoder] in situ:") == 3
    assert out.count("teacher-forced") == 7
    assert "7c deepseek-moe-reduced: depth cut from 2 to 1 layers" in out
    assert "moe_ffn sync check skipped" in out
    assert counts["flash_attention"] == counts["ssd_scan"] == 0


def test_decoder_runs_resolve_at_full_width(chip_smoke):
    """``DECODER_RUNS``: full-width configurations, only deepseek-moe-16b
    cut in depth (to 8 of 28 layers, 20.5 of 67.5 GB in float32), every
    head dim one the attention kernel takes."""
    seen = {}
    for step, arch, n_versions, prompts, layers in chip_smoke.DECODER_RUNS:
        full = get_config(arch)
        seen[arch] = (step, n_versions, layers)
        assert full.head_dim % 16 == 0 and full.head_dim <= 128
        assert all(S <= 1024 for S in prompts)
        if layers is not None:
            assert full.param_count() * 4 > 60e9
            cut = full.replace(n_layers=layers).param_count() * 4
            assert 20e9 < cut < 21e9
    assert seen == {"qwen3-14b": ("7a", 1, None),
                    "qwen2-0.5b": ("7b", 2, None),
                    "qwen2-vl-2b": ("7b", 2, None),
                    "deepseek-moe-16b": ("7c", 1, 8)}
    assert get_config("qwen3-14b").param_count() == 14_769_602_560
