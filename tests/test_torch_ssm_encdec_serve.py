"""``chip_smoke.py``'s phase 8 (the SSM and encoder-decoder families behind
``Server``) rehearsed on the CPU, and its runs resolved at full width.

* ``chip_smoke.ssm_encdec_phase`` end to end on the CPU at reduced size on
  the ``torch`` route, the card's clock calls stubbed: reduced mamba2-130m
  over a 40- and a 37-token prompt (37 is a ragged last chunk of 16) and
  reduced seamless over 24-token prompts with 40 and 37 encoder frames,
  two weight versions each and a publish; one weight version per batch,
  the in-situ and teacher-forced checks run, no kernel launches off the
  card.
* ``SSM_ENCDEC_RUNS`` resolves to the full-width, full-depth
  configurations: every SSD and attention shape one the kernels take, the
  float32 SSD kernel's shared memory within a block's limit at
  mamba2-130m's N=128 and chunk 128.
* ``examples/serve_hotswap_torch.py`` runs on the CPU: versions
  ``[0, 0, 0, 1, 1, 2, 2, 2]``, the half-written publish invisible.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels.build import SMEM_LIMIT
from repro_torch.kernels.ssd_scan import ssd_smem_bytes

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    for fn in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "SERVE_BATCH", 2)
    return chip_smoke


def test_chip_smoke_ssm_encdec_phase_rehearses_on_cpu(chip_smoke, capsys):
    cfg = chip_smoke.parse_config(["--new-tokens", "3"])
    runs = [("8a", get_reduced("mamba2-130m"), 2, (40, 37), None),
            ("8b", get_reduced("seamless-m4t-large-v2"), 2, (24, 24),
             (40, 37))]
    counts = chip_smoke.ssm_encdec_phase(torch, torch.device("cpu"), cfg,
                                         "cpu", runs=runs, route="torch")
    out = capsys.readouterr().out
    assert out.count("versions [0, 1]") == 2
    assert out.count("[ssm-encdec] in situ:") == 2
    assert out.count("teacher-forced") == 4
    assert "printed, not gated" in out
    assert "over 40 encoder frames" in out and "over 37 encoder frames" in out
    assert counts["flash_attention"] == counts["ssd_scan"] == 0


def test_model_launches_per_family(chip_smoke):
    """The launches phase 8 gates: 24 ssd_scan a mamba2-130m prefill; 72
    flash_attention a seamless prefill and 24 a decode step."""
    pre, step = chip_smoke.model_launches(get_config("mamba2-130m"))
    assert pre == {"flash_attention": 0, "ssd_scan": 24}
    assert step == {"flash_attention": 0, "ssd_scan": 0}
    pre, step = chip_smoke.model_launches(get_config("seamless-m4t-large-v2"))
    assert pre == {"flash_attention": 72, "ssd_scan": 0}
    assert step == {"flash_attention": 24, "ssd_scan": 0}
    pre, step = chip_smoke.model_launches(get_config("zamba2-2.7b"))
    assert pre == {"flash_attention": 9, "ssd_scan": 54}
    assert chip_smoke.model_launches(get_config("qwen3-14b"))[0] == {
        "flash_attention": 40, "ssd_scan": 0}


def test_ssm_encdec_runs_resolve_at_full_width(chip_smoke):
    seen = {}
    for step, arch, n_versions, prompts, src in chip_smoke.SSM_ENCDEC_RUNS:
        full = get_config(arch)
        seen[arch] = (step, n_versions, prompts, src)
        assert not full.name.endswith("reduced")
        if full.family == "ssm":
            assert (full.n_layers, full.d_model, full.d_state, full.headdim,
                    full.ssd_chunk) == (24, 768, 128, 64, 128)
            for dt in (torch.float32, torch.bfloat16):
                assert ssd_smem_bytes(full.headdim, full.d_state,
                                      full.ssd_chunk, dt) <= SMEM_LIMIT
        else:
            assert (full.n_enc_layers, full.n_layers, full.d_model,
                    full.n_heads, full.head_dim, full.d_ff,
                    full.vocab_size) == (24, 24, 1024, 16, 64, 8192,
                                         256_206)
            assert full.head_dim % 16 == 0 and full.head_dim <= 128
    assert seen == {
        "mamba2-130m": ("8a", 2, (1024, 1000), None),
        "seamless-m4t-large-v2": ("8b", 2, (128, 128), (1024, 1000))}
    assert chip_smoke.ENC_SCALE == 0.05


def test_hotswap_example_serves_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "serve_hotswap_torch", ROOT / "examples" / "serve_hotswap_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--device", "cpu"]) == [0, 0, 0, 1, 1, 2, 2, 2]
    assert "no torn weights" in capsys.readouterr().out


@pytest.mark.parametrize("traced,ok", [
    (24, True), (23, True), (1, True), (0, False), (25, False),
    ("mma", False)])
def test_chip_smoke_ssd_check_holds_the_traced_scans_to_the_route_kernel(
        chip_smoke, capsys, traced, ok):
    """Phases 6 and 8 hold a profiled prefill's scans to the route table's
    kernel.  The launch counters count the scans; the trace need only show
    their kernel, so a trace short of scans (the profiler dropped events)
    passes, and a scan on another kernel, no scan, or more scans than
    layers fail.  The prefill is profiled once."""
    mcfg = get_config("mamba2-130m")
    calls = []

    def profile():
        calls.append(1)
        scans = ({"ssd_scan_mma_kernel<4, 8>": 24} if traced == "mma" else
                 {"ssd_scan_wgmma_kernel<2>": traced} if traced else {})
        return {"flash_attention_wgmma_kernel<64>": 1, **scans}
    if ok:
        chip_smoke.ssd_check(mcfg, profile, True, "t", 1024)
        assert (f"the prefill's scans ran on ssd_scan_wgmma_kernel<2> "
                f"({traced} of 24 in the trace)") in capsys.readouterr().out
    else:
        with pytest.raises(AssertionError, match="expected "
                                                 "ssd_scan_wgmma_kernel x24"):
            chip_smoke.ssd_check(mcfg, profile, True, "t", 1024)
    assert len(calls) == 1
