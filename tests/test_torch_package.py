"""Independence and no-silent-fallback guards of the PyTorch port.

* no module of ``src/repro_torch`` and no line of ``chip_smoke.py``
  imports ``jax`` or the JAX package ``repro``, and importing the port
  leaves ``jax`` out of ``sys.modules``;
* the entry points run on the CUDA device by default and raise without
  one — they never quietly run on the CPU;
* a ``cuda`` kernel config with CPU tensors raises — it is never served by
  the plain version;
* the service planes this slice does not port raise
  ``NotImplementedError`` instead of being ignored;
* the backend registry resolves and round-trips like the reference's.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch import kernels as tk
from repro_torch.core import workloads as tw
from repro_torch.kernels import KernelConfig, backend, build
from repro_torch.service import TxnService

ROOT = Path(__file__).resolve().parents[1]
IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|$)",
                    re.MULTILINE)


def test_port_sources_import_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    offenders = {str(f.relative_to(ROOT)): IMPORT.findall(f.read_text())
                 for f in files}
    assert {f: m for f, m in offenders.items() if m} == {}


def test_chip_smoke_flags_cut_depth_only():
    """The smoke run's sizes are fixed; its flags set only the depth."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    full = chip_smoke.parse_config([])
    assert full == chip_smoke.Config()
    assert (full.nodes * full.kpn, full.V, full.T) == (1_000_000, 8, 256)
    short = chip_smoke.parse_config(["--waves", "2", "--scheds", "postsi",
                                     "--ticks", "4"])
    assert short == full._replace(waves=2, scheds="postsi", ticks=4)
    with pytest.raises(SystemExit):
        chip_smoke.parse_config(["--kpn", "10"])


def test_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch, repro_torch.core, "
            "repro_torch.service, repro_torch.kernels.ops; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_default_entry_points_need_cuda(monkeypatch):
    """With no CUDA device the default device is refused, loudly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.make_store(8, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tw.smallbank_waves(np.random.RandomState(0), 1, 4, 2, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TxnService(16, T=4, n_nodes=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.wave_from_numpy(tw.smallbank_waves(
            np.random.RandomState(0), 1, 4, 2, 4, device="cpu")[0])
    assert KernelConfig("auto").backend == "torch"
    assert tk.resolve("auto", "cpu") == KernelConfig("torch")


def test_cuda_config_with_cpu_tensors_raises():
    store = tc.make_store(8, 2, device="cpu")
    (wave,) = tw.smallbank_waves(np.random.RandomState(0), 1, 4, 2, 4,
                                 device="cpu")
    for spec in ("cuda", "cuda+fused", KernelConfig("cuda")):
        with pytest.raises(ValueError, match="cuda"):
            tc.run_wave(store, wave, 1, 1, 2, kernels=spec)
        with pytest.raises(ValueError, match="cuda"):
            tc.LocalSubstrate(spec, device="cpu")
        with pytest.raises(ValueError, match="cuda"):
            TxnService(8, T=4, n_nodes=2, kernels=spec, device="cpu")
    with pytest.raises(ValueError, match="cuda"):
        tc.commit_phase.build_potential(wave.op_key, wave.op_kind > 0,
                                        wave.op_kind > 1, backend="cuda")


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_inputs():
    """The CUDA entry points take CUDA int32 tensors only; they raise before
    building or launching anything."""
    from repro_torch.kernels.interval_negotiate import potential_matrix_cuda
    from repro_torch.kernels.version_scan import version_scan_cuda
    from repro_torch.kernels.wave_commit import wave_commit_cuda
    a = torch.zeros((4, 2), dtype=torch.int32)
    k = torch.zeros(4, dtype=torch.int32)
    before = dict(tk.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        version_scan_cuda(a, a, k, k)
    with pytest.raises(ValueError, match="CUDA tensor"):
        potential_matrix_cuda(a, a)
    with pytest.raises(ValueError, match="CUDA tensor"):
        wave_commit_cuda(a, a, a, a, a[:1], a[:1], a[:1], a[:1].bool(),
                         a[:1])
    assert tk.LAUNCHES == before


@pytest.mark.parametrize("arg,item", [
    ("mesh", "Mesh substrate"), ("planner", "Planner"),
    ("durability", "durability"), ("faults", "fault injection"),
    ("placement", "Elastic placement"), ("replicas", "Elastic placement"),
    ("replica_refresh", "Elastic placement"),
    ("balancer", "Elastic placement")])
def test_unported_service_planes_raise(arg, item):
    with pytest.raises(NotImplementedError, match=item):
        TxnService(16, T=4, n_nodes=2, device="cpu", **{arg: object()})


def test_run_streaming_not_ported():
    svc = TxnService(16, T=4, n_nodes=2, device="cpu")
    with pytest.raises(NotImplementedError, match="Streaming service plane"):
        svc.run_streaming([1], lambda: None)


def test_kernel_config_resolution_round_trips(monkeypatch):
    for spec in ("cuda", "torch", "cuda+fused", "torch+fused"):
        cfg = KernelConfig(spec)
        assert tk.resolve(cfg.name) == cfg and hash(cfg) == hash(
            KernelConfig(spec))
        assert cfg.fused == spec.endswith("+fused")
        assert cfg.use_kernel == spec.startswith("cuda")
    assert tk.resolve("auto+fused", "cpu") == KernelConfig("torch", True)
    with pytest.raises(ValueError):
        KernelConfig("pallas")
    monkeypatch.setattr(backend, "_default", "auto")
    tk.set_default_backend("torch+fused")
    assert tk.default_backend() == "torch+fused"
    assert tk.resolve(None, "cpu") == KernelConfig("torch", fused=True)
    with pytest.raises(ValueError):
        tk.set_default_backend("jnp")


def test_build_hash_covers_sources_and_flags(tmp_path):
    """The library is rebuilt when a source changes: its directory is named
    by a hash of every source and the flags.  Each source carries its
    header note."""
    sources, headers = build._sources()
    assert {s.name for s in sources} == {
        "version_scan.cu", "interval_negotiate.cu", "wave_commit.cu"}
    assert [h.name for h in headers] == ["common.cuh"]
    for src in sources:
        text = src.read_text()
        assert "Replaces the TPU kernel" in text
        assert "What bounds it" in text and "What the design does" in text
    d0 = build._digest(sources + headers)
    copy = tmp_path / sources[-1].name
    copy.write_text(sources[-1].read_text() + "\n// edited\n")
    assert build._digest(sources[:-1] + [copy] + headers) != d0
