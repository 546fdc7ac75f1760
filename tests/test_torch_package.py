"""Independence and no-silent-fallback guards of the PyTorch port.

* no module of ``src/repro_torch`` and no line of ``chip_smoke.py``
  imports ``jax`` or the JAX package ``repro``, and importing the port
  leaves ``jax`` out of ``sys.modules``;
* the entry points run on the CUDA device by default and raise without
  one — they never quietly run on the CPU;
* a ``cuda`` kernel config with CPU tensors raises — it is never served by
  the plain version;
* every architecture id resolves, an unknown family raises ``ValueError``,
  the reference-only config knobs raise ``NotImplementedError`` instead of
  being ignored, and a ``mesh`` that is not a ``NodeMesh`` raises
  ``TypeError``;
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
from repro_torch.configs import ARCH_IDS, PORTED, get_config, get_reduced
from repro_torch.kernels import KernelConfig, backend, build
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.ssd_scan import ssd_cuda, ssd_smem_bytes
from repro_torch.launch.serve import Server
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build as build_model
from repro_torch.placement import PlacementMap
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
    assert (full.serve_batches, full.new_tokens) == (3, 16)
    assert (chip_smoke.SERVE_ARCH, chip_smoke.SERVE_BATCH,
            chip_smoke.SERVE_PROMPTS) == ("zamba2-2.7b", 4, (1024, 1024, 1000))
    short = chip_smoke.parse_config(["--waves", "2", "--scheds", "postsi",
                                     "--ticks", "4", "--serve-batches", "1",
                                     "--new-tokens", "2"])
    assert short == full._replace(waves=2, scheds="postsi", ticks=4,
                                  serve_batches=1, new_tokens=2)
    for bad in (["--kpn", "10"], ["--serve-batches", "4"],
                ["--batch", "8"], ["--prompt", "64"]):
        with pytest.raises(SystemExit):
            chip_smoke.parse_config(bad)


def test_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch, repro_torch.core, "
            "repro_torch.service, repro_torch.kernels.ops, "
            "repro_torch.configs, repro_torch.models.convert, "
            "repro_torch.launch.serve, repro_torch.durability, "
            "repro_torch.checkpoint, repro_torch.runtime, "
            "repro_torch.placement, repro_torch.planner; "
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
        PlacementMap(16, 2, headroom=2).device_arrays()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.wave_from_numpy(tw.smallbank_waves(
            np.random.RandomState(0), 1, 4, 2, 4, device="cpu")[0])
    cfg = get_reduced("zamba2-2.7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Server(cfg, {}, batch_size=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax(cfg, {})
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
    # the model plane: prefill with the kernels on CPU tokens raises too
    cfg = get_reduced("zamba2-2.7b").replace(compute_dtype=torch.float32)
    model = build_model(cfg, kernels="cuda")
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="cuda"):
        model.prefill(params, {"tokens": torch.zeros((1, 8), dtype=torch.int32)})
    with pytest.raises(ValueError, match="cuda"):
        Server(cfg, params, batch_size=1, kernels="cuda", device="cpu")


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_inputs():
    """The CUDA entry points take CUDA int32 tensors only; they raise before
    building or launching anything."""
    from repro_torch.core.engine import wave_read_phase
    from repro_torch.kernels.commit_loop import commit_loop_cuda
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
    store = tc.make_store(8, 2, device="cpu")
    (wave,) = tw.smallbank_waves(np.random.RandomState(0), 1, 4, 2, 4,
                                 device="cpu")
    inputs = wave_read_phase(tc.LocalSubstrate("torch", "cpu"), store, wave,
                             1, 1)
    kw = dict(sched="postsi", n_nodes=2, gc_track=False, gc_block=False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        commit_loop_cuda(store, inputs, **kw)
    with pytest.raises(ValueError, match="unknown scheduler"):
        commit_loop_cuda(store, inputs, **{**kw, "sched": "2pl"})
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_cuda(q, q, q)
    x, dA, bc = torch.zeros((2, 8, 4)), torch.zeros((2, 8)), torch.zeros(
        (1, 8, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd_cuda(x, dA, bc, bc, 2)
    with pytest.raises(ValueError, match="groups"):
        ssd_cuda(x, dA, bc, bc, 3)
    assert tk.LAUNCHES == before


def test_ssd_kernel_shared_memory_limit():
    """The SSD kernel keeps a chunk in shared memory, the float32 kernel's
    [M | C] rows one strip of 64 at a time: zamba2's sizes fit, and so
    does mamba2-130m's N=128 at chunk 128, in float32 and in bf16 (checked,
    not launched); N=256 does not."""
    assert ssd_smem_bytes(64, 64, 128) == 132_352 <= build.SMEM_LIMIT
    assert ssd_smem_bytes(64, 128, 128) == 197_888 <= build.SMEM_LIMIT
    assert ssd_smem_bytes(64, 128, 128, torch.float32) <= build.SMEM_LIMIT
    assert ssd_smem_bytes(64, 128, 128, torch.bfloat16) == 165_888
    assert ssd_smem_bytes(64, 256, 128) > build.SMEM_LIMIT
    # chunks under one strip stage whole
    assert ssd_smem_bytes(16, 16, 16) == 4 * (16 * 33 + 16 * 17 + 32 * 16
                                              + 16)


@pytest.mark.parametrize("arch", [
    "qwen2-vl-2b", "qwen2-0.5b", "qwen3-14b", "deepseek-coder-33b", "yi-9b",
    "phi3.5-moe-42b-a6.6b", "deepseek-moe-16b", "mamba2-130m",
    "seamless-m4t-large-v2"])
def test_ported_archs_resolve(arch):
    """Every id resolves, full and reduced, and its parameter tree has the
    reference's leaves."""
    from repro.configs import get_config as j_get_config
    from repro.configs import get_reduced as j_get_reduced
    from repro.models.model import build as j_build
    from repro_torch.models.module import tree_leaves
    assert arch in PORTED
    for ours, ref in ((get_config(arch), j_get_config(arch)),
                      (get_reduced(arch), j_get_reduced(arch))):
        assert ours.name == ref.name and ours.family == ref.family
        # both trees are nested dicts of specs, walked in sorted-key order
        model = build_model(ours)
        assert [s.shape for s in tree_leaves(model.param_specs())] == [
            s.shape for s in tree_leaves(j_build(ref).param_specs())]
        # a layer's specs are the stacked blocks without their layer axis
        if ours.family == "encdec":
            pairs = ((model.enc_layer_specs(), model.param_specs()["enc"]),
                     (model.dec_layer_specs(), model.param_specs()["dec"]))
        else:
            pairs = ((model.layer_specs(), model.param_specs()["blocks"]),)
        for one, stacked in pairs:
            assert [s.shape for s in tree_leaves(one)] == [
                s.shape[1:] for s in tree_leaves(stacked)]


def test_unported_families_and_options_raise():
    """Every architecture id is served; an unknown family or id raises."""
    cfg = get_reduced("zamba2-2.7b")
    assert list(ARCH_IDS) == list(PORTED) and len(ARCH_IDS) == 10
    with pytest.raises(ValueError, match="unknown family"):
        build_model(cfg.replace(family="rnn"))
    with pytest.raises(KeyError):
        get_config("gpt-5")


@pytest.mark.parametrize("field,value", [
    ("remat_policy", "dots"), ("attn_chunk", 16), ("attn_seq_shard", True),
    ("decode_seq_shard", True)])
def test_reference_only_knobs_refuse_other_values(field, value):
    """The GSPMD/XLA-only fields are kept at their defaults; another value
    raises instead of meaning nothing."""
    cfg = get_reduced("zamba2-2.7b")
    with pytest.raises(NotImplementedError, match="Model plane"):
        cfg.replace(**{field: value})
    assert cfg.replace(**{field: getattr(cfg, field)}) == cfg


def test_service_mesh_is_a_node_mesh():
    """``mesh=`` takes a ``NodeMesh``: anything else raises ``TypeError``,
    and a NodeMesh serves the stream the single device serves."""
    with pytest.raises(TypeError, match="NodeMesh"):
        TxnService(16, T=4, n_nodes=2, device="cpu", mesh=object())
    read_one = lambda: (np.array([tc.READ, tc.NOP, tc.NOP, tc.NOP]),
                        np.array([3, 0, 0, 0]), np.zeros(4), 1)
    fates = []
    for mesh in (None, tc.make_node_mesh(2, "cpu")):
        svc = TxnService(16, T=4, n_nodes=2, device="cpu", mesh=mesh)
        rep = svc.run_stream([2, 2], read_one)
        assert rep.committed == 4 and svc.verify() == []
        fates.append([(r.status, r.s, r.c) for r in svc.requests])
    assert fates[0] == fates[1]


def test_run_streaming_not_ported(tmp_path):
    """The streaming plane serves, and serves durably: with a durability
    manager and a fault schedule attached, every retired block is logged
    and a fresh service on the directory recovers the same store."""
    from repro_torch.durability import DurabilityManager, wal, wal_path
    from repro_torch.runtime import FaultSchedule
    read_one = lambda: (np.array([tc.READ, tc.NOP, tc.NOP, tc.NOP]),
                        np.array([3, 0, 0, 0]), np.zeros(4), 1)
    mgr = DurabilityManager(str(tmp_path))
    svc = TxnService(16, T=4, n_nodes=2, device="cpu", durability=mgr,
                     faults=FaultSchedule())
    rep = svc.run_streaming([2, 2], read_one, B=2, K=2)
    mgr.close()
    assert rep.committed == rep.admitted == 4 and rep.blocks > 0
    assert len(wal.scan(wal_path(str(tmp_path))).blocks) == rep.blocks
    again = TxnService(16, T=4, n_nodes=2, device="cpu",
                       durability=DurabilityManager(str(tmp_path)))
    for a, b in zip(again.store, svc.store):
        assert torch.equal(a, b)
    assert again.former.next_tid == svc.former.next_tid


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
        "version_scan.cu", "interval_negotiate.cu", "wave_commit.cu",
        "commit_loop.cu", "flash_attention.cu", "ssd_scan.cu",
        "ssd_scan_bwd.cu"}
    assert set(build.LAUNCHES) == {
        "version_scan", "potential_matrix", "wave_commit", "commit_loop",
        "flash_attention", "ssd_scan", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkdv", "ssd_scan_bwd_states",
        "ssd_scan_bwd_scan", "ssd_scan_bwd_states_scan",
        "ssd_scan_bwd_grads"}
    assert {f"{n}_launch" for n in build.LAUNCHES} == set(build.SIGNATURES)
    assert [h.name for h in headers] == ["common.cuh", "mma.cuh", "sm90.cuh"]
    for src in sources:
        text = src.read_text()
        assert "Replaces the TPU kernel" in text
        assert "What bounds it" in text and "What the design does" in text
    d0 = build._digest(sources + headers)
    copy = tmp_path / sources[-1].name
    copy.write_text(sources[-1].read_text() + "\n// edited\n")
    assert build._digest(sources[:-1] + [copy] + headers) != d0
