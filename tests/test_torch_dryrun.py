"""The dry run of the port: ``launch.op_count`` on ``meta``, the kernel
route's meta path, ``launch.dryrun.run_cell`` / ``main`` and
``chip_smoke.py``'s phase 9g, on the CPU at reduced sizes.

* a reduced train step counted on ``meta`` equals the same step run on
  the CPU: FLOPs (by dtype), bytes, aten ops, launches and memory;
* on the ``cuda`` route a meta trace launches nothing and counts each
  hand-written kernel as the step makes it, remat included: for each
  family, what ``chip_smoke.train_launches`` says the card launches
  (attention: the forward twice, dq and dk/dv once a call; the SSD scan
  twice, ``_states`` + ``_scan`` or, at the Hopper forms' shapes,
  ``_states_scan``, and ``_grads`` once a layer), each by its own cost
  formula;
* every kernel wrapper on meta tensors: the kernel's output shapes and
  dtypes (and what ``FlashAttentionFn`` / ``SsdScanFn`` save), no launch
  counted, nothing built;
* a ``run_cell`` record for each kind and a skipped cell, and ``main``'s
  files, over reduced configs and small cells;
* phase 9g of ``chip_smoke.py`` rehearsed (the card's clock and memory
  calls stubbed), and a count that differs from its meta trace fails.
"""
import json

import pytest
import torch

from repro_torch.configs import ShapeCell, get_reduced
from repro_torch.kernels import KernelConfig, LAUNCHES, build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import dryrun
from repro_torch.launch.inputs import input_specs, make_batch
from repro_torch.launch.op_count import count_call
from repro_torch.launch.train import abstract_train_state, make_train_step
from repro_torch.optim import adamw_init
from test_torch_commit_loop import _chip_smoke

cs = _chip_smoke()
B, S = 2, 64
META = torch.device("meta")


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_meta_trace_equals_a_cpu_run():
    torch.set_num_threads(1)
    cfg = get_reduced("qwen2-0.5b")
    model, step = make_train_step(cfg, kernels="torch")
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = make_batch(cfg, B, S, "train", device="cpu")
    _, real = count_call(step, params, adamw_init(params), batch)
    _, mparams, mopt = abstract_train_state(cfg, kernels="torch")
    _, meta = count_call(step, mparams, mopt,
                         input_specs(cfg, ShapeCell("t", S, B, "train"))[0])
    assert real == meta
    assert real["flops"] > 0 and real["kernels"] == {}
    mem = real["memory"]
    assert mem["peak_live_bytes"] > mem["argument_bytes"] > 0


def _family(name):
    """The reduced config of ``name``; the Hopper shapes: P = N = 64 in
    one chunk of S < 128 rows, where the states and scan run fused."""
    if name == "mamba2-130m (Hopper shapes)":
        return get_reduced("mamba2-130m").replace(headdim=64, d_state=64,
                                                  ssd_chunk=128)
    return get_reduced(name)


FAMILIES = ("qwen2-0.5b", "mamba2-130m", "mamba2-130m (Hopper shapes)",
            "zamba2-2.7b")


@pytest.mark.parametrize("name", FAMILIES)
def test_cuda_route_meta_trace_counts_each_kernel(name):
    cfg = _family(name)
    _, params, opt = abstract_train_state(cfg, kernels="cuda")
    _, step = make_train_step(cfg, kernels="cuda")
    before = dict(LAUNCHES)
    _, count = count_call(step, params, opt,
                          input_specs(cfg, ShapeCell("t", S, B, "train"))[0])
    assert LAUNCHES == before                    # nothing launched
    want = {k: v for k, v in cs.train_launches(cfg, S).items() if v}
    got = {k: v["launches"] for k, v in count["kernels"].items()}
    assert got == want
    if name == "mamba2-130m (Hopper shapes)":
        assert "ssd_scan_bwd_states_scan" in got
    if "flash_attention" in got:
        H, KH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        one = fa.flash_attention_cost(B, S, S, H, KH, D, True,
                                      cfg.compute_dtype, with_lse=True)
        k = count["kernels"]["flash_attention"]
        assert (k["flops"], k["bytes"]) == (got["flash_attention"] * one[0],
                                            got["flash_attention"] * one[1])
    kernel_flops = sum(v["flops"] for v in count["kernels"].values())
    assert count["flops"] > kernel_flops > 0


def test_kernel_wrappers_on_meta():
    before = dict(LAUNCHES)
    Bq, Sq, H, KH, D = 2, 40, 4, 2, 64
    q, k, v = _meta(Bq, Sq, H, D), _meta(Bq, Sq, KH, D), _meta(Bq, Sq, KH, D)
    o, lse = fa.flash_attention_fwd(q, k, v)
    assert (o.shape, o.dtype, o.device) == (q.shape, q.dtype, META)
    assert (lse.shape, lse.dtype) == ((Bq, H, Sq), torch.float32)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, _meta(Bq, Sq, H, D))
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    qg = q.clone().requires_grad_()
    out = ops.flash_attention(qg, k, v, use_kernel=True)
    saved = out.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [
        q.shape, k.shape, v.shape, q.shape, (Bq, H, Sq)]
    assert saved[-1].dtype == torch.float32
    # the SSD scan in the model layout, at the Hopper shapes and elsewhere
    G, Hs, Ss, P, N = 2, 3, 200, 64, 64
    x = _meta(G, Ss, Hs, P).transpose(1, 2)
    dA = _meta(G, Ss, Hs, dtype=torch.float32).transpose(1, 2)
    Bm, Cm = _meta(G, Ss, N), _meta(G, Ss, N)
    y, h = ss.ssd_scan(x, dA, Bm, Cm, Hs, 128)
    assert y.shape == x.shape and y.stride() == x.stride()
    assert (h.shape, h.dtype) == ((G * Hs, N, P), torch.float32)
    grads = ss.ssd_bwd(x, dA, Bm, Cm, y, Hs, 128)
    assert [t.shape for t in grads[:4]] == [x.shape, dA.shape, Bm.shape,
                                           Cm.shape]
    assert grads[4].shape == (G * Hs, N, P)
    st, U, aL = ss.ssd_bwd_states_cuda(x, dA, Bm, Cm, y, Hs, 128)
    assert st.shape == U.shape == (G * Hs, 2, N, P) and aL.shape == (6, 2)
    # the engine's kernels
    cid = _meta(100, 8, dtype=torch.int32)
    keys = _meta(64, dtype=torch.int32)
    slot, best = ops.version_scan(cid, cid, keys, keys=keys)
    assert slot.shape == best.shape == (64,) and slot.device == META
    rk = _meta(16, 4, dtype=torch.int32)
    assert ops.potential_matrix(rk, rk).dtype == torch.int8
    outs = ops.wave_commit(cid, cid, cid, cid, rk, rk, rk,
                           _meta(16, 4, dtype=torch.bool), keys=rk)
    assert [tuple(t.shape) for t in outs] == [(16, 4)] * 5 + [(16,),
                                                             (16, 16)]
    assert LAUNCHES == before
    assert build.stream_of(q) is None
    KernelConfig("cuda").check_device("meta")
    with pytest.raises(ValueError):
        KernelConfig("cuda").check_device("cpu")


@pytest.fixture
def reduced_cells(monkeypatch):
    """``dryrun`` over the reduced configs and cells of B=2, S=64."""
    monkeypatch.setattr(dryrun, "get_config", get_reduced)
    monkeypatch.setattr(dryrun, "SHAPES", {
        name: ShapeCell(name, S, B, cell.kind)
        for name, cell in dryrun.SHAPES.items()})


def test_run_cell_records(reduced_cells):
    for shape, kind in (("train_4k", "train"), ("prefill_32k", "prefill"),
                        ("decode_32k", "decode")):
        rec = dryrun.run_cell("qwen2-0.5b", shape)
        assert (rec["arch"], rec["shape"], rec["kind"], rec["n_devices"],
                rec["route"]) == ("qwen2-0.5b", shape, kind, 1, "cuda")
        mf = dryrun.model_flops(get_reduced("qwen2-0.5b"),
                                dryrun.SHAPES[shape])
        r, c = rec["roofline"], rec["count"]
        assert rec["model_flops_global"] == mf
        assert r["useful_flops_frac"] == mf / c["flops"]
        assert r["collective_s"] == 0.0 and r["memory_s"] > 0
        assert r["dominant"] in ("compute", "memory")
        assert set(c) == {"flops", "flops_by_dtype", "bytes", "aten_ops",
                          "kernels"}
        assert rec["fits_one_card"] is True
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                      "peak_live_bytes"}
        if kind != "decode":         # decode attends in plain PyTorch
            assert c["kernels"]["flash_attention"]["launches"] >= 2
    skip = dryrun.run_cell("qwen2-0.5b", "long_500k")
    assert skip == {"arch": "qwen2-0.5b", "shape": "long_500k",
                    "skipped": "long_500k not applicable to family=dense "
                               "(full attention; see DESIGN.md §5)"}


def test_main_writes_a_record_a_cell(reduced_cells, tmp_path, monkeypatch,
                                     capsys):
    monkeypatch.setattr("sys.argv", [
        "dryrun", "--arch", "mamba2-130m,qwen2-0.5b", "--outdir",
        str(tmp_path), "--route", "torch"])
    dryrun.main()
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == 8
    recs = [json.loads((tmp_path / f).read_text()) for f in files]
    assert sum("skipped" in r for r in recs) == 1
    assert all(r["count"]["kernels"] == {} for r in recs if "count" in r)
    dryrun.main()                    # a second run keeps what exists
    assert capsys.readouterr().out.count("[skip]") == 8


def test_chip_smoke_dry_run_phase_rehearses_on_cpu(monkeypatch):
    for fn in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    cfg = get_reduced("mamba2-130m")
    model, step = make_train_step(cfg, kernels="torch")
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = make_batch(cfg, B, S, "train", device="cpu")
    dry = {}
    cs.dry_run_call(torch, dry, "step", step,
                    (params, adamw_init(params), batch), 1.0, profile=False)
    cs.dry_run_phase(torch, dry, "CPU")
    dry["step"]["count"]["bytes"] += 1
    with pytest.raises(AssertionError, match="bytes on the card"):
        cs.dry_run_phase(torch, dry, "CPU")
