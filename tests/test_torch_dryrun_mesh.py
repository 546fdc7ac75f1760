"""The dry run of one PostSI wave of the node mesh
(``launch.dryrun_postsi``), on the CPU at 8 nodes x 64 keys, T = 32,
O = 8 (the reference's mix: 60% reads, 30% distributed txns).

* counted on ``meta`` it equals the same wave run on the CPU: FLOPs,
  bytes, aten ops, launches and memory; the wave makes no host sync;
* on the ``cuda`` route the meta trace counts what the card launches
  (``chip_smoke.mesh_wave_launches``): ``version_scan`` once a node a
  commit step plus once a node for the read phase, ``potential_matrix``
  once, the commit loop plain;
* ``main`` writes the record; ``chip_smoke.py``'s phase 9g mesh call
  (``mesh_wave_call``) traces on meta as it runs on the CPU.
"""
import json

import torch

from repro_torch.launch import dryrun_postsi
from repro_torch.launch.op_count import count_call
from test_torch_commit_loop import _chip_smoke

cs = _chip_smoke()
NODES, KPN, T, O = 8, 64, 32, 8


def test_mesh_wave_meta_trace_equals_a_cpu_run():
    torch.set_num_threads(1)
    meta = dryrun_postsi.wave_cell(NODES, KPN, T, O, "meta", "torch")
    real = dryrun_postsi.wave_cell(NODES, KPN, T, O, "cpu", "torch")
    assert meta["count"] == real["count"] and meta["memory"] == real["memory"]
    assert meta["count"]["kernels"] == {} and meta["count"]["bytes"] > 0
    assert (meta["kind"], meta["nodes"], meta["keys"]) == ("txn-wave", NODES,
                                                          NODES * KPN)
    assert meta["roofline"]["useful_flops_frac"] is None


def test_mesh_wave_on_the_cuda_route_counts_its_launches(tmp_path,
                                                         monkeypatch):
    torch.set_num_threads(1)
    out = tmp_path / "wave.json"
    monkeypatch.setattr("sys.argv", [
        "dryrun_postsi", "--nodes", str(NODES), "--keys-per-node", str(KPN),
        "--txns", str(T), "--ops", str(O), "--out", str(out)])
    dryrun_postsi.main()
    rec = json.loads(out.read_text())
    assert (rec["device"], rec["route"]) == ("meta", "cuda")
    got = {k: v["launches"] for k, v in rec["count"]["kernels"].items()}
    want = {k: v for k, v in cs.mesh_wave_launches("cuda", NODES, T, 1).items()
            if v}
    assert got == want == {"version_scan": NODES * (T + 1),
                           "potential_matrix": 1}


def test_chip_smoke_mesh_call_traces_on_meta():
    torch.set_num_threads(1)
    cfg = cs.Config(nodes=NODES, kpn=40, V=4, T=16)
    counts = [count_call(fn, *args, **kw)[1] for fn, args, kw in (
        cs.mesh_wave_call(torch, torch.device(d), cfg, "torch")
        for d in ("cpu", "meta"))]
    assert counts[0] == counts[1] and counts[0]["aten_ops"] > 0
