"""Phase 4q of ``chip_smoke.py`` rehearsed on the CPU at a small size.

``process_planes_phase`` runs as on the card, on 4 ``gloo`` ranks over
the CPU and the ``torch`` / ``torch+fused`` routes: two spawns, the
durable session equal to the emulated mesh's (WAL bytes included), the
``drop_node`` crash a prefix of it, the elastic deployment with replicas
equal to the emulated mesh's, the hybrid planner session equal to one
device's, the fresh ranks' recoveries equal to the live store and the
crashed log taken up and served on as one device does.  Every check of
the phase runs but the launch counts, which need the card.
"""
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke
    return chip_smoke


def test_chip_smoke_process_planes_phase_rehearses_on_cpu(chip_smoke,
                                                          capsys):
    # the rate and wave size at which the hybrid session plans a wave in
    # its PROCESS_PLANNER_TICKS ticks, as the card's configuration does
    cfg = chip_smoke.Config(nodes=4, kpn=40, V=4, T=16, service_T=16,
                            rate=16.0, process_ticks=6)
    totals = chip_smoke.process_planes_phase(
        torch, torch.device("cpu"), cfg, "CPU",
        routes=("torch", "torch+fused"))
    out = capsys.readouterr().out
    for label in ("durable", "elastic", "planner"):
        assert f"[process] 4q {label} [torch] on 4 ranks" in out, label
    assert "equals the emulated mesh's byte for byte" in out
    assert "a prefix of the fault-free log" in out
    assert out.count("on 4 fresh ranks") == 3
    assert "equal to one device taking up a copy" in out
    assert totals == dict.fromkeys(chip_smoke.LAUNCH_KEYS, 0)


def test_process_phase_depth_flags(chip_smoke):
    cfg = chip_smoke.parse_config(["--process-ticks", "4"])
    assert cfg.process_ticks == 4
    full = chip_smoke.parse_config([])
    assert full.process_ticks == full.mesh_ticks


def test_rank_launches_count_a_wave_as_the_emulated_mesh_node(chip_smoke):
    """One rank's launches for one wave of T rows are one node's of the
    emulated mesh (``mesh_wave_launches(route, 1, T, 1)``); a merged read
    adds one ``version_scan``."""
    for route in ("cuda", "cuda+fused"):
        for T in (1, 64, 256):
            assert chip_smoke.rank_launches(route, 1, T) == \
                chip_smoke.mesh_wave_launches(route, 1, T, 1)
        want = chip_smoke.rank_launches(route, 3, 192)
        got = chip_smoke.rank_launches(route, 3, 192, reads=2)
        assert got["version_scan"] == want["version_scan"] + 2
