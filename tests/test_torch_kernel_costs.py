"""The kernels' cost formulas (each kernel module's ``*_cost``) and the
H100's peaks (``kernels.roofline``), held to ``PERF.md`` §6's kernel
table: every bound the table prints is reproduced to its printed digits
at the row's shape.  ``chip_smoke.py`` phase 3 and the dry run's counter
read these same functions.

The data-dependent counts are this run's data, as phase 3 takes them: the
read-phase rows' live reader keys (the timed wave's 60% reads leave the
byte bound standing), and row 6's distinct rows, installs and SID bumps of
the path's wave, computed here on the CPU exactly as phase 3 does on the
card (the plain loop run four times on the aged store, then counted on a
copy).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import LocalSubstrate, MVStore, wave_from_numpy
from repro_torch.core.engine import wave_read_phase
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.commit_loop import commit_loop_cost, commit_loop_plain
from repro_torch.kernels.interval_negotiate import potential_matrix_cost
from repro_torch.kernels.roofline import (ALU_OPS_PER_S, BF16_FLOPS_PER_S,
                                          bound, ops_rate)
from repro_torch.kernels.version_scan import version_scan_cost
from repro_torch.kernels.wave_commit import wave_commit_cost
from test_torch_commit_loop import _chip_smoke

cs = _chip_smoke()

BF16, F32 = torch.bfloat16, torch.float32
LIVE = 614          # reader keys >= 0 of the timed T=256, O=4 wave (60%)


def _ssd(H, N, dtype):
    """(BH, G, S, P, N, Q, dtype) of B=4, S=1,024 in chunks of 128, P=64,
    one group of heads a batch row: zamba2-2.7b (H=80, N=64) and
    mamba2-130m (H=24, N=128)."""
    return (4 * H, 4, 1024, 64, N, 128, dtype)


ZAMBA, MAMBA = _ssd(80, 64, BF16), _ssd(24, 128, BF16)
ATTN = {"zamba2": (4, 1024, 1024, 32, 32, 80),
        "qwen3-14b": (4, 1024, 1024, 40, 8, 128),
        "qwen2-0.5b": (4, 1024, 1024, 14, 2, 64)}
# (row, (operations, bytes), ops rate, printed bound ms, printed bound_by)
ROWS = [
    ("1", version_scan_cost(1024, 8), ALU_OPS_PER_S, "0.0000245", "bytes"),
    ("2", potential_matrix_cost(256, 4, LIVE), ALU_OPS_PER_S, "0.0000220",
     "bytes"),
    ("3", wave_commit_cost(256, 4, 8, LIVE), ALU_OPS_PER_S, "0.0000532",
     "bytes"),
    ("4", fa.flash_attention_cost(*ATTN["zamba2"]), BF16_FLOPS_PER_S,
     "0.02504", "bytes"),
    ("4'", fa.flash_attention_cost(*ATTN["qwen3-14b"]), BF16_FLOPS_PER_S,
     "0.04347", "operations"),
    ("4'''", fa.flash_attention_cost(*ATTN["qwen2-0.5b"]), BF16_FLOPS_PER_S,
     "0.00761", "operations"),
    ("4b", fa.flash_attention_bwd_dq_cost(*ATTN["qwen2-0.5b"]),
     BF16_FLOPS_PER_S, "0.01141", "operations"),
    ("4c", fa.flash_attention_bwd_dkdv_cost(*ATTN["qwen2-0.5b"]),
     BF16_FLOPS_PER_S, "0.01521", "operations"),
    ("5", ss.ssd_cost(*ZAMBA), BF16_FLOPS_PER_S, "0.02731", "bytes"),
    ("5''", ss.ssd_cost(*MAMBA), BF16_FLOPS_PER_S, "0.00919", "bytes"),
    ("5'' f32", ss.ssd_cost(*_ssd(24, 128, F32)), ALU_OPS_PER_S, "0.08442",
     "operations"),
    ("5'' f32 zamba2", ss.ssd_cost(*_ssd(80, 64, F32)), ALU_OPS_PER_S,
     "0.16089", "operations"),
    ("5b", ss.ssd_bwd_states_cost(*ZAMBA), BF16_FLOPS_PER_S, "0.02574",
     "bytes"),
    ("5b mamba2", ss.ssd_bwd_states_cost(*MAMBA), BF16_FLOPS_PER_S,
     "0.00826", "bytes"),
    ("5b'", ss.ssd_bwd_states_scan_cost(*ZAMBA), BF16_FLOPS_PER_S, "0.02731",
     "bytes"),
    ("5b' mamba2", ss.ssd_bwd_states_scan_cost(*MAMBA), BF16_FLOPS_PER_S,
     "0.00919", "bytes"),
    ("5c", ss.ssd_bwd_scan_cost(320, 8, 64, 64), ALU_OPS_PER_S, "0.00157",
     "bytes"),
    ("5c mamba2", ss.ssd_bwd_scan_cost(96, 8, 128, 64), ALU_OPS_PER_S,
     "0.00094", "bytes"),
    ("5d", ss.ssd_bwd_grads_cost(*ZAMBA), BF16_FLOPS_PER_S, "0.03897",
     "bytes"),
    ("5d mamba2", ss.ssd_bwd_grads_cost(*MAMBA), BF16_FLOPS_PER_S, "0.01276",
     "bytes"),
    ("5d whole", ss.ssd_bwd_cost(*ZAMBA), BF16_FLOPS_PER_S, "0.04053",
     "bytes"),
    ("5d whole mamba2", ss.ssd_bwd_cost(*MAMBA), BF16_FLOPS_PER_S, "0.01369",
     "bytes"),
]


def _printed(ms: float, digits: str) -> bool:
    """``ms`` rounds to the table's ``digits``."""
    places = len(digits.split(".")[1])
    return f"{ms:.{places}f}" == digits


@pytest.mark.parametrize("row,cost,rate,digits,by", ROWS,
                         ids=[r[0] for r in ROWS])
def test_bound_column_of_the_kernel_table(row, cost, rate, digits, by):
    ms, got_by = bound(cost[1], cost[0], rate)
    assert _printed(ms, digits) and got_by == by, (row, ms, got_by)


def test_commit_loop_bound_on_the_path_wave():
    """Row 6: 0.0000456 ms by bytes, phase 3's count on the card (152,784
    bytes in its log)."""
    torch.set_num_threads(1)
    dev = torch.device("cpu")
    _, n_keys, V, n_nodes, (wave,), _, _ = cs.commit_loop_cases(
        np, cs.Config())[-1]
    store = cs.aged_store(torch, np, np.random.RandomState(0), n_keys, V, dev)
    inputs = wave_read_phase(LocalSubstrate("torch", dev), store,
                             wave_from_numpy(wave, dev), 1, V + 2,
                             sched="postsi")
    kw = dict(sched="postsi", n_nodes=n_nodes, gc_track=True,
              gc_block=False)
    for _ in range(4):            # phase 3 times the plain loop 1 + 3 times
        commit_loop_plain(store, inputs, **kw)
    status, _, _, wcid, _, _ = commit_loop_plain(
        MVStore(*(t.clone() for t in store)), inputs, **kw)
    T, O = wave[0].shape
    n_ops, n_bytes = commit_loop_cost(T, O, V, *cs.path_wave_counts(
        np, wave, status.numpy(), wcid.numpy(), n_keys))
    assert n_bytes == 152_784
    ms, by = bound(n_bytes, n_ops)
    assert _printed(ms, "0.0000456") and by == "bytes"


def test_shape_only_costs_bound_the_data_counts():
    """Without data counts the formulas take what the shapes allow: every
    reader key live, every op a distinct row, an install and a bump."""
    T, O, V = 256, 4, 8
    assert potential_matrix_cost(T, O) == potential_matrix_cost(T, O, T * O)
    assert wave_commit_cost(T, O, V)[0] >= wave_commit_cost(T, O, V, LIVE)[0]
    assert commit_loop_cost(T, O, V) == commit_loop_cost(T, O, V, T * O,
                                                         T * O, T * O)
    assert commit_loop_cost(T, O, V)[1] > commit_loop_cost(
        T, O, V, 437, 0, 130)[1]


def test_rates_and_dtypes():
    assert ops_rate(BF16) == BF16_FLOPS_PER_S == 989e12
    assert ops_rate(torch.float32) == ops_rate(torch.int32) == 67e12
    assert cs.HBM_BYTES_PER_S == 3.35e12 and cs.bound is bound
    # causal pairs: query i sees keys 0..i, aligned top-left
    assert fa.flash_attention_cost(1, 3, 3, 1, 1, 16)[0] == 4 * 6 * 16
    assert fa.flash_attention_cost(1, 4, 2, 1, 1, 16)[0] == 4 * 7 * 16
    assert fa.flash_attention_cost(1, 2, 5, 1, 1, 16, False)[0] == \
        4 * 10 * 16
    # the float32 lse a training forward writes
    assert fa.flash_attention_cost(2, 8, 8, 4, 2, 16, with_lse=True)[1] - \
        fa.flash_attention_cost(2, 8, 8, 4, 2, 16)[1] == 2 * 4 * 8 * 4
    # the whole backward: both kernels' products, lse and delta once
    dq, dkdv = (f(*ATTN["qwen2-0.5b"]) for f in (
        fa.flash_attention_bwd_dq_cost, fa.flash_attention_bwd_dkdv_cost))
    whole = fa.flash_attention_bwd_cost(*ATTN["qwen2-0.5b"])
    assert whole[0] * 14 == (dq[0] + dkdv[0]) * 10      # 5 of 7 products
