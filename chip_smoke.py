#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

Run from the repository root, with one CUDA device:

    python3 chip_smoke.py

Phases (any failure raises, so the process exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc),
   then disassemble the library (``cuobjdump -sass``): every bf16
   instantiation of ``flash_attention`` and ``ssd_scan`` must run
   tensor-core (HMMA / HGMMA) instructions;
3. each engine kernel against its plain PyTorch version on the card,
   bit-equal, at the main path's shapes and on adversarial inputs
   (the read-phase corners: tied visible CIDs, empty rings, V = 1 / 3 /
   16 / 40, O = 12, T = 1 and ragged T, pad keys 0 / -1 / hot / past the
   last row; ``version_scan`` also at ragged M),
   with CUDA-event times of both; the read-phase kernels' device ms from
   the profiler, warm (one key set) and with cold rows (a rotating pool of
   key sets over the whole store, ``scripts/read_phase_ab.py``), beside an
   empty kernel's (the launch floor) and their bound restated as the larger
   of bytes over the memory rate and dependent device-memory round trips x
   one round trip (a pointer chase over 256 MB, ``scripts/probes.py``);
   the model plane's ``flash_attention`` and
   ``ssd_scan`` likewise, within their tolerances, at the serve path's
   shapes plus ragged, GQA, non-causal, initial-state, float32, 128-row
   q tile, N=128, model-layout and slow-decay cases, each bf16 output also
   against its plain version in float32 on the same inputs, the element
   closest to its limit printed per check, with
   ``scaled_dot_product_attention`` timed beside attention as a yardstick
   (never called by the port); ``commit_loop`` against the engine's plain
   loop, bit-equal in its outputs and the store, for the six schedulers x
   {no GC, ``gc_track``, ``gc_block``} on corner waves (V=2 rings read and
   read-modify-written in one wave, duplicate write keys, T=1, T=33, O=12,
   T=1040 past the shared-memory budget, placement with clocksi skew,
   negative and out-of-range rows on live ops, -1 and n - 1 written by one
   txn, V=1 where every install overwrites the slot read, one hot key under
   a T=256 wave, and T=256 O=4 at the largest V that stages and the next)
   and on a
   wave of the engine path (T=256 over the 1,000,000-account store), in the
   variant the wrapper picks (``staged`` or ``global``) and, where that is
   ``staged``, in ``global`` too; CUDA-event times of both variants and the
   plain loop there, and the wrapper's host time a call at T=1;
   one profiled postsi wave on each CUDA route, with its launches (one
   ``commit_loop`` a wave);
4. engine: 8 SmallBank waves of T=256 over a 1,000,000-account store
   (8 nodes x 125,000 accounts, V=8, 20% distributed) through
   ``run_workload_fused`` for all six schedulers under the ``cuda``,
   ``cuda+fused``, ``torch`` and ``torch+fused`` routes; every route equal
   to ``torch`` bit for bit, histories verified; each CUDA route launches
   ``commit_loop`` once a wave and ``version_scan`` once a wave on ``cuda``
   (the read phase), never on ``cuda+fused``;
5. service: a Poisson SmallBank stream through ``TxnService`` over the same
   1,000,000 accounts, ``verify() == []``, under ``torch``, ``cuda`` and
   ``cuda+fused``; the CUDA routes' request fates, histories and final
   stores equal the ``torch`` route's; then the streaming plane and the
   planner on the same store size:

   * the dispatch check: ``torch.cuda.set_sync_debug_mode("error")`` is
     shown to raise on a known blocking copy, then every block dispatch of
     every ``cuda`` / ``cuda+fused`` streaming session below
     (``TxnService._run_block``) runs under it, and their count is printed;
   * ``run_streaming`` at B=1, K=1 on ``cuda`` equals the ``cuda`` step
     loop above (fates, histories, final store); at B=4, K=2 with the
     adaptive sizer on ``torch``, ``cuda`` and ``cuda+fused``, the CUDA
     routes equal to ``torch``; each route's goodput, blocks, waves, wall
     time and the sizer's final T and B;
   * the planner: ``run_workload_planned`` (base postsi) over SmallBank
     waves of T=256 with a hotspot (``hot_frac=0.5``, 4 hot keys a node)
     with zero aborts, the CUDA routes equal to ``torch`` and the
     committed values equal to ``core/seq.py``'s; a
     ``planner="planned"`` stream with no retry and no spill; a
     ``planner="hybrid"`` ``run_streaming`` (B=2, K=2) on YCSB at
     theta=0.99 with 10% reads, ``cuda`` equal to ``torch``;

   5c. durability, on the same stream, each durable directory a fresh
   temporary one:

   * durable serving: ``run_streaming`` B=4, K=2 (``sizer="auto"``) on
     ``cuda`` with ``DurabilityManager(fsync_every=1, snapshot_every=4)``
     equals the non-durable ``cuda`` session of phase 5 (fates,
     histories, final store); its block dispatches run under sync debug
     mode "error" and count in the dispatch check;
   * recovery: a clean restart on that directory recovers from its
     snapshot and serves 2 more ticks, stopping short of the next
     snapshot; then ``recover()`` of the directory on ``cuda`` and
     ``cuda+fused`` from the snapshot plus the WAL suffix and by full
     replay, and on ``torch`` by full replay; each equals the live store,
     clock, wave index, GC clock and next TID bit for bit, the full
     replays equal ``torch``'s wave by wave, and each CUDA replay launches
     ``commit_loop`` once a replayed wave (``version_scan`` once a wave on
     ``cuda``);
   * crash and restart: the same stream under a kill after the 6th log
     record and a 40-byte tear; the crashed log is a bit-identical prefix
     of the durable one; a new ``cuda`` service on the directory
     recovers it, the requests neither acked nor committed in the log are
     resubmitted and drained: nothing commits twice, every acked commit is
     in the log, ``verify() == []``; the directory then recovers to the
     restarted service on both CUDA routes;
   * printed, not claimed: WAL append + fsync host ms a block (median),
     snapshot save ms and bytes, recovery seconds split into scan,
     snapshot restore and replay, replayed waves/s per route, and the
     durable session's goodput beside the non-durable one's;
   5d. elastic placement, at full width: the 1,000,000 keys of phase 5
   laid out by ``PlacementMap(1_000_000, 8, headroom=2)`` (2,000,000
   physical rows, the free ones empty), served with the reference's
   elastic deployment (``benchmarks/bench_dist.py``: YCSB theta=0.99, 97%
   reads, 2 ops a txn, 3 x T = 192 arrivals a tick for 20 ticks at T=64,
   ``replica_refresh=8``, the replica set of ``zipf_hot_keys(8, 125_000,
   0.99, mass=0.95, max_frac=0.4)``); first, outside the counted path,
   a wave with live reads and padding on key -1 and past the last key
   over the placed store, before and after a move that fills the last
   physical row, equal on both CUDA routes to ``torch`` (wave and store);
   then:

   * elastic = static: placement and ``balancer=True``, plus an explicit
     ``move_range(0, 31_250, 1)`` at tick 10, on ``cuda`` and
     ``cuda+fused``: moves made, fates, history rows and the logical store
     equal to the static ``cuda`` session on the same stream,
     ``verify() == []``, one ``commit_loop`` launch a wave (one
     ``version_scan`` a wave on ``cuda``, none on ``cuda+fused``);
   * replicas: the same with the replica set on: replica commits made,
     ``max_cid() <= floor`` after every refresh, ``verify() == []``,
     ``cuda`` equal to ``cuda+fused``; and ``torch`` equal to ``cuda``
     over the first 6 ticks (the explicit move at tick 3);
   * streaming: ``run_streaming(B=4, K=2)`` under the placement on
     ``cuda``, every block dispatch under sync debug mode "error", equal
     to the static B=4, K=2 session (fates, histories, logical store) and
     committing the placed step loop's request set;
   * durable: the first session with ``DurabilityManager(fsync_every=1,
     snapshot_every=2)`` equals the non-durable one and recovers on
     ``cuda`` (snapshot) and ``cuda+fused`` (full replay) to the live
     store, ``slot`` and ``owner``; a session crashed right after its
     first REC_MOVE record (the explicit move at tick 3) recovers on
     ``cuda``, ``cuda+fused`` and ``torch`` to the live state at the
     crash; a restarted service adopts the replayed map, serves 2 more
     ticks and verifies;
   * printed, not claimed, each line with the card's name and power
     limit: ms and keys of each move, ms of each replica refresh, goodput
     of elastic against static on each CUDA route, the balancer's load
     imbalance before and after each move, occupancy, replica-served
     reads, recovery seconds;
   4m. the engine on the node mesh: phase 4's store sharded over
   ``make_node_mesh(8)`` (125,000 rows a node; the nodes emulated as the
   leading dimension of a view of the one store), ``--mesh-waves`` of
   phase 4's waves for all six schedulers through
   ``run_workload_fused_dist`` and ``run_workload_dist`` on ``cuda`` and
   ``cuda+fused``, each equal to the single-device ``cuda`` run (WaveOut,
   stats, store), ms a wave beside the single device's; launches a mesh
   wave asserted: ``version_scan`` N (T + 1) = 2,056 and
   ``potential_matrix`` 1 on ``cuda``, ``wave_commit`` 8 and
   ``version_scan`` N T = 2,048 on ``cuda+fused``, ``commit_loop`` 0 (the
   mesh runs the plain commit loop); one postsi wave on the mesh's
   ``torch`` route equal to it too;
   5m. the service on the node mesh, phase 5's stream for ``--mesh-ticks``
   ticks: ``TxnService(mesh=...)`` on both CUDA routes equal to the
   single-device ``cuda`` session (fates, history, store), ``verify() ==
   []``, goodput beside the single device's; ``run_streaming`` B=4, K=2 on
   the mesh equal to the single-device B=4, K=2 session, every mesh block
   dispatch under sync debug mode "error"; a durable mesh session
   (``fsync_every=1``, ``snapshot_every=4``) recovered onto the mesh on
   ``cuda`` (from the snapshot and by full replay) and onto one device on
   ``cuda+fused`` by full replay, each
   equal to the live state; phase 5d's elastic deployment on the mesh
   (2,000,000 rows, the balancer, one explicit ``move_range``) equal to
   the static mesh session; the mesh phases' launches on a line of their
   own (not in the kernels line);
6. serve: zamba2-2.7b at full width (2.42 B parameters, random weights
   from a seeded generator on the card) behind ``launch.serve.Server`` on
   the ``cuda`` route, batch 4: 3 batches (prompts of 1,024, 1,024 and
   1,000 tokens, 16 new tokens each) with a second weight version
   published after the first, one version per batch (0, 1, 1); then
   prefill/decode times, a profile of one prefill, every kernel call of
   one prefill held to its plain version on the same activations (and,
   in bf16, to the float32 one), and
   every batch again on the ``cuda`` and the ``torch`` route
   teacher-forced with the served tokens: in float32 compute the logits
   agree within 1e-3 * scale at every step; the bf16 distance is printed
   beside each route's own bf16-vs-float32 distance;
7. one JSON line of per-kernel results, with the launches each kernel made
   on its own path (phases 4-5d for the engine's, the streamed, planned,
   durable, replayed and placed runs included, the served batches of phase 6 for
   the model plane's;
   each must be > 0), the card line again,
   and last ``{"ok": true, "device": {...}}``.

The store, wave, stream and model sizes are fixed (the constants below);
the flags cut only the depth: ``--waves``, ``--scheds``, ``--ticks``,
``--planned-waves``, ``--elastic-ticks``, ``--mesh-waves``,
``--mesh-ticks``, ``--serve-batches`` and ``--new-tokens``.

Without a CUDA device, or in a directory that does not hold the repository,
it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, the non-tensor-core
# 32-bit rate (taken for the engine kernels' integer compares) and the dense
# bf16 tensor rate (taken for the model kernels' bf16 products)
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

# the serve phase: model, batch and prompt lengths (fixed)
SERVE_ARCH = "zamba2-2.7b"
SERVE_BATCH = 4
SERVE_PROMPTS = (1024, 1024, 1000)


class Config(NamedTuple):
    """The run's sizes.  The defaults are the configuration the smoke run
    holds the port to: SmallBank at BenchBase's default 1,000,000 accounts
    (``SmallBankConstants.NUM_ACCOUNTS``), one key per account over 8 nodes,
    V=8 versions, waves of T=256 with 20% distributed txns, and a service
    stream of 48 arrivals/tick at T=64."""
    nodes: int = 8
    kpn: int = 125_000             # keys (accounts) per node
    V: int = 8
    T: int = 256
    O: int = 4                     # SmallBank ops per txn
    service_T: int = 64
    rate: float = 48.0             # Poisson arrivals per tick
    seed: int = 0
    waves: int = 8                 # cut from 16 to make room for 4m, 5m
    scheds: str = "all"
    ticks: int = 32
    serve_batches: int = 3         # of SERVE_PROMPTS
    new_tokens: int = 16
    planned_waves: int = 2         # hot SmallBank waves the planner replays
    elastic_ticks: int = 20        # ticks of phase 5d's elastic stream
    mesh_waves: int = 2            # waves a scheduler and route, phase 4m
    mesh_ticks: int = 8            # ticks of phase 5m's mesh sessions


KERNELS = {
    "version_scan": ("src/repro_torch/kernels/csrc/version_scan.cu",
                     "src/repro/kernels/version_scan.py:41"),
    "potential_matrix": ("src/repro_torch/kernels/csrc/interval_negotiate.cu",
                         "src/repro/kernels/interval_negotiate.py:39"),
    "wave_commit": ("src/repro_torch/kernels/csrc/wave_commit.cu",
                    "src/repro/kernels/wave_commit.py:90"),
    "commit_loop": ("src/repro_torch/kernels/csrc/commit_loop.cu",
                    "src/repro/core/engine.py:264"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:74"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:67"),
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def bound(n_bytes: float, n_ops: float, ops_per_s: float = ALU_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over ``ops_per_s``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(torch, fn, iters=200, warmup=10) -> float:
    """Mean ms per call over ``iters`` back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(torch, got, want) -> int:
    """Largest |got - want| over every output tensor (0 = bit-equal)."""
    err = 0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"shape/dtype {a.shape}/{a.dtype} vs "
                                 f"{b.shape}/{b.dtype}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


# (T, O, V) of the read-phase corner cases: T = 1 and T not a multiple of
# 4 (the potential matrix's byte stores on a ragged tail), O = 12 (s_lo0
# through shared memory), V = 1 and 3 (lanes an op past V), V = 16 (a
# group of 16 lanes) and V = 40 (a lane holding two slots), each with the
# pad keys 0 / -1 / a hot row / past the last row
READ_CORNERS = ((1, 1, 1), (40, 4, 8), (130, 5, 3), (256, 4, 8),
                (1024, 12, 8), (256, 12, 2), (40, 1, 2), (130, 12, 1),
                (1024, 4, 3), (64, 2, 16), (33, 3, 40))
CORNER_ROWS = 64
CORNER_PADS = (0, -1, 5, CORNER_ROWS + 3)


def read_phase_corner(np, T, O, V, pad):
    """One corner of the read phase as numpy arrays: ((cid, tid, sid, val)
    [CORNER_ROWS, V] int32, keys, max_cid, read_key, write_key [T, O]
    int32, rvalid [T, O] bool).  CIDs come from [0, 4), so visible slots
    tie and the first must win (>= 0 as a store's: the reference's Pallas
    kernel pads V and O with slots and ops that read as -1 and 0, and
    leaves its own plain version on a negative CID); every eighth row is
    empty and some ceilings are -1, so rings have no visible slot; every
    fifth key is ``pad``, and 64 rows make hot rows and matching keys."""
    rng = np.random.RandomState(1000 * T + 100 * O + 10 * V + pad % 97)
    i32 = lambda a: np.asarray(a, np.int32)
    shape = (CORNER_ROWS, V)
    tid = np.where(rng.rand(*shape) < 0.3, -1, rng.randint(1, 99, shape))
    tid[::8] = -1
    tables = (i32(rng.randint(0, 4, shape)), i32(tid),
              i32(rng.randint(0, 40, shape)), i32(rng.randint(-99, 99, shape)))
    keys = rng.randint(0, CORNER_ROWS, (T, O))
    keys.reshape(-1)[::5] = pad
    is_r, is_w = rng.rand(T, O) < 0.5, rng.rand(T, O) < 0.4
    return (tables, i32(keys), i32(rng.randint(-1, 4, (T, O))),
            i32(np.where(is_r, keys, -1)), i32(np.where(is_w, keys, -1)),
            is_r)


# ---------------------------------------------------------------- phase 3
def kernel_phase(torch, dev, n_keys, V, T, O):
    """Each kernel vs its plain version on the card; returns per-kernel
    records of the main-path shape (T*O requests, a T-txn wave) and the
    store tables they ran on (for ``engine_device_ms``)."""
    from repro_torch.kernels.interval_negotiate import (
        potential_matrix_cuda, potential_matrix_ref)
    from repro_torch.kernels.version_scan import (version_scan_cuda,
                                                  version_scan_plain)
    from repro_torch.kernels.wave_commit import (wave_commit_cuda,
                                                 wave_commit_plain)
    g = torch.Generator(device=dev).manual_seed(0)
    i32 = dict(dtype=torch.int32, device=dev)
    ri = lambda lo, hi, shape: torch.randint(lo, hi, shape, generator=g,
                                             **i32)
    # a live-looking store: per-ring CIDs unique and >= 0, 30% empty slots
    cid = (torch.rand((n_keys, V), generator=g, device=dev).argsort(1) * 3
           + ri(0, 3, (n_keys, 1))).to(torch.int32).contiguous()
    tid = torch.where(torch.rand((n_keys, V), generator=g, device=dev) < 0.3,
                      -1, ri(1, 1 << 20, (n_keys, V))).to(torch.int32)
    sid, val = ri(0, 1 << 16, (n_keys, V)), ri(-1000, 1000, (n_keys, V))
    hot = 5

    def keys_for(shape, pad):
        k = ri(0, n_keys, shape)
        flat = k.view(-1)
        flat[::7] = pad                      # NOP padding / hot key
        return k

    records, checks = {}, []

    def check(name, got, want, label):
        err = max_abs_err(torch, got, want)
        checks.append((name, label, err))
        if err:
            raise AssertionError(f"{name} [{label}] differs from its plain "
                                 f"version: max_abs_err={err}")
        return err

    # version_scan: M = T*O on the read phase, and ragged M (groups of V
    # lanes past M stay idle in the kernel)
    for M in (T * O, O, 40, 1, T * O + 1):
        for pad in (0, -1, hot):
            k = keys_for((M,), pad)
            mc = ri(-1, 3 * V, (M,))               # incl. all-invisible rows
            args = (cid, tid, mc, k)
            check("version_scan", version_scan_cuda(*args),
                  version_scan_plain(*args), f"M={M} pad={pad}")
    mc_none = torch.full((T * O,), -1, **i32)     # every row invisible
    k = keys_for((T * O,), 0)
    check("version_scan", version_scan_cuda(cid, tid, mc_none, k),
          version_scan_plain(cid, tid, mc_none, k), "all-invisible")
    # potential_matrix at T in {64, 256} and a ragged 130
    for Tp in (64, T, 130, 40):
        kk = ri(0, 64, (Tp, O))
        rk = torch.where(torch.rand((Tp, O), generator=g, device=dev) < 0.5,
                         kk, -1).to(torch.int32)
        wk = torch.where(torch.rand((Tp, O), generator=g, device=dev) < 0.4,
                         kk, -1).to(torch.int32)
        rk[::3] = -1                                # interleaved NOP rows
        wk[::3] = -1
        check("potential_matrix", (potential_matrix_cuda(rk, wk),),
              (potential_matrix_ref(rk, wk),), f"T={Tp}")
    # wave_commit over the store tables
    for Tw in (T, 130, 40):
        for pad in (0, -1, hot):
            k = keys_for((Tw, O), pad)
            mc = ri(-1, 3 * V, (Tw, O))
            is_r = torch.rand((Tw, O), generator=g, device=dev) < 0.5
            is_w = torch.rand((Tw, O), generator=g, device=dev) < 0.4
            rk = torch.where(is_r, k, -1).to(torch.int32)
            wk = torch.where(is_w, k, -1).to(torch.int32)
            args = (cid, tid, sid, val, mc, rk, wk, is_r)
            check("wave_commit", wave_commit_cuda(*args, keys=k),
                  wave_commit_plain(*args, keys=k), f"T={Tw} pad={pad}")
    # the read-phase corners: ties, empty rings, V = 1 / 3 / 16 / 40,
    # O = 12, T = 1 and ragged T, pad keys 0 / -1 / hot / past the last row
    import numpy as np
    for Tc, Oc, Vc in READ_CORNERS:
        for pad in CORNER_PADS:
            tabs, k, mc, rk, wk, rv = (
                [torch.as_tensor(a, device=dev) for a in x]
                if isinstance(x, tuple) else torch.as_tensor(x, device=dev)
                for x in read_phase_corner(np, Tc, Oc, Vc, pad))
            label = f"corner T={Tc} O={Oc} V={Vc} pad={pad}"
            args = (*tabs, mc, rk, wk, rv)
            check("wave_commit", wave_commit_cuda(*args, keys=k),
                  wave_commit_plain(*args, keys=k), label)
            check("potential_matrix", (potential_matrix_cuda(rk, wk),),
                  (potential_matrix_ref(rk, wk),), label)
            flat = (tabs[0], tabs[1], mc.view(-1), k.view(-1))
            check("version_scan", version_scan_cuda(*flat),
                  version_scan_plain(*flat), label)
    torch.cuda.synchronize()
    print(f"[kernels] {len(checks)} checks, all bit-equal to the plain "
          f"versions ({3 * len(READ_CORNERS) * len(CORNER_PADS)} of them "
          f"on the read-phase corners)", flush=True)

    # times at the main path's shapes
    M = T * O
    k = keys_for((M,), 0)
    mc = torch.full((M,), 1 << 30, **i32)
    vs = (cid, tid, mc, k)
    ms = {}
    ms["version_scan"] = (cuda_ms(torch, lambda: version_scan_cuda(*vs)),
                          cuda_ms(torch, lambda: version_scan_plain(*vs)))
    kw = k.view(T, O)
    is_r = torch.rand((T, O), generator=g, device=dev) < 0.6
    is_w = torch.rand((T, O), generator=g, device=dev) < 0.5
    rk = torch.where(is_r, kw, -1).to(torch.int32)
    wk = torch.where(is_w, kw, -1).to(torch.int32)
    ms["potential_matrix"] = (
        cuda_ms(torch, lambda: potential_matrix_cuda(rk, wk)),
        cuda_ms(torch, lambda: potential_matrix_ref(rk, wk)))
    wc = (cid, tid, sid, val, mc.view(T, O), rk, wk, is_r)
    ms["wave_commit"] = (
        cuda_ms(torch, lambda: wave_commit_cuda(*wc, keys=kw)),
        cuda_ms(torch, lambda: wave_commit_plain(*wc, keys=kw)))
    # bytes: each input read once (ring rows of cid/tid, val/sid at the
    # chosen slot), each output written once; operations: compares and
    # selects, the potential tile's only for the reader keys >= 0 that this
    # run's data holds (inactive reader keys are skipped)
    pairs = 2 * T * O * int((rk >= 0).sum())
    work = {
        "version_scan": (M * (4 + 4 + 2 * 4 * V + 2 * 4), 3 * M * V),
        "potential_matrix": (2 * T * O * 4 + T * T, pairs),
        "wave_commit": (T * O * (4 * 4 + 1 + 2 * 4 * V + 2 * 4 + 5 * 4)
                        + T * 4 + T * T, 3 * T * O * V + pairs),
    }
    for name, (k_ms, p_ms) in ms.items():
        b_ms, b_by = bound(*work[name])
        records[name] = {
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": 0,
            "max_abs_err": max(e for n, _, e in checks if n == name),
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}
        print(f"[kernels] {name}: {k_ms:.5f} ms/call (plain {p_ms:.5f}), "
              f"bound {b_ms:.6f} ms by {b_by}", flush=True)
    return records, (cid, tid, sid, val)


def start_profiler(tag):
    """A started ``torch.profiler`` session tracing the CPU and the card, or
    None where the profiler cannot start.  Only the profiler is guarded:
    the work run under it is not, so a failed launch still raises."""
    from torch.profiler import ProfilerActivity, profile
    try:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
        return prof
    except Exception as exc:           # the profiler is optional here
        print(f"[{tag}] profiler unavailable: {exc!r}", flush=True)
        return None


def stop_profiler(prof, tag):
    """Stop ``prof``; True when its events can be read."""
    if prof is None:
        return False
    try:
        prof.stop()
        return True
    except Exception as exc:           # the profiler is optional here
        print(f"[{tag}] profiler unavailable: {exc!r}", flush=True)
        return False


def kernel_of(symbol: str):
    """The kernel (a key of KERNELS) whose CUDA function ``symbol`` (a
    demangled profiler key or a mangled SASS name) is, else None.  Each is
    ``<name>_kernel``, ``<name>_mma_kernel`` (bf16, tensor cores) or
    ``<name>_fma_kernel`` (float32)."""
    for name in KERNELS:
        if any(f"{name}{kind}_kernel" in symbol
               for kind in ("", "_mma", "_fma")):
            return name
    return None


def tensor_core_counts(sass: str) -> dict:
    """``cuobjdump -sass`` text -> {function: count of HMMA / HGMMA
    instructions} for every function of the model kernels."""
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            fn = fn if kernel_of(fn) in ("flash_attention", "ssd_scan") \
                else None
            if fn:
                counts[fn] = 0
        elif fn and ("HMMA" in line or "HGMMA" in line):
            counts[fn] += 1
    return counts


def tensor_core_check(lib_path, nvcc):
    """Disassemble the built library; raise unless every bf16 instantiation
    of flash_attention and ssd_scan (``*_mma_kernel``) runs tensor-core
    instructions.  Prints the counts per kernel and dtype."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], check=True,
                          capture_output=True, text=True).stdout
    counts = tensor_core_counts(sass)
    for name in ("flash_attention", "ssd_scan"):
        for kind in ("mma", "fma"):
            got = {f: n for f, n in counts.items()
                   if kernel_of(f) == name and f"_{kind}_kernel" in f}
            print(f"[build] {name} {'bf16' if kind == 'mma' else 'float32'}"
                  f": {len(got)} instantiations, HMMA/HGMMA per "
                  f"instantiation {sorted(got.values())}", flush=True)
            if kind == "mma" and (not got or min(got.values()) == 0):
                raise AssertionError(f"{name}: a bf16 instantiation runs no "
                                     f"tensor-core instruction")


def scripts_module(name: str):
    """A measurement module of the repository's ``scripts/``."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


# dependent device-memory round trips of the read-phase kernels: the key,
# then the ring row it names (version_scan, wave_commit); the keys, then
# the stores (potential_matrix)
ROUND_TRIPS = {"version_scan": 2, "potential_matrix": 1, "wave_commit": 2}


def engine_device_ms(torch, tables, records, loop_fn, T, O):
    """Kernel-only device ms a launch from the profiler, recorded as
    ``device_ms`` (None where the profiler shows no device time), beside
    the launch floor, an empty kernel's device time in the same session:
    the engine kernels on one input set (warm: their rows stay in L2);
    then the read-phase kernels on a rotating pool of key sets over the
    whole store (cold rows, as an engine wave's; ``device_ms_cold``)
    (``scripts/read_phase_ab.py``).  Each read-phase kernel's bound,
    restated as the larger of its bytes over the memory rate and its
    dependent device-memory round trips x one round trip (a pointer chase
    over 256 MB, beyond the 50 MB L2, in this run), is printed and
    recorded as ``latency_bound_ms``; the JSON's ``bound_ms`` stays the
    bytes-or-operations bound."""
    probes = scripts_module("probes")
    ab = scripts_module("read_phase_ab")
    lib = probes.build_probes()
    warm, cold = ab.calls(tables, T, O)
    got = ab.measure(lib, warm, cold, extra={
        "commit_loop": (loop_fn, "commit_loop_kernel")})
    trip_ns = probes.chase_ns(lib, 256 << 20, 20_000, warm=False)
    floor = {k: got[k]["empty"] for k in got}
    print(f"[kernels] launch floor (an empty kernel's device ms, same "
          f"sessions): warm {floor['warm']}, cold {floor['cold']}; one "
          f"dependent device-memory round trip {trip_ns:.1f} ns (chase over "
          f"256 MB)", flush=True)
    for name, rec in records.items():
        rec["device_ms"] = got["warm"][name]
        if name not in ROUND_TRIPS:
            continue
        rec["device_ms_cold"] = got["cold"][name]
        lat = ROUND_TRIPS[name] * trip_ns * 1e-6
        rec["latency_bound_ms"] = max(rec["bound_ms"], lat)
        rec["launch_floor_ms"] = floor["cold"]
        by = ("bytes" if rec["bound_ms"] >= lat else
              f"latency, {ROUND_TRIPS[name]} dependent round trips")
        cold_ms = rec["device_ms_cold"]
        share = (f"{100 * rec['latency_bound_ms'] / cold_ms:.1f}% of cold"
                 if cold_ms else "share not measured")
        print(f"[kernels] {name}: device ms warm {rec['device_ms']}, cold "
              f"{cold_ms}; bound restated max(bytes {rec['bound_ms']:.7f},"
              f" {ROUND_TRIPS[name]} x {trip_ns:.1f} ns) = "
              f"{rec['latency_bound_ms']:.7f} ms by {by} ({share}); launch "
              f"floor {floor['cold']} ms", flush=True)
    print("[kernels] profiler device ms/launch (warm): "
          + ", ".join(f"{n}={r['device_ms']}" for n, r in records.items()),
          flush=True)


# ------------------------------------------------- phase 3, commit loop
def aged_store(torch, np, rng, n_keys, V, dev):
    """A store whose rings have wrapped: V + 1 rounds of installs on random
    halves of the keys (CIDs 1..V+1, creator TIDs that collide with the
    waves' own), SIDs random below 4."""
    from repro_torch.core import install_version, make_store
    store = make_store(n_keys, V, device=dev)
    for r in range(V + 1):
        ks = rng.choice(n_keys, size=max(n_keys // 2, 1), replace=False)
        install_version(store, ks, rng.randint(-50, 50, ks.size), 1 + r,
                        1 + r, r)
    store.sid.copy_(torch.as_tensor(rng.randint(0, 4, tuple(store.sid.shape)),
                                    dtype=torch.int32, device=dev))
    return store


def commit_loop_cases(np, cfg):
    """(label, n_keys, V, n_nodes, numpy waves, host_skew, placement) of
    the waves ``commit_loop`` is held to its plain version on: the corners
    where a slip shows, then one wave of the engine path."""
    from repro_torch.core import wave_to_numpy
    from repro_torch.core import workloads as tw
    from repro_torch.kernels.commit_loop import commit_loop_smem_bytes
    rng = np.random.RandomState(11)
    i32 = lambda a: np.asarray(a, np.int32)

    def wave(kind, key, val, tid0):
        T = kind.shape[0]
        return (i32(kind), i32(key), i32(val), i32(rng.randint(0, 4, T)),
                i32(tid0 + np.arange(T)))

    def gen(fn, *args, **kw):
        return [tuple(np.asarray(a) for a in wave_to_numpy(w))
                for w in fn(rng, *args, device="cpu", **kw)]

    rmw = []                # every other txn reads k, then RMWs k
    for w in range(2):
        kind, key = rng.randint(0, 4, (12, 3)), rng.randint(0, 6, (12, 3))
        kind[::2, 0], kind[::2, 1], key[::2, 1] = 1, 3, key[::2, 0]
        rmw.append(wave(kind, key, rng.randint(1, 9, (12, 3)), 1 + 12 * w))
    kind, key = rng.randint(0, 4, (16, 4)), rng.randint(0, 8, (16, 4))
    kind[:, 1], key[:, 1] = 2, key[:, 0]          # a second write of key 0
    kind[::3, 2], key[::3, 2] = 3, key[::3, 0]    # and an RMW of it
    dup = [wave(kind, key, rng.randint(-9, 9, (16, 4)), 40)]
    n_keys = cfg.nodes * cfg.kpn
    path = [tuple(np.asarray(a) for a in wave_to_numpy(w))
            for w in tw.smallbank_waves(np.random.RandomState(cfg.seed + 4),
                                        1, cfg.T, cfg.nodes, cfg.kpn,
                                        dist_frac=0.2, device="cpu")]
    perm = np.random.RandomState(4).permutation(24).astype(np.int32)
    # live ops on negative and out-of-range rows: a negative key's scans
    # read clip_row (row 0) while its SID re-gather, install and bump reach
    # gather_row; -1 is written where n - 1 is read.  At most one live
    # install a row per txn: the reference leaves which of two installs
    # into one cell wins to its backend
    n = 8
    neg = []
    for w in range(2):
        kind = rng.randint(1, 4, (16, 4))
        key = rng.choice([-1, -2, -n, -n - 3, n, n + 2, 0, 1, 3, n - 1],
                         (16, 4))
        kind[::3, 0], key[::3, 0] = 2, -1
        kind[::3, 1], key[::3, 1] = 1, n - 1
        for t in range(16):
            rows = set()
            for o in range(4):
                row = key[t, o] + n if key[t, o] < 0 else key[t, o]
                if kind[t, o] >= 2 and 0 <= row < n:
                    if row in rows:
                        kind[t, o] = 1
                    rows.add(row)
        neg.append(wave(kind, key, rng.randint(-9, 9, (16, 4)), 1 + 16 * w))
    # -1 and n - 1 written by one txn: one row, two heads (as duplicate
    # write keys, held to the plain loop alone)
    kind, key = rng.randint(1, 4, (16, 4)), rng.randint(0, n, (16, 4))
    kind[:, :2], key[:, 0], key[:, 1] = 2, -1, n - 1
    heads = [wave(kind, key, rng.randint(-9, 9, (16, 4)), 40)]
    # V=1: every install overwrites the slot its txn read, so the SID
    # bump's TID guard sees the txn's own TID (the waves repeat their tids)
    v1 = []
    for w in range(2):
        kind, key = np.ones((16, 3), np.int64), rng.randint(0, 4, (16, 3))
        kind[:, 1], key[:, 1] = rng.choice([2, 3], 16), key[:, 0]
        v1.append(wave(kind, key, rng.randint(-9, 9, (16, 3)), 1))
    # every op of a T=256 wave on one key, one write a txn: one staged row,
    # a dense potential
    kind = np.ones((256, 4), np.int64)
    kind[:, 1] = rng.choice([2, 3], 256)
    hot = [wave(kind, np.full((256, 4), 5), rng.randint(-9, 9, (256, 4)),
                300)]
    # the largest V whose wave of T=256, O=4 still stages, and the next
    v_edge = max(v for v in range(1, 64)
                 if commit_loop_smem_bytes(256, 4, v)[1] == "staged")
    edge = gen(tw.smallbank_waves, 1, 256, 4, 64, dist_frac=0.2)
    return [
        ("V=2 read+RMW of one key", 6, 2, 4, rmw, None, None),
        ("duplicate write keys", 8, 4, 4, dup, None, None),
        ("T=1", 16, 4, 4, gen(tw.smallbank_waves, 3, 1, 4, 4,
                              dist_frac=0.5), None, None),
        ("T=33", 16, 4, 4, gen(tw.smallbank_waves, 2, 33, 4, 4,
                               dist_frac=0.5), None, None),
        ("tpcc O=12", 256, 4, 4, gen(tw.tpcc_waves, 2, 16, 4, 64), None,
         None),
        # past the shared-memory budget of potential and past 512 threads
        ("T=1040", 64, 4, 4, gen(tw.micro_waves, 1, 1040, 4, 16, n_ops=2,
                                 read_ratio=0.5, hot_frac=0.3,
                                 hot_per_node=4), None, None),
        ("placement + host skew", 24, 4, 4,
         gen(tw.smallbank_waves, 3, 16, 4, 6, dist_frac=0.6),
         np.array([0, 2, 1, 3], np.int32),
         ((np.arange(24) % 4).astype(np.int32), perm)),
        ("negative and out-of-range rows", n, 4, 4, neg, None, None),
        ("one row from two heads", n, 4, 4, heads, None, None),
        ("V=1, each install over the slot read", 4, 1, 4, v1, None, None),
        ("one hot key, T=256", 64, 8, 4, hot, None, None),
        (f"T=256 O=4 V={v_edge}, the largest V that stages", 256, v_edge, 4,
         edge, None, None),
        (f"T=256 O=4 V={v_edge + 1}, the smallest V that does not", 256,
         v_edge + 1, 4, edge, None, None),
        (f"path T={cfg.T}", n_keys, cfg.V, cfg.nodes, path, None, None),
    ]


def check_commit_loop(torch, np, dev, case, sched, gc, kernel, plain):
    """Every wave of ``case`` through ``kernel`` (one callable or a tuple
    of them, each on its own clone of the store) and ``plain`` from one aged
    store, GC watermark 2 (below most superseders: evictions are real);
    returns the largest difference over the outputs and the store (0 =
    bit-equal)."""
    from repro_torch.core import LocalSubstrate, MVStore, wave_from_numpy
    from repro_torch.core.engine import wave_read_phase
    from repro_torch.core.store import as_placement_arrays
    label, n_keys, V, n_nodes, waves, hs, pl = case
    kernels = kernel if isinstance(kernel, tuple) else (kernel,)
    store = aged_store(torch, np, np.random.RandomState(n_keys + V), n_keys,
                       V, dev)
    copies = [MVStore(*(t.clone() for t in store)) for _ in kernels]
    sub = LocalSubstrate("torch", dev)
    kw = dict(sched=sched, n_nodes=n_nodes, gc_track=gc == "track",
              gc_block=gc == "block")
    hs = None if hs is None else torch.as_tensor(hs, device=dev)
    pl = as_placement_arrays(pl, dev)
    clock = torch.tensor(V + 2, dtype=torch.int32, device=dev)
    err = 0
    for w, wave in enumerate(waves):
        inputs = wave_read_phase(sub, store, wave_from_numpy(wave, dev),
                                 w + 1, clock, sched=sched, host_skew=hs,
                                 watermark=2, placement=pl)
        got = [k(copy, inputs, **kw) for k, copy in zip(kernels, copies)]
        want = plain(store, inputs, **kw)
        for k, out, copy in zip(kernels, got, copies):
            err = max(err, max_abs_err(torch, out, want),
                      max_abs_err(torch, copy, store))
            if err:
                raise AssertionError(
                    f"commit_loop [{label}, {sched}, gc {gc}, wave {w}, "
                    f"{getattr(k, 'keywords', {}).get('variant', 'auto')}] "
                    f"differs from the plain loop: max_abs_err={err}")
        clock = want[4]
    return err


def commit_loop_phase(torch, np, dev, cfg):
    """``commit_loop`` against the engine's plain loop on every case, for
    the six schedulers x three GC modes, in the variant the wrapper picks
    and, where that is ``staged``, in the ``global`` one too; then
    CUDA-event times of both variants and of the plain loop on the path's
    wave (postsi, ``gc_track`` as the engine phase runs it), the bound and
    the wrapper's host time a call at T=1.  Returns the kernel's record and
    a call of it there."""
    from functools import partial

    from repro_torch.core import SCHEDULERS, LocalSubstrate, MVStore
    from repro_torch.core import wave_from_numpy
    from repro_torch.core.engine import wave_read_phase
    from repro_torch.kernels.commit_loop import (VARIANTS, commit_loop_cuda,
                                                 commit_loop_plain,
                                                 commit_loop_smem_bytes)
    cases = commit_loop_cases(np, cfg)
    n, err = 0, 0
    for case in cases:
        label, _, V, _, waves, _, _ = case
        T, O = waves[0][0].shape
        smem, auto = commit_loop_smem_bytes(T, O, V)
        kernels = {auto: commit_loop_cuda}
        if auto == "staged":
            kernels["global"] = partial(commit_loop_cuda, variant="global")
        for sched in SCHEDULERS:
            for gc in ("none", "track", "block"):
                err = max(err, check_commit_loop(
                    torch, np, dev, case, sched, gc, tuple(kernels.values()),
                    commit_loop_plain))
                n += 1
        print(f"[kernels] commit_loop [{label}] T={T} O={O} V={V}: runs "
              f"{auto} ({smem} bytes of shared memory); bit-equal in "
              f"{' and '.join(kernels)}", flush=True)
    print(f"[kernels] commit_loop: {n} checks ({len(cases)} cases x 6 "
          f"schedulers x 3 GC modes, each in every variant that fits), "
          f"outputs and store bit-equal to the plain loop", flush=True)

    # the wrapper's host time a call at T=1 (enqueue only: no sync inside)
    _, _, V, n_nodes, (wave, *_), _, _ = next(
        c for c in cases if c[0] == "T=1")
    store = aged_store(torch, np, np.random.RandomState(1), 16, V, dev)
    inputs = wave_read_phase(LocalSubstrate("torch", dev), store,
                             wave_from_numpy(wave, dev), 1, V + 2,
                             sched="postsi")
    kw = dict(sched="postsi", n_nodes=n_nodes, gc_track=True,
              gc_block=False)
    cuda_ms(torch, lambda: commit_loop_cuda(store, inputs, **kw), iters=20)
    t0 = time.perf_counter()
    for _ in range(200):
        commit_loop_cuda(store, inputs, **kw)
    host_ms = (time.perf_counter() - t0) * 1e3 / 200
    torch.cuda.synchronize()
    print(f"[kernels] commit_loop wrapper host time at T=1: {host_ms:.4f} "
          f"ms a call", flush=True)

    # times on the path's wave: each call installs again into its store
    label, n_keys, V, n_nodes, (wave,), _, _ = cases[-1]
    store = aged_store(torch, np, np.random.RandomState(0), n_keys, V, dev)
    sub = LocalSubstrate("torch", dev)
    inputs = wave_read_phase(sub, store, wave_from_numpy(wave, dev), 1,
                             V + 2, sched="postsi")
    kw = dict(sched="postsi", n_nodes=n_nodes, gc_track=True,
              gc_block=False)
    k_store = MVStore(*(t.clone() for t in store))
    kind, T, O = wave[0], *wave[0].shape
    auto = commit_loop_smem_bytes(T, O, V)[1]
    k_ms = {v: cuda_ms(torch, lambda: commit_loop_cuda(k_store, inputs,
                                                        variant=v, **kw),
                       iters=20, warmup=2) for v in VARIANTS}
    p_ms = cuda_ms(torch, lambda: commit_loop_plain(store, inputs, **kw),
                   iters=3, warmup=1)
    # bytes of this wave: the per-op inputs (8 [T, O] int32 arrays), host,
    # tid, s_lo0, potential and 3 scalars read once; the ring rows of the
    # distinct keys touched (cid, tid, sid) and their heads; every install
    # (4 ring fields, head, wave tag) and SID bump written once; the
    # outputs.  Operations: the ring compares and the two [T, T] passes.
    status, _, _, wcid, _, _ = commit_loop_plain(
        MVStore(*(t.clone() for t in store)), inputs, **kw)
    rows = len(np.unique(np.clip(wave[1], 0, n_keys - 1)))
    reads = ((kind == 1) | (kind == 3)) & (status.cpu().numpy() == 1)[:, None]
    n_bytes = (8 * T * O * 4 + 3 * T * 4 + T * T + 12 + rows * (3 * V + 1) * 4
               + int((wcid >= 0).sum()) * 6 * 4 + int(reads.sum()) * 4
               + 3 * T * 4 + T * O * 4 + 8)
    b_ms, b_by = bound(n_bytes, 3 * T * O * V + 2 * T * T)
    print(f"[kernels] commit_loop at the path's wave ({label}, O={O}, "
          f"V={V}, postsi): "
          + ", ".join(f"{v} {ms:.4f} ms/wave ({1e3 * ms / T:.3f} us a step)"
                      for v, ms in k_ms.items())
          + f"; runs {auto}; plain loop {p_ms:.2f} ms; bound {b_ms:.6f} ms "
          f"by {b_by} ({n_bytes} bytes)", flush=True)
    rec = {"name": "commit_loop", "route": "cuda",
           "source": KERNELS["commit_loop"][0],
           "replaces": KERNELS["commit_loop"][1], "launches": 0,
           "max_abs_err": err, "ms": k_ms[auto], "plain_ms": p_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    return {"commit_loop": rec}, {"commit_loop": lambda: commit_loop_cuda(
        k_store, inputs, **kw)}


# ------------------------------------------------------- phase 3, model
def close_err(torch, name, label, got, want, atol, rtol, use=None):
    """Largest |got - want| over the output tensors; raise unless every
    output is finite, has the reference's shape and dtype, and is within
    ``atol + rtol * |want|``.  ``use`` (a dict), where given, keeps under
    ``name`` the element that came closest to its limit over all calls:
    (|got - want| / limit, |got - want|, |want|, label)."""
    err = 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name} [{label}]: shape/dtype {a.shape}/"
                                 f"{a.dtype} vs {b.shape}/{b.dtype}")
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name} [{label}]: non-finite output")
        if not a.numel():
            continue
        d = (a.float() - b.float()).abs().flatten()
        mag = b.float().abs().flatten()
        limit = atol + rtol * mag
        share = d / limit.clamp_min(1e-30)
        i = int(share.argmax())
        worst = (float(share[i]), float(d[i]), float(mag[i]), label)
        err = max(err, float(d.max()))
        if use is not None and worst[0] > use.get(name, (-1.0,))[0]:
            use[name] = worst
        if worst[0] > 1.0:
            raise AssertionError(
                f"{name} [{label}] differs from its reference beyond "
                f"atol={atol} rtol={rtol}: max_abs_err={float(d.max())}; "
                f"largest excess over the limit "
                f"{float((d - limit).max())}, worst element |d|={worst[1]} "
                f"at |want|={worst[2]} ({worst[0]:.3g} x its limit)")
    return err


def limit_use_line(use) -> str:
    """The elements closest to their limits, as close_err keeps them."""
    return "; ".join(f"{name} {share:.3g} of its limit (|d|={d:.4g} at "
                     f"|want|={mag:.4g}, {label})"
                     for name, (share, d, mag, label) in sorted(use.items()))


def attention_oracle_err(torch, label, got, q, k, v, causal, plain,
                         use=None):
    """A bf16 flash_attention output against the plain version computed in
    float32 on the same bf16 inputs.  The kernel computes in float32 and
    rounds its output once, so it must lie within one bf16 rounding of that
    oracle (rtol 1e-2 > 2^-8) plus 1e-3 * max|o| for the order of sums: a
    bound well under a typical |o|, unlike the 2e-2 of the bf16-vs-bf16
    check, whose atol is as large as the outputs of a flat softmax."""
    want = plain(q.float(), k.float(), v.float(), causal)
    atol = 1e-3 * float(want.abs().max())
    return close_err(torch, "flash_attention oracle",
                     label + " vs float32 oracle", (got.float(),), (want,),
                     atol, 1e-2, use)


def ssd_oracle_err(torch, label, y, x, dA, Bm, Cm, H, chunk, h0, plain,
                   use=None):
    """A bf16 ssd_scan output y against the plain version computed in
    float32 on the same bf16 inputs (``plain``: ssd_plain's arguments).
    The kernel keeps about 16 mantissa bits in every operand that is not a
    bf16 input and rounds y once, so y must lie within one bf16 rounding
    of that oracle (rtol 1e-2 > 2^-8) plus 1e-3 * max|y| for the order of
    sums.  The bf16-vs-bf16 check (2e-2 + 2e-2 |y|) sets its limit from a
    y rounded to bf16 and cannot tell a kernel that rounds its products'
    operands once from one that keeps them."""
    want, _ = plain(x.float(), dA, Bm.float(), Cm.float(), H, chunk, h0)
    atol = 1e-3 * float(want.abs().max())
    return close_err(torch, "ssd_scan oracle", label + " vs float32 oracle",
                     (y.float(),), (want,), atol, 1e-2, use)


def model_layout(x, dA, Bg, H):
    """x [BH, S, P] and dA [BH, S] as the [Bg, H, S, .] transpose views of
    the model's [Bg, S, H, .] layout, the views models/ssm.py:ssd passes."""
    S, P = x.shape[1:]
    return (x.reshape(Bg, H, S, P).transpose(1, 2).contiguous()
            .transpose(1, 2),
            dA.reshape(Bg, H, S).transpose(1, 2).contiguous().transpose(1, 2))


def model_kernel_phase(torch, dev):
    """flash_attention and ssd_scan against their plain versions on the
    card, at the serve path's shapes and on edge cases; returns the two
    per-kernel records (times at the serve path's shapes)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    from repro_torch.kernels.ssd_scan import ssd_cuda, ssd_plain
    torch.backends.cuda.matmul.allow_tf32 = False   # plain fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32

    def rn(shape, scale, dtype):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(dtype)

    errs = {"flash_attention": [], "ssd_scan": []}
    use = {}
    # (B, S, H, KH, D, dtype, causal): the path in bf16 and float32,
    # ragged, GQA, non-causal and small odd shapes.  q and k at scale 2
    # make the softmax peaked (scores of std 4), so outputs are of the
    # order of v and a wrong tile shows well above the tolerances.
    fa_cases = [(4, 1024, 32, 32, 80, bf16, True),
                (4, 1024, 32, 32, 80, f32, True),
                (4, 1000, 32, 32, 80, bf16, True),
                (2, 1024, 14, 2, 64, bf16, True),
                (4, 1024, 32, 32, 80, bf16, False),
                (2, 256, 4, 2, 128, f32, True),
                (2, 200, 4, 2, 80, f32, False),
                (1, 70, 2, 1, 48, f32, True),
                (1, 1, 4, 4, 16, f32, True),
                (1, 2048, 32, 8, 128, bf16, True)]
    for B, S, H, KH, D, dt, causal in fa_cases:
        q = rn((B, S, H, D), 2.0, dt)
        k, v = rn((B, S, KH, D), 2.0, dt), rn((B, S, KH, D), 1.0, dt)
        tol = 2e-2 if dt == bf16 else 2e-5
        label = f"B={B} S={S} H={H} KH={KH} D={D} {dt} causal={causal}"
        o = flash_attention_cuda(q, k, v, causal)
        errs["flash_attention"].append(close_err(
            torch, "flash_attention", label, (o,),
            (flash_attention_plain(q, k, v, causal),), tol, tol, use))
        if dt == bf16:
            errs["flash_attention"].append(attention_oracle_err(
                torch, label, o, q, k, v, causal, flash_attention_plain,
                use))
        del q, k, v, o
    # (Bg, H, S, P, N, chunk, dtype, h0, decay, model layout): the path
    # (decay as the model's dt*A, about -0.7 a step), with an initial
    # state, ragged, float32, small chunks, mamba2-130m's N=128, and x / dA
    # as the [B, H, S, .] views of the model's [B, S, H, .] that the path
    # passes.  The last three decay slowly (dA ~ -U(0, 0.01), as trained
    # SSM heads do), so that every row tile of the state product and every
    # block below the diagonal of (C B^T .* L) x carries weight: at a decay
    # of 0.7 a step, rows 16 back add under e^-6 and a wrong or skipped
    # block would pass unseen.
    ssd_cases = [(4, 80, 1024, 64, 64, 128, bf16, False, 1.4, False),
                 (4, 80, 1024, 64, 64, 128, bf16, True, 1.4, False),
                 (4, 80, 1000, 64, 64, 128, bf16, False, 1.4, False),
                 (2, 3, 256, 32, 64, 64, f32, False, 0.3, False),
                 (2, 3, 300, 64, 64, 128, f32, True, 0.3, False),
                 (2, 4, 77, 16, 16, 16, f32, True, 0.3, False),
                 (1, 2, 50, 64, 64, 128, f32, False, 0.3, False),
                 (4, 24, 1024, 64, 128, 128, bf16, True, 1.4, False),
                 (4, 80, 1000, 64, 64, 128, bf16, True, 1.4, True),
                 (2, 3, 300, 64, 64, 128, f32, True, 0.3, True),
                 (4, 80, 1024, 64, 64, 128, bf16, True, 0.01, True),
                 (4, 24, 1024, 64, 128, 128, bf16, True, 0.01, False),
                 (2, 3, 300, 32, 64, 64, bf16, True, 0.01, False)]
    for Bg, H, S, P, N, Q, dt, with_h0, decay, model in ssd_cases:
        x = rn((Bg * H, S, P), 0.5, dt)
        dA = -torch.rand((Bg * H, S), generator=g, device=dev) * decay
        if model:
            x, dA = model_layout(x, dA, Bg, H)
        Bm, Cm = rn((Bg, S, N), 0.3, dt), rn((Bg, S, N), 0.3, dt)
        h0 = rn((Bg * H, N, P), 0.2, f32) if with_h0 else None
        label = (f"BH={Bg * H} S={S} P={P} N={N} chunk={Q} {dt} "
                 f"h0={with_h0}{' model layout' if model else ''}")
        y, h = ssd_cuda(x, dA, Bm, Cm, H, Q, h0)
        yp, hp = ssd_plain(x, dA, Bm, Cm, H, Q, h0)
        # y in bf16 may differ by one bf16 rounding (2^-8 relative)
        ytol = 2e-2 if dt == bf16 else 1e-3
        errs["ssd_scan"].append(max(
            close_err(torch, "ssd_scan", label + " y", (y,), (yp,), ytol,
                      ytol, use),
            close_err(torch, "ssd_scan state", label + " h", (h,), (hp,),
                      1e-3, 1e-3, use)))
        if dt == bf16:
            errs["ssd_scan"].append(ssd_oracle_err(
                torch, label, y, x, dA, Bm, Cm, H, Q, h0, ssd_plain, use))
        del x, dA, Bm, Cm, h0, y, h, yp, hp
    print(f"[kernels] flash_attention: {len(fa_cases)} checks, ssd_scan: "
          f"{len(ssd_cases)} checks, all within tolerance of the plain "
          f"versions (max abs err {max(errs['flash_attention']):.3g} / "
          f"{max(errs['ssd_scan']):.3g})", flush=True)
    print(f"[kernels] closest to the limit: {limit_use_line(use)}",
          flush=True)

    # times at the serve path's shapes
    B, S, H, D = SERVE_BATCH, SERVE_PROMPTS[0], 32, 80
    q, k, v = (rn((B, S, H, D), 0.5, bf16) for _ in range(3))
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    BH, P, N, Q = SERVE_BATCH * 80, 64, 64, 128
    # the scan in the layout the path gives it (views of [B, S, H, .])
    x, dA = model_layout(rn((BH, S, P), 0.5, bf16),
                         -torch.rand((BH, S), generator=g, device=dev) * 1.4,
                         SERVE_BATCH, 80)
    Bm, Cm = rn((SERVE_BATCH, S, N), 0.3, bf16), rn((SERVE_BATCH, S, N), 0.3,
                                                     bf16)
    calls = {
        "flash_attention": (lambda: flash_attention_cuda(q, k, v, True),
                            lambda: flash_attention_plain(q, k, v, True),
                            lambda: F.scaled_dot_product_attention(
                                qt, kt, vt, is_causal=True)),
        "ssd_scan": (lambda: ssd_cuda(x, dA, Bm, Cm, 80, Q),
                     lambda: ssd_plain(x, dA, Bm, Cm, 80, Q), None),
    }
    # bytes: inputs read once, outputs written once; operations: the causal
    # products (half of S^2 for attention, Q(Q+1)/2 per chunk for the
    # SSD's two intra-chunk products, plus its two state products)
    pairs = B * H * S * (S + 1) // 2
    nc = -(-S // Q)
    work = {
        "flash_attention": (4 * B * S * H * D * 2, 4 * pairs * D),
        "ssd_scan": (2 * BH * S * P * 2 + BH * S * 4 + 2 * SERVE_BATCH * S
                     * N * 2 + BH * N * P * 4,
                     2 * BH * nc * (Q * (Q + 1) // 2 * (N + P)
                                    + 2 * Q * N * P)),
    }
    records = {}
    for name, (kern, plain, lib) in calls.items():
        k_ms = cuda_ms(torch, kern, iters=20, warmup=3)
        p_ms = cuda_ms(torch, plain, iters=10, warmup=2)
        l_ms = None if lib is None else cuda_ms(torch, lib, iters=20,
                                                warmup=3)
        b_ms, b_by = bound(*work[name], BF16_FLOPS_PER_S)
        records[name] = {
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": 0,
            "max_abs_err": max(errs[name]), "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms}
        print(f"[kernels] {name}: {k_ms:.4f} ms/call (plain {p_ms:.4f}, "
              f"library {l_ms}), bound {b_ms:.5f} ms by {b_by}", flush=True)
    probes = scripts_module("probes")
    got = probes.profile_device_ms(
        {n: (c[0], f"{n}_") for n, c in calls.items()}, iters=10)
    for name, rec in records.items():
        rec["device_ms"] = got[name]
    print("[kernels] profiler device ms/launch: "
          + ", ".join(f"{n}={r['device_ms']}" for n, r in records.items()),
          flush=True)
    return records


# ------------------------------------------------------------ phase 6
def forced_logits(torch, model, params, toks, forced, max_len):
    """Logits of every generated position when the batch is fed the tokens
    ``forced`` ([B, n]) instead of its own: [B, n, vocab] float32."""
    logits, cache = model.prefill(params, {"tokens": toks}, max_len)
    out = [logits[:, -1]]
    for i in range(forced.shape[1] - 1):
        logits, cache = model.decode(params, cache,
                                     {"token": forced[:, i:i + 1]})
        out.append(logits[:, -1])
    return torch.stack(out, dim=1)


def profile_call(torch, label, fn, card):
    """Device kernels, busy share and top device ops of one call of
    ``fn``."""
    prof = start_profiler("serve")
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not stop_profiler(prof, "serve"):
        return
    try:
        kernels = [e for e in prof.events()
                   if getattr(e, "device_type", None) is not None
                   and "CUDA" in str(e.device_type)]
        busy = sum(getattr(e, "device_time", 0) for e in kernels) / 1e6
        tops = sorted(prof.key_averages(),
                      key=lambda e: -getattr(e, "device_time_total", 0))[:8]
        print(f"[serve] profile of {label}: wall "
              f"{wall * 1e3:.1f} ms, {len(kernels)} device kernels, device "
              f"busy {busy * 1e3:.2f} ms ({100 * busy / wall:.1f}% of wall)"
              f" [{card}]", flush=True)
        print("[serve]   top device time: " + "; ".join(
            f"{e.key[:48]} {getattr(e, 'device_time_total', 0) / 1e3:.2f}"
            f" ms x{e.count}" for e in tops), flush=True)
    except Exception as exc:           # reading the trace is optional here
        print(f"[serve] profile unavailable: {exc!r}", flush=True)


def serve_phase(torch, dev, cfg, card, mcfg=None, route="cuda"):
    """zamba2-2.7b (or ``mcfg``) behind ``Server`` on ``route``.  Returns
    the launch counts of the served batches (the counted path); measures
    and cross-checks against the ``torch`` route after reading them."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve import Server
    from repro_torch.models.model import build
    from repro_torch.models.module import tree_leaves
    mcfg = get_config(SERVE_ARCH) if mcfg is None else mcfg
    n = min(cfg.serve_batches, len(SERVE_PROMPTS))
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    t0 = time.perf_counter()
    versions = [build(mcfg).init(gen) for _ in range(2)]
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(versions[0]))
    print(f"[serve] {mcfg.name}: {n_params:,} parameters per version "
          f"(param_count {mcfg.param_count():,}), 2 versions made on the "
          f"card in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.RandomState(cfg.seed + 3)
    prompts = [rng.randint(0, mcfg.vocab_size, (SERVE_BATCH, S))
               .astype(np.int32) for S in SERVE_PROMPTS[:n]]
    srv = Server(mcfg, versions[0], batch_size=SERVE_BATCH, kernels=route,
                 device=dev)
    torch.cuda.reset_peak_memory_stats()
    results = []
    reset_launch_counts()
    for i, toks in enumerate(prompts):
        if i == 1 and not srv.publish(versions[1]):
            raise AssertionError("publish of weight version 1 failed")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = srv.serve_batch(toks, max_new_tokens=cfg.new_tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        results.append(r)
        print(f"[serve] batch {i}: {SERVE_BATCH} x {toks.shape[1]} prompt "
              f"tokens + {cfg.new_tokens} new, weight version "
              f"{r['weight_version']}, {wall:.3f} s, "
              f"{SERVE_BATCH * cfg.new_tokens / wall:.1f} generated tokens/s"
              f" [{card}]", flush=True)
    counts = dict(LAUNCHES)
    want = [0, 1, 1][:n]
    got = [r["weight_version"] for r in results]
    if got != want or srv.stats.versions_served != want:
        raise AssertionError(f"weight versions served {got}, expected {want}")
    if srv.stats.batches != n or srv.stats.publishes != min(n - 1, 1):
        raise AssertionError(f"serve stats {srv.stats}")
    for r in results:
        g_ = r["generated"]
        if g_.shape != (SERVE_BATCH, cfg.new_tokens) or g_.min() < 0 \
                or g_.max() >= mcfg.vocab_size:
            raise AssertionError(f"generated ids {g_.shape} out of range")
    print(f"[serve] versions {got}, stats {srv.stats}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches "
          f"{counts} ({n} prefills: expected flash_attention "
          f"{9 * n}, ssd_scan {54 * n}) [{card}]", flush=True)

    # ---- measurement (not counted): prefill and decode times, a profile
    params = versions[0]
    toks = torch.as_tensor(prompts[0], device=dev)
    max_len = toks.shape[1] + srv.cache_margin
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = srv.prefill(params, {"tokens": toks}, max_len)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    tok = torch.zeros((SERVE_BATCH, 1), dtype=torch.int32, device=dev)
    steps = max(cfg.new_tokens - 1, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        tok, cache = srv.decode(params, cache, {"token": tok})
    torch.cuda.synchronize()
    dec = (time.perf_counter() - t0) / steps
    print(f"[serve] prefill {SERVE_BATCH} x {toks.shape[1]}: "
          + ", ".join(f"{t * 1e3:.1f}" for t in times)
          + f" ms ({SERVE_BATCH * toks.shape[1] / min(times):.0f} prompt "
          f"tokens/s); decode {dec * 1e3:.2f} ms/step "
          f"({SERVE_BATCH / dec:.1f} tokens/s at batch {SERVE_BATCH}) "
          f"[{card}]", flush=True)
    profile_call(torch, "one decode step", lambda: srv.decode(
        params, cache, {"token": tok}), card)
    del cache
    profile_call(torch, f"one prefill (S={toks.shape[1]})",
                 lambda: srv.prefill(params, {"tokens": toks}, max_len), card)

    # ---- the kernels on the path's own activations
    in_situ_check(torch, srv, params, toks, max_len)

    # ---- the served route against the torch route, teacher-forced with
    # the served tokens.  In float32 compute the two differ only in the
    # order of sums: gated at 1e-3 * scale.  In bf16, the served type, the
    # two round at different places (attention's probabilities, the scan's
    # sums) and 54 layers of random weights amplify that far past
    # 0.06 * scale, so bf16 is gated against the rounding noise of the
    # torch route itself: cuda vs torch in bf16 within 1.5 times the torch
    # route's own bf16-vs-float32 distance.
    f32 = mcfg.replace(compute_dtype=torch.float32)
    models = {(dt, r): build(c, kernels=k)
              for dt, c in (("bf16", mcfg), ("fp32", f32))
              for r, k in (("cuda", route), ("torch", "torch"))}
    for i, (toks, r) in enumerate(zip(prompts, results)):
        params = versions[r["weight_version"]]
        t = torch.as_tensor(toks, device=dev)
        forced = torch.as_tensor(r["generated"], device=dev)
        lg = {key: forced_logits(torch, m, params, t, forced,
                                 toks.shape[1] + srv.cache_margin)
              [..., :mcfg.vocab_size] for key, m in models.items()}
        for key, v in lg.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"serve: {key} logits not finite")
        diff = lambda a, b: float((lg[a] - lg[b]).abs().max())
        scale = max(float(lg["fp32", "torch"].abs().max()), 1.0)
        e32 = diff(("fp32", "cuda"), ("fp32", "torch"))
        e16 = diff(("bf16", "cuda"), ("bf16", "torch"))
        own = diff(("bf16", "torch"), ("fp32", "torch"))
        first = float((lg["bf16", "cuda"][:, 0]
                       - lg["bf16", "torch"][:, 0]).abs().max())
        same = float((lg["bf16", "cuda"].argmax(-1) == forced).float().mean())
        print(f"[serve] batch {i} teacher-forced ({forced.shape[1]} steps):"
              f" float32 cuda vs torch logits max abs diff {e32:.3g} (bound "
              f"{1e-3 * scale:.3g} = 1e-3 * {scale:.3f}); bf16 cuda vs torch "
              f"{e16:.4f} (bound {1.5 * own:.4f} = 1.5 * the torch route's "
              f"bf16 vs float32 {own:.4f}; at the prefill's token "
              f"{first:.4f}), bf16 vs float32 on the cuda route "
              f"{diff(('bf16', 'cuda'), ('fp32', 'cuda')):.4f}; "
              f"bf16 cuda argmax = served token at {100 * same:.1f}% of "
              f"steps", flush=True)
        if e32 > 1e-3 * scale:
            raise AssertionError(f"serve batch {i}: cuda route logits differ "
                                 f"from the torch route by {e32} in float32")
        if e16 > 1.5 * own:
            raise AssertionError(f"serve batch {i}: cuda route bf16 logits "
                                 f"differ from the torch route's by {e16}, "
                                 f"more than 1.5 x its own bf16 rounding "
                                 f"distance {own}")
    return counts


def in_situ_check(torch, srv, params, toks, max_len):
    """One prefill with every ``ops.flash_attention`` / ``ops.ssd`` call
    also run on the plain version with the same (real) inputs, each pair
    held to the kernel tolerances.  Measurement only: not counted."""
    from repro_torch.kernels import ops
    orig = {"flash_attention": ops.flash_attention, "ssd": ops.ssd}
    worst = {name: 0.0 for name in orig}
    use = {}

    def recorder(name):
        def call(*args, **kw):
            out = orig[name](*args, **kw)
            plain = orig[name](*args, **{**kw, "use_kernel": False})
            out_t = out if isinstance(out, tuple) else (out,)
            plain_t = plain if isinstance(plain, tuple) else (plain,)
            tol = 2e-2 if out_t[0].dtype == torch.bfloat16 else 1e-3
            err = close_err(torch, name, "in situ", out_t[:1], plain_t[:1],
                            tol, tol, use)
            kernel = (out_t[0].dtype == torch.bfloat16 and out_t[0].is_cuda
                      and kw.get("use_kernel", True))
            # the kernel, not the bf16 plain version it is checked with
            if name == "flash_attention" and kernel:
                err = max(err, attention_oracle_err(
                    torch, "in situ", out, *args, kw.get("causal", True),
                    lambda q, k, v, c: orig[name](q, k, v, causal=c,
                                                  use_kernel=False), use))
            if name == "ssd" and kernel:
                err = max(err, ssd_oracle_err(
                    torch, "in situ", out_t[0], *args,
                    kw["n_heads_per_group"], kw.get("chunk", 128),
                    kw.get("h0"),
                    lambda x, a, b, c, H, Q, h0: orig[name](
                        x, a, b, c, n_heads_per_group=H, chunk=Q, h0=h0,
                        use_kernel=False), use))
            if len(out_t) > 1:                      # the scan's fp32 state
                err = max(err, close_err(torch, name + " state",
                                         "in situ state", out_t[1:],
                                         plain_t[1:], 1e-3, 1e-3, use))
            worst[name] = max(worst[name], err)
            return out
        return call

    ops.flash_attention = recorder("flash_attention")
    ops.ssd = recorder("ssd")
    try:
        srv.prefill(params, {"tokens": toks}, max_len)
    finally:
        ops.flash_attention, ops.ssd = orig["flash_attention"], orig["ssd"]
    print(f"[serve] in situ: every flash_attention and ssd call of one "
          f"prefill within tolerance of its plain version on the same "
          f"activations (max abs err {worst})", flush=True)
    print(f"[serve] in situ, closest to the limit: {limit_use_line(use)}",
          flush=True)


# ---------------------------------------------------------------- phase 4
def same_run(torch, np, label, ref_hist, ref_store, hist, store):
    """Raise unless ``hist``/``store`` equal the reference route's bit for
    bit (every WaveOut field and dtype, every store field)."""
    if len(hist) != len(ref_hist):
        raise AssertionError(f"{label}: {len(hist)} waves vs {len(ref_hist)}"
                             f" on the torch route")
    for (ta, oa), (tb, ob) in zip(ref_hist, hist):
        if not np.array_equal(ta, tb):
            raise AssertionError(f"{label}: wave tids differ from the torch "
                                 f"route")
        for f, a, b in zip(oa._fields, oa, ob):
            if not np.array_equal(a, b) or a.dtype != b.dtype:
                raise AssertionError(f"{label}: WaveOut.{f} differs from the"
                                     f" torch route")
    for f, a, b in zip(store._fields, ref_store, store):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: store.{f} differs from the torch "
                                 f"route")


def check_route_launches(label, route, n_waves, before, after):
    """Raise unless ``n_waves`` waves on ``route`` launched ``commit_loop``
    once a wave and ``version_scan`` once a wave on ``cuda`` (the read
    phase; never inside the commit loop), not at all on ``cuda+fused``; the
    ``torch`` routes launch nothing.  Returns the deltas."""
    got = {k: after[k] - before[k] for k in after}
    cuda = route.startswith("cuda")
    want = {"commit_loop": n_waves if cuda else 0,
            "version_scan": n_waves if route == "cuda" else 0}
    if any(got[k] != v for k, v in want.items()):
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    return got


def engine_phase(torch, dev, cfg,
                 routes=("torch", "cuda", "cuda+fused", "torch+fused")):
    import numpy as np
    from repro_torch.core import (SCHEDULERS, final_values_ok, make_store,
                                  run_workload_fused, verify_cv, verify_si)
    from repro_torch.core.workloads import smallbank_waves
    from repro_torch.kernels import LAUNCHES
    n_keys = cfg.nodes * cfg.kpn
    waves = smallbank_waves(np.random.RandomState(cfg.seed), cfg.waves,
                            cfg.T, cfg.nodes, cfg.kpn, dist_frac=0.2,
                            device=dev)
    scheds = SCHEDULERS if cfg.scheds == "all" else cfg.scheds.split(",")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    n_txn = cfg.waves * cfg.T
    for sched in scheds:
        ref_store = ref_hist = None
        for route in routes:
            store = make_store(n_keys, cfg.V, device=dev)
            sync()
            before = dict(LAUNCHES)
            t0 = time.perf_counter()
            store, hist, stats = run_workload_fused(
                store, waves, sched=sched, n_nodes=cfg.nodes,
                gc_track=True, kernels=route)
            sync()
            dt = time.perf_counter() - t0
            check_route_launches(f"{sched}/{route}", route, cfg.waves,
                                 before, LAUNCHES)
            if ref_store is None:
                ref_store, ref_hist = store, hist
                errs = final_values_ok(store, hist, n_keys)
                if sched != "optimal":    # the paper's unchecked upper bound
                    errs += (verify_cv if sched == "cv" else verify_si)(hist)
                if errs:
                    raise AssertionError(f"{sched}: history fails its "
                                         f"verifier: {errs[:3]}")
            else:
                same_run(torch, np, f"{sched}/{route}", ref_hist, ref_store,
                         hist, store)
            print(f"[engine] {sched:8s} {route:12s} {dt:8.3f} s  "
                  f"{cfg.waves / dt:8.2f} waves/s  {n_txn / dt:10.1f} txn/s"
                  f"  committed={stats.committed} aborted={stats.aborted}",
                  flush=True)
        del ref_store


def profile_wave(torch, dev, cfg):
    """Where one wave's time goes: the profiler's device-kernel time, the
    kernel launches and the device's busy share of the wall time, for one
    postsi SmallBank wave on each CUDA route.  The wave's launch counts are
    checked (one ``commit_loop``; one ``version_scan`` on ``cuda``, none
    on ``cuda+fused``) outside the guard around the profiler."""
    import numpy as np
    from repro_torch.core import make_store, run_wave
    from repro_torch.core.workloads import smallbank_waves
    from repro_torch.kernels import LAUNCHES
    (wave,) = smallbank_waves(np.random.RandomState(cfg.seed + 2), 1,
                              cfg.T, cfg.nodes, cfg.kpn, dist_frac=0.2,
                              device=dev)
    for route in ("cuda", "cuda+fused"):
        store = make_store(cfg.nodes * cfg.kpn, cfg.V, device=dev)
        run_wave(store, wave, 1, 1, cfg.nodes, kernels=route)    # warm-up
        torch.cuda.synchronize()
        before = dict(LAUNCHES)
        prof = start_profiler("profile")
        t0 = time.perf_counter()
        run_wave(store, wave, 2, 1, cfg.nodes, kernels=route)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = check_route_launches(f"profiled postsi wave, {route}", route,
                                   1, before, LAUNCHES)
        print(f"[profile] postsi {route}: launches of the wave "
              f"{ {k: v for k, v in got.items() if v} }", flush=True)
        if not stop_profiler(prof, "profile"):
            continue
        try:
            kernels = [e for e in prof.events()
                       if getattr(e, "device_type", None) is not None
                       and "CUDA" in str(e.device_type)]
            busy = sum(getattr(e, "device_time", 0) for e in kernels) / 1e6
            tops = sorted(
                prof.key_averages(),
                key=lambda e: -getattr(e, "device_time_total", 0))[:6]
            print(f"[profile] postsi {route}: wall {wall * 1e3:.1f} ms/wave,"
                  f" {len(kernels)} device kernels, device busy "
                  f"{busy * 1e3:.2f} ms ({100 * busy / wall:.1f}% of wall)",
                  flush=True)
            print("[profile]   top device time: " + "; ".join(
                f"{e.key[:40]} {getattr(e, 'device_time_total', 0) / 1e3:.2f}"
                f" ms x{e.count}" for e in tops), flush=True)
        except Exception as exc:       # reading the trace is optional here
            print(f"[profile] unavailable: {exc!r}", flush=True)


# ---------------------------------------------------------------- phase 5
def service_phase(torch, dev, cfg, routes=("torch", "cuda", "cuda+fused")):
    """The stream on each route; the first route is the reference the
    others must equal per request, per wave and in the final store.
    Returns each route's (fates, history, store)."""
    import numpy as np
    from repro_torch.core.workloads import poisson_arrivals
    from repro_torch.service import TxnService, smallbank_txn_gen
    ref = None
    runs = {}
    for kernels in routes:
        rng = np.random.RandomState(cfg.seed + 1)
        arrivals = poisson_arrivals(rng, cfg.rate, cfg.ticks)
        svc = TxnService(n_keys=cfg.nodes * cfg.kpn, n_versions=cfg.V,
                         T=cfg.service_T, sched="postsi", n_nodes=cfg.nodes,
                         kernels=kernels, device=dev)
        rep = svc.run_stream(arrivals, smallbank_txn_gen(
            rng, cfg.nodes, cfg.kpn, dist_frac=0.2))
        served_ok(f"service [{kernels}]", svc, rep)
        runs[kernels] = (fates_of(svc), svc.history, svc.store)
        if ref is None:
            ref = runs[kernels]
        else:
            same_session(torch, np, f"service [{kernels}]",
                         f"the {routes[0]} route", ref, runs[kernels])
        print(f"[service] {kernels:10s} offered={rep.offered} "
              f"committed={rep.committed} dropped={rep.dropped} "
              f"waves={rep.waves} wall={rep.wall_s:.3f} s "
              f"goodput={rep.goodput_tps} txn/s retry_rate={rep.retry_rate}"
              f" p50={rep.latency_p50} p99={rep.latency_p99} ticks",
              flush=True)
    return runs


def fates_of(svc):
    """Every request's fate: status, execution tids, interval, commit
    tick."""
    return [(r.status, tuple(r.tids), r.s, r.c, r.commit_tick)
            for r in svc.requests]


def same_session(torch, np, label, ref_label, ref, got):
    """Raise unless two served sessions' (fates, history, store) are equal
    per request, per wave and in the final store."""
    if got[0] != ref[0]:
        raise AssertionError(f"{label}: request fates differ from "
                             f"{ref_label}")
    same_run(torch, np, label, ref[1], ref[2], got[1], got[2])


def served_ok(label, svc, rep):
    """Raise unless the served history verifies and every admitted request
    committed or dropped (replica reads commit at submit, unadmitted)."""
    errs = svc.verify()
    if errs:
        raise AssertionError(f"{label}: history fails: {errs[:3]}")
    if rep.committed - rep.replica_commits + rep.dropped != rep.admitted:
        raise AssertionError(f"{label}: admitted requests did not all "
                             f"commit or drop")


# --------------------------------------------------------------- phase 5b
def sync_detector_fires(torch, np, dev) -> None:
    """Raise unless ``torch.cuda.set_sync_debug_mode("error")`` raises on a
    known blocking copy (a pageable numpy array to the card), so that its
    silence around a dispatch means the dispatch did not wait."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.as_tensor(np.zeros(4, np.int32), device=dev)
    except RuntimeError as exc:
        if "synchroniz" not in str(exc):
            raise
        print(f"[stream] sync debug mode 'error' fires on a blocking copy: "
              f"{str(exc).splitlines()[0]!r}", flush=True)
        return
    finally:
        torch.cuda.set_sync_debug_mode("default")
    raise AssertionError("sync debug mode 'error' let a blocking copy pass")


def check_dispatch(torch, svc, checked):
    """Run each block dispatch of ``svc`` (``TxnService._run_block``, the
    dispatch half of the streaming driver) under sync debug mode "error":
    a host wait inside it raises.  ``checked[0]`` counts the dispatches."""
    run = svc._run_block

    def run_checked(waves):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = run(waves)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        checked[0] += 1
        return out
    svc._run_block = run_checked


def oracle_values(waves):
    """Final value of every key the waves touch, from ``core/seq.py`` run
    one txn at a time in tid order (keys renumbered densely, which the
    oracle cannot tell apart)."""
    import numpy as np
    from repro_torch.core import NOP, READ, RMW, WRITE
    from repro_torch.core.seq import SeqScheduler
    waves = [[np.asarray(f.cpu()) for f in w] for w in waves]
    keys = np.unique(np.concatenate([w[1][w[0] != NOP] for w in waves]))
    seq = SeqScheduler(len(keys))
    for kinds, op_key, vals, _, _ in waves:
        dense = np.searchsorted(keys, op_key)
        for t in range(kinds.shape[0]):
            tid = seq.begin()
            for kind, k, v in zip(kinds[t].tolist(), dense[t].tolist(),
                                  vals[t].tolist()):
                if kind == READ:
                    seq.read(tid, k)
                elif kind == WRITE:
                    seq.write(tid, k, v)
                elif kind == RMW:
                    seq.write(tid, k, seq.read(tid, k) + v)
            if not seq.commit(tid):
                raise AssertionError("the serial oracle aborted a txn")
    return {int(key): seq.versions[i][-1].value
            for i, key in enumerate(keys.tolist())}


def streaming_phase(torch, dev, cfg, step_runs,
                    routes=("torch", "cuda", "cuda+fused")):
    """The pipelined streaming plane on phase 5's stream: B=1, K=1 on
    ``cuda`` equals phase 5's ``cuda`` step loop; B=4, K=2 with the
    adaptive sizer on every route, the CUDA routes equal to ``torch``.
    Every ``cuda`` block dispatch runs under sync debug mode "error"."""
    import numpy as np
    from repro_torch.core.workloads import poisson_arrivals
    from repro_torch.service import TxnService, smallbank_txn_gen
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    checked = [0]
    if on_card:
        sync_detector_fires(torch, np, dev)

    def session(kernels, B, K, sizer=None):
        rng = np.random.RandomState(cfg.seed + 1)
        arrivals = poisson_arrivals(rng, cfg.rate, cfg.ticks)
        svc = TxnService(n_keys=cfg.nodes * cfg.kpn, n_versions=cfg.V,
                         T=cfg.service_T, sched="postsi", n_nodes=cfg.nodes,
                         kernels=kernels, device=dev)
        if on_card and kernels.startswith("cuda"):
            check_dispatch(torch, svc, checked)
        sync()
        t0 = time.perf_counter()
        rep = svc.run_streaming(arrivals, smallbank_txn_gen(
            rng, cfg.nodes, cfg.kpn, dist_frac=0.2), B=B, K=K, sizer=sizer)
        sync()
        wall = time.perf_counter() - t0
        label = f"streaming [{kernels} B={B} K={K}]"
        served_ok(label, svc, rep)
        sz = svc.stream.sizer
        print(f"[stream] {kernels:10s} B={B} K={K} "
              f"sizer={sizer or 'none'}: offered={rep.offered} "
              f"committed={rep.committed} dropped={rep.dropped} "
              f"blocks={rep.blocks} waves={rep.waves} wall={wall:.3f} s "
              f"(report {rep.wall_s:.3f} s) goodput={rep.goodput_tps} txn/s"
              f" retry_rate={rep.retry_rate} p50={rep.latency_p50} "
              f"p99={rep.latency_p99} ticks"
              + (f" final T={sz.T} B={sz.B} (+{sz.increases} "
                 f"-{sz.decreases})" if sz else ""), flush=True)
        return label, (fates_of(svc), svc.history, svc.store), rep

    route = routes[1]                  # cuda on the card
    label, run, _ = session(route, 1, 1)
    same_session(torch, np, label, f"the {route} step loop",
                 step_runs[route], run)
    print(f"[stream] {route} B=1 K=1 equals the {route} step loop of phase "
          f"5: fates, histories, final store", flush=True)
    ref = streamed = None
    for kernels in routes:
        label, run, rep = session(kernels, 4, 2, "auto")
        if ref is None:
            ref = run
        else:
            same_session(torch, np, label, f"the {routes[0]} route", ref,
                         run)
        if kernels == route:
            streamed = (run, rep)
    if on_card:
        if checked[0] == 0:
            raise AssertionError("no block dispatch was checked")
        print(f"[stream] dispatch check: {checked[0]} block dispatches of "
              f"the cuda routes ran under sync debug mode 'error', none "
              f"waited on the card", flush=True)
    return checked, streamed


def planner_phase(torch, dev, cfg, checked,
                  routes=("torch", "cuda", "cuda+fused")):
    """The planner: ``run_workload_planned`` over hot SmallBank waves (zero
    aborts, every route equal to ``torch``, the committed values the serial
    oracle's), a ``planner="planned"`` service stream (no retry, no
    spill) and a ``planner="hybrid"`` streaming session on skewed YCSB,
    ``cuda`` equal to ``torch``."""
    import numpy as np
    from repro_torch.core import make_store, verify_si
    from repro_torch.core.workloads import poisson_arrivals, smallbank_waves
    from repro_torch.planner import run_workload_planned
    from repro_torch.service import (TxnService, smallbank_txn_gen,
                                     ycsb_txn_gen)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    n_keys = cfg.nodes * cfg.kpn
    waves = smallbank_waves(np.random.RandomState(cfg.seed + 3),
                            cfg.planned_waves, cfg.T, cfg.nodes, cfg.kpn,
                            dist_frac=0.2, hot_frac=0.5, hot_per_node=4,
                            device=dev)
    ref = None
    for kernels in routes:
        store = make_store(n_keys, cfg.V, device=dev)
        sync()
        t0 = time.perf_counter()
        store, hist, stats = run_workload_planned(
            store, waves, sched="postsi", n_nodes=cfg.nodes, kernels=kernels)
        sync()
        dt = time.perf_counter() - t0
        label = f"planner [{kernels}]"
        if stats.aborted or stats.spilled_txns:
            raise AssertionError(f"{label}: {stats.aborted} aborts, "
                                 f"{stats.spilled_txns} spilled")
        if ref is None:
            ref = (hist, store)
            errs = verify_si(hist)
            if errs:
                raise AssertionError(f"{label}: history fails: {errs[:3]}")
            want = oracle_values(waves)
            rows = torch.tensor(sorted(want), device=dev, dtype=torch.long)
            got = store.val[rows, store.head[rows].long()].tolist()
            if got != [want[k] for k in sorted(want)]:
                raise AssertionError(f"{label}: committed values differ "
                                     f"from core/seq.py")
        else:
            same_run(torch, np, label, ref[0], ref[1], hist, store)
        print(f"[planner] run_workload_planned postsi {kernels:10s}: "
              f"{cfg.planned_waves} waves of T={cfg.T} -> "
              f"{stats.dispatched_waves} lane waves (deepest "
              f"{stats.max_lanes_seen} lanes), committed={stats.committed}"
              f" aborted=0, {dt:.3f} s (planning {stats.plan_s:.3f} s)",
              flush=True)
    del ref

    def serve(kernels, planner, gen_of, B=None):
        rng = np.random.RandomState(cfg.seed + 4)
        arrivals = poisson_arrivals(rng, cfg.rate, cfg.ticks)
        svc = TxnService(n_keys=n_keys, n_versions=cfg.V, T=cfg.service_T,
                         sched="postsi", n_nodes=cfg.nodes, kernels=kernels,
                         planner=planner, device=dev)
        if on_card and kernels.startswith("cuda") and B:
            check_dispatch(torch, svc, checked)
        sync()
        t0 = time.perf_counter()
        gen = gen_of(rng)
        rep = (svc.run_streaming(arrivals, gen, B=B, K=2) if B
               else svc.run_stream(arrivals, gen))
        sync()
        wall = time.perf_counter() - t0
        label = f"planner={planner} [{kernels}{f' B={B} K=2' if B else ''}]"
        served_ok(label, svc, rep)
        print(f"[planner] {label}: offered={rep.offered} "
              f"committed={rep.committed} retries={rep.retries} "
              f"planned_waves={rep.planned_waves} lane waves="
              f"{rep.planned_lane_waves} spilled={rep.planned_spilled} "
              f"switches={rep.planner_switches} blocks={rep.blocks} "
              f"waves={rep.waves} wall={wall:.3f} s goodput="
              f"{rep.goodput_tps} txn/s", flush=True)
        return label, svc, rep

    bank = lambda rng: smallbank_txn_gen(rng, cfg.nodes, cfg.kpn,
                                         dist_frac=0.2)
    label, _, rep = serve(routes[1], "planned", bank)
    if rep.retries or rep.planned_spilled or not rep.planned_waves:
        raise AssertionError(f"{label}: {rep.retries} retries, "
                             f"{rep.planned_spilled} spilled, "
                             f"{rep.planned_waves} planned waves")
    hot = lambda rng: ycsb_txn_gen(rng, cfg.nodes, cfg.kpn, theta=0.99,
                                   read_frac=0.1)
    ref = None
    for kernels in routes[:2]:
        label, svc, rep = serve(kernels, "hybrid", hot, B=2)
        run = (fates_of(svc), svc.history, svc.store)
        if ref is None:
            ref = run
        else:
            same_session(torch, np, label, f"the {routes[0]} route", ref,
                         run)


# --------------------------------------------------------------- phase 5c
# the durable sessions: phase 5's B=4, K=2 stream, a WAL synced before
# every ack, a snapshot every 4 retired blocks at pipeline-empty boundaries;
# the crash: a kill after the 6th log record (earlier when a cut run logs
# fewer than 7 blocks), then a 40-byte tear (which fsync_every=1 clamps to
# nothing: every record is behind the fsync barrier)
DURABLE_FSYNC_EVERY, DURABLE_SNAPSHOT_EVERY = 1, 4
CRASH_AT, CRASH_TEAR = 5, 40
# a clean restart on the durable directory serves this many more ticks and
# stops short of the snapshot cadence: the directory then ends in a
# snapshot plus a WAL suffix for the recoveries to replay
RESUME_TICKS = 2
PREFIX_KEYS = ("op_kind", "op_key", "op_val", "host", "tid", "status", "s",
               "c", "fold")


def timed(fn, ms):
    """``fn`` wrapped to append the host ms of each call to ``ms``."""
    def run(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            ms.append((time.perf_counter() - t0) * 1e3)
    return run


def same_state(torch, label, st, svc):
    """Raise unless a recovered state equals the live service's store and
    meta (clock, wave index, GC clock, next TID) bit for bit."""
    for f, a, b in zip(svc.store._fields, st.store, svc.store):
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: store.{f} differs from the live "
                                 f"service")
    got = (st.clock, st.wave_idx, st.gc_clock, st.next_tid)
    want = (int(svc.clock), svc.wave_idx, svc.gc.clock, svc.former.next_tid)
    if got != want:
        raise AssertionError(f"{label}: (clock, wave_idx, gc_clock, "
                             f"next_tid) {got} vs live {want}")


def wal_prefix(np, label, crashed, ref):
    """Raise unless ``crashed`` is a non-empty proper prefix of ``ref``,
    record by record, bit for bit."""
    if not 0 < len(crashed) < len(ref):
        raise AssertionError(f"{label}: {len(crashed)} crashed records vs "
                             f"{len(ref)}: not mid-stream")
    for i, (a, b) in enumerate(zip(crashed, ref)):
        for k in PREFIX_KEYS:
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f"{label}: record {i} field {k} differs")
        for k in ("seq", "wave_idx0", "wm", "clock", "gc_clock"):
            if a[k] != b[k]:
                raise AssertionError(f"{label}: record {i} field {k} differs")


def durability_phase(torch, dev, cfg, streamed, checked,
                     routes=("torch", "cuda", "cuda+fused")):
    """Durable serving, recovery and a crash with restart on phase 5's
    stream.  ``streamed`` is phase 5's non-durable ``run_streaming``
    session on ``routes[1]`` ((fates, history, store), report); the
    durable one must equal it.  Each ``recover`` must give the live state;
    the full replays on ``routes[1:]`` must equal ``routes[0]``'s, wave by
    wave; the crashed log must be a prefix of the durable one and the
    restart must commit nothing twice."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.core import COMMITTED
    from repro_torch.core.workloads import poisson_arrivals
    from repro_torch.durability import DurabilityManager, recover, wal
    from repro_torch.kernels import LAUNCHES
    from repro_torch.runtime import Fault, FaultSchedule, InjectedCrash
    from repro_torch.service import TxnService, smallbank_txn_gen
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    route = routes[1]
    n_keys = cfg.nodes * cfg.kpn
    root = tempfile.mkdtemp(prefix="chip_smoke_durable_")
    n_checked = checked[0]

    def service(d, faults=None, max_queue=None):
        mgr = DurabilityManager(d, fsync_every=DURABLE_FSYNC_EVERY,
                                snapshot_every=DURABLE_SNAPSHOT_EVERY)
        svc = TxnService(n_keys=n_keys, n_versions=cfg.V, T=cfg.service_T,
                         sched="postsi", n_nodes=cfg.nodes, kernels=route,
                         device=dev, durability=mgr, faults=faults,
                         max_queue=max_queue)
        return svc, mgr

    def serve(d, faults=None, ticks=cfg.ticks, seed=cfg.seed + 1):
        svc, mgr = service(d, faults)
        log_ms, snap_ms = [], []
        mgr.log_block = timed(mgr.log_block, log_ms)
        mgr.snaps.save = timed(mgr.snaps.save, snap_ms)
        if on_card:
            check_dispatch(torch, svc, checked)
        rng = np.random.RandomState(seed)
        arrivals = poisson_arrivals(rng, cfg.rate, ticks)
        sync()
        t0 = time.perf_counter()
        try:
            rep = svc.run_streaming(arrivals, smallbank_txn_gen(
                rng, cfg.nodes, cfg.kpn, dist_frac=0.2), B=4, K=2,
                sizer="auto")
        except InjectedCrash:
            mgr.crash()
            torn = faults.mutilate_wal(mgr.wal_path, mgr.crash_synced_bytes)
            return svc, mgr, None, torn
        sync()
        wall = time.perf_counter() - t0
        mgr.close()
        return svc, mgr, (rep, wall, log_ms, snap_ms), None

    try:
        # 1. durable serving equals the non-durable session
        d = os.path.join(root, "durable")
        svc, mgr, (rep, wall, log_ms, snap_ms), _ = serve(d)
        label = f"durable streaming [{route} B=4 K=2]"
        served_ok(label, svc, rep)
        (ref_run, ref_rep) = streamed
        same_session(torch, np, label, f"the non-durable {route} session",
                     ref_run, (fates_of(svc), svc.history, svc.store))
        blocks = wal.scan(mgr.wal_path).blocks
        if len(blocks) != rep.blocks:
            raise AssertionError(f"{label}: {len(blocks)} records for "
                                 f"{rep.blocks} blocks")
        if not mgr.snapshots_taken:
            raise AssertionError(f"{label}: no snapshot in {len(blocks)} "
                                 f"blocks: run more --ticks")
        snap_bytes = sum(t.numel() * t.element_size() for t in svc.store)
        print(f"[durable] {label} equals the non-durable session: fates, "
              f"histories, final store; {len(blocks)} WAL records "
              f"({os.path.getsize(mgr.wal_path)} bytes), "
              f"{mgr.snapshots_taken} snapshots; wall {wall:.3f} s",
              flush=True)
        print(f"[durable] WAL append + fsync, host ms a block: median "
              f"{float(np.median(log_ms)):.4f} (min {min(log_ms):.4f}, max "
              f"{max(log_ms):.4f}, {len(log_ms)} blocks); snapshot save ms: "
              f"{', '.join(f'{x:.1f}' for x in snap_ms)}, {snap_bytes} bytes "
              f"of arrays each", flush=True)
        print(f"[durable] goodput: durable {rep.goodput_tps} txn/s "
              f"(report wall {rep.wall_s:.3f} s) beside non-durable "
              f"{ref_rep.goodput_tps} txn/s (report wall "
              f"{ref_rep.wall_s:.3f} s), {route}", flush=True)

        # 2. a clean restart resumes from the snapshot and serves on, then
        # recovery from the snapshot + suffix and by full replay, each route
        live, r_mgr, (r_rep, _, _, _), _ = serve(d, ticks=RESUME_TICKS,
                                                 seed=cfg.seed + 5)
        served_ok("resumed durable session", live, r_rep)
        st = r_mgr.last_recovery
        if (st is None or st.snapshot_seq is None or r_mgr.snapshots_taken
                or len(wal.scan(r_mgr.wal_path).blocks) <= len(blocks)):
            raise AssertionError("the resumed session did not start from "
                                 "the snapshot and end in a WAL suffix")
        print(f"[durable] resumed on the directory: recovered from snapshot "
              f"{st.snapshot_seq} ({st.seconds['snapshot']:.4f} s), served "
              f"{RESUME_TICKS} more ticks ({r_rep.blocks} blocks, "
              f"{r_rep.committed} committed), verify() == [] on the suffix "
              f"history against the snapshot's rings", flush=True)
        full = {}
        cases = ([(r, True) for r in routes[1:]]
                 + [(r, False) for r in routes[1:]] + [(routes[0], False)])
        for kernels, use_snapshot in cases:
            how = "snapshot + WAL suffix" if use_snapshot else "full replay"
            lbl = f"recover [{kernels}, {how}]"
            sync()
            before = dict(LAUNCHES)
            t0 = time.perf_counter()
            st = recover(d, kernels=kernels, device=dev,
                         use_snapshot=use_snapshot)
            sync()
            dt = time.perf_counter() - t0
            n_waves = len(st.history)
            got = check_route_launches(lbl, kernels, n_waves, before,
                                       LAUNCHES)
            same_state(torch, lbl, st, live)
            if use_snapshot != (st.snapshot_seq is not None) or not n_waves:
                raise AssertionError(f"{lbl}: snapshot {st.snapshot_seq}, "
                                     f"{n_waves} waves replayed")
            if not use_snapshot:
                full[kernels] = st
            sec = st.seconds
            rate = (f"{n_waves / sec['replay']:.1f} replayed waves/s"
                    if n_waves else "no wave to replay")
            print(f"[durable] {lbl}: {dt:.3f} s (scan {sec['scan']:.4f}, "
                  f"snapshot restore {sec['snapshot']:.4f}, replay "
                  f"{sec['replay']:.4f}), {st.n_replayed} of {st.n_blocks} "
                  f"blocks = {n_waves} waves replayed, {rate}; launches "
                  f"{ {k: v for k, v in got.items() if v} }; equal to the "
                  f"live store, clock, wave index, GC clock, next TID",
                  flush=True)
        ref = full[routes[0]]
        for kernels in routes[1:]:
            same_run(torch, np, f"full replay [{kernels}]", ref.history,
                     ref.store, full[kernels].history, full[kernels].store)
        del full, ref, st, live

        # 3. crash after the 6th log record, restart, resubmit
        c_d = os.path.join(root, "crashed")
        at = min(CRASH_AT, len(blocks) - 2)     # >= 2: a snapshot was due
        crash = [Fault("kill", "post_log", at),
                 Fault("torn_tail", "wal", 0, arg=CRASH_TEAR)]
        faults = FaultSchedule(crash)
        crashed, c_mgr, done, torn = serve(c_d, faults)
        if done is not None or not faults.pure_kill:
            raise AssertionError("the crash schedule did not kill the run")
        c_blocks = wal.scan(c_mgr.wal_path).blocks
        wal_prefix(np, "crashed WAL", c_blocks, blocks)
        C = {int(t) for rec in c_blocks
             for t, s in zip(rec["tid"].ravel(), rec["status"].ravel())
             if s == COMMITTED}
        acked = [r for r in crashed.requests if r.status == "committed"]
        if any(r.tid not in C for r in acked):
            raise AssertionError("an acked commit is not in the crashed log")
        t0 = time.perf_counter()
        svc2, mgr2 = service(c_d, max_queue=10_000)
        t_restart = time.perf_counter() - t0
        st2 = mgr2.last_recovery
        if st2 is None or st2.n_blocks != len(c_blocks):
            raise AssertionError("the restart did not recover the log")
        resub = {}
        for r in crashed.requests:
            if r.status in ("committed", "dropped", "rejected") or any(
                    t in C for t in r.tids):
                continue           # acked, dropped or durable-but-unacked
            resub[r.req_id] = svc2.submit(r.op_kind, r.op_key, r.op_val,
                                          r.host)
        svc2.drain()
        window = 0
        for r in crashed.requests:
            pre = any(t in C for t in r.tids)
            r2 = resub.get(r.req_id)
            if pre and r2 is not None:
                raise AssertionError(f"req {r.req_id} resubmitted though "
                                     f"committed in the log")
            if r2 is not None and r2.status not in ("committed", "dropped"):
                raise AssertionError(f"req {r.req_id}: {r2.status}")
            window += pre and r.status != "committed"
        errs = svc2.verify()
        if errs:
            raise AssertionError(f"restarted service fails: {errs[:3]}")
        mgr2.close()
        # the directory now holds the crashed prefix, the restart's B=1
        # blocks and their snapshots: it recovers to the restarted service
        for kernels, use_snapshot in ([(r, True) for r in routes[1:]]
                                      + [(routes[1], False)]):
            before = dict(LAUNCHES)
            st = recover(c_d, kernels=kernels, device=dev,
                         use_snapshot=use_snapshot)
            lbl = (f"recover after the restart [{kernels}, "
                   f"{'snapshot' if use_snapshot else 'full replay'}]")
            check_route_launches(lbl, kernels, len(st.history), before,
                                 LAUNCHES)
            same_state(torch, lbl, st, svc2)
            print(f"[durable] {lbl}: {st.n_replayed} of {st.n_blocks} "
                  f"blocks = {len(st.history)} waves replayed, snapshot "
                  f"{st.snapshot_seq}; equal to the restarted service",
                  flush=True)
        print(f"[durable] crash {crash}: {len(c_blocks)} of "
              f"{len(blocks)} records survive, a bit-identical prefix; "
              f"{torn} bytes torn (behind the fsync barrier: none at risk); "
              f"{len(acked)} acked commits all in the log, {window} "
              f"committed but never acked (not resubmitted); restart "
              f"{t_restart:.3f} s (recovery scan "
              f"{st2.seconds['scan']:.4f}, snapshot "
              f"{st2.seconds['snapshot']:.4f}, replay "
              f"{st2.seconds['replay']:.4f}; {st2.n_replayed} blocks "
              f"replayed), {len(resub)} resubmitted: "
              f"{sum(r.status == 'committed' for r in resub.values())} "
              f"committed, none twice; verify() == []"
              + (" (suffix history, the snapshot's rings)"
                 if svc2.base_store is not None else ""), flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if on_card:
        print(f"[durable] dispatch check: {checked[0] - n_checked} block "
              f"dispatches of the durable sessions ran under sync debug "
              f"mode 'error', none waited on the card", flush=True)


# --------------------------------------------------------------- phase 5d
# the reference's elastic deployment (benchmarks/bench_dist.py, _elastic):
# zipf theta=0.99, 97% reads, 2 ops a txn, 3 x T arrivals a tick, replicas
# refreshed every 8 ticks over the rank prefix holding 95% of the zipf
# mass (at most 40% of the keys), 2x headroom; the request stream's seed
ELASTIC_THETA, ELASTIC_READ_FRAC, ELASTIC_N_OPS = 0.99, 0.97, 2
ELASTIC_LOAD, ELASTIC_REFRESH, ELASTIC_HEADROOM = 3, 8, 2
ELASTIC_MASS, ELASTIC_MAX_FRAC, ELASTIC_SEED = 0.95, 0.4, 31
# the explicit move (the first quarter of node 0's keys, [0, 31_250), to
# node 1) and its tick; the short sessions (torch against cuda, the crash)
# move at tick 3
ELASTIC_MOVE_AT, ELASTIC_SHORT = 10, 6
ELASTIC_CRASH_AT, ELASTIC_SNAPSHOT_EVERY = 3, 2


def placed_corner_check(torch, dev, cfg, card,
                        routes=("torch", "cuda", "cuda+fused")):
    """A wave with live reads and NOP padding on key -1 (which reaches the
    last physical row) and on a key past the last one (clamped to
    ``slot[n_keys - 1]``), over the placed store, before and after a move
    that fills the last physical row: each CUDA route's outcomes and store
    equal the ``torch`` route's.  Not part of the counted path."""
    import numpy as np
    from repro_torch.core import (NOP, READ, WaveOut, make_store, run_wave,
                                  wave_from_numpy)
    from repro_torch.core.workloads import ycsb_waves
    from repro_torch.placement import PlacementMap, apply_move, \
        physical_store
    n_keys, T = cfg.nodes * cfg.kpn, cfg.service_T
    pm = PlacementMap(n_keys, cfg.nodes, headroom=ELASTIC_HEADROOM)
    stores = {r: physical_store(make_store(n_keys, cfg.V, device=dev), pm)
              for r in routes}
    waves = ycsb_waves(np.random.RandomState(cfg.seed + 6), 2, T, cfg.nodes,
                       cfg.kpn, theta=ELASTIC_THETA, read_frac=0.5,
                       n_ops=ELASTIC_N_OPS, device="cpu")
    for w, wave in enumerate(waves):
        kind, key = wave.op_kind.numpy().copy(), wave.op_key.numpy().copy()
        kind[T - 4:], key[T - 4:] = NOP, -1                  # padding
        kind[0, 0], key[0, 0] = READ, -1                     # live reads
        kind[1, 0], key[1, 0] = READ, n_keys + 3
        kind[2, :], key[2, :] = READ, [-1, n_keys + 3]
        wave = wave_from_numpy(wave._replace(op_kind=torch.as_tensor(kind),
                                             op_key=torch.as_tensor(key)),
                               dev)
        if w == 1:
            rec = pm.move(0, cfg.kpn, cfg.nodes - 1)
            if rec.new_slots[-1] != pm.n_slots - 1:
                raise AssertionError("the move does not fill the last row")
            for r in routes:
                apply_move(stores[r], rec)
            pm.apply_record(rec)
        outs = {}
        for r in routes:
            stores[r], out, _ = run_wave(stores[r], wave, w + 1, 1,
                                         cfg.nodes, kernels=r,
                                         placement=pm.device_arrays(dev))
            outs[r] = [f.cpu().numpy() for f in out]
        for r in routes[1:]:
            for f, a, b in zip(WaveOut._fields, outs[routes[0]], outs[r]):
                if not np.array_equal(a, b):
                    raise AssertionError(f"placed corner wave {w} [{r}]: "
                                         f"WaveOut.{f} differs from torch")
            for f, a, b in zip(stores[r]._fields, stores[routes[0]],
                               stores[r]):
                if not torch.equal(a, b):
                    raise AssertionError(f"placed corner wave {w} [{r}]: "
                                         f"store.{f} differs from torch")
    print(f"[elastic] keys -1 and {n_keys + 3} on live reads and padding "
          f"over the placed store ({pm.n_slots} rows), before and after a "
          f"{cfg.kpn}-key move that fills row {pm.n_slots - 1}: "
          f"{', '.join(routes[1:])} equal {routes[0]} in every WaveOut "
          f"field and the store ({card})", flush=True)


def elastic_phase(torch, dev, cfg, card, checked,
                  routes=("torch", "cuda", "cuda+fused")):
    """Elastic placement on the card: elastic = static on both CUDA routes,
    replicas, a placed streaming session under the dispatch check, a
    durable session with its recoveries, a crash after the first move
    record and a restart.  Returns nothing; every check raises."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.core.workloads import zipf_hot_keys
    from repro_torch.durability import DurabilityManager, recover
    from repro_torch.kernels import LAUNCHES
    from repro_torch.placement import PlacementMap, logical_store
    from repro_torch.service import TxnService, ycsb_txn_gen
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    plain, cuda, fused = routes
    n_keys, T = cfg.nodes * cfg.kpn, cfg.service_T
    ticks = cfg.elastic_ticks
    hot = zipf_hot_keys(cfg.nodes, cfg.kpn, ELASTIC_THETA, mass=ELASTIC_MASS,
                        max_frac=ELASTIC_MAX_FRAC)
    tag = f"({card})"

    def service(kernels, elastic, replicas=False, durability=None):
        return TxnService(
            n_keys=n_keys, n_versions=cfg.V, T=T, O=ELASTIC_N_OPS,
            sched="postsi", n_nodes=cfg.nodes, seed=0, kernels=kernels,
            device=dev, durability=durability,
            placement=(PlacementMap(n_keys, cfg.nodes,
                                    headroom=ELASTIC_HEADROOM)
                       if elastic else None),
            balancer=True if elastic else None,
            replicas=hot if replicas else None,
            replica_refresh=ELASTIC_REFRESH)

    def instrument(svc, log):
        """Time each move and each replica refresh with the device synced
        on both sides, record the balancer's load imbalance around each
        move, and check the replica floor after each refresh."""
        if svc.placement is not None:
            move = svc.move_range

            def timed_move(lo, hi, dst):
                # the imbalance readings are instrumentation: their host
                # time is taken back out of the report's wall
                t_in = time.perf_counter()
                lb = svc.balancer
                before = lb.imbalance(svc.placement) if lb else None
                sync()
                t0 = time.perf_counter()
                rec = move(lo, hi, dst)
                sync()
                t1 = time.perf_counter()
                if rec is not None:
                    after = lb.imbalance(svc.placement) if lb else None
                    log["moves"].append((lo, hi, dst, int(rec.keys.size),
                                         (t1 - t0) * 1e3, before, after))
                svc._wall_s -= (t0 - t_in) + (time.perf_counter() - t1)
                return rec
            svc.move_range = timed_move
        if svc.replicas is not None:
            rep = svc.replicas
            if rep.max_cid() > rep.floor:
                raise AssertionError("bootstrap replica above its floor")
            refresh = rep.refresh

            def timed_refresh(store, floor, slot_of=None):
                sync()
                t0 = time.perf_counter()
                refresh(store, floor, slot_of=slot_of)
                log["refresh_ms"].append((time.perf_counter() - t0) * 1e3)
                if rep.max_cid() > rep.floor:
                    raise AssertionError(f"replica max_cid {rep.max_cid()} "
                                         f"above its floor {rep.floor}")
            rep.refresh = timed_refresh

    def session(kernels, elastic, replicas=False, n_ticks=ticks,
                move_at=ELASTIC_MOVE_AT, streaming=None, durability=None,
                drain=True, crash=False):
        """Serve the elastic stream; an elastic session makes the explicit
        move after tick ``move_at``.  Returns (svc, report, log)."""
        gen = ycsb_txn_gen(np.random.RandomState(ELASTIC_SEED), cfg.nodes,
                           cfg.kpn, theta=ELASTIC_THETA,
                           read_frac=ELASTIC_READ_FRAC, n_ops=ELASTIC_N_OPS)
        svc = service(kernels, elastic, replicas, durability)
        log = {"moves": [], "refresh_ms": [], "wall": 0.0}
        instrument(svc, log)
        if streaming and on_card and kernels.startswith("cuda"):
            check_dispatch(torch, svc, checked)
        B, K = streaming or (None, None)
        arr = [ELASTIC_LOAD * T] * n_ticks

        def run(part, last):
            if streaming:
                return svc.run_streaming(part, gen, B=B, K=K,
                                         drain=last and drain)
            return svc.run_stream(part, gen, drain=last and drain)
        sync()
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        rep = run(arr[:move_at], False)
        if elastic:
            svc.move_range(0, cfg.kpn // 4, 1)
        if crash:
            return svc, None, log
        if move_at < n_ticks:
            rep = run(arr[move_at:], True)
        sync()
        log["wall"] = time.perf_counter() - t0
        label = (f"{'elastic' if elastic else 'static'}"
                 f"{'+replicas' if replicas else ''} "
                 f"[{kernels}{f' B={B} K={K}' if streaming else ''}]")
        check_route_launches(label, kernels, svc.wave_idx, before, LAUNCHES)
        if drain:
            served_ok(label, svc, rep)
        elif svc.verify():
            raise AssertionError(f"{label}: history fails")
        return svc, rep, log

    def placed(svc):
        return (fates_of(svc), svc.history,
                logical_store(svc.store, svc.placement))

    def show(label, svc, rep, log, ref=None):
        moves = "; ".join(
            f"[{lo},{hi})->{dst}: {k} keys {ms:.2f} ms"
            + (f", load imbalance {b:.4f} -> {a:.4f}" if b is not None
               else "") for lo, hi, dst, k, ms, b, a in log["moves"])
        ref_s = (f", {rep.goodput_tps / ref.goodput_tps:.3f}x static "
                 f"{ref.goodput_tps} txn/s" if ref is not None else "")
        print(f"[elastic] {label}: offered={rep.offered} rejected="
              f"{rep.rejected} committed={rep.committed} (replica "
              f"{rep.replica_commits}) dropped={rep.dropped} waves="
              f"{rep.waves} blocks={rep.blocks} wall={log['wall']:.3f} s "
              f"(report {rep.wall_s:.3f} s) goodput={rep.goodput_tps} txn/s"
              f"{ref_s}; moves={rep.placement_moves} moved_keys="
              f"{rep.moved_keys} occupancy={rep.occupancy} imbalance="
              f"{rep.imbalance} {tag}", flush=True)
        if moves:
            print(f"[elastic]   moves of {label}: {moves} {tag}", flush=True)
        if log["refresh_ms"]:
            r = log["refresh_ms"]
            print(f"[elastic]   replica refreshes of {label}: {len(r)} of "
                  f"{svc.replicas.keys.size} keys, ms "
                  f"{', '.join(f'{x:.3f}' for x in r)}; served reads "
                  f"{svc.replicas.served}, floor {svc.replicas.floor}, "
                  f"max_cid {svc.replicas.max_cid()} {tag}", flush=True)

    # 1. elastic = static, both CUDA routes
    statics = {}
    for kernels in (cuda, fused):
        svc, rep, log = session(kernels, False)
        show(f"static [{kernels}]", svc, rep, log)
        statics[kernels] = ((fates_of(svc), svc.history, svc.store), rep)
        del svc
    (s_run, s_rep), (f_run, _) = statics[cuda], statics[fused]
    same_session(torch, np, f"static [{fused}]", f"static [{cuda}]", s_run,
                 f_run)
    del f_run
    elastic = {}
    for kernels in (cuda, fused):
        svc, rep, log = session(kernels, True)
        label = f"elastic [{kernels}]"
        if rep.placement_moves < 1 or not log["moves"]:
            raise AssertionError(f"{label}: {rep.placement_moves} moves")
        same_session(torch, np, label, f"the static {cuda} session", s_run,
                     placed(svc))
        show(label, svc, rep, log, statics[kernels][1])
        elastic[kernels] = svc
    e_c, e_f = elastic[cuda], elastic[fused]
    if not np.array_equal(e_c.placement.slot, e_f.placement.slot):
        raise AssertionError("elastic sessions moved different keys")
    same_run(torch, np, f"elastic [{fused}] placed store", e_c.history,
             e_c.store, e_f.history, e_f.store)
    print(f"[elastic] elastic = static on {cuda} and {fused}: fates, "
          f"history rows and the logical store equal the static {cuda} "
          f"session; the placed stores equal each other; verify() == []; "
          f"commit_loop once a wave {tag}", flush=True)
    e_run = (fates_of(e_c), e_c.history, e_c.store)
    e_logical = placed(e_c)
    e_map = (e_c.placement.slot.copy(), e_c.placement.owner.copy())
    del elastic, e_f, e_c, statics

    # 2. replicas
    rep_runs = {}
    for kernels in (cuda, fused):
        svc, rep, log = session(kernels, True, replicas=True)
        label = f"elastic+replicas [{kernels}]"
        if rep.replica_commits <= 0 or not log["refresh_ms"]:
            raise AssertionError(f"{label}: {rep.replica_commits} replica "
                                 f"commits, {len(log['refresh_ms'])} "
                                 f"refreshes")
        show(label, svc, rep, log, s_rep)
        rep_runs[kernels] = (fates_of(svc), svc.history, svc.store)
        del svc
    same_session(torch, np, f"elastic+replicas [{fused}]",
                 f"elastic+replicas [{cuda}]", rep_runs[cuda],
                 rep_runs[fused])
    del rep_runs
    short = {}
    for kernels in (plain, cuda):
        svc, rep, log = session(kernels, True, replicas=True,
                                n_ticks=ELASTIC_SHORT, move_at=ELASTIC_CRASH_AT,
                                drain=False)
        show(f"elastic+replicas, {ELASTIC_SHORT} ticks [{kernels}]", svc,
             rep, log)
        short[kernels] = (fates_of(svc), svc.history, svc.store)
        del svc
    same_session(torch, np, f"elastic+replicas {ELASTIC_SHORT} ticks "
                 f"[{cuda}]", f"the {plain} route", short[plain], short[cuda])
    print(f"[elastic] replicas: {cuda} equals {fused}; {cuda} equals "
          f"{plain} over {ELASTIC_SHORT} ticks; max_cid <= floor after "
          f"every refresh {tag}", flush=True)
    del short

    # 3. the placed streaming sessions, every block dispatch checked: B=1,
    # K=1 is the step loop (same fates and history rows; the driver's
    # retire does not run the balancer, so only the explicit move is made
    # and the stores are compared in key order); B=4, K=2 forms up to a
    # block of waves a tick, so it admits another request set, held to
    # the static B=4, K=2 session instead
    n_checked = checked[0]
    o_svc, o_rep, o_log = session(cuda, True, streaming=(1, 1))
    same_session(torch, np, f"elastic [{cuda} B=1 K=1]",
                 f"the placed {cuda} step loop", e_logical, placed(o_svc))
    show(f"elastic [{cuda} B=1 K=1]", o_svc, o_rep, o_log)
    p_svc, p_rep, p_log = session(cuda, True, streaming=(4, 2))
    q_svc, q_rep, q_log = session(cuda, False, streaming=(4, 2))
    same_session(torch, np, f"elastic [{cuda} B=4 K=2]",
                 f"the static {cuda} B=4 K=2 session",
                 (fates_of(q_svc), q_svc.history, q_svc.store),
                 placed(p_svc))
    show(f"elastic [{cuda} B=4 K=2]", p_svc, p_rep, p_log, q_rep)
    show(f"static [{cuda} B=4 K=2]", q_svc, q_rep, q_log)
    if on_card:
        n = checked[0] - n_checked
        if n < o_rep.blocks + p_rep.blocks:
            raise AssertionError("placed block dispatches went unchecked")
        print(f"[elastic] dispatch check: {n} block dispatches of the placed "
              f"B=1 K=1 and B=4 K=2 sessions and the static one ran under "
              f"sync debug mode 'error', none waited on the card {tag}",
              flush=True)
    print(f"[elastic] streaming under the placement: B=1 K=1 equals the "
          f"placed step loop (fates, histories, logical store); B=4 K=2 "
          f"equals the static B=4 K=2 session (fates, histories, logical "
          f"store) {tag}", flush=True)
    del o_svc, p_svc, q_svc

    # 4. durable: the first session logged, recovered; a crash and restart
    root = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    try:
        d = os.path.join(root, "durable")
        mgr = DurabilityManager(d, fsync_every=1,
                                snapshot_every=ELASTIC_SNAPSHOT_EVERY)
        svc, rep, log = session(cuda, True, durability=mgr)
        mgr.close()
        same_session(torch, np, f"durable elastic [{cuda}]",
                     f"the elastic {cuda} session", e_run,
                     (fates_of(svc), svc.history, svc.store))
        if not (np.array_equal(svc.placement.slot, e_map[0])
                and mgr.snapshots_taken):
            raise AssertionError("durable elastic session: map or snapshots")
        show(f"durable elastic [{cuda}]", svc, rep, log)
        print(f"[elastic] durable elastic [{cuda}] equals the non-durable "
              f"session; {mgr.snapshots_taken} snapshots of "
              f"{sum(t.numel() * t.element_size() for t in svc.store)} "
              f"bytes, {rep.placement_moves} REC_MOVE records {tag}",
              flush=True)

        def recovered(lbl, dd, live, kernels, use_snapshot):
            sync()
            before = dict(LAUNCHES)
            t0 = time.perf_counter()
            st = recover(dd, kernels=kernels, device=dev,
                         use_snapshot=use_snapshot)
            sync()
            dt = time.perf_counter() - t0
            check_route_launches(lbl, kernels, len(st.history), before,
                                 LAUNCHES)
            same_state(torch, lbl, st, live)
            for f in ("slot", "owner"):
                if not np.array_equal(getattr(st.placement_map, f),
                                      getattr(live.placement, f)):
                    raise AssertionError(f"{lbl}: {f} differs from live")
            sec = st.seconds
            print(f"[elastic] {lbl}: {dt:.3f} s (scan {sec['scan']:.4f}, "
                  f"snapshot restore {sec['snapshot']:.4f}, replay "
                  f"{sec['replay']:.4f}), {st.n_replayed} of {st.n_blocks} "
                  f"blocks and {st.n_records - st.n_blocks} moves in the "
                  f"log, snapshot {st.snapshot_seq}; equal to the live "
                  f"store, slot, owner, clock, wave index, GC clock, next "
                  f"TID {tag}", flush=True)
        recovered(f"recover [{cuda}, snapshot + suffix]", d, svc, cuda,
                  True)
        recovered(f"recover [{fused}, full replay]", d, svc, fused, False)
        del svc

        c_d = os.path.join(root, "crashed")
        c_mgr = DurabilityManager(c_d, fsync_every=1,
                                  snapshot_every=ELASTIC_SNAPSHOT_EVERY)
        crashed, _, _ = session(cuda, True, durability=c_mgr,
                                n_ticks=ELASTIC_SHORT,
                                move_at=ELASTIC_CRASH_AT, crash=True)
        c_mgr.crash()
        from repro_torch.durability import wal
        recs = wal.scan(c_mgr.wal_path).records
        if recs[-1][0] != wal.REC_MOVE or sum(
                rt == wal.REC_MOVE for rt, _ in recs) != 1:
            raise AssertionError("the crash did not follow the first move")
        for kernels, use_snapshot in ((cuda, True), (fused, False),
                                      (plain, True)):
            recovered(f"recover after the crash [{kernels}, "
                      f"{'snapshot' if use_snapshot else 'full replay'}]",
                      c_d, crashed, kernels, use_snapshot)
        t0 = time.perf_counter()
        r_mgr = DurabilityManager(c_d, fsync_every=1,
                                  snapshot_every=ELASTIC_SNAPSHOT_EVERY)
        svc2 = service(cuda, True, durability=r_mgr)
        t_restart = time.perf_counter() - t0
        if not np.array_equal(svc2.placement.slot, crashed.placement.slot):
            raise AssertionError("the restart did not adopt the map")
        gen = ycsb_txn_gen(np.random.RandomState(ELASTIC_SEED + 1),
                           cfg.nodes, cfg.kpn, theta=ELASTIC_THETA,
                           read_frac=ELASTIC_READ_FRAC, n_ops=ELASTIC_N_OPS)
        r_rep = svc2.run_stream([ELASTIC_LOAD * T] * 2, gen)
        r_mgr.close()
        served_ok("restarted elastic service", svc2, r_rep)
        print(f"[elastic] crash right after the first REC_MOVE record "
              f"({len(recs)} records); restart {t_restart:.3f} s adopted "
              f"the replayed map, served 2 more ticks ({r_rep.committed} "
              f"committed), verify() == [] {tag}", flush=True)
        del svc2, crashed
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------------- phases 4m and 5m
def mesh_wave_launches(route, n_nodes, T, n_waves):
    """The launches ``n_waves`` mesh waves make on ``route``: the read
    phase on every node's block (``version_scan`` once a node on ``cuda``
    with one ``potential_matrix`` from the global keys, ``wave_commit``
    once a node on ``cuda+fused``) and the plain commit loop's per-step
    read on every node (``version_scan`` N a step); never ``commit_loop``."""
    if route == "cuda":
        return {"version_scan": n_waves * n_nodes * (T + 1),
                "potential_matrix": n_waves, "wave_commit": 0,
                "commit_loop": 0}
    return {"version_scan": n_waves * n_nodes * T, "potential_matrix": 0,
            "wave_commit": n_waves * n_nodes, "commit_loop": 0}


def mesh_engine_phase(torch, dev, cfg, card, routes=("cuda", "cuda+fused"),
                      plain="torch"):
    """Phase 4m: phase 4's store sharded over ``make_node_mesh(nodes)``
    and ``--mesh-waves`` of its waves for every scheduler through
    ``run_workload_fused_dist`` and ``run_workload_dist`` on each route of
    ``routes``, each equal to the single-device ``routes[0]`` run (WaveOut,
    stats, store) and launching what ``mesh_wave_launches`` says; one
    postsi wave on the mesh's ``plain`` route equal to it too."""
    import numpy as np
    from repro_torch.core import (SCHEDULERS, make_node_mesh, make_store,
                                  run_workload_dist, run_workload_fused,
                                  run_workload_fused_dist, shard_store)
    from repro_torch.core.workloads import smallbank_waves
    from repro_torch.kernels import LAUNCHES
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    n_keys, W = cfg.nodes * cfg.kpn, cfg.mesh_waves
    mesh = make_node_mesh(cfg.nodes, dev)
    waves = smallbank_waves(np.random.RandomState(cfg.seed), W, cfg.T,
                            cfg.nodes, cfg.kpn, dist_frac=0.2, device=dev)
    scheds = SCHEDULERS if cfg.scheds == "all" else cfg.scheds.split(",")
    ref_route = routes[0]
    for sched in scheds:
        sync()
        t0 = time.perf_counter()
        ref_store, ref_hist, stats = run_workload_fused(
            make_store(n_keys, cfg.V, device=dev), waves, sched=sched,
            n_nodes=cfg.nodes, gc_track=True, kernels=ref_route)
        sync()
        one_ms = (time.perf_counter() - t0) * 1e3 / W
        times = []
        for route in routes:
            for drv in (run_workload_fused_dist, run_workload_dist):
                store = shard_store(make_store(n_keys, cfg.V, device=dev),
                                    mesh)
                sync()
                before = dict(LAUNCHES)
                t0 = time.perf_counter()
                store, hist, m_stats = drv(store, waves, mesh, sched=sched,
                                           gc_track=True, kernels=route)
                sync()
                ms = (time.perf_counter() - t0) * 1e3 / W
                label = f"mesh {sched}/{route}/{drv.__name__}"
                same_run(torch, np, label, ref_hist, ref_store, hist, store)
                if m_stats != stats:
                    raise AssertionError(f"{label}: stats {m_stats} vs "
                                         f"{stats}")
                if on_card:
                    got = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
                    want = mesh_wave_launches(route, cfg.nodes, cfg.T, W)
                    if any(got[k] != v for k, v in want.items()):
                        raise AssertionError(f"{label}: launches {got}, "
                                             f"expected {want}")
                times.append(f"{route} {drv.__name__} {ms:.1f}")
                del store
        print(f"[mesh] {sched:8s} {W} waves of T={cfg.T} on {cfg.nodes} "
              f"nodes x {cfg.kpn} rows equal the single-device {ref_route} "
              f"run (WaveOut, stats, store); ms a wave: "
              f"{'; '.join(times)}; single device {ref_route} {one_ms:.2f} "
              f"({card})", flush=True)
        del ref_store
    # the mesh's plain route: one postsi wave
    one = waves[:1]
    ref_store, ref_hist, _ = run_workload_fused(
        make_store(n_keys, cfg.V, device=dev), one, n_nodes=cfg.nodes,
        gc_track=True, kernels=ref_route)
    sync()
    t0 = time.perf_counter()
    store, hist, _ = run_workload_fused_dist(
        shard_store(make_store(n_keys, cfg.V, device=dev), mesh), one, mesh,
        gc_track=True, kernels=plain)
    sync()
    same_run(torch, np, f"mesh postsi/{plain}", ref_hist, ref_store, hist,
             store)
    print(f"[mesh] postsi 1 wave on the mesh's {plain} route equals the "
          f"single-device {ref_route} wave: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms ({card})", flush=True)


def mesh_service_phase(torch, dev, cfg, card, checked,
                       routes=("cuda", "cuda+fused")):
    """Phase 5m: phase 5's stream (T=64, Poisson arrivals, postsi) for
    ``--mesh-ticks`` ticks served on ``make_node_mesh(nodes)``:
    ``TxnService(mesh=...)`` on each route equal to the single-device
    ``routes[0]`` session; ``run_streaming`` B=4, K=2 on the mesh equal to
    the single-device B=4, K=2 session, every mesh block dispatch under
    sync debug mode "error"; a durable mesh session recovered onto the
    mesh on ``routes[0]`` (from its snapshot and by full replay) and onto
    one device on ``routes[1]`` by full replay; phase 5d's elastic deployment on the mesh (balancer, one
    explicit move) equal to the static mesh session."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.core import make_node_mesh
    from repro_torch.core.workloads import poisson_arrivals
    from repro_torch.durability import DurabilityManager, recover
    from repro_torch.kernels import LAUNCHES
    from repro_torch.placement import PlacementMap, logical_store
    from repro_torch.service import (TxnService, smallbank_txn_gen,
                                     ycsb_txn_gen)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cuda, fused = routes
    n_keys, T, ticks = cfg.nodes * cfg.kpn, cfg.service_T, cfg.mesh_ticks
    mesh = make_node_mesh(cfg.nodes, dev)
    tag = f"({card})"
    n_checked = checked[0]

    def serve(kernels, on_mesh, streaming=None, durability=None,
              check=False):
        rng = np.random.RandomState(cfg.seed + 1)
        arrivals = poisson_arrivals(rng, cfg.rate, ticks)
        svc = TxnService(n_keys=n_keys, n_versions=cfg.V, T=T,
                         sched="postsi", n_nodes=cfg.nodes, kernels=kernels,
                         device=dev, mesh=mesh if on_mesh else None,
                         durability=durability)
        if check and on_card:
            check_dispatch(torch, svc, checked)
        gen = smallbank_txn_gen(rng, cfg.nodes, cfg.kpn, dist_frac=0.2)
        sync()
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        rep = (svc.run_streaming(arrivals, gen, B=streaming[0],
                                 K=streaming[1]) if streaming
               else svc.run_stream(arrivals, gen))
        sync()
        wall = time.perf_counter() - t0
        label = (f"{'mesh' if on_mesh else 'one device'} [{kernels}"
                 f"{f' B={streaming[0]} K={streaming[1]}' if streaming else ''}"
                 f"]")
        served_ok(label, svc, rep)
        if on_mesh and on_card and (LAUNCHES["commit_loop"]
                                    != before["commit_loop"]
                                    or LAUNCHES["version_scan"]
                                    == before["version_scan"]):
            raise AssertionError(f"{label}: the mesh ran commit_loop or no "
                                 f"version_scan")
        print(f"[mesh] service {label}: offered={rep.offered} committed="
              f"{rep.committed} dropped={rep.dropped} waves={rep.waves} "
              f"blocks={rep.blocks} wall={wall:.3f} s (report "
              f"{rep.wall_s:.3f} s, {rep.wall_s * 1e3 / max(rep.waves, 1):.1f}"
              f" ms a wave) goodput={rep.goodput_tps} txn/s p50="
              f"{rep.latency_p50} p99={rep.latency_p99} ticks {tag}",
              flush=True)
        return svc, rep

    one, one_rep = serve(cuda, False)
    ref = (fates_of(one), one.history, one.store)
    for kernels in routes:
        svc, rep = serve(kernels, True)
        same_session(torch, np, f"mesh service [{kernels}]",
                     f"the single-device {cuda} session", ref,
                     (fates_of(svc), svc.history, svc.store))
        print(f"[mesh] service [{kernels}] on {cfg.nodes} nodes equals the "
              f"single-device {cuda} session (fates, history, store), "
              f"verify() == []; goodput {rep.goodput_tps} txn/s beside "
              f"{one_rep.goodput_tps} txn/s on one device "
              f"({rep.goodput_tps / one_rep.goodput_tps:.4f}x) {tag}",
              flush=True)
        del svc
    del one, ref

    s_one, _ = serve(cuda, False, streaming=(4, 2))
    s_ref = (fates_of(s_one), s_one.history, s_one.store)
    del s_one
    for kernels in routes:
        svc, rep = serve(kernels, True, streaming=(4, 2), check=True)
        same_session(torch, np, f"mesh streaming [{kernels} B=4 K=2]",
                     f"the single-device {cuda} B=4 K=2 session", s_ref,
                     (fates_of(svc), svc.history, svc.store))
        del svc
    if on_card:
        print(f"[mesh] dispatch check: {checked[0] - n_checked} mesh block "
              f"dispatches ran under sync debug mode 'error', none waited "
              f"on the card {tag}", flush=True)

    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        d = os.path.join(root, "durable")
        mgr = DurabilityManager(d, fsync_every=DURABLE_FSYNC_EVERY,
                                snapshot_every=DURABLE_SNAPSHOT_EVERY)
        live, rep = serve(cuda, True, streaming=(4, 2), durability=mgr,
                          check=True)
        mgr.close()
        same_session(torch, np, f"durable mesh [{cuda} B=4 K=2]",
                     "the non-durable mesh session", s_ref,
                     (fates_of(live), live.history, live.store))
        for lbl, kw in ((f"recover onto the mesh [{cuda}]",
                         dict(mesh=mesh, kernels=cuda)),
                        (f"recover onto the mesh [{cuda}, full replay]",
                         dict(mesh=mesh, kernels=cuda, use_snapshot=False)),
                        (f"recover onto one device [{fused}, full replay]",
                         dict(kernels=fused, device=dev,
                              use_snapshot=False))):
            sync()
            t0 = time.perf_counter()
            st = recover(d, **kw)
            sync()
            same_state(torch, lbl, st, live)
            sec = st.seconds
            print(f"[mesh] {lbl}: {time.perf_counter() - t0:.3f} s (scan "
                  f"{sec['scan']:.4f}, snapshot restore "
                  f"{sec['snapshot']:.4f}, replay {sec['replay']:.4f}), "
                  f"{st.n_replayed} of {st.n_blocks} blocks replayed, "
                  f"snapshot {st.snapshot_seq}; equal to the live mesh "
                  f"session {tag}", flush=True)
        del live, st
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del s_ref

    # phase 5d's elastic deployment on the mesh, against the static mesh
    def elastic(placed):
        gen = ycsb_txn_gen(np.random.RandomState(ELASTIC_SEED), cfg.nodes,
                           cfg.kpn, theta=ELASTIC_THETA,
                           read_frac=ELASTIC_READ_FRAC, n_ops=ELASTIC_N_OPS)
        svc = TxnService(
            n_keys=n_keys, n_versions=cfg.V, T=T, O=ELASTIC_N_OPS,
            sched="postsi", n_nodes=cfg.nodes, seed=0, kernels=cuda,
            mesh=mesh, placement=(PlacementMap(n_keys, cfg.nodes,
                                               headroom=ELASTIC_HEADROOM)
                                  if placed else None),
            balancer=True if placed else None)
        arr = [ELASTIC_LOAD * T] * ticks
        sync()
        t0 = time.perf_counter()
        svc.run_stream(arr[:ticks // 2], gen, drain=False)
        if placed:
            svc.move_range(0, cfg.kpn // 4, 1)
        rep = svc.run_stream(arr[ticks // 2:], gen)
        sync()
        wall = time.perf_counter() - t0
        label = f"{'elastic' if placed else 'static'} mesh [{cuda}]"
        served_ok(label, svc, rep)
        print(f"[mesh] {label}: rows={svc.store.n_keys} committed="
              f"{rep.committed} waves={rep.waves} wall={wall:.3f} s "
              f"goodput={rep.goodput_tps} txn/s moves={rep.placement_moves}"
              f" moved_keys={rep.moved_keys} {tag}", flush=True)
        return svc, rep
    st_svc, _ = elastic(False)
    el_svc, el_rep = elastic(True)
    if el_rep.placement_moves < 1:
        raise AssertionError("elastic mesh: no move")
    same_session(torch, np, f"elastic mesh [{cuda}]", "the static mesh",
                 (fates_of(st_svc), st_svc.history, st_svc.store),
                 (fates_of(el_svc), el_svc.history,
                  logical_store(el_svc.store, el_svc.placement)))
    print(f"[mesh] elastic mesh equals the static mesh session (fates, "
          f"history rows, logical store) over {ticks} ticks, "
          f"{el_rep.placement_moves} moves {tag}", flush=True)


def parse_config(argv=None) -> Config:
    """The fixed configuration, with only its depth taken from the flags."""
    full = Config()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--waves", type=int, default=full.waves,
                    help="engine waves per scheduler and route")
    ap.add_argument("--scheds", default=full.scheds,
                    help="'all' or a comma-separated list of schedulers")
    ap.add_argument("--ticks", type=int, default=full.ticks,
                    help="service ticks of arrivals before the drain")
    ap.add_argument("--planned-waves", type=int, default=full.planned_waves,
                    help="waves run_workload_planned replays")
    ap.add_argument("--elastic-ticks", type=int, default=full.elastic_ticks,
                    help="ticks of arrivals of phase 5d's elastic stream")
    ap.add_argument("--mesh-waves", type=int, default=full.mesh_waves,
                    help="waves of phase 4m's mesh engine runs")
    ap.add_argument("--mesh-ticks", type=int, default=full.mesh_ticks,
                    help="ticks of arrivals of phase 5m's mesh sessions")
    ap.add_argument("--serve-batches", type=int, default=full.serve_batches,
                    choices=range(1, len(SERVE_PROMPTS) + 1),
                    help="served batches, the first ones of SERVE_PROMPTS")
    ap.add_argument("--new-tokens", type=int, default=full.new_tokens,
                    help="tokens generated per served batch")
    args = ap.parse_args(argv)
    return full._replace(waves=args.waves, scheds=args.scheds,
                         ticks=args.ticks, serve_batches=args.serve_batches,
                         new_tokens=args.new_tokens,
                         planned_waves=args.planned_waves,
                         elastic_ticks=args.elastic_ticks,
                         mesh_waves=args.mesh_waves,
                         mesh_ticks=args.mesh_ticks)


def main(argv=None) -> int:
    cfg = parse_config(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.kernels.build import build_info, library, nvcc_path

    dev = torch.device("cuda:0")
    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    library()
    print(f"[build] kernels ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build_info.get('seconds', 0.0):.2f} s, "
          f"cached={build_info.get('cached')}) -> {build_info['path']}",
          flush=True)
    for line in build_info.get("log", "").splitlines():
        if ("registers" in line or "spill" in line or line.startswith("==")
                or "entry function" in line):
            print(f"[build] {line.strip()}", flush=True)
    tensor_core_check(build_info["path"], nvcc_path())

    import numpy as np
    records, tables = kernel_phase(torch, dev, cfg.nodes * cfg.kpn, cfg.V,
                                   cfg.T, cfg.O)
    loop_record, loop_fn = commit_loop_phase(torch, np, dev, cfg)
    records.update(loop_record)
    engine_device_ms(torch, tables, records, loop_fn["commit_loop"], cfg.T,
                     cfg.O)
    del tables
    records.update(model_kernel_phase(torch, dev))

    profile_wave(torch, dev, cfg)
    # each path with the counts set to 0 just before it and read just after
    reset_launch_counts()
    t0 = time.perf_counter()
    engine_phase(torch, dev, cfg)
    step_runs = service_phase(torch, dev, cfg)
    print(f"[main path] engine + service: {time.perf_counter() - t0:.1f} s, "
          f"kernel launches {dict(LAUNCHES)}", flush=True)
    t1 = time.perf_counter()
    checked, streamed = streaming_phase(torch, dev, cfg, step_runs)
    del step_runs
    planner_phase(torch, dev, cfg, checked)
    engine_counts = dict(LAUNCHES)
    print(f"[main path] streaming + planner: {time.perf_counter() - t1:.1f} "
          f"s, {checked[0]} block dispatches checked for host waits; kernel "
          f"launches of engine, service, streaming and planner "
          f"{engine_counts}", flush=True)
    reset_launch_counts()
    t1 = time.perf_counter()
    durability_phase(torch, dev, cfg, streamed, checked)
    del streamed
    durable_counts = dict(LAUNCHES)
    if durable_counts["commit_loop"] <= 0:
        raise AssertionError("recovery replayed no wave through commit_loop")
    print(f"[main path] durability: {time.perf_counter() - t1:.1f} s, "
          f"{checked[0]} block dispatches checked in all; kernel launches "
          f"of durable serving, recovery and restart {durable_counts}",
          flush=True)
    engine_counts = {k: v + durable_counts[k]
                     for k, v in engine_counts.items()}
    placed_corner_check(torch, dev, cfg, card)
    reset_launch_counts()
    t1 = time.perf_counter()
    elastic_phase(torch, dev, cfg, card, checked)
    elastic_counts = dict(LAUNCHES)
    print(f"[main path] elastic placement: {time.perf_counter() - t1:.1f} s,"
          f" {checked[0]} block dispatches checked in all; kernel launches "
          f"of the placed sessions and their recoveries {elastic_counts}",
          flush=True)
    engine_counts = {k: v + elastic_counts[k]
                     for k, v in engine_counts.items()}
    reset_launch_counts()
    t1 = time.perf_counter()
    mesh_engine_phase(torch, dev, cfg, card)
    mesh_service_phase(torch, dev, cfg, card, checked)
    mesh_counts = dict(LAUNCHES)
    for name in ("version_scan", "potential_matrix", "wave_commit"):
        if mesh_counts[name] <= 0:
            raise AssertionError(f"{name} never launched on the mesh path")
    print(f"[main path] node mesh: {time.perf_counter() - t1:.1f} s, "
          f"{checked[0]} block dispatches checked in all; kernel launches "
          f"of the mesh engine and service runs and their single-device "
          f"references (not in the kernels line) {mesh_counts}", flush=True)
    t0 = time.perf_counter()
    serve_counts = serve_phase(torch, dev, cfg, card)
    print(f"[main path] serve: {time.perf_counter() - t0:.1f} s with its "
          f"measurements, kernel launches {serve_counts}", flush=True)
    paths = {"version_scan": engine_counts, "potential_matrix": engine_counts,
             "wave_commit": engine_counts, "commit_loop": engine_counts,
             "flash_attention": serve_counts,
             "ssd_scan": serve_counts}
    for name, counts in paths.items():
        if counts[name] <= 0:
            raise AssertionError(f"{name} never launched on its path")
        records[name]["launches"] = counts[name]

    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
