#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

Run from the repository root, with one CUDA device:

    python3 chip_smoke.py

Phases (any failure raises, so the process exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc);
3. each kernel against its plain PyTorch version on the card, bit-equal,
   at the main path's shapes and on adversarial inputs, with CUDA-event
   times of both;
4. engine: 16 SmallBank waves of T=256 over a 1,000,000-account store
   (8 nodes x 125,000 accounts, V=8, 20% distributed) through
   ``run_workload_fused`` for all six schedulers under the ``cuda``,
   ``cuda+fused``, ``torch`` and ``torch+fused`` routes; every route equal
   to ``torch`` bit for bit, histories verified;
5. service: a Poisson SmallBank stream through ``TxnService`` over the same
   1,000,000 accounts, ``verify() == []``, under ``torch``, ``cuda`` and
   ``cuda+fused``; the CUDA routes' request fates, histories and final
   stores equal the ``torch`` route's;
6. one JSON line of per-kernel results, with the launches the kernels
   made during phases 4-5 (each must be > 0), the card line again, and
   last ``{"ok": true, "device": {...}}``.

The store, wave and stream sizes are fixed (the constants below); the
flags cut only the depth: ``--waves``, ``--scheds`` and ``--ticks``.

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

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the non-tensor-core
# 32-bit rate, taken here for the kernels' integer compares
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12


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
    waves: int = 16
    scheds: str = "all"
    ticks: int = 32


KERNELS = {
    "version_scan": ("src/repro_torch/kernels/csrc/version_scan.cu",
                     "src/repro/kernels/version_scan.py:41"),
    "potential_matrix": ("src/repro_torch/kernels/csrc/interval_negotiate.cu",
                         "src/repro/kernels/interval_negotiate.py:39"),
    "wave_commit": ("src/repro_torch/kernels/csrc/wave_commit.cu",
                    "src/repro/kernels/wave_commit.py:90"),
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the ALU rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ALU_OPS_PER_S * 1e3
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


# ---------------------------------------------------------------- phase 3
def kernel_phase(torch, dev, n_keys, V, T, O):
    """Each kernel vs its plain version on the card; returns per-kernel
    records of the main-path shape (T*O requests, a T-txn wave)."""
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

    # version_scan: M = T*O on the read phase, M = O on each commit step
    for M in (T * O, O, 40):
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
    print(f"[kernels] {len(checks)} checks, all bit-equal to the plain "
          f"versions", flush=True)

    # times at the main path's shapes
    M = T * O
    k = keys_for((M,), 0)
    mc = torch.full((M,), 1 << 30, **i32)
    vs = (cid, tid, mc, k)
    ms = {}
    ms["version_scan"] = (cuda_ms(torch, lambda: version_scan_cuda(*vs)),
                          cuda_ms(torch, lambda: version_scan_plain(*vs)))
    vs_o = (cid, tid, mc[:O].contiguous(), k[:O].contiguous())
    ms_o = (cuda_ms(torch, lambda: version_scan_cuda(*vs_o)),
            cuda_ms(torch, lambda: version_scan_plain(*vs_o)))
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
    print(f"[kernels] version_scan at M={O} (one commit step): "
          f"{ms_o[0]:.5f} ms/call (plain {ms_o[1]:.5f})", flush=True)
    device_ms(torch, {"version_scan": lambda: version_scan_cuda(*vs),
                      "potential_matrix": lambda: potential_matrix_cuda(
                          rk, wk),
                      "wave_commit": lambda: wave_commit_cuda(*wc, keys=kw)},
              records)
    return records


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


def device_ms(torch, fns, records, iters=50):
    """Kernel-only device time from the profiler's CUDA trace, where the
    profiler sees the device; recorded as ``device_ms`` (else None)."""
    for rec in records.values():
        rec["device_ms"] = None
    prof = start_profiler("kernels")
    for _ in range(iters):
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    if stop_profiler(prof, "kernels"):
        for evt in prof.key_averages():
            for name in fns:
                if evt.key.startswith(f"{name}_kernel"):
                    total = getattr(evt, "device_time_total",
                                    getattr(evt, "cuda_time_total", 0))
                    records[name]["device_ms"] = total / 1e3 / iters
    print("[kernels] profiler device ms/launch: "
          + ", ".join(f"{n}={r['device_ms']}" for n, r in records.items()),
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


def engine_phase(torch, dev, cfg,
                 routes=("torch", "cuda", "cuda+fused", "torch+fused")):
    import numpy as np
    from repro_torch.core import (SCHEDULERS, final_values_ok, make_store,
                                  run_workload_fused, verify_cv, verify_si)
    from repro_torch.core.workloads import smallbank_waves
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
            t0 = time.perf_counter()
            store, hist, stats = run_workload_fused(
                store, waves, sched=sched, n_nodes=cfg.nodes,
                gc_track=True, kernels=route)
            sync()
            dt = time.perf_counter() - t0
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
    postsi SmallBank wave on each CUDA route.  Measurement only."""
    import numpy as np
    from repro_torch.core import make_store, run_wave
    from repro_torch.core.workloads import smallbank_waves
    (wave,) = smallbank_waves(np.random.RandomState(cfg.seed + 2), 1,
                              cfg.T, cfg.nodes, cfg.kpn, dist_frac=0.2,
                              device=dev)
    for route in ("cuda", "cuda+fused"):
        store = make_store(cfg.nodes * cfg.kpn, cfg.V, device=dev)
        run_wave(store, wave, 1, 1, cfg.nodes, kernels=route)    # warm-up
        torch.cuda.synchronize()
        prof = start_profiler("profile")
        t0 = time.perf_counter()
        run_wave(store, wave, 2, 1, cfg.nodes, kernels=route)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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
    others must equal per request, per wave and in the final store."""
    import numpy as np
    from repro_torch.core.workloads import poisson_arrivals
    from repro_torch.service import TxnService, smallbank_txn_gen
    ref = None
    for kernels in routes:
        rng = np.random.RandomState(cfg.seed + 1)
        arrivals = poisson_arrivals(rng, cfg.rate, cfg.ticks)
        svc = TxnService(n_keys=cfg.nodes * cfg.kpn, n_versions=cfg.V,
                         T=cfg.service_T, sched="postsi", n_nodes=cfg.nodes,
                         kernels=kernels, device=dev)
        rep = svc.run_stream(arrivals, smallbank_txn_gen(
            rng, cfg.nodes, cfg.kpn, dist_frac=0.2))
        errs = svc.verify()
        if errs:
            raise AssertionError(f"service [{kernels}] history fails: "
                                 f"{errs[:3]}")
        if rep.committed + rep.dropped != rep.admitted:
            raise AssertionError(f"service [{kernels}]: admitted requests "
                                 f"did not all commit or drop")
        fates = [(r.status, r.tids, r.s, r.c) for r in svc.requests]
        if ref is None:
            ref = (fates, svc.history, svc.store)
        else:
            if fates != ref[0]:
                raise AssertionError(f"service [{kernels}]: request fates "
                                     f"differ from the {routes[0]} route")
            same_run(torch, np, f"service [{kernels}]", ref[1], ref[2],
                     svc.history, svc.store)
        print(f"[service] {kernels:10s} offered={rep.offered} "
              f"committed={rep.committed} dropped={rep.dropped} "
              f"waves={rep.waves} wall={rep.wall_s:.3f} s "
              f"goodput={rep.goodput_tps} txn/s retry_rate={rep.retry_rate}"
              f" p50={rep.latency_p50} p99={rep.latency_p99} ticks",
              flush=True)


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
    args = ap.parse_args(argv)
    return full._replace(waves=args.waves, scheds=args.scheds,
                         ticks=args.ticks)


def main(argv=None) -> int:
    cfg = parse_config(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.kernels.build import build_info, library

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
        if "registers" in line or line.startswith("=="):
            print(f"[build] {line.strip()}", flush=True)

    records = kernel_phase(torch, dev, cfg.nodes * cfg.kpn, cfg.V, cfg.T,
                           cfg.O)

    profile_wave(torch, dev, cfg)
    reset_launch_counts()
    t0 = time.perf_counter()
    engine_phase(torch, dev, cfg)
    service_phase(torch, dev, cfg)
    counts = dict(LAUNCHES)
    print(f"[main path] {time.perf_counter() - t0:.1f} s, kernel launches "
          f"{counts}", flush=True)
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
        records[name]["launches"] = n

    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
