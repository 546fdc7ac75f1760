"""Device time of the read-phase kernels (``version_scan``,
``potential_matrix``, ``wave_commit``) at the engine path's shape, for the
checkout this file sits in, on one CUDA device.

    python3 scripts/read_phase_ab.py [--reps N]

The path's shape: waves of T=256 SmallBank txns of O=4 ops over a store of
1,000,000 rows of V=8 slots (four [N, V] int32 tables, 128 MB together),
rings filled as a live store's (CIDs unique in a ring, 30% empty slots).
Each kernel is timed by the profiler (kernel-only device ms a launch), in
one session with an empty kernel, whose device time is the launch floor:

* warm: one key set, called again and again, so its rows stay in L2;
* cold: a rotating pool of ``SETS`` key sets drawn over the whole store;
  a set's rings are 128 KB, the pool's 128 MB, so the rows a launch
  gathers were evicted since their set's last turn, as an engine wave's
  are.  Each call first copies its set's per-op inputs (one copy kernel,
  outside the kernel's time), since the engine's read phase makes them
  fresh just before the launch; only the rings are cold.

The kernels are called in turns, in the order named above, so
``potential_matrix`` runs right after ``version_scan``, as on the unfused
``cuda`` route, where both launch once a wave; their sum is printed as
that route's read phase.
``measure`` is also what ``chip_smoke.py`` prints.  Each measurement runs
once unrecorded, then ``--reps`` times; every run and the median are
printed with the card's name and power limit.  To compare two trees copy
this file and ``probes.py`` into the other checkout's ``scripts/`` and run
the two in alternating processes (A, B, B, A, ...): the kernels' wrappers
take the same arguments in both.  Nothing of the port imports this script.
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import probes  # noqa: E402
from repro_torch.kernels.interval_negotiate import \
    potential_matrix_cuda  # noqa: E402
from repro_torch.kernels.version_scan import version_scan_cuda  # noqa: E402
from repro_torch.kernels.wave_commit import wave_commit_cuda  # noqa: E402

N_KEYS, V, T, O = 1_000_000, 8, 256, 4
SETS = 1024                  # key sets of the cold pool
WARM_ITERS = 50
KERNELS = ("version_scan", "potential_matrix", "wave_commit")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def store_tables(dev, seed=0, n_keys=N_KEYS, v=V):
    """(cid, tid, sid, val) [n_keys, v] int32 of a live-looking store:
    CIDs unique and >= 0 in a ring, 30% empty slots (tid -1)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ri = lambda lo, hi, shape: torch.randint(lo, hi, shape, generator=g,
                                             dtype=torch.int32, device=dev)
    cid = (torch.rand((n_keys, v), generator=g, device=dev).argsort(1) * 3
           + ri(0, 3, (n_keys, 1))).to(torch.int32).contiguous()
    tid = torch.where(torch.rand((n_keys, v), generator=g, device=dev) < 0.3,
                      -1, ri(1, 1 << 20, (n_keys, v))).to(torch.int32)
    return cid, tid, ri(0, 1 << 16, (n_keys, v)), ri(-1000, 1000, (n_keys, v))


def calls(tables, t=T, o=O, sets=SETS, seed=1):
    """({kernel: warm call}, {kernel: cold call}) at a wave of t txns of o
    ops over ``tables``; the cold calls rotate through ``sets`` key sets,
    each kernel a third of the pool apart from the others."""
    dev, n_keys = tables[0].device, tables[0].shape[0]
    g = torch.Generator(device=dev).manual_seed(seed)
    # keys, read keys, write keys of every set; rvalid = is_read
    keys = torch.randint(0, n_keys, (sets, t, o), generator=g,
                         dtype=torch.int32, device=dev)
    is_r = torch.rand((sets, t, o), generator=g, device=dev) < 0.6
    is_w = torch.rand((sets, t, o), generator=g, device=dev) < 0.5
    pool = torch.stack([keys, torch.where(is_r, keys, -1),
                        torch.where(is_w, keys, -1)], 1).contiguous()
    mc = torch.full((t, o), 1 << 30, dtype=torch.int32, device=dev)

    def vs(j):
        k = pool[j, 0].clone().view(-1)
        return version_scan_cuda(tables[0], tables[1], mc.view(-1), k)

    def pm(j):
        rw = pool[j, 1:].clone()
        return potential_matrix_cuda(rw[0], rw[1])

    def wc(j):
        x = pool[j].clone()
        return wave_commit_cuda(*tables, mc, x[1], x[2], is_r[j].clone(),
                                keys=x[0])

    def rotating(fn, offset):
        turn = [offset]

        def call():
            turn[0] = (turn[0] + 1) % sets
            return fn(turn[0])
        return call

    # warm: set 0's inputs, copied once
    x0, rv0 = pool[0].clone(), is_r[0].clone()
    warm = {"version_scan": lambda: version_scan_cuda(
                tables[0], tables[1], mc.view(-1), x0[0].view(-1)),
            "potential_matrix": lambda: potential_matrix_cuda(x0[1], x0[2]),
            "wave_commit": lambda: wave_commit_cuda(
                *tables, mc, x0[1], x0[2], rv0, keys=x0[0])}
    cold = {name: rotating(fn, k * sets // 3)
            for k, (name, fn) in enumerate(zip(KERNELS, (vs, pm, wc)))}
    return warm, cold


def measure(lib, warm, cold, extra=None, sets=SETS) -> dict:
    """Device ms a launch: {"warm": {kernel: ms, ..., "empty": ms},
    "cold": {...}}; ``extra`` ({name: (fn, kernel)}) joins the warm
    session."""
    empty = (probes.empty_call(lib), probes.EMPTY_KERNEL)
    w = {n: (f, f"{n}_kernel") for n, f in warm.items()}
    c = {n: (f, f"{n}_kernel") for n, f in cold.items()}
    return {"warm": probes.profile_device_ms(
                {**w, **(extra or {}), "empty": empty}, WARM_ITERS),
            "cold": probes.profile_device_ms({**c, "empty": empty}, sets)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    reps = ap.parse_args().reps
    if not torch.cuda.is_available():
        print("read_phase_ab: no CUDA device", file=sys.stderr)
        return 2
    card, dev = card_line(), torch.device("cuda")
    lib = probes.build_probes()
    warm, cold = calls(store_tables(dev))
    measure(lib, warm, cold)                           # the warm-up
    runs: dict[str, list[float]] = {}
    for _ in range(reps):
        for temp, ms in measure(lib, warm, cold).items():
            for name, x in ms.items():
                runs.setdefault(f"{name} device ms, {temp}", []).append(x)
            pair = (ms["version_scan"], ms["potential_matrix"])
            runs.setdefault(f"unfused read phase (version_scan + "
                            f"potential_matrix) device ms, {temp}",
                            []).append(None if None in pair else sum(pair))
    for name, xs in runs.items():
        if None in xs:
            print(f"{name}: not measured (no profiler device time) "
                  f"[{card}]", flush=True)
            continue
        print(f"{name}: median {statistics.median(xs):.6f} of "
              f"{' '.join(f'{x:.6f}' for x in xs)} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
