"""Meshes of the port (counterpart of ``repro.launch.mesh``).

``make_cc_node_mesh(n_nodes)`` is the launch-layer name of the
concurrency-control data plane's ``("node",)`` mesh,
``core.dist_engine.make_node_mesh``: the paper's shared-nothing nodes as
blocks of one card's store.  Pair it with a ``PlacementMap(n_keys,
n_nodes)`` for the elastic layout, or ``placement=None`` for the frozen
blocks.

``make_cc_process_mesh()`` is the same mesh across processes
(``core.dist_engine.make_process_mesh``): one ``torch.distributed`` rank a
node, each holding its own block.  ``spawn_ranks(fn, n)`` starts ``n``
such ranks on this host and returns what ``fn(pmesh, *args)`` returned on
each: ``torch.multiprocessing`` with the ``spawn`` start method, a
rendezvous through a file (no port, no network), a timeout on the
process group's collectives, and a deadline on the whole run that kills
every rank and raises when one fails or hangs.

Not ported: ``make_production_mesh`` and ``make_test_mesh`` (the
reference's GSPMD meshes of 256 and 512 TPU chips and of 8 host devices
for its model plane) and ``repro.launch.sharding`` (their logical-axis
rules): they shard models, not the concurrency-control engine.
"""
from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback
from multiprocessing.connection import wait

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core.dist_engine import (NodeMesh, ProcessMesh,
                                          check_backend, make_node_mesh,
                                          make_process_mesh)

__all__ = ["RankFailure", "make_cc_node_mesh", "make_cc_process_mesh",
           "spawn_ranks"]


def make_cc_node_mesh(n_nodes: int = 8, device=None) -> NodeMesh:
    """The ``("node",)`` mesh of ``n_nodes`` nodes on ``device`` (None:
    the CUDA device)."""
    return make_node_mesh(n_nodes, device)


def make_cc_process_mesh(group=None, device=None) -> ProcessMesh:
    """The ``("node",)`` mesh over the ranks of ``group`` (None: the
    default process group), this rank's block on ``device`` (None: its
    CUDA device)."""
    return make_process_mesh(group, device)


class RankFailure(RuntimeError):
    """A rank of ``spawn_ranks`` raised, died or missed the deadline."""


def _rank_main(fn, rank, world, init_file, backend, device, timeout, args,
               conn):
    """One rank: join the process group, make its mesh node, run ``fn``
    and send ``("ok", result)`` or ``("error", traceback)`` to the
    parent.  Torch runs one intra-op thread a rank, so that ranks sharing
    a host's cores do not stall each other."""
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method="file://" + init_file, rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        result = ("ok", fn(make_process_mesh(device=device), *args))
    except Exception:
        result = ("error", traceback.format_exc())
    try:
        conn.send(result)
    finally:
        conn.close()
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, n_ranks: int, *, args=(), backend: str = "gloo",
                device=None, timeout: float = 120.0,
                deadline: float = 600.0) -> list:
    """Run ``fn(pmesh, *args)`` on ``n_ranks`` new processes, one mesh
    node each, and return their results in rank order.

    ``fn`` and ``args`` cross to the ranks by pickling (``fn``: a function
    of an importable module).  Each rank initialises ``backend`` through a
    rendezvous file in a fresh temporary directory, with ``timeout``
    seconds for any collective, pins torch to one intra-op thread, and
    calls ``make_process_mesh(device=device)`` (``None``: one
    CUDA device a rank).  ``nccl`` with fewer cards than ranks, or on the
    CPU, raises ``ValueError`` here, before any rank starts: nothing
    switches backends.  A rank that raises or exits without a result, or
    a run that passes ``deadline`` seconds, kills every rank and raises
    ``RankFailure`` with the rank's traceback."""
    dev_type = "cuda" if device is None else torch.device(device).type
    check_backend(backend, dev_type, n_ranks)
    ctx = mp.get_context("spawn")
    root = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    procs, conns = [], []
    try:
        for rank in range(n_ranks):
            recv, send = ctx.Pipe(duplex=False)
            proc = ctx.Process(
                target=_rank_main, daemon=True,
                args=(fn, rank, n_ranks, os.path.join(root, "rendezvous"),
                      backend, device, timeout, args, send))
            proc.start()
            send.close()
            procs.append(proc)
            conns.append(recv)
        return _collect(procs, conns, time.monotonic() + deadline, deadline)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
        for proc in procs:
            proc.join()
        shutil.rmtree(root, ignore_errors=True)


def _collect(procs, conns, end: float, deadline: float) -> list:
    """Every rank's result, in rank order; raise ``RankFailure`` at the
    first rank that fails or exits without one, or at ``end``."""
    results = [None] * len(procs)
    pending = set(range(len(procs)))
    while pending:
        left = end - time.monotonic()
        if left <= 0:
            raise RankFailure(f"ranks {sorted(pending)} gave no result "
                              f"within the {deadline:g} s deadline")
        wait([conns[r] for r in pending]
             + [procs[r].sentinel for r in pending], timeout=left)
        for r in sorted(pending):
            if conns[r].poll():
                try:
                    status, payload = conns[r].recv()
                except EOFError:
                    raise RankFailure(f"rank {r} exited with code "
                                      f"{procs[r].exitcode} and no result")
                if status != "ok":
                    raise RankFailure(f"rank {r} failed:\n{payload}")
                results[r] = payload
                pending.discard(r)
            elif not procs[r].is_alive() and not conns[r].poll():
                # (a result sent just before the exit is read next round)
                raise RankFailure(f"rank {r} exited with code "
                                  f"{procs[r].exitcode} and no result")
    for proc in procs:
        proc.join(timeout=max(0.0, end - time.monotonic()))
    return results
