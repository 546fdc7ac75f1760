"""Workload generators: SmallBank and TPC-C-lite (the paper's §V benchmarks)
plus a parametric microbenchmark for the §V-D characteristic studies (port
of ``repro.core.workloads``).

The numpy generation is a copy of the reference's, draw for draw, so one
``RandomState`` seed gives the same waves in both packages; only
``_mk_wave`` differs: it builds int32 tensors on ``device`` (``None`` is
the CUDA device; pass ``device="cpu"`` for the CPU).

Keys are interleaved across nodes (``node = key % n_nodes``, matching
``store.node_of_key``): local key ``i`` of node ``h`` is ``i * n_nodes + h``.
Transactions are generated in waves; each txn runs on a host node, local
txns touch only host-partition keys, distributed txns touch 2-3 nodes
(paper §V-A).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.kernels import resolve_device
from .engine import NOP, READ, RMW, WRITE, Wave


def _key(local_idx, node, n_nodes):
    return local_idx * n_nodes + node


def _mk_wave(op_kind, op_key, op_val, host, tid0, device=None):
    T = op_kind.shape[0]
    dev = resolve_device(device)
    as_i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    return Wave(
        op_kind=as_i32(op_kind),
        op_key=as_i32(op_key),
        op_val=as_i32(op_val),
        host=as_i32(host),
        tid=as_i32(tid0 + np.arange(T)),
    )


def _pick_nodes(rng, host, n_nodes, distributed):
    """Host plus 1-2 extra nodes for distributed txns."""
    if not distributed or n_nodes == 1:
        return [host]
    extra = rng.choice([n for n in range(n_nodes) if n != host],
                       size=min(rng.randint(1, 3), n_nodes - 1), replace=False)
    return [host] + list(extra)


SMALLBANK_O = 4


def smallbank_txn(rng: np.random.RandomState, host: int, n_nodes: int,
                  keys_per_node: int, dist_frac: float = 0.2,
                  hot_frac: float = 0.0, hot_per_node: int = 20):
    """One SmallBank transaction on ``host``: balance (2 reads), deposit
    (1 rmw), transfer (2 rmw), write-check (1 read + 1 rmw).

    Returns ``(op_kind, op_key, op_val)`` as ``[SMALLBANK_O]`` int32 arrays —
    the per-txn building block shared by the batch generator below and the
    open-stream request generator in ``repro_torch.service``."""
    O = SMALLBANK_O
    op_kind = np.zeros(O, np.int32)
    op_key = np.zeros(O, np.int32)
    op_val = np.zeros(O, np.int32)
    nodes = _pick_nodes(rng, host, n_nodes, rng.rand() < dist_frac)
    hot = rng.rand() < hot_frac

    def draw(node):
        pool = hot_per_node if hot else keys_per_node
        return _key(rng.randint(0, pool), node, n_nodes)

    kind = rng.randint(0, 4)
    if kind == 0:      # balance: read two accounts
        op_kind[:2] = READ
        op_key[0] = draw(nodes[0])
        op_key[1] = draw(nodes[-1])
    elif kind == 1:    # deposit
        op_kind[0] = RMW
        op_key[0] = draw(nodes[0])
        op_val[0] = rng.randint(1, 100)
    elif kind == 2:    # transfer: two rmws (possibly cross-node)
        op_kind[:2] = RMW
        op_key[0] = draw(nodes[0])
        op_key[1] = draw(nodes[-1])
        amt = rng.randint(1, 100)
        op_val[0] = -amt
        op_val[1] = amt
    else:              # write-check: read one, rmw another
        op_kind[0] = READ
        op_kind[1] = RMW
        op_key[0] = draw(nodes[0])
        op_key[1] = draw(nodes[-1])
        op_val[1] = -rng.randint(1, 50)
    # de-dup keys inside a txn (engine assumes distinct write keys); a
    # NOP-ed slot drops its payload too, so padding is canonical
    seen = {}
    for o in range(O):
        if op_kind[o] != NOP:
            k = op_key[o]
            if k in seen:
                op_kind[o] = NOP
                op_key[o] = 0
                op_val[o] = 0
                continue
            seen[k] = True
    return op_kind, op_key, op_val


def smallbank_waves(rng: np.random.RandomState, n_waves: int, T: int,
                    n_nodes: int, keys_per_node: int, dist_frac: float = 0.2,
                    hot_frac: float = 0.0, hot_per_node: int = 20,
                    tid0: int = 1, device=None) -> List[Wave]:
    """SmallBank in closed batches: ``n_waves`` waves of ``T`` txns drawn
    from ``smallbank_txn``.  ``hot_frac`` of txns draw keys from the
    per-node hotspot (paper §V-D contention study)."""
    O = SMALLBANK_O
    waves = []
    for w in range(n_waves):
        op_kind = np.zeros((T, O), np.int32)
        op_key = np.zeros((T, O), np.int32)
        op_val = np.zeros((T, O), np.int32)
        host = rng.randint(0, n_nodes, T)
        for t in range(T):
            op_kind[t], op_key[t], op_val[t] = smallbank_txn(
                rng, host[t], n_nodes, keys_per_node, dist_frac, hot_frac,
                hot_per_node)
        waves.append(_mk_wave(op_kind, op_key, op_val, host, tid0 + w * T,
                              device))
    return waves


def tpcc_waves(rng: np.random.RandomState, n_waves: int, T: int, n_nodes: int,
               keys_per_node: int, dist_frac: float = 0.2,
               districts_per_node: int = 50, tid0: int = 1,
               device=None) -> List[Wave]:
    """TPC-C-lite: new-order (1 district rmw + 5 stock rmws + 3 item reads)
    and payment (1 warehouse rmw + 1 customer rmw).  Districts/warehouse rows
    live in the low key range -> natural contention."""
    O = 12
    waves = []
    for w in range(n_waves):
        op_kind = np.zeros((T, O), np.int32)
        op_key = np.zeros((T, O), np.int32)
        op_val = np.zeros((T, O), np.int32)
        host = rng.randint(0, n_nodes, T)
        for t in range(T):
            nodes = _pick_nodes(rng, host[t], n_nodes, rng.rand() < dist_frac)
            if rng.rand() < 0.6:   # new-order
                op_kind[t, 0] = RMW      # district next-o-id
                op_key[t, 0] = _key(rng.randint(0, districts_per_node), host[t], n_nodes)
                op_val[t, 0] = 1
                for j in range(5):       # stock updates, maybe remote
                    node = nodes[rng.randint(0, len(nodes))]
                    op_kind[t, 1 + j] = RMW
                    op_key[t, 1 + j] = _key(
                        districts_per_node + rng.randint(0, keys_per_node - districts_per_node),
                        node, n_nodes)
                    op_val[t, 1 + j] = -rng.randint(1, 10)
                for j in range(3):       # item reads
                    node = nodes[rng.randint(0, len(nodes))]
                    op_kind[t, 6 + j] = READ
                    op_key[t, 6 + j] = _key(
                        districts_per_node + rng.randint(0, keys_per_node - districts_per_node),
                        node, n_nodes)
            else:                  # payment
                op_kind[t, 0] = RMW      # warehouse ytd (hot)
                op_key[t, 0] = _key(rng.randint(0, 10), host[t], n_nodes)
                op_val[t, 0] = rng.randint(1, 100)
                node = nodes[-1]
                op_kind[t, 1] = RMW      # customer balance
                op_key[t, 1] = _key(
                    districts_per_node + rng.randint(0, keys_per_node - districts_per_node),
                    node, n_nodes)
                op_val[t, 1] = -rng.randint(1, 100)
            seen = {}
            for o in range(O):
                if op_kind[t, o] != NOP:
                    k = op_key[t, o]
                    if k in seen:
                        op_kind[t, o] = NOP
                        op_key[t, o] = 0
                        op_val[t, o] = 0
                        continue
                    seen[k] = True
        waves.append(_mk_wave(op_kind, op_key, op_val, host, tid0 + w * T,
                              device))
    return waves


def micro_waves(rng: np.random.RandomState, n_waves: int, T: int, n_nodes: int,
                keys_per_node: int, n_ops: int = 4, read_ratio: float = 0.8,
                dist_frac: float = 0.3, hot_frac: float = 0.0,
                hot_per_node: int = 20, blind_frac: float = 0.0,
                tid0: int = 1, device=None) -> List[Wave]:
    """Parametric microbenchmark for §V-D: vary txn length (n_ops), read mix,
    distribution fraction and contention.  ``blind_frac`` of non-read ops are
    blind WRITEs — the paper's Figure-1 case where PostSI commits and
    first-committer-wins SI aborts."""
    O = n_ops
    waves = []
    for w in range(n_waves):
        op_kind = np.zeros((T, O), np.int32)
        op_key = np.zeros((T, O), np.int32)
        op_val = np.zeros((T, O), np.int32)
        host = rng.randint(0, n_nodes, T)
        for t in range(T):
            nodes = _pick_nodes(rng, host[t], n_nodes, rng.rand() < dist_frac)
            hot = rng.rand() < hot_frac
            pool = hot_per_node if hot else keys_per_node
            ks = set()
            for o in range(O):
                node = nodes[rng.randint(0, len(nodes))]
                k = _key(rng.randint(0, pool), node, n_nodes)
                if k in ks:
                    continue
                ks.add(k)
                if rng.rand() < read_ratio:
                    op_kind[t, o] = READ
                elif rng.rand() < blind_frac:
                    op_kind[t, o] = WRITE
                    op_val[t, o] = rng.randint(1, 10)
                else:
                    op_kind[t, o] = RMW
                    op_val[t, o] = rng.randint(1, 10)
                op_key[t, o] = k
        waves.append(_mk_wave(op_kind, op_key, op_val, host, tid0 + w * T,
                              device))
    return waves


# ---------------------------------------------------------------------------
# YCSB-style zipfian transactions (paper §V-D skew/contention regime)
# ---------------------------------------------------------------------------

YCSB_O = 4

_zipf_cdf_cache: dict = {}


def zipf_cdf(n: int, theta: float) -> np.ndarray:
    """CDF of the bounded zipfian over ranks ``0..n-1``:
    ``P(rank=k) ∝ 1/(k+1)^theta`` — rank 0 is the hottest key, YCSB's key
    popularity model.  ``theta=0`` degenerates to uniform.  Cached per
    ``(n, theta)``: the zeta normalization is O(n) and the open-stream
    generator draws one rank per op."""
    key = (n, round(float(theta), 6))
    cdf = _zipf_cdf_cache.get(key)
    if cdf is None:
        w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), theta)
        cdf = np.cumsum(w / w.sum())
        cdf[-1] = 1.0                      # guard fp drift at the top rank
        _zipf_cdf_cache[key] = cdf
    return cdf


def zipf_rank(rng: np.random.RandomState, cdf: np.ndarray) -> int:
    """Draw one zipfian rank by inverting the cached CDF."""
    return int(np.searchsorted(cdf, rng.rand(), side="right"))


def zipf_hot_keys(n_nodes: int, keys_per_node: int, theta: float,
                  mass: float = 0.5, max_frac: float = 0.25) -> np.ndarray:
    """The hot-key set a zipfian YCSB stream concentrates on: the smallest
    rank prefix covering ``mass`` of the per-node popularity curve, expanded
    across every host's partition via the interleaved key encoding
    (``_key(rank, node, n) = rank * n_nodes + node``) — i.e. the LOW keys
    ``arange(R * n_nodes)``.  Because the physical store is partitioned in
    contiguous blocks, this entire set lands in node 0's block: the hot
    shard the elastic plane replicates and splits.  ``max_frac`` caps the
    set at that fraction of the key space (replicating everything is not a
    replica strategy)."""
    cdf = zipf_cdf(keys_per_node, theta)
    ranks = int(np.searchsorted(cdf, mass, side="left")) + 1
    ranks = max(1, min(ranks, int(keys_per_node * max_frac) or 1))
    return np.arange(ranks * n_nodes, dtype=np.int64)


def ycsb_txn(rng: np.random.RandomState, host: int, n_nodes: int,
             keys_per_node: int, theta: float = 0.9, read_frac: float = 0.8,
             dist_frac: float = 0.1, n_ops: int = YCSB_O):
    """One YCSB-style transaction on ``host``: ``n_ops`` ops, each a READ
    with probability ``read_frac`` else an RMW, over zipfian-skewed keys
    (skew ``theta``; every node's partition shares the popularity curve, so
    rank 0 of each node is hot).  With probability ``dist_frac`` the txn is
    distributed and ops spread over 2-3 nodes, else all ops stay on
    ``host`` — the open-stream analogue of ``micro_waves`` with the §V-D
    skew knob the uniform SmallBank stream cannot reach.

    Returns ``(op_kind, op_key, op_val)`` as ``[n_ops]`` int32 arrays;
    duplicate keys inside the txn are NOP-ed out like every generator here
    (the engine assumes distinct write keys per txn)."""
    O = n_ops
    op_kind = np.zeros(O, np.int32)
    op_key = np.zeros(O, np.int32)
    op_val = np.zeros(O, np.int32)
    nodes = _pick_nodes(rng, host, n_nodes, rng.rand() < dist_frac)
    cdf = zipf_cdf(keys_per_node, theta)
    seen = set()
    for o in range(O):
        node = nodes[rng.randint(0, len(nodes))]
        k = _key(zipf_rank(rng, cdf), node, n_nodes)
        if k in seen:
            continue                       # leave the slot as NOP padding
        seen.add(k)
        op_key[o] = k
        if rng.rand() < read_frac:
            op_kind[o] = READ
        else:
            op_kind[o] = RMW
            op_val[o] = rng.randint(1, 100)
    return op_kind, op_key, op_val


def rmw_hot_txn(rng: np.random.RandomState, host: int, n_nodes: int,
                keys_per_node: int, theta: float = 0.99,
                n_ops: int = YCSB_O, val_max: int = 8):
    """One single-op zipfian RMW transaction on ``host``: op slot 0 carries
    an RMW with a small positive delta on a zipf(``theta``)-ranked key of
    the host's partition; slots 1.. stay NOP padding.  This is the
    write-hot regime of DESIGN.md §12.2 — at θ=0.99 the stream piles onto
    each host's rank-0 key, where unfolded same-key RMWs serialize one
    commit per wave via lost-update retries and the former's commutative
    fold turns the pile-up into a single delta-summed row.

    Returns ``(op_kind, op_key, op_val)`` as ``[n_ops]`` int32 arrays."""
    op_kind = np.zeros(n_ops, np.int32)
    op_key = np.zeros(n_ops, np.int32)
    op_val = np.zeros(n_ops, np.int32)
    cdf = zipf_cdf(keys_per_node, theta)
    op_kind[0] = RMW
    op_key[0] = _key(zipf_rank(rng, cdf), host, n_nodes)
    op_val[0] = rng.randint(1, val_max)
    return op_kind, op_key, op_val


def ycsb_waves(rng: np.random.RandomState, n_waves: int, T: int, n_nodes: int,
               keys_per_node: int, theta: float = 0.9, read_frac: float = 0.8,
               dist_frac: float = 0.1, n_ops: int = YCSB_O,
               tid0: int = 1, device=None) -> List[Wave]:
    """YCSB in closed batches (the replay-driver twin of the open-stream
    generator ``repro_torch.service.ycsb_txn_gen``)."""
    waves = []
    for w in range(n_waves):
        op_kind = np.zeros((T, n_ops), np.int32)
        op_key = np.zeros((T, n_ops), np.int32)
        op_val = np.zeros((T, n_ops), np.int32)
        host = rng.randint(0, n_nodes, T)
        for t in range(T):
            op_kind[t], op_key[t], op_val[t] = ycsb_txn(
                rng, host[t], n_nodes, keys_per_node, theta, read_frac,
                dist_frac, n_ops)
        waves.append(_mk_wave(op_kind, op_key, op_val, host, tid0 + w * T,
                              device))
    return waves


CHAIN_O = 2


def chain_txn(prev_key, link_key: int, kind: str = "raw",
              n_ops: int = CHAIN_O, val: int = 1):
    """One link of a deliberate intra-wave dependency chain (DESIGN.md §10).

    Every other generator here NOP-dedups duplicate keys *within* a txn and
    draws keys independently *across* txns, so same-wave dependency chains
    only arise by collision.  Chains build them on purpose — the structure
    the planner's lanes exist to serialize:

    * ``raw`` — READ the predecessor's ``prev_key`` (head links skip it),
      then RMW this link's own fresh ``link_key``: a write→read chain
      across consecutive txns.  Optimistic waves commit these but every
      reader sees the *wave-start* snapshot, never its predecessor; planned
      lanes place each link after its predecessor's commit.
    * ``waw`` — RMW ``link_key`` (the chain's single shared key; callers
      pass ``prev_key`` through as ``link_key``): successive RMWs of one
      key, which rule 4(a) serializes the hard way — in an optimistic wave
      all but the first link lose their update and abort.

    Pure function of its arguments (the rng lives in ``chain_waves``);
    returns ``(op_kind, op_key, op_val)`` as ``[n_ops]`` int32 arrays."""
    if kind not in ("raw", "waw"):
        raise ValueError(f"unknown chain link kind {kind!r}")
    if n_ops < CHAIN_O:
        raise ValueError(f"chain links need n_ops >= {CHAIN_O}, got {n_ops}")
    op_kind = np.zeros(n_ops, np.int32)
    op_key = np.zeros(n_ops, np.int32)
    op_val = np.zeros(n_ops, np.int32)
    if kind == "raw" and prev_key is not None:
        op_kind[0], op_key[0] = READ, prev_key
    op_kind[1], op_key[1], op_val[1] = RMW, link_key, val
    return op_kind, op_key, op_val


def chain_waves(rng: np.random.RandomState, n_waves: int, T: int,
                n_nodes: int, keys_per_node: int, chain_len: int = 4,
                kind: str = "raw", n_ops: int = CHAIN_O,
                tid0: int = 1, device=None) -> List[Wave]:
    """Waves of intra-wave dependency chains: consecutive txns
    ``[t, t+chain_len)`` form one chain on one host node (rows are tid
    order, so chain depth == conflict-chain depth for the planner's layered
    coloring).  ``kind``: ``raw`` / ``waw`` as in ``chain_txn``, or
    ``mixed`` — chains alternate raw and waw links (both edge flavors in
    one wave).  Fresh keys come from a per-host shuffled permutation of the
    host's partition, so chains never collide with each other and every key
    obeys the partition invariant (``key % n_nodes == host``)."""
    if kind not in ("raw", "waw", "mixed"):
        raise ValueError(f"unknown chain kind {kind!r}")
    waves = []
    for w in range(n_waves):
        perms = [rng.permutation(keys_per_node) for _ in range(n_nodes)]
        used = np.zeros(n_nodes, np.int64)

        def fresh(h):
            if used[h] >= keys_per_node:
                raise ValueError(
                    f"host {h} partition exhausted: T={T} chains need more "
                    f"than keys_per_node={keys_per_node} fresh keys")
            k = _key(int(perms[h][used[h]]), h, n_nodes)
            used[h] += 1
            return k

        op_kind = np.zeros((T, n_ops), np.int32)
        op_key = np.zeros((T, n_ops), np.int32)
        op_val = np.zeros((T, n_ops), np.int32)
        host = np.zeros(T, np.int32)
        h = prev = None
        for t in range(T):
            pos = t % chain_len
            if pos == 0:                       # new chain, new host
                h, prev = int(rng.randint(0, n_nodes)), None
            link_kind = kind if kind != "mixed" else \
                ("raw" if pos % 2 == 0 else "waw")
            if link_kind == "waw":
                # continue on the shared chain key (head draws it fresh)
                link = prev if prev is not None else fresh(h)
            else:
                link = fresh(h)
            op_kind[t], op_key[t], op_val[t] = chain_txn(
                prev, link, link_kind, n_ops, val=int(rng.randint(1, 10)))
            host[t] = h
            prev = link
        waves.append(_mk_wave(op_kind, op_key, op_val, host, tid0 + w * T,
                              device))
    return waves


# ---------------------------------------------------------------------------
# open-stream arrival processes (DESIGN.md §8)
# ---------------------------------------------------------------------------

def poisson_arrivals(rng: np.random.RandomState, rate: float,
                     n_ticks: int) -> np.ndarray:
    """Open-system arrivals: i.i.d. ``Poisson(rate)`` new requests per
    scheduler tick (one tick = one wave slot of the closed-loop service)."""
    return rng.poisson(rate, size=n_ticks).astype(np.int64)


def tenant_poisson_arrivals(rng: np.random.RandomState, rates,
                            n_ticks: int) -> np.ndarray:
    """Multi-tenant open-system arrivals: ``[n_ticks, n_tenants]`` i.i.d.
    ``Poisson(rates[t])`` new requests per tenant per tick.  Feed the 2-D
    array straight to ``TxnService.run_stream``/``run_streaming`` with a
    ``tenant_txn_gen`` — column ``t`` arrives tagged as tenant ``t``
    (DESIGN.md §12.1)."""
    rates = np.asarray(rates, np.float64)
    return rng.poisson(rates, size=(n_ticks, rates.size)).astype(np.int64)


def bursty_arrivals(rng: np.random.RandomState, rate: float, n_ticks: int,
                    burst_factor: float = 6.0, p_enter: float = 0.08,
                    p_exit: float = 0.35) -> np.ndarray:
    """Two-state Markov-modulated Poisson process: a calm state at ``rate``
    and a burst state at ``rate * burst_factor``; geometric sojourns with
    entry/exit probabilities per tick.  Mean offered load exceeds ``rate``
    by the burst duty cycle — bursts model flash crowds, the case where the
    wave former's admission control and the retry pipeline's backoff earn
    their keep."""
    counts = np.zeros(n_ticks, np.int64)
    burst = False
    for t in range(n_ticks):
        burst = (rng.rand() < p_enter) if not burst else (rng.rand() >= p_exit)
        counts[t] = rng.poisson(rate * burst_factor if burst else rate)
    return counts
