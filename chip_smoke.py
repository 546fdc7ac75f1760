#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``) on one GPU.

Run from the repository root, with one CUDA device:

    python3 chip_smoke.py

Phases (any failure raises, so the process exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc),
   then disassemble the library (``cuobjdump -sass``): every bf16
   instantiation of ``flash_attention``, its two backward kernels and
   ``ssd_scan`` must run tensor-core (HMMA / HGMMA) instructions, and the
   Hopper forms (the forward in bf16 at D = 64, 80 and 128, the backward
   kernels at D = 64 and 128, the SSD scan at N = 64 and 128) wgmma
   (HGMMA) products and TMA (UTMALDG) loads; the SSD scan's backward
   (``ssd_scan_bwd_states`` and ``_grads``) HMMA in each of its 12 bf16
   instantiations (P in 16, 32, 64 x N in 16, 32, 64, 128) and HGMMA and
   UTMALDG in each of their Hopper forms and of the fused states and scan
   (P = 64, N = 64 and 128);
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
   q tile, N=128 (bf16 and float32), model-layout and slow-decay cases and
   phase 8's cross-attention (Sq = 128 and 1 over Sk = 1,024 and 1,000
   encoder rows) and encoder shapes (``ATTENTION_FWD_CASES``: also the
   Hopper forward's edges, one query row at D = 128, causal with Sk > Sq,
   a 2,048-row walk, a q tile with one group's rows, and the ``mma.sync``
   kernel in bf16 at D = 48, 96 and 112; the SSD scan's Hopper kernel
   also at 9 and 16 chunks with h0, at S = 100 and S = 1, each case
   naming the kernel it reaches), attention's lse
   against the plain version's and the Hopper forward's and the SSD
   Hopper kernel's two calls bit-equal, each bf16 output also
   against its plain version in float32 on the same inputs, the element
   closest to its limit printed per check, with
   ``scaled_dot_product_attention`` timed beside attention as a yardstick
   (never called by the port; by its kernels' device ms), the times also
   at qwen3-14b's prefill, seamless' cross-attention and qwen2-0.5b's
   training step, and ``ssd_scan``'s at mamba2-130m's prefill
   (bf16 and float32) and zamba2's in float32, the bf16 Hopper kernel's
   beside ``ssd_scan_mma_kernel``'s at both prefill shapes in the same
   call; the attention backward's
   two kernels (``flash_attention_bwd_dq``, ``_dkdv``) against
   ``flash_attention_bwd_plain`` on the forward kernel's o and lse (and
   that lse against the plain version's) at phase 9's training shape
   (qwen2-0.5b: B=4, S=1,024, H=14, KH=2, D=64) in bf16 and float32,
   ragged S=1,000, GQA at G=1, 3 and 7, D=128 at G=7, seamless' cross
   shape (Sq=128 over Sk=1,024 and 1,000), Sq=1, causal with Sk > Sq (zero
   dk and dv past the last query), an odd count of (query head, q tile)
   pairs a kv tile and small odd shapes (``ATTENTION_BWD_CASES``), each
   case's two calls bit-equal, the element closest to its limit printed,
   with CUDA-event times of each kernel at the training shape beside the
   plain backward's and SDPA's backward with each backend forced in turn
   and unforced (a yardstick the port never calls; the fastest forced is
   the library time), and the Hopper kernels' grids and longest walks;
   the SSD scan's backward kernels (``ssd_scan_bwd_states``, ``_scan``,
   ``_grads``, and ``ssd_scan_bwd_states_scan``, the first two as one
   launch where ``ssd_bwd_fused`` takes the case: also against the two
   launches, hprev, G and dh0 bit-equal, sc within ``SSD_SC_ORDER_TOL``;
   the clusters of it that fit at once printed) each against its plain
   version on the same
   inputs (``SSD_BWD_CASES``: zamba2-2.7b's and mamba2-130m's training
   shapes, B=4, S=1,024, in bf16 and float32; S = 1,000, S = 1, one chunk
   of S < 128, 16 chunks, h0 and dh_final given, the model's layout,
   decays of 0.01 and 1.4, the reduced configs' P = N = 16 in chunks of
   16), float32 within 1e-3 x scale, bf16 within 2e-2 x scale and the
   chained backward within one bf16 rounding of a float32 oracle on the
   same bf16 inputs, each kernel's two calls bit-equal (the bf16 cases at
   P = 64, N = 64 and 128 on the Hopper forms of the states and grads
   kernels); CUDA-event and profiler device ms of each at both training
   shapes (the Hopper forms beside the ``mma.sync`` forms they replace)
   beside the forward kernel's and the plain backward's, each bounded by
   the gradient's own
   bytes and operations (the design's float32 state arrays printed
   apart, outside the bound);
   ``commit_loop`` against the
   engine's plain
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
4. engine: 4 SmallBank waves of T=256 over a 1,000,000-account store
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
   mesh runs the plain commit loop); each scheduler through one of the
   four (route, driver) pairs, the pairs in turn (every pair for one
   scheduler or two); one postsi wave on the mesh's ``torch``
   route equal to it too; then one more postsi wave on ``cuda`` under the
   counter for phase 9g;
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
   prefill/decode times, a profile of one prefill (its model kernels by
   name: the 54 scans on ``ssd_scan_wgmma_kernel``, as phase 8's 24 of
   mamba2-130m), every kernel call of
   one prefill held to its plain version on the same activations (and,
   in bf16, to the float32 one), and
   every batch again on the ``cuda`` and the ``torch`` route
   teacher-forced with the served tokens: in float32 compute the logits
   agree within 1e-3 * scale at every step; the bf16 distance is printed
   beside each route's own bf16-vs-float32 distance;
7. decoder: ``DecoderLM`` behind ``Server`` on the ``cuda`` route, as
   phase 6 serves zamba2, after zamba2's versions are freed, each model's
   versions freed before the next (``DECODER_RUNS``):

   7a. qwen3-14b at full width and depth (40 layers, 14,769,602,560
   parameters, 59.1 GB in float32): one weight version (two would not
   fit), batch 4 of prompts 1,024 and 1,000, 16 new tokens;
   7b. qwen2-0.5b and qwen2-vl-2b (M-RoPE: ``[B, S, 3]`` positions) at
   full width and depth, two versions each, published after the first
   batch, over phase 6's three prompts;
   7c. deepseek-moe-16b at full width, its depth cut from 28 to 8 layers
   (the cut printed first), one version; one prefill with every
   ``moe_ffn`` call under sync debug mode "error".

   Each: one weight version per batch, ``flash_attention`` launched once a
   layer a prefill, prefill ms, decode ms a step, tokens/s, peak memory
   and ``profile_call`` profiles, the in-situ kernel checks, and the
   teacher-forced ``cuda``-vs-``torch`` gates of phase 6 (MoE: the float32
   distance printed, not gated: routing flips at near-ties);
8. the SSM and encoder-decoder families behind ``Server`` on the ``cuda``
   route at full width and depth, after phase 7's models are freed, as
   phase 7 serves its models (``SSM_ENCDEC_RUNS``; batch 4, 16 new tokens,
   bf16 over float32 weights, two weight versions and a publish after the
   first batch):

   8a. mamba2-130m (24 layers, N=128, chunk 128, tied embeddings), prompts
   of 1,024 and 1,000 tokens (a ragged last chunk);
   8b. seamless-m4t-large-v2 (24 encoder + 24 decoder layers, 2.03 B
   parameters), decoder prompts of 128 tokens over seeded frame
   embeddings (``randn * 0.05``, ``make_batch``'s scale) of 1,024 and
   1,000 encoder frames.

   Each: one weight version per batch; the launches (``ssd_scan`` 24 a
   mamba2 prefill; ``flash_attention`` 72 a seamless prefill and 24 a
   decode step), over the served batches and for one prefill and one
   decode step apart; the in-situ checks; the teacher-forced ``cuda``-vs-
   ``torch`` logits in float32 within 1e-3 * scale (the bf16 distance
   printed beside the ``torch`` route's own bf16-vs-float32 distance, not
   gated); prefill ms, decode ms a step, tokens/s, peak memory,
   ``profile_call`` profiles;
9. training on the ``cuda`` route, after phase 8's models are freed:

   9a. qwen2-0.5b at full width and depth (24 layers, 494,147,456
   parameters), bf16 compute over float32 parameters, ``TrainRunner`` over
   ``TokenStream`` batches of 4 x 1,024 with a checkpoint every 4 steps, 8
   steps and a failure injected at step 6: restarts 1, final step 8, 10
   finite losses, the last below the first; every step launches the
   forward kernel 48 times (24 layers, again under remat) and each
   backward kernel 24 times; ms a step, tokens/s, peak memory, checkpoint
   save and restore seconds, a ``profile_call`` profile; then one float32
   loss and gradient on ``cuda`` against the ``torch`` route (the loss
   and every gradient leaf within 1e-3 of scale);
   9b. deepseek-moe-16b at full width cut to 2 layers, and 9c.
   seamless-m4t-large-v2 at full width cut to 4 + 4 layers (1,000 encoder
   frames under 512 decoder tokens: cross-attention at Sq != Sk): one
   float32 step each on ``cuda`` against ``torch`` with the same gate and
   its launches; the MoE step's backward under sync debug mode "warn",
   its host waits printed;
   9d. mamba2-130m at full width and depth (24 layers), as 9a: the
   runner over batches of 4 x 1,024 through its injected failure
   (``--ssm-train-steps`` steps, default 8), finite falling losses, every
   step launching ``ssd_scan`` 48 times (24 layers, again under remat)
   and ``ssd_scan_bwd_states_scan`` and ``_grads`` 24 times each (bf16
   at S = 1,024: the states and the scan fused; its float32 step, 9e,
   the two launches), ms a step, tokens/s, peak
   memory, a profile;
   9e. one float32 step of mamba2-130m and of zamba2-2.7b at full width
   cut to 6 of 54 layers (one shared-attention application; batch 2 x
   1,024) on ``cuda`` against ``torch`` with 9a's gate, and their
   launches: the float32 forms of the scan (``ssd_scan_fma_kernel``), of
   its backward and of the attention kernels;
   9f. the same zamba2-2.7b step in its bf16 compute dtype on ``cuda``:
   the Hopper forward at N = 64 (``ssd_scan_wgmma_kernel``), the bf16
   backward under group remat and the shared attention's bf16 kernels in
   one step; the loss within 2e-2 of the ``torch`` route's on the same
   parameters and batch, every gradient leaf finite, its launches as
   counted, ms a loss and gradient;
   9g. the dry run held to the card: phases 4m, 6, 7a, 9a and 9d each
   make one untimed extra call under ``launch.op_count``'s counter on the
   ``cuda`` route (a postsi mesh wave at phase 4m's shape, zamba2-2.7b's
   and qwen3-14b's 4 x 1,024 prefill, a qwen2-0.5b and a mamba2-130m
   train step of 4 x 1,024), and 9g traces each on ``meta`` (the mesh
   wave in a child process started at the beginning, which never touches
   the card): FLOPs (by dtype) and bytes equal exactly; each hand-written
   kernel's launches in the trace equal to the card's counter's and the
   wrappers' (``LAUNCHES``); every one of them in the profiler's trace
   (at most as often: the profiler can drop an event); printed beside
   the card line: each call's ``compute_s``, ``memory_s`` and measured
   ms (its phase's time), the share of the roofline, and the peak-live
   estimate beside ``torch.cuda.max_memory_allocated``;
10. one JSON line of per-kernel results, with the launches each kernel made
   on its own path (phases 4-5d for the engine's, the streamed, planned,
   durable, replayed and placed runs included, the served batches of
   phases 6, 7 and 8 and phase 9's training for the model plane's, phase
   9 alone for the backward kernels, the SSD's included; each must be
   > 0), the card line
   again, and last ``{"ok": true, "device": {...}}``.

The store, wave, stream and model sizes are fixed (the constants below);
the flags cut only the depth: ``--waves``, ``--scheds``, ``--ticks``,
``--planned-waves``, ``--elastic-ticks``, ``--mesh-waves``,
``--mesh-ticks``, ``--serve-batches``, ``--new-tokens`` and
``--ssm-train-steps``.  Each phase's seconds are printed at the end
(``[phases]``).

Without a CUDA device, or in a directory that does not hold the repository,
it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, the non-tensor-core
# 32-bit rate (taken for the engine kernels' integer compares) and the dense
# bf16 tensor rate (taken for the model kernels' bf16 products); the bound
# of (bytes, operations)
from repro_torch.kernels.roofline import (ALU_OPS_PER_S,  # noqa: E402
                                          BF16_FLOPS_PER_S, HBM_BYTES_PER_S,
                                          bound, ops_rate)

# the serve phase: model, batch and prompt lengths (fixed)
SERVE_ARCH = "zamba2-2.7b"
SERVE_BATCH = 4
SERVE_PROMPTS = (1024, 1024, 1000)
# phase 7, the decoder family at full width: (step, arch, weight versions,
# prompt lengths, layers kept where the full depth does not fit the card
# in float32 with room to serve, else None)
DECODER_RUNS = (
    ("7a", "qwen3-14b", 1, (1024, 1000), None),
    ("7b", "qwen2-0.5b", 2, SERVE_PROMPTS, None),
    ("7b", "qwen2-vl-2b", 2, SERVE_PROMPTS, None),
    ("7c", "deepseek-moe-16b", 1, (1024, 1000), 8),
)
# phase 8, the SSM and encoder-decoder families at full width and depth:
# (step, arch, weight versions, prompt lengths, encoder frames a batch or
# None), a second version published after the first batch
SSM_ENCDEC_RUNS = (
    ("8a", "mamba2-130m", 2, (1024, 1000), None),
    ("8b", "seamless-m4t-large-v2", 2, (128, 128), (1024, 1000)),
)
# the scale of the encoder's seeded frame embeddings (launch/inputs.py
# make_batch draws them as randn * 0.05)
ENC_SCALE = 0.05
# phase 9, training: qwen2-0.5b at full width and depth (the one decoder
# whose float32 training state fits the card), TokenStream batches of
# TRAIN_BATCH x TRAIN_SEQ, TrainRunner over TRAIN_STEPS steps with a
# checkpoint every half of them and a failure injected two before the end
# (every 4 and at step 6)
TRAIN_ARCH = "qwen2-0.5b"
TRAIN_BATCH, TRAIN_SEQ = 4, 1024
TRAIN_STEPS = 8
TRAIN_LR = 3e-4
# one float32 step each of two more families at full width, depth cut:
# (step, arch, decoder layers, encoder layers or None, batch, seq)
TRAIN_FAMILY_RUNS = (("9b", "deepseek-moe-16b", 2, None, 2, 512),
                     ("9c", "seamless-m4t-large-v2", 4, 4, 2, 512))
# encoder frames of the encoder-decoder step: not the decoder's length
# (cross-attention at Sq != Sk) and not a multiple of the kernels' tile
TRAIN_ENC_FRAMES = 1000
# phase 9d, the SSM family trained at full width and depth as 9a trains
# qwen2-0.5b; 9e, one float32 step of it and of the hybrid family at full
# width, depth cut, and 9f the hybrid one again in bf16: (step, arch,
# layers, batch, seq), the layers a whole number of shared-attention groups
SSM_TRAIN_ARCH = "mamba2-130m"
HYBRID_TRAIN_RUNS = (("9e", "zamba2-2.7b", 6, 2, 1024),)
# phase 9g, the dry run held to the card: the prefills of these models
# (phases 6, 7a) and the runners' steps (9a, 9d) are counted on the card
# and traced on meta, with one postsi mesh wave (phase 4m)
DRY_PREFILLS = ("zamba2-2.7b", "qwen3-14b")


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
    waves: int = 4                 # cut from 16 to make room for 4m, 5m,
                                   # and from 8 for 9g
    scheds: str = "all"
    ticks: int = 16                # cut from 32 to make room for 9g
    serve_batches: int = 3         # of SERVE_PROMPTS
    new_tokens: int = 16
    planned_waves: int = 1         # hot SmallBank waves the planner replays
                                   # (cut from 2 to make room for 9g)
    elastic_ticks: int = 20        # ticks of phase 5d's elastic stream
    mesh_waves: int = 1            # waves a scheduler and route, phase 4m
                                   # (cut from 2 to make room for phase 8;
                                   # 5m carries state across mesh waves)
    mesh_ticks: int = 6            # ticks of phase 5m's mesh sessions
                                   # (cut from 8 to make room for 9g)
    ssm_train_steps: int = 8       # steps of phase 9d's runner


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
    # no Pallas kernel: the reference differentiates its plain attention
    # (layers._dense_attention / _chunked_attention) with XLA's autodiff
    "flash_attention_bwd_dq": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/models/layers.py:123"),
    "flash_attention_bwd_dkdv": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/models/layers.py:123"),
    # no Pallas kernel: the reference trains its scan through XLA's
    # autodiff of models/ssm.py ssd_chunked
    "ssd_scan_bwd_states": ("src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                            "src/repro/models/ssm.py:70"),
    "ssd_scan_bwd_scan": ("src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                          "src/repro/models/ssm.py:70"),
    "ssd_scan_bwd_states_scan": (
        "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        "src/repro/models/ssm.py:70"),
    "ssd_scan_bwd_grads": ("src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                           "src/repro/models/ssm.py:70"),
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


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
        potential_matrix_cost, potential_matrix_cuda, potential_matrix_ref)
    from repro_torch.kernels.version_scan import (version_scan_cost,
                                                  version_scan_cuda,
                                                  version_scan_plain)
    from repro_torch.kernels.wave_commit import (wave_commit_cost,
                                                 wave_commit_cuda,
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
    # each kernel's cost formula; the potential tile's operations only for
    # the reader keys >= 0 that this run's data holds
    live = int((rk >= 0).sum())
    work = {"version_scan": version_scan_cost(M, V),
            "potential_matrix": potential_matrix_cost(T, O, live),
            "wave_commit": wave_commit_cost(T, O, V, live)}
    for name, (k_ms, p_ms) in ms.items():
        b_ms, b_by = bound(work[name][1], work[name][0])
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
    ``<name>_kernel``, ``<name>_mma_kernel`` (bf16, tensor cores),
    ``<name>_wgmma_kernel`` (bf16, Hopper's wgmma and TMA) or
    ``<name>_fma_kernel`` (float32)."""
    for name in KERNELS:
        if any(f"{name}{kind}_kernel" in symbol
               for kind in ("", "_mma", "_wgmma", "_fma")):
            return name
    return None


def tensor_core_counts(sass: str, ops=("HMMA", "HGMMA"),
                       kernels=None) -> dict:
    """``cuobjdump -sass`` text -> {function: count of instructions whose
    text holds one of ``ops`` (default HMMA / HGMMA: tensor-core products;
    UTMALDG: TMA tile loads)} for every function of ``kernels`` (default
    the model kernels)."""
    kernels = MODEL_KERNELS if kernels is None else kernels
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            fn = fn if kernel_of(fn) in kernels else None
            if fn:
                counts[fn] = 0
        elif fn and any(op in line for op in ops):
            counts[fn] += 1
    return counts


# the model plane's kernels, each with a bf16 (tensor-core) and a float32
# (FMA) form
MODEL_KERNELS = ("flash_attention", "ssd_scan", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkdv")


# the SSD scan's backward kernels, one template over (bf16 or float32, P,
# N) each; the states and grads kernels' bf16 forms run mma.sync products,
# the scan kernel has none (float32 states, either dtype); the states and
# the scan fused, a Hopper kernel only (bf16 at P = 64, N = 64 and 128, at
# most 8 chunks: ``ssd_bwd_fused``)
SSD_BWD_KERNELS = ("ssd_scan_bwd_states", "ssd_scan_bwd_scan",
                   "ssd_scan_bwd_states_scan", "ssd_scan_bwd_grads")
SSD_BWD_FUSED = "ssd_scan_bwd_states_scan"
SSD_BWD_SHAPES = 12       # instantiations a form: P in 16, 32, 64 x N in
                          # 16, 32, 64, 128


# the model kernels with a Hopper form (``*_wgmma_kernel``: bf16, wgmma
# products fed by TMA) and the sizes of its instantiations: the attention
# forward at head dims 64, 80 and 128, the backward at 64 and 128, the SSD
# scan at state sizes N = 64 and 128 (P = 64)
WGMMA_KERNELS = {"flash_attention": (64, 80, 128),
                 "flash_attention_bwd_dq": (64, 128),
                 "flash_attention_bwd_dkdv": (64, 128),
                 "ssd_scan": (64, 128)}
# the dimension those sizes are of
WGMMA_DIM = {"ssd_scan": "N"}


def tensor_core_check(lib_path, nvcc):
    """Disassemble the built library; raise unless every bf16 instantiation
    of the model kernels (``*_mma_kernel``: attention, its backward and the
    SSD scan) runs tensor-core instructions, and every Hopper instantiation
    (``*_wgmma_kernel``: the attention forward at D = 64, 80 and 128,
    three; the backward's two kernels at D = 64 and 128, two each; the SSD
    scan at N = 64 and 128, two) issues its products by wgmma (HGMMA) and
    its tiles by TMA (UTMALDG).  Prints the counts per kernel and form."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], check=True,
                          capture_output=True, text=True).stdout
    counts = tensor_core_counts(sass)
    hopper = {op: tensor_core_counts(sass, (op,))
              for op in ("HGMMA", "UTMALDG")}
    for name in MODEL_KERNELS:
        for kind in ("mma", "wgmma", "fma"):
            if kind == "wgmma" and name not in WGMMA_KERNELS:
                continue
            got = {f: n for f, n in counts.items()
                   if kernel_of(f) == name and f"_{kind}_kernel" in f}
            label = {"mma": "bf16", "wgmma": "bf16 Hopper",
                     "fma": "float32"}[kind]
            print(f"[build] {name} {label}: {len(got)} instantiations, "
                  f"HMMA/HGMMA per instantiation {sorted(got.values())}",
                  flush=True)
            if kind == "mma" and (not got or min(got.values()) == 0):
                raise AssertionError(f"{name}: a bf16 instantiation runs no "
                                     f"tensor-core instruction")
            if kind == "wgmma":
                per = {op: sorted(hopper[op][f] for f in got)
                       for op in hopper}
                print(f"[build] {name} bf16 Hopper: HGMMA {per['HGMMA']}, "
                      f"UTMALDG {per['UTMALDG']} per instantiation",
                      flush=True)
                dims = WGMMA_KERNELS[name]
                if (len(got) != len(dims)
                        or 0 in per["HGMMA"] + per["UTMALDG"]):
                    raise AssertionError(
                        f"{name}: expected {len(dims)} "
                        f"({WGMMA_DIM.get(name, 'D')} = "
                        f"{', '.join(map(str, dims))}) Hopper "
                        f"instantiations with wgmma products and TMA "
                        f"loads, got {per}")


def ssd_bwd_tensor_core_check(lib_path, nvcc):
    """Disassemble the built library; raise unless each bf16 instantiation
    of the SSD backward's states and grads kernels (template argument
    ``true``: ``ILb1E`` in the mangled name; 12 each) runs tensor-core
    (HMMA) instructions.  Prints the counts of both forms (the float32
    ones, ``ILb0E``, keep full fp32 products: 0)."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], check=True,
                          capture_output=True, text=True).stdout
    counts = tensor_core_counts(sass, ("HMMA",), SSD_BWD_KERNELS)
    for name in ("ssd_scan_bwd_states", "ssd_scan_bwd_grads"):
        forms = {bf: sorted(n for f, n in counts.items()
                            if kernel_of(f) == name and f"ILb{bf}E" in f)
                 for bf in (1, 0)}
        print(f"[build] {name}: bf16 {len(forms[1])} instantiations, HMMA "
              f"{forms[1]}; float32 {len(forms[0])}, HMMA {forms[0]}",
              flush=True)
        if len(forms[1]) != SSD_BWD_SHAPES or 0 in forms[1]:
            raise AssertionError(f"{name}: expected {SSD_BWD_SHAPES} bf16 "
                                 f"instantiations with tensor-core "
                                 f"products, got {forms[1]}")


# the SSD backward's kernels with a Hopper form (``*_wgmma_kernel``: bf16,
# wgmma products fed by TMA, P = 64) and the state sizes N of its
# instantiations
SSD_BWD_WGMMA = {"ssd_scan_bwd_states": (64, 128),
                 "ssd_scan_bwd_states_scan": (64, 128),
                 "ssd_scan_bwd_grads": (64, 128)}


def ssd_bwd_wgmma_check(lib_path, nvcc):
    """Disassemble the built library; raise unless the SSD backward's
    states, fused states and scan, and grads kernels each have their two
    Hopper instantiations (``*_wgmma_kernel``, N = 64 and 128) and each
    issues its products by wgmma (HGMMA) and its tiles by TMA (UTMALDG).
    Prints the counts."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], check=True,
                          capture_output=True, text=True).stdout
    counts = {op: tensor_core_counts(sass, (op,), tuple(SSD_BWD_WGMMA))
              for op in ("HGMMA", "UTMALDG")}
    for name, dims in SSD_BWD_WGMMA.items():
        per = {op: sorted(n for f, n in c.items()
                          if kernel_of(f) == name and "_wgmma_kernel" in f)
               for op, c in counts.items()}
        print(f"[build] {name} bf16 Hopper: HGMMA {per['HGMMA']}, UTMALDG "
              f"{per['UTMALDG']} per instantiation", flush=True)
        if (len(per["HGMMA"]) != len(dims)
                or 0 in per["HGMMA"] + per["UTMALDG"]):
            raise AssertionError(
                f"{name}: expected {len(dims)} (N = "
                f"{', '.join(map(str, dims))}) Hopper instantiations with "
                f"wgmma products and TMA loads, got {per}")


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


def path_wave_counts(np, wave, status, wcid, n_keys):
    """(rows, installs, reads) of ``commit_loop_cost`` for one wave
    (numpy fields) and its plain loop's status [T] and wcid [T, O]: the
    distinct keys it touches, its installs and its committed txns' live
    reads (SID bumps)."""
    kind = wave[0]
    reads = ((kind == 1) | (kind == 3)) & (status == 1)[:, None]
    return (len(np.unique(np.clip(wave[1], 0, n_keys - 1))),
            int((wcid >= 0).sum()), int(reads.sum()))


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
    from repro_torch.kernels.commit_loop import (VARIANTS, commit_loop_cost,
                                                 commit_loop_cuda,
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
    # the kernel's cost formula at this wave's distinct keys, installs and
    # SID bumps
    status, _, _, wcid, _, _ = commit_loop_plain(
        MVStore(*(t.clone() for t in store)), inputs, **kw)
    n_ops, n_bytes = commit_loop_cost(T, O, V, *path_wave_counts(
        np, wave, status.cpu().numpy(), wcid.cpu().numpy(), n_keys))
    b_ms, b_by = bound(n_bytes, n_ops)
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


# the bf16 head dims of the Hopper forward (flash_attention_wgmma_kernel)
HOPPER_FWD_DIMS = WGMMA_KERNELS["flash_attention"]
# (B, Sq, Sk, H, KH, D, dtype name, causal) of the forward's checks, each
# against the plain version (o and lse) and, in bf16, the float32 oracle;
# the Hopper kernel's twice, bit-equal: the path in bf16 and float32,
# ragged, GQA, non-causal and small odd shapes.  q and k at scale 2 make
# the softmax peaked (scores of std 4), so outputs are of the order of v
# and a wrong tile shows well above the tolerances.
ATTENTION_FWD_CASES = (
    (4, 1024, 1024, 32, 32, 80, "bf16", True),
    (4, 1024, 1024, 32, 32, 80, "f32", True),
    (4, 1000, 1000, 32, 32, 80, "bf16", True),
    (2, 1024, 1024, 14, 2, 64, "bf16", True),
    (4, 1024, 1024, 32, 32, 80, "bf16", False),
    (2, 256, 256, 4, 2, 128, "f32", True),
    (2, 200, 200, 4, 2, 80, "f32", False),
    (1, 70, 70, 2, 1, 48, "f32", True),
    (1, 1, 1, 4, 4, 16, "f32", True),
    (1, 2048, 2048, 32, 8, 128, "bf16", True),
    # phase 7's prefills: qwen3-14b, qwen2-vl-2b, deepseek-moe
    (4, 1024, 1024, 40, 8, 128, "bf16", True),
    (4, 1000, 1000, 12, 2, 128, "bf16", True),
    (4, 1024, 1024, 16, 16, 128, "bf16", True),
    # phase 8b, seamless: cross-attention of the 128-token prompt over
    # 1,024 and 1,000 encoder frames (Sq != Sk, the key tail masked), a
    # decode step's one query row, and the encoder's full self-attention
    (4, 128, 1024, 16, 16, 64, "bf16", False),
    (4, 128, 1000, 16, 16, 64, "bf16", False),
    (4, 1, 1000, 16, 16, 64, "bf16", False),
    (4, 1, 1000, 16, 16, 64, "f32", False),
    (4, 1024, 1024, 16, 16, 64, "bf16", False),
    # the Hopper kernel's edges: one query row at D = 128, causal with
    # Sk > Sq (top-left: the last kv tiles only partly reached), ragged
    # at G = 7, a 2,048-row causal walk, a q tile whose second consumer
    # group has no rows (Sq = 50) and a kv tile past Sq at D = 80
    (4, 1, 1000, 8, 8, 128, "bf16", False),
    (1, 200, 512, 14, 2, 128, "bf16", True),
    (2, 1000, 1000, 14, 2, 64, "bf16", True),
    (1, 2048, 2048, 14, 2, 64, "bf16", True),
    (2, 50, 300, 4, 4, 64, "bf16", True),
    (1, 300, 77, 10, 2, 80, "bf16", True),
    # the mma.sync kernel, bf16 at the other head dims: small and odd,
    # ragged GQA at D = 96, Sq != Sk at D = 112
    (1, 70, 70, 2, 1, 48, "bf16", True),
    (2, 300, 300, 8, 2, 96, "bf16", True),
    (1, 130, 200, 6, 3, 112, "bf16", False))


# (Bg, H, S, P, N, chunk, dtype, h0, decay, model layout): the path
# (decay as the model's dt*A, about -0.7 a step), with an initial
# state, ragged, float32, small chunks, mamba2-130m's N=128, and x / dA
# as the [B, H, S, .] views of the model's [B, S, H, .] that the path
# passes.  Those at a decay of 0.01 decay slowly (dA ~ -U(0, 0.01), as
# trained SSM heads do), so that every row tile of the state product and
# every block below the diagonal of (C B^T .* L) x carries weight: at a
# decay of 0.7 a step, rows 16 back add under e^-6 and a wrong or skipped
# block would pass unseen.
SSD_CASES = (
    (4, 80, 1024, 64, 64, 128, "bf16", False, 1.4, False),
    (4, 80, 1024, 64, 64, 128, "bf16", True, 1.4, False),
    (4, 80, 1000, 64, 64, 128, "bf16", False, 1.4, False),
    (2, 3, 256, 32, 64, 64, "f32", False, 0.3, False),
    (2, 3, 300, 64, 64, 128, "f32", True, 0.3, False),
    (2, 4, 77, 16, 16, 16, "f32", True, 0.3, False),
    (1, 2, 50, 64, 64, 128, "f32", False, 0.3, False),
    (4, 24, 1024, 64, 128, 128, "bf16", True, 1.4, False),
    (4, 80, 1000, 64, 64, 128, "bf16", True, 1.4, True),
    (2, 3, 300, 64, 64, 128, "f32", True, 0.3, True),
    (4, 80, 1024, 64, 64, 128, "bf16", True, 0.01, True),
    (4, 24, 1024, 64, 128, 128, "bf16", True, 0.01, False),
    (2, 3, 300, 32, 64, 64, "bf16", True, 0.01, False),
    # the float32 kernel at mamba2-130m's N=128, chunk 128
    # (its [M | C] rows staged in strips), both layouts
    (2, 24, 1000, 64, 128, 128, "f32", True, 0.3, False),
    (2, 24, 1000, 64, 128, 128, "f32", True, 0.01, True),
    # the Hopper kernel's edges (a cluster of min(nc, 8) blocks a
    # batch*head): 16 chunks, two rounds a block, with h0 at both N; 9
    # chunks (block 0's second round alone, the state carried over from
    # block 7); one chunk of S < 128 rows; S = 1 at both N
    (1, 4, 2048, 64, 64, 128, "bf16", True, 0.01, True),
    (1, 3, 2048, 64, 128, 128, "bf16", True, 0.01, False),
    (2, 3, 1100, 64, 64, 128, "bf16", True, 0.01, False),
    (2, 3, 100, 64, 64, 128, "bf16", True, 0.01, True),
    (2, 3, 1, 64, 64, 128, "bf16", True, 0.8, False),
    (2, 3, 1, 64, 128, 128, "bf16", False, 0.8, True))


def model_kernel_phase(torch, dev):
    """flash_attention and ssd_scan against their plain versions on the
    card, at the serve path's shapes and on edge cases; returns the two
    per-kernel records (times at the serve path's shapes)."""
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     flash_attention_plain)
    from repro_torch.kernels.ssd_scan import ssd_cuda, ssd_kernel, ssd_plain
    torch.backends.cuda.matmul.allow_tf32 = False   # plain fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32

    def rn(shape, scale, dtype):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(dtype)

    errs = {"flash_attention": [], "ssd_scan": []}
    use = {}
    for B, Sq, Sk, H, KH, D, dt, causal in ATTENTION_FWD_CASES:
        dt = bf16 if dt == "bf16" else f32
        q = rn((B, Sq, H, D), 2.0, dt)
        k, v = rn((B, Sk, KH, D), 2.0, dt), rn((B, Sk, KH, D), 1.0, dt)
        tol = 2e-2 if dt == bf16 else 2e-5
        label = (f"B={B} Sq={Sq} Sk={Sk} H={H} KH={KH} D={D} {dt} "
                 f"causal={causal}")
        o, lse = flash_attention_cuda(q, k, v, causal, with_lse=True)
        want, lse_p = flash_attention_plain(q, k, v, causal, with_lse=True)
        errs["flash_attention"].append(close_err(
            torch, "flash_attention", label, (o,), (want,), tol, tol, use))
        errs["flash_attention"].append(close_err(
            torch, "flash_attention lse", label, (lse,), (lse_p,), 1e-3,
            1e-5, use))
        if dt == bf16:
            errs["flash_attention"].append(attention_oracle_err(
                torch, label, o, q, k, v, causal, flash_attention_plain,
                use))
            if D in HOPPER_FWD_DIMS:   # the Hopper kernel: the same bits
                again = flash_attention_cuda(q, k, v, causal, with_lse=True)
                if not (torch.equal(o, again[0])
                        and torch.equal(lse, again[1])):
                    raise AssertionError(f"flash_attention [{label}]: two "
                                         f"calls on the same inputs differ")
        del q, k, v, o, lse, want, lse_p
    reached = {}
    for Bg, H, S, P, N, Q, dt, with_h0, decay, model in SSD_CASES:
        dt = bf16 if dt == "bf16" else f32
        x = rn((Bg * H, S, P), 0.5, dt)
        dA = -torch.rand((Bg * H, S), generator=g, device=dev) * decay
        if model:
            x, dA = model_layout(x, dA, Bg, H)
        Bm, Cm = rn((Bg, S, N), 0.3, dt), rn((Bg, S, N), 0.3, dt)
        h0 = rn((Bg * H, N, P), 0.2, f32) if with_h0 else None
        kern = ssd_kernel(P, N, min(Q, S), S, dt)   # the one it reaches
        reached[kern] = reached.get(kern, 0) + 1
        label = (f"BH={Bg * H} S={S} P={P} N={N} chunk={Q} {dt} "
                 f"h0={with_h0}{' model layout' if model else ''}, "
                 f"ssd_scan_{kern}_kernel")
        y, h = ssd_cuda(x, dA, Bm, Cm, H, Q, h0)
        if kern == "wgmma":   # the Hopper kernel: the same bits
            again = ssd_cuda(x, dA, Bm, Cm, H, Q, h0)
            if not (torch.equal(y, again[0]) and torch.equal(h, again[1])):
                raise AssertionError(f"ssd_scan [{label}]: two calls on "
                                     f"the same inputs differ")
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
    print(f"[kernels] flash_attention: {len(ATTENTION_FWD_CASES)} checks "
          f"(o and lse; the Hopper kernel's two calls bit-equal), ssd_scan: "
          f"{len(SSD_CASES)} checks ("
          + ", ".join(f"{n} on ssd_scan_{k}_kernel"
                      for k, n in sorted(reached.items()))
          + "; the Hopper kernel's two calls bit-equal), all within "
          f"tolerance of the plain "
          f"versions (max abs err {max(errs['flash_attention']):.3g} / "
          f"{max(errs['ssd_scan']):.3g})", flush=True)
    print(f"[kernels] closest to the limit: {limit_use_line(use)}",
          flush=True)

    # times at the serve path's shapes
    probes = scripts_module("probes")
    records = {"flash_attention": attention_times(
        torch, rn, probes, SERVE_BATCH, SERVE_PROMPTS[0], 32, 32, 80)}
    records["ssd_scan"] = ssd_times(torch, dev, rn, probes, SERVE_BATCH, 80,
                                    SERVE_PROMPTS[0], 64, 64, 128, bf16)
    for name, rec in records.items():
        records[name] = {
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": 0,
            "max_abs_err": max(errs[name]), **rec}
        mma = (f", ssd_scan_mma_kernel device {rec['mma_device_ms']} "
               f"ms/launch in the same call" if name == "ssd_scan" else "")
        print(f"[kernels] {name}: {rec['ms']:.4f} ms/call (plain "
              f"{rec['plain_ms']:.4f}, library {rec['library_ms']}), "
              f"profiler device {rec['device_ms']} ms/launch{mma}, bound "
              f"{rec['bound_ms']:.5f} ms by {rec['bound_by']}", flush=True)
    # phase 7a's prefill, phase 8b's cross-attention and phase 9's
    # training step: printed, not in the JSON line
    for what, (B, Sq, Sk, H, KH, D, causal) in (
            ("qwen3-14b's prefill", (SERVE_BATCH, 1024, 1024, 40, 8, 128,
                                     True)),
            ("seamless' cross-attention", (SERVE_BATCH, 128, 1024, 16, 16,
                                           64, False)),
            ("qwen2-0.5b's training step", (TRAIN_BATCH, TRAIN_SEQ,
                                            TRAIN_SEQ, 14, 2, 64, True))):
        rec = attention_times(torch, rn, probes, B, Sq, H, KH, D, Sk=Sk,
                              causal=causal)
        print(f"[kernels] flash_attention at {what} shape (B={B} Sq={Sq} "
              f"Sk={Sk} H={H} KH={KH} D={D} bf16 causal={causal}): "
              f"{rec['ms']:.4f} ms/call, device {rec['device_ms']} ms (plain "
              f"{rec['plain_ms']:.4f}, SDPA device {rec['library_ms']} ms, "
              f"SDPA events {rec['library_events_ms']:.4f}), bound "
              f"{rec['bound_ms']:.5f} ms by {rec['bound_by']}", flush=True)
    # phase 8a's scan (mamba2-130m: N=128) in bf16 and float32, and the
    # float32 kernel at zamba2's shape: printed, not in the JSON line
    for what, (Bg, H, N, dt) in (("mamba2-130m", (SERVE_BATCH, 24, 128, bf16)),
                                 ("mamba2-130m", (SERVE_BATCH, 24, 128, f32)),
                                 ("zamba2-2.7b", (SERVE_BATCH, 80, 64, f32))):
        rec = ssd_times(torch, dev, rn, probes, Bg, H, SERVE_PROMPTS[0], 64,
                        N, 128, dt)
        mma = ("" if rec["mma_device_ms"] is None else
               f"; ssd_scan_mma_kernel device {rec['mma_device_ms']} ms in "
               f"the same call")
        print(f"[kernels] ssd_scan at {what}'s prefill shape (BH={Bg}x{H} "
              f"S={SERVE_PROMPTS[0]} P=64 N={N} chunk 128 {dt}, model "
              f"layout): {rec['kernel']} {rec['ms']:.4f} ms/call, device "
              f"{rec['device_ms']} ms (plain {rec['plain_ms']:.4f}){mma}, "
              f"bound {rec['bound_ms']:.5f} ms by {rec['bound_by']}",
              flush=True)
    return records


def attention_times(torch, rn, probes, B, S, H, KH, D, Sk=None,
                    causal=True):
    """flash_attention at one bf16 shape (S query rows over Sk key rows,
    default S): CUDA events ms of the kernel and its plain version, the
    profiler's device ms of the kernel and of SDPA (the library call,
    reading the KH kv heads as the kernel does: its device ms, the
    library time, since its CUDA events read the host's pace; the events
    beside them), and the bytes-or-operations bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_cost,
                                                     flash_attention_cuda,
                                                     flash_attention_plain)
    Sk = S if Sk is None else Sk
    q = rn((B, S, H, D), 0.5, torch.bfloat16)
    k, v = (rn((B, Sk, KH, D), 0.5, torch.bfloat16) for _ in range(2))
    qt, kt, vt = (a.transpose(1, 2).contiguous() for a in (q, k, v))
    kern = lambda: flash_attention_cuda(q, k, v, causal)
    sdpa = lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=H != KH)
    n_ops, n_bytes = flash_attention_cost(B, S, Sk, H, KH, D, causal)
    b_ms, b_by = bound(n_bytes, n_ops, BF16_FLOPS_PER_S)
    return {
        "ms": cuda_ms(torch, kern, iters=20, warmup=3),
        "plain_ms": cuda_ms(torch, lambda: flash_attention_plain(q, k, v,
                                                                 causal),
                            iters=10, warmup=2),
        "library_ms": device_kernels_ms(torch, sdpa)[0],
        "library": "SDPA (scaled_dot_product_attention), device ms of its "
                   "kernels",
        "library_events_ms": cuda_ms(torch, sdpa, iters=20, warmup=3),
        "device_ms": probes.profile_device_ms(
            {"flash_attention": (kern, "flash_attention_")},
            iters=10)["flash_attention"],
        "bound_ms": b_ms, "bound_by": b_by}


def ssd_times(torch, dev, rn, probes, Bg, H, S, P, N, Q, dtype):
    """ssd_scan at one shape, x and dA as the views of the model's
    [B, S, H, .] layout the path passes: CUDA events ms of the kernel the
    route takes and of its plain version, the profiler's device ms of that
    kernel (and, where it is the Hopper kernel, of the mma.sync kernel at
    the same shape, ``mma_device_ms``) and the bytes-or-operations bound
    (bf16 products over the tensor rate, float32 ones over the FMA
    rate)."""
    from repro_torch.kernels.ssd_scan import (ssd_cost, ssd_cuda, ssd_kernel,
                                              ssd_plain)
    BH = Bg * H
    g = torch.Generator(device=dev).manual_seed(BH + N)
    x, dA = model_layout(rn((BH, S, P), 0.5, dtype),
                         -torch.rand((BH, S), generator=g, device=dev) * 1.4,
                         Bg, H)
    Bm, Cm = rn((Bg, S, N), 0.3, dtype), rn((Bg, S, N), 0.3, dtype)
    kern = lambda: ssd_cuda(x, dA, Bm, Cm, H, Q)
    n_ops, n_bytes = ssd_cost(BH, Bg, S, P, N, Q, dtype)
    b_ms, b_by = bound(n_bytes, n_ops, ops_rate(dtype))
    routed = ssd_kernel(P, N, min(Q, S), S, dtype)
    mma = None
    if routed == "wgmma":
        mma = probes.profile_device_ms(
            {"mma": (lambda: ssd_cuda(x, dA, Bm, Cm, H, Q, kernel="mma"),
                     "ssd_scan_mma_kernel")}, iters=10)["mma"]
    return {
        "ms": cuda_ms(torch, kern, iters=20, warmup=3),
        "plain_ms": cuda_ms(torch, lambda: ssd_plain(x, dA, Bm, Cm, H, Q),
                            iters=10, warmup=2),
        "library_ms": None,
        "device_ms": probes.profile_device_ms(
            {"ssd_scan": (kern, f"ssd_scan_{routed}_kernel")},
            iters=10)["ssd_scan"],
        "kernel": f"ssd_scan_{routed}_kernel", "mma_device_ms": mma,
        "bound_ms": b_ms, "bound_by": b_by}


# (Bg, H, S, P, N, chunk, dtype, h0, dh_final, decay, model layout) of the
# SSD backward's checks: zamba2-2.7b's and mamba2-130m's training shapes
# (B = 4, S = 1,024, the model's layout) in bf16 and float32; a ragged tail
# (S = 1,000); 16 chunks; one chunk of S < 128 rows; S = 1; h0 and
# dh_final given; decays of 0.01 (every block below the diagonal carries
# weight, as the forward's note above says) and 1.4 (a_cum reaches -179 in
# a chunk, e^179 past float32: any factored exponential overflows); the
# reduced configs' P = N = 16 in chunks of 16, and P = 32 in chunks of 64
SSD_BWD_CASES = (
    (4, 80, 1024, 64, 64, 128, "bf16", False, False, 1.4, True),
    (4, 80, 1024, 64, 64, 128, "f32", False, False, 1.4, True),
    (4, 24, 1024, 64, 128, 128, "bf16", False, False, 0.01, True),
    (4, 24, 1024, 64, 128, 128, "f32", False, False, 0.01, True),
    (4, 80, 1000, 64, 64, 128, "bf16", True, True, 1.4, True),
    (2, 24, 1000, 64, 128, 128, "f32", True, True, 0.01, False),
    (1, 4, 2048, 64, 64, 128, "bf16", True, True, 0.01, True),
    (1, 3, 2048, 64, 128, 128, "bf16", True, True, 1.4, False),
    (2, 3, 100, 64, 64, 128, "bf16", True, True, 0.01, True),
    (2, 3, 100, 64, 128, 128, "f32", False, True, 1.4, False),
    (2, 3, 1, 64, 64, 128, "bf16", True, True, 0.8, False),
    (2, 3, 1, 64, 128, 128, "f32", True, False, 0.8, True),
    (2, 4, 77, 16, 16, 16, "f32", True, True, 0.3, True),
    (2, 4, 77, 16, 16, 16, "bf16", False, True, 0.3, False),
    (2, 3, 300, 32, 64, 64, "bf16", True, False, 0.01, False),
    (1, 1, 50, 16, 32, 32, "bf16", False, False, 1.4, False))


def ssd_bwd_inputs(torch, dev, rn, g, case):
    """Seeded inputs of one SSD_BWD_CASES case on the card: (x, dA, Bm,
    Cm, dy, h0, dh), x, dA and dy as views of the model's layout where the
    case asks for it."""
    Bg, H, S, P, N, Q, dt, with_h0, with_dh, decay, model = case
    dt = torch.bfloat16 if dt == "bf16" else torch.float32
    BH = Bg * H
    x = rn((BH, S, P), 0.5, dt)
    dA = -torch.rand((BH, S), generator=g, device=dev) * decay
    dy = rn((BH, S, P), 1.0, dt)
    if model:
        x, dA = model_layout(x, dA, Bg, H)
        dy = dy.reshape(Bg, H, S, P).transpose(1, 2).contiguous().transpose(
            1, 2)
    Bm, Cm = rn((Bg, S, N), 0.3, dt), rn((Bg, S, N), 0.3, dt)
    h0 = rn((BH, N, P), 0.2, torch.float32) if with_h0 else None
    dh = rn((BH, N, P), 0.2, torch.float32) if with_dh else None
    return x, dA, Bm, Cm, dy, h0, dh


# sc of the fused states and scan kernel against the scan kernel's: the
# same N P products (hprev and G equal to the bit) summed in another order,
# each sum within about 50 roundings of 2^-24 (a thread's products in
# order, five shuffle levels, eight warps, the nc blocks), 3e-6 of
# exp(a_L) sum |h| |G|: the limit is 1e-5 of that
SSD_SC_ORDER_TOL = 1e-5


def ssd_bwd_check(torch, dev, rn, g, case, errs, use):
    """One SSD_BWD_CASES case on the card: each backward kernel against its
    plain version on the same inputs (the scan and grads kernels on the
    plain stages' outputs): float32 outputs (the states, dA, dh0, the
    scan's scalars) within 1e-3 x scale (scale = max |plain|) in both
    dtypes; dx, dB, dC in float32 within 1e-3 x scale, in bf16 within
    2e-2 x scale of the plain version (which rounds to bf16 too) and, the
    backward chained (``ssd_bwd_cuda``: the fused states and scan where
    ``ssd_bwd_fused`` says so), within one bf16 rounding (rtol 1e-2 >
    2^-8) plus 1e-3 x scale of the plain version in float32 on the same
    bf16 inputs; each kernel twice, the two results bit-equal.  Where the
    fused kernel takes the case, it too: against the plain states and
    scan (1e-3 x scale), against the states and scan kernels on the card
    (hprev, G and dh0 bit-equal, sc within SSD_SC_ORDER_TOL), two calls
    bit-equal.  Appends the max abs errors to ``errs`` (by kernel);
    ``use`` as close_err's.  Returns whether the fused kernel ran."""
    from repro_torch.kernels import ssd_scan as ss
    Bg, H, S, P, N, Q, dt, *_ = case
    x, dA, Bm, Cm, dy, h0, dh = ssd_bwd_inputs(torch, dev, rn, g, case)
    bf = x.dtype == torch.bfloat16
    label = (f"Bg={Bg} H={H} S={S} P={P} N={N} chunk={Q} {dt} "
             f"h0={h0 is not None} dh={dh is not None} decay={case[9]}"
             f"{' model layout' if case[10] else ''}")

    def same(name, a, b):
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            raise AssertionError(f"{name} [{label}]: two calls on the same "
                                 f"inputs differ")

    def check(name, got, want, tol):
        for i, (a, w) in enumerate(zip(got, want)):
            t = tol[i] if isinstance(tol, tuple) else tol
            errs[name].append(close_err(
                torch, name, f"{label} output {i}", (a,), (w,),
                t * float(w.float().abs().max()), 0.0, use))

    # states: st, U, aL (float32)
    got = ss.ssd_bwd_states_cuda(x, dA, Bm, Cm, dy, H, Q)
    same("ssd_scan_bwd_states", got,
         ss.ssd_bwd_states_cuda(x, dA, Bm, Cm, dy, H, Q))
    st, U, aL = ss.ssd_bwd_states_plain(x, dA, Bm, Cm, dy, H, Q)
    check("ssd_scan_bwd_states", got, (st, U, aL), 1e-3)
    # scan: hprev, G, dh0, sc (float32), on the plain states
    got = ss.ssd_bwd_scan_cuda(st.clone(), U.clone(), aL, h0, dh)
    same("ssd_scan_bwd_scan", got,
         ss.ssd_bwd_scan_cuda(st.clone(), U.clone(), aL, h0, dh))
    hp, G, dh0, sc = ss.ssd_bwd_scan_plain(st, U, aL, h0, dh)
    check("ssd_scan_bwd_scan", got, (hp, G, dh0, sc), 1e-3)
    # grads: dx, ddA, dB, dC, on the plain scan's outputs
    got = ss.ssd_bwd_grads_cuda(x, dA, Bm, Cm, dy, hp, G, sc, H, Q)
    same("ssd_scan_bwd_grads", got,
         ss.ssd_bwd_grads_cuda(x, dA, Bm, Cm, dy, hp, G, sc, H, Q))
    want = ss.ssd_bwd_grads_plain(x, dA, Bm, Cm, dy, hp, G, sc, H, Q)
    check("ssd_scan_bwd_grads", got, want,
          (2e-2, 1e-3, 2e-2, 2e-2) if bf else 1e-3)
    fused = ss.ssd_bwd_fused(P, N, min(Q, S), S, x.dtype)
    if fused:   # the states and the scan in one launch
        got = ss.ssd_bwd_states_scan_cuda(x, dA, Bm, Cm, dy, H, Q, h0, dh)
        same(SSD_BWD_FUSED, got, ss.ssd_bwd_states_scan_cuda(
            x, dA, Bm, Cm, dy, H, Q, h0, dh))
        check(SSD_BWD_FUSED, got, (hp, G, dh0, sc), 1e-3)
        st2, U2, aL2 = ss.ssd_bwd_states_cuda(x, dA, Bm, Cm, dy, H, Q)
        pair = ss.ssd_bwd_scan_cuda(st2, U2, aL2, h0, dh)
        if not all(torch.equal(a, b) for a, b in zip(got[:3], pair[:3])):
            raise AssertionError(f"{SSD_BWD_FUSED} [{label}]: hprev, G or "
                                 f"dh0 differ from the two launches'")
        mag = torch.exp(aL2) * (pair[0].abs() * pair[1].abs()).sum((-1, -2))
        over = float(((got[3] - pair[3]).abs()
                      - SSD_SC_ORDER_TOL * mag).max())
        if over > 0:
            raise AssertionError(f"{SSD_BWD_FUSED} [{label}]: sc beyond "
                                 f"{SSD_SC_ORDER_TOL} x exp(a_L) sum |h||G| "
                                 f"of the two launches' by {over:.3g}")
    if bf:   # the backward chained, against the float32 oracle
        chain = ss.ssd_bwd_cuda(x, dA, Bm, Cm, dy, H, Q, h0, dh)
        oracle = ss.ssd_bwd_plain(x.float(), dA, Bm.float(), Cm.float(),
                                  dy.float(), H, Q, h0, dh)
        for i, (a, w) in enumerate(zip(chain, oracle)):
            errs["ssd_scan_bwd_grads"].append(close_err(
                torch, "ssd backward oracle",
                f"{label} output {i} vs float32 oracle", (a.float(),), (w,),
                1e-3 * float(w.abs().max()),
                1e-2 if a.dtype == torch.bfloat16 else 0.0, use))
    return fused


def ssd_bwd_phase(torch, dev):
    """The SSD scan's backward kernels on the card against their plain
    versions at SSD_BWD_CASES (``ssd_bwd_check``), then the clusters of the
    fused states and scan kernel that fit at once and the times at both
    training shapes (``ssd_bwd_times``).  Returns the kernels' records
    (zamba2-2.7b's shape)."""
    g = torch.Generator(device=dev).manual_seed(4)

    def rn(shape, scale, dtype):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(dtype)

    errs = {name: [] for name in SSD_BWD_KERNELS}
    use = {}
    fused = sum(ssd_bwd_check(torch, dev, rn, g, case, errs, use)
                for case in SSD_BWD_CASES)
    print(f"[kernels] ssd backward: {len(SSD_BWD_CASES)} cases, each of "
          f"ssd_scan_bwd_states, _scan and _grads against its plain version "
          f"(and, in bf16, the backward chained against the float32 oracle)"
          f", {fused} of them also {SSD_BWD_FUSED} against the plain states "
          f"and scan and against the two launches (hprev, G, dh0 bit-equal, "
          f"sc within {SSD_SC_ORDER_TOL} x exp(a_L) sum |h||G|), all within "
          f"tolerance (max abs err " + ", ".join(
              f"{n} {max(v):.3g}" for n, v in errs.items())
          + "), each kernel's two calls bit-equal", flush=True)
    print(f"[kernels] closest to the limit: {limit_use_line(use)}",
          flush=True)
    from repro_torch.kernels import ssd_scan as ss
    probes = scripts_module("probes")
    records = {}
    for what, Bg, H, N in (("zamba2-2.7b", TRAIN_BATCH, 80, 64),
                           ("mamba2-130m", TRAIN_BATCH, 24, 128)):
        nc = -(-TRAIN_SEQ // 128)
        fit = ss.ssd_bwd_states_scan_clusters(N, nc)
        print(f"[kernels] {SSD_BWD_FUSED} at {what}'s training shape: "
              f"{fit} clusters of {nc} blocks fit on the card at once "
              f"(cudaOccupancyMaxActiveClusters), {Bg * H} clusters: "
              f"{-(-Bg * H // fit)} waves", flush=True)
        rec = ssd_bwd_times(torch, dev, rn, g, probes, Bg, H, TRAIN_SEQ, 64,
                            N, 128, torch.bfloat16)
        names = [n for n in SSD_BWD_KERNELS if n in rec]
        print(f"[kernels] ssd backward at {what}'s training shape "
              f"(BH={Bg}x{H} S={TRAIN_SEQ} P=64 N={N} chunk 128 bf16, model "
              f"layout): " + ", ".join(
                  f"{n} {rec[n]['ms']:.4f} ms (device {rec[n]['device_ms']}"
                  f" in {rec[n]['kernel']}"
                  + ("" if rec[n]["mma_device_ms"] is None else
                     f", the mma.sync form {rec[n]['mma_device_ms']}")
                  + f", bound {rec[n]['bound_ms']:.5f} by "
                  f"{rec[n]['bound_by']})" for n in names)
              + f"; the backward as routed {rec['all_ms']:.4f} ms, bound of "
              f"the backward {rec['bound_ms']:.5f} ms by {rec['bound_by']} "
              f"(the design's float32 state traffic, outside the bounds, at "
              f"the HBM rate: {rec['design_ms']:.5f} ms fused, hprev and G "
              f"written and read, 4 passes; {rec['design_chain_ms']:.5f} ms "
              f"as two launches, 8 passes); forward {rec['fwd_kernel']} "
              f"device {rec['fwd_device_ms']} ms; plain backward "
              f"{rec['plain_ms']:.4f} ms", flush=True)
        pair = [rec[n]["device_ms"] for n in SSD_BWD_KERNELS[:2]]
        got = rec[SSD_BWD_FUSED]["device_ms"]
        if None not in pair + [got]:
            print(f"[kernels] {SSD_BWD_FUSED} at {what}'s training shape: "
                  f"device {got:.5f} ms against states {pair[0]:.5f} + scan "
                  f"{pair[1]:.5f} = {sum(pair):.5f} ms, one profiler "
                  f"session ({got / sum(pair):.3f} of the pair)", flush=True)
        if not records:
            for name in SSD_BWD_KERNELS:
                plain = rec[name].get("plain_ms", rec["plain_ms"])
                records[name] = {
                    "name": name, "route": "cuda",
                    "source": KERNELS[name][0], "replaces": KERNELS[name][1],
                    "launches": 0, "max_abs_err": max(errs[name]),
                    "ms": rec[name]["ms"], "plain_ms": plain,
                    "bound_ms": rec[name]["bound_ms"],
                    "bound_by": rec[name]["bound_by"], "library_ms": None,
                    "device_ms": rec[name]["device_ms"]}
    return records


def ssd_bwd_times(torch, dev, rn, g, probes, Bg, H, S, P, N, Q, dtype):
    """The SSD backward at one shape, x, dA and dy as views of the model's
    layout: CUDA-event ms of each kernel, of the three chained and of the
    plain backward; the profiler's device ms of each kernel in the form
    the route table names beside, where that is the Hopper form, the
    states and grads kernels' mma.sync forms (``kernel="mma"``) and the
    forward kernel's, in one session; each kernel's bound and the whole
    backward's.  A bound counts only what the gradient needs: bytes, the
    gradient's inputs (x, dy, dA, B, C) that the kernel reads, each once,
    and its outputs (dx, dA, dB, dC, dh0) that the kernel writes, each
    once; operations, the products over the (row, column) pairs at or
    below each chunk's diagonal, C B^T once a group, the five state
    products, the two scans and the chunk's dot product.  The design's
    own float32 arrays are its cost, not the gradient's: st and U are
    written, read and rewritten in place as hprev and G, and read again,
    eight passes of a [BH, nc, N, P] array (``design_chain_ms``: that
    traffic over the HBM rate, outside every bound); where the states and
    the scan run fused (``ssd_bwd_fused``), st and U stay on chip and four
    passes are left, hprev and G written and read (``design_ms``).  The
    fused kernel is timed beside the pair it replaces in the same sessions,
    its bound the pair's, its plain version the plain states and scan."""
    from repro_torch.kernels import ssd_scan as ss
    BH, nc = Bg * H, -(-S // Q)
    case = (Bg, H, S, P, N, Q, "bf16" if dtype == torch.bfloat16 else "f32",
            False, False, 1.4, True)
    x, dA, Bm, Cm, dy, _, _ = ssd_bwd_inputs(torch, dev, rn, g, case)
    st, U, aL = ss.ssd_bwd_states_cuda(x, dA, Bm, Cm, dy, H, Q)
    hp, G, _, sc = ss.ssd_bwd_scan_cuda(st.clone(), U.clone(), aL)
    fns = {"ssd_scan_bwd_states": lambda: ss.ssd_bwd_states_cuda(
               x, dA, Bm, Cm, dy, H, Q),
           # rewrites st and U in place at every call: the same work
           "ssd_scan_bwd_scan": lambda: ss.ssd_bwd_scan_cuda(st, U, aL),
           "ssd_scan_bwd_grads": lambda: ss.ssd_bwd_grads_cuda(
               x, dA, Bm, Cm, dy, hp, G, sc, H, Q)}
    fused = ss.ssd_bwd_fused(P, N, Q, S, dtype)
    if fused:
        fns[SSD_BWD_FUSED] = lambda: ss.ssd_bwd_states_scan_cuda(
            x, dA, Bm, Cm, dy, H, Q)
    hopper = ss.ssd_bwd_kernel(P, N, Q, S, dtype) == "wgmma"
    # the CUDA functions the profiler reads: the states and grads kernels'
    # Hopper forms where they run, else the template's form
    names = {n: n + ("_wgmma_kernel" if hopper and n != "ssd_scan_bwd_scan"
                     else "_kernel") for n in fns}
    # beside the Hopper forms, the mma.sync forms they replace
    mma = {} if not hopper else {
        "ssd_scan_bwd_states": lambda: ss.ssd_bwd_states_cuda(
            x, dA, Bm, Cm, dy, H, Q, kernel="mma"),
        "ssd_scan_bwd_grads": lambda: ss.ssd_bwd_grads_cuda(
            x, dA, Bm, Cm, dy, hp, G, sc, H, Q, kernel="mma")}
    fwd_kernel = f"ssd_scan_{ss.ssd_kernel(P, N, Q, S, dtype)}_kernel"
    out = {n: {"ms": cuda_ms(torch, f, iters=20, warmup=3)}
           for n, f in fns.items()}
    device = probes.profile_device_ms(
        {**{n: (f, names[n]) for n, f in fns.items()},
         **{n + " (mma)": (f, n + "_kernel") for n, f in mma.items()},
         "forward": (lambda: ss.ssd_cuda(x, dA, Bm, Cm, H, Q), fwd_kernel)},
        iters=10)
    rate = ops_rate(dtype)
    shape = (BH, Bg, S, P, N, Q, dtype)
    costs = {"ssd_scan_bwd_states": (ss.ssd_bwd_states_cost(*shape), rate),
             "ssd_scan_bwd_scan": (ss.ssd_bwd_scan_cost(BH, nc, N, P),
                                   ALU_OPS_PER_S),
             SSD_BWD_FUSED: (ss.ssd_bwd_states_scan_cost(*shape), rate),
             "ssd_scan_bwd_grads": (ss.ssd_bwd_grads_cost(*shape), rate)}
    bounds = {n: bound(c[1], c[0], r) for n, (c, r) in costs.items()}
    for n in fns:
        out[n].update(device_ms=device[n], kernel=names[n],
                      mma_device_ms=device.get(n + " (mma)"),
                      bound_ms=bounds[n][0], bound_by=bounds[n][1])
    if fused:
        out[SSD_BWD_FUSED]["plain_ms"] = cuda_ms(
            torch, lambda: ss.ssd_bwd_states_scan_plain(
                x, dA, Bm, Cm, dy, H, Q), iters=3, warmup=1)
    n_ops, n_bytes = ss.ssd_bwd_cost(*shape)
    whole = bound(n_bytes, n_ops, rate)
    state_ms = BH * nc * N * P * 4 / HBM_BYTES_PER_S * 1e3   # one pass
    out.update(all_ms=cuda_ms(torch, lambda: ss.ssd_bwd_cuda(
                   x, dA, Bm, Cm, dy, H, Q), iters=20, warmup=3),
               plain_ms=cuda_ms(torch, lambda: ss.ssd_bwd_plain(
                   x, dA, Bm, Cm, dy, H, Q), iters=3, warmup=1),
               fwd_kernel=fwd_kernel, fwd_device_ms=device["forward"],
               bound_ms=whole[0], bound_by=whole[1],
               design_ms=(4 if fused else 8) * state_ms,
               design_chain_ms=8 * state_ms)
    return out


# (B, Sq, Sk, H, KH, D, dtype name, causal) of the attention backward's
# checks: phase 9's training shape (qwen2-0.5b) in bf16 and float32,
# ragged, GQA at G = 1, 3 and 7, D = 128 at G = 7, seamless'
# cross-attention, one query row, causal with Sk > Sq (kv tiles no query
# reaches), an odd count of (query head, q tile) pairs a kv tile (G = 3,
# ragged: the Hopper dk/dv kernel's four consumer groups take them in
# turn) and small odd shapes
ATTENTION_BWD_CASES = (
    (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 14, 2, 64, "bf16", True),
    (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 14, 2, 64, "f32", True),
    (TRAIN_BATCH, 1000, 1000, 14, 2, 64, "bf16", True),
    (2, 1000, 1000, 14, 2, 64, "f32", True),
    (2, TRAIN_SEQ, TRAIN_SEQ, 16, 16, 64, "bf16", True),
    (2, TRAIN_SEQ, TRAIN_SEQ, 7, 1, 128, "bf16", True),
    (1, 300, 300, 7, 1, 128, "bf16", False),
    (2, 200, 200, 3, 1, 64, "bf16", True),
    (1, 70, 70, 3, 1, 64, "bf16", True),
    (1, 200, 512, 4, 2, 64, "bf16", True),
    (1, 200, 512, 14, 2, 128, "bf16", True),
    (4, 128, 1024, 16, 16, 64, "bf16", False),
    (4, 128, 1000, 16, 16, 64, "f32", False),
    (4, 1, 1000, 16, 16, 64, "bf16", False),
    (4, 1, 1000, 16, 16, 64, "f32", False),
    (1, 70, 70, 2, 1, 48, "f32", True),
    (2, 200, 200, 4, 2, 80, "bf16", False))


def attention_bwd_walks(B, Sq, Sk, H, KH, D):
    """The launch geometry of the bf16 Hopper backward kernels (D = 64,
    128) at a causal shape: {kernel: (grid, the longest walk of one
    consumer group: (query head, q tile) pairs for dk/dv, kv tiles for dq,
    and the same for a block)}.  dk/dv: clusters of two blocks a 64-row kv
    tile, four consumer groups taking the tile's pairs in turn; dq: a block
    a 128-row q tile, two groups of 64 rows."""
    G, nq, nk = H // KH, -(-Sq // 64), -(-Sk // 64)
    pairs = G * nq                            # kv tile 0 meets every q tile
    dq_tiles = min(nk, (-(-Sq // 128) * 128 - 1) // 64 + 1)
    return {"flash_attention_bwd_dkdv": ((2 * nk, B * KH), -(-pairs // 4),
                                         -(-pairs // 2)),
            "flash_attention_bwd_dq": ((-(-Sq // 128), B * H), dq_tiles,
                                       dq_tiles)}


def device_kernels_ms(torch, fn, iters=5):
    """(device ms of every CUDA kernel one call of ``fn`` launches, summed,
    and their names by device time), from the profiler over ``iters``
    calls; (None, [why]) where the profiler shows no device time.  Unlike
    CUDA events around back-to-back calls it does not read the host's pace
    where a call's host time exceeds its device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and getattr(e, "device_time_total", 0) > 0]
    except Exception as exc:           # the profiler is optional here
        return None, [f"profiler unavailable: {exc!r}"]
    if not evts:
        return None, ["no device time"]
    evts.sort(key=lambda e: -e.device_time_total)
    return (sum(e.device_time_total for e in evts) / 1e3 / iters,
            [e.key for e in evts])


def sdpa_backward_times(torch, q, k, v, do, H, KH):
    """SDPA's backward (dq, dk, dv of one causal
    ``scaled_dot_product_attention`` call: the yardstick, never called by
    the port), unforced and with each backend forced in turn: {backend:
    (device ms, CUDA-events ms, how, its kernels' names)}, the device ms
    the summed kernels of one call (the events also read the host's pace:
    an autograd call's host time can exceed its device time).  A backend
    that refuses ``enable_gqa`` is timed on K and V expanded to H heads,
    one that refuses the shape is (None, None, its reason, [])."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt, dot = (a.transpose(1, 2).contiguous() for a in (q, k, v, do))
    G = H // KH

    def backward_times(keys, values, gqa, backend=None):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (qt, keys, values)]
        ctx = sdpa_kernel(backend) if backend is not None else \
            contextlib.nullcontext()
        with ctx:
            o = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                               enable_gqa=gqa)
            fn = lambda: torch.autograd.grad(o, leaves, dot,
                                             retain_graph=True)
            events = cuda_ms(torch, fn, iters=10, warmup=2)
            dev_ms, names = device_kernels_ms(torch, fn)
        return dev_ms, events, names

    out = {}
    for name, backend in (("unforced", None),
                          ("flash", SDPBackend.FLASH_ATTENTION),
                          ("efficient", SDPBackend.EFFICIENT_ATTENTION),
                          ("cuDNN", SDPBackend.CUDNN_ATTENTION)):
        how = "enable_gqa" if H != KH else "as given"
        try:
            dev_ms, events, names = backward_times(kt, vt, H != KH, backend)
        except RuntimeError as exc:
            if H == KH or backend is None:
                out[name] = (None, None, f"refused: "
                             f"{str(exc).splitlines()[0]}", [])
                continue
            how = "K and V expanded to H heads (refuses enable_gqa)"
            try:
                dev_ms, events, names = backward_times(
                    kt.repeat_interleave(G, dim=1),
                    vt.repeat_interleave(G, dim=1), False, backend)
            except RuntimeError as exc2:
                out[name] = (None, None, f"refused: "
                             f"{str(exc2).splitlines()[0]}", [])
                continue
        out[name] = (dev_ms, events, how, names)
    return out


def attention_bwd_phase(torch, dev):
    """The two attention backward kernels against their plain version
    (``flash_attention_bwd_plain``, the same formulas in float32) on the
    card, on the lse and o of the forward kernel, at ATTENTION_BWD_CASES;
    every case twice, the two results bit-equal; where causal with Sk > Sq
    the key rows no query reaches get zero dk and dv; the forward's lse
    against the plain version's.  Then CUDA-event times at the training
    shape beside the plain version's and SDPA's backward unforced and with
    each backend forced (device ms of its kernels; the fastest forced is the
    records' library time), and the Hopper kernels' grids and longest
    walks.  Returns the two kernels' records."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_bwd_dkdv_cuda,
        flash_attention_bwd_dq_cuda, flash_attention_bwd_plain,
        flash_attention_cuda, flash_attention_plain)
    g = torch.Generator(device=dev).manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32

    def rn(shape, scale, dtype):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(dtype)

    B, S, H, KH, D = TRAIN_BATCH, TRAIN_SEQ, 14, 2, 64
    # q and k at scale 2 make the softmax peaked, as in the forward's checks
    errs, use = [], {}
    for b, Sq, Sk, h, kh, d, dt, causal in ATTENTION_BWD_CASES:
        dt = bf16 if dt == "bf16" else f32
        q = rn((b, Sq, h, d), 2.0, dt)
        k, v = rn((b, Sk, kh, d), 2.0, dt), rn((b, Sk, kh, d), 1.0, dt)
        do = rn((b, Sq, h, d), 1.0, dt)
        label = (f"B={b} Sq={Sq} Sk={Sk} H={h} KH={kh} D={d} {dt} "
                 f"causal={causal}")
        o, lse = flash_attention_cuda(q, k, v, causal, with_lse=True)
        _, lse_p = flash_attention_plain(q, k, v, causal, with_lse=True)
        close_err(torch, "flash_attention lse", label, (lse,), (lse_p,),
                  1e-4, 1e-5, use)
        got = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
        again = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"flash_attention_bwd [{label}]: two calls "
                                 f"on the same inputs differ")
        if causal and Sk > Sq and any(bool(t[:, Sq:].any())
                                      for t in got[1:]):
            raise AssertionError(f"flash_attention_bwd [{label}]: nonzero "
                                 f"dk or dv past the last query")
        want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
        # float32: sums in another order; bf16: both round one float32
        # value once (rtol 1e-2 > 2^-8), plus 1e-3 of the largest |want|
        # for the order of sums
        rtol = 1e-2 if dt == bf16 else 1e-4
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            atol = (1e-3 if dt == bf16 else 1e-5) * float(
                w.float().abs().max())
            errs.append(close_err(torch, f"flash_attention_bwd {name}",
                                  label, (a,), (w,), atol, rtol, use))
        del q, k, v, do, o, lse, lse_p, got, again, want
    print(f"[kernels] flash_attention_bwd: {len(ATTENTION_BWD_CASES)} checks"
          f" of dq, dk, dv against flash_attention_bwd_plain, all within "
          f"tolerance (max abs err {max(errs):.3g}), each case's two calls "
          f"bit-equal", flush=True)
    print(f"[kernels] closest to the limit: {limit_use_line(use)}",
          flush=True)

    # times at the training shape, bf16
    probes = scripts_module("probes")
    q = rn((B, S, H, D), 0.5, bf16)
    k, v = (rn((B, S, KH, D), 0.5, bf16) for _ in range(2))
    do = rn((B, S, H, D), 0.5, bf16)
    o, lse = flash_attention_cuda(q, k, v, True, with_lse=True)
    _, delta = flash_attention_bwd_dq_cuda(q, k, v, o, lse, do, True)
    fns = {"flash_attention_bwd_dq": lambda: flash_attention_bwd_dq_cuda(
               q, k, v, o, lse, do, True),
           "flash_attention_bwd_dkdv": lambda: flash_attention_bwd_dkdv_cuda(
               q, k, v, do, lse, delta, True)}
    ms = {n: cuda_ms(torch, fn, iters=10, warmup=2) for n, fn in fns.items()}
    both_ms = cuda_ms(torch, lambda: flash_attention_bwd_cuda(
        q, k, v, o, lse, do, True), iters=10, warmup=2)
    fwd_ms = cuda_ms(torch, lambda: flash_attention_cuda(
        q, k, v, True, with_lse=True), iters=20, warmup=3)
    plain_ms = cuda_ms(torch, lambda: flash_attention_bwd_plain(
        q, k, v, o, lse, do, True), iters=5, warmup=1)
    device = probes.profile_device_ms(
        {"flash_attention_bwd_dq": (fns["flash_attention_bwd_dq"],
                                    "flash_attention_bwd_dq_"),
         "flash_attention_bwd_dkdv": (fns["flash_attention_bwd_dkdv"],
                                      "flash_attention_bwd_dkdv_")},
        iters=5)
    backends = sdpa_backward_times(torch, q, k, v, do, H, KH)
    for name, (dev_ms, events, how, names) in backends.items():
        print(f"[kernels] SDPA backward, {name}"
              + ("" if name == "unforced" else " forced") + ": "
              + ("refused" if events is None else
                 f"device {dev_ms} ms, events {events:.4f} ms")
              + f" ({how}); its kernels by device time: "
              f"{[n[:90] for n in names[:3]]}", flush=True)
    timed = {n: r[0] for n, r in backends.items()
             if n != "unforced" and r[0] is not None}
    fastest = min(timed, key=timed.get) if timed else None
    sdpa_bwd_ms = backends["unforced"][0]
    from repro_torch.kernels import flash_attention as fa
    shape = (B, S, S, H, KH, D, True)
    bounds = {n: bound(*reversed(getattr(fa, n + "_cost")(*shape)),
                       BF16_FLOPS_PER_S) for n in fns}
    whole = bound(*reversed(fa.flash_attention_bwd_cost(*shape)),
                  BF16_FLOPS_PER_S)
    print(f"[kernels] attention backward at phase 9's training shape (B={B} "
          f"S={S} H={H} KH={KH} D={D} bf16 causal): dq kernel "
          f"{ms['flash_attention_bwd_dq']:.4f} ms, dk/dv kernel "
          f"{ms['flash_attention_bwd_dkdv']:.4f} ms, both "
          f"{both_ms:.4f} ms (device {device}); bound of the backward "
          f"{whole[0]:.5f} ms by {whole[1]}; forward with lse "
          f"{fwd_ms:.4f} ms; plain backward {plain_ms:.4f} ms; SDPA "
          f"backward device {sdpa_bwd_ms} ms unforced, fastest forced "
          f"{fastest} " + ("none" if fastest is None
                           else f"device {timed[fastest]:.4f} ms"),
          flush=True)
    walks = attention_bwd_walks(B, S, S, H, KH, D)
    for name, (grid, group, block) in walks.items():
        unit = "pairs" if name.endswith("dkdv") else "kv tiles"
        print(f"[kernels] {name} (Hopper, D={D}): grid {grid}"
              + (" in clusters of 2" if name.endswith("dkdv") else "")
              + f", 384 threads a block; the longest walk {block} {unit} a "
              f"block, {group} a consumer group", flush=True)
    records = {}
    for name in fns:
        records[name] = {
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": 0,
            "max_abs_err": max(errs), "ms": ms[name], "plain_ms": plain_ms,
            "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
            "library_ms": None if fastest is None else timed[fastest],
            "library": None if fastest is None else
            f"SDPA backward (dq, dk, dv), {fastest} forced, "
            f"{backends[fastest][2]}, device ms of its kernels",
            "device_ms": device[name], "sdpa_backward_ms": sdpa_bwd_ms}
        print(f"[kernels] {name}: {ms[name]:.4f} ms/call (plain backward "
              f"{plain_ms:.4f}), profiler device {device[name]} ms/launch, "
              f"bound {bounds[name][0]:.5f} ms by {bounds[name][1]}",
              flush=True)
    return records


# ------------------------------------------------------------ phase 6
def forced_logits(torch, model, params, batch, forced, max_len):
    """Logits of every generated position when the prefill ``batch`` is fed
    the tokens ``forced`` ([B, n]) instead of its own: [B, n, vocab]
    float32."""
    logits, cache = model.prefill(params, batch, max_len)
    out = [logits[:, -1]]
    for i in range(forced.shape[1] - 1):
        logits, cache = model.decode(params, cache,
                                     {"token": forced[:, i:i + 1]})
        out.append(logits[:, -1])
    return torch.stack(out, dim=1)


def profile_call(torch, label, fn, card, tag="serve"):
    """Device kernels, busy share and top device ops of one call of
    ``fn``; returns {model kernel function: launches} as the profiler
    names them (empty where it cannot read the trace)."""
    prof = start_profiler(tag)
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not stop_profiler(prof, tag):
        return {}
    try:
        kernels = [e for e in prof.events()
                   if getattr(e, "device_type", None) is not None
                   and "CUDA" in str(e.device_type)]
        busy = sum(getattr(e, "device_time", 0) for e in kernels) / 1e6
        tops = sorted(prof.key_averages(),
                      key=lambda e: -getattr(e, "device_time_total", 0))[:8]
        print(f"[{tag}] profile of {label}: wall "
              f"{wall * 1e3:.1f} ms, {len(kernels)} device kernels, device "
              f"busy {busy * 1e3:.2f} ms ({100 * busy / wall:.1f}% of wall)"
              f" [{card}]", flush=True)
        print(f"[{tag}]   top device time: " + "; ".join(
            f"{e.key[:48]} {getattr(e, 'device_time_total', 0) / 1e3:.2f}"
            f" ms x{e.count}" for e in tops), flush=True)
        model, model_ms = {}, {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", 0)
            if kernel_of(e.key) in MODEL_KERNELS + SSD_BWD_KERNELS and t > 0:
                fn_name = e.key.split("(")[0].replace("void ", "")
                model[fn_name] = model.get(fn_name, 0) + e.count
                model_ms[fn_name] = model_ms.get(fn_name, 0) + t / 1e3
        print(f"[{tag}]   model kernels: " + (", ".join(
            f"{k} x{n} {model_ms[k]:.2f} ms" for k, n in sorted(model.items()))
            or "none") + (f"; {sum(model_ms.values()):.2f} ms of the busy "
                          f"time" if model else ""), flush=True)
        return model
    except Exception as exc:           # reading the trace is optional here
        print(f"[{tag}] profile unavailable: {exc!r}", flush=True)
    return {}


def ssd_check(mcfg, profile, use, tag, S):
    """``profile()`` profiles one prefill of ``mcfg`` over S positions and
    returns ``profile_call``'s {kernel function: launches}; on the kernel
    route a model with SSD layers must show its scans on the kernel the
    route table names for its (P, N, chunk) (the Hopper kernel at the full
    configs' shapes in bf16).  The launch counters, checked before, hold
    the count of scans; the trace shows which kernel ran them: it fails
    where a traced scan ran on another kernel, or where it holds no scan
    or more than one a layer (the profiler can drop an event, so fewer
    is taken)."""
    from repro_torch.kernels.ssd_scan import ssd_kernel
    n = model_launches(mcfg)[0]["ssd_scan"]
    want = "ssd_scan_{}_kernel".format(ssd_kernel(
        mcfg.headdim, mcfg.d_state, min(mcfg.ssd_chunk, S), S,
        mcfg.compute_dtype))
    seen = profile()
    if not (seen and use and n):
        return
    got = {k: c for k, c in seen.items() if kernel_of(k) == "ssd_scan"}
    traced = sum(got.values())
    if not (len(got) == 1 and next(iter(got)).startswith(want)
            and 0 < traced <= n):
        raise AssertionError(f"{mcfg.name}: the prefill's scans ran on "
                             f"{got}, expected {want} x{n}")
    print(f"[{tag}] {mcfg.name}: the prefill's scans ran on "
          f"{next(iter(got))} ({traced} of {n} in the trace)", flush=True)


def model_launches(mcfg):
    """Kernel launches on the ``cuda`` route of one prefill and of one
    decode step: the hybrid family attends once a group and scans once a
    layer, the SSM family scans once a layer, the decoder family attends
    once a layer; the encoder-decoder family attends once an encoder layer
    and twice a decoder layer (itself, then the encoder's output), and in
    a decode step once a decoder layer (cross-attention of the one new
    row).  Every other decode step is plain PyTorch."""
    step = {"flash_attention": 0, "ssd_scan": 0}
    if mcfg.family == "hybrid":
        pre = {"flash_attention": mcfg.n_layers // mcfg.attn_every,
               "ssd_scan": mcfg.n_layers}
    elif mcfg.family == "ssm":
        pre = {"flash_attention": 0, "ssd_scan": mcfg.n_layers}
    elif mcfg.family == "encdec":
        pre = {"flash_attention": mcfg.n_enc_layers + 2 * mcfg.n_layers,
               "ssd_scan": 0}
        step = {"flash_attention": mcfg.n_layers, "ssd_scan": 0}
    else:
        pre = {"flash_attention": mcfg.n_layers, "ssd_scan": 0}
    return pre, step


def serve_phase(torch, dev, cfg, card, mcfg=None, route="cuda",
                n_versions=2, prompts=None, tag="serve", src_lens=None,
                gate_bf16=True, dry=None):
    """zamba2-2.7b (or ``mcfg``) behind ``Server`` on ``route``, with
    ``n_versions`` random weight versions (the second published after the
    first batch) over ``prompts`` (default ``SERVE_PROMPTS``; the first
    ``cfg.serve_batches`` of them), an encoder-decoder model over seeded
    frame embeddings of ``src_lens`` frames a batch.  Returns the launch
    counts of the served batches (the counted path); measures and
    cross-checks against the ``torch`` route after reading them (the bf16
    distance gated only where ``gate_bf16``).  A model of ``DRY_PREFILLS``
    makes one more prefill under the counter for phase 9g, into ``dry``
    (``dry_run_call``)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve import Server, prompt_batch
    from repro_torch.models.model import build
    from repro_torch.models.module import tree_leaves
    mcfg = get_config(SERVE_ARCH) if mcfg is None else mcfg
    prompts = SERVE_PROMPTS if prompts is None else prompts
    n = min(cfg.serve_batches, len(prompts))
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    t0 = time.perf_counter()
    versions = [build(mcfg).init(gen) for _ in range(n_versions)]
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(versions[0]))
    n_bytes = sum(t.numel() * t.element_size()
                  for t in tree_leaves(versions[0]))
    print(f"[{tag}] {mcfg.name}: {n_params:,} parameters per version "
          f"(param_count {mcfg.param_count():,}; {n_bytes / 1e9:.1f} GB in "
          f"{str(mcfg.param_dtype).split('.')[-1]}), {n_versions} "
          f"version(s) made on the card in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.RandomState(cfg.seed + 3)
    prompts = [rng.randint(0, mcfg.vocab_size, (SERVE_BATCH, S))
               .astype(np.int32) for S in prompts[:n]]
    frames = [None] * n
    if src_lens is not None:
        erng = np.random.RandomState(cfg.seed + 5)
        frames = [(erng.randn(SERVE_BATCH, S, mcfg.d_model) * ENC_SCALE)
                  .astype(np.float32) for S in src_lens[:n]]
    srv = Server(mcfg, versions[0], batch_size=SERVE_BATCH, kernels=route,
                 device=dev)
    torch.cuda.reset_peak_memory_stats()
    results = []
    reset_launch_counts()
    for i, toks in enumerate(prompts):
        if i == 1 and n_versions > 1 and not srv.publish(versions[1]):
            raise AssertionError("publish of weight version 1 failed")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = srv.serve_batch(toks, max_new_tokens=cfg.new_tokens,
                            enc_embeds=frames[i])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        results.append(r)
        src = ("" if frames[i] is None else
               f" over {frames[i].shape[1]} encoder frames")
        print(f"[{tag}] batch {i}: {SERVE_BATCH} x {toks.shape[1]} prompt "
              f"tokens{src} + {cfg.new_tokens} new, weight version "
              f"{r['weight_version']}, {wall:.3f} s, "
              f"{SERVE_BATCH * cfg.new_tokens / wall:.1f} generated tokens/s"
              f" [{card}]", flush=True)
    counts = dict(LAUNCHES)
    want = ([0, 1, 1] if n_versions > 1 else [0, 0, 0])[:n]
    got = [r["weight_version"] for r in results]
    if got != want or srv.stats.versions_served != want:
        raise AssertionError(f"weight versions served {got}, expected {want}")
    if srv.stats.batches != n or srv.stats.publishes != min(
            n - 1, n_versions - 1):
        raise AssertionError(f"serve stats {srv.stats}")
    for r in results:
        g_ = r["generated"]
        if g_.shape != (SERVE_BATCH, cfg.new_tokens) or g_.min() < 0 \
                or g_.max() >= mcfg.vocab_size:
            raise AssertionError(f"generated ids {g_.shape} out of range")
    pre, step = model_launches(mcfg)
    use = srv.kernels.use_kernel
    expected = {k: (v + (cfg.new_tokens - 1) * step[k]) * n if use else 0
                for k, v in pre.items()}
    print(f"[{tag}] versions {got}, stats {srv.stats}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches "
          f"{counts} ({n} prefills and {n * (cfg.new_tokens - 1)} decode "
          f"steps: expected {expected}) [{card}]", flush=True)
    if {k: counts[k] for k in expected} != expected:
        raise AssertionError(f"{mcfg.name}: launches {counts}, expected "
                             f"{expected}")

    # ---- measurement (not counted): prefill and decode times, a profile,
    # and the launches of one prefill and of one decode step apart
    params = versions[0]
    toks = torch.as_tensor(prompts[0], device=dev)
    batch = prompt_batch(mcfg, toks, frames[0])
    max_len = toks.shape[1] + srv.cache_margin
    launched = lambda before: {k: LAUNCHES[k] - before[k] for k in pre}
    times = []
    for _ in range(3):
        before = dict(LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = srv.prefill(params, batch, max_len)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if launched(before) != {k: v * use for k, v in pre.items()}:
            raise AssertionError(f"{mcfg.name}: one prefill launched "
                                 f"{launched(before)}, expected {pre}")
    tok = torch.zeros((SERVE_BATCH, 1), dtype=torch.int32, device=dev)
    steps = max(cfg.new_tokens - 1, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        before = dict(LAUNCHES)
        tok, cache = srv.decode(params, cache, {"token": tok})
        if i == 0 and launched(before) != {k: v * use
                                           for k, v in step.items()}:
            raise AssertionError(f"{mcfg.name}: one decode step launched "
                                 f"{launched(before)}, expected {step}")
    torch.cuda.synchronize()
    dec = (time.perf_counter() - t0) / steps
    print(f"[{tag}] {mcfg.name} prefill {SERVE_BATCH} x {toks.shape[1]}: "
          + ", ".join(f"{t * 1e3:.1f}" for t in times)
          + f" ms ({SERVE_BATCH * toks.shape[1] / min(times):.0f} prompt "
          f"tokens/s); decode {dec * 1e3:.2f} ms/step "
          f"({SERVE_BATCH / dec:.1f} tokens/s at batch {SERVE_BATCH}); peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
          f" GiB [{card}]", flush=True)
    profile_call(torch, f"one {mcfg.name} decode step", lambda: srv.decode(
        params, cache, {"token": tok}), card, tag)
    del cache
    if dry is not None and mcfg.name in DRY_PREFILLS and use:
        dry_run_call(torch, dry, f"{mcfg.name} prefill {SERVE_BATCH} x "
                     f"{toks.shape[1]}", srv.prefill,
                     (params, batch, max_len), min(times) * 1e3)
    ssd_check(mcfg, lambda: profile_call(
        torch, f"one {mcfg.name} prefill (S={toks.shape[1]})",
        lambda: srv.prefill(params, batch, max_len), card, tag), use, tag,
        toks.shape[1])

    # ---- the kernels on the path's own activations
    in_situ_check(torch, srv, params, batch, max_len, tag)
    if mcfg.moe:
        moe_sync_check(torch, srv, params, batch, max_len, tag)

    # ---- the served route against the torch route, teacher-forced with
    # the served tokens.  In float32 compute the two differ only in the
    # order of sums: gated at 1e-3 * scale.  In bf16, the served type, the
    # two round at different places (attention's probabilities, the scan's
    # sums) and dozens of layers of random weights amplify that far past
    # 0.06 * scale, so bf16 is gated against the rounding noise of the
    # torch route itself: cuda vs torch in bf16 within 1.5 times the torch
    # route's own bf16-vs-float32 distance.  An MoE layer's routing is a
    # discontinuous function of its input: where two experts nearly tie,
    # float32 sums in another order can flip the choice, so the float32
    # distance of an MoE model is printed, not gated.
    f32 = mcfg.replace(compute_dtype=torch.float32)
    models = {(dt, r): build(c, kernels=k)
              for dt, c in (("bf16", mcfg), ("fp32", f32))
              for r, k in (("cuda", route), ("torch", "torch"))}
    for i, (toks, r) in enumerate(zip(prompts, results)):
        params = versions[r["weight_version"]]
        batch = prompt_batch(mcfg, torch.as_tensor(toks, device=dev),
                             frames[i])
        forced = torch.as_tensor(r["generated"], device=dev)
        lg = {key: forced_logits(torch, m, params, batch, forced,
                                 toks.shape[1] + srv.cache_margin)
              [..., :mcfg.vocab_size] for key, m in models.items()}
        for key, v in lg.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{tag}: {key} logits not finite")
        diff = lambda a, b: float((lg[a] - lg[b]).abs().max())
        scale = max(float(lg["fp32", "torch"].abs().max()), 1.0)
        e32 = diff(("fp32", "cuda"), ("fp32", "torch"))
        e16 = diff(("bf16", "cuda"), ("bf16", "torch"))
        own = diff(("bf16", "torch"), ("fp32", "torch"))
        first = float((lg["bf16", "cuda"][:, 0]
                       - lg["bf16", "torch"][:, 0]).abs().max())
        same = float((lg["bf16", "cuda"].argmax(-1) == forced).float().mean())
        gate = (f"bound {1.5 * own:.4f} = 1.5 *" if gate_bf16 else
                "printed, not gated, beside")
        print(f"[{tag}] {mcfg.name} batch {i} teacher-forced "
              f"({forced.shape[1]} steps): float32 cuda vs torch logits max "
              f"abs diff {e32:.3g} (bound {1e-3 * scale:.3g} = 1e-3 * {scale:.3f}); bf16 cuda vs torch "
              f"{e16:.4f} ({gate} the torch route's "
              f"bf16 vs float32 {own:.4f}; at the prefill's token "
              f"{first:.4f}), bf16 vs float32 on the cuda route "
              f"{diff(('bf16', 'cuda'), ('fp32', 'cuda')):.4f}; "
              f"bf16 cuda argmax = served token at {100 * same:.1f}% of "
              f"steps", flush=True)
        if e32 > 1e-3 * scale:
            raise AssertionError(f"{tag} batch {i}: cuda route logits differ "
                                 f"from the torch route by {e32} in float32")
        if gate_bf16 and e16 > 1.5 * own:
            raise AssertionError(f"{tag} batch {i}: cuda route bf16 logits "
                                 f"differ from the torch route's by {e16}, "
                                 f"more than 1.5 x its own bf16 rounding "
                                 f"distance {own}")
    return counts


def decoder_phase(torch, dev, cfg, card, runs=None, route="cuda", dry=None):
    """Phase 7: ``DecoderLM`` behind ``Server`` at full width, one
    ``serve_phase`` a configuration of ``runs`` (default ``DECODER_RUNS``,
    built from the registry; tuples of step, config, weight versions,
    prompt lengths and a note printed first), each model's versions freed
    before the next is made; ``dry`` as ``serve_phase``'s.
    Returns the launch counts of all their served batches."""
    import gc
    from repro_torch.configs import get_config
    if runs is None:
        runs = []
        for step, arch, n_versions, prompts, layers in DECODER_RUNS:
            mcfg, note = get_config(arch), ""
            if layers is not None:
                gb = lambda c: c.param_count() * c.param_dtype.itemsize / 1e9
                cut = mcfg.replace(n_layers=layers)
                note = (f"full width, depth cut from {mcfg.n_layers} to "
                        f"{layers} layers: {gb(mcfg):.1f} GB at full depth "
                        f"in {str(mcfg.param_dtype).split('.')[-1]}, the "
                        f"config's param_dtype, {gb(cut):.1f} GB cut")
                mcfg = cut
            runs.append((step, mcfg, n_versions, prompts, note))
    total = {}
    for step, mcfg, n_versions, prompts, note in runs:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        if note:
            print(f"[decoder] {step} {mcfg.name}: {note}", flush=True)
        print(f"[decoder] {step} {mcfg.name}: {mcfg.family}, "
              f"{mcfg.n_layers} layers, d_model {mcfg.d_model}, "
              f"{mcfg.n_heads} heads over {mcfg.n_kv_heads} kv heads of "
              f"{mcfg.head_dim}, {n_versions} weight version(s) on "
              f"{route} [{card}]", flush=True)
        counts = serve_phase(torch, dev, cfg, card, mcfg=mcfg, route=route,
                             n_versions=n_versions, prompts=prompts,
                             tag="decoder", dry=dry)
        print(f"[decoder] {step} {mcfg.name}: {time.perf_counter() - t0:.1f}"
              f" s with its measurements", flush=True)
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
    gc.collect()
    torch.cuda.empty_cache()
    return total


def ssm_encdec_phase(torch, dev, cfg, card, runs=None, route="cuda"):
    """Phase 8: ``SSMModel`` (mamba2-130m) and ``EncDecModel``
    (seamless-m4t-large-v2) behind ``Server`` at full width and depth, one
    ``serve_phase`` a configuration of ``runs`` (default
    ``SSM_ENCDEC_RUNS``, built from the registry; tuples of step, config,
    weight versions, prompt lengths and encoder frames a batch or None),
    each model's versions freed before the next is made.  At full depth
    two bf16 routes that round at different places can differ by most of
    the logits' scale (phase 6), so only float32 is gated.
    Returns the launch counts of all their served batches."""
    import gc
    from repro_torch.configs import get_config
    if runs is None:
        runs = [(step, get_config(arch), n_versions, prompts, src)
                for step, arch, n_versions, prompts, src in SSM_ENCDEC_RUNS]
    total = {}
    for step, mcfg, n_versions, prompts, src in runs:
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        shape = (f"{mcfg.n_layers} layers of d_model {mcfg.d_model}, "
                 f"{mcfg.ssm_heads} SSD heads of {mcfg.headdim}, N="
                 f"{mcfg.d_state}, chunk {mcfg.ssd_chunk}"
                 if mcfg.family == "ssm" else
                 f"{mcfg.n_enc_layers} encoder + {mcfg.n_layers} decoder "
                 f"layers of d_model {mcfg.d_model}, {mcfg.n_heads} heads of "
                 f"{mcfg.head_dim}, d_ff {mcfg.d_ff}, vocab "
                 f"{mcfg.vocab_size:,} (padded {mcfg.padded_vocab:,})")
        print(f"[ssm-encdec] {step} {mcfg.name}: {mcfg.family}, {shape}, "
              f"{n_versions} weight version(s) on {route} [{card}]",
              flush=True)
        counts = serve_phase(torch, dev, cfg, card, mcfg=mcfg, route=route,
                             n_versions=n_versions, prompts=prompts,
                             tag="ssm-encdec", src_lens=src,
                             gate_bf16=False)
        print(f"[ssm-encdec] {step} {mcfg.name}: "
              f"{time.perf_counter() - t0:.1f} s with its measurements",
              flush=True)
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ------------------------------------------------------------ phase 9
def train_launches(mcfg, seq=None):
    """Kernel launches of one loss and its gradient over ``seq`` positions
    (default TRAIN_SEQ) on the ``cuda`` route: every attention call runs
    the forward kernel twice (the forward, then its layer's recomputation
    under remat) and each backward kernel once, and so does every SSD scan
    (its states and scan as one launch where ``ssd_bwd_fused`` says so at
    the config's P, N, chunk and compute dtype: bf16 at the full configs'
    shapes, seq <= 1,024; else as two).  The decoder family attends once a
    layer, the encoder-decoder family once an encoder layer and twice a
    decoder layer; the SSM family scans once a layer, the hybrid family
    too, attending once a group of ``attn_every`` layers."""
    from repro_torch.kernels.ssd_scan import ssd_bwd_fused
    if mcfg.family == "encdec":
        calls = mcfg.n_enc_layers + 2 * mcfg.n_layers
    elif mcfg.family == "hybrid":
        calls = mcfg.n_layers // mcfg.attn_every
    else:
        calls = 0 if mcfg.family == "ssm" else mcfg.n_layers
    scans = mcfg.n_layers if mcfg.family in ("ssm", "hybrid") else 0
    seq = TRAIN_SEQ if seq is None else seq
    fused = scans and ssd_bwd_fused(mcfg.headdim, mcfg.d_state, max(1, min(
        mcfg.ssd_chunk, seq)), seq, mcfg.compute_dtype)
    pair = 0 if fused else scans
    return {"flash_attention": 2 * calls, "flash_attention_bwd_dq": calls,
            "flash_attention_bwd_dkdv": calls, "ssd_scan": 2 * scans,
            "ssd_scan_bwd_states": pair, "ssd_scan_bwd_scan": pair,
            SSD_BWD_FUSED: scans - pair, "ssd_scan_bwd_grads": scans}


def launch_delta(before, after, keys):
    return {k: after[k] - before[k] for k in keys}


def f32_gate(torch, mcfg, params, batch, route, tag, label, card,
             sync_warn=False):
    """One float32 loss and gradient of ``mcfg`` on ``route`` against the
    ``torch`` route on the same parameters and batch: the loss within
    1e-3 of its size and every gradient leaf within 1e-3 of that leaf's
    scale (max |torch route|).  ``sync_warn``: the ``route``'s call under
    sync debug mode "warn" (on the card), its host waits counted and
    printed.  Returns the launches of the ``route`` call."""
    import warnings
    from repro_torch.checkpoint.postsi_store import _leaf_paths
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.models.model import build
    from repro_torch.models.module import tree_leaves
    f32 = mcfg.replace(compute_dtype=torch.float32)
    ref_loss, _, ref = loss_and_grads(build(f32, "torch"), params, batch)
    model = build(f32, route)
    before = dict(LAUNCHES)
    waits = None
    if sync_warn and batch["tokens"].is_cuda:
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                loss, _, got = loss_and_grads(model, params, batch)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # the mode's own notice on being switched on is not a wait
        waits = [str(w.message).splitlines()[0][:80] for w in caught
                 if "synchronizing CUDA operation" in str(w.message)]
    else:
        loss, _, got = loss_and_grads(model, params, batch)
    torch.cuda.synchronize()
    counts = launch_delta(before, LAUNCHES, LAUNCHES)
    if not abs(float(loss) - float(ref_loss)) <= 1e-3 * abs(float(ref_loss)):
        raise AssertionError(f"[{tag}] {label}: float32 loss {float(loss)} "
                             f"on {route}, {float(ref_loss)} on torch")
    worst = (0.0, "")
    for path, a, b in zip(_leaf_paths(params), tree_leaves(got),
                          tree_leaves(ref)):
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max())
        if not bool(torch.isfinite(a).all()) or err > 1e-3 * scale:
            raise AssertionError(f"[{tag}] {label}: float32 gradient {path} "
                                 f"on {route} {err} from the torch route's, "
                                 f"scale {scale}")
        worst = max(worst, (err / max(scale, 1e-30), path))
    print(f"[{tag}] {label}: float32 {route} vs torch: loss {float(loss):.6f}"
          f" vs {float(ref_loss):.6f}, {len(tree_leaves(got))} gradient "
          f"leaves within 1e-3 of scale (largest {worst[0]:.3g} of scale at "
          f"{worst[1]}) [{card}]", flush=True)
    if waits is not None:
        print(f"[{tag}] {label}: host waits of the {route} loss and gradient "
              f"under sync debug mode 'warn' (moe_ffn's forward has none: "
              f"phase 7): {len(waits)}"
              + (f" ({'; '.join(sorted(set(waits))[:4])})" if waits else ""),
              flush=True)
    return counts


def bf16_step(torch, mcfg, params, batch, route, tag, label, card):
    """One loss and gradient of ``mcfg`` in its own compute dtype (bf16) on
    ``route``, beside the ``torch`` route's on the same parameters and
    batch: the loss within 2e-2 of the torch route's and every gradient
    leaf finite; the call timed twice.  Returns the launches of the first
    ``route`` call."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.train import loss_and_grads
    from repro_torch.models.model import build
    from repro_torch.models.module import tree_leaves
    ref_loss = float(loss_and_grads(build(mcfg, "torch"), params, batch)[0])
    model = build(mcfg, route)
    secs, counts = [], None
    for _ in range(2):
        torch.cuda.synchronize()
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        loss, _, got = loss_and_grads(model, params, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts = counts or launch_delta(before, LAUNCHES, LAUNCHES)
    bad = [n for n, g in enumerate(tree_leaves(got))
           if not bool(torch.isfinite(g).all())]
    del got
    if not (math.isfinite(float(loss)) and not bad
            and abs(float(loss) - ref_loss) <= 2e-2 * abs(ref_loss)):
        raise AssertionError(f"[{tag}] {label}: {mcfg.compute_dtype} loss "
                             f"{float(loss)} on {route}, {ref_loss} on "
                             f"torch; gradient leaves not finite: {bad}")
    print(f"[{tag}] {label}: {str(mcfg.compute_dtype).split('.')[-1]} "
          f"{route} vs torch: loss {float(loss):.6f} vs {ref_loss:.6f}, "
          f"every gradient leaf finite; {secs[1] * 1e3:.1f} ms a loss and "
          f"gradient (first call {secs[0] * 1e3:.1f} ms) [{card}]",
          flush=True)
    return counts


def runner_phase(torch, dev, cfg, card, mcfg, route, step, steps,
                 gate_step, dry=None):
    """``TrainRunner`` on ``route`` over ``TokenStream`` batches of
    TRAIN_BATCH x TRAIN_SEQ of ``mcfg`` (bf16 compute over float32
    parameters): ``steps`` steps, a checkpoint every ``steps // 2`` and a
    failure injected at step ``steps - 2`` (every 4 and at 6 of 8); one
    restart, finite losses, the last below the first, every step's
    launches ``train_launches``; ms a step, tokens/s, peak memory,
    checkpoint save and restore seconds, a profile of one more step; then
    one float32 step on ``route`` against the ``torch`` route
    (``f32_gate``, its lines labelled ``gate_step``).  ``step`` labels the
    lines ("9a").  With ``dry`` one more step runs under the counter for
    phase 9g (``dry_run_call``)."""
    import gc
    import tempfile
    from repro_torch.checkpoint import PostSICheckpointer
    from repro_torch.data import TokenStream
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.module import tree_leaves
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import FailureInjector, TrainRunner
    gc.collect()
    torch.cuda.empty_cache()
    B, S = TRAIN_BATCH, TRAIN_SEQ
    ckpt_every, fail_at = max(1, steps // 2), max(1, steps - 2)
    model, step_fn = make_train_step(mcfg, lr=TRAIN_LR, kernels=route)
    params = model.init(torch.Generator(device=dev).manual_seed(cfg.seed),
                        dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    opt = adamw_init(params)
    shape = (f"{mcfg.ssm_heads} SSD heads of {mcfg.headdim}, N="
             f"{mcfg.d_state}, chunk {mcfg.ssd_chunk}" if mcfg.ssm else
             f"{mcfg.n_heads} heads over {mcfg.n_kv_heads} kv heads of "
             f"{mcfg.head_dim}")
    print(f"[train] {step} {mcfg.name}: {mcfg.n_layers} layers, d_model "
          f"{mcfg.d_model}, {shape}, vocab {mcfg.vocab_size:,} (padded "
          f"{mcfg.padded_vocab:,}), {n_params:,} parameters in "
          f"{str(mcfg.param_dtype).split('.')[-1]}, compute "
          f"{str(mcfg.compute_dtype).split('.')[-1]}; batch {B} x {S}, "
          f"{steps} steps, a checkpoint every {ckpt_every}, a failure at "
          f"step {fail_at}, on {route} [{card}]", flush=True)
    want = train_launches(mcfg, S) if route == "cuda" else \
        dict.fromkeys(train_launches(mcfg, S), 0)
    step_s, step_counts = [], []

    def timed_step(p, o, batch):
        torch.cuda.synchronize()
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        out = step_fn(p, o, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        step_counts.append(launch_delta(before, LAUNCHES, want))
        return out

    def timed(fn, secs):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            secs.append(time.perf_counter() - t0)
            return out
        return call

    save_s, restore_s = [], []
    with tempfile.TemporaryDirectory(prefix="train_ckpt_") as ckdir:
        tree_ex = {"params": params, "opt": opt,
                   "data": {"step": torch.tensor(0, dtype=torch.int32)}}
        ck = PostSICheckpointer(ckdir, tree_ex)
        ck.save = timed(ck.save, save_s)
        ck.restore = timed(ck.restore, restore_s)
        runner = TrainRunner(timed_step, TokenStream(
            mcfg, B, S, seed=cfg.seed, device=dev), ck,
            ckpt_every=ckpt_every)
        torch.cuda.reset_peak_memory_stats()
        out = runner.run(params, opt, steps,
                         injector=FailureInjector(fail_at=(fail_at,)))
        peak = torch.cuda.max_memory_allocated()
    del params, opt, tree_ex
    losses = out["losses"]
    n_runs = steps + fail_at - (fail_at // ckpt_every * ckpt_every)
    if out["restarts"] != 1 or out["final_step"] != steps:
        raise AssertionError(f"[train] {step}: restarts {out['restarts']}, "
                             f"final step {out['final_step']}")
    if len(losses) != n_runs or not all(map(math.isfinite, losses)):
        raise AssertionError(f"[train] {step}: losses {losses}: expected "
                             f"{n_runs} finite ones")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"[train] {step}: the loss did not fall: "
                             f"{losses}")
    for i, got in enumerate(step_counts):
        if got != want:
            raise AssertionError(f"[train] {step}: step run {i} launched "
                                 f"{got}, expected {want}")
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    print(f"[train] {step} {mcfg.name}: restarts {out['restarts']}, final "
          f"step {out['final_step']}, {len(losses)} losses "
          f"[{', '.join(f'{x:.4f}' for x in losses)}]", flush=True)
    print(f"[train] {step} {mcfg.name}: {steady * 1e3:.1f} ms a step "
          f"(median of {len(step_s) - 1} after the first, "
          f"{step_s[0] * 1e3:.1f} ms), {B * S / steady:.0f} tokens/s, peak "
          f"memory {peak / 2**30:.2f} GiB, launches a step "
          f"{ {k: v for k, v in want.items() if v} }, checkpoint save "
          f"{', '.join(f'{s:.2f}' for s in save_s)} s, restore "
          f"{', '.join(f'{s:.2f}' for s in restore_s)} s [{card}]",
          flush=True)
    params, opt = out["state"]["params"], out["state"]["opt"]
    del out
    stream = TokenStream(mcfg, B, S, seed=cfg.seed + 1, device=dev)
    batch = stream.next()
    profile_call(torch, f"one {mcfg.name} train step",
                 lambda: step_fn(params, opt, batch), card, tag="train")
    if dry is not None:
        dry_run_call(torch, dry, f"{mcfg.name} train step {B} x {S}",
                     step_fn, (params, opt, batch), steady * 1e3)
    del opt
    gc.collect()
    torch.cuda.empty_cache()
    f32_gate(torch, mcfg, params, batch, route, "train",
             f"{gate_step} {mcfg.name}", card)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()


def train_phase(torch, dev, cfg, card, mcfg=None, family_runs=None,
                route="cuda", ssm_mcfg=None, hybrid_runs=None, dry=None):
    """Phase 9: training on ``route``.  9a: qwen2-0.5b (or ``mcfg``) at
    full width and depth through ``runner_phase`` (TRAIN_STEPS steps).
    9b, 9c: one float32 step of each of ``family_runs`` (default
    TRAIN_FAMILY_RUNS: tuples of step, config, full config, batch, seq)
    against the ``torch`` route, with its launches.  9d: mamba2-130m (or
    ``ssm_mcfg``) at full width and depth through ``runner_phase``
    (``cfg.ssm_train_steps`` steps), its float32 step labelled 9e; 9e:
    one float32 step of each of ``hybrid_runs`` (default
    HYBRID_TRAIN_RUNS, as ``family_runs``); 9f: one step of each in its
    bf16 compute dtype (``bf16_step``), with its launches.  ``dry``: the
    runners' counted steps for phase 9g.  Returns the launch counts of the
    phase."""
    import gc
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.models.model import build
    t_phase = time.perf_counter()
    reset_launch_counts()     # the phase's path starts here
    runner_phase(torch, dev, cfg, card, mcfg or get_config(TRAIN_ARCH),
                 route, "9a", TRAIN_STEPS, "9a", dry)

    def cut_runs(runs):
        out = []
        for step, arch, layers, enc_layers, b, s in runs:
            full = get_config(arch)
            out.append((step, full.replace(n_layers=layers, **(
                {"n_enc_layers": enc_layers} if enc_layers else {})),
                full, b, s))
        return out

    if family_runs is None:
        family_runs = cut_runs(TRAIN_FAMILY_RUNS)
    if hybrid_runs is None:
        hybrid_runs = cut_runs((step, arch, layers, None, b, s)
                               for step, arch, layers, b, s
                               in HYBRID_TRAIN_RUNS)

    def gate_runs(runs, bf16_label=None):
        for step, fcfg, full, b, s in runs:
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            depth = (f"{fcfg.n_enc_layers} + {fcfg.n_layers} of "
                     f"{full.n_enc_layers} + {full.n_layers} layers"
                     if fcfg.family == "encdec" else
                     f"{fcfg.n_layers} of {full.n_layers} layers")
            print(f"[train] {step} {fcfg.name}: {fcfg.family} at full width,"
                  f" depth cut to {depth}, {fcfg.param_count():,} "
                  f"parameters, batch {b} x {s}, one float32 step on "
                  f"{route} [{card}]", flush=True)
            fparams = build(fcfg).init(
                torch.Generator(device=dev).manual_seed(cfg.seed), dev)
            fbatch = TokenStream(fcfg, b, s, seed=cfg.seed, device=dev).next()
            if fcfg.family == "encdec":
                fbatch["enc_embeds"] = torch.randn(
                    (b, TRAIN_ENC_FRAMES, fcfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(
                        cfg.seed)) * ENC_SCALE
            counts = f32_gate(torch, fcfg, fparams, fbatch, route, "train",
                              f"{step} {fcfg.name}", card,
                              sync_warn=fcfg.moe)

            def wanted(mcfg):
                w = train_launches(mcfg, s)
                return w if route == "cuda" else dict.fromkeys(w, 0)
            fwant = wanted(fcfg.replace(compute_dtype=torch.float32))
            if {k: counts[k] for k in fwant} != fwant:
                raise AssertionError(f"[train] {step}: launches {counts}, "
                                     f"expected {fwant}")
            print(f"[train] {step} {fcfg.name}: launches "
                  f"{ {k: v for k, v in fwant.items() if v} }, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            if bf16_label:
                counts = bf16_step(torch, fcfg, fparams, fbatch, route,
                                   "train", f"{bf16_label} {fcfg.name}",
                                   card)
                fwant = wanted(fcfg)
                if {k: counts[k] for k in fwant} != fwant:
                    raise AssertionError(f"[train] {bf16_label}: launches "
                                         f"{counts}, expected {fwant}")
                print(f"[train] {bf16_label} {fcfg.name}: launches "
                      f"{ {k: v for k, v in fwant.items() if v} }",
                      flush=True)
            del fparams, fbatch

    gate_runs(family_runs)
    runner_phase(torch, dev, cfg, card, ssm_mcfg or get_config(
        SSM_TRAIN_ARCH), route, "9d", cfg.ssm_train_steps, "9e", dry)
    gate_runs(hybrid_runs, bf16_label="9f")
    total = dict(LAUNCHES)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[train] phase 9: {time.perf_counter() - t_phase:.1f} s, kernel "
          f"launches {total}", flush=True)
    return total


# ------------------------------------------------------------ phase 9g
def meta_like(torch, tree):
    """``tree`` with every tensor replaced by an empty one on ``meta`` of
    its shape, strides and dtype (the same tree structure)."""
    from torch.utils._pytree import tree_map
    return tree_map(lambda t: torch.empty_strided(
        t.shape, t.stride(), dtype=t.dtype, device="meta")
        if isinstance(t, torch.Tensor) else t, tree)


def traced_kernels(prof) -> dict:
    """{kernel of KERNELS: device launches} in a stopped profiler's trace
    (the profiler can drop an event: a count may fall short)."""
    out = {}
    for e in prof.events():
        if getattr(e, "device_type", None) is not None \
                and "CUDA" in str(e.device_type):
            k = kernel_of(e.name)
            if k:
                out[k] = out.get(k, 0) + 1
    return out


def dry_run_call(torch, dry, label, fn, args, ms, kwargs=None,
                 profile=True, meta_proc=None):
    """One untimed call of ``fn(*args, **kwargs)`` on the card under the
    counter (``launch.op_count.count_call``), kept in ``dry[label]`` for
    phase 9g with: the meta twin of its arguments (made before the call,
    which may update them in place), the wrappers' launches
    (``LAUNCHES``), the profiler's kernel counts where ``profile``, the
    card's peak memory over the call, and ``ms``, the call's time as its
    phase measured it.  ``meta_proc``: a child making the meta trace
    instead (``start_mesh_meta_trace``)."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch.op_count import count_call
    kwargs = kwargs or {}
    meta_args = None if meta_proc else meta_like(torch, (args, kwargs))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = dict(LAUNCHES)
    prof = start_profiler("dry") if profile else None
    out, count = count_call(fn, *args, **kwargs)
    torch.cuda.synchronize()
    traced = traced_kernels(prof) if stop_profiler(prof, "dry") else None
    del out
    dry[label] = {"fn": fn, "meta_args": meta_args, "meta_proc": meta_proc,
                  "count": count, "traced": traced, "ms": ms,
                  "launched": {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                               if LAUNCHES[k] != before[k]},
                  "peak": torch.cuda.max_memory_allocated(), "base": base}


def start_mesh_meta_trace():
    """A child process (``chip_smoke.py --mesh-meta-trace``) tracing
    ``mesh_wave_call`` on ``meta`` at the fixed sizes while the card runs
    the phases before 9g; it never touches the card (no CUDA device is
    visible to it) and prints the count as its last line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh-meta-trace"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT)


def mesh_meta_trace() -> int:
    """The child of ``start_mesh_meta_trace``."""
    import torch
    from repro_torch.launch.op_count import count_call
    torch.set_num_threads(1)
    fn, args, kwargs = mesh_wave_call(torch, torch.device("meta"), Config())
    print(json.dumps(count_call(fn, *args, **kwargs)[1]), flush=True)
    return 0


def dry_run_phase(torch, dry, card):
    """Phase 9g: each call of ``dry`` traced on ``meta`` (or its child's
    trace read) and held to its count on the card: FLOPs (by dtype) and
    bytes equal exactly; each hand-written kernel's launches in the trace
    equal to the card's counter's and to the wrappers' (``LAUNCHES``);
    where profiled, every kernel in the profiler's trace, at most as
    often.  Prints each call's roofline (``launch.dryrun.roofline``)
    beside its measured ms, the share of the roofline, and the peak-live
    estimate beside ``torch.cuda.max_memory_allocated``."""
    from repro_torch.launch.dryrun import roofline
    from repro_torch.launch.op_count import count_call
    for label, d in dry.items():
        t0 = time.perf_counter()
        if d["meta_proc"] is not None:
            out, err = d["meta_proc"].communicate(timeout=900)
            if d["meta_proc"].returncode != 0:
                raise AssertionError(f"[dry] {label}: the meta trace failed:"
                                     f" {err[-2000:]}")
            meta = json.loads(out.strip().splitlines()[-1])
        else:
            (args, kwargs) = d["meta_args"]
            meta = count_call(d["fn"], *args, **kwargs)[1]
        real = d["count"]
        for key in ("flops", "flops_by_dtype", "bytes"):
            if real[key] != meta[key]:
                raise AssertionError(f"[dry] {label}: {key} on the card "
                                     f"{real[key]}, on meta {meta[key]}")
        launches = {k: v["launches"] for k, v in real["kernels"].items()}
        meta_launches = {k: v["launches"] for k, v in meta["kernels"].items()}
        if launches != meta_launches or launches != d["launched"]:
            raise AssertionError(f"[dry] {label}: kernel launches counted "
                                 f"{launches}, on meta {meta_launches}, by "
                                 f"the wrappers {d['launched']}")
        traced = d["traced"]
        if traced is not None and any(
                not 0 < traced.get(k, 0) <= n for k, n in launches.items()):
            raise AssertionError(f"[dry] {label}: the profiler traced "
                                 f"{traced}, the counter {launches}")
        r = roofline(real)
        least_ms = max(r["compute_s"], r["memory_s"]) * 1e3
        share = ("not measured" if d["ms"] is None else
                 f"{d['ms']:.1f} ms measured, {100 * least_ms / d['ms']:.2f}%"
                 f" of the roofline")
        gib = lambda n: f"{n / 2 ** 30:.2f} GiB"
        print(f"[dry] {label}: {real['flops']:.4g} FLOPs "
              f"{ {k: f'{v:.4g}' for k, v in real['flops_by_dtype'].items()} }"
              f", {real['bytes']:.4g} bytes, {real['aten_ops']} aten ops, "
              f"equal on meta (traced in {time.perf_counter() - t0:.1f} s); "
              f"launches {launches} = the wrappers' = meta's"
              + ("" if traced is None else f", profiler {traced}")
              + f"; compute_s {r['compute_s']:.6g} memory_s "
              f"{r['memory_s']:.6g} ({r['dominant']}), least "
              f"{least_ms:.4f} ms, {share}; peak-live estimate "
              f"{gib(real['memory']['peak_live_bytes'])} beside "
              f"max_memory_allocated {gib(d['peak'])} "
              f"({gib(d['base'])} allocated before the call) [{card}]",
              flush=True)


def in_situ_check(torch, srv, params, batch, max_len, tag="serve"):
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
        srv.prefill(params, batch, max_len)
    finally:
        ops.flash_attention, ops.ssd = orig["flash_attention"], orig["ssd"]
    print(f"[{tag}] in situ: every flash_attention and ssd call of one "
          f"{srv.cfg.name} prefill within tolerance of its plain version on "
          f"the same activations (max abs err {worst})", flush=True)
    print(f"[{tag}] in situ, closest to the limit: {limit_use_line(use)}",
          flush=True)


def moe_sync_check(torch, srv, params, batch, max_len, tag):
    """One prefill with every ``moe_ffn`` call under
    ``torch.cuda.set_sync_debug_mode("error")``: the layer's routing, sort,
    capacity drops and combine must not wait on the card.  Needs the card;
    skipped elsewhere."""
    import repro_torch.models.model as model_module
    if not batch["tokens"].is_cuda:
        print(f"[{tag}] moe_ffn sync check skipped: it needs the card",
              flush=True)
        return
    orig = model_module.moe_ffn
    calls = [0]

    def checked(*args):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = orig(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        calls[0] += 1
        return out

    model_module.moe_ffn = checked
    try:
        srv.prefill(params, batch, max_len)
    finally:
        model_module.moe_ffn = orig
    if calls[0] != srv.cfg.n_layers:
        raise AssertionError(f"moe_ffn ran {calls[0]} times in a prefill of "
                             f"{srv.cfg.n_layers} layers")
    print(f"[{tag}] moe_ffn under sync debug mode 'error': {calls[0]} calls "
          f"of one prefill, 0 host waits", flush=True)


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


def mesh_wave_call(torch, dev, cfg, route="cuda"):
    """(fn, args, kwargs) of the mesh wave phase 9g counts: phase 4m's
    first wave, postsi, on a fresh store sharded over
    ``make_node_mesh(cfg.nodes)`` on ``dev`` (the card, or ``meta`` for its
    trace), through ``run_wave_dist`` on ``route``."""
    import numpy as np
    from repro_torch.core import make_node_mesh, make_store, shard_store
    from repro_torch.core.dist_engine import run_wave_dist
    from repro_torch.core.workloads import smallbank_waves
    mesh = make_node_mesh(cfg.nodes, dev)
    wave = smallbank_waves(np.random.RandomState(cfg.seed), 1, cfg.T,
                           cfg.nodes, cfg.kpn, dist_frac=0.2, device=dev)[0]
    store = shard_store(make_store(cfg.nodes * cfg.kpn, cfg.V, device=dev),
                        mesh)
    return run_wave_dist, (store, wave, 1, 1, mesh), dict(
        sched="postsi", gc_track=True, kernels=route)


def mesh_engine_phase(torch, dev, cfg, card, routes=("cuda", "cuda+fused"),
                      plain="torch", dry=None, meta_proc=None):
    """Phase 4m: phase 4's store sharded over ``make_node_mesh(nodes)``
    and ``--mesh-waves`` of its waves for every scheduler through
    one (route, driver) of ``routes`` x (``run_workload_fused_dist``,
    ``run_workload_dist``), the four taken in turn (scheduler i on the
    (i mod 4)-th: every pair for one scheduler or two), each equal to the
    single-device ``routes[0]`` run (WaveOut, stats, store) and launching
    what ``mesh_wave_launches`` says; one postsi wave on the
    mesh's ``plain`` route equal to it too.  With ``dry``, one more postsi
    wave (``mesh_wave_call``) under the counter for phase 9g, its meta
    trace the one ``meta_proc`` makes (``start_mesh_meta_trace``)."""
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
    combos = [(route, drv) for route in routes
              for drv in (run_workload_fused_dist, run_workload_dist)]
    wave_ms = None
    for i, sched in enumerate(scheds):
        sync()
        t0 = time.perf_counter()
        ref_store, ref_hist, stats = run_workload_fused(
            make_store(n_keys, cfg.V, device=dev), waves, sched=sched,
            n_nodes=cfg.nodes, gc_track=True, kernels=ref_route)
        sync()
        one_ms = (time.perf_counter() - t0) * 1e3 / W
        times = []
        for route, drv in combos[i % len(combos):][:1]:
            store = shard_store(make_store(n_keys, cfg.V, device=dev), mesh)
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
                raise AssertionError(f"{label}: stats {m_stats} vs {stats}")
            if on_card:
                got = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
                want = mesh_wave_launches(route, cfg.nodes, cfg.T, W)
                if any(got[k] != v for k, v in want.items()):
                    raise AssertionError(f"{label}: launches {got}, "
                                         f"expected {want}")
            times.append(f"{route} {drv.__name__} {ms:.1f}")
            if (sched, route, drv) == ("postsi", ref_route,
                                       run_workload_fused_dist):
                wave_ms = ms
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
    del store, ref_store
    if dry is not None:
        fn, args, kwargs = mesh_wave_call(torch, dev, cfg)
        dry_run_call(torch, dry, f"postsi mesh wave T={cfg.T} on "
                     f"{cfg.nodes} nodes", fn, args, wave_ms, kwargs,
                     profile=False, meta_proc=meta_proc)


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
    ap.add_argument("--ssm-train-steps", type=int,
                    default=full.ssm_train_steps,
                    help="steps of phase 9d's runner (mamba2-130m), at "
                         "least 3: a checkpoint every half, a failure two "
                         "before the end")
    args = ap.parse_args(argv)
    return full._replace(waves=args.waves, scheds=args.scheds,
                         ticks=args.ticks, serve_batches=args.serve_batches,
                         new_tokens=args.new_tokens,
                         planned_waves=args.planned_waves,
                         elastic_ticks=args.elastic_ticks,
                         mesh_waves=args.mesh_waves,
                         mesh_ticks=args.mesh_ticks,
                         ssm_train_steps=max(3, args.ssm_train_steps))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--mesh-meta-trace"]:
        return mesh_meta_trace()
    cfg = parse_config(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    mesh_proc = start_mesh_meta_trace()
    try:
        return run(torch, cfg, mesh_proc)
    finally:
        if mesh_proc.poll() is None:
            mesh_proc.kill()
            mesh_proc.communicate()


def run(torch, cfg, mesh_proc) -> int:
    """The phases, in order (the module's docstring), on the first CUDA
    device; ``mesh_proc`` traces phase 9g's mesh wave on meta meanwhile."""
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.kernels.build import build_info, library, nvcc_path

    dev = torch.device("cuda:0")
    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    seconds = {}              # each phase's wall seconds
    t_run = t0 = time.perf_counter()
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
    ssd_bwd_tensor_core_check(build_info["path"], nvcc_path())
    ssd_bwd_wgmma_check(build_info["path"], nvcc_path())

    seconds["1-2 build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    import numpy as np
    records, tables = kernel_phase(torch, dev, cfg.nodes * cfg.kpn, cfg.V,
                                   cfg.T, cfg.O)
    loop_record, loop_fn = commit_loop_phase(torch, np, dev, cfg)
    records.update(loop_record)
    engine_device_ms(torch, tables, records, loop_fn["commit_loop"], cfg.T,
                     cfg.O)
    del tables
    records.update(model_kernel_phase(torch, dev))
    records.update(attention_bwd_phase(torch, dev))
    records.update(ssd_bwd_phase(torch, dev))
    seconds["3 kernels"] = time.perf_counter() - t0
    dry = {}                  # the calls phase 9g holds to their counts

    profile_wave(torch, dev, cfg)
    # each path with the counts set to 0 just before it and read just after
    reset_launch_counts()
    t0 = time.perf_counter()
    engine_phase(torch, dev, cfg)
    step_runs = service_phase(torch, dev, cfg)
    seconds["4-5 engine, service"] = time.perf_counter() - t0
    print(f"[main path] engine + service: {time.perf_counter() - t0:.1f} s, "
          f"kernel launches {dict(LAUNCHES)}", flush=True)
    t1 = time.perf_counter()
    checked, streamed = streaming_phase(torch, dev, cfg, step_runs)
    del step_runs
    planner_phase(torch, dev, cfg, checked)
    seconds["5 streaming, planner"] = time.perf_counter() - t1
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
    seconds["5c durability"] = time.perf_counter() - t1
    if durable_counts["commit_loop"] <= 0:
        raise AssertionError("recovery replayed no wave through commit_loop")
    print(f"[main path] durability: {time.perf_counter() - t1:.1f} s, "
          f"{checked[0]} block dispatches checked in all; kernel launches "
          f"of durable serving, recovery and restart {durable_counts}",
          flush=True)
    engine_counts = {k: v + durable_counts[k]
                     for k, v in engine_counts.items()}
    t1 = time.perf_counter()
    placed_corner_check(torch, dev, cfg, card)
    reset_launch_counts()
    elastic_phase(torch, dev, cfg, card, checked)
    elastic_counts = dict(LAUNCHES)
    seconds["5d elastic"] = time.perf_counter() - t1
    print(f"[main path] elastic placement: {time.perf_counter() - t1:.1f} s,"
          f" {checked[0]} block dispatches checked in all; kernel launches "
          f"of the placed sessions and their recoveries {elastic_counts}",
          flush=True)
    engine_counts = {k: v + elastic_counts[k]
                     for k, v in engine_counts.items()}
    reset_launch_counts()
    t1 = time.perf_counter()
    mesh_engine_phase(torch, dev, cfg, card, dry=dry, meta_proc=mesh_proc)
    seconds["4m mesh engine"] = time.perf_counter() - t1
    mesh_service_phase(torch, dev, cfg, card, checked)
    seconds["5m mesh service"] = time.perf_counter() - t1 \
        - seconds["4m mesh engine"]
    mesh_counts = dict(LAUNCHES)
    for name in ("version_scan", "potential_matrix", "wave_commit"):
        if mesh_counts[name] <= 0:
            raise AssertionError(f"{name} never launched on the mesh path")
    print(f"[main path] node mesh: {time.perf_counter() - t1:.1f} s, "
          f"{checked[0]} block dispatches checked in all; kernel launches "
          f"of the mesh engine and service runs and their single-device "
          f"references (not in the kernels line) {mesh_counts}", flush=True)
    t0 = time.perf_counter()
    serve_counts = serve_phase(torch, dev, cfg, card, dry=dry)
    seconds["6 serve"] = time.perf_counter() - t0
    print(f"[main path] serve: {time.perf_counter() - t0:.1f} s with its "
          f"measurements, kernel launches {serve_counts}", flush=True)
    t0 = time.perf_counter()
    decoder_counts = decoder_phase(torch, dev, cfg, card, dry=dry)
    seconds["7 decoder"] = time.perf_counter() - t0
    print(f"[main path] decoder: {time.perf_counter() - t0:.1f} s with its "
          f"measurements, kernel launches {decoder_counts}", flush=True)
    t0 = time.perf_counter()
    family_counts = ssm_encdec_phase(torch, dev, cfg, card)
    seconds["8 ssm, encdec"] = time.perf_counter() - t0
    print(f"[main path] ssm and encdec: {time.perf_counter() - t0:.1f} s "
          f"with their measurements, kernel launches {family_counts}",
          flush=True)
    t0 = time.perf_counter()
    train_counts = train_phase(torch, dev, cfg, card, dry=dry)
    seconds["9 train"] = time.perf_counter() - t0
    print(f"[main path] train: {time.perf_counter() - t0:.1f} s with its "
          f"measurements, kernel launches {train_counts}", flush=True)
    t0 = time.perf_counter()
    dry_run_phase(torch, dry, card)
    seconds["9g dry run"] = time.perf_counter() - t0
    print(f"[phases] seconds: "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + f"; in all {time.perf_counter() - t_run:.1f}", flush=True)
    model_counts = {k: v + decoder_counts[k] + family_counts[k]
                    + train_counts[k] for k, v in serve_counts.items()}
    paths = {"version_scan": engine_counts, "potential_matrix": engine_counts,
             "wave_commit": engine_counts, "commit_loop": engine_counts,
             "flash_attention": model_counts, "ssd_scan": model_counts,
             "flash_attention_bwd_dq": train_counts,
             "flash_attention_bwd_dkdv": train_counts,
             **dict.fromkeys(SSD_BWD_KERNELS, train_counts)}
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
