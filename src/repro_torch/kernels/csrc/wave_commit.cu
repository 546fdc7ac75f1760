// wave_commit: the whole wave read phase in one launch.
//
// Replaces the TPU kernel src/repro/kernels/wave_commit.py:
// wave_commit_pallas (body _kernel), reached through ops.wave_commit on the
// "+fused" route of LocalSubstrate.read_phase.
//
// One launch computes, for a wave of T txns with O ops each:
//   * the version scan of every op's ring (newest visible slot),
//   * r_val / r_tid / r_cid / r_sid: the ring fields at the chosen slot,
//   * the PostSI rule-3 seed s_lo0[t] = max over ops of
//     (rvalid ? r_cid : 0), as [T],
//   * the potential matrix (potential_part, shared with
//     interval_negotiate.cu).
//
// What bounds it on the H100: the chain of dependent device-memory round
// trips, not bytes.  At T = 256, O = 4, V = 8 it reads 1024 ring rows of
// four fields (128 KB) plus 20 KB of per-op inputs and writes 86 KB: under
// a tenth of a microsecond at 3.35 TB/s.  But an op's ring row is known
// only once its key has arrived, so an op needs at least two dependent
// round trips (key, then ring): about 0.6 us on an H100 where the rows are
// not in L2, as an engine wave's over 1,000,000 accounts are not
// (PERF.md); an empty launch alone takes about 0.9 us.
//
// What the design does about it:
//   * The grid is 1-D and split by role.  Its first read_blocks blocks run
//     the read phase and nothing else, so it never waits behind a
//     potential tile or its barrier; the others compute the potential
//     matrix, 16 flat bytes a thread.
//   * Read phase: each op takes a group of Vg lanes (V rounded up to a power
//     of two, at most 32).  Lane v loads cid, tid, sid and val of slot v
//     (and v + Vg, ...) of the op's clipped row in one round: four
//     independent loads, each field's row one 32-byte sector at V = 8.  The
//     key, the ceiling and rvalid are loaded together before that.  So the
//     chain is two round trips, key then ring.  xor shuffles over the
//     group pick the newest visible slot (the larger ok ? cid : -1, a tie
//     the lower slot; ring_pick in common.cuh, shared with
//     version_scan.cu), and the winning lane writes the five [T, O]
//     outputs from its registers.
//   * A txn's O groups are adjacent lanes.  Where O * Vg <= 32 (SmallBank:
//     4 x 8) a txn lies in one warp and s_lo0 is one redux.sync over its
//     lanes; otherwise (TPC-C's O = 12 at V = 8 is 96 lanes) the seeds go
//     through shared memory and one __syncthreads of a block that holds
//     whole txns only.
//   * SmallBank's O = 4 has its own instantiation (loops unrolled,
//     divisions by O folded); every other O runs the run-time one.
//   * No TMA, cp.async or wgmma: there is no product, the ring reads are
//     gathers of one 32-byte row picked by data, and the whole call moves
//     about 150 KB.  What the kernel uses instead is many SMs in flight on
//     the gathers (96 blocks at the path's shape), full 32-byte sectors,
//     16-byte stores, warp shuffles and reductions.
// The host computes the launch geometry (wave_commit.py: geometry) and
// passes it in.
#include <climits>

#include "common.cuh"

template <int kO>
__global__ void wave_commit_kernel(
    const int* __restrict__ cid, const int* __restrict__ tid,
    const int* __restrict__ sid, const int* __restrict__ val,
    const int* __restrict__ keys, const int* __restrict__ max_cid,
    const int* __restrict__ rk, const int* __restrict__ wk,
    const uint8_t* __restrict__ rvalid, int* __restrict__ slot_out,
    int* __restrict__ rval_out, int* __restrict__ rtid_out,
    int* __restrict__ rcid_out, int* __restrict__ rsid_out,
    int* __restrict__ slo_out, int8_t* __restrict__ pot, int T, int O_rt,
    int V, int n_rows, int vg_log, int txns, int read_blocks) {
  extern __shared__ __align__(16) int smem[];
  if ((int)blockIdx.x >= read_blocks) {  // uniform per block
    potential_part<kO>(rk, wk, pot, T, O_rt, blockIdx.x - read_blocks, smem);
    return;
  }
  const int O = kO > 0 ? kO : O_rt;
  // which txn, op and slot lane this thread is: txns of L = O * Vg adjacent
  // lanes, packed 32 / L to a warp where L <= 32, else txns to a block
  const int Vg = 1 << vg_log, L = O << vg_log;
  const int lane = threadIdx.x & 31;
  int local, r;
  bool idle;
  if (L <= 32) {
    // L is a power of two where O = 4: shifts in place of divisions
    const int k = kO == 4 ? lane >> (2 + vg_log) : lane / L;
    const int per_warp = kO == 4 ? 32 >> (2 + vg_log) : 32 / L;
    local = (threadIdx.x >> 5) * per_warp + k;
    r = lane - k * L;
    idle = k >= per_warp;
  } else {
    local = threadIdx.x / L;
    r = threadIdx.x - local * L;
    idle = local >= txns;
  }
  const int t = blockIdx.x * txns + local;
  const bool live = !idle && t < T;
  const int o = r >> vg_log;
  const long long m = (long long)t * O + o;

  // one round: key, ceiling, rvalid; then one round: the ring row's slots
  int key = 0, ceil = 0, valid = 0;
  if (live) {
    key = keys[m];
    ceil = max_cid[m];
    valid = rvalid[m];
  }
  const int* const more[2] = {sid, val};
  const RingPick<2> p = ring_pick<2>(cid, tid, more,
                                     clip_row(key, n_rows) * V, V, Vg, ceil,
                                     live);
  if (p.mine) {
    slot_out[m] = p.slot;
    rval_out[m] = p.more[1];
    rtid_out[m] = p.tid;
    rcid_out[m] = p.cid;  // RAW cid at the slot, even if -1
    rsid_out[m] = p.more[0];
  }
  const int seed = p.mine ? (valid ? p.cid : 0) : INT_MIN;
  if (L <= 32) {
    if (!idle) {
      const unsigned tmask =
          L == 32 ? 0xffffffffu : ((1u << L) - 1u) << (lane - r);
      const int s_lo = __reduce_max_sync(tmask, seed);
      if (live && r == 0) slo_out[t] = s_lo;
    }
  } else {  // uniform per launch
    if (p.mine) smem[local * O + o] = seed;
    __syncthreads();
    const int tt = blockIdx.x * txns + threadIdx.x;
    if ((int)threadIdx.x < txns && tt < T) {
      const int* s = smem + threadIdx.x * O;
      int s_lo = s[0];
      for (int q = 1; q < O; ++q) s_lo = max(s_lo, s[q]);
      slo_out[tt] = s_lo;
    }
  }
}

template <int kO>
int launch(const void* cid, const void* tid, const void* sid, const void* val,
           const void* keys, const void* max_cid, const void* rk,
           const void* wk, const void* rvalid, void* slot, void* r_val,
           void* r_tid, void* r_cid, void* r_sid, void* s_lo0, void* pot,
           int T, int O, int V, int n_rows, int vg_log, int txns,
           int threads, int read_blocks, int pot_blocks, int smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        wave_commit_kernel<kO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  wave_commit_kernel<kO><<<read_blocks + pot_blocks, threads, smem, stream>>>(
      (const int*)cid, (const int*)tid, (const int*)sid, (const int*)val,
      (const int*)keys, (const int*)max_cid, (const int*)rk, (const int*)wk,
      (const uint8_t*)rvalid, (int*)slot, (int*)r_val, (int*)r_tid,
      (int*)r_cid, (int*)r_sid, (int*)s_lo0, (int8_t*)pot, T, O, V, n_rows,
      vg_log, txns, read_blocks);
  return (int)cudaGetLastError();
}

// cid/tid/sid/val: [n_rows, V] int32 tables; keys: [T, O] int32 rows;
// max_cid/rk/wk: [T, O] int32; rvalid: [T, O] bool.  Writes
// slot/r_val/r_tid/r_cid/r_sid [T, O] int32, s_lo0 [T] int32 and pot [T, T]
// int8.  The geometry (lanes an op as log2, txns a read block, threads a
// block, read and potential blocks, dynamic shared memory bytes) comes from
// wave_commit.py: geometry.  SmallBank's O = 4 runs its own instantiation,
// every other O the run-time one.
extern "C" int wave_commit_launch(
    const void* cid, const void* tid, const void* sid, const void* val,
    const void* keys, const void* max_cid, const void* rk, const void* wk,
    const void* rvalid, void* slot, void* r_val, void* r_tid, void* r_cid,
    void* r_sid, void* s_lo0, void* pot, int T, int O, int V, int n_rows,
    int vg_log, int txns, int threads, int read_blocks, int pot_blocks,
    int smem, void* stream) {
  return (O == 4 ? launch<4> : launch<0>)(
      cid, tid, sid, val, keys, max_cid, rk, wk, rvalid, slot, r_val, r_tid,
      r_cid, r_sid, s_lo0, pot, T, O, V, n_rows, vg_log, txns, threads,
      read_blocks, pot_blocks, smem, (cudaStream_t)stream);
}
