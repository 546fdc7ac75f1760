// wave_commit: the whole wave read phase in one launch.
//
// Replaces the TPU kernel src/repro/kernels/wave_commit.py:
// wave_commit_pallas (body _kernel), reached through ops.wave_commit on the
// "+fused" route of LocalSubstrate.read_phase.
//
// One launch computes, for a wave of T txns with O ops each:
//   * the version_scan of every op's ring (newest visible slot),
//   * r_val / r_tid / r_cid / r_sid: the ring fields at the chosen slot,
//   * the PostSI rule-3 seed s_lo0[t] = max over ops of
//     (rvalid ? r_cid : 0), as [T],
//   * the potential matrix tile (shared with interval_negotiate.cu).
//
// What bounds it on the H100: bytes.  At T = 256, O = 4, V = 8 it reads 1024
// rings of four fields (128 KB) plus 20 KB of per-op inputs and writes 86 KB:
// under a tenth of a microsecond at 3.35 TB/s.  The launch, a few
// microseconds, is what the caller waits for; fusing three dispatches (and
// the four ring gathers before them) into one launch is the point.
//
// What the design does about it: the grid is the potential matrix's 2-D grid
// of 32 x 32 tiles.  The blocks of tile column 0 also run the read phase for
// their 32 reader rows, so it runs once per reader row (the TPU grid
// recomputed it for every column tile, as revisited blocks).  Rings are
// gathered from the store tables in-kernel by clipped key, and s_lo0 is
// reduced over O in shared memory.  rvalid stays an input so a sharded caller can pass
// is_read & mine.
#include "common.cuh"

__global__ void wave_commit_kernel(
    const int* __restrict__ cid, const int* __restrict__ tid,
    const int* __restrict__ sid, const int* __restrict__ val,
    const int* __restrict__ keys, const int* __restrict__ max_cid,
    const int* __restrict__ rk, const int* __restrict__ wk,
    const uint8_t* __restrict__ rvalid, int* __restrict__ slot_out,
    int* __restrict__ rval_out, int* __restrict__ rtid_out,
    int* __restrict__ rcid_out, int* __restrict__ rsid_out,
    int* __restrict__ slo_out, int8_t* __restrict__ pot, int T, int O, int V,
    int n_rows) {
  extern __shared__ int smem[];
  int* rk_s = smem;
  int* wk_s = smem + REPRO_TILE * O;
  int* seed_s = smem + 2 * REPRO_TILE * O;
  const int i0 = blockIdx.y * REPRO_TILE;
  potential_tile(rk, wk, pot, T, O, i0, blockIdx.x * REPRO_TILE, rk_s, wk_s);
  if (blockIdx.x != 0) return;  // uniform per block

  // read phase of reader rows [i0, i0 + TILE): one thread per (row, op)
  const int lin = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  for (int idx = lin; idx < REPRO_TILE * O; idx += nthr) {
    const int t = i0 + idx / O;
    int seed = 0;
    if (t < T) {
      const long long m = (long long)t * O + (idx - (idx / O) * O);
      const long long row = clip_row(keys[m], n_rows);
      const long long base = row * V;
      int slot, best;
      scan_ring(cid + base, tid + base, V, max_cid[m], slot, best);
      const int r_cid = cid[base + slot];  // RAW cid at the slot, even if -1
      slot_out[m] = slot;
      rval_out[m] = val[base + slot];
      rtid_out[m] = tid[base + slot];
      rcid_out[m] = r_cid;
      rsid_out[m] = sid[base + slot];
      seed = rvalid[m] ? r_cid : 0;
    }
    seed_s[idx] = seed;
  }
  __syncthreads();
  if (lin < REPRO_TILE && i0 + lin < T) {
    const int* s = seed_s + lin * O;
    int m = s[0];
    for (int o = 1; o < O; ++o) m = max(m, s[o]);
    slo_out[i0 + lin] = m;
  }
}

// cid/tid/sid/val: [n_rows, V] int32 tables; keys: [T, O] int32 rows;
// max_cid/rk/wk: [T, O] int32; rvalid: [T, O] bool.  Writes slot/r_val/r_tid/r_cid/r_sid [T, O]
// int32, s_lo0 [T] int32 and pot [T, T] int8.
extern "C" int wave_commit_launch(
    const void* cid, const void* tid, const void* sid, const void* val,
    const void* keys, const void* max_cid, const void* rk, const void* wk,
    const void* rvalid, void* slot, void* r_val, void* r_tid, void* r_cid,
    void* r_sid, void* s_lo0, void* pot, int T, int O, int V, int n_rows,
    void* stream) {
  const int tiles = (T + REPRO_TILE - 1) / REPRO_TILE;
  const dim3 grid(tiles, tiles);
  const dim3 block(REPRO_TILE, REPRO_TILE);
  const size_t smem = 3 * REPRO_TILE * O * sizeof(int);
  wave_commit_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const int*)cid, (const int*)tid, (const int*)sid, (const int*)val,
      (const int*)keys, (const int*)max_cid, (const int*)rk, (const int*)wk,
      (const uint8_t*)rvalid, (int*)slot, (int*)r_val, (int*)r_tid,
      (int*)r_cid, (int*)r_sid, (int*)s_lo0, (int8_t*)pot, T, O, V, n_rows);
  return (int)cudaGetLastError();
}
