// Device helpers shared by the wave engine's CUDA kernels.
//
// All data is int32 (keys, CIDs, TIDs, SIDs, payloads); results are exact and
// must match the plain PyTorch versions in kernels/ref.py bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Output tile edge of the potential-matrix kernels: a block of
// TILE x TILE threads writes one [TILE, TILE] tile of the [T, T] matrix.
#define REPRO_TILE 32

// Store row of a request key: negative NOP padding and out-of-range keys are
// clipped into [0, n_rows) so they can never wrap to the last row.
__device__ __forceinline__ long long clip_row(int key, int n_rows) {
  return key < 0 ? 0 : (key >= n_rows ? n_rows - 1 : key);
}

// Newest visible version in one ring of V slots (paper §IV-B read rule):
// ok = tid != -1 && cid <= ceil; best = max(ok ? cid : -1); slot = the FIRST
// slot attaining best (so an all-invisible ring gives slot 0, best -1).
__device__ __forceinline__ void scan_ring(const int* __restrict__ cid,
                                          const int* __restrict__ tid, int V,
                                          int ceil, int& slot, int& best) {
  int b = (tid[0] != -1 && cid[0] <= ceil) ? cid[0] : -1;
  int s = 0;
  for (int v = 1; v < V; ++v) {
    const int c = cid[v];
    const int m = (tid[v] != -1 && c <= ceil) ? c : -1;
    if (m > b) {  // strict: ties keep the first slot
      b = m;
      s = v;
    }
  }
  slot = s;
  best = b;
}

// One [TILE, TILE] tile of potential[i, j] = "some read key of txn i equals
// some write key of txn j", key >= 0, i != j.  Called by every thread of a
// (TILE, TILE) block; rk_s / wk_s are TILE * O ints of shared memory each.
// Reader keys < 0 (inactive or NOP ops) never match, whatever the writer key.
__device__ __forceinline__ void potential_tile(
    const int* __restrict__ rk, const int* __restrict__ wk,
    int8_t* __restrict__ pot, int T, int O, int i0, int j0, int* rk_s,
    int* wk_s) {
  const int lin = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  for (int idx = lin; idx < REPRO_TILE * O; idx += nthr) {
    const int r = idx / O, o = idx - (idx / O) * O;
    rk_s[idx] = (i0 + r < T) ? rk[(long long)(i0 + r) * O + o] : -1;
    wk_s[idx] = (j0 + r < T) ? wk[(long long)(j0 + r) * O + o] : -1;
  }
  __syncthreads();
  const int i = i0 + threadIdx.y, j = j0 + threadIdx.x;
  if (i < T && j < T) {
    bool hit = false;
    const int* rrow = rk_s + threadIdx.y * O;
    const int* wrow = wk_s + threadIdx.x * O;
    for (int o1 = 0; o1 < O; ++o1) {
      const int r = rrow[o1];
      if (r < 0) continue;
      for (int o2 = 0; o2 < O; ++o2) hit |= (r == wrow[o2]);
    }
    pot[(long long)i * T + j] = (hit && i != j) ? 1 : 0;
  }
}
