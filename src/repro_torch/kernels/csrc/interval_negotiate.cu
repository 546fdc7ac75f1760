// potential_matrix: the wave's anti-dependency candidate matrix.
//
// Replaces the TPU kernel src/repro/kernels/interval_negotiate.py:
// potential_matrix_pallas (body _kernel), reached through
// ops.potential_matrix from commit_phase.build_potential.
//
// potential[i, j] = 1 iff some read key of txn i equals some write key of
// txn j, the key is >= 0 and i != j.  int8 [T, T] out of two [T, O] int32 key
// sets: T^2 * O^2 compares.
//
// What bounds it on the H100: bytes, and barely.  At T = 256, O = 4 it reads
// 8 KB of keys, writes 64 KB and does about 1M integer compares: a few
// hundredths of a microsecond against either roof.  The launch itself, a few
// microseconds, is what the caller waits for.
//
// What the design does about it: one launch over a 2-D grid of 32 x 32
// output tiles, one thread per output byte, consecutive threads on
// consecutive columns so each warp writes 32 contiguous bytes.  Each block
// stages its 32 reader rows' and 32 writer rows' O keys in shared memory
// once; the O^2 compares then run out of shared memory.
#include "common.cuh"

__global__ void potential_matrix_kernel(const int* __restrict__ rk,
                                        const int* __restrict__ wk,
                                        int8_t* __restrict__ pot, int T,
                                        int O) {
  extern __shared__ int smem[];
  potential_tile(rk, wk, pot, T, O, blockIdx.y * REPRO_TILE,
                 blockIdx.x * REPRO_TILE, smem, smem + REPRO_TILE * O);
}

// rk/wk: [T, O] int32 (-1 = inactive op); pot: [T, T] int8.
extern "C" int potential_matrix_launch(const void* rk, const void* wk,
                                       void* pot, int T, int O,
                                       void* stream) {
  const int tiles = (T + REPRO_TILE - 1) / REPRO_TILE;
  const dim3 grid(tiles, tiles);
  const dim3 block(REPRO_TILE, REPRO_TILE);
  const size_t smem = 2 * REPRO_TILE * O * sizeof(int);
  potential_matrix_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const int*)rk, (const int*)wk, (int8_t*)pot, T, O);
  return (int)cudaGetLastError();
}
