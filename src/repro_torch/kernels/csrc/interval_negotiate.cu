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
// What bounds it on the H100: one dependent device-memory round trip (the
// keys, then the stores), not bytes or operations.  At T = 256, O = 4 it
// reads 8 KB of keys, writes 64 KB and does about 1M integer compares: a few
// hundredths of a microsecond against either roof, against about 0.3 us
// for one round trip on an H100 (PERF.md); an empty launch alone takes
// about 0.9 us.
//
// What the design does about it: one launch of a 1-D grid over the FLAT
// [T, T] output, 16 bytes a thread, written with one 16-byte store
// (potential_part in common.cuh): 4,096 threads at T = 256 in 32 blocks.
// Each block stages the writer keys of the columns its bytes touch, and
// the reader keys of its rows, in shared memory in one round of loads; a
// thread keeps its row's reader keys in registers, skips a row whose reader
// keys are all negative and reads a column's four writer keys with one
// 16-byte load.  Index arithmetic is 32-bit, and SmallBank's O = 4 has its
// own instantiation (loops unrolled, divisions by O folded).  No TMA,
// cp.async or wgmma: there is no product, and the 8 KB of keys are one
// round of loads.
// The host computes the launch geometry (interval_negotiate.py: geometry).
#include "common.cuh"

template <int kO>
__global__ void potential_matrix_kernel(const int* __restrict__ rk,
                                        const int* __restrict__ wk,
                                        int8_t* __restrict__ pot, int T,
                                        int O) {
  extern __shared__ __align__(16) int smem[];
  potential_part<kO>(rk, wk, pot, T, O, blockIdx.x, smem);
}

template <int kO>
int launch(const void* rk, const void* wk, void* pot, int T, int O,
           int threads, int blocks, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        potential_matrix_kernel<kO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  potential_matrix_kernel<kO><<<blocks, threads, smem, stream>>>(
      (const int*)rk, (const int*)wk, (int8_t*)pot, T, O);
  return (int)cudaGetLastError();
}

// rk/wk: [T, O] int32 (-1 = inactive op); pot: [T, T] int8.  threads,
// blocks and smem (dynamic shared memory bytes) from
// interval_negotiate.py: geometry.  SmallBank's O = 4 runs its own
// instantiation, every other O the run-time one.
extern "C" int potential_matrix_launch(const void* rk, const void* wk,
                                       void* pot, int T, int O, int threads,
                                       int blocks, int smem, void* stream) {
  return O == 4 ? launch<4>(rk, wk, pot, T, O, threads, blocks, smem,
                            (cudaStream_t)stream)
                : launch<0>(rk, wk, pot, T, O, threads, blocks, smem,
                            (cudaStream_t)stream);
}
