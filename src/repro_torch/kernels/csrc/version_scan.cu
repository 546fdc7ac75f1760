// version_scan: newest visible version per read request.
//
// Replaces the TPU kernel src/repro/kernels/version_scan.py:
// version_scan_pallas (body _kernel), reached through ops.version_scan.
//
// What bounds it on the H100: bytes.  Each request reads its key, its
// ceiling and one ring row of V cids and V tids (8 + 8V bytes) and writes two
// ints, so M = 1024 requests at V = 8 move about 82 KB, a few hundredths of a
// microsecond at 3.35 TB/s.  At the engine's sizes (M = T*O on the read
// phase, M = O on every commit step) the launch itself, a few microseconds,
// is what the caller waits for.
//
// What the design does about it: one thread per request and one launch per
// call.  The ring rows are gathered in-kernel from the store tables by the
// clipped key, which removes the separate store.cid[k] / store.tid[k] gathers
// (two launches and a [M, V] round trip each) that the TPU route pays before
// its kernel.  V is a runtime argument (2..8 in practice), with no padding of
// V to 128 lanes and no lane-broadcast outputs.
#include "common.cuh"

__global__ void version_scan_kernel(const int* __restrict__ cid,
                                    const int* __restrict__ tid,
                                    const int* __restrict__ keys,
                                    const int* __restrict__ max_cid,
                                    int* __restrict__ slot_out,
                                    int* __restrict__ best_out, int M, int V,
                                    int n_rows) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const long long row = clip_row(keys[m], n_rows);
  int slot, best;
  scan_ring(cid + row * V, tid + row * V, V, max_cid[m], slot, best);
  slot_out[m] = slot;
  best_out[m] = best;
}

// cid/tid: [n_rows, V] int32 tables; keys: [M] int32 rows; max_cid: [M]
// int32.  Writes slot/best [M] int32.
extern "C" int version_scan_launch(const void* cid, const void* tid,
                                   const void* keys, const void* max_cid,
                                   void* slot, void* best, int M, int V,
                                   int n_rows, void* stream) {
  const int threads = 128;
  const int blocks = (M + threads - 1) / threads;
  version_scan_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)cid, (const int*)tid, (const int*)keys,
      (const int*)max_cid, (int*)slot, (int*)best, M, V, n_rows);
  return (int)cudaGetLastError();
}
