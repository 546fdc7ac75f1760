// version_scan: newest visible version per read request.
//
// Replaces the TPU kernel src/repro/kernels/version_scan.py:
// version_scan_pallas (body _kernel), reached through ops.version_scan on
// the unfused "cuda" route of LocalSubstrate.read_visible (the read phase,
// M = T * O requests, once a wave).
//
// What bounds it on the H100: the chain of dependent device-memory round
// trips, not bytes.  Each request reads its key, its ceiling and one ring
// row of V cids and V tids (8 + 8V bytes) and writes two ints, so M = 1024
// requests at V = 8 move about 82 KB, a few hundredths of a microsecond at
// 3.35 TB/s.  But a ring row is known only once its key has arrived: two
// dependent round trips (key, then ring), about 0.6 us where the rows are
// not in L2, as an engine wave's over 1,000,000 accounts are not; an empty
// launch alone takes about 0.9 us.
//
// What the design does about it (after wave_commit's read blocks):
//   * Each request takes a group of Vg lanes, V rounded up to a power of
//     two and at most 32, packed 32 / Vg groups to a warp: at the path's
//     M = 1024, V = 8 that is 8,192 threads in 64 blocks of 128, so 64 SMs
//     issue the gathers.  Lane v loads slots v, v + Vg, ... (one each where
//     V <= Vg).
//   * Two rounds of loads: every lane of a group loads the key and the
//     ceiling, then cid and tid of its slot; at V = 8 a field's row is one
//     32-byte sector, read by 8 adjacent lanes.
//   * log2(Vg) steps of xor shuffles merge the group's lanes (ring_pick,
//     shared with wave_commit.cu): the larger ok ? cid : -1 wins, a tie the
//     lower slot; the lane holding the slot writes slot and best.  Lanes
//     past M stay in the kernel as idle lanes, since every lane of the warp
//     must reach the shuffles.  Two redux.sync (a max, then a min over the
//     group's lanes) took more device time on the H100 (PERF.md).
//   * Vg is fixed at compile time, one instance per power of two from 1 to
//     32, so a lane's request and slot are shifts.  The C entry computes
//     Vg and the grid from M and V and picks the instance.
//   * No TMA, cp.async or wgmma: there is no product, each ring read is a
//     gather of one 32-byte row picked by data, and the call moves about
//     82 KB.  What helps is many SMs in flight on the gathers, full sectors
//     and warp shuffles.
// The rows are gathered in-kernel from the store tables by the clipped key,
// so the TPU route's store.cid[k] / store.tid[k] pre-gathers and its
// 128-lane padding of V do not exist.
#include "common.cuh"

template <int kVgLog>
__global__ void __launch_bounds__(128) version_scan_kernel(
    const int* __restrict__ cid, const int* __restrict__ tid,
    const int* __restrict__ keys, const int* __restrict__ max_cid,
    int* __restrict__ slot_out, int* __restrict__ best_out, int M, int V,
    int n_rows) {
  const int m = (blockIdx.x * blockDim.x + threadIdx.x) >> kVgLog;
  const bool live = m < M;  // uniform per group
  int key = 0, ceil = 0;
  if (live) {
    key = keys[m];
    ceil = max_cid[m];
  }
  const RingPick<0> p = ring_pick<0>(cid, tid, nullptr,
                                     clip_row(key, n_rows) * V, V,
                                     1 << kVgLog, ceil, live);
  if (p.mine) {
    slot_out[m] = p.slot;
    best_out[m] = p.best;
  }
}

template <int kVgLog>
static int launch(const int* cid, const int* tid, const int* keys,
                  const int* max_cid, int* slot, int* best, int M, int V,
                  int n_rows, int blocks, cudaStream_t stream) {
  version_scan_kernel<kVgLog><<<blocks, 128, 0, stream>>>(
      cid, tid, keys, max_cid, slot, best, M, V, n_rows);
  return (int)cudaGetLastError();
}

// cid/tid: [n_rows, V] int32 tables; keys: [M] int32 rows; max_cid: [M]
// int32.  Writes slot/best [M] int32.  Vg = V to a power of two (at most
// 32) lanes a request, blocks of 128 threads; a grid of more than
// 2^31 - 128 lanes is refused.
extern "C" int version_scan_launch(const void* cid, const void* tid,
                                   const void* keys, const void* max_cid,
                                   void* slot, void* best, int M, int V,
                                   int n_rows, void* stream) {
  int vg_log = 0;
  while (vg_log < 5 && (1 << vg_log) < V) ++vg_log;
  const long long lanes = (long long)M << vg_log;
  if (lanes > INT_MAX - 127) return (int)cudaErrorInvalidValue;
  static decltype(&launch<0>) const runs[] = {
      launch<0>, launch<1>, launch<2>, launch<3>, launch<4>, launch<5>};
  return runs[vg_log]((const int*)cid, (const int*)tid, (const int*)keys,
                      (const int*)max_cid, (int*)slot, (int*)best, M, V,
                      n_rows, (int)((lanes + 127) / 128),
                      (cudaStream_t)stream);
}
