// Hopper-only helpers (sm_90a) for the kernels that feed the tensor cores
// by TMA and wgmma: mbarriers, clusters, TMA tile loads and stores, bulk
// copies, the host's tensor-map encoder and its rank-4 maps over strided
// (inner, head, position, group) views, wgmma descriptors and products,
// register reallocation between warp groups, named barriers.
//
// Shared-memory tiles are 64-column boxes of bf16 (128-byte rows) laid out
// by TMA with the 128-byte swizzle, each box 1024-byte aligned; wgmma reads
// them through descriptors of the same swizzle:
//   K-major (the contraction dimension along a row): SBO = 1024 bytes
//     between groups of 8 rows, LBO unused; k-step kk of 16 columns starts
//     kk * 32 bytes into the box.
//   MN-major (the contraction dimension down the rows): SBO = 1024 bytes
//     between groups of 8 rows along the contraction, LBO = the bytes
//     between two 64-column boxes along N; k-step kk of 16 rows starts
//     kk * 2048 bytes into the box.
// wgmma m64nNk16 fragments (warp w of the warp group, lane = 4 g + t):
//   accumulator d[4 j + e] at row 16 w + g + 8 (e >> 1), column
//     8 j + 2 t + (e & 1), j < N / 8;
//   A from registers, k-step of 16: a[0] (row g, cols 2t, 2t+1), a[1]
//     (row g+8), a[2] (row g, cols 2t+8, 2t+9), a[3] (row g+8), two bf16 a
//     register, the lower column in the low half: the accumulator's n-tiles
//     2 kk and 2 kk + 1, packed as pairs, are the A operand of k-step kk.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>

__device__ __forceinline__ uint32_t sm90_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   sm90_addr(bar)),
               "r"(count)
               : "memory");
}

// After every mbar_init of the block, before any use by another thread.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` more of asynchronous copies this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          sm90_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   sm90_addr(bar))
               : "memory");
}

// One arrival once every cp.async this thread issued before has landed
// (counted in the barrier's expected arrivals: .noinc).
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   sm90_addr(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed; kCluster: with
// acquire at cluster scope, for a barrier that another block of the
// cluster arrives on.  A wait of more than 2^34 clocks (seconds: a barrier
// that can never complete) traps, so the launch fails instead of holding
// the card.
template <bool kCluster = false>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = sm90_addr(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    if (clock64() - t0 > (1ll << 34)) __trap();
    if constexpr (kCluster)
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
          "%2;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}\n"
          : "=r"(done)
          : "r"(a), "r"(parity)
          : "memory");
    else
      asm volatile(
          "{\n"
          ".reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n"
          "}\n"
          : "=r"(done)
          : "r"(a), "r"(parity)
          : "memory");
  } while (!done);
}

// --------------------------------------------------------------- clusters
// Every thread of both (all) blocks of the cluster, released and acquired.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of `p` (this block's shared memory) in block
// `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_map(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(sm90_addr(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster_v4(uint32_t addr, float a,
                                              float b, float c, float d) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// An asynchronous store of 16 bytes into another block of the cluster (its
// shared::cluster address), its bytes counted on that block's mbarrier at
// `bar` (complete_tx) once they land: the storing thread does not wait.
__device__ __forceinline__ void st_async_v4(uint32_t addr, float a, float b,
                                            float c, float d, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
      : "memory");
}

// An asynchronous store of a float into another block of the cluster, as
// st_async_v4.
__device__ __forceinline__ void st_async_f32(uint32_t addr, float a,
                                             uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "f"(a), "r"(bar)
      : "memory");
}

// One arrival on a barrier of another block of the cluster (its
// shared::cluster address), releasing this thread's stores before it.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t addr) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          addr)
      : "memory");
}

// A float of another block's shared memory (its shared::cluster address).
__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(addr)
               : "memory");
  return v;
}

// 8 bytes of another block's shared memory (its shared::cluster address).
__device__ __forceinline__ float2 ld_cluster_v2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

// 16 bytes of another block's shared memory (its shared::cluster
// address).
__device__ __forceinline__ float4 ld_cluster_v4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// ------------------------------------------------------------------ TMA
// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) from device to shared memory; they complete on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(sm90_addr(dst)),
      "l"(src), "r"(bytes), "r"(sm90_addr(bar))
      : "memory");
}

// One box of a rank-4 tensor map at (c0, c1, c2, c3), innermost first,
// into shared memory; its bytes complete on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(sm90_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(sm90_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box from shared memory to a rank-4 tensor map at (c0, c1, c2, c3);
// the parts past the tensor's extent are not written.  Committed and
// waited on per thread (tma_store_commit, tma_store_wait_read).
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(sm90_addr(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until this thread's committed stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// This thread's writes to shared memory, made visible to TMA (the async
// proxy) before a store reads them.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Slot k of a tensor map made by sw_map holds semantic dimension
// (order >> 2 k) & 3 of (inner, head, position, group).
__device__ __forceinline__ int sw_coord(int order, int k, int c0, int c1,
                                        int c2, int c3) {
  const int d = (order >> (2 * k)) & 3;
  return d == 0 ? c0 : d == 1 ? c1 : d == 2 ? c2 : c3;
}

// A box at semantic coordinates (inner, head, position, group).
__device__ __forceinline__ void sw_load(void* dst, const CUtensorMap* m,
                                        uint64_t* bar, int order, int c0,
                                        int c1, int c2, int c3) {
  tma_load_4d(dst, m, bar, sw_coord(order, 0, c0, c1, c2, c3),
              sw_coord(order, 1, c0, c1, c2, c3),
              sw_coord(order, 2, c0, c1, c2, c3),
              sw_coord(order, 3, c0, c1, c2, c3));
}
__device__ __forceinline__ void sw_store(const CUtensorMap* m,
                                         const void* src, int order, int c0,
                                         int c1, int c2, int c3) {
  tma_store_4d(m, src, sw_coord(order, 0, c0, c1, c2, c3),
               sw_coord(order, 1, c0, c1, c2, c3),
               sw_coord(order, 2, c0, c1, c2, c3),
               sw_coord(order, 3, c0, c1, c2, c3));
}

// ---------------------------------------------------------------- wgmma
// Descriptor of a 128-byte-swizzled operand at shared address p.
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((sm90_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products (after wg_wait, before the next issue).
template <int N>
__device__ __forceinline__ void wg_hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for A fragments: their registers stay live (and unwritten)
// until the products reading them are known complete.
template <int N>
__device__ __forceinline__ void wg_hold(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

#define WG_D8(b)                                                         \
  "+f"(d[(b) + 0]), "+f"(d[(b) + 1]), "+f"(d[(b) + 2]), "+f"(d[(b) + 3]), \
      "+f"(d[(b) + 4]), "+f"(d[(b) + 5]), "+f"(d[(b) + 6]), "+f"(d[(b) + 7])

// d[64 x 32] (= or +=) A B^T over 16 columns: A and B both K-major from
// shared memory; accumulate unless `zero`.
__device__ __forceinline__ void wgmma_ss_64x32(float (&d)[16], uint64_t da,
                                               uint64_t db, int zero) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_D8(0), WG_D8(8)
      : "l"(da), "l"(db), "r"(zero));
}

// d[64 x 64] (= or +=) A B^T over 16 columns: A and B both K-major from
// shared memory; accumulate unless `zero`.
__device__ __forceinline__ void wgmma_ss_64x64(float (&d)[32], uint64_t da,
                                               uint64_t db, int zero) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "l"(da), "l"(db), "r"(zero));
}

// d[64 x 128] (= or +=) A B^T over 16 columns, as above.
__device__ __forceinline__ void wgmma_ss_64x128(float (&d)[64], uint64_t da,
                                                uint64_t db, int zero) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56)
      : "l"(da), "l"(db), "r"(zero));
}

// d[64 x N] (= or +=) A B^T, N = 32, 64 or 128.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int zero) {
  if constexpr (N == 32)
    wgmma_ss_64x32(d, da, db, zero);
  else if constexpr (N == 64)
    wgmma_ss_64x64(d, da, db, zero);
  else
    wgmma_ss_64x128(d, da, db, zero);
}

// d[64 x 64] (= or +=) A B over 16 rows: A K-major, B MN-major (the
// contraction dimension down its rows), both from shared memory;
// accumulate unless `zero`.
__device__ __forceinline__ void wgmma_ss_mn_64x64(float (&d)[32], uint64_t da,
                                                  uint64_t db, int zero) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "l"(da), "l"(db), "r"(zero));
}

// d[64 x 64] += A B over 16 rows: A from registers, B MN-major from
// shared memory.
__device__ __forceinline__ void wgmma_rs_64x64(float (&d)[32],
                                               const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A B over 16 rows, as above.
__device__ __forceinline__ void wgmma_rs_64x128(float (&d)[64],
                                                const uint32_t* a,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1, 1;\n"
      "}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
        WG_D8(48), WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef WG_D8

// d[64 x N] += A B, N = 64 or 128.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t* a, uint64_t db) {
  if constexpr (N == 64)
    wgmma_rs_64x64(d, a, db);
  else
    wgmma_rs_64x128(d, a, db);
}

// ------------------------------------------------- warp groups, barriers
// A warp group's register budget, given up (release) or taken (claim); all
// four warps of the group execute it.
template <int R>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_claim() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Barrier `id` (1..15; 0 is __syncthreads) over `n` threads, whole warps.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// Arrive at barrier `id` without waiting (the threads that bar.sync on it
// wait for these arrivals; this thread's earlier writes are ordered before
// their later reads).
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ------------------------------------------------------------ launch (host)
// Kernel's dynamic shared-memory size, set once a device (at its first
// launch there), not by a cudaFuncSetAttribute call at every launch.
template <auto Kernel>
static cudaError_t smem_attribute_once(int bytes) {
  static std::atomic<unsigned long long> set{0};   // a bit a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (bit && (set.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) set.fetch_or(bit, std::memory_order_relaxed);
  return e;
}

// ------------------------------------------------------ tensor maps (host)
// cuTensorMapEncodeTiled, looked up through the CUDA runtime
// (cudaGetDriverEntryPointByVersion): the library links no libcuda.
typedef CUresult (*tma_encode_fn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static tma_encode_fn tma_encoder() {
  static const tma_encode_fn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? (tma_encode_fn)p
               : (tma_encode_fn)nullptr;
  }();
  return fn;
}

// ------------------------------------- tensors as rank-4 maps (host)
// A bf16 tensor of semantic dimensions (inner, head, position, group),
// the inner one dense, as a rank-4 TMA map: its dimensions ordered by
// stride (those of size 1 last, at a stride past the tensor), boxes of 64
// inner x `rows` positions, 128-byte swizzle, zeros past the extents.
// *order gets the slots' semantic dimensions (slot k holds dimension
// (order >> 2 k) & 3, as sw_coord reads it).  Returns 0 or a cudaError.
static int sw_map(CUtensorMap* m, const void* p, const long long (&dim)[4],
                  const long long (&stride)[4], int rows, int* order) {
  const tma_encode_fn enc = tma_encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  auto key = [&](int d) { return dim[d] == 1 ? LLONG_MAX : stride[d]; };
  int slot[4] = {0, 1, 2, 3};
  for (int a = 2; a < 4; ++a)   // insertion sort of slots 1..3 by key
    for (int b = a; b > 1 && key(slot[b]) < key(slot[b - 1]); --b) {
      const int tmp = slot[b];
      slot[b] = slot[b - 1];
      slot[b - 1] = tmp;
    }
  long long top = dim[0];
  for (int d = 1; d < 4; ++d)
    if (dim[d] > 1 && stride[d] * dim[d] > top) top = stride[d] * dim[d];
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4];
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  *order = 0;
  for (int k = 0; k < 4; ++k) {
    const int d = slot[k];
    dims[k] = (cuuint64_t)dim[d];
    box[k] = d == 0 ? 64 : d == 2 ? (cuuint32_t)rows : 1;
    *order |= d << (2 * k);
    if (k > 0) strides[k - 1] = (cuuint64_t)(dim[d] == 1 ? top : stride[d]) * 2;
  }
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(p), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}
