// flash_attention: causal or full attention with an online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_pallas (body _kernel), reached through
// ops.flash_attention; in the port it is the prefill attention of the
// hybrid model (models/layers.py attention, once per shared-block
// application).
//
// What bounds it on the H100: bytes, barely.  At the zamba2-2.7b prefill
// (B=4, S=1024, H=KH=32, D=80, bf16) the call must read q, k, v and write o,
// 84 MB, 25 us at 3.35 TB/s; its causal products are 21.5 GFLOP, 22 us at
// the 989 TFLOP/s bf16 tensor rate.  This first kernel multiplies in fp32
// on the FMA units (67 TFLOP/s), so operations, not bytes, set its pace.
//
// What the design does about it: one block per (q tile of 64 rows,
// batch*head).  q, k and v tiles are converted to fp32 in dynamic shared
// memory (rows padded to D+1 floats, so the column walks are free of bank
// conflicts); each of the 256 threads owns a 4 x 4 block of the 64 x 64
// score tile and a 4 x D/16 block of the output, in registers, so every
// shared-memory load feeds two or more FMAs.  The running max and sum (m, l)
// of each row are reduced across the 16 threads that share it with warp
// shuffles.  Kv tiles above the diagonal are skipped (the causal skip of the
// Pallas kernel), and q tiles run heaviest first.  GQA is read by index
// (kv head h / (H / KH)) from the [B, S, KH, D] layout: no repeat, no D
// padding.  Ragged S is masked in-kernel: out-of-range keys score -1e30 (not
// -inf) and l is clamped at 1e-37, as in the Pallas kernel, so no row is
// NaN.  Tensor-core products (mma / wgmma) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define FA_BQ 64
#define FA_BK 64
#define FA_THREADS 256
#define FA_NEG_INF (-1.0e30f)

__device__ __forceinline__ float fa_load(const float* p) { return *p; }
__device__ __forceinline__ float fa_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void fa_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void fa_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// q: [B, Sq, H, D]; k, v: [B, Sk, KH, D]; o: [B, Sq, H, D]; D = 16 * DC.
// grid (ceil(Sq / FA_BQ), B * H), FA_THREADS threads.
template <typename T, int DC>
__global__ void __launch_bounds__(FA_THREADS)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int Sq, int Sk, int H, int KH, float scale,
                           int causal) {
  constexpr int D = 16 * DC;
  constexpr int LDQ = D + 1;      // padded rows: conflict-free walks over d
  constexpr int LDS = FA_BK + 1;
  extern __shared__ float smem[];
  float* qs = smem;               // [BQ][LDQ]
  float* ks = qs + FA_BQ * LDQ;   // [BK][LDQ]
  float* vs = ks + FA_BK * LDQ;   // [BK][D]
  float* ps = vs + FA_BK * D;     // [BQ][LDS] probabilities of one kv tile

  const int nq = gridDim.x;
  const int q0 = (nq - 1 - blockIdx.x) * FA_BQ;   // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;        // rows ty*4+i, cols tx+16j

  const long long q_stride = (long long)H * D;   // between sequence rows
  const long long kv_stride = (long long)KH * D;
  const T* qb = q + ((long long)b * Sq * H + h) * D;
  const T* kb = k + ((long long)b * Sk * KH + kh) * D;
  const T* vb = v + ((long long)b * Sk * KH + kh) * D;
  T* ob = o + ((long long)b * Sq * H + h) * D;

  for (int i = tid; i < FA_BQ * D; i += FA_THREADS) {
    const int r = i / D, c = i - (i / D) * D;
    const int s = q0 + r;
    qs[r * LDQ + c] = s < Sq ? fa_load(qb + s * q_stride + c) : 0.f;
  }

  float acc[4][DC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = FA_NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  int n_kv = (Sk + FA_BK - 1) / FA_BK;
  if (causal) {
    const int last = (q0 + FA_BQ - 1) / FA_BK;   // the causal skip
    n_kv = last + 1 < n_kv ? last + 1 : n_kv;
  }
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * FA_BK;
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < FA_BK * D; i += FA_THREADS) {
      const int r = i / D, c = i - (i / D) * D;
      const int s = k0 + r;
      const bool in = s < Sk;
      ks[r * LDQ + c] = in ? fa_load(kb + s * kv_stride + c) : 0.f;
      vs[r * D + c] = in ? fa_load(vb + s * kv_stride + c) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = ks[(tx + 16 * j) * LDQ + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bb[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = FA_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float s = sc[i][j] * scale;
        if (kpos >= Sk || (causal && kpos > qpos)) s = FA_NEG_INF;
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
      // the 16 threads of a row are lanes of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        ps[(ty * 4 + i) * LDS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < FA_BK; ++kk) {
      float p[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * LDS + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-37f);
#pragma unroll
    for (int j = 0; j < DC; ++j)
      fa_store(ob + qpos * q_stride + tx + 16 * j, acc[i][j] * inv);
  }
}

template <typename T, int DC>
static int fa_launch(const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Sk, int H, int KH, float scale,
                     int causal, cudaStream_t stream) {
  constexpr int D = 16 * DC;
  const int smem = (int)sizeof(float) *
                   (2 * FA_BQ * (D + 1) + FA_BK * D + FA_BQ * (FA_BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + FA_BQ - 1) / FA_BQ, B * H);
  flash_attention_kernel<T, DC><<<grid, FA_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Sq, Sk, H, KH, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
static int fa_dispatch(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Sk, int H, int KH, int D,
                       float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 16: return fa_launch<T, 1>(q, k, v, o, B, Sq, Sk, H, KH, scale, causal, s);
    case 32: return fa_launch<T, 2>(q, k, v, o, B, Sq, Sk, H, KH, scale, causal, s);
    case 48: return fa_launch<T, 3>(q, k, v, o, B, Sq, Sk, H, KH, scale, causal, s);
    case 64: return fa_launch<T, 4>(q, k, v, o, B, Sq, Sk, H, KH, scale, causal, s);
    case 80: return fa_launch<T, 5>(q, k, v, o, B, Sq, Sk, H, KH, scale, causal, s);
    case 96: return fa_launch<T, 6>(q, k, v, o, B, Sq, Sk, H, KH, scale, causal, s);
    case 112: return fa_launch<T, 7>(q, k, v, o, B, Sq, Sk, H, KH, scale, causal, s);
    case 128: return fa_launch<T, 8>(q, k, v, o, B, Sq, Sk, H, KH, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// q: [B, Sq, H, D], k/v: [B, Sk, KH, D], o: [B, Sq, H, D], all contiguous,
// one dtype (bf16 != 0: bfloat16, else float32).  D in {16, 32, ..., 128},
// H a multiple of KH.  Writes o.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int H, int KH, int D, int causal,
                                      int bf16, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return fa_dispatch<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KH, D, scale,
                                      causal, s);
  return fa_dispatch<float>(q, k, v, o, B, Sq, Sk, H, KH, D, scale, causal,
                            s);
}
