// ssd_scan: the Mamba2 SSD chunked scan, state carried across chunks on
// chip.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py: ssd_scan_pallas
// (body _kernel), reached through ops.ssd; in the port it is the scan of
// every Mamba2 mixer's prefill (models/ssm.py mamba2_forward).
//
// Per chunk of Q rows (cs = cumsum(dA) within the chunk):
//   y  = (C B^T .* L) x + exp(cs) .* (C h),     L = tril(exp(cs_i - cs_j))
//   h' = exp(cs_Q) h + B^T (exp(cs_Q - cs) .* x)
//
// What bounds it on the H100: bytes.  At the zamba2-2.7b prefill (BH = 320,
// S = 1024, P = N = 64, Q = 128, x/B/C bf16) the call reads x, dA, B, C and
// writes y and h, 91 MB, 27 us at 3.35 TB/s; its products are about 11
// GFLOP, 11 us at the 989 TFLOP/s bf16 tensor rate.  This first kernel
// multiplies in fp32 on the FMA units (67 TFLOP/s), so operations set its
// pace.
//
// What the design does about it: one block per batch*head, looping over the
// chunks in order (the Pallas grid's sequential chunk axis); h [N, P] stays
// in fp32 shared memory for the whole sequence, so x, B and C are read once
// and y written once.  The chunk's four products run as shared-memory tile
// products in which each of 256 threads owns a 4 x 4 block in registers;
// the [Q, Q] decay-weighted scores sit beside C (scaled by exp(cs)) in one
// row so that y = [M | C'] [x ; h] is a single product over Q + N, whose
// causal half above the diagonal is skipped.  All arithmetic is fp32; y is
// written in x's type, h in fp32.  B and C are shared by the H heads of a
// group (row bh / H).  Ragged S is masked in-kernel (x = dA = B = C = 0
// past the end, which leaves the state as it is, as the reference's zero
// padding does).  h0 may be NULL (zero initial state).  Shared memory is
// 4 * (Q (Q + N + 1) + Q (N + 1) + (Q + N) P + Q) bytes, 181,760 at the
// path's sizes: dynamic, within the 227 KB limit that the wrapper checks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define SSD_THREADS 256

__device__ __forceinline__ float ssd_load(const float* p) { return *p; }
__device__ __forceinline__ float ssd_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void ssd_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void ssd_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// acc += A[m0:m0+64, k0:k1] * B[k0:k1, n0:n0+64] on this thread's 4 x 4
// block (rows m0 + ty*4 + i, cols n0 + tx + 16 j).  A(r, k) = A[r*ars +
// k*aks], B(k, c) = B[k*bks + c*bjs]; rows/cols past M/NC are clamped (the
// caller discards them).
__device__ __forceinline__ void tile_mma(float (&acc)[4][4], const float* A,
                                         int ars, int aks, int M,
                                         const float* Bm, int bks, int bjs,
                                         int NC, int m0, int n0, int k0,
                                         int k1) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* ap[4];
  const float* bp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = min(m0 + ty * 4 + i, M - 1);
    ap[i] = A + r * ars;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = min(n0 + tx + 16 * j, NC - 1);
    bp[j] = Bm + c * bjs;
  }
#pragma unroll 4
  for (int kk = k0; kk < k1; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ap[i][kk * aks];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = bp[j][kk * bks];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void zero_tile(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// x: [BH, S, P]; dA: [BH, S] fp32; Bm, Cm: [BH / H, S, N]; h0: [BH, N, P]
// fp32 or NULL.  Writes y: [BH, S, P] (x's type) and h: [BH, N, P] fp32.
// grid BH, SSD_THREADS threads; Q rows per chunk.
template <typename T>
__global__ void __launch_bounds__(SSD_THREADS)
    ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dA,
                    const T* __restrict__ Bm, const T* __restrict__ Cm,
                    const float* __restrict__ h0, T* __restrict__ y,
                    float* __restrict__ h_out, int S, int P, int N, int H,
                    int Q) {
  const int LDA = Q + N + 1;   // row of [M | C]: Q scores, then N of C
  const int LDB = N + 1;
  extern __shared__ float smem[];
  float* As = smem;             // [Q][LDA]
  float* Bs = As + Q * LDA;     // [Q][LDB]
  float* Xs = Bs + Q * LDB;     // [Q + N][P]: x rows, then h rows
  float* Hs = Xs + Q * P;       // h [N][P]
  float* cs = Xs + (Q + N) * P; // [Q]

  const int bh = blockIdx.x;
  const int bg = bh / H;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const T* xb = x + (long long)bh * S * P;
  T* yb = y + (long long)bh * S * P;
  const float* ab = dA + (long long)bh * S;
  const T* bb = Bm + (long long)bg * S * N;
  const T* cb = Cm + (long long)bg * S * N;

  for (int i = tid; i < N * P; i += SSD_THREADS)
    Hs[i] = h0 ? h0[(long long)bh * N * P + i] : 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    // ---- load the chunk (rows past S: zero) ----
    for (int i = tid; i < Q * P; i += SSD_THREADS) {
      const int s = c0 + i / P;
      Xs[i] = s < S ? ssd_load(xb + (long long)c0 * P + i) : 0.f;
    }
    for (int i = tid; i < Q * N; i += SSD_THREADS) {
      const int r = i / N, n = i - (i / N) * N;
      const bool in = c0 + r < S;
      Bs[r * LDB + n] = in ? ssd_load(bb + (long long)(c0 + r) * N + n) : 0.f;
      As[r * LDA + Q + n] =
          in ? ssd_load(cb + (long long)(c0 + r) * N + n) : 0.f;
    }
    for (int r = tid; r < Q; r += SSD_THREADS)
      cs[r] = c0 + r < S ? ab[c0 + r] : 0.f;
    __syncthreads();

    // ---- cs = cumsum(dA) over the chunk, by warp 0 ----
    if (tid < 32) {
      const int per = (Q + 31) / 32, beg = tid * per;
      float run = 0.f;
      for (int t = 0; t < per; ++t)
        if (beg + t < Q) {
          run += cs[beg + t];
          cs[beg + t] = run;
        }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      for (int t = 0; t < per; ++t)
        if (beg + t < Q) cs[beg + t] += excl;
    }
    __syncthreads();

    // ---- M = (C B^T) .* L into As[:, :Q]; tiles above the diagonal: 0 ----
    for (int m0 = 0; m0 < Q; m0 += 64)
      for (int n0 = 0; n0 < Q; n0 += 64) {
        float acc[4][4];
        zero_tile(acc);
        if (n0 <= m0 + 63)
          tile_mma(acc, As + Q, LDA, 1, Q, Bs, 1, LDB, Q, m0, n0, 0, N);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = m0 + ty * 4 + i, c = n0 + tx + 16 * j;
            if (r < Q && c < Q)
              As[r * LDA + c] = c <= r ? acc[i][j] * expf(cs[r] - cs[c]) : 0.f;
          }
      }
    __syncthreads();
    // C' = exp(cs) .* C, in place
    for (int i = tid; i < Q * N; i += SSD_THREADS) {
      const int r = i / N, n = i - (i / N) * N;
      As[r * LDA + Q + n] *= expf(cs[r]);
    }
    __syncthreads();

    // ---- y = M x + C' h = [M | C'] [x ; h] ----
    for (int m0 = 0; m0 < Q; m0 += 64)
      for (int n0 = 0; n0 < P; n0 += 64) {
        float acc[4][4];
        zero_tile(acc);
        const int kd = m0 + 64 < Q ? m0 + 64 : Q;   // M is lower triangular
        tile_mma(acc, As, LDA, 1, Q, Xs, P, 1, P, m0, n0, 0, kd);
        tile_mma(acc, As, LDA, 1, Q, Xs, P, 1, P, m0, n0, Q, Q + N);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = m0 + ty * 4 + i, c = n0 + tx + 16 * j;
            if (r < Q && c < P && c0 + r < S)
              ssd_store(yb + (long long)(c0 + r) * P + c, acc[i][j]);
          }
      }
    __syncthreads();
    // x~ = exp(cs_Q - cs) .* x, in place
    const float cq = cs[Q - 1];
    for (int i = tid; i < Q * P; i += SSD_THREADS)
      Xs[i] *= expf(cq - cs[i / P]);
    __syncthreads();

    // ---- h' = exp(cs_Q) h + B^T x~ (each thread updates its own cells) ----
    const float dq = expf(cq);
    for (int m0 = 0; m0 < N; m0 += 64)
      for (int n0 = 0; n0 < P; n0 += 64) {
        float acc[4][4];
        zero_tile(acc);
        tile_mma(acc, Bs, 1, LDB, N, Xs, P, 1, P, m0, n0, 0, Q);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = m0 + ty * 4 + i, c = n0 + tx + 16 * j;
            if (r < N && c < P) Hs[r * P + c] = dq * Hs[r * P + c] + acc[i][j];
          }
      }
    __syncthreads();
  }

  for (int i = tid; i < N * P; i += SSD_THREADS)
    h_out[(long long)bh * N * P + i] = Hs[i];
}

// Shared memory of one block, in bytes (the wrapper checks the same sum).
static int ssd_smem_bytes(int P, int N, int Q) {
  return (int)sizeof(float) *
         (Q * (Q + N + 1) + Q * (N + 1) + (Q + N) * P + Q);
}

template <typename T>
static int ssd_launch_t(const void* x, const void* dA, const void* Bm,
                        const void* Cm, const void* h0, void* y, void* h,
                        int BH, int S, int P, int N, int H, int Q,
                        cudaStream_t stream) {
  const int smem = ssd_smem_bytes(P, N, Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T><<<BH, SSD_THREADS, smem, stream>>>(
      (const T*)x, (const float*)dA, (const T*)Bm, (const T*)Cm,
      (const float*)h0, (T*)y, (float*)h, S, P, N, H, Q);
  return (int)cudaGetLastError();
}

// x: [BH, S, P], Bm/Cm: [BH / H, S, N] (bf16 != 0: bfloat16, else float32);
// dA: [BH, S] fp32; h0: [BH, N, P] fp32 or NULL.  Writes y [BH, S, P] (x's
// type) and h [BH, N, P] fp32.  Q rows per chunk (1 <= Q <= S).
extern "C" int ssd_scan_launch(const void* x, const void* dA, const void* Bm,
                               const void* Cm, const void* h0, void* y,
                               void* h, int BH, int S, int P, int N, int H,
                               int Q, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return ssd_launch_t<__nv_bfloat16>(x, dA, Bm, Cm, h0, y, h, BH, S, P, N,
                                       H, Q, s);
  return ssd_launch_t<float>(x, dA, Bm, Cm, h0, y, h, BH, S, P, N, H, Q, s);
}
