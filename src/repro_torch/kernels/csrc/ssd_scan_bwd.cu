// ssd_scan_bwd: the gradient of the Mamba2 SSD chunked scan of ssd_scan.cu,
// in three kernels.
//
// Replaces the TPU kernel: none.  The reference has no Pallas backward for
// its scan: it trains the SSM and hybrid families through XLA's autodiff of
// src/repro/models/ssm.py:70 ssd_chunked.  In the port these kernels are
// the backward of kernels/ssd_scan.py SsdScanFn, which ops.ssd runs under a
// gradient on the cuda route: the training step of every Mamba2 mixer
// (models/ssm.py mamba2_forward, under its layer's remat).
//
// Notation, for one batch*head (of a group of H heads that share B and C)
// and one chunk c of Q rows: a_i = cumsum(dA) within the chunk, a_L its
// last value (on a ragged tail the last real row's: padded rows add
// dA = 0); L_ij = exp(a_i - a_j) for j <= i, else 0; w_j = exp(a_L - a_j);
// h_{c-1} the state entering the chunk, G_c = dloss/dh_c (dh_final for the
// last chunk, zeros where the final state has no gradient).
//
// * ssd_scan_bwd_states, a block per (batch*head, chunk): st_c = sum_j
//   w_j B_j^T x_j (the chunk's end state from a zero start, recomputed, so
//   the forward saves only its inputs) and U_c = sum_i exp(a_i) C_i^T dy_i,
//   float32 [BH, nc, N, P], and a_L [BH, nc].
// * ssd_scan_bwd_scan, a block per batch*head: h_c = exp(a_L) h_{c-1} +
//   st_c from h0, h_{c-1} written over st_c; G_{c-1} = U_c + exp(a_L) G_c
//   from dh_final, G_c written over U_c; dh0 = G_{-1}; and s_c =
//   exp(a_L) <h_{c-1}, G_c> [BH, nc], dA's share of the chunk decay.
// * ssd_scan_bwd_grads, a block per (batch*head, chunk), with S_ij =
//   C_i . B_j, W_ij = (dy_i . x_j) L_ij and R_ij = W_ij S_ij:
//     dx_j = sum_{i>=j} S_ij L_ij dy_i + w_j B_j G_c
//     dC_i = sum_{j<=i} W_ij B_j + exp(a_i) dy_i h_{c-1}^T
//     dB_j = sum_{i>=j} W_ij C_i + w_j x_j G_c^T
//     da_i = sum_j R_ij - sum_k R_ki + C_i . (exp(a_i) dy_i h_{c-1}^T)
//            - B_i . (w_i x_i G_c^T), and at i = L also
//            + sum_j B_j . (w_j x_j G_c^T) + s_c
//     dA_k = sum_{i>=k} da_i within the chunk (a reverse cumsum).
//   dB and dC are sums over the H heads of a group: each block writes its
//   head's float32 rows, and the block of a (group, chunk) that finishes
//   last (an integer counter) adds the H heads' rows in a fixed order (four
//   running sums over the heads k mod 4, then their sum), so two calls give
//   the same bits: no float atomics anywhere.  (The Hopper form sums them
//   on chip; see its section at the end.)
//
// Three forms of the states and grads kernels, chosen in the open by the
// wrapper's table (kernels/ssd_scan.py ssd_bwd_kernel; no fallback): bf16
// at P = 64 with N = 64 or 128 in chunks of 128 rows the Hopper kernels
// (ssd_scan_bwd_states_wgmma_kernel, ssd_scan_bwd_grads_wgmma_kernel: the
// last section of this file), the other bf16 shapes the mma.sync form,
// float32 the FMA form, both one template (below).  The scan kernel has
// one form.  Where the Hopper kernels run and a batch*head has at most 8
// chunks (S <= 1,024: every training shape of the repo), the table
// (ssd_bwd_fused) takes the states and the scan as one launch instead,
// ssd_scan_bwd_states_scan_wgmma_kernel (the end of this file): st and U
// never leave the chip.
//
// What bounds it on the H100: bytes.  At zamba2-2.7b's training shape
// (B = 4, S = 1,024, H = 80, P = N = 64, chunks of 128, bf16) the gradient
// must read x, dy, dA, B, C (and h0, dh) and write dx, dA, dB, dC: 130 MB,
// 39 us at 3.35 TB/s; its products (the five Q x Q halves under the
// diagonal and five state products) are about 27 GFLOP, 27 us at the
// 989 TFLOP/s bf16 tensor rate, 400 us on the fp32 FMA units.
//
// What the design of the template does about it: it is the first,
// simple form, right before fast.  The products run on the tensor cores (mma.sync m16n8k16,
// bf16 operands by ldmatrix from swizzled shared tiles, fp32 sums); every
// operand that is not a bf16 input (W and S L, fed back from the
// accumulators, and the float32 states h and G, staged once a block as
// tiles) is split into bf16 hi + lo and multiplied twice, keeping about 16
// bits of mantissa, as the forward kernels do.  No Q x Q matrix leaves the chip: in the grads kernel warp w
// owns row tile w of the chunk (Q <= 128: at most 8 tiles of 16) and walks
// the tiles at or below the diagonal for the row outputs (dC, the row sums
// of R), then owns column tile w and walks the tiles at or above it,
// recomputing the two score tiles transposed, for the column outputs (dx,
// dB, the column sums of R).  The design's own float32 traffic (st and U
// written, read and rewritten by the scan, read again; each head's dB and
// dC rows written and read back for the head sum) is about 0.7 GB at that
// shape, some 0.2 ms: the price of the simple form.  The Hopper grads
// kernel keeps the head sum on chip, the fused states and scan kernel st
// and U; hprev and G stay float32 arrays between the kernels.  The float32 form (float tiles, each product by fmaf in the
// same fragment layout, a register operand passed through a 16 x 17 tile
// of the warp's, h and G read from device memory: no room for them in
// shared memory at N = 128) keeps full fp32 products, which the float32
// checks (1e-3) rely on.
#include <cuda_runtime.h>

#include "mma.cuh"
#include "sm90.cuh"

#define SB_THREADS 256
#define SB_WARPS 8

// SB_CUT is 0 in the port.  Only timing builds set it (by -D, in
// scripts/ssd_bwd_ab.py --cut): bit 1 drops the mma.sync grads kernel's
// head sum of dB and dC (the counter and the last block's reads), bit 2
// its writes of each head's rows to `part`; what they save is the time
// the head sum through device memory costs.
#ifndef SB_CUT
#define SB_CUT 0
#endif
#define SB_MAXQ 128      // rows of a chunk, at most: a 16-row tile a warp
#define SB_SCRATCH 272   // floats of a warp's 16 x 17 operand tile

// Element strides: x, dy, dx by (group, head, position); dA and its
// gradient likewise; B and C by (group, position).  The innermost
// dimension of x, dy, dx, B and C is dense.
struct SbStrides {
  long long x[3], dy[3], dx[3], a[3], da[3], bc[2];
};

template <bool BF>
struct SbElem {
  typedef float T;
};
template <>
struct SbElem<true> {
  typedef bf16 T;
};

__device__ __forceinline__ float sb_f(float v) { return v; }
__device__ __forceinline__ float sb_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void sb_put(float* p, float v) { *p = v; }
__device__ __forceinline__ void sb_put(bf16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void sb_put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void sb_put2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// Element (r, c) of a shared tile of COLS columns.  bf16 tiles keep their
// 16-byte chunks XOR-swizzled by row (as ssd_scan.cu's), so the eight rows
// of every ldmatrix fall on eight bank groups; float tiles are row-major
// with one pad column, so the eight rows a warp reads at one column fall
// in eight banks.
template <bool BF, int COLS>
__device__ __forceinline__ int sb_at(int r, int c) {
  if constexpr (BF) {
    constexpr int CH = COLS / 8;
    const int ch = c >> 3;
    const int sw = CH >= 8 ? ch ^ (r & 7) : ch ^ ((r / (8 / CH)) & (CH - 1));
    return r * COLS + sw * 8 + (c & 7);
  } else {
    return r * (COLS + 1) + c;
  }
}

// Elements of such a tile of `rows` rows.
template <bool BF, int COLS>
__host__ __device__ constexpr int sb_tile(int rows) {
  return rows * (BF ? COLS : COLS + 1);
}

// Rows 0 .. Qp - 1 of a tile from the rows of `src` (element stride rs);
// rows from qv on are zeros.  bf16 by cp.async (the caller commits and
// waits), float by plain loads.
template <bool BF, int COLS>
__device__ __forceinline__ void sb_load(typename SbElem<BF>::T* dst,
                                        const typename SbElem<BF>::T* src,
                                        long long rs, int qv, int Qp) {
  if constexpr (BF) {
    constexpr int CH = COLS / 8;
    for (int i = threadIdx.x; i < Qp * CH; i += SB_THREADS) {
      const int r = i / CH, c = i - (i / CH) * CH;
      const bool in = r < qv;
      cp_async16(dst + sb_at<true, COLS>(r, 8 * c),
                 src + (in ? r : 0) * rs + 8 * c, in);
    }
  } else {
    for (int i = threadIdx.x; i < Qp * COLS; i += SB_THREADS) {
      const int r = i / COLS, c = i - (i / COLS) * COLS;
      dst[sb_at<false, COLS>(r, c)] = r < qv ? src[r * rs + c] : 0.f;
    }
  }
}

// a[r] = dA summed over rows 0 .. r of the chunk (rows from qv on add 0),
// by warp 0 in a fixed order, so every kernel of the backward gets the
// same bits.  ab: the chunk's first dA, element stride as.  Syncs the
// block before and after (the caller's tile loads included).
__device__ __forceinline__ void sb_cumsum(float* a, const float* ab,
                                          long long as, int qv, int Qp) {
  for (int r = threadIdx.x; r < Qp; r += SB_THREADS)
    a[r] = r < qv ? ab[r * as] : 0.f;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (Qp + 31) / 32, beg = lane * per;
    float run = 0.f;
    for (int t = 0; t < per; ++t)
      if (beg + t < Qp) {
        run += a[beg + t];
        a[beg + t] = run;
      }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    for (int t = 0; t < per; ++t)
      if (beg + t < Qp) a[beg + t] += excl;
  }
  __syncthreads();
}

// ------------------------------------------------------------- products
// Every product below adds to a 16 x 16 fp32 tile held as two mma.sync C
// fragments: acc[j][e] is row g + 8 (e >> 1), column 8 j + 2 t + (e & 1)
// (lane = 4 g + t).  The float32 form computes the same elements by fmaf.

// A 16 x 16 fp32 operand in registers (in that fragment layout), ready to
// be the A side of products: bf16 hi + lo fragments, or (float32 form) the
// warp's 16 x 17 scratch tile.
template <bool BF>
struct SbA {
  const float* s;
  __device__ __forceinline__ void set(const float (&v)[2][4], float* scr,
                                      int lane) {
    const int g = lane >> 2, t = lane & 3;
    __syncwarp();   // the warp's products from the scratch are done
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        scr[(g + 8 * (e >> 1)) * 17 + 8 * j + 2 * t + (e & 1)] = v[j][e];
    __syncwarp();
    s = scr;
  }
};
template <>
struct SbA<true> {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(const float (&v)[2][4], float*, int) {
    split_bf16(v[0][0], v[0][1], hi[0], lo[0]);
    split_bf16(v[0][2], v[0][3], hi[1], lo[1]);
    split_bf16(v[1][0], v[1][1], hi[2], lo[2]);
    split_bf16(v[1][2], v[1][3], hi[3], lo[3]);
  }
};

__device__ __forceinline__ void sb_zero(float (&acc)[2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// acc += A[ar0 .. +16][0 .. K) Bt[br0 .. +16][0 .. K)^T: two shared tiles
// of K columns, k contiguous in both.
template <bool BF, int K>
__device__ __forceinline__ void sb_mm_nt(float (&acc)[2][4],
                                         const typename SbElem<BF>::T* A,
                                         int ar0,
                                         const typename SbElem<BF>::T* Bt,
                                         int br0, int lane) {
  if constexpr (BF) {
#pragma unroll
    for (int kb = 0; kb < K / 16; ++kb) {
      uint32_t a[4], b[4];
      ldsm_x4(a, A + sb_at<true, K>(ar0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                    16 * kb + 8 * (lane >> 4)));
      ldsm_x4(b, Bt + sb_at<true, K>(br0 + (lane & 7) + (lane >> 4) * 8,
                                     16 * kb + 8 * ((lane >> 3) & 1)));
      mma_bf16(acc[0], a, b[0], b[1]);
      mma_bf16(acc[1], a, b[2], b[3]);
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float a0 = A[sb_at<false, K>(ar0 + g, k)];
      const float a1 = A[sb_at<false, K>(ar0 + g + 8, k)];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float b = Bt[sb_at<false, K>(br0 + 8 * j + 2 * t + e, k)];
          acc[j][e] = fmaf(a0, b, acc[j][e]);
          acc[j][2 + e] = fmaf(a1, b, acc[j][2 + e]);
        }
    }
  }
}

// acc += A Bk[kr0 .. +16][16 nb .. +16]: A a ready register operand, Bk a
// shared tile of NC columns whose rows are the k of the product.
template <bool BF, int NC>
__device__ __forceinline__ void sb_mm_rk(float (&acc)[2][4], const SbA<BF>& A,
                                         const typename SbElem<BF>::T* Bk,
                                         int kr0, int nb, int lane) {
  if constexpr (BF) {
    uint32_t b[4];
    ldsm_x4_t(b, Bk + sb_at<true, NC>(kr0 + (lane & 7) +
                                          ((lane >> 3) & 1) * 8,
                                      16 * nb + 8 * (lane >> 4)));
    mma_bf16(acc[0], A.hi, b[0], b[1]);
    mma_bf16(acc[0], A.lo, b[0], b[1]);
    mma_bf16(acc[1], A.hi, b[2], b[3]);
    mma_bf16(acc[1], A.lo, b[2], b[3]);
  } else {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
    for (int k = 0; k < 16; ++k) {
      const float a0 = A.s[g * 17 + k], a1 = A.s[(g + 8) * 17 + k];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float b = Bk[sb_at<false, NC>(kr0 + k,
                                              16 * nb + 8 * j + 2 * t + e)];
          acc[j][e] = fmaf(a0, b, acc[j][e]);
          acc[j][2 + e] = fmaf(a1, b, acc[j][2 + e]);
        }
    }
  }
}

// acc += A[ar0 .. +16][0 .. K) Bk[0 .. K)[16 nb .. +16]: bf16 shared tiles,
// A of K columns, Bk of NC columns whose rows are the k of the product.
template <int K, int NC>
__device__ __forceinline__ void sb_mm_sk(float (&acc)[2][4], const bf16* A,
                                         int ar0, const bf16* Bk, int nb,
                                         int lane) {
#pragma unroll
  for (int kb = 0; kb < K / 16; ++kb) {
    uint32_t a[4], b[4];
    ldsm_x4(a, A + sb_at<true, K>(ar0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                  16 * kb + 8 * (lane >> 4)));
    ldsm_x4_t(b, Bk + sb_at<true, NC>(16 * kb + (lane & 7) +
                                          ((lane >> 3) & 1) * 8,
                                      16 * nb + 8 * (lane >> 4)));
    mma_bf16(acc[0], a, b[0], b[1]);
    mma_bf16(acc[1], a, b[2], b[3]);
  }
}

// Float32 form: acc += A[ar0 .. +16][0 .. P) M[16 nb .. +16][0 .. P)^T, A a
// shared tile of P columns, M a float32 [N][P] state in device memory
// (h_{c-1} or G_c).
template <int P>
__device__ __forceinline__ void sb_mm_gt(float (&acc)[2][4], const float* A,
                                         int ar0, const float* M, int nb,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int p = 0; p < P; ++p) {
    const float a0 = A[sb_at<false, P>(ar0 + g, p)];
    const float a1 = A[sb_at<false, P>(ar0 + g + 8, p)];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float b = M[(16 * nb + 8 * j + 2 * t + e) * P + p];
        acc[j][e] = fmaf(a0, b, acc[j][e]);
        acc[j][2 + e] = fmaf(a1, b, acc[j][2 + e]);
      }
  }
}

// Float32 form: acc += A[ar0 .. +16][0 .. N) M[0 .. N)[16 pb .. +16], A a
// shared tile of N columns, M a float32 [N][P] state in device memory.
template <int N, int P>
__device__ __forceinline__ void sb_mm_gn(float (&acc)[2][4], const float* A,
                                         int ar0, const float* M, int pb,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    const float a0 = A[sb_at<false, N>(ar0 + g, n)];
    const float a1 = A[sb_at<false, N>(ar0 + g + 8, n)];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float b = M[n * P + 16 * pb + 8 * j + 2 * t + e];
        acc[j][e] = fmaf(a0, b, acc[j][e]);
        acc[j][2 + e] = fmaf(a1, b, acc[j][2 + e]);
      }
  }
}

// A float32 [N][P] state in device memory as two bf16 shared tiles of P
// columns (rows n), hi and lo: hi + lo keeps about 16 bits of each value.
template <int N, int P>
__device__ __forceinline__ void sb_stage_state(bf16* hi, bf16* lo,
                                               const float* M) {
  for (int i = threadIdx.x; i < N * P / 2; i += SB_THREADS) {
    const int n = 2 * i / P, p = 2 * i - n * P;
    const float2 v = *reinterpret_cast<const float2*>(M + 2 * i);
    split_bf16(v.x, v.y, *reinterpret_cast<uint32_t*>(hi + sb_at<true, P>(n, p)),
               *reinterpret_cast<uint32_t*>(lo + sb_at<true, P>(n, p)));
  }
}

// acc += sum over the chunk's rows k of w_k Bk[k][16 mt + m] X[k][16 pn + p]:
// the rows of two shared tiles (N and P columns) are the k of the product,
// w float weights (bf16 form: w_k Bk[k][.] split into hi + lo).  RT 16-row
// tiles of k.
template <bool BF, int N, int P>
__device__ __forceinline__ void sb_mm_tw(float (&acc)[2][4],
                                         const typename SbElem<BF>::T* Bk,
                                         const float* w,
                                         const typename SbElem<BF>::T* X,
                                         int mt, int pn, int RT, int lane) {
  const int g = lane >> 2, t = lane & 3;
  for (int kq = 0; kq < RT; ++kq) {
    if constexpr (BF) {
      const int q = 16 * kq + 2 * t;
      const float w0 = w[q], w1 = w[q + 1], w8 = w[q + 8], w9 = w[q + 9];
      uint32_t a[4], hi[4], lo[4], b[4];
      // Bk^T: rows m, k = positions (the transpose of Bk's rows)
      ldsm_x4_t(a, Bk + sb_at<true, N>(16 * kq + (lane & 7) + (lane >> 4) * 8,
                                       16 * mt + 8 * ((lane >> 3) & 1)));
      split_bf16(bf16_lo(a[0]) * w0, bf16_hi(a[0]) * w1, hi[0], lo[0]);
      split_bf16(bf16_lo(a[1]) * w0, bf16_hi(a[1]) * w1, hi[1], lo[1]);
      split_bf16(bf16_lo(a[2]) * w8, bf16_hi(a[2]) * w9, hi[2], lo[2]);
      split_bf16(bf16_lo(a[3]) * w8, bf16_hi(a[3]) * w9, hi[3], lo[3]);
      ldsm_x4_t(b, X + sb_at<true, P>(16 * kq + (lane & 7) +
                                          ((lane >> 3) & 1) * 8,
                                      16 * pn + 8 * (lane >> 4)));
      mma_bf16(acc[0], hi, b[0], b[1]);
      mma_bf16(acc[0], lo, b[0], b[1]);
      mma_bf16(acc[1], hi, b[2], b[3]);
      mma_bf16(acc[1], lo, b[2], b[3]);
    } else {
#pragma unroll 4
      for (int k = 16 * kq; k < 16 * kq + 16; ++k) {
        const float a0 = w[k] * Bk[sb_at<false, N>(k, 16 * mt + g)];
        const float a1 = w[k] * Bk[sb_at<false, N>(k, 16 * mt + g + 8)];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float b = X[sb_at<false, P>(k, 16 * pn + 8 * j + 2 * t + e)];
            acc[j][e] = fmaf(a0, b, acc[j][e]);
            acc[j][2 + e] = fmaf(a1, b, acc[j][2 + e]);
          }
      }
    }
  }
}

// --------------------------------------------------------------- kernels
// Shared memory of a block, in bytes (Qp = Q rounded up to 16).
static int sb_states_smem(bool bf, int P, int N, int Qp) {
  const int tiles = bf ? 2 * (2 * Qp * N + 2 * Qp * P)
                       : 4 * (2 * Qp * (N + 1) + 2 * Qp * (P + 1));
  return tiles + 4 * 3 * Qp;
}
static int sb_grads_smem(bool bf, int P, int N, int Qp) {
  return sb_states_smem(bf, P, N, Qp) + 4 * 3 * Qp +
         (bf ? 4 * 2 * N * P : 4 * SB_WARPS * SB_SCRATCH);
}

// The shared tiles of a chunk: B, C ([Qp][N]), x, dy ([Qp][P]), then
// float arrays of Qp: a (the chunk's cumsum), exp(a), w.  Loaded and
// synced; returns the float arrays' base.
template <bool BF, int P, int N>
__device__ __forceinline__ float* sb_stage(
    unsigned char* smem, const typename SbElem<BF>::T* x, const float* dA,
    const typename SbElem<BF>::T* Bm, const typename SbElem<BF>::T* Cm,
    const typename SbElem<BF>::T* dy, const SbStrides& sd, int bg, int hh,
    int c0, int qv, int Qp) {
  typedef typename SbElem<BF>::T T;
  T* Bs = reinterpret_cast<T*>(smem);
  T* Cs = Bs + sb_tile<BF, N>(Qp);
  T* Xs = Cs + sb_tile<BF, N>(Qp);
  T* Ds = Xs + sb_tile<BF, P>(Qp);
  float* a = reinterpret_cast<float*>(Ds + sb_tile<BF, P>(Qp));
  sb_load<BF, N>(Bs, Bm + bg * sd.bc[0] + c0 * sd.bc[1], sd.bc[1], qv, Qp);
  sb_load<BF, N>(Cs, Cm + bg * sd.bc[0] + c0 * sd.bc[1], sd.bc[1], qv, Qp);
  sb_load<BF, P>(Xs, x + bg * sd.x[0] + hh * sd.x[1] + c0 * sd.x[2],
                 sd.x[2], qv, Qp);
  sb_load<BF, P>(Ds, dy + bg * sd.dy[0] + hh * sd.dy[1] + c0 * sd.dy[2],
                 sd.dy[2], qv, Qp);
  if constexpr (BF) {
    cp_async_commit();
    cp_async_wait<0>();
  }
  sb_cumsum(a, dA + bg * sd.a[0] + hh * sd.a[1] + c0 * sd.a[2], sd.a[2], qv,
            Qp);
  float* ea = a + Qp;
  float* wq = ea + Qp;
  const float aL = a[Qp - 1];
  for (int r = threadIdx.x; r < Qp; r += SB_THREADS) {
    ea[r] = expf(a[r]);
    wq[r] = expf(aL - a[r]);
  }
  __syncthreads();
  return a;
}

// x, dy: element (g, h, s, p) at [g sd.x[0] + h sd.x[1] + s sd.x[2] + p]
// (dy by sd.dy; row bh = g H + h); dA: (g, h, s) by sd.a; Bm, Cm: (g, s, n)
// by sd.bc.  Writes st, U [BH, nc, N, P] and aL [BH, nc], float32.  grid
// (nc, BH), SB_THREADS threads; P = 16 PT, N = 16 NT, Q <= SB_MAXQ rows a
// chunk.
template <bool BF, int PT, int NT>
__global__ void __launch_bounds__(SB_THREADS)
    ssd_scan_bwd_states_kernel(const typename SbElem<BF>::T* __restrict__ x,
                               const float* __restrict__ dA,
                               const typename SbElem<BF>::T* __restrict__ Bm,
                               const typename SbElem<BF>::T* __restrict__ Cm,
                               const typename SbElem<BF>::T* __restrict__ dy,
                               float* __restrict__ st, float* __restrict__ U,
                               float* __restrict__ aL, SbStrides sd, int S,
                               int H, int Q) {
  typedef typename SbElem<BF>::T T;
  constexpr int P = 16 * PT, N = 16 * NT, UN = NT * PT;
  extern __shared__ __align__(16) unsigned char sb_smem[];
  const int c = blockIdx.x, nc = gridDim.x, bh = blockIdx.y;
  const int bg = bh / H, hh = bh - (bh / H) * H;
  const int c0 = c * Q, qv = min(Q, S - c0);
  const int Qp = (Q + 15) / 16 * 16, RT = Qp / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* a = sb_stage<BF, P, N>(sb_smem, x, dA, Bm, Cm, dy, sd, bg, hh, c0,
                                qv, Qp);
  const T* Bs = reinterpret_cast<const T*>(sb_smem);
  const T* Cs = Bs + sb_tile<BF, N>(Qp);
  const T* Xs = Cs + sb_tile<BF, N>(Qp);
  const T* Ds = Xs + sb_tile<BF, P>(Qp);
  const float* ea = a + Qp;
  const float* wq = ea + Qp;
  const long long mo = ((long long)bh * nc + c) * N * P;

  // 16 x 16 units: st (B weighted by w, with x), then U (C weighted by
  // exp(a), with dy)
  for (int u = warp; u < 2 * UN; u += SB_WARPS) {
    const int which = u / UN, mt = (u % UN) / PT, pn = u % PT;
    float acc[2][4];
    sb_zero(acc);
    if (which == 0)
      sb_mm_tw<BF, N, P>(acc, Bs, wq, Xs, mt, pn, RT, lane);
    else
      sb_mm_tw<BF, N, P>(acc, Cs, ea, Ds, mt, pn, RT, lane);
    float* out = (which ? U : st) + mo;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        sb_put2(out + (16 * mt + g + 8 * r) * P + 16 * pn + 8 * j + 2 * t,
                acc[j][2 * r], acc[j][2 * r + 1]);
  }
  if (threadIdx.x == 0) aL[(long long)bh * nc + c] = a[Qp - 1];
}

// st, U: [BH, nc, NP] float32, rewritten in place (h_{c-1}, G_c); aL:
// [BH, nc]; h0, dh: [BH, NP] or NULL (zeros); writes dh0 [BH, NP] and sc
// [BH, nc].  grid BH, SB_THREADS threads; NP = EPT SB_THREADS.  Thread i
// keeps elements i + k SB_THREADS (k < EPT) of the running state in
// registers throughout, and loads the next chunk's values while it
// updates this chunk's, so each step waits on one round of loads.
template <int EPT>
__global__ void __launch_bounds__(SB_THREADS)
    ssd_scan_bwd_scan_kernel(float* __restrict__ st, float* __restrict__ U,
                             const float* __restrict__ aL,
                             const float* __restrict__ h0,
                             const float* __restrict__ dh,
                             float* __restrict__ dh0, float* __restrict__ sc,
                             int nc) {
  constexpr int NP = EPT * SB_THREADS;
  __shared__ float red[SB_WARPS];
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  float* stb = st + (long long)bh * nc * NP + tid;
  float* ub = U + (long long)bh * nc * NP + tid;
  const float* al = aL + (long long)bh * nc;
  float run[EPT], ns[EPT], nu[EPT];
#pragma unroll
  for (int k = 0; k < EPT; ++k) {
    run[k] = h0 ? h0[(long long)bh * NP + tid + k * SB_THREADS] : 0.f;
    ns[k] = stb[k * SB_THREADS];
  }
  for (int c = 0; c < nc; ++c) {   // h_c = exp(aL_c) h_{c-1} + st_c
    const float d = expf(al[c]);
    float* s = stb + (long long)c * NP;
    float cur[EPT];
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      cur[k] = ns[k];
      if (c + 1 < nc) ns[k] = s[NP + k * SB_THREADS];
    }
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      s[k * SB_THREADS] = run[k];
      run[k] = d * run[k] + cur[k];
    }
  }
  const long long last = (long long)(nc - 1) * NP;
#pragma unroll
  for (int k = 0; k < EPT; ++k) {   // G_{nc-1} = dh
    run[k] = dh ? dh[(long long)bh * NP + tid + k * SB_THREADS] : 0.f;
    ns[k] = stb[last + k * SB_THREADS];
    nu[k] = ub[last + k * SB_THREADS];
  }
  for (int c = nc - 1; c >= 0; --c) {   // G_{c-1} = U_c + exp(aL_c) G_c
    const float d = expf(al[c]);
    float* u = ub + (long long)c * NP;
    float hs[EPT], us[EPT];
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      hs[k] = ns[k];
      us[k] = nu[k];
      if (c > 0) {
        ns[k] = stb[(long long)(c - 1) * NP + k * SB_THREADS];
        nu[k] = u[k * SB_THREADS - NP];
      }
    }
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      part += hs[k] * run[k];
      u[k * SB_THREADS] = run[k];
      run[k] = us[k] + d * run[k];
    }
#pragma unroll
    for (int off = 16; off; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    if (tid == 0) {
      float tot = 0.f;
      for (int w = 0; w < SB_WARPS; ++w) tot += red[w];
      sc[(long long)bh * nc + c] = d * tot;
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < EPT; ++k)
    dh0[(long long)bh * NP + tid + k * SB_THREADS] = run[k];
}

// Inputs as ssd_scan_bwd_states_kernel's, with hprev, Gc [BH, nc, N, P]
// (the scan's h_{c-1} and G_c) and sc [BH, nc].  Writes dx (x's type, by
// sd.dx), dda (float32, by sd.da), dB and dC (B's type, [G, S, N]
// contiguous); part: float32 [2][BH][S][N] (each head's rows of dB, then
// of dC), count: int [G nc] zeros.  grid (nc, BH), SB_THREADS threads.
template <bool BF, int PT, int NT>
__global__ void __launch_bounds__(SB_THREADS, NT <= 4 ? 2 : 1)
    ssd_scan_bwd_grads_kernel(const typename SbElem<BF>::T* __restrict__ x,
                              const float* __restrict__ dA,
                              const typename SbElem<BF>::T* __restrict__ Bm,
                              const typename SbElem<BF>::T* __restrict__ Cm,
                              const typename SbElem<BF>::T* __restrict__ dy,
                              const float* __restrict__ hprev,
                              const float* __restrict__ Gc,
                              const float* __restrict__ sc,
                              typename SbElem<BF>::T* __restrict__ dx,
                              float* __restrict__ dda,
                              typename SbElem<BF>::T* __restrict__ dB,
                              typename SbElem<BF>::T* __restrict__ dC,
                              float* part, int* __restrict__ count,
                              SbStrides sd, int S, int H, int Q) {
  typedef typename SbElem<BF>::T T;
  constexpr int P = 16 * PT, N = 16 * NT;
  extern __shared__ __align__(16) unsigned char sb_smem[];
  __shared__ int sb_last;
  const int c = blockIdx.x, nc = gridDim.x, bh = blockIdx.y;
  const int BH = gridDim.y;
  const int bg = bh / H, hh = bh - (bh / H) * H;
  const int c0 = c * Q, qv = min(Q, S - c0);
  const int Qp = (Q + 15) / 16 * 16, RT = Qp / 16;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* a = sb_stage<BF, P, N>(sb_smem, x, dA, Bm, Cm, dy, sd, bg, hh, c0,
                                qv, Qp);
  const T* Bs = reinterpret_cast<const T*>(sb_smem);
  const T* Cs = Bs + sb_tile<BF, N>(Qp);
  const T* Xs = Cs + sb_tile<BF, N>(Qp);
  const T* Ds = Xs + sb_tile<BF, P>(Qp);
  const float* ea = a + Qp;
  const float* wq = ea + Qp;
  float* da_row = a + 3 * Qp;     // sum_j R_ij + C_i . dCst_i
  float* da_col = a + 4 * Qp;     // -sum_k R_kj
  float* sterm = a + 5 * Qp;      // B_j . dBst_j
  float* scr = a + 6 * Qp + SB_SCRATCH * warp;   // float32 form only
  const long long mo = ((long long)bh * nc + c) * N * P;
  const float* hp = hprev + mo;
  const float* gp = Gc + mo;
  // bf16 form: h and G as hi + lo tiles [N][P] (the float32 form reads
  // them from device memory)
  bf16* Hh = reinterpret_cast<bf16*>(a + 6 * Qp);
  bf16* Hl = Hh + N * P;
  bf16* Gh = Hl + N * P;
  bf16* Gl = Gh + N * P;
  if constexpr (BF) {
    sb_stage_state<N, P>(Hh, Hl, hp);
    sb_stage_state<N, P>(Gh, Gl, gp);
    __syncthreads();
  }
  float* part_b = part + (long long)bh * S * N;
  float* part_c = part_b + (long long)BH * S * N;

  // ---- rows i of row tile `warp`: dC_i and the row sums of R ----
  if (warp < RT) {
    const int r0 = 16 * warp;
    const float e0 = ea[r0 + g], e1 = ea[r0 + g + 8];
    float acc[NT][2][4];
    float rs0 = 0.f, rs1 = 0.f;   // rows r0 + g, r0 + g + 8
#pragma unroll
    for (int nb = 0; nb < NT; ++nb) {
      // exp(a_i) dy_i h^T, and C_i . it into da_i
      sb_zero(acc[nb]);
      if constexpr (BF) {
        sb_mm_nt<true, P>(acc[nb], Ds, r0, Hh, 16 * nb, lane);
        sb_mm_nt<true, P>(acc[nb], Ds, r0, Hl, 16 * nb, lane);
      } else {
        sb_mm_gt<P>(acc[nb], Ds, r0, hp, nb, lane);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 16 * nb + 8 * j + 2 * t + e;
          acc[nb][j][e] *= e0;
          acc[nb][j][2 + e] *= e1;
          rs0 += sb_f(Cs[sb_at<BF, N>(r0 + g, n)]) * acc[nb][j][e];
          rs1 += sb_f(Cs[sb_at<BF, N>(r0 + g + 8, n)]) * acc[nb][j][2 + e];
        }
    }
    for (int kk = 0; kk <= warp; ++kk) {   // column tiles j at or below
      float s[2][4], w[2][4];
      sb_zero(s);
      sb_zero(w);
      sb_mm_nt<BF, N>(s, Cs, r0, Bs, 16 * kk, lane);   // C B^T
      sb_mm_nt<BF, P>(w, Ds, r0, Xs, 16 * kk, lane);   // dy x^T
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + g + 8 * (e >> 1);
          const int col = 16 * kk + 8 * j + 2 * t + (e & 1);
          const float l = col <= row ? expf(a[row] - a[col]) : 0.f;
          w[j][e] *= l;                                  // W
          if (e >> 1)
            rs1 += w[j][e] * s[j][e];                    // R
          else
            rs0 += w[j][e] * s[j][e];
        }
      SbA<BF> aw;
      aw.set(w, scr, lane);
#pragma unroll
      for (int nb = 0; nb < NT; ++nb)
        sb_mm_rk<BF, N>(acc[nb], aw, Bs, 16 * kk, nb, lane);   // W B
    }
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
    if (t == 0) {
      da_row[r0 + g] = rs0;
      da_row[r0 + g + 8] = rs1;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row >= qv) continue;
      if (SB_CUT & 2) continue;
#pragma unroll
      for (int nb = 0; nb < NT; ++nb)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          sb_put2(part_c + (long long)(c0 + row) * N + 16 * nb + 8 * j + 2 * t,
                  acc[nb][j][2 * r], acc[nb][j][2 * r + 1]);
    }
  }

  // ---- columns j of column tile `warp`: dx_j, dB_j, the column sums of R
  if (warp < RT) {
    const int j0 = 16 * warp;
    const float w0 = wq[j0 + g], w1 = wq[j0 + g + 8];
    float ax[PT][2][4], ab[NT][2][4];
    float cs0 = 0.f, cs1 = 0.f, st0 = 0.f, st1 = 0.f;
#pragma unroll
    for (int pb = 0; pb < PT; ++pb) {   // w_j B_j G
      sb_zero(ax[pb]);
      if constexpr (BF) {
        sb_mm_sk<N, P>(ax[pb], Bs, j0, Gh, pb, lane);
        sb_mm_sk<N, P>(ax[pb], Bs, j0, Gl, pb, lane);
      } else {
        sb_mm_gn<N, P>(ax[pb], Bs, j0, gp, pb, lane);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          ax[pb][j][e] *= w0;
          ax[pb][j][2 + e] *= w1;
        }
    }
#pragma unroll
    for (int nb = 0; nb < NT; ++nb) {   // w_j x_j G^T, and B_j . it
      sb_zero(ab[nb]);
      if constexpr (BF) {
        sb_mm_nt<true, P>(ab[nb], Xs, j0, Gh, 16 * nb, lane);
        sb_mm_nt<true, P>(ab[nb], Xs, j0, Gl, 16 * nb, lane);
      } else {
        sb_mm_gt<P>(ab[nb], Xs, j0, gp, nb, lane);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 16 * nb + 8 * j + 2 * t + e;
          ab[nb][j][e] *= w0;
          ab[nb][j][2 + e] *= w1;
          st0 += sb_f(Bs[sb_at<BF, N>(j0 + g, n)]) * ab[nb][j][e];
          st1 += sb_f(Bs[sb_at<BF, N>(j0 + g + 8, n)]) * ab[nb][j][2 + e];
        }
    }
    for (int kk = warp; kk < RT; ++kk) {   // row tiles i at or above
      float s[2][4], w[2][4];
      sb_zero(s);
      sb_zero(w);
      sb_mm_nt<BF, N>(s, Bs, j0, Cs, 16 * kk, lane);   // (C B^T)^T
      sb_mm_nt<BF, P>(w, Xs, j0, Ds, 16 * kk, lane);   // (dy x^T)^T
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j0 + g + 8 * (e >> 1);            // j
          const int row = 16 * kk + 8 * j + 2 * t + (e & 1);  // i
          const float l = col <= row ? expf(a[row] - a[col]) : 0.f;
          w[j][e] *= l;                                  // W^T
          if (e >> 1)
            cs1 += w[j][e] * s[j][e];                    // R^T
          else
            cs0 += w[j][e] * s[j][e];
          s[j][e] *= l;                                  // (S .* L)^T
        }
      SbA<BF> am;
      am.set(s, scr, lane);
#pragma unroll
      for (int pb = 0; pb < PT; ++pb)
        sb_mm_rk<BF, P>(ax[pb], am, Ds, 16 * kk, pb, lane);   // (S L)^T dy
      SbA<BF> aw;
      aw.set(w, scr, lane);
#pragma unroll
      for (int nb = 0; nb < NT; ++nb)
        sb_mm_rk<BF, N>(ab[nb], aw, Cs, 16 * kk, nb, lane);   // W^T C
    }
    cs0 += __shfl_xor_sync(0xffffffffu, cs0, 1);
    cs0 += __shfl_xor_sync(0xffffffffu, cs0, 2);
    cs1 += __shfl_xor_sync(0xffffffffu, cs1, 1);
    cs1 += __shfl_xor_sync(0xffffffffu, cs1, 2);
    st0 += __shfl_xor_sync(0xffffffffu, st0, 1);
    st0 += __shfl_xor_sync(0xffffffffu, st0, 2);
    st1 += __shfl_xor_sync(0xffffffffu, st1, 1);
    st1 += __shfl_xor_sync(0xffffffffu, st1, 2);
    if (t == 0) {
      da_col[j0 + g] = -cs0;
      da_col[j0 + g + 8] = -cs1;
      sterm[j0 + g] = st0;
      sterm[j0 + g + 8] = st1;
    }
    T* dxb = dx + bg * sd.dx[0] + hh * sd.dx[1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = j0 + g + 8 * r;
      if (row >= qv) continue;
#pragma unroll
      for (int pb = 0; pb < PT; ++pb)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          sb_put2(dxb + (c0 + row) * sd.dx[2] + 16 * pb + 8 * j + 2 * t,
                  ax[pb][j][2 * r], ax[pb][j][2 * r + 1]);
      if (SB_CUT & 2) continue;
#pragma unroll
      for (int nb = 0; nb < NT; ++nb)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          sb_put2(part_b + (long long)(c0 + row) * N + 16 * nb + 8 * j + 2 * t,
                  ab[nb][j][2 * r], ab[nb][j][2 * r + 1]);
    }
  }
  __syncthreads();

  // ---- da, then dA = its reverse cumsum over the chunk, by warp 0 ----
  if (warp == 0) {
    const int per = (Qp + 31) / 32, beg = lane * per;   // per <= 4
    float v[4], sl = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = beg + u;
      v[u] = 0.f;
      if (u < per && i < Qp) {
        v[u] = da_row[i] + da_col[i] - sterm[i];
        sl += sterm[i];
      }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1)   // every lane: the sum over rows
      sl += __shfl_xor_sync(0xffffffffu, sl, off);
    // the chunk's last row L (past a ragged tail a padded row, whose own
    // terms are zero, as the reference's zero padding leaves them)
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (u < per && beg + u == Qp - 1)
        v[u] += sl + sc[(long long)bh * nc + c];
    float tot = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) tot += v[u];
    float suf = tot;   // the sum of tot over lanes >= this one
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float dn = __shfl_down_sync(0xffffffffu, suf, off);
      if (lane + off < 32) suf += dn;
    }
    float run = __shfl_down_sync(0xffffffffu, suf, 1);
    if (lane == 31) run = 0.f;
    float* db = dda + bg * sd.da[0] + hh * sd.da[1];
#pragma unroll
    for (int u = 3; u >= 0; --u) {
      const int i = beg + u;
      if (u < per && i < Qp) {
        run += v[u];
        if (i < qv) db[(c0 + i) * sd.da[2]] = run;
      }
    }
  }

  // ---- dB, dC: the last of the group's H blocks of this chunk to finish
  // adds their rows, in head order ----
  if (SB_CUT & 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) sb_last = atomicAdd(count + bg * nc + c, 1) == H - 1;
  __syncthreads();
  if (!sb_last) return;
  __threadfence();
  const long long hs = (long long)S * N;
  const float* pb0 = part + (long long)bg * H * hs + (long long)c0 * N;
  const float* pc0 = pb0 + (long long)BH * hs;
  T* dbo = dB + ((long long)bg * S + c0) * N;
  T* dco = dC + ((long long)bg * S + c0) * N;
  for (int i = tid; i < qv * N; i += SB_THREADS) {
    // four running sums (heads k mod 4) keep eight loads in flight; they
    // meet in a fixed order
    float sb[4] = {0.f, 0.f, 0.f, 0.f}, sc4[4] = {0.f, 0.f, 0.f, 0.f};
    int k = 0;
    for (; k + 4 <= H; k += 4)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        sb[m] += __ldcg(pb0 + (k + m) * hs + i);
        sc4[m] += __ldcg(pc0 + (k + m) * hs + i);
      }
    for (; k < H; ++k) {
      sb[0] += __ldcg(pb0 + k * hs + i);
      sc4[0] += __ldcg(pc0 + k * hs + i);
    }
    sb_put(dbo + i, (sb[0] + sb[1]) + (sb[2] + sb[3]));
    sb_put(dco + i, (sc4[0] + sc4[1]) + (sc4[2] + sc4[3]));
  }
}

// ======================================= bf16 on Hopper (P = 64, N = 64, 128)
// ssd_scan_bwd_states_wgmma_kernel and ssd_scan_bwd_grads_wgmma_kernel:
// the functions of the mma.sync forms above (the same strides, ragged
// tail, outputs; st, U, hprev, G and sc float32 between the kernels) at
// the shapes of the full configs, P = 64 with N = 64 (zamba2-2.7b) and
// N = 128 (mamba2-130m), in chunks of SBW_Q = 128 rows (a single chunk of
// S < 128 rows is the same chunk with zero rows after S: padded rows add
// dA = 0, so a_L is the last real row's).  kernels/ssd_scan.py
// ssd_bwd_kernel is the route table.
//
// What held the mma.sync grads kernel to 8% of its bound: the head sum of
// dB and dC through device memory (each head's float32 rows written to
// `part` and read back by the last block of a (group, chunk): 335 MB at
// zamba2's shape, 2.6x the kernel's bound), every product on mma.sync
// with the register operands twice (hi + lo), the two score tiles
// recomputed transposed for the column walk, and 225 registers at
// N = 128 (one block of 8 warps an SM, each warp walking the triangle
// alone).
//
// What the design does about it:
// * The grads kernel takes a (group, chunk) as a thread block cluster of
//   csz blocks (sbw_cluster_size: of 1 .. min(H, 8), the size with the
//   fewest heads a block times waves of clusters that fit on the card at
//   once; 30 clusters of 4 fit on the H100 measured, not the 32 of
//   zamba2's and mamba2-130m's shapes); block r walks the heads
//   [r H / csz, (r + 1) H / csz) in order (slices differ by at most one
//   head, none is empty).  dB and dC are summed on chip: each block adds
//   its heads' rows into float32 accumulators held in registers across
//   its heads (the wgmma accumulators of the products W B and W^T C, and
//   the state terms added to them), in head order; then every block
//   writes its sums to its shared memory, the cluster syncs, and block r
//   adds the csz blocks' rows [128 r / csz, 128 (r + 1) / csz) through
//   distributed shared memory in rank order (0, 1, ..., csz - 1) and
//   writes them in bf16.  No float atomics, no `part`: two calls give the
//   same bits.  One block an SM (the accumulators and shared memory
//   below allow one).
// * Every product is a wgmma on tiles that TMA brings: x, dy (the next
//   head's into a second buffer while this head computes; the model's
//   strided views as rank-4 maps, sw_map), B and C once a block; hprev and
//   G ([N, 64] float32, contiguous) by a bulk copy, split in place into
//   bf16 hi + lo tiles.  Operands fed back from accumulators (W, W^T,
//   (S .* L)^T) enter the RS form as bf16 hi + lo, and hprev and G as hi
//   + lo tiles: each such product runs twice, keeping about 16 bits of
//   mantissa (one bf16 rounding left dq 1.32x beyond its limit in the
//   attention backward).
// * No accumulator is transposed: the column walk computes its own
//   products, W^T = (x dy^T) .* L^T and S^T = B C^T, so dx += (S .* L)^T dy
//   and dB += W^T C take their A operand straight from the accumulator.
//   C B^T is recomputed per head and per walk (a wgmma from shared tiles):
//   keeping it across a block's heads would take 96 KB of shared memory
//   or 96 registers a thread, neither of which is left.
// * 256 threads, two warp groups; group g owns rows 64 g .. 64 g + 63 of
//   the chunk as the rows i of the row walk (dC, the row sums of R) and as
//   the columns j of the column walk (dx, dB, the column sums of R): the
//   triangle's blocks split 1 + 2 and 2 + 1, three each.  The blocks of
//   the walks are sbw_bw(NT) columns wide (64 at N = 64, 32 at N = 128,
//   where the persistent dB and dC take 128 registers a thread).
// * The walks' element loop (mask, decay, R's sums) was the kernel's
//   largest cost (timing builds, -DSBW_CUT): L_ij = 2^(a2_i - a2_j) with
//   a2 = a log2(e) from the cumsum, one ex2.approx an element, a's values
//   by float2 loads, and the select of the mask (j <= i) only in blocks
//   that reach the diagonal.  No factored exponential: the exponent is
//   non-positive wherever the mask keeps it.  dA is each head's reverse
//   cumsum of da by one warp in a fixed order, as above.
//
// The states kernel is sw_state of ssd_scan.cu twice: st = (w .* B)^T x
// and U = (e^a .* C)^T dy, the weighted operand read transposed by
// ldmatrix and split into hi + lo, x and dy MN-major from TMA tiles; st
// and U leave by 16-byte stores (neighbouring lanes swap halves), a_L
// beside them.  A block a (batch*head, chunk), two blocks an SM.
#define SBW_Q 128                  // rows of a chunk
#define SBW_THREADS 256            // two warp groups
#define SBW_BOX (SBW_Q * 128)      // bytes of a 128-row box of 64 bf16
#define SBW_CLUSTER 8              // blocks of a grads cluster, at most
#define SBW_LOG2E 1.4426950408889634f

// SBW_CLOCKS is 0 in the port.  Timing builds set it (by -D, in
// scripts/ssd_bwd_ab.py --clocks): then the first block of the grads
// kernel's grid records clock64() at SBW_MARKS points of each head, for
// each warp group (sbw_clock[group][head][mark], the first SBW_HEADS
// heads), read back by sbw_clocks_read.
#ifndef SBW_CLOCKS
#define SBW_CLOCKS 0
#endif
// SBW_CUT is 0 in the port.  Timing builds set it (scripts/ssd_bwd_ab.py
// --cut): bit 1 drops the walks' mask and decay (and R's sums), bit 2
// their fed-back products (dx += (S .* L)^T dy, dB += W^T C, dC += W B;
// the hi + lo splits stay), bit 4 their score products (S, W and the
// transposes).  Their outputs are wrong by design.
#ifndef SBW_CUT
#define SBW_CUT 0
#endif
#define SBW_MARKS 8
#define SBW_HEADS 24
#if SBW_CLOCKS
__device__ long long sbw_clock[2][SBW_HEADS][SBW_MARKS];
#define SBW_MARK(k, m)                                                 \
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0 && (k) < SBW_HEADS) \
  sbw_clock[wg][k][m] = clock64()
#else
#define SBW_MARK(k, m)
#endif

// The slots' semantic dimensions of the maps (sw_map, sm90.cuh).
struct SbwOrders {
  int x, dy, dx, bc;
};

// Descriptor of k-step kk (16 columns) of a K-major tile of 128-row boxes
// of 64 columns (or one [N][64] tile), rows r0 .. of it; and of rows
// 16 kk of an MN-major box.
__device__ __forceinline__ uint64_t sbw_k(const unsigned char* t, int r0,
                                          int kk) {
  return wg_desc(t + (kk >> 2) * SBW_BOX + r0 * 128 + (kk & 3) * 32, 16,
                 1024);
}
__device__ __forceinline__ uint64_t sbw_mn(const unsigned char* t, int kk) {
  return wg_desc(t + kk * 2048, SBW_BOX, 1024);
}

// Elements (row, n), (row, n + 1) of a swizzled tile of 64-column boxes
// (n even), as floats.
__device__ __forceinline__ float2 sbw_pair(const unsigned char* t, int row,
                                           int n) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(
      t + (n >> 6) * SBW_BOX + row * 128 +
      ((((n & 63) >> 3) ^ (row & 7)) << 4) + (n & 7) * 2);
  return make_float2(bf16_lo(v), bf16_hi(v));
}

// a = cumsum(dA) over the chunk's 128 rows by warp group 0, thread tid
// holding row tid (v: its dA, zero past S), in a fixed order (warp scans,
// then the four warps' sums in order); writes a2 = a log2(e), ea = exp(a)
// and wq = exp(a_L - a), and returns a_L = a[127] (to the bit: the same
// three additions).  The caller syncs before others read.
__device__ __forceinline__ float sbw_cumsum(float v, float* a2, float* ea,
                                            float* wq, float* wsum,
                                            int tid) {
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += u;
  }
  if (lane == 31) wsum[warp] = v;
  named_sync(1, 128);
  float pre = 0.f, total = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float w = wsum[k];
    if (k < warp) pre += w;
    total += w;
  }
  v += pre;
  a2[tid] = v * SBW_LOG2E;
  ea[tid] = expf(v);
  wq[tid] = expf(total - v);
  return total;
}

// 2^x (ex2.approx: relative error 2^-22; +inf for large x, which the
// callers' masks then drop)
__device__ __forceinline__ float sbw_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// acc[64 x 64] = (w .* Bk)^T X over the chunk's 128 rows, for the 64
// columns of the box bt (state rows): A from registers (the box read
// transposed by ldmatrix, scaled by w, split into bf16 hi + lo), X
// MN-major.  sw_state of ssd_scan.cu, its weights from an array.
__device__ __forceinline__ void sbw_state(float (&acc)[32],
                                          const unsigned char* bt,
                                          const unsigned char* xs,
                                          const float* w, int tid) {
  const int warp = tid >> 5, lane = tid & 31, t4 = lane & 3;
  uint32_t hi[32], lo[32];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int q = 16 * kk + (lane & 7) + 8 * (lane >> 4);
    const int ch = 2 * warp + ((lane >> 3) & 1);
    uint32_t r[4];
    ldsm_x4_t(r, bt + q * 128 + ((ch ^ (q & 7)) << 4));
    const int qq = 16 * kk + 2 * t4;
    const float w0 = w[qq], w1 = w[qq + 1], w8 = w[qq + 8], w9 = w[qq + 9];
    split_bf16(bf16_lo(r[0]) * w0, bf16_hi(r[0]) * w1, hi[4 * kk], lo[4 * kk]);
    split_bf16(bf16_lo(r[1]) * w0, bf16_hi(r[1]) * w1, hi[4 * kk + 1],
               lo[4 * kk + 1]);
    split_bf16(bf16_lo(r[2]) * w8, bf16_hi(r[2]) * w9, hi[4 * kk + 2],
               lo[4 * kk + 2]);
    split_bf16(bf16_lo(r[3]) * w8, bf16_hi(r[3]) * w9, hi[4 * kk + 3],
               lo[4 * kk + 3]);
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t d = sbw_mn(xs, kk);
    wgmma_rs_64x64(acc, hi + 4 * kk, d);
    wgmma_rs_64x64(acc, lo + 4 * kk, d);
  }
  wg_commit();
  wg_wait<0>();
  wg_hold(acc);
  wg_hold(hi);
  wg_hold(lo);
}

// A [64 x 64] float32 accumulator of a warp group into rows 0..63 of
// `out` (64 floats a row) by 16-byte stores: lanes t and t ^ 1 swap
// halves, so each lane holds four neighbouring columns.
__device__ __forceinline__ void sbw_store_rows(const float (&acc)[32],
                                               float* out, int tid) {
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const bool odd = t4 & 1;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* e0 = acc + 8 * m + 2 * r;       // columns 16 m + 2 t
      const float* e1 = acc + 8 * m + 4 + 2 * r;   // 16 m + 8 + 2 t
      const float q0 = __shfl_xor_sync(0xffffffffu, odd ? e0[0] : e1[0], 1);
      const float q1 = __shfl_xor_sync(0xffffffffu, odd ? e0[1] : e1[1], 1);
      const float4 v = odd ? make_float4(q0, q1, e1[0], e1[1])
                           : make_float4(e0[0], e0[1], q0, q1);
      const int row = 16 * warp + g + 8 * r;
      const int col = 16 * m + 2 * t4 + (odd ? 6 : 0);
      *reinterpret_cast<float4*>(out + row * 64 + col) = v;
    }
}

// Shared memory of the states kernel: x, dy, B, C; a, ea, wq; the warp
// sums; one mbarrier.  67,096 bytes at N = 64, 99,864 at N = 128.
static constexpr int sbw_states_smem(int NT) {
  return SBW_BOX * (2 + 2 * NT) + 4 * (3 * SBW_Q + 4) + 8;
}

// x, dy: [G, H, S, 64] bf16 and B, C: [G, S, N] bf16 as tensor maps
// (boxes of 128 rows); dA: (g, h, s) at the element strides as*.  Writes
// st, U [BH, nc, N, 64] and aL [BH, nc], float32.  grid (nc, BH),
// SBW_THREADS threads.  N = 64: group 0 takes st, group 1 U; N = 128:
// group g takes rows 64 g .. of both.
template <int NT>
__global__ void __launch_bounds__(SBW_THREADS, 2)
    ssd_scan_bwd_states_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                                     const __grid_constant__ CUtensorMap tm_dy,
                                     const __grid_constant__ CUtensorMap tm_b,
                                     const __grid_constant__ CUtensorMap tm_c,
                                     SbwOrders ord, const float* __restrict__ dA,
                                     long long as0, long long as1,
                                     long long as2, float* __restrict__ st,
                                     float* __restrict__ U,
                                     float* __restrict__ aL, int S, int H) {
  constexpr int N = 64 * NT;
  extern __shared__ __align__(1024) unsigned char sbw_smem[];
  unsigned char* xs = sbw_smem;   // 1024-aligned: the swizzle's period
  if (sm90_addr(xs) & 1023) __trap();
  unsigned char* ds = xs + SBW_BOX;
  unsigned char* bs = ds + SBW_BOX;            // [NT][SBW_BOX]
  unsigned char* cs = bs + NT * SBW_BOX;       // [NT][SBW_BOX]
  float* a2 = reinterpret_cast<float*>(cs + NT * SBW_BOX);   // unread here
  float* ea = a2 + SBW_Q;
  float* wq = ea + SBW_Q;
  float* wsum = wq + SBW_Q;
  uint64_t* full = reinterpret_cast<uint64_t*>(wsum + 4);
  const int c = blockIdx.x, nc = gridDim.x, bh = blockIdx.y;
  const int bg = bh / H, hh = bh - bg * H, s0 = c * SBW_Q;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int tid = threadIdx.x & 127;
  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    mbar_init_fence();
    mbar_expect_tx(full, (2 + 2 * NT) * SBW_BOX);
    sw_load(xs, &tm_x, full, ord.x, 0, hh, s0, bg);
    sw_load(ds, &tm_dy, full, ord.dy, 0, hh, s0, bg);
    for (int b = 0; b < NT; ++b) {
      sw_load(bs + b * SBW_BOX, &tm_b, full, ord.bc, 64 * b, 0, s0, bg);
      sw_load(cs + b * SBW_BOX, &tm_c, full, ord.bc, 64 * b, 0, s0, bg);
    }
  }
  float aLv = 0.f;   // group 0: the chunk's a_L
  if (wg == 0)
    aLv = sbw_cumsum(
        s0 + tid < S ? dA[bg * as0 + hh * as1 + (s0 + tid) * as2] : 0.f, a2,
        ea, wq, wsum, tid);
  __syncthreads();   // a, ea, wq; the barrier initialized
  mbar_wait(full, 0);
  const long long mo = ((long long)bh * nc + c) * N * 64;
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const int which = NT == 1 ? wg : k;   // 0: st, 1: U
    const int u = NT == 1 ? 0 : wg;       // the state's rows 64 u ..
    float acc[32];
    sbw_state(acc, (which ? cs : bs) + u * SBW_BOX, which ? ds : xs,
              which ? ea : wq, tid);
    sbw_store_rows(acc, (which ? U : st) + mo + u * 64 * 64, tid);
  }
  if (threadIdx.x == 0) aL[(long long)bh * nc + c] = aLv;
}

// Columns of a walk's blocks: 64 at N = 64; 32 at N = 128, where dB and dC
// stay in registers across the heads (128 a thread).
__host__ __device__ constexpr int sbw_bw(int NT) { return NT == 1 ? 64 : 32; }

// A float32 [N][64] state (a bulk copy) rewritten in place as its bf16 hi
// tile [N][64] then its lo tile (128-byte swizzle, rows n): hi + lo keeps
// about 16 bits of each value.  Every thread of the block; syncs it
// between the reads and the writes.
template <int NT>
__device__ __forceinline__ void sbw_split_state(unsigned char* s) {
  constexpr int PER = 64 * NT * 64 / 4 / SBW_THREADS;   // float4 a thread
  float4 v[PER];
  const float4* f = reinterpret_cast<const float4*>(s);
#pragma unroll
  for (int i = 0; i < PER; ++i) v[i] = f[threadIdx.x + i * SBW_THREADS];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int e = 4 * (threadIdx.x + i * SBW_THREADS);
    const int n = e >> 6, p = e & 63;
    const int off = n * 128 + (((p >> 3) ^ (n & 7)) << 4) + (p & 7) * 2;
    uint32_t h0, l0, h1, l1;
    split_bf16(v[i].x, v[i].y, h0, l0);
    split_bf16(v[i].z, v[i].w, h1, l1);
    *reinterpret_cast<uint2*>(s + off) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(s + 64 * NT * 128 + off) = make_uint2(l0, l1);
  }
}

// da of one head from its row terms (rs: sum_j R_ij + C_i . dCst_i), its
// column terms (cs: -sum_k R_kj) and sterm (B_j . dBst_j), then dA = the
// reverse cumsum over the chunk, by one warp in a fixed order (as the
// mma.sync kernel's): db at element stride ds, rows < qv written.
__device__ __forceinline__ void sbw_da(const float* rs, const float* cs,
                                       const float* sterm, float scv,
                                       float* db, long long ds, int qv,
                                       int lane) {
  const int beg = 4 * lane;
  float v[4], sl = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    v[u] = rs[beg + u] + cs[beg + u] - sterm[beg + u];
    sl += sterm[beg + u];
  }
#pragma unroll
  for (int off = 16; off; off >>= 1)
    sl += __shfl_xor_sync(0xffffffffu, sl, off);
  if (lane == 31) v[3] += sl + scv;   // the chunk's last row
  const float tot = (v[0] + v[1]) + (v[2] + v[3]);
  float suf = tot;   // the sum of tot over lanes >= this one
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float dn = __shfl_down_sync(0xffffffffu, suf, off);
    if (lane + off < 32) suf += dn;
  }
  float run = __shfl_down_sync(0xffffffffu, suf, 1);
  if (lane == 31) run = 0.f;
#pragma unroll
  for (int u = 3; u >= 0; --u) {
    run += v[u];
    if (beg + u < qv) db[(beg + u) * ds] = run;
  }
}

// Shared memory of the grads kernel: B, C; x and dy in two buffers; hprev
// and G (float32, then their hi + lo tiles); dx's two 64-row tiles; a, ea,
// wq; the three row terms in two buffers (by head parity); the warp sums;
// four mbarriers.  152,112 bytes at N = 64, 217,648 at N = 128.  At the
// end its start holds the block's dC and dB sums, [128][N + 8] float32.
static constexpr int sbw_grads_smem(int NT) {
  return SBW_BOX * (4 * NT + 5) + 4 * (9 * SBW_Q + 4) + 8 * 4;
}

// x, dy, dx: [G, H, S, 64] bf16 and B, C: [G, S, N] bf16 as tensor maps
// (x, dy, B, C boxes of 128 rows, dx of 64); dA and dda: (g, h, s) at the
// element strides as*, ds*; hprev, Gc [BH, nc, N, 64] and sc [BH, nc]
// float32 (from the scan kernel).  Writes dx, dda, and dB, dC [G, S, N]
// bf16 contiguous.  grid (csz, G nc) in clusters of csz <= min(H, 8)
// blocks (sbw_cluster_size), SBW_THREADS threads; block r of cluster
// (g, c) takes heads [r H / csz, (r + 1) H / csz) of group g in chunk c.
//
// A head, in order: (1) group 0 takes a's cumsum, every thread splits
// hprev and G into hi + lo (the bulk copies issued during the head before)
// and the block syncs; (2) the state products: group g's rows of
// dCst = e^a .* (dy h^T) and dBst = w .* (x G^T), added to dC and dB with
// C_i . dCst_i and B_j . dBst_j into the row terms, and dx = w .* (B G);
// the block syncs and thread 0 starts the next head's states; (3) the
// column walk (dx, dB, the column sums of R), dx out by a TMA store;
// (4) the row walk (dC, the row sums of R); the block syncs, thread 0
// starts the x and dy tiles of the head after next, and warp 7 turns the
// head's row terms into its dA.
template <int NT>
__global__ void __launch_bounds__(SBW_THREADS, 1)
    ssd_scan_bwd_grads_wgmma_kernel(
        const __grid_constant__ CUtensorMap tm_x,
        const __grid_constant__ CUtensorMap tm_dy,
        const __grid_constant__ CUtensorMap tm_b,
        const __grid_constant__ CUtensorMap tm_c,
        const __grid_constant__ CUtensorMap tm_dx, SbwOrders ord,
        const float* __restrict__ dA, long long as0, long long as1,
        long long as2, const float* __restrict__ hprev,
        const float* __restrict__ Gc, const float* __restrict__ sc,
        float* __restrict__ dda, long long ds0, long long ds1, long long ds2,
        bf16* __restrict__ dB, bf16* __restrict__ dC, int S, int H, int nc) {
  constexpr int N = 64 * NT, BW = sbw_bw(NT), KB = BW / 16;
  constexpr int SB = 64 * NT * 256;   // bytes of a float32 state
  extern __shared__ __align__(1024) unsigned char sbw_smem[];
  unsigned char* bt = sbw_smem;   // 1024-aligned: the swizzle's period
  if (sm90_addr(bt) & 1023) __trap();
  unsigned char* ct = bt + NT * SBW_BOX;       // [NT][SBW_BOX]
  unsigned char* xt2 = ct + NT * SBW_BOX;      // [2][SBW_BOX]
  unsigned char* dt2 = xt2 + 2 * SBW_BOX;      // [2][SBW_BOX]
  unsigned char* sth = dt2 + 2 * SBW_BOX;      // hprev: float32, hi + lo
  unsigned char* stg = sth + SB;               // G
  unsigned char* dxs = stg + SB;               // [2][64 rows x 128 B]
  float* a2 = reinterpret_cast<float*>(dxs + SBW_BOX);   // a log2(e)
  float* ea = a2 + SBW_Q;
  float* wq = ea + SBW_Q;
  float* rsum = wq + SBW_Q;                    // [2][128]
  float* csum = rsum + 2 * SBW_Q;              // [2][128]
  float* sterm = csum + 2 * SBW_Q;             // [2][128]
  float* wsum = sterm + 2 * SBW_Q;             // [4]
  uint64_t* bc_full = reinterpret_cast<uint64_t*>(wsum + 4);
  uint64_t* xd_full = bc_full + 1;             // [2]
  uint64_t* st_full = bc_full + 3;

  const int rank = blockIdx.x, csz = gridDim.x;
  const int bg = blockIdx.y / nc, c = blockIdx.y - (blockIdx.y / nc) * nc;
  const int s0 = c * SBW_Q, qv = min(SBW_Q, S - s0);
  const int hb = rank * H / csz, nh = (rank + 1) * H / csz - hb;
  // the warp group, uniform to the compiler
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = 64 * wg;   // the group's rows of the chunk
  auto state_at = [&](int h) {   // the (batch*head, chunk)'s state offset
    return ((long long)(bg * H + h) * nc + c) * N * 64;
  };
  auto dA_at = [&](int h) {   // row tid's dA of head h (group 0)
    return s0 + tid < S ? dA[bg * as0 + h * as1 + (s0 + tid) * as2] : 0.f;
  };

  if (threadIdx.x == 0) {
    mbar_init(bc_full, 1);
    mbar_init(xd_full, 1);
    mbar_init(xd_full + 1, 1);
    mbar_init(st_full, 1);
    mbar_init_fence();
    if (nh > 0) {
      mbar_expect_tx(bc_full, 2 * NT * SBW_BOX);
      for (int b = 0; b < NT; ++b) {
        sw_load(bt + b * SBW_BOX, &tm_b, bc_full, ord.bc, 64 * b, 0, s0, bg);
        sw_load(ct + b * SBW_BOX, &tm_c, bc_full, ord.bc, 64 * b, 0, s0, bg);
      }
      for (int k = 0; k < 2 && k < nh; ++k) {
        mbar_expect_tx(xd_full + k, 2 * SBW_BOX);
        sw_load(xt2 + k * SBW_BOX, &tm_x, xd_full + k, ord.x, 0, hb + k, s0,
                bg);
        sw_load(dt2 + k * SBW_BOX, &tm_dy, xd_full + k, ord.dy, 0, hb + k, s0,
                bg);
      }
      mbar_expect_tx(st_full, 2 * SB);
      bulk_load(sth, hprev + state_at(hb), SB, st_full);
      bulk_load(stg, Gc + state_at(hb), SB, st_full);
    }
  }
  float dCa[NT][32], dBa[NT][32];   // the block's sums over its heads
#pragma unroll
  for (int u = 0; u < NT; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) dCa[u][i] = dBa[u][i] = 0.f;
  float dav = wg == 0 && nh > 0 ? dA_at(hb) : 0.f;
  __syncthreads();   // the barriers initialized

  for (int k = 0; k < nh; ++k) {
    const int hh = hb + k, bh = bg * H + hh, buf = k & 1;
    const unsigned char* xt = xt2 + buf * SBW_BOX;
    const unsigned char* dt = dt2 + buf * SBW_BOX;
    float* rs = rsum + buf * SBW_Q;
    float* cs = csum + buf * SBW_Q;
    float* stm = sterm + buf * SBW_Q;
    // ---- (1) a's cumsum; hprev and G as hi + lo tiles
    SBW_MARK(k, 0);
    if (wg == 0) sbw_cumsum(dav, a2, ea, wq, wsum, tid);
    mbar_wait(st_full, k & 1);
    sbw_split_state<NT>(sth);
    sbw_split_state<NT>(stg);
    fence_async_smem();   // the tiles, before wgmma reads them
    if (wg == 0 && k + 1 < nh) dav = dA_at(hh + 1);
    // the head's sc, for warp 7's dA at its end
    const float scv = wg == 1 && warp == 3 ? sc[(long long)bh * nc + c] : 0.f;
    __syncthreads();
    if (k == 0) mbar_wait(bc_full, 0);
    mbar_wait(xd_full + buf, (k >> 1) & 1);
    SBW_MARK(k, 1);

    // ---- (2) the state products of the group's rows: dy h^T (rows i)
    // and x G^T (rows j) of state rows 64 u .. in one batch, at N = 64
    // with B G (rows j) beside them; each product's hi and lo halves
    // chained into one accumulator
    const int ra = r0 + 16 * warp + g, rb = ra + 8;   // this thread's rows
    float rt0 = 0.f, rt1 = 0.f;   // row terms of rows ra, rb
    float st0 = 0.f, st1 = 0.f;   // B_j . dBst_j
    float dx[32];   // w_j (B G)_j, then the column walk's sums
    auto bg_issue = [&]() {   // B G into dx
#pragma unroll
      for (int kk = 0; kk < 4 * NT; ++kk)
        wgmma_ss_mn_64x64(dx, sbw_k(bt, r0, kk), sbw_mn(stg, kk), kk == 0);
#pragma unroll
      for (int kk = 0; kk < 4 * NT; ++kk)
        wgmma_ss_mn_64x64(dx, sbw_k(bt, r0, kk), sbw_mn(stg + N * 128, kk),
                          0);
    };
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      float pc[32], pb[32];
      wg_fence();
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)   // hi, then lo
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_ss_64x64(pc, sbw_k(dt, r0, kk),
                         sbw_k(sth + h2 * N * 128 + u * 8192, 0, kk),
                         h2 == 0 && kk == 0);
          wgmma_ss_64x64(pb, sbw_k(xt, r0, kk),
                         sbw_k(stg + h2 * N * 128 + u * 8192, 0, kk),
                         h2 == 0 && kk == 0);
        }
      if (NT == 1) bg_issue();
      wg_commit();
      wg_wait<0>();
      wg_hold(pc);
      wg_hold(pb);
      if (NT == 1) wg_hold(dx);
      const float e0 = ea[ra], e1 = ea[rb], w0 = wq[ra], w1 = wq[rb];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * jj + 2 * r, n = 64 * u + 8 * jj + 2 * t4;
          const float e = r ? e1 : e0, w = r ? w1 : w0;
          const float c0 = pc[i] * e, c1 = pc[i + 1] * e;   // dCst
          const float b0 = pb[i] * w, b1 = pb[i + 1] * w;   // dBst
          const float2 cv = sbw_pair(ct, r ? rb : ra, n);
          const float2 bv = sbw_pair(bt, r ? rb : ra, n);
          (r ? rt1 : rt0) += cv.x * c0 + cv.y * c1;
          (r ? st1 : st0) += bv.x * b0 + bv.y * b1;
          dCa[u][i] += c0;
          dCa[u][i + 1] += c1;
          dBa[u][i] += b0;
          dBa[u][i + 1] += b1;
        }
    }
    if (NT != 1) {
      wg_fence();
      bg_issue();
      wg_commit();
      wg_wait<0>();
      wg_hold(dx);
    }
    {
      const float w0 = wq[ra], w1 = wq[rb];
#pragma unroll
      for (int i = 0; i < 32; ++i) dx[i] *= (i & 2) ? w1 : w0;
    }
    SBW_MARK(k, 2);
    __syncthreads();   // every read of hprev's and G's tiles done
    SBW_MARK(k, 3);
    if (threadIdx.x == 0 && k + 1 < nh) {
      mbar_expect_tx(st_full, 2 * SB);
      bulk_load(sth, hprev + state_at(hh + 1), SB, st_full);
      bulk_load(stg, Gc + state_at(hh + 1), SB, st_full);
    }

    // ---- (3) the column walk: columns j of the group's rows, the row
    // blocks i at or below them
    float cs0 = 0.f, cs1 = 0.f;   // sum_i R_ij of columns ra, rb
    // the A operands of a block's products: they stay unwritten until the
    // next block's wait, which also drains those products
    uint32_t hs[BW / 4], ls[BW / 4], hw[BW / 4], lw[BW / 4];
    for (int ib = r0 / BW; ib < SBW_Q / BW; ++ib) {
      const int i0 = BW * ib;
      float sT[BW / 2], wT[BW / 2];
      wg_fence();
      if (!(SBW_CUT & 4)) {
#pragma unroll
        for (int kk = 0; kk < 4 * NT; ++kk)
          wgmma_ss<BW>(sT, sbw_k(bt, r0, kk), sbw_k(ct, i0, kk), kk == 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<BW>(wT, sbw_k(xt, r0, kk), sbw_k(dt, i0, kk), kk == 0);
      }
      wg_commit();
      wg_wait<0>();
      wg_hold(sT);
      wg_hold(wT);
      wg_hold(dx);
#pragma unroll
      for (int u = 0; u < NT; ++u) wg_hold(dBa[u]);
      wg_hold(hs);
      wg_hold(ls);
      wg_hold(hw);
      wg_hold(lw);
      // L_ij = 2^(a2_i - a2_j) for i >= j: rows j (ra, rb), columns i;
      // masked only where the block reaches the diagonal
      const bool diag = i0 < r0 + 64;
      const float aj0 = a2[ra], aj1 = a2[rb];
#pragma unroll
      for (int jj = 0; jj < (SBW_CUT & 1 ? 0 : BW / 8); ++jj) {
        const int i = i0 + 8 * jj + 2 * t4;
        const float2 ai = *reinterpret_cast<const float2*>(a2 + i);
        float l[4] = {sbw_exp2(ai.x - aj0), sbw_exp2(ai.y - aj0),
                      sbw_exp2(ai.x - aj1), sbw_exp2(ai.y - aj1)};
        if (diag) {
          l[0] = i >= ra ? l[0] : 0.f;
          l[1] = i + 1 >= ra ? l[1] : 0.f;
          l[2] = i >= rb ? l[2] : 0.f;
          l[3] = i + 1 >= rb ? l[3] : 0.f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = 4 * jj + e;
          wT[q] *= l[e];                                 // W^T
          ((e & 2) ? cs1 : cs0) += wT[q] * sT[q];        // R^T
          sT[q] *= l[e];                                 // (S .* L)^T
        }
      }
#pragma unroll
      for (int q = 0; q < BW / 4; ++q)
        split_bf16(sT[2 * q], sT[2 * q + 1], hs[q], ls[q]);
      wg_fence();
#pragma unroll
      for (int s = 0; s < (SBW_CUT & 2 ? 0 : KB); ++s) {   // dx += (S L)^T dy
        wgmma_rs_64x64(dx, hs + 4 * s, sbw_mn(dt, i0 / 16 + s));
        wgmma_rs_64x64(dx, ls + 4 * s, sbw_mn(dt, i0 / 16 + s));
      }
      wg_commit();
#pragma unroll
      for (int q = 0; q < BW / 4; ++q)
        split_bf16(wT[2 * q], wT[2 * q + 1], hw[q], lw[q]);
      wg_fence();
#pragma unroll
      for (int u = 0; u < NT; ++u)
#pragma unroll
        for (int s = 0; s < (SBW_CUT & 2 ? 0 : KB); ++s) {   // dB += W^T C
          wgmma_rs_64x64(dBa[u], hw + 4 * s,
                         sbw_mn(ct + u * SBW_BOX, i0 / 16 + s));
          wgmma_rs_64x64(dBa[u], lw + 4 * s,
                         sbw_mn(ct + u * SBW_BOX, i0 / 16 + s));
        }
      wg_commit();
    }
    wg_wait<0>();
    wg_hold(dx);
#pragma unroll
    for (int u = 0; u < NT; ++u) wg_hold(dBa[u]);
    wg_hold(hs);
    wg_hold(ls);
    wg_hold(hw);
    wg_hold(lw);
    SBW_MARK(k, 4);
    {   // dx out: bf16 into the group's tile (the map's 128-byte swizzle),
        // then one TMA store, clipped at S
      unsigned char* xo = dxs + wg * 8192;
      if (tid == 0) tma_store_wait_read();   // the last head's store read
      named_sync(2 + wg, 128);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * warp + g + 8 * r;
          *reinterpret_cast<uint32_t*>(xo + row * 128 +
                                       ((jj ^ (row & 7)) << 4) + 4 * t4) =
              pack_bf16(dx[4 * jj + 2 * r], dx[4 * jj + 2 * r + 1]);
        }
      fence_async_smem();
      named_sync(2 + wg, 128);
      if (tid == 0 && s0 + r0 < S) {
        sw_store(&tm_dx, xo, ord.dx, 0, hh, s0 + r0, bg);
        tma_store_commit();
      }
    }
    cs0 += __shfl_xor_sync(0xffffffffu, cs0, 1);
    cs0 += __shfl_xor_sync(0xffffffffu, cs0, 2);
    cs1 += __shfl_xor_sync(0xffffffffu, cs1, 1);
    cs1 += __shfl_xor_sync(0xffffffffu, cs1, 2);
    st0 += __shfl_xor_sync(0xffffffffu, st0, 1);
    st0 += __shfl_xor_sync(0xffffffffu, st0, 2);
    st1 += __shfl_xor_sync(0xffffffffu, st1, 1);
    st1 += __shfl_xor_sync(0xffffffffu, st1, 2);
    if (t4 == 0) {
      cs[ra] = -cs0;
      cs[rb] = -cs1;
      stm[ra] = st0;
      stm[rb] = st1;
    }

    SBW_MARK(k, 5);
    // ---- (4) the row walk: rows i of the group, the column blocks j at
    // or below them
    for (int kb = 0; kb < (r0 + 64) / BW; ++kb) {
      const int j0 = BW * kb;
      float sS[BW / 2], w[BW / 2];
      wg_fence();
      if (!(SBW_CUT & 4)) {
#pragma unroll
        for (int kk = 0; kk < 4 * NT; ++kk)
          wgmma_ss<BW>(sS, sbw_k(ct, r0, kk), sbw_k(bt, j0, kk), kk == 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<BW>(w, sbw_k(dt, r0, kk), sbw_k(xt, j0, kk), kk == 0);
      }
      wg_commit();
      wg_wait<0>();
      wg_hold(sS);
      wg_hold(w);
#pragma unroll
      for (int u = 0; u < NT; ++u) wg_hold(dCa[u]);
      wg_hold(hw);
      wg_hold(lw);
      // L_ij = 2^(a2_i - a2_j) for j <= i: rows i (ra, rb), columns j;
      // masked only where the block reaches the diagonal
      const bool diag = j0 + BW > r0;
      const float ai0 = a2[ra], ai1 = a2[rb];
#pragma unroll
      for (int jj = 0; jj < (SBW_CUT & 1 ? 0 : BW / 8); ++jj) {
        const int j = j0 + 8 * jj + 2 * t4;
        const float2 aj = *reinterpret_cast<const float2*>(a2 + j);
        float l[4] = {sbw_exp2(ai0 - aj.x), sbw_exp2(ai0 - aj.y),
                      sbw_exp2(ai1 - aj.x), sbw_exp2(ai1 - aj.y)};
        if (diag) {
          l[0] = j <= ra ? l[0] : 0.f;
          l[1] = j + 1 <= ra ? l[1] : 0.f;
          l[2] = j <= rb ? l[2] : 0.f;
          l[3] = j + 1 <= rb ? l[3] : 0.f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = 4 * jj + e;
          w[q] *= l[e];                                  // W
          ((e & 2) ? rt1 : rt0) += w[q] * sS[q];         // R
        }
      }
#pragma unroll
      for (int q = 0; q < BW / 4; ++q)
        split_bf16(w[2 * q], w[2 * q + 1], hw[q], lw[q]);
      wg_fence();
#pragma unroll
      for (int u = 0; u < NT; ++u)
#pragma unroll
        for (int s2 = 0; s2 < (SBW_CUT & 2 ? 0 : KB); ++s2) {   // dC += W B
          wgmma_rs_64x64(dCa[u], hw + 4 * s2,
                         sbw_mn(bt + u * SBW_BOX, j0 / 16 + s2));
          wgmma_rs_64x64(dCa[u], lw + 4 * s2,
                         sbw_mn(bt + u * SBW_BOX, j0 / 16 + s2));
        }
      wg_commit();
    }
    wg_wait<0>();
#pragma unroll
    for (int u = 0; u < NT; ++u) wg_hold(dCa[u]);
    wg_hold(hw);
    wg_hold(lw);
    rt0 += __shfl_xor_sync(0xffffffffu, rt0, 1);
    rt0 += __shfl_xor_sync(0xffffffffu, rt0, 2);
    rt1 += __shfl_xor_sync(0xffffffffu, rt1, 1);
    rt1 += __shfl_xor_sync(0xffffffffu, rt1, 2);
    if (t4 == 0) {
      rs[ra] = rt0;
      rs[rb] = rt1;
    }
    SBW_MARK(k, 6);
    __syncthreads();   // x and dy's buffer read; the row terms whole
    SBW_MARK(k, 7);
    if (threadIdx.x == 0 && k + 2 < nh) {
      mbar_expect_tx(xd_full + buf, 2 * SBW_BOX);
      sw_load(xt2 + buf * SBW_BOX, &tm_x, xd_full + buf, ord.x, 0, hh + 2, s0,
              bg);
      sw_load(dt2 + buf * SBW_BOX, &tm_dy, xd_full + buf, ord.dy, 0, hh + 2,
              s0, bg);
    }
    if (wg == 1 && warp == 3)
      sbw_da(rs, cs, stm, scv,
             dda + bg * ds0 + hh * ds1 + (long long)s0 * ds2, ds2, qv, lane);
  }

  // ---- dB, dC: the block's sums into its shared memory, then block r
  // adds rows [128 r / csz, 128 (r + 1) / csz) of the csz blocks in rank
  // order through distributed shared memory
  if (tid == 0) tma_store_wait_read();
  __syncthreads();   // every tile free
  constexpr int RP = N + 8;   // a row of the sums, padded
  float* rc = reinterpret_cast<float*>(sbw_smem);
  float* rb_ = rc + SBW_Q * RP;
#pragma unroll
  for (int u = 0; u < NT; ++u)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 16 * warp + g + 8 * r;
        const int col = 64 * u + 8 * jj + 2 * t4;
        const int i = 4 * jj + 2 * r;
        *reinterpret_cast<float2*>(rc + row * RP + col) =
            make_float2(dCa[u][i], dCa[u][i + 1]);
        *reinterpret_cast<float2*>(rb_ + row * RP + col) =
            make_float2(dBa[u][i], dBa[u][i + 1]);
      }
  cluster_sync();
  const int q0 = rank * SBW_Q / csz, q1 = (rank + 1) * SBW_Q / csz;
  const int per = (q1 - q0) * (N / 4);   // float4s of one of dC, dB
  for (int idx = threadIdx.x; idx < 2 * per; idx += SBW_THREADS) {
    const int which = idx >= per, rem = idx - which * per;
    const int row = q0 + rem / (N / 4), col = 4 * (rem % (N / 4));
    if (row >= qv) continue;
    const float* src = (which ? rb_ : rc) + row * RP + col;
    float4 sum = ld_cluster_v4(cluster_map(src, 0));
    for (int q = 1; q < csz; ++q) {
      const float4 v = ld_cluster_v4(cluster_map(src, q));
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    bf16* out = (which ? dB : dC) + ((long long)bg * S + s0 + row) * N + col;
    *reinterpret_cast<uint2*>(out) =
        make_uint2(pack_bf16(sum.x, sum.y), pack_bf16(sum.z, sum.w));
  }
  cluster_sync();   // no block leaves while another reads its sums
  if (tid == 0)      // the last dx stores done before the block ends
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------ the states and the scan, fused
// ssd_scan_bwd_states_scan_wgmma_kernel: ssd_scan_bwd_states_wgmma_kernel
// and ssd_scan_bwd_scan_kernel in one launch, at the Hopper shapes with at
// most SBW_CLUSTER chunks (S <= 1,024: every training shape of the repo).
//
// What held the two-launch chain back: not the scan kernel's loop but its
// interface.  The states kernel wrote st and U, float32 [BH, nc, N, 64],
// only for the scan kernel to read them, write hprev over st, read it
// again and write G over U: seven passes of the array (210 MB at
// zamba2-2.7b's training shape, 0.063 ms at 3.35 TB/s; the scan kernel ran
// at 88% of its five).  Here st and U never leave the chip: the two passes
// left are the writes of hprev and G, which the grads kernel reads.
//
// What the design does about it:
// * The grid is (nc, BH) in clusters of nc blocks: block c of a cluster is
//   chunk c of one batch*head, its rank c.  It computes st_c and U_c as
//   the states kernel does (the same TMA tiles, cumsum and sbw_state
//   products, so the same bits) and parks them, float32 [N][64] each, in
//   its own shared memory over B's and C's boxes (NT x 16 KB each: the
//   states' exact size), once every product reading a box is done (a
//   block barrier after each product's wgmma.wait_group); a_L beside them.
// * The scans as a transpose, not a chain (a step through distributed
//   shared memory cost 1.0-2.0 us in ssd_scan_wgmma_kernel): after a
//   cluster barrier block r owns float2s [r F / nc, (r + 1) F / nc) of the
//   F = 32 N of a state, all 256 threads at work.  A thread reads its
//   float2 of every block's st and U in one round of ld.shared::cluster
//   (16 loads in flight), no block waiting on another, runs both
//   recurrences in registers in the scan kernel's order and expressions
//   (h_c = exp(a_L) h_{c-1} + st_c from h0; G_{c-1} = U_c + exp(a_L) G_c
//   from dh), so hprev, G and dh0 equal the chain's to the bit, and writes
//   hprev and G by 8-byte stores.
// * sc_c = exp(a_L_c) <h_{c-1}, G_c>: each block reduces its slice's
//   products for every c in a fixed order (a thread's float2s in order,
//   the warp by shuffles, the eight warps in order) and sends the sum for
//   chunk k to block k (st.async, counted on block k's mbarrier); block c
//   waits for its nc sums and adds them in rank order.  No float atomics:
//   two calls give the same bits (sc differs from the scan kernel's by the
//   order of its sum alone).  A block sends only after all its reads of
//   the cluster's st and U, so a block that has its nc sums may leave: no
//   barrier after the first.
// Two blocks an SM, as the states kernel: its shared memory plus the sums.

// SBF_CUT is 0 in the port.  Timing builds set it (scripts/ssd_bwd_ab.py
// --cut): bit 1 drops the fused kernel's scans (it ends after the first
// cluster barrier), bit 2 their stores of hprev, G and dh0.  Their outputs
// are wrong by design.
#ifndef SBF_CUT
#define SBF_CUT 0
#endif

// Shared memory of the fused kernel: the states kernel's, then the
// mbarrier of sc's sums, the warps' sums by chunk [8][SBW_CLUSTER], the
// cluster's sums for this block's chunk [SBW_CLUSTER] and its a_L.  67,408
// bytes at N = 64, 100,176 at N = 128.
static constexpr int sbw_fused_smem(int NT) {
  return sbw_states_smem(NT) + 8 + 4 * (9 * SBW_CLUSTER + 4);
}

// x, dy, B, C, dA as ssd_scan_bwd_states_wgmma_kernel's; h0, dh [BH, N, 64]
// float32 or NULL (zeros).  Writes hprev, Gc [BH, nc, N, 64], dh0
// [BH, N, 64] and sc [BH, nc], float32.  grid (nc, BH) in clusters of
// (nc, 1, 1), nc <= SBW_CLUSTER, SBW_THREADS threads.
template <int NT>
__global__ void __launch_bounds__(SBW_THREADS, 2)
    ssd_scan_bwd_states_scan_wgmma_kernel(
        const __grid_constant__ CUtensorMap tm_x,
        const __grid_constant__ CUtensorMap tm_dy,
        const __grid_constant__ CUtensorMap tm_b,
        const __grid_constant__ CUtensorMap tm_c, SbwOrders ord,
        const float* __restrict__ dA, long long as0, long long as1,
        long long as2, const float* __restrict__ h0,
        const float* __restrict__ dh, float* __restrict__ hprev,
        float* __restrict__ Gc, float* __restrict__ dh0,
        float* __restrict__ sc, int S, int H) {
  constexpr int N = 64 * NT, F = N * 64 / 2;   // float2s of a state
  extern __shared__ __align__(1024) unsigned char sbw_smem[];
  unsigned char* xs = sbw_smem;   // 1024-aligned: the swizzle's period
  if (sm90_addr(xs) & 1023) __trap();
  unsigned char* ds = xs + SBW_BOX;
  unsigned char* bs = ds + SBW_BOX;            // [NT][SBW_BOX]; then st_c
  unsigned char* cs = bs + NT * SBW_BOX;       // [NT][SBW_BOX]; then U_c
  float* a2 = reinterpret_cast<float*>(cs + NT * SBW_BOX);   // unread here
  float* ea = a2 + SBW_Q;
  float* wq = ea + SBW_Q;
  float* wsum = wq + SBW_Q;
  uint64_t* full = reinterpret_cast<uint64_t*>(wsum + 4);
  uint64_t* sums = full + 1;   // the nc ranks' sums for chunk c landed
  float* red = reinterpret_cast<float*>(sums + 1);   // [8][SBW_CLUSTER]
  float* recv = red + 8 * SBW_CLUSTER;                // [SBW_CLUSTER]
  float* aLs = recv + SBW_CLUSTER;
  float* sts = reinterpret_cast<float*>(bs);
  float* Us = reinterpret_cast<float*>(cs);
  const int c = blockIdx.x, nc = gridDim.x, bh = blockIdx.y;
  const int bg = bh / H, hh = bh - bg * H, s0 = c * SBW_Q;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int tid = threadIdx.x & 127;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    mbar_init(sums, 1);
    mbar_init_fence();
    mbar_expect_tx(sums, 4 * nc);
    mbar_expect_tx(full, (2 + 2 * NT) * SBW_BOX);
    sw_load(xs, &tm_x, full, ord.x, 0, hh, s0, bg);
    sw_load(ds, &tm_dy, full, ord.dy, 0, hh, s0, bg);
    for (int b = 0; b < NT; ++b) {
      sw_load(bs + b * SBW_BOX, &tm_b, full, ord.bc, 64 * b, 0, s0, bg);
      sw_load(cs + b * SBW_BOX, &tm_c, full, ord.bc, 64 * b, 0, s0, bg);
    }
  }
  if (wg == 0) {
    const float aLv = sbw_cumsum(
        s0 + tid < S ? dA[bg * as0 + hh * as1 + (s0 + tid) * as2] : 0.f, a2,
        ea, wq, wsum, tid);
    if (tid == 0) *aLs = aLv;
  }
  __syncthreads();   // a, ea, wq, a_L; the barrier initialized
  mbar_wait(full, 0);
  // N = 64: group 0 takes st (B's box, x), group 1 U (C's box, dy), one
  // product each; N = 128: both groups st (rows 64 g ..), then both U
  // (B's boxes are dead once both st products are done)
#pragma unroll
  for (int k = 0; k < NT; ++k) {
    const int which = NT == 1 ? wg : k;   // 0: st, 1: U
    const int u = NT == 1 ? 0 : wg;       // the state's rows 64 u ..
    float acc[32];
    sbw_state(acc, (which ? cs : bs) + u * SBW_BOX, which ? ds : xs,
              which ? ea : wq, tid);
    __syncthreads();   // every product reading the boxes below is done
    sbw_store_rows(acc, (which ? Us : sts) + u * 64 * 64, tid);
  }
  cluster_sync();   // every block's st, U, a_L and barriers ready
  if (SBF_CUT & 1) return;

  float d[SBW_CLUSTER], part[SBW_CLUSTER];
#pragma unroll
  for (int k = 0; k < SBW_CLUSTER; ++k) {
    d[k] = k < nc ? expf(ld_cluster_f32(cluster_map(aLs, k))) : 0.f;
    part[k] = 0.f;
  }
  const long long o = (long long)bh * nc * F;   // hprev, Gc [bh] in float2s
  float2* hp2 = reinterpret_cast<float2*>(hprev) + o;
  float2* g2 = reinterpret_cast<float2*>(Gc) + o;
  for (int e = c * F / nc + threadIdx.x; e < (c + 1) * F / nc;
       e += SBW_THREADS) {
    const long long oe = (long long)bh * F + e;
    float2 v[SBW_CLUSTER], u[SBW_CLUSTER], hs[SBW_CLUSTER];
#pragma unroll
    for (int k = 0; k < SBW_CLUSTER; ++k)   // st_k and U_k, one round
      if (k < nc) {
        v[k] = ld_cluster_v2(cluster_map(sts + 2 * e, k));
        u[k] = ld_cluster_v2(cluster_map(Us + 2 * e, k));
      }
    float2 h = make_float2(0.f, 0.f), g = h;
    if (h0) h = make_float2(h0[2 * oe], h0[2 * oe + 1]);
    if (dh) g = make_float2(dh[2 * oe], dh[2 * oe + 1]);
#pragma unroll
    for (int k = 0; k < SBW_CLUSTER; ++k)   // h_k = exp(aL_k) h_{k-1} + st_k
      if (k < nc) {
        hs[k] = h;
        if (!(SBF_CUT & 2)) hp2[k * F + e] = h;
        h.x = d[k] * h.x + v[k].x;
        h.y = d[k] * h.y + v[k].y;
      }
#pragma unroll
    for (int k = SBW_CLUSTER - 1; k >= 0; --k)   // G_{k-1} = U_k + e^aL G_k
      if (k < nc) {
        if (!(SBF_CUT & 2)) g2[k * F + e] = g;
        part[k] += hs[k].x * g.x + hs[k].y * g.y;
        g.x = u[k].x + d[k] * g.x;
        g.y = u[k].y + d[k] * g.y;
      }
    if (!(SBF_CUT & 2)) reinterpret_cast<float2*>(dh0)[oe] = g;
  }
#pragma unroll
  for (int k = 0; k < SBW_CLUSTER; ++k)
    if (k < nc) {
      float p = part[k];
#pragma unroll
      for (int off = 16; off; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0) red[warp * SBW_CLUSTER + k] = p;
    }
  __syncthreads();   // every thread's reads of the cluster's st, U done
  if (threadIdx.x < nc) {   // this block's sum for chunk k, to block k
    const int k = threadIdx.x;
    float t = 0.f;
    for (int w = 0; w < SBW_THREADS / 32; ++w) t += red[w * SBW_CLUSTER + k];
    st_async_f32(cluster_map(recv + c, k), t, cluster_map(sums, k));
  }
  if (threadIdx.x == 0) {
    // every block has sent its sum, so has read this block's st and U:
    // none is read once this block leaves
    mbar_wait<true>(sums, 0);
    float t = 0.f;
    for (int r = 0; r < nc; ++r) t += recv[r];
    sc[(long long)bh * nc + c] = expf(*aLs) * t;
  }
}

// ---------------------------------------------------------------- launch
// Op::run<BF, PT, NT>(args...) for the (bf16, P, N) given; an invalid value
// where no instantiation takes it (P in {16, 32, 64}, N in {16, 32, 64,
// 128}).
template <typename Op, bool BF, int PT, typename... A>
static int sb_dispatch_n(int N, A... args) {
  switch (N) {
    case 16: return Op::template run<BF, PT, 1>(args...);
    case 32: return Op::template run<BF, PT, 2>(args...);
    case 64: return Op::template run<BF, PT, 4>(args...);
    case 128: return Op::template run<BF, PT, 8>(args...);
    default: return (int)cudaErrorInvalidValue;
  }
}
template <typename Op, bool BF, typename... A>
static int sb_dispatch_p(int P, int N, A... args) {
  switch (P) {
    case 16: return sb_dispatch_n<Op, BF, 1>(N, args...);
    case 32: return sb_dispatch_n<Op, BF, 2>(N, args...);
    case 64: return sb_dispatch_n<Op, BF, 4>(N, args...);
    default: return (int)cudaErrorInvalidValue;
  }
}
template <typename Op, typename... A>
static int sb_dispatch(int bf16, int P, int N, A... args) {
  return bf16 ? sb_dispatch_p<Op, true>(P, N, args...)
              : sb_dispatch_p<Op, false>(P, N, args...);
}

struct SbStatesOp {
  template <bool BF, int PT, int NT>
  static int run(const void* x, const void* dA, const void* Bm,
                 const void* Cm, const void* dy, void* st, void* U, void* aL,
                 SbStrides sd, int BH, int S, int H, int Q,
                 cudaStream_t stream) {
    typedef typename SbElem<BF>::T T;
    const int Qp = (Q + 15) / 16 * 16, nc = (S + Q - 1) / Q;
    const int smem = sb_states_smem(BF, 16 * PT, 16 * NT, Qp);
    // the limit set once a device, at the largest chunk's size
    cudaError_t e = smem_attribute_once<ssd_scan_bwd_states_kernel<BF, PT, NT>>(
        sb_states_smem(BF, 16 * PT, 16 * NT, SB_MAXQ));
    if (e != cudaSuccess) return (int)e;
    ssd_scan_bwd_states_kernel<BF, PT, NT>
        <<<dim3(nc, BH), SB_THREADS, smem, stream>>>(
            (const T*)x, (const float*)dA, (const T*)Bm, (const T*)Cm,
            (const T*)dy, (float*)st, (float*)U, (float*)aL, sd, S, H, Q);
    return (int)cudaGetLastError();
  }
};

struct SbGradsOp {
  template <bool BF, int PT, int NT>
  static int run(const void* x, const void* dA, const void* Bm,
                 const void* Cm, const void* dy, const void* hprev,
                 const void* G, const void* sc, void* dx, void* dda,
                 void* dB, void* dC, void* part, void* count, SbStrides sd,
                 int BH, int S, int H, int Q, cudaStream_t stream) {
    typedef typename SbElem<BF>::T T;
    const int Qp = (Q + 15) / 16 * 16, nc = (S + Q - 1) / Q;
    const int smem = sb_grads_smem(BF, 16 * PT, 16 * NT, Qp);
    // the limit set once a device, at the largest chunk's size
    cudaError_t e = smem_attribute_once<ssd_scan_bwd_grads_kernel<BF, PT, NT>>(
        sb_grads_smem(BF, 16 * PT, 16 * NT, SB_MAXQ));
    if (e != cudaSuccess) return (int)e;
    ssd_scan_bwd_grads_kernel<BF, PT, NT>
        <<<dim3(nc, BH), SB_THREADS, smem, stream>>>(
            (const T*)x, (const float*)dA, (const T*)Bm, (const T*)Cm,
            (const T*)dy, (const float*)hprev, (const float*)G,
            (const float*)sc, (T*)dx, (float*)dda, (T*)dB, (T*)dC,
            (float*)part, (int*)count, sd, S, H, Q);
    return (int)cudaGetLastError();
  }
};

// The Hopper kernels' tensor maps: x, dy [G, H, S, 64] (boxes of 128
// rows), dx (64 rows, when given), B, C [G, S, N] (128 rows), over the
// strides of sd.  Returns 0 or a cudaError.
static int sbw_maps(CUtensorMap* mx, CUtensorMap* my, CUtensorMap* mb,
                    CUtensorMap* mc, CUtensorMap* mdx, const void* x,
                    const void* dy, const void* Bm, const void* Cm, void* dx,
                    const SbStrides& sd, int G, int H, int S, int N,
                    SbwOrders* ord) {
  const long long xdim[4] = {64, H, S, G}, bdim[4] = {N, 1, S, G};
  const long long xst[4] = {1, sd.x[1], sd.x[2], sd.x[0]};
  const long long yst[4] = {1, sd.dy[1], sd.dy[2], sd.dy[0]};
  const long long dxst[4] = {1, sd.dx[1], sd.dx[2], sd.dx[0]};
  const long long bst[4] = {1, 0, sd.bc[1], sd.bc[0]};
  int err;
  if ((err = sw_map(mx, x, xdim, xst, SBW_Q, &ord->x)) ||
      (err = sw_map(my, dy, xdim, yst, SBW_Q, &ord->dy)) ||
      (err = sw_map(mb, Bm, bdim, bst, SBW_Q, &ord->bc)) ||
      (err = sw_map(mc, Cm, bdim, bst, SBW_Q, &ord->bc)))
    return err;
  return mdx ? sw_map(mdx, dx, xdim, dxst, 64, &ord->dx) : 0;
}

template <int NT>
static int sbw_states_launch(const void* x, const void* dA, const void* Bm,
                             const void* Cm, const void* dy, void* st,
                             void* U, void* aL, const SbStrides& sd, int BH,
                             int S, int H, cudaStream_t stream) {
  const int nc = (S + SBW_Q - 1) / SBW_Q;
  CUtensorMap mx, my, mb, mc;
  SbwOrders ord = {0, 0, 0, 0};
  const int err = sbw_maps(&mx, &my, &mb, &mc, nullptr, x, dy, Bm, Cm,
                           nullptr, sd, BH / H, H, S, 64 * NT, &ord);
  if (err) return err;
  cudaError_t e = smem_attribute_once<ssd_scan_bwd_states_wgmma_kernel<NT>>(
      sbw_states_smem(NT));
  if (e != cudaSuccess) return (int)e;
  ssd_scan_bwd_states_wgmma_kernel<NT>
      <<<dim3(nc, BH), SBW_THREADS, sbw_states_smem(NT), stream>>>(
          mx, my, mb, mc, ord, (const float*)dA, sd.a[0], sd.a[1], sd.a[2],
          (float*)st, (float*)U, (float*)aL, S, H);
  return (int)cudaGetLastError();
}

// The grads kernel's cluster size for H heads a group and `pairs`
// (group, chunk) clusters: the csz in 1 .. min(H, SBW_CLUSTER) that gives
// the fewest heads a block times waves of clusters (pairs over the
// clusters of csz blocks that fit on the card at once, as
// cudaOccupancyMaxActiveClusters counts them: the GPCs' sizes decide,
// e.g. 30 of 4 blocks where 32 would be one wave), the smaller on a tie.
// The counts are asked once a device.  Returns 0 or a cudaError.
template <int NT>
static int sbw_cluster_size(int H, int pairs, int* csz) {
  static std::atomic<int> fit[64][SBW_CLUSTER + 1];   // 0: not asked yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  long long best = LLONG_MAX;
  *csz = 1;
  for (int c = 1; c <= SBW_CLUSTER && c <= H; ++c) {
    int n = fit[dev & 63][c].load(std::memory_order_relaxed);
    if (n == 0) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(c, 1, 1);
      cfg.blockDim = dim3(SBW_THREADS, 1, 1);
      cfg.dynamicSmemBytes = sbw_grads_smem(NT);
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = c;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      e = cudaOccupancyMaxActiveClusters(
          &n, ssd_scan_bwd_grads_wgmma_kernel<NT>, &cfg);
      if (e != cudaSuccess) return (int)e;
      n = n > 0 ? n : -1;   // -1: no cluster of c blocks fits
      fit[dev & 63][c].store(n, std::memory_order_relaxed);
    }
    if (n < 0) continue;
    const long long cost =
        (long long)((pairs + n - 1) / n) * ((H + c - 1) / c);
    if (cost < best) {
      best = cost;
      *csz = c;
    }
  }
  return 0;
}

template <int NT>
static int sbw_grads_launch(const void* x, const void* dA, const void* Bm,
                            const void* Cm, const void* dy, const void* hprev,
                            const void* G, const void* sc, void* dx,
                            void* dda, void* dB, void* dC,
                            const SbStrides& sd, int BH, int S, int H,
                            cudaStream_t stream) {
  const int Gg = BH / H, nc = (S + SBW_Q - 1) / SBW_Q;
  if ((long long)Gg * nc > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap mx, my, mb, mc, mdx;
  SbwOrders ord = {0, 0, 0, 0};
  int err = sbw_maps(&mx, &my, &mb, &mc, &mdx, x, dy, Bm, Cm, dx, sd, Gg, H,
                     S, 64 * NT, &ord);
  if (err) return err;
  cudaError_t e = smem_attribute_once<ssd_scan_bwd_grads_wgmma_kernel<NT>>(
      sbw_grads_smem(NT));
  if (e != cudaSuccess) return (int)e;
  int csz = 1;
  if ((err = sbw_cluster_size<NT>(H, Gg * nc, &csz))) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csz, Gg * nc, 1);
  cfg.blockDim = dim3(SBW_THREADS, 1, 1);
  cfg.dynamicSmemBytes = sbw_grads_smem(NT);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csz;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, ssd_scan_bwd_grads_wgmma_kernel<NT>, mx, my,
                         mb, mc, mdx, ord, (const float*)dA, sd.a[0], sd.a[1],
                         sd.a[2], (const float*)hprev, (const float*)G,
                         (const float*)sc, (float*)dda, sd.da[0], sd.da[1],
                         sd.da[2], (bf16*)dB, (bf16*)dC, S, H, nc);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The launch configuration of the fused kernel: grid (nc, BH) in clusters
// of nc blocks, its shared memory set once a device.
template <int NT>
static cudaError_t sbw_fused_config(cudaLaunchConfig_t* cfg,
                                    cudaLaunchAttribute* attr, int nc,
                                    int BH, cudaStream_t stream) {
  cudaError_t e =
      smem_attribute_once<ssd_scan_bwd_states_scan_wgmma_kernel<NT>>(
          sbw_fused_smem(NT));
  *cfg = {};
  cfg->gridDim = dim3(nc, BH, 1);
  cfg->blockDim = dim3(SBW_THREADS, 1, 1);
  cfg->dynamicSmemBytes = sbw_fused_smem(NT);
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = nc;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return e;
}

template <int NT>
static int sbw_states_scan_launch(const void* x, const void* dA,
                                  const void* Bm, const void* Cm,
                                  const void* dy, const void* h0,
                                  const void* dh, void* hprev, void* G,
                                  void* dh0, void* sc, const SbStrides& sd,
                                  int BH, int S, int H,
                                  cudaStream_t stream) {
  const int nc = (S + SBW_Q - 1) / SBW_Q;
  if (nc > SBW_CLUSTER) return (int)cudaErrorInvalidValue;
  CUtensorMap mx, my, mb, mc;
  SbwOrders ord = {0, 0, 0, 0};
  const int err = sbw_maps(&mx, &my, &mb, &mc, nullptr, x, dy, Bm, Cm,
                           nullptr, sd, BH / H, H, S, 64 * NT, &ord);
  if (err) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = sbw_fused_config<NT>(&cfg, attr, nc, BH, stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, ssd_scan_bwd_states_scan_wgmma_kernel<NT>, mx,
                         my, mb, mc, ord, (const float*)dA, sd.a[0], sd.a[1],
                         sd.a[2], (const float*)h0, (const float*)dh,
                         (float*)hprev, (float*)G, (float*)dh0, (float*)sc, S,
                         H);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The Hopper kernels take P = 64, N = 64 or 128 and chunks of 128 rows
// (or one chunk, Q = S < 128).
static bool sbw_shape_ok(int P, int N, int S, int Q) {
  return P == 64 && (N == 64 || N == 128) &&
         (Q == SBW_Q || (Q == S && S < SBW_Q));
}

static bool sb_sizes_ok(int BH, int S, int H, int Q) {
  return BH > 0 && BH <= 65535 && S > 0 && H > 0 && BH % H == 0 && Q >= 1 &&
         Q <= SB_MAXQ && Q <= S;
}

// x, dy: [G, H, S, P] by the element strides xs*, ys* (BH = G H rows;
// innermost dense); dA: [G, H, S] fp32 by as*; Bm, Cm: [G, S, N] by bs*
// (innermost dense); one dtype for x, B, C, dy.  kind: 0 float32 (the FMA
// form); bf16 with 16-byte aligned rows: 1 the mma.sync form, 2 the
// Hopper kernel (sbw_shape_ok).  Writes st, U [BH, nc, N, P] and aL
// [BH, nc], float32 (nc = ceil(S / Q), 1 <= Q <= 128).
extern "C" int ssd_scan_bwd_states_launch(
    const void* x, const void* dA, const void* Bm, const void* Cm,
    const void* dy, void* st, void* U, void* aL, int BH, int S, int P, int N,
    int H, int Q, int kind, long long xs0, long long xs1, long long xs2,
    long long as0, long long as1, long long as2, long long ys0, long long ys1,
    long long ys2, long long bs0, long long bs1, void* stream) {
  if (!sb_sizes_ok(BH, S, H, Q)) return (int)cudaErrorInvalidValue;
  const SbStrides sd = {{xs0, xs1, xs2}, {ys0, ys1, ys2}, {0, 0, 0},
                        {as0, as1, as2}, {0, 0, 0}, {bs0, bs1}};
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 2) {
    if (!sbw_shape_ok(P, N, S, Q)) return (int)cudaErrorInvalidValue;
    return N == 64 ? sbw_states_launch<1>(x, dA, Bm, Cm, dy, st, U, aL, sd,
                                          BH, S, H, s)
                   : sbw_states_launch<2>(x, dA, Bm, Cm, dy, st, U, aL, sd,
                                          BH, S, H, s);
  }
  return sb_dispatch<SbStatesOp>(kind, P, N, x, dA, Bm, Cm, dy, st, U, aL,
                                 sd, BH, S, H, Q, s);
}

// The states and scan kernels fused (ssd_scan_bwd_states_scan_wgmma_kernel)
// at the Hopper shapes (sbw_shape_ok) with nc = ceil(S / 128) <= 8:
// inputs as ssd_scan_bwd_states_launch's (bf16), h0 and dh as
// ssd_scan_bwd_scan_launch's.  Writes hprev, G [BH, nc, N, P], dh0
// [BH, N, P] and sc [BH, nc], float32, as that pair of launches.
extern "C" int ssd_scan_bwd_states_scan_launch(
    const void* x, const void* dA, const void* Bm, const void* Cm,
    const void* dy, const void* h0, const void* dh, void* hprev, void* G,
    void* dh0, void* sc, int BH, int S, int P, int N, int H, int Q,
    long long xs0, long long xs1, long long xs2, long long as0,
    long long as1, long long as2, long long ys0, long long ys1,
    long long ys2, long long bs0, long long bs1, void* stream) {
  if (!sb_sizes_ok(BH, S, H, Q) || !sbw_shape_ok(P, N, S, Q))
    return (int)cudaErrorInvalidValue;
  const SbStrides sd = {{xs0, xs1, xs2}, {ys0, ys1, ys2}, {0, 0, 0},
                        {as0, as1, as2}, {0, 0, 0}, {bs0, bs1}};
  cudaStream_t s = (cudaStream_t)stream;
  return N == 64 ? sbw_states_scan_launch<1>(x, dA, Bm, Cm, dy, h0, dh,
                                             hprev, G, dh0, sc, sd, BH, S,
                                             H, s)
                 : sbw_states_scan_launch<2>(x, dA, Bm, Cm, dy, h0, dh,
                                             hprev, G, dh0, sc, sd, BH, S,
                                             H, s);
}

// The clusters of nc blocks of the fused kernel at state size N (64 or
// 128) that fit on the card at once (cudaOccupancyMaxActiveClusters) into
// *n.  Returns 0 or a cudaError.
extern "C" int ssd_scan_bwd_states_scan_clusters(int N, int nc, int* n) {
  if ((N != 64 && N != 128) || nc < 1 || nc > SBW_CLUSTER)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e =
      N == 64 ? sbw_fused_config<1>(&cfg, attr, nc, 1, nullptr)
              : sbw_fused_config<2>(&cfg, attr, nc, 1, nullptr);
  if (e != cudaSuccess) return (int)e;
  e = N == 64 ? cudaOccupancyMaxActiveClusters(
                    n, ssd_scan_bwd_states_scan_wgmma_kernel<1>, &cfg)
              : cudaOccupancyMaxActiveClusters(
                    n, ssd_scan_bwd_states_scan_wgmma_kernel<2>, &cfg);
  return (int)e;
}

template <int EPT>
static int sb_scan_launch(void* st, void* U, const void* aL, const void* h0,
                          const void* dh, void* dh0, void* sc, int BH, int nc,
                          cudaStream_t stream) {
  ssd_scan_bwd_scan_kernel<EPT><<<BH, SB_THREADS, 0, stream>>>(
      (float*)st, (float*)U, (const float*)aL, (const float*)h0,
      (const float*)dh, (float*)dh0, (float*)sc, nc);
  return (int)cudaGetLastError();
}

// st, U: [BH, nc, NP] float32, rewritten in place with h_{c-1} and G_c;
// aL: [BH, nc]; h0, dh: [BH, NP] float32 or NULL (zeros).  Writes dh0
// [BH, NP] and sc [BH, nc], float32.  NP = N P: 256 times 1, 2, 4, 8, 16
// or 32.
extern "C" int ssd_scan_bwd_scan_launch(void* st, void* U, const void* aL,
                                        const void* h0, const void* dh,
                                        void* dh0, void* sc, int BH, int nc,
                                        int NP, void* stream) {
  if (BH <= 0 || nc <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (NP) {
    case 256: return sb_scan_launch<1>(st, U, aL, h0, dh, dh0, sc, BH, nc, s);
    case 512: return sb_scan_launch<2>(st, U, aL, h0, dh, dh0, sc, BH, nc, s);
    case 1024: return sb_scan_launch<4>(st, U, aL, h0, dh, dh0, sc, BH, nc, s);
    case 2048: return sb_scan_launch<8>(st, U, aL, h0, dh, dh0, sc, BH, nc, s);
    case 4096: return sb_scan_launch<16>(st, U, aL, h0, dh, dh0, sc, BH, nc, s);
    case 8192: return sb_scan_launch<32>(st, U, aL, h0, dh, dh0, sc, BH, nc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Inputs as ssd_scan_bwd_states_launch's (kind likewise), with hprev, G
// [BH, nc, N, P] and sc [BH, nc] from ssd_scan_bwd_scan_launch.  Writes dx
// in x's type by the element strides dxs* (innermost dense, rows of an
// even count of elements; kind 2: 16-byte aligned), dda float32 by das*,
// dB and dC in x's type, [G, S, N] contiguous; part: float32 scratch
// [2, BH, S, N] and count: int [G nc], zeros, for kinds 0 and 1 (kind 2
// sums the heads on chip and takes NULL).
extern "C" int ssd_scan_bwd_grads_launch(
    const void* x, const void* dA, const void* Bm, const void* Cm,
    const void* dy, const void* hprev, const void* G, const void* sc,
    void* dx, void* dda, void* dB, void* dC, void* part, void* count, int BH,
    int S, int P, int N, int H, int Q, int kind, long long xs0, long long xs1,
    long long xs2, long long as0, long long as1, long long as2, long long ys0,
    long long ys1, long long ys2, long long dxs0, long long dxs1,
    long long dxs2, long long das0, long long das1, long long das2,
    long long bs0, long long bs1, void* stream) {
  if (!sb_sizes_ok(BH, S, H, Q)) return (int)cudaErrorInvalidValue;
  const SbStrides sd = {{xs0, xs1, xs2},    {ys0, ys1, ys2},
                        {dxs0, dxs1, dxs2}, {as0, as1, as2},
                        {das0, das1, das2}, {bs0, bs1}};
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 2) {
    if (!sbw_shape_ok(P, N, S, Q)) return (int)cudaErrorInvalidValue;
    return N == 64 ? sbw_grads_launch<1>(x, dA, Bm, Cm, dy, hprev, G, sc, dx,
                                         dda, dB, dC, sd, BH, S, H, s)
                   : sbw_grads_launch<2>(x, dA, Bm, Cm, dy, hprev, G, sc, dx,
                                         dda, dB, dC, sd, BH, S, H, s);
  }
  return sb_dispatch<SbGradsOp>(kind, P, N, x, dA, Bm, Cm, dy, hprev, G, sc,
                                dx, dda, dB, dC, part, count, sd, BH, S, H, Q,
                                s);
}

#if SBW_CLOCKS
// The marks of the last grads launch (2 x SBW_HEADS x SBW_MARKS long
// longs) into dst (host memory); the cluster size the N = 64 NT kernel
// takes for H heads and `pairs` clusters into *csz.
extern "C" int sbw_clocks_read(void* dst, int NT, int H, int pairs,
                               int* csz) {
  cudaError_t e = cudaMemcpyFromSymbol(dst, sbw_clock, sizeof(sbw_clock));
  if (e != cudaSuccess) return (int)e;
  return NT == 1 ? sbw_cluster_size<1>(H, pairs, csz)
                 : sbw_cluster_size<2>(H, pairs, csz);
}
#endif
