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
//   the same bits: no float atomics anywhere.
//
// What bounds it on the H100: bytes.  At zamba2-2.7b's training shape
// (B = 4, S = 1,024, H = 80, P = N = 64, chunks of 128, bf16) the gradient
// must read x, dy, dA, B, C (and h0, dh) and write dx, dA, dB, dC: 130 MB,
// 39 us at 3.35 TB/s; its products (the five Q x Q halves under the
// diagonal and five state products) are about 27 GFLOP, 27 us at the
// 989 TFLOP/s bf16 tensor rate, 400 us on the fp32 FMA units.
//
// What the design does about it: this is the first, simple form, right
// before fast.  The products run on the tensor cores (mma.sync m16n8k16,
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
// shape, some 0.2 ms: the price of the simple form, for a Hopper redesign
// to remove.  The float32 form (float tiles, each product by fmaf in the
// same fragment layout, a register operand passed through a 16 x 17 tile
// of the warp's, h and G read from device memory: no room for them in
// shared memory at N = 128) keeps full fp32 products, which the float32
// checks (1e-3) rely on.
#include <cuda_runtime.h>

#include "mma.cuh"
#include "sm90.cuh"   // smem_attribute_once

#define SB_THREADS 256
#define SB_WARPS 8
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

static bool sb_sizes_ok(int BH, int S, int H, int Q) {
  return BH > 0 && BH <= 65535 && S > 0 && H > 0 && BH % H == 0 && Q >= 1 &&
         Q <= SB_MAXQ && Q <= S;
}

// x, dy: [G, H, S, P] by the element strides xs*, ys* (BH = G H rows;
// innermost dense); dA: [G, H, S] fp32 by as*; Bm, Cm: [G, S, N] by bs*
// (innermost dense); one dtype for x, B, C, dy: bf16 (bf16 = 1, rows
// 16-byte aligned) or float32.  Writes st, U [BH, nc, N, P] and aL
// [BH, nc], float32 (nc = ceil(S / Q), 1 <= Q <= 128).
extern "C" int ssd_scan_bwd_states_launch(
    const void* x, const void* dA, const void* Bm, const void* Cm,
    const void* dy, void* st, void* U, void* aL, int BH, int S, int P, int N,
    int H, int Q, int bf16, long long xs0, long long xs1, long long xs2,
    long long as0, long long as1, long long as2, long long ys0, long long ys1,
    long long ys2, long long bs0, long long bs1, void* stream) {
  if (!sb_sizes_ok(BH, S, H, Q)) return (int)cudaErrorInvalidValue;
  const SbStrides sd = {{xs0, xs1, xs2}, {ys0, ys1, ys2}, {0, 0, 0},
                        {as0, as1, as2}, {0, 0, 0}, {bs0, bs1}};
  return sb_dispatch<SbStatesOp>(bf16, P, N, x, dA, Bm, Cm, dy, st, U, aL,
                                 sd, BH, S, H, Q, (cudaStream_t)stream);
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

// Inputs as ssd_scan_bwd_states_launch's, with hprev, G [BH, nc, N, P] and
// sc [BH, nc] from ssd_scan_bwd_scan_launch.  Writes dx in x's type by the
// element strides dxs* (innermost dense, rows of an even count of
// elements), dda float32 by das*, dB and dC in x's type, [G, S, N]
// contiguous; part: float32 scratch [2, BH, S, N]; count: int [G nc],
// zeros.
extern "C" int ssd_scan_bwd_grads_launch(
    const void* x, const void* dA, const void* Bm, const void* Cm,
    const void* dy, const void* hprev, const void* G, const void* sc,
    void* dx, void* dda, void* dB, void* dC, void* part, void* count, int BH,
    int S, int P, int N, int H, int Q, int bf16, long long xs0, long long xs1,
    long long xs2, long long as0, long long as1, long long as2, long long ys0,
    long long ys1, long long ys2, long long dxs0, long long dxs1,
    long long dxs2, long long das0, long long das1, long long das2,
    long long bs0, long long bs1, void* stream) {
  if (!sb_sizes_ok(BH, S, H, Q)) return (int)cudaErrorInvalidValue;
  const SbStrides sd = {{xs0, xs1, xs2},    {ys0, ys1, ys2},
                        {dxs0, dxs1, dxs2}, {as0, as1, as2},
                        {das0, das1, das2}, {bs0, bs1}};
  return sb_dispatch<SbGradsOp>(bf16, P, N, x, dA, Bm, Cm, dy, hprev, G, sc,
                                dx, dda, dB, dC, part, count, sd, BH, S, H, Q,
                                (cudaStream_t)stream);
}
