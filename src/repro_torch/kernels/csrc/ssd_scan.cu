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
// GFLOP, 11 us at the 989 TFLOP/s bf16 tensor rate, but 160 us on the fp32
// FMA units (67 TFLOP/s), so they must run on the tensor cores.
//
// What the design does about it: one block per batch*head walks the
// chunks in order (the Pallas grid's sequential chunk axis) with the state
// h [N, P] on chip for the whole sequence, so x, B and C are read once and
// y written once.  x, dA and y are read and written through the (group,
// head, position) element strides the wrapper passes, so the model's
// [B, S, H, P] layout needs no copy; B and C (rows of the group bh / H,
// shared by its H heads) through (group, position) strides.  Ragged S is masked in-kernel (x = dA = B = C
// = 0 past the end, which leaves the state as it is, as the reference's
// zero padding does).  h0 may be NULL (zero initial state).  Three
// kernels, chosen in the open by the wrapper's table (kernels/ssd_scan.py
// ssd_kernel; no fallback between them): bf16 at P = 64 with N = 64 or 128
// in chunks of 128 rows takes ssd_scan_wgmma_kernel (the last section of
// this file: the chunks in parallel, a cluster a batch*head), the other
// bf16 shapes ssd_scan_mma_kernel, float32 ssd_scan_fma_kernel:
//
// * bf16, ssd_scan_mma_kernel: 8 warps; all four products on mma.sync
//   m16n8k16 (bf16 operands, fp32 sums), operands by ldmatrix from bf16
//   shared memory whose 16-byte chunks are XOR-swizzled by row, so every
//   ldmatrix is free of bank conflicts.  The next chunk's x, B and dA
//   arrive by cp.async into the other stage of a two-stage ring while this
//   chunk computes; C, read only by the y phase, has one stage and its
//   next chunk arrives during the state product.  Warp w owns rows 16w..
//   of the chunk: it holds C's A fragments, computes C h scaled by exp(cs)
//   into its y accumulator, then walks the 16-column blocks at or below
//   the diagonal: C B^T on the tensor cores (exact bf16 inputs), times L
//   built in fp32 registers on the accumulator fragment, fed back as the A
//   fragment of the product with x without leaving registers.  Every
//   operand that is not a bf16 input -- that product (C B^T .* L), the
//   state h in C h, and exp(cs_Q - cs) .* B in the state product -- is
//   split into bf16 hi + lo parts and multiplied twice, so it keeps about
//   16 bits of mantissa: one bf16 rounding of those operands put y up to
//   0.5 from the plain version on the model's own activations, past the
//   2e-2 gate.  The master state stays in fp32 registers of the warp that
//   updates it.  P in {16, 32, 64}, N in {16, 32, 64, 128}; a chunk is
//   padded to a multiple of 16 rows with zeros.  Shared memory is
//   4 Qp (P + N) + 2 Qp N + 16 Qp + 4 N P bytes (Qp = Q rounded up to 16):
//   100,352 at Q = 128, N = P = 64, so two blocks fit on an SM; 165,888 at
//   mamba2-130m's N = 128.
// * float32, ssd_scan_fma_kernel: shared-memory tile products by fmaf, each
//   of 256 threads owning a 4 x 4 block in registers; the decay-weighted
//   scores sit beside C (scaled by exp(cs)) in one row so that
//   y = [M | C'] [x ; h] is a single product over Q + N, whose causal half
//   above the diagonal is skipped.  Those rows are formed and consumed one
//   strip of Qs = min(Q, 64) rows (the tile height) at a time, so a chunk
//   of Q = 128 rows fits at N = 128: shared memory is 4 (Qs (Q + N + 1) +
//   Q (N + 1) + (Q + N) P + Q) bytes, 132,352 at zamba2's N = P = 64 and
//   197,888 at mamba2-130m's N = 128, P = 64 (a whole chunk of [M | C]
//   would need 263,680, past the 232,448 a block may use).  All arithmetic
//   fp32, which the float32 checks (1e-3) rely on.
#include <cuda_runtime.h>

#include <climits>

#include "mma.cuh"
#include "sm90.cuh"

// Element strides: x and y by (group, head, position), dA likewise, B and C
// by (group, position); the innermost dimension of x, y, B, C is dense.
struct SsdStrides {
  long long x[3], a[3], y[3], bc[2];
};

#define SSD_THREADS 256

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

// ---------------------------------------------------------------- float32
// Rows of [M | C] staged at a time: the tile height of tile_mma.
#define SSD_STRIP 64

// x, y: element (g, h, s, p) at [g sd.x[0] + h sd.x[1] + s sd.x[2] + p]
// (row bh = g H + h; y likewise with sd.y); dA: (g, h, s) at sd.a; Bm, Cm:
// (g, s, n) at [g sd.bc[0] + s sd.bc[1] + n]; h0: [BH, N, P] or NULL.
// Writes y and h: [BH, N, P].  grid BH, SSD_THREADS threads; Q rows per
// chunk.  The [M | C] rows of a chunk are formed and consumed one strip of
// SSD_STRIP rows at a time: a strip's y rows need M's columns at or below
// the strip's last row only, and its own rows of C.
__global__ void __launch_bounds__(SSD_THREADS)
    ssd_scan_fma_kernel(const float* __restrict__ x,
                        const float* __restrict__ dA,
                        const float* __restrict__ Bm,
                        const float* __restrict__ Cm,
                        const float* __restrict__ h0, float* __restrict__ y,
                        float* __restrict__ h_out, SsdStrides sd, int S,
                        int P, int N, int H, int Q) {
  const int LDA = Q + N + 1;   // row of [M | C]: Q scores, then N of C
  const int LDB = N + 1;
  const int QS = Q < SSD_STRIP ? Q : SSD_STRIP;
  extern __shared__ float smem[];
  float* As = smem;             // [QS][LDA]: one strip of [M | C]
  float* Bs = As + QS * LDA;    // [Q][LDB]
  float* Xs = Bs + Q * LDB;     // [Q + N][P]: x rows, then h rows
  float* Hs = Xs + Q * P;       // h [N][P]
  float* cs = Xs + (Q + N) * P; // [Q]

  const int bh = blockIdx.x;
  const int bg = bh / H, hh = bh - (bh / H) * H;
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const float* xb = x + bg * sd.x[0] + hh * sd.x[1];
  float* yb = y + bg * sd.y[0] + hh * sd.y[1];
  const float* ab = dA + bg * sd.a[0] + hh * sd.a[1];
  const float* bb = Bm + bg * sd.bc[0];
  const float* cb = Cm + bg * sd.bc[0];

  for (int i = tid; i < N * P; i += SSD_THREADS)
    Hs[i] = h0 ? h0[(long long)bh * N * P + i] : 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    // ---- load the chunk's x, B and dA (rows past S: zero) ----
    for (int i = tid; i < Q * P; i += SSD_THREADS) {
      const int s = c0 + i / P;
      Xs[i] = s < S ? xb[s * sd.x[2] + i % P] : 0.f;
    }
    for (int i = tid; i < Q * N; i += SSD_THREADS) {
      const int r = i / N, n = i - (i / N) * N;
      Bs[r * LDB + n] = c0 + r < S ? bb[(c0 + r) * sd.bc[1] + n] : 0.f;
    }
    for (int r = tid; r < Q; r += SSD_THREADS)
      cs[r] = c0 + r < S ? ab[(c0 + r) * sd.a[2]] : 0.f;
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

    // ---- y, one strip of rows m0 .. m0 + R - 1 at a time ----
    for (int m0 = 0; m0 < Q; m0 += SSD_STRIP) {
      const int R = Q - m0 < SSD_STRIP ? Q - m0 : SSD_STRIP;
      const int kd = m0 + R;   // M is lower triangular: columns < kd
      for (int i = tid; i < R * N; i += SSD_THREADS) {
        const int r = i / N, n = i - (i / N) * N;
        const int s = c0 + m0 + r;
        As[r * LDA + Q + n] = s < S ? cb[s * sd.bc[1] + n] : 0.f;
      }
      __syncthreads();
      // M = (C B^T) .* L into As[:, :kd]
      for (int n0 = 0; n0 < kd; n0 += 64) {
        float acc[4][4];
        zero_tile(acc);
        tile_mma(acc, As + Q, LDA, 1, R, Bs, 1, LDB, Q, 0, n0, 0, N);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int rl = ty * 4 + i, c = n0 + tx + 16 * j, r = m0 + rl;
            if (rl < R && c < kd)
              As[rl * LDA + c] =
                  c <= r ? acc[i][j] * expf(cs[r] - cs[c]) : 0.f;
          }
      }
      __syncthreads();
      // C' = exp(cs) .* C, in place
      for (int i = tid; i < R * N; i += SSD_THREADS) {
        const int r = i / N, n = i - (i / N) * N;
        As[r * LDA + Q + n] *= expf(cs[m0 + r]);
      }
      __syncthreads();
      // y = M x + C' h = [M | C'] [x ; h]
      for (int n0 = 0; n0 < P; n0 += 64) {
        float acc[4][4];
        zero_tile(acc);
        tile_mma(acc, As, LDA, 1, R, Xs, P, 1, P, 0, n0, 0, kd);
        tile_mma(acc, As, LDA, 1, R, Xs, P, 1, P, 0, n0, Q, Q + N);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int rl = ty * 4 + i, c = n0 + tx + 16 * j;
            if (rl < R && c < P && c0 + m0 + rl < S)
              yb[(c0 + m0 + rl) * sd.y[2] + c] = acc[i][j];
          }
      }
      __syncthreads();
    }
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

// ------------------------------------------------------------------- bf16
#define SSD_WARPS 8
#define SSD_LOG2E 1.4426950408889634f
// SSD_CUT is 0 in the port.  Only timing builds set it (by -D, in
// scripts/kernel_variants.py), each bit cutting a phase out of the chunk
// loop, so their outputs are wrong by design: 1 the state product, 2 C B^T
// and its product with x, 4 the whole y phase.
#ifndef SSD_CUT
#define SSD_CUT 0
#endif

// Index of 16-byte chunk c of row r of a tile with CH chunks a row, XOR-
// swizzled so that any eight consecutive rows (one ldmatrix matrix) fall
// on eight different 16-byte bank groups.
template <int CH>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (CH >= 8)
    return c ^ (r & 7);
  else
    return c ^ ((r / (8 / CH)) & (CH - 1));
}

// Address of element (r, 8c) of a swizzled bf16 tile with CH chunks a row.
template <int CH, typename E>
__device__ __forceinline__ E* tile_at(E* base, int r, int c) {
  return base + r * (CH * 8) + swz<CH>(r, c) * 8;
}

// The operand copy of the state, bf16 hi + lo: unit u = warp + SSD_WARPS i
// of the master state hr (see ssd_scan_mma_kernel) into Hs [N][P] (hi) and
// Hs + N P (lo), swizzled.
template <int PT, int NT, int UPW>
__device__ __forceinline__ void store_state_operand(
    bf16* Hs, const float (&hr)[UPW][2][4], int warp, int g, int t4) {
#pragma unroll
  for (int i = 0; i < UPW; ++i) {
    const int u = warp + SSD_WARPS * i;
    if (u >= NT * PT) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = 16 * (u / PT) + g + 8 * r;
        const int off =
            tile_at<2 * PT>(Hs, n, 2 * (u % PT) + j) + 2 * t4 - Hs;
        split_bf16(hr[i][j][2 * r], hr[i][j][2 * r + 1],
                   *reinterpret_cast<uint32_t*>(Hs + off),
                   *reinterpret_cast<uint32_t*>(Hs + NT * PT * 256 + off));
      }
  }
}

// (x0 w0, x1 w1) of a bf16 pair, split into bf16 hi + lo pairs.
__device__ __forceinline__ void scale_split(uint32_t v, float w0, float w1,
                                            uint32_t& hi, uint32_t& lo) {
  split_bf16(bf16_lo(v) * w0, bf16_hi(v) * w1, hi, lo);
}

// Shared memory of one block of ssd_scan_mma_kernel, in bytes: x and B in
// two stages, C in one, dA in two, cs and wq, the state operand hi + lo.
static int ssd_mma_smem_bytes(int P, int N, int Q) {
  const int Qp = (Q + 15) / 16 * 16;
  return 4 * Qp * (P + N) + 2 * Qp * N + 16 * Qp + 4 * N * P;
}

// As ssd_scan_fma_kernel, bf16 x/B/C/y; P = 16 PT, N = 16 NT.  grid BH,
// 32 SSD_WARPS threads.
template <int PT, int NT>
__global__ void __launch_bounds__(32 * SSD_WARPS, NT <= 4 ? 2 : 1)
    ssd_scan_mma_kernel(const bf16* __restrict__ x,
                        const float* __restrict__ dA,
                        const bf16* __restrict__ Bm,
                        const bf16* __restrict__ Cm,
                        const float* __restrict__ h0, bf16* __restrict__ y,
                        float* __restrict__ h_out, SsdStrides sd, int S,
                        int H, int Q) {
  constexpr int P = 16 * PT, N = 16 * NT;
  constexpr int CP = 2 * PT, CN = 2 * NT;      // 16-byte chunks of a row
  constexpr int NTHR = 32 * SSD_WARPS;
  constexpr int U = NT * PT;                   // 16 x 16 tiles of h
  constexpr int UPW = (U + SSD_WARPS - 1) / SSD_WARPS;
  const int Qp = (Q + 15) / 16 * 16;
  const int RT = Qp / 16;                      // row tiles of a chunk

  extern __shared__ __align__(16) unsigned char ssd_smem[];
  bf16* stage_base = reinterpret_cast<bf16*>(ssd_smem);
  const int stage_elems = Qp * (P + N);        // x, B of one stage
  bf16* ct = stage_base + 2 * stage_elems;     // C [Qp][N], one stage
  float* dAs = reinterpret_cast<float*>(ct + Qp * N);   // [2][Qp]
  float* cs2 = dAs + 2 * Qp;                   // cumsum(dA) * log2(e)
  float* wq = cs2 + Qp;                        // exp(cs_Q - cs)
  bf16* Hs = reinterpret_cast<bf16*>(wq + Qp); // state operand, hi and lo
  auto Xs = [&](int st) { return stage_base + st * stage_elems; };
  auto Bs = [&](int st) { return stage_base + st * stage_elems + Qp * P; };

  const int bh = blockIdx.x;
  const int bg = bh / H, hh = bh - (bh / H) * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* xb = x + bg * sd.x[0] + hh * sd.x[1];
  bf16* yb = y + bg * sd.y[0] + hh * sd.y[1];
  const float* ab = dA + bg * sd.a[0] + hh * sd.a[1];
  const bf16* bb = Bm + bg * sd.bc[0];
  const bf16* cb = Cm + bg * sd.bc[0];

  // x, B and dA of the chunk at c0 into stage st; rows past S: zeros
  auto load_xb = [&](int c0, int st) {
    const int qv = min(Q, S - c0);             // rows of this chunk
    bf16* xd = Xs(st);
    bf16* bd = Bs(st);
    for (int i = tid; i < Qp * CP; i += NTHR) {
      const int r = i / CP, c = i - (i / CP) * CP;
      const bool in = r < qv;
      cp_async16(tile_at<CP>(xd, r, c),
                 xb + (c0 + (in ? r : 0)) * sd.x[2] + c * 8, in);
    }
    for (int i = tid; i < Qp * CN; i += NTHR) {
      const int r = i / CN, c = i - (i / CN) * CN;
      const bool in = r < qv;
      cp_async16(tile_at<CN>(bd, r, c),
                 bb + (c0 + (in ? r : 0)) * sd.bc[1] + c * 8, in);
    }
    for (int r = tid; r < Qp; r += NTHR) {
      const bool in = r < qv;
      cp_async4(dAs + st * Qp + r, ab + (c0 + (in ? r : 0)) * sd.a[2], in);
    }
  };
  // C of the chunk at c0 (one stage: loaded once the y phase is done)
  auto load_c = [&](int c0) {
    const int qv = min(Q, S - c0);
    for (int i = tid; i < Qp * CN; i += NTHR) {
      const int r = i / CN, c = i - (i / CN) * CN;
      const bool in = r < qv;
      cp_async16(tile_at<CN>(ct, r, c),
                 cb + (c0 + (in ? r : 0)) * sd.bc[1] + c * 8, in);
    }
  };

  // the master state: unit u = warp + 8 i is the 16 x 16 tile (rows 16
  // (u / PT) of N, cols 16 (u % PT) of P), held as two C fragments
  float hr[UPW][2][4];
#pragma unroll
  for (int i = 0; i < UPW; ++i) {
    const int u = warp + SSD_WARPS * i;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 16 * (u / PT) + g + 8 * (e >> 1);
        const int p = 16 * (u % PT) + 8 * j + 2 * t4 + (e & 1);
        hr[i][j][e] = (u < U && h0) ? h0[((long long)bh * N + n) * P + p]
                                    : 0.f;
      }
  }
  store_state_operand<PT, NT, UPW>(Hs, hr, warp, g, t4);

  // cp.async groups, in commit order: x/B/dA of chunk 0, C of chunk 0,
  // then per chunk c: x/B/dA of c + 1 (top), C of c + 1 (after the y
  // phase); possibly empty, so that "all but the newest" is always chunk c
  load_xb(0, 0);
  cp_async_commit();
  load_c(0);
  cp_async_commit();
  for (int ci = 0, c0 = 0; c0 < S; ++ci, c0 += Q) {
    const int st = ci & 1;
    if (c0 + Q < S) load_xb(c0 + Q, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this chunk landed for this thread
    __syncthreads();     // ... and for every thread; Hs written

    // ---- cs = cumsum(dA) over the chunk, by warp 0 ----
    if (warp == 0) {
      const float* a = dAs + st * Qp;
      const int per = (Qp + 31) / 32, beg = lane * per;
      float run = 0.f;
      for (int t = 0; t < per; ++t)
        if (beg + t < Qp) {
          run += a[beg + t];
          cs2[beg + t] = run;
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
        if (beg + t < Qp) cs2[beg + t] += excl;
      __syncwarp();
      const float last = cs2[Qp - 1];   // padded rows add dA = 0
      __syncwarp();
      for (int t = 0; t < per; ++t)
        if (beg + t < Qp) {
          const float c = cs2[beg + t];
          wq[beg + t] = expf(last - c);
          cs2[beg + t] = c * SSD_LOG2E;
        }
    }
    __syncthreads();

    const bf16* xs = Xs(st);
    const bf16* bs = Bs(st);
    const int qv = min(Q, S - c0);

    // ---- y for the row tiles of this warp ----
    for (int rt = warp; rt < (SSD_CUT & 4 ? 0 : RT); rt += SSD_WARPS) {
      const int r0 = 16 * rt;
      uint32_t cf[NT][4];                      // C rows r0.., A fragments
#pragma unroll
      for (int kn = 0; kn < NT; ++kn)
        ldsm_x4(cf[kn], tile_at<CN>(ct,
                                    r0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                    2 * kn + (lane >> 4)));
      float acc[2 * PT][4];
#pragma unroll
      for (int j = 0; j < 2 * PT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      // C h, from the hi + lo copies of the state (rows n are the k of B)
#pragma unroll
      for (int kn = 0; kn < NT; ++kn)
#pragma unroll
        for (int pn = 0; pn < PT; ++pn) {
          const int off = tile_at<CP>(Hs, kn * 16 + (lane & 7) +
                                              ((lane >> 3) & 1) * 8,
                                      2 * pn + (lane >> 4)) - Hs;
          uint32_t bhi[4], blo[4];
          ldsm_x4_t(bhi, Hs + off);
          ldsm_x4_t(blo, Hs + N * P + off);
          mma_bf16(acc[2 * pn], cf[kn], bhi[0], bhi[1]);
          mma_bf16(acc[2 * pn], cf[kn], blo[0], blo[1]);
          mma_bf16(acc[2 * pn + 1], cf[kn], bhi[2], bhi[3]);
          mma_bf16(acc[2 * pn + 1], cf[kn], blo[2], blo[3]);
        }
      const float la = cs2[r0 + g], lb = cs2[r0 + g + 8];
      const float ea = exp2f(la), eb = exp2f(lb);
#pragma unroll
      for (int j = 0; j < 2 * PT; ++j) {
        acc[j][0] *= ea;
        acc[j][1] *= ea;
        acc[j][2] *= eb;
        acc[j][3] *= eb;
      }
      // (C B^T .* L) x over the 16-column blocks kk <= rt
      for (int kk = 0; kk <= (SSD_CUT & 2 ? -1 : rt); ++kk) {
        float sc[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
        for (int kn = 0; kn < NT; ++kn) {
          uint32_t bfr[4];   // B rows (positions) are the columns of C B^T
          ldsm_x4(bfr, tile_at<CN>(bs,
                                   kk * 16 + (lane & 7) + (lane >> 4) * 8,
                                   2 * kn + ((lane >> 3) & 1)));
          mma_bf16(sc[0], cf[kn], bfr[0], bfr[1]);
          mma_bf16(sc[1], cf[kn], bfr[2], bfr[3]);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = kk * 16 + 8 * j + 2 * t4 + (e & 1);
            const int row = r0 + g + 8 * (e >> 1);
            sc[j][e] = col <= row
                ? sc[j][e] * exp2f((e >> 1 ? lb : la) - cs2[col]) : 0.f;
          }
        uint32_t pa[4], pl[4];   // (C B^T .* L) as bf16 hi + lo
        split_bf16(sc[0][0], sc[0][1], pa[0], pl[0]);
        split_bf16(sc[0][2], sc[0][3], pa[1], pl[1]);
        split_bf16(sc[1][0], sc[1][1], pa[2], pl[2]);
        split_bf16(sc[1][2], sc[1][3], pa[3], pl[3]);
#pragma unroll
        for (int pn = 0; pn < PT; ++pn) {
          uint32_t bfr[4];   // x rows (positions) are the k of B
          ldsm_x4_t(bfr, tile_at<CP>(xs,
                                     kk * 16 + (lane & 7) +
                                         ((lane >> 3) & 1) * 8,
                                     2 * pn + (lane >> 4)));
          mma_bf16(acc[2 * pn], pa, bfr[0], bfr[1]);
          mma_bf16(acc[2 * pn], pl, bfr[0], bfr[1]);
          mma_bf16(acc[2 * pn + 1], pa, bfr[2], bfr[3]);
          mma_bf16(acc[2 * pn + 1], pl, bfr[2], bfr[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + g + 8 * r;
        if (row >= qv) continue;
        bf16* yrow = yb + (c0 + row) * sd.y[2] + 2 * t4;
#pragma unroll
        for (int j = 0; j < 2 * PT; ++j)
          *reinterpret_cast<uint32_t*>(yrow + 8 * j) =
              pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
      }
    }

    __syncthreads();     // every warp is done with C: load the next one
    if (c0 + Q < S) load_c(c0 + Q);
    cp_async_commit();

    // ---- h' = exp(cs_Q) h + (wq .* B)^T x, wq .* B as bf16 hi + lo ----
    float a4[UPW][2][4];
#pragma unroll
    for (int i = 0; i < UPW; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) a4[i][j][e] = 0.f;
    for (int kq = 0; kq < (SSD_CUT & 1 ? 0 : RT); ++kq) {
      const int q = kq * 16 + 2 * t4;
      const float w0 = wq[q], w1 = wq[q + 1], w8 = wq[q + 8],
                  w9 = wq[q + 9];
#pragma unroll
      for (int i = 0; i < UPW; ++i) {
        const int u = warp + SSD_WARPS * i;
        if (u >= U) continue;
        const int mt = u / PT, pn = u % PT;
        uint32_t a[4], hi[4], lo[4], bfr[4];
        // B^T: rows n, k = positions (transpose of B's rows)
        ldsm_x4_t(a, tile_at<CN>(bs,
                                 kq * 16 + (lane & 7) + (lane >> 4) * 8,
                                 2 * mt + ((lane >> 3) & 1)));
        scale_split(a[0], w0, w1, hi[0], lo[0]);
        scale_split(a[1], w0, w1, hi[1], lo[1]);
        scale_split(a[2], w8, w9, hi[2], lo[2]);
        scale_split(a[3], w8, w9, hi[3], lo[3]);
        ldsm_x4_t(bfr, tile_at<CP>(xs,
                                   kq * 16 + (lane & 7) +
                                       ((lane >> 3) & 1) * 8,
                                   2 * pn + (lane >> 4)));
        mma_bf16(a4[i][0], hi, bfr[0], bfr[1]);
        mma_bf16(a4[i][0], lo, bfr[0], bfr[1]);
        mma_bf16(a4[i][1], hi, bfr[2], bfr[3]);
        mma_bf16(a4[i][1], lo, bfr[2], bfr[3]);
      }
    }
    const float dq = exp2f(cs2[Qp - 1]);
    __syncthreads();   // every warp is done with Hs and this stage
#pragma unroll
    for (int i = 0; i < UPW; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hr[i][j][e] = dq * hr[i][j][e] + a4[i][j][e];
    store_state_operand<PT, NT, UPW>(Hs, hr, warp, g, t4);
  }

#pragma unroll
  for (int i = 0; i < UPW; ++i) {
    const int u = warp + SSD_WARPS * i;
    if (u >= U) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 16 * (u / PT) + g + 8 * (e >> 1);
        const int p = 16 * (u % PT) + 8 * j + 2 * t4 + (e & 1);
        h_out[((long long)bh * N + n) * P + p] = hr[i][j][e];
      }
  }
}

// ======================================= bf16 on Hopper (P = 64, N = 64, 128)
// ssd_scan_wgmma_kernel: the function of ssd_scan_mma_kernel (the same
// strides, ragged tail, h0 and outputs) at the shapes of the full configs:
// P = 64 with N = 64 (zamba2-2.7b) and N = 128 (mamba2-130m), in chunks of
// SW_Q = 128 rows (a single chunk of S < 128 rows is the same chunk with
// zero rows after S).
//
// What held the mma.sync kernel to 14% of its byte bound: one block a
// batch*head walking its chunks in order (320 blocks on 132 SMs at
// zamba2's shape, two rounds where 1.21 would do; 96 at mamba2's, one an
// SM, 36 SMs idle), and inside a block a chunk bound by latency: one warp
// taking the cumsum while seven wait, three block barriers a chunk, the
// causal triangle split 8 : 1 between warps.
//
// What the design does about it: the chunks run in parallel.  A block
// takes one (batch*head, chunk); the nc chunks of a batch*head form a
// thread block cluster of csz = min(nc, 8) blocks, block r taking chunk
// t csz + r in round t (nc > 8: rounds, the cluster synced between them).
// A chunk's block computes from its own data y_diag = (C B^T .* L) x and
// its map h -> a h + s (s = B^T (exp(cs_Q - cs) .* x), a = exp(cs_Q)).
// The states entering the chunks travel between the blocks through
// distributed shared memory (st.async into the receiver's shared memory,
// counted on its mbarrier); only y_off = exp(cs) .* (C h_j) waits for
// them, and the last chunk's block writes h.  Nothing but x, dA, B, C, y
// and h crosses device memory, and every sum is taken in a fixed order:
// the same bits every run.  The SM-to-SM stores move ~40 GB/s an SM, so a
// 16 or 32 KB state costs ~1 us a step, and how the states travel is set
// by N:
// * N = 64: an exclusive scan of the chunk maps over the cluster in
//   log2(8) = 3 steps (measured faster here than a chain of 7 hops).
// * N = 128: a chain, block to block, each warp group passing on its half
//   of the state; one receive buffer leaves two blocks an SM (the scan's
//   three 32 KB buffers allowed one), which measured faster.
//
// 256 threads, two warp groups; group c owns rows 64 c .. 64 c + 63 of
// the chunk.  Thread 0 brings x [128 x 64], B and C [128 x N] by TMA
// (rank-4 maps over the strided views, dimensions ordered by stride, so
// rows past S read zeros; 128-byte swizzle), dA comes by plain loads and
// group 0 takes its cumsum by warp scans.  Every product is a wgmma:
// the state from registers (wq .* B, read transposed by ldmatrix, split
// into bf16 hi + lo) times x (MN-major); C B^T from shared memory
// (K-major), masked and decayed by L in float32 registers, split into hi +
// lo and fed back as the A operand of the product with x (the P V pattern
// of flash_attention_wgmma_kernel); C h from C (K-major) and h's hi + lo
// tiles (MN-major), hi and lo in two accumulators (one chain of 8 or 16
// products into one accumulator made ptxas serialize them).  Group 0
// takes the cumsum.  At N = 64 group 0 takes the state and the scan, the
// chunk's critical path, then C h of its rows; group 1 all three blocks
// of (C B^T .* L) x, the first (group 0's rows) handed over in shared
// memory, then C h of its rows.  At N = 128 group g takes the state's
// rows 64 g .. and its half of each hop, then its rows' blocks of
// (C B^T .* L) x (one, two) and C h.  y leaves by a TMA store from the
// group's rows of C's tile (free once its C h is done), clipped at S.
//
// Shared memory (sw_smem_bytes): x, B, C, the states a block receives
// (float32; h's bf16 hi + lo tiles take their place once read), at
// N = 64 the hand-over tile: 115,296 bytes at N = 64, 115,248 at N = 128,
// two blocks an SM at both.
#define SW_Q 128                   // rows of a chunk
#define SW_THREADS 256             // two warp groups
#define SW_BOX (SW_Q * 128)        // bytes of a 128-row box of 64 bf16
#define SW_CLUSTER 8               // blocks of a cluster, at most
#define SW_SCAN 3                  // steps of the scan over a cluster

// x, B, C; at N = 64 the SW_SCAN states R a block receives, the hand-over
// tile and the states' a; at N = 128 the state arriving from the previous
// block; cs, the warp sums and the mbarriers.  Two blocks an SM at both N
// (2 (115,296 + the 1,024 reserved) of 233,472 bytes).
static constexpr int sw_smem_bytes(int NT) {
  return NT == 1 ? SW_BOX * (1 + 2 + SW_SCAN + 1) + 16 * SW_SCAN + SW_Q * 4 +
                       4 * 4 + (1 + SW_SCAN) * 8
                 : SW_BOX * (1 + 4 + 2) + SW_Q * 4 + 4 * 4 + (1 + SW_SCAN) * 8;
}

// The slots' semantic dimensions of the maps of x, B and C, and y
// (sw_map, sm90.cuh).
struct SwOrders {
  int x, bc, y;
};

// Descriptor of k-step kk (16 columns) of a K-major tile of 128-row
// boxes (64 rows of it from t on), and of rows 16 kk of an MN-major tile.
__device__ __forceinline__ uint64_t sw_kmajor(const unsigned char* t,
                                              int kk) {
  return wg_desc(t + (kk >> 2) * SW_BOX + (kk & 3) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t sw_mnmajor(const unsigned char* t,
                                               int kk) {
  return wg_desc(t + kk * 2048, SW_BOX, 1024);
}

// y[0..3] += a v
__device__ __forceinline__ void sw_fma4(float* y, float a, float4 v) {
  y[0] = fmaf(a, v.x, y[0]);
  y[1] = fmaf(a, v.y, y[1]);
  y[2] = fmaf(a, v.z, y[2]);
  y[3] = fmaf(a, v.w, y[3]);
}

__device__ __forceinline__ void sw_zero(float (&a)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) a[i] = 0.f;
}

// cs = cumsum(dA) over the chunk at s0 (zero past S) by warp group 0,
// thread tid holding row tid: cs2 = cs log2(e); returns cs_Q, the chunk's
// log-decay.
__device__ __forceinline__ float sw_cumsum(const float* ab, long long as2,
                                           int s0, int S, float* cs2,
                                           float* wsum, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  float v = s0 + tid < S ? ab[(long long)(s0 + tid) * as2] : 0.f;
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
  cs2[tid] = (v + pre) * SSD_LOG2E;
  return total;
}

// st[64 x 64] = (wq .* B)^T x over the chunk's 128 rows, wq = exp(cs_Q -
// cs), for the 64 state rows n of B's box bt: A from registers (B read
// transposed by ldmatrix, scaled by wq, split into bf16 hi + lo), x
// MN-major.
__device__ __forceinline__ void sw_state(float (&st)[32],
                                         const unsigned char* bt,
                                         const unsigned char* xs,
                                         const float* cs2, int tid) {
  const int warp = tid >> 5, lane = tid & 31, t4 = lane & 3;
  const float cq = cs2[SW_Q - 1];
  auto wq = [&](int q) { return exp2f(cq - cs2[q]); };
  uint32_t hi[32], lo[32];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int q = 16 * kk + (lane & 7) + 8 * (lane >> 4);
    const int ch = 2 * warp + ((lane >> 3) & 1);
    uint32_t a[4];
    ldsm_x4_t(a, bt + q * 128 + ((ch ^ (q & 7)) << 4));
    const int qq = 16 * kk + 2 * t4;
    const float w0 = wq(qq), w1 = wq(qq + 1), w8 = wq(qq + 8),
                w9 = wq(qq + 9);
    scale_split(a[0], w0, w1, hi[4 * kk], lo[4 * kk]);
    scale_split(a[1], w0, w1, hi[4 * kk + 1], lo[4 * kk + 1]);
    scale_split(a[2], w8, w9, hi[4 * kk + 2], lo[4 * kk + 2]);
    scale_split(a[3], w8, w9, hi[4 * kk + 3], lo[4 * kk + 3]);
  }
  sw_zero(st);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t d = sw_mnmajor(xs, kk);
    wgmma_rs_64x64(st, hi + 4 * kk, d);
    wgmma_rs_64x64(st, lo + 4 * kk, d);
  }
  wg_commit();
  wg_wait<0>();
  wg_hold(st);
  wg_hold(hi);
  wg_hold(lo);
}

// yd[64 x 64] += ((C B^T) .* L) x over the 64 columns of block kb, for the
// 64 rows of group c: the scores from shared memory (both K-major),
// masked above the diagonal and decayed by exp(cs_row - cs_col) in float32
// registers, then bf16 hi + lo as the A operand of the product with x's
// rows 64 kb .. (MN-major).
template <int NT>
__device__ __forceinline__ void sw_diag(float (&yd)[32],
                                        const unsigned char* ct,
                                        const unsigned char* bs,
                                        const unsigned char* xs,
                                        const float* cs2, int c, int kb,
                                        int tid) {
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  float sc[32];
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * NT; ++kk)
    wgmma_ss_64x64(sc, sw_kmajor(ct + 8192 * c, kk),
                   sw_kmajor(bs + 8192 * kb, kk), kk == 0);
  wg_commit();
  wg_wait<0>();
  wg_hold(sc);
  const int r0 = 64 * c + 16 * warp + g;
  const float la = cs2[r0], lb = cs2[r0 + 8];
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 64 * kb + 8 * jj + 2 * t4 + (e & 1);
      const int row = r0 + 8 * (e >> 1);
      sc[4 * jj + e] = kb < c || col <= row
          ? sc[4 * jj + e] * exp2f((e >> 1 ? lb : la) - cs2[col]) : 0.f;
    }
  uint32_t hi[16], lo[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) split_bf16(sc[2 * i], sc[2 * i + 1], hi[i], lo[i]);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t d = sw_mnmajor(xs + 8192 * kb, kk);
    wgmma_rs_64x64(yd, hi + 4 * kk, d);
    wgmma_rs_64x64(yd, lo + 4 * kk, d);
  }
  wg_commit();
  wg_wait<0>();
  wg_hold(yd);
  wg_hold(hi);
  wg_hold(lo);
}

// y of group c's 64 rows: yd + exp(cs) .* (C h), C h from C's rows and h's
// bf16 hi + lo tiles [N][64]; y as bf16 into the group's rows of C's first
// box (the 128-byte swizzle of the map), then one TMA store, clipped at S.
template <int NT>
__device__ __forceinline__ void sw_output(const float (&yd)[32],
                                          unsigned char* ct,
                                          const unsigned char* hhi,
                                          const unsigned char* hlo,
                                          const float* cs2,
                                          const CUtensorMap* tm_y, int order,
                                          int c, int hh, int s0, int bg,
                                          int S, int tid) {
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  unsigned char* yt = ct + 8192 * c;
  float ch[32], cl[32];   // C h_hi, C h_lo: two independent chains
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * NT; ++kk) {
    wgmma_ss_mn_64x64(ch, sw_kmajor(yt, kk), sw_mnmajor(hhi, kk), kk == 0);
    wgmma_ss_mn_64x64(cl, sw_kmajor(yt, kk), sw_mnmajor(hlo, kk), kk == 0);
  }
  wg_commit();
  wg_wait<0>();
  wg_hold(ch);
  wg_hold(cl);
#pragma unroll
  for (int i = 0; i < 32; ++i) ch[i] += cl[i];
  const int r0 = 64 * c + 16 * warp + g;
  const float ea = exp2f(cs2[r0]), eb = exp2f(cs2[r0 + 8]);
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 16 * warp + g + 8 * r;
      const float e = r ? eb : ea;
      *reinterpret_cast<uint32_t*>(yt + row * 128 + ((jj ^ (row & 7)) << 4) +
                                   4 * t4) =
          pack_bf16(fmaf(e, ch[4 * jj + 2 * r], yd[4 * jj + 2 * r]),
                    fmaf(e, ch[4 * jj + 2 * r + 1], yd[4 * jj + 2 * r + 1]));
    }
  fence_async_smem();
  named_sync(1 + c, 128);
  if (tid == 0 && s0 + 64 * c < S) {
    sw_store(tm_y, yt, order, 0, hh, s0 + 64 * c, bg);
    tma_store_commit();
    tma_store_wait_read();
  }
}

// h [N x 64] in group 0's accumulator layout as h's operand for C h: bf16
// hi + lo tiles [N][64] (MN-major, 128-byte swizzle).
template <int NT>
__device__ __forceinline__ void sw_h_operand(unsigned char* hhi,
                                             unsigned char* hlo,
                                             const float (&h)[NT][32],
                                             int tid) {
  const int warp = tid >> 5, g = (tid & 31) >> 2, t4 = tid & 3;
#pragma unroll
  for (int u = 0; u < NT; ++u)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int n = 64 * u + 16 * warp + g + 8 * ((i >> 1) & 1);
      const int off = n * 128 + (((i >> 2) ^ (n & 7)) << 4) + 4 * t4;
      split_bf16(h[u][i], h[u][i + 1], *reinterpret_cast<uint32_t*>(hhi + off),
                 *reinterpret_cast<uint32_t*>(hlo + off));
    }
}

// x, y: [G, H, S, 64] bf16 and B, C: [G, S, N] bf16 as tensor maps (x, B,
// C boxes of 128 rows, y of 64; semantic orders in ord); dA: (g, h, s) at
// the element strides as*; h0: [BH, N, 64] float32 or NULL; writes h
// [BH, N, 64] float32.  grid (csz, BH) in clusters of csz = min(nc, 8)
// blocks, SW_THREADS threads; in cluster round t block r takes chunk
// t csz + r.
//
// N = 128, the chain: the state entering chunk j > 0 arrives in hin,
// stored by the block of chunk j - 1 (both its groups, a half each) with
// st.async, counted on hin_full against this block's expect_tx, its m-th
// reception (m = (j - 1) / csz) completing phase m; each group reads its
// half, passes a h + s on to the block of chunk j + 1 (or writes h after
// the last chunk) without waiting for the stores, then writes its rows of
// h's operand in hin's place.  A block that receives again (nc > 8) first
// tells its sender, by one arrival on the sender's peer_free, that hin is
// free; the sender waits for that before it stores.
//
// N = 64, the scan: each chunk's map h -> a h + s is X, the round's first
// chunk's with its entry state folded in (the constant map to a h_entry +
// s, h_entry = h0, zero, or the state after the previous round's last
// chunk, sent to block 0's R[1] by its block); an exclusive scan of the
// maps over the cluster in SW_SCAN steps (block r sends X to block r + d,
// d = 1, 2, 4, into its R[k] by st.async counted on rbar[k]; receives X'
// of block r - d and composes Y = Y o X', X = X o X').  Y then maps to
// h_r, the state entering the block's chunk, and X to the state after it.
// Between two rounds (nc > 8) the cluster syncs, so R is free again.
template <int NT>
__global__ void __launch_bounds__(SW_THREADS, 2)
    ssd_scan_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                          const __grid_constant__ CUtensorMap tm_b,
                          const __grid_constant__ CUtensorMap tm_c,
                          const __grid_constant__ CUtensorMap tm_y,
                          SwOrders ord, const float* __restrict__ dA,
                          long long as0, long long as1, long long as2,
                          const float* __restrict__ h0,
                          float* __restrict__ h_out, int S, int H) {
  constexpr int N = 64 * NT, RB = NT * SW_BOX;   // bytes of a state
  extern __shared__ __align__(1024) unsigned char sw_smem[];
  unsigned char* xs = sw_smem;   // 1024-aligned: the swizzle's period
  if (sm90_addr(xs) & 1023) __trap();
  unsigned char* bs = xs + SW_BOX;                  // [NT][SW_BOX]
  unsigned char* ct = bs + NT * SW_BOX;             // [NT][SW_BOX]
  unsigned char* rs = ct + NT * SW_BOX;
  // N = 64: the SW_SCAN states R (h's operand in R[0] once read), the
  // hand-over tile, the states' a.  N = 128: the state arriving from the
  // previous block (hin, float32, group g's rows in its half; h's operand
  // in its place once read)
  unsigned char* hhi = rs;                          // [N][64] bf16
  unsigned char* hlo = hhi + NT * 8192;
  float4* hin = reinterpret_cast<float4*>(rs);      // [2][8][128]
  float4* sx = reinterpret_cast<float4*>(rs + SW_SCAN * RB);   // [8][128]
  float4* ra = sx + 8 * 128;                        // [SW_SCAN]: X's a
  float* cs2 = reinterpret_cast<float*>(NT == 1 ? (unsigned char*)(ra + SW_SCAN)
                                                 : rs + RB);   // [Q]
  float* wsum = cs2 + SW_Q;                         // [4]
  uint64_t* tile_full = reinterpret_cast<uint64_t*>(wsum + 4);
  uint64_t* rbar = tile_full + 1;                   // [SW_SCAN]
  uint64_t* hin_full = tile_full + 1;               // N = 128
  uint64_t* peer_free = tile_full + 2;              // N = 128
  auto R = [&](int k) { return reinterpret_cast<const float4*>(rs + k * RB); };

  const int rank = blockIdx.x, csz = gridDim.x, bh = blockIdx.y;
  const int bg = bh / H, hh = bh - bg * H;
  const int nc = (S + SW_Q - 1) / SW_Q, rounds = (nc + csz - 1) / csz;
  // the warp group, uniform to the compiler
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const float* ab = dA + bg * as0 + hh * as1;

  if (threadIdx.x == 0) {
    mbar_init(tile_full, 1);
    for (int k = 0; k < SW_SCAN; ++k)
      mbar_init(rbar + k, 1);    // this block's expect_tx, then the bytes
    mbar_init_fence();
  }
  cluster_sync();   // every block's barriers exist before a remote store

  for (int t = 0; t < rounds; ++t) {
    const int j = t * csz + rank;                   // this block's chunk
    if (j >= nc) break;
    const int cnt = min(csz, nc - t * csz);         // chunks of the round
    const int s0 = j * SW_Q;
    if (threadIdx.x == 0) {
      if constexpr (NT == 1) {
        for (int k = 0; k < SW_SCAN; ++k)           // X of block rank - d
          if (rank >= (1 << k)) mbar_expect_tx(rbar + k, RB + 16);
        if (rank == 0 && t > 0)                      // the previous round's
          mbar_expect_tx(rbar + 1, RB + 16);        // last state
      } else if (j >= 1) {
        mbar_expect_tx(hin_full, RB);               // the entering state
      }
      mbar_expect_tx(tile_full, (1 + 2 * NT) * SW_BOX);
      sw_load(xs, &tm_x, tile_full, ord.x, 0, hh, s0, bg);
      for (int b = 0; b < NT; ++b) {
        sw_load(bs + b * SW_BOX, &tm_b, tile_full, ord.bc, 64 * b, 0, s0, bg);
        sw_load(ct + b * SW_BOX, &tm_c, tile_full, ord.bc, 64 * b, 0, s0, bg);
      }
    }
    const float* cs = cs2;
    float total = 0.f;   // the chunk's log-decay (group 0)
    if (wg == 0) total = sw_cumsum(ab, as2, s0, S, cs2, wsum, tid);
    named_sync(7, 256);   // cs written
    mbar_wait(tile_full, t & 1);
    float yd[32];   // (C B^T .* L) x of the group's rows
    if constexpr (NT == 2) {
      // ---- the chain: group g's half of the state (rows 64 g ..), the
      // entering state's half from hin (or h0), a h + s on to the next
      // block, h's operand, then this group's blocks of (C B^T .* L) x
      float st[32], hr[32];
      sw_state(st, bs + wg * SW_BOX, xs, cs2, tid);
      if (j == 0) {
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int n = 64 * wg + 16 * warp + g + 8 * ((i >> 1) & 1);
          const int p = 8 * (i >> 2) + 2 * t4;
          float2 v = make_float2(0.f, 0.f);
          if (h0)
            v = *reinterpret_cast<const float2*>(
                h0 + ((long long)bh * N + n) * 64 + p);
          hr[i] = v.x;
          hr[i + 1] = v.y;
        }
      } else {
        mbar_wait<true>(hin_full, ((j - 1) / csz) & 1);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 v = hin[(wg * 8 + i) * 128 + tid];
          hr[4 * i] = v.x;
          hr[4 * i + 1] = v.y;
          hr[4 * i + 2] = v.z;
          hr[4 * i + 3] = v.w;
        }
      }
      const float a = exp2f(cs2[SW_Q - 1]);
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = fmaf(a, hr[i], st[i]);
      if (j == nc - 1) {
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int n = 64 * wg + 16 * warp + g + 8 * ((i >> 1) & 1);
          const int p = 8 * (i >> 2) + 2 * t4;
          *reinterpret_cast<float2*>(h_out + ((long long)bh * N + n) * 64 +
                                     p) = make_float2(st[i], st[i + 1]);
        }
      } else {
        const int m = j / csz;   // the receiver's earlier receptions
        if (m >= 1) mbar_wait<true>(peer_free, (m - 1) & 1);
        const int to = rank + 1 == csz ? 0 : rank + 1;
        const uint32_t dst = cluster_map(hin, to);
        const uint32_t bar = cluster_map(hin_full, to);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          st_async_v4(dst + ((wg * 8 + i) * 128 + tid) * 16, st[4 * i],
                      st[4 * i + 1], st[4 * i + 2], st[4 * i + 3], bar);
      }
      named_sync(8, 256);   // hin read by both groups
      sw_h_operand<1>(hhi + wg * 8192, hlo + wg * 8192,
                      reinterpret_cast<const float(&)[1][32]>(hr), tid);
      fence_async_smem();
      named_sync(8, 256);   // h's operand whole
      sw_zero(yd);
      if (wg == 0) {
        sw_diag<NT>(yd, ct, bs, xs, cs, 0, 0, tid);
      } else {
        sw_diag<NT>(yd, ct, bs, xs, cs, 1, 0, tid);
        sw_diag<NT>(yd, ct, bs, xs, cs, 1, 1, tid);
      }
      sw_output<NT>(yd, ct, hhi, hlo, cs, &tm_y, ord.y, wg, hh, s0, bg, S,
                    tid);
    } else if (wg == 0) {
      // ---- the state, the scan of the maps, h's operand, y
      float xs_[NT][32];   // X's s: first the chunk's local state
      sw_state(xs_[0], bs, xs, cs2, tid);
      float ax = expf(total), ay = 1.f;   // the maps' a
      float ys_[NT][32];                  // Y's s
#pragma unroll
      for (int u = 0; u < NT; ++u)
#pragma unroll
        for (int i = 0; i < 32; ++i) ys_[u][i] = 0.f;
      if (rank == 0) {   // fold the entry state in: X = (0, a h + s)
        if (t == 0) {
#pragma unroll
          for (int u = 0; u < NT; ++u)
#pragma unroll
            for (int i = 0; i < 32; i += 2) {
              const int n = 64 * u + 16 * warp + g + 8 * ((i >> 1) & 1);
              const int p = 8 * (i >> 2) + 2 * t4;
              float2 v = make_float2(0.f, 0.f);
              if (h0)
                v = *reinterpret_cast<const float2*>(
                    h0 + ((long long)bh * N + n) * 64 + p);
              ys_[u][i] = v.x;
              ys_[u][i + 1] = v.y;
            }
        } else {
          mbar_wait<true>(rbar + 1, (t - 1) & 1);
#pragma unroll
          for (int u = 0; u < NT; ++u)
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float4 v = R(1)[(u * 8 + i) * 128 + tid];
              ys_[u][4 * i] = v.x;
              ys_[u][4 * i + 1] = v.y;
              ys_[u][4 * i + 2] = v.z;
              ys_[u][4 * i + 3] = v.w;
            }
        }
#pragma unroll
        for (int u = 0; u < NT; ++u)
#pragma unroll
          for (int i = 0; i < 32; ++i)
            xs_[u][i] = fmaf(ax, ys_[u][i], xs_[u][i]);
        ax = 0.f;
        sw_h_operand<NT>(hhi, hlo, ys_, tid);   // h_j: the entry state
#pragma unroll
        for (int u = 0; u < NT; ++u)
#pragma unroll
          for (int i = 0; i < 32; ++i) ys_[u][i] = 0.f;
      }
      // X to block `to`'s R[k], its a beside
      auto send = [&](int to, int k) {
        const uint32_t dst = cluster_map(rs + k * RB, to);
        const uint32_t bar = cluster_map(rbar + k, to);
#pragma unroll
        for (int u = 0; u < NT; ++u)
#pragma unroll
          for (int i = 0; i < 8; ++i)
            st_async_v4(dst + ((u * 8 + i) * 128 + tid) * 16, xs_[u][4 * i],
                        xs_[u][4 * i + 1], xs_[u][4 * i + 2],
                        xs_[u][4 * i + 3], bar);
        if (tid == 0)
          st_async_v4(cluster_map(ra + k, to), ax, 0.f, 0.f, 0.f, bar);
      };
#pragma unroll
      for (int k = 0; k < SW_SCAN; ++k) {
        const int d = 1 << k;
        if (d >= cnt) break;
        if (rank + d < cnt) send(rank + d, k);
        if (rank >= d) {   // Y = Y o X', X = X o X'
          mbar_wait<true>(rbar + k, t & 1);
          const float ar = ra[k].x;
#pragma unroll
          for (int u = 0; u < NT; ++u)
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float4 v = R(k)[(u * 8 + i) * 128 + tid];
              sw_fma4(ys_[u] + 4 * i, ay, v);
              sw_fma4(xs_[u] + 4 * i, ax, v);
            }
          ay *= ar;
          ax *= ar;
        }
      }
      // Y maps to h_j (rank 0: written above)
      named_sync(1, 128);   // R[0] read: h's operand tiles take its place
      if (rank > 0) sw_h_operand<NT>(hhi, hlo, ys_, tid);
      fence_async_smem();
      named_sync(1, 128);
      named_arrive(4, 256);   // h's operand ready for group 1
      // X now maps to the state after chunk j: h after the last chunk, or
      // the next round's entry state for block 0
      if (rank == cnt - 1) {
        if (j == nc - 1) {
#pragma unroll
          for (int u = 0; u < NT; ++u)
#pragma unroll
            for (int i = 0; i < 32; i += 2) {
              const int n = 64 * u + 16 * warp + g + 8 * ((i >> 1) & 1);
              const int p = 8 * (i >> 2) + 2 * t4;
              *reinterpret_cast<float2*>(
                  h_out + ((long long)bh * N + n) * 64 + p) =
                  make_float2(xs_[u][i], xs_[u][i + 1]);
            }
        } else {
          send(0, 1);
        }
      }
      {   // the diagonal block of this group's rows, from group 1
        named_sync(6, 256);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 v = sx[i * 128 + tid];
          yd[4 * i] = v.x;
          yd[4 * i + 1] = v.y;
          yd[4 * i + 2] = v.z;
          yd[4 * i + 3] = v.w;
        }
      }
      sw_output<NT>(yd, ct, hhi, hlo, cs, &tm_y, ord.y, 0, hh, s0, bg, S,
                    tid);
    } else {
      // ---- the diagonal block of group 0's rows (for group 0, which
      // the scan keeps busy), the two blocks of this group's rows, then y
      // once h's operand is ready
      {
        float y0[32];
        sw_zero(y0);
        sw_diag<NT>(y0, ct, bs, xs, cs, 0, 0, tid);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          sx[i * 128 + tid] = make_float4(y0[4 * i], y0[4 * i + 1],
                                          y0[4 * i + 2], y0[4 * i + 3]);
        named_arrive(6, 256);
      }
      sw_zero(yd);
      sw_diag<NT>(yd, ct, bs, xs, cs, 1, 0, tid);
      sw_diag<NT>(yd, ct, bs, xs, cs, 1, 1, tid);
      named_sync(4, 256);
      sw_output<NT>(yd, ct, hhi, hlo, cs, &tm_y, ord.y, 1, hh, s0, bg, S,
                    tid);
    }
    __syncthreads();   // the tiles, R / hin and the arrays are free here
    if constexpr (NT == 1) {
      if (t + 1 < rounds) cluster_sync();   // ... and in every block
    } else if (threadIdx.x == 0 && j >= 1 && j + csz < nc) {
      // this block receives again: its sender may fill hin
      mbar_arrive_cluster(cluster_map(peer_free, rank == 0 ? csz - 1
                                                           : rank - 1));
    }
  }
  if (tid == 0)   // the last y stores done before the block ends
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------- launch
// Shared memory of one block of ssd_scan_fma_kernel, in bytes.
static int ssd_fma_smem_bytes(int P, int N, int Q) {
  const int QS = Q < SSD_STRIP ? Q : SSD_STRIP;
  return (int)sizeof(float) *
         (QS * (Q + N + 1) + Q * (N + 1) + (Q + N) * P + Q);
}

static int ssd_fma_launch(const void* x, const void* dA, const void* Bm,
                          const void* Cm, const void* h0, void* y, void* h,
                          const SsdStrides& sd, int BH, int S, int P, int N,
                          int H, int Q, cudaStream_t stream) {
  const int smem = ssd_fma_smem_bytes(P, N, Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_fma_kernel<<<BH, SSD_THREADS, smem, stream>>>(
      (const float*)x, (const float*)dA, (const float*)Bm, (const float*)Cm,
      (const float*)h0, (float*)y, (float*)h, sd, S, P, N, H, Q);
  return (int)cudaGetLastError();
}

template <int PT, int NT>
static int ssd_mma_launch(const void* x, const void* dA, const void* Bm,
                          const void* Cm, const void* h0, void* y, void* h,
                          const SsdStrides& sd, int BH, int S, int H, int Q,
                          cudaStream_t stream) {
  const int smem = ssd_mma_smem_bytes(16 * PT, 16 * NT, Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_mma_kernel<PT, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_mma_kernel<PT, NT><<<BH, 32 * SSD_WARPS, smem, stream>>>(
      (const bf16*)x, (const float*)dA, (const bf16*)Bm, (const bf16*)Cm,
      (const float*)h0, (bf16*)y, (float*)h, sd, S, H, Q);
  return (int)cudaGetLastError();
}

template <int PT>
static int ssd_mma_dispatch_n(const void* x, const void* dA, const void* Bm,
                              const void* Cm, const void* h0, void* y,
                              void* h, const SsdStrides& sd, int BH, int S,
                              int N, int H, int Q, cudaStream_t s) {
  switch (N) {
    case 16: return ssd_mma_launch<PT, 1>(x, dA, Bm, Cm, h0, y, h, sd, BH, S, H, Q, s);
    case 32: return ssd_mma_launch<PT, 2>(x, dA, Bm, Cm, h0, y, h, sd, BH, S, H, Q, s);
    case 64: return ssd_mma_launch<PT, 4>(x, dA, Bm, Cm, h0, y, h, sd, BH, S, H, Q, s);
    case 128: return ssd_mma_launch<PT, 8>(x, dA, Bm, Cm, h0, y, h, sd, BH, S, H, Q, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int NT>
static int ssd_wgmma_launch(const void* x, const void* dA, const void* Bm,
                            const void* Cm, const void* h0, void* y, void* h,
                            const SsdStrides& sd, int BH, int S, int H,
                            cudaStream_t stream) {
  const int G = BH / H, nc = (S + SW_Q - 1) / SW_Q;
  const int csz = nc < SW_CLUSTER ? nc : SW_CLUSTER;
  if (BH > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mb, mc, my;
  SwOrders ord;
  const long long xdim[4] = {64, H, S, G}, bdim[4] = {64 * NT, 1, S, G};
  const long long xst[4] = {1, sd.x[1], sd.x[2], sd.x[0]};
  const long long yst[4] = {1, sd.y[1], sd.y[2], sd.y[0]};
  const long long bst[4] = {1, 0, sd.bc[1], sd.bc[0]};
  int err;
  if ((err = sw_map(&mx, x, xdim, xst, SW_Q, &ord.x)) ||
      (err = sw_map(&mb, Bm, bdim, bst, SW_Q, &ord.bc)) ||
      (err = sw_map(&mc, Cm, bdim, bst, SW_Q, &ord.bc)) ||
      (err = sw_map(&my, y, xdim, yst, 64, &ord.y)))
    return err;
  cudaError_t e =
      smem_attribute_once<ssd_scan_wgmma_kernel<NT>>(sw_smem_bytes(NT));
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csz, BH, 1);
  cfg.blockDim = dim3(SW_THREADS, 1, 1);
  cfg.dynamicSmemBytes = sw_smem_bytes(NT);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csz;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, ssd_scan_wgmma_kernel<NT>, mx, mb, mc, my,
                         ord, (const float*)dA, sd.a[0], sd.a[1], sd.a[2],
                         (const float*)h0, (float*)h, S, H);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// x, y: [G, H, S, P] by the element strides xs*, ys* (BH = G H rows;
// innermost dense); dA: [G, H, S] fp32 by as*; Bm, Cm: [G, S, N] by bs*
// (innermost dense).  kind: 0 float32 (the FMA kernel); bf16 x/B/C/y with
// 16-byte aligned rows: 1 the mma.sync kernel (P in {16, 32, 64}, N in
// {16, 32, 64, 128}), 2 the Hopper kernel (P = 64, N in {64, 128}, chunks
// of 128 rows: Q = 128, or one chunk, Q = S < 128).  h0: [BH, N, P] fp32 or
// NULL.  Writes y (x's type) and h [BH, N, P] fp32.  Q rows per chunk
// (1 <= Q <= S).
extern "C" int ssd_scan_launch(const void* x, const void* dA, const void* Bm,
                               const void* Cm, const void* h0, void* y,
                               void* h, int BH, int S, int P, int N, int H,
                               int Q, int kind, long long xs0,
                               long long xs1, long long xs2, long long as0,
                               long long as1, long long as2, long long ys0,
                               long long ys1, long long ys2, long long bs0,
                               long long bs1, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const SsdStrides sd = {{xs0, xs1, xs2}, {as0, as1, as2}, {ys0, ys1, ys2},
                         {bs0, bs1}};
  if (kind == 0)
    return ssd_fma_launch(x, dA, Bm, Cm, h0, y, h, sd, BH, S, P, N, H, Q, s);
  if (kind == 2) {
    if (P != 64 || !(Q == SW_Q || (Q == S && S < SW_Q)))
      return (int)cudaErrorInvalidValue;
    switch (N) {
      case 64: return ssd_wgmma_launch<1>(x, dA, Bm, Cm, h0, y, h, sd, BH, S, H, s);
      case 128: return ssd_wgmma_launch<2>(x, dA, Bm, Cm, h0, y, h, sd, BH, S, H, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (P) {
    case 16: return ssd_mma_dispatch_n<1>(x, dA, Bm, Cm, h0, y, h, sd, BH, S, N, H, Q, s);
    case 32: return ssd_mma_dispatch_n<2>(x, dA, Bm, Cm, h0, y, h, sd, BH, S, N, H, Q, s);
    case 64: return ssd_mma_dispatch_n<4>(x, dA, Bm, Cm, h0, y, h, sd, BH, S, N, H, Q, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
