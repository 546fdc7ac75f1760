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
// zero padding does).  h0 may be NULL (zero initial state).  Two kernels,
// chosen by dtype in the open (no fallback between them):
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

#include "mma.cuh"

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

// x, y: [G, H, S, P] by the element strides xs*, ys* (BH = G H rows;
// innermost dense); dA: [G, H, S] fp32 by as*; Bm, Cm: [G, S, N] by bs*
// (innermost dense).  bf16 != 0: x/B/C/y bfloat16 (the tensor-core kernel;
// P in {16, 32, 64}, N in {16, 32, 64, 128}, 16-byte aligned rows), else
// float32 (the FMA kernel).  h0: [BH, N, P] fp32 or NULL.  Writes y (x's
// type) and h [BH, N, P] fp32.  Q rows per chunk (1 <= Q <= S).
extern "C" int ssd_scan_launch(const void* x, const void* dA, const void* Bm,
                               const void* Cm, const void* h0, void* y,
                               void* h, int BH, int S, int P, int N, int H,
                               int Q, int bf16_in, long long xs0,
                               long long xs1, long long xs2, long long as0,
                               long long as1, long long as2, long long ys0,
                               long long ys1, long long ys2, long long bs0,
                               long long bs1, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const SsdStrides sd = {{xs0, xs1, xs2}, {as0, as1, as2}, {ys0, ys1, ys2},
                         {bs0, bs1}};
  if (!bf16_in)
    return ssd_fma_launch(x, dA, Bm, Cm, h0, y, h, sd, BH, S, P, N, H, Q, s);
  switch (P) {
    case 16: return ssd_mma_dispatch_n<1>(x, dA, Bm, Cm, h0, y, h, sd, BH, S, N, H, Q, s);
    case 32: return ssd_mma_dispatch_n<2>(x, dA, Bm, Cm, h0, y, h, sd, BH, S, N, H, Q, s);
    case 64: return ssd_mma_dispatch_n<4>(x, dA, Bm, Cm, h0, y, h, sd, BH, S, N, H, Q, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
