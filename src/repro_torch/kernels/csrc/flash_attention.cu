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
// the 989 TFLOP/s bf16 tensor rate.  Off the tensor cores (67 TFLOP/s of
// fp32 FMA) the products alone take 320 us, so they must run on them.
//
// What the design does about it: three kernels, chosen by dtype and head
// dim in the open (no fallback between them):
//
// * bf16 at D = 64, 80 and 128, flash_attention_wgmma_kernel: the Hopper
//   design (TMA, wgmma, warp-specialised consumer groups, persistent
//   blocks) of the section "forward, bf16 on Hopper" at the end.
// * bf16 at the other head dims, flash_attention_mma_kernel (FA2-style).
//   One block per q tile of one batch*head, 4 warps, heaviest tiles
//   launched first.  A tile is 128
//   rows, each warp two m-tiles of 16 that share every K and V fragment
//   the warp loads: half the shared-memory reads per product of 16-row
//   warps.  K and V tiles of
//   64 keys go to bf16 shared memory by cp.async (16 bytes a thread) in a
//   ring of two stages, so the next tile's load overlaps this tile's
//   products; Q is loaded once, its A fragments re-read from shared memory
//   at each tile.  Both products run on mma.sync m16n8k16 (bf16 operands,
//   fp32 sums), their operands brought in by ldmatrix (.trans for V) from
//   rows padded to D+8 elements, an odd number of 16-byte chunks, so the
//   eight rows of every ldmatrix hit eight different bank groups.  The online softmax stays in
//   fp32 registers (row max by quad shuffles, exp2 with the scale folded
//   in, per-thread partial sums reduced once at the end), and the QK^T
//   accumulator fragment, rounded to bf16, is the A fragment of PV as it
//   stands: P never touches shared memory.  A warp skips a kv tile wholly
//   above its rows; the mask runs only on a tile that crosses the diagonal
//   or the end of the keys.
// * float32, flash_attention_fma_kernel: q, k and v tiles in fp32 shared
//   memory (rows padded to D+1 floats), each of 256 threads owning a 4 x 4
//   score block and a 4 x D/16 output block, products by fmaf.  It keeps
//   full fp32 products, which the float32 checks (2e-5) rely on.
//
// All three: GQA by index (kv head h / (H / KH)) from [B, S, KH, D], no
// repeat; no D padding in memory (D a multiple of 16 up to 128; the Hopper
// kernel's tensor maps end at D); the causal skip of kv tiles above the
// diagonal; ragged S masked in-kernel with -1e30 (not -inf) and l clamped
// at 1e-37, as in the Pallas kernel, so no row is NaN.
#include <cuda_runtime.h>

#include "mma.cuh"
#include "sm90.cuh"

#define FA_BQ 64
#define FA_BK 64
#define FA_THREADS 256
#define FA_NEG_INF (-1.0e30f)

// ---------------------------------------------------------------- float32
// q: [B, Sq, H, D]; k, v: [B, Sk, KH, D]; o: [B, Sq, H, D]; D = 16 * DC.
// grid (ceil(Sq / FA_BQ), B * H), FA_THREADS threads.
template <int DC>
__global__ void __launch_bounds__(FA_THREADS)
    flash_attention_fma_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ o,
                               float* __restrict__ lse, int Sq, int Sk, int H,
                               int KH, float scale, int causal) {
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
  const float* qb = q + ((long long)b * Sq * H + h) * D;
  const float* kb = k + ((long long)b * Sk * KH + kh) * D;
  const float* vb = v + ((long long)b * Sk * KH + kh) * D;
  float* ob = o + ((long long)b * Sq * H + h) * D;

  for (int i = tid; i < FA_BQ * D; i += FA_THREADS) {
    const int r = i / D, c = i - (i / D) * D;
    const int s = q0 + r;
    qs[r * LDQ + c] = s < Sq ? qb[s * q_stride + c] : 0.f;
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
      ks[r * LDQ + c] = in ? kb[s * kv_stride + c] : 0.f;
      vs[r * D + c] = in ? vb[s * kv_stride + c] : 0.f;
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
      ob[qpos * q_stride + tx + 16 * j] = acc[i][j] * inv;
    if (lse && tx == 0)
      lse[(long long)bh * Sq + qpos] = m[i] + logf(fmaxf(l[i], 1e-37f));
  }
}


// ------------------------------------------------------------------- bf16
#define FA_STAGES 2
#define FA_WARPS 4
#define FA_MT 2   // 16-row m-tiles of a warp: q tiles of 16 FA_MT FA_WARPS
#define FA_LOG2E 1.4426950408889634f
#define FA_LN2 0.6931471805599453f

// q: [B, Sq, H, D]; k, v: [B, Sk, KH, D]; o: [B, Sq, H, D], bf16; D = 16 DC.
// grid (B * H, ceil(Sq / BQ)), BQ = 16 MT FA_WARPS rows, 32 FA_WARPS
// threads: warp w owns rows 16 MT w .. 16 MT (w + 1) - 1, as MT = FA_MT
// m-tiles of 16 that share every K and V fragment it loads.  scale_log2 is
// the softmax scale times log2(e): scores live in the exp2 domain.
template <int DC>
__global__ void __launch_bounds__(32 * FA_WARPS)
    flash_attention_mma_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               bf16* __restrict__ o,
                               float* __restrict__ lse, int Sq, int Sk, int H,
                               int KH, float scale_log2, int causal) {
  constexpr int D = 16 * DC, MT = FA_MT;
  constexpr int LD = D + 8;       // padded rows: an odd count of 16 B chunks
  constexpr int CH = D / 8;       // 16-byte chunks of a row
  constexpr int WR = 16 * MT;     // rows of a warp
  constexpr int BQ = WR * FA_WARPS;
  constexpr int NTHR = 32 * FA_WARPS;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  bf16* qs = reinterpret_cast<bf16*>(fa_smem);   // [BQ][LD]
  bf16* ks = qs + BQ * LD;                       // [STAGES][BK][LD]
  bf16* vs = ks + FA_STAGES * FA_BK * LD;        // [STAGES][BK][LD]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tiles first
  const int b = bh / H, h = bh - (bh / H) * H;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wq0 = q0 + WR * warp;                 // this warp's first row

  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)KH * D;
  const bf16* qb = q + ((long long)b * Sq * H + h) * D;
  const bf16* kb = k + ((long long)b * Sk * KH + kh) * D;
  const bf16* vb = v + ((long long)b * Sk * KH + kh) * D;
  bf16* ob = o + ((long long)b * Sq * H + h) * D;

  for (int i = tid; i < BQ * CH; i += NTHR) {
    const int r = i / CH, c = i - (i / CH) * CH;
    const int s = q0 + r;
    cp_async16(qs + r * LD + c * 8, qb + (s < Sq ? s : 0) * q_stride + c * 8,
               s < Sq);
  }
  auto load_kv = [&](int t, int st) {
    bf16* kd = ks + st * FA_BK * LD;
    bf16* vd = vs + st * FA_BK * LD;
    for (int i = tid; i < FA_BK * CH; i += NTHR) {
      const int r = i / CH, c = i - (i / CH) * CH;
      const int s = t * FA_BK + r;
      const long long off = (s < Sk ? s : 0) * kv_stride + c * 8;
      cp_async16(kd + r * LD + c * 8, kb + off, s < Sk);
      cp_async16(vd + r * LD + c * 8, vb + off, s < Sk);
    }
  };

  int n_kv = (Sk + FA_BK - 1) / FA_BK;
  if (causal) {
    const int last = (q0 + BQ - 1) / FA_BK;   // the causal skip
    n_kv = last + 1 < n_kv ? last + 1 : n_kv;
  }
  load_kv(0, 0);
  cp_async_commit();   // group 0: q and kv tile 0

  float acc[MT][2 * DC][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = FA_NEG_INF;
      l[mt][r] = 0.f;
    }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 2 * DC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  for (int t = 0; t < n_kv; ++t) {
    if (t + 1 < n_kv) load_kv(t + 1, (t + 1) & 1);
    cp_async_commit();   // possibly empty: keeps one group per step
    cp_async_wait<1>();  // tile t (and q) landed for this thread
    __syncthreads();     // ... and for every thread
    const int k0 = t * FA_BK;
    // a tile wholly above this warp's rows, or rows past Sq: nothing to do
    if (!(causal && k0 > wq0 + WR - 1) && wq0 < Sq) {
      const bf16* kt = ks + (t & 1) * FA_BK * LD;
      const bf16* vt = vs + (t & 1) * FA_BK * LD;
      float s[MT][8][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
      // S = Q K^T: Q's A fragments from shared memory, K rows are the B
      // operand's columns (no transpose), each K fragment used MT times
#pragma unroll
      for (int kd = 0; kd < DC; ++kd) {
        uint32_t qf[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldsm_x4(qf[mt], qs + (WR * warp + 16 * mt + (lane & 7) +
                                ((lane >> 3) & 1) * 8) * LD +
                              (2 * kd + (lane >> 4)) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bk[4];
          ldsm_x4(bk, kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                          (2 * kd + ((lane >> 3) & 1)) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][2 * np], qf[mt], bk[0], bk[1]);
            mma_bf16(s[mt][2 * np + 1], qf[mt], bk[2], bk[3]);
          }
        }
      }
      // online softmax on rows g (e = 0, 1) and g + 8 (e = 2, 3) of each
      // m-tile; the mask only where the tile crosses the diagonal or Sk
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r0 = wq0 + 16 * mt;
        const bool need_mask =
            k0 + FA_BK > Sk || (causal && k0 + FA_BK - 1 > r0);
        float mx[2] = {m[mt][0], m[mt][1]};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[mt][j][e] * scale_log2;
            if (need_mask) {
              const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
              const int qpos = r0 + g + 8 * (e >> 1);
              if (kpos >= Sk || (causal && kpos > qpos)) x = FA_NEG_INF;
            }
            s[mt][j][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          corr[r] = exp2f(m[mt][r] - mx[r]);
          m[mt][r] = mx[r];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[mt][j][e] = exp2f(s[mt][j][e] - m[mt][e >> 1]);
            rs[e >> 1] += s[mt][j][e];
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[mt][r] = l[mt][r] * corr[r] + rs[r];
#pragma unroll
        for (int j = 0; j < 2 * DC; ++j) {
          acc[mt][j][0] *= corr[0];
          acc[mt][j][1] *= corr[0];
          acc[mt][j][2] *= corr[1];
          acc[mt][j][3] *= corr[1];
        }
      }
      // O += P V: the S fragments of keys 16kk..16kk+15, rounded to bf16,
      // are the A fragment; V rows are the B operand's k (transpose), each
      // V fragment used MT times
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t pa[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int dp = 0; dp < DC; ++dp) {
          uint32_t bv[4];
          ldsm_x4_t(bv, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 LD + (2 * dp + (lane >> 4)) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(acc[mt][2 * dp], pa[mt], bv[0], bv[1]);
            mma_bf16(acc[mt][2 * dp + 1], pa[mt], bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();   // stage t & 1 is free for tile t + 2
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[mt][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int qpos = wq0 + 16 * mt + g + 8 * r;
      if (qpos >= Sq) continue;
      const float inv = 1.f / fmaxf(lr, 1e-37f);
      if (lse && t4 == 0)   // natural log: the scores were in log2 units
        lse[(long long)bh * Sq + qpos] =
            (m[mt][r] + log2f(fmaxf(lr, 1e-37f))) * FA_LN2;
      bf16* orow = ob + qpos * q_stride + 2 * t4;
#pragma unroll
      for (int j = 0; j < 2 * DC; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) = pack_bf16(
            acc[mt][j][2 * r] * inv, acc[mt][j][2 * r + 1] * inv);
    }
}

// ---------------------------------------------------------------- launch
template <int DC>
static int fa_fma_launch(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int Sq, int Sk, int H, int KH,
                         float scale, int causal, cudaStream_t stream) {
  constexpr int D = 16 * DC;
  const int smem = (int)sizeof(float) *
                   (2 * FA_BQ * (D + 1) + FA_BK * D + FA_BQ * (FA_BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fma_kernel<DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + FA_BQ - 1) / FA_BQ, B * H);
  flash_attention_fma_kernel<DC><<<grid, FA_THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, Sq,
      Sk, H, KH, scale, causal);
  return (int)cudaGetLastError();
}

template <int DC>
static int fa_mma_launch(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int Sq, int Sk, int H, int KH,
                         float scale, int causal, cudaStream_t stream) {
  constexpr int LD = 16 * DC + 8, BQ = 16 * FA_MT * FA_WARPS;
  const int smem = (int)sizeof(bf16) * LD * (BQ + 2 * FA_STAGES * FA_BK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_mma_kernel<DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_attention_mma_kernel<DC><<<grid, 32 * FA_WARPS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, Sq, Sk,
      H, KH, scale * FA_LOG2E, causal);
  return (int)cudaGetLastError();
}

// The Hopper kernel (section "forward, bf16 on Hopper" at the end).
template <int D>
static int fa_wgmma_launch(const void* q, const void* k, const void* v,
                           void* o, float* lse, int B, int Sq, int Sk, int H,
                           int KH, float scale, int causal, cudaStream_t s);

// float32: the FMA kernel; bf16 at D = 64, 80 and 128: the Hopper kernel;
// bf16 at the other head dims: mma.sync.  No fallback between them.
template <int DC>
static int fa_launch(const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int Sq, int Sk, int H, int KH,
                     float scale, int causal, int bf16_in, cudaStream_t s) {
  if (!bf16_in)
    return fa_fma_launch<DC>(q, k, v, o, lse, B, Sq, Sk, H, KH, scale,
                             causal, s);
  if constexpr (DC == 4 || DC == 5 || DC == 8)
    return fa_wgmma_launch<16 * DC>(q, k, v, o, lse, B, Sq, Sk, H, KH, scale,
                                    causal, s);
  else
    return fa_mma_launch<DC>(q, k, v, o, lse, B, Sq, Sk, H, KH, scale,
                             causal, s);
}

// q: [B, Sq, H, D], k/v: [B, Sk, KH, D], o: [B, Sq, H, D], all contiguous,
// one dtype: bf16 != 0 takes the bfloat16 tensor-core kernel (128-row q
// tiles), bf16 == 0 the float32 FMA kernel (64-row tiles).  D in {16, 32,
// ..., 128}, H a multiple of KH; the bf16 pointers 16-byte aligned.
// Writes o, and, where lse is not null, the float32 log-sum-exp of each
// row's scaled scores, lse [B, H, Sq] (natural log), for the backward.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int B, int Sq,
                                      int Sk, int H, int KH, int D, int causal,
                                      int bf16_in, float scale,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return fa_launch<1>(q, k, v, o, (float*)lse, B, Sq, Sk, H, KH, scale, causal, bf16_in, s);
    case 32: return fa_launch<2>(q, k, v, o, (float*)lse, B, Sq, Sk, H, KH, scale, causal, bf16_in, s);
    case 48: return fa_launch<3>(q, k, v, o, (float*)lse, B, Sq, Sk, H, KH, scale, causal, bf16_in, s);
    case 64: return fa_launch<4>(q, k, v, o, (float*)lse, B, Sq, Sk, H, KH, scale, causal, bf16_in, s);
    case 80: return fa_launch<5>(q, k, v, o, (float*)lse, B, Sq, Sk, H, KH, scale, causal, bf16_in, s);
    case 96: return fa_launch<6>(q, k, v, o, (float*)lse, B, Sq, Sk, H, KH, scale, causal, bf16_in, s);
    case 112: return fa_launch<7>(q, k, v, o, (float*)lse, B, Sq, Sk, H, KH, scale, causal, bf16_in, s);
    case 128: return fa_launch<8>(q, k, v, o, (float*)lse, B, Sq, Sk, H, KH, scale, causal, bf16_in, s);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ================================================================ backward
// The gradient of the attention above: dq, dk and dv from q, k, v, o, the
// forward's lse and do.  It replaces no Pallas kernel: the reference takes
// this gradient by XLA's autodiff of layers._dense_attention /
// _chunked_attention (src/repro/models/layers.py:123-213), since its
// flash_attention_pallas has no custom_vjp.  FlashAttention-2's backward:
// p = exp(s * scale - lse) recomputed tile by tile (never stored),
// delta = rowsum(do .* o), ds = p .* (dp - delta) with dp = do v^T, then
// dq = scale ds k, dk = scale ds^T q, dv = p^T do.
//
// What bounds it on the H100: operations.  At qwen2-0.5b's training shape
// (B=4, S=1024, H=14, KH=2, D=64, causal) its five products over the
// causal half are 18.8 GFLOP, 19 us at the 989 TFLOP/s bf16 tensor rate;
// it must move q, k, v, o, do, dq, dk, dv and lse, 33.6 MB, 10 us at
// 3.35 TB/s.
//
// What the design does about it: two kernels, each in three forms chosen
// in the open by dtype and head dim (no fallback between them); the
// mma.sync and FMA forms:
//
// * flash_attention_bwd_dq_*: one block per (batch * head, 64-row q tile),
//   heaviest tiles first; it writes delta for its rows (read by the next
//   kernel), then walks the kv tiles (to the diagonal when causal): s and
//   dp, then p and ds, then dq += ds k.
// * flash_attention_bwd_dkdv_*: one block per (batch * kv head, 64-row kv
//   tile), walking the q tiles (from the diagonal when causal) of every
//   one of the G = H / KH query heads of its group, so the GQA sum of dk
//   and dv stays in the block's registers: no atomics, the same bits
//   every run.  s^T and dp^T, then p^T and ds^T, then dv += p^T do and
//   dk += ds^T q.
//
// bf16 at D = 64 and 128: the Hopper kernels (*_wgmma_kernel) of the
// section "bf16 on Hopper" below.  bf16 at the other head dims
// (*_mma_kernel): 4 warps, each owning 16 rows of the tile; every
// product on mma.sync m16n8k16 (bf16 operands, fp32 sums), operands by
// ldmatrix from rows padded to D+8 (the forward's layout): the two score
// products read their tiles as they lie, the two or three accumulating
// products take the score fragments as their A operand as they stand (p
// and ds never touch shared memory) and the other tile through
// ldmatrix.trans.  p and ds go in as a pair of bf16 each, hi + lo (about
// 16 mantissa bits, split_bf16), two products where FlashAttention-2 rounds
// them to bf16 once: ds sums to zero along a row, and one bf16 rounding of
// its terms left dq 1.3x beyond one rounding of the float32 result.  So
// the kernels round only their inputs and outputs, as the float32 oracle
// assumes.  The streamed tiles (k and v in the first, q, do, lse and delta
// in the second) come by cp.async in a ring of two stages, the next one's
// load under this one's products.
// float32 (*_fma_kernel): each of 256 threads owns a 4 x 4 block of the
// 64 x 64 score tile (rows ty*4+i, columns tx+16j) and a 4 x D/16 block
// of its outputs, products by fmaf from float32 shared memory: full fp32,
// which the float32 checks (1e-4) rely on.
//
// The masks are the forward's: a key past Sk, a query past Sq and, when
// causal, a key after its query get p = 0.
#define FB_T 64              // rows of a q tile and of a kv tile
#define FB_LDS (FB_T + 1)    // padded rows of the score tiles

__device__ __forceinline__ float fb_ld(const float* p) { return *p; }
__device__ __forceinline__ float fb_ld(const bf16* p) {
  return __bfloat162float(*p);
}

// rows [r0, r0 + FB_T) of a [S, heads, D] float32 tensor at one head, into
// shared rows of ld floats; zeros past S.
template <int D>
__device__ __forceinline__ void fb_load_tile(float* dst, int ld,
                                             const float* src, int r0, int S,
                                             long long stride) {
  for (int i = threadIdx.x; i < FB_T * D; i += FA_THREADS) {
    const int r = i / D, c = i - (i / D) * D;
    const int s = r0 + r;
    dst[r * ld + c] = s < S ? src[s * stride + c] : 0.f;
  }
}

// delta = rowsum(do .* o) of rows [r0, r0 + FB_T) of one head, one warp a
// row of nwarps, o and do read from memory; zeros past Sq.  Also stages
// each row's lse (times lse_scale) in lse_s.
template <typename T, int D>
__device__ __forceinline__ void fb_delta(const T* dout, const T* o,
                                         const float* lse, float* delta,
                                         float* dl_s, float* lse_s,
                                         float lse_scale, int r0, int Sq,
                                         long long stride, int nwarps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < FB_T; r += nwarps) {
    const int s = r0 + r;
    float acc = 0.f;
    if (s < Sq)
      for (int c = lane; c < D; c += 32)
        acc += fb_ld(dout + s * stride + c) * fb_ld(o + s * stride + c);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      dl_s[r] = acc;
      lse_s[r] = s < Sq ? lse[s] * lse_scale : 0.f;
      if (s < Sq) delta[s] = acc;
    }
  }
}

// ---------------------------------------------------------------- float32
// q, o, do, dq: [B, Sq, H, D]; k, v: [B, Sk, KH, D]; lse, delta: [B, H, Sq]
// float32.  grid (ceil(Sq / FB_T), B * H), FA_THREADS threads.
template <int DC>
__global__ void __launch_bounds__(FA_THREADS)
    flash_attention_bwd_dq_fma_kernel(const float* __restrict__ q,
                                      const float* __restrict__ k,
                                      const float* __restrict__ v,
                                      const float* __restrict__ o,
                                      const float* __restrict__ dout,
                                      const float* __restrict__ lse,
                                      float* __restrict__ delta,
                                      float* __restrict__ dq, int Sq, int Sk,
                                      int H, int KH, float scale,
                                      int causal) {
  constexpr int D = 16 * DC, LD = D + 1;
  extern __shared__ float fb_smem[];
  float* qs = fb_smem;             // [T][LD]
  float* dos = qs + FB_T * LD;     // [T][LD]
  float* ks = dos + FB_T * LD;     // [T][LD]
  float* vs = ks + FB_T * LD;      // [T][LD]
  float* dss = vs + FB_T * LD;     // [T][LDS] ds of one kv tile
  float* lse_s = dss + FB_T * FB_LDS;
  float* dl_s = lse_s + FB_T;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * FB_T;   // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long q_stride = (long long)H * D, kv_stride = (long long)KH * D;
  const long long qoff = ((long long)b * Sq * H + h) * D;
  const long long kvoff = ((long long)b * Sk * KH + kh) * D;

  fb_load_tile<D>(qs, LD, q + qoff, q0, Sq, q_stride);
  fb_load_tile<D>(dos, LD, dout + qoff, q0, Sq, q_stride);
  fb_delta<float, D>(dout + qoff, o + qoff, lse + (long long)bh * Sq,
                     delta + (long long)bh * Sq, dl_s, lse_s, 1.f, q0, Sq,
                     q_stride, FA_THREADS / 32);

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  int n_kv = (Sk + FB_T - 1) / FB_T;
  if (causal) {
    const int last = (q0 + FB_T - 1) / FB_T;
    n_kv = last + 1 < n_kv ? last + 1 : n_kv;
  }
  for (int t = 0; t < n_kv; ++t) {
    const int k0 = t * FB_T;
    __syncthreads();   // the previous tile's readers are done
    fb_load_tile<D>(ks, LD, k + kvoff, k0, Sk, kv_stride);
    fb_load_tile<D>(vs, LD, v + kvoff, k0, Sk, kv_stride);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], ad[4], bk[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[(ty * 4 + i) * LD + d];
        ad[i] = dos[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bk[j] = ks[(tx + 16 * j) * LD + d];
        bv[j] = vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], bk[j], s[i][j]);
          dp[i][j] = fmaf(ad[i], bv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool live = qpos < Sq && kpos < Sk && !(causal && kpos > qpos);
        const float p = live ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        dss[r * FB_LDS + tx + 16 * j] = p * (dp[i][j] - dl_s[r]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < FB_T; ++kk) {
      float ds[4], kv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dss[(ty * 4 + i) * FB_LDS + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) kv[j] = ks[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(ds[i], kv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= Sq) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      dq[qoff + qpos * q_stride + tx + 16 * j] = acc[i][j] * scale;
  }
}

// q, do: [B, Sq, H, D]; k, v, dk, dv: [B, Sk, KH, D]; lse, delta:
// [B, H, Sq] float32 (delta written by the dq kernel).
// grid (ceil(Sk / FB_T), B * KH), FA_THREADS threads.
template <int DC>
__global__ void __launch_bounds__(FA_THREADS)
    flash_attention_bwd_dkdv_fma_kernel(const float* __restrict__ q,
                                        const float* __restrict__ k,
                                        const float* __restrict__ v,
                                        const float* __restrict__ dout,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta,
                                        float* __restrict__ dk,
                                        float* __restrict__ dv, int Sq,
                                        int Sk, int H, int KH, float scale,
                                        int causal) {
  constexpr int D = 16 * DC, LD = D + 1;
  extern __shared__ float fb_smem[];
  float* ks = fb_smem;             // [T][LD]
  float* vs = ks + FB_T * LD;      // [T][LD]
  float* qs = vs + FB_T * LD;      // [T][LD]
  float* dos = qs + FB_T * LD;     // [T][LD]
  float* ps = dos + FB_T * LD;     // [T][LDS] p^T: kv rows x q columns
  float* dss = ps + FB_T * FB_LDS; // [T][LDS] ds^T
  float* lse_s = dss + FB_T * FB_LDS;
  float* dl_s = lse_s + FB_T;

  const int k0 = blockIdx.x * FB_T;   // tile 0 walks the most q tiles
  const int bkh = blockIdx.y;
  const int b = bkh / KH, kh = bkh - (bkh / KH) * KH;
  const int G = H / KH;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long q_stride = (long long)H * D, kv_stride = (long long)KH * D;
  const long long kvoff = ((long long)b * Sk * KH + kh) * D;

  fb_load_tile<D>(ks, LD, k + kvoff, k0, Sk, kv_stride);
  fb_load_tile<D>(vs, LD, v + kvoff, k0, Sk, kv_stride);

  float dka[4][DC], dva[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) dka[i][j] = dva[i][j] = 0.f;

  const int nq = (Sq + FB_T - 1) / FB_T;
  const int t0 = causal ? k0 / FB_T : 0;   // q tiles wholly before k0: none
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const long long qoff = ((long long)b * Sq * H + h) * D;
    const long long roff = ((long long)b * H + h) * Sq;
    for (int t = t0; t < nq; ++t) {
      const int q0 = t * FB_T;
      __syncthreads();   // the previous tile's readers are done
      fb_load_tile<D>(qs, LD, q + qoff, q0, Sq, q_stride);
      fb_load_tile<D>(dos, LD, dout + qoff, q0, Sq, q_stride);
      for (int r = tid; r < FB_T; r += FA_THREADS) {
        const int s = q0 + r;
        lse_s[r] = s < Sq ? lse[roff + s] : 0.f;
        dl_s[r] = s < Sq ? delta[roff + s] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];   // s^T and dp^T: kv rows x q columns
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float ak[4], av[4], bq[4], bd[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ak[i] = ks[(ty * 4 + i) * LD + d];
          av[i] = vs[(ty * 4 + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bq[j] = qs[(tx + 16 * j) * LD + d];
          bd[j] = dos[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(ak[i], bq[j], s[i][j]);
            dp[i][j] = fmaf(av[i], bd[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i, kpos = k0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j, qpos = q0 + c;
          const bool live =
              qpos < Sq && kpos < Sk && !(causal && kpos > qpos);
          const float p = live ? expf(s[i][j] * scale - lse_s[c]) : 0.f;
          ps[r * FB_LDS + c] = p;
          dss[r * FB_LDS + c] = p * (dp[i][j] - dl_s[c]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < FB_T; ++c) {
        float pr[4], dr[4], bq[DC], bd[DC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pr[i] = ps[(ty * 4 + i) * FB_LDS + c];
          dr[i] = dss[(ty * 4 + i) * FB_LDS + c];
        }
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          bq[j] = qs[c * LD + tx + 16 * j];
          bd[j] = dos[c * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DC; ++j) {
            dva[i][j] = fmaf(pr[i], bd[j], dva[i][j]);
            dka[i][j] = fmaf(dr[i], bq[j], dka[i][j]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty * 4 + i;
    if (kpos >= Sk) continue;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const long long off = kvoff + kpos * kv_stride + tx + 16 * j;
      dk[off] = dka[i][j] * scale;
      dv[off] = dva[i][j];
    }
  }
}


// ------------------------------------------------------------------- bf16
#define FB_WARPS 4   // 16 rows of the 64-row tile a warp

// 64 rows [r0, r0 + FB_T) of a [S, heads, D] bf16 tensor at one head into
// shared rows of LD elements, by cp.async (zeros past S).
template <int D>
__device__ __forceinline__ void fb_cp_tile(bf16* dst, const bf16* src,
                                           int r0, int S, long long stride) {
  constexpr int CH = D / 8, LD = D + 8;
  for (int i = threadIdx.x; i < FB_T * CH; i += 32 * FB_WARPS) {
    const int r = i / CH, c = i - (i / CH) * CH;
    const int s = r0 + r;
    cp_async16(dst + r * LD + c * 8, src + (s < S ? s : 0) * stride + c * 8,
               s < S);
  }
}

// acc[16 x 64] += A B^T over d: A's 16 rows (this warp's, at a_rows) and
// B's 64 rows (b_rows) both from shared rows of D (+8) bf16, d contiguous;
// the eight n-tiles of 8 columns each.  Two such products at once (the
// score and its gradient's dp), sharing the loop.
template <int DC>
__device__ __forceinline__ void fb_mma_ab_t(float (&acc0)[8][4],
                                            const bf16* a0, const bf16* b0,
                                            float (&acc1)[8][4],
                                            const bf16* a1, const bf16* b1) {
  constexpr int LD = 16 * DC + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc0[j][e] = acc1[j][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < DC; ++kd) {
    uint32_t f0[4], f1[4];
    const int aoff = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                     (2 * kd + (lane >> 4)) * 8;
    ldsm_x4(f0, a0 + aoff);
    ldsm_x4(f1, a1 + aoff);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t g0[4], g1[4];
      const int boff = (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                       (2 * kd + ((lane >> 3) & 1)) * 8;
      ldsm_x4(g0, b0 + boff);
      ldsm_x4(g1, b1 + boff);
      mma_bf16(acc0[2 * np], f0, g0[0], g0[1]);
      mma_bf16(acc0[2 * np + 1], f0, g0[2], g0[3]);
      mma_bf16(acc1[2 * np], f1, g1[0], g1[1]);
      mma_bf16(acc1[2 * np + 1], f1, g1[2], g1[3]);
    }
  }
}

// out[16 x D] += P C over the 64 tile rows: P the warp's 16 x 64 float32
// score fragments, split here into bf16 hi + lo A operands as they stand
// (about 16 mantissa bits, two products), C 64 shared rows of D (+8) bf16
// (the B operand, through ldmatrix.trans, used by both).
template <int DC>
__device__ __forceinline__ void fb_mma_pc(float (&out)[2 * DC][4],
                                          const float (&p)[8][4],
                                          const bf16* c) {
  constexpr int LD = 16 * DC + 8;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t hi[4], lo[4];
    split_bf16(p[2 * kk][0], p[2 * kk][1], hi[0], lo[0]);
    split_bf16(p[2 * kk][2], p[2 * kk][3], hi[1], lo[1]);
    split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], hi[2], lo[2]);
    split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int dp = 0; dp < DC; ++dp) {
      uint32_t bc[4];
      ldsm_x4_t(bc, c + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                        (2 * dp + (lane >> 4)) * 8);
      mma_bf16(out[2 * dp], hi, bc[0], bc[1]);
      mma_bf16(out[2 * dp], lo, bc[0], bc[1]);
      mma_bf16(out[2 * dp + 1], hi, bc[2], bc[3]);
      mma_bf16(out[2 * dp + 1], lo, bc[2], bc[3]);
    }
  }
}

// q, o, do, dq: [B, Sq, H, D] bf16; k, v: [B, Sk, KH, D] bf16; lse, delta:
// [B, H, Sq] float32.  grid (ceil(Sq / FB_T), B * H), 32 FB_WARPS threads.
// scale_log2: the softmax scale times log2(e).
template <int DC>
__global__ void __launch_bounds__(32 * FB_WARPS)
    flash_attention_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                                      const bf16* __restrict__ k,
                                      const bf16* __restrict__ v,
                                      const bf16* __restrict__ o,
                                      const bf16* __restrict__ dout,
                                      const float* __restrict__ lse,
                                      float* __restrict__ delta,
                                      bf16* __restrict__ dq, int Sq, int Sk,
                                      int H, int KH, float scale,
                                      float scale_log2, int causal) {
  constexpr int D = 16 * DC, LD = D + 8;
  extern __shared__ __align__(16) unsigned char fb_mma_smem[];
  bf16* qs = reinterpret_cast<bf16*>(fb_mma_smem);   // [T][LD]
  bf16* dos = qs + FB_T * LD;                        // [T][LD]
  bf16* ks = dos + FB_T * LD;                        // [2][T][LD]
  bf16* vs = ks + 2 * FB_T * LD;                     // [2][T][LD]
  float* lse_s = reinterpret_cast<float*>(vs + 2 * FB_T * LD);  // log2
  float* dl_s = lse_s + FB_T;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * FB_T;   // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = 16 * warp;                 // this warp's first tile row
  const long long q_stride = (long long)H * D, kv_stride = (long long)KH * D;
  const long long qoff = ((long long)b * Sq * H + h) * D;
  const long long kvoff = ((long long)b * Sk * KH + kh) * D;

  int n_kv = (Sk + FB_T - 1) / FB_T;
  if (causal) {
    const int last = (q0 + FB_T - 1) / FB_T;
    n_kv = last + 1 < n_kv ? last + 1 : n_kv;
  }
  fb_cp_tile<D>(qs, q + qoff, q0, Sq, q_stride);
  fb_cp_tile<D>(dos, dout + qoff, q0, Sq, q_stride);
  fb_cp_tile<D>(ks, k + kvoff, 0, Sk, kv_stride);
  fb_cp_tile<D>(vs, v + kvoff, 0, Sk, kv_stride);
  cp_async_commit();   // group 0: q, do and kv tile 0
  fb_delta<bf16, D>(dout + qoff, o + qoff, lse + (long long)bh * Sq,
                    delta + (long long)bh * Sq, dl_s, lse_s, FA_LOG2E, q0,
                    Sq, q_stride, FB_WARPS);

  float acc[2 * DC][4];
#pragma unroll
  for (int j = 0; j < 2 * DC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int t = 0; t < n_kv; ++t) {
    if (t + 1 < n_kv) {
      fb_cp_tile<D>(ks + ((t + 1) & 1) * FB_T * LD, k + kvoff, (t + 1) * FB_T,
                    Sk, kv_stride);
      fb_cp_tile<D>(vs + ((t + 1) & 1) * FB_T * LD, v + kvoff, (t + 1) * FB_T,
                    Sk, kv_stride);
    }
    cp_async_commit();   // possibly empty: keeps one group per step
    cp_async_wait<1>();  // tile t (and q, do) landed for this thread
    __syncthreads();     // ... and for every thread (and lse_s, dl_s)
    const int k0 = t * FB_T;
    // a tile wholly above this warp's rows, or rows past Sq: nothing to do
    if (!(causal && k0 > q0 + wr + 15) && q0 + wr < Sq) {
      const bf16* kt = ks + (t & 1) * FB_T * LD;
      const bf16* vt = vs + (t & 1) * FB_T * LD;
      float s[8][4], dp[8][4];
      fb_mma_ab_t<DC>(s, qs + wr * LD, kt, dp, dos + wr * LD, vt);
      const bool need_mask = k0 + FB_T > Sk || q0 + wr + 16 > Sq ||
                             (causal && k0 + FB_T - 1 > q0 + wr);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = wr + g + 8 * (e >> 1);
          float p = exp2f(s[j][e] * scale_log2 - lse_s[r]);
          if (need_mask) {
            const int kpos = k0 + 8 * j + 2 * t4 + (e & 1), qpos = q0 + r;
            if (kpos >= Sk || qpos >= Sq || (causal && kpos > qpos)) p = 0.f;
          }
          s[j][e] = p * (dp[j][e] - dl_s[r]);   // ds
        }
      fb_mma_pc<DC>(acc, s, kt);                // dq += ds k
    }
    __syncthreads();   // stage t & 1 is free for tile t + 2
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int qpos = q0 + wr + g + 8 * rr;
    if (qpos >= Sq) continue;
    bf16* row = dq + qoff + qpos * q_stride + 2 * t4;
#pragma unroll
    for (int j = 0; j < 2 * DC; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          pack_bf16(acc[j][2 * rr] * scale, acc[j][2 * rr + 1] * scale);
  }
}

// q, do: [B, Sq, H, D] bf16; k, v, dk, dv: [B, Sk, KH, D] bf16; lse,
// delta: [B, H, Sq] float32.  grid (ceil(Sk / FB_T), B * KH), 32 FB_WARPS
// threads.
template <int DC>
__global__ void __launch_bounds__(32 * FB_WARPS)
    flash_attention_bwd_dkdv_mma_kernel(const bf16* __restrict__ q,
                                        const bf16* __restrict__ k,
                                        const bf16* __restrict__ v,
                                        const bf16* __restrict__ dout,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta,
                                        bf16* __restrict__ dk,
                                        bf16* __restrict__ dv, int Sq,
                                        int Sk, int H, int KH, float scale,
                                        float scale_log2, int causal) {
  constexpr int D = 16 * DC, LD = D + 8;
  extern __shared__ __align__(16) unsigned char fb_mma_smem[];
  bf16* ks = reinterpret_cast<bf16*>(fb_mma_smem);   // [T][LD]
  bf16* vs = ks + FB_T * LD;                         // [T][LD]
  bf16* qs = vs + FB_T * LD;                         // [2][T][LD]
  bf16* dos = qs + 2 * FB_T * LD;                    // [2][T][LD]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * FB_T * LD);  // [2][T]
  float* dl_s = lse_s + 2 * FB_T;                                 // [2][T]

  const int k0 = blockIdx.x * FB_T;   // tile 0 walks the most q tiles
  const int bkh = blockIdx.y;
  const int b = bkh / KH, kh = bkh - (bkh / KH) * KH;
  const int G = H / KH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = 16 * warp;
  const long long q_stride = (long long)H * D, kv_stride = (long long)KH * D;
  const long long kvoff = ((long long)b * Sk * KH + kh) * D;

  const int nq = (Sq + FB_T - 1) / FB_T;
  const int t0 = causal ? k0 / FB_T : 0;   // q tiles wholly before k0: none
  const int nt = nq > t0 ? nq - t0 : 0;
  const int n_it = G * nt;                 // (query head, q tile) pairs
  auto load_q = [&](int it, int st) {
    const int hq = kh * G + it / nt, q0 = (t0 + it % nt) * FB_T;
    const long long qoff = ((long long)b * Sq * H + hq) * D;
    const long long roff = ((long long)b * H + hq) * Sq;
    fb_cp_tile<D>(qs + st * FB_T * LD, q + qoff, q0, Sq, q_stride);
    fb_cp_tile<D>(dos + st * FB_T * LD, dout + qoff, q0, Sq, q_stride);
    for (int i = threadIdx.x; i < FB_T; i += 32 * FB_WARPS) {
      const int s = q0 + i < Sq ? q0 + i : 0;
      cp_async4(lse_s + st * FB_T + i, lse + roff + s, q0 + i < Sq);
      cp_async4(dl_s + st * FB_T + i, delta + roff + s, q0 + i < Sq);
    }
  };
  fb_cp_tile<D>(ks, k + kvoff, k0, Sk, kv_stride);
  fb_cp_tile<D>(vs, v + kvoff, k0, Sk, kv_stride);
  if (n_it > 0) load_q(0, 0);
  cp_async_commit();   // group 0: k, v and the first q tile

  float dka[2 * DC][4], dva[2 * DC][4];
#pragma unroll
  for (int j = 0; j < 2 * DC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load_q(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int st = it & 1, q0 = (t0 + it % nt) * FB_T;
    // kv rows past Sk, or a q tile wholly before this warp's rows
    if (k0 + wr < Sk && !(causal && q0 + FB_T - 1 < k0 + wr)) {
      const bf16* qt = qs + st * FB_T * LD;
      const bf16* dt = dos + st * FB_T * LD;
      const float* ls = lse_s + st * FB_T;
      const float* dl = dl_s + st * FB_T;
      float s[8][4], dp[8][4];   // s^T, dp^T: this warp's kv rows x q
      fb_mma_ab_t<DC>(s, ks + wr * LD, qt, dp, vs + wr * LD, dt);
      const bool need_mask = q0 + FB_T > Sq || k0 + wr + 16 > Sk ||
                             (causal && k0 + wr + 15 > q0);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t4 + (e & 1);
          float p = exp2f(s[j][e] * scale_log2 - ls[c] * FA_LOG2E);
          if (need_mask) {
            const int kpos = k0 + wr + g + 8 * (e >> 1), qpos = q0 + c;
            if (kpos >= Sk || qpos >= Sq || (causal && kpos > qpos)) p = 0.f;
          }
          s[j][e] = p;                          // p^T
          dp[j][e] = p * (dp[j][e] - dl[c]);    // ds^T
        }
      fb_mma_pc<DC>(dva, s, dt);   // dv += p^T do
      fb_mma_pc<DC>(dka, dp, qt);  // dk += ds^T q
    }
    __syncthreads();   // stage it & 1 is free for pair it + 2
  }
  cp_async_wait<0>();
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int kpos = k0 + wr + g + 8 * rr;
    if (kpos >= Sk) continue;
    const long long off = kvoff + kpos * kv_stride + 2 * t4;
#pragma unroll
    for (int j = 0; j < 2 * DC; ++j) {
      *reinterpret_cast<uint32_t*>(dk + off + 8 * j) =
          pack_bf16(dka[j][2 * rr] * scale, dka[j][2 * rr + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + off + 8 * j) =
          pack_bf16(dva[j][2 * rr], dva[j][2 * rr + 1]);
    }
  }
}

// ------------------------------------------------ bf16 on Hopper, D = 64, 128
// The backward's bf16 kernels at the head dims of the full configs (64:
// qwen2-0.5b, seamless; 128: the others).  Like the mma.sync kernels above
// they replace no Pallas kernel: the reference takes attention's gradient
// by XLA's autodiff of models/layers.py:123-213.
//
// What bounds them on the H100: operations.  At qwen2-0.5b's training shape
// (B=4, S=1024, H=14, KH=2, D=64, causal) dq's three products (s, dp, dq)
// take 0.0114 ms at the 989 TFLOP/s bf16 rate and dk/dv's four (s, dp, dv,
// dk) 0.0152 ms; their bytes 0.0065 and 0.0045 ms at 3.35 TB/s.  What
// keeps a kernel from that: tiles read once per warp rather than once per
// warp group, a block barrier at every copy, and, for dk/dv, one block
// walking all of a kv tile's G x nq (query head, q tile) pairs: at the
// training shape 128 tiles on 132 SMs, the first walking 112 pairs against
// a mean of 59.5.
//
// What the design does about it: both kernels are warp-specialised, 384
// threads: in warp group 0 one warp issues the copies and nothing else
// (its group gives up registers by setmaxnreg), groups 1 and 2 consume.
// Every tile comes by TMA (rank-4 tensor maps over [B, S, heads, D], boxes
// of 64 columns x 1 head x rows x 1 batch, so rows past S read zeros,
// never the next batch's; 128-byte swizzle, two boxes a tile at D = 128)
// into an mbarrier ring with full and empty barriers.  Every product runs
// on wgmma m64nNk16: the two score products (s and dp, or s^T and dp^T)
// with both operands in shared memory, K-major; the accumulating products
// with A in
// registers (the score accumulators turned, as they stand, into bf16 hi +
// lo fragments, as in the mma.sync kernels: one bf16 rounding of ds left
// dq 1.3x beyond its limit) and B in shared memory, MN-major.
//
// * flash_attention_bwd_dkdv_wgmma_kernel: one cluster of two blocks per
//   (64-row kv tile, kv head, batch), tile 0 (the longest walk when
//   causal) first.  Each block's producer brings the tile's K and V once by
//   TMA, then every other (query head, q tile) pair's q and do tiles
//   through a ring (FhStages), and each pair's 64 lse and delta values by
//   cp.async (a [B, H, Sq] float32 row starts at Sq * 4 bytes, not 16-byte
//   aligned at ragged Sq, so not by TMA), their landing counted on the same
//   full barrier.  The block's two consumer groups take its pairs in turn,
//   so the four groups of a cluster take the tile's pairs in turn: at the
//   training shape the longest walk is 28 pairs a group, 56 a block (the
//   128 tiles' pairs spread over 256 blocks on 132 SMs); each
//   group keeps its own 64 x D float32 dk and dv in registers.  At the end
//   the four partial sums meet in a fixed order (the kernel's own comment
//   says which), through shared memory and the other block's shared
//   memory: the same bits every run, with no atomics.
// * flash_attention_bwd_dq_wgmma_kernel: one block per (128-row q tile,
//   batch * head), heaviest tiles first; TMA brings the tile's q and do
//   once, then the kv tiles through a ring (FhStages), each K and V
//   tile serving both groups' 64 rows.  Under the first copies each group
//   computes delta = rowsum(do .* o) of its rows by 16-byte loads and
//   writes it for the dk/dv kernel.
//
// Registers: 384 threads leave 168 a thread; setmaxnreg moves the
// producer group's to the consumers (FH_CONSUMER_REGS).  ptxas gave the
// dk/dv consumers more than 168 only at D = 128 (where dk, dv, s^T, dp^T and
// the fragments come to ~200) and there only where the warp group's index
// comes from a shuffle, which it reads as uniform; the dq kernel measured
// faster without that shuffle.  Hence dk/dv waits for a pair's dv and dk
// before it issues the next pair's scores (a second pair's scores do not
// fit beside them), while dq, whose accumulator is one 64 x D tile, issues
// tile t + 1's scores ahead of tile t's dq products.  The other head dims
// (16, 32, 48, 80, 96, 112) keep the mma.sync kernels above, chosen by D in
// the launchers below under the same launch names.
#define FH_T 64                 // rows of a tile
#define FH_BOX (FH_T * 128)     // bytes of a 64-row box of 64 columns
#define FH_THREADS 384          // a producer warp group, two consumer groups
#define FH_PRODUCER_REGS 40
#define FH_CONSUMER_REGS 232

// Ring stages: dk/dv's q + do pairs (16.5 KB a stage at D = 64, 32.5 at
// 128), dq's k + v tiles (16 KB, 32 KB).  One block an SM either way (384
// threads), so D = 64 takes deep rings.
template <int DB>
struct FhStages {
  static constexpr int kv = DB == 1 ? 8 : 4;
  static constexpr int dq = DB == 1 ? 4 : 3;
};

// The dynamic shared memory rounded up to 1024 bytes (the swizzle's
// period; the launchers ask for 1024 bytes more).
__device__ __forceinline__ unsigned char* fh_align(unsigned char* p) {
  return p + ((1024 - (sm90_addr(p) & 1023)) & 1023);
}

// 2^x on the MUFU unit (ex2.approx, denormals flushed: p underflows to 0).
__device__ __forceinline__ float fh_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Descriptors of one tile of DB boxes, `box_bytes` apart: K-major at
// k-step kk of 16 columns, MN-major at k-step kk of 16 rows.
__device__ __forceinline__ uint64_t fh_kmajor(const unsigned char* t, int kk,
                                              int box_bytes) {
  return wg_desc(t + (kk >> 2) * box_bytes + (kk & 3) * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t fh_mnmajor(const unsigned char* t, int kk,
                                               int box_bytes = FH_BOX) {
  return wg_desc(t + kk * 2048, box_bytes, 1024);
}

// a[64 x 64] = A B^T and b[64 x 64] = C E^T over D = 64 DB columns, all
// four K-major tiles in shared memory (A and C boxes `ab` bytes apart, B
// and E FH_BOX), issued as one wgmma group.
template <int DB>
__device__ __forceinline__ void fh_scores(float (&a)[32], float (&b)[32],
                                          const unsigned char* A,
                                          const unsigned char* B,
                                          const unsigned char* C,
                                          const unsigned char* E, int ab) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * DB; ++kk)
    wgmma_ss_64x64(a, fh_kmajor(A, kk, ab), fh_kmajor(B, kk, FH_BOX),
                   kk == 0);
#pragma unroll
  for (int kk = 0; kk < 4 * DB; ++kk)
    wgmma_ss_64x64(b, fh_kmajor(C, kk, ab), fh_kmajor(E, kk, FH_BOX),
                   kk == 0);
  wg_commit();
}

// A 64 x 64 float32 accumulator as bf16 hi + lo A fragments (pair i of
// the accumulator, elements 2i and 2i + 1, is fragment register i).
__device__ __forceinline__ void fh_split(const float (&x)[32],
                                         uint32_t (&hi)[16],
                                         uint32_t (&lo)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    split_bf16(x[2 * i], x[2 * i + 1], hi[i], lo[i]);
}

// acc[64 x D] += (hi + lo) T over 64 rows of the MN-major tile T: eight
// wgmma, not committed.
template <int D>
__device__ __forceinline__ void fh_accumulate(float (&acc)[D / 2],
                                              const uint32_t (&hi)[16],
                                              const uint32_t (&lo)[16],
                                              const unsigned char* T) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t bd = fh_mnmajor(T, kk);
    wgmma_rs<D>(acc, hi + 4 * kk, bd);
    wgmma_rs<D>(acc, lo + 4 * kk, bd);
  }
}

// The warp's share of a consumer group's release of a ring stage.
__device__ __forceinline__ void fh_release(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// 64 x D float32 accumulator rows (this thread's, times sc) as bf16 into a
// [B, S, heads, D] tensor at rows r0 + 16 warp + g (+ 8), below S.
template <int D>
__device__ __forceinline__ void fh_store(bf16* out, const float (&acc)[D / 2],
                                         float sc, long long base, int r0,
                                         int S, long long stride) {
  const int tid = threadIdx.x & 127;
  const int warp = tid >> 5, g = (tid & 31) >> 2, t4 = tid & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r0 + 16 * warp + g + 8 * rr;
    if (r >= S) continue;
    bf16* row = out + base + r * stride + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          pack_bf16(acc[4 * j + 2 * rr] * sc, acc[4 * j + 2 * rr + 1] * sc);
  }
}

// This thread's 64 x D float32 accumulator into block `rank` of the
// cluster (its xr at the same offset, [D / 8][128] float4), then one
// arrival on that block's rx_bar, released to the cluster.
template <int D>
__device__ __forceinline__ void fh_send(const float (&acc)[D / 2],
                                        float4* xr, uint64_t* rx_bar,
                                        int rank) {
  const int tid = threadIdx.x & 127;
  const uint32_t dst = cluster_map(xr, rank);
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    st_cluster_v4(dst + (i * 128 + tid) * 16, acc[4 * i], acc[4 * i + 1],
                  acc[4 * i + 2], acc[4 * i + 3]);
  mbar_arrive_cluster(cluster_map(rx_bar, rank));
}

// q, do: [B, Sq, H, D]; k, v, dk, dv: [B, Sk, KH, D], bf16, as tensor maps
// (all boxes of 64 rows) and pointers; lse, delta: [B, H, Sq] float32.
// grid (2 ceil(Sk / 64), B * KH) in clusters of two blocks, FH_THREADS.
//
// The two blocks of a cluster share one kv tile: block r takes the pairs
// r, r + 2, ..., and its consumer group c every other one of those, so the
// four groups take the pairs in turn.  A group's pair: s^T and dp^T, then
// p^T and ds^T in their place, their hi + lo fragments, dv += p^T do
// (issued under the split of ds^T) and dk += ds^T q; the next pair's s^T
// and dp^T wait for both (the registers hold no second pair's scores beside
// dk, dv and the fragments), and the other group's products fill the
// tensor cores meanwhile.  The sums: in each block group 0 adds group 1's
// dk to its own, group 1 adds group 0's dv (through the drained ring); then
// block 1 sends its dk to block 0 and block 0 its dv to block 1 (stores
// into the other block's shared memory, an mbarrier there counting them),
// and block 0 writes dk = dk(block 0) + dk(block 1), block 1 dv likewise.
// Each sum is taken in that fixed order: the same bits every run, no
// atomics.
template <int DB>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(FH_THREADS, 1)
    flash_attention_bwd_dkdv_wgmma_kernel(
        const __grid_constant__ CUtensorMap tm_q,
        const __grid_constant__ CUtensorMap tm_do,
        const __grid_constant__ CUtensorMap tm_k,
        const __grid_constant__ CUtensorMap tm_v,
        const float* __restrict__ lse, const float* __restrict__ delta,
        bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk, int H,
        int KH, float scale, float scale_log2, int causal) {
  constexpr int D = 64 * DB, TB = DB * FH_BOX, NS = FhStages<DB>::kv;
  extern __shared__ unsigned char fh_smem[];
  unsigned char* ks = fh_align(fh_smem);   // [TB]
  unsigned char* vs = ks + TB;             // [TB]
  unsigned char* qs = vs + TB;             // [NS][TB]
  unsigned char* dos = qs + NS * TB;       // [NS][TB]
  float4* xr = reinterpret_cast<float4*>(dos + NS * TB);   // [D/8][128]
  float* lse_s = reinterpret_cast<float*>(xr + (D / 8) * 128);   // [NS][64]
  float* dl_s = lse_s + NS * FH_T;                               // [NS][64]
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(dl_s + NS * FH_T);
  uint64_t* rx_bar = kv_bar + 1;           // the other block's half landed
  uint64_t* full = rx_bar + 1;             // [NS]
  uint64_t* empty = full + NS;             // [NS]

  const int rank = blockIdx.x & 1;         // in the cluster
  const int k0 = (blockIdx.x >> 1) * FH_T;   // tile 0 walks the most
  const int b = blockIdx.y / KH, kh = blockIdx.y - b * KH;
  const int G = H / KH;
  const int nq = (Sq + FH_T - 1) / FH_T;
  const int t0 = causal ? k0 / FH_T : 0;   // q tiles wholly before k0: none
  const int nt = nq > t0 ? nq - t0 : 0;
  const int n_it = G * nt;                 // (query head, q tile) pairs
  const int n_loc = (n_it + 1 - rank) / 2;   // this block's: rank + 2 j
  // the warp group, uniform to the compiler: 0 produces, 1 and 2 consume
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    mbar_init(rx_bar, 128);          // the other block's sending group
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1 + 32);   // the expect_tx, 32 cp.async lanes
      mbar_init(empty + s, 4);       // the consuming group's 4 warps
    }
    mbar_init_fence();
  }
  cluster_sync();   // both blocks' barriers exist before any remote arrive

  if (wg == 0) {
    // ------------------------------------------------------- producer
    regs_release<FH_PRODUCER_REGS>();
    const int lane = threadIdx.x;
    if (lane < 32 && n_loc > 0) {
      if (lane == 0) {
        mbar_expect_tx(kv_bar, 2 * TB);
        for (int x = 0; x < DB; ++x) {
          tma_load_4d(ks + x * FH_BOX, &tm_k, kv_bar, 64 * x, kh, k0, b);
          tma_load_4d(vs + x * FH_BOX, &tm_v, kv_bar, 64 * x, kh, k0, b);
        }
      }
      for (int j = 0; j < n_loc; ++j) {
        const int st = j % NS, it = rank + 2 * j;
        if (j >= NS) mbar_wait(empty + st, (j / NS - 1) & 1);
        const int hq = kh * G + it / nt, q0 = (t0 + it % nt) * FH_T;
        if (lane == 0) {
          mbar_expect_tx(full + st, 2 * TB);
          for (int x = 0; x < DB; ++x) {
            tma_load_4d(qs + st * TB + x * FH_BOX, &tm_q, full + st, 64 * x,
                        hq, q0, b);
            tma_load_4d(dos + st * TB + x * FH_BOX, &tm_do, full + st,
                        64 * x, hq, q0, b);
          }
        }
        const long long roff = ((long long)b * H + hq) * Sq;
        for (int i = lane; i < FH_T; i += 32) {
          const bool in = q0 + i < Sq;
          const int s = in ? q0 + i : 0;
          cp_async4(lse_s + st * FH_T + i, lse + roff + s, in);
          cp_async4(dl_s + st * FH_T + i, delta + roff + s, in);
        }
        mbar_arrive_cp_async(full + st);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    regs_claim<FH_CONSUMER_REGS>();
    const int c = wg - 1, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    float s[32], dp[32];                      // s^T, dp^T: kv rows x q
    uint32_t ph[16], pl[16], dh[16], dlo[16];   // p^T, ds^T: hi + lo
    if (n_loc > c) mbar_wait(kv_bar, 0);
    for (int j = c; j < n_loc; j += 2) {
      const int st = j % NS, it = rank + 2 * j;
      mbar_wait(full + st, (j / NS) & 1);
      const unsigned char* qt = qs + st * TB;
      const unsigned char* dt = dos + st * TB;
      fh_scores<DB>(s, dp, ks, qt, vs, dt, FH_BOX);
      wg_wait<0>();
      wg_hold(s);
      wg_hold(dp);
      const int q0 = (t0 + it % nt) * FH_T;
      const float* ls = lse_s + st * FH_T;
      const float* dl = dl_s + st * FH_T;
      const bool need_mask = q0 + FH_T > Sq || k0 + FH_T > Sk ||
                             (causal && k0 + FH_T - 1 > q0);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {   // p^T, ds^T in place of s^T, dp^T
        const int col = 8 * jj + 2 * t4;
        const float2 lv = *reinterpret_cast<const float2*>(ls + col);
        const float2 dv2 = *reinterpret_cast<const float2*>(dl + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l = (e & 1) ? lv.y : lv.x, d = (e & 1) ? dv2.y : dv2.x;
          float p = fh_exp2(s[4 * jj + e] * scale_log2 - l * FA_LOG2E);
          if (need_mask) {
            const int kpos = k0 + 16 * warp + g + 8 * (e >> 1);
            const int qpos = q0 + col + (e & 1);
            if (kpos >= Sk || qpos >= Sq || (causal && kpos > qpos)) p = 0.f;
          }
          s[4 * jj + e] = p;
          dp[4 * jj + e] = p * (dp[4 * jj + e] - d);
        }
      }
      fh_split(s, ph, pl);
      wg_fence();
      fh_accumulate<D>(dva, ph, pl, dt);   // dv += p^T do
      fh_split(dp, dh, dlo);
      wg_fence();
      fh_accumulate<D>(dka, dh, dlo, qt);  // dk += ds^T q
      wg_commit();
      wg_wait<0>();
      wg_hold(dka);
      wg_hold(dva);
      wg_hold(ph);
      wg_hold(pl);
      wg_hold(dh);
      wg_hold(dlo);
      fh_release(empty + st);
    }
    // the sums: first the block's two groups, through the drained ring
    // (group 0 ends with the block's dk, group 1 with its dv), then the
    // cluster's two blocks (block 0 writes dk, block 1 dv)
    named_sync(1, 256);
    float* xk = reinterpret_cast<float*>(qs);   // [D / 2][128]: group 1's dk
    float* xv = xk + (D / 2) * 128;             // [D / 2][128]: group 0's dv
    const long long base = ((long long)b * Sk * KH + kh) * D;
    const long long stride = (long long)KH * D;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) xv[i * 128 + tid] = dva[i];
      named_sync(1, 256);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dka[i] += xk[i * 128 + tid];
      if (rank == 0) {
        mbar_wait<true>(rx_bar, 0);   // block 1's dk
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          const float4 x = xr[i * 128 + tid];
          dka[4 * i] += x.x;
          dka[4 * i + 1] += x.y;
          dka[4 * i + 2] += x.z;
          dka[4 * i + 3] += x.w;
        }
        fh_store<D>(dk, dka, scale, base, k0, Sk, stride);
      } else {
        fh_send<D>(dka, xr, rx_bar, 0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) xk[i * 128 + tid] = dka[i];
      named_sync(1, 256);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dva[i] += xv[i * 128 + tid];
      if (rank == 1) {
        mbar_wait<true>(rx_bar, 0);   // block 0's dv
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {   // dv(block 0) + dv(block 1)
          const float4 x = xr[i * 128 + tid];
          dva[4 * i] = x.x + dva[4 * i];
          dva[4 * i + 1] = x.y + dva[4 * i + 1];
          dva[4 * i + 2] = x.z + dva[4 * i + 2];
          dva[4 * i + 3] = x.w + dva[4 * i + 3];
        }
        fh_store<D>(dv, dva, 1.f, base, k0, Sk, stride);
      } else {
        fh_send<D>(dva, xr, rx_bar, 1);
      }
    }
  }
}

// rowsum of 8 bf16 products (two 16-byte words), in a fixed order.
__device__ __forceinline__ float fh_dot8(uint4 x, uint4 y) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(bf16_lo(xs[i]), bf16_lo(ys[i]), acc);
    acc = fmaf(bf16_hi(xs[i]), bf16_hi(ys[i]), acc);
  }
  return acc;
}

// q, o, do, dq: [B, Sq, H, D]; k, v: [B, Sk, KH, D], bf16, as tensor maps
// (tm_q, tm_do boxes of 128 rows; tm_k, tm_v of 64 rows) and pointers;
// lse, delta: [B, H, Sq] float32.  grid (ceil(Sq / 128), B * H),
// FH_THREADS; consumer group c owns rows 64 c .. 64 c + 63 of the tile.
//
// A group's kv tile t: s and dp (issued ahead), ds in place of dp while
// tile t - 1's dq products run, its hi + lo fragments, tile t + 1's s and dp
// issued, then dq += ds k.
template <int DB>
__global__ void __launch_bounds__(FH_THREADS, 1)
    flash_attention_bwd_dq_wgmma_kernel(
        const __grid_constant__ CUtensorMap tm_q,
        const __grid_constant__ CUtensorMap tm_do,
        const __grid_constant__ CUtensorMap tm_k,
        const __grid_constant__ CUtensorMap tm_v, const bf16* __restrict__ o,
        const bf16* __restrict__ dout, const float* __restrict__ lse,
        float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Sk,
        int H, int KH, float scale, float scale_log2, int causal) {
  constexpr int D = 64 * DB, TB = DB * FH_BOX, QB = 2 * FH_BOX;
  constexpr int NS = FhStages<DB>::dq;
  extern __shared__ unsigned char fh_smem[];
  unsigned char* qs = fh_align(fh_smem);   // [DB][QB]: 128 rows a box
  unsigned char* dos = qs + DB * QB;       // [DB][QB]
  unsigned char* ks = dos + DB * QB;       // [NS][TB]
  unsigned char* vs = ks + NS * TB;        // [NS][TB]
  float* dl_s = reinterpret_cast<float*>(vs + NS * TB);   // [2][64]
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(dl_s + 2 * FH_T);
  uint64_t* full = q_bar + 1;              // [NS]
  uint64_t* empty = full + NS;             // [NS]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * 2 * FH_T;   // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int kh = h / (H / KH);
  int n_kv = (Sk + FH_T - 1) / FH_T;
  if (causal) {
    const int last = (q0 + 2 * FH_T - 1) / FH_T;
    n_kv = last + 1 < n_kv ? last + 1 : n_kv;
  }
  const int wg = threadIdx.x >> 7;   // 0 produces, 1 and 2 consume

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);   // both groups' 4 warps
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------- producer
    regs_release<FH_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, 4 * TB);
      for (int x = 0; x < DB; ++x) {
        tma_load_4d(qs + x * QB, &tm_q, q_bar, 64 * x, h, q0, b);
        tma_load_4d(dos + x * QB, &tm_do, q_bar, 64 * x, h, q0, b);
      }
      for (int t = 0; t < n_kv; ++t) {
        const int st = t % NS;
        if (t >= NS) mbar_wait(empty + st, (t / NS - 1) & 1);
        mbar_expect_tx(full + st, 2 * TB);
        for (int x = 0; x < DB; ++x) {
          tma_load_4d(ks + st * TB + x * FH_BOX, &tm_k, full + st, 64 * x,
                      kh, t * FH_T, b);
          tma_load_4d(vs + st * TB + x * FH_BOX, &tm_v, full + st, 64 * x,
                      kh, t * FH_T, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    regs_claim<FH_CONSUMER_REGS>();
    const int c = wg - 1, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int r0 = q0 + c * FH_T;            // this group's first row
    const long long q_stride = (long long)H * D;
    const long long qbase = ((long long)b * Sq * H + h) * D;
    {   // delta of the group's rows, two threads a row, under the copies
      const int row = tid >> 1, half = tid & 1, s = r0 + row;
      float acc = 0.f;
      if (s < Sq) {
        const long long off = qbase + s * q_stride + half * (D / 2);
        const uint4* x = reinterpret_cast<const uint4*>(dout + off);
        const uint4* y = reinterpret_cast<const uint4*>(o + off);
#pragma unroll
        for (int ch = 0; ch < D / 16; ++ch)
          acc += fh_dot8(__ldg(x + ch), __ldg(y + ch));
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (half == 0) {
        dl_s[c * FH_T + row] = acc;
        if (s < Sq) delta[(long long)bh * Sq + s] = acc;
      }
    }
    named_sync(2 + c, 128);
    float lse2[2], dl2[2];   // rows 16 warp + g (+ 8) of the group
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 16 * warp + g + 8 * hr;
      lse2[hr] = r0 + r < Sq ? lse[(long long)bh * Sq + r0 + r] * FA_LOG2E
                             : 0.f;
      dl2[hr] = dl_s[c * FH_T + r];
    }
    float dqa[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
    float s[32], dp[32];
    uint32_t dh[16], dlo[16];   // ds: hi + lo
    // the kv tiles this group computes: none for rows past Sq, none past
    // its diagonal when causal
    int end = r0 >= Sq ? 0 : n_kv;
    if (causal && r0 < Sq) {
      const int last = (r0 + FH_T - 1) / FH_T;
      end = last + 1 < n_kv ? last + 1 : n_kv;
    }
    const unsigned char* qc = qs + c * FH_BOX;
    const unsigned char* dc = dos + c * FH_BOX;
    mbar_wait(q_bar, 0);
    if (end > 0) {
      mbar_wait(full, 0);
      fh_scores<DB>(s, dp, qc, ks, dc, vs, QB);
    }
    for (int t = 0; t < end; ++t) {
      const int st = t % NS;
      // s, dp of tile t; dq's products of tile t - 1 may still run
      if (t > 0)
        wg_wait<1>();
      else
        wg_wait<0>();
      wg_hold(s);
      wg_hold(dp);
      const int k0 = t * FH_T;
      const bool need_mask = k0 + FH_T > Sk || r0 + FH_T > Sq ||
                             (causal && k0 + FH_T - 1 > r0);
#pragma unroll
      for (int j = 0; j < 8; ++j)   // ds in place of dp
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          float p = fh_exp2(s[4 * j + e] * scale_log2 - lse2[hr]);
          if (need_mask) {
            const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
            const int qpos = r0 + 16 * warp + g + 8 * hr;
            if (kpos >= Sk || qpos >= Sq || (causal && kpos > qpos)) p = 0.f;
          }
          dp[4 * j + e] = p * (dp[4 * j + e] - dl2[hr]);
        }
      wg_wait<0>();   // dq's products of tile t - 1: fragments, stage free
      wg_hold(dqa);
      wg_hold(dh);
      wg_hold(dlo);
      if (t > 0) fh_release(empty + (t - 1) % NS);
      fh_split(dp, dh, dlo);
      if (t + 1 < end) {   // the next tile's scores ahead of dq's products
        const int sn = (t + 1) % NS;
        mbar_wait(full + sn, ((t + 1) / NS) & 1);
        fh_scores<DB>(s, dp, qc, ks + sn * TB, dc, vs + sn * TB, QB);
      }
      wg_fence();
      fh_accumulate<D>(dqa, dh, dlo, ks + st * TB);   // dq += ds k
      wg_commit();
    }
    if (end > 0) {
      wg_wait<0>();
      wg_hold(dqa);
      wg_hold(dh);
      wg_hold(dlo);
      fh_release(empty + (end - 1) % NS);
    }
    for (int t = end; t < n_kv; ++t) {   // tiles the other group computes
      mbar_wait(full + t % NS, (t / NS) & 1);
      fh_release(empty + t % NS);
    }
    fh_store<D>(dq, dqa, scale, qbase, r0, Sq, q_stride);
  }
}

// ------------------------------------------------------ tensor maps (host)
// A [B, S, heads, D] bf16 tensor as a rank-4 map (D, heads, S, B), boxes of
// 64 columns x 1 head x `rows` rows x 1 batch, 128-byte swizzle; reads past
// S give zeros.  Returns 0 or a cudaError.
static int fh_map(CUtensorMap* m, const void* p, int B, int S, int heads,
                  int D, int rows) {
  const tma_encode_fn enc = tma_encoder();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(p), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DB>
static int fh_dq_launch(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse,
                        void* delta, void* dq, int B, int Sq, int Sk, int H,
                        int KH, float scale, int causal, cudaStream_t s) {
  constexpr int D = 64 * DB, TB = DB * FH_BOX;
  CUtensorMap mq, mdo, mk, mv;
  int err;
  if ((err = fh_map(&mq, q, B, Sq, H, D, 2 * FH_T)) ||
      (err = fh_map(&mdo, dout, B, Sq, H, D, 2 * FH_T)) ||
      (err = fh_map(&mk, k, B, Sk, KH, D, FH_T)) ||
      (err = fh_map(&mv, v, B, Sk, KH, D, FH_T)))
    return err;
  constexpr int NS = FhStages<DB>::dq;
  const int smem =
      1024 + 4 * TB + 2 * NS * TB + 2 * FH_T * 4 + (1 + 2 * NS) * 8;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_bwd_dq_wgmma_kernel<DB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + 2 * FH_T - 1) / (2 * FH_T), B * H);
  flash_attention_bwd_dq_wgmma_kernel<DB><<<grid, FH_THREADS, smem, s>>>(
      mq, mdo, mk, mv, (const bf16*)o, (const bf16*)dout, (const float*)lse,
      (float*)delta, (bf16*)dq, Sq, Sk, H, KH, scale, scale * FA_LOG2E,
      causal);
  return (int)cudaGetLastError();
}

template <int DB>
static int fh_dkdv_launch(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, int B,
                          int Sq, int Sk, int H, int KH, float scale,
                          int causal, cudaStream_t s) {
  constexpr int D = 64 * DB, TB = DB * FH_BOX;
  CUtensorMap mq, mdo, mk, mv;
  int err;
  if ((err = fh_map(&mq, q, B, Sq, H, D, FH_T)) ||
      (err = fh_map(&mdo, dout, B, Sq, H, D, FH_T)) ||
      (err = fh_map(&mk, k, B, Sk, KH, D, FH_T)) ||
      (err = fh_map(&mv, v, B, Sk, KH, D, FH_T)))
    return err;
  constexpr int NS = FhStages<DB>::kv;
  const int smem = 1024 + 2 * TB + 2 * NS * TB + D * 256 +
                   2 * NS * FH_T * 4 + (2 + 2 * NS) * 8;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_bwd_dkdv_wgmma_kernel<DB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(2 * ((Sk + FH_T - 1) / FH_T), B * KH);   // clusters of 2
  flash_attention_bwd_dkdv_wgmma_kernel<DB><<<grid, FH_THREADS, smem, s>>>(
      mq, mdo, mk, mv, (const float*)lse, (const float*)delta, (bf16*)dk,
      (bf16*)dv, Sq, Sk, H, KH, scale, scale * FA_LOG2E, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- launch
template <int DC>
static int fb_dq_launch(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse,
                        void* delta, void* dq, int B, int Sq, int Sk, int H,
                        int KH, float scale, int causal, int bf16_in,
                        cudaStream_t s) {
  const dim3 grid((Sq + FB_T - 1) / FB_T, B * H);
  if (bf16_in) {
    // D = 64 and 128: the Hopper kernel; other head dims: mma.sync
    if constexpr (DC == 4 || DC == 8) {
      return fh_dq_launch<DC / 4>(q, k, v, o, dout, lse, delta, dq, B, Sq,
                                  Sk, H, KH, scale, causal, s);
    } else {
      constexpr int LD = 16 * DC + 8;
      const int smem = (int)sizeof(bf16) * 6 * FB_T * LD +
                       (int)sizeof(float) * 2 * FB_T;
      cudaError_t err = cudaFuncSetAttribute(
          flash_attention_bwd_dq_mma_kernel<DC>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      flash_attention_bwd_dq_mma_kernel<DC><<<grid, 32 * FB_WARPS, smem, s>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
          (const bf16*)dout, (const float*)lse, (float*)delta, (bf16*)dq, Sq,
          Sk, H, KH, scale, scale * FA_LOG2E, causal);
      return (int)cudaGetLastError();
    }
  }
  constexpr int LD = 16 * DC + 1;
  const int smem =
      (int)sizeof(float) * (4 * FB_T * LD + FB_T * FB_LDS + 2 * FB_T);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_dq_fma_kernel<DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_attention_bwd_dq_fma_kernel<DC><<<grid, FA_THREADS, smem, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o,
      (const float*)dout, (const float*)lse, (float*)delta, (float*)dq, Sq,
      Sk, H, KH, scale, causal);
  return (int)cudaGetLastError();
}

template <int DC>
static int fb_dkdv_launch(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, int B,
                          int Sq, int Sk, int H, int KH, float scale,
                          int causal, int bf16_in, cudaStream_t s) {
  const dim3 grid((Sk + FB_T - 1) / FB_T, B * KH);
  if (bf16_in) {
    if constexpr (DC == 4 || DC == 8) {
      return fh_dkdv_launch<DC / 4>(q, k, v, dout, lse, delta, dk, dv, B, Sq,
                                    Sk, H, KH, scale, causal, s);
    } else {
      constexpr int LD = 16 * DC + 8;
      const int smem = (int)sizeof(bf16) * 6 * FB_T * LD +
                       (int)sizeof(float) * 4 * FB_T;
      cudaError_t err = cudaFuncSetAttribute(
          flash_attention_bwd_dkdv_mma_kernel<DC>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      flash_attention_bwd_dkdv_mma_kernel<DC>
          <<<grid, 32 * FB_WARPS, smem, s>>>(
          (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
          (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, Sq, Sk,
          H, KH, scale, scale * FA_LOG2E, causal);
      return (int)cudaGetLastError();
    }
  }
  constexpr int LD = 16 * DC + 1;
  const int smem =
      (int)sizeof(float) * (4 * FB_T * LD + 2 * FB_T * FB_LDS + 2 * FB_T);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_dkdv_fma_kernel<DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  flash_attention_bwd_dkdv_fma_kernel<DC><<<grid, FA_THREADS, smem, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, Sq, Sk,
      H, KH, scale, causal);
  return (int)cudaGetLastError();
}

#define FB_SWITCH(D, CALL)                  \
  switch (D) {                              \
    case 16: return CALL(1);                \
    case 32: return CALL(2);                \
    case 48: return CALL(3);                \
    case 64: return CALL(4);                \
    case 80: return CALL(5);                \
    case 96: return CALL(6);                \
    case 112: return CALL(7);               \
    case 128: return CALL(8);               \
    default: return (int)cudaErrorInvalidValue; \
  }

// The first backward kernel: q, o, do, dq [B, Sq, H, D], k, v [B, Sk, KH,
// D], contiguous, one dtype (bf16 != 0: bfloat16, the tensor-core kernel,
// 16-byte aligned; else float32, the FMA kernel); lse the forward's
// [B, H, Sq] float32.  Writes dq and delta [B, H, Sq] float32.
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, int B, int Sq,
    int Sk, int H, int KH, int D, int causal, int bf16_in, float scale,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define FB_DQ(DC)                                                         \
  fb_dq_launch<DC>(q, k, v, o, dout, lse, delta, dq, B, Sq, Sk, H, KH,   \
                   scale, causal, bf16_in, s)
  FB_SWITCH(D, FB_DQ)
#undef FB_DQ
}

// The second backward kernel, after the first on the same stream: reads
// its delta.  Writes dk, dv [B, Sk, KH, D] in the inputs' dtype.
extern "C" int flash_attention_bwd_dkdv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
    int Sk, int H, int KH, int D, int causal, int bf16_in, float scale,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define FB_DKDV(DC)                                                       \
  fb_dkdv_launch<DC>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, KH, \
                     scale, causal, bf16_in, s)
  FB_SWITCH(D, FB_DKDV)
#undef FB_DKDV
}


// ======================================== forward, bf16 on Hopper (D = 64,
// 80, 128)
// flash_attention_wgmma_kernel: the forward above (the function and contract
// of flash_attention_mma_kernel: GQA by index, the scale 1/sqrt(D) in the exp2
// domain, top-left causal masking, ragged Sq and Sk, -1e30 for masked scores
// and l clamped at 1e-37, bf16 o and the float32 natural-log lse) at the
// head dims of the full configs: 64 (qwen2-0.5b, seamless), 80 (zamba2) and
// 128 (the others).  It replaces the same TPU kernel,
// src/repro/kernels/flash_attention.py: flash_attention_pallas.
//
// What bounds it on the H100: operations at qwen3-14b's prefill (B=4,
// S=1024, H=40, KH=8, D=128, causal: 0.0435 ms at 989 TFLOP/s, its bytes
// 0.0301 ms), bytes at zamba2's (D=80, KH=H: 0.0250 ms against 0.0216).
// What kept the mma.sync kernel at 21-23% of that: each of its four warps
// reading every K and V tile from shared memory by ldmatrix, all threads
// issuing the copies and meeting at two block barriers a tile, the softmax
// between the two products with nothing under it, and 104 KB of shared
// memory a block at D = 128.
//
// What the design does about it: 384 threads, warp-specialised as the
// backward's Hopper kernels.  Warp group 0 gives up registers by setmaxnreg
// and one of its threads issues every copy by TMA (rank-4 tensor maps over
// [B, S, heads, D], so rows past S read zeros, never the next batch's): a
// 128-row q tile a work item, then its K and V tiles of BK keys through an
// mbarrier ring (full and empty barriers).  Groups 1 and 2 each own 64 q
// rows; every product is one wgmma per 16-deep k-step, read once a warp
// group: S = Q K^T with both operands in shared memory, K-major
// (m64nBKk16), and O += P V with P, the score accumulator rounded to bf16,
// as the A operand from registers as it stands, and V MN-major (m64nPDk16).
// The online softmax stays in float32 registers (one FFMA and one exp2 a
// score).  Its exp2 runs under products: a group issues tile t's S and tile
// t - 1's P V together, waits for S alone, computes tile t's probabilities
// while P V runs, then waits for P V and rescales O (not at all where no
// row max of the warp moved).  At D = 64 the two groups also take turns
// to issue (an mbarrier each), so one group's exp2 runs under the other's
// products; at D = 80 and 128 the turns measured slower.
//
// Persistent: one block an SM walks (q tile, batch * head) items, the
// heaviest q tiles first, dealt forwards and backwards in turn (fw_item).
// Across items the ring runs on, q has two buffers (the next item's q and
// first kv tiles load while this one computes), and o leaves by a TMA
// store from the group's own rows of the q buffer.  Without these three
// the kernel measured 1.41x slower at qwen3-14b's shape and 1.42x at
// zamba2's: with a block a q tile, every
// block's first loads and last stores stood in the open; with one q
// buffer the ring ran dry at every item; 4-byte stores of o from
// registers cost as much as all the loads.
//
// Tile widths and ring.  Registers a consumer thread: S BK / 2, P BK / 4
// and O PD / 2 floats.  ptxas holds the consumers to 168 registers in some
// builds whatever setmaxnreg gives, and 128-key tiles at D = 80 and 128
// (S 64 + P 32 + O 64) then spill: 64 keys there, 128 at D = 64 (one
// m64n128k16 per k-step of S; measured faster than 64).  The ring takes
// as many K + V stages as shared memory holds beside two q tiles: six at
// D = 64, five at D = 80 and 128 (32 KB each).  One block an SM.
//
// D = 80 takes two 64-column boxes whose map ends at column 80: TMA fills
// columns 80-127 with zeros, S runs five k-steps (the zero tail adds
// nothing), P V runs at 128 columns, and the store of o is clipped at 80.
template <int D>
struct FwTile {
  static constexpr int NC = 2;               // consumer groups
  static constexpr int BQ = 64 * NC;         // q rows a block: 64 a group
  static constexpr int QBOX = BQ * 128;      // bytes of a q box
  static constexpr int DB = (D + 63) / 64;   // 64-column boxes a row
  static constexpr int PD = 64 * DB;         // columns of P V
  static constexpr int KS = D / 16;          // k-steps of S
  static constexpr bool TURNS = D == 64;   // the groups take turns
  static constexpr int BK = DB == 1 ? 128 : 64;   // keys a kv tile
  static constexpr int KBOX = BK * 128;       // bytes of a K or V box
  static constexpr int STAGE = 2 * DB * KBOX;  // K + V bytes
  // ring stages: as many as a block's shared memory holds beside q and
  // the barriers
  static constexpr int NS = (232448 - 1024 - 256 - 2 * DB * QBOX) / STAGE;
  static constexpr int SMEM =
      1024 + 2 * DB * QBOX + NS * STAGE + (4 + NC + 2 * NS) * 8;
};

// s[64 x BK] = Q K^T over D: Q's 64 rows (boxes QBOX apart) and the K
// tile (boxes KBOX apart), K-major in shared memory; not committed.
template <int D>
__device__ __forceinline__ void fw_scores(float (&s)[FwTile<D>::BK / 2],
                                          const unsigned char* qt,
                                          const unsigned char* kt) {
  using T = FwTile<D>;
#pragma unroll
  for (int kk = 0; kk < T::KS; ++kk)
    wgmma_ss<T::BK>(s, fh_kmajor(qt, kk, T::QBOX), fh_kmajor(kt, kk, T::KBOX),
                    kk == 0);
}

// o[64 x PD] += P V over the tile's BK keys, V MN-major; not committed.
template <int D>
__device__ __forceinline__ void fw_pv(float (&o)[FwTile<D>::PD / 2],
                                      const uint32_t (&p)[FwTile<D>::BK / 4],
                                      const unsigned char* vt) {
  using T = FwTile<D>;
#pragma unroll
  for (int kk = 0; kk < T::BK / 16; ++kk)
    wgmma_rs<T::PD>(o, p + 4 * kk, fh_mnmajor(vt, kk, T::KBOX));
}

// The online softmax of one kv tile on this thread's rows qrow, qrow + 8:
// the scores (masked to -1e30 where need_mask) become exp2(s scale_log2 -
// m) in place, one FFMA and one exp2 each, m the new running max in the
// exp2 domain (the row max of the raw scores, scaled: scale_log2 > 0), l
// updated; corr the factor by which O must be rescaled.
template <int BK>
__device__ __forceinline__ void fw_softmax(float (&s)[BK / 2],
                                           float (&m)[2], float (&l)[2],
                                           float (&corr)[2], bool need_mask,
                                           int k0, int qrow, int Sk,
                                           int causal, float scale_log2) {
  const int t4 = threadIdx.x & 3;
  float mx[2] = {FA_NEG_INF, FA_NEG_INF};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (need_mask) {
        const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
        const int qpos = qrow + 8 * (e >> 1);
        if (kpos >= Sk || (causal && kpos > qpos)) s[4 * j + e] = FA_NEG_INF;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
  float rs[2] = {0.f, 0.f}, nm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {   // a row's 4 threads: lanes 4 g .. 4 g + 3
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    corr[r] = fh_exp2(m[r] - m_new);
    m[r] = m_new;
    nm[r] = -m_new;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const float x = fmaf(s[i], scale_log2, nm[(i >> 1) & 1]);
    s[i] = fh_exp2(x);
    rs[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
}

// The (q tile, batch * head) work item w of the persistent walk: q tiles
// heaviest first (the last tile walks the most kv tiles when causal), each
// round of `blocks` items dealt to the blocks forwards, the next round
// backwards, so no block takes the heaviest item of every round.
__device__ __forceinline__ int fw_item(int round, int blocks) {
  return round * blocks +
         ((round & 1) ? blocks - 1 - (int)blockIdx.x : (int)blockIdx.x);
}

// q: [B, Sq, H, D]; k, v: [B, Sk, KH, D]; o: [B, Sq, H, D], bf16, as
// tensor maps (tm_q boxes of 128 rows, tm_k and tm_v of BK, tm_o of 64);
// lse [B, H, Sq] float32 or null.  Persistent: grid min(items, SMs),
// FH_THREADS; each block walks the items fw_item gives it; group c owns rows
// 64 c .. 64 c + 63 of an item's q tile.  The ring's stages and phases run
// on across items (a running count of kv tiles); the q tile has two
// buffers, item r the (r & 1)-th, so the producer loads the next item's q
// and its first kv tiles while the groups still work on this one.  A
// group's o goes out through its own 64 rows of the q buffer (free once its
// last S is done), in the map's swizzled box layout, by a TMA store.
template <int D>
__global__ void __launch_bounds__(FH_THREADS, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                 const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v,
                                 const __grid_constant__ CUtensorMap tm_o,
                                 float* __restrict__ lse, int B, int Sq,
                                 int Sk, int H, int KH, float scale_log2,
                                 int causal) {
  using T = FwTile<D>;
  constexpr int DB = T::DB, NS = T::NS, BK = T::BK, NC = T::NC, BQ = T::BQ;
  extern __shared__ unsigned char fh_smem[];
  constexpr int QT = DB * T::QBOX;           // bytes of a q tile
  unsigned char* qs = fh_align(fh_smem);      // [2][DB][QBOX]
  unsigned char* ring = qs + 2 * QT;          // [NS][K: DB boxes, V: DB]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + NS * T::STAGE);
  uint64_t* q_empty = q_full + 2;             // [2]: both groups done
  uint64_t* full = q_empty + 2;               // [NS]
  uint64_t* empty = full + NS;                // [NS]
  uint64_t* turn = empty + NS;                // [NC]: group c may issue

  const int BH = B * H, nq = (Sq + BQ - 1) / BQ;
  const int n_items = nq * BH, blocks = (int)gridDim.x;
  const int n_rounds = (n_items + blocks - 1) / blocks;
  // item w: its batch * head, first q row, and the kv tiles it walks (the
  // causal skip: none wholly above its rows)
  auto item = [&](int w, int& bh, int& q0) {
    bh = w % BH;
    q0 = (nq - 1 - w / BH) * BQ;
    int n = (Sk + BK - 1) / BK;
    if (causal) {
      const int last = (q0 + BQ - 1) / BK;
      n = last + 1 < n ? last + 1 : n;
    }
    return n;
  };
  // the kv tiles group c computes of an item's n: none for rows past Sq,
  // none wholly above its rows when causal (taking turns, all n: both
  // groups then take as many turns)
  auto group_end = [&](int c, int q0, int n) {
    const int r0 = q0 + 64 * c;
    if (r0 >= Sq) return 0;
    if (!causal || T::TURNS) return n;
    const int last = (r0 + 63) / BK;
    return last + 1 < n ? last + 1 : n;
  };
  // the warp group, uniform to the compiler: 0 produces, 1 and 2 consume
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);

  if (threadIdx.x == 0) {
    for (int x = 0; x < 2; ++x) {
      mbar_init(q_full + x, 1);
      mbar_init(q_empty + x, NC);   // each group, once its o is out
    }
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * NC);   // every group's 4 warps
    }
    for (int x = 0; x < NC; ++x)
      mbar_init(turn + x, 4);     // the group before's 4 warps
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ------------------------------------------------------- producer
    regs_release<FH_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int it = 0;   // kv tiles loaded, over all items
      for (int r = 0; r < n_rounds; ++r) {
        const int w = fw_item(r, blocks);
        if (w >= n_items) continue;
        int bh, q0;
        const int n = item(w, bh, q0);
        const int b = bh / H, h = bh - b * H, kh = h / (H / KH);
        const int qb = r & 1;   // item r's q buffer, its (r >> 1)-th use
        if (r >= 2) mbar_wait(q_empty + qb, ((r >> 1) - 1) & 1);
        mbar_expect_tx(q_full + qb, QT);
        for (int x = 0; x < DB; ++x)
          tma_load_4d(qs + qb * QT + x * T::QBOX, &tm_q, q_full + qb, 64 * x,
                      h, q0, b);
        for (int t = 0; t < n; ++t, ++it) {
          const int st = it % NS;
          unsigned char* kt = ring + st * T::STAGE;
          if (it >= NS) mbar_wait(empty + st, (it / NS - 1) & 1);
          mbar_expect_tx(full + st, T::STAGE);
          for (int x = 0; x < DB; ++x) {
            tma_load_4d(kt + x * T::KBOX, &tm_k, full + st, 64 * x, kh,
                        t * BK, b);
            tma_load_4d(kt + (DB + x) * T::KBOX, &tm_v, full + st, 64 * x,
                        kh, t * BK, b);
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    regs_claim<FH_CONSUMER_REGS>();
    const int c = wg - 1, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    int it = 0, turns = 0;
    float oa[T::PD / 2];
    float s[BK / 2];
    uint32_t p[BK / 4];
    for (int r = 0; r < n_rounds; ++r) {
      const int w = fw_item(r, blocks);
      if (w >= n_items) continue;
      int bh, q0;
      const int n = item(w, bh, q0);
      const int r0 = q0 + 64 * c;              // this group's first row
      const int qrow = r0 + 16 * warp + g;     // this thread's rows (+ 8)
      const int end = group_end(c, q0, n);
      // turns: only where every group walks the item's tiles (the last
      // group has rows: a test uniform in the block), group 0 first; each
      // waits on its own barrier and, once its products are issued, lets
      // the next go (the last group skips its last pass, so every phase is
      // waited on)
      const bool pp = T::TURNS && group_end(NC - 1, q0, n) > 0;
      auto take_turn = [&]() {
        if (pp) mbar_wait(turn + c, turns++ & 1);
      };
      auto pass_turn = [&](bool last) {
        if (pp && !(c == NC - 1 && last)) fh_release(turn + (c + 1) % NC);
      };
      auto need_mask = [&](int k0) {
        return k0 + BK > Sk || (causal && k0 + BK - 1 > r0);
      };
      if (pp && c == NC - 1) fh_release(turn);
#pragma unroll
      for (int i = 0; i < T::PD / 2; ++i) oa[i] = 0.f;
      float m[2] = {FA_NEG_INF, FA_NEG_INF}, l[2] = {0.f, 0.f}, corr[2];
      const int qb = r & 1;
      unsigned char* qt = qs + qb * QT + c * FH_BOX;   // 64 rows of a box
      mbar_wait(q_full + qb, (r >> 1) & 1);
      if (end > 0) {   // tile 0: S, then its probabilities
        mbar_wait(full + it % NS, (it / NS) & 1);
        take_turn();
        wg_fence();
        fw_scores<D>(s, qt, ring + (it % NS) * T::STAGE);
        wg_commit();
        pass_turn(false);
        wg_wait<0>();
        wg_hold(s);
        fw_softmax<BK>(s, m, l, corr, need_mask(0), 0, qrow, Sk, causal,
                       scale_log2);
#pragma unroll
        for (int i = 0; i < BK / 4; ++i)
          p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
      }
      for (int t = 1; t < end; ++t) {
        // tile t's S and tile t - 1's P V issued together; the
        // probabilities of tile t computed while P V runs
        const int st = (it + t) % NS, sp = (it + t - 1) % NS;
        mbar_wait(full + st, ((it + t) / NS) & 1);
        take_turn();
        wg_fence();
        fw_scores<D>(s, qt, ring + st * T::STAGE);
        wg_commit();
        fw_pv<D>(oa, p, ring + sp * T::STAGE + DB * T::KBOX);
        wg_commit();
        pass_turn(false);
        wg_wait<1>();
        wg_hold(s);
        const int k0 = t * BK;
        fw_softmax<BK>(s, m, l, corr, need_mask(k0), k0, qrow, Sk, causal,
                       scale_log2);
        wg_wait<0>();
        wg_hold(oa);
        wg_hold(p);
        fh_release(empty + sp);
        // O's rescale, skipped where no row max of the warp moved
        if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
          for (int i = 0; i < T::PD / 2; ++i) oa[i] *= corr[(i >> 1) & 1];
        }
#pragma unroll
        for (int i = 0; i < BK / 4; ++i)
          p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
      }
      if (end > 0) {   // the last tile's P V
        const int sp = (it + end - 1) % NS;
        take_turn();
        wg_fence();
        fw_pv<D>(oa, p, ring + sp * T::STAGE + DB * T::KBOX);
        wg_commit();
        pass_turn(true);
        wg_wait<0>();
        wg_hold(oa);
        wg_hold(p);
        fh_release(empty + sp);
      }
      for (int t = end; t < n; ++t) {   // tiles only the other group needs
        mbar_wait(full + (it + t) % NS, ((it + t) / NS) & 1);
        fh_release(empty + (it + t) % NS);
      }
      it += n;

      // o = O / l as bf16 into the group's rows of the q buffer (box x of
      // 64 columns, 16-byte chunk j ^ (row & 7) of a 128-byte row: the
      // 128-byte swizzle, no bank conflicts), then one TMA store a box,
      // clipped at Sq and D; lse directly
      const int b = bh / H, h = bh - b * H;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float lr = l[rr];
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        const int row = 16 * warp + g + 8 * rr, qpos = r0 + row;
        const float inv = 1.f / fmaxf(lr, 1e-37f);
        if (lse && t4 == 0 && qpos < Sq && end > 0)
          lse[(long long)bh * Sq + qpos] =
              (m[rr] + log2f(fmaxf(lr, 1e-37f))) * FA_LN2;
#pragma unroll
        for (int j = 0; j < D / 8 && end > 0; ++j)
          *reinterpret_cast<uint32_t*>(
              qt + (j >> 3) * T::QBOX + row * 128 +
              (((j & 7) ^ (row & 7)) << 4) + 4 * t4) =
              pack_bf16(oa[4 * j + 2 * rr] * inv,
                        oa[4 * j + 2 * rr + 1] * inv);
      }
      fence_async_smem();
      named_sync(1 + c, 128);   // the group's rows written
      if (tid == 0) {
        if (end > 0) {
          for (int x = 0; x < DB; ++x)
            tma_store_4d(&tm_o, qt + x * T::QBOX, 64 * x, h, r0, b);
          tma_store_commit();
          tma_store_wait_read();
        }
        mbar_arrive(q_empty + qb);   // the buffer may take the next q
      }
      __syncwarp();
    }
    if (tid == 0)   // the last stores done before the block ends
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// The card's SM count: the persistent grid.
static int fw_sms() {
  static const int n = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    return sms;
  }();
  return n;
}


template <int D>
static int fa_wgmma_launch(const void* q, const void* k, const void* v,
                           void* o, float* lse, int B, int Sq, int Sk, int H,
                           int KH, float scale, int causal, cudaStream_t s) {
  CUtensorMap mq, mk, mv, mo;
  int err;
  using T = FwTile<D>;
  if ((err = fh_map(&mq, q, B, Sq, H, D, T::BQ)) ||
      (err = fh_map(&mk, k, B, Sk, KH, D, FwTile<D>::BK)) ||
      (err = fh_map(&mv, v, B, Sk, KH, D, FwTile<D>::BK)) ||
      (err = fh_map(&mo, o, B, Sq, H, D, 64)))
    return err;
  const int sms = fw_sms();
  if (sms <= 0) return (int)cudaErrorInvalidValue;
  constexpr int smem = FwTile<D>::SMEM;
  const cudaError_t e =
      smem_attribute_once<flash_attention_wgmma_kernel<D>>(smem);
  if (e != cudaSuccess) return (int)e;
  const long long items = (long long)B * H * ((Sq + T::BQ - 1) / T::BQ);
  const int grid = items < sms ? (int)items : sms;
  flash_attention_wgmma_kernel<D><<<grid, FH_THREADS, smem, s>>>(
      mq, mk, mv, mo, lse, B, Sq, Sk, H, KH, scale * FA_LOG2E, causal);
  return (int)cudaGetLastError();
}
