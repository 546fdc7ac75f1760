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
// What the design does about it: two kernels, chosen by dtype in the open
// (no fallback between them):
//
// * bf16, flash_attention_mma_kernel (FA2-style).  One block per q tile of
//   one batch*head, 4 warps, heaviest tiles launched first.  A tile is 128
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
// Both: GQA by index (kv head h / (H / KH)) from [B, S, KH, D], no repeat
// and no D padding (D a multiple of 16 up to 128, so D = 80 is five k-steps
// of 16 and ten n-tiles of 8); the causal skip of kv tiles above the
// diagonal; ragged S masked in-kernel with -1e30 (not -inf) and l clamped
// at 1e-37, as in the Pallas kernel, so no row is NaN.
#include <cuda_runtime.h>

#include "mma.cuh"

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
                               float* __restrict__ o, int Sq, int Sk, int H,
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
  }
}


// ------------------------------------------------------------------- bf16
#define FA_STAGES 2
#define FA_WARPS 4
#define FA_MT 2   // 16-row m-tiles of a warp: q tiles of 16 FA_MT FA_WARPS
#define FA_LOG2E 1.4426950408889634f

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
                               bf16* __restrict__ o, int Sq, int Sk, int H,
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
                         int B, int Sq, int Sk, int H, int KH, float scale,
                         int causal, cudaStream_t stream) {
  constexpr int D = 16 * DC;
  const int smem = (int)sizeof(float) *
                   (2 * FA_BQ * (D + 1) + FA_BK * D + FA_BQ * (FA_BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fma_kernel<DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + FA_BQ - 1) / FA_BQ, B * H);
  flash_attention_fma_kernel<DC><<<grid, FA_THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, Sq, Sk, H,
      KH, scale, causal);
  return (int)cudaGetLastError();
}

template <int DC>
static int fa_mma_launch(const void* q, const void* k, const void* v, void* o,
                         int B, int Sq, int Sk, int H, int KH, float scale,
                         int causal, cudaStream_t stream) {
  constexpr int LD = 16 * DC + 8, BQ = 16 * FA_MT * FA_WARPS;
  const int smem = (int)sizeof(bf16) * LD * (BQ + 2 * FA_STAGES * FA_BK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_mma_kernel<DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_attention_mma_kernel<DC><<<grid, 32 * FA_WARPS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, Sq, Sk, H, KH,
      scale * FA_LOG2E, causal);
  return (int)cudaGetLastError();
}

template <int DC>
static int fa_launch(const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Sk, int H, int KH, float scale,
                     int causal, int bf16_in, cudaStream_t s) {
  if (!bf16_in)
    return fa_fma_launch<DC>(q, k, v, o, B, Sq, Sk, H, KH, scale, causal, s);
  return fa_mma_launch<DC>(q, k, v, o, B, Sq, Sk, H, KH, scale, causal, s);
}

// q: [B, Sq, H, D], k/v: [B, Sk, KH, D], o: [B, Sq, H, D], all contiguous,
// one dtype: bf16 != 0 takes the bfloat16 tensor-core kernel (128-row q
// tiles), bf16 == 0 the float32 FMA kernel (64-row tiles).  D in {16, 32,
// ..., 128}, H a multiple of KH; the bf16 pointers 16-byte aligned.
// Writes o.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Sk, int H, int KH, int D, int causal,
                                      int bf16_in, float scale,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return fa_launch<1>(q, k, v, o, B, Sq, Sk, H, KH, scale, causal, bf16_in, s);
    case 32: return fa_launch<2>(q, k, v, o, B, Sq, Sk, H, KH, scale, causal, bf16_in, s);
    case 48: return fa_launch<3>(q, k, v, o, B, Sq, Sk, H, KH, scale, causal, bf16_in, s);
    case 64: return fa_launch<4>(q, k, v, o, B, Sq, Sk, H, KH, scale, causal, bf16_in, s);
    case 80: return fa_launch<5>(q, k, v, o, B, Sq, Sk, H, KH, scale, causal, bf16_in, s);
    case 96: return fa_launch<6>(q, k, v, o, B, Sq, Sk, H, KH, scale, causal, bf16_in, s);
    case 112: return fa_launch<7>(q, k, v, o, B, Sq, Sk, H, KH, scale, causal, bf16_in, s);
    case 128: return fa_launch<8>(q, k, v, o, B, Sq, Sk, H, KH, scale, causal, bf16_in, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
