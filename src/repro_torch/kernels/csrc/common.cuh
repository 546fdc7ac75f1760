// Device helpers shared by the wave engine's CUDA kernels.
//
// All data is int32 (keys, CIDs, TIDs, SIDs, payloads); results are exact and
// must match the plain PyTorch versions in kernels/ref.py bit for bit.
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

// Bytes of the [T, T] potential matrix one thread computes and stores
// (one 16-byte store).
#define POT_UNIT 16

// Store row of a request key: negative NOP padding and out-of-range keys are
// clipped into [0, n_rows) so they can never wrap to the last row.
__device__ __forceinline__ long long clip_row(int key, int n_rows) {
  return key < 0 ? 0 : (key >= n_rows ? n_rows - 1 : key);
}

// What a group of lanes finds in one ring (ring_pick): the group's slot
// and newest visible CID, and this lane's own candidate with its fields.
template <int kN>
struct RingPick {
  int slot;                   // the first slot reaching best (0 if none is)
  int best;                   // the newest visible CID, -1 where none is
  bool mine;                  // this lane's candidate is `slot` (live only)
  int cid, tid;               // this lane's candidate's raw cid and tid
  int more[kN > 0 ? kN : 1];  // and its kN further fields
};

// Newest visible version in one ring (paper §IV-B read rule), read by a
// group of Vg lanes: ok = tid != -1 && cid <= ceil; best = max over slots
// of (ok ? cid : -1); slot = the FIRST slot reaching best (an all-invisible
// ring gives slot 0, best -1).  Vg is a power of two, at most 32, and the
// group is Vg adjacent lanes from a multiple of Vg in its warp.  Lane v of
// it (v = lane % Vg) loads cid, tid and the kN fields more[0..kN) of slots
// v, v + Vg, ... of the ring at element `base` and keeps its first slot
// reaching its own maximum; slot v's loads stand outside the loop, so where
// V <= Vg they are one round of independent loads and no loop runs.  Then
// log2(Vg) steps of xor shuffles merge the lanes' (maximum, slot) pairs:
// the larger maximum wins, a tie the lower slot; a lane without a slot
// (v >= V) or of a group that is not live holds (INT_MIN, INT_MAX).  The
// shuffles take the whole warp: every lane of it must call, live or not,
// with the same Vg.  Two redux.sync over the group's lanes (a max, then a
// min) would do the same, but took more device time on the H100 (PERF.md,
// the version_scan finding).
template <int kN>
__device__ __forceinline__ RingPick<kN> ring_pick(
    const int* __restrict__ cid, const int* __restrict__ tid,
    const int* const* more, long long base, int V, int Vg, int ceil,
    bool live) {
  const int v = threadIdx.x & (Vg - 1);
  RingPick<kN> p;
  p.cid = p.tid = 0;
#pragma unroll
  for (int i = 0; i < kN; ++i) p.more[i] = 0;
  int best = INT_MIN, slot = INT_MAX;
  if (live && v < V) {
    p.cid = cid[base + v];
    p.tid = tid[base + v];
#pragma unroll
    for (int i = 0; i < kN; ++i) p.more[i] = more[i][base + v];
    best = (p.tid != -1 && p.cid <= ceil) ? p.cid : -1;
    slot = v;
    for (int s = v + Vg; s < V; s += Vg) {  // only where V > Vg
      const int c = cid[base + s], t = tid[base + s];
      int f[kN > 0 ? kN : 1];
#pragma unroll
      for (int i = 0; i < kN; ++i) f[i] = more[i][base + s];
      const int mk = (t != -1 && c <= ceil) ? c : -1;
      if (mk > best) {  // strict: ties keep the first slot
        best = mk;
        slot = s;
        p.cid = c;
        p.tid = t;
#pragma unroll
        for (int i = 0; i < kN; ++i) p.more[i] = f[i];
      }
    }
  }
  p.best = best;
  p.slot = slot;
  for (int o = 1; o < Vg; o <<= 1) {
    const int ob = __shfl_xor_sync(0xffffffffu, p.best, o);
    const int os = __shfl_xor_sync(0xffffffffu, p.slot, o);
    if (ob > p.best || (ob == p.best && os < p.slot)) {
      p.best = ob;
      p.slot = os;
    }
  }
  p.mine = live && slot == p.slot;
  return p;
}

// 1 where x equals one of the reader keys r[0..3], else 0.
__device__ __forceinline__ unsigned pot_match(int x, const int (&r)[4]) {
  return (unsigned)((x == r[0]) | (x == r[1]) | (x == r[2]) | (x == r[3]));
}

// Loads a thread of potential_part keeps in flight while it stages keys.
#define POT_STAGE 16

// Part of the potential matrix: potential[i, j] = "some read key of txn i
// equals some write key of txn j", key >= 0, i != j, as int8 0/1.  Block
// `part` of the part covers bytes [part * 16 * blockDim.x, ...) of the FLAT
// [T, T] output, and thread f of it the 16 bytes from that start + 16 f, so
// a thread's bytes may run over the end of a row (and over several rows
// where T < 16).  T * T < 2^31 (the host refuses more), so every index is
// 32-bit.  kO > 0 fixes O at compile time (SmallBank's 4); 0 reads it at run
// time.
//
// The block first stages, in one round of loads (POT_STAGE a thread in
// flight), the writer keys of every column its bytes touch, at most
// min(T, 16 * blockDim.x) columns, in keys_s: O ints a column, in order,
// with 4 ints of padding after every 16 columns, so that the 16-byte loads
// of a quarter warp's lanes, 16 columns apart, fall in distinct banks;
// negatives as -2.  Then the reader keys of the rows they touch, O a row,
// negatives as -1, so the two never match (interval_negotiate.py: geometry
// sizes keys_s).  A thread keeps a row's reader keys in registers, four at
// a time, skips a row whose reader keys are all negative, reads a column's
// writer keys with one 16-byte load where O = 4, and writes its 16 bytes
// with one 16-byte store (byte stores on a ragged tail).  Called by every
// thread of the block: it holds a __syncthreads.
template <int kO>
__device__ __forceinline__ void potential_part(
    const int* __restrict__ rk, const int* __restrict__ wk,
    int8_t* __restrict__ pot, int T, int O_rt, int part,
    int* __restrict__ keys_s) {
  const int O = kO > 0 ? kO : O_rt;
  const int TT = T * T;
  const int b0 = part * POT_UNIT * (int)blockDim.x;
  const int span = min(POT_UNIT * (int)blockDim.x, TT - b0);
  // staged column c holds column (c0 + c) % T; all T columns in order
  // where the span reaches T bytes, else the at most two runs it touches
  const int ncols = min(span, T);
  const int c0 = span >= T ? 0 : b0 % T;
  const int i0 = b0 / T;
  const int nw = ncols * O, n16 = 16 * O;
  const int rbase = nw + 4 * ((nw + n16 - 1) / n16);  // reader keys' start
  const int total = nw + ((b0 + span - 1) / T - i0 + 1) * O;
  if (kO == 4 && ((uintptr_t)wk & 15) == 0 && ((uintptr_t)rk & 15) == 0) {
    // a column's four writer keys, or a row's four reader keys, are one
    // 16-byte load and one 16-byte store
    const int units = total / 4;
    for (int first = threadIdx.x; first < units;
         first += POT_STAGE / 4 * blockDim.x) {
      int4 x[POT_STAGE / 4];
      int at[POT_STAGE / 4];
#pragma unroll
      for (int q = 0; q < POT_STAGE / 4; ++q) {
        const int u = first + q * blockDim.x;
        at[q] = -1;
        if (u < ncols) {
          const int col = c0 + u < T ? c0 + u : c0 + u - T;
          x[q] = reinterpret_cast<const int4*>(wk)[col];
          at[q] = 4 * u + 4 * (u >> 4);
        } else if (u < units) {
          x[q] = reinterpret_cast<const int4*>(rk)[i0 + u - ncols];
          at[q] = rbase + 4 * (u - ncols);
        }
      }
#pragma unroll
      for (int q = 0; q < POT_STAGE / 4; ++q) {
        if (at[q] < 0) continue;
        const int neg = at[q] < rbase ? -2 : -1;
        int4 v = x[q];
        v.x = v.x >= 0 ? v.x : neg;
        v.y = v.y >= 0 ? v.y : neg;
        v.z = v.z >= 0 ? v.z : neg;
        v.w = v.w >= 0 ? v.w : neg;
        *reinterpret_cast<int4*>(keys_s + at[q]) = v;
      }
    }
  } else {
    for (int first = threadIdx.x; first < total;
         first += POT_STAGE * blockDim.x) {
      int x[POT_STAGE], at[POT_STAGE];
#pragma unroll
      for (int q = 0; q < POT_STAGE; ++q) {
        const int idx = first + q * blockDim.x;
        at[q] = -1;
        if (idx < nw) {
          int src = c0 * O + idx;  // (c0 + c) % T, key o
          if (src >= T * O) src -= T * O;
          x[q] = wk[src];
          at[q] = idx + 4 * (idx / n16);
        } else if (idx < total) {
          x[q] = rk[i0 * O + (idx - nw)];
          at[q] = rbase + (idx - nw);
        }
      }
#pragma unroll
      for (int q = 0; q < POT_STAGE; ++q) {
        if (at[q] >= 0)
          keys_s[at[q]] = x[q] >= 0 ? x[q] : (at[q] < rbase ? -2 : -1);
      }
    }
  }
  __syncthreads();
  const int b = b0 + POT_UNIT * threadIdx.x;
  if (b >= TT) return;
  const int n = min(POT_UNIT, TT - b);
  int i = b / T, j = b - i * T;
  unsigned hit = 0;  // bit k: byte b + k
  for (int k = 0; k < n; j = 0, ++i) {
    const int seg = min(T - j, n - k);  // bytes of row i from column j
    const int* rrow = keys_s + rbase + (i - i0) * O;
    const int cs = j >= c0 ? j - c0 : j - c0 + T;  // staged column of j
    for (int oc = 0; oc < O; oc += 4) {
      int r[4];
      bool any = false;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        r[q] = oc + q < O ? rrow[oc + q] : -1;
        any |= r[q] >= 0;
      }
      if (!any) continue;
      // the writer keys of staged column c, matched against r
      auto column = [&](int c) -> unsigned {
        const int* w = keys_s + c * O + 4 * (c >> 4);
        if constexpr (kO == 4) {
          const int4 v = *reinterpret_cast<const int4*>(w);
          return pot_match(v.x, r) | pot_match(v.y, r) | pot_match(v.z, r) |
                 pot_match(v.w, r);
        } else {
          unsigned h = 0;
          for (int o2 = 0; o2 < O; ++o2) h |= pot_match(w[o2], r);
          return h;
        }
      };
      if (seg == POT_UNIT) {
#pragma unroll
        for (int s = 0; s < POT_UNIT; ++s) hit |= column(cs + s) << s;
      } else {
        for (int s = 0; s < seg; ++s) hit |= column(cs + s) << (k + s);
      }
    }
    if (i >= j && i < j + seg) hit &= ~(1u << (k + i - j));
    k += seg;
  }
  int8_t* out = pot + b;
  if (n == POT_UNIT && ((uintptr_t)out & 15) == 0) {
    // bit q of each nibble to bit 0 of byte q: x * 0x204081 places the four
    // bits 7 apart, with no carries between them
    uint4 v;
    v.x = ((hit & 15u) * 0x204081u) & 0x01010101u;
    v.y = (((hit >> 4) & 15u) * 0x204081u) & 0x01010101u;
    v.z = (((hit >> 8) & 15u) * 0x204081u) & 0x01010101u;
    v.w = (((hit >> 12) & 15u) * 0x204081u) & 0x01010101u;
    *reinterpret_cast<uint4*>(out) = v;
  } else {
    for (int k = 0; k < n; ++k) out[k] = (int8_t)((hit >> k) & 1u);
  }
}
