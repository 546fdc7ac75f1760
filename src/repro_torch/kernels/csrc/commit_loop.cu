// commit_loop: the whole commit phase of one wave in one launch.
//
// Replaces the TPU kernel src/repro/kernels/version_scan.py:
// version_scan_pallas where the reference runs it at every commit step
// (LocalSubstrate.read_newest), together with the loop that carries it: the
// lax.fori_loop over commit_one at src/repro/core/engine.py:264, one device
// program per wave.  The port's plain version is engine._commit_loop_plain,
// T Python steps of about 170 small launches each; this kernel is held to it
// bit for bit.
//
// What bounds it on the H100: neither bytes nor operations but the chain of
// dependent accesses.  The T steps are serially dependent (the commit order
// is the paper's deterministic order, and step i reads what step i-1
// installed), and a step reads a ring, then the slot it chose, then the
// creator's status, installs, and re-reads the creator TID for the SID bump
// guard.  From L2 each link of that chain costs about 145 ns; from shared
// memory about 30 cycles.
//
// What the design does about it:
//   * The state that changes within a wave is small: the tid, cid and sid
//     rings and the head of the rows the wave's ops touch (at most T*O + 1
//     rows: an op reaches clip_row(pk) and gather_row(pk), which differ only
//     for a negative pk, whose clip row is row 0).  Every write to them
//     during the loop comes from this one block.  The "staged" variant maps
//     each touched row to a staged row in shared memory (an open-address
//     hash filled with atomicCAS), gathers its rings with cp.async (16 bytes
//     a copy where V % 4 == 0), runs the loop on them and writes the dirty
//     rows back at the end.  val and the wave tag are never read inside the
//     loop: they are stored to device memory as the steps install.
//   * potential becomes two bit matrices, P and its transpose, built from
//     the nonzero bytes alone.  Txn j is RUNNING at step i exactly when
//     j >= i (status[j] changes only at step j), so ongoing_readers_of and
//     push_bounds walk the set bits of P[i] / P^T[i] above bit i: O(T/32)
//     words and the set bits, not O(T) int8 loads by every thread.
//   * One warp runs the steps, with no block barrier: G lanes an op scan
//     its ring (one slot a lane at V <= G, merged by shuffles), the
//     reductions are shuffle butterflies, and a step needs two __syncwarp:
//     one after its reads (the install scratch of every op), one at its end.
//     The SID bump's TID guard, which the reference reads after the install,
//     is known before it: the txn's own TID where the step installs into
//     the bumped cell, the TID read before the install elsewhere; so the
//     install and the bumps are one phase.  The other warps only help in
//     the prologue and epilogue.
//   * Where the staged rings, bit matrices and op records do not fit in
//     shared memory (T, O or V large), the "global" variant runs the same
//     one-warp step on the store tables in device memory (ld.global.cg, so
//     a line an earlier step rewrote is never read stale from L1), with the
//     bit matrices and the op records in a device scratch buffer, each
//     step's share prefetched into shared memory by cp.async during the
//     step before.  The host picks the variant before the launch
//     (commit_loop.py: commit_loop_smem_bytes).
//   * One warp issuing a chain of dependent instructions is what a step
//     costs, so SmallBank's shape (O=4, V=8, the engine path's) has its own
//     instantiation with both fixed at compile time (loops unrolled,
//     offsets folded); every other shape runs the same code reading them at
//     run time.
//
// One step i, each block citing the core/commit_phase.py (or ops.py /
// store.py) function it computes:
//   (A) G lanes an op: ring_pick's rule with ceiling INF (read_newest),
//       creator_slots, lost_update, rw_edge_to_creator or first-committer-
//       wins, the dsi remote check, postsi_bounds' per-op maxima with the
//       re-gathered SID (ops.sid_regather), the install slot head + 1 and
//       store.evicting_visible; one lane per bit word: ongoing_readers_of's
//       maximum of s_lo; all reduced over the warp.
//   (B) every lane: postsi_bounds (s_i, c_i, rule 5) or the clocked s_i/c_i,
//       the gc_block abort, commit, the outputs s/c, clk and evicted.
//   (C) ops.masked_install: among a transaction's ops that install into one
//       cell the largest value wins, and head advances to the largest new
//       slot of its row, as the port's min-then-max scatter does;
//       ops.masked_sid_bump (rule 4(c)) in the same phase, as above.
//   (D) push_bounds (rule 4(b)) on the running transactions.
#include <limits.h>
#include <string.h>

#include "common.cuh"

// phases: prologue 1-4, (A) op reads, (A) readers walk, reductions +
// decision, install scratch, install, bump + push_bounds + step end,
// epilogue
constexpr int kClockPhases = 11;

// -DCOMMIT_LOOP_CLOCKS (scripts/kernel_variants.py builds it apart): thread
// 0 adds the clock64() cycles of each phase of a launch into g_clocks, read
// back with commit_loop_clocks.  Never part of the library the port loads.
#ifdef COMMIT_LOOP_CLOCKS
__device__ unsigned long long g_clocks[kClockPhases];
#define CLOCK_MARK(k)                                  \
  do {                                                 \
    if (tx == 0) {                                     \
      const long long t_ = clock64();                  \
      clk_acc[k] += t_ - clk_last;                     \
      clk_last = t_;                                   \
    }                                                  \
  } while (0)
#else
#define CLOCK_MARK(k)
#endif

// Where everything lives, in ints (make_layout).  commit_loop.py
// (Layout, _layout) makes the same struct on the host, where it sizes the
// launch and picks the variant; the launch entry refuses one that differs
// in any field.  The kernel makes its own from T, O and V rather than
// take the host's: with O and V fixed at compile time the offsets fold
// into its address arithmetic.
struct Layout {
  long long W, WP, OPW, R, H;
  // shared memory, both variants: s_lo, s_hi, c_lo, txn tid [T], the
  // committed bits [WP], the step's install scratch [O] x 6 and a counter
  long long slo, shi, clo, ttid, cmask, dh, misc;
  // staged: P, P^T [T][WP], op records [T][OPW], staged row -> store row
  // [R], and one region that holds the hash (hkey, hval [H]) in the
  // prologue and the staged rings after it: tid, cid, sid [R][V], head and
  // a dirty flag [R]
  long long P, PT, ops, row_of, uni;
  // global: two step buffers of OPW + 2 WP ints (ops, P row, P^T row)
  long long step;
  long long total;    // ints of dynamic shared memory
  long long scratch;  // ints of device scratch (global: P, P^T, ops)
};

namespace {

constexpr int kRead = 1, kWrite = 2, kRmw = 3;
constexpr int kInf = 1 << 30;
constexpr int kPostsi = 0, kCv = 1, kDsi = 4;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBatch = 4;  // prologue and epilogue: loads in flight a thread
// op record: kFields ints per op, stored field-major per step (field f of
// op o of step i at ops[i * OPW + f * O + o])
constexpr int kFields = 6;
enum { kMeta, kClip, kGather, kValNew, kRTid, kRCid };
// meta bits; the read slot r_slot sits above them
constexpr int kMR = 1, kMW = 2, kMRemote = 4, kMLive = 8, kSlotShift = 8;

__host__ __device__ inline long long round4(long long x) {
  return (x + 3) & ~3LL;
}

__host__ __device__ inline Layout make_layout(int T, int O, int V,
                                              bool staged) {
  Layout L = {};
  L.W = (T + 31) >> 5;
  L.WP = round4(L.W);
  L.OPW = staged ? kFields * O : round4(kFields * O);
  L.R = T * O + 1;
  L.H = 2;
  while (L.H < 2 * L.R) L.H <<= 1;
  L.slo = 0;
  L.shi = T;
  L.clo = 2LL * T;
  L.ttid = 3LL * T;
  L.cmask = 4LL * T;
  L.dh = L.cmask + L.WP;
  L.misc = L.dh + 6LL * O;
  const long long base = round4(L.misc + 1);
  if (staged) {
    L.P = base;
    L.PT = L.P + (long long)T * L.WP;
    L.ops = L.PT + (long long)T * L.WP;
    L.row_of = L.ops + (long long)T * L.OPW;
    L.uni = round4(L.row_of + L.R);
    const long long recs = (long long)L.R * (3 * V + 2), hash = 2LL * L.H;
    L.total = L.uni + (recs > hash ? recs : hash);
  } else {
    L.step = base;
    L.total = base + 2LL * (L.OPW + 2 * L.WP);
    L.scratch = 2LL * T * L.WP + (long long)T * L.OPW;
  }
  return L;
}

// int32 arithmetic that wraps, as PyTorch's does
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// floor modulo for a positive divisor (PyTorch's % on integers)
__device__ __forceinline__ int floor_mod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// ops.gather_rows: a negative key counts from the end, then clamp
__device__ __forceinline__ int gather_row(int key, int n) {
  const long long k = key < 0 ? (long long)key + n : key;
  return (int)(k < 0 ? 0 : (k >= n ? n - 1 : k));
}

// ops._drop_rows: does a mode="drop" scatter write this key (into
// gather_row)?
__device__ __forceinline__ bool drop_live(int key, int n) {
  const long long k = key < 0 ? (long long)key + n : key;
  return k >= 0 && k < n;
}

__device__ __forceinline__ bool is_read(int k) { return k == kRead || k == kRmw; }
__device__ __forceinline__ bool is_write(int k) { return k == kWrite || k == kRmw; }

// log2 of the lanes an op gets in step (A): as many as 32 / O (rounded
// down to a power of two) allows, but no more than V's next power of two
__host__ __device__ constexpr int lanes_log(int O, int V) {
  int lg = 5;
  while (lg > 0 && ((O - 1) >> (5 - lg)) > 0) --lg;
  while (lg > 0 && (1 << (lg - 1)) >= V) --lg;
  return lg;
}

__device__ __forceinline__ bool bit(const unsigned* m, int j) {
  return (m[j >> 5] >> (j & 31)) & 1u;
}

// 4 bytes from device to shared memory, asynchronous (cached in L1: the
// prologue reads the store before this kernel writes any of it)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// 16 bytes, through L2 only (so also the scratch this kernel wrote)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The rings the loop reads and writes: tid, cid, sid [.][V] and head [.],
// in shared memory (staged: a handle is a staged row, and a dirty flag
// marks the rows to write back) or the store tables (global: a handle is
// the store row; loads through L2 only, so a line an earlier step
// rewrote is never read stale from L1).
template <bool kStaged>
struct Rings {
  int *tid_, *cid_, *sid_, *head_, *dirty_;
  int V;
  __device__ long long cell(int h, int v) const { return (long long)h * V + v; }
  __device__ int ld(const int* p) const { return kStaged ? *p : __ldcg(p); }
  __device__ void st(int* p, int x) const {
    if (kStaged) *p = x;
    else __stcg(p, x);
  }
  __device__ int tid(int h, int v) const { return ld(tid_ + cell(h, v)); }
  __device__ int cid(int h, int v) const { return ld(cid_ + cell(h, v)); }
  __device__ int sid(int h, int v) const { return ld(sid_ + cell(h, v)); }
  __device__ int head(int h) const { return ld(head_ + h); }
  __device__ void install(int h, int v, int t, int c, int sd, int hd) const {
    st(tid_ + cell(h, v), t);
    st(cid_ + cell(h, v), c);
    st(sid_ + cell(h, v), sd);
    st(head_ + h, hd);
    if (kStaged) dirty_[h] = 1;
  }
  __device__ void bump(int h, int v, int s) const {
    atomicMax(sid_ + cell(h, v), s);
    if (kStaged) dirty_[h] = 1;
  }
};

// read_newest's slot of one ring, G lanes a ring: ring_pick's rule
// (common.cuh) with ceiling INF picks the FIRST slot with the largest
// m = (tid != -1 && cid <= INF) ? cid : -1, slot 0 when none is visible.
// Each of the G lanes takes the slots v = g, g + G, ..., then the group
// merges (m, slot) pairs by xor shuffles (larger m wins, ties the lower
// slot); identity (INT_MIN, INT_MAX) for lanes without a slot or an active
// op.  Called by all 32 lanes.
template <class Rings>
__device__ __forceinline__ int newest_slot(const Rings& rg, bool active,
                                           int h, int V, int g, int G) {
  int bm = INT_MIN, bv = INT_MAX;
  if (active)
    for (int v = g; v < V; v += G) {
      const int c = rg.cid(h, v), t = rg.tid(h, v);
      const int m = (t != -1 && c <= kInf) ? c : -1;
      if (bv == INT_MAX || m > bm) {  // within a lane the slots ascend
        bm = m;
        bv = v;
      }
    }
  for (int off = 1; off < G; off <<= 1) {
    const int om = __shfl_xor_sync(kFull, bm, off);
    const int ov = __shfl_xor_sync(kFull, bv, off);
    if (om > bm || (om == bm && ov < bv)) {
      bm = om;
      bv = ov;
    }
  }
  return bv;
}

struct Args {
  // the store, updated in place
  int *val, *tid, *cid, *sid, *head, *wave;
  // the wave and the read phase
  const int *kind, *keys, *pkeys, *op_val, *host, *txn_tid, *r_val, *r_tid,
      *r_cid, *r_slot, *s_lo0;
  const int8_t* pot;
  const int *wave_idx, *clock, *wm;
  // outputs
  int *status, *s_out, *c_out, *wcid, *clk, *evicted;
  int* scratch;  // global variant: P, P^T, op records
  int T, O, V, N, sched, gc_track, gc_block, n_nodes;
  int vec16;  // tid, cid, sid 16-byte aligned: the gathers copy 16 bytes
};

__device__ __forceinline__ int hash_slot(int row, int log_h) {
  return (int)(((unsigned)row * 2654435761u) >> (32 - log_h));
}

// staged prologue: give `row` a staged index once
__device__ void hash_insert(int row, int* hkey, int* hval, int* row_of,
                            int* count, int H, int log_h) {
  int s = hash_slot(row, log_h);
  for (;;) {
    const int prev = atomicCAS(hkey + s, -1, row);
    if (prev == -1) {  // one atomicAdd for the lanes that win together
      const unsigned won = __activemask();
      const int lane = threadIdx.x & 31, leader = __ffs(won) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(count, __popc(won));
      const int idx = __shfl_sync(won, base, leader) +
                      __popc(won & ((1u << lane) - 1));
      hval[s] = idx;
      row_of[idx] = row;
      return;
    }
    if (prev == row) return;
    s = (s + 1) & (H - 1);
  }
}

__device__ int hash_find(int row, const int* hkey, const int* hval, int H,
                         int log_h) {
  int s = hash_slot(row, log_h);
  while (hkey[s] != row) s = (s + 1) & (H - 1);
  return hval[s];
}

template <bool kStaged, int kO, int kV>
__global__ void __launch_bounds__(kThreads, 1)
    commit_loop_kernel(Args a) {
  extern __shared__ int4 smem4[];
  int* sm = reinterpret_cast<int*>(smem4);
  // kO, kV: O and V fixed at compile time (0: read at run time)
  const int T = a.T, O = kO ? kO : a.O, V = kV ? kV : a.V, N = a.N;
  const Layout L = make_layout(T, O, V, kStaged);
  const int tx = threadIdx.x, nthr = blockDim.x;
  const int lane = tx & 31, warp = tx >> 5;
  const bool postsi = a.sched == kPostsi;
  const bool cv_rules = a.sched == kPostsi || a.sched == kCv;
  const bool dsi = a.sched == kDsi;
  const int W = (int)L.W, WP = (int)L.WP, OPW = (int)L.OPW, H = (int)L.H;
#ifdef COMMIT_LOOP_CLOCKS
  long long clk_acc[kClockPhases] = {}, clk_last = clock64();
#endif

  int* slo = sm + L.slo;
  int* shi = sm + L.shi;
  int* clo = sm + L.clo;
  int* ttid = sm + L.ttid;
  unsigned* cmask = reinterpret_cast<unsigned*>(sm + L.cmask);
  // [O] each: the row an op installs into (or -1), its slot and value;
  // the row it may bump (or -1), the read slot and the guard's two
  // outcomes (bit 0: the old TID matches, bit 1: the txn's own does)
  int* dh_s = sm + L.dh;
  int* hn_s = dh_s + O;
  int* vn_s = hn_s + O;
  int* bh_s = vn_s + O;
  int* bs_s = bh_s + O;
  int* bg_s = bs_s + O;
  int* count = sm + L.misc;
  unsigned *P, *PT;
  int* ops;
  if (kStaged) {
    P = reinterpret_cast<unsigned*>(sm + L.P);
    PT = reinterpret_cast<unsigned*>(sm + L.PT);
    ops = sm + L.ops;
  } else {
    P = reinterpret_cast<unsigned*>(a.scratch);
    PT = P + (long long)T * WP;
    ops = a.scratch + 2LL * T * WP;
  }
  int* row_of = sm + L.row_of;
  int* hkey = sm + L.uni;  // the hash, prologue only
  int* hval = hkey + H;
  int log_h = 0;
  while ((1 << log_h) < H) ++log_h;

  // ---- prologue 1: interval state, zeroed bit matrices, empty hash
  for (int j = tx; j < T; j += nthr) {
    slo[j] = a.s_lo0[j];
    clo[j] = a.s_lo0[j];
    shi[j] = kInf;
    ttid[j] = a.txn_tid[j];
  }
  for (int c = tx; c < WP; c += nthr) cmask[c] = 0;
  for (long long x = tx; x < 2LL * T * WP; x += nthr) P[x] = 0;  // P, PT
  if (kStaged) {
    for (int s = tx; s < H; s += nthr) hkey[s] = -1;
    if (tx == 0) *count = 0;
  }
  __syncthreads();
  CLOCK_MARK(0);

  // ---- prologue 2: the rows the wave touches; the nonzero bytes of
  // potential as bits of P[i] and P^T[j]
  if (kStaged)
    for (int m0 = tx; m0 < T * O; m0 += kBatch * nthr) {
      int k[kBatch], pk[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {  // the batch's loads in flight
        const int m = m0 + u * nthr;
        k[u] = m < T * O ? __ldg(a.kind + m) : 0;
        pk[u] = m < T * O ? __ldg(a.pkeys + m) : 0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (!is_read(k[u]) && !is_write(k[u])) continue;
        hash_insert((int)clip_row(pk[u], N), hkey, hval, row_of, count, H,
                    log_h);
        if (pk[u] < 0)
          hash_insert(gather_row(pk[u], N), hkey, hval, row_of, count, H,
                      log_h);
      }
    }
  {
    const long long n = (long long)T * T, n16 = n >> 4;
    const int4* p4 = reinterpret_cast<const int4*>(a.pot);  // 16-B aligned
    auto set_bit = [&](long long f) {  // potential[i, j] != 0, f = i T + j
      const int i = (int)((unsigned)f / (unsigned)T), j = (int)f - i * T;
      atomicOr(P + (long long)i * WP + (j >> 5), 1u << (j & 31));
      atomicOr(PT + (long long)j * WP + (i >> 5), 1u << (i & 31));
    };
    for (long long q0 = tx; q0 < n16; q0 += (long long)kBatch * nthr) {
      int4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const long long q = q0 + (long long)u * nthr;
        v[u] = q < n16 ? __ldg(p4 + q) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const unsigned w4[4] = {(unsigned)v[u].x, (unsigned)v[u].y,
                                (unsigned)v[u].z, (unsigned)v[u].w};
        if ((w4[0] | w4[1] | w4[2] | w4[3]) == 0) continue;
        const long long f0 = (q0 + (long long)u * nthr) << 4;
        for (int b = 0; b < 16; ++b)
          if ((w4[b >> 2] >> (8 * (b & 3))) & 0xffu) set_bit(f0 + b);
      }
    }
    for (long long f = (n16 << 4) + tx; f < n; f += nthr)  // the n % 16 tail
      if (a.pot[f]) set_bit(f);
  }
  __syncthreads();
  CLOCK_MARK(1);

  // ---- prologue 3: one record per op (row handles, flags, the value an
  // install writes), field-major per step
  for (int m0 = tx; m0 < T * O; m0 += kBatch * nthr) {
    int in[kBatch][9];  // kind, pkeys, keys, op_val, r_val, r_tid, r_cid,
                        // r_slot, host: the batch's loads in flight
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int m = m0 + u * nthr, mm = m < T * O ? m : 0;
      const int* src[8] = {a.kind,  a.pkeys, a.keys,  a.op_val,
                           a.r_val, a.r_tid, a.r_cid, a.r_slot};
#pragma unroll
      for (int f = 0; f < 8; ++f) in[u][f] = __ldg(src[f] + mm);
      in[u][8] = __ldg(a.host + mm / O);
      if (m >= T * O) in[u][0] = -1;  // none
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int m = m0 + u * nthr;
      if (m >= T * O) continue;
      const int i = m / O, o = m - i * O;
      const int k = in[u][0], pk = in[u][1];
      int rec[kFields] = {0, 0, 0, 0, 0, 0};
      if (is_read(k) || is_write(k)) {
        const int c = (int)clip_row(pk, N), g = gather_row(pk, N);
        rec[kClip] = kStaged ? hash_find(c, hkey, hval, H, log_h) : c;
        rec[kGather] = !kStaged ? g
                       : g == c ? rec[kClip]
                                : hash_find(g, hkey, hval, H, log_h);
        const bool remote = floor_mod(in[u][2], a.n_nodes) != in[u][8];
        rec[kMeta] = (is_read(k) ? kMR : 0) | (is_write(k) ? kMW : 0) |
                     (remote ? kMRemote : 0) |
                     (drop_live(pk, N) ? kMLive : 0) |
                     (in[u][7] << kSlotShift);
        rec[kValNew] = k == kRmw ? wrap_add(in[u][4], in[u][3]) : in[u][3];
        rec[kRTid] = in[u][5];
        rec[kRCid] = in[u][6];
      }
      int* dst = ops + (long long)i * OPW + o;
#pragma unroll
      for (int f = 0; f < kFields; ++f) dst[f * O] = rec[f];
    }
  }
  __syncthreads();
  CLOCK_MARK(2);

  // ---- prologue 4 (staged): gather the rings over the hash's space, a
  // thread a row, in copies of 16 bytes (V % 4 == 0 and aligned tables)
  // or 4
  Rings<kStaged> rings;
  rings.V = V;
  const int cw = kStaged && a.vec16 && V % 4 == 0 ? 4 : 1;  // ints a copy
  if constexpr (kStaged) {
    const int R = *count;
    rings.tid_ = sm + L.uni;
    rings.cid_ = rings.tid_ + L.R * V;
    rings.sid_ = rings.cid_ + L.R * V;
    rings.head_ = rings.sid_ + L.R * V;
    rings.dirty_ = rings.head_ + L.R;
    for (int h = tx; h < R; h += nthr) {  // a thread a row
      const long long row = row_of[h];
      const int* src[3] = {a.tid + row * V, a.cid + row * V, a.sid + row * V};
      int* dst[3] = {rings.tid_ + h * V, rings.cid_ + h * V,
                     rings.sid_ + h * V};
      for (int f = 0; f < 3; ++f)
        for (int v = 0; v < V; v += cw)
          if (cw == 4) cp_async16(dst[f] + v, src[f] + v);
          else cp_async4(dst[f] + v, src[f] + v);
      cp_async4(rings.head_ + h, a.head + row);
      rings.dirty_[h] = 0;
    }
    cp_async_wait_all();
  } else {
    rings.tid_ = a.tid;
    rings.cid_ = a.cid;
    rings.sid_ = a.sid;
    rings.head_ = a.head;
  }
  __syncthreads();
  CLOCK_MARK(3);

  // ---- the T steps, one warp
  if (warp == 0) {
    const int wave_idx = __ldg(a.wave_idx), clock0 = __ldg(a.clock);
    const int wm = __ldg(a.wm), tid0 = ttid[0];
    int clk = clock0, evicted = 0;
    const int log_g = lanes_log(O, V), G = 1 << log_g;
    int* stepbuf = sm + L.step;
    const int step_ints = OPW + 2 * WP;
    // global: copy step s's op records and bit rows into buffer s & 1
    auto prefetch = [&](int s) {
      int* dst = stepbuf + (s & 1) * step_ints;
      const int n_ops = OPW >> 2, n_all = n_ops + (WP >> 1);
      for (int c = lane; c < n_all; c += 32) {
        const int* src =
            c < n_ops ? ops + (long long)s * OPW + 4 * c
            : c < n_ops + (WP >> 2)
                ? reinterpret_cast<const int*>(P + (long long)s * WP) +
                      4 * (c - n_ops)
                : reinterpret_cast<const int*>(PT + (long long)s * WP) +
                      4 * (c - n_ops - (WP >> 2));
        cp_async16(dst + 4 * c, src);
      }
      cp_async_commit();
    };
    if (!kStaged) prefetch(0);

    for (int i = 0; i < T; ++i) {
      const int* opr;
      const unsigned *prow, *ptrow;
      if (kStaged) {
        opr = ops + i * OPW;
        prow = P + i * WP;
        ptrow = PT + i * WP;
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncwarp();
        opr = stepbuf + (i & 1) * step_ints;
        prow = reinterpret_cast<const unsigned*>(opr + OPW);
        ptrow = prow + WP;
        if (i + 1 < T) prefetch(i + 1);
      }
      // this step's own state and bit words, loaded before anything waits
      const int tid_i = ttid[i], slo_i = slo[i], clo_i = clo[i];
      const int shi_i = shi[i];
      const int c0 = (i + 1) >> 5;  // txns j > i are the RUNNING ones
      const unsigned above = ~0u << ((i + 1) & 31);
      const int cw = c0 + lane;
      const unsigned pw = cw < W ? prow[cw] & (lane ? ~0u : above) : 0u;
      const unsigned ptw = cw < W ? ptrow[cw] & (lane ? ~0u : above) : 0u;

      // ---- (A) reads, all before step i's install; G lanes an op, each
      // lane of a group holding the op's values alike
      int any_ab = 0, ev = 0;
      // postsi_bounds' per-op maxima: wmax feeds s_lo and c_lo, cmax
      // (with the reads' SIDs and the overwritten SIDs) c_lo
      int wmax = INT_MIN, cmax = INT_MIN;
      for (int o0 = 0; o0 < O; o0 += 32 >> log_g) {
        const int o = o0 + (lane >> log_g), g = lane & (G - 1);
        const int ov = o < O ? o : 0;
        const int meta = o < O ? opr[ov] : 0;
        const int hc = opr[kClip * O + ov], hg = opr[kGather * O + ov];
        const int rc = opr[kRCid * O + ov], rt = opr[kRTid * O + ov];
        const int vn = opr[kValNew * O + ov];
        const bool r = meta & kMR, w = meta & kMW, act = r || w;
        const int rslot = meta >> kSlotShift;
        // loads that do not wait on the scan: head, the re-gathered SID
        // and the TID the bump's guard compares (both at the read's slot)
        const int hd = act ? rings.head(hc) : 0;
        const int cur_sid = act ? rings.sid(hg, rslot) : 0;
        const int old_tid = r ? rings.tid(hg, rslot) : 0;
        // the install slot head + 1 (floor_mod without a division when
        // head is in range) and the GC consult's two fields
        int h_new = wrap_add(hd, 1);
        if (h_new < 0 || h_new >= V) h_new = floor_mod(h_new, V);
        const int h_next = h_new + 1 == V ? 0 : h_new + 1;
        const bool gc = a.gc_track && w;
        const int gc_tid = gc ? rings.tid(hc, h_new) : -1;
        const int gc_cid = gc ? rings.cid(hc, h_next) : 0;
        // the ring's newest visible slot (read_newest), then its fields
        const int slot = newest_slot(rings, act, hc, V, g, G);
        if (act) {
          const int nv_tid = rings.tid(hc, slot);
          const int nv_cid = rings.cid(hc, slot);
          const int nv_sid = rings.sid(hc, slot);
          // creator_slots: the newest creator as a wave-local id; only
          // txns before i can have committed (both bit words are read
          // whatever local is, at a clamped index, so nothing branches)
          const int local = wrap_add(nv_tid, -tid0);
          const int lc = min(max(local, 0), T - 1);
          const bool creator_committed =
              (local >= 0) & (local < i) & bit(cmask, lc);
          bool ab = r & w & (nv_cid != rc);  // lost_update
          if (cv_rules)                      // rw_edge_to_creator
            ab |= w & creator_committed & bit(prow, lc);
          else                               // first-committer-wins
            ab |= w & creator_committed;
          if (dsi)  // a remote read whose key was overwritten meanwhile
            ab |= r & ((meta & kMRemote) != 0) & (nv_cid != rc);
          any_ab |= ab;
          const int w_cid = w ? nv_cid : 0;
          wmax = max(wmax, w_cid);
          cmax = max(cmax, max(w_cid, max(r ? cur_sid : 0,
                                          w ? nv_sid : 0)));
          ev += gc & (gc_tid != -1) & (gc_cid > wm);
        } else if (o < O) {  // a NOP contributes where(mask, x, 0) = 0
          wmax = max(wmax, 0);
          cmax = max(cmax, 0);
        }
        if (o < O) {  // what (C) needs of every op (a group writes alike)
          const bool live = meta & kMLive;
          dh_s[o] = w && live ? hg : -1;  // installs into (hg, h_new)
          hn_s[o] = h_new;
          vn_s[o] = vn;
          bh_s[o] = r && live ? hg : -1;  // may bump (hg, rslot)
          bs_s[o] = rslot;
          bg_s[o] = (old_tid == rt ? 1 : 0) | (tid_i == rt ? 2 : 0);
        }
      }
      CLOCK_MARK(4);
      // ongoing_readers_of: RUNNING (j > i) readers of my writes, a lane a
      // bit word
      int readers = 0;
      if (postsi) {
        for (int c = cw; c < W; c += 32) {
          unsigned wd = c == cw ? ptw : ptrow[c];
          while (wd) {
            readers = max(readers, slo[32 * c + __ffs(wd) - 1]);
            wd &= wd - 1;
          }
        }
        readers = __reduce_max_sync(kFull, readers);
      }
      __syncwarp();  // the install scratch of every op
      CLOCK_MARK(5);
      // the four reductions side by side, over the op groups only
      for (int off = G; off < 32; off <<= 1) {
        any_ab |= __shfl_xor_sync(kFull, any_ab, off);
        ev += __shfl_xor_sync(kFull, ev, off);
        wmax = max(wmax, __shfl_xor_sync(kFull, wmax, off));
        cmax = max(cmax, __shfl_xor_sync(kFull, cmax, off));
      }
      bool abort = any_ab != 0;

      // ---- (B) every lane decides
      int s_i, c_i;
      if (postsi) {  // postsi_bounds: rules 3, 4(a) and 5
        const int s_lo_i = max(slo_i, wmax);
        const int c_lo_i = max(max(clo_i, cmax), readers);
        abort = abort || s_lo_i > shi_i;
        s_i = s_lo_i;
        c_i = wrap_add(max(c_lo_i, s_i), 1);
      } else {  // clocked: snapshot = wave-entry clock, commit = clock + 1
        s_i = clock0;
        c_i = wrap_add(clk, 1);
      }
      if (a.gc_block) abort = abort || ev > 0;
      const bool commit = !abort;  // step i's txn is always RUNNING here
      if (lane == 0) {
        a.s_out[i] = commit ? s_i : -1;
        a.c_out[i] = commit ? c_i : -1;
      }
      for (int o = lane; o < O; o += 32)
        a.wcid[(long long)i * O + o] = commit && (opr[o] & kMW) ? c_i : -1;
      CLOCK_MARK(6);

      // ---- (C) install and (D) the SID bumps, one phase: a cell this
      // step installs into gets sid max(0, s_i) when a guarded bump aims
      // at it (install, then bump) and 0 otherwise; a bump elsewhere is
      // an atomicMax.  A bump's guard reads the TID after the install: the
      // txn's own where this step installs, the old one elsewhere.
      if (commit) {
        for (int o = lane; o < O; o += 32) {
          const int h = dh_s[o], hn = hn_s[o];
          const int bh = bh_s[o], bs = bs_s[o], bg = bg_s[o];
          int hmax = hn, vmax = vn_s[o];
          bool bumped = false, overwritten = false;
          for (int q = 0; q < O; ++q) {  // branch-free over every op
            const int hq = dh_s[q], nq = hn_s[q], vq = vn_s[q];
            const int bhq = bh_s[q], bsq = bs_s[q], bgq = bg_s[q];
            const bool row = (h >= 0) & (hq == h);  // installs into my row
            hmax = row ? max(hmax, nq) : hmax;
            vmax = row & (nq == hn) ? max(vmax, vq) : vmax;  // my cell
            bumped |= (h >= 0) & (bhq == h) & (bsq == hn) & ((bgq & 2) != 0);
            overwritten |= (bh >= 0) & (hq == bh) & (nq == bs);
          }
          if (h >= 0) {
            rings.install(h, hn, tid_i, c_i, bumped ? max(0, s_i) : 0,
                          hmax);
            const long long row = kStaged ? row_of[h] : h;
            __stcg(a.val + row * V + hn, vmax);
            __stcg(a.wave + row, wave_idx);
          }
          if (bh >= 0 && !overwritten && (bg & 1)) rings.bump(bh, bs, s_i);
        }
        CLOCK_MARK(7);
        // rule 4(b): push the bounds of the running txns j > i
        if (postsi)
          for (int c = cw; c < W; c += 32) {
            unsigned rd = c == cw ? pw : prow[c];
            unsigned wr = c == cw ? ptw : ptrow[c];
            while (rd) {  // i -rw-> j
              const int j = 32 * c + __ffs(rd) - 1;
              clo[j] = max(clo[j], wrap_add(s_i, 1));
              rd &= rd - 1;
            }
            while (wr) {  // j -rw-> i
              const int j = 32 * c + __ffs(wr) - 1;
              shi[j] = min(shi[j], wrap_add(c_i, -1));
              wr &= wr - 1;
            }
          }
        if (lane == 0) cmask[i >> 5] |= 1u << (i & 31);
        clk = max(clk, c_i);
        if (a.gc_track) evicted = wrap_add(evicted, ev);
      }
      CLOCK_MARK(8);
      __syncwarp();
      CLOCK_MARK(9);
    }
    if (lane == 0) {
      *a.clk = clk;
      *a.evicted = evicted;
    }
  }
  __syncthreads();

  // ---- epilogue: statuses; the staged records that changed go back
  for (int j = tx; j < T; j += nthr) a.status[j] = bit(cmask, j) ? 1 : 2;
  if constexpr (kStaged) {
    const int R = *count;
    for (int h = tx; h < R; h += nthr) {  // a thread a row
      if (!rings.dirty_[h]) continue;
      const long long row = row_of[h];
      int* dst[3] = {a.tid + row * V, a.cid + row * V, a.sid + row * V};
      const int* src[3] = {rings.tid_ + h * V, rings.cid_ + h * V,
                           rings.sid_ + h * V};
      for (int f = 0; f < 3; ++f)
        for (int v = 0; v < V; v += cw)
          if (cw == 4)
            *reinterpret_cast<int4*>(dst[f] + v) =
                *reinterpret_cast<const int4*>(src[f] + v);
          else
            dst[f][v] = src[f][v];
      a.head[row] = rings.head_[h];
    }
  }
#ifdef COMMIT_LOOP_CLOCKS
  __syncthreads();
  CLOCK_MARK(10);
  if (tx == 0)
    for (int k = 0; k < kClockPhases; ++k) atomicAdd(g_clocks + k, clk_acc[k]);
#endif
}

template <bool kStaged, int kO, int kV>
int launch(const Args& a, long long smem, cudaStream_t stream) {
  static bool attr_set = false;  // raise the opt-in limit once
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        commit_loop_kernel<kStaged, kO, kV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  commit_loop_kernel<kStaged, kO, kV><<<1, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// val, tid, cid, sid [N, V], head, wave [N] int32 (updated in place);
// kind, keys, pkeys, op_val [T, O], host, txn tid [T] int32; r_val, r_tid,
// r_cid, r_slot [T, O], s_lo0 [T] int32; potential [T, T] int8 (16-byte
// aligned); wave_idx, clock, watermark int32 scalars; outputs status, s, c
// [T], wcid [T, O], clk, evicted int32; scratch int32 of the layout's
// `scratch` ints (global variant, else unused); the sizes and flags;
// staged, the variant; the host's Layout of the launch and its size in
// bytes.  One block of kThreads threads with layout->total ints of dynamic
// shared memory.  Returns a cudaError_t (cudaErrorInvalidValue for a
// Layout that is not make_layout's).
extern "C" int commit_loop_launch(
    int* val, int* tid, int* cid, int* sid, int* head, int* wave,
    const int* kind, const int* keys, const int* pkeys, const int* op_val,
    const int* host, const int* txn_tid, const int* r_val, const int* r_tid,
    const int* r_cid, const int* r_slot, const int* s_lo0,
    const int8_t* pot, const int* wave_idx, const int* clock,
    const int* wm, int* status, int* s_out, int* c_out, int* wcid, int* clk,
    int* evicted, int* scratch, int T, int O, int V, int N, int sched,
    int gc_track, int gc_block, int n_nodes, int vec16, int staged,
    const Layout* layout, int layout_bytes, void* stream) {
  const Layout mine = make_layout(T, O, V, staged != 0);
  if (layout_bytes != (int)sizeof(Layout) ||
      memcmp(&mine, layout, sizeof(Layout)) != 0)
    return (int)cudaErrorInvalidValue;
  const Args a = {val, tid, cid, sid, head, wave, kind, keys, pkeys, op_val,
                  host, txn_tid, r_val, r_tid, r_cid, r_slot, s_lo0, pot,
                  wave_idx, clock, wm, status, s_out, c_out, wcid, clk,
                  evicted, scratch, T, O, V, N, sched, gc_track, gc_block,
                  n_nodes, vec16};
  const long long smem = 4 * layout->total;
  cudaStream_t st = (cudaStream_t)stream;
#ifndef COMMIT_LOOP_RUNTIME_SHAPE
  // SmallBank's shape (O=4, V=8) with both fixed at compile time; every
  // other shape runs the same code with them read at run time (as every
  // shape does in a -DCOMMIT_LOOP_RUNTIME_SHAPE build, which
  // scripts/kernel_variants.py times apart)
  if (O == 4 && V == 8)
    return staged ? launch<true, 4, 8>(a, smem, st)
                  : launch<false, 4, 8>(a, smem, st);
#endif
  return staged ? launch<true, 0, 0>(a, smem, st)
                : launch<false, 0, 0>(a, smem, st);
}

#ifdef COMMIT_LOOP_CLOCKS
// the cycles of each phase summed over the launches since the last call
// (thread 0's clock64()), copied to host memory `out` [kClockPhases] and
// cleared
extern "C" int commit_loop_clocks(void* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_clocks, sizeof(g_clocks));
  if (err != cudaSuccess) return (int)err;
  static const unsigned long long zeros[kClockPhases] = {};
  return (int)cudaMemcpyToSymbol(g_clocks, zeros, sizeof(g_clocks));
}
#endif
