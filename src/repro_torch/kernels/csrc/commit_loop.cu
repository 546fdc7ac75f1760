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
// dependent memory accesses.  The T steps are serially dependent (the commit
// order is the paper's deterministic order, and step i reads what step i-1
// installed), and a step reads a ring, then the slot it chose, then installs
// and re-reads the creator TID for the SID bump guard: a few dependent L2 or
// HBM round trips a step.  The bytes (the touched rings and the per-op
// inputs, under a megabyte a wave) take well under a microsecond at
// 3.35 TB/s.
//
// What the design does about it: one block runs the wave, so a step needs
// only __syncthreads (five a step), never a grid-wide sync.  blockDim is T
// rounded up to a warp, at most kMaxThreads = 512 (strided loops above):
// the kernel takes about 96 registers a thread, and 1024 threads of that
// would not fit the SM's 65,536 (the launch is refused).  The interval
// state (status, s_lo, s_hi, c_lo) lives in shared memory, and so does the
// potential matrix where T^2 bytes fit (rows padded to an odd count of words,
// so a column read by 32 threads hits 32 banks); above that it is read from
// global memory (L2).  Store tables are read with ld.global.cg (L2 only), so
// a line that an earlier step rewrote is never read stale from L1.
//
// One step i, each block citing the core/commit_phase.py (or ops.py / store.py)
// function it computes:
//   (A) warp 0, one lane per op: scan_ring with ceiling INF (read_newest),
//       creator_slots, lost_update, rw_edge_to_creator or first-committer-
//       wins, the dsi remote check, postsi_bounds' per-op maxima with the
//       re-gathered SID (ops.sid_regather), the install slot head + 1 and
//       store.evicting_visible; reduced over O by warp shuffles.  At the same
//       time every thread reduces ongoing_readers_of's maximum of s_lo over
//       column i of potential.
//   (B) thread 0: postsi_bounds (s_i, c_i, rule 5) or the clocked s_i/c_i,
//       the gc_block abort, commit, the outputs s/c, clk and evicted.
//   (C) warp 0: ops.masked_install, first half (the fixed fields; val and
//       head set to INT_MIN); all threads: push_bounds (rule 4(b)).
//   (D) warp 0: ops.masked_install, second half: atomicMax of val and head,
//       so among duplicate keys of one transaction the largest value wins and
//       head advances once, exactly as the min-then-max scatter.
//   (E) warp 0: ops.masked_sid_bump (rule 4(c)), its TID guard read after the
//       install; thread 0: status[i].
#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kRunning = 0, kCommitted = 1, kAborted = 2;
constexpr int kRead = 1, kWrite = 2, kRmw = 3;
constexpr int kInf = 1 << 30;
constexpr int kPostsi = 0, kCv = 1, kDsi = 4;
// shared scratch: [0, 32) per-warp reader maxima, [32, 37) the op
// reductions, [40, 44) the step's decision
constexpr int kScratch = 64;
constexpr int kMaxThreads = 512;  // commit_loop.py: MAX_THREADS

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
__device__ __forceinline__ long long gather_row(int key, int n) {
  const long long k = key < 0 ? (long long)key + n : key;
  return k < 0 ? 0 : (k >= n ? n - 1 : k);
}

// ops._drop_rows: the row a mode="drop" scatter writes, -1 if it drops
__device__ __forceinline__ long long drop_row(int key, int n) {
  const long long k = key < 0 ? (long long)key + n : key;
  return (k >= 0 && k < n) ? k : -1;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ bool is_read(int k) { return k == kRead || k == kRmw; }
__device__ __forceinline__ bool is_write(int k) { return k == kWrite || k == kRmw; }

__global__ void __launch_bounds__(kMaxThreads) commit_loop_kernel(
    // the store, updated in place (never restrict: this kernel writes it)
    int* val, int* tid, int* cid, int* sid, int* head, int* wave_tag,
    // the wave and the read phase
    const int* __restrict__ kind, const int* __restrict__ keys,
    const int* __restrict__ pkeys, const int* __restrict__ op_val,
    const int* __restrict__ host, const int* __restrict__ txn_tid,
    const int* __restrict__ r_val, const int* __restrict__ r_tid,
    const int* __restrict__ r_cid, const int* __restrict__ r_slot,
    const int* __restrict__ s_lo0, const int8_t* __restrict__ pot_g,
    const int* __restrict__ wave_idx_p, const int* __restrict__ clock_p,
    const int* __restrict__ wm_p,
    // outputs
    int* __restrict__ status_out, int* __restrict__ s_out,
    int* __restrict__ c_out, int* __restrict__ wcid_out,
    int* __restrict__ clk_out, int* __restrict__ evicted_out, int T, int O,
    int V, int N, int sched, int gc_track, int gc_block, int n_nodes,
    int staged) {
  extern __shared__ int smem[];
  int* status_s = smem;
  int* slo_s = smem + T;
  int* shi_s = smem + 2 * T;
  int* clo_s = smem + 3 * T;
  int* hnew_s = smem + 4 * T;  // [O] install slot of each op
  int* red_s = hnew_s + O;     // [kScratch]
  int8_t* pot_s = reinterpret_cast<int8_t*>(red_s + kScratch);
  const int tx = threadIdx.x, nthr = blockDim.x;
  const int lane = tx & 31, warp = tx >> 5, n_warps = nthr >> 5;
  const bool postsi = sched == kPostsi;
  const bool cv_rules = sched == kPostsi || sched == kCv;
  const bool dsi = sched == kDsi;

  const long long pitch = staged ? ((((T + 3) >> 2) | 1) << 2) : T;
  for (int j = tx; j < T; j += nthr) {
    status_s[j] = kRunning;
    slo_s[j] = s_lo0[j];
    clo_s[j] = s_lo0[j];
    shi_s[j] = kInf;
  }
  if (staged)
    for (int idx = tx; idx < T * T; idx += nthr) {
      const int r = idx / T;
      pot_s[r * pitch + (idx - r * T)] = pot_g[idx];
    }
  const int8_t* P = staged ? pot_s : pot_g;
  const int wave_idx = *wave_idx_p, clock0 = *clock_p, wm = *wm_p;
  const int tid0 = txn_tid[0];
  int clk = clock0, evicted = 0;  // thread 0's running values
  __syncthreads();

  for (int i = 0; i < T; ++i) {
    // ---- (A) reads, all before step i's install
    if (postsi) {  // ongoing_readers_of: RUNNING readers of my writes, not i
      int m = 0;
      for (int j = tx; j < T; j += nthr)
        if (j != i && P[j * pitch + i] && status_s[j] == kRunning)
          m = max(m, slo_s[j]);
      m = warp_max(m);
      if (lane == 0) red_s[warp] = m;
    }
    if (warp == 0) {
      int abort = 0, ev_cnt = 0;
      int wmax = INT_MIN, rsid = INT_MIN, wsid = INT_MIN;
      for (int o = lane; o < O; o += 32) {
        const long long m = (long long)i * O + o;
        const int k = kind[m];
        const bool r = is_read(k), w = is_write(k);
        const int pk = pkeys[m];
        const long long base = clip_row(pk, N) * V;
        int slot, best;
        scan_ring<true>(cid + base, tid + base, V, kInf, slot, best);
        const int nv_tid = __ldcg(tid + base + slot);
        const int nv_cid = __ldcg(cid + base + slot);
        const int nv_sid = __ldcg(sid + base + slot);
        // creator_slots: the newest creator as a wave-local id
        const int local = wrap_add(nv_tid, -tid0);
        const bool mine = local >= 0 && local < T;
        const bool creator_committed = mine && status_s[local] == kCommitted;
        const int rc = r_cid[m];
        bool ab = r && w && nv_cid != rc;  // lost_update
        if (cv_rules)                      // rw_edge_to_creator
          ab = ab || (w && creator_committed && P[i * pitch + local] != 0);
        else                               // first-committer-wins
          ab = ab || (w && creator_committed);
        if (dsi)  // a remote read whose key was overwritten meanwhile
          ab = ab || (r && floor_mod(keys[m], n_nodes) != host[i] &&
                      nv_cid != rc);
        abort |= ab;
        if (postsi) {  // postsi_bounds' per-op maxima
          const int cur_sid =
              __ldcg(sid + gather_row(pk, N) * V + r_slot[m]);
          wmax = max(wmax, w ? nv_cid : 0);
          rsid = max(rsid, r ? cur_sid : 0);
          wsid = max(wsid, w ? nv_sid : 0);
        }
        // the slot an install would reuse (head + 1), and the GC consult
        const int h_new = floor_mod(__ldcg(head + clip_row(pk, N)) + 1, V);
        hnew_s[o] = h_new;
        if (gc_track && w && __ldcg(tid + base + h_new) != -1 &&
            __ldcg(cid + base + floor_mod(h_new + 1, V)) > wm)
          ++ev_cnt;
      }
      abort = __any_sync(0xffffffffu, abort);
      wmax = warp_max(wmax);
      rsid = warp_max(rsid);
      wsid = warp_max(wsid);
      ev_cnt = warp_sum(ev_cnt);
      if (lane == 0) {
        red_s[32] = abort;
        red_s[33] = wmax;
        red_s[34] = rsid;
        red_s[35] = wsid;
        red_s[36] = ev_cnt;
      }
    }
    __syncthreads();

    // ---- (B) thread 0 decides
    if (tx == 0) {
      bool abort = red_s[32] != 0;
      int s_i, c_i;
      if (postsi) {  // postsi_bounds: rules 3, 4(a) and 5
        int readers = 0;
        for (int w = 0; w < n_warps; ++w) readers = max(readers, red_s[w]);
        const int wmax = red_s[33];
        const int s_lo_i = max(slo_s[i], wmax);
        int c_lo_i = max(clo_s[i], wmax);
        c_lo_i = max(c_lo_i, red_s[34]);
        c_lo_i = max(c_lo_i, red_s[35]);
        c_lo_i = max(c_lo_i, readers);
        abort = abort || s_lo_i > shi_s[i];
        s_i = s_lo_i;
        c_i = wrap_add(max(c_lo_i, s_i), 1);
      } else {  // clocked: snapshot = wave-entry clock, commit = clock + 1
        s_i = clock0;
        c_i = wrap_add(clk, 1);
      }
      const int ev_cnt = red_s[36];
      if (gc_block) abort = abort || ev_cnt > 0;
      const bool active = status_s[i] == kRunning;
      const bool commit = active && !abort;
      red_s[40] = commit;
      red_s[41] = s_i;
      red_s[42] = c_i;
      red_s[43] = active ? (abort ? kAborted : kCommitted) : status_s[i];
      s_out[i] = commit ? s_i : -1;
      c_out[i] = commit ? c_i : -1;
      if (commit) {
        clk = max(clk, c_i);
        if (gc_track) evicted = wrap_add(evicted, ev_cnt);
      }
    }
    __syncthreads();
    const bool commit = red_s[40] != 0;
    const int s_i = red_s[41], c_i = red_s[42];

    // ---- (C) install, first half; push_bounds
    if (warp == 0)
      for (int o = lane; o < O; o += 32) {
        const long long m = (long long)i * O + o;
        const bool w = is_write(kind[m]) && commit;
        wcid_out[m] = w ? c_i : -1;
        const long long row = drop_row(pkeys[m], N);
        if (w && row >= 0) {
          const long long cell = row * V + hnew_s[o];
          __stcg(val + cell, INT_MIN);
          __stcg(tid + cell, txn_tid[i]);
          __stcg(cid + cell, c_i);
          __stcg(sid + cell, 0);
          __stcg(head + row, INT_MIN);
          __stcg(wave_tag + row, wave_idx);
        }
      }
    if (postsi && commit) {  // status_s[i] is still RUNNING here
      for (int j = tx; j < T; j += nthr) {
        if (status_s[j] != kRunning) continue;
        if (P[i * pitch + j]) clo_s[j] = max(clo_s[j], wrap_add(s_i, 1));
        if (P[j * pitch + i]) shi_s[j] = min(shi_s[j], wrap_add(c_i, -1));
      }
      if (tx == 0) slo_s[i] = s_i;
    }
    __syncthreads();

    // ---- (D) install, second half: the largest live value wins
    if (warp == 0 && commit)
      for (int o = lane; o < O; o += 32) {
        const long long m = (long long)i * O + o;
        const int k = kind[m];
        const long long row = drop_row(pkeys[m], N);
        if (is_write(k) && row >= 0) {
          const int v_new = k == kRmw ? wrap_add(r_val[m], op_val[m])
                                      : op_val[m];
          atomicMax(val + row * V + hnew_s[o], v_new);
          atomicMax(head + row, hnew_s[o]);
        }
      }
    __syncthreads();

    // ---- (E) rule 4(c): SID bump, guarded by the TID read after install
    if (warp == 0 && commit)
      for (int o = lane; o < O; o += 32) {
        const long long m = (long long)i * O + o;
        if (!is_read(kind[m])) continue;
        const int pk = pkeys[m], slot = r_slot[m];
        if (__ldcg(tid + gather_row(pk, N) * V + slot) != r_tid[m]) continue;
        const long long row = drop_row(pk, N);
        if (row >= 0) atomicMax(sid + row * V + slot, s_i);
      }
    if (tx == 0) status_s[i] = red_s[43];
    __syncthreads();
  }

  for (int j = tx; j < T; j += nthr) status_out[j] = status_s[j];
  if (tx == 0) {
    *clk_out = clk;
    *evicted_out = evicted;
  }
}

}  // namespace

// val/tid/cid/sid: [N, V] int32, head/wave: [N] int32 (updated in place);
// kind/keys/pkeys/op_val/r_val/r_tid/r_cid/r_slot: [T, O] int32; host/tid/
// s_lo0: [T] int32; pot: [T, T] int8; wave_idx/clock/watermark: int32
// scalars.  Writes status/s/c [T], wcid [T, O], clk and evicted (scalars).
// One block of `threads` threads with `smem` bytes of dynamic shared memory;
// `staged`: potential copied into shared memory.
extern "C" int commit_loop_launch(
    void* val, void* tid, void* cid, void* sid, void* head, void* wave,
    const void* kind, const void* keys, const void* pkeys, const void* op_val,
    const void* host, const void* txn_tid, const void* r_val,
    const void* r_tid, const void* r_cid, const void* r_slot,
    const void* s_lo0, const void* pot, const void* wave_idx,
    const void* clock, const void* watermark, void* status, void* s_out,
    void* c_out, void* wcid, void* clk, void* evicted, int T, int O, int V,
    int N, int sched, int gc_track, int gc_block, int n_nodes, int threads,
    int smem, int staged, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      commit_loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  commit_loop_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      (int*)val, (int*)tid, (int*)cid, (int*)sid, (int*)head, (int*)wave,
      (const int*)kind, (const int*)keys, (const int*)pkeys,
      (const int*)op_val, (const int*)host, (const int*)txn_tid,
      (const int*)r_val, (const int*)r_tid, (const int*)r_cid,
      (const int*)r_slot, (const int*)s_lo0, (const int8_t*)pot,
      (const int*)wave_idx, (const int*)clock, (const int*)watermark,
      (int*)status, (int*)s_out, (int*)c_out, (int*)wcid, (int*)clk,
      (int*)evicted, T, O, V, N, sched, gc_track, gc_block, n_nodes, staged);
  return (int)cudaGetLastError();
}
