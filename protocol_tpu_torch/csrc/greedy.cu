// K12: the sequential greedy assignment for Hopper (sm_90a).
//
// Replaces protocol_tpu/ops/assign.py::assign_greedy (a lax.scan over the
// tasks in task_order): each task in turn takes the cheapest provider
// still free, the first index among equal costs, if that cost is
// < INFEASIBLE/2, else -1; the provider it takes is no longer free. It is
// also the rounding of assign_sinkhorn (a greedy on -plan).
//
// One block. The free set is a bitmask in shared memory (P/8 bytes; up to
// 1,638,400 providers). The steps form a chain (each pick shrinks the free
// set the next step sees), but the rows they read do not depend on it: the
// visit order is known at launch. So the work is split:
//   - producer warps 1..W take steps s = w-1, w-1+W, ...: each reads the
//     cost row of task order[s] (slot-major [T, P]: one contiguous row) and
//     reduces it, off the chain, to a list of its m = kList smallest keys
//     among the cells that are candidates (cost < INFEASIBLE/2, or NaN) and
//     free in a snapshot of the bitmask. A key is (ordered cost bits, -0
//     taken as +0) << 32 | provider, so the list runs in the plain argmin's
//     order; a NaN keys as 0 << 32 | provider, ahead of every cost, as
//     argmin puts it first. The snapshot is read only after the consumer's
//     progress word (acquire) shows step s - m done. The select takes two
//     passes over the row: the first bounds the list from above (each
//     lane's two least free values; see scan_row), the second is a
//     warp-wide threshold filter: a cell whose cost cannot beat the bound,
//     then the list's m-th key, is dropped by one compare; a lane with a
//     cell that passes tests it exactly and against the snapshot's free
//     bit and queues its key, and every 32 queued are sorted (bitonic, over
//     the lanes) and merged into the list. The list goes into slot s % m of
//     a ring of lists, released by a flag (release / acquire);
//   - warp 0 is the consumer: at step s it tests the list's m providers
//     against the free bitmask in one ballot and takes the first free one;
//     if its cell is < INFEASIBLE/2 it clears the bit and writes p4t[order
//     [s]], otherwise (a free NaN, or no free entry) the task stays -1; it
//     then publishes its progress (release).
//
// Why this is exact. The free set only shrinks, so the snapshot's free set
// contains the free set at step s, and the step's true pick (the least key
// among the candidates free at step s) is in it. A snapshot-free candidate
// with a smaller key than the true pick is not free at step s, so it was
// taken after the snapshot, by one of the steps s-m+1 .. s-1: at most m - 1
// of them. So the true pick is among the first m entries of the list, and
// no entry before it is free at step s: the first free entry is the pick.
// If no entry is free, no candidate is free (a list shorter than m holds
// every snapshot-free candidate; a full one would hold the pick) and the
// step gives -1. No step ever needs a scan of its own. The snapshot need
// not be taken at one instant: each bit is read after step s - m was
// done, and that is all the argument uses. The first pass's bound keeps
// this: the m free candidates it counts (free when it read them, after
// step s - m) all have smaller keys than any cell above the bound, so such
// a cell has m snapshot-free cells ahead of it and is never the true pick;
// the second pass may read bits later (fewer free), and the true pick,
// free at step s, is free in every read.
//
// The producers read their rows from device memory with 16-byte vector
// loads, four in flight a lane (the second pass finds the row in L2), not
// through a TMA ring of row buffers in shared memory: two buffers a
// producer leave room for 6 producers at 4,096 providers, 3.3 us a step,
// where 31 streaming producers take 1.0; and even where all 31 fit
// (up to 749 providers) the ring lost, 1.07-1.70 ms against 1.02-1.44 for
// 4,096 steps (H100 80GB HBM3, 700 W).
//
// What bounds it on the H100: the producers' select, not bytes: a row
// costs a producer warp ~27,000 cycles alone at 4,096 providers (the two
// passes, the exact tests and queueing of the ~50 cells under the bound,
// two merges of ~1,150 cycles), so 31 of them give the consumer a list
// every ~2,000 cycles; the consumer's own step (an acquire, a free-word
// read, a ballot, a release) is ~200-250 cycles. Its bytes are the cost
// block once (T x P x 4).
//
// Numerics: comparisons only (and +0.0 added to each cost); a free NaN
// cell wins the step and leaves the task unassigned, as in the scan;
// bit-identical to the plain torch loop in protocol_tpu_torch/ops/assign.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "chain.cuh"

namespace {

constexpr int kList = 32;  // m: a step's list, one entry a lane
constexpr int kMaxProducers = 31;
constexpr int kQueue = kList + 128;     // a vector queues at most 4 cells a lane
constexpr int kMaxFreeBytes = 200 * 1024;  // the free bitmask: 1,638,400 providers
constexpr int kUnroll = 4;              // 16-byte loads in flight a lane
constexpr unsigned kFull = 0xffffffffu;
constexpr float kHalfInfeasible = 5e8f;
constexpr unsigned long long kNoKey = ~0ull;
constexpr uint32_t kNanFlag = 0x80000000u;  // a list entry whose cell is NaN

// the block's dynamic shared memory: the free bitmask, the consumer's
// progress word, the list ring's flags, rows, counts and entries, then the
// producers' queues and their counts: as many producers as fit, at most
// kMaxProducers (the bitmask of 1.6M providers leaves room for 17)
struct Layout {
  int producers;
  int off_done, off_seq, off_row, off_n, off_ent, off_queue, off_count, smem;
};

inline int round16(long long x) { return (int)((x + 15) & ~15ll); }

inline Layout k12_layout(int P) {
  Layout l{};
  l.off_done = round16((long long)(P + 31) / 32 * 4);
  l.off_seq = l.off_done + 16;
  l.off_row = l.off_seq + kList * 4;
  l.off_n = l.off_row + kList * 4;
  l.off_ent = l.off_n + kList * 4;
  l.off_queue = l.off_ent + kList * kList * 4;
  const long long W = (kSmemMax - l.off_queue) / (kQueue * 8 + 16);
  l.producers = (int)(W < kMaxProducers ? W : kMaxProducers);
  l.off_count = l.off_queue + l.producers * kQueue * 8;
  l.smem = l.off_count + l.producers * 16;
  return l;
}

// order-preserving bits of a finite f32 (-0 taken as +0, as argmin does)
__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t u = __float_as_uint(__fadd_rn(f, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// The producer's select: the list (lane l holds its l-th smallest key,
// kNoKey past its end), the queue of cells that may enter it, and the
// threshold a cell must beat, kept as float compares: a cell c at p
// enters the queue iff its key is below the list's m-th key.
struct Select {
  unsigned long long best;
  int qn;       // cells queued (the same in every lane)
  float f_lim;  // the m-th key's cost (5e8 while the list is short; NaN if it is a NaN)
  int p_lim;    // its provider (INT_MIN while the list is short)
  bool nan_all; // every NaN beats it

  __device__ void reset() {
    best = kNoKey;
    qn = 0;
    f_lim = kHalfInfeasible;
    p_lim = INT32_MIN;
    nan_all = true;
  }

  __device__ __forceinline__ bool beats(float c, int p) const {
    return c != c ? (nan_all || p < p_lim) : (c < f_lim || (c == f_lim && p < p_lim));
  }

  // merge the queue's first whole 32-key chunks (all of it when `all`)
  // into the list; what is left moves to the queue's front, and the shared
  // count with it
  __device__ void merge(unsigned long long* q, int* count, int lane, bool all) {
    const int n = all ? qn : qn & ~31;
    for (int k = 0; k < n; k += 32) {
      unsigned long long x[1] = {k + lane < qn ? q[k + lane] : kNoKey};
      warp_sort<1>(x, lane);
      // the least 32 of two sorted runs: a bitonic sequence, then its merge
      const unsigned long long y = __shfl_sync(kFull, x[0], 31 - lane);
      unsigned long long c = y < best ? y : best;
#pragma unroll
      for (int stride = 16; stride > 0; stride >>= 1) {
        const unsigned long long o = __shfl_xor_sync(kFull, c, stride);
        c = (lane & stride) == 0 ? (o < c ? o : c) : (o < c ? c : o);
      }
      best = c;
    }
    const int left = qn - n;  // < 32
    const unsigned long long rest = lane < left ? q[n + lane] : kNoKey;
    __syncwarp();
    if (lane < left) q[lane] = rest;
    if (lane == 0) *count = left;
    __syncwarp();
    qn = left;
    const unsigned long long thr = __shfl_sync(kFull, best, kList - 1);
    if (thr != kNoKey) {
      const uint32_t hi = (uint32_t)(thr >> 32);
      nan_all = hi != 0u;
      f_lim = hi != 0u ? from_ordered(hi) : __uint_as_float(0x7fc00000u);
      p_lim = (int)(uint32_t)thr;
    }
  }
};

// The snapshot's free bits of the cells p0 .. p0 + 3 (bit e for cell
// p0 + e; 0 outside [0, P)). Where the row starts on a 16-byte granule
// (lead 0) the four lie in one word.
__device__ __forceinline__ uint32_t free4(const uint32_t* s_free, int p0, int P, int lead) {
  if (lead == 0 && p0 + 3 < P) return ld_word(&s_free[p0 >> 5]) >> (p0 & 31) & 0xfu;
  uint32_t f = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int p = p0 + e;
    if (p >= 0 && p < P) f |= (ld_word(&s_free[p >> 5]) >> (p & 31) & 1u) << e;
  }
  return f;
}

// a cell of a row of P read alone (+inf outside [0, P)): the row's last
// vector where it would end past the row
__device__ __forceinline__ float ld_cell(const float* __restrict__ row, int p, int P) {
  return p >= 0 && p < P ? __ldcs(row + p) : INFINITY;
}

// Walk a row of P cells, [-lead, ...) read as 16-byte vectors from its
// granule, kUnroll a lane at once: fn(vector, its first cell p0) for each.
// A vector that would end past the row is read cell by cell, so nothing
// past the row's last cell is read.
template <class F>
__device__ __forceinline__ void for_row(const float4* __restrict__ v4, int lead, int P, int lane,
                                        F&& fn) {
  const int n4 = (lead + P + 3) >> 2;
  const int n4_whole = (lead + P) >> 2;
  const float* row = reinterpret_cast<const float*>(v4) + lead;
  for (int b = 0; b < n4; b += 32 * kUnroll) {
    float4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = b + u * 32 + lane;
      const int p0 = j * 4 - lead;
      x[u] = j < n4_whole ? __ldcs(&v4[j])
             : j < n4     ? make_float4(ld_cell(row, p0, P), ld_cell(row, p0 + 1, P),
                                        ld_cell(row, p0 + 2, P), ld_cell(row, p0 + 3, P))
                          : make_float4(INFINITY, INFINITY, INFINITY, INFINITY);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) fn(x[u], (b + u * 32 + lane) * 4 - lead);
  }
}

// One producer's select over a row, in two passes. The first bounds the
// list from above: each lane keeps its two least values free in the
// snapshot (min / max step over a NaN; a free NaN after the least makes it
// the second too, and rightly: a NaN's key is below every cost's), and
// where the 32nd least of the lanes' 64 values, v, is below INFEASIBLE/2,
// at least 32 free candidates have keys below any cell above v, so no such
// cell is among the least 32. The second pass drops every cell above
// the threshold (v, then the list's m-th key) by one compare; a lane with
// a cell that passes tests it exactly and against the snapshot's free bit
// and queues its key (a shared-memory count hands out the slots); after
// each vector the warp merges the queue's whole 32-key chunks into the
// list.
__device__ __forceinline__ void scan_row(const float4* __restrict__ v4, int lead, int P,
                                         const uint32_t* s_free, Select& sel,
                                         unsigned long long* q, int* count, int lane) {
  float m[2] = {INFINITY, INFINITY};
  for_row(v4, lead, P, lane, [&](float4 x, int p0) {
    const uint32_t f = free4(s_free, p0, P, lead);
    const float c[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // min / max step over a NaN
      const float v = f >> e & 1u ? c[e] : INFINITY;
      m[1] = fminf(m[1], fmaxf(m[0], v));
      m[0] = fminf(m[0], v);
    }
  });
  // the 32nd least of the lanes' 64 values: element 31, lane 15's second
  warp_sort<2>(m, lane);
  const float v = __shfl_sync(kFull, m[1], 15);
  if (v < kHalfInfeasible) {  // candidates at or below it, and every NaN
    sel.f_lim = v;
    sel.p_lim = INT32_MAX;
  }
  for_row(v4, lead, P, lane, [&](float4 x, int p0) {
    const float c[4] = {x.x, x.y, x.z, x.w};
    unsigned pass = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) pass |= (unsigned)!(c[e] > sel.f_lim) << e;
    bool put = false;
    for (; pass; pass &= pass - 1) {  // the rare cells, one at a time
      const int e = __ffs(pass) - 1;
      const int p = p0 + e;
      const float v = e == 0 ? c[0] : e == 1 ? c[1] : e == 2 ? c[2] : c[3];
      if (p >= 0 && p < P && sel.beats(v, p) && (ld_word(&s_free[p >> 5]) >> (p & 31) & 1u)) {
        q[atomicAdd(count, 1)] =
            v != v ? (unsigned long long)(uint32_t)p
                   : ((unsigned long long)ordered_bits(v) << 32) | (uint32_t)p;
        put = true;
      }
    }
    if (__any_sync(kFull, put)) {
      __syncwarp();  // the lanes' appends, then lane 0's count for all
      sel.qn = __shfl_sync(kFull, lane == 0 ? *count : 0, 0);
      if (sel.qn >= kList) sel.merge(q, count, lane, false);
    }
  });
  if (sel.qn > 0) sel.merge(q, count, lane, true);
}

__global__ void __launch_bounds__(32 * (1 + kMaxProducers), 1)
    greedy_kernel(const float* __restrict__ cost, int T, int P,
                  const int32_t* __restrict__ order, int n_steps, int32_t* __restrict__ p4t,
                  Layout lay) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_free = reinterpret_cast<uint32_t*>(smem);
  int* s_done = reinterpret_cast<int*>(smem + lay.off_done);
  int* s_seq = reinterpret_cast<int*>(smem + lay.off_seq);
  int* s_row = reinterpret_cast<int*>(smem + lay.off_row);
  int* s_n = reinterpret_cast<int*>(smem + lay.off_n);
  uint32_t* s_ent = reinterpret_cast<uint32_t*>(smem + lay.off_ent);
  unsigned long long* s_queue = reinterpret_cast<unsigned long long*>(smem + lay.off_queue);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int W = lay.producers;
  const int n_words = (P + 31) / 32;
  for (int w = threadIdx.x; w < n_words; w += blockDim.x) {
    const int left = P - w * 32;
    s_free[w] = left >= 32 ? kFull : (1u << left) - 1u;
  }
  for (int s = threadIdx.x; s < kList; s += blockDim.x) s_seq[s] = 0;
  for (int k = threadIdx.x; k < 4 * W; k += blockDim.x)
    reinterpret_cast<int*>(smem + lay.off_count)[k] = 0;
  if (threadIdx.x == 0) *s_done = 0;
  __syncthreads();

  if (warp > 0) {
    const int k = warp - 1;
    unsigned long long* q = s_queue + (size_t)k * kQueue;
    int* count = reinterpret_cast<int*>(smem + lay.off_count) + 4 * k;
    Select sel;
    for (int i = k; i < n_steps; i += W) {
      // the row of step i from its 16-byte granule, the lead masked
      const uintptr_t a = reinterpret_cast<uintptr_t>(cost + (size_t)order[i] * P);
      const float4* src = reinterpret_cast<const float4*>(a & ~(uintptr_t)15);
      const int lead = (int)(a & 15) >> 2;
      // the snapshot: read only once step i - kList is done
      for (unsigned ns = 32; ld_acquire(s_done) < i - kList + 1; ns = ns < 1024 ? 2 * ns : ns)
        nap(ns);
      sel.reset();
      scan_row(src, lead, P, s_free, sel, q, count, lane);
      __syncwarp();
      const int slot = i % kList;
      const unsigned have = __ballot_sync(kFull, sel.best != kNoKey);
      if (sel.best != kNoKey) {
        const uint32_t hi = (uint32_t)(sel.best >> 32);
        s_ent[slot * kList + lane] = (uint32_t)sel.best | (hi == 0u ? kNanFlag : 0u);
      }
      if (lane == 0) {
        s_row[slot] = order[i];
        s_n[slot] = __popc(have);
      }
      __threadfence_block();
      __syncwarp();
      if (lane == 0) st_release(&s_seq[slot], i + 1);
    }
    return;
  }

  // the consumer: one ballot over a step's list; the next step's list is
  // read while this one's pick is stored
  struct Step {
    int n, row;
    uint32_t e;
  };
  auto take = [&](int s) {
    Step st{0, 0, 0u};
    if (s < n_steps) {
      const int slot = s % kList;
      while (ld_acquire(&s_seq[slot]) != s + 1) {
      }
      st.n = s_n[slot];
      st.row = s_row[slot];
      st.e = lane < st.n ? s_ent[slot * kList + lane] : 0u;
    }
    return st;
  };
  Step cur = take(0);
  for (int s = 0; s < n_steps; ++s) {
    const int p = (int)(cur.e & ~kNanFlag);
    const uint32_t w = lane < cur.n ? s_free[p >> 5] : 0u;
    const unsigned m = __ballot_sync(kFull, (w >> (p & 31)) & 1u);
    if (m && lane == __ffs(m) - 1 && !(cur.e & kNanFlag)) {
      s_free[p >> 5] = w & ~(1u << (p & 31));
      p4t[cur.row] = p;
    }
    __syncwarp();
    if (lane == 0) st_release(s_done, s + 1);
    cur = take(s + 1);
  }
}

}  // namespace

// Plain C interface (loaded with ctypes): walks order [n_steps] (task ids
// in [0, T)) over cost [T, P] f32 slot-major (16-byte aligned; nothing is
// read past its end, so it needs no padding), writing
// each assigned step's pick into p4t [T] (the caller fills it with -1
// first). Returns the launch's cudaError_t (0 = launched).
extern "C" int k12_greedy(const float* cost, int T, int P, const int32_t* order, int n_steps,
                          int32_t* p4t, void* stream) {
  if (T < 1 || P < 1 || n_steps < 0 || (P + 31) / 32 * 4 > kMaxFreeBytes ||
      (reinterpret_cast<uintptr_t>(cost) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const Layout lay = k12_layout(P);
  cudaError_t err =
      cudaFuncSetAttribute(greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.smem);
  if (err != cudaSuccess) return (int)err;
  greedy_kernel<<<1, 32 * (1 + lay.producers), lay.smem, (cudaStream_t)stream>>>(
      cost, T, P, order, n_steps, p4t, lay);
  return (int)cudaGetLastError();
}
