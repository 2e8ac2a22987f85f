// K9: the greedy cleanup at the end of the sparse auctions, for Hopper
// (sm_90a).
//
// Replaces protocol_tpu/ops/sparse.py::_greedy_cleanup_compacted (a
// lax.scan over the compacted open tasks): the open tasks go in index
// order, and each takes its cheapest still-free candidate (the first
// column among equal costs; an invalid or taken candidate costs
// INFEASIBLE), if that cost is < INFEASIBLE/2; the provider it takes is no
// longer free for the tasks after it.
//
// One block of 16 warps. They first build the free set (owner < 0) as a
// bitmask in shared memory (P/8 bytes; up to 1.6M providers), a warp
// reading 32 consecutive owners a word and forming it with a ballot. Then
// the sweep is a chain (each pick changes the free set the next row sees)
// whose rows' candidates do not depend on it:
//   - warps 1..15 are producers. Warp w stages open rows w-1, w+14, ...
//     into a ring of shared-memory slots, the next row's candidates in
//     flight in registers: it drops the entries that cannot be picked
//     (p < 0, a cost >= INFEASIBLE/2 or a provider already taken: the free
//     set only shrinks), sorts the rest by (cost with -0 taken as +0,
//     column k) with a bitonic sort over the warp's registers (64-bit
//     keys: cost bits, k, provider), and writes the providers in that
//     order and their count; a flag per slot (release / acquire) hands
//     the row over, and the consumer's progress word frees the slot;
//   - warp 0 sweeps, with the next two rows' first 32 providers already
//     in its registers: it tests 32 sorted providers a ballot against the
//     free bitmask and takes the first free one (__ffs), moving to the
//     next 32 only when none is free. Since the free set only shrinks, the
//     first entry in that order that is still free is exactly the plain
//     argmin's pick. The winning lane clears its bit and writes p4t.
//
// What bounds it on the H100: the chain of dependent rows, not bytes: a
// row costs the consumer a free-word read, a ballot, the winner's store
// and the next rows' reads, ~600 cycles under the producers' traffic
// (~0.28 us a row at 4,096 and 60,364 open rows, H100 80GB HBM3, 700 W);
// its bytes are the open rows' candidates (K x 8 per row) and the owner
// vector.
//
// Numerics: comparisons only; bit-identical to the plain torch loop in
// protocol_tpu_torch/ops/sparse.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "chain.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kProducers = kThreads / 32 - 1;  // warps 1..15
constexpr int kMaxK = 128;                  // candidates a row
constexpr int kMaxFreeBytes = 200 * 1024;   // the free bitmask: 1,638,400 providers
constexpr int kMinSlots = 32;
constexpr int kMaxSlots = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kHalfInfeasible = 5e8f;
constexpr unsigned long long kNoKey = ~0ull;

// the block's dynamic shared memory: the free bitmask, the consumer's
// progress word, S slots' flags, rows and counts, then S slots of up to
// K providers (a stride of K rounded up to 4, at least 32)
struct Layout {
  int S, stride, off_done, off_seq, off_row, off_n, off_slot, smem;
};

inline int round16(int x) { return (x + 15) & ~15; }

inline Layout k9_layout(int P, int K) {
  Layout l{};
  const int free_bytes = round16((P + 31) / 32 * 4);
  l.stride = K <= 32 ? 32 : (K + 3) & ~3;  // a warp reads a slot's first 32 unmasked
  const int per_slot = l.stride * 4 + 12;
  int S = (kSmemMax - free_bytes - 16 - 48) / per_slot;
  S = S < kMaxSlots ? S : kMaxSlots;
  l.S = S >= kMinSlots ? S : 0;
  l.off_done = free_bytes;
  l.off_seq = l.off_done + 16;
  l.off_row = l.off_seq + round16(l.S * 4);
  l.off_n = l.off_row + round16(l.S * 4);
  l.off_slot = l.off_n + round16(l.S * 4);
  l.smem = l.off_slot + l.S * l.stride * 4;
  return l;
}

// order-preserving bits of a finite f32 (-0 taken as +0, as min does)
__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t u = __float_as_uint(__fadd_rn(f, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <int NJ>
__global__ void __launch_bounds__(kThreads, 1)
    cleanup_kernel(const int32_t* __restrict__ cand_p, const float* __restrict__ cand_c, int K,
                   int P, const int32_t* __restrict__ owner, const int32_t* __restrict__ open_idx,
                   int n_open, int32_t* __restrict__ p4t, Layout lay) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* s_free = reinterpret_cast<uint32_t*>(smem);
  int* s_done = reinterpret_cast<int*>(smem + lay.off_done);
  int* s_seq = reinterpret_cast<int*>(smem + lay.off_seq);
  int* s_row = reinterpret_cast<int*>(smem + lay.off_row);
  int* s_n = reinterpret_cast<int*>(smem + lay.off_n);
  int* s_slot = reinterpret_cast<int*>(smem + lay.off_slot);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int S = lay.S;

  // the free set, 8 words a warp at a time (8 loads in flight a lane)
  const int n_words = (P + 31) / 32;
  for (int w0 = warp * 8; w0 < n_words; w0 += kThreads / 32 * 8) {
    int32_t o[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int p = (w0 + u) * 32 + lane;
      o[u] = w0 + u < n_words && p < P ? owner[p] : 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const unsigned m = __ballot_sync(kFull, o[u] < 0);
      if (lane == 0 && w0 + u < n_words) s_free[w0 + u] = m;
    }
  }
  for (int s = threadIdx.x; s < S; s += kThreads) s_seq[s] = 0;
  if (threadIdx.x == 0) *s_done = 0;
  __syncthreads();

  if (warp > 0) {
    // producer: rows warp-1, warp-1+kProducers, ...; the next row's
    // candidates and the row after's id are in flight while this row is
    // sorted
    int i = warp - 1;
    int32_t np[NJ];
    float nc[NJ];
    auto load_row = [&](int row) {
      const size_t base = (size_t)row * K;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int k = lane + 32 * j;
        np[j] = k < K ? cand_p[base + k] : -1;
        nc[j] = k < K ? cand_c[base + k] : 0.0f;
      }
    };
    int r_cur = i < n_open ? open_idx[i] : 0;
    if (i < n_open) load_row(r_cur);
    int r_next = i + kProducers < n_open ? open_idx[i + kProducers] : 0;
    for (; i < n_open; i += kProducers) {
      int32_t cp[NJ];
      float cc[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        cp[j] = np[j];
        cc[j] = nc[j];
      }
      const int row = r_cur;
      if (i + kProducers < n_open) {
        load_row(r_next);
        r_cur = r_next;
        r_next = i + 2 * kProducers < n_open ? open_idx[i + 2 * kProducers] : 0;
      }
      unsigned long long key[NJ];
      int n = 0;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int k = lane + 32 * j;
        const int p = cp[j];
        const bool v = k < K && p >= 0 && cc[j] < kHalfInfeasible &&
                       ((ld_word(&s_free[p >> 5]) >> (p & 31)) & 1u);
        key[j] = v ? ((unsigned long long)ordered_bits(cc[j]) << 28) |
                         ((unsigned long long)k << 21) | (uint32_t)p
                   : kNoKey;
        n += __popc(__ballot_sync(kFull, v));
      }
      if (n > 1) warp_sort<NJ>(key, lane);
      else if (n == 1) {  // the one entry to the front
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const unsigned m = __ballot_sync(kFull, key[j] != kNoKey);
          if (m) {
            key[0] = __shfl_sync(kFull, key[j], __ffs(m) - 1);
            break;
          }
        }
      }
      const int s = i % S;
      for (unsigned ns = 32; ld_acquire(s_done) < i - S + 1; ns = ns < 2048 ? 2 * ns : ns) nap(ns);
      int* slot = s_slot + s * lay.stride;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int e = lane * NJ + j;
        if (e < n) slot[e] = (int)(key[j] & 0x1fffffull);
      }
      if (lane == 0) {
        s_row[s] = row;
        s_n[s] = n;
      }
      __threadfence_block();
      __syncwarp();
      if (lane == 0) st_release(&s_seq[s], i + 1);
    }
    return;
  }

  // consumer: warp 0 sweeps the rows in order, with the providers of the
  // next two rows already in registers: a row's chain is a free-word read,
  // one ballot and the winner's store; the read of row i + 2 follows it
  struct Row {
    int n, row, p, s;
  };
  auto fetch = [&](int i, int s) {
    Row r{0, 0, -1, s};
    if (i < n_open) {
      while (ld_acquire(&s_seq[s]) != i + 1) {
      }
      r.n = s_n[s];
      r.row = s_row[s];
      r.p = s_slot[s * lay.stride + lane];  // past n: masked in the sweep
    }
    return r;
  };
  auto next_slot = [&](int s) { return s + 1 == S ? 0 : s + 1; };
  Row cur = fetch(0, 0);
  Row nxt = fetch(1, next_slot(0));
  int s_ahead = next_slot(next_slot(0));  // row i + 2's slot
  for (int i = 0; i < n_open; ++i) {
    int p = lane < cur.n ? cur.p : -1;
    uint32_t w = p >= 0 ? s_free[p >> 5] : 0u;
    unsigned m = __ballot_sync(kFull, (w >> (p & 31)) & 1u);
    for (int base = 32; m == 0 && base < cur.n; base += 32) {  // all 32 taken: the next 32
      p = base + lane < cur.n ? s_slot[cur.s * lay.stride + base + lane] : -1;
      w = p >= 0 ? s_free[p >> 5] : 0u;
      m = __ballot_sync(kFull, (w >> (p & 31)) & 1u);
    }
    if (m && lane == __ffs(m) - 1) {
      s_free[p >> 5] = w & ~(1u << (p & 31));
      p4t[cur.row] = p;
    }
    __syncwarp();
    const Row ahead = fetch(i + 2, s_ahead);
    s_ahead = next_slot(s_ahead);
    if (lane == 0) st_release(s_done, i + 1);
    cur = nxt;
    nxt = ahead;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes): sweeps open_idx [n_open] (task
// ids, ascending) over cand_p / cand_c [T, K], writing each pick into p4t
// [T] in place. Returns the launch's cudaError_t (0 = launched).
extern "C" int k9_greedy_cleanup(const int32_t* cand_p, const float* cand_c, int K, int P,
                                 const int32_t* owner, const int32_t* open_idx, int n_open,
                                 int32_t* p4t, void* stream) {
  if (K < 1 || K > kMaxK || P < 1 || n_open < 0 || (P + 31) / 32 * 4 > kMaxFreeBytes)
    return (int)cudaErrorInvalidValue;
  const Layout lay = k9_layout(P, K);
  if (lay.S == 0) return (int)cudaErrorInvalidValue;
  auto kern = K <= 32 ? cleanup_kernel<1> : K <= 64 ? cleanup_kernel<2> : cleanup_kernel<4>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<1, kThreads, lay.smem, (cudaStream_t)stream>>>(cand_p, cand_c, K, P, owner, open_idx,
                                                        n_open, p4t, lay);
  return (int)cudaGetLastError();
}
