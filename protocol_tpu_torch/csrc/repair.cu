// The repair refold of the warm path for Hopper (sm_90a): the part of the
// reference's churn-masked candidate repair (protocol_tpu/parallel/
// sparse.py: repair_topk_bidir_sharded) that is neither a K1 launch nor a
// list launch. K3 (the enter scan), K4 (the dirty-column tile minima) and
// the reverse blocks are list launches of K1's layout in candidates.cu,
// bound there (k3_repair_enter, k4_repair_tile_min, k1_reverse_blocks);
// this library holds K5 alone.
//
//   K5 refold    (_build_repair_refold + _merge_rev_pools at d_fold
//                lanes) each provider's best r of its pool entries [P,
//                n_tiles] from the (INFEASIBLE, -1) carry: the reference
//                folds each lane's consecutive tiles in tile order with
//                lax.top_k of the negated costs (the carry first among
//                ties) and merges the lanes' lists in lane order by the
//                same rule. That is the stable top-r of the entries in
//                tile order, whatever d_fold, under top_k's order: the IEEE
//                total order of the costs (-NaN < -inf < ... < -0 < +0 <
//                ... < +inf < +NaN), the earlier entry first among equal
//                bits. An entry enters when it lies below the carry's
//                INFEASIBLE in that order (a negative NaN does, at -1; +NaN,
//                +inf and the entries at or above INFEASIBLE never do).
//                Writes rev_c [P, r], each entry's cost bits as in the
//                pool, and rev_t [P, r], -1 where the cost is not below
//                INFEASIBLE/2 (a NaN fails the test); a list with fewer
//                than r entries ends with (INFEASIBLE, -1).
//
// Layout. A group of G lanes a provider (G a power of two from n_tiles /
// kLaneEntries, 1 to 32: 2 at 64 tiles), four warps a block. Lane g takes
// the entries g, g + G, ... of its provider's cost row, 8 a batch, the
// next batch loaded while one is sorted; each entry becomes a 64-bit key
// (order_bits(cost) << 32 | position), order_bits the total order as
// unsigned bits (candidates.cu's), or the all-ones key where it does not
// enter. A lane sorts a batch with Batcher's odd-even network (19
// compare-exchanges of 64-bit keys) and keeps the least 8 of it and its
// list: min(a[i], b[7 - i]) is bitonic and holds the least 8 of the two
// sorted lists, and three half-cleaner stages sort it. The group's lists
// then meet the same way over log2(G) rounds of 64-bit shuffles, every
// lane ending with the group's least 8 keys. Lane g writes places g, g +
// G, ... < r of rev_c (decoded from the key: the total order is a
// bijection, so the pool's bits come back) and rev_t (read from the pool
// at the key's position). d_fold is checked and otherwise unused: lanes of
// consecutive tiles give the same list.
//
// What bounds it on the H100: bytes. The pools are read once, the costs
// whole and the tasks at the winners, and the edges written once: ~P
// (n_tiles + r) x 8 bytes counted as in PERF.md. The work is integer
// compares and selects: 8 lanes a provider at 64 tiles spend 3 rounds of
// merges on top of the networks, 1 lane loses the coalesced loads; 2 lanes
// took the least time (PERF.md §6). The kernel it replaced, a thread a
// provider, folded n_tiles x r dependent compare-and-swaps, its warps'
// loads strided by the row length.
//
// Numerics: no arithmetic on the costs: every output is bit-identical to
// the plain torch version in protocol_tpu_torch/parallel/sparse.py.

#include "cell.cuh"

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 128;
constexpr int kBatch = 8;             // entries a lane takes a batch; keys a list keeps
constexpr int kLaneEntries = 32;      // entries a lane takes before its group doubles
constexpr u64 kNoKey = ~0ull;         // above every key: an entry that does not enter
constexpr unsigned kFull = 0xffffffffu;

// A float's place in the IEEE total order, as unsigned bits (sign bit set
// on a non-negative float, every bit flipped on a negative one).
__device__ __forceinline__ uint32_t order_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// order_bits' inverse: a key's cost bits.
__device__ __forceinline__ float order_float(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ void order2(u64& a, u64& b) {  // a, b ascending
  const u64 lo = a < b ? a : b;
  b = a < b ? b : a;
  a = lo;
}

// A bitonic sequence of kBatch keys sorted ascending: half-cleaners.
__device__ __forceinline__ void bitonic_merge(u64 (&k)[kBatch]) {
#pragma unroll
  for (int stride = kBatch / 2; stride > 0; stride >>= 1)
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if ((i ^ stride) > i) order2(k[i], k[i ^ stride]);
}

// kBatch (8) keys sorted ascending: Batcher's odd-even merge sort, 19
// compare-exchanges.
__device__ __forceinline__ void sort8(u64 (&k)[kBatch]) {
  static_assert(kBatch == 8, "the network is for 8 keys");
  order2(k[0], k[1]), order2(k[2], k[3]), order2(k[4], k[5]), order2(k[6], k[7]);
  order2(k[0], k[2]), order2(k[1], k[3]), order2(k[4], k[6]), order2(k[5], k[7]);
  order2(k[1], k[2]), order2(k[5], k[6]);
  order2(k[0], k[4]), order2(k[1], k[5]), order2(k[2], k[6]), order2(k[3], k[7]);
  order2(k[2], k[4]), order2(k[3], k[5]);
  order2(k[1], k[2]), order2(k[3], k[4]), order2(k[5], k[6]);
}

// a := the least kBatch keys of the ascending lists a and b, ascending.
__device__ __forceinline__ void keep_least(u64 (&a)[kBatch], const u64 (&b)[kBatch]) {
#pragma unroll
  for (int i = 0; i < kBatch; ++i) a[i] = a[i] < b[kBatch - 1 - i] ? a[i] : b[kBatch - 1 - i];
  bitonic_merge(a);
}

template <int G>
__global__ void __launch_bounds__(kThreads) refold_kernel(const int32_t* __restrict__ pool_t,
                                                          const float* __restrict__ pool_c,
                                                          int P, int n_tiles, int r,
                                                          int32_t* __restrict__ rev_t,
                                                          float* __restrict__ rev_c) {
  const int p = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const int g = threadIdx.x % G;
  const bool live = p < P;  // group-uniform; every lane stays for the shuffles
  const size_t base = (size_t)p * n_tiles;
  const uint32_t cap = order_bits(kInfeasible);  // the carry's place
  u64 best[kBatch];
#pragma unroll
  for (int e = 0; e < kBatch; ++e) best[e] = kNoKey;
  // batches of the lane's positions g + (8 b + e) G, each loaded while the
  // last one is sorted and merged
  uint32_t o[kBatch];
#pragma unroll
  for (int e = 0; e < kBatch; ++e) {
    const int i = g + e * G;
    o[e] = live && i < n_tiles ? order_bits(pool_c[base + i]) : ~0u;  // ~0u never enters
  }
  for (int i0 = g; i0 < n_tiles; i0 += kBatch * G) {
    u64 k[kBatch];
#pragma unroll
    for (int e = 0; e < kBatch; ++e)
      k[e] = o[e] < cap ? (u64)o[e] << 32 | (uint32_t)(i0 + e * G) : kNoKey;
    const int next = i0 + kBatch * G;
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const int i = next + e * G;
      o[e] = live && i < n_tiles ? order_bits(pool_c[base + i]) : ~0u;
    }
    sort8(k);
    if (i0 == g) {  // the lane's first batch (g < n_tiles: G <= n_tiles)
#pragma unroll
      for (int e = 0; e < kBatch; ++e) best[e] = k[e];
    } else {
      keep_least(best, k);
    }
  }
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    u64 other[kBatch];
#pragma unroll
    for (int e = 0; e < kBatch; ++e) other[e] = __shfl_xor_sync(kFull, best[e], off);
    keep_least(best, other);
  }
  if (!live) return;
#pragma unroll
  for (int e = 0; e < kBatch; ++e) {
    if (e < r && e % G == g) {
      float c = kInfeasible;
      int32_t t = -1;
      if (best[e] != kNoKey) {
        c = order_float((uint32_t)(best[e] >> 32));
        t = pool_t[base + (uint32_t)best[e]];
      }
      rev_c[(size_t)p * r + e] = c;
      rev_t[(size_t)p * r + e] = c < kHalfInfeasible ? t : -1;
    }
  }
}

template <int G>
void launch_refold(const int32_t* pool_t, const float* pool_c, int P, int n_tiles, int r,
                   int32_t* rev_t, float* rev_c, cudaStream_t st) {
  constexpr int per_block = kThreads / G;
  refold_kernel<G><<<(P + per_block - 1) / per_block, kThreads, 0, st>>>(pool_t, pool_c, P,
                                                                         n_tiles, r, rev_t, rev_c);
}

}  // namespace

// Lanes a provider for n_tiles pool entries: the power of two at or above
// n_tiles / kLaneEntries, from 1 to 32. Mirrored by kernels.refold_group.
extern "C" int k5_group(int n_tiles) {
  int g = 1;
  while (g < 32 && g * kLaneEntries < n_tiles) g <<= 1;
  return g;
}

// Plain C interface (loaded with ctypes), as candidates.cu. Returns the
// launch's cudaError_t (0 = launched).
extern "C" int k5_repair_refold(const int32_t* pool_t, const float* pool_c, int P, int n_tiles,
                                int r, int d_fold, int32_t* rev_t, float* rev_c, void* stream) {
  if (r < 1 || r > kMaxR || P < 1 || d_fold < 1 || n_tiles < 1 || n_tiles % d_fold != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (k5_group(n_tiles)) {
    case 1: launch_refold<1>(pool_t, pool_c, P, n_tiles, r, rev_t, rev_c, st); break;
    case 2: launch_refold<2>(pool_t, pool_c, P, n_tiles, r, rev_t, rev_c, st); break;
    case 4: launch_refold<4>(pool_t, pool_c, P, n_tiles, r, rev_t, rev_c, st); break;
    case 8: launch_refold<8>(pool_t, pool_c, P, n_tiles, r, rev_t, rev_c, st); break;
    case 16: launch_refold<16>(pool_t, pool_c, P, n_tiles, r, rev_t, rev_c, st); break;
    default: launch_refold<32>(pool_t, pool_c, P, n_tiles, r, rev_t, rev_c, st); break;
  }
  return (int)cudaGetLastError();
}
