// The batch matcher's dense auction for Hopper (sm_90a): K7, the auction
// of protocol_tpu/sched/tpu_backend.py::_solve_bounded. Its inputs, K6's
// value rows and task feasibility, and the swarm phase's argmin K8
// (_solve_unbounded) are list launches of K1's layout in candidates.cu
// (k6_value_base, k8_unbounded_best), as is K10 (k10_cost_block).
//
//   K7 auction      (ops/assign.py::assign_auction, the dense Jacobi
//                   auction, its lax.while_loop) all rounds in ONE
//                   cooperative launch of one persistent block of 1,024
//                   threads an SM, no host sync per round. The open slots
//                   live in a compacted list (the first round's: every
//                   feasible slot). A round:
//                     A. the list's rows are spread over the grid's warps,
//                        a row to a group of g warps, g chosen from the
//                        open count so that the rows fill the warps (g =
//                        1 once there are about as many rows as warps, and
//                        where a block would hold more groups than named
//                        barriers; up to a block a row). Each warp reads a
//                        strided share of the value row as 16-byte vectors
//                        (4 in flight a lane, the prices' vectors beside
//                        them) minus the prices, staged in shared memory
//                        once a round where P x 4 bytes fit (else read
//                        through L2, which is 2-21% slower where both
//                        fit): p1 = the first index of the maximum
//                        v1, v2 = the maximum with only p1 masked (a tie
//                        elsewhere gives v2 = v1), merged over the lanes
//                        and the group's warps (through shared memory) by
//                        the same rule, floored at -1e8; bid = (price[p1]
//                        + (v1 - v2)) + eps; a 64-bit atomicMax on
//                        (order-preserving bid bits << 32 | ~slot) keeps
//                        the highest bid per provider and, among equal
//                        bids, the lowest slot (the reference's argmax over
//                        the bid column), so the list's order changes no
//                        bit;
//                     B. the bidders only: the winner of each provider
//                        evicts the old owner, takes the seat and sets the
//                        price to its bid; losers and evicted owners are
//                        appended to the next round's list (one atomic a
//                        warp); the keys of the round before are reset
//                        here (two key buffers alternate by round parity);
//                   the list's length is the open count, and `it <
//                   max_iters && open > 0` is tested before every round,
//                   as the reference's while_loop cond. A grid barrier
//                   (a release add on a generation word, acquire polls)
//                   follows each step; the cooperative launch guarantees
//                   every block is resident.
// What bounds it on the H100: K7 reads the open slots' value rows each
// round, bound by bytes: sum over rounds of open rows x P x 4 bytes. At
// 4,096^2 a round's bid step reads at ~2.8 TB/s where each warp has at
// most one row; the two grid barriers (~2,100 cycles each at 132 blocks,
// against ~2,800 for a fenced volatile spin), the seat step's chain of L2
// reads and the price staging take the rest, about a quarter of a round. The open count never falls below ~1,450 of
// 3,040 at 4,096^2 (300 rounds) nor ~190 of 32,768 (500 rounds) on the
// main path's inputs, so no tail of a few rows is worth handing to one
// cluster.
//
// Numerics: built like candidates.cu (-fmad=false, no fast-math), so each
// f32 operation rounds once in the reference's order; the atomics are
// order-independent integer maxima. Every output is bit-identical to the
// plain torch version (ops/assign.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kV2Floor = -1e8f;

__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// ---------------------------------------------------------------- K7

constexpr int kAucThreads = 1024;
constexpr int kAucWarps = kAucThreads / 32;
constexpr int kAucUnroll = 4;                // 16-byte value loads in flight a lane
constexpr int kPriceMaxBytes = 200 * 1024;   // the shared-memory price route's limit
constexpr int kNamedBarriers = 15;           // bar.sync 1..15 (0 is __syncthreads)

// the launch's route: the round's prices staged in shared memory where
// P x 4 bytes fit; kernels.dense_route mirrors it
__host__ __device__ inline bool k7_shared_prices(int P) {
  return (long long)P * 4 <= kPriceMaxBytes;
}

__device__ __forceinline__ unsigned atom_add_release_gpu(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Grid-wide barrier: thread 0 of every block adds one to a monotone
// generation word with release semantics and polls it with acquire loads
// until it reaches epoch x blocks (the block's other threads are ordered
// by the __syncthreads around it). The word starts at 0.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned n_blocks, unsigned& epoch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    ++epoch;
    atom_add_release_gpu(bar, 1u);
    const unsigned target = epoch * n_blocks;
    while (ld_acquire_gpu(bar) < target) {
    }
  }
  __syncthreads();
}

// the top two of a set of cells with the first index of the first, from
// those of two disjoint sets (a tie elsewhere gives v2 = v1)
__device__ __forceinline__ void top2_merge(float& b1, int& i1, float& b2, float c1, int k1,
                                           float c2) {
  if (c1 > b1 || (c1 == b1 && k1 < i1)) {
    b2 = fmaxf(fmaxf(b1, b2), c2);
    b1 = c1;
    i1 = k1;
  } else {
    b2 = fmaxf(fmaxf(b2, c1), c2);
  }
}

// append `who` to the next round's open list, one atomic a warp
__device__ __forceinline__ void warp_append(bool app, int who, unsigned* cnt, int32_t* list,
                                            int lane) {
  const unsigned m = __ballot_sync(kFull, app);
  if (!m) return;
  const int leader = __ffs(m) - 1;
  unsigned base = 0;
  if (lane == leader) base = atomicAdd(cnt, (unsigned)__popc(m));
  base = __shfl_sync(kFull, base, leader);
  if (app) list[base + __popc(m & ((1u << lane) - 1u))] = who;
}

// a lane's next cell value v at p (p grows in the lane: the first maximum
// stays)
__device__ __forceinline__ void top2_push(float& b1, int& i1, float& b2, float v, int p) {
  if (v > b1) {
    b2 = b1;
    b1 = v;
    i1 = p;
  } else {
    b2 = fmaxf(b2, v);
  }
}

struct Part {  // one warp's share of a row: its top two and the first index
  float b1;
  int i1;
  float b2;
  int pad;
};

template <bool kSharedPrice>
__global__ void __launch_bounds__(kAucThreads, 1) dense_auction_kernel(
    const float* __restrict__ vb, const uint8_t* __restrict__ feasible, int T, int P, float eps,
    int max_iters, float* price, int32_t* owner, int32_t* p4t, int32_t* fr_p1,
    unsigned long long* fr_key, unsigned long long* win_key, int32_t* list, unsigned* ctl,
    long long* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Part s_part[2][kAucWarps];
  float* s_price = reinterpret_cast<float*>(smem);
  unsigned* bar = ctl;      // the grid barrier's generation word
  unsigned* cnt = ctl + 1;  // three open-list counts, by round mod 3
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nb = gridDim.x;
  const int gtid = blockIdx.x * kAucThreads + threadIdx.x;
  const int n_threads = nb * kAucThreads;
  const int n_warps_total = nb * kAucWarps;
  unsigned epoch = 0;

  // the first round's open list: every feasible slot
  for (int t0 = (gtid & ~31); t0 < T; t0 += n_threads) {
    const int t = t0 + lane;
    warp_append(t < T && feasible[t], t, &cnt[0], list, lane);
  }
  grid_barrier(bar, nb, epoch);

  int it = 0;
  int n_prev = 0;      // the round before's bidders (their keys are reset here)
  long long rows = 0;  // open rows summed over rounds (the launch's work)
  for (;;) {
    const int n_cur = (int)__ldcg(&cnt[it % 3]);
    if (it >= max_iters || n_cur == 0) break;
    rows += n_cur;
    const int par = it & 1;
    const int32_t* lst = list + (size_t)par * T;
    int32_t* nxt = list + (size_t)(par ^ 1) * T;
    unsigned long long* wk = win_key + (size_t)par * P;
    int32_t* fp = fr_p1 + (size_t)par * T;
    if (gtid == 0) cnt[(it + 2) % 3] = 0u;  // read as n_cur two rounds ago; next round's

    // ---- A. bids: a group of g warps a row, g from the open count so
    // that the rows fill the grid's warps; each warp scans a strided share
    // of the row's 16-byte vectors
    int g = 1;
    while (g < kAucWarps && (long long)n_cur * g * 2 <= n_warps_total) g *= 2;
    if (kAucWarps / g > kNamedBarriers) g = 1;  // more groups than named barriers
    const int gpb = kAucWarps / g;          // groups a block
    const int grp = warp / g, sub = warp % g;
    const int n_groups = nb * gpb;
    const int first = grp * nb + blockIdx.x;  // rows spread over the blocks first
    if (kSharedPrice) {
      if (blockIdx.x < n_cur) {  // a block with a row stages the round's prices
        for (int p = threadIdx.x; p < P; p += kAucThreads) s_price[p] = __ldcg(&price[p]);
      }
      __syncthreads();
    }
    int k_it = 0;
    for (int i = first; i < n_cur; i += n_groups, ++k_it) {
      const int t = __ldcg(&lst[i]);
      const uintptr_t a = reinterpret_cast<uintptr_t>(vb + (size_t)t * P);
      const float4* v4 = reinterpret_cast<const float4*>(a & ~(uintptr_t)15);
      const int lead = (int)(a & 15) >> 2;
      const int n4 = (lead + P) >> 2;  // the vectors that end inside the row
      float b1 = -INFINITY, b2 = -INFINITY;
      int i1 = P;
      const int step = 32 * g;
      for (int j0 = sub * 32 + lane; j0 < n4; j0 += step * kAucUnroll) {
        float4 x[kAucUnroll], q[kAucUnroll];
#pragma unroll
        for (int u = 0; u < kAucUnroll; ++u) {
          const int j = j0 + u * step;
          if (j < n4) {
            x[u] = __ldg(&v4[j]);
            if (lead == 0)  // the prices as vectors too
              q[u] = kSharedPrice ? reinterpret_cast<const float4*>(s_price)[j]
                                  : __ldcg(reinterpret_cast<const float4*>(price) + j);
          }
        }
#pragma unroll
        for (int u = 0; u < kAucUnroll; ++u) {
          const int j = j0 + u * step;
          if (j >= n4) break;
          const float c[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
          const float pq[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = j * 4 + e - lead;
            if (p < 0) continue;
            const float pr = lead == 0 ? pq[e] : kSharedPrice ? s_price[p] : __ldcg(&price[p]);
            top2_push(b1, i1, b2, __fsub_rn(c[e], pr), p);
          }
        }
      }
      // the row's last cells, where a vector would end past the row: one by
      // one, by the lane whose share the vector is (its last)
      if (((lead + P) & 3) != 0 && n4 % step == sub * 32 + lane) {
        const float* row = vb + (size_t)t * P;
        for (int p = n4 * 4 - lead > 0 ? n4 * 4 - lead : 0; p < P; ++p) {
          const float pr = kSharedPrice ? s_price[p] : __ldcg(&price[p]);
          top2_push(b1, i1, b2, __fsub_rn(__ldg(row + p), pr), p);
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const float c1 = __shfl_xor_sync(kFull, b1, o);
        const int k1 = __shfl_xor_sync(kFull, i1, o);
        const float c2 = __shfl_xor_sync(kFull, b2, o);
        top2_merge(b1, i1, b2, c1, k1, c2);
      }
      if (g > 1) {  // the group's warps merge through shared memory
        Part* part = s_part[k_it & 1];
        if (lane == 0) part[warp] = Part{b1, i1, b2, 0};
        asm volatile("bar.sync %0, %1;" ::"r"(1 + grp), "r"(32 * g) : "memory");
        if (sub == 0) {
          const Part q = lane < g ? part[grp * g + lane] : Part{-INFINITY, P, -INFINITY, 0};
          b1 = q.b1;
          i1 = q.i1;
          b2 = q.b2;
          for (int o = 16; o > 0; o >>= 1) {
            const float c1 = __shfl_xor_sync(kFull, b1, o);
            const int k1 = __shfl_xor_sync(kFull, i1, o);
            const float c2 = __shfl_xor_sync(kFull, b2, o);
            top2_merge(b1, i1, b2, c1, k1, c2);
          }
        }
      }
      if (sub == 0 && lane == 0) {
        const float v2 = fmaxf(b2, kV2Floor);
        const float p1 = kSharedPrice ? s_price[i1] : __ldcg(&price[i1]);
        const float bid = __fadd_rn(__fadd_rn(p1, __fsub_rn(b1, v2)), eps);
        const unsigned long long key =
            ((unsigned long long)ordered_bits(bid) << 32) | (unsigned long long)(~(uint32_t)t);
        atomicMax(&wk[i1], key);
        fp[i] = i1;
        fr_key[i] = key;
      }
    }
    grid_barrier(bar, nb, epoch);

    // ---- B. the round before's keys are reset; winners take their seats,
    // evicting the old owners; losers and the evicted make the next list
    unsigned long long* wk_prev = win_key + (size_t)(par ^ 1) * P;
    const int32_t* fp_prev = fr_p1 + (size_t)(par ^ 1) * T;
    unsigned* cnt_next = &cnt[(it + 1) % 3];
    const int n_seat = n_cur > n_prev ? n_cur : n_prev;
    // 32 slots a warp, spread over the blocks first: each SM's loads few
    for (int i0 = (warp * nb + blockIdx.x) * 32; i0 < n_seat; i0 += n_threads) {
      const int i = i0 + lane;
      // the independent reads first, then the two that need the provider
      const int q = i < n_prev ? __ldcg(&fp_prev[i]) : -1;
      const bool bidder = i < n_cur;
      const int t = bidder ? __ldcg(&lst[i]) : 0;
      const int p = bidder ? __ldcg(&fp[i]) : 0;
      const unsigned long long key = bidder ? __ldcg(&fr_key[i]) : 0ull;
      if (q >= 0) wk_prev[q] = 0ull;
      bool app = false;
      int who = 0;
      if (bidder) {
        const unsigned long long won = __ldcg(&wk[p]);
        const int old = __ldcg(&owner[p]);
        if (won == key) {
          if (old >= 0) {
            p4t[old] = -1;
            app = true;
            who = old;
          }
          p4t[t] = p;
          owner[p] = t;
          price[p] = from_ordered((uint32_t)(key >> 32));
        } else {
          app = true;
          who = t;
        }
      }
      warp_append(app, who, cnt_next, nxt, lane);
    }
    grid_barrier(bar, nb, epoch);
    n_prev = n_cur;
    ++it;
  }
  if (gtid == 0) {
    out[0] = it;
    out[1] = rows;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). Each returns the launch's
// cudaError_t (0 = launched); nothing synchronises.

// K7's route at P providers: 1 where the round's prices are staged in
// shared memory, 0 where they are read through L2. kernels.dense_route
// mirrors it.
extern "C" int k7_route(int P) { return k7_shared_prices(P) ? 1 : 0; }

// K7: the dense auction from scratch duals, one persistent block of 1,024
// threads an SM in a cooperative launch. State on entry: price 0 [P] and
// owner -1 [P], p4t -1 [T], win_key 0 [2, P], ctl 0 [4] (the barrier's
// generation word, three open-list counts); fr_p1 [2, T], fr_key [T] and
// list [2, T] are scratch. value_base and price 16-byte aligned; nothing
// is read past their ends (a row's last vector, where it would end past
// the row, is read cell by cell), so neither needs padding. out [2] i64
// receives (rounds, open rows summed over the rounds).
extern "C" int k7_dense_auction(const float* value_base, const uint8_t* feasible, int T, int P,
                                float eps, int max_iters, float* price, int32_t* owner,
                                int32_t* p4t, int32_t* fr_p1, unsigned long long* fr_key,
                                unsigned long long* win_key, int32_t* list, unsigned* ctl,
                                long long* out, void* stream) {
  if (P < 1 || T < 1 || max_iters < 0 || (reinterpret_cast<uintptr_t>(value_base) & 15) ||
      (reinterpret_cast<uintptr_t>(price) & 15))
    return (int)cudaErrorInvalidValue;
  const bool shared = k7_shared_prices(P);
  const int smem = shared ? (P * 4 + 15) & ~15 : 0;
  auto kern = shared ? dense_auction_kernel<true> : dense_auction_kernel<false>;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kAucThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1 || n_sm < 1) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {(void*)&value_base, (void*)&feasible, (void*)&T, (void*)&P,
                  (void*)&eps, (void*)&max_iters, (void*)&price, (void*)&owner,
                  (void*)&p4t, (void*)&fr_p1, (void*)&fr_key, (void*)&win_key,
                  (void*)&list, (void*)&ctl, (void*)&out};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3((unsigned)n_sm), dim3(kAucThreads),
                                    args, (size_t)smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
