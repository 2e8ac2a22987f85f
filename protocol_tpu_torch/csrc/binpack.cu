// K11: the first-fit-decreasing vector bin-pack for Hopper (sm_90a).
//
// Replaces protocol_tpu/ops/binpack.py::assign_binpack_ffd (a lax.scan
// over the tasks) and its default visit order ffd_demand_order (:54), as
// the matcher's anti-affinity and colocation phases run them.
//
// Two launches:
//   rank   (only when the caller gives no visit order) one thread per
//          task: its L1 demand, summed left to right in f32, and its rank
//          in the stable descending order, counted over every task's key
//          through shared-memory tiles of 1,024 keys:
//            rank(t) = #{u : s_u > s_t} + #{u < t : s_u == s_t},
//          then order[rank(t)] = t. No library sort.
//   pack   one block walks the T steps in visit order. A step's pick is
//          the least (cost, provider) key over the cells where the cost
//          is < INFEASIBLE/2, the provider's remaining capacity holds the
//          demand in every resource and its domain does not hold the
//          task's group yet (argmin's first minimum over the masked
//          column); on a pick the provider's capacity loses the demand
//          and the (domain, group) bit is set; an all-infeasible column
//          changes nothing and gives -1.
//
// The pack launch (one block of 16 warps) is a chain: each step reads the
// capacity and occupancy the step before left. Nothing else it reads
// depends on the chain, so:
//   - warp 15 is a producer: it reads the visit order, groups and demands
//     32 steps at a time, and streams each step's cost column (slot-major
//     [T, P], K10's layout: a column is contiguous) into a ring of
//     shared-memory slots with TMA bulk copies, each completing on its
//     slot's mbarrier, up to S steps ahead of the chain (a column longer
//     than a slot goes as several chunks);
//   - warps 0..14 walk the chain. The capacity [R, P] (resource-major),
//     the providers' domains and the occupancy bitmask [L x G bits] live
//     in shared memory where they fit beside a ring of two slots (the
//     "shared" instantiation), else in device memory (the "device" one,
//     the same body; both templated on R). Providers go to the consumer
//     warps in blocks of 32, round robin: a warp reads its blocks of the
//     column, queues the finite cells (ballot, prefix popcount) and, 32
//     at a time, each lane checks one cell's capacity and occupancy, so
//     the checks run on full warps (a column is ~10% finite at the
//     colocation call). Only the owning warp reads a provider's capacity,
//     and its lane 0 updates it after a pick, so no barrier stands between
//     the update and the next read;
//   - one barrier a step: each warp's least (cost, provider) key, by a
//     warp reduction, meets the others' in a 64-bit atomicMin on a shared
//     key (three, used in turn, so that thread 0 resets the one of step
//     i + 2 after step i's barrier); after the consumers' named barrier
//     every thread reads the pick. The owner warp subtracts the demand,
//     lane 0 of every warp sets the occupancy bit in the word its lanes
//     read, and thread 0 writes the pick to the step's task.
//
// What bounds it on the H100: the chain, one barrier a step, not bytes
// (the cost block once, T x P x 4, plus the capacity and demands). At
// the colocation call (4,096 steps x 4,096 rows, R = 5) a step costs
// ~2,900 cycles, 1.53 us (H100 80GB HBM3, 700 W): the 15 warps' pass over
// the column's 4,096 cells (reads, ballots, queue writes and the queued
// cells' checks, ~1,600), the pick (warp reduction, atomicMin, barrier,
// read, ~800) and the update and loop (~350); 1.0-1.2 us at the
// anti-affinity calls (2,048 x 2,048, R = 1). 8 or 31 consumer warps and
// 2 or 8 reads in flight were no faster at the colocation call.
//
// Numerics: comparisons, one f32 subtraction per resource (cap + (-d),
// as the reference's .add(-take)) and the left-to-right demand sums, each
// rounding once (-fmad=false); bit-identical to the plain torch loop in
// protocol_tpu_torch/ops/binpack.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "chain.cuh"

namespace {

constexpr int kThreads = 1024;           // the rank launch's block
constexpr int kScanWarps = 15;            // warps 0..14 walk the chain
constexpr int kScan = kScanWarps * 32;    // 480 consumer threads
constexpr int kProducerWarp = kScanWarps;
constexpr int kPackThreads = kScan + 32;  // the pack launch's block
constexpr int kUnroll = 4;                // column reads a lane has in flight
constexpr int kMaxRes = 8;                // resources per demand vector
constexpr int kChunkMax = 32 * kScan;     // cost floats a slot holds: 60 KB
constexpr int kMaxSlots = 32;
constexpr int kMinSlots = 2;
constexpr int kHdrBytes = 48;             // a slot's header: Hdr below
constexpr int kQueue = 32 + kUnroll * 32;  // a warp's queue of finite cells
// the pick's keys (3 x 8 bytes, rounded), the warps' queues of (provider,
// cost), alignment
constexpr int kFixedBytes = 64 + kScanWarps * kQueue * 8 + 128;
constexpr float kHalfInfeasible = 5e8f;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNone32 = 0xffffffffu;
constexpr unsigned long long kNoKey = ~0ull;

struct Hdr {  // what the producer stages beside a step's column
  int t, g, lead, pad;
  float d[kMaxRes];
};
static_assert(sizeof(Hdr) == kHdrBytes, "Hdr layout");

// the ring's layout in the block's dynamic shared memory: S slots of up
// to C cost floats (a column in n_chunks chunks), their mbarriers (full,
// empty) and headers, the pick's keys and the warps' queues, then the
// state in the shared instantiation; S = 0 where it does not fit
struct Layout {
  int C, n_chunks, S, slot_floats;
  int off_hdr, off_key, off_queue, off_ring, off_state, smem;
};

__host__ __device__ inline long long round16(long long x) { return (x + 15) & ~15ll; }

__host__ __device__ inline Layout k11_layout(int P, int R, long long LG, bool shared_state) {
  Layout l{};
  l.C = P <= kChunkMax ? P : kChunkMax;
  l.n_chunks = (P + l.C - 1) / l.C;
  const long long slot = round16((long long)l.C * 4 + 12);  // a lead of up to 3 floats
  const long long state =
      shared_state ? round16((long long)R * P * 4 + (long long)P * 4 + (LG + 31) / 32 * 4) : 0;
  const long long room = kSmemMax - kFixedBytes - state;
  const long long per_slot = slot + 16 + kHdrBytes;
  long long S = room > 0 ? room / per_slot : 0;
  S = S < kMaxSlots ? S : kMaxSlots;
  l.S = S >= kMinSlots ? (int)S : 0;
  l.slot_floats = (int)(slot / 4);
  l.off_hdr = l.S * 16;
  l.off_key = l.off_hdr + l.S * kHdrBytes;
  l.off_queue = l.off_key + 64;
  l.off_ring = (int)((l.off_queue + kScanWarps * kQueue * 8 + 127) & ~127ll);
  l.off_state = l.off_ring + (int)(l.S * slot);
  l.smem = l.off_state + (int)state;
  return l;
}

__device__ __forceinline__ float l1_demand(const float* __restrict__ demand, int t, int R) {
  float s = demand[(size_t)t * R];
  for (int j = 1; j < R; ++j) s = __fadd_rn(s, demand[(size_t)t * R + j]);
  return s;
}

__global__ void __launch_bounds__(kThreads) rank_kernel(const float* __restrict__ demand, int T,
                                                        int R, int32_t* __restrict__ order) {
  __shared__ float s_key[kThreads];
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const float mine = t < T ? l1_demand(demand, t, R) : 0.0f;
  int rank = 0;
  for (int base = 0; base < T; base += kThreads) {
    const int u = base + threadIdx.x;
    __syncthreads();
    s_key[threadIdx.x] = u < T ? l1_demand(demand, u, R) : 0.0f;
    __syncthreads();
    const int n = min(kThreads, T - base);
    for (int j = 0; j < n; ++j) {
      const float k = s_key[j];
      rank += (k > mine) | ((k == mine) & (base + j < t));
    }
  }
  if (t < T) order[rank] = t;
}

// order-preserving bits of a finite f32 (-0 taken as +0, as argmin does)
__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t u = __float_as_uint(__fadd_rn(f, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the warp that owns provider p: its capacity is read and written by that
// warp's lanes only (32 consecutive providers a warp, round robin)
__device__ __forceinline__ int owner_warp(int p) { return (p >> 5) % kScanWarps; }

template <bool kShared, int kR>
__global__ void __launch_bounds__(kPackThreads, 1)
    pack_kernel(const float* __restrict__ cost, int P, int T, const float* __restrict__ demand,
                const int32_t* __restrict__ order, const int32_t* __restrict__ group,
                const int32_t* __restrict__ loc_id, int G, long long LG, float* cap,
                uint32_t* used, int32_t* __restrict__ pft, Layout lay) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + lay.S;
  Hdr* hdr = reinterpret_cast<Hdr*>(smem + lay.off_hdr);
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(smem + lay.off_key);
  int2* queue = reinterpret_cast<int2*>(smem + lay.off_queue);
  float* ring = reinterpret_cast<float*>(smem + lay.off_ring);
  float* s_cap = reinterpret_cast<float*>(smem + lay.off_state);  // [R, P]
  int32_t* s_loc = reinterpret_cast<int32_t*>(s_cap + (size_t)kR * P);
  uint32_t* s_used = reinterpret_cast<uint32_t*>(s_loc + P);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) {
    for (int s = 0; s < lay.S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kScanWarps);
    }
    mbar_init_fence();
    for (int k = 0; k < 3; ++k) s_key[k] = kNoKey;
  }
  if (kShared) {
    for (int x = tid; x < P * kR; x += kPackThreads) s_cap[(x % kR) * P + x / kR] = cap[x];
    for (int p = tid; p < P; p += kPackThreads) s_loc[p] = loc_id[p];
    const int words = (int)((LG + 31) / 32);
    for (int w = tid; w < words; w += kPackThreads) s_used[w] = 0u;
  }
  __syncthreads();

  // the chain's state: in shared memory, or in device memory as given
  auto cap_at = [&](int p, int j) -> float& {
    return kShared ? s_cap[(size_t)j * P + p] : cap[(size_t)p * kR + j];
  };
  auto word_at = [&](long long bit) -> uint32_t& {
    return kShared ? s_used[bit >> 5] : used[bit >> 5];
  };
  auto loc_of = [&](int p) -> int { return kShared ? s_loc[p] : loc_id[p]; };

  int s = 0;           // the ring's next slot
  uint32_t round = 0;  // and how often the ring went round before it

  if (warp == kProducerWarp) {
    for (int b = 0; b < T; b += 32) {
      const int i = b + lane;
      int t = 0, g = -1;
      float d[kR];
#pragma unroll
      for (int j = 0; j < kR; ++j) d[j] = 0.0f;
      if (i < T) {
        t = order[i];
        g = group[t];
#pragma unroll
        for (int j = 0; j < kR; ++j) d[j] = demand[(size_t)t * kR + j];
      }
      const int n = min(32, T - b);
      for (int l = 0; l < n; ++l) {
        const int tl = __shfl_sync(kFull, t, l);
        const int gl = __shfl_sync(kFull, g, l);
        float dl[kR];
#pragma unroll
        for (int j = 0; j < kR; ++j) dl[j] = __shfl_sync(kFull, d[j], l);
        if (lane == 0) {
          const float* col = cost + (size_t)tl * P;
          for (int c = 0; c < lay.n_chunks; ++c) {
            if (round > 0) mbar_wait(&empty[s], (round - 1) & 1u);
            const int base = c * lay.C;
            const int n_c = min(lay.C, P - base);
            const uintptr_t a = reinterpret_cast<uintptr_t>(col + base);
            const uintptr_t a0 = a & ~(uintptr_t)15;
            const int lead = (int)(a - a0) >> 2;
            Hdr& h = hdr[s];
            h.t = tl;
            h.g = gl;
            h.lead = lead;
#pragma unroll
            for (int j = 0; j < kR; ++j) h.d[j] = dl[j];
            const uint32_t bytes = (uint32_t)(((lead + n_c) * 4 + 15) & ~15);
            mbar_arrive_expect_tx(&full[s], bytes);
            bulk_copy_g2s(ring + (size_t)s * lay.slot_floats, reinterpret_cast<const void*>(a0),
                          bytes, &full[s]);
            if (++s == lay.S) {
              s = 0;
              ++round;
            }
          }
        }
        __syncwarp();
      }
    }
    return;
  }

  // a consumer warp scans its blocks of 32 providers a column; the finite
  // cells go to its queue, and whenever 32 are queued each lane checks one
  // (capacity, occupancy) and keeps the least (cost, provider) key
  int2* q = queue + warp * kQueue;
  const unsigned lt = (1u << lane) - 1u;
  int ikey = 0;  // s_key's slot for this step: i % 3
  for (int i = 0; i < T; ++i) {
    uint32_t hi = kNone32, lo = kNone32;
    int t = 0, g = -1;
    float d[kR];
    auto check = [&](int2 e) {
      const int p = e.x;
      const float v = __int_as_float(e.y);
      bool ok = true;
#pragma unroll
      for (int j = 0; j < kR; ++j) ok &= cap_at(p, j) >= d[j];
      if (ok && g >= 0) {
        const long long bit = (long long)loc_of(p) * G + g;
        ok = ((word_at(bit) >> (bit & 31)) & 1u) == 0u;
      }
      if (ok) {
        const uint32_t o = ordered_bits(v);
        if (o < hi || (o == hi && (uint32_t)p < lo)) {
          hi = o;
          lo = (uint32_t)p;
        }
      }
    };
    int qn = 0;  // cells queued (the same in every lane)
    for (int c = 0; c < lay.n_chunks; ++c) {
      mbar_wait(&full[s], round & 1u);
      const Hdr& h = hdr[s];
      if (c == 0) {
        t = h.t;
        g = h.g;
#pragma unroll
        for (int j = 0; j < kR; ++j) d[j] = h.d[j];
      }
      const float* col = ring + (size_t)s * lay.slot_floats + h.lead;
      const int base = c * lay.C;
      const int n_c = min(lay.C, P - base);
      for (int b = warp * 32; b < n_c; b += kUnroll * kScan) {
        // kUnroll blocks at once: their reads, ballots and queue slots are
        // independent of each other
        float v[kUnroll];
        unsigned m[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int x = b + u * kScan + lane;
          v[u] = x < n_c ? col[x] : INFINITY;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) m[u] = __ballot_sync(kFull, v[u] < kHalfInfeasible);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (v[u] < kHalfInfeasible)
            q[qn + __popc(m[u] & lt)] =
                make_int2(base + b + u * kScan + lane, __float_as_int(v[u]));
          qn += __popc(m[u]);
        }
        if (qn >= 32) {
          __syncwarp();
          int k = 0;
          for (; k + 32 <= qn; k += 32) check(q[k + lane]);
          __syncwarp();
          qn -= k;
          if (lane < qn) q[lane] = q[k + lane];
          __syncwarp();
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == lay.S) {
        s = 0;
        ++round;
      }
    }
    if (lane < qn) check(q[lane]);
    // the step's pick: the warps' least keys meet in one 64-bit atomicMin
    const uint32_t wh = __reduce_min_sync(kFull, hi);
    const uint32_t wl = __reduce_min_sync(kFull, hi == wh ? lo : kNone32);
    if (lane == 0 && wh != kNone32) atomicMin(&s_key[ikey], ((unsigned long long)wh << 32) | wl);
    named_sync(kScan);
    const unsigned long long best = s_key[ikey];
    if (tid == 0) s_key[ikey == 0 ? 2 : ikey - 1] = kNoKey;  // the slot of step i + 2
    ikey = ikey == 2 ? 0 : ikey + 1;
    const int pick = best == kNoKey ? -1 : (int)(uint32_t)best;
    if (pick >= 0) {
      if (lane == 0) {
        if (warp == owner_warp(pick)) {
#pragma unroll
          for (int j = 0; j < kR; ++j) cap_at(pick, j) = __fadd_rn(cap_at(pick, j), -d[j]);
        }
        if (g >= 0) {
          const long long bit = (long long)loc_of(pick) * G + g;
          word_at(bit) |= 1u << (bit & 31);
        }
      }
      __syncwarp();
    }
    if (tid == 0) pft[t] = pick;
  }
  if (kShared) {
    for (int p = warp * 32 + lane; p < P; p += kScan)
#pragma unroll
      for (int j = 0; j < kR; ++j) cap[(size_t)p * kR + j] = s_cap[(size_t)j * P + p];
  }
}

template <bool kShared>
using PackFn = decltype(&pack_kernel<kShared, 1>);

template <bool kShared>
PackFn<kShared> pack_for(int R) {
  switch (R) {
    case 1: return pack_kernel<kShared, 1>;
    case 2: return pack_kernel<kShared, 2>;
    case 3: return pack_kernel<kShared, 3>;
    case 4: return pack_kernel<kShared, 4>;
    case 5: return pack_kernel<kShared, 5>;
    case 6: return pack_kernel<kShared, 6>;
    case 7: return pack_kernel<kShared, 7>;
    default: return pack_kernel<kShared, 8>;
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). Each returns the launch's
// cudaError_t (0 = launched); nothing synchronises.

// The ring's slot count for these shapes and instantiation (shared_state
// 1: the capacity, domains and occupancy in shared memory); 0 where the
// instantiation does not fit. kernels.py's binpack_layout mirrors it.
extern "C" int k11_slots(int P, int R, long long LG, int shared_state) {
  return k11_layout(P, R, LG, shared_state != 0).S;
}

// K11: cost [T, P] f32 slot-major, demand [T, R], cap [P, R] (the
// capacity on entry, the remaining capacity on exit), group [T] (-1 or
// < G), loc_id [P] (< L), pft [T] i32; used [ceil(L * G / 32)] u32 zeroed
// for the device instantiation (not read by the shared one). order [T] is
// the visit order when has_order, else scratch the rank launch fills.
extern "C" int k11_binpack_ffd(const float* cost, int P, int T, const float* demand, int R,
                               int32_t* order, int has_order, const int32_t* group,
                               const int32_t* loc_id, int L, int G, float* cap, uint32_t* used,
                               int32_t* pft, int shared_state, void* stream) {
  if (P < 1 || T < 1 || R < 1 || R > kMaxRes || L < 1 || G < 1)
    return (int)cudaErrorInvalidValue;
  const long long LG = (long long)L * G;
  const Layout lay = k11_layout(P, R, LG, shared_state != 0);
  if (lay.S == 0 || (!shared_state && used == nullptr)) return (int)cudaErrorInvalidValue;
  if (!has_order) {
    rank_kernel<<<(T + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(demand, T,
                                                                                      R, order);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  auto kern = shared_state ? pack_for<true>(R) : pack_for<false>(R);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<1, kPackThreads, lay.smem, (cudaStream_t)stream>>>(
      cost, P, T, demand, order, group, loc_id, G, LG, cap, used, pft, lay);
  return (int)cudaGetLastError();
}
