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
//   pack   one block of 1,024 threads walks the T steps in visit order.
//          A step reads its slot's cost column [P] (the cost is slot-major
//          [T, P], K10's layout, so the read is coalesced); only where the
//          cost is < INFEASIBLE/2 does a thread read the provider's
//          remaining capacity [R] and its group bit, so
//            fits     = all(cap[p] >= d),
//            excluded = g >= 0 && used[loc_id[p], g];
//          the step's pick is the least (cost, provider) key over the
//          cells left, a block reduction of 64-bit keys (ordered cost bits
//          << 32 | provider), the lower provider winning ties, which is
//          argmin's first minimum over the masked column. Thread 0 then
//          subtracts d from cap[p] and sets used[loc_id[p], g], only when
//          a pick exists (an all-infeasible column leaves every row,
//          row 0 included, untouched), and writes the pick, or -1, to the
//          step's task: the scatter back to task order.
//          The capacity [P, R] and the occupancy bitmask [L x G bits] live
//          in device memory; one block keeps every write visible to the
//          next step after __syncthreads.
//
// What bounds it on the H100: the chain of dependent steps, not bytes:
// each step changes the capacity and occupancy the next one sees, so the
// T steps run one after another, each a few microseconds of column read,
// block reduction and two barriers. Its bytes are the cost block once
// (T x P x 4) plus the capacity and demand.
//
// Numerics: comparisons, one f32 subtraction per resource (cap + (-d),
// as the reference's .add(-take)) and the left-to-right demand sums, each
// rounding once (-fmad=false); bit-identical to the plain torch loop in
// protocol_tpu_torch/ops/binpack.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxRes = 8;  // resources per demand vector
constexpr float kHalfInfeasible = 5e8f;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull;

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

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long x = __shfl_xor_sync(kFull, v, o);
    v = x < v ? x : v;
  }
  return v;
}

__global__ void __launch_bounds__(kThreads, 1)
    pack_kernel(const float* __restrict__ cost, int P, int T, const float* __restrict__ demand,
                int R, const int32_t* __restrict__ order, const int32_t* __restrict__ group,
                const int32_t* __restrict__ loc_id, int G, float* cap, uint32_t* used,
                int32_t* __restrict__ pft) {
  __shared__ unsigned long long s_red[kThreads / 32];
  __shared__ float s_d[kMaxRes];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = 0; i < T; ++i) {
    const int t = order[i];
    const int g = group[t];
    if (tid < R) s_d[tid] = demand[(size_t)t * R + tid];
    __syncthreads();
    const float* col = cost + (size_t)t * P;
    unsigned long long best = kNone;
    for (int p = tid; p < P; p += kThreads) {
      const float c = col[p];
      if (!(c < kHalfInfeasible)) continue;
      bool ok = true;
      for (int j = 0; j < R; ++j) ok &= cap[(size_t)p * R + j] >= s_d[j];
      if (ok && g >= 0) {
        const size_t bit = (size_t)loc_id[p] * G + g;
        ok = ((used[bit >> 5] >> (bit & 31)) & 1u) == 0u;
      }
      if (ok) {
        const unsigned long long key = ((unsigned long long)ordered_bits(c) << 32) | (uint32_t)p;
        best = key < best ? key : best;
      }
    }
    best = warp_min(best);
    if (lane == 0) s_red[warp] = best;
    __syncthreads();
    if (warp == 0) {
      best = warp_min(s_red[lane]);
      if (lane == 0) {
        int pick = -1;
        if (best != kNone) {
          pick = (int)(uint32_t)best;
          for (int j = 0; j < R; ++j)
            cap[(size_t)pick * R + j] = __fadd_rn(cap[(size_t)pick * R + j], -s_d[j]);
          if (g >= 0) {
            const size_t bit = (size_t)loc_id[pick] * G + g;
            used[bit >> 5] |= 1u << (bit & 31);
          }
        }
        pft[t] = pick;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Plain C interface (loaded with ctypes). Each returns the launch's
// cudaError_t (0 = launched); nothing synchronises.

// K11: cost [T, P] f32 slot-major, demand [T, R], cap [P, R] (the
// capacity on entry, the remaining capacity on exit), group [T] (-1 or
// < G), loc_id [P] (< L), used [ceil(L * G / 32)] u32 zeroed, pft [T]
// i32. order [T] is the visit order when has_order, else scratch the rank
// launch fills.
extern "C" int k11_binpack_ffd(const float* cost, int P, int T, const float* demand, int R,
                               int32_t* order, int has_order, const int32_t* group,
                               const int32_t* loc_id, int G, float* cap, uint32_t* used,
                               int32_t* pft, void* stream) {
  if (P < 1 || T < 1 || R < 1 || R > kMaxRes || G < 1) return (int)cudaErrorInvalidValue;
  if (!has_order) {
    rank_kernel<<<(T + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(demand, T,
                                                                                      R, order);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  pack_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(cost, P, T, demand, R, order, group,
                                                        loc_id, G, cap, used, pft);
  return (int)cudaGetLastError();
}
