// K12: the sequential greedy assignment for Hopper (sm_90a).
//
// Replaces protocol_tpu/ops/assign.py::assign_greedy (a lax.scan over the
// tasks in task_order): each task in turn takes the cheapest provider
// still free, the first index among equal costs, if that cost is
// < INFEASIBLE/2, else -1; the provider it takes is no longer free. It is
// also the rounding of assign_sinkhorn (a greedy on -plan).
//
// One block of 1,024 threads walks the steps. The free set is a bitmask in
// shared memory (P/8 bytes; up to 1,638,400 providers). Step s reads the
// cost row of task order[s]; the cost is slot-major [T, P] (K10's layout,
// and the rounding cost K13 writes), so the read is one contiguous row,
// coalesced. Each thread keeps the least 64-bit key (ordered cost bits
// << 32 | provider) over its free cells below INFEASIBLE/2; a block
// reduction gives the step's pick, the lower provider winning ties, which
// is argmin's first minimum over the masked row. -0.0 counts as +0.0, as
// jnp.argmin counts it (the rounding cost is -0.0 wherever the plan
// underflowed to 0). Thread 0 clears the pick's bit only when it assigns,
// and writes the pick, or -1, to the step's task.
//
// What bounds it on the H100: the chain of dependent steps, not bytes:
// each pick changes the free set the next step sees, so the T steps run
// one after another, each a row read, a block reduction and two barriers
// (a few microseconds). Its bytes are the cost block once (T x P x 4).
//
// Numerics: comparisons only (and +0.0 added to each cost); a free NaN
// cell wins the step and leaves the task unassigned, as in the scan;
// bit-identical to the plain torch loop in protocol_tpu_torch/ops/assign.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr float kHalfInfeasible = 5e8f;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull;

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
    greedy_kernel(const float* __restrict__ cost, int T, int P,
                  const int32_t* __restrict__ order, int n_steps, int32_t* __restrict__ p4t) {
  extern __shared__ uint32_t s_free[];
  __shared__ unsigned long long s_red[kThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_words = (P + 31) / 32;
  for (int w = tid; w < n_words; w += kThreads) {
    const int left = P - w * 32;
    s_free[w] = left >= 32 ? kFull : (1u << left) - 1u;
  }
  __syncthreads();
  for (int s = 0; s < n_steps; ++s) {
    const int t = order[s];
    const float* row = cost + (size_t)t * P;
    unsigned long long best = kNone;
    for (int p = tid; p < P; p += kThreads) {
      const float c = row[p];
      if ((s_free[p >> 5] >> (p & 31)) & 1u) {
        // a NaN is argmin's pick, as in the reference, and is never taken
        const unsigned long long key =
            c < kHalfInfeasible ? ((unsigned long long)ordered_bits(c) << 32) | (uint32_t)p
            : c != c            ? (unsigned long long)(uint32_t)p
                                : kNone;
        best = key < best ? key : best;
      }
    }
    best = warp_min(best);
    if (lane == 0) s_red[warp] = best;
    __syncthreads();
    if (warp == 0) {
      best = warp_min(s_red[lane]);
      if (lane == 0) {
        int pick = best == kNone ? -1 : (int)(uint32_t)best;
        if (pick >= 0 && row[pick] < kHalfInfeasible)
          s_free[pick >> 5] &= ~(1u << (pick & 31));
        else
          pick = -1;
        p4t[t] = pick;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Shared memory the free bitmask may take: 200 KB holds 1,638,400 providers.
constexpr int kMaxFreeBytes = 200 * 1024;

// Plain C interface (loaded with ctypes): walks order [n_steps] (task ids
// in [0, T)) over cost [T, P] f32 slot-major, writing each step's pick
// into p4t [T] (the caller fills it with -1 first). Returns the launch's
// cudaError_t (0 = launched).
extern "C" int k12_greedy(const float* cost, int T, int P, const int32_t* order, int n_steps,
                          int32_t* p4t, void* stream) {
  const int smem = (P + 31) / 32 * 4;
  if (T < 1 || P < 1 || n_steps < 0 || smem > kMaxFreeBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(greedy_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxFreeBytes);
  if (err != cudaSuccess) return (int)err;
  greedy_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(cost, T, P, order, n_steps, p4t);
  return (int)cudaGetLastError();
}
