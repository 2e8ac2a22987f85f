// K9: the greedy cleanup at the end of the sparse auctions, for Hopper
// (sm_90a).
//
// Replaces protocol_tpu/ops/sparse.py::_greedy_cleanup_compacted (a
// lax.scan over the compacted open tasks): the open tasks go in index
// order, and each takes its cheapest still-free candidate (the first
// index among equal costs; an invalid or taken candidate costs
// INFEASIBLE), if that cost is < INFEASIBLE/2; the provider it takes is no
// longer free for the tasks after it.
//
// One block. Its 1,024 threads first build the free set (owner < 0) as a
// bitmask in shared memory (P/8 bytes; up to 1.6M providers), then one
// warp sweeps the open tasks: the lanes share a row's K candidates (up to
// 4 each, K <= 128), test them against the bitmask, and merge their first
// minima by (cost, column) with shuffles; lane 0 takes the seat. The next
// row's candidates are loaded before the current row is reduced, so the
// sweep waits on device memory about once per row, not twice.
//
// What bounds it on the H100: the chain of dependent rows, not bytes: the
// sweep is sequential by nature (each pick changes the free set the next
// row sees), so it costs a few hundred nanoseconds per open task; its
// bytes are the open rows' candidates (K x 8 per row) and the owner
// vector.
//
// Numerics: comparisons only; bit-identical to the plain torch loop in
// protocol_tpu_torch/ops/sparse.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kSlots = 4;  // candidates per lane: K <= 128
constexpr unsigned kFull = 0xffffffffu;
constexpr float kInfeasible = 1e9f;
constexpr float kHalfInfeasible = 5e8f;

__global__ void __launch_bounds__(kThreads, 1)
    cleanup_kernel(const int32_t* __restrict__ cand_p, const float* __restrict__ cand_c, int K,
                   int P, const int32_t* __restrict__ owner, const int32_t* __restrict__ open_idx,
                   int n_open, int32_t* __restrict__ p4t) {
  extern __shared__ uint32_t s_free[];
  const int n_words = (P + 31) / 32;
  for (int w = threadIdx.x; w < n_words; w += kThreads) {
    uint32_t m = 0;
    for (int b = 0; b < 32; ++b) {
      const int p = w * 32 + b;
      if (p < P && owner[p] < 0) m |= 1u << b;
    }
    s_free[w] = m;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;

  int32_t np[kSlots];
  float nc[kSlots];
  auto load = [&](int i) {
    const size_t row = (size_t)open_idx[i] * K;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int k = lane + 32 * j;
      np[j] = k < K ? cand_p[row + k] : -1;
      nc[j] = k < K ? cand_c[row + k] : kInfeasible;
    }
  };
  if (n_open > 0) load(0);
  for (int i = 0; i < n_open; ++i) {
    int32_t cp[kSlots];
    float cc[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      cp[j] = np[j];
      cc[j] = nc[j];
    }
    if (i + 1 < n_open) load(i + 1);
    float bc = INFINITY;
    int bk = K;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int k = lane + 32 * j;
      if (k < K) {
        const int p = cp[j];
        const bool free_p = p >= 0 && ((s_free[p >> 5] >> (p & 31)) & 1u);
        const float c = free_p ? cc[j] : kInfeasible;
        if (c < bc) {  // k grows with j: the first minimum of the lane stays
          bc = c;
          bk = k;
        }
      }
    }
    int bp = -1;
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      if (lane + 32 * j == bk) bp = cp[j];
    for (int o = 16; o > 0; o >>= 1) {
      const float oc = __shfl_xor_sync(kFull, bc, o);
      const int ok = __shfl_xor_sync(kFull, bk, o);
      const int op = __shfl_xor_sync(kFull, bp, o);
      if (oc < bc || (oc == bc && ok < bk)) {
        bc = oc;
        bk = ok;
        bp = op;
      }
    }
    if (lane == 0 && bc < kHalfInfeasible) {
      s_free[bp >> 5] &= ~(1u << (bp & 31));
      p4t[open_idx[i]] = bp;
    }
    __syncwarp();
  }
}

}  // namespace

// Shared memory the free bitmask may take: 200 KB holds 1,638,400 providers.
constexpr int kMaxFreeBytes = 200 * 1024;

// Plain C interface (loaded with ctypes): sweeps open_idx [n_open] (task
// ids, ascending) over cand_p / cand_c [T, K], writing each pick into p4t
// [T] in place. Returns the launch's cudaError_t (0 = launched).
extern "C" int k9_greedy_cleanup(const int32_t* cand_p, const float* cand_c, int K, int P,
                                 const int32_t* owner, const int32_t* open_idx, int n_open,
                                 int32_t* p4t, void* stream) {
  const int smem = (P + 31) / 32 * 4;
  if (K < 1 || K > 32 * kSlots || P < 1 || n_open < 0 || smem > kMaxFreeBytes)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(cleanup_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxFreeBytes);
  if (err != cudaSuccess) return (int)err;
  cleanup_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(cand_p, cand_c, K, P, owner,
                                                              open_idx, n_open, p4t);
  return (int)cudaGetLastError();
}
