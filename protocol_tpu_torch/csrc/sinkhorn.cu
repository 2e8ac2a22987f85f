// K13: the log-domain Sinkhorn of the dense assignment, for Hopper
// (sm_90a).
//
// Replaces protocol_tpu/ops/assign.py::sinkhorn_plan (a lax.fori_loop of
// two logsumexp passes over the dense [P, T] cost) and the inputs of
// assign_sinkhorn's rounding (:150): the rounding cost where(feasible,
// -plan, INFEASIBLE) and each task's largest plan entry, which the
// rounding visits in descending order (K12 then rounds).
//
// The cost is slot-major, [T, P] (K10's layout): row t holds task t's
// column of the reference's [P, T]. Launches, in order on one stream:
//   prep_rows   one block per task row: K = -cost / eps where cost <
//               INFEASIBLE/2, else -1e18 (an IEEE division), written to
//               the scratch block, and whether the task has a feasible
//               provider;
//   prep_cols   per provider, whether it has a feasible task;
//   marginals   one block: the counts, m = min(P_valid, T_valid) and the
//               log marginals log_a [P], log_b [T] (-1e18 where empty);
//   then num_iters times
//   u_pass      u[p] = log_a[p] - LSE_t(K[p, t] + v[t]), -1e18 where the
//               provider has no feasible task. A block takes 32 providers
//               (the warp's lanes, adjacent in a row: coalesced) and
//               splits the task rows over its 32 warps;
//   v_pass      v[t] = log_b[t] - LSE_p(K[p, t] + u[p]), one block per
//               task row (contiguous);
//   then final  one block per task row: plan = exp((K + u) + v) with
//               subnormal entries flushed to +0 (XLA flushes them; the
//               rounding is a greedy with first-index ties, so a
//               subnormal where the reference has 0 could change a
//               pick), the rounding cost written over the scratch block,
//               and the row's plan maximum.
// Each LSE is max-then-sum, as jax.nn.logsumexp computes it: the max (0
// where not finite), then log(sum(exp(x - max))) + max.
//
// What bounds it on the H100: device memory. Each pass reads the [T, P]
// block twice (the max, then the sum), so an iteration moves 4 x T x P x 4
// bytes; the exps (2 x T x P an iteration) are far below the f32 rate. The
// function's own bytes (the cost in, the plan out) are much fewer: the
// bound counted in chip_smoke.py is then the operations.
//
// Numerics: the same f32 operations per element as the plain torch
// version in protocol_tpu_torch/ops/assign.py, each rounding once
// (-fmad=false); the sums run in another order, so the potentials and the
// plan agree within a tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e18f;
constexpr float kInfeasible = 1e9f;
constexpr float kHalfInfeasible = 5e8f;
constexpr float kTiny = 1.17549435e-38f;  // FLT_MIN, the least normal f32
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowThreads = 256;  // a task row's block
constexpr int kCols = 32;         // providers a column block takes

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// block-wide reductions over kRowThreads threads; every thread gets the result
__device__ float block_max(float v, float* s_red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = threadIdx.x < kRowThreads / 32 ? s_red[threadIdx.x] : -INFINITY;
  if (threadIdx.x < 32) v = warp_max(v);
  if (threadIdx.x == 0) s_red[0] = v;
  __syncthreads();
  v = s_red[0];
  __syncthreads();
  return v;
}

__device__ float block_sum(float v, float* s_red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = threadIdx.x < kRowThreads / 32 ? s_red[threadIdx.x] : 0.0f;
  if (threadIdx.x < 32) v = warp_sum(v);
  if (threadIdx.x == 0) s_red[0] = v;
  __syncthreads();
  v = s_red[0];
  __syncthreads();
  return v;
}

__device__ __forceinline__ float finite_or_zero(float m) { return isfinite(m) ? m : 0.0f; }

__global__ void __launch_bounds__(kRowThreads)
    prep_rows_kernel(const float* __restrict__ cost, int P, float eps, float* __restrict__ K,
                     uint8_t* __restrict__ feas_col) {
  const size_t base = (size_t)blockIdx.x * P;
  int any = 0;
  for (int p = threadIdx.x; p < P; p += kRowThreads) {
    const float c = cost[base + p];
    const bool ok = c < kHalfInfeasible;
    K[base + p] = ok ? __fdiv_rn(-c, eps) : kNeg;
    any |= ok;
  }
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) feas_col[blockIdx.x] = (uint8_t)(any != 0);
}

__global__ void __launch_bounds__(kCols * 32)
    prep_cols_kernel(const float* __restrict__ cost, int T, int P, uint8_t* __restrict__ feas_row) {
  __shared__ int s_any[32][kCols];
  const int p = blockIdx.x * kCols + threadIdx.x;
  int any = 0;
  if (p < P)
    for (int t = threadIdx.y; t < T; t += 32) any |= cost[(size_t)t * P + p] < kHalfInfeasible;
  s_any[threadIdx.y][threadIdx.x] = any;
  __syncthreads();
  if (threadIdx.y == 0 && p < P) {
    for (int y = 1; y < 32; ++y) any |= s_any[y][threadIdx.x];
    feas_row[p] = (uint8_t)(any != 0);
  }
}

__global__ void __launch_bounds__(1024)
    marginals_kernel(const uint8_t* __restrict__ feas_row, int P,
                     const uint8_t* __restrict__ feas_col, int T, float* __restrict__ log_a,
                     float* __restrict__ log_b) {
  __shared__ int s_n[2];
  if (threadIdx.x == 0) s_n[0] = s_n[1] = 0;
  __syncthreads();
  int np_ = 0, nt_ = 0;
  for (int p = threadIdx.x; p < P; p += 1024) np_ += feas_row[p];
  for (int t = threadIdx.x; t < T; t += 1024) nt_ += feas_col[t];
  atomicAdd(&s_n[0], np_);
  atomicAdd(&s_n[1], nt_);
  __syncthreads();
  const int np_valid = max(s_n[0], 1), nt_valid = max(s_n[1], 1);
  const float m = (float)min(np_valid, nt_valid);
  const float la = logf(__fdiv_rn(m, (float)np_valid));
  const float lb = logf(__fdiv_rn(m, (float)nt_valid));
  for (int p = threadIdx.x; p < P; p += 1024) log_a[p] = feas_row[p] ? la : kNeg;
  for (int t = threadIdx.x; t < T; t += 1024) log_b[t] = feas_col[t] ? lb : kNeg;
}

// u over providers: block (kCols lanes = providers, 32 warps = task-row lanes)
__global__ void __launch_bounds__(kCols * 32)
    u_pass_kernel(const float* __restrict__ K, int T, int P, const float* __restrict__ v,
                  const float* __restrict__ log_a, const uint8_t* __restrict__ feas_row,
                  float* __restrict__ u) {
  __shared__ float s_red[32][kCols + 1];
  __shared__ float s_max[kCols];
  const int p = blockIdx.x * kCols + threadIdx.x;
  const bool live = p < P;
  float mx = -INFINITY;
  if (live) {
#pragma unroll 4
    for (int t = threadIdx.y; t < T; t += 32)
      mx = fmaxf(mx, __fadd_rn(K[(size_t)t * P + p], v[t]));
  }
  s_red[threadIdx.y][threadIdx.x] = mx;
  __syncthreads();
  if (threadIdx.y == 0) {
    for (int y = 1; y < 32; ++y) mx = fmaxf(mx, s_red[y][threadIdx.x]);
    s_max[threadIdx.x] = finite_or_zero(mx);
  }
  __syncthreads();
  const float amax = s_max[threadIdx.x];
  float sum = 0.0f;
  if (live) {
#pragma unroll 4
    for (int t = threadIdx.y; t < T; t += 32)
      sum = __fadd_rn(sum, expf(__fsub_rn(__fadd_rn(K[(size_t)t * P + p], v[t]), amax)));
  }
  s_red[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && live) {
    for (int y = 1; y < 32; ++y) sum = __fadd_rn(sum, s_red[y][threadIdx.x]);
    const float lse = __fadd_rn(logf(sum), amax);
    u[p] = feas_row[p] ? __fsub_rn(log_a[p], lse) : kNeg;
  }
}

// v over tasks: one block per task row
__global__ void __launch_bounds__(kRowThreads)
    v_pass_kernel(const float* __restrict__ K, int P, const float* __restrict__ u,
                  const float* __restrict__ log_b, const uint8_t* __restrict__ feas_col,
                  float* __restrict__ v) {
  __shared__ float s_red[kRowThreads / 32];
  const int t = blockIdx.x;
  const float* row = K + (size_t)t * P;
  float mx = -INFINITY;
  for (int p = threadIdx.x; p < P; p += kRowThreads) mx = fmaxf(mx, __fadd_rn(row[p], u[p]));
  const float amax = finite_or_zero(block_max(mx, s_red));
  float sum = 0.0f;
  for (int p = threadIdx.x; p < P; p += kRowThreads)
    sum = __fadd_rn(sum, expf(__fsub_rn(__fadd_rn(row[p], u[p]), amax)));
  sum = block_sum(sum, s_red);
  if (threadIdx.x == 0) {
    const float lse = __fadd_rn(logf(sum), amax);
    v[t] = feas_col[t] ? __fsub_rn(log_b[t], lse) : kNeg;
  }
}

// the plan, the rounding cost (over K, in place) and each row's plan maximum
__global__ void __launch_bounds__(kRowThreads)
    final_kernel(const float* __restrict__ cost, float* K, int P, const float* __restrict__ u,
                 const float* __restrict__ v, float* __restrict__ plan,
                 float* __restrict__ colmax) {
  __shared__ float s_red[kRowThreads / 32];
  const int t = blockIdx.x;
  const size_t base = (size_t)t * P;
  const float vt = v[t];
  float mx = 0.0f;  // every entry is >= +0
  for (int p = threadIdx.x; p < P; p += kRowThreads) {
    float x = expf(__fadd_rn(__fadd_rn(K[base + p], u[p]), vt));
    if (x < kTiny) x = 0.0f;
    plan[base + p] = x;
    K[base + p] = cost[base + p] < kHalfInfeasible ? -x : kInfeasible;
    mx = fmaxf(mx, x);
  }
  mx = block_max(mx, s_red);
  if (threadIdx.x == 0) colmax[t] = mx;
}

}  // namespace

// Plain C interface (loaded with ctypes): every launch of one Sinkhorn
// solve on ``stream``. cost [T, P] f32 slot-major; K_rcost [T, P] f32
// scratch that holds the rounding cost on return; feas_row [P] and
// feas_col [T] u8, log_a / u [P] and log_b / v [T] f32 scratch, u and v
// zeroed by the caller (they hold the potentials on return); plan [T, P]
// and colmax [T] f32 outputs. Returns the first launch's error (0 = all
// launched).
extern "C" int k13_sinkhorn(const float* cost, int T, int P, float eps, int num_iters,
                            float* K_rcost, uint8_t* feas_row, uint8_t* feas_col, float* log_a,
                            float* log_b, float* u, float* v, float* plan, float* colmax,
                            void* stream) {
  if (T < 1 || P < 1 || num_iters < 0 || !(eps > 0.0f)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 col_block(kCols, 32);
  const int col_grid = (P + kCols - 1) / kCols;
  cudaError_t err;
  prep_rows_kernel<<<T, kRowThreads, 0, s>>>(cost, P, eps, K_rcost, feas_col);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  prep_cols_kernel<<<col_grid, col_block, 0, s>>>(cost, T, P, feas_row);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  marginals_kernel<<<1, 1024, 0, s>>>(feas_row, P, feas_col, T, log_a, log_b);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int i = 0; i < num_iters; ++i) {
    u_pass_kernel<<<col_grid, col_block, 0, s>>>(K_rcost, T, P, v, log_a, feas_row, u);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    v_pass_kernel<<<T, kRowThreads, 0, s>>>(K_rcost, P, u, log_b, feas_col, v);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  final_kernel<<<T, kRowThreads, 0, s>>>(cost, K_rcost, P, u, v, plan, colmax);
  return (int)cudaGetLastError();
}
