// K14: the streamed passes of the blocked (matrix-free) Sinkhorn, and K15:
// the cost of assigned (provider, task) pairs, for Hopper (sm_90a).
//
// K14 replaces the device work of protocol_tpu/ops/blocked.py::
// sinkhorn_potentials_blocked (:92) with its make_k_block (:40),
// feasibility_scan (:54) and streaming_row_logsumexp (:64): the reference
// streams [P, tile] blocks of K = -cost/eps (-1e18 off the mask) through
// XLA, twice per iteration. Here no [P, T] or [P, tile] block exists:
// every launch rescores its cells from the encoded columns with K1's cell
// function (cell_cost<false>, cell.cuh: the unjittered cost, as
// cost_matrix gives it) and keeps K in registers. Three launches:
//   feasibility  row_any[p] (u8) and col_bits (a [ceil(T/32)] u32 bitmap
//                of col_any): whether each provider / task has a cell
//                with cost < INFEASIBLE/2;
//   row pass     lse_u[p] = logsumexp over all T of K[p, t] + v[t];
//   column pass  lse_v[t] = logsumexp over all P of K[p, t] + u[p].
// The marginals, the masks (where(row_any, log_a - lse_u, -1e18), ...)
// and the loop over the iterations stay torch glue on the card
// (protocol_tpu_torch/ops/blocked.py).
//
// Layout (all three): a block serves 32 "own" rows, one a lane (providers
// for the feasibility and row passes, tasks for the column pass), and its
// kParts warps each walk a contiguous part of the other side in index
// order, so the other side's loads are warp-uniform and hit L1 (K1's
// reverse launch has this shape). Each thread keeps an online (max,
// sum-exp) pair; the parts merge theirs at the end,
//   (m, s) + (m', s') = (M, s * exp(m - M) + s' * exp(m' - M)),  M = max,
// and the result is m + log(max(s, 1e-30)), the reference's epilogue.
// This is not the reference's summation order (a per-tile max, then a sum
// over the tile, carried tile to tile), so the passes agree with the plain
// version within a tolerance, not bit for bit.
//
// Cells off the mask are skipped. In the reference they hold K = -1e18,
// and K + v is then <= -1e18 + |v|, which rounds to about -1e18 in f32:
// once a row has met a feasible cell they add exp(~-1e18 - m) = 0 exactly,
// and whatever they added before is scaled by that same 0 when the first
// feasible cell raises the max. A row with no feasible cell (its sum-exp
// is not 0 in the reference: K + v with both at -1e18 is -2e18) is masked
// by row_any / col_any in the glue, here as there; the kernel leaves such
// a row at -inf. So the masked potentials agree, and the masks are exact.
//
// The feasibility launch ORs the other side into a shared-memory bitmap
// of the T tasks (a register word per 32 tasks, flushed by lane 0) and
// the bitmap into col_bits with one atomicOr per changed word, so the
// [P/32 x T] redundant stores of a plain OR never reach L2.
//
// K15 replaces ops/cost.py::_cost_pairs_vmapped (:137) / cost_pairs
// (:149): one thread per task t scores the cell (p4t[t], t) with
// cell_cost<false>, INFEASIBLE where p4t[t] < 0 (the stage-S quality
// measure, O(T) cells where [P, T] cannot exist).
//
// What bounds them on the H100: operations. A pass reads O(P + T) bytes
// and writes O(P) or O(T); it scores P x T cells, ~12 operations each for
// the capability check and ~30 more on a feasible one, plus the division,
// the add and the exp of the online sum-exp on a feasible cell. K15 reads
// one provider row per task: bytes.
//
// Numerics: built like candidates.cu (-fmad=false, no fast-math). K =
// -cost / eps is an IEEE division (__fdiv_rn), as the reference's and the
// plain version's (which divides by a 0-d tensor on the same device: CUDA
// torch turns a division by a CPU scalar into a multiplication by its
// reciprocal, one bit off). The exps and logs are CUDA's expf / logf,
// within an ulp or two of XLA's and torch's; subnormal sum-exp terms are
// kept (XLA flushes them), which is far below the tolerance of a
// log-domain sum. K15 is bit-identical to the plain version at proximity 0.

#include <math.h>

#include "cell.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kTiny = 1e-30f;  // the reference's floor under the sum-exp
constexpr int kLanes = 32;       // own rows a block serves
constexpr int kParts = 8;        // warps a block splits the other side over
constexpr int kThreads = 256;    // K15

// Add x to the online (max, sum-exp) pair (m, s); m starts at -inf, s at 0.
__device__ __forceinline__ void lse_push(float x, float& m, float& s) {
  if (x > m) {
    s = __fadd_rn(__fmul_rn(s, expf(__fsub_rn(m, x))), 1.0f);
    m = x;
  } else {
    s = __fadd_rn(s, expf(__fsub_rn(x, m)));
  }
}

// (m, s) <- (m, s) merged with (m2, s2).
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  const float M = fmaxf(m, m2);
  if (M == -INFINITY) return;  // both empty
  s = __fadd_rn(__fmul_rn(s, expf(__fsub_rn(m, M))), __fmul_rn(s2, expf(__fsub_rn(m2, M))));
  m = M;
}

// The part [lo, hi) of n that warp `part` of kParts walks.
__device__ __forceinline__ void part_range(int n, int part, int& lo, int& hi) {
  const int chunk = (n + kParts - 1) / kParts;
  lo = min(n, part * chunk);
  hi = min(n, lo + chunk);
}

__global__ void __launch_bounds__(kLanes * kParts) feasibility_kernel(
    Prov prov, Req req, Aux aux, Weights w, int P, int T, int K, int W,
    uint8_t* __restrict__ row_any, uint32_t* __restrict__ col_bits) {
  extern __shared__ uint32_t s_col[];  // ceil(T / 32) words
  __shared__ int s_row[kParts][kLanes];
  const int lane = threadIdx.x % kLanes;
  const int part = threadIdx.x / kLanes;
  const int p = blockIdx.x * kLanes + lane;
  const bool active = p < P;
  const int n_words = (T + 31) / 32;
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) s_col[i] = 0u;
  __syncthreads();
  const ProvRow pr = load_prov(prov, aux, active ? p : 0);
  int lo, hi;
  part_range(T, part, lo, hi);
  int any = 0;
  uint32_t word = 0u;  // this part's bits of the current 32-task word
  for (int t = lo; t < hi; ++t) {
    const TaskRow tr = load_task(req, aux, t, K);
    const bool f = active && cell_cost<false>(pr, p, tr, t, req, K, W, w) < kHalfInfeasible;
    any |= f;
    if (__ballot_sync(kFull, f) != 0u) word |= 1u << (t & 31);
    if ((t & 31) == 31 || t == hi - 1) {
      if (lane == 0 && word != 0u) atomicOr(&s_col[t >> 5], word);
      word = 0u;
    }
  }
  s_row[part][lane] = any;
  __syncthreads();
  if (part == 0 && active) {
    int r = 0;
    for (int q = 0; q < kParts; ++q) r |= s_row[q][lane];
    row_any[p] = (uint8_t)(r != 0);
  }
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) {
    const uint32_t b = s_col[i];
    // a stale read only costs an atomic that changes nothing
    if (b != 0u && (col_bits[i] | b) != col_bits[i]) atomicOr(&col_bits[i], b);
  }
}

// kRows: own = provider, lse over the tasks of K + v (the u pass);
// otherwise own = task, lse over the providers of K + u (the v pass).
template <bool kRows>
__global__ void __launch_bounds__(kLanes * kParts) lse_kernel(
    Prov prov, Req req, Aux aux, Weights w, int P, int T, int K, int W, float eps,
    const float* __restrict__ pot, float* __restrict__ lse) {
  __shared__ float s_m[kParts][kLanes];
  __shared__ float s_s[kParts][kLanes];
  const int lane = threadIdx.x % kLanes;
  const int part = threadIdx.x / kLanes;
  const int own = blockIdx.x * kLanes + lane;
  const int n_own = kRows ? P : T;
  const bool active = own < n_own;
  float m = -INFINITY, s = 0.0f;
  if (active) {
    int lo, hi;
    part_range(kRows ? T : P, part, lo, hi);
    if constexpr (kRows) {
      const ProvRow pr = load_prov(prov, aux, own);
      for (int t = lo; t < hi; ++t) {
        const TaskRow tr = load_task(req, aux, t, K);
        const float c = cell_cost<false>(pr, own, tr, t, req, K, W, w);
        if (c < kHalfInfeasible) lse_push(__fadd_rn(__fdiv_rn(-c, eps), pot[t]), m, s);
      }
    } else {
      const TaskRow tr = load_task(req, aux, own, K);
      for (int p = lo; p < hi; ++p) {
        const ProvRow pr = load_prov(prov, aux, p);
        const float c = cell_cost<false>(pr, p, tr, own, req, K, W, w);
        if (c < kHalfInfeasible) lse_push(__fadd_rn(__fdiv_rn(-c, eps), pot[p]), m, s);
      }
    }
  }
  s_m[part][lane] = m;
  s_s[part][lane] = s;
  __syncthreads();
  if (part != 0 || !active) return;
  for (int q = 1; q < kParts; ++q) lse_merge(m, s, s_m[q][lane], s_s[q][lane]);
  lse[own] = __fadd_rn(m, logf(fmaxf(s, kTiny)));
}

__global__ void __launch_bounds__(kThreads) pair_cost_kernel(Prov prov, Req req, Aux aux,
                                                             Weights w, int T, int K, int W,
                                                             const int32_t* __restrict__ p4t,
                                                             float* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  const int p = p4t[t];
  if (p < 0) {
    out[t] = kInfeasible;
    return;
  }
  const TaskRow tr = load_task(req, aux, t, K);
  const ProvRow pr = load_prov(prov, aux, p);
  out[t] = cell_cost<false>(pr, p, tr, t, req, K, W, w);
}

int own_blocks(int n) { return (n + kLanes - 1) / kLanes; }

}  // namespace

// Plain C interface (loaded with ctypes). Pointer arrays hold the columns
// in the order of the port's _P_SPEC / _R_SPEC. Each returns the launch's
// cudaError_t (0 = launched); nothing synchronises.

// K14 feasibility: row_any [P] u8, col_bits [ceil(T/32)] u32 (zero on entry).
extern "C" int k14_feasibility(const void* const* prov_cols, const void* const* req_cols, int P,
                               int T, int K, int W, float w_price, float w_load, float w_prox,
                               float w_prio, float* aux, uint8_t* row_any, uint32_t* col_bits,
                               void* stream) {
  const size_t smem = (size_t)((T + 31) / 32) * sizeof(uint32_t);
  if (P < 1 || T < 1 || K > kMaxOpts || smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        feasibility_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const Weights w{w_price, w_load, w_prox, w_prio};
  const Prov prov = make_prov(prov_cols);
  const Req req = make_req(req_cols);
  launch_prep(prov, req, w, P, T, aux, (cudaStream_t)stream);
  feasibility_kernel<<<own_blocks(P), kLanes * kParts, smem, (cudaStream_t)stream>>>(
      prov, req, make_aux(aux, P, T), w, P, T, K, W, row_any, col_bits);
  return (int)cudaGetLastError();
}

// K14 row pass (rows != 0): lse [P] over the tasks of K + pot[t], pot = v
// [T]; column pass (rows == 0): lse [T] over the providers of K + pot[p],
// pot = u [P].
extern "C" int k14_lse(const void* const* prov_cols, const void* const* req_cols, int P, int T,
                       int K, int W, float w_price, float w_load, float w_prox, float w_prio,
                       float eps, int rows, const float* pot, float* aux, float* lse,
                       void* stream) {
  if (P < 1 || T < 1 || K > kMaxOpts || !(eps > 0.0f)) return (int)cudaErrorInvalidValue;
  const Weights w{w_price, w_load, w_prox, w_prio};
  const Prov prov = make_prov(prov_cols);
  const Req req = make_req(req_cols);
  const Aux ax = make_aux(aux, P, T);
  launch_prep(prov, req, w, P, T, aux, (cudaStream_t)stream);
  if (rows)
    lse_kernel<true><<<own_blocks(P), kLanes * kParts, 0, (cudaStream_t)stream>>>(
        prov, req, ax, w, P, T, K, W, eps, pot, lse);
  else
    lse_kernel<false><<<own_blocks(T), kLanes * kParts, 0, (cudaStream_t)stream>>>(
        prov, req, ax, w, P, T, K, W, eps, pot, lse);
  return (int)cudaGetLastError();
}

// K15: out [T] f32, the unjittered cost of (p4t[t], t), INFEASIBLE where
// p4t[t] < 0 (every p4t[t] < P).
extern "C" int k15_pair_cost(const void* const* prov_cols, const void* const* req_cols, int P,
                             int T, int K, int W, float w_price, float w_load, float w_prox,
                             float w_prio, const int32_t* p4t, float* aux, float* out,
                             void* stream) {
  if (P < 1 || T < 1 || K > kMaxOpts) return (int)cudaErrorInvalidValue;
  const Weights w{w_price, w_load, w_prox, w_prio};
  const Prov prov = make_prov(prov_cols);
  const Req req = make_req(req_cols);
  launch_prep(prov, req, w, P, T, aux, (cudaStream_t)stream);
  pair_cost_kernel<<<(T + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      prov, req, make_aux(aux, P, T), w, T, K, W, p4t, out);
  return (int)cudaGetLastError();
}
