// K14: the streamed passes of the blocked (matrix-free) Sinkhorn, and K15:
// the cost of assigned (provider, task) pairs, for Hopper (sm_90a).
//
// K14 replaces the device work of protocol_tpu/ops/blocked.py::
// sinkhorn_potentials_blocked (:92) with its make_k_block (:40),
// feasibility_scan (:54) and streaming_row_logsumexp (:64): the reference
// streams [P, tile] blocks of K = -cost/eps (-1e18 off the mask) through
// XLA, twice per iteration. Here no [P, T] or [P, tile] block of floats
// exists. Three launches, the third with a partial mode:
//   feasibility  once per solve: the mask as two bitmaps, row-major
//                rows[p][w] (bit j: cell (p, 32w + j)) and column-major
//                cols[t][w] (bit j: cell (32w + j, t)), u32 words, pad
//                bits 0; with row_any[p] (u8) and col_bits (a
//                [ceil(T/32)] u32 bitmap of col_any). The predicate is
//                K1's cell function, cell_cost<false> < INFEASIBLE/2;
//   row pass     lse_u[p] = logsumexp over the feasible t of K[p, t] + v[t];
//   column pass  lse_v[t] = logsumexp over the feasible p of K[p, t] + u[p];
//                or, in its partial mode, the pair itself, m[t] and s[t],
//                over the P rows it is given (one shard's providers).
// The partial mode replaces the v step of protocol_tpu/parallel/
// sinkhorn.py::_build_sharded_sinkhorn (:100-110), which takes each
// shard's per-tile column max, a pmax, then each shard's sum of exp(k -
// gmax) (recomputing the block) and a psum: here each shard's cells are
// scored once, and the shards' pairs combine on the host side as
// gmax = max m_s, gsum = sum of s_s * exp(m_s - gmax) in shard order
// (protocol_tpu_torch/parallel/sinkhorn.py). A column with no feasible
// cell in the shard keeps m = -inf, s = 0; the combine adds 0 for it.
// The marginals, the masks (where(row_any, log_a - lse_u, -1e18), ...)
// and the loop over the iterations stay torch glue on the card
// (protocol_tpu_torch/ops/blocked.py).
//
// Feasibility layout: a block serves 32 providers, one a lane, and its
// kParts warps each walk a 32-aligned part of the tasks in index order,
// so the task loads are warp-uniform and hit L1. A __ballot_sync over the
// lanes is the column-major word of (task, block); each lane gathers its
// own row-major word bit by bit. Every word of both bitmaps is written
// once. The launch ORs col_any into a shared-memory bitmap of the T tasks
// and that into col_bits with one atomicOr per changed word.
//
// Pass layout: one warp per own row at a time (a provider in the row
// pass, a task in the column pass), so no pass runs the capability check
// or loads a task's GPU options. A warp takes its next own row from a
// counter (an atomicAdd by lane 0) until the rows run out, and the grid
// holds as many blocks as the card keeps resident: the rows' feasible
// counts differ by up to ~90x between tasks, and a block that waited for
// its slowest warp would hold its idle warps' slots. The warp reads its
// row of the bitmap 32 words
// (1,024 cells) at a time, a word a lane; an exclusive scan of the words'
// popcounts over the lanes places the other-side indices of the set bits
// in a per-warp queue in shared memory, and the warp drains the queue 32
// cells at a time, one a lane, carrying fewer than 32 to the next chunk:
// every lane scores a feasible cell, none idles on an infeasible one. A
// lane scores its cell from the own row's four floats (registers) and the
// other side's, one 16-byte load (lat, lon, coslat or kNoLoc, and prio
// for a task or base for a provider, packed per call by pack_kernel from
// prep_kernel's terms), with cell_terms (cell.cuh: the terms of
// cell_cost after compat), so each cell's K = -cost/eps + pot is the bits
// of the per-cell pass it replaces. Each lane keeps an online (max,
// sum-exp) pair; the lanes merge theirs with shuffles at the end of the
// row,
//   (m, s) + (m', s') = (M, s * exp(m - M) + s' * exp(m' - M)),  M = max,
// and the result is m + log(max(s, 1e-30)), the reference's epilogue (the
// partial mode stops before it). This is not the reference's summation
// order (a per-tile max, then a sum over the tile, carried tile to tile),
// so the passes agree with the plain version within a tolerance, not bit
// for bit.
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
// K15 replaces ops/cost.py::_cost_pairs_vmapped (:137) / cost_pairs
// (:149): one thread per task t scores the cell (p4t[t], t) with
// cell_cost<false>, INFEASIBLE where p4t[t] < 0 (the stage-S quality
// measure, O(T) cells where [P, T] cannot exist).
//
// What bounds them on the H100: operations. The feasibility launch
// scores P x T cells, ~12 operations each for the capability check and
// ~30 more on a feasible one, and writes 2 x P x T / 8 bytes of bitmap.
// A pass reads P x T / 8 bytes of bitmap and O(P + T) of rows, and does
// the ~30 operations of the cost plus the division, the add and the exp
// of the online sum-exp on each feasible cell only. K15 reads one
// provider row per task: bytes.
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
constexpr int kLanes = 32;       // providers a feasibility block serves
constexpr int kParts = 8;        // warps a feasibility block splits the tasks over
constexpr int kWarps = 4;        // warps of a pass block, each on one own row at a time
constexpr int kChunk = 32;       // bitmap words a warp reads at a time (a word a lane)
constexpr int kQueue = kChunk * 32 + kLanes;  // one chunk's cells + fewer than 32 carried
constexpr float kNoLoc = -2.0f;  // the packed coslat of a row without a location
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

__global__ void __launch_bounds__(kLanes * kParts) feasibility_kernel(
    Prov prov, Req req, Aux aux, Weights w, int P, int T, int K, int W,
    uint8_t* __restrict__ row_any, uint32_t* __restrict__ col_bits,
    uint32_t* __restrict__ rows, uint32_t* __restrict__ cols) {
  extern __shared__ uint32_t s_col[];  // ceil(T / 32) words
  __shared__ int s_row[kParts][kLanes];
  const int lane = threadIdx.x % kLanes;
  const int part = threadIdx.x / kLanes;
  const int p = blockIdx.x * kLanes + lane;
  const bool active = p < P;
  const int n_words = (T + 31) / 32;
  const size_t p_words = gridDim.x;  // ceil(P / 32): a column-major row's words
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) s_col[i] = 0u;
  __syncthreads();
  const ProvRow pr = load_prov(prov, aux, active ? p : 0);
  // this warp's part of the tasks, whole words: [lo, hi)
  const int part_words = (n_words + kParts - 1) / kParts;
  const int lo = min(T, part * part_words * 32);
  const int hi = min(T, lo + part_words * 32);
  int any = 0;
  uint32_t col_word = 0u;  // col_any bits of the current 32 tasks
  uint32_t row_word = 0u;  // this lane's cells among them
  uint32_t my_col = 0u;    // the ballot of task (t & ~31) + lane
  for (int t = lo; t < hi; ++t) {
    const TaskRow tr = load_task(req, aux, t, K);
    const bool f = active && cell_cost<false>(pr, p, tr, t, req, K, W, w) < kHalfInfeasible;
    any |= f;
    row_word |= (uint32_t)f << (t & 31);
    const uint32_t b = __ballot_sync(kFull, f);
    if (lane == (t & 31)) my_col = b;
    if (b != 0u) col_word |= 1u << (t & 31);
    if ((t & 31) == 31 || t == hi - 1) {
      const int w0 = t >> 5;
      const int tl = (t & ~31) + lane;
      if (tl <= t) cols[(size_t)tl * p_words + blockIdx.x] = my_col;
      if (active) rows[(size_t)p * n_words + w0] = row_word;
      if (lane == 0 && col_word != 0u) atomicOr(&s_col[w0], col_word);
      col_word = row_word = 0u;
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

// One thread per row: the 16 bytes a pass reads of each side's row,
// (lat, lon, coslat or kNoLoc, base) for a provider and (lat, lon, coslat
// or kNoLoc, prio) for a task, from prep_kernel's terms; and the pass's
// row counter set to 0.
__global__ void pack_kernel(Prov prov, Req req, Aux x, int P, int T, float4* __restrict__ pp,
                            float4* __restrict__ pt, int* __restrict__ next_row) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) *next_row = 0;
  if (i < P)
    pp[i] = make_float4(prov.lat[i], prov.lon[i],
                        prov.has_location[i] != 0 ? x.p_coslat[i] : kNoLoc, x.p_base[i]);
  if (i < T)
    pt[i] = make_float4(req.lat[i], req.lon[i],
                        req.has_location[i] != 0 ? x.t_coslat[i] : kNoLoc, x.t_prio[i]);
}

// kRows: own = provider, lse over its feasible tasks of K + v (the u
// pass), reading the row-major bitmap; otherwise own = task, lse over its
// feasible providers of K + u (the v pass), reading the column-major one.
// kPartial (a column pass only): write the pair (m into lse, s into sum)
// instead of m + log(max(s, 1e-30)).
template <bool kRows, bool kPartial>
__device__ __forceinline__ void lse_row(int own, int* queue, const float4* __restrict__ own_rows,
                                        const float4* __restrict__ other_rows,
                                        const uint32_t* __restrict__ bits, int n_words,
                                        float proximity, float eps,
                                        const float* __restrict__ pot, float* __restrict__ lse,
                                        float* __restrict__ sum) {
  const int lane = threadIdx.x % kLanes;
  const float4 o = own_rows[own];
  const bool o_loc = o.z != kNoLoc;
  const uint32_t* row = bits + (size_t)own * n_words;
  float m = -INFINITY, s = 0.0f;

  auto score = [&](int j) {  // cell (own, j) or (j, own), feasible
    const float4 x = other_rows[j];
    const bool x_loc = x.z != kNoLoc;
    const float c = kRows ? cell_terms(o.w, o.x, o.y, o.z, o_loc, x.x, x.y, x.z, x_loc, x.w,
                                       proximity)
                          : cell_terms(x.w, x.x, x.y, x.z, x_loc, o.x, o.y, o.z, o_loc, o.w,
                                       proximity);
    lse_push(__fadd_rn(__fdiv_rn(-c, eps), pot[j]), m, s);
  };

  int queued = 0;  // cells in the queue, fewer than 32 between chunks
  for (int w0 = 0; w0 < n_words; w0 += kChunk) {
    const int wi = w0 + lane;
    uint32_t word = wi < n_words ? row[wi] : 0u;
    const int n = __popc(word);
    int incl = n;  // inclusive scan of the popcounts over the lanes
#pragma unroll
    for (int d = 1; d < kLanes; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    const int total = __shfl_sync(kFull, incl, kLanes - 1);
    int at = queued + incl - n;
    while (word != 0u) {
      queue[at++] = wi * 32 + __ffs(word) - 1;
      word &= word - 1u;
    }
    queued += total;
    __syncwarp();
    const int full = queued & ~(kLanes - 1);
    for (int b = 0; b < full; b += kLanes) score(queue[b + lane]);
    const int rest = queued - full;
    if (full > 0 && rest > 0) {  // carry the remainder to the front
      const int j = lane < rest ? queue[full + lane] : 0;
      __syncwarp();
      if (lane < rest) queue[lane] = j;
    }
    __syncwarp();
    queued = rest;
  }
  if (lane < queued) score(queue[lane]);
#pragma unroll
  for (int d = kLanes / 2; d > 0; d >>= 1) {
    const float m2 = __shfl_xor_sync(kFull, m, d);
    const float s2 = __shfl_xor_sync(kFull, s, d);
    lse_merge(m, s, m2, s2);
  }
  if (lane != 0) return;
  if constexpr (kPartial) {
    lse[own] = m;
    sum[own] = s;
  } else {
    lse[own] = __fadd_rn(m, logf(fmaxf(s, kTiny)));
  }
}

template <bool kRows, bool kPartial = false>
__global__ void __launch_bounds__(kLanes * kWarps) lse_kernel(
    const float4* __restrict__ own_rows, const float4* __restrict__ other_rows,
    const uint32_t* __restrict__ bits, int n_own, int n_words, float proximity, float eps,
    const float* __restrict__ pot, float* __restrict__ lse, float* __restrict__ sum,
    int* __restrict__ next_row) {
  static_assert(!(kRows && kPartial), "the partial mode is a column pass");
  __shared__ int s_queue[kWarps][kQueue];
  int* queue = s_queue[threadIdx.x / kLanes];
  for (;;) {
    int own = 0;
    if (threadIdx.x % kLanes == 0) own = atomicAdd(next_row, 1);
    own = __shfl_sync(kFull, own, 0);
    if (own >= n_own) return;  // the whole warp
    lse_row<kRows, kPartial>(own, queue, own_rows, other_rows, bits, n_words, proximity, eps,
                             pot, lse, sum);
    __syncwarp();
  }
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

// Where the packed rows start in aux, in floats: past prep_kernel's 2 (P +
// T) terms, rounded up to 16 bytes.
size_t pack_offset(int P, int T) { return ((2 * (size_t)(P + T) + 3) / 4) * 4; }

// The pass's row counter, an int after the packed rows in aux.
int* row_counter(float* aux, int P, int T) {
  return reinterpret_cast<int*>(aux + pack_offset(P, T) + 4 * (size_t)(P + T));
}

// prep_kernel's terms, then the packed rows (P provider float4, then T
// task float4) and the zeroed row counter after them in aux.
void launch_pack(const Prov& prov, const Req& req, const Weights& w, int P, int T, float* aux,
                 cudaStream_t stream) {
  launch_prep(prov, req, w, P, T, aux, stream);
  float4* pp = reinterpret_cast<float4*>(aux + pack_offset(P, T));
  const int n = P > T ? P : T;
  pack_kernel<<<(n + 255) / 256, 256, 0, stream>>>(prov, req, make_aux(aux, P, T), P, T, pp,
                                                   pp + P, row_counter(aux, P, T));
}

// A pass: own rows from the packed rows at `own`, the other side's at
// `other`, the bitmap row of each own row n_words long; as many blocks as
// the card keeps resident (fewer for fewer rows).
template <bool kRows, bool kPartial>
int launch_pass(const void* const* prov_cols, const void* const* req_cols, int P, int T,
                float w_price, float w_load, float w_prox, float w_prio, float eps,
                const float* pot, float* aux, const uint32_t* bits, float* lse, float* sum,
                void* stream) {
  if (P < 1 || T < 1 || !(eps > 0.0f)) return (int)cudaErrorInvalidValue;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lse_kernel<kRows, kPartial>,
                                                        kLanes * kWarps, 0);
  if (err != cudaSuccess) return (int)err;
  const Weights w{w_price, w_load, w_prox, w_prio};
  launch_pack(make_prov(prov_cols), make_req(req_cols), w, P, T, aux, (cudaStream_t)stream);
  const float4* pp = reinterpret_cast<const float4*>(aux + pack_offset(P, T));
  const int n_own = kRows ? P : T;
  const int n_words = kRows ? (T + 31) / 32 : (P + 31) / 32;
  const int blocks = min((n_own + kWarps - 1) / kWarps, max(1, n_sm * per_sm));
  lse_kernel<kRows, kPartial><<<blocks, kLanes * kWarps, 0, (cudaStream_t)stream>>>(
      kRows ? pp : pp + P, kRows ? pp + P : pp, bits, n_own, n_words, w_prox, eps, pot, lse,
      sum, row_counter(aux, P, T));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointer arrays hold the columns
// in the order of the port's _P_SPEC / _R_SPEC. Each returns the launch's
// cudaError_t (0 = launched); nothing synchronises. A pass's aux holds
// pack_offset(P, T) + 4 (P + T) + 1 floats.

// K14 feasibility: row_any [P] u8, col_bits [ceil(T/32)] u32 (zero on
// entry), rows [P][ceil(T/32)] u32 and cols [T][ceil(P/32)] u32 (every
// word written).
extern "C" int k14_feasibility(const void* const* prov_cols, const void* const* req_cols, int P,
                               int T, int K, int W, float w_price, float w_load, float w_prox,
                               float w_prio, float* aux, uint8_t* row_any, uint32_t* col_bits,
                               uint32_t* rows, uint32_t* cols, void* stream) {
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
      prov, req, make_aux(aux, P, T), w, P, T, K, W, row_any, col_bits, rows, cols);
  return (int)cudaGetLastError();
}

// K14 row pass (rows != 0): lse [P] over each provider's feasible tasks of
// K + pot[t], pot = v [T], bits = the row-major bitmap; column pass (rows
// == 0): lse [T] over each task's feasible providers of K + pot[p], pot =
// u [P], bits = the column-major bitmap.
extern "C" int k14_lse(const void* const* prov_cols, const void* const* req_cols, int P, int T,
                       float w_price, float w_load, float w_prox, float w_prio, float eps,
                       int rows, const float* pot, float* aux, const uint32_t* bits, float* lse,
                       void* stream) {
  if (rows)
    return launch_pass<true, false>(prov_cols, req_cols, P, T, w_price, w_load, w_prox, w_prio,
                                    eps, pot, aux, bits, lse, nullptr, stream);
  return launch_pass<false, false>(prov_cols, req_cols, P, T, w_price, w_load, w_prox, w_prio,
                                   eps, pot, aux, bits, lse, nullptr, stream);
}

// K14 column pass, partial mode: m [T] and s [T], the online (max,
// sum-exp) pair over each task's feasible providers among the P given of
// K + pot[p], pot = u [P], bits = their column-major bitmap; m = -inf and
// s = 0 where a task has no feasible cell among them.
extern "C" int k14_col_partial(const void* const* prov_cols, const void* const* req_cols, int P,
                               int T, float w_price, float w_load, float w_prox, float w_prio,
                               float eps, const float* pot, float* aux, const uint32_t* bits,
                               float* m, float* s, void* stream) {
  return launch_pass<false, true>(prov_cols, req_cols, P, T, w_price, w_load, w_prox, w_prio,
                                  eps, pot, aux, bits, m, s, stream);
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
