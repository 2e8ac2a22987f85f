// K1: fused candidate pass for Hopper (sm_90a).
//
// Replaces, on the cold path, the reference's candidate scan
// (protocol_tpu/ops/sparse.py: _forward_tile_select and the reverse step
// and carry of candidates_topk_reverse), over compat_mask
// (ops/encoding.py), cost_matrix and tie_jitter (ops/cost.py). The
// reference streams [P, tile] cost blocks through XLA; here every (p, t)
// cell is scored in registers by one __device__ function and the
// [P, T] block never reaches device memory.
//
// Two launches over the same cell function (cell.cuh):
//   forward  (k1_forward_rows) for a list of global task ids, row i of
//            the output for task t_ids[i]: the cold pass gives every task
//            id, the warm-path repair (parallel/sparse.py
//            _build_repair_forward's selection) the dirty ones. Each row
//            walks the P providers in index order, split over up to 32
//            lanes of a warp, each lane keeping a running top-k under the
//            key (cost, provider), so the lower index wins among equal
//            costs (lax.top_k's order); admitted costs are buffered and
//            merged 16 at a time, and the lanes' lists are merged by
//            shuffles, so that a few rows still fill the card. Writes
//            [R, k], provider -1 where cost >= 5e8. A jitter offset
//            (the reference's task_offset) shifts each task's jitter key,
//            not the requirement row it reads. An optional [P] bias (the
//            reference's provider_offset; the blocked Sinkhorn's rounding
//            passes -eps * u) is added to the feasible cells' cost for the
//            selection only: that instantiation keys the walk, its buffer
//            and the lane merge on (selection, provider), carries each
//            entry's true cost beside the key, writes the true costs, and
//            sets the provider to -1 where the selection is >= 5e8. The
//            unbiased instantiation is the code it was, bit for bit.
//   reverse  per provider, four threads each take a quarter of the task
//            tiles: the first argmin of each tile goes to pool_t / pool_c
//            [P, n_tiles]; then the pools are folded in tile order into a
//            register top-r carry (the carry wins ties). Writes rev_t /
//            rev_c [P, r]. Where a tile contributes rt > 1 tasks (fewer
//            than r tiles, as the matcher's colocation phase has), each
//            tile keeps a stable register top-rt instead of its argmin,
//            the pools are [P, n_tiles * rt] in tile order, and the fold
//            takes their entries in that order: the stable top-r of
//            concat(carry, tile's top-rt) per tile, the reference's step.
//            It takes the same jitter offset as the forward launch.
//            Blocks variant (k1_reverse_blocks; replaces parallel/sparse.py
//            _build_repair_tile at rt = 1): one thread per flagged
//            (provider, tile) block of a flat list, writing that block's
//            first argmin into the pools in place; the list is ordered by
//            (tile, provider), so a warp's task loads stay uniform.
//
// What bounds it on the H100: arithmetic. Each cell is ~40 integer ops of
// the capability check plus, on feasible cells, two sinf, one asinf and
// one sqrtf; the inputs are O(P + T) bytes and the outputs O(T k + P r).
// The design therefore keeps the loop side of each launch (providers in
// the forward launch, tasks in the reverse launch) as warp-uniform loads
// that hit L1, hoists the per-row terms (base price term, cos(lat)) out
// of the cell, and skips the haversine on infeasible cells (their cost is
// INFEASIBLE whatever the distance). Measured on the H100 both launches
// run far above that bound: the forward launch is held back by its
// running top-k (a lane that inserts stalls its warp), which its buffered
// insertion eases, the reverse launch by latency at low occupancy, which
// its four-way split of the tiles eases.
//
// Numerics: built with -fmad=false and no fast-math, so every f32
// operation rounds once, in the reference's order, as torch's eager ops
// do. With proximity 0 the cost involves no transcendental and the
// outputs are bit-identical to the plain torch version.

#include <climits>

#include "cell.cuh"

namespace {

// Admitted costs wait in a small unsorted buffer (arrival = provider
// order) and are merged into the sorted list when it fills: appending is
// two stores, where a sorted insertion shifts half the list while the
// other lanes of the warp wait.
constexpr int kBuf = 16;

// Merge the first nq buffered entries into the sorted top-k (bc, bp).
// Every list entry has a lower provider index than every buffered one,
// so the list wins ties; the buffer is sorted stably first. The key bc /
// qc is the cost, or on the biased path the selection value (cost plus
// the provider's bias); there bx / qx carry each entry's true cost along.
template <bool kBias>
__device__ __forceinline__ void flush_topk(float* bc, int32_t* bp, float* bx, float* qc,
                                           int32_t* qp, float* qx, int nq, int k) {
  for (int i = 1; i < nq; ++i) {
    const float x = qc[i];
    const int32_t xp = qp[i];
    float xx = 0.0f;
    if constexpr (kBias) xx = qx[i];
    int j = i;
    while (j > 0 && qc[j - 1] > x) {
      qc[j] = qc[j - 1];
      qp[j] = qp[j - 1];
      if constexpr (kBias) qx[j] = qx[j - 1];
      --j;
    }
    qc[j] = x;
    qp[j] = xp;
    if constexpr (kBias) qx[j] = xx;
  }
  float mc[kMaxK];
  int32_t mp[kMaxK];
  float mx[kBias ? kMaxK : 1];
  int a = 0, b = 0;
  for (int i = 0; i < k; ++i) {  // a <= i < k: the list never runs out
    if (b >= nq || bc[a] <= qc[b]) {
      mc[i] = bc[a];
      mp[i] = bp[a];
      if constexpr (kBias) mx[i] = bx[a];
      ++a;
    } else {
      mc[i] = qc[b];
      mp[i] = qp[b];
      if constexpr (kBias) mx[i] = qx[b];
      ++b;
    }
  }
  for (int i = 0; i < k; ++i) {
    bc[i] = mc[i];
    bp[i] = mp[i];
    if constexpr (kBias) bx[i] = mx[i];
  }
}

// Walk providers [p0, p1) in index order for task row tr (global id t),
// keeping the running top-k (bc, bp) under the key (cost, provider). On
// the biased path (the reference's provider_offset) the key is the
// selection value where(cost < INFEASIBLE/2, cost + bias[p], cost) and bx
// holds each entry's true cost, as the walk computed it.
template <bool kBias>
__device__ __forceinline__ void walk_topk(const Prov& prov, const Req& req, const Aux& aux,
                                          const Weights& w, const TaskRow& tr, int t, int K,
                                          int W, int k, int p0, int p1,
                                          const float* __restrict__ bias, float* bc,
                                          int32_t* bp, float* bx) {
  for (int j = 0; j < k; ++j) {
    bc[j] = INFINITY;
    bp[j] = -1;
    if constexpr (kBias) bx[j] = INFINITY;
  }
  float qc[kBuf];
  int32_t qp[kBuf];
  float qx[kBias ? kBuf : 1];
  int nq = 0;
  // the list's k-th key as of the last merge: never below the exact
  // running threshold, so every key that belongs in the top-k is
  // admitted (the merge drops the rest)
  float worst = INFINITY;
  for (int p = p0; p < p1; ++p) {
    const ProvRow pr = load_prov(prov, aux, p);
    const float c = cell_cost(pr, p, tr, t, req, K, W, w);
    float s = c;
    if constexpr (kBias) s = c < kHalfInfeasible ? __fadd_rn(c, bias[p]) : c;
    if (s < worst) {
      qc[nq] = s;
      qp[nq] = p;
      if constexpr (kBias) qx[nq] = c;
      if (++nq == kBuf) {
        flush_topk<kBias>(bc, bp, bx, qc, qp, qx, nq, k);
        nq = 0;
        worst = bc[k - 1];
      }
    }
  }
  flush_topk<kBias>(bc, bp, bx, qc, qp, qx, nq, k);
}

// Row i is task t_ids[i], shared by `lanes` threads of one warp (a power
// of two <= 32). Lane j walks the j-th contiguous part of
// the providers with its own top-k; the lanes then merge their lists k
// times by warp shuffles, taking the least (cost, provider) each time, so
// the lower index wins among equal costs as in one walk (each list keeps
// its own lower indices first). A few rows (a requirement-churn tick's
// ~1%, a matcher phase's few thousand slots) still spread over the card
// this way; lanes = 1 is one walk per row, as the cold pass over 65,536
// tasks takes.
template <bool kBias>
__global__ void __launch_bounds__(128) forward_rows_kernel(Prov prov, Req req, Aux aux, Weights w,
                                                           int P, int n_rows,
                                                           const int32_t* __restrict__ t_ids,
                                                           int K, int W, int k, int lanes,
                                                           uint32_t offset,
                                                           const float* __restrict__ bias,
                                                           int32_t* __restrict__ out_p,
                                                           float* __restrict__ out_c) {
  // every thread of a warp takes part in the shuffles: no early return
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = g / lanes;
  const int lane = g % lanes;
  const bool active = i < n_rows;
  float bc[kMaxK];
  int32_t bp[kMaxK];
  float bx[kBias ? kMaxK : 1];
  if (active) {
    const int t = t_ids[i];
    const TaskRow tr = load_task(req, aux, t, K, offset);
    const int part = (P + lanes - 1) / lanes;
    const int p0 = min(P, lane * part);
    walk_topk<kBias>(prov, req, aux, w, tr, t, K, W, k, p0, min(P, p0 + part), bias, bc, bp, bx);
  } else {
    for (int j = 0; j < k; ++j) {
      bc[j] = INFINITY;
      bp[j] = -1;
      if constexpr (kBias) bx[j] = INFINITY;
    }
  }
  int head = 0;
  for (int j = 0; j < k; ++j) {
    const float c = head < k ? bc[head] : INFINITY;
    int32_t p = head < k ? bp[head] : -1;
    if (p < 0) p = INT_MAX;  // an empty slot sorts last
    float best_c = c;
    int32_t best_p = p;
    // the biased path's key is the selection value: its true cost rides along
    float best_x = 0.0f;
    if constexpr (kBias) best_x = head < k ? bx[head] : INFINITY;
    for (int off = lanes >> 1; off > 0; off >>= 1) {
      const float oc = __shfl_xor_sync(0xffffffffu, best_c, off);
      const int32_t op = __shfl_xor_sync(0xffffffffu, best_p, off);
      float ox = 0.0f;
      if constexpr (kBias) ox = __shfl_xor_sync(0xffffffffu, best_x, off);
      if (oc < best_c || (oc == best_c && op < best_p)) {
        best_c = oc;
        best_p = op;
        if constexpr (kBias) best_x = ox;
      }
    }
    if (p == best_p) ++head;  // provider ids are unique across the lanes
    if (active && lane == 0) {
      out_c[(size_t)i * k + j] = kBias ? best_x : best_c;
      out_p[(size_t)i * k + j] = best_c < kHalfInfeasible ? best_p : -1;
    }
  }
}

// The reverse launch serves 32 providers per block with kParts warps: warp
// q takes the q-th contiguous part of the task tiles for all 32 providers,
// so the loop side stays warp-uniform and four times as many warps are
// resident as with one thread per provider; the pools are folded in tile
// order afterwards, so ties resolve exactly as one walk would resolve
// them. (The forward launch splits a row only where the rows are too
// few to fill the card: split the same way at full width, its top-k
// insertions per cell rise and it measured 2x slower.)
constexpr int kParts = 4;
constexpr int kRows = 32;

template <bool kMulti>
__global__ void __launch_bounds__(kRows * kParts) reverse_kernel(
    Prov prov, Req req, Aux aux, Weights w, int P, int T, int K, int W, int tile, int r, int rt,
    uint32_t offset, int32_t* pool_t, float* pool_c, int32_t* __restrict__ rev_t,
    float* __restrict__ rev_c) {
  // pool_t / pool_c are written by every part and read back by part 0
  const int lane = threadIdx.x % kRows;
  const int part = threadIdx.x / kRows;
  const int p = blockIdx.x * kRows + lane;
  const bool active = p < P;
  const int n_tiles = T / tile;
  const int chunk = (n_tiles + kParts - 1) / kParts;
  const int ti_end = min(n_tiles, (part + 1) * chunk);
  const int n_pool = n_tiles * rt;
  if (active) {
    const ProvRow pr = load_prov(prov, aux, p);
    for (int ti = part * chunk; ti < ti_end; ++ti) {
      const int t0 = ti * tile;
      if constexpr (!kMulti) {
        float best = INFINITY;
        int32_t bt = -1;
        for (int j = 0; j < tile; ++j) {
          const int t = t0 + j;
          const TaskRow tr = load_task(req, aux, t, K, offset);
          const float c = cell_cost(pr, p, tr, t, req, K, W, w);
          if (c < best) {  // strict: the first index among ties
            best = c;
            bt = t;
          }
        }
        pool_t[(size_t)p * n_pool + ti] = bt;
        pool_c[(size_t)p * n_pool + ti] = best;
      } else {
        // stable top-rt of the tile: an entry goes after the entries it
        // equals, so the lower index comes first among ties
        float tc[kMaxR];
        int32_t tt[kMaxR];
#pragma unroll
        for (int i = 0; i < kMaxR; ++i) {
          tc[i] = INFINITY;
          tt[i] = -1;
        }
        for (int j = 0; j < tile; ++j) {
          const int t = t0 + j;
          const TaskRow tr = load_task(req, aux, t, K, offset);
          float c = cell_cost(pr, p, tr, t, req, K, W, w);
          int32_t ct = t;
          bool moved = false;
#pragma unroll
          for (int i = 0; i < kMaxR; ++i) {
            if (i < rt && (moved || c < tc[i])) {
              const float sc = tc[i];
              const int32_t st = tt[i];
              tc[i] = c;
              tt[i] = ct;
              c = sc;
              ct = st;
              moved = true;
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kMaxR; ++i) {
          if (i < rt) {
            pool_t[(size_t)p * n_pool + (size_t)ti * rt + i] = tt[i];
            pool_c[(size_t)p * n_pool + (size_t)ti * rt + i] = tc[i];
          }
        }
      }
    }
  }
  __syncthreads();  // every part's pool entries of this block are written
  if (part != 0 || !active) return;
  // fold the pools in tile order into the carry (the carry wins ties)
  float rc[kMaxR];
  int32_t rv[kMaxR];
  fold_pools(pool_t, pool_c, (size_t)p * n_pool, n_pool, r, rc, rv);
#pragma unroll
  for (int i = 0; i < kMaxR; ++i) {
    if (i < r) {
      rev_c[(size_t)p * r + i] = rc[i];
      rev_t[(size_t)p * r + i] = rv[i];
    }
  }
}

// One thread per flagged (provider, tile) block: the first argmin of the
// block's cells (strict <, as the cold reverse launch), written into the
// pools at [p, j]. Blocks come ordered by (tile, provider).
__global__ void __launch_bounds__(128) reverse_blocks_kernel(
    Prov prov, Req req, Aux aux, Weights w, int n_tiles, int K, int W, int tile,
    const int32_t* __restrict__ blk_p, const int32_t* __restrict__ blk_j, int n_blocks,
    int32_t* __restrict__ pool_t, float* __restrict__ pool_c) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_blocks) return;
  const int p = blk_p[b];
  const int t0 = blk_j[b] * tile;
  const ProvRow pr = load_prov(prov, aux, p);
  float best = INFINITY;
  int32_t bt = -1;
  for (int j = 0; j < tile; ++j) {
    const int t = t0 + j;
    const TaskRow tr = load_task(req, aux, t, K);
    const float c = cell_cost(pr, p, tr, t, req, K, W, w);
    if (c < best) {
      best = c;
      bt = t;
    }
  }
  pool_t[(size_t)p * n_tiles + blk_j[b]] = bt;
  pool_c[(size_t)p * n_tiles + blk_j[b]] = best;
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointer arrays hold the columns
// in the order of the port's _P_SPEC / _R_SPEC. Each returns the launch's
// cudaError_t (0 = launched).
extern "C" int k1_limits(int* max_k, int* max_r, int* max_opts) {
  *max_k = kMaxK;
  *max_r = kMaxR;
  *max_opts = kMaxOpts;
  return 0;
}

// The forward walk for the n_rows global task ids t_ids, `lanes` threads
// per row, the jitter keyed on (id + offset) mod 2^32. With a [P] bias
// (not null) the selection is biased per provider and out_c holds the
// true costs; null takes the unbiased instantiation.
extern "C" int k1_forward_rows(const void* const* prov_cols, const void* const* req_cols, int P,
                               int T, int K, int W, float w_price, float w_load, float w_prox,
                               float w_prio, int k, const int32_t* t_ids, int n_rows, int lanes,
                               unsigned int offset, const float* bias, float* aux,
                               int32_t* out_p, float* out_c, void* stream) {
  if (k < 1 || k > kMaxK || K > kMaxOpts || k > P || n_rows < 1 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const Weights w{w_price, w_load, w_prox, w_prio};
  const int threads = 128;
  const long long total = (long long)n_rows * lanes;
  const Prov prov = make_prov(prov_cols);
  const Req req = make_req(req_cols);
  launch_prep(prov, req, w, P, T, aux, (cudaStream_t)stream);
  const int blocks = (int)((total + threads - 1) / threads);
  if (bias == nullptr)
    forward_rows_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        prov, req, make_aux(aux, P, T), w, P, n_rows, t_ids, K, W, k, lanes, offset, nullptr,
        out_p, out_c);
  else
    forward_rows_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        prov, req, make_aux(aux, P, T), w, P, n_rows, t_ids, K, W, k, lanes, offset, bias,
        out_p, out_c);
  return (int)cudaGetLastError();
}

// rt tasks per tile (1 <= rt <= r, rt <= tile): pools [P, n_tiles * rt];
// the jitter keyed on (task id + offset) mod 2^32. Fewer pool entries than
// r (a shard of the provider mesh holds few tiles) leave the carry's
// (INFEASIBLE, -1) entries in place, as the reference's fold does.
extern "C" int k1_reverse(const void* const* prov_cols, const void* const* req_cols, int P,
                          int T, int K, int W, float w_price, float w_load, float w_prox,
                          float w_prio, int tile, int r, int rt, unsigned int offset, float* aux,
                          int32_t* pool_t, float* pool_c, int32_t* rev_t, float* rev_c,
                          void* stream) {
  if (r < 1 || r > kMaxR || K > kMaxOpts || tile < 1 || T % tile != 0 || rt < 1 || rt > r ||
      rt > tile)
    return (int)cudaErrorInvalidValue;
  const Weights w{w_price, w_load, w_prox, w_prio};
  const int threads = kRows * kParts;
  const int blocks = (P + kRows - 1) / kRows;
  const Prov prov = make_prov(prov_cols);
  const Req req = make_req(req_cols);
  const Aux ax = make_aux(aux, P, T);
  launch_prep(prov, req, w, P, T, aux, (cudaStream_t)stream);
  if (rt == 1)
    reverse_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        prov, req, ax, w, P, T, K, W, tile, r, 1, offset, pool_t, pool_c, rev_t, rev_c);
  else
    reverse_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        prov, req, ax, w, P, T, K, W, tile, r, rt, offset, pool_t, pool_c, rev_t, rev_c);
  return (int)cudaGetLastError();
}

// Blocks variant: rescore n_blocks (provider, tile) blocks into the pools
// [P, T / tile] in place (one contribution per tile).
extern "C" int k1_reverse_blocks(const void* const* prov_cols, const void* const* req_cols, int P,
                                 int T, int K, int W, float w_price, float w_load, float w_prox,
                                 float w_prio, int tile, const int32_t* blk_p,
                                 const int32_t* blk_j, int n_blocks, float* aux, int32_t* pool_t,
                                 float* pool_c, void* stream) {
  if (K > kMaxOpts || tile < 1 || T % tile != 0 || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const Weights w{w_price, w_load, w_prox, w_prio};
  const int threads = 128;
  const Prov prov = make_prov(prov_cols);
  const Req req = make_req(req_cols);
  launch_prep(prov, req, w, P, T, aux, (cudaStream_t)stream);
  reverse_blocks_kernel<<<(n_blocks + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      prov, req, make_aux(aux, P, T), w, T / tile, K, W, tile, blk_p, blk_j, n_blocks, pool_t,
      pool_c);
  return (int)cudaGetLastError();
}
