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
//                bits 0; with row_bits and col_bits (u32 bitmaps of
//                row_any [P] and col_any [T]). The predicate is K1's
//                cell function's, cell_cost<false> < INFEASIBLE/2;
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
// Feasibility layout. A block stages kTileTasks (256) task rows once in
// shared memory: each row's limits as RowCaps, its GPU options as OptCaps
// (cell.cuh, K1's staged form: an absent limit folded into one compare)
// and its cost terms (lat, lon, coslat or kNoLoc, prio). blockIdx.y takes
// a range of the providers, a multiple of a warp step, and the block's
// warps walk it kLaneProv (2) providers a lane a step, loaded from the
// columns into registers; each lane checks its providers against every
// staged row with compat_many, so a row's limits and options are read
// once for a lane's providers and once for the warp (a broadcast), never a
// cell at a time, and every branch of the check is on the row's fields,
// so the warp does not diverge. A lane gathers its providers' row-major words, 32 tasks a
// word; the column-major words of the same 32 x 32 cells are the
// transpose of the warp's 32 row words, which five shuffle stages give
// (transpose32), so lane l ends with task (32w + l)'s word. The block
// stages a step's words (512 providers by its 256 tasks) in shared memory
// and writes them whole, each once, consecutive threads on consecutive
// words: a provider's 8 row words (32 bytes) and a task's 16 column words
// (64). Written straight from the lanes, a store touched 32 sectors 4
// bytes each and took ~10 ms of the launch's ~57 at 100,000^2 (an H100,
// scripts/torch_k14_ab.py). The lanes' any() bits go into row_bits and
// the words' any() bits into col_bits, one atomicOr a word where it sets a
// bit (a stale read first skips the rest).
//
// The cost predicate of a compatible cell, without the haversine where
// the answer is settled. cell_terms returns fsub(fadd(base, near), prio)
// with near = fmul(proximity, dist), dist in [0, kTwoR * asinf(1) ~
// 20,015.09 km] where both sides are located, else near = 0. IEEE
// round-to-nearest is monotone in each operand (x <= y implies fl(x op c)
// <= fl(y op c) for + and -, and for * by c >= 0; reversed for c < 0), so
// with proximity finite, near lies between near_lo = min(0, fmul(proximity,
// kFarKm)) and near_hi = max(0, fmul(proximity, kFarKm)) for any f32 kFarKm
// at or above the largest dist (20,016), and the cost between lo =
// fsub(fadd(base, near_lo), prio) and hi = fsub(fadd(base, near_hi), prio)
// (a zero's sign changes no comparison). So hi < INFEASIBLE/2 makes the
// cell feasible, lo >= INFEASIBLE/2 infeasible, and only a cell between
// the two, or one whose lo or hi is NaN, runs the exact cell_terms. An
// unlocated cell's bracket is [0, 0]: lo = hi is its exact cost. A
// proximity that is not finite makes near_lo and near_hi NaN, so every
// located cell takes the exact path. With finite ends, fadd(base, near)
// is NaN for no near in the bracket unless base is, and then lo and hi are
// NaN too. A wider bracket only sends more cells to the exact path; it
// cannot change a bit. Per cell that is two selects, two subtractions
// and two compares, with no branch but the exact path's: the
// per-provider sums fadd(base, 0), fadd(base, near_lo) and fadd(base,
// near_hi) are made once a step.
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
// (:149): the unjittered cost of the cell (p4t[t], t) of every task t,
// INFEASIBLE where p4t[t] < 0 (the stage-S quality measure, O(T) cells
// where [P, T] cannot exist). One launch, one thread a task: no prep pass
// over the P + T rows; the thread computes its task's terms and its
// provider's with prep_kernel's functions (cell.cuh: prov_base, task_prio,
// cosf) and scores the cell with cell_cost<false>, so the bits are the
// per-row terms' bits. The task's columns are read at t, coalesced, in
// the same wave as p4t[t]; the provider's columns are gathered at p only
// where the task's rules read them (each is a 32-byte sector at a random
// row): valid, price and load always; has_cpu and cpu_cores where the task
// requires a CPU; ram_mb, storage_gb where it sets a minimum; the GPU
// columns where it has a GPU option; has_location, lat, lon where it is
// located. A field left unread takes a value the rule that reads it
// ignores, so compat and cell_terms see the bits they would have seen.
// Every load of a thread depends on p4t[t] or on nothing, so a thread's
// gathers are in flight together, and the grid holds every pair at once
// at stage S's 100,000.
//
// What bounds them on the H100: operations. The feasibility launch
// checks P x T cells, ~12 operations each, and writes 2 x P x T / 8 bytes
// of bitmap; the haversine (~30 more) runs only where the bracket above
// leaves the answer open, none of trace/synth.py's cells.
// A pass reads P x T / 8 bytes of bitmap and O(P + T) of rows, and does
// the ~30 operations of the cost plus the division, the add and the exp
// of the online sum-exp on each feasible cell only. K15 reads one task
// row and the needed part of one provider row per pair: bytes.
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

#include "bits.cuh"
#include "cell.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kTiny = 1e-30f;  // the reference's floor under the sum-exp
constexpr int kLanes = 32;
constexpr int kFeasWarps = 8;    // warps of a feasibility block
constexpr int kFeasThreads = kFeasWarps * 32;
constexpr int kTileWords = 8;    // task words a feasibility block stages
constexpr int kTileTasks = kTileWords * 32;
constexpr int kLaneProv = 2;     // providers a feasibility lane checks at once
constexpr int kBlockProv = kFeasWarps * 32 * kLaneProv;  // providers a feasibility block step
constexpr int kRowPad = kTileWords + 1;       // a staged provider's words, padded (banks)
constexpr int kColPad = kBlockProv / 32 + 1;  // a staged task's words, padded
constexpr int kStageBytes = (kBlockProv * kRowPad + kTileTasks * kColPad) * 4;
constexpr float kFarKm = 20016.0f;  // at or above every distance cell_terms gives
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

struct FeasArgs {
  Prov prov;
  Req req;
  Aux aux;
  float proximity;
  int P, T, K, W;
  int p_split;  // providers a blockIdx.y takes, a multiple of a warp step
  uint32_t* row_bits;
  uint32_t* col_bits;
  uint32_t* rows;
  uint32_t* cols;
};

// The exact predicate of a compatible cell, out of line: the haversine's
// code (sinf's slow path among it) stays out of the check's loop.
__device__ __noinline__ bool exact_feasible(const ProvRow& p, const float4& t, bool t_loc,
                                            float proximity) {
  return cell_terms(p.base, p.lat, p.lon, p.coslat, p.has_loc, t.x, t.y, t.z, t_loc, t.w,
                    proximity) < kHalfInfeasible;
}

// Which of a lane's kN compatible cells f (bit h: provider h) against task
// row t are feasible: the bracket on every one, then the exact cost on the
// cells it leaves open (see the head comment), the one divergent branch.
template <int kN>
__device__ __forceinline__ uint32_t cost_feasible(uint32_t f, const ProvRow* p, const float* b0,
                                                  const float* blo, const float* bhi,
                                                  const float4& t, float proximity) {
  const bool t_loc = t.z != kNoLoc;
  uint32_t sure = 0u, open = 0u;
#pragma unroll
  for (int h = 0; h < kN; ++h) {
    const float lo = __fsub_rn(t_loc ? blo[h] : b0[h], t.w);
    const float hi = __fsub_rn(t_loc ? bhi[h] : b0[h], t.w);
    sure |= (hi < kHalfInfeasible ? 1u : 0u) << h;
    open |= (!(hi < kHalfInfeasible) && !(lo >= kHalfInfeasible) ? 1u : 0u) << h;
  }
  open &= f;
  if (open) {
#pragma unroll
    for (int h = 0; h < kN; ++h)
      if (((open >> h) & 1u) && exact_feasible(p[h], t, t_loc, proximity)) sure |= 1u << h;
  }
  return f & sure;
}

// kN providers a lane (a warp step of 32 kN providers).
template <int kN>
__global__ void __launch_bounds__(kFeasThreads, 3) feasibility_kernel(const FeasArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  RowCaps* s_caps = reinterpret_cast<RowCaps*>(smem);
  float4* s_terms = reinterpret_cast<float4*>(smem + kTileTasks * sizeof(RowCaps));
  OptCaps* s_opt = reinterpret_cast<OptCaps*>(smem + kTileTasks * (sizeof(RowCaps) +
                                                                   sizeof(float4)));
  // a block step's words, staged to be written whole: [kBlockProv][kRowPad]
  // row words, then [kTileTasks][kColPad] column words
  uint32_t* s_rows = reinterpret_cast<uint32_t*>(
      smem + kTileTasks * (sizeof(RowCaps) + sizeof(float4) + a.K * sizeof(OptCaps)));
  uint32_t* s_cols = s_rows + kBlockProv * kRowPad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * kTileTasks;
  const int n_t = min(kTileTasks, a.T - t0);
  const int WT = (a.T + 31) >> 5, WP = (a.P + 31) >> 5;
  for (int j = threadIdx.x; j < n_t; j += kFeasThreads) {
    const TaskRow tr = load_task(a.req, a.aux, t0 + j, a.K);
    s_caps[j] = load_row_caps(tr);
    s_terms[j] = make_float4(tr.lat, tr.lon, tr.has_loc ? tr.coslat : kNoLoc, tr.prio);
  }
  for (int e = threadIdx.x; e < n_t * a.K; e += kFeasThreads)
    s_opt[e] = load_opt(a.req, t0 * a.K + e);
  __syncthreads();
  // the bracket's ends of a located cell; NaN (every located cell exact)
  // where the proximity is not finite
  const float far = __fmul_rn(a.proximity, kFarKm);
  const bool finite_prox = isfinite(a.proximity);
  const float near_lo = finite_prox ? fminf(0.0f, far) : NAN;
  const float near_hi = finite_prox ? fmaxf(0.0f, far) : NAN;
  const int p_lo = blockIdx.y * a.p_split;
  const int p_hi = min(a.P, p_lo + a.p_split);
  constexpr int kStep = 32 * kN;
  static_assert(kStep * kFeasWarps == kBlockProv, "a block step is every warp's step");
  const int tw0 = t0 >> 5;
  const int n_tw = min(kTileWords, WT - tw0);  // the block's task words
  uint32_t col_acc[kTileWords];  // OR of this warp's column words, a task word each
#pragma unroll
  for (int i = 0; i < kTileWords; ++i) col_acc[i] = 0u;
  for (int pb = p_lo; pb < p_hi; pb += kBlockProv) {
    const int p0 = pb + warp * kStep;
    if (p0 < p_hi) {  // warp-uniform
      ProvRow pr[kN];
      float b0[kN], blo[kN], bhi[kN];
      uint32_t valid = 0u;
#pragma unroll
      for (int h = 0; h < kN; ++h) {
        const int p = p0 + 32 * h + lane;
        valid |= (p < p_hi ? 1u : 0u) << h;
        pr[h] = load_prov(a.prov, a.aux, p < p_hi ? p : 0);
        b0[h] = __fadd_rn(pr[h].base, 0.0f);
        blo[h] = pr[h].has_loc ? __fadd_rn(pr[h].base, near_lo) : b0[h];
        bhi[h] = pr[h].has_loc ? __fadd_rn(pr[h].base, near_hi) : b0[h];
      }
      uint32_t any = 0u;  // bit h: provider h has a feasible task among the block's
#pragma unroll
      for (int i = 0; i < kTileWords; ++i) {
        const int tw = (t0 >> 5) + i;
        if (tw >= WT) continue;  // warp-uniform
        uint32_t r[kN];
#pragma unroll
        for (int h = 0; h < kN; ++h) r[h] = 0u;
        const int jn = min(32, n_t - 32 * i);
        for (int j = 0; j < jn; ++j) {
          const int lt = 32 * i + j;
          uint32_t f = valid & compat_many<kN>(pr, s_caps[lt], s_opt + lt * a.K,
                                               a.req.gpu_model_mask +
                                                   (size_t)(t0 + lt) * a.K * a.W,
                                               a.K, a.W);
          f = cost_feasible<kN>(f, pr, b0, blo, bhi, s_terms[lt], a.proximity);
#pragma unroll
          for (int h = 0; h < kN; ++h) r[h] |= ((f >> h) & 1u) << j;
        }
#pragma unroll
        for (int h = 0; h < kN; ++h) {
          any |= (r[h] != 0u ? 1u : 0u) << h;
          const uint32_t c = transpose32(r[h], lane);
          col_acc[i] |= c;
          s_rows[(warp * kStep + 32 * h + lane) * kRowPad + i] = r[h];
          s_cols[(32 * i + lane) * kColPad + warp * kN + h] = c;
        }
      }
#pragma unroll
      for (int h = 0; h < kN; ++h) {
        const uint32_t b = __ballot_sync(kFull, (any >> h) & 1u);
        uint32_t* word = a.row_bits + (p0 >> 5) + h;
        // a stale read only costs an atomic that changes nothing
        if (lane == 0 && b != 0u && p0 + 32 * h < p_hi && (*word & b) != b) atomicOr(word, b);
      }
    }
    __syncthreads();
    // the step's words, consecutive threads on consecutive words: a
    // provider's kTileWords row words (32 bytes), a task's kBlockProv / 32
    // column words; a word of providers past p_hi or of tasks past T is
    // left to its block or not written
    for (int e = threadIdx.x; e < kBlockProv * kTileWords; e += kFeasThreads) {
      const int pp = e / kTileWords, w = e % kTileWords;
      if (pb + pp < p_hi && w < n_tw)
        a.rows[(size_t)(pb + pp) * WT + tw0 + w] = s_rows[pp * kRowPad + w];
    }
    for (int e = threadIdx.x; e < kTileTasks * (kBlockProv / 32); e += kFeasThreads) {
      const int tt = e / (kBlockProv / 32), w = e % (kBlockProv / 32);
      if (tt < n_t && pb + 32 * w < p_hi)
        a.cols[(size_t)(t0 + tt) * WP + (pb >> 5) + w] = s_cols[tt * kColPad + w];
    }
    __syncthreads();  // the stage is free for the next step
  }
#pragma unroll
  for (int i = 0; i < kTileWords; ++i) {
    const uint32_t b = __ballot_sync(kFull, col_acc[i] != 0u);
    const int tw = (t0 >> 5) + i;
    if (lane == 0 && b != 0u && tw < WT && (a.col_bits[tw] & b) != b)
      atomicOr(a.col_bits + tw, b);
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

// K15: a task's row with its terms computed here (no aux); the jitter key
// is unused (the pair cost is unjittered).
__device__ __forceinline__ TaskRow pair_task(const Req& R, const Weights& w, int t, int K) {
  TaskRow r;
  r.jkey = (uint32_t)t;
  r.cores = R.cpu_cores[t];
  r.ram = R.ram_mb[t];
  r.storage = R.storage_gb[t];
  r.cpu_required = R.cpu_required[t] != 0;
  bool any = false;
  for (int k = 0; k < K; ++k) any |= R.gpu_opt_valid[t * K + k] != 0;
  r.any_opt = any;
  r.has_loc = R.has_location[t] != 0;
  r.valid = R.valid[t] != 0;
  r.lat = R.lat[t];
  r.lon = R.lon[t];
  r.coslat = r.has_loc ? cosf(r.lat) : 0.0f;  // read only where both sides are located
  r.prio = task_prio(w, R.priority[t]);
  return r;
}

// K15: provider p's row, gathered only where task t's rules read it (the
// comment at the top of this file); a field left unread is one its rule
// ignores: has_cpu / cores without cpu_required, ram / storage under an
// absent minimum (ge_min passes), the GPU fields without an option,
// has_loc false for an unlocated task (no distance term).
__device__ __forceinline__ ProvRow pair_prov(const Prov& P, const Weights& w, int p,
                                             const TaskRow& t) {
  ProvRow r;
  r.valid = P.valid[p] != 0;
  r.base = prov_base(w, P.price[p], P.load[p]);
  r.has_cpu = t.cpu_required ? P.has_cpu[p] != 0 : false;
  r.cores = t.cpu_required ? P.cpu_cores[p] : 0;
  r.ram = t.ram >= 0 ? P.ram_mb[p] : 0;
  r.storage = t.storage >= 0 ? P.storage_gb[p] : 0;
  r.has_gpu = t.any_opt ? P.has_gpu[p] != 0 : false;
  r.count = t.any_opt ? P.gpu_count[p] : 0;
  r.mem = t.any_opt ? P.gpu_mem_mb[p] : 0;
  r.model = t.any_opt ? P.gpu_model_id[p] : 0;
  r.has_loc = t.has_loc ? P.has_location[p] != 0 : false;
  r.lat = t.has_loc ? P.lat[p] : 0.0f;
  r.lon = t.has_loc ? P.lon[p] : 0.0f;
  r.coslat = r.has_loc ? cosf(r.lat) : 0.0f;
  return r;
}

__global__ void __launch_bounds__(kThreads) pair_cost_kernel(Prov prov, Req req, Weights w,
                                                             int T, int K, int W,
                                                             const int32_t* __restrict__ p4t,
                                                             float* __restrict__ out) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  const int p = p4t[t];
  const TaskRow tr = pair_task(req, w, t, K);
  if (p < 0) {
    out[t] = kInfeasible;
    return;
  }
  out[t] = cell_cost<false>(pair_prov(prov, w, p, tr), p, tr, t, req, K, W, w);
}

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

// K14 feasibility: row_bits [ceil(P/32)] and col_bits [ceil(T/32)] u32
// (zero on entry: bit j of word w set where row / column 32w + j has a
// feasible cell), rows [P][ceil(T/32)] u32 and cols [T][ceil(P/32)] u32
// (every word written). The grid: a block a 256-task tile by as many
// provider ranges (multiples of 64, at least 2,048 providers each) as
// bring the blocks to about four times what the card keeps resident.
extern "C" int k14_feasibility(const void* const* prov_cols, const void* const* req_cols, int P,
                               int T, int K, int W, float w_price, float w_load, float w_prox,
                               float w_prio, float* aux, uint32_t* row_bits, uint32_t* col_bits,
                               uint32_t* rows, uint32_t* cols, void* stream) {
  if (P < 1 || T < 1 || K < 0 || K > kMaxOpts || W < 0) return (int)cudaErrorInvalidValue;
  const int smem =
      kTileTasks * (int)(sizeof(RowCaps) + sizeof(float4) + K * sizeof(OptCaps)) + kStageBytes;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(feasibility_kernel<kLaneProv>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, feasibility_kernel<kLaneProv>,
                                                        kFeasThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const int gx = (T + kTileTasks - 1) / kTileTasks;
  const long long want = 4LL * max(1, n_sm * per_sm);
  int gy = (int)min((long long)(P + 2047) / 2048, (want + gx - 1) / gx);
  gy = max(1, gy);
  constexpr int kStep = 32 * kLaneProv;
  const int p_split = (((P + gy - 1) / gy) + kStep - 1) / kStep * kStep;
  gy = (P + p_split - 1) / p_split;
  const Weights w{w_price, w_load, w_prox, w_prio};
  FeasArgs fa;
  fa.prov = make_prov(prov_cols);
  fa.req = make_req(req_cols);
  fa.aux = make_aux(aux, P, T);
  fa.proximity = w_prox;
  fa.P = P;
  fa.T = T;
  fa.K = K;
  fa.W = W;
  fa.p_split = p_split;
  fa.row_bits = row_bits;
  fa.col_bits = col_bits;
  fa.rows = rows;
  fa.cols = cols;
  launch_prep(fa.prov, fa.req, w, P, T, aux, (cudaStream_t)stream);
  feasibility_kernel<kLaneProv><<<dim3((unsigned)gx, (unsigned)gy), kFeasThreads, smem,
                       (cudaStream_t)stream>>>(fa);
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
// p4t[t] < 0 (every p4t[t] < P, which the wrapper checks): one launch.
extern "C" int k15_pair_cost(const void* const* prov_cols, const void* const* req_cols, int P,
                             int T, int K, int W, float w_price, float w_load, float w_prox,
                             float w_prio, const int32_t* p4t, float* out, void* stream) {
  if (P < 1 || T < 1 || K > kMaxOpts) return (int)cudaErrorInvalidValue;
  const Weights w{w_price, w_load, w_prox, w_prio};
  pair_cost_kernel<<<(T + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      make_prov(prov_cols), make_req(req_cols), w, T, K, W, p4t, out);
  return (int)cudaGetLastError();
}
