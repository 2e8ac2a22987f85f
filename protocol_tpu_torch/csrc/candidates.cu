// K1: the candidate kernel for Hopper (sm_90a).
//
// Replaces the reference's candidate scan (protocol_tpu/ops/sparse.py:
// _forward_tile_select and the reverse step and carry of
// candidates_topk_reverse), over compat_mask (ops/encoding.py),
// cost_matrix and tie_jitter (ops/cost.py). The reference streams
// [P, tile] cost blocks through XLA and feeds both selections from each;
// here every (provider, task) cell is scored once, in registers, by the
// functions of cell.cuh, and the [P, T] block never reaches device memory.
//
// One kernel template, k1_kernel<kFwd, kRev, kBias, kMulti>, in three
// launches:
//   bidir    (k1_bidir, kFwd and kRev) the cold pass: each task's k
//            cheapest providers and each provider's per-tile best tasks
//            from the same scored cells, then a fold launch (below);
//   rows     (k1_forward_rows, kFwd) the forward selection for a list of
//            global task ids (the warm repair's dirty rows, the cache's
//            delta rows, the matcher's phases) and, with a [P] bias, the
//            blocked Sinkhorn's biased rounding (kBias);
//   reverse  (k1_reverse, kRev) the reverse selection alone (the cache's
//            uncovered rows, the matcher's colocation phase at rt > 1).
// Six list launches of a second kernel template, list_kernel<kMode>:
//   blocks   (k1_reverse_blocks; replaces parallel/sparse.py
//            _build_repair_tile at rt = 1) rescores flagged (provider,
//            tile) blocks into the pools in place, each block's first
//            argmin as its least (cost, task) key;
//   K4       (k4_repair_tile_min; replaces the dirty-column cost block of
//            _build_repair_forward, reduced to per-(provider, tile) minima
//            on the host there) the least fresh cost of each provider over
//            each tile's dirty tasks;
//   K3       (k3_repair_enter; replaces parallel/sparse.py
//            _build_repair_enter, and at a jitter offset a shard's part of
//            _build_repair_enter_sharded) flags each task that some dirty
//            provider's fresh jittered cost can enter: c <= the task's
//            stored k-th cost and c < INFEASIBLE/2;
//   K10      (k10_cost_block; replaces sched/tpu_backend.py _cost_only,
//            the unjittered cost_matrix of the matcher's phases 0 and 0.5
//            and the greedy and sinkhorn RPCs) the slot-major [T, P] cost
//            block;
//   K6       (k6_value_base; replaces sched/tpu_backend.py _solve_bounded's
//            cost_matrix + with_tie_jitter and the value_base /
//            task_feasible of ops/assign.py assign_auction) the dense
//            auction's slot-major [T, P] value rows and each slot's
//            feasibility;
//   K8       (k8_unbounded_best; replaces sched/tpu_backend.py
//            _solve_unbounded) each provider's first argmin over the tasks
//            of the unjittered cost.
// The first three run the warm repair (parallel/sparse.py:
// repair_topk_bidir). All hold a block's providers fixed and stream task
// rows past them; the check and the scoring of a warp's step are
// k1_kernel's (score_step, unjittered for K10 and K8).
//
// Layout. A block is kWarps warps in G groups of S warps (G * S = kWarps,
// S <= 2); a group owns rw <= 8 task rows, staged once in shared memory
// with their per-row terms, jitter key, limits and GPU options; its S
// warps split the providers. The block streams the providers in chunks
// of kChunk staged in shared memory; a lane takes two providers of a
// 64-provider step and walks its warp's rows. Per step:
//   1. the capability check per (row, provider) cell (compat_many: compat's
//      rules with each row's limits loaded once for both providers);
//      infeasible cells cost exactly INFEASIBLE, feasible ones are queued
//      per warp at a warp scan of the lanes' counts;
//   2. the queued cells are scored one a lane (cell_terms and the jitter,
//      feasible_cost), so the haversine never runs on a warp whose lanes
//      are mostly infeasible;
//   3. selection: forward, a cell whose selection value is at most its
//      row's threshold (the k-th key's value) is pushed with its key into
//      the row's buffer (ballot, no atomics); a full buffer is merged into
//      the row's sorted top-k by rank (every key is unique, so each
//      entry's place is the count of keys below it), and the k-th key
//      gives the new threshold, so once it settles almost no step admits
//      a cell and the warp skips its ballots. Reverse, each lane keeps the
//      least (or, at rt > 1, the stable top-rt) key of its provider over
//      the warp's rows, which lie in one tile (rw divides the tile); the
//      block's warps are combined per provider in shared memory and
//      flushed to a [P, n_tiles * rt] key buffer with 64-bit atomicMin
//      (at rt > 1 a cascade: the displaced key moves on to the next slot),
//      which keeps the rt least keys of every block in any order. The fold
//      launch decodes the buffer into the pools and folds them per provider
//      with fold_pools, the carry winning ties, as before.
//
// Keys. A selection is a function of unique 64-bit keys: forward (cost,
// provider), or on the biased path (selection, provider) with selection =
// cost + bias[p] on the cells below INFEASIBLE/2; reverse (cost, task).
// The float goes to the high word through order_bits (sign bit set on a
// non-negative float, every bit flipped on a negative one), so unsigned
// order is float order, then the lower index. order_bits is a bijection:
// the written costs and selections are decoded from the keys bit for bit;
// the biased path rescores its k winners for their true costs. It orders
// -0 before +0, where the parent's `<` held them equal; no K1 key is -0:
// a feasible cost below INFEASIBLE/2 gets + jitter with jitter >= +0, and
// in round-to-nearest -0 + (+0) = +0, a larger cost is positive, an
// infeasible cell is 1e9; so a selection c + bias[p] is -0 only for c = -0.
// With unique keys any order of scoring gives the same selections, which
// are the parent's at every weight. NaN costs follow the reference: the
// forward selection (lax.top_k) and the reverse at rt > 1 put NaN cells
// last, where a NaN's key lies (a NaN cell is never admitted, and a row
// with fewer than k other cells ends with (-1, NaN) places); the reverse
// at rt = 1 (an argmin, which returns a row's first NaN) keys a NaN cell
// below every cost (rev_key), and the fold never takes a NaN into a list.
// The blocks launch keys only cells
// below +inf, the parent's strict `<` from +inf (no NaN or +inf cell
// wins; a block without a key decodes to (+inf, -1), as before), so its
// key order over a tile's cells is `<` with the lowest task first among
// ties, the first argmin, however the cells are split. K8 keys the cells
// below INFEASIBLE/2, with -0 folded to +0 first (the unjittered cost can
// be -0, and the reference's argmin holds -0 and +0 equal and takes the
// lower task), and every NaN cell as kNanKey, 0, below every real key
// (order_bits(-inf) is 0x007fffff): the reference's argmin returns a row's
// first NaN, whose cost then fails its test, so a provider with a NaN cell
// decodes to -1, as does one without a key. An incompatible cell is
// INFEASIBLE, never NaN; -inf is a real cost and keeps its task. K4 needs no key:
// fminf from the pad is exact in any order of the cells, as no cost is -0
// and fminf passes over a NaN as the parent's did. Nor do K3 and K6's
// feasibility, ORs of per-cell tests (a NaN cost or threshold flags
// nothing), and K10 and K6's rows, which store each cell once.
//
// What bounds it on the H100: operations. Every cell pays the capability
// check, a feasible cell (22% at the main path's 65,536^2) the haversine
// (two sinf, an asinf, an IEEE square root); the inputs are O(P + T)
// bytes and the outputs O(T k + P n_tiles). The design keeps loads off
// the per-cell path (providers staged a chunk a block, each row's limits
// and options loaded once for two providers as warp-uniform broadcasts,
// an absent limit folded into one compare), packs the feasible cells
// across the lanes, scores every cell once for both directions, and
// admits into the forward select only the cells that reach the
// threshold. Measured by clock64 probes at the kernel's phase markers: the
// check still takes the largest share of the fused launch's cycles, then
// the scoring and the selection, then the block barrier of a chunk. The
// list launches are bound the same way over far fewer cells (their work
// is the flagged blocks', the dirty rows' or the dirty providers' cells;
// K10's and K6's, every cell of a gathered block, whose 4 bytes a cell
// stored take ~5% of K10's time at 4,096^2; K8's, every cell of a gathered
// block, with a key a provider flushed a block); the kernels they replaced
// walked a block's (or a provider's, or a task's) cells one at a time a
// thread, thousands of cycles a cell with few warps an SM, so a launch
// lasted one thread's walk, or scored each cell in a thread of its own
// from unstaged rows (K10, K6). A list launch spreads the cells over 16 or
// 32 blocks of 4 warps an SM (list_target) and pays K1's check and
// scoring.
//
// Numerics: built with -fmad=false and no fast-math, so every f32
// operation rounds once, in the reference's order, as torch's eager ops
// do. With proximity 0 the cost involves no transcendental and the
// outputs are bit-identical to the plain torch version.

#include <climits>

#include "cell.cuh"

namespace {

using u64 = unsigned long long;

constexpr int kWarps = 4;             // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = kThreads;      // providers staged a chunk: one a thread
constexpr int kStep = 64;             // providers a warp step: two a lane
constexpr int kSub = kChunk / kStep;  // steps a chunk (a group splits over at most kSub warps)
constexpr int kMaxRows = 8;           // task rows a warp group
constexpr int kCap = 32;              // a row's admission buffer: one push of up to 32
constexpr u64 kNoKey = ~0ull;         // above every key (provider and task ids < 2^31)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t order_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float order_float(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ u64 make_key(float f, uint32_t idx) {
  return ((u64)order_bits(f) << 32) | idx;
}

// A reverse key of cell (cost c, task t). At rt = 1 the reference takes
// each tile's argmin, which returns the row's first NaN, so the key's high
// word is order_bits(c) + 1 (mod 2^32): the card's NaN, 0x7fffffff, whose
// order_bits is 0xffffffff, becomes 0, below every cost (the largest
// other, +inf's, is 0xff800000, and -inf's + 1 is 0x00800000), at one add
// a cell; the order of the costs is kept. rev_cost decodes it. At rt > 1
// the reference takes lax.top_k of the negated costs, which puts a NaN
// last, as order_bits does.
template <bool kMulti>
__device__ __forceinline__ u64 rev_key(float c, uint32_t t) {
  return ((u64)(order_bits(c) + (kMulti ? 0u : 1u)) << 32) | t;
}

// A reverse key's cost: the NaN of a high word 0 at rt = 1, else the cost.
template <bool kMulti>
__device__ __forceinline__ float rev_cost(u64 x) {
  const uint32_t hi = (uint32_t)(x >> 32);
  if (kMulti) return order_float(hi);
  return hi == 0 ? __int_as_float(0x7fffffff) : order_float(hi - 1u);
}

// Keys of a sorted list below x: its place in the list.
__device__ __forceinline__ int count_below(const u64* list, int n, u64 x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (list[mid] < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Insert x into an ascending list of rt keys, dropping the largest.
template <bool kMulti>
__device__ __forceinline__ void insert_key(u64* best, u64 x, int rt) {
  if constexpr (!kMulti) {
    best[0] = x < best[0] ? x : best[0];
  } else {
#pragma unroll
    for (int e = 0; e < kMaxR; ++e) {
      if (e < rt) {
        const u64 lo = x < best[e] ? x : best[e];
        x = x < best[e] ? best[e] : x;
        best[e] = lo;
      }
    }
  }
}

// Shared memory of a block, carved from one dynamic allocation (16-byte
// aligned regions). Per-warp regions are indexed by the warp.
struct K1Smem {
  int prov, bias, task, tid, caps, opt, ctile, queue, list, buf, tmp, thr, nlist, nbuf, rev,
      bytes;
};

__host__ __device__ inline int k1_take(int& at, int bytes) {
  const int o = at;
  at += (bytes + 15) & ~15;
  return o;
}

__host__ __device__ inline K1Smem k1_smem(bool fwd, bool rev, bool bias, int k, int rt, int K) {
  K1Smem s;
  int at = 0;
  const int fw = fwd ? kWarps : 0;
  s.prov = k1_take(at, kChunk * (int)sizeof(ProvRow));
  s.bias = k1_take(at, bias ? kChunk * 4 : 0);
  s.task = k1_take(at, kWarps * kMaxRows * (int)sizeof(TaskRow));
  s.tid = k1_take(at, kWarps * kMaxRows * 4);
  s.caps = k1_take(at, kWarps * kMaxRows * (int)sizeof(RowCaps));     // the rows' limits
  s.opt = k1_take(at, kWarps * kMaxRows * K * (int)sizeof(OptCaps));  // the rows' GPU options
  s.ctile = k1_take(at, kWarps * kMaxRows * kStep * 4);  // a warp's costs [row][provider]
  s.queue = k1_take(at, kWarps * kMaxRows * kStep * 2);  // a warp's feasible cells
  s.list = k1_take(at, fw * kMaxRows * k * 8);          // sorted top-k [warp][row][k]
  s.buf = k1_take(at, fw * kMaxRows * kCap * 8);        // admitted keys [warp][row][kCap]
  s.tmp = k1_take(at, fw * k * 8);                      // a merge's output [warp][k]
  s.thr = k1_take(at, fw * kMaxRows * 4);               // admission thresholds
  s.nlist = k1_take(at, fw * kMaxRows * 4);
  s.nbuf = k1_take(at, fw * kMaxRows * 4);
  s.rev = k1_take(at, rev ? kWarps * kChunk * rt * 8 : 0);  // [group][provider][rt]
  s.bytes = at;
  return s;
}

// Merge a row's nb admitted keys (unsorted) into its sorted list of nl:
// every key's place in the merged order is the count of keys below it in
// both (keys are unique), and the first k places are kept. The k-th key's
// value becomes the row's threshold. All 32 lanes call it together.
__device__ void merge_row(u64* list, int* nlist, const u64* buf, int nb, u64* tmp, float* thr,
                          int k, int lane) {
  const int nl = *nlist;
  const u64 l0 = lane < nl ? list[lane] : kNoKey;
  const u64 l1 = lane + 32 < nl ? list[lane + 32] : kNoKey;
  const u64 b0 = lane < nb ? buf[lane] : kNoKey;
  const u64 b1 = lane + 32 < nb ? buf[lane + 32] : kNoKey;
  int pl0 = lane, pl1 = lane + 32, pb0 = 0, pb1 = 0;
  for (int y = 0; y < nb; ++y) {
    const u64 v = buf[y];
    pl0 += v < l0;
    pl1 += v < l1;
    pb0 += v < b0;
    pb1 += v < b1;
  }
  for (int y = 0; y < nl; ++y) {
    const u64 v = list[y];
    pb0 += v < b0;
    pb1 += v < b1;
  }
  if (lane < nl && pl0 < k) tmp[pl0] = l0;
  if (lane + 32 < nl && pl1 < k) tmp[pl1] = l1;
  if (lane < nb && pb0 < k) tmp[pb0] = b0;
  if (lane + 32 < nb && pb1 < k) tmp[pb1] = b1;
  __syncwarp();
  const int nn = min(k, nl + nb);
  for (int a = lane; a < nn; a += 32) list[a] = tmp[a];
  __syncwarp();
  if (lane == 0) {
    *nlist = nn;
    *thr = nn == k ? order_float((uint32_t)(list[k - 1] >> 32)) : INFINITY;
  }
  __syncwarp();
}

// Steps 1 and 2 of a warp over nact <= kMaxRows staged task rows (their
// limits caps[j], options opt[j * K ...], ids tid[j], terms task[j]) and a
// 64-provider step, two a lane: pr[h] is provider lane + 32 h of the step,
// sprov[l] its row for the scoring and pid(l) its global id, bit h of
// valid whether it exists. Writes ctile[j * kStep + l] for every existing
// cell: INFEASIBLE off the mask, else the exact cost, jittered when
// kJitter (K10 scores without). The check runs per (row, lane) for both
// providers; the feasible cells are queued at a warp scan of the lanes'
// counts and scored one a lane.
template <bool kJitter = true, class PidFn>
__device__ __forceinline__ void score_step(const ProvRow (&pr)[2], uint32_t valid,
                                           const ProvRow* sprov, PidFn pid, const RowCaps* caps,
                                           const OptCaps* opt, const int* tid, const TaskRow* task,
                                           int nact, const Req& req, int K, int W,
                                           const Weights& w, float* ctile, uint16_t* queue,
                                           int lane) {
  // 1. the capability check, each row's fields and options loaded once
  // for both providers; bit 2j + h of fm: cell (j, h) feasible
  uint32_t fm = 0;
  for (int j = 0; j < nact; ++j) {
    const RowCaps tc = caps[j];
    const uint32_t f = valid & compat_many<2>(pr, tc, opt + j * K,
                                              req.gpu_model_mask + (size_t)tid[j] * K * W, K, W);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if ((valid & ~f) >> h & 1u) ctile[j * kStep + 32 * h + lane] = kInfeasible;
    fm |= f << (2 * j);
  }
  // the feasible cells into the warp's queue at a scan of the counts
  const int cnt = __popc(fm);
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  const int qn = __shfl_sync(kFull, incl, 31);
  int pos = incl - cnt;
  while (fm) {
    const int b = __ffs(fm) - 1;
    fm &= fm - 1;
    queue[pos++] = (uint16_t)((b >> 1) << 6 | (b & 1) << 5 | lane);
  }
  __syncwarp();
  // 2. score the queued cells, one a lane
  for (int e = lane; e < qn; e += 32) {
    const int en = queue[e];
    const int j = en >> 6, l = en & (kStep - 1);
    ctile[j * kStep + l] = feasible_cost<kJitter>(sprov[l], pid(l), task[j], w);
  }
  __syncwarp();
}

struct K1Args {
  Prov prov;
  Req req;
  Aux aux;
  Weights w;
  int P, T, K, W;
  const int32_t* t_ids;  // the rows' global task ids; null: row i is task i
  int n_rows;
  int rw, split;          // rows a warp group, warps a group (the providers' split)
  int k, tile, rt, n_pool;
  uint32_t offset;        // jitter offset, added to a task's key where its row is staged
  const float* bias;      // [P] selection bias (kBias)
  int32_t* out_p;         // [n_rows, k] (kFwd)
  float* out_c;
  u64* rkey;              // [P, n_pool] reverse keys, all ones before the launch (kRev)
};

// Flush a block's rt least reverse keys of provider p in tile ti into the
// key buffer: each key is min-exchanged down the tile's rt slots, the
// displaced one going on, so the slots end as the rt least keys of all
// blocks, ascending, whatever the order of the blocks.
template <bool kMulti>
__device__ __forceinline__ void flush_rev(const K1Args& a, int p, int ti, const u64* best) {
  u64* slot = a.rkey + (size_t)p * a.n_pool + (size_t)ti * a.rt;
  if constexpr (!kMulti) {
    atomicMin(slot, best[0]);
  } else {
#pragma unroll
    for (int e = 0; e < kMaxR; ++e) {
      if (e < a.rt) {
        u64 x = best[e];
        for (int s = 0; s < a.rt && x != kNoKey; ++s) {
          const u64 old = atomicMin(slot + s, x);
          x = old > x ? old : x;
        }
      }
    }
  }
}

template <bool kFwd, bool kRev, bool kBias, bool kMulti>
__global__ void __launch_bounds__(kThreads, 4) k1_kernel(const K1Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kR = kMulti ? kMaxR : 1;
  const K1Smem L = k1_smem(kFwd, kRev, kBias, a.k, a.rt, a.K);
  ProvRow* s_prov = reinterpret_cast<ProvRow*>(smem + L.prov);
  float* s_bias = reinterpret_cast<float*>(smem + L.bias);
  TaskRow* s_task = reinterpret_cast<TaskRow*>(smem + L.task);
  int* s_tid = reinterpret_cast<int*>(smem + L.tid);
  RowCaps* s_caps = reinterpret_cast<RowCaps*>(smem + L.caps);
  OptCaps* s_opt = reinterpret_cast<OptCaps*>(smem + L.opt);
  u64* s_list = reinterpret_cast<u64*>(smem + L.list);
  int* s_nlist = reinterpret_cast<int*>(smem + L.nlist);
  u64* s_rev = reinterpret_cast<u64*>(smem + L.rev);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t lt = (1u << lane) - 1u;
  float* ctile = reinterpret_cast<float*>(smem + L.ctile) + warp * kMaxRows * kStep;
  uint16_t* queue = reinterpret_cast<uint16_t*>(smem + L.queue) + warp * kMaxRows * kStep;
  u64* w_list = s_list + warp * kMaxRows * a.k;
  u64* w_buf = reinterpret_cast<u64*>(smem + L.buf) + warp * kMaxRows * kCap;
  u64* w_tmp = reinterpret_cast<u64*>(smem + L.tmp) + warp * a.k;
  float* w_thr = reinterpret_cast<float*>(smem + L.thr) + warp * kMaxRows;
  int* w_nlist = s_nlist + warp * kMaxRows;
  int* w_nbuf = reinterpret_cast<int*>(smem + L.nbuf) + warp * kMaxRows;

  const int groups = kWarps / a.split;
  const int g = warp / a.split, q = warp % a.split;
  const int row0 = blockIdx.x * groups * a.rw;  // the block's first row
  const int grow0 = row0 + g * a.rw;            // the group's first row
  const int nact = max(0, min(a.rw, a.n_rows - grow0));
  const TaskRow* w_task = s_task + g * a.rw;
  const int* w_tid = s_tid + g * a.rw;
  const RowCaps* w_caps = s_caps + g * a.rw;
  const OptCaps* w_opt = s_opt + g * a.rw * a.K;

  // the block's task rows and their GPU options, loaded once; the jitter
  // offset goes into the row's key
  for (int j = threadIdx.x; j < groups * a.rw; j += kThreads) {
    const int row = row0 + j;
    if (row < a.n_rows) {
      const int t = a.t_ids ? a.t_ids[row] : row;
      s_tid[j] = t;
      const TaskRow tr = load_task(a.req, a.aux, t, a.K, a.offset);
      s_task[j] = tr;
      s_caps[j] = load_row_caps(tr);
    }
  }
  for (int e = threadIdx.x; e < groups * a.rw * a.K; e += kThreads) {
    const int j = e / a.K, row = row0 + j;
    if (row < a.n_rows) {
      const int t = a.t_ids ? a.t_ids[row] : row;
      s_opt[e] = load_opt(a.req, t * a.K + e % a.K);
    }
  }
  if constexpr (kFwd) {
    if (lane < kMaxRows) {
      w_thr[lane] = INFINITY;
      w_nlist[lane] = 0;
      w_nbuf[lane] = 0;
    }
  }

  for (int cb = 0; cb < a.P; cb += kChunk) {
    __syncthreads();  // the last chunk's readers are done
    {
      const int p = cb + threadIdx.x;
      if (p < a.P) {
        s_prov[threadIdx.x] = load_prov(a.prov, a.aux, p);
        if constexpr (kBias) s_bias[threadIdx.x] = a.bias[p];
      }
    }
    __syncthreads();
    if (nact > 0) {
      for (int m = q; m < kSub; m += a.split) {
        // a lane's two providers: i0 and i0 + 32 of the chunk
        const int i0 = m * kStep + lane;
        bool pv[2];
        ProvRow pr[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          pv[h] = cb + i0 + 32 * h < a.P;
          pr[h] = s_prov[i0 + 32 * h];
        }
        const uint32_t valid = (pv[0] ? 1u : 0u) | (pv[1] ? 2u : 0u);
        const int p0 = cb + m * kStep;
        score_step(pr, valid, s_prov + m * kStep, [p0](int l) { return p0 + l; }, w_caps, w_opt,
                   w_tid, w_task, nact, a.req, a.K, a.W, a.w, ctile, queue, lane);
        // 3. selection. Forward: a cell is admitted when its selection
        // value is <= the row's threshold (the k-th key's value), which
        // takes in every cell whose key is below the k-th key; its key is
        // built then. Reverse: each lane keeps its providers' least (at rt
        // > 1 the rt least) (cost, task) keys over the warp's rows.
        u64 best[2][kR];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < kR; ++e) best[h][e] = kNoKey;
        float pb[2] = {0.0f, 0.0f};
        if constexpr (kBias) {
#pragma unroll
          for (int h = 0; h < 2; ++h) pb[h] = pv[h] ? s_bias[i0 + 32 * h] : 0.0f;
        }
        for (int j = 0; j < nact; ++j) {
          float c[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) c[h] = ctile[j * kStep + 32 * h + lane];
          if constexpr (kFwd) {
            const float th = w_thr[j];
            float sel[2];
            bool adm[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              sel[h] = c[h];
              if constexpr (kBias) sel[h] = c[h] < kHalfInfeasible ? __fadd_rn(c[h], pb[h]) : c[h];
              adm[h] = pv[h] && sel[h] <= th;
            }
            // once the threshold settles, few steps admit a cell
            if (__any_sync(kFull, adm[0] || adm[1])) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const uint32_t mk = __ballot_sync(kFull, adm[h]);
                if (mk) {
                  u64* buf = w_buf + j * kCap;
                  int nb = w_nbuf[j];
                  const int cnt = __popc(mk);
                  if (nb + cnt > kCap) {
                    merge_row(w_list + j * a.k, w_nlist + j, buf, nb, w_tmp, w_thr + j, a.k,
                              lane);
                    nb = 0;
                  }
                  if (adm[h])
                    buf[nb + __popc(mk & lt)] = make_key(sel[h], (uint32_t)(cb + i0 + 32 * h));
                  __syncwarp();
                  if (lane == 0) w_nbuf[j] = nb + cnt;
                  __syncwarp();
                }
              }
            }
          }
          if constexpr (kRev) {
            const uint32_t t = (uint32_t)w_tid[j];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (!pv[h]) continue;
              if constexpr (kMulti) {
                insert_key<true>(best[h], rev_key<true>(c[h], t), a.rt);
              } else {
                // the rows' tasks ascend, so a key is below the lane's least
                // exactly when its high word is: one 32-bit compare
                const u64 x = rev_key<false>(c[h], t);
                if ((uint32_t)(x >> 32) < (uint32_t)(best[h][0] >> 32)) best[h][0] = x;
              }
            }
          }
        }
        if constexpr (kRev) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (pv[h]) {
              u64* part = s_rev + ((size_t)g * kChunk + i0 + 32 * h) * a.rt;
#pragma unroll
              for (int e = 0; e < kR; ++e)
                if (e < a.rt) part[e] = best[h][e];
            }
          }
        }
      }
    }
    if constexpr (kRev) {
      // combine the groups' keys per provider, tile by tile, and flush
      __syncthreads();
      const int p = cb + threadIdx.x;
      if (p < a.P) {
        u64 cur[kR];
        int cur_tile = -1;
        for (int gg = 0; gg < groups; ++gg) {
          const int r0 = row0 + gg * a.rw;
          if (r0 >= a.n_rows) break;
          const int ti = r0 / a.tile;
          const u64* part = s_rev + ((size_t)gg * kChunk + threadIdx.x) * a.rt;
          if (ti != cur_tile) {
            if (cur_tile >= 0) flush_rev<kMulti>(a, p, cur_tile, cur);
            cur_tile = ti;
#pragma unroll
            for (int e = 0; e < kR; ++e) cur[e] = e < a.rt ? part[e] : kNoKey;
          } else {
            for (int e = 0; e < a.rt; ++e) insert_key<kMulti>(cur, part[e], a.rt);
          }
        }
        if (cur_tile >= 0) flush_rev<kMulti>(a, p, cur_tile, cur);
      }
    }
  }

  if constexpr (kFwd) {
    for (int j = 0; j < nact; ++j) {
      const int nb = w_nbuf[j];
      if (nb > 0) merge_row(w_list + j * a.k, w_nlist + j, w_buf + j * kCap, nb, w_tmp, w_thr + j,
                            a.k, lane);
    }
    __syncthreads();  // every warp of a group holds its lists
    // the group's S lists of row j merged by rank; warp q writes rows q, q + S, ...
    for (int j = q; j < nact; j += a.split) {
      const int row = grow0 + j;
      for (int s = 0; s < a.split; ++s) {
        const int ws = g * a.split + s;
        const u64* ls = s_list + (ws * kMaxRows + j) * a.k;
        const int ns = s_nlist[ws * kMaxRows + j];
        for (int e = lane; e < ns; e += 32) {
          const u64 x = ls[e];
          int rank = e;
          for (int s2 = 0; s2 < a.split; ++s2) {
            if (s2 == s) continue;
            const int w2 = g * a.split + s2;
            rank += count_below(s_list + (w2 * kMaxRows + j) * a.k, s_nlist[w2 * kMaxRows + j], x);
          }
          if (rank >= a.k) continue;
          const int pp = (int)(uint32_t)x;
          const float sel = order_float((uint32_t)(x >> 32));
          float c = sel;
          if constexpr (kBias)
            c = cell_cost(load_prov(a.prov, a.aux, pp), pp, w_task[j], w_tid[j], a.req, a.K, a.W,
                          a.w);
          a.out_p[(size_t)row * a.k + rank] = sel < kHalfInfeasible ? pp : -1;
          a.out_c[(size_t)row * a.k + rank] = c;
        }
      }
      // a row with fewer than k cells that are not NaN (every such cell is
      // admitted while its list is short): the rest of its k places are
      // NaN cells, which the plain stable sort puts last, at -1 (a NaN
      // fails the test against INFEASIBLE/2) and the card's NaN
      int n_all = 0;
      for (int s = 0; s < a.split; ++s) n_all += s_nlist[(g * a.split + s) * kMaxRows + j];
      for (int e = n_all + lane; e < a.k; e += 32) {
        a.out_p[(size_t)row * a.k + e] = -1;
        a.out_c[(size_t)row * a.k + e] = __int_as_float(0x7fffffff);
      }
    }
  }
}

// One thread per provider: decode its reverse keys (rev_key's, at rt > 1
// when multi) into the pools [P, n_pool] (tile order), then fold them into
// its best r from an (INFEASIBLE, -1) carry, the carry winning ties.
__global__ void __launch_bounds__(128) fold_kernel(const u64* __restrict__ rkey, int P,
                                                   int n_pool, int r, bool multi,
                                                   int32_t* pool_t, float* pool_c,
                                                   int32_t* __restrict__ rev_t,
                                                   float* __restrict__ rev_c) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const size_t base = (size_t)p * n_pool;
  for (int e = 0; e < n_pool; ++e) {
    const u64 x = rkey[base + e];
    pool_t[base + e] = (int32_t)(uint32_t)x;
    pool_c[base + e] = multi ? rev_cost<true>(x) : rev_cost<false>(x);
  }
  float rc[kMaxR];
  int32_t rv[kMaxR];
  fold_pools(pool_t, pool_c, base, n_pool, r, rc, rv);
#pragma unroll
  for (int i = 0; i < kMaxR; ++i) {
    if (i < r) {
      rev_c[(size_t)p * r + i] = rc[i];
      rev_t[(size_t)p * r + i] = rv[i];
    }
  }
}

// ---- the list launches: the repair's reverse blocks, K4, K3, K10, K6, K8 ----
//
// A block holds kListProv providers, 64 a warp (two a lane), for the whole
// launch, and streams task rows past them kMaxRows a step, staged once in
// shared memory for its 4 warps; each warp runs score_step on the step.
//   blocks (kListBlocks): the providers are a chunk of the flagged entries
//     of one tile (entries come ordered by tile, so a tile's are one run);
//     the rows are a slice of that tile. Each lane keeps the least (cost,
//     task) key of its two entries over the slice's cells with cost <
//     +inf (the parent's strict `<` from +inf: NaN and +inf never win),
//     and the slices meet in a [n_blocks] key buffer by 64-bit atomicMin;
//     a decode launch writes the pools, (+inf, -1) where no key came.
//   tile minima (K4, kListTileMin): the providers are P's kListProv-wide
//     chunks; the rows are a range of the dirty task ids cut at tile
//     boundaries, so a block sees every dirty task of its tiles. A lane
//     keeps a running fminf from the pad over the current tile
//     (warp-uniform: the ids ascend) and stores it when the tile changes.
//   enter (K3, kListEnter): the providers are a kListProv-wide chunk of
//     the dirty ids, the rows a contiguous range of the tasks, each with
//     its threshold staged beside its limits and its jitter keyed on row
//     + offset. A row's hit is one ballot over the lanes' (c <= th) & (c <
//     INFEASIBLE/2); the warps' hits meet in a shared word and the block
//     stores a 1 for each row hit, into enter zeroed before the launch.
//     Blocks of other chunks may store a 1 to the same row: equal bytes,
//     and the result an OR, exact in any order of the cells.
//   cost block (K10, kListCost): the providers are P's kListProv-wide
//     chunks, the rows a contiguous range of the slots, scored without
//     jitter; each warp stores its step's cells from its cost tile, a row
//     as two 128-byte runs of cost[t * P + p].
//   value rows (K6, kListValue): K10's providers and ranges, scored with
//     the jitter (keyed on the slot's row); each warp stores its step's
//     cells as K10 does, -c where c < INFEASIBLE/2, else -1e18, and a row's
//     feasibility is K3's hit: one ballot over the lanes' c < INFEASIBLE/2,
//     the warps met in the shared word, 1s stored into task_feasible
//     zeroed before the launch (an OR over the chunks' blocks).
//   unbounded best (K8, kListBest): K10's providers and ranges, scored
//     without jitter. Each lane keeps its two providers' least (cost, task)
//     key over the range's feasible cells, the cost with -0 folded to +0,
//     and a NaN cell's key kNanKey below them all; the ranges meet in a [P]
//     key buffer set to all ones before the launch, by 64-bit atomicMin,
//     and a decode launch writes the task, -1 where no key or kNanKey
//     came.
constexpr int kListProv = kWarps * kStep;  // providers (or flagged entries) a block
constexpr int kListBlocks = 0, kListTileMin = 1, kListEnter = 2, kListCost = 3, kListValue = 4,
              kListBest = 5;
constexpr float kNegValue = -1e18f;  // K6's value where the cost is >= INFEASIBLE/2 (_NEG)
constexpr u64 kNanKey = 0;           // K8: a NaN cell's key, below every real one

struct ListArgs {
  Prov prov;
  Req req;
  Aux aux;
  Weights w;
  int P, K, W, tile, n_tiles;
  // blocks: entries [blk_p, blk_j], lo[j] the first entry of tile j (lo
  // [n_tiles] = n_blocks), the slice's rows, the key buffer
  const int32_t* blk_p;
  const int32_t* blk_j;
  const int32_t* lo;
  int n_blocks, slice;
  u64* rkey;             // blocks: [n_blocks]; K8: [P]
  // K4: the ascending dirty ids, the ranges over them, the pad, the output
  const int32_t* t_ids;
  int n_t, ranges;
  float pad;
  float* min_tile;
  // K3, K10, K6 and K8: T rows in ranges of `slice`; the providers
  // p_ids[0, n_p) (K3) or 0..P-1 (the others, n_p = P)
  int T, n_p;
  const int32_t* p_ids;
  uint32_t offset;       // K3: the jitter offset
  const float* thresh;   // K3: [T]
  uint8_t* enter;        // K3: enter, K6: task_feasible; [T], zero before the launch
  float* cost;           // K10: the cost, K6: the value rows; [T, P]
};

struct ListSmem {
  int prov, pid, task, tid, caps, opt, tile, ctile, queue, th, bytes;
};

__host__ __device__ inline ListSmem list_smem(int K) {
  ListSmem s;
  int at = 0;
  s.prov = k1_take(at, kListProv * (int)sizeof(ProvRow));
  s.pid = k1_take(at, kListProv * 4);
  s.task = k1_take(at, kMaxRows * (int)sizeof(TaskRow));
  s.tid = k1_take(at, kMaxRows * 4);
  s.caps = k1_take(at, kMaxRows * (int)sizeof(RowCaps));
  s.opt = k1_take(at, kMaxRows * K * (int)sizeof(OptCaps));
  s.tile = k1_take(at, kMaxRows * 4);
  s.ctile = k1_take(at, kWarps * kMaxRows * kStep * 4);
  s.queue = k1_take(at, kWarps * kMaxRows * kStep * 2);
  s.th = k1_take(at, kMaxRows * 4 + 4);  // K3: the rows' thresholds, then the step's hits
  s.bytes = at;
  return s;
}

// The least index i' >= i of the ascending ids where a tile starts (0, n,
// or ids[i'] in another tile than ids[i' - 1]). All 32 lanes call it.
__device__ int tile_cut(const int32_t* ids, int n, int i, int tile, int lane) {
  if (i <= 0) return 0;
  if (i >= n) return n;
  const int prev = ids[i - 1] / tile;
  for (int base = i; base < n; base += 32) {
    const int k = base + lane;
    const uint32_t m = __ballot_sync(kFull, k < n && ids[k] / tile != prev);
    if (m) return base + __ffs(m) - 1;
  }
  return n;
}

// K3 and K6: a 1 into enter for each row of the step at row0 that some
// warp hit (bit j of *hits), and the word cleared for the next step. One
// thread.
__device__ __forceinline__ void flush_hits(uint32_t* hits, uint8_t* enter, int row0) {
  uint32_t m = *hits;
  *hits = 0;
  while (m) {
    const int j = __ffs(m) - 1;
    m &= m - 1;
    enter[row0 + j] = 1;
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 4) list_kernel(const ListArgs a) {
  constexpr bool kBlocks = kMode == kListBlocks;
  constexpr bool kRange = kMode >= kListEnter;  // rows [y slice, ...)
  constexpr bool kHits = kMode == kListEnter || kMode == kListValue;  // a row's OR of ballots
  constexpr bool kKeys = kBlocks || kMode == kListBest;  // a lane's least (cost, task) keys
  constexpr bool kJitter = kMode != kListCost && kMode != kListBest;  // K10 and K8 score without
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_range[4];
  const ListSmem L = list_smem(a.K);
  ProvRow* s_prov = reinterpret_cast<ProvRow*>(smem + L.prov);
  int* s_pid = reinterpret_cast<int*>(smem + L.pid);
  TaskRow* s_task = reinterpret_cast<TaskRow*>(smem + L.task);
  int* s_tid = reinterpret_cast<int*>(smem + L.tid);
  RowCaps* s_caps = reinterpret_cast<RowCaps*>(smem + L.caps);
  OptCaps* s_opt = reinterpret_cast<OptCaps*>(smem + L.opt);
  int* s_tile = reinterpret_cast<int*>(smem + L.tile);
  float* s_th = reinterpret_cast<float*>(smem + L.th);
  uint32_t* s_hits = reinterpret_cast<uint32_t*>(smem + L.th) + kMaxRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* ctile = reinterpret_cast<float*>(smem + L.ctile) + warp * kMaxRows * kStep;
  uint16_t* queue = reinterpret_cast<uint16_t*>(smem + L.queue) + warp * kMaxRows * kStep;

  // the block's providers [e0, e0 + ne) and rows [r0, r1)
  if (threadIdx.x == 0) {
    if constexpr (kBlocks) {
      // chunk c of tile j is block g(j) + c, g(j) = lo[j] / kListProv + j,
      // strictly increasing, g(0) = 0, g(n_tiles) = the grid's width
      int jl = 0, jh = a.n_tiles;
      while (jh - jl > 1) {
        const int mid = (jl + jh) >> 1;
        if (a.lo[mid] / kListProv + mid <= (int)blockIdx.x)
          jl = mid;
        else
          jh = mid;
      }
      const int b0 = a.lo[jl] + ((int)blockIdx.x - (a.lo[jl] / kListProv + jl)) * kListProv;
      const int r0 = blockIdx.y * a.slice;
      s_range[0] = b0;
      s_range[1] = max(0, min(kListProv, a.lo[jl + 1] - b0));
      s_range[2] = jl * a.tile + r0;                    // the slice's first task
      s_range[3] = min(a.slice, a.tile - r0);           // its rows
    }
    if constexpr (kRange) {
      const int r0 = blockIdx.y * a.slice;
      s_range[0] = blockIdx.x * kListProv;
      s_range[1] = min(kListProv, a.n_p - (int)blockIdx.x * kListProv);
      s_range[2] = r0;
      s_range[3] = min(a.slice, a.T - r0);
    }
    if constexpr (kHits) *s_hits = 0;
  }
  if constexpr (kMode == kListTileMin) {
    if (warp == 0) {
      const int n0 = (int)((long long)a.n_t * blockIdx.y / a.ranges);
      const int n1 = (int)((long long)a.n_t * (blockIdx.y + 1) / a.ranges);
      const int r0 = tile_cut(a.t_ids, a.n_t, n0, a.tile, lane);
      const int r1 = tile_cut(a.t_ids, a.n_t, n1, a.tile, lane);
      if (lane == 0) {
        s_range[0] = blockIdx.x * kListProv;
        s_range[1] = min(kListProv, a.P - (int)blockIdx.x * kListProv);
        s_range[2] = r0;
        s_range[3] = r1 - r0;
      }
    }
  }
  __syncthreads();
  const int e0 = s_range[0], ne = s_range[1], row0 = s_range[2], n_rows = s_range[3];
  if (ne <= 0 || n_rows <= 0) return;  // block-uniform

  for (int i = threadIdx.x; i < ne; i += kThreads) {
    const int p = kBlocks ? a.blk_p[e0 + i] : kMode == kListEnter ? a.p_ids[e0 + i] : e0 + i;
    s_pid[i] = p;
    s_prov[i] = load_prov(a.prov, a.aux, p);
  }
  const int i0 = warp * kStep + lane;  // the lane's entries i0 and i0 + 32
  const bool pv[2] = {i0 < ne, i0 + 32 < ne};
  const uint32_t valid = (pv[0] ? 1u : 0u) | (pv[1] ? 2u : 0u);
  const bool live = warp * kStep < ne;  // warp-uniform
  const int* w_pid = s_pid + warp * kStep;
  u64 best[2] = {kNoKey, kNoKey};  // blocks, K8
  float m[2] = {a.pad, a.pad};     // K4: the current tile's minimum
  int cur = -1;                    // K4: the current tile

  for (int rs = 0; rs < n_rows; rs += kMaxRows) {
    const int nact = min(kMaxRows, n_rows - rs);
    __syncthreads();  // the last step's readers are done
    if constexpr (kHits) {
      if (threadIdx.x == 0 && rs > 0) flush_hits(s_hits, a.enter, row0 + rs - kMaxRows);
    }
    for (int i = threadIdx.x; i < nact; i += kThreads) {
      const int t = kMode == kListTileMin ? a.t_ids[row0 + rs + i] : row0 + rs + i;
      s_tid[i] = t;
      const TaskRow tr = load_task(a.req, a.aux, t, a.K, kMode == kListEnter ? a.offset : 0u);
      s_task[i] = tr;
      s_caps[i] = load_row_caps(tr);
      if constexpr (!kRange) s_tile[i] = t / a.tile;
      if constexpr (kMode == kListEnter) s_th[i] = a.thresh[t];
    }
    for (int e = threadIdx.x; e < nact * a.K; e += kThreads) {
      const int i = e / a.K;
      const int t = kMode == kListTileMin ? a.t_ids[row0 + rs + i] : row0 + rs + i;
      s_opt[e] = load_opt(a.req, t * a.K + e % a.K);
    }
    __syncthreads();
    if (!live) continue;
    const ProvRow pr[2] = {s_prov[i0], s_prov[i0 + 32]};
    score_step<kJitter>(pr, valid, s_prov + warp * kStep, [w_pid](int l) { return w_pid[l]; },
                        s_caps, s_opt, s_tid, s_task, nact, a.req, a.K, a.W, a.w, ctile, queue,
                        lane);
    uint32_t hits = 0;  // K3, K6: bit j, row j hit by a lane of this warp
    for (int j = 0; j < nact; ++j) {
      float c[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) c[h] = ctile[j * kStep + 32 * h + lane];
      if constexpr (kKeys) {
        const uint32_t t = (uint32_t)s_tid[j];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // blocks: the cells below +inf; K8: the feasible cells, -0 as
          // +0, and every NaN cell as kNanKey
          const bool nan = !kBlocks && c[h] != c[h];
          const bool in = kBlocks ? c[h] < INFINITY : (c[h] < kHalfInfeasible) | nan;
          const u64 x =
              nan ? kNanKey : make_key(kBlocks ? c[h] : (c[h] == 0.0f ? 0.0f : c[h]), t);
          // the rows' tasks ascend, so a key is below the lane's least
          // exactly when its high word is: one 32-bit compare
          if (pv[h] && in && (uint32_t)(x >> 32) < (uint32_t)(best[h] >> 32)) best[h] = x;
        }
      } else if constexpr (kMode == kListTileMin) {
        const int tj = s_tile[j];
        if (tj != cur) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (cur >= 0 && pv[h]) a.min_tile[(size_t)(e0 + i0 + 32 * h) * a.n_tiles + cur] = m[h];
            m[h] = a.pad;
          }
          cur = tj;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) m[h] = fminf(m[h], c[h]);
      } else if constexpr (kMode == kListEnter) {
        const float th = s_th[j];
        bool hit = false;
#pragma unroll
        for (int h = 0; h < 2; ++h) hit |= pv[h] & (c[h] <= th) & (c[h] < kHalfInfeasible);
        hits |= (__ballot_sync(kFull, hit) != 0u ? 1u : 0u) << j;
      } else if constexpr (kMode == kListValue) {
        float* out = a.cost + (size_t)(row0 + rs + j) * a.P + e0 + i0;
        bool hit = false;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool ok = c[h] < kHalfInfeasible;
          hit |= pv[h] & ok;
          if (pv[h]) out[32 * h] = ok ? -c[h] : kNegValue;
        }
        hits |= (__ballot_sync(kFull, hit) != 0u ? 1u : 0u) << j;
      } else if constexpr (kMode == kListCost) {
        float* out = a.cost + (size_t)(row0 + rs + j) * a.P + e0 + i0;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (pv[h]) out[32 * h] = c[h];
      }
    }
    if constexpr (kHits) {
      if (lane == 0 && hits) atomicOr(s_hits, hits);
    }
  }
  if constexpr (kHits) {
    __syncthreads();  // every warp's hits of the last step are in
    if (threadIdx.x == 0) flush_hits(s_hits, a.enter, row0 + (n_rows - 1) / kMaxRows * kMaxRows);
    return;
  }
  if (!live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!pv[h]) continue;
    if constexpr (kKeys) {  // rkey by entry (blocks) or provider (K8)
      if (best[h] != kNoKey) atomicMin(a.rkey + e0 + i0 + 32 * h, best[h]);
    } else if constexpr (kMode == kListTileMin) {
      if (cur >= 0) a.min_tile[(size_t)(e0 + i0 + 32 * h) * a.n_tiles + cur] = m[h];
    }
  }
}

// One thread an entry: rkey[b] to all ones, and lo[j] (the first entry of
// tile j, entries ordered by tile; lo[n_tiles] = n) for every j in
// (blk_j[b - 1], blk_j[b]], and past the last entry's tile.
__global__ void __launch_bounds__(128) blocks_plan_kernel(const int32_t* __restrict__ blk_j, int n,
                                                          int n_tiles, int32_t* __restrict__ lo,
                                                          u64* __restrict__ rkey) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  rkey[b] = kNoKey;
  const int jb = blk_j[b];
  for (int j = b == 0 ? 0 : blk_j[b - 1] + 1; j <= jb; ++j) lo[j] = b;
  if (b == n - 1)
    for (int j = jb + 1; j <= n_tiles; ++j) lo[j] = n;
}

// One thread an entry: its key decoded into the pools at [p, j].
__global__ void __launch_bounds__(128) blocks_decode_kernel(const u64* __restrict__ rkey,
                                                            const int32_t* __restrict__ blk_p,
                                                            const int32_t* __restrict__ blk_j, int n,
                                                            int n_tiles, int32_t* __restrict__ pool_t,
                                                            float* __restrict__ pool_c) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  const u64 x = rkey[b];
  const size_t at = (size_t)blk_p[b] * n_tiles + blk_j[b];
  pool_t[at] = x == kNoKey ? -1 : (int32_t)(uint32_t)x;
  pool_c[at] = x == kNoKey ? INFINITY : order_float((uint32_t)(x >> 32));
}

// K8: one thread a provider, its key decoded into best[p]: the task, or -1
// where no feasible cell keyed it or a NaN cell did.
__global__ void __launch_bounds__(128) best_decode_kernel(const u64* __restrict__ rkey, int P,
                                                          int32_t* __restrict__ best) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const u64 x = rkey[p];
  best[p] = x == kNoKey || x == kNanKey ? -1 : (int32_t)(uint32_t)x;
}

// Blocks a list launch aims for: four times what the card holds at once
// (4 blocks an SM, the launch bound).
int list_target() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return 16 * sms;
}

ListArgs list_args(const void* const* prov_cols, const void* const* req_cols, int P, int T, int K,
                   int W, float w_price, float w_load, float w_prox, float w_prio, int tile,
                   float* aux) {
  ListArgs a{};
  a.prov = make_prov(prov_cols);
  a.req = make_req(req_cols);
  a.aux = make_aux(aux, P, T);
  a.w = Weights{w_price, w_load, w_prox, w_prio};
  a.P = P;
  a.K = K;
  a.W = W;
  a.tile = tile;
  a.n_tiles = T / tile;
  return a;
}

template <int kMode>
int run_list(const ListArgs& a, dim3 grid, cudaStream_t stream) {
  const int bytes = list_smem(a.K).bytes;
  cudaError_t e = cudaFuncSetAttribute(list_kernel<kMode>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  list_kernel<kMode><<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// K3, K10, K6 and K8: a.n_p providers in kListProv-wide chunks against
// a.T rows in ranges of a.slice (a multiple of kMaxRows), as many ranges
// as bring the launch to twice list_target blocks (at most one a step of
// rows): their blocks are shorter than the other list launches', and 32
// blocks an SM took 4-8% less than 16 at 65,536 x 655 and 4,096^2 (2% more
// on a 16,384-task shard). Few rows give one step a block (K8 at 1,024 or
// 64 tasks), which beat blocks of 16 or 32 rows (34 against 38-40 us for
// K8's list launch on an H100 80GB HBM3 at 700 W).
template <int kMode>
int run_range_list(ListArgs& a, cudaStream_t stream) {
  const int chunks = (a.n_p + kListProv - 1) / kListProv;
  const int max_ranges = (a.T + kMaxRows - 1) / kMaxRows;
  const int ranges = min(max_ranges, max(1, (2 * list_target() + chunks - 1) / chunks));
  a.slice = ((a.T + ranges - 1) / ranges + kMaxRows - 1) / kMaxRows * kMaxRows;
  const dim3 grid(chunks, (a.T + a.slice - 1) / a.slice);
  return run_list<kMode>(a, grid, stream);
}

template <bool kFwd, bool kRev, bool kBias, bool kMulti>
int run_k1(const K1Args& a, int blocks, cudaStream_t stream) {
  const int bytes = k1_smem(kFwd, kRev, kBias, a.k, a.rt, a.K).bytes;
  cudaError_t e = cudaFuncSetAttribute(k1_kernel<kFwd, kRev, kBias, kMulti>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  k1_kernel<kFwd, kRev, kBias, kMulti><<<blocks, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

K1Args k1_args(const void* const* prov_cols, const void* const* req_cols, int P, int T, int K,
               int W, float w_price, float w_load, float w_prox, float w_prio, float* aux) {
  K1Args a{};
  a.prov = make_prov(prov_cols);
  a.req = make_req(req_cols);
  a.aux = make_aux(aux, P, T);
  a.w = Weights{w_price, w_load, w_prox, w_prio};
  a.P = P;
  a.T = T;
  a.K = K;
  a.W = W;
  return a;
}

bool pow2_at_most(int x, int hi) { return x >= 1 && x <= hi && (x & (x - 1)) == 0; }

// The reverse side's arguments: rt tasks per tile (1 <= rt <= min(r,
// tile)), rw rows a warp (a power of two <= 8) dividing the tile.
int check_reverse(int P, int T, int K, int tile, int r, int rt, int rw) {
  if (P < 1 || r < 1 || r > kMaxR || K > kMaxOpts || tile < 1 || T % tile != 0 || rt < 1 ||
      rt > r || rt > tile || !pow2_at_most(rw, kMaxRows) || tile % rw != 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointer arrays hold the columns
// in the order of the port's _P_SPEC / _R_SPEC. Each returns the first
// refused launch's cudaError_t (0 = launched).
extern "C" int k1_limits(int* max_k, int* max_r, int* max_opts) {
  *max_k = kMaxK;
  *max_r = kMaxR;
  *max_opts = kMaxOpts;
  return 0;
}

// The forward selection for the n_rows global task ids t_ids: groups of rw
// rows (1, 2, 4 or 8), each walked by `split` warps (1 or 2) over a share
// of the providers, the jitter keyed on (id + offset) mod 2^32. With
// a [P] bias (not null) the selection is biased per provider and out_c
// holds the true costs; null takes the unbiased instantiation.
extern "C" int k1_forward_rows(const void* const* prov_cols, const void* const* req_cols, int P,
                               int T, int K, int W, float w_price, float w_load, float w_prox,
                               float w_prio, int k, const int32_t* t_ids, int n_rows, int rw,
                               int split, unsigned int offset, const float* bias, float* aux,
                               int32_t* out_p, float* out_c, void* stream) {
  if (k < 1 || k > kMaxK || K > kMaxOpts || k > P || n_rows < 1 ||
      !pow2_at_most(rw, kMaxRows) || !pow2_at_most(split, kSub))
    return (int)cudaErrorInvalidValue;
  K1Args a = k1_args(prov_cols, req_cols, P, T, K, W, w_price, w_load, w_prox, w_prio, aux);
  a.t_ids = t_ids;
  a.n_rows = n_rows;
  a.rw = rw;
  a.split = split;
  a.k = k;
  a.tile = 1;
  a.rt = 1;
  a.offset = offset;
  a.bias = bias;
  a.out_p = out_p;
  a.out_c = out_c;
  const cudaStream_t st = (cudaStream_t)stream;
  launch_prep(a.prov, a.req, a.w, P, T, aux, st);
  const int rows_a_block = kWarps / split * rw;
  const int blocks = (n_rows + rows_a_block - 1) / rows_a_block;
  return bias == nullptr ? run_k1<true, false, false, false>(a, blocks, st)
                         : run_k1<true, false, true, false>(a, blocks, st);
}

// The reverse selection alone: each tile's rt least (cost, task) keys per
// provider (1 <= rt <= min(r, tile)) into rkey [P, n_tiles * rt], the
// pools decoded from it [P, n_tiles * rt] in tile order, and the fold into
// rev [P, r]; rw rows a warp (a power of two <= 8 dividing the tile), the
// jitter keyed on (task id + offset) mod 2^32. Fewer pool entries than r
// (a shard of the provider mesh holds few tiles) leave the carry's
// (INFEASIBLE, -1) entries in place, as the reference's fold does.
extern "C" int k1_reverse(const void* const* prov_cols, const void* const* req_cols, int P,
                          int T, int K, int W, float w_price, float w_load, float w_prox,
                          float w_prio, int tile, int r, int rt, int rw, unsigned int offset,
                          float* aux, u64* rkey, int32_t* pool_t, float* pool_c, int32_t* rev_t,
                          float* rev_c, void* stream) {
  if (int rc = check_reverse(P, T, K, tile, r, rt, rw)) return rc;
  K1Args a = k1_args(prov_cols, req_cols, P, T, K, W, w_price, w_load, w_prox, w_prio, aux);
  a.n_rows = T;
  a.rw = rw;
  a.split = 1;
  a.tile = tile;
  a.rt = rt;
  a.n_pool = T / tile * rt;
  a.offset = offset;
  a.rkey = rkey;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(rkey, 0xff, (size_t)P * a.n_pool * sizeof(u64), st);
  if (e != cudaSuccess) return (int)e;
  launch_prep(a.prov, a.req, a.w, P, T, aux, st);
  const int blocks = (T + kWarps * rw - 1) / (kWarps * rw);
  const int rc = rt == 1 ? run_k1<false, true, false, false>(a, blocks, st)
                         : run_k1<false, true, false, true>(a, blocks, st);
  if (rc) return rc;
  fold_kernel<<<(P + 127) / 128, 128, 0, st>>>(rkey, P, a.n_pool, r, rt > 1, pool_t, pool_c,
                                               rev_t, rev_c);
  return (int)cudaGetLastError();
}

// The cold pass in one launch: every task's forward top-k (fwd [T, k]) and
// the reverse pools and fold of k1_reverse, each cell scored once.
extern "C" int k1_bidir(const void* const* prov_cols, const void* const* req_cols, int P, int T,
                        int K, int W, float w_price, float w_load, float w_prox, float w_prio,
                        int k, int tile, int r, int rt, int rw, unsigned int offset, float* aux,
                        u64* rkey, int32_t* fwd_p, float* fwd_c, int32_t* pool_t, float* pool_c,
                        int32_t* rev_t, float* rev_c, void* stream) {
  if (k < 1 || k > kMaxK || k > P) return (int)cudaErrorInvalidValue;
  if (int rc = check_reverse(P, T, K, tile, r, rt, rw)) return rc;
  K1Args a = k1_args(prov_cols, req_cols, P, T, K, W, w_price, w_load, w_prox, w_prio, aux);
  a.n_rows = T;
  a.rw = rw;
  a.split = 1;
  a.k = k;
  a.tile = tile;
  a.rt = rt;
  a.n_pool = T / tile * rt;
  a.offset = offset;
  a.out_p = fwd_p;
  a.out_c = fwd_c;
  a.rkey = rkey;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(rkey, 0xff, (size_t)P * a.n_pool * sizeof(u64), st);
  if (e != cudaSuccess) return (int)e;
  launch_prep(a.prov, a.req, a.w, P, T, aux, st);
  const int blocks = (T + kWarps * rw - 1) / (kWarps * rw);
  const int rc = rt == 1 ? run_k1<true, true, false, false>(a, blocks, st)
                         : run_k1<true, true, false, true>(a, blocks, st);
  if (rc) return rc;
  fold_kernel<<<(P + 127) / 128, 128, 0, st>>>(rkey, P, a.n_pool, r, rt > 1, pool_t, pool_c,
                                               rev_t, rev_c);
  return (int)cudaGetLastError();
}

// Blocks variant: rescore n_blocks (provider blk_p[b], tile blk_j[b])
// blocks, ordered by tile, into the pools [P, T / tile] in place (one
// contribution per tile, the first argmin): a plan launch (rkey [n_blocks]
// to all ones, lo [n_tiles + 1]), the list launch over chunks of each
// tile's entries and slices of its rows (as many slices as bring the
// launch to list_target blocks), a decode launch.
extern "C" int k1_reverse_blocks(const void* const* prov_cols, const void* const* req_cols, int P,
                                 int T, int K, int W, float w_price, float w_load, float w_prox,
                                 float w_prio, int tile, const int32_t* blk_p,
                                 const int32_t* blk_j, int n_blocks, float* aux, u64* rkey,
                                 int32_t* lo, int32_t* pool_t, float* pool_c, void* stream) {
  if (K > kMaxOpts || tile < 1 || T % tile != 0 || n_blocks < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
  ListArgs a = list_args(prov_cols, req_cols, P, T, K, W, w_price, w_load, w_prox, w_prio, tile,
                         aux);
  a.blk_p = blk_p;
  a.blk_j = blk_j;
  a.lo = lo;
  a.n_blocks = n_blocks;
  a.rkey = rkey;
  const int chunks = (n_blocks + kListProv - 1) / kListProv;
  const int max_slices = (tile + kMaxRows - 1) / kMaxRows;
  const int slices = min(max_slices, max(1, (list_target() + chunks - 1) / chunks));
  a.slice = ((tile + slices - 1) / slices + kMaxRows - 1) / kMaxRows * kMaxRows;
  const cudaStream_t st = (cudaStream_t)stream;
  launch_prep(a.prov, a.req, a.w, P, T, aux, st);
  blocks_plan_kernel<<<(n_blocks + 127) / 128, 128, 0, st>>>(blk_j, n_blocks, a.n_tiles, lo, rkey);
  const dim3 grid(n_blocks / kListProv + a.n_tiles, (tile + a.slice - 1) / a.slice);
  if (int rc = run_list<kListBlocks>(a, grid, st)) return rc;
  blocks_decode_kernel<<<(n_blocks + 127) / 128, 128, 0, st>>>(rkey, blk_p, blk_j, n_blocks,
                                                               a.n_tiles, pool_t, pool_c);
  return (int)cudaGetLastError();
}

// K4: per (provider, tile), the least fresh cost over the ascending task
// ids t_ids of that tile, from pad, into min_tile [P, T / tile] (prefilled
// with pad; a tile without a dirty task keeps it): the list launch over
// kListProv-wide provider chunks and ranges of the ids cut at tile
// boundaries (as many ranges as bring the launch to list_target blocks).
extern "C" int k4_repair_tile_min(const void* const* prov_cols, const void* const* req_cols,
                                  int P, int T, int K, int W, float w_price, float w_load,
                                  float w_prox, float w_prio, int tile, const int32_t* t_ids,
                                  int n_t, float pad, float* aux, float* min_tile, void* stream) {
  if (K > kMaxOpts || tile < 1 || T % tile != 0 || n_t < 1 || P < 1)
    return (int)cudaErrorInvalidValue;
  ListArgs a = list_args(prov_cols, req_cols, P, T, K, W, w_price, w_load, w_prox, w_prio, tile,
                         aux);
  a.t_ids = t_ids;
  a.n_t = n_t;
  a.pad = pad;
  a.min_tile = min_tile;
  const int chunks = (P + kListProv - 1) / kListProv;
  a.ranges = min(n_t, max(1, (list_target() + chunks - 1) / chunks));
  const cudaStream_t st = (cudaStream_t)stream;
  launch_prep(a.prov, a.req, a.w, P, T, aux, st);
  return run_list<kListTileMin>(a, dim3(chunks, a.ranges), st);
}

// K3: enter [T] u8, 1 where some dirty provider (global ids p_ids[0,
// n_p), repeats allowed) has a fresh jittered cost c <= thresh[t] with c <
// INFEASIBLE/2, the jitter keyed on (t + offset) mod 2^32; zeroed here,
// then the list launch over chunks of the ids and ranges of the tasks.
extern "C" int k3_repair_enter(const void* const* prov_cols, const void* const* req_cols, int P,
                               int T, int K, int W, float w_price, float w_load, float w_prox,
                               float w_prio, const int32_t* p_ids, int n_p,
                               unsigned int offset, const float* thresh, float* aux,
                               uint8_t* enter, void* stream) {
  if (K > kMaxOpts || n_p < 1 || T < 1 || P < 1) return (int)cudaErrorInvalidValue;
  ListArgs a = list_args(prov_cols, req_cols, P, T, K, W, w_price, w_load, w_prox, w_prio, 1,
                         aux);
  a.T = T;
  a.n_p = n_p;
  a.p_ids = p_ids;
  a.offset = offset;
  a.thresh = thresh;
  a.enter = enter;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(enter, 0, (size_t)T, st);
  if (e != cudaSuccess) return (int)e;
  launch_prep(a.prov, a.req, a.w, P, T, aux, st);
  return run_range_list<kListEnter>(a, st);
}

// K10: cost [T, P] f32, slot-major: the unjittered cost of every cell,
// INFEASIBLE off the mask; the list launch over P's chunks and ranges of
// the slots.
extern "C" int k10_cost_block(const void* const* prov_cols, const void* const* req_cols, int P,
                              int T, int K, int W, float w_price, float w_load, float w_prox,
                              float w_prio, float* aux, float* cost, void* stream) {
  if (P < 1 || T < 1 || K > kMaxOpts) return (int)cudaErrorInvalidValue;
  ListArgs a = list_args(prov_cols, req_cols, P, T, K, W, w_price, w_load, w_prox, w_prio, 1,
                         aux);
  a.T = T;
  a.n_p = P;
  a.cost = cost;
  const cudaStream_t st = (cudaStream_t)stream;
  launch_prep(a.prov, a.req, a.w, P, T, aux, st);
  return run_range_list<kListCost>(a, st);
}

// K6: value_base [T, P] f32, slot-major: -(the jittered cost), the jitter
// keyed on the slot's row, or -1e18 where the cost is >= INFEASIBLE/2; and
// feasible [T] u8, 1 where some provider's cost is below INFEASIBLE/2
// (zeroed here). The list launch over P's chunks and ranges of the slots.
extern "C" int k6_value_base(const void* const* prov_cols, const void* const* req_cols, int P,
                             int T, int K, int W, float w_price, float w_load, float w_prox,
                             float w_prio, float* aux, float* value_base, uint8_t* feasible,
                             void* stream) {
  if (P < 1 || T < 1 || K > kMaxOpts) return (int)cudaErrorInvalidValue;
  ListArgs a = list_args(prov_cols, req_cols, P, T, K, W, w_price, w_load, w_prox, w_prio, 1,
                         aux);
  a.T = T;
  a.n_p = P;
  a.cost = value_base;
  a.enter = feasible;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(feasible, 0, (size_t)T, st);
  if (e != cudaSuccess) return (int)e;
  launch_prep(a.prov, a.req, a.w, P, T, aux, st);
  return run_range_list<kListValue>(a, st);
}

// K8: best [P] i32, the first argmin over T of the unjittered cost (-0 and
// +0 equal, a NaN below every cost), -1 where that cost is >= INFEASIBLE/2
// or NaN: rkey [P] set to all
// ones, the list launch over P's chunks and ranges of the tasks, a decode
// launch.
extern "C" int k8_unbounded_best(const void* const* prov_cols, const void* const* req_cols, int P,
                                 int T, int K, int W, float w_price, float w_load, float w_prox,
                                 float w_prio, float* aux, u64* rkey, int32_t* best,
                                 void* stream) {
  if (P < 1 || T < 1 || K > kMaxOpts) return (int)cudaErrorInvalidValue;
  ListArgs a = list_args(prov_cols, req_cols, P, T, K, W, w_price, w_load, w_prox, w_prio, 1,
                         aux);
  a.T = T;
  a.n_p = P;
  a.rkey = rkey;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(rkey, 0xff, (size_t)P * sizeof(u64), st);
  if (e != cudaSuccess) return (int)e;
  launch_prep(a.prov, a.req, a.w, P, T, aux, st);
  if (int rc = run_range_list<kListBest>(a, st)) return rc;
  best_decode_kernel<<<(P + 127) / 128, 128, 0, st>>>(rkey, P, best);
  return (int)cudaGetLastError();
}
