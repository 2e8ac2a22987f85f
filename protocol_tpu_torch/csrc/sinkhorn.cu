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
// column of the reference's [P, T]. One cooperative launch runs every
// phase of a solve, a grid barrier (K7's release / acquire one) between
// two (it beat one launch a phase by 8-10% at the RPC's 4,096^2):
//   bits     the cost read once, a warp a 32 x 32 tile: the feasibility
//            mask (cost < INFEASIBLE/2) as two bitmaps, a provider's row
//            over the tasks and a task's row over the providers (the
//            second the bit transpose of the first, transpose32); u, v = 0;
//   offsets  a warp a row of either side: its feasible cells (cnt), each
//            bitmap word's place in the row's packed values (a prefix of
//            the popcounts) and the row's place, its cells padded to a
//            multiple of 4 (a block's rows handed out by one atomicAdd, so
//            the rows lie in any order, each contiguous); how many rows of
//            a side have a feasible cell (the marginals), and how many
//            cells are feasible;
//   values   the cost read again, a tile a warp: K = -cost / eps (an IEEE
//            division) of every feasible cell into both orientations, a
//            provider's row over the tasks and a task's over the
//            providers. The layout follows the feasible share, which the
//            offsets phase counted (dense_of):
//              packed  (share below kDenseNum / kDenseDen, and at most
//                      kPackedCols columns a side) a row's feasible cells
//                      contiguous in column order, each with its column (16
//                      bits), -inf cells at column 0 padding the row to a
//                      multiple of 4: at the sinkhorn RPC's 4,096^2 with ~22%
//                      of the cells feasible, ~22 MB a side;
//              dense   every cell of the row, -inf off the mask, the row
//                      padded to a multiple of 4 columns; no column is
//                      stored (a cell's column is its place). A pass reads
//                      4 bytes of every cell where packed reads 6 of a
//                      feasible one, and no column gather: at 4,096^2 it
//                      takes 11.2 ms for 200 rounds at any share, packed
//                      9.3 at half the cells feasible, 11.0-11.1 at 60% and
//                      12.1 at 70% (an H100, scripts/torch_sinkhorn_ab.py),
//                      hence a threshold near 0.6. Wider sides, whose
//                      columns 16 bits cannot hold, take it at any share;
//   then num_iters times
//   u pass   u[p] = log_a - LSE_t(K[p, t] + v[t]) over provider p's row,
//            -1e18 where the provider has no feasible task;
//   v pass   v[t] = log_b - LSE_p(K[p, t] + u[p]) over task t's row;
//   final    a warp a task row: plan = exp((K + u) + v) with K recomputed
//            from the cost (the same division, so the same bits), subnormal
//            entries flushed to +0 (XLA flushes them; the rounding is a
//            greedy with first-index ties, so a subnormal where the
//            reference has 0 could change a pick), +0 on an infeasible
//            cell, the rounding cost and the row's plan maximum. The plan
//            and the rounding cost are written over the two sides' values,
//            which no phase reads any more.
//
// A pass: a warp a row, rows handed out by a counter (their cells differ
// ~100-fold). The lanes read the row's values (and its columns) 16 bytes a
// lane, coalesced, and the other side's potential at those columns from
// device memory, each cell once: each lane keeps an online (max, sum-exp)
// pair over its cells, rescaled as its max rises, and the warp takes the
// row's max (0 where it is not finite) and sums the lanes' sums rescaled
// to it, then log, + max (jax.nn.logsumexp's epilogue). Max then sum, as
// jax.nn.logsumexp computes it, read a packed row twice and was slower:
// 8.1-8.3 ms against 6.4-6.5 at the RPC's 4,096^2 (an H100,
// scripts/torch_sinkhorn_ab.py). The sums are taken in a fixed order
// (each lane's cells, then the warp's shuffle tree), so a solve's bits
// repeat from run to run.
//
// Cells off the mask are skipped (packed) or hold -inf (dense), which is
// exact. In the reference they hold K = -1e18, and K + v is then <= -1e18 +
// |v|, which rounds to about -1e18 in f32, while a feasible cell's K + v is
// of the order of the costs over eps (|K| < 5e8 / eps): a row's max is a
// feasible cell's, and each infeasible cell adds exp(~-1e18 - max) = 0
// exactly to its sum, as exp(-inf) does. A row with no feasible cell (its
// LSE in the reference is that of -1e18 or -2e18 terms) is masked to -1e18
// by feas_row / feas_col there, and the kernel writes -1e18 for it
// directly; a column with no feasible cell meets only -inf cells in the
// other side's dense rows and none in its packed rows. So the masks are
// exact, and u, v and the plan differ from the reference's by the
// summation order alone.
//
// What bounds it on the H100: instruction issue and the L2 (packed), device
// memory (dense). A round reads both sides once: packed, 6 bytes and ~6
// operations a feasible cell a pass; dense, 4 bytes a cell.
// The function's own device-memory bytes (the cost twice in the prep, once
// more in the final pass, the plan and the rounding cost out) are a
// one-off. The bound counted in chip_smoke.py is the operations on the
// feasible cells and those bytes.
//
// Numerics: the same f32 operations per element as the plain torch
// version in protocol_tpu_torch/ops/assign.py, each rounding once
// (-fmad=false); the sums run in another order, so the potentials and the
// plan agree within a tolerance, not bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bits.cuh"

namespace {

constexpr float kNeg = -1e18f;
constexpr float kInfeasible = 1e9f;
constexpr float kHalfInfeasible = 5e8f;
constexpr float kTiny = 1.17549435e-38f;  // FLT_MIN, the least normal f32
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 16;  // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kScan = 32;  // bitmap words a warp scans at a time: a word a lane
// the dense layout where at least kDenseNum / kDenseDen of the cells are
// feasible, or a side has more than kPackedCols columns
constexpr unsigned long long kDenseNum = 4, kDenseDen = 7;
constexpr int kPackedCols = 65536;

__host__ __device__ inline bool dense_of(unsigned long long feasible, int T, int P) {
  return T > kPackedCols || P > kPackedCols ||
         feasible * kDenseDen >= (unsigned long long)T * (unsigned long long)P * kDenseNum;
}

// One orientation of the block: own rows over the other side's columns.
struct Side {
  int rows;             // own rows, over the other side's columns
  int words, stride;    // bitmap words a row; a dense row's values (columns to a multiple of 4)
  uint32_t* bits;       // [rows][words]
  int32_t* wpre;        // [rows][words]: a word's first cell's place in the row's packed values
  long long* off;       // [rows]: a packed row's first value in vals, a multiple of 4
  int32_t* cnt;         // [rows]: the row's feasible cells
  float* vals;          // K: packed rows, or [rows][stride] dense
  uint16_t* cidx;       // a packed cell's column
  float* pot;           // [stride of the other side]: the potential this side's pass writes
};

struct Args {
  const float* cost;  // [T][P]
  int T, P, iters;
  float eps;
  Side prov, task;
  float* plan;   // [T][P], over prov.vals
  float* rcost;  // [T][P], over task.vals
  float* colmax;
  unsigned* ctl;  // [0] barrier generation, [1] + s: side s's rows with a feasible cell,
                  // [3] + i % 3: pass i's row counter
  unsigned long long* alloc;  // [s]: side s's packed values handed out; [2] feasible cells
};

__device__ __forceinline__ unsigned atom_add_release_gpu(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Grid-wide barrier (K7's): thread 0 of every block adds one to a
// monotone generation word with release semantics and polls it with
// acquire loads until it reaches epoch x blocks; the block's other
// threads are ordered by the __syncthreads around it.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned n_blocks, unsigned& epoch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    ++epoch;
    atom_add_release_gpu(bar, 1u);
    const unsigned target = epoch * n_blocks;
    while (ld_acquire_gpu(bar) < target) {
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_incl_scan(int n, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, n, d);
    if (lane >= d) n += y;
  }
  return n;
}

__device__ __forceinline__ float finite_or_zero(float m) { return isfinite(m) ? m : 0.0f; }

__device__ __forceinline__ float max4(const float4& x) {
  return fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w));
}

// ---- bits: a warp a 32 x 32 tile (tasks 32 tw.., providers 32 pw..)
__device__ void phase_bits(const Args& a, int gw, int nw, int lane) {
  const int WT = a.prov.words, WP = a.task.words;
  const long long n_tiles = (long long)WT * WP;
  for (long long it = gw; it < n_tiles; it += nw) {
    const int tw = (int)(it / WP), pw = (int)(it % WP);
    const int t0 = tw * 32, p = pw * 32 + lane;
    uint32_t word = 0u;  // provider p's row over tasks t0..t0 + 31
#pragma unroll 8
    for (int i = 0; i < 32; ++i) {
      const int t = t0 + i;
      if (p < a.P && t < a.T && a.cost[(size_t)t * a.P + p] < kHalfInfeasible) word |= 1u << i;
    }
    const uint32_t tword = transpose32(word, lane);  // task t0 + lane's over providers 32 pw..
    if (p < a.P) a.prov.bits[(size_t)p * WT + tw] = word;
    if (t0 + lane < a.T) a.task.bits[(size_t)(t0 + lane) * WP + pw] = tword;
  }
  // the potentials with their padding to the dense stride (0: finite)
  const int nu = a.task.stride, nv = a.prov.stride;
  for (long long i = (long long)gw * 32 + lane; i < (long long)nu + nv; i += (long long)nw * 32) {
    if (i < nu)
      a.prov.pot[i] = 0.0f;
    else
      a.task.pot[i - nu] = 0.0f;
  }
}

// ---- offsets: a warp a row of either side (providers, then tasks).
// Returns the row's feasible cells; writes wpre.
__device__ int row_offsets(const Side& S, int row, int lane) {
  int running = 0;
  for (int w0 = 0; w0 < S.words; w0 += kScan) {
    const int w = w0 + lane;
    const uint32_t word = w < S.words ? S.bits[(size_t)row * S.words + w] : 0u;
    const int n = __popc(word);
    const int incl = warp_incl_scan(n, lane);
    if (w < S.words) S.wpre[(size_t)row * S.words + w] = running + incl - n;
    running += __shfl_sync(kFull, incl, 31);
  }
  return running;
}

__device__ __forceinline__ int padded(int n) { return (n + 3) & ~3; }

__device__ void phase_offsets(const Args& a, int gw, int nw, int warp, int lane) {
  __shared__ unsigned long long s_sum[kWarps][3];
  __shared__ unsigned s_cnt[kWarps][2];
  __shared__ unsigned long long s_base[2];
  const int n_rows = a.P + a.T;
  unsigned long long sum[3] = {0ull, 0ull, 0ull};  // each side's packed values, the cells
  unsigned cnt[2] = {0u, 0u};
  for (int r = gw; r < n_rows; r += nw) {
    const int s = r < a.P ? 0 : 1;
    const Side& S = s == 0 ? a.prov : a.task;
    const int row = s == 0 ? r : r - a.P;
    const int n = row_offsets(S, row, lane);
    if (lane == 0) S.cnt[row] = n;
    sum[s] += (unsigned long long)padded(n);
    if (s == 0) sum[2] += (unsigned long long)n;
    cnt[s] += n > 0 ? 1u : 0u;
  }
  if (lane == 0) {
    for (int s = 0; s < 3; ++s) s_sum[warp][s] = sum[s];
    s_cnt[warp][0] = cnt[0];
    s_cnt[warp][1] = cnt[1];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    const int s = threadIdx.x;
    unsigned long long tot = 0ull;
    unsigned rows = 0u;
    for (int w = 0; w < kWarps; ++w) {
      tot += s_sum[w][s];
      if (s < 2) rows += s_cnt[w][s];
    }
    if (s < 2) {
      s_base[s] = atomicAdd(a.alloc + s, tot);
      if (rows) atomicAdd(a.ctl + 1 + s, rows);
    } else if (tot) {
      atomicAdd(a.alloc + 2, tot);
    }
  }
  __syncthreads();
  if (lane != 0) return;
  unsigned long long base[2] = {s_base[0], s_base[1]};
  for (int w = 0; w < warp; ++w) {
    base[0] += s_sum[w][0];
    base[1] += s_sum[w][1];
  }
  for (int r = gw; r < n_rows; r += nw) {
    const int s = r < a.P ? 0 : 1;
    const Side& S = s == 0 ? a.prov : a.task;
    const int row = s == 0 ? r : r - a.P;
    S.off[row] = (long long)base[s];
    base[s] += (unsigned long long)padded(S.cnt[row]);
  }
}

// ---- values: a warp a 32 x 32 tile, K into both sides' rows
__device__ void phase_values(const Args& a, bool dense, int gw, int nw, int lane) {
  const int WT = a.prov.words, WP = a.task.words;
  if (!dense) {  // a packed row's padding to 4 values: -inf cells at column 0
    for (int r = gw; r < a.P + a.T; r += nw) {
      const Side& S = r < a.P ? a.prov : a.task;
      const int row = r < a.P ? r : r - a.P;
      const int n = S.cnt[row], q = n + lane;
      if (lane < 3 && q < padded(n)) {
        S.vals[S.off[row] + q] = -INFINITY;
        S.cidx[S.off[row] + q] = 0;
      }
    }
  }
  const long long n_tiles = (long long)WT * WP;
  const uint32_t below = (1u << lane) - 1u;
  for (long long it = gw; it < n_tiles; it += nw) {
    const int tw = (int)(it / WP), pw = (int)(it % WP);
    const int t0 = tw * 32, p = pw * 32 + lane, tl = t0 + lane;
    if (dense) {
      // provider p's cells t0.. and task t's cell p, -inf off the mask and
      // in the padding columns
      for (int i = 0; i < 32; ++i) {
        const int t = t0 + i;
        float c = kInfeasible;
        if (p < a.P && t < a.T) c = a.cost[(size_t)t * a.P + p];
        const float k = c < kHalfInfeasible ? __fdiv_rn(-c, a.eps) : -INFINITY;
        if (p < a.P && t < a.prov.stride) a.prov.vals[(size_t)p * a.prov.stride + t] = k;
        if (t < a.T && p < a.task.stride) a.task.vals[(size_t)t * a.task.stride + p] = k;
      }
      continue;
    }
    long long pb = 0, tb = 0;
    if (p < a.P) pb = a.prov.off[p] + a.prov.wpre[(size_t)p * WT + tw];
    if (tl < a.T) tb = a.task.off[tl] + a.task.wpre[(size_t)tl * WP + pw];
    for (int i = 0; i < 32; ++i) {
      const int t = t0 + i;
      float c = kInfeasible;
      if (p < a.P && t < a.T) c = a.cost[(size_t)t * a.P + p];
      const bool f = c < kHalfInfeasible;
      const uint32_t b = __ballot_sync(kFull, f);
      const long long tbi = __shfl_sync(kFull, tb, i);
      if (f) {
        const float k = __fdiv_rn(-c, a.eps);
        const long long at = tbi + __popc(b & below);
        a.prov.cidx[pb] = (uint16_t)t;
        a.prov.vals[pb++] = k;
        a.task.cidx[at] = (uint16_t)p;
        a.task.vals[at] = k;
      }
    }
  }
}

__device__ __forceinline__ float add_exp(float sum, const float4& x, float m) {
  sum = __fadd_rn(sum, expf(__fsub_rn(x.x, m)));
  sum = __fadd_rn(sum, expf(__fsub_rn(x.y, m)));
  sum = __fadd_rn(sum, expf(__fsub_rn(x.z, m)));
  return __fadd_rn(sum, expf(__fsub_rn(x.w, m)));
}

// LSE of a row of n cells (a multiple of 4), read once: each lane's online
// (max, sum-exp) pair, then the warp's max and the lanes' sums rescaled to
// it. A cell's column is its place in a dense row, its cidx in a packed one.
// (Unrolled 4 or 8 times, the loop took 16% and 29% longer at the RPC's
// 4,096^2: an H100, scripts/torch_sinkhorn_ab.py.)
__device__ __forceinline__ float lse_row(const float* vals, const uint16_t* cidx,
                                         const float* pot, int n, int lane, bool dense) {
  float m = -INFINITY, s = 0.0f;
#pragma unroll 2
  for (int q = 4 * lane; q < n; q += 128) {
    const float4 k = *reinterpret_cast<const float4*>(vals + q);
    float4 p;
    if (dense) {
      p = *reinterpret_cast<const float4*>(pot + q);
    } else {
      const ushort4 j = *reinterpret_cast<const ushort4*>(cidx + q);
      p = make_float4(pot[j.x], pot[j.y], pot[j.z], pot[j.w]);
    }
    const float4 x = make_float4(__fadd_rn(k.x, p.x), __fadd_rn(k.y, p.y), __fadd_rn(k.z, p.z),
                                 __fadd_rn(k.w, p.w));
    const float mx = fmaxf(m, max4(x));
    if (mx == -INFINITY) continue;  // no finite cell yet
    s = add_exp(__fmul_rn(s, expf(__fsub_rn(m, mx))), x, mx);
    m = mx;
  }
  const float M = finite_or_zero(warp_max(m));
  const float t = m == -INFINITY ? 0.0f : __fmul_rn(s, expf(__fsub_rn(m, M)));
  return __fadd_rn(logf(warp_sum(t)), M);
}

// ---- pass i over side S's rows: S.pot[row] = lmarg - LSE(K + pot[col]),
// a warp a row. A warp's first row is its index; where there are more
// rows than warps, a warp that is done takes the next from the pass's
// counter (ctr[i % 3], zeroed in pass i - 1), so one that drew short rows
// takes more: rows differ ~100-fold in cells. (A claim at every row's
// start, by every warp at once, serialises thousands of atomics on one
// word.)
__device__ void phase_pass(const Side& S, const float* pot, float lmarg, unsigned* ctr, int pass,
                           int gw, int nw, int lane, bool dense) {
  if (blockIdx.x == 0 && threadIdx.x == 0) ctr[(pass + 1) % 3] = 0u;
  for (int row = gw; row < S.rows;) {
    const int n = S.cnt[row];
    if (n == 0) {
      if (lane == 0) S.pot[row] = kNeg;
    } else {
      const size_t at = dense ? (size_t)row * S.stride : (size_t)S.off[row];
      const float lse = lse_row(S.vals + at, S.cidx + at, pot, dense ? S.stride : padded(n),
                                lane, dense);
      if (lane == 0) S.pot[row] = __fsub_rn(lmarg, lse);
    }
    if (S.rows <= nw) return;  // a row a warp at most: no counter
    int next = 0;
    if (lane == 0) next = nw + (int)atomicAdd(ctr + pass % 3, 1u);
    row = __shfl_sync(kFull, next, 0);
  }
}

// ---- final: a warp a task row
__device__ void phase_final(const Args& a, int gw, int nw, int lane) {
  const float* u = a.prov.pot;
  for (int t = gw; t < a.T; t += nw) {
    const float vt = a.task.pot[t];
    const size_t base = (size_t)t * a.P;
    float mx = 0.0f;  // every entry is >= +0
#pragma unroll 4
    for (int p = lane; p < a.P; p += 32) {
      const float c = a.cost[base + p];
      const bool f = c < kHalfInfeasible;
      float x = 0.0f;
      if (f) {
        x = expf(__fadd_rn(__fadd_rn(__fdiv_rn(-c, a.eps), u[p]), vt));
        if (x < kTiny) x = 0.0f;
      }
      a.plan[base + p] = x;
      a.rcost[base + p] = f ? -x : kInfeasible;
      mx = fmaxf(mx, x);
    }
    mx = warp_max(mx);
    if (lane == 0) a.colmax[t] = mx;
  }
}

// The marginal of a side with n feasible rows against the other's o:
// log(min(n, o) / n) over at least one row each, as marginals' glue.
__device__ __forceinline__ float log_marginal(unsigned n, unsigned o) {
  const unsigned nv = n > 0u ? n : 1u, ov = o > 0u ? o : 1u;
  const float m = (float)(nv < ov ? nv : ov);
  return logf(__fdiv_rn(m, (float)nv));
}

// Every phase of a solve: 0 bits, 1 offsets, 2 values, 3 + 2i the u pass
// of round i, 4 + 2i its v pass, 3 + 2 iters the final pass; a grid
// barrier between two (the launch is cooperative).
__global__ void __launch_bounds__(kThreads, 2) sinkhorn_kernel(const Args a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWarps + warp, nw = gridDim.x * kWarps;
  const int n_phases = 4 + 2 * a.iters;
  unsigned epoch = 0;
  bool dense = false;
  for (int ph = 0; ph < n_phases; ++ph) {
    if (ph > 0) grid_barrier(a.ctl, gridDim.x, epoch);
    if (ph == 0) {
      phase_bits(a, gw, nw, lane);
    } else if (ph == 1) {
      phase_offsets(a, gw, nw, warp, lane);
    } else if (ph == 2) {
      dense = dense_of(a.alloc[2], a.T, a.P);
      phase_values(a, dense, gw, nw, lane);
    } else if (ph < n_phases - 1) {
      const unsigned np = a.ctl[1], nt = a.ctl[2];
      const int pass = ph - 3;
      const bool u_pass = pass % 2 == 0;
      const Side& S = u_pass ? a.prov : a.task;
      const float* pot = u_pass ? a.task.pot : a.prov.pot;
      const float lmarg = u_pass ? log_marginal(np, nt) : log_marginal(nt, np);
      phase_pass(S, pot, lmarg, a.ctl + 3, pass, gw, nw, lane, dense);
    } else {
      phase_final(a, gw, nw, lane);
    }
  }
}

Side make_side(int rows, int cols, uint32_t* bits, int32_t* wpre, long long* off, int32_t* cnt,
               float* vals, uint16_t* cidx, float* pot) {
  Side s;
  s.rows = rows;
  s.words = (cols + 31) / 32;
  s.stride = (cols + 3) & ~3;
  s.bits = bits;
  s.wpre = wpre;
  s.off = off;
  s.cnt = cnt;
  s.vals = vals;
  s.cidx = cidx;
  s.pot = pot;
  return s;
}

bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }

}  // namespace

// Whether K13 runs its rounds over dense rows on a [T, P] cost with
// ``feasible`` feasible cells (kernels.py mirrors it).
extern "C" int k13_dense_layout(long long feasible, int T, int P) {
  return dense_of((unsigned long long)feasible, T, P) ? 1 : 0;
}

// Plain C interface (loaded with ctypes): one Sinkhorn solve on
// ``stream``. cost [T, P] f32 slot-major; T4, P4 are T and P rounded up to
// a multiple of 4. The provider side: pbits [P][ceil(T/32)] u32, pwpre
// [P][ceil(T/32)] i32, poff [P] i64, pcnt [P] i32, its values over plan and
// their columns in pcidx (u16); the task side likewise over rcost (tbits
// [T][ceil(P/32)], ...). plan and pcidx hold P x T4 values, rcost and tcidx
// T x P4; plan and rcost return the plan and the rounding cost [T, P].
// colmax [T] output; u [P4] and v [T4] return the potentials in their
// first P and T. plan, rcost, u and v are 16-byte aligned, pcidx and tcidx
// 8. ctl [6] u32 and alloc [3] u64 zeroed by the caller. Every phase runs
// in one cooperative launch. Returns the launch's error (0 = launched).
extern "C" int k13_sinkhorn(const float* cost, int T, int P, float eps, int num_iters,
                            uint32_t* pbits, int32_t* pwpre, long long* poff, int32_t* pcnt,
                            uint16_t* pcidx, uint32_t* tbits, int32_t* twpre, long long* toff,
                            int32_t* tcnt, uint16_t* tcidx, float* plan, float* rcost,
                            float* colmax, float* u, float* v, unsigned* ctl,
                            unsigned long long* alloc, void* stream) {
  if (T < 1 || P < 1 || num_iters < 0 || !(eps > 0.0f) || misaligned(plan) ||
      misaligned(rcost) || misaligned(u) || misaligned(v) ||
      (reinterpret_cast<uintptr_t>(pcidx) & 7) || (reinterpret_cast<uintptr_t>(tcidx) & 7))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.cost = cost;
  a.T = T;
  a.P = P;
  a.iters = num_iters;
  a.eps = eps;
  a.prov = make_side(P, T, pbits, pwpre, poff, pcnt, plan, pcidx, u);
  a.task = make_side(T, P, tbits, twpre, toff, tcnt, rcost, tcidx, v);
  a.plan = plan;
  a.rcost = rcost;
  a.colmax = colmax;
  a.ctl = ctl;
  a.alloc = alloc;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sinkhorn_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1 || n_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)(n_sm * per_sm));
  void* args[] = {(void*)&a};
  err = cudaLaunchCooperativeKernel((const void*)sinkhorn_kernel, grid, dim3(kThreads), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
