// K2: one eps phase of the sparse frontier auction for Hopper (sm_90a), and
// K16's segment launch: the same rounds over the D task shards of a mesh
// whose shards all lie on this card.
//
// K2 replaces protocol_tpu/ops/sparse.py::_sparse_auction_phase (its
// lax.while_loop) with frontier_bids inside it. K16's segment launch
// replaces protocol_tpu/parallel/sparse.py::_build_sharded_phase (the body
// of its lax.while_loop under shard_map): each shard owns Tl consecutive
// task rows (global ids d Tl .. (d + 1) Tl - 1) and takes its own frontier,
// the first B open rows of its rows (flatnonzero(open, size=B) per shard);
// the round's pmax of the bids and pmin of the winning global task ids are
// one 64-bit atomicMax, as K2 resolves its round. K2 is the kernel at D = 1.
//
// All rounds of one call, up to max_iters (K16: up to round_cap a launch,
// the loop state carried in ctl between launches), run in ONE launch of
// one thread-block cluster of C blocks of 1024 threads (one block an SM;
// C = 16 on an H100), with no host sync per round. Each round:
//   1. compact each shard's first B open (unassigned, feasible, unretired)
//      rows in index order into f_idx, the shards' frontiers one after
//      another. The open set is a bitmask sharded over the cluster, each
//      shard's rows starting a word: block r holds words [r wpb, (r + 1)
//      wpb) in its shared memory, with the open count of each shard in
//      them. Warp 0 of each block reads the C blocks' counts over
//      distributed shared memory, so all blocks agree on each shard's total
//      and each knows its offset in every shard; a block compacts its share
//      of a shard with a scan of its 32 warps' popcounts;
//   2. global warp g takes frontier entries g, g + 32 C, ... two at a
//      time (the second task's loads in flight beside the first's) and
//      computes frontier_bids over its K candidates (K <= 128, in
//      registers): best value v1 at the first argmax, carrying the
//      candidate's provider and price through the reduction, runner-up v2
//      (the max with the argmax slot masked to -1e18) floored at -1e8;
//   3. retire tasks with v1 < their shard's give_up (their open bit and
//      their shard's count are cleared in the owning block);
//   4. bid (price[p1] + (v1 - v2)) + eps in f32 (the price replicas are
//      equal: a bid reads replica 0);
//   5. resolve one winner per provider with a 64-bit atomicMax on
//      (order-preserving bid bits << 32 | ~task) in global memory: the max
//      bid, and among equal bids the lowest global task whatever block or
//      shard bid it, as the reference's scatter-max then scatter-min (or
//      pmax then pmin) give;
//   6. the winning bidder evicts the provider's old owner, whichever shard
//      owns that row, and takes the seat (p4t, and owner and price in every
//      shard's replica: as fast as writing replica 0 and copying it out at
//      the exit, PERF.md); the open bits and counts of the evicted and the
//      seated task are updated in their owning block's shared memory
//      (atomics on shared::cluster addresses), each shard's assigned
//      balance in the seating block's;
//   7. it, best and stall advance as in the reference's loop body, from the
//      summed seat counts, read after the next barrier.
// Three cluster barriers a round: before the compaction (the seats and
// counts are in), before the bids (f_idx is written), before the seats
// (the keys are resolved). win_key and fr_p1 alternate between two buffers
// by round parity, so a round's keys are reset in the next round without
// a barrier of their own; the last round's are reset before the exit.
// Every block takes the loop's exit decisions from the same shared values
// read after the same barrier, so none leaves a barrier unmatched. At the
// exit block 0 writes each shard's ctl words (the Ctl layout, auction.cuh):
// it, best, stall, go (whether the rounds would go on past round_cap), the
// shard's frontier rows, open and assigned counts.
//
// One block takes over: the open count never grows within a phase (a seat
// with an eviction keeps it, a seat or a retirement lowers it). Once it is
// at most one_block_open (one block's bid pass), block 0 gathers the other
// blocks' words and counts, they leave, and block 0 runs the rest of the
// launch as a cluster of one: block barriers, L1, its own shared memory. A
// launch of C = 1 runs that way from the start. K16's segment launch never
// takes over (one_block_open 0): at D = 4, 65,536^2 it measured slower with
// the takeover than without (PERF.md).
//
// What bounds it on the H100: latency. A round is a chain of dependent
// steps (compaction, gathers of candidate rows and prices, resolve, seat)
// over small data: O(D B K) gathers a round against a 0.01 ms byte bound
// a 256-round launch. The cluster puts 32 C warps on a round's bids (a
// block alone has 32), keeps the open set in shared memory (D ceil(Tl /
// 32) words; up to 1,638,400 rows), and crosses a step with a hardware
// cluster barrier instead of a grid barrier through device memory or, for
// K16, a launch and a host collective. Loop state the blocks write for
// each other (f_idx, fr_*, win_key, p4t, owner, price, retired) is read
// through L2 (ld.global.cg) while the cluster runs. A cluster round costs
// ~3 barriers of ~1,200 cycles each beside its loads; when few tasks are
// open, one block's round is cheaper (PERF.md, K2's findings). K16 at D
// shards bids up to D B rows a round, D times K2's early rounds.
//
// Numerics: f32 subtractions, adds and max only, each rounded once
// (-fmad=false), and order-independent integer atomics: the results are
// bit-identical to the plain torch versions at every cluster size.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "auction.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 32;  // the counts are read one lane a block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ uint32_t bit_of(int i) { return 1u << (i & 31); }

// A load of loop state another thread wrote this launch: through L2 when
// other SMs write it (a cluster), through L1 when one block runs the phase.
template <typename T>
__device__ __forceinline__ T ld_state(const T* p, bool one_block) {
  return one_block ? *p : __ldcg(p);
}

// D shards of Tl rows: cand_safe / value_base [D Tl, K], feasible / p4t /
// retired [D Tl], give_up [D], price / owner [D, P] (replicas), ctl [D,
// kCtl]; scratch f_idx [D B], fr_p1 [2, D B], fr_key [D B], win_key [2, P]
// (zero on entry, zero again on exit). kShards = false is K2: one shard, a
// fresh loop state and no round cap, the shard arithmetic compiled out.
template <bool kShards>
__global__ void __launch_bounds__(kThreads, 1)
    auction_phase_kernel(const int32_t* __restrict__ cand_safe,
                         const float* __restrict__ value_base,
                         const uint8_t* __restrict__ feasible, const float* give_up,
                         int n_shards, int Tl, int K, int B, int P, int max_iters,
                         int stall_limit, int round_cap, int fresh_state, float eps, int wpb,
                         int one_block_open, float* price, int32_t* owner, int32_t* p4t,
                         uint8_t* retired, int32_t* f_idx, int32_t* fr_p1,
                         unsigned long long* fr_key, unsigned long long* win_key, int32_t* ctl) {
  // this block's words of the open set (unassigned, feasible, unretired),
  // one bit per row in row order, each shard's rows from a word's start,
  // kept in step with every seat, eviction and retirement
  extern __shared__ uint32_t s_open[];
  __shared__ int s_warp[kWarps];
  // per shard: the open rows in this block's words; rows assigned at entry
  // in this block's words, plus every seat and minus every eviction this
  // block's threads make (the cluster's sum is the shard's assigned
  // count); the cluster's totals of both and this block's offset in the
  // shard's open rows, as warp 0 read them; block 0: the frontier rows bid
  __shared__ int s_cnt[kMaxShards];
  __shared__ int s_asg[kMaxShards];
  __shared__ int s_tot[kMaxShards];
  __shared__ int s_atot[kMaxShards];
  __shared__ int s_off[kMaxShards];
  __shared__ int s_rows[kMaxShards];
  __shared__ int s_round[2];  // open and assigned rows over all shards
  cg::cluster_group cluster = cg::this_cluster();
  int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int D = kShards ? n_shards : 1;
  const bool fresh = !kShards || fresh_state;
  const float give_up0 = give_up[0];
  const int wps = (Tl + 31) / 32;  // words a shard
  const int n_words = D * wps;
  const int DB = D * B;
  const int wbase = rank * wpb;
  int nw = max(0, min(wpb, n_words - wbase));
  // one block: block barriers and L1; else cluster barriers, L2 and
  // distributed shared memory
  bool one = C == 1;
  auto sync = [&]() {
    if (one)
      __syncthreads();
    else
      cluster.sync();
  };
  // frontier entries go round-robin over the blocks: a warp per task in
  // the bids, a thread per entry in the seats
  int gw = warp * C + rank;
  int n_gw = kWarps * C;
  int gt = tid * C + rank;
  int n_gt = kThreads * C;

  // the shard of global task t, and t's bit in the open set
  auto shard_of = [&](int t) { return D == 1 ? 0 : t / Tl; };
  auto open_bit = [&](int t, int d) { return t + d * (wps * 32 - Tl); };
  // the word of bit b, and shard d's open count, in the block that owns b
  auto open_word = [&](int b) -> uint32_t* {
    const int w = b >> 5;
    const int r = w / wpb;
    return (one ? s_open : cluster.map_shared_rank(s_open, r)) + (w - r * wpb);
  };
  auto open_count = [&](int b, int d) -> int* {
    return one ? &s_cnt[d] : cluster.map_shared_rank(&s_cnt[d], (b >> 5) / wpb);
  };
  for (int d = tid; d < D; d += kThreads) {
    s_cnt[d] = 0;
    s_asg[d] = 0;
    s_rows[d] = fresh ? 0 : ctl[d * kCtl + kRows];
  }
  __syncthreads();
  for (int w = warp; w < nw; w += kWarps) {
    const int g = wbase + w;
    const int d = D == 1 ? 0 : g / wps;
    const int r = (g - d * wps) * 32 + lane;
    const int i = d * Tl + r;
    const bool assigned = r < Tl && __ldcg(&p4t[i]) >= 0;
    const bool open = r < Tl && !assigned && feasible[i] && !__ldcg(&retired[i]);
    const unsigned m = __ballot_sync(kFull, open);
    const int a = __popc(__ballot_sync(kFull, assigned));
    if (lane == 0) {
      s_open[w] = m;
      if (m) atomicAdd(&s_cnt[d], __popc(m));
      if (a) atomicAdd(&s_asg[d], a);
    }
  }

  int it = fresh ? 0 : ctl[kIt];
  int best = fresh ? 0 : ctl[kBest];
  int stall = fresh ? 0 : ctl[kStall];
  const int it_stop = kShards ? it + min(round_cap, max(0, max_iters - it)) : max_iters;
  bool go = false;
  int nb = 0;  // the last round's frontier entries over all shards; 0 before the first
  int p_seat = -1;  // the provider of this thread's first seat entry, last round
  // zero the last round's keys (round it - 1, parity (it - 1) & 1, nb_prev
  // entries): this thread's first seat entry from the provider it read,
  // the rest (frontiers beyond 1,024 C entries) from fr_p1
  auto reset_keys = [&](int nb_prev) {
    if (nb_prev == 0) return;
    const int prev = (it - 1) & 1;
    unsigned long long* wk = win_key + (size_t)prev * P;
    if (p_seat >= 0) wk[p_seat] = 0ull;
    for (int i = gt + n_gt; i < nb_prev; i += n_gt) {
      const int p = ld_state(&fr_p1[prev * DB + i], one);
      if (p >= 0) wk[p] = 0ull;
    }
  };

  for (;;) {
    // ---- barrier 1: the last round's seats, evictions and counts are in
    sync();
    // each shard's open count, this block's offset in it and its assigned
    // count: one block's own, or the C blocks' as warp 0 reads them
    int n_open = 0;
    int n_now = 0;
    if (!one) {
      if (warp == 0) {
        int no = 0;
        int na = 0;
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          int c_r = 0;
          int a_r = 0;
          if (lane < C) {
            c_r = *cluster.map_shared_rank(&s_cnt[d], lane);
            a_r = *cluster.map_shared_rank(&s_asg[d], lane);
          }
          const int c = __reduce_add_sync(kFull, c_r);
          const int o = __reduce_add_sync(kFull, lane < rank ? c_r : 0);
          const int a = __reduce_add_sync(kFull, a_r);
          if (lane == 0) {
            s_tot[d] = c;
            s_off[d] = o;
            s_atot[d] = a;
          }
          no += c;
          na += a;
        }
        if (lane == 0) {
          s_round[0] = no;
          s_round[1] = na;
        }
      }
      __syncthreads();
      n_open = s_round[0];
      n_now = s_round[1];
    } else {
      for (int d = 0; d < D; ++d) {
        n_open += s_cnt[d];
        n_now += s_asg[d];
      }
    }
    int nb_prev = nb;
    if (nb > 0) {
      // ---- 7. progress bookkeeping of the last round (every thread
      // keeps its own copy); its keys are reset below
      stall = n_now > best ? 0 : stall + 1;
      best = max(best, n_now);
      ++it;
    } else if (fresh) {
      best = n_now;  // the number assigned at entry
    }
    go = it < max_iters && (stall_limit <= 0 || stall < stall_limit) && n_open > 0;
    if (!go || it >= it_stop) {
      reset_keys(nb_prev);
      break;
    }
    if (!one && n_open <= one_block_open) {
      // ---- the open set fits one block's bid pass, and it never grows in
      // a phase: block 0 gathers the other blocks' words and runs the rest
      // of the launch alone, with block barriers and L1
      reset_keys(nb_prev);
      if (rank == 0) {
        for (int w = wpb + tid; w < n_words; w += kThreads)
          s_open[w] = cluster.map_shared_rank(s_open, w / wpb)[w % wpb];
      }
      cluster.sync();  // block 0 has read every slice: the others leave
      if (rank != 0) return;
      one = true;
      C = 1;
      wpb = n_words;
      nw = n_words;
      gw = warp;
      n_gw = kWarps;
      gt = tid;
      n_gt = kThreads;
      nb_prev = 0;  // the last round's keys are reset
      for (int d = tid; d < D; d += kThreads) {
        s_cnt[d] = s_tot[d];
        s_asg[d] = s_atot[d];
      }
      __syncthreads();
    }
    const int par = it & 1;
    int32_t* fp = fr_p1 + par * DB;
    unsigned long long* wk = win_key + (size_t)par * P;

    // ---- 1. frontier: this block's share of each shard's first B open
    // rows, at the shard's place in f_idx (the shards in order)
    int nb_all = 0;
    const int d_lo = nw > 0 ? (kShards ? wbase / wps : 0) : D;
    const int d_hi = nw > 0 ? (kShards ? (wbase + nw - 1) / wps : 0) : -1;
    for (int d = 0; d < D; ++d) {
      const int nb_d = min(kShards ? (one ? s_cnt[d] : s_tot[d]) : n_open, B);
      const int at0 = nb_all;
      nb_all += nb_d;
      if (rank == 0 && tid == 0) s_rows[d] += nb_d;
      const int off = one ? 0 : s_off[d];
      if (d < d_lo || d > d_hi || off >= nb_d) continue;  // the same in every warp
      // this block's words of shard d, split into a contiguous range a warp
      const int sb = kShards ? max(0, d * wps - wbase) : 0;
      const int se = kShards ? min(nw, (d + 1) * wps - wbase) : nw;
      const int per = (se - sb + kWarps - 1) / kWarps;
      const int wb = min(sb + warp * per, se);
      const int we = min(wb + per, se);
      int wc = 0;
      for (int w = wb + lane; w < we; w += 32) wc += __popc(s_open[w]);
      wc = __reduce_add_sync(kFull, wc);
      if (lane == 0) s_warp[warp] = wc;
      __syncthreads();
      const int v = s_warp[lane];
      int pos = off + __reduce_add_sync(kFull, lane < warp ? v : 0);
      const int t_base = d * (Tl - wps * 32);  // a global task id is t_base + its bit
      for (int base = wb; base < we && pos < nb_d; base += 32) {
        const int w = base + lane;
        uint32_t m = w < we ? s_open[w] : 0u;
        const int c = __popc(m);
        int incl = c;
        for (int o = 1; o < 32; o <<= 1) {
          const int n = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += n;
        }
        int at = pos + incl - c;
        const int t0 = t_base + (wbase + w) * 32;
        while (m && at < nb_d) {
          const int b = __ffs(m) - 1;
          f_idx[at0 + at++] = t0 + b;
          m &= m - 1;
        }
        pos += __shfl_sync(kFull, incl, 31);
      }
      if (d < d_hi) __syncthreads();  // s_warp is the next shard's
    }
    nb = nb_all;
    // ---- barrier 2: the frontier is written
    sync();

    // ---- 2-5. bids: a warp per frontier task, two tasks in flight; each
    // lane keeps the values of candidates lane, lane + 32, ... in registers
    for (int i = gw; i < nb; i += 2 * n_gw) {
      bool live[2];
      int f[2];
      live[0] = true;
      live[1] = i + n_gw < nb;
      f[0] = ld_state(&f_idx[i], one);
      f[1] = live[1] ? ld_state(&f_idx[i + n_gw], one) : f[0];
      int cs[2][kMaxSlots];
      float vals[2][kMaxSlots];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const size_t row = (size_t)f[q] * K;
#pragma unroll
        for (int j = 0; j < kMaxSlots; ++j) {
          const int k = lane + 32 * j;
          cs[q][j] = 0;
          vals[q][j] = -INFINITY;
          if (k < K) {
            cs[q][j] = cand_safe[row + k];
            vals[q][j] = value_base[row + k];
          }
        }
      }
      float bv[2], bp[2];
      int bk[2], bc[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        bv[q] = -INFINITY;
        bk[q] = K;
        bc[q] = 0;
        bp[q] = 0.f;
#pragma unroll
        for (int j = 0; j < kMaxSlots; ++j) {
          const int k = lane + 32 * j;
          if (k < K) {
            const float pr = ld_state(&price[cs[q][j]], one);
            vals[q][j] = __fsub_rn(vals[q][j], pr);
            if (vals[q][j] > bv[q]) {  // k grows with j: the first max is kept
              bv[q] = vals[q][j];
              bk[q] = k;
              bc[q] = cs[q][j];
              bp[q] = pr;
            }
          }
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float ov = __shfl_xor_sync(kFull, bv[q], o);
          const int ok = __shfl_xor_sync(kFull, bk[q], o);
          const int oc = __shfl_xor_sync(kFull, bc[q], o);
          const float op = __shfl_xor_sync(kFull, bp[q], o);
          if (ov > bv[q] || (ov == bv[q] && ok < bk[q])) {
            bv[q] = ov;
            bk[q] = ok;
            bc[q] = oc;
            bp[q] = op;
          }
        }
      }
      float m2[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        m2[q] = -INFINITY;
#pragma unroll
        for (int j = 0; j < kMaxSlots; ++j) {
          const int k = lane + 32 * j;
          if (k < K) m2[q] = fmaxf(m2[q], k == bk[q] ? kNeg : vals[q][j]);
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int q = 0; q < 2; ++q) m2[q] = fmaxf(m2[q], __shfl_xor_sync(kFull, m2[q], o));
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (lane != q || !live[q]) continue;
        const int t = f[q];
        const int slot = i + q * n_gw;
        const float v1 = bv[q];
        const float v2 = fmaxf(m2[q], kV2Floor);
        const int p1 = bc[q];
        const int d = shard_of(t);
        const bool newly_retired = v1 < (D == 1 ? give_up0 : give_up[d]);
        if (newly_retired) {
          const int b = open_bit(t, d);
          retired[t] = 1;
          atomicAnd(open_word(b), ~bit_of(b));
          atomicSub(open_count(b, d), 1);
        }
        if (!newly_retired && v1 > kHalfNeg) {
          const float bid = __fadd_rn(__fadd_rn(bp[q], __fsub_rn(v1, v2)), eps);
          const unsigned long long key =
              ((unsigned long long)ordered_bits(bid) << 32) | (unsigned long long)(~(uint32_t)t);
          atomicMax(&wk[p1], key);
          fp[slot] = p1;
          fr_key[slot] = key;
        } else {
          fp[slot] = -1;
        }
      }
    }
    reset_keys(nb_prev);  // the keys of the last round, off the bids' path
    // ---- barrier 3: every bid is resolved
    sync();

    // ---- 6. the winning bidder of each provider takes the seat
    p_seat = -1;
    for (int i = gt; i < nb; i += n_gt) {
      const int p = ld_state(&fp[i], one);
      const unsigned long long key = ld_state(&fr_key[i], one);
      if (i == gt) p_seat = p;
      if (p < 0) continue;
      const unsigned long long won = ld_state(&wk[p], one);
      const int old = ld_state(&owner[p], one);
      if (won != key) continue;
      const int t = (int)~(uint32_t)key;  // the key's low word
      const int dt = shard_of(t);
      if (old >= 0) {
        const int de = shard_of(old);
        p4t[old] = -1;
        if (feasible[old] && !ld_state(&retired[old], one)) {
          const int b = open_bit(old, de);
          atomicOr(open_word(b), bit_of(b));
          atomicAdd(open_count(b, de), 1);
        }
        if (de != dt) {
          atomicSub(&s_asg[de], 1);
          atomicAdd(&s_asg[dt], 1);
        }
      } else {
        atomicAdd(&s_asg[dt], 1);
      }
      p4t[t] = p;
      const int b = open_bit(t, dt);
      atomicAnd(open_word(b), ~bit_of(b));
      atomicSub(open_count(b, dt), 1);
      const float won_bid = from_ordered((uint32_t)(key >> 32));
      for (int q = 0; q < D; ++q) {
        owner[(size_t)q * P + p] = t;
        price[(size_t)q * P + p] = won_bid;
      }
    }
  }
  // no block leaves while another may still read its shared memory
  sync();
  if (rank == 0) {
    for (int d = tid; d < D; d += kThreads) {
      int32_t* c = ctl + d * kCtl;
      c[kIt] = it;
      c[kBest] = best;
      c[kStall] = stall;
      c[kGo] = go;
      c[kPending] = 0;
      c[kNb] = 0;
      c[kRows] = s_rows[d];
      // the shard's totals: one block's own counts, or the cluster's as
      // warp 0 read them at the last barrier
      c[kOpen] = one ? s_cnt[d] : s_tot[d];
      c[kAssigned] = one ? s_asg[d] : s_atot[d];
    }
  }
}

// The attributes every launch and query needs, and the cluster's launch
// configuration; `smem` is the dynamic shared memory of a block.
template <bool kShards>
cudaError_t cluster_config(int cluster, int smem, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(
      auction_phase_kernel<kShards>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxOpenBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(auction_phase_kernel<kShards>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster, 1, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

// `err`, or else the runtime's last error; either way the last error is
// cleared, so a refused call is reported once, here, and never to the
// next launch of another kernel.
int settle(cudaError_t err) {
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

template <bool kShards>
int launch_phase(const int32_t* cand_safe, const float* value_base, const uint8_t* feasible,
                 const float* give_up, int D, int Tl, int K, int B, int P, int max_iters,
                 int stall_limit, int round_cap, int fresh, float eps, int one_block_open,
                 float* price, int32_t* owner, int32_t* p4t, uint8_t* retired,
                 int32_t* f_idx, int32_t* fr_p1, unsigned long long* fr_key,
                 unsigned long long* win_key, int32_t* ctl, int cluster, void* stream) {
  if (D < 1 || D > kMaxShards || Tl < 1 || (long long)D * Tl > 0x7fffffffLL || K < 1 ||
      K > 32 * kMaxSlots || B < 1 || P < 1 || round_cap < 1 || cluster < 1 ||
      cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  const long long n_words = (long long)D * ((Tl + 31) / 32);
  if (n_words * 4 > kMaxOpenBytes) return (int)cudaErrorInvalidValue;
  const int wpb = (int)((n_words + cluster - 1) / cluster);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  // every block has room for the whole open set: block 0 may take it all
  cudaError_t err =
      cluster_config<kShards>(cluster, (int)n_words * 4, (cudaStream_t)stream, &cfg, &attr);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, auction_phase_kernel<kShards>, cand_safe, value_base, feasible,
                             give_up, D, Tl, K, B, P, max_iters, stall_limit, round_cap, fresh,
                             eps, wpb, one_block_open, price, owner, p4t, retired,
                             f_idx, fr_p1, fr_key, win_key, ctl);
  return settle(err);
}

}  // namespace

// Plain C interface (loaded with ctypes): launches one phase on `stream`
// as one cluster of `cluster` blocks and returns the launch's cudaError_t
// (0 = launched; a cluster size the card refuses comes back as its error).
// Block 0 finishes alone once at most `one_block_open` tasks are open (0:
// never). fr_p1 is [2][B] and win_key [2][P]: win_key must be zero on
// entry and is zero again on exit. ctl is int32 [kCtl]: it, stall and the
// frontier rows bid come back at kIt, kStall and kRows.
extern "C" int k2_auction_phase(const int32_t* cand_safe, const float* value_base,
                                const uint8_t* feasible, const float* give_up, int T, int K,
                                int B, int P, int max_iters, int stall_limit, float eps,
                                int one_block_open, float* price, int32_t* owner,
                                int32_t* p4t, uint8_t* retired, int32_t* f_idx, int32_t* fr_p1,
                                unsigned long long* fr_key, unsigned long long* win_key,
                                int32_t* ctl, int cluster, void* stream) {
  return launch_phase<false>(cand_safe, value_base, feasible, give_up, 1, T, K, B, P, max_iters,
                      stall_limit, max_iters < 1 ? 1 : max_iters, 1, eps, one_block_open, price,
                      owner, p4t, retired, f_idx, fr_p1, fr_key, win_key, ctl, cluster, stream);
}

// K16's segment launch over D shards of Tl rows (the stacked shard fields,
// see auction_phase_kernel): up to round_cap rounds of the phase's
// max_iters, from a fresh loop state (`fresh`: it and stall 0, best the
// assigned count) or from the one in ctl. fr_p1 is [2][D B], f_idx and
// fr_key [D B], win_key [2][P], zero on entry and on exit. Returns the
// launch's cudaError_t. No block takes over alone.
extern "C" int k16_mesh_segment(const int32_t* cand_safe, const float* value_base,
                                const uint8_t* feasible, const float* give_up, int D, int Tl,
                                int K, int B, int P, int max_iters, int stall_limit,
                                int round_cap, int fresh, float eps, float* price,
                                int32_t* owner, int32_t* p4t, uint8_t* retired,
                                int32_t* f_idx, int32_t* fr_p1, unsigned long long* fr_key,
                                unsigned long long* win_key, int32_t* ctl, int cluster,
                                void* stream) {
  return launch_phase<true>(cand_safe, value_base, feasible, give_up, D, Tl, K, B, P, max_iters,
                      stall_limit, round_cap, fresh, eps, 0, price, owner, p4t, retired, f_idx,
                      fr_p1, fr_key, win_key, ctl, cluster, stream);
}

// How many clusters of `cluster` blocks (each with the shared memory of the
// largest task count) the current card can run at once, into *n; returns
// the query's cudaError_t.
extern "C" int k2_active_clusters(int cluster, int* n) {
  *n = 0;
  if (cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<false>(cluster, kMaxOpenBytes, nullptr, &cfg, &attr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(n, (void*)auction_phase_kernel<false>, &cfg);
  return settle(err);
}
