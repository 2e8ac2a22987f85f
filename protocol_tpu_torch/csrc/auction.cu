// K2: one eps phase of the sparse frontier auction for Hopper (sm_90a).
//
// Replaces protocol_tpu/ops/sparse.py::_sparse_auction_phase (its
// lax.while_loop) with frontier_bids inside it. All rounds of one call,
// up to max_iters, run in ONE launch of one thread-block cluster of C
// blocks of 1024 threads (one block an SM; C = 16 on an H100), with no host
// sync per round. Each round:
//   1. compact the first B open (unassigned, feasible, unretired) tasks in
//      index order (jnp.flatnonzero(size=B)) into f_idx. The open set is a
//      bitmask sharded over the cluster: block r holds words [r wpb,
//      (r + 1) wpb) in its shared memory, with their open count. Warp 0 of
//      each block reads the C counts over distributed shared memory, so all
//      blocks agree on the total and each knows its offset; a block
//      compacts its share with a scan of its 32 warps' popcounts;
//   2. global warp g takes frontier entries g, g + 32 C, ... two at a
//      time (the second task's loads in flight beside the first's) and
//      computes frontier_bids over its K candidates (K <= 128, in
//      registers): best value v1 at the first argmax, carrying the
//      candidate's provider and price through the reduction, runner-up v2
//      (the max with the argmax slot masked to -1e18) floored at -1e8;
//   3. retire tasks with v1 < give_up (their open bit and their block's
//      count are cleared in the owning block);
//   4. bid (price[p1] + (v1 - v2)) + eps in f32;
//   5. resolve one winner per provider with a 64-bit atomicMax on
//      (order-preserving bid bits << 32 | ~task) in global memory: the max
//      bid, and among equal bids the lowest task whatever block bid it, as
//      the reference's scatter-max then scatter-min give;
//   6. the winning bidder evicts the provider's old owner and takes the
//      seat (p4t, owner, price); the open bits and counts of the evicted
//      and the seated task are updated in their owning block's shared
//      memory (atomics on shared::cluster addresses);
//   7. it, best and stall advance as in the reference's loop body, from the
//      blocks' seat counts, read after the next barrier.
// Three cluster barriers a round: before the compaction (the seats and
// counts are in), before the bids (f_idx is written), before the seats
// (the keys are resolved). win_key and fr_p1 alternate between two buffers
// by round parity, so a round's keys are reset in the next round without
// a barrier of their own; the last round's are reset before the exit.
// Every block takes the loop's exit decisions from the same shared values
// read after the same barrier, so none leaves a barrier unmatched.
//
// One block takes over: the open count never grows within a phase (a seat
// with an eviction keeps it, a seat or a retirement lowers it). Once it is
// at most one_block_open (one block's bid pass), block 0 gathers the other
// blocks' words, they leave, and block 0 runs the rest of the launch as a
// cluster of one: block barriers, L1, its own shared memory. A launch of C
// = 1 runs that way from the start.
//
// What bounds it on the H100: latency. A round is a chain of dependent
// steps (compaction, gathers of candidate rows and prices, resolve, seat)
// over small data: O(B K) gathers a round against a 0.01 ms byte bound a
// 256-round launch. The cluster puts 32 C warps on a round's bids (a
// block alone has 32), keeps the open set in shared memory (T/8 bytes; up
// to 1,638,400 tasks), and crosses a step with a hardware cluster barrier
// instead of a grid barrier through device memory. Loop state the blocks
// write for each other (f_idx, fr_*, win_key, p4t, owner, price, retired)
// is read through L2 (ld.global.cg) while the cluster runs. A cluster
// round costs ~3 barriers of ~1,200 cycles each beside its loads; when few
// tasks are open, one block's round is cheaper (PERF.md, K2's findings).
//
// Numerics: f32 subtractions, adds and max only, each rounded once
// (-fmad=false), and order-independent integer atomics: the results are
// bit-identical to the plain torch version at every cluster size.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 4;  // candidate values each lane keeps: K <= 128
constexpr int kMaxCluster = 32;  // the counts are read one lane a block
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e18f;
constexpr float kHalfNeg = -5e17f;  // _NEG * 0.5
constexpr float kV2Floor = -1e8f;

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

__global__ void __launch_bounds__(kThreads, 1)
    auction_phase_kernel(const int32_t* __restrict__ cand_safe,
                         const float* __restrict__ value_base,
                         const uint8_t* __restrict__ feasible, const float* give_up_ptr, int T,
                         int K, int B, int P, int max_iters, int stall_limit, float eps, int wpb,
                         int one_block_open, float* price, int32_t* owner, int32_t* p4t,
                         uint8_t* retired, int32_t* f_idx, int32_t* fr_p1,
                         unsigned long long* fr_key, unsigned long long* win_key, int32_t* out) {
  // this block's words of the open set (unassigned, feasible, unretired),
  // one bit per task in task order, kept in step with every seat, eviction
  // and retirement, and their open count
  extern __shared__ uint32_t s_open[];
  __shared__ int s_warp[kWarps];
  __shared__ int s_round[3];  // the cluster's counts, as warp 0 read them
  __shared__ int s_cnt;
  // tasks assigned at entry in this block's words, plus every new seat
  // this block's threads make: the cluster's sum is the assigned count
  __shared__ int s_asg;
  cg::cluster_group cluster = cg::this_cluster();
  int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float give_up = *give_up_ptr;
  const int n_words = (T + 31) / 32;
  const int wbase = rank * wpb;
  int nw = max(0, min(wpb, n_words - wbase));
  // contiguous range of this block's words per warp
  int wb = min(warp * ((nw + kWarps - 1) / kWarps), nw);
  int we = min(wb + (nw + kWarps - 1) / kWarps, nw);
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

  // the word of task t, and the open count, in the block that owns it
  auto open_word = [&](int t) -> uint32_t* {
    const int w = t >> 5;
    const int r = w / wpb;
    return (one ? s_open : cluster.map_shared_rank(s_open, r)) + (w - r * wpb);
  };
  auto open_count = [&](int t) -> int* {
    return one ? &s_cnt : cluster.map_shared_rank(&s_cnt, (t >> 5) / wpb);
  };
  if (tid == 0) {
    s_cnt = 0;
    s_asg = 0;
  }
  __syncthreads();
  int cnt = 0;
  int asg = 0;
  for (int w = warp; w < nw; w += kWarps) {
    const int i = (wbase + w) * 32 + lane;
    const bool assigned = i < T && __ldcg(&p4t[i]) >= 0;
    const bool open = i < T && !assigned && feasible[i] && !__ldcg(&retired[i]);
    const unsigned m = __ballot_sync(kFull, open);
    if (lane == 0) s_open[w] = m;
    cnt += __popc(m);
    asg += __popc(__ballot_sync(kFull, assigned));
  }
  if (lane == 0 && (cnt | asg)) {
    atomicAdd(&s_cnt, cnt);
    atomicAdd(&s_asg, asg);
  }

  int best = 0;
  int stall = 0;
  int it = 0;
  int nb = 0;  // the last round's frontier size; 0 before the first round
  int p_seat = -1;  // the provider of this thread's first seat entry, last round
  int frontier_rows = 0;  // rows bid over all rounds (the launch's work)
  // zero the last round's keys (round it - 1, parity (it - 1) & 1, nb_prev
  // entries): this thread's first seat entry from the provider it read,
  // the rest (frontiers beyond 1,024 C entries) from fr_p1
  auto reset_keys = [&](int nb_prev) {
    if (nb_prev == 0) return;
    const int prev = (it - 1) & 1;
    unsigned long long* wk = win_key + (size_t)prev * P;
    if (p_seat >= 0) wk[p_seat] = 0ull;
    for (int i = gt + n_gt; i < nb_prev; i += n_gt) {
      const int p = ld_state(&fr_p1[prev * B + i], one);
      if (p >= 0) wk[p] = 0ull;
    }
  };

  for (;;) {
    // ---- barrier 1: the last round's seats, evictions and counts are in
    sync();
    // the open count, this block's offset in it and the assigned count:
    // one block's own, or the C blocks' as warp 0 reads them
    int n_open = s_cnt;
    int off = 0;
    int n_now = s_asg;
    if (!one) {
      if (warp == 0) {
        int c_r = 0;
        int a_r = 0;
        if (lane < C) {
          c_r = *cluster.map_shared_rank(&s_cnt, lane);
          a_r = *cluster.map_shared_rank(&s_asg, lane);
        }
        n_open = __reduce_add_sync(kFull, c_r);
        off = __reduce_add_sync(kFull, lane < rank ? c_r : 0);
        n_now = __reduce_add_sync(kFull, a_r);
        if (lane == 0) {
          s_round[0] = n_open;
          s_round[1] = off;
          s_round[2] = n_now;
        }
      }
      __syncthreads();
      n_open = s_round[0];
      off = s_round[1];
      n_now = s_round[2];
    }
    int nb_prev = nb;
    if (nb > 0) {
      // ---- 7. progress bookkeeping of the last round (every thread
      // keeps its own copy); its keys are reset below
      stall = n_now > best ? 0 : stall + 1;
      best = max(best, n_now);
      ++it;
    } else {
      best = n_now;  // the number assigned at entry
    }
    if (!(it < max_iters && (stall_limit <= 0 || stall < stall_limit)) || n_open == 0) {
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
      wb = min(warp * ((nw + kWarps - 1) / kWarps), nw);
      we = min(wb + (nw + kWarps - 1) / kWarps, nw);
      gw = warp;
      n_gw = kWarps;
      gt = tid;
      n_gt = kThreads;
      nb_prev = 0;  // the last round's keys are reset
      if (tid == 0) {
        s_cnt = n_open;
        s_asg = n_now;
      }
      __syncthreads();
    }
    nb = min(n_open, B);
    frontier_rows += nb;
    const int par = it & 1;
    int32_t* fp = fr_p1 + par * B;
    unsigned long long* wk = win_key + (size_t)par * P;

    // ---- 1. frontier: this block's share of the first B open tasks
    if (off < nb && nw > 0) {  // the same in every warp of the block
      int wc = 0;
      for (int w = wb + lane; w < we; w += 32) wc += __popc(s_open[w]);
      wc = __reduce_add_sync(kFull, wc);
      if (lane == 0) s_warp[warp] = wc;
      __syncthreads();
      const int v = s_warp[lane];
      int pos = off + __reduce_add_sync(kFull, lane < warp ? v : 0);
      for (int base = wb; base < we && pos < nb; base += 32) {
        const int w = base + lane;
        uint32_t m = w < we ? s_open[w] : 0u;
        const int c = __popc(m);
        int incl = c;
        for (int o = 1; o < 32; o <<= 1) {
          const int n = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += n;
        }
        int at = pos + incl - c;
        const int t0 = (wbase + w) * 32;
        while (m && at < nb) {
          const int b = __ffs(m) - 1;
          f_idx[at++] = t0 + b;
          m &= m - 1;
        }
        pos += __shfl_sync(kFull, incl, 31);
      }
    }
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
        const bool newly_retired = v1 < give_up;
        if (newly_retired) {
          retired[t] = 1;
          atomicAnd(open_word(t), ~bit_of(t));
          atomicSub(open_count(t), 1);
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
      if (old >= 0) {
        p4t[old] = -1;
        if (feasible[old] && !ld_state(&retired[old], one)) {
          atomicOr(open_word(old), bit_of(old));
          atomicAdd(open_count(old), 1);
        }
      } else {
        atomicAdd(&s_asg, 1);
      }
      p4t[t] = p;
      atomicAnd(open_word(t), ~bit_of(t));
      atomicSub(open_count(t), 1);
      owner[p] = t;
      price[p] = from_ordered((uint32_t)(key >> 32));
    }
  }
  // no block leaves while another may still read its shared memory
  sync();
  if (rank == 0 && tid == 0) {
    out[0] = it;
    out[1] = stall;
    out[2] = frontier_rows;
  }
}

}  // namespace

// Shared memory the open bitmask may take in one block: 200 KB holds
// 1,638,400 tasks at any cluster size.
constexpr int kMaxOpenBytes = 200 * 1024;

namespace {

// The attributes every launch and query needs, and the cluster's launch
// configuration; `smem` is the dynamic shared memory of a block.
cudaError_t cluster_config(int cluster, int smem, cudaStream_t stream, cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(
      auction_phase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxOpenBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(auction_phase_kernel,
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

}  // namespace

// Plain C interface (loaded with ctypes): launches one phase on `stream`
// as one cluster of `cluster` blocks and returns the launch's cudaError_t
// (0 = launched; a cluster size the card refuses comes back as its error).
// Block 0 finishes alone once at most `one_block_open` tasks are open (0:
// never). fr_p1 is [2][B] and win_key [2][P]: win_key must be zero on
// entry and is zero again on exit.
extern "C" int k2_auction_phase(const int32_t* cand_safe, const float* value_base,
                                const uint8_t* feasible, const float* give_up, int T, int K,
                                int B, int P, int max_iters, int stall_limit, float eps,
                                int one_block_open, float* price, int32_t* owner,
                                int32_t* p4t, uint8_t* retired, int32_t* f_idx, int32_t* fr_p1,
                                unsigned long long* fr_key, unsigned long long* win_key,
                                int32_t* out, int cluster, void* stream) {
  if (T < 1 || K < 1 || K > 32 * kMaxSlots || B < 1 || P < 1 || cluster < 1 ||
      cluster > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  const int n_words = (T + 31) / 32;
  const int wpb = (n_words + cluster - 1) / cluster;
  if (n_words * 4 > kMaxOpenBytes) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  // every block has room for the whole open set: block 0 may take it all
  cudaError_t err = cluster_config(cluster, n_words * 4, (cudaStream_t)stream, &cfg, &attr);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, auction_phase_kernel, cand_safe, value_base, feasible,
                             give_up, T, K, B, P, max_iters, stall_limit, eps, wpb,
                             one_block_open, price, owner, p4t, retired, f_idx, fr_p1, fr_key,
                             win_key, out);
  return settle(err);
}

// How many clusters of `cluster` blocks (each with the shared memory of the
// largest task count) the current card can run at once, into *n; returns
// the query's cudaError_t.
extern "C" int k2_active_clusters(int cluster, int* n) {
  *n = 0;
  if (cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      cluster_config(cluster, kMaxOpenBytes, nullptr, &cfg, &attr);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(n, (void*)auction_phase_kernel, &cfg);
  return settle(err);
}
