// K16: one round of the task-sharded frontier auction for Hopper (sm_90a),
// per shard, in three launches around the round's two cross-shard
// combines: the route of shards on several cards. Where every shard lies
// on one card, K16 runs as its segment launch instead (csrc/auction.cu,
// K2's cluster kernel over the shards: 256 rounds of every shard in one
// launch); parallel/sparse.py::segment_route chooses.
//
// Replaces protocol_tpu/parallel/sparse.py::_build_sharded_phase (the body
// of its lax.while_loop under shard_map). Each shard owns Tl consecutive
// task rows (global ids offset .. offset + Tl - 1) of the candidate arrays
// and the rows' assignment and retirement; every shard keeps its own
// replica of the provider prices and owners (global task ids). A round:
//
//   k16_round_bid      (one block of 1024 threads per shard)
//       0. control: folds the previous round's combined counts into the
//          shard's copy of the loop state (it, best, stall), then
//          evaluates the loop condition (it < max_iters, open tasks left
//          anywhere, stall below its limit); a round after the stop does
//          nothing, in this launch and the two below;
//       1. the frontier: the first B open local rows in ascending index
//          (jnp.flatnonzero(open, size=B)): each thread counts the open
//          rows of a contiguous chunk, a block scan gives each chunk its
//          place;
//       2. frontier_bids, one warp per frontier row as in K2: best value
//          v1 at the first argmax, runner-up v2 floored at -1e8;
//       3. retirement below give_up;
//       4. bid = (price[p1] + (v1 - v2)) + eps, scatter-maxed into the
//          shard's [P] key array as an order-preserving int32 (a float's
//          bits with the magnitude bits flipped when negative, so a signed
//          int compare orders the floats; atomicMax on the raw bits would
//          misorder negative values);
//   -> the host combines the shards' keys with pmax;
//   k16_round_resolve  (one thread per frontier row)
//       5. a bidder whose bid equals its provider's combined best writes
//          its global task id with atomicMin: the lowest task wins ties;
//   -> the host combines the shards' winners with pmin;
//   k16_round_apply    (one thread per provider)
//       6. a provider with a winner evicts its old owner where that row is
//          the shard's, seats the winner where that row is the shard's, and
//          takes the winner and the bid in its replica of owner and price;
//          the shard's open and assigned counts move with every row it
//          changes, and the shard's key and winner arrays are reset;
//   -> the host combines the counts with psum for the next round's step 0.
//
// The counts live in device memory and the stop is decided there, so the
// host enqueues a segment's rounds without reading anything back.
//
// What bounds it on the H100: latency. A round is a dependent chain of
// small launches (a scan over Tl rows, O(B K) gathers of prices and
// candidate rows, O(P) resets) with host combines between them; the bid
// launch runs on one SM per shard. The work a round does is small next to
// the card's rates; its cost is launches and the one-block bid step.
//
// Numerics: f32 subtractions, adds and max only, each rounded once
// (-fmad=false), and order-independent integer atomics: the results are
// bit-identical to the plain torch version in
// protocol_tpu_torch/parallel/sparse.py.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "auction.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoBid = INT_MIN;  // below every float's key

__device__ __forceinline__ int32_t ordered_key(float f) {
  const int32_t i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float from_key(int32_t k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

__global__ void __launch_bounds__(kThreads, 1)
    round_bid_kernel(const int32_t* __restrict__ cand_safe, const float* __restrict__ value_base,
                     const uint8_t* __restrict__ feasible, const float* give_up_ptr, int Tl,
                     int K, int B, int max_iters, int stall_limit, float eps,
                     const float* __restrict__ price, uint8_t* retired,
                     const int32_t* __restrict__ p4t, const int32_t* __restrict__ tot,
                     int32_t* ctl, int32_t* front, float* front_bid, int32_t* win_key) {
  __shared__ int s_warp[kWarps];
  __shared__ int s_go;
  __shared__ int s_total;
  __shared__ int s_retired;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // ---- 0. control (one copy of the loop state per shard, all equal)
  if (tid == 0) {
    int it = ctl[kIt], best = ctl[kBest], stall = ctl[kStall];
    if (ctl[kPending]) {
      const int n_now = tot[1];
      stall = n_now > best ? 0 : stall + 1;
      best = max(best, n_now);
      ++it;
    }
    const int go = it < max_iters && tot[0] > 0 && (stall_limit <= 0 || stall < stall_limit);
    ctl[kIt] = it;
    ctl[kBest] = best;
    ctl[kStall] = stall;
    ctl[kGo] = go;
    ctl[kPending] = go;
    ctl[kNb] = 0;
    s_go = go;
    s_retired = 0;
  }
  __syncthreads();
  if (!s_go) return;

  // ---- 1. the frontier: the first B open rows in ascending index
  const int chunk = (Tl + kThreads - 1) / kThreads;
  const int r0 = min(Tl, tid * chunk);
  const int r1 = min(Tl, r0 + chunk);
  int mine = 0;
  for (int t = r0; t < r1; ++t) mine += (p4t[t] < 0) & (feasible[t] != 0) & (retired[t] == 0);
  int incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = s_warp[lane];
    int w = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += n;
    }
    s_warp[lane] = w - v;  // exclusive offset of each warp
    if (lane == 31) s_total = w;  // the shard's open rows
  }
  __syncthreads();
  const int n_open = s_total;
  const int nb = min(n_open, B);
  int pos = s_warp[warp] + incl - mine;
  for (int t = r0; t < r1 && pos < nb; ++t) {
    if ((p4t[t] < 0) & (feasible[t] != 0) & (retired[t] == 0)) front[pos++] = t;
  }
  __syncthreads();

  // ---- 2-4. bids: one warp per frontier row; each lane keeps the values
  // of candidates lane, lane + 32, ... in registers
  for (int i = warp; i < nb; i += kWarps) {
    const int f = front[i];
    const size_t row = (size_t)f * K;
    float vals[kMaxSlots];
    float bv = -INFINITY;
    int bk = K;
#pragma unroll
    for (int j = 0; j < kMaxSlots; ++j) {
      const int k = lane + 32 * j;
      vals[j] = -INFINITY;
      if (k < K) {
        vals[j] = __fsub_rn(value_base[row + k], price[cand_safe[row + k]]);
        if (vals[j] > bv) {  // k grows with j: the first max is kept
          bv = vals[j];
          bk = k;
        }
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, o);
      const int ok = __shfl_xor_sync(kFull, bk, o);
      if (ov > bv || (ov == bv && ok < bk)) {
        bv = ov;
        bk = ok;
      }
    }
    const float v1 = bv;
    const int k1 = bk;
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kMaxSlots; ++j) {
      const int k = lane + 32 * j;
      if (k < K) m = fmaxf(m, k == k1 ? kNeg : vals[j]);
    }
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    const float v2 = fmaxf(m, kV2Floor);
    if (lane == 0) {
      const int p1 = cand_safe[row + k1];
      const bool newly_retired = v1 < *give_up_ptr;
      int bidder = -1;
      if (newly_retired) {
        retired[f] = 1;
        atomicAdd(&s_retired, 1);
      } else if (v1 > kHalfNeg) {
        const float bid = __fadd_rn(__fadd_rn(price[p1], __fsub_rn(v1, v2)), eps);
        atomicMax(&win_key[p1], ordered_key(bid));
        front_bid[i] = bid;
        bidder = p1;
      }
      front[B + i] = bidder;
    }
  }
  __syncthreads();
  if (tid == 0) {
    ctl[kNb] = nb;
    ctl[kRows] += nb;
    ctl[kOpen] -= s_retired;
  }
}

__global__ void __launch_bounds__(256)
    round_resolve_kernel(int B, int offset, const int32_t* __restrict__ ctl,
                         const int32_t* __restrict__ front, const float* __restrict__ front_bid,
                         const int32_t* __restrict__ win_key, int32_t* win_task) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ctl[kNb]) return;  // 0 after the stop
  const int p = front[B + i];
  if (p < 0) return;
  if (front_bid[i] >= from_key(win_key[p])) atomicMin(&win_task[p], offset + front[i]);
}

__global__ void __launch_bounds__(256)
    round_apply_kernel(int P, int T, int Tl, int offset, const int32_t* __restrict__ win_key,
                       const int32_t* __restrict__ win_task,
                       const uint8_t* __restrict__ feasible,
                       const uint8_t* __restrict__ retired, int32_t* ctl, float* price,
                       int32_t* owner, int32_t* p4t, int32_t* key_local, int32_t* task_local) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P || !ctl[kGo]) return;
  const int32_t k = win_key[p];
  const int32_t wt = win_task[p];
  key_local[p] = kNoBid;
  task_local[p] = T;
  const float wb = k == kNoBid ? kNeg : from_key(k);
  if (!(wb > kHalfNeg) || wt >= T) return;
  // eviction first, then the win: the rows differ (a winner was open, an
  // evicted owner was seated), so the order across providers is free
  const int old = owner[p];
  if (old >= offset && old < offset + Tl) {
    const int e = old - offset;
    if (p4t[e] >= 0) {
      atomicSub(&ctl[kAssigned], 1);
      if (feasible[e] && !retired[e]) atomicAdd(&ctl[kOpen], 1);
    }
    p4t[e] = -1;
  }
  if (wt >= offset && wt < offset + Tl) {
    const int w = wt - offset;
    if (p4t[w] < 0) {
      atomicAdd(&ctl[kAssigned], 1);
      if (feasible[w] && !retired[w]) atomicSub(&ctl[kOpen], 1);
    }
    p4t[w] = p;
  }
  owner[p] = wt;
  price[p] = wb;
}

}  // namespace

// Plain C interface (loaded with ctypes): each launches one step of the
// round on `stream` and returns the launch's cudaError_t (0 = launched).
// ctl is the shard's int32 [9] state (it, best, stall, go, pending, nb,
// frontier rows, open, assigned), tot the combined [open, assigned];
// front is int32 [2, B] (frontier rows, bidders' providers), front_bid
// f32 [B]; win_key / win_task are the shard's [P] arrays, kNoBid and T
// between rounds.
extern "C" int k16_round_bid(const int32_t* cand_safe, const float* value_base,
                             const uint8_t* feasible, const float* give_up, int Tl, int K, int B,
                             int max_iters, int stall_limit, float eps, const float* price,
                             uint8_t* retired, const int32_t* p4t, const int32_t* tot,
                             int32_t* ctl, int32_t* front, float* front_bid, int32_t* win_key,
                             void* stream) {
  if (Tl < 1 || K < 1 || K > 32 * kMaxSlots || B < 1 || B > Tl)
    return (int)cudaErrorInvalidValue;
  round_bid_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      cand_safe, value_base, feasible, give_up, Tl, K, B, max_iters, stall_limit, eps, price,
      retired, p4t, tot, ctl, front, front_bid, win_key);
  return (int)cudaGetLastError();
}

extern "C" int k16_round_resolve(int B, int offset, const int32_t* ctl, const int32_t* front,
                                 const float* front_bid, const int32_t* win_key,
                                 int32_t* win_task, void* stream) {
  if (B < 1 || offset < 0) return (int)cudaErrorInvalidValue;
  round_resolve_kernel<<<(B + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      B, offset, ctl, front, front_bid, win_key, win_task);
  return (int)cudaGetLastError();
}

extern "C" int k16_round_apply(int P, int T, int Tl, int offset, const int32_t* win_key,
                               const int32_t* win_task, const uint8_t* feasible,
                               const uint8_t* retired, int32_t* ctl, float* price,
                               int32_t* owner, int32_t* p4t, int32_t* key_local,
                               int32_t* task_local, void* stream) {
  if (P < 1 || Tl < 1 || offset < 0 || offset + Tl > T) return (int)cudaErrorInvalidValue;
  round_apply_kernel<<<(P + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      P, T, Tl, offset, win_key, win_task, feasible, retired, ctl, price, owner, p4t, key_local,
      task_local);
  return (int)cudaGetLastError();
}
