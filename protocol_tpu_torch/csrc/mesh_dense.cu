// K17: one round of the provider-sharded dense Jacobi auction for Hopper
// (sm_90a), one shard's launches at a time.
//
// Replaces protocol_tpu/parallel/auction.py::_build_sharded_dense_auction
// (:38; the body of its lax.while_loop under shard_map, :66-128). Each
// shard owns Pl consecutive provider rows (global ids offset .. offset +
// Pl - 1): its value rows value_base [T, Pl] (-cost, -1e18 off the mask,
// row per task), its providers' prices and owners (global task ids), its
// win keys and its [T] delta. The assignment p4t [T] and the loop state
// live once, on the mesh's first device, and each shard reads a copy. A
// round, every launch a no-op once the loop state says stop:
//
//   k17_scan      (per shard; one warp per open task, p4t < 0 and
//                 feasible) K7's step A (dense.cu) over the shard's row
//                 minus its prices: v1 at the first maximum p1 (the lowest
//                 local index), v2 the maximum with only p1 masked (a tie
//                 elsewhere gives v2 = v1), p1g = offset + p1 (-1 where
//                 v1 <= -5e17) and price[p1], into the shard's [4, T]
//                 scan buffer; no bid. Every task's delta is reset to -2.
//   -> the host all-gathers the D scan buffers onto the first device;
//   k17_combine   (first device; one thread per task) the best shard is
//                 the first maximum of the D v1 values, so equal values go
//                 to the lower shard, which holds the lower provider ids;
//                 gv2 = max(the other shards' v1, every shard's v2),
//                 floored at -1e8; bid = (price1 + (gv1 - gv2)) + eps and
//                 target = p1g for an open task with gv1 > -5e17, else
//                 target -1;
//   -> the host hands (bid, target) to every shard;
//   k17_resolve   (per shard; one thread per task) a 64-bit atomicMax of
//                 (order-preserving bid bits << 32 | ~task) into the
//                 shard's key of each target in its range: the highest
//                 bid wins, and among equal bids the lowest task;
//   k17_apply     (per shard; one thread per local provider) a provider
//                 with a key evicts its owner (delta -1), takes the winner
//                 (delta = its global id) and the bid as its price, and
//                 resets its key;
//   -> the host all-gathers the D deltas onto the first device;
//   k17_finish    (first device; one block) the pmax of the deltas over
//                 the shards; where it is > -2, p4t takes it; then it + 1,
//                 the open count, the open rows summed over the rounds,
//                 and go = it < max_iters && open > 0, the reference's
//                 while_loop condition.
//
// The loop state lives in device memory and every launch tests it, so the
// host enqueues a segment of rounds and reads back once per segment (as
// K16, mesh_auction.cu). An eviction and a win never land on one task in
// one round: an owner is seated and a bidder is not.
//
// What bounds it on the H100: bytes. The scan reads each open task's value
// row of the shard, Pl x 4 bytes, per round: open rows x P x 4 bytes a
// round over the D shards (the prices stay in L2). The other launches move
// O(D T + P) bytes a round. The rounds are a dependent chain of 3 D + 2
// launches enqueued by the host, so late rounds, with few open rows, are
// bound by the launches.
//
// Numerics: built like candidates.cu (-fmad=false, no fast-math): each
// f32 subtraction and add rounds once in the reference's order, the keys
// are integers. The result is bit-identical to the plain torch rounds
// (protocol_tpu_torch/parallel/auction.py) and, through the same
// tie-breaking, to the one-device dense auction (K7).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kHalfNeg = -5e17f;  // _NEG * 0.5
constexpr float kV2Floor = -1e8f;
constexpr int kThreads = 256;
constexpr int kFinishThreads = 1024;

// the loop state, int64 [kCtl], in the order of kernels.py's DCTL_* (the
// one definition of the layout)
enum Ctl { kIt, kGo, kOpen, kRows, kCtl };

__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__global__ void __launch_bounds__(kThreads) scan_kernel(
    const float* __restrict__ vb, const float* __restrict__ price, const int32_t* __restrict__ p4t,
    const uint8_t* __restrict__ feasible, const long long* __restrict__ ctl, int T, int Pl,
    int offset, float* __restrict__ scan, int32_t* __restrict__ delta) {
  if (!ctl[kGo]) return;
  const int lane = threadIdx.x & 31;
  const long long t = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  if (t >= T) return;  // warp-uniform
  if (lane == 0) delta[t] = -2;
  if (p4t[t] >= 0 || !feasible[t]) return;
  const float* row = vb + (size_t)t * Pl;
  float b1 = -INFINITY, b2 = -INFINITY;
  int i1 = Pl;
  for (int p = lane; p < Pl; p += 32) {
    const float v = __fsub_rn(row[p], price[p]);
    if (v > b1) {  // p grows: the first maximum of the lane stays
      b2 = b1;
      b1 = v;
      i1 = p;
    } else {
      b2 = fmaxf(b2, v);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float c1 = __shfl_xor_sync(kFull, b1, o);
    const int k1 = __shfl_xor_sync(kFull, i1, o);
    const float c2 = __shfl_xor_sync(kFull, b2, o);
    if (c1 > b1 || (c1 == b1 && k1 < i1)) {
      b2 = fmaxf(fmaxf(b1, b2), c2);
      b1 = c1;
      i1 = k1;
    } else {
      b2 = fmaxf(fmaxf(b2, c1), c2);
    }
  }
  if (lane == 0) {
    scan[t] = b1;
    scan[(size_t)T + t] = b2;
    reinterpret_cast<int32_t*>(scan)[(size_t)2 * T + t] = b1 > kHalfNeg ? offset + i1 : -1;
    scan[(size_t)3 * T + t] = price[i1];
  }
}

// gathered: the D scan buffers [D, 4, T] in shard order; bt [2, T]: the
// bids, then the targets (int32 bits).
__global__ void __launch_bounds__(kThreads) combine_kernel(
    const float* __restrict__ gathered, const int32_t* __restrict__ p4t,
    const uint8_t* __restrict__ feasible, const long long* __restrict__ ctl, int D, int T,
    float eps, float* __restrict__ bt) {
  if (!ctl[kGo]) return;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  int32_t* tgt = reinterpret_cast<int32_t*>(bt) + T;
  if (p4t[t] >= 0 || !feasible[t]) {
    tgt[t] = -1;
    return;
  }
  const size_t stride = (size_t)4 * T;
  int best = 0;
  float gv1 = gathered[t];
  for (int d = 1; d < D; ++d) {
    const float v = gathered[d * stride + t];
    if (v > gv1) {  // the first maximum: equal values stay with the lower shard
      gv1 = v;
      best = d;
    }
  }
  float gv2 = -INFINITY;
  for (int d = 0; d < D; ++d) {
    if (d != best) gv2 = fmaxf(gv2, gathered[d * stride + t]);
    gv2 = fmaxf(gv2, gathered[d * stride + T + t]);
  }
  gv2 = fmaxf(gv2, kV2Floor);
  if (gv1 > kHalfNeg) {
    const float price1 = gathered[best * stride + (size_t)3 * T + t];
    bt[t] = __fadd_rn(__fadd_rn(price1, __fsub_rn(gv1, gv2)), eps);
    tgt[t] = reinterpret_cast<const int32_t*>(gathered)[best * stride + (size_t)2 * T + t];
  } else {
    tgt[t] = -1;
  }
}

__global__ void __launch_bounds__(kThreads) resolve_kernel(
    const float* __restrict__ bt, const long long* __restrict__ ctl, int T, int Pl, int offset,
    unsigned long long* __restrict__ win_key) {
  if (!ctl[kGo]) return;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= T) return;
  const int g = reinterpret_cast<const int32_t*>(bt)[T + t];
  if (g < offset || g >= offset + Pl) return;  // -1, or another shard's
  const unsigned long long key =
      ((unsigned long long)ordered_bits(bt[t]) << 32) | (unsigned long long)(~(uint32_t)t);
  atomicMax(&win_key[g - offset], key);
}

__global__ void __launch_bounds__(kThreads) apply_kernel(
    unsigned long long* __restrict__ win_key, const long long* __restrict__ ctl, int Pl,
    int offset, float* __restrict__ price, int32_t* __restrict__ owner,
    int32_t* __restrict__ delta) {
  if (!ctl[kGo]) return;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= Pl) return;
  const unsigned long long key = win_key[p];
  if (key == 0ull) return;  // no bid
  win_key[p] = 0ull;
  const float bid = from_ordered((uint32_t)(key >> 32));
  if (!(bid > kHalfNeg)) return;
  const int t = (int)(~(uint32_t)key);
  const int old = owner[p];
  if (old >= 0) delta[old] = -1;
  owner[p] = t;
  price[p] = bid;
  delta[t] = offset + p;
}

// deltas: the D shards' [T] deltas in shard order.
__global__ void __launch_bounds__(kFinishThreads) finish_kernel(
    const int32_t* __restrict__ deltas, const uint8_t* __restrict__ feasible, long long* ctl,
    int D, int T, int max_iters, int32_t* __restrict__ p4t) {
  __shared__ int s_warp[kFinishThreads / 32];
  if (!ctl[kGo]) return;
  int open = 0;
  for (int t = threadIdx.x; t < T; t += kFinishThreads) {
    int g = -2;
    for (int d = 0; d < D; ++d) g = max(g, deltas[(size_t)d * T + t]);
    int a = p4t[t];
    if (g > -2) {
      a = g;
      p4t[t] = g;
    }
    open += (a < 0 && feasible[t]) ? 1 : 0;
  }
  for (int o = 16; o > 0; o >>= 1) open += __shfl_xor_sync(kFull, open, o);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = open;
  __syncthreads();  // every thread has read ctl[kGo] before it changes
  if (threadIdx.x == 0) {
    long long n_open = 0;
    for (int w = 0; w < kFinishThreads / 32; ++w) n_open += s_warp[w];
    const long long it = ctl[kIt] + 1;
    ctl[kRows] += ctl[kOpen];
    ctl[kIt] = it;
    ctl[kOpen] = n_open;
    ctl[kGo] = (it < max_iters && n_open > 0) ? 1 : 0;
  }
}

int blocks(long long threads) { return (int)((threads + kThreads - 1) / kThreads); }

}  // namespace

// Plain C interface (loaded with ctypes). Each returns the launch's
// cudaError_t (0 = launched); nothing synchronises. ctl is the int64 loop
// state [kCtl] (a shard's copy, or the first device's for combine and
// finish).

// value_base [T, Pl] f32, price [Pl] f32, p4t [T] i32, feasible [T] u8;
// writes scan [4, T] (v1, v2, p1g as int32 bits, price1) for the open
// tasks and delta [T] = -2.
extern "C" int k17_scan(const float* value_base, const float* price, const int32_t* p4t,
                        const uint8_t* feasible, const long long* ctl, int T, int Pl, int offset,
                        float* scan, int32_t* delta, void* stream) {
  if (T < 1 || Pl < 1) return (int)cudaErrorInvalidValue;
  scan_kernel<<<blocks((long long)T * 32), kThreads, 0, (cudaStream_t)stream>>>(
      value_base, price, p4t, feasible, ctl, T, Pl, offset, scan, delta);
  return (int)cudaGetLastError();
}

// gathered [D, 4, T] f32; writes bt [2, T] (bids, targets).
extern "C" int k17_combine(const float* gathered, const int32_t* p4t, const uint8_t* feasible,
                           const long long* ctl, int D, int T, float eps, float* bt,
                           void* stream) {
  if (D < 1 || T < 1) return (int)cudaErrorInvalidValue;
  combine_kernel<<<blocks(T), kThreads, 0, (cudaStream_t)stream>>>(gathered, p4t, feasible, ctl,
                                                                  D, T, eps, bt);
  return (int)cudaGetLastError();
}

// bt [2, T]; win_key [Pl] u64 (0 = no bid).
extern "C" int k17_resolve(const float* bt, const long long* ctl, int T, int Pl, int offset,
                           unsigned long long* win_key, void* stream) {
  if (T < 1 || Pl < 1) return (int)cudaErrorInvalidValue;
  resolve_kernel<<<blocks(T), kThreads, 0, (cudaStream_t)stream>>>(bt, ctl, T, Pl, offset,
                                                                  win_key);
  return (int)cudaGetLastError();
}

// win_key [Pl], price [Pl] f32, owner [Pl] i32, delta [T] i32.
extern "C" int k17_apply(unsigned long long* win_key, const long long* ctl, int Pl, int offset,
                         float* price, int32_t* owner, int32_t* delta, void* stream) {
  if (Pl < 1) return (int)cudaErrorInvalidValue;
  apply_kernel<<<blocks(Pl), kThreads, 0, (cudaStream_t)stream>>>(win_key, ctl, Pl, offset,
                                                                 price, owner, delta);
  return (int)cudaGetLastError();
}

// deltas [D, T] i32, feasible [T] u8; updates p4t [T] and ctl.
extern "C" int k17_finish(const int32_t* deltas, const uint8_t* feasible, long long* ctl, int D,
                          int T, int max_iters, int32_t* p4t, void* stream) {
  if (D < 1 || T < 1) return (int)cudaErrorInvalidValue;
  finish_kernel<<<1, kFinishThreads, 0, (cudaStream_t)stream>>>(deltas, feasible, ctl, D, T,
                                                               max_iters, p4t);
  return (int)cudaGetLastError();
}
