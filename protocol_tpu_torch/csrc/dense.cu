// The batch matcher's dense route for Hopper (sm_90a): the kernels of
// protocol_tpu/sched/tpu_backend.py::_solve_bounded, _solve_unbounded and
// _cost_only.
//
//   K6 value base   (_solve_bounded's cost_matrix + with_tie_jitter, and
//                   the value_base / task_feasible of ops/assign.py::
//                   assign_auction) one thread per (slot, provider) cell
//                   writes value_base[t, p] = -(jittered cost), or -1e18
//                   where the cost is >= INFEASIBLE/2, row per slot so the
//                   auction's row scans read it coalesced; a block covers
//                   256 providers of one slot and ORs task_feasible[t]. The
//                   cost is cell_cost (cell.cuh), K1's own cell function.
//   K7 auction      (ops/assign.py::assign_auction, the dense Jacobi
//                   auction, its lax.while_loop) all rounds in ONE
//                   cooperative launch with a grid barrier between steps,
//                   no host sync per round. A round:
//                     A. one warp per open slot (p4t < 0, feasible) scans
//                        its value row minus the prices: p1 = the first
//                        index of the maximum v1, v2 = the maximum with
//                        only p1 masked (a tie elsewhere gives v2 = v1),
//                        floored at -1e8; bid = (price[p1] + (v1 - v2)) +
//                        eps; a 64-bit atomicMax on (order-preserving bid
//                        bits << 32 | ~slot) keeps the highest bid per
//                        provider and, among equal bids, the lowest slot
//                        (the reference's argmax over the bid column);
//                     B. the winning slot of each provider evicts the old
//                        owner, takes the seat and sets the price to its
//                        bid; the win keys of the round before are reset
//                        here (two key buffers alternate by round parity);
//                   the open count is kept on the device (a win on a free
//                   provider closes one slot, an eviction reopens one), and
//                   `it < max_iters && open > 0` is tested before every
//                   round, as the reference's while_loop cond. The barrier
//                   is a monotone counter in device memory; the cooperative
//                   launch guarantees every block is resident.
//   K8 swarm argmin (_solve_unbounded) one warp per provider: each lane
//                   walks a strided share of the tasks and keeps the first
//                   argmin of the UNJITTERED cost (cell_cost<false>: the
//                   reference applies no tie jitter here), the lanes merge
//                   by (cost, index); -1 where that cost is >= INFEASIBLE/2.
//                   The [P, T] cost never reaches device memory.
//   K10 cost block  (_cost_only: the unjittered cost_matrix(ep, er, w)[0]
//                   of the anti-affinity and colocation phases, over a
//                   gathered provider subset) one thread per (slot,
//                   provider) cell writes cost[t, p] = cell_cost<false>,
//                   INFEASIBLE off the mask, slot-major so that each step
//                   of the bin-pack (binpack.cu, K11) reads one slot's
//                   column over all rows coalesced. The caller sees the
//                   reference's [P, T] meaning through a transposed view.
//
// What bounds them on the H100: K6, K8 and K10 score every cell with
// cell_cost, ~12 operations per cell and ~30 more per feasible one
// (K6 also writes 4 bytes per cell: at 4,096 x 4,096, 64 MB, which is the
// larger bound there; K10 likewise writes 4 bytes per cell). K7 reads the open slots' value rows each round,
// bound by bytes: sum over rounds of open rows x P x 4 bytes. Its first
// version keeps the prices in device memory (L2-resident) and spends
// two grid barriers per round.
//
// Numerics: built like candidates.cu (-fmad=false, no fast-math), so each
// f32 operation rounds once in the reference's order; the atomics are
// order-independent integer maxima. At proximity 0 every output is
// bit-identical to the plain torch versions (ops/assign.py,
// sched/torch_backend.py).

#include "cell.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e18f;  // _NEG as f32
constexpr float kV2Floor = -1e8f;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// ---------------------------------------------------------------- K6

__global__ void __launch_bounds__(kThreads) value_base_kernel(Prov prov, Req req, Aux aux,
                                                              Weights w, int P, int K, int W,
                                                              int n_chunks,
                                                              float* __restrict__ value_base,
                                                              uint8_t* __restrict__ feasible) {
  const int t = blockIdx.x / n_chunks;
  const int p = (blockIdx.x % n_chunks) * kThreads + threadIdx.x;
  const TaskRow tr = load_task(req, aux, t, K);
  bool ok = false;
  if (p < P) {
    const ProvRow pr = load_prov(prov, aux, p);
    const float c = cell_cost(pr, p, tr, t, req, K, W, w);
    ok = c < kHalfInfeasible;
    value_base[(size_t)t * P + p] = ok ? -c : kNeg;
  }
  if (__syncthreads_or(ok) && threadIdx.x == 0) feasible[t] = 1;
}

// ---------------------------------------------------------------- K7

// Grid-wide barrier: every block adds one to a monotone counter and waits
// until it reaches epoch x blocks. The counter starts at 0.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned n_blocks, unsigned& epoch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    ++epoch;
    __threadfence();
    atomicAdd(bar, 1u);
    const unsigned target = epoch * n_blocks;
    while (*(volatile unsigned*)bar < target) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) dense_auction_kernel(
    const float* __restrict__ vb, const uint8_t* __restrict__ feasible, int T, int P, float eps,
    int max_iters, float* price, int32_t* owner, int32_t* p4t, int32_t* fr_p1,
    unsigned long long* fr_key, unsigned long long* win_key, unsigned* bar, int* n_open,
    long long* out) {
  const int lane = threadIdx.x & 31;
  const int gtid = blockIdx.x * kThreads + threadIdx.x;
  const int n_threads = gridDim.x * kThreads;
  const int gwarp = gtid >> 5;
  const int n_warps = n_threads >> 5;
  unsigned epoch = 0;

  // every slot starts open if it is feasible
  int cnt = 0;
  for (int t = gtid; t < T; t += n_threads) cnt += feasible[t] ? 1 : 0;
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(kFull, cnt, o);
  if (lane == 0 && cnt) atomicAdd(n_open, cnt);
  grid_barrier(bar, gridDim.x, epoch);

  int it = 0;
  long long rows = 0;  // open rows summed over rounds (the launch's work)
  for (;;) {
    const int open_now = *(volatile int*)n_open;
    if (it >= max_iters || open_now == 0) break;
    rows += open_now;
    const int par = it & 1;
    unsigned long long* wk = win_key + (size_t)par * P;
    int32_t* fp = fr_p1 + (size_t)par * T;

    // ---- A. bids
    for (int t = gwarp; t < T; t += n_warps) {
      if (__ldcg(&p4t[t]) >= 0 || !feasible[t]) {
        if (lane == 0) fp[t] = -1;
        continue;
      }
      const float* row = vb + (size_t)t * P;
      float b1 = -INFINITY, b2 = -INFINITY;
      int i1 = P;
      for (int p = lane; p < P; p += 32) {
        const float v = __fsub_rn(row[p], __ldcg(&price[p]));
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
        const float v2 = fmaxf(b2, kV2Floor);
        const float bid = __fadd_rn(__fadd_rn(__ldcg(&price[i1]), __fsub_rn(b1, v2)), eps);
        const unsigned long long key =
            ((unsigned long long)ordered_bits(bid) << 32) | (unsigned long long)(~(uint32_t)t);
        atomicMax(&wk[i1], key);
        fp[t] = i1;
        fr_key[t] = key;
      }
    }
    grid_barrier(bar, gridDim.x, epoch);

    // ---- B. winners take their seats; last round's keys are reset
    unsigned long long* wk_prev = win_key + (size_t)(par ^ 1) * P;
    const int32_t* fp_prev = fr_p1 + (size_t)(par ^ 1) * T;
    for (int t = gtid; t < T; t += n_threads) {
      const int q = __ldcg(&fp_prev[t]);
      if (q >= 0) wk_prev[q] = 0ull;
      const int p = __ldcg(&fp[t]);
      if (p < 0) continue;
      const unsigned long long key = __ldcg(&fr_key[t]);
      if (__ldcg(&wk[p]) != key) continue;
      const int old = __ldcg(&owner[p]);
      if (old >= 0) {
        p4t[old] = -1;
      } else {
        atomicSub(n_open, 1);
      }
      p4t[t] = p;
      owner[p] = t;
      price[p] = from_ordered((uint32_t)(key >> 32));
    }
    grid_barrier(bar, gridDim.x, epoch);
    ++it;
  }
  if (gtid == 0) {
    out[0] = it;
    out[1] = rows;
  }
}

// ---------------------------------------------------------------- K8

__global__ void __launch_bounds__(kThreads) unbounded_best_kernel(Prov prov, Req req, Aux aux,
                                                                  Weights w, int P, int T, int K,
                                                                  int W,
                                                                  int32_t* __restrict__ best) {
  const int p = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (p >= P) return;  // warp-uniform
  const ProvRow pr = load_prov(prov, aux, p);
  float bc = INFINITY;
  int bt = T;
  for (int t = lane; t < T; t += 32) {
    const TaskRow tr = load_task(req, aux, t, K);
    const float c = cell_cost<false>(pr, p, tr, t, req, K, W, w);
    if (c < bc) {  // t grows: the first minimum of the lane stays
      bc = c;
      bt = t;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float oc = __shfl_xor_sync(kFull, bc, o);
    const int ot = __shfl_xor_sync(kFull, bt, o);
    if (oc < bc || (oc == bc && ot < bt)) {
      bc = oc;
      bt = ot;
    }
  }
  if (lane == 0) best[p] = bc < kHalfInfeasible ? bt : -1;
}

// ---------------------------------------------------------------- K10

__global__ void __launch_bounds__(kThreads) cost_block_kernel(Prov prov, Req req, Aux aux,
                                                              Weights w, int P, int K, int W,
                                                              int n_chunks,
                                                              float* __restrict__ cost) {
  const int t = blockIdx.x / n_chunks;
  const int p = (blockIdx.x % n_chunks) * kThreads + threadIdx.x;
  if (p >= P) return;
  const TaskRow tr = load_task(req, aux, t, K);
  const ProvRow pr = load_prov(prov, aux, p);
  cost[(size_t)t * P + p] = cell_cost<false>(pr, p, tr, t, req, K, W, w);
}

}  // namespace

// Plain C interface (loaded with ctypes). Each returns the launch's
// cudaError_t (0 = launched); nothing synchronises.

// K6: value_base [T, P] f32 and feasible [T] u8 (zero on entry).
extern "C" int k6_value_base(const void* const* prov_cols, const void* const* req_cols, int P,
                             int T, int K, int W, float w_price, float w_load, float w_prox,
                             float w_prio, float* aux, float* value_base, uint8_t* feasible,
                             void* stream) {
  if (P < 1 || T < 1 || K > kMaxOpts) return (int)cudaErrorInvalidValue;
  const Weights w{w_price, w_load, w_prox, w_prio};
  const Prov prov = make_prov(prov_cols);
  const Req req = make_req(req_cols);
  launch_prep(prov, req, w, P, T, aux, (cudaStream_t)stream);
  const int n_chunks = (P + kThreads - 1) / kThreads;
  const long long blocks = (long long)n_chunks * T;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  value_base_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      prov, req, make_aux(aux, P, T), w, P, K, W, n_chunks, value_base, feasible);
  return (int)cudaGetLastError();
}

// K7: the dense auction from scratch duals. State on entry: price 0,
// owner -1 [P], p4t -1 [T], fr_p1 -1 [2, T], win_key 0 [2, P], bar 0,
// n_open 0; fr_key [T] is scratch. out [2] i64 receives (rounds, open rows
// summed over the rounds).
extern "C" int k7_dense_auction(const float* value_base, const uint8_t* feasible, int T, int P,
                                float eps, int max_iters, float* price, int32_t* owner,
                                int32_t* p4t, int32_t* fr_p1, unsigned long long* fr_key,
                                unsigned long long* win_key, unsigned* bar, int* n_open,
                                long long* out, void* stream) {
  if (P < 1 || T < 1 || max_iters < 0) return (int)cudaErrorInvalidValue;
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dense_auction_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  // one warp per slot at most, and no more blocks than can be resident
  const long long want = ((long long)T * 32 + kThreads - 1) / kThreads;
  long long blocks = (long long)n_sm * per_sm;
  if (want < blocks) blocks = want;
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {(void*)&value_base, (void*)&feasible, (void*)&T, (void*)&P,
                  (void*)&eps, (void*)&max_iters, (void*)&price, (void*)&owner,
                  (void*)&p4t, (void*)&fr_p1, (void*)&fr_key, (void*)&win_key,
                  (void*)&bar, (void*)&n_open, (void*)&out};
  err = cudaLaunchCooperativeKernel((const void*)dense_auction_kernel, dim3((unsigned)blocks),
                                    dim3(kThreads), args, 0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K8: best [P] i32, the first argmin over T of the unjittered cost, -1
// where it is >= INFEASIBLE/2.
extern "C" int k8_unbounded_best(const void* const* prov_cols, const void* const* req_cols, int P,
                                 int T, int K, int W, float w_price, float w_load, float w_prox,
                                 float w_prio, float* aux, int32_t* best, void* stream) {
  if (P < 1 || T < 1 || K > kMaxOpts) return (int)cudaErrorInvalidValue;
  const Weights w{w_price, w_load, w_prox, w_prio};
  const Prov prov = make_prov(prov_cols);
  const Req req = make_req(req_cols);
  launch_prep(prov, req, w, P, T, aux, (cudaStream_t)stream);
  const long long threads = (long long)P * 32;
  unbounded_best_kernel<<<(int)((threads + kThreads - 1) / kThreads), kThreads, 0,
                          (cudaStream_t)stream>>>(prov, req, make_aux(aux, P, T), w, P, T, K, W,
                                                  best);
  return (int)cudaGetLastError();
}

// K10: cost [T, P] f32, slot-major: the unjittered cost of every cell,
// INFEASIBLE off the mask.
extern "C" int k10_cost_block(const void* const* prov_cols, const void* const* req_cols, int P,
                              int T, int K, int W, float w_price, float w_load, float w_prox,
                              float w_prio, float* aux, float* cost, void* stream) {
  if (P < 1 || T < 1 || K > kMaxOpts) return (int)cudaErrorInvalidValue;
  const Weights w{w_price, w_load, w_prox, w_prio};
  const Prov prov = make_prov(prov_cols);
  const Req req = make_req(req_cols);
  launch_prep(prov, req, w, P, T, aux, (cudaStream_t)stream);
  const int n_chunks = (P + kThreads - 1) / kThreads;
  const long long blocks = (long long)n_chunks * T;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cost_block_kernel<<<(int)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      prov, req, make_aux(aux, P, T), w, P, K, W, n_chunks, cost);
  return (int)cudaGetLastError();
}
