// Repair kernels of the warm path for Hopper (sm_90a): the parts of the
// reference's churn-masked candidate repair (protocol_tpu/parallel/
// sparse.py: repair_topk_bidir_sharded) that are not a K1 launch. K4, the
// dirty-column tile minima, is one of K1's list launches (candidates.cu).
//
//   K3 enter     (_build_repair_enter) one thread per task walks the dirty
//                providers (global ids, read from the full columns) and
//                flags the task when some fresh jittered cost is <= the
//                task's stored k-th cost and feasible: such rows are the
//                ones whose forward top-k a dirty provider can enter. The
//                test keeps the reference's <=, which over-flags exact ties
//                on purpose (a flagged row is recomputed exactly). Every
//                dirty provider is scored for every task: no early exit,
//                so the work is n_dirty x T cells whatever the data. A
//                jitter offset (a uint32, added once where the task row is
//                loaded, as K1's) keys the jitter on offset + t: a shard of
//                the provider mesh scans its own rows at their global ids
//                (_build_repair_enter_sharded, B5s).
//   K5 refold    (_build_repair_refold + _merge_rev_pools at d_fold
//                lanes) one thread per provider: each lane l folds its
//                n_tiles / d_fold consecutive pool entries in tile order
//                into a best r with fold_pools (cell.cuh), the same device
//                function the cold reverse launch folds with, from the
//                (INFEASIBLE, -1) carry (a lane may hold fewer tiles than
//                r); each later lane's list is then inserted, best first,
//                into the first lane's by the same rule, the earlier entry
//                first among ties: the stable top-r of the lanes'
//                concatenation in lane order. Writes rev_t (-1 where the
//                cost is >= INFEASIBLE/2) and rev_c [P, r]. At one lane the
//                merge is the identity.
//
// What bounds them on the H100: K3 scores cells with cell_cost, so it is
// bound by its arithmetic like K1, over n_dirty x T cells (small at 1%
// churn); the loop side (the providers) is a warp-uniform load that hits
// L1. K5 reads the pools once and writes the edges once: bound by bytes,
// ~P (n_tiles + r) x 8.
//
// Numerics: built like candidates.cu (-fmad=false, no fast-math); with
// proximity 0 every output is bit-identical to the plain torch versions
// in protocol_tpu_torch/parallel/sparse.py.

#include "cell.cuh"

namespace {

__global__ void __launch_bounds__(128) enter_kernel(Prov prov, Req req, Aux aux, Weights w, int T,
                                                    int K, int W, const int32_t* __restrict__ p_ids,
                                                    int n_p, uint32_t offset,
                                                    const float* __restrict__ thresh,
                                                    uint8_t* __restrict__ enter) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const TaskRow tr = load_task(req, aux, t, K, offset);
  const float th = thresh[t];
  bool hit = false;
  for (int i = 0; i < n_p; ++i) {
    const int p = p_ids[i];
    const ProvRow pr = load_prov(prov, aux, p);
    const float c = cell_cost(pr, p, tr, t, req, K, W, w);
    hit |= (c <= th) & (c < kHalfInfeasible);
  }
  enter[t] = hit ? 1 : 0;
}

__global__ void __launch_bounds__(128) refold_kernel(const int32_t* __restrict__ pool_t,
                                                     const float* __restrict__ pool_c, int P,
                                                     int n_tiles, int r, int d_fold,
                                                     int32_t* __restrict__ rev_t,
                                                     float* __restrict__ rev_c) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int ntl = n_tiles / d_fold;
  float rc[kMaxR];
  int32_t rt[kMaxR];
  fold_pools(pool_t, pool_c, (size_t)p * n_tiles, ntl, r, rc, rt);
  for (int lane = 1; lane < d_fold; ++lane) {
    float lc[kMaxR];
    int32_t lt[kMaxR];
    fold_pools(pool_t, pool_c, (size_t)p * n_tiles + (size_t)lane * ntl, ntl, r, lc, lt);
    for (int j = 0; j < r; ++j) {  // the lane's list, best first, after the earlier lanes'
      float c = lc[j];
      int32_t tt = lt[j];
      bool moved = false;
#pragma unroll
      for (int i = 0; i < kMaxR; ++i) {
        if (i < r && (moved || c < rc[i])) {
          const float sc = rc[i];
          const int32_t st = rt[i];
          rc[i] = c;
          rt[i] = tt;
          c = sc;
          tt = st;
          moved = true;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxR; ++i) {
    if (i < r) {
      rev_c[(size_t)p * r + i] = rc[i];
      rev_t[(size_t)p * r + i] = rc[i] < kHalfInfeasible ? rt[i] : -1;
    }
  }
}

}  // namespace

// Plain C interface (loaded with ctypes), as candidates.cu. Each returns
// the launch's cudaError_t (0 = launched).
extern "C" int k3_repair_enter(const void* const* prov_cols, const void* const* req_cols, int P,
                               int T, int K, int W, float w_price, float w_load, float w_prox,
                               float w_prio, const int32_t* p_ids, int n_p,
                               unsigned int offset, const float* thresh, float* aux,
                               uint8_t* enter, void* stream) {
  if (K > kMaxOpts || n_p < 1 || T < 1) return (int)cudaErrorInvalidValue;
  const Weights w{w_price, w_load, w_prox, w_prio};
  const Prov prov = make_prov(prov_cols);
  const Req req = make_req(req_cols);
  launch_prep(prov, req, w, P, T, aux, (cudaStream_t)stream);
  enter_kernel<<<(T + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      prov, req, make_aux(aux, P, T), w, T, K, W, p_ids, n_p, offset, thresh, enter);
  return (int)cudaGetLastError();
}

extern "C" int k5_repair_refold(const int32_t* pool_t, const float* pool_c, int P, int n_tiles,
                                int r, int d_fold, int32_t* rev_t, float* rev_c, void* stream) {
  if (r < 1 || r > kMaxR || P < 1 || d_fold < 1 || n_tiles < 1 || n_tiles % d_fold != 0)
    return (int)cudaErrorInvalidValue;
  refold_kernel<<<(P + 127) / 128, 128, 0, (cudaStream_t)stream>>>(pool_t, pool_c, P, n_tiles, r,
                                                                   d_fold, rev_t, rev_c);
  return (int)cudaGetLastError();
}
