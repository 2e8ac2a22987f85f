// The repair refold of the warm path for Hopper (sm_90a): the part of the
// reference's churn-masked candidate repair (protocol_tpu/parallel/
// sparse.py: repair_topk_bidir_sharded) that is neither a K1 launch nor a
// list launch. K3 (the enter scan), K4 (the dirty-column tile minima) and
// the reverse blocks are list launches of K1's layout in candidates.cu,
// bound there (k3_repair_enter, k4_repair_tile_min, k1_reverse_blocks);
// this library holds K5 alone.
//
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
// What bounds it on the H100: K5 reads the pools once and writes the edges
// once: bound by bytes, ~P (n_tiles + r) x 8.
//
// Numerics: built like candidates.cu (-fmad=false, no fast-math); every
// output is bit-identical to the plain torch version in
// protocol_tpu_torch/parallel/sparse.py.

#include "cell.cuh"

namespace {

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

// Plain C interface (loaded with ctypes), as candidates.cu. Returns the
// launch's cudaError_t (0 = launched).
extern "C" int k5_repair_refold(const int32_t* pool_t, const float* pool_c, int P, int n_tiles,
                                int r, int d_fold, int32_t* rev_t, float* rev_c, void* stream) {
  if (r < 1 || r > kMaxR || P < 1 || d_fold < 1 || n_tiles < 1 || n_tiles % d_fold != 0)
    return (int)cudaErrorInvalidValue;
  refold_kernel<<<(P + 127) / 128, 128, 0, (cudaStream_t)stream>>>(pool_t, pool_c, P, n_tiles, r,
                                                                   d_fold, rev_t, rev_c);
  return (int)cudaGetLastError();
}
