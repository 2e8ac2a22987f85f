// Shared by the candidate and list kernels (candidates.cu, among them the
// dense matcher's K6, K8 and K10), the repair refold (repair.cu) and the
// blocked kernels (blocked.cu): the column
// layout, the per-row cost terms, the capability check, the exact
// jittered cost of one (provider, task) cell, and the fold of per-tile
// reverse pools into a provider's best r. Every kernel that scores a cell
// calls cell_cost, or compat_many and then feasible_cost (its arithmetic
// after the mask test), and both the cold reverse launch and the repair
// refold call fold_pools, so a repaired cell or edge is the same bits as a
// cold one.
//
// Jitter is keyed on the global provider and task ids the caller passes
// (a kernel that walks a gathered subset reads its columns at the global
// ids), so a subset lands on the exact cells of the full pass. A task's
// jitter key may be shifted by a runtime offset (the candidate launches'
// task_offset: delta batches generated under a persistent cursor), added
// once where the task row is loaded.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr float kInfeasible = 1e9f;
constexpr float kHalfInfeasible = 5e8f;  // INFEASIBLE * 0.5, exact in f32
constexpr float kTwoR = 12742.0f;        // 2 * EARTH_RADIUS_KM
constexpr int kMaxK = 64;                // forward top-k capacity
constexpr int kMaxR = 8;                 // reverse carry capacity
constexpr int kMaxOpts = 8;              // GPU OR-options per requirement

struct Prov {
  const int32_t* gpu_count;
  const int32_t* gpu_mem_mb;
  const int32_t* gpu_model_id;
  const uint8_t* has_gpu;
  const uint8_t* has_cpu;
  const int32_t* cpu_cores;
  const int32_t* ram_mb;
  const int32_t* storage_gb;
  const float* lat;
  const float* lon;
  const uint8_t* has_location;
  const float* price;
  const float* load;
  const uint8_t* valid;
};

struct Req {
  const uint8_t* cpu_required;
  const int32_t* cpu_cores;
  const int32_t* ram_mb;
  const int32_t* storage_gb;
  const uint8_t* gpu_opt_valid;
  const int32_t* gpu_count;
  const int32_t* gpu_mem_min;
  const int32_t* gpu_mem_max;
  const int32_t* gpu_total_mem_min;
  const int32_t* gpu_total_mem_max;
  const uint32_t* gpu_model_mask;
  const uint8_t* gpu_model_constrained;
  const float* lat;
  const float* lon;
  const uint8_t* has_location;
  const float* priority;
  const uint8_t* valid;
};

struct Weights {
  float price, load, proximity, priority;
};

// One provider's row, with its per-row cost terms hoisted.
struct ProvRow {
  int32_t count, mem, model, cores, ram, storage;
  bool has_gpu, has_cpu, has_loc, valid;
  float lat, lon, coslat, base;
};

// One requirement's scalar columns, with its per-row terms hoisted.
struct TaskRow {
  uint32_t jkey;  // the jitter's task key: (row id + offset) mod 2^32
  int32_t cores, ram, storage;
  bool cpu_required, any_opt, has_loc, valid;
  float lat, lon, coslat, prio;
};

__device__ __forceinline__ bool ge_min(int32_t spec, int32_t req) {
  return (req < 0) | ((spec >= 0) & (spec >= req));
}

__device__ __forceinline__ bool le_max(int32_t spec, int32_t req) {
  return (req < 0) | ((spec >= 0) & (spec <= req));
}

// Per-row cost terms, computed once per row by prep_kernel into aux:
// [p_base P][p_coslat P][t_prio T][t_coslat T].
struct Aux {
  const float* p_base;
  const float* p_coslat;
  const float* t_prio;
  const float* t_coslat;
};

__device__ __forceinline__ ProvRow load_prov(const Prov& P, const Aux& x, int p) {
  ProvRow r;
  r.count = P.gpu_count[p];
  r.mem = P.gpu_mem_mb[p];
  r.model = P.gpu_model_id[p];
  r.cores = P.cpu_cores[p];
  r.ram = P.ram_mb[p];
  r.storage = P.storage_gb[p];
  r.has_gpu = P.has_gpu[p] != 0;
  r.has_cpu = P.has_cpu[p] != 0;
  r.has_loc = P.has_location[p] != 0;
  r.valid = P.valid[p] != 0;
  r.lat = P.lat[p];
  r.lon = P.lon[p];
  r.coslat = x.p_coslat[p];
  r.base = x.p_base[p];
  return r;
}

__device__ __forceinline__ TaskRow load_task(const Req& R, const Aux& x, int t, int K,
                                             uint32_t jitter_offset = 0) {
  TaskRow r;
  r.jkey = (uint32_t)t + jitter_offset;
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
  r.coslat = x.t_coslat[t];
  r.prio = x.t_prio[t];
  return r;
}

// The terms of cost_matrix that depend on one side: a provider's base,
// weights.price * price + weights.load * load, one rounding per op, and a
// task's weighted priority. prep_kernel writes them for every row; the
// pair cost (K15) computes them for the rows it reads. A row's coslat is
// cosf(lat) in both.
__device__ __forceinline__ float prov_base(const Weights& w, float price, float load) {
  return __fadd_rn(__fmul_rn(w.price, price), __fmul_rn(w.load, load));
}

__device__ __forceinline__ float task_prio(const Weights& w, float priority) {
  return __fmul_rn(w.priority, priority);
}

// One thread per row: the terms of cost_matrix that depend on one side.
__global__ void prep_kernel(Prov prov, Req req, Weights w, int P, int T, float* aux) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < P) {
    aux[i] = prov_base(w, prov.price[i], prov.load[i]);
    aux[P + i] = cosf(prov.lat[i]);
  }
  if (i < T) {
    aux[2 * P + i] = task_prio(w, req.priority[i]);
    aux[2 * P + T + i] = cosf(req.lat[i]);
  }
}

Aux make_aux(const float* aux, int P, int T) {
  return Aux{aux, aux + P, aux + 2 * P, aux + 2 * P + T};
}

void launch_prep(const Prov& prov, const Req& req, const Weights& w, int P, int T, float* aux,
                 cudaStream_t stream) {
  const int n = P > T ? P : T;
  prep_kernel<<<(n + 255) / 256, 256, 0, stream>>>(prov, req, w, P, T, aux);
}

// compat_mask for one cell: the reference's rules in its order.
__device__ __forceinline__ bool compat(const ProvRow& p, const TaskRow& t, const Req& R,
                                       int ti, int K, int W) {
  bool ok = !t.cpu_required | (p.has_cpu & ge_min(p.cores, t.cores));
  ok &= ge_min(p.ram, t.ram);
  ok &= ge_min(p.storage, t.storage);
  ok &= p.valid & t.valid;
  if (!ok) return false;
  if (!t.any_opt) return true;
  if (!p.has_gpu) return false;
  const int32_t pc = p.count, pm = p.mem;
  // i32 product, wrapping as the reference's does
  const int32_t total = (int32_t)((uint32_t)pc * (uint32_t)pm);
  const bool have_total = (pc >= 0) & (pm >= 0);
  const int mid = p.model < 0 ? 0 : p.model;
  const int word = mid >> 5;
  const uint32_t bit = (uint32_t)(mid & 31);
  const bool has_model = p.model >= 0;
  for (int k = 0; k < K; ++k) {
    const int o = ti * K + k;
    if (!R.gpu_opt_valid[o]) continue;
    const int32_t rc = R.gpu_count[o];
    const bool count_ok = (rc < 0) | (pc < 0 ? rc == 0 : pc == rc);
    const bool mem_ok = ge_min(pm, R.gpu_mem_min[o]) & le_max(pm, R.gpu_mem_max[o]);
    const int32_t tmin = R.gpu_total_mem_min[o], tmax = R.gpu_total_mem_max[o];
    const bool tot_ok = ((tmin < 0) | !have_total | (total >= tmin)) &
                        ((tmax < 0) | !have_total | (total <= tmax));
    bool model_ok = true;
    if (R.gpu_model_constrained[o]) {
      const uint32_t wbits = word < W ? R.gpu_model_mask[(size_t)o * W + word] : 0u;
      model_ok = has_model & (((wbits >> bit) & 1u) != 0u);
    }
    if (count_ok & mem_ok & tot_ok & model_ok) return true;
  }
  return false;
}

// A requirement row's capability limits, staged where a kernel checks many
// providers against few rows. An absent limit (< 0) is folded into the
// staged value once, so that each rule of compat is one compare a cell:
//   ge_min(spec, req) == (spec >= (req < 0 ? INT_MIN : req)): for req >= 0,
//     spec >= req implies spec >= 0;
//   le_max(spec, req) == ((uint32_t)spec <= (req < 0 ? UINT32_MAX : req)):
//     a negative spec is above every non-negative req as unsigned;
//   the total-memory rule's (lim < 0) | (total op lim) likewise, with INT_MIN
//     and INT_MAX.
// Row flags: bit 0 cpu_required, bit 1 valid, bit 2 any GPU option. An
// option's flags: bit 0 gpu_opt_valid, bit 1 gpu_model_constrained.
struct alignas(16) RowCaps {
  int32_t cores, ram, storage;
  uint32_t flags;
};

struct alignas(16) OptCaps {
  int32_t count, mem_min;
  uint32_t mem_max;
  int32_t tot_min, tot_max;
  uint32_t flags;
  int32_t pad0, pad1;
};

__device__ __forceinline__ int32_t stage_min(int32_t req) { return req < 0 ? INT32_MIN : req; }

__device__ __forceinline__ RowCaps load_row_caps(const TaskRow& t) {
  RowCaps c;
  c.cores = stage_min(t.cores);
  c.ram = stage_min(t.ram);
  c.storage = stage_min(t.storage);
  c.flags = (t.cpu_required ? 1u : 0u) | (t.valid ? 2u : 0u) | (t.any_opt ? 4u : 0u);
  return c;
}

__device__ __forceinline__ OptCaps load_opt(const Req& R, int o) {
  OptCaps c;
  const int32_t mmax = R.gpu_mem_max[o], tmax = R.gpu_total_mem_max[o];
  c.count = R.gpu_count[o];
  c.mem_min = stage_min(R.gpu_mem_min[o]);
  c.mem_max = mmax < 0 ? 0xffffffffu : (uint32_t)mmax;
  c.tot_min = stage_min(R.gpu_total_mem_min[o]);
  c.tot_max = tmax < 0 ? INT32_MAX : tmax;
  c.flags = (R.gpu_opt_valid[o] ? 1u : 0u) | (R.gpu_model_constrained[o] ? 2u : 0u);
  c.pad0 = c.pad1 = 0;
  return c;
}

// compat for N providers against one requirement row at once: compat's
// rules on the row's staged limits (one compare a rule, above) and its K
// options (each loaded once for the N providers), the model masks read at
// mask_row (gpu_model_mask + row * K * W). Bit i of the result is
// compat(p[i], t). Every branch is on the row's fields alone (no option
// loop that ends per lane), so a warp checking its lanes' providers
// against one row never diverges.
template <int N>
__device__ __forceinline__ uint32_t compat_many(const ProvRow* p, const RowCaps& t,
                                                const OptCaps* opts, const uint32_t* mask_row,
                                                int K, int W) {
  uint32_t gate = 0, ok_bits = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    bool ok = !(t.flags & 1u) | (p[i].has_cpu & (p[i].cores >= t.cores));
    ok &= (p[i].ram >= t.ram) & (p[i].storage >= t.storage);
    ok &= p[i].valid & ((t.flags & 2u) != 0u);
    ok_bits |= (ok ? 1u : 0u) << i;
    gate |= (ok & p[i].has_gpu ? 1u : 0u) << i;
  }
  if (!(t.flags & 4u)) return ok_bits;
  uint32_t found = 0;
  for (int k = 0; k < K; ++k) {
    const OptCaps o = opts[k];
    if (!(o.flags & 1u)) continue;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int32_t pc = p[i].count, pm = p[i].mem;
      // i32 product, wrapping as the reference's does
      const int32_t total = (int32_t)((uint32_t)pc * (uint32_t)pm);
      const bool have_total = (pc >= 0) & (pm >= 0);
      const bool count_ok = (o.count < 0) | (pc < 0 ? o.count == 0 : pc == o.count);
      const bool mem_ok = (pm >= o.mem_min) & ((uint32_t)pm <= o.mem_max);
      const bool tot_ok = !have_total | ((total >= o.tot_min) & (total <= o.tot_max));
      bool model_ok = true;
      if (o.flags & 2u) {
        const int mid = p[i].model < 0 ? 0 : p[i].model;
        const int word = mid >> 5;
        const uint32_t wbits = word < W ? mask_row[(size_t)k * W + word] : 0u;
        model_ok = (p[i].model >= 0) & (((wbits >> (uint32_t)(mid & 31)) & 1u) != 0u);
      }
      if (count_ok & mem_ok & tot_ok & model_ok) found |= gate & (1u << i);
    }
  }
  return found;
}

// The cost terms of a compatible cell: cost_matrix's in its order,
// base + proximity * haversine (0 unless both sides are located) - prio,
// from the provider's (base, lat, lon, coslat) and the task's (lat, lon,
// coslat, prio). Halving is a multiplication by 0.5, which rounds to the
// same bits as the reference's division by 2.
__device__ __forceinline__ float cell_terms(float base, float plat, float plon, float pcos,
                                            bool p_loc, float tlat, float tlon, float tcos,
                                            bool t_loc, float prio, float proximity) {
  float near = 0.0f;
  if (p_loc & t_loc) {
    const float dlat = __fsub_rn(tlat, plat);
    const float dlon = __fsub_rn(tlon, plon);
    const float s1 = sinf(__fmul_rn(dlat, 0.5f));
    const float s2 = sinf(__fmul_rn(dlon, 0.5f));
    float a = __fadd_rn(__fmul_rn(s1, s1), __fmul_rn(__fmul_rn(pcos, tcos), __fmul_rn(s2, s2)));
    a = fminf(fmaxf(a, 0.0f), 1.0f);
    const float dist = __fmul_rn(kTwoR, asinf(__fsqrt_rn(a)));
    near = __fmul_rn(proximity, dist);
  }
  return __fsub_rn(__fadd_rn(base, near), prio);
}

// The exact cost of cell (p, t): compat, then cell_terms, INFEASIBLE off
// the mask, plus tie_jitter on feasible cells when kJitter (the
// candidate, repair and dense auction kernels), keyed on provider id pi
// and the task's jkey; without it for the swarm phase's argmin (K8) and
// the pair cost (K15), which the reference scores unjittered.
template <bool kJitter = true>
__device__ __forceinline__ float cell_cost(const ProvRow& p, int pi, const TaskRow& t, int ti,
                                           const Req& R, int K, int W, const Weights& w) {
  if (!compat(p, t, R, ti, K, W)) return kInfeasible;
  float cost = cell_terms(p.base, p.lat, p.lon, p.coslat, p.has_loc, t.lat, t.lon, t.coslat,
                          t.has_loc, t.prio, w.proximity);
  if (kJitter && cost < kHalfInfeasible) {
    const uint32_t h = ((uint32_t)pi * 2654435761u) ^ (t.jkey * 40503u);
    cost = __fadd_rn(cost, __fmul_rn((float)(h & 1023u), 1e-7f));
  }
  return cost;
}

// The cost of a cell that compat admits: cell_cost<kJitter>'s arithmetic
// after its mask test, operation for operation, the jitter included when
// kJitter. The list and candidate kernels check every cell first and
// score the feasible ones apart.
template <bool kJitter = true>
__device__ __forceinline__ float feasible_cost(const ProvRow& p, int pi, const TaskRow& t,
                                               const Weights& w) {
  float cost = cell_terms(p.base, p.lat, p.lon, p.coslat, p.has_loc, t.lat, t.lon, t.coslat,
                          t.has_loc, t.prio, w.proximity);
  if (kJitter && cost < kHalfInfeasible) {
    const uint32_t h = ((uint32_t)pi * 2654435761u) ^ (t.jkey * 40503u);
    cost = __fadd_rn(cost, __fmul_rn((float)(h & 1023u), 1e-7f));
  }
  return cost;
}

Prov make_prov(const void* const* a) {
  Prov p;
  p.gpu_count = (const int32_t*)a[0];
  p.gpu_mem_mb = (const int32_t*)a[1];
  p.gpu_model_id = (const int32_t*)a[2];
  p.has_gpu = (const uint8_t*)a[3];
  p.has_cpu = (const uint8_t*)a[4];
  p.cpu_cores = (const int32_t*)a[5];
  p.ram_mb = (const int32_t*)a[6];
  p.storage_gb = (const int32_t*)a[7];
  p.lat = (const float*)a[8];
  p.lon = (const float*)a[9];
  p.has_location = (const uint8_t*)a[10];
  p.price = (const float*)a[11];
  p.load = (const float*)a[12];
  p.valid = (const uint8_t*)a[13];
  return p;
}

Req make_req(const void* const* a) {
  Req r;
  r.cpu_required = (const uint8_t*)a[0];
  r.cpu_cores = (const int32_t*)a[1];
  r.ram_mb = (const int32_t*)a[2];
  r.storage_gb = (const int32_t*)a[3];
  r.gpu_opt_valid = (const uint8_t*)a[4];
  r.gpu_count = (const int32_t*)a[5];
  r.gpu_mem_min = (const int32_t*)a[6];
  r.gpu_mem_max = (const int32_t*)a[7];
  r.gpu_total_mem_min = (const int32_t*)a[8];
  r.gpu_total_mem_max = (const int32_t*)a[9];
  r.gpu_model_mask = (const uint32_t*)a[10];
  r.gpu_model_constrained = (const uint8_t*)a[11];
  r.lat = (const float*)a[12];
  r.lon = (const float*)a[13];
  r.has_location = (const uint8_t*)a[14];
  r.priority = (const float*)a[15];
  r.valid = (const uint8_t*)a[16];
  return r;
}

// Fold n_tiles pool entries (one per tile, in tile order, at
// pool_t/pool_c[base + j]) into a register top-r carry (rc, rt), which
// starts at (INFEASIBLE, -1): each entry enters before the first carry
// entry that is strictly worse, the rest shift down, so the carry wins
// ties. This is the stable top-r of concat(carry, entry) per tile, the
// reference's scan step.
__device__ __forceinline__ void fold_pools(const int32_t* pool_t, const float* pool_c,
                                           size_t base, int n_tiles, int r, float* rc,
                                           int32_t* rt) {
#pragma unroll
  for (int i = 0; i < kMaxR; ++i) {
    rc[i] = kInfeasible;
    rt[i] = -1;
  }
  for (int ti = 0; ti < n_tiles; ++ti) {
    float c = pool_c[base + ti];
    int32_t tt = pool_t[base + ti];
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

}  // namespace
