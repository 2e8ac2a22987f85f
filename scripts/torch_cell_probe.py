#!/usr/bin/env python3
"""Where the one-thread-a-cell kernels spend their cycles: K3 (the enter
scan) and K10 (the dense cost block) as they stood before their list
launches, on one NVIDIA card.

    python3 scripts/torch_cell_probe.py [--root DIR]

Compiles, from this file, a library of two kernels that repeat the older
K3 (one thread a task walks the dirty providers, each cell through
``load_prov``, ``compat`` and the cell's terms) and the older K10 (one
thread a (slot, provider) cell, 256 threads a block of one slot), each in
a plain and a probed copy, over ``cell.cuh`` of the checkout at ``--root``
(default: this one), into ``build/probe/``. The probed copies read
``clock64`` around each part of a cell and sum the cycles over every
thread (a warp's sums added once): the row loads, the capability check,
the terms (the haversine and the jitter, on feasible cells only), and the
whole thread. Prints, per call, cycles a cell by part, the plain copy's ms
by CUDA events (mean of 10 after a warm-up), its registers and resident
blocks an SM (the occupancy API), the launch's blocks an SM, and a sha256
of both copies' output beside the checkout's own kernel's.

The calls: K3 on the 1% provider-churn repair's enter call at 65,536^2
(``scripts/torch_repair_ab.py``'s, rebuilt from the same seeds) and on the
last of its four task shards at offset 49,152; K10 on the colocation call,
the wide run's phase 0 call and the backend's 4,096^2 block
(``scripts/torch_dense_ab.py``'s). Prints the card's name and power limit
and, last, one JSON line. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import json
import os
import pathlib
import subprocess
import sys

SRC = r"""
#include "cell.cuh"

namespace {

using u64 = unsigned long long;

// a value the clock read after it waits for: one real instruction on it
__device__ __forceinline__ void wait_for(uint32_t x) {
  uint32_t y;
  asm volatile("add.u32 %0, %1, 1;" : "=r"(y) : "r"(x));
}

__device__ __forceinline__ uint32_t fold_prov(const ProvRow& r) {
  return (uint32_t)(r.count ^ r.mem ^ r.model ^ r.cores ^ r.ram ^ r.storage) ^
         __float_as_uint(r.lat) ^ __float_as_uint(r.lon) ^ __float_as_uint(r.coslat) ^
         __float_as_uint(r.base) ^ (uint32_t)(r.has_gpu + r.has_cpu + r.has_loc + r.valid);
}

__device__ __forceinline__ uint32_t fold_task(const TaskRow& r) {
  return r.jkey ^ (uint32_t)(r.cores ^ r.ram ^ r.storage) ^ __float_as_uint(r.lat) ^
         __float_as_uint(r.lon) ^ __float_as_uint(r.coslat) ^ __float_as_uint(r.prio) ^
         (uint32_t)(r.cpu_required + r.any_opt + r.has_loc + r.valid);
}

// acc: [loads, check, terms, thread total, cells, feasible cells]; every
// lane of the warp calls it
__device__ __forceinline__ void add_warp(u64* acc, u64 v[6]) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int i = 0; i < 6; ++i) atomicAdd(acc + i, v[i]);
}

__device__ __forceinline__ float jittered(const ProvRow& pr, int p, const TaskRow& tr,
                                          const Weights& w, bool jitter) {
  float cost = cell_terms(pr.base, pr.lat, pr.lon, pr.coslat, pr.has_loc, tr.lat, tr.lon,
                          tr.coslat, tr.has_loc, tr.prio, w.proximity);
  if (jitter && cost < kHalfInfeasible) {
    const uint32_t h = ((uint32_t)p * 2654435761u) ^ (tr.jkey * 40503u);
    cost = __fadd_rn(cost, __fmul_rn((float)(h & 1023u), 1e-7f));
  }
  return cost;
}

template <bool kProbe>
__global__ void __launch_bounds__(128) enter_copy(Prov prov, Req req, Aux aux, Weights w, int T,
                                                  int K, int W, const int32_t* __restrict__ p_ids,
                                                  int n_p, uint32_t offset,
                                                  const float* __restrict__ thresh,
                                                  uint8_t* __restrict__ enter, u64* acc) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  u64 v[6] = {0, 0, 0, 0, 0, 0};
  if (t < T) {
    const long long c0 = kProbe ? clock64() : 0;
    const TaskRow tr = load_task(req, aux, t, K, offset);
    const float th = thresh[t];
    if (kProbe) {
      wait_for(fold_task(tr) ^ __float_as_uint(th));
      v[0] += clock64() - c0;
    }
    bool hit = false;
    for (int i = 0; i < n_p; ++i) {
      const long long a = kProbe ? clock64() : 0;
      const int p = p_ids[i];
      const ProvRow pr = load_prov(prov, aux, p);
      long long b = 0, c = 0;
      if (kProbe) {
        wait_for(fold_prov(pr));
        b = clock64();
      }
      const bool ok = compat(pr, tr, req, t, K, W);
      if (kProbe) {
        wait_for(ok);
        c = clock64();
      }
      const float cost = ok ? jittered(pr, p, tr, w, true) : kInfeasible;
      if (kProbe) {
        wait_for(__float_as_uint(cost));
        const long long d = clock64();
        v[0] += b - a;
        v[1] += c - b;
        v[2] += d - c;
        v[5] += ok;
      }
      hit |= (cost <= th) & (cost < kHalfInfeasible);
    }
    enter[t] = hit ? 1 : 0;
    if (kProbe) {
      v[3] = clock64() - c0;
      v[4] = n_p;
    }
  }
  if (kProbe) add_warp(acc, v);
}

template <bool kProbe>
__global__ void __launch_bounds__(256) cost_copy(Prov prov, Req req, Aux aux, Weights w, int P,
                                                 int K, int W, int n_chunks,
                                                 float* __restrict__ cost, u64* acc) {
  const int t = blockIdx.x / n_chunks;
  const int p = (blockIdx.x % n_chunks) * 256 + threadIdx.x;
  u64 v[6] = {0, 0, 0, 0, 0, 0};
  if (p < P) {
    const long long a = kProbe ? clock64() : 0;
    const TaskRow tr = load_task(req, aux, t, K);
    const ProvRow pr = load_prov(prov, aux, p);
    long long b = 0, c = 0;
    if (kProbe) {
      wait_for(fold_task(tr) ^ fold_prov(pr));
      b = clock64();
    }
    const bool ok = compat(pr, tr, req, t, K, W);
    if (kProbe) {
      wait_for(ok);
      c = clock64();
    }
    const float x = ok ? jittered(pr, p, tr, w, false) : kInfeasible;
    if (kProbe) {
      wait_for(__float_as_uint(x));
      v[2] = clock64() - c;
    }
    cost[(size_t)t * P + p] = x;
    if (kProbe) {
      v[0] = b - a;
      v[1] = c - b;
      v[3] = clock64() - a;
      v[4] = 1;
      v[5] = ok;
    }
  }
  if (kProbe) add_warp(acc, v);
}

template <class F>
int occupancy(F kern, int threads, int* per_sm, int* regs) {
  cudaFuncAttributes at;
  cudaError_t e = cudaFuncGetAttributes(&at, kern);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, threads, 0);
  *regs = at.numRegs;
  return (int)e;
}

}  // namespace

extern "C" int probe_enter(const void* const* prov_cols, const void* const* req_cols, int P, int T,
                           int K, int W, float w_price, float w_load, float w_prox, float w_prio,
                           const int32_t* p_ids, int n_p, unsigned int offset, const float* thresh,
                           float* aux, uint8_t* enter, u64* acc, int probe, void* stream) {
  const Weights w{w_price, w_load, w_prox, w_prio};
  const Prov prov = make_prov(prov_cols);
  const Req req = make_req(req_cols);
  launch_prep(prov, req, w, P, T, aux, (cudaStream_t)stream);
  auto kern = probe ? enter_copy<true> : enter_copy<false>;
  kern<<<(T + 127) / 128, 128, 0, (cudaStream_t)stream>>>(prov, req, make_aux(aux, P, T), w, T, K,
                                                          W, p_ids, n_p, offset, thresh, enter,
                                                          acc);
  return (int)cudaGetLastError();
}

extern "C" int probe_cost(const void* const* prov_cols, const void* const* req_cols, int P, int T,
                          int K, int W, float w_price, float w_load, float w_prox, float w_prio,
                          float* aux, float* cost, u64* acc, int probe, void* stream) {
  const Weights w{w_price, w_load, w_prox, w_prio};
  const Prov prov = make_prov(prov_cols);
  const Req req = make_req(req_cols);
  launch_prep(prov, req, w, P, T, aux, (cudaStream_t)stream);
  const int n_chunks = (P + 255) / 256;
  auto kern = probe ? cost_copy<true> : cost_copy<false>;
  kern<<<n_chunks * T, 256, 0, (cudaStream_t)stream>>>(prov, req, make_aux(aux, P, T), w, P, K, W,
                                                       n_chunks, cost, acc);
  return (int)cudaGetLastError();
}

// which 0: the plain K3 copy, 1: the plain K10 copy
extern "C" int probe_occupancy(int which, int* per_sm, int* regs) {
  return which == 0 ? occupancy(enter_copy<false>, 128, per_sm, regs)
                    : occupancy(cost_copy<false>, 256, per_sm, regs);
}
"""

PARTS = ("loads", "check", "terms", "thread")
PROVIDER_CHURN_SEED = 7
SHARDS = 4


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def sha(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def build(kernels, csrc: pathlib.Path) -> ctypes.CDLL:
    """The probe library, compiled with the kernels' own flags over ``csrc``'s
    headers into build/probe/."""
    out_dir = pathlib.Path(__file__).resolve().parent.parent / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "cell_probe.cu"
    src.write_text(SRC)
    lib = out_dir / "libcell_probe.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(csrc), "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"probe build failed:\n{proc.stdout}\n{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas probe: {line.strip()}", flush=True)
    so = ctypes.CDLL(str(lib))
    P_, I_, F_, U_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
    so.probe_enter.argtypes = [P_, P_, I_, I_, I_, I_, F_, F_, F_, F_, P_, I_, U_, P_, P_, P_, P_,
                               I_, P_]
    so.probe_cost.argtypes = [P_, P_, I_, I_, I_, I_, F_, F_, F_, F_, P_, P_, P_, I_, P_]
    so.probe_occupancy.argtypes = [I_, P_, P_]
    for fn in ("probe_enter", "probe_cost", "probe_occupancy"):
        getattr(so, fn).restype = I_
    return so


def summarise(acc, launch, sms: int, per_sm: int, regs: int, blocks: int,
              threads: int) -> dict:
    v = acc.cpu().tolist()
    cells = max(v[4], 1)
    r = {f"{name}_cycles_a_cell": v[i] / cells for i, name in enumerate(PARTS)}
    r["terms_cycles_a_feasible_cell"] = v[2] / max(v[5], 1)
    r["feasible_share"] = v[5] / cells
    r["cells"] = v[4]
    r["registers"] = regs
    r["resident_blocks_an_sm"] = per_sm
    r["launch_blocks_an_sm"] = blocks / sms
    r["warps_an_sm"] = min(per_sm, blocks / sms) * threads / 32
    r["plain_ms"] = launch
    return r


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import torch_dense_ab as dab
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops import sparse as sp
    from protocol_tpu_torch.ops.cost import CostWeights
    from protocol_tpu_torch.sched import torch_backend as tb
    from protocol_tpu_torch.trace.synth import synth_providers, synth_requirements

    card = card_line()
    print(f"card: {card}", flush=True)
    kernels.build()
    so = build(kernels, pathlib.Path(root) / "protocol_tpu_torch" / "csrc")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    occ = {}
    for which in (0, 1):
        per_sm, regs = ctypes.c_int(0), ctypes.c_int(0)
        kernels._check(so.probe_occupancy(which, ctypes.byref(per_sm), ctypes.byref(regs)),
                       "probe_occupancy")
        occ[which] = (per_sm.value, regs.value)
    out = {"root": root, "card": card, "sms": sms}

    def run(fn, *a):
        kernels._check(fn(*a), fn.__name__)

    def enter_probe(label, ep, er, w, p_ids, thresh, offset):
        _, pcols, rcols, (P, T, K, W), wt, aux = kernels._k1_setup(ep, er, w)
        ids = p_ids.to(torch.int32).contiguous()
        enter = torch.empty(T, dtype=torch.uint8, device="cuda")
        acc = torch.zeros(6, dtype=torch.int64, device="cuda")
        st = kernels._stream(enter)

        def plain():
            run(so.probe_enter, pcols, rcols, P, T, K, W, *wt, ids.data_ptr(), ids.numel(),
                offset, thresh.data_ptr(), aux.data_ptr(), enter.data_ptr(), acc.data_ptr(), 0, st)

        ms = cs.cuda_ms(torch, plain, 10)
        plain_sha = sha(enter)
        acc.zero_()
        run(so.probe_enter, pcols, rcols, P, T, K, W, *wt, ids.data_ptr(), ids.numel(), offset,
            thresh.data_ptr(), aux.data_ptr(), enter.data_ptr(), acc.data_ptr(), 1, st)
        torch.cuda.synchronize()
        blocks = (T + 127) // 128
        r = summarise(acc, ms, sms, *occ[0], blocks, 128)
        r.update(providers=ids.numel(), tasks=T, offset=offset, sha_copy=plain_sha,
                 sha_probed=sha(enter),
                 sha_kernel=sha(kernels.repair_enter(ep, er, w, p_ids, thresh, offset=offset)
                                .to(torch.uint8)))
        print(f"K3 {label}: {json.dumps(r)}", flush=True)
        return r

    def cost_probe(label, ep, er, w):
        _, pcols, rcols, (P, T, K, W), wt, aux = kernels._k1_setup(ep, er, w)
        cost = torch.empty((T, P), dtype=torch.float32, device="cuda")
        acc = torch.zeros(6, dtype=torch.int64, device="cuda")
        st = kernels._stream(cost)

        def plain():
            run(so.probe_cost, pcols, rcols, P, T, K, W, *wt, aux.data_ptr(), cost.data_ptr(),
                acc.data_ptr(), 0, st)

        ms = cs.cuda_ms(torch, plain, 10)
        plain_sha = sha(cost)
        acc.zero_()
        run(so.probe_cost, pcols, rcols, P, T, K, W, *wt, aux.data_ptr(), cost.data_ptr(),
            acc.data_ptr(), 1, st)
        torch.cuda.synchronize()
        blocks = (P + 255) // 256 * T
        r = summarise(acc, ms, sms, *occ[1], blocks, 256)
        r.update(T=T, P=P, sha_copy=plain_sha, sha_probed=sha(cost),
                 sha_kernel=sha(kernels.cost_block(ep, er, w)))
        print(f"K10 {label}: {json.dumps(r)}", flush=True)
        return r

    # K3: the 1% provider-churn repair's enter call at 65,536^2, as
    # scripts/torch_repair_ab.py draws it (dirty tasks first, then the
    # dirty providers from the same stream)
    n, w = cs.N, CostWeights()
    ep = synth_providers(np.random.default_rng(2), n, device="cuda")
    er = synth_requirements(np.random.default_rng(3), n, device="cuda")
    _, fc, *_ = sp.candidates_topk_reverse(ep, er, w, k=64, tile=1024, reverse_r=8,
                                           with_pools=True)
    thresh = fc[:, -1].contiguous()
    rng = np.random.default_rng(PROVIDER_CHURN_SEED)
    dirty_t = rng.choice(n, int(n * 0.01), replace=False)
    rng.integers(256, 65_536, dirty_t.size)
    dirty_p = np.sort(rng.choice(n, int(n * 0.01), replace=False))
    pids = torch.from_numpy(dirty_p).cuda()
    price, load = ep.price.clone(), ep.load.clone()
    price[pids] = torch.from_numpy(rng.uniform(0.5, 4.0, dirty_p.size).astype(np.float32)).cuda()
    load[pids] = torch.from_numpy(rng.uniform(0, 1, dirty_p.size).astype(np.float32)).cuda()
    ep = dataclasses.replace(ep, price=price, load=load)
    out["k3_warm"] = enter_probe(f"{n}^2", ep, er, w, pids, thresh, 0)
    lo = n // SHARDS * (SHARDS - 1)
    out["k3_shard"] = enter_probe(f"shard at {lo}", ep, sp.slice_requirements(er, lo, n - lo), w,
                                  pids, thresh[lo:].contiguous(), lo)
    del ep, er, fc, thresh
    torch.cuda.empty_cache()

    # K10: the phase runs' calls and the backend's block
    picked, _ = dab.phase_k10_calls(cs, kernels, tb, torch, "cuda")
    for label, (a10, _) in picked.items():
        out[f"k10_{label}"] = cost_probe(label, *a10)
    del picked
    ep, er = dab.backend_market(cs, cs.SEED + 50, cs.BACKEND_N, "cuda")
    out["k10_backend"] = cost_probe("backend", ep, er, CostWeights())
    print(f"card: {card}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
