#!/usr/bin/env python3
"""Time the dense auction K7 and the sequential greedy K12 on one NVIDIA
card, for an A/B of two checkouts.

    python3 scripts/torch_dense_ab.py [--root DIR] [--skip-large]

Imports ``protocol_tpu_torch`` and ``chip_smoke`` from ``--root`` (default:
this checkout), so that one call can time a parent and a change in turn
(parent, change, change, parent); works on checkouts from before the
redesign of the two kernels too. Builds the kernels, then times, each the
mean of three runs by CUDA events after a warm-up, with a sha256 of every
output:
  - K7 on the dense route's first-refresh inputs (``chip_smoke.py``'s
    4,096-node pool: the value rows of its first K6 call, eps 0.05, 300
    rounds) and on ``chip_smoke.mesh_dense_cost`` at 32,768^2 (eps 0.05,
    500 rounds), with the rounds, the open rows summed over them and us a
    round;
  - K12 on the greedy RPC's call (K10's block over the backend's 4,096 x
    4,096 market, tasks in index order) and on the sinkhorn RPC's rounding
    (K13's rounding cost and visit order over its market), with us a step;
  - the dense route's two refreshes (the pool, then 1% of the nodes
    repriced and two tasks replaced): ``phase1_ms``, the refresh wall and
    K7's in-place device ms.
Prints the card's name and power limit and, last, one JSON line. Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def sha(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def dense_route_inputs(cs, kernels, tb, dev):
    """The arguments of the dense route's first K6 call (chip_smoke.py's
    4,096-node pool), and the matcher and store for its refreshes."""
    import numpy as np

    nodes, tasks = cs.make_pool(np.random.default_rng(cs.SEED + 20), *cs.DENSE_POOL)
    store = cs.mem_store(nodes, tasks)
    matcher = tb.TorchBatchMatcher(store, device=dev)
    calls = []
    orig = kernels.dense_value_base

    def spy(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    kernels.dense_value_base = spy
    try:
        matcher.refresh()
    finally:
        kernels.dense_value_base = orig
    return calls[0][0], matcher, store


def backend_market(cs, seed: int, n: int, dev):
    """One of the backend run's markets (chip_smoke.run_backend) on the card."""
    import numpy as np

    from protocol_tpu_torch.ops.encoding import providers_from_numpy, requirements_from_numpy
    from protocol_tpu_torch.trace.synth import synth_provider_arrays, synth_requirement_arrays

    rng = np.random.default_rng(seed)
    ep = synth_provider_arrays(rng, n)
    er = synth_requirement_arrays(rng, n)
    return providers_from_numpy(ep, dev), requirements_from_numpy(er, dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--skip-large", action="store_true", help="leave out K7 at 32,768^2")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops import assign as da
    from protocol_tpu_torch.ops.cost import CostWeights
    from protocol_tpu_torch.sched import torch_backend as tb

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"root: {kernels.__file__}", flush=True)
    dev = "cuda"
    out = {"root": os.path.abspath(args.root), "card": card, "build_s": kernels.build()}
    for name in ("dense", "greedy"):
        for line in kernels.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    def cuda_ms(fn, reps: int = 3) -> float:
        return cs.cuda_ms(torch, fn, reps)

    def k7(label, vb, feas, eps, iters):
        work: dict = {}
        got = kernels.dense_auction(vb, feas, eps, iters, work)
        ms = cuda_ms(lambda: kernels.dense_auction(vb, feas, eps, iters))
        rounds, open_rows = int(got[3]), int(work["open_rows"])
        r = {"T": vb.shape[0], "P": vb.shape[1], "eps": eps, "max_iters": iters,
             "rounds": rounds, "open_rows": open_rows, "ms": ms,
             "us_per_round": ms * 1e3 / max(rounds, 1),
             "seated": int((got[0] >= 0).sum()),
             "sha256": sha(*got[:3], got[3].reshape(1), work["open_rows"].reshape(1))}
        print(f"K7 {label}: {json.dumps(r)}", flush=True)
        return r

    def k12(label, cost_tp, order):
        got = kernels.greedy_assign(cost_tp, order)
        ms = cuda_ms(lambda: kernels.greedy_assign(cost_tp, order))
        r = {"steps": int(order.numel()), "P": cost_tp.shape[1], "ms": ms,
             "us_per_step": ms * 1e3 / max(int(order.numel()), 1),
             "seated": int((got >= 0).sum()), "sha256": sha(got)}
        print(f"K12 {label}: {json.dumps(r)}", flush=True)
        return r

    # ---- K7: the dense route's first-refresh inputs, then 32,768^2
    (ep6, er6, w6), matcher, store = dense_route_inputs(cs, kernels, tb, dev)
    vb, feas = kernels.dense_value_base(ep6, er6, w6)
    out["k7_dense_route"] = k7("dense route", vb, feas, 0.05, 300)
    del vb, feas

    # ---- the dense route's refreshes: phase1_ms and K7 in place
    import numpy as np

    rng = np.random.default_rng(cs.SEED + 21)
    out["dense_refreshes"] = []
    for step in ("pool", "churn"):
        if step == "churn":
            cs.churn_pool(rng, store, cs.CHURN, replace_tasks=2)
        else:  # a fresh matcher: the recorded refresh above warmed the process
            matcher = tb.TorchBatchMatcher(store, device=dev)
        torch.cuda.synchronize()
        kernels.time_in_place(True)
        t0 = time.perf_counter()
        matcher.refresh()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        in_place = kernels.in_place_ms()
        kernels.time_in_place(False)
        st = matcher.last_solve_stats
        k7_ip = in_place.get("dense_auction", {"ms": 0.0, "launches": 0})
        r = {"step": step, "wall_ms": wall, "phase1_ms": st["phase1_ms"],
             "auction_rounds": int(st["auction_rounds"]), "assigned": st["assigned"],
             "k7_in_place_ms": k7_ip["ms"], "k7_launches": k7_ip["launches"],
             "assignment_sha256": hashlib.sha256(json.dumps(sorted(
                 (a, store.task_store.get_task(t).name) for a, t in matcher._assignment.items()
             )).encode()).hexdigest()[:16]}
        out["dense_refreshes"].append(r)
        print(f"dense route refresh: {json.dumps(r)}", flush=True)
    del matcher, store

    if not args.skip_large:
        n = cs.MESH_DENSE_N
        cost = cs.mesh_dense_cost(torch, n, cs.SEED + 72)
        vb, feas = da._value_base(cost)
        del cost
        out["k7_mesh_dense_cost"] = k7(f"{n}^2", vb, feas, cs.MESH_DENSE_EPS,
                                       cs.MESH_DENSE_ITERS)
        del vb, feas
        torch.cuda.empty_cache()

    # ---- K12: the greedy RPC's call and the sinkhorn RPC's rounding
    n = cs.BACKEND_N
    weights = CostWeights()
    ep, er = backend_market(cs, cs.SEED + 50, n, dev)
    cost_tp = kernels.cost_block(ep, er, weights)
    out["k12_greedy_rpc"] = k12("greedy RPC", cost_tp, torch.arange(n, dtype=torch.int32,
                                                                      device=dev))
    ep, er = backend_market(cs, cs.SEED + 51, n, dev)
    cost_tp = kernels.cost_block(ep, er, weights)
    _, rcost_tp, colmax, _, _ = kernels.sinkhorn(cost_tp, cs.SINKHORN_EPS, cs.SINKHORN_ITERS)
    order = torch.sort(-colmax, stable=True).indices.to(torch.int32)
    out["k12_sinkhorn_rounding"] = k12("sinkhorn rounding", rcost_tp, order)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
