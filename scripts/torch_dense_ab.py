#!/usr/bin/env python3
"""Time the dense route's list launches (the cost block K10, the value
rows K6, the unbounded best K8), the dense auction K7 and the sequential
greedy K12 on one NVIDIA card, for an A/B of two checkouts.

    python3 scripts/torch_dense_ab.py [--root DIR] [--skip-large] [--list-only]

Imports ``protocol_tpu_torch`` and ``chip_smoke`` from ``--root`` (default:
this checkout), so that one call can time a parent and a change in turn
(parent, change, change, parent); works on checkouts from before the
redesign of these kernels too. Builds the kernels, then times, each
the mean of three runs by CUDA events after a warm-up (K10, K6 and K8 of
ten, and of 50 launches alone, ``launch_ms``: the wrapper's host work left
out), with a sha256 of every output:
  - K10 on the colocation call (``chip_smoke.py``'s torch-route phase run:
    the 65,536-node pool with its phase tasks, the cold refresh's
    five-resource bin-pack call), on the wide run's phase 0 call (the
    4,096-node pool with PHASE_WIDE's provider-spread tasks) and on the
    backend's 4,096^2 block (the greedy RPC's market), with each refresh's
    K10 in-place device ms and the sha256 of its matching; and K1's fused
    cold pass at 65,536^2 (whose check and scoring K10 shares) as a guard;
  - K6 on the dense route's first-refresh call (``chip_smoke.py``'s
    4,096-node pool: 3,072 slots x 4,096 nodes) and on the backend's
    auction RPC call (4,096^2); K8 on the dense route's first-refresh call
    (4,096 nodes x 1,024 swarm tasks), the backend's best RPC call (4,096 x
    1,024) and the torch route's phase 2 call (the 65,536-node pool's
    cold refresh); each at the recorded weights and at proximity 0; and
    K3 as a guard, on a 1% provider churn at 65,536^2 (655 dirty providers
    against every task, thresholds the cold pass's k-th costs);
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
    K6's, K7's and K8's in-place device ms.
``--list-only`` leaves out K7 and K12.
Prints the card's name and power limit and, last, one JSON line. Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
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


def launch_ms(torch, kernels, call, reps: int) -> float:
    """Device ms of the launch a wrapper call makes, alone: ``call()`` runs
    the wrapper once, and its C entry, once launched, is launched ``reps``
    times more back to back between two CUDA events, while the wrapper's
    buffers are alive (every entry timed here rewrites the same outputs).
    Leaves out the wrapper's host checks and syncs."""
    orig, got = kernels._launch, {}

    def replay(key, fn, *args, what=None):
        orig(key, fn, *args, what=what)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            kernels._check(fn(*args), key)
        end.record()
        end.synchronize()
        got["ms"] = start.elapsed_time(end) / reps

    kernels._launch = replay
    try:
        call()
    finally:
        kernels._launch = orig
    return got["ms"]


def sha(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def first_calls(cs, kernels, matcher, names) -> dict:
    """The arguments of each wrapper's first call in a refresh of
    ``matcher``: {name: args}."""
    recorded, originals = cs.record_first_calls(kernels, {n: () for n in names})
    try:
        matcher.refresh()
    finally:
        for n, fn in originals.items():
            setattr(kernels, n, fn)
    return {n: args for n, (args, _) in recorded.items()}


def dense_route_inputs(cs, kernels, tb, dev):
    """The arguments of the dense route's first K6 and K8 calls
    (chip_smoke.py's 4,096-node pool), and the matcher and store for its
    refreshes."""
    import numpy as np

    nodes, tasks = cs.make_pool(np.random.default_rng(cs.SEED + 20), *cs.DENSE_POOL)
    store = cs.mem_store(nodes, tasks)
    matcher = tb.TorchBatchMatcher(store, device=dev)
    calls = first_calls(cs, kernels, matcher, ("dense_value_base", "unbounded_best"))
    return calls, matcher, store


def torch_route_phase2(cs, kernels, tb, dev):
    """The arguments of K8's call in the torch route's cold refresh
    (chip_smoke.py's 65,536-node pool)."""
    import numpy as np

    nodes, tasks = cs.make_pool(np.random.default_rng(cs.SEED + 30), *cs.ARENA_POOL)
    store = cs.mem_store(nodes, tasks)
    matcher = tb.TorchBatchMatcher(store, native_engine="torch", device=dev)
    return first_calls(cs, kernels, matcher, ("unbounded_best",))["unbounded_best"]


def backend_market(cs, seed: int, n: int, dev, t: int | None = None):
    """One of the backend run's markets (chip_smoke.run_backend) on the
    card: n providers, t tasks (default n)."""
    import numpy as np

    from protocol_tpu_torch.ops.encoding import providers_from_numpy, requirements_from_numpy
    from protocol_tpu_torch.trace.synth import synth_provider_arrays, synth_requirement_arrays

    rng = np.random.default_rng(seed)
    ep = synth_provider_arrays(rng, n)
    er = synth_requirement_arrays(rng, n if t is None else t)
    return providers_from_numpy(ep, dev), requirements_from_numpy(er, dev)


def matching_sha(matcher, store) -> str:
    """sha256 of a matcher's single and multi-slot assignments, each task by
    its name (task ids are drawn anew each run)."""
    name = lambda t: store.task_store.get_task(t).name  # noqa: E731
    return hashlib.sha256(repr((
        sorted((a, name(t)) for a, t in matcher._assignment.items()),
        sorted((a, sorted(map(name, ts))) for a, ts in matcher._assignment_multi.items()),
    )).encode()).hexdigest()[:16]


def phase_k10_calls(cs, kernels, tb, torch, dev) -> tuple[dict, dict]:
    """K10's recorded calls from two of ``chip_smoke.run_phases``'s cold
    refreshes: the torch route's colocation call and the wide run's phase
    0 call. Returns ({label: (args, out)}, {label: refresh summary})."""
    import numpy as np

    runs = {
        "colocation": (cs.ARENA_POOL, cs.SEED + 30,
                       lambda: cs.phase_tasks(np.random.default_rng(cs.SEED + 32), *cs.PHASE_MIX),
                       {"native_engine": "torch"}),
        "wide_phase0": (cs.DENSE_POOL, cs.SEED + 20,
                        lambda: cs.phase_tasks(np.random.default_rng(cs.SEED + 24), 0,
                                               cs.PHASE_WIDE[0], 0, replicas=cs.PHASE_WIDE[1]),
                        {}),
    }
    # load K10's library first, so that no refresh's first launch loads it
    from protocol_tpu_torch.ops.cost import CostWeights

    kernels.cost_block(*backend_market(cs, cs.SEED, 64, dev), CostWeights())
    picked, summary = {}, {}
    for label, (pool, seed, extra, kw) in runs.items():
        nodes, tasks = cs.make_pool(np.random.default_rng(seed), *pool, sites=cs.SITES)
        tasks += extra()
        store = cs.mem_store(nodes, tasks)
        matcher = tb.TorchBatchMatcher(store, device=dev, **kw)
        torch.cuda.synchronize()
        kernels.time_in_place(True)
        calls, originals = cs.record_calls(kernels, ("cost_block", "binpack_ffd"))
        try:
            matcher.refresh()
        finally:
            for name, fn in originals.items():
                setattr(kernels, name, fn)
        in_place = kernels.in_place_ms()
        kernels.time_in_place(False)
        if label == "colocation":
            at = [i for i, (a, _, _) in enumerate(calls["binpack_ffd"]) if a[1].shape[1] == 5]
            at = at[0]
        else:
            at = 0  # phase 0 runs first
        args, _, out = calls["cost_block"][at]
        picked[label] = (args, out)
        summary[label] = {
            "k10_calls": [list(c[2].shape) for c in calls["cost_block"]],
            "k10_in_place": in_place.get("cost_block"),
            "matching_sha": matching_sha(matcher, store),
        }
        print(f"{label} refresh: {json.dumps(summary[label])}", flush=True)
        del matcher, store, calls
        torch.cuda.empty_cache()
    return picked, summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--skip-large", action="store_true", help="leave out K7 at 32,768^2")
    ap.add_argument("--list-only", action="store_true", help="leave out K7 and K12")
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
    for name in ("candidates", "dense", "greedy"):
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

    # ---- K10: the phase runs' calls and the backend's block; K1's cold
    # pass as the guard
    import numpy as np

    from protocol_tpu_torch.ops import sparse as sp
    from protocol_tpu_torch.trace.synth import synth_providers, synth_requirements

    def k10(label, ep, er, w):
        got = kernels.cost_block(ep, er, w)
        r = {"T": got.shape[0], "P": got.shape[1], "finite": int((got < 5e8).sum()),
             "ms": cuda_ms(lambda: kernels.cost_block(ep, er, w), 10),
             "launch_ms": launch_ms(torch, kernels, lambda: kernels.cost_block(ep, er, w), 50),
             "sha256": sha(got)}
        print(f"K10 {label}: {json.dumps(r)}", flush=True)
        return r

    picked, out["phase_refreshes"] = phase_k10_calls(cs, kernels, tb, torch, dev)
    for label, (a10, _) in picked.items():
        out[f"k10_{label}"] = k10(label, *a10)
    del picked
    ep, er = backend_market(cs, cs.SEED + 50, cs.BACKEND_N, dev)
    out["k10_backend"] = k10("backend", ep, er, CostWeights())
    ep = synth_providers(np.random.default_rng(2), cs.N, device=dev)
    er = synth_requirements(np.random.default_rng(3), cs.N, device=dev)

    def cold():
        return sp.candidates_topk_reverse(ep, er, CostWeights(), k=64, tile=1024, reverse_r=8,
                                          with_pools=True)

    parts = cold()
    out["k1_cold_pass"] = {"ms": cuda_ms(cold), "launch_ms": launch_ms(torch, kernels, cold, 5),
                           "sha256": sha(*parts)}
    print(f"K1 cold pass {cs.N}^2 (guard): {json.dumps(out['k1_cold_pass'])}", flush=True)

    # K3 (guard): 1% of the providers repriced, against every task
    rng = np.random.default_rng(7)
    dirty = torch.from_numpy(np.sort(rng.choice(cs.N, int(cs.N * cs.CHURN), replace=False))).to(dev)
    price = ep.price.clone()
    price[dirty] = torch.from_numpy(rng.uniform(0.5, 4.0, dirty.numel()).astype(np.float32)).to(dev)
    ep_churn = dataclasses.replace(ep, price=price)
    thresh = parts[1][:, -1].contiguous()

    def enter():
        return kernels.repair_enter(ep_churn, er, CostWeights(), dirty, thresh)

    got = enter()
    out["k3_guard"] = {"providers": dirty.numel(), "tasks": er.num, "flagged": int(got.sum()),
                       "ms": cuda_ms(enter, 10), "launch_ms": launch_ms(torch, kernels, enter, 20),
                       "sha256": sha(got)}
    print(f"K3 {dirty.numel()} x {cs.N} (guard): {json.dumps(out['k3_guard'])}", flush=True)
    del ep, er, ep_churn, parts, got
    torch.cuda.empty_cache()

    # ---- K6 and K8 on their recorded calls
    def both(w):  # the recorded weights and proximity 0
        return (("", w), ("_prox0", dataclasses.replace(w, proximity=0.0)))

    def k6(label, ep, er, w):
        r = {"T": er.num, "P": ep.num}
        for tag, wt in both(w):
            vb, feas = kernels.dense_value_base(ep, er, wt)
            r[f"sha256{tag}"] = sha(vb, feas)
        r.update(feasible_cells=int((vb > -5e17).sum()), feasible_slots=int(feas.sum()),
                 ms=cuda_ms(lambda: kernels.dense_value_base(ep, er, w), 10),
                 launch_ms=launch_ms(torch, kernels,
                                     lambda: kernels.dense_value_base(ep, er, w), 50))
        print(f"K6 {label}: {json.dumps(r)}", flush=True)
        return r

    def k8(label, ep, er, w):
        r = {"P": ep.num, "T": er.num}
        for tag, wt in both(w):
            best = kernels.unbounded_best(ep, er, wt)
            r[f"sha256{tag}"] = sha(best)
        r.update(seated=int((best >= 0).sum()),
                 ms=cuda_ms(lambda: kernels.unbounded_best(ep, er, w), 10),
                 launch_ms=launch_ms(torch, kernels, lambda: kernels.unbounded_best(ep, er, w), 50))
        print(f"K8 {label}: {json.dumps(r)}", flush=True)
        return r

    calls, matcher, store = dense_route_inputs(cs, kernels, tb, dev)
    out["k6_dense_route"] = k6("dense route", *calls["dense_value_base"])
    out["k8_dense_route"] = k8("dense route", *calls["unbounded_best"])
    ep, er = backend_market(cs, cs.SEED + 52, cs.BACKEND_N, dev)
    out["k6_auction_rpc"] = k6("auction RPC", ep, er, CostWeights())
    ep, er = backend_market(cs, cs.SEED + 53, cs.BACKEND_BEST[0], dev, cs.BACKEND_BEST[1])
    out["k8_best_rpc"] = k8("best RPC", ep, er, CostWeights())
    del ep, er
    out["k8_torch_route"] = k8("torch route phase 2", *torch_route_phase2(cs, kernels, tb, dev))
    torch.cuda.empty_cache()
    if args.list_only:
        print(f"card: {card}", flush=True)
        print(json.dumps(out), flush=True)
        return 0

    # ---- K7: the dense route's first-refresh inputs, then 32,768^2
    ep6, er6, w6 = calls["dense_value_base"]
    vb, feas = kernels.dense_value_base(ep6, er6, w6)
    out["k7_dense_route"] = k7("dense route", vb, feas, 0.05, 300)
    del vb, feas

    # ---- the dense route's refreshes: phase1_ms and K7 in place
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
        r = {"step": step, "wall_ms": wall, "phase1_ms": st["phase1_ms"],
             "auction_rounds": int(st["auction_rounds"]), "assigned": st["assigned"]}
        for tag, key in (("k6", "dense_value_base"), ("k7", "dense_auction"),
                         ("k8", "unbounded_best")):
            ip = in_place.get(key, {"ms": 0.0, "launches": 0})
            r.update({f"{tag}_in_place_ms": ip["ms"], f"{tag}_launches": ip["launches"]})
        r["assignment_sha256"] = hashlib.sha256(json.dumps(sorted(
            (a, store.task_store.get_task(t).name) for a, t in matcher._assignment.items()
        )).encode()).hexdigest()[:16]
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
    print(f"card: {card}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
