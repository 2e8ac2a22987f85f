#!/usr/bin/env python3
"""Time K2, the frontier auction phase, at the arena's shape on one NVIDIA
card, for an A/B of two checkouts.

    python3 scripts/torch_k2_ab.py [--root DIR] [--n 65536] [--sweep 1,8,16] [--switch 0,64]

Imports ``protocol_tpu_torch`` from ``--root`` (default: this checkout), so
that one call can time a parent and a change in turn (parent, change,
change, parent). Works on the one-block K2 and on the cluster K2. Builds
the kernels and makes the n x n synthetic marketplace of ``chip_smoke.py``
(seeds 2 / 3, default weights, k = 64, reverse r = 8, 16 extra columns),
then:
  - K2's timed launches, by CUDA events over five launches after a
    warm-up: the cold phase (eps 4.0, B 4,096, 256 rounds from scratch)
    and the carried one (eps 0.02, B 512, 256 rounds from the cold phase's
    state), with their rounds and frontier rows; with ``--sweep`` (the
    cluster K2 only) the same two at each listed cluster size;
  - K2 in place: the device ms of every K2 launch (an event pair around
    each call of the C entry point), summed over one cold tick of
    TorchSolveArena(cold_every=0) after a warm-up tick, and over a 1%
    requirement-churn and a 1% provider-churn warm tick after a cold prime
    and a warm-up churn tick (the churn of ``scripts/torch_tick_profile.py
    --warm``), with the launches, the rounds (``eng_rounds_total``), the
    tick's wall ms, ``assigned`` and ``plan_cost``; with ``--switch`` (the
    cluster K2 only) the timed launches and the three ticks again under
    each listed ``kernels.K2_ONE_BLOCK_OPEN`` (the open count at which
    block 0 takes the launch alone; 0: never).
Prints the card's name and power limit and, last, one JSON line. Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time
import types


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def cuda_ms(torch, fn, reps: int = 5) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--n", type=int, default=65_536)
    ap.add_argument("--sweep", default="", help="cluster sizes to time K2 at, e.g. 1,2,4,8,16")
    ap.add_argument("--switch", default="",
                    help="values of K2_ONE_BLOCK_OPEN to time K2 under, e.g. 0,32,64,128")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops import sparse as sp
    from protocol_tpu_torch.ops.cost import CostWeights
    from protocol_tpu_torch.parallel.torch_arena import TorchSolveArena
    from protocol_tpu_torch.trace.synth import (
        synth_provider_arrays, synth_providers, synth_requirement_arrays, synth_requirements,
    )

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"root: {kernels.__file__}", flush=True)
    clustered = "cluster" in inspect.signature(kernels.auction_phase).parameters
    out = {"root": os.path.abspath(args.root), "card": card,
           "k2": "cluster" if clustered else "one block", "n": args.n,
           "build_s": kernels.build()}
    for line in kernels.BUILD_LOG.get("auction", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas auction: {line.strip()}", flush=True)
    if clustered:
        out["cluster"] = kernels.k2_cluster(torch.device("cuda", torch.cuda.current_device()))
        out["one_block_open"] = kernels.K2_ONE_BLOCK_OPEN
        print(f"K2 cluster size: {out['cluster']}, one block from {out['one_block_open']} open "
              "tasks", flush=True)

    n, w = args.n, CostWeights()
    ep = synth_providers(np.random.default_rng(2), n, device="cuda")
    er = synth_requirements(np.random.default_rng(3), n, device="cuda")
    tile = sp.pick_tile(n, cap=min(1024, max(1, n // 8)))
    fwd_p, fwd_c, rev_t, rev_c = sp.candidates_topk_reverse(ep, er, w, k=64, tile=tile,
                                                           reverse_r=8)
    cand_p, cand_c = sp.merge_reverse_candidates(fwd_p, fwd_c, rev_t, rev_c, extra=16)
    inputs = sp._phase_inputs(cand_p, cand_c, True)
    del ep, er, fwd_p, fwd_c, rev_t, rev_c
    state0 = sp._initial_state(n, n, cand_c.device)
    work: dict = {}
    cold, _ = kernels.auction_phase(*inputs, state0, P=n, eps=4.0, max_iters=256, B=4096,
                                    stall_limit=0, work_out=work)
    out["cold_rounds"], out["cold_rows"] = int(cold[0]), int(work["frontier_rows"])
    carried, _ = kernels.auction_phase(*inputs, cold, P=n, eps=0.02, max_iters=256, B=512,
                                       stall_limit=0, work_out=work)
    out["carried_rounds"], out["carried_rows"] = int(carried[0]), int(work["frontier_rows"])
    cases = {"b4096": (state0, 4.0, 4096), "b512": (cold, 0.02, 512)}

    def launch(st, eps, B, **kw):
        return kernels.auction_phase(*inputs, st, P=n, eps=eps, max_iters=256, B=B,
                                     stall_limit=0, **kw)

    for key, (st, eps, B) in cases.items():
        out[f"{key}_ms"] = cuda_ms(torch, lambda: launch(st, eps, B))
    if args.sweep and clustered:
        out["sweep"] = {}
        for c in (int(x) for x in args.sweep.split(",")):
            out["sweep"][c] = {key: cuda_ms(torch, lambda: launch(st, eps, B, cluster=c))
                               for key, (st, eps, B) in cases.items()}
            print(f"K2 at cluster {c}: {json.dumps(out['sweep'][c])}", flush=True)
    if args.switch and clustered:
        out["switch"] = {}
        default = kernels.K2_ONE_BLOCK_OPEN
        for o in (int(x) for x in args.switch.split(",")):
            kernels.K2_ONE_BLOCK_OPEN = o
            out["switch"][o] = {key: cuda_ms(torch, lambda: launch(st, eps, B))
                                for key, (st, eps, B) in cases.items()}
            print(f"K2 with K2_ONE_BLOCK_OPEN = {o}: {json.dumps(out['switch'][o])}", flush=True)
        kernels.K2_ONE_BLOCK_OPEN = default
    del cand_p, cand_c, inputs, cold, carried, state0, cases

    # K2 in place: an event pair around every call of the C entry point
    lib = kernels._lib("auction")
    entry = lib.k2_auction_phase
    pairs: list = []

    def timed(*a):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        rc = entry(*a)
        end.record()
        pairs.append((start, end))
        return rc

    lib.k2_auction_phase = timed
    pa = ra = churn = None  # set for each run of ticks()

    def solve(arena):
        return arena.solve(types.SimpleNamespace(**pa), types.SimpleNamespace(**ra), w)

    def req_churn():
        rows = churn.choice(n, max(1, n // 100), replace=False)
        ram = ra["ram_mb"].copy()
        ram[rows] = np.maximum(256, (ram[rows] * churn.uniform(0.8, 1.25, rows.size)).astype(np.int32))
        ra["ram_mb"] = ram

    def prov_churn():
        rows = churn.choice(n, max(1, n // 100), replace=False)
        price, load = pa["price"].copy(), pa["load"].copy()
        price[rows] = churn.uniform(0.5, 4.0, rows.size).astype(np.float32)
        load[rows] = churn.uniform(0, 1, rows.size).astype(np.float32)
        pa["price"], pa["load"] = price, load

    def tick(label, arena, step, into=out):
        torch.cuda.synchronize()
        pairs.clear()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        st = arena.last_stats
        k2 = sum(s.elapsed_time(e) for s, e in pairs)
        rounds = st.get("eng_rounds_total")
        into[label] = {"k2_ms": k2, "launches": len(pairs), "rounds": rounds,
                       "us_per_round": k2 * 1e3 / rounds if rounds else None, "wall_ms": wall,
                       "assigned": st.get("assigned"), "plan_cost": st.get("plan_cost")}
        print(f"{label}: {json.dumps(into[label])}", flush=True)

    def ticks(into):
        nonlocal pa, ra, churn
        pa = synth_provider_arrays(np.random.default_rng(2), n)
        ra = synth_requirement_arrays(np.random.default_rng(3), n)
        churn = np.random.default_rng(3)
        arena = TorchSolveArena(device="cuda", cold_every=0)
        solve(arena)  # warm-up: allocator, library loads
        tick("cold_tick", arena, lambda: solve(arena), into)
        del arena
        arena = TorchSolveArena(device="cuda")
        solve(arena)  # the cold prime
        req_churn()
        solve(arena)  # warm-up warm tick
        for label, churn_fn in (("req_churn_tick", req_churn), ("prov_churn_tick", prov_churn)):
            churn_fn()
            tick(label, arena, lambda: solve(arena), into)

    ticks(out)
    if args.switch and clustered:
        default = kernels.K2_ONE_BLOCK_OPEN
        for o in (int(x) for x in args.switch.split(",")):
            kernels.K2_ONE_BLOCK_OPEN = o
            print(f"ticks with K2_ONE_BLOCK_OPEN = {o}", flush=True)
            ticks(out["switch"][o])
        kernels.K2_ONE_BLOCK_OPEN = default
    lib.k2_auction_phase = entry
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
