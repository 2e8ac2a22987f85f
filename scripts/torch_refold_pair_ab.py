#!/usr/bin/env python3
"""Time K5 (the repair refold, ``kernels.repair_refold``) and K15 (the pair
cost, ``kernels.pair_cost``) of the PyTorch port on one NVIDIA card, for
an A/B of two checkouts.

    python3 scripts/torch_refold_pair_ab.py [--root DIR] [--reps 20] [--no-chain]
        [--lane-entries N]

Imports ``protocol_tpu_torch`` from ``--root`` (default: this checkout), so
that one call can time a parent and a change in turn (parent, change,
change, parent); the wrappers' signatures are those of older checkouts
too. Builds the kernels and prints the compiler's register, stack and
spill lines for ``csrc/repair.cu`` and ``csrc/blocked.cu``. Then:

  - K5 on the pools of a cold pass at 65,536^2 (``chip_smoke.py``'s
    arena: synthetic providers seed 2, requirements seed 3, k 64, tile
    1,024, so 64 pool entries a provider, r 8), at one lane and at 4 lanes
    (the mesh's d_fold): the wrapper's mean ms over ``--reps`` calls, its
    launch alone (``launch_ms``: the C entry replayed back to back between
    two CUDA events), the library yardstick ``torch.sort(pool_c, dim=1,
    stable=True)`` and the sha256 of (rev_t, rev_c);
  - K15 on stage S's instance (``stage_s.run``'s draws: one generator,
    seed 42, 100,000 providers then 100,000 tasks) with a matching-like
    p4t (a permutation of the providers, 1% of the tasks unassigned, seed
    5), at stage S's weights and at proximity 0: the wrapper's ms (with its
    read of max(p4t)), the launch alone and the sha256 of the costs;
  - unless ``--no-chain``: K5 in place, on ``chip_smoke.py``'s warm chain
    at 65,536^2 (``TorchSolveArena(dual_refresh_every=4)``: a cold prime,
    then three 1% requirement-churn ticks, a 1% provider-churn tick, an
    8-provider ``apply_rows`` event, the dual-refresh tick and a
    reconcile), with in-place timing on (``kernels.time_in_place``: an
    event pair around each launch) and ``torch.profiler`` recording at
    once: per kernel the in-place ms and launches, against the profiler's
    device ms of the kernels K5's C entry runs, so the in-place sum can be
    split into the kernel's time and the time the event pair spans around
    it.

``--lane-entries N`` times a variant of the root whose K5 gives a lane up
to N pool entries before its group of lanes a provider doubles (the
root's ``kLaneEntries``; fewer lanes do more of the work in registers and
fewer shuffle rounds): a copy of the root's package under
``build/k5_lanes<N>/`` with the constant and its mirror in ``kernels.py``
replaced, built there.

Prints the card's name and power limit and, last, one JSON line. Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
N = 65_536
CHURN = 0.01
STAGE_S = 100_000
EVENT_ROWS = 8  # chip_smoke.py's apply_rows event


def variant(root: str, lane_entries: int) -> str:
    """A copy of ``root``'s package whose K5 takes ``lane_entries`` entries a
    lane; returns its root."""
    import re
    import shutil

    out = os.path.join(root, "build", f"k5_lanes{lane_entries}")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(root, "protocol_tpu_torch"),
                    os.path.join(out, "protocol_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, pat, rep in (
            ("csrc/repair.cu", r"constexpr int kLaneEntries = \d+;",
             f"constexpr int kLaneEntries = {lane_entries};"),
            ("kernels.py", r"K5_LANE_ENTRIES = \d+", f"K5_LANE_ENTRIES = {lane_entries}")):
        path = os.path.join(out, "protocol_tpu_torch", rel)
        with open(path) as f:
            text, n = re.subn(pat, rep, f.read())
        if n != 1:
            raise SystemExit(f"{rel}: the lane-entries constant not found")
        with open(path, "w") as f:
            f.write(text)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--no-chain", action="store_true")
    ap.add_argument("--lane-entries", type=int, default=0)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    if args.lane_entries:
        root = variant(root, args.lane_entries)
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import torch_repair_ab as ab
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops import sparse as sp
    from protocol_tpu_torch.ops.cost import CostWeights
    from protocol_tpu_torch.trace.synth import synth_providers, synth_requirements

    card = ab.card_line()
    print(f"card: {card}", flush=True)
    print(f"root: {kernels.__file__}", flush=True)
    out = {"root": root, "card": card, "build_s": kernels.build(("candidates", "repair",
                                                                 "blocked", "auction",
                                                                 "cleanup"))}
    for lib in ("repair", "blocked"):
        out[f"ptxas_{lib}"] = ab.ptxas_lines(kernels.BUILD_LOG.get(lib, ""))
        for line in out[f"ptxas_{lib}"]:
            print(f"ptxas {lib}: {line}", flush=True)

    # ---- K5 alone, on a cold pass's pools
    w = CostWeights()
    ep = synth_providers(np.random.default_rng(2), N, device="cuda")
    er = synth_requirements(np.random.default_rng(3), N, device="cuda")
    _, _, _, _, pt, pc = sp.candidates_topk_reverse(ep, er, w, k=64, tile=1024, reverse_r=8,
                                                   with_pools=True)
    del ep, er
    group = getattr(kernels, "refold_group", lambda n: 1)  # older checkouts: a thread each
    k5 = out["k5"] = {"P": pt.shape[0], "n_tiles": pt.shape[1], "r": 8,
                      "lanes_a_provider": group(pt.shape[1]),
                      "library_ms": ab.cuda_ms(torch, lambda: torch.sort(pc, dim=1, stable=True),
                                               args.reps)}
    for d_fold in (1, 4):
        def call():
            return kernels.repair_refold(pt, pc, 8, d_fold)

        r = k5[f"d_fold_{d_fold}"] = {
            "sha256": ab.sha(torch.cat([a.view(torch.int32).flatten() for a in call()])),
            "ms": ab.cuda_ms(torch, call, args.reps),
            "launch_ms": [ab.launch_ms(torch, kernels, call, 5 * args.reps) for _ in range(3)],
        }
        print(f"K5 {k5['P']} x {k5['n_tiles']}, r 8, d_fold {d_fold}: {json.dumps(r)}",
              flush=True)
    print(f"K5 library yardstick torch.sort(pool_c, dim=1, stable=True): "
          f"{k5['library_ms']:.4f} ms", flush=True)

    # ---- K15 alone, on stage S's instance
    rng = np.random.default_rng(42)
    ep = synth_providers(rng, STAGE_S, device="cuda")
    er = synth_requirements(rng, STAGE_S, device="cuda")
    r5 = np.random.default_rng(5)
    p4t_np = r5.permutation(STAGE_S).astype(np.int32)
    p4t_np[r5.uniform(size=STAGE_S) < 0.01] = -1
    p4t = torch.from_numpy(p4t_np).cuda()
    k15 = out["k15"] = {"pairs": STAGE_S, "assigned": int((p4t_np >= 0).sum())}
    for label, wk in (("stage_s_weights", CostWeights()),
                      ("proximity_0", CostWeights(proximity=0.0))):
        def pair():
            return kernels.pair_cost(ep, er, wk, p4t)

        r = k15[label] = {
            "sha256": ab.sha(pair()),
            "ms": ab.cuda_ms(torch, pair, args.reps),
            "launch_ms": [ab.launch_ms(torch, kernels, pair, 5 * args.reps) for _ in range(3)],
        }
        print(f"K15 {STAGE_S} pairs ({label}): {json.dumps(r)}", flush=True)
    del ep, er, p4t
    torch.cuda.empty_cache()

    if not args.no_chain:
        out["chain"] = chain(np, torch, kernels, w)
    print(f"card: {card}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


def chain(np, torch, kernels, w) -> dict:
    """K5 in place on the arena's warm chain, with the profiler's device
    times of the same launches (the module docstring)."""
    import types

    from torch.profiler import ProfilerActivity, profile

    from protocol_tpu_torch.parallel.torch_arena import TorchSolveArena
    from protocol_tpu_torch.trace.synth import synth_provider_arrays, synth_requirement_arrays

    pa = synth_provider_arrays(np.random.default_rng(2), N)
    ra = synth_requirement_arrays(np.random.default_rng(3), N)
    churn = np.random.default_rng(3)
    n_churn = int(N * CHURN)

    def ns(cols):
        return types.SimpleNamespace(**cols)

    def req_churn():
        rows = churn.choice(N, n_churn, replace=False)
        ram = ra["ram_mb"].copy()
        ram[rows] = np.maximum(256, (ram[rows] * churn.uniform(0.8, 1.25, rows.size))
                               .astype(np.int32))
        ra["ram_mb"] = ram

    def prov_churn():
        rows = churn.choice(N, n_churn, replace=False)
        price, load = pa["price"].copy(), pa["load"].copy()
        price[rows] = churn.uniform(0.5, 4.0, rows.size).astype(np.float32)
        load[rows] = churn.uniform(0, 1, rows.size).astype(np.float32)
        pa["price"], pa["load"] = price, load

    arena = TorchSolveArena(device="cuda", dual_refresh_every=4)
    arena.solve(ns(pa), ns(ra), w)  # the cold prime, outside the window

    def solve(step):
        def run():
            step()
            return arena.solve(ns(pa), ns(ra), w)
        return run

    def event():
        rows = np.sort(churn.choice(N, EVENT_ROWS, replace=False)).astype(np.int32)
        vals = {n: arena._p_fields[n][rows].copy() for n in arena._p_fields}
        vals["price"] = churn.uniform(0.5, 4.0, rows.size).astype(np.float32)
        return arena.apply_rows(rows, vals, None, None, w)

    ticks = (("req-churn-0", solve(req_churn)), ("req-churn-1", solve(req_churn)),
             ("req-churn-2", solve(req_churn)), ("prov-churn", solve(prov_churn)),
             ("event", event), ("dual-refresh", solve(req_churn)),
             ("reconcile", arena.reconcile))
    per_tick = {}
    torch.cuda.synchronize()
    kernels.time_in_place(True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for label, tick in ticks:
            before = dict(kernels.in_place_ms().get("repair_refold", {"ms": 0.0,
                                                                      "launches": 0}))
            tick()
            after = kernels.in_place_ms().get("repair_refold", {"ms": 0.0, "launches": 0})
            per_tick[label] = {"ms": after["ms"] - before["ms"],
                               "launches": after["launches"] - before["launches"]}
        torch.cuda.synchronize()
    sums = kernels.in_place_ms()
    kernels.time_in_place(False)
    device = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if us:  # kernels, and the CPU ops that launched some (their kernels' sums)
            device[e.key[:60]] = {"ms": us / 1e3, "count": e.count}
    refold = {k: v for k, v in device.items() if "refold" in k}
    print(f"chain: K5 in place a tick {json.dumps(per_tick)}", flush=True)
    r = {"in_place": sums, "in_place_k5_a_tick": per_tick, "profiler_refold": refold,
         "profiler_top": dict(sorted(device.items(), key=lambda kv: -kv[1]["ms"])[:12])}
    k5 = sums.get("repair_refold", {"ms": 0.0, "launches": 0})
    dev_ms = sum(v["ms"] for v in refold.values())
    print(f"chain: K5 in place {k5['ms']:.4f} ms over {k5['launches']} launches; the "
          f"profiler's refold kernels {dev_ms:.4f} ms over "
          f"{sum(v['count'] for v in refold.values())}: {json.dumps(refold)}", flush=True)
    print(f"chain in place: {json.dumps(sums)}", flush=True)
    print(f"chain profiler top: {json.dumps(r['profiler_top'])}", flush=True)
    del arena
    torch.cuda.empty_cache()
    return r


if __name__ == "__main__":
    sys.exit(main())
