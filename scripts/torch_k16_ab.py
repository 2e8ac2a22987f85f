#!/usr/bin/env python3
"""Time K16, the task-sharded frontier auction, at D = 4 views of one
NVIDIA card, for an A/B of two checkouts.

    python3 scripts/torch_k16_ab.py [--root DIR] [--n 65536]

Imports ``protocol_tpu_torch`` and ``chip_smoke`` from ``--root`` (default:
this checkout), so that one call can time a parent and a change in turn
(parent, change, change, parent). Works on the three-launch K16 of older
checkouts and on the segment launch. Builds the kernels, makes the n x n
synthetic marketplace of ``chip_smoke.py`` (seeds 2 / 3, default weights,
k = 64, reverse r = 8, 16 extra columns) and a mesh of 4 views of the
card, then:
  - one 256-round segment of the sharded phase from scratch (eps 4.0, per
    shard B 4,096) and one carried from its state (eps 0.02, B 512), each
    the mean of three by CUDA events after a warm-up, with its rounds,
    frontier rows and a sha256 of the stacked state it leaves;
  - the mesh matcher (``TorchBatchMatcher(use_mesh=True)``, the candidate
    cache) on ``chip_smoke.py``'s torch-route pool: a cold refresh and one
    after 1% node churn, each with ``phase1_ms``, the refresh wall,
    ``assigned`` and every kernel's launches and in-place device ms;
  - a ``TorchSolveArena(devices=4)`` cold tick after a warm-up tick, with
    its wall, ``assigned`` and ``plan_cost``.
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
import types


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--n", type=int, default=65_536)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops import sparse as sp
    from protocol_tpu_torch.ops.cost import CostWeights
    from protocol_tpu_torch.parallel import sparse as ps
    from protocol_tpu_torch.parallel.mesh import make_mesh
    from protocol_tpu_torch.parallel.torch_arena import TorchSolveArena
    from protocol_tpu_torch.sched import torch_backend as tb
    from protocol_tpu_torch.trace.synth import (
        synth_provider_arrays, synth_providers, synth_requirement_arrays, synth_requirements,
    )
    from protocol_tpu_torch.utils import platform

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"root: {kernels.__file__}", flush=True)
    segment_launch = hasattr(kernels, "mesh_segment")
    D, n, w, dev = 4, args.n, CostWeights(), "cuda"
    out = {"root": os.path.abspath(args.root), "card": card, "n": n, "D": D,
           "k16": "segment launch" if segment_launch else "three launches a round",
           "build_s": kernels.build()}
    for line in kernels.BUILD_LOG.get("auction", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas auction: {line.strip()}", flush=True)
    prev = platform.force_virtual_devices(D, "cuda")
    try:
        mesh = make_mesh(D, dev)
        ep = synth_providers(np.random.default_rng(2), n, device=dev)
        er = synth_requirements(np.random.default_rng(3), n, device=dev)
        tile = sp.pick_tile(n, cap=min(1024, max(1, n // 8)))
        fwd_p, fwd_c, rev_t, rev_c = sp.candidates_topk_reverse(ep, er, w, k=64, tile=tile,
                                                               reverse_r=8)
        cand_p, cand_c = sp.merge_reverse_candidates(fwd_p, fwd_c, rev_t, rev_c, extra=16)
        del ep, er, fwd_p, fwd_c, rev_t, rev_c
        zeros = (torch.zeros(n, device=dev), torch.full((n,), -1, dtype=torch.int32, device=dev),
                 torch.full((n,), -1, dtype=torch.int32, device=dev),
                 torch.zeros(n, dtype=torch.bool, device=dev))

        def shards(state, B):
            return ps._make_shards(mesh, cand_p, cand_c, True, *state, B)

        def digest(st) -> str:
            h = hashlib.sha256()
            for name in ("price", "owner", "p4t", "retired", "ctl", "win_key", "win_task"):
                h.update(getattr(st, name).cpu().numpy().tobytes())
            return h.hexdigest()[:16]

        # the cold segment's state, the carried segment's start
        sh = shards(zeros, 4096)
        ps._segment(mesh, *sh, n, 4.0, 4096, 256, 0)
        st = sh[1]
        carried = (st.price[0].clone(), st.owner[0].clone(), st.p4t.reshape(-1).clone(),
                   torch.zeros(n, dtype=torch.bool, device=dev))
        cases = {"cold": (zeros, 4.0, 4096), "carried": (carried, 0.02, 512)}

        out["segments"] = {}
        for key, (state, eps, B) in cases.items():
            ms, res = [], None
            for rep in range(4):  # a warm-up, then three timed
                sh = shards(state, B)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                res = ps._segment(mesh, *sh, n, eps, B, 256, 0)
                end.record()
                end.synchronize()
                if rep:
                    ms.append(start.elapsed_time(end))
            st = sh[1]
            seg = {"ms": sum(ms) / len(ms), "ms_each": ms, "it_stall_open": list(res),
                   "frontier_rows": int(st.ctl[:, kernels.CTL_ROWS].sum()),
                   "assigned": int((st.p4t >= 0).sum()), "sha256": digest(st)}
            out["segments"][key] = seg
            print(f"segment {key}: {json.dumps(seg)}", flush=True)
        del cand_p, cand_c, carried, cases

        # the mesh matcher on chip_smoke.py's torch-route pool: cold, then
        # after 1% node churn
        nodes, tasks = cs.make_pool(np.random.default_rng(cs.SEED + 30), *cs.ARENA_POOL,
                                    sites=cs.SITES)
        store = cs.mem_store(nodes, tasks)
        rng = np.random.default_rng(cs.SEED + 63)
        m = tb.TorchBatchMatcher(store, use_mesh=True, device=dev)
        out["matcher"] = {}
        for step in ("cold", "node_churn"):
            if step == "node_churn":
                cs.churn_nodes(rng, store, cs.CHURN, first=n * 3)
            torch.cuda.synchronize()
            kernels.reset_launches()
            kernels.time_in_place(True)
            t0 = time.perf_counter()
            m.refresh()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            in_place = kernels.in_place_ms()
            kernels.time_in_place(False)
            s_ = m.last_solve_stats
            out["matcher"][step] = {
                "wall_ms": wall, "phase1_ms": s_["phase1_ms"], "solve_ms": s_["solve_ms"],
                "assigned": s_["assigned"], "mesh_sharded": s_["mesh_sharded"],
                "mesh_route": s_.get("mesh_route"), "stall_exit": s_.get("stall_exit"),
                "launches": {k: v for k, v in kernels.LAUNCHES.items() if v},
                "in_place_ms": {k: v["ms"] for k, v in in_place.items()},
            }
            print(f"matcher {step}: {json.dumps(out['matcher'][step])}", flush=True)
        del m, store, nodes, tasks

        # the D = 4 arena's cold tick, after a warm-up tick
        pa = synth_provider_arrays(np.random.default_rng(2), n)
        ra = synth_requirement_arrays(np.random.default_rng(3), n)
        arena = TorchSolveArena(devices=D, device=dev, cold_every=0)
        arena.solve(types.SimpleNamespace(**pa), types.SimpleNamespace(**ra), w)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arena.solve(types.SimpleNamespace(**pa), types.SimpleNamespace(**ra), w)
        torch.cuda.synchronize()
        s_ = arena.last_stats
        out["arena_cold_tick"] = {"wall_ms": (time.perf_counter() - t0) * 1e3,
                                  "gen_ms": s_.get("gen_ms"), "solve_ms": s_.get("solve_ms"),
                                  "assigned": s_.get("assigned"),
                                  "plan_cost": s_.get("plan_cost")}
        print(f"arena cold tick: {json.dumps(out['arena_cold_tick'])}", flush=True)
    finally:
        platform.force_virtual_devices(prev, "cuda")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
