#!/usr/bin/env python3
"""Time the dependent-chain kernels, K11 (the FFD bin-pack) and K9 (the
greedy cleanup), on one NVIDIA card, for an A/B of two checkouts.

    python3 scripts/torch_chain_ab.py [--root DIR]

Imports ``protocol_tpu_torch`` and ``chip_smoke`` from ``--root`` (default:
this checkout), so that one call can time a parent and a change in turn
(parent, change, change, parent); works on checkouts from before the
chain kernels' redesign too. Builds the kernels, then:
  - K11 on every call of a cold refresh of the matcher's dense route
    (``chip_smoke.py``'s 4,096-node pool with its phase mix at 1/8) and of
    its torch route (the 65,536-node pool with the full phase mix): the
    anti-affinity calls (R = 1) and the colocation call (R = 5), each the
    mean of three by CUDA events after a warm-up, with its shapes, us a
    step and a sha256 of its outputs; where the checkout has K11's two
    instantiations, each call also in the device one;
  - the dense route's refresh wall, ``phase0_ms`` and ``phase05_ms``;
  - K9 on the cut-auction state of ``chip_smoke.py`` (65,536^2, k = 64,
    reverse r = 8, 16 extra columns; the cold phase cut after two rounds):
    on its first 4,096 open rows and on every open row, each the mean of
    five, with ns a row and a sha256 of p4t;
  - the mesh matcher (``use_mesh=True``, 4 views of the card, the
    candidate cache) on the torch route's pool, cold and after 1% node
    churn: ``phase1_ms``, the refresh wall, K9's in-place device ms and a
    sha256 of the (node, task name) pairs.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
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
    from protocol_tpu_torch.sched import torch_backend as tb
    from protocol_tpu_torch.trace.synth import synth_providers, synth_requirements
    from protocol_tpu_torch.utils import platform

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"root: {kernels.__file__}", flush=True)
    routes = hasattr(kernels, "binpack_route")
    dev = "cuda"
    out = {"root": os.path.abspath(args.root), "card": card,
           "k11": "two instantiations" if routes else "one", "build_s": kernels.build()}
    for name in ("binpack", "cleanup"):
        for line in kernels.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    def cuda_ms(fn, reps: int) -> float:
        return cs.cuda_ms(torch, fn, reps)

    # ---- K11 on the matcher's calls, and the dense route's phase times
    def k11_calls(label, pool, mix, **kw):
        nodes, tasks = cs.make_pool(np.random.default_rng(pool[0]), *pool[1], sites=cs.SITES)
        tasks += cs.phase_tasks(np.random.default_rng(mix[0]), *mix[1])
        store = cs.mem_store(nodes, tasks)
        m = tb.TorchBatchMatcher(store, device=dev, **kw)
        calls = []
        orig = kernels.binpack_ffd

        def spy(*a, **k):
            calls.append((a, k))
            return orig(*a, **k)

        kernels.binpack_ffd = spy
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.refresh()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            kernels.binpack_ffd = orig
        st = m.last_solve_stats
        res = {"wall_ms": wall, "phase0_ms": st["phase0_ms"], "phase05_ms": st["phase05_ms"],
               "binpack_routes": st.get("binpack_routes"), "calls": []}
        for a, k in calls:
            T, P = a[0].shape
            got = kernels.binpack_ffd(*a, **k)
            c = {"T": T, "P": P, "R": int(a[1].shape[1]), "LG": int(a[6]) * int(a[7]),
                 "route": k.get("route"), "ms": cuda_ms(lambda: kernels.binpack_ffd(*a, **k), 3),
                 "sha256": sha(*got)}
            c["us_per_step"] = c["ms"] * 1e3 / T
            if routes:
                c["device_ms"] = cuda_ms(lambda: kernels.binpack_ffd(*a, route="device"), 3)
                c["device_sha256"] = sha(*kernels.binpack_ffd(*a, route="device"))
            res["calls"].append(c)
            print(f"K11 {label}: {json.dumps(c)}", flush=True)
        print(f"matcher {label}: wall_ms {wall:.1f} phase0_ms {st['phase0_ms']:.1f} "
              f"phase05_ms {st['phase05_ms']:.1f}", flush=True)
        return res

    out["dense"] = k11_calls("dense", (cs.SEED + 20, cs.DENSE_POOL),
                             (cs.SEED + 22, cs.PHASE_DENSE_MIX))
    out["torch"] = k11_calls("torch", (cs.SEED + 30, cs.ARENA_POOL),
                             (cs.SEED + 32, cs.PHASE_MIX), native_engine="torch")

    # ---- K9 on the cut-auction state
    n = cs.N
    ep = synth_providers(np.random.default_rng(2), n, device=dev)
    er = synth_requirements(np.random.default_rng(3), n, device=dev)
    tile = sp.pick_tile(n, cap=min(1024, max(1, n // 8)))
    fwd_p, fwd_c, rev_t, rev_c = sp.candidates_topk_reverse(ep, er, CostWeights(), k=64,
                                                           tile=tile, reverse_r=8)
    cand_p, cand_c = sp.merge_reverse_candidates(fwd_p, fwd_c, rev_t, rev_c, extra=16)
    del ep, er, fwd_p, fwd_c, rev_t, rev_c
    cand_safe, value_base, feas, give_up = sp._phase_inputs(cand_p, cand_c, True)
    state0 = sp._initial_state(n, n, torch.device(dev))
    cut, _ = kernels.auction_phase(cand_safe, value_base, feas, give_up, state0, P=n, eps=4.0,
                                   max_iters=2, B=4096, stall_limit=0)
    owner, p4t = cut[2], cut[3]
    open_all = torch.nonzero(p4t < 0).flatten()
    out["k9"] = {}
    for key, rows in (("open_4096", open_all[:4096]), ("open_all", open_all)):
        got = kernels.greedy_cleanup(cand_p, cand_c, owner, p4t, rows)
        ms = cuda_ms(lambda: kernels.greedy_cleanup(cand_p, cand_c, owner, p4t, rows), 5)
        r = {"open_rows": int(rows.numel()), "ms": ms, "ns_per_row": ms * 1e6 / rows.numel(),
             "seated": int((got[rows] >= 0).sum()), "sha256": sha(got)}
        out["k9"][key] = r
        print(f"K9 {key}: {json.dumps(r)}", flush=True)
    del cand_p, cand_c, cand_safe, value_base, feas, give_up, cut, owner, p4t

    # ---- the mesh matcher: cold, then after 1% node churn
    prev = platform.force_virtual_devices(4, "cuda")
    try:
        nodes, tasks = cs.make_pool(np.random.default_rng(cs.SEED + 30), *cs.ARENA_POOL,
                                    sites=cs.SITES)
        store = cs.mem_store(nodes, tasks)
        rng = np.random.default_rng(cs.SEED + 63)
        m = tb.TorchBatchMatcher(store, use_mesh=True, device=dev)
        out["mesh_matcher"] = {}
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
            k9 = in_place.get("greedy_cleanup", {"ms": 0.0, "launches": 0})
            out["mesh_matcher"][step] = {
                "wall_ms": wall, "phase1_ms": s_["phase1_ms"], "assigned": s_["assigned"],
                "stall_exit": s_.get("stall_exit"), "k9_in_place_ms": k9["ms"],
                "k9_launches": k9["launches"],
                # task ids are drawn at random: the pairs by task name
                "assignment_sha256": hashlib.sha256(json.dumps(sorted(
                    (a, store.task_store.get_task(t).name) for a, t in m._assignment.items()
                )).encode()).hexdigest()[:16],
            }
            print(f"mesh matcher {step}: {json.dumps(out['mesh_matcher'][step])}", flush=True)
        del m, store, nodes, tasks
    finally:
        platform.force_virtual_devices(prev, "cuda")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
