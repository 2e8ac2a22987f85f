#!/usr/bin/env python3
"""Time K13, the dense Sinkhorn, at the scheduler backend's sinkhorn RPC
shape on one NVIDIA card, for an A/B of two checkouts.

    python3 scripts/torch_sinkhorn_ab.py [--root DIR] [--sizes 4096,8192] [--iters 200]
        [--shares 1.0] [--share-size 4096]

Imports ``protocol_tpu_torch`` from ``--root`` (default: this checkout), so
that one call can time a parent and a change in turn (parent, change,
change, parent); works on any K13 whose ``kernels.sinkhorn(cost_tp, eps,
num_iters)`` returns (plan, rounding cost, column maxima, u, v). For each
size n it makes the backend's marketplace at n x n (the sinkhorn RPC's
draws at 4,096, seed 53: providers, then requirements, default weights),
its unjittered cost block (K10, slot-major, as the RPC's ``cost_only``);
for each share in ``--shares`` a uniform [0, 10) cost at ``--share-size``
squared with that share of its cells feasible (1.0: every cell, as an RPC
may be sent; seed 7). On each it times with CUDA events, three runs after a warm-up: K13 at eps 0.05
and ``--iters`` rounds, and at 0 rounds (its prep and final pass alone).
It holds the result against the plain Sinkhorn (``ops/assign.py``): the
masks of u and v, their largest difference on the unmasked entries, the
plan's, whether the rounding inputs are those of K13's own plan bit for
bit and K12 on them the plain loop's; and prints the sha256 of each
output, the feasible share of the cells and, where the checkout has
``kernels.sinkhorn_layout``, the layout K13 takes. Prints the card's name and
power limit and one JSON line per size. Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def cuda_ms(torch, fn, reps: int = 3) -> float:
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


def sha(t) -> str:
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--sizes", default="4096,8192")
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--shares", default="1.0")
    ap.add_argument("--share-size", type=int, default=4096)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops import assign as da
    from protocol_tpu_torch.ops.cost import CostWeights
    from protocol_tpu_torch.ops.encoding import providers_from_numpy, requirements_from_numpy
    from protocol_tpu_torch.trace.synth import synth_provider_arrays, synth_requirement_arrays

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"root: {kernels.__file__}", flush=True)
    build_s = kernels.build(("dense", "greedy", "sinkhorn"))
    eps, iters = 0.05, args.iters

    def rpc_cost(n):
        rng = np.random.default_rng(53)
        ep = providers_from_numpy(synth_provider_arrays(rng, n), "cuda")
        er = requirements_from_numpy(synth_requirement_arrays(rng, n), "cuda")
        return kernels.cost_block(ep, er, CostWeights())

    def share_cost(share):
        gen = torch.Generator(device="cuda").manual_seed(7)
        n = args.share_size
        c = torch.rand((n, n), generator=gen, device="cuda") * 10.0
        return torch.where(torch.rand((n, n), generator=gen, device="cuda") < share, c, 1e9)

    cases = [(f"rpc_{n}", lambda n=n: rpc_cost(n)) for n in (int(x) for x in args.sizes.split(","))
             if n > 0]
    cases += [(f"share_{x}", lambda x=x: share_cost(float(x))) for x in args.shares.split(",")
              if x]
    for name, make in cases:
        cost_tp = make()
        cost = cost_tp.T
        n = cost_tp.shape[0]
        feasible = int((cost_tp < 5e8).sum())
        out = {"root": os.path.abspath(args.root), "card": card, "case": name, "n": n,
               "eps": eps, "iters": iters, "build_s": build_s, "feasible": feasible,
               "feasible_share": feasible / (n * n)}
        if hasattr(kernels, "sinkhorn_layout"):
            out["layout"] = kernels.sinkhorn_layout(feasible, n, n)
        out["ms"] = cuda_ms(torch, lambda: kernels.sinkhorn(cost_tp, eps, iters))
        out["ms_zero_rounds"] = cuda_ms(torch, lambda: kernels.sinkhorn(cost_tp, eps, 0))
        out["us_per_round"] = (out["ms"] - out["ms_zero_rounds"]) * 1e3 / max(iters, 1)
        plan_tp, rcost_tp, colmax, u, v = kernels.sinkhorn(cost_tp, eps, iters)
        out["sha256"] = {name: sha(t) for name, t in (("plan", plan_tp), ("rcost", rcost_tp),
                                                      ("colmax", colmax), ("u", u), ("v", v))}
        K, pu, pv = da._sinkhorn_plain(cost, eps, iters)
        pplan = da._plan_plain(K, pu, pv)
        del K
        masks, errs = True, {}
        for name, got, ref in (("u", u, pu), ("v", v, pv)):
            masked = ref < -1e17
            masks &= bool(torch.equal(got < -1e17, masked)) and bool((got[masked] == -1e18).all())
            errs[name] = float((got - ref)[~masked].abs().max()) if bool((~masked).any()) else 0.0
        errs["plan"] = float((plan_tp.T - pplan).abs().max())
        del pplan
        r_tp, order = da._rounding_inputs(cost, plan_tp.T)
        k_order = torch.sort(-colmax, stable=True).indices.to(torch.int32)
        rounding = (torch.equal(rcost_tp.view(torch.int32), r_tp.view(torch.int32))
                    and torch.equal(k_order, order))
        out["greedy_ms"] = cuda_ms(torch, lambda: kernels.greedy_assign(rcost_tp, k_order))
        p4t = kernels.greedy_assign(rcost_tp, k_order)
        out.update(masks_exact=masks, max_abs_err=errs, rounding_inputs_exact=rounding,
                   rounding_equals_plain=bool(torch.equal(p4t, da._greedy_plain(r_tp, order))),
                   assigned=int((p4t >= 0).sum()), p4t_sha256=sha(p4t))
        print(json.dumps(out), flush=True)
        del cost_tp, cost, plan_tp, rcost_tp, colmax, u, v, r_tp
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
