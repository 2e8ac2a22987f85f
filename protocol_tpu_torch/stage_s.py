"""BASELINE ladder #3 at shape on one card: Sinkhorn-OT soft assignment at
P = T = 100,000, its quality compared with the eps-scaled auction on the
same instance. The port's counterpart of the blocked engine of
``scripts/stage_s_100k.py``:

    python -m protocol_tpu_torch.stage_s [--size 100000] [--tile 2500]
        [--iters 20] [--device cuda] [--json-out PATH]

The potentials (blocked Sinkhorn, eps 0.05, kernel K14) are computed once
and reused for the plan-guided rounding (k = 32 candidates under the
provider offset -eps*u, K1's biased forward launch, then the scaled
sparse auction); the referee is the bidirectional candidate generation (k
= 64, reverse r = 8, 16 extra columns) and the scaled auction with a
frontier of 8,192. Quality is measured pairwise (``cost_pairs``, K15), as
[P, T] would be 40 GB. Prints one JSON line per stage row (the
reference's keys) and, last, the summary with the Sinkhorn-vs-auction
mean-cost delta in %. ``--device cpu`` runs the plain torch path (keep
the size small there). The reference's ``sparse-mt`` engine (the native
C++ library) is not ported: ``--engine sparse-mt`` is refused.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from protocol_tpu_torch.device import resolve_device
from protocol_tpu_torch.ops.blocked import plan_guided_rounding, sinkhorn_potentials_blocked
from protocol_tpu_torch.ops.cost import INFEASIBLE, CostWeights, cost_pairs
from protocol_tpu_torch.ops.sparse import assign_auction_sparse_scaled, candidates_topk_bidir
from protocol_tpu_torch.trace.synth import synth_providers, synth_requirements

EPS = 0.05  # the Sinkhorn's entropic regularisation, as the reference's stage S


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def quality(ep, er, p4t: torch.Tensor, weights: CostWeights) -> dict:
    """Assigned count, injectivity, infeasible pairs and mean cost of an
    assignment, from its pairwise costs."""
    c = cost_pairs(ep, er, p4t, weights).cpu().numpy()
    p4t = p4t.cpu().numpy()
    ok = (p4t >= 0) & (c < INFEASIBLE * 0.5)
    pos = p4t[p4t >= 0]
    return {
        "assigned": int((p4t >= 0).sum()),
        "injective": bool(np.unique(pos).size == pos.size),
        "infeasible_pairs": int((p4t >= 0).sum() - ok.sum()),
        "mean_cost": round(float(c[ok].mean()), 4) if ok.any() else None,
    }


def run(size: int = 100_000, tile: int = 2_500, iters: int = 20, device="cuda",
        emit=None, keep: dict | None = None) -> dict:
    """Stage S at P = T = ``size``. Returns the summary dict (``rows``,
    ``sinkhorn_vs_auction_mean_cost_delta_pct``); each row is passed to
    ``emit`` as it completes. ``keep``, when given, receives the instance
    and the intermediate tensors (ep, er, u, v, the two matchings, the
    referee's candidates) for the caller's checks."""
    dev = resolve_device(device)
    P = T = size
    if T % tile != 0:
        raise ValueError(f"tile {tile} must divide T {T}")
    platform = "gpu" if dev.type == "cuda" else "cpu"
    weights = CostWeights()
    rng = np.random.default_rng(42)
    ep = synth_providers(rng, P, device=dev)
    er = synth_requirements(rng, T, device=dev)
    summary: dict = {"engine": "blocked", "size": size, "rows": []}

    def add(row: dict) -> None:
        summary["rows"].append(row)
        if emit is not None:
            emit(row)

    # ---- Sinkhorn potentials, computed once and reused for the rounding
    _sync(dev)
    t0 = time.perf_counter()
    u, v = sinkhorn_potentials_blocked(ep, er, weights, eps=EPS, num_iters=iters, tile=tile)
    _sync(dev)
    t_pot = time.perf_counter() - t0

    # plan-guided candidates + auction rounding
    t0 = time.perf_counter()
    res_s = plan_guided_rounding(ep, er, u, weights, eps=EPS, tile=tile, k=32)
    _sync(dev)
    t_sink = t_pot + (time.perf_counter() - t0)
    q_sink = quality(ep, er, res_s.provider_for_task, weights)
    add({
        "stage": "S sinkhorn-OT at shape (measured)",
        "platform": platform,
        "shape": f"P=T={P} iters={iters} tile={tile} (potentials reused for rounding)",
        "potentials_s": round(t_pot, 2),
        "end_to_end_s": round(t_sink, 2),
        **{f"sinkhorn_{k}": val for k, val in q_sink.items()},
    })

    # ---- the auction on the same instance (quality referee)
    t0 = time.perf_counter()
    cp, cc = candidates_topk_bidir(ep, er, weights, k=64, tile=tile, reverse_r=8, extra=16)
    _sync(dev)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_a = assign_auction_sparse_scaled(cp, cc, num_providers=P, frontier=8192)
    _sync(dev)
    t_solve = time.perf_counter() - t0
    q_auc = quality(ep, er, res_a.provider_for_task, weights)
    add({
        "stage": "S auction referee on the same instance (measured)",
        "platform": platform,
        "shape": f"P=T={P} k=64 bidir",
        "gen_s": round(t_gen, 2),
        "solve_s": round(t_solve, 2),
        **{f"auction_{k}": val for k, val in q_auc.items()},
    })
    delta = None
    if q_sink["mean_cost"] and q_auc["mean_cost"]:
        delta = round(100.0 * (q_sink["mean_cost"] - q_auc["mean_cost"]) / q_auc["mean_cost"], 3)
    summary["sinkhorn_vs_auction_mean_cost_delta_pct"] = delta
    summary["timings_s"] = {"potentials": t_pot, "end_to_end": t_sink, "gen": t_gen,
                            "solve": t_solve}
    if keep is not None:
        keep.update(ep=ep, er=er, u=u, v=v, weights=weights, sinkhorn=res_s, auction=res_a,
                    referee_candidates=(cp, cc))
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m protocol_tpu_torch.stage_s")
    ap.add_argument("--size", type=int, default=100_000)
    ap.add_argument("--tile", type=int, default=2_500)
    ap.add_argument("--iters", type=int, default=20, help="Sinkhorn iterations")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--engine", choices=("blocked", "sparse-mt"), default="blocked")
    ap.add_argument("--json-out", default="", help="write the summary dict here as JSON")
    args = ap.parse_args(argv)
    if args.engine != "blocked":
        ap.error(f"engine {args.engine!r}: the native sparse engine is not ported "
                 "(ROADMAP.md queue A, M5)")
    print(f"# stage S at shape: P=T={args.size} tile={args.tile} device={args.device} "
          f"engine={args.engine}", file=sys.stderr, flush=True)
    summary = run(args.size, args.tile, args.iters, args.device,
                  emit=lambda row: print(json.dumps(row), flush=True))
    print(json.dumps({k: summary[k] for k in ("engine", "size",
                                              "sinkhorn_vs_auction_mean_cost_delta_pct")}),
          flush=True)
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump(summary, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
