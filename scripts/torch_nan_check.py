#!/usr/bin/env python3
"""Hold the kernels the backend's RPCs reach against their plain versions
on NaN cells, on one NVIDIA card, for a check of two checkouts.

    python3 scripts/torch_nan_check.py [--root DIR]

Imports ``protocol_tpu_torch`` from ``--root`` (default: this checkout).
The cells: the synthetic marketplace with ``chip_smoke.nan_columns``' NaN
price on provider 7 and NaN priority on task 5, which asks for nothing
(every provider fits it) or, for the dense kernels, for the providers'
median RAM (about half of them fit it), at proximity 0. For each kernel
it prints the outputs that differ from the plain version and in how many
places:

  - K1 (the ``topk`` RPC): the fused cold pass, the rows launch over every
    task and the reverse launch, at 3,000 x 1,024 (tile 256: rt 2) and 20
    x 512 (k 20, tile 64: rt 1), against ``_bidir_plain``;
  - K8 (``best``), K6 with K7 (``auction``) and K10 (``greedy``,
    ``sinkhorn``) at 1,000 x 700 against ``_solve_unbounded_plain``,
    ``cost_matrix`` + ``with_tie_jitter`` and the plain auction, and
    ``cost_matrix``; K13 on K10's block with the NaN cells against the
    plain Sinkhorn (u, v masked where the plain ones are, within 1e-3;
    the plan within 2e-5).

Prints the card's name and power limit and, last, one JSON line. Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def nan_columns():
    """``chip_smoke.nan_columns`` of this checkout (the root's may predate it)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_nan", os.path.join(os.path.dirname(HERE), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.nan_columns, mod.NAN_TASK


def differ(torch, names, got, ref) -> dict:
    """{name: places whose bits differ} for each pair that differs."""
    out = {}
    for name, a, b in zip(names, got, ref):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        n = int((a != b).sum())
        if n:
            out[name] = n
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(HERE))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops import assign as da
    from protocol_tpu_torch.ops import sparse as sp
    from protocol_tpu_torch.ops.cost import CostWeights, cost_matrix, with_tie_jitter
    from protocol_tpu_torch.sched import torch_backend as tb
    from protocol_tpu_torch.trace.synth import synth_providers, synth_requirements

    nan_edit, nan_task = nan_columns()
    card = card_line()
    print(f"card: {card}", flush=True)
    out = {"root": os.path.abspath(args.root), "card": card, "build_s": kernels.build()}
    w = CostWeights(proximity=0.0)

    def market(P, T, seed_p, seed_t):
        return (synth_providers(np.random.default_rng(seed_p), P, device="cuda"),
                synth_requirements(np.random.default_rng(seed_t), T, device="cuda"))

    k1_names = ("fwd_p", "fwd_c", "rev_t", "rev_c", "pool_t", "pool_c")
    for P, T, k, tile in ((3000, 1024, 64, 256), (20, 512, 20, 64)):
        ep, er = nan_edit(torch, *market(P, T, P, T), ram_mb=-1)
        rt = max(1, -(-8 // (T // tile)))
        ref = sp._bidir_plain(ep, er, w, k, tile, 8, rt, 0)
        ids = torch.arange(T, dtype=torch.int32, device="cuda")
        r = out[f"k1_{P}x{T}_rt{rt}"] = {
            "fused": differ(torch, k1_names, sp.candidates_fused(ep, er, w, k, tile, 8, rt), ref),
            "rows": differ(torch, k1_names[:2],
                           kernels.candidates_forward_rows(ep, er, w, k, ids), ref[:2]),
            "reverse": differ(torch, k1_names[2:],
                              kernels.candidates_reverse(ep, er, w, tile, 8, rt), ref[2:]),
            "nan_task_row_nan_places": int(torch.isnan(ref[1][nan_task]).sum()),
        }
        print(f"K1 {P} x {T}, k {k}, tile {tile}, rt {rt}: places differing from the plain "
              f"version {json.dumps(r)}", flush=True)

    ep, er = market(1000, 700, 43, 44)
    ep, er = nan_edit(torch, ep, er)
    w1 = CostWeights(priority=1.0, proximity=0.0)
    cost, _ = cost_matrix(ep, er, w1)
    vb, feas = kernels.dense_value_base(ep, er, w1)
    pvb, pfeas = da._value_base(with_tie_jitter(cost))
    got7 = kernels.dense_auction(vb, feas, 0.05, 300)
    ref7 = da._auction_dense_plain(vb, feas, 0.05, 300)
    best = kernels.unbounded_best(ep, er, w1)
    pbest = tb._solve_unbounded_plain(ep, er, w1)
    block = kernels.cost_block(ep, er, w1)
    nan_row = torch.isnan(cost).any(dim=1)
    r = out["dense_1000x700"] = {
        "providers_with_a_nan_cell": int(nan_row.sum()),
        "k8": differ(torch, ("best",), (best,), (pbest,)),
        "k8_nan_rows_not_minus_1": int((best[nan_row] != -1).sum()),
        "k6": differ(torch, ("value_base", "task_feasible"), (vb, feas), (pvb, pfeas)),
        "k7": differ(torch, ("p4t", "t4p", "price"), got7[:3], ref7[:3]),
        "k10": differ(torch, ("cost",), (block.T.contiguous(),), (cost,)),
    }
    print(f"dense kernels 1000 x 700: {json.dumps(r)}", flush=True)

    plan_tp, _, _, u, v = kernels.sinkhorn(block, 0.05, 200)
    K, pu, pv = da._sinkhorn_plain(cost, 0.05, 200)
    pplan = da._plan_plain(K, pu, pv)
    uv = {}
    for name, a, b in (("u", u, pu), ("v", v, pv)):
        masked = b < -1e17
        uv[name] = {"mask_equal": bool(torch.equal(a < -1e17, masked)),
                    "max_abs_err": float((a - b)[~masked].abs().max())}
    r = out["k13_1000x700"] = dict(uv, plan_max_abs_err=float((plan_tp.T - pplan).abs().max()),
                                   nan_in_plan=bool(torch.isnan(plan_tp).any()))
    print(f"K13 on K10's block: {json.dumps(r)}", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
