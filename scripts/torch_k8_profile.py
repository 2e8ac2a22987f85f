#!/usr/bin/env python3
"""Profile K8, the unbounded best (``kernels.unbounded_best``), on one
NVIDIA card: its launch alone and the device time of each kernel its C
entry launches (the prep, the key buffer's memset, the list launch, the
decode).

    python3 scripts/torch_k8_profile.py [--root DIR] [--min-rows N]

Imports ``protocol_tpu_torch`` and ``chip_smoke`` from ``--root`` (default:
this checkout). ``--min-rows N`` (a multiple of 8) times a variant whose
list launch gives each block at least N task rows (the checkout's grid
gives it one 8-row step where the tasks are few): a copy of the root's
package under ``build/k8_min<N>/`` with ``run_range_list`` patched for
K8, built there. At two shapes, default weights: the backend's ``best``
RPC market (``chip_smoke.run_backend``'s, 4,096 providers x 1,024 tasks)
and 65,536 providers x 64 tasks (the torch route's phase 2 shape, on the
synthetic marketplace). For each: three means of 100 launches alone
(``scripts/torch_dense_ab.py``'s ``launch_ms``), the sha256 of ``best``,
and ``torch.profiler``'s device microseconds a launch per kernel over 20
calls. Prints the card's name and power limit and, last, one JSON line.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROW_STEP = "  const int max_ranges = (a.T + kMaxRows - 1) / kMaxRows;\n"


def variant(root: str, min_rows: int) -> str:
    """A copy of ``root``'s package and ``chip_smoke.py`` whose K8 list
    launch gives a block at least ``min_rows`` rows; returns its root."""
    out = os.path.join(root, "build", f"k8_min{min_rows}")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(os.path.join(root, "protocol_tpu_torch"),
                    os.path.join(out, "protocol_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(root, "chip_smoke.py"), out)
    src = os.path.join(out, "protocol_tpu_torch", "csrc", "candidates.cu")
    with open(src) as f:
        text = f.read()
    if text.count(ROW_STEP) != 1:
        raise SystemExit("run_range_list's row step not found: this checkout has another grid")
    text = text.replace(ROW_STEP, (
        f"  constexpr int kMin = kMode == kListBest ? {min_rows} : kMaxRows;\n"
        "  const int max_ranges = (a.T + kMin - 1) / kMin;\n"))
    with open(src, "w") as f:
        f.write(text)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--min-rows", type=int, default=0)
    args = ap.parse_args()
    if args.min_rows % 8:
        raise SystemExit("--min-rows takes a multiple of 8")
    root = os.path.abspath(args.root)
    if args.min_rows:
        root = variant(root, args.min_rows)
    sys.path.insert(0, root)
    sys.path.insert(1, HERE)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    import torch_dense_ab as ab
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops.cost import CostWeights
    from protocol_tpu_torch.trace.synth import synth_providers, synth_requirements

    card = ab.card_line()
    print(f"card: {card}", flush=True)
    out = {"root": root, "min_rows": args.min_rows, "card": card,
           "build_s": kernels.build(("candidates",))}
    w = CostWeights()
    shapes = {
        "best_rpc": ab.backend_market(cs, cs.SEED + 53, cs.BACKEND_BEST[0], "cuda",
                                      cs.BACKEND_BEST[1]),
        "phase2_shape": (synth_providers(np.random.default_rng(2), 65_536, device="cuda"),
                         synth_requirements(np.random.default_rng(3), 64, device="cuda")),
    }
    for name, (ep, er) in shapes.items():
        def call():
            return kernels.unbounded_best(ep, er, w)

        r = {"P": ep.num, "T": er.num, "sha256": ab.sha(call()),
             "launch_ms": [ab.launch_ms(torch, kernels, call, 100) for _ in range(3)]}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        r["device_us_a_launch"] = {}
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            if us:
                r["device_us_a_launch"][e.key[:48]] = us / max(e.count, 1)
        print(f"K8 {name}: {json.dumps(r)}", flush=True)
        out[name] = r
    print(f"card: {card}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
