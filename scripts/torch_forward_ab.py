#!/usr/bin/env python3
"""Time K1's forward candidate pass and the cold solve tick of the PyTorch
port on one NVIDIA card, for an A/B of two checkouts.

    python3 scripts/torch_forward_ab.py [--root DIR] [--n 65536] [--ticks 5]

Imports ``protocol_tpu_torch`` from ``--root`` (default: this checkout), so
that one call can time a parent and a change in turn (parent, change,
change, parent). Builds the kernels, makes an n x n synthetic marketplace
(seeds 2/3, default weights), then times, with CUDA events, the forward
pass ``ops.sparse.candidates_forward`` (k = 64) over the first T tasks
for T in 2,048 .. n, five runs each, and ``--ticks`` cold ticks of
``TorchSolveArena(cold_every=0)`` after one warm-up tick (host wall clock
to the end of the device work, with the tick's gen_ms / solve_ms). Prints
the card's name and power limit and one JSON line. Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SIZES = (2_048, 8_192, 32_768, 65_536)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def event_ms(torch, fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--n", type=int, default=65_536)
    ap.add_argument("--ticks", type=int, default=5)
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
    from protocol_tpu_torch.ops.encoding import slice_requirements
    from protocol_tpu_torch.parallel.torch_arena import TorchSolveArena
    from protocol_tpu_torch.trace.synth import synth_providers, synth_requirements

    print(f"card: {card_line()}", flush=True)
    print(f"root: {kernels.__file__}", flush=True)
    build_s = kernels.build()
    n = args.n
    ep = synth_providers(np.random.default_rng(2), n, device="cuda")
    er = synth_requirements(np.random.default_rng(3), n, device="cuda")
    w = CostWeights()
    out = {"root": os.path.abspath(args.root), "n": n, "build_s": build_s, "forward_ms": {}}
    for T in (t for t in SIZES if t <= n):
        er_t = slice_requirements(er, 0, T)
        tile = sp.pick_tile(T, cap=min(1024, max(1, T // 8)))
        sp.candidates_forward(ep, er_t, w, 64, tile)  # warm-up
        out["forward_ms"][T] = [event_ms(torch, lambda: sp.candidates_forward(ep, er_t, w, 64, tile))
                                for _ in range(5)]
        print(f"forward {T} x {n}: {out['forward_ms'][T]}", flush=True)
    arena = TorchSolveArena(device="cuda", cold_every=0)
    arena.solve(ep, er, w)  # warm-up
    walls, gen, solve = [], [], []
    for _ in range(args.ticks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arena.solve(ep, er, w)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        gen.append(arena.last_stats["gen_ms"])
        solve.append(arena.last_stats["solve_ms"])
    out.update(tick_wall_ms=walls, tick_gen_ms=gen, tick_solve_ms=solve,
               assigned=int(arena.last_stats["assigned"]))
    print(f"cold ticks: wall {walls} gen {gen} solve {solve}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
