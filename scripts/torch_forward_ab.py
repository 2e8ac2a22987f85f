#!/usr/bin/env python3
"""Time K1, the candidate kernel, and the cold solve tick of the PyTorch
port on one NVIDIA card, for an A/B of two checkouts.

    python3 scripts/torch_forward_ab.py [--root DIR] [--n 65536] [--stage 100000] [--ticks 3]

Imports ``protocol_tpu_torch`` from ``--root`` (default: this checkout), so
that one call can time a parent and a change in turn (parent, change,
change, parent). Builds the kernels and prints the compiler's register,
stack and spill lines for ``csrc/candidates.cu`` (per kernel). Then,
with CUDA events over five runs after a warm-up, default weights:

  - the cold pass ``candidates_topk_reverse(with_pools=True)`` (k = 64,
    reverse r = 8, tile 1,024) on the n x n synthetic marketplace of
    ``chip_smoke.py`` (seeds 2 / 3);
  - K1's rows launch over 655 task ids (the 1% a warm tick repairs, drawn
    from seed 7), unbiased;
  - on stage S's instance (P = T = ``--stage``, tile 2,500, its generator
    seed 42): the biased forward pass ``candidates_topk(k=32,
    provider_offset=bias)`` with a [P] bias of -0.05 x U(0, 4) (seed 9),
    and the referee's cold pass (k = 64, reverse r = 8);
  - ``--ticks`` cold ticks of ``TorchSolveArena(cold_every=0)`` after a
    warm-up tick (host wall clock to the end of the device work);
  - every kernel's device ms in place (``kernels.time_in_place``) over one
    cold tick and over a warm chain: a cold prime, then a 1%
    requirement-churn tick and a 1% provider-churn tick (the churn of
    ``scripts/torch_tick_profile.py --warm``).

Every output array and each tick's ``assigned`` / ``plan_cost`` is printed
with a sha256 of its bytes, so the two sides compare bit for bit. Prints
the card's name and power limit and, last, one JSON line. Exits non-zero
without a CUDA device.
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

REPAIR_ROWS = 655  # 1% of 65,536: the rows a warm tick's forward repair takes
STAGE_TILE = 2_500
BIAS_K = 32


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


def digests(arrays, names) -> dict:
    """sha256 of each array's bytes (on the host)."""
    return {n: hashlib.sha256(a.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]
            for n, a in zip(names, arrays)}


def ptxas_lines(log: str) -> list[str]:
    """The compiler's per-kernel lines: each entry function's name, then its
    registers and its stack and spill bytes."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
        elif name and ("registers" in line or "spill" in line or "stack frame" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--n", type=int, default=65_536)
    ap.add_argument("--stage", type=int, default=100_000)
    ap.add_argument("--ticks", type=int, default=3)
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
    out = {"root": os.path.abspath(args.root), "card": card, "n": args.n,
           "build_s": kernels.build()}
    out["ptxas"] = ptxas_lines(kernels.BUILD_LOG.get("candidates", ""))
    for line in out["ptxas"]:
        print(f"ptxas candidates: {line}", flush=True)

    n, w = args.n, CostWeights()
    ep = synth_providers(np.random.default_rng(2), n, device="cuda")
    er = synth_requirements(np.random.default_rng(3), n, device="cuda")
    tile = sp.pick_tile(n, cap=min(1024, max(1, n // 8)))
    six = ("fwd_p", "fwd_c", "rev_t", "rev_c", "pool_t", "pool_c")

    def cold_pass(ep_, er_, tile_):
        return sp.candidates_topk_reverse(ep_, er_, w, k=64, tile=tile_, reverse_r=8,
                                          with_pools=True)

    out["cold_pass_sha"] = digests(cold_pass(ep, er, tile), six)
    out["cold_pass_ms"] = cuda_ms(torch, lambda: cold_pass(ep, er, tile))
    print(f"cold pass {n}^2: {out['cold_pass_ms']:.3f} ms {json.dumps(out['cold_pass_sha'])}",
          flush=True)
    ids = torch.from_numpy(np.sort(np.random.default_rng(7).choice(
        n, REPAIR_ROWS, replace=False)).astype(np.int32)).cuda()
    out["rows_sha"] = digests(kernels.candidates_forward_rows(ep, er, w, 64, ids), ("p", "c"))
    out["rows_ms"] = cuda_ms(torch, lambda: kernels.candidates_forward_rows(ep, er, w, 64, ids))
    print(f"rows launch, {REPAIR_ROWS} rows: {out['rows_ms']:.3f} ms "
          f"{json.dumps(out['rows_sha'])}", flush=True)
    del ep, er, ids

    rng = np.random.default_rng(42)  # stage S's instance: one generator, providers first
    ep = synth_providers(rng, args.stage, device="cuda")
    er = synth_requirements(rng, args.stage, device="cuda")
    bias = torch.from_numpy((-0.05 * np.random.default_rng(9).uniform(0, 4, args.stage))
                            .astype(np.float32)).cuda()

    def biased():
        return sp.candidates_topk(ep, er, w, k=BIAS_K, tile=STAGE_TILE, provider_offset=bias)

    out["biased_sha"] = digests(biased(), ("p", "c"))
    out["biased_ms"] = cuda_ms(torch, biased)
    print(f"biased forward {args.stage}^2 k={BIAS_K}: {out['biased_ms']:.3f} ms "
          f"{json.dumps(out['biased_sha'])}", flush=True)
    out["stage_cold_pass_sha"] = digests(cold_pass(ep, er, STAGE_TILE), six)
    out["stage_cold_pass_ms"] = cuda_ms(torch, lambda: cold_pass(ep, er, STAGE_TILE), 3)
    print(f"cold pass {args.stage}^2 tile {STAGE_TILE}: {out['stage_cold_pass_ms']:.3f} ms "
          f"{json.dumps(out['stage_cold_pass_sha'])}", flush=True)
    del ep, er, bias

    # cold ticks on the device-resident marketplace
    ep = synth_providers(np.random.default_rng(2), n, device="cuda")
    er = synth_requirements(np.random.default_rng(3), n, device="cuda")
    arena = TorchSolveArena(device="cuda", cold_every=0)
    arena.solve(ep, er, w)  # warm-up
    walls, gen = [], []
    for _ in range(args.ticks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        arena.solve(ep, er, w)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        gen.append(arena.last_stats["gen_ms"])
    out.update(tick_wall_ms=walls, tick_gen_ms=gen, assigned=int(arena.last_stats["assigned"]),
               plan_cost=arena.last_stats.get("plan_cost"))
    print(f"cold ticks: wall {walls} gen {gen} assigned {out['assigned']} "
          f"plan_cost {out['plan_cost']}", flush=True)
    del arena, ep, er

    # every kernel in place over a cold tick and a warm chain
    pa = synth_provider_arrays(np.random.default_rng(2), n)
    ra = synth_requirement_arrays(np.random.default_rng(3), n)
    churn = np.random.default_rng(3)

    def solve(arena):
        return arena.solve(types.SimpleNamespace(**pa), types.SimpleNamespace(**ra), w)

    def req_churn():
        rows = churn.choice(n, max(1, n // 100), replace=False)
        ram = ra["ram_mb"].copy()
        ram[rows] = np.maximum(256, (ram[rows] * churn.uniform(0.8, 1.25, rows.size))
                               .astype(np.int32))
        ra["ram_mb"] = ram

    def prov_churn():
        rows = churn.choice(n, max(1, n // 100), replace=False)
        price, load = pa["price"].copy(), pa["load"].copy()
        price[rows] = churn.uniform(0.5, 4.0, rows.size).astype(np.float32)
        load[rows] = churn.uniform(0, 1, rows.size).astype(np.float32)
        pa["price"], pa["load"] = price, load

    def in_place(label, arena, step):
        torch.cuda.synchronize()
        kernels.time_in_place(True)
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        sums = kernels.in_place_ms()
        kernels.time_in_place(False)
        st = arena.last_stats
        out[label] = {"wall_ms": wall, "in_place": sums, "assigned": st.get("assigned"),
                      "plan_cost": st.get("plan_cost"),
                      "p4t_sha": hashlib.sha256(np.asarray(step.result).tobytes()).hexdigest()[:16]}
        print(f"{label}: {json.dumps(out[label])}", flush=True)

    def run(fn):
        def step():
            step.result = fn()
        return step

    arena = TorchSolveArena(device="cuda", cold_every=0)
    solve(arena)  # warm-up
    in_place("cold_tick", arena, run(lambda: solve(arena)))
    arena = TorchSolveArena(device="cuda")
    in_place("warm_prime", arena, run(lambda: solve(arena)))
    for label, churn_fn in (("req_churn_tick", req_churn), ("prov_churn_tick", prov_churn)):
        churn_fn()
        in_place(label, arena, run(lambda: solve(arena)))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
