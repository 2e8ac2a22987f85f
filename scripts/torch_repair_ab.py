#!/usr/bin/env python3
"""Time the warm repair's list launches of the PyTorch port, K1's reverse
blocks, K4 (the dirty-tile minima) and K3 (the enter scan), on one NVIDIA
card, for an A/B of two checkouts.

    python3 scripts/torch_repair_ab.py [--root DIR] [--reps 5]

Imports ``protocol_tpu_torch`` from ``--root`` (default: this checkout), so
that one call can time a parent and a change in turn (parent, change,
change, parent). Builds the kernels and prints the compiler's register,
stack and spill lines for ``csrc/candidates.cu`` and ``csrc/repair.cu``.
Then, at default weights, on ``chip_smoke.py``'s synthetic marketplace
(providers seed 2, requirements seed 3) at two shapes, 65,536^2 with tile
1,024 and ``chip_smoke.py``'s SECOND, 24,576 providers x 20,000 tasks with
tile 1,000 (a tile that is no multiple of a power-of-two row step):

  - a cold pass with pools (k = 64, reverse r = 8);
  - a 1% requirement-churn repair (new ``ram_mb`` on 1% of the tasks, seed
    7) and a 1% provider-churn repair (new price and load on 1% of the
    providers: every tile of each one flagged), through
    ``parallel/sparse.py::repair_topk_bidir``, recording the arguments of
    each one's reverse-blocks launch and the first one's K4 launch, with
    every kernel's device ms in place (``kernels.time_in_place``);
  - with CUDA events over ``--reps`` runs after a warm-up, and over 4 x
    ``--reps`` launches alone (``launch_ms``, the wrapper's host checks and
    syncs left out): the reverse
    blocks on both recorded block sets and K4 on the recorded dirty ids;
    K3 on the provider-churn repair's recorded enter call (its dirty
    providers against every task) and, at 65,536^2, on the last of four
    shards of those tasks at its jitter offset (16,384 tasks at 49,152,
    the sharded enter scan); at 65,536^2 also the cold pass (K1's fused
    launch, whose check and scoring the list launches share).

Every output is printed with a sha256 of its bytes (the pools after each
blocks launch from the cold pools, the tile minima, the enter flags, the
repaired parts), so the two sides compare bit for bit. Prints the card's name and power
limit and, last, one JSON line. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys

SHAPES = ((65_536, 65_536, 1_024), (24_576, 20_000, 1_000))  # (P, T, tile)
CHURN = 0.01
SHARDS = 4  # the sharded enter scan: the last shard's tasks at its offset


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def cuda_ms(torch, fn, reps: int) -> float:
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


def launch_ms(torch, kernels, call, reps: int) -> float:
    """Device ms of the launch a wrapper call makes, alone: ``call()`` runs
    the wrapper once, and its C entry, once launched, is launched ``reps``
    times more back to back between two CUDA events, while the wrapper's
    buffers are alive (every entry timed here rewrites the same outputs).
    Leaves out the wrapper's host checks and syncs."""
    orig, got = kernels._launch, {}

    def replay(key, fn, *args, what=None):
        orig(key, fn, *args, what=what)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            kernels._check(fn(*args), key)
        end.record()
        end.synchronize()
        got["ms"] = start.elapsed_time(end) / reps

    kernels._launch = replay
    try:
        call()
    finally:
        kernels._launch = orig
    return got["ms"]


def sha(a) -> str:
    return hashlib.sha256(a.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def ptxas_lines(log: str) -> list[str]:
    """Each entry function's name, then its registers and stack and spill bytes."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
        elif name and ("registers" in line or "spill" in line or "stack frame" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def enter_ab(torch, kernels, sp, ep, er, w, p_ids, thresh, offset: int, reps: int,
             label: str) -> dict:
    """K3 on one call: its flags' sha256, the mean ms of ``reps`` wrapper
    calls (its id checks included) and of its launch alone."""
    def call():
        return kernels.repair_enter(ep, er, w, p_ids, thresh, offset=offset)

    got = call()
    r = {"providers": p_ids.numel(), "tasks": er.num, "offset": offset,
         "flagged": int(got.sum()), "sha": sha(got), "ms": cuda_ms(torch, call, reps),
         "launch_ms": launch_ms(torch, kernels, call, 4 * reps)}
    print(f"{label}: K3 {json.dumps(r)}", flush=True)
    return r


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=5)
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
    from protocol_tpu_torch.parallel import sparse as ps
    from protocol_tpu_torch.trace.synth import synth_providers, synth_requirements

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"root: {kernels.__file__}", flush=True)
    out = {"root": os.path.abspath(args.root), "card": card, "build_s": kernels.build()}
    for lib in ("candidates", "repair"):
        out[f"ptxas_{lib}"] = ptxas_lines(kernels.BUILD_LOG.get(lib, ""))
        for line in out[f"ptxas_{lib}"]:
            print(f"ptxas {lib}: {line}", flush=True)

    w = CostWeights()
    recorded: dict = {}
    originals = {n: getattr(kernels, n)
                 for n in ("candidates_reverse_blocks", "repair_tile_min", "repair_enter")}

    def recording(name):
        def call(*a, **kw):
            recorded.setdefault(name, []).append(
                tuple(x.clone() if torch.is_tensor(x) else x for x in a))
            return originals[name](*a, **kw)
        return call

    for P, T, tile in SHAPES:
        key = f"{P}x{T}"
        res = out[key] = {"P": P, "T": T, "tile": tile}
        ep = synth_providers(np.random.default_rng(2), P, device="cuda")
        er = synth_requirements(np.random.default_rng(3), T, device="cuda")

        def cold():
            return sp.candidates_topk_reverse(ep, er, w, k=64, tile=tile, reverse_r=8,
                                              with_pools=True)

        fp, fc, _, _, pt, pc = cold()
        if P == T:
            res["cold_pass_ms"] = cuda_ms(torch, cold, 3)
            res["cold_launch_ms"] = launch_ms(torch, kernels, cold, 5)
            print(f"{key} cold pass (K1 fused): {res['cold_pass_ms']:.3f} ms, launch "
                  f"{res['cold_launch_ms']:.3f} ms", flush=True)
        rng = np.random.default_rng(7)
        dirty_t = np.sort(rng.choice(T, int(T * CHURN), replace=False))
        ram = er.ram_mb.clone()
        ids = torch.from_numpy(dirty_t).cuda()
        ram[ids] = torch.from_numpy(
            rng.integers(256, 65_536, dirty_t.size).astype(np.int32)).cuda()
        er_req = dataclasses.replace(er, ram_mb=ram)
        dirty_p = np.sort(rng.choice(P, int(P * CHURN), replace=False))
        price, load = ep.price.clone(), ep.load.clone()
        pids = torch.from_numpy(dirty_p).cuda()
        price[pids] = torch.from_numpy(rng.uniform(0.5, 4.0, dirty_p.size).astype(np.float32)).cuda()
        load[pids] = torch.from_numpy(rng.uniform(0, 1, dirty_p.size).astype(np.float32)).cuda()
        ep_prov = dataclasses.replace(ep, price=price, load=load)
        none = np.zeros(0, np.int64)
        for label, ep_, er_, d_p, d_t in (("req_churn", ep, er_req, none, dirty_t),
                                          ("prov_churn", ep_prov, er, dirty_p, none)):
            recorded.clear()
            for n in originals:
                setattr(kernels, n, recording(n))
            torch.cuda.synchronize()
            kernels.time_in_place(True)
            try:
                parts = ps.repair_topk_bidir(ep_, er_, w, fwd_p=fp, fwd_c=fc, pool_t=pt,
                                             pool_c=pc, dirty_p=d_p, dirty_t=d_t, tile=tile)
            finally:
                for n, f in originals.items():
                    setattr(kernels, n, f)
            sums = kernels.in_place_ms()
            kernels.time_in_place(False)
            r = res[label] = {
                "repair_blocks": parts[6]["repair_blocks"], "repair_rows": parts[6]["repair_rows"],
                "in_place": {n: sums[n] for n in originals if n in sums},
                "parts_sha": {n: sha(a) for n, a in zip(
                    ("cand_p", "cand_c", "fwd_p", "fwd_c", "pool_t", "pool_c"), parts[:6])},
            }
            (b_ep, b_er, b_w, b_tile, b_p, b_j, b_pt, b_pc), = recorded["candidates_reverse_blocks"]
            pools = (b_pt.clone(), b_pc.clone())
            kernels.candidates_reverse_blocks(b_ep, b_er, b_w, b_tile, b_p, b_j, *pools)
            r["blocks"] = b_p.numel()
            r["blocks_tiles"] = int(torch.unique(b_j).numel())
            r["blocks_sha"] = {"pool_t": sha(pools[0]), "pool_c": sha(pools[1])}
            def blocks():
                kernels.candidates_reverse_blocks(b_ep, b_er, b_w, b_tile, b_p, b_j, *pools)

            r["blocks_ms"] = cuda_ms(torch, blocks, args.reps)
            r["blocks_launch_ms"] = launch_ms(torch, kernels, blocks, 4 * args.reps)
            print(f"{key} {label}: reverse blocks {r['blocks']} blocks in {r['blocks_tiles']} "
                  f"tiles: {r['blocks_ms']:.4f} ms, launch {r['blocks_launch_ms']:.4f} ms "
                  f"{json.dumps(r['blocks_sha'])}", flush=True)
            if "repair_tile_min" in recorded:
                (m_ep, m_er, m_w, m_ids, m_tile, m_pad), = recorded["repair_tile_min"]
                r["tile_min_rows"] = m_ids.numel()
                r["tile_min_sha"] = sha(kernels.repair_tile_min(m_ep, m_er, m_w, m_ids, m_tile,
                                                                m_pad))
                def tile_min():
                    kernels.repair_tile_min(m_ep, m_er, m_w, m_ids, m_tile, m_pad)

                r["tile_min_ms"] = cuda_ms(torch, tile_min, args.reps)
                r["tile_min_launch_ms"] = launch_ms(torch, kernels, tile_min, 4 * args.reps)
                print(f"{key} {label}: K4 over {r['tile_min_rows']} dirty tasks: "
                      f"{r['tile_min_ms']:.4f} ms, launch {r['tile_min_launch_ms']:.4f} ms "
                      f"{r['tile_min_sha']}", flush=True)
            if "repair_enter" in recorded:
                (n_ep, n_er, n_w, n_ids, n_th), = recorded["repair_enter"]
                r["enter"] = enter_ab(torch, kernels, sp, n_ep, n_er, n_w, n_ids, n_th, 0,
                                      args.reps, f"{key} {label}")
                if P == T:
                    lo = T // SHARDS * (SHARDS - 1)
                    r["enter_shard"] = enter_ab(
                        torch, kernels, sp, n_ep, sp.slice_requirements(n_er, lo, T - lo), n_w,
                        n_ids, n_th[lo:].contiguous(), lo, args.reps, f"{key} {label} shard")
            print(f"{key} {label}: in place {json.dumps(r['in_place'])} repair_blocks "
                  f"{r['repair_blocks']} parts {json.dumps(r['parts_sha'])}", flush=True)
        del ep, er, fp, fc, pt, pc, ep_prov, er_req
        torch.cuda.empty_cache()
    print(f"card: {card}", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
