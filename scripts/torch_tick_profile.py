#!/usr/bin/env python3
"""Where the time of one solve tick of the PyTorch port goes, on one NVIDIA
card.

    python3 scripts/torch_tick_profile.py [--n 65536] [--warm] [--out FILE]

Builds the kernels and makes an n x n synthetic marketplace (seeds 2/3,
default weights). Without ``--warm``: one warm-up cold tick of
TorchSolveArena(cold_every=0), then one more under torch.profiler. With
``--warm``: a cold prime and one warm-up warm tick at 1% requirement churn
(``ram_mb`` x U(0.8, 1.25), floored at 256, the reference's warm bench),
then two profiled warm ticks: one at 1% requirement churn and one at 1%
provider churn (price U(0.5, 4.0), load U(0, 1)). For each profiled tick
it prints the wall time and stage split (gen_ms / solve_ms / quality_ms
and the repair scope from last_stats), the device time by kernel, the
device's busy and idle shares of the tick's wall time, and each hand
kernel's device ms and launches timed in place by the launch wrappers
(``kernels.time_in_place``); ``--out`` also writes the full report
(every device row) to a file. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAT_KEYS = ("gen_ms", "solve_ms", "quality_ms", "eng_rounds_total", "assigned", "changed_rows",
             "repair_rows", "repair_providers", "repair_blocks", "repair_enter_rows",
             "visited_cells_frac", "cand_cold_passes")


def profile_tick(torch, kernels, arena, step, label: str) -> tuple[list[str], bool]:
    """Run ``step()`` (one tick) under torch.profiler, with the kernels'
    in-place timing on; the report lines and whether any device time was
    recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    kernels.time_in_place(True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    in_place = kernels.in_place_ms()
    kernels.time_in_place(False)
    st = arena.last_stats

    # device-side events only (kernels, copies, fills): a host op's row
    # repeats the device time of the kernels it launched
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    lines = [
        f"== {label}",
        f"wall_ms={wall_ms:.3f} " + " ".join(f"{k}={st.get(k)}" for k in STAT_KEYS),
        f"device busy_ms={busy_ms:.3f} busy_share={busy_ms / wall_ms:.4f} "
        f"idle_share={1 - busy_ms / wall_ms:.4f}",
        f"{'device_ms':>12} {'calls':>7}  name",
    ]
    lines += [f"{us / 1e3:12.3f} {cnt:7d}  {name[:100]}" for us, cnt, name in rows]
    lines.append("in place (event pairs around each launch): " + "; ".join(
        f"{name} {v['ms']:.3f} ms ({v['launches']})"
        for name, v in sorted(in_place.items(), key=lambda kv: -kv[1]["ms"])))
    return lines, bool(rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=65_536)
    ap.add_argument("--warm", action="store_true", help="profile warm ticks, not a cold one")
    ap.add_argument("--out", default="", help="also write the full report to this file")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this profile needs one card", file=sys.stderr)
        return 2
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops.cost import CostWeights
    from protocol_tpu_torch.parallel.torch_arena import TorchSolveArena
    from protocol_tpu_torch.trace.synth import synth_provider_arrays, synth_requirement_arrays

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    kernels.build()
    n = args.n
    w = CostWeights()
    pa = synth_provider_arrays(np.random.default_rng(2), n)
    ra = synth_requirement_arrays(np.random.default_rng(3), n)
    churn = np.random.default_rng(3)

    def solve(arena):
        return arena.solve(types.SimpleNamespace(**pa), types.SimpleNamespace(**ra), w)

    def req_churn():
        rows = churn.choice(n, max(1, n // 100), replace=False)
        ram = ra["ram_mb"].copy()
        ram[rows] = np.maximum(256, (ram[rows] * churn.uniform(0.8, 1.25, rows.size)).astype(np.int32))
        ra["ram_mb"] = ram

    def prov_churn():
        rows = churn.choice(n, max(1, n // 100), replace=False)
        price, load = pa["price"].copy(), pa["load"].copy()
        price[rows] = churn.uniform(0.5, 4.0, rows.size).astype(np.float32)
        load[rows] = churn.uniform(0, 1, rows.size).astype(np.float32)
        pa["price"], pa["load"] = price, load

    lines = [f"card: {card}", f"n={n} mode={'warm' if args.warm else 'cold'}"]
    recorded = True
    if args.warm:
        arena = TorchSolveArena(device="cuda")
        solve(arena)  # the cold prime
        req_churn()
        solve(arena)  # warm-up warm tick: allocator, library loads
        for label, churn_fn in (("warm tick, 1% requirement churn", req_churn),
                                ("warm tick, 1% provider churn", prov_churn)):
            churn_fn()
            part, got = profile_tick(torch, kernels, arena, lambda: solve(arena), label)
            lines += part
            recorded &= got
    else:
        arena = TorchSolveArena(device="cuda", cold_every=0)
        solve(arena)  # warm-up: allocator, library loads
        part, recorded = profile_tick(torch, kernels, arena, lambda: solve(arena), "cold tick")
        lines += part
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    # the report without the device rows under 1 ms (--out keeps them all)
    print("\n".join(
        line for line in lines
        if not line[:12].strip().replace(".", "").isdigit() or float(line.split()[0]) >= 1.0
    ))
    if not recorded:
        print("the profiler recorded no device time", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
