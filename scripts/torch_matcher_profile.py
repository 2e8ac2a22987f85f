#!/usr/bin/env python3
"""Where the time of the matcher's default route above dense_cell_budget
goes (the candidate cache), on one NVIDIA card.

    python3 scripts/torch_matcher_profile.py [--out FILE]

Builds the kernels and the pool of ``chip_smoke.py``'s default-route run
(ARENA_POOL: 65,536 nodes, 4,096 bounded tasks x 16 replicas, 64 swarm
tasks, located nodes at 256 shared sites) and drives
``TorchBatchMatcher(store)`` with the reference's defaults: a warm-up
refresh pair on a second matcher (allocator, library loads), then three
profiled refreshes under torch.profiler: cold, warm after 1% node churn
(joins, departures, price drift), and two tasks replaced. For each it
prints the wall time, the matcher's stats, the host split of the cache's
prepare (the time inside each CandidateCache step, its device work
included up to its readbacks; ``topk`` counts the delta and merge passes,
``merge_new_rows`` includes its own), the device time by kernel, and the
device's busy and idle shares of the wall time; ``--out`` also writes the
full report. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAT_KEYS = ("prepare_ms", "encode_ms", "phase1_ms", "phase2_ms", "warm", "warm_seeded_slots",
             "stall_exit", "cache_rebuilt", "cache_delta_rows", "cache_delta_tasks",
             "cache_uncovered_rows", "assigned")
CACHE_STEPS = ("_register_batch", "_encode_req_row", "_assemble_ep", "_stale_fraction", "_topk",
               "_merge_new_rows", "_repair_coverage")


def time_cache_steps(cache) -> dict:
    """Wrap the cache's steps so the host time inside each one (ms, summed
    over its calls) lands in the returned dict; reset it per refresh."""
    spent: dict = {}
    for name in CACHE_STEPS:
        orig = getattr(cache, name)

        def wrapped(*args, _orig=orig, _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _orig(*args, **kw)
            finally:
                spent[_name] = spent.get(_name, 0.0) + (time.perf_counter() - t0) * 1e3

        setattr(cache, name, wrapped)
    return spent


def profile_refresh(torch, matcher, spent: dict, label: str) -> tuple[list[str], bool]:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    spent.clear()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        matcher.refresh()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    st = matcher.last_solve_stats
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
        "prepare split (host ms, device work to its readbacks): "
        + " ".join(f"{k.lstrip('_')}={v:.3f}" for k, v in spent.items()),
        f"device busy_ms={busy_ms:.3f} busy_share={busy_ms / wall_ms:.4f} "
        f"idle_share={1 - busy_ms / wall_ms:.4f}",
        f"{'device_ms':>12} {'calls':>7}  name",
    ]
    lines += [f"{us / 1e3:12.3f} {cnt:7d}  {name[:100]}" for us, cnt, name in rows]
    return lines, bool(rows)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write the full report to this file")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this profile needs one card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.sched.torch_backend import TorchBatchMatcher

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    kernels.build()

    def pool(seed):
        nodes, tasks = cs.make_pool(np.random.default_rng(seed), *cs.ARENA_POOL, sites=cs.SITES)
        return cs.mem_store(nodes, tasks), len(nodes)

    # warm-up on a pool of its own: the allocator, library loads
    store, n = pool(cs.SEED + 60)
    warmup = TorchBatchMatcher(store)
    warmup.refresh()
    cs.churn_nodes(np.random.default_rng(cs.SEED + 61), store, cs.CHURN, first=n)
    warmup.refresh()
    del warmup, store

    store, n = pool(cs.SEED + 30)
    rng = np.random.default_rng(cs.SEED + 52)
    matcher = TorchBatchMatcher(store)  # the reference's defaults
    spent = time_cache_steps(matcher._cache)
    lines = [f"card: {card}",
             f"pool: {cs.ARENA_POOL[0]} nodes, {cs.ARENA_POOL[1]} tasks x {cs.ARENA_POOL[2]}, "
             f"{cs.ARENA_POOL[3]} swarm tasks"]
    recorded = True
    steps = (
        ("cold refresh", lambda: None),
        ("warm refresh after 1% node churn",
         lambda: cs.churn_nodes(rng, store, cs.CHURN, first=n)),
        ("refresh after two tasks replaced",
         lambda: cs.churn_pool(rng, store, 0.0, replace_tasks=2)),
    )
    for label, change in steps:
        change()
        part, got = profile_refresh(torch, matcher, spent, label)
        lines += part
        recorded &= got
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
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
