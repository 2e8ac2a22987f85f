#!/usr/bin/env python3
"""Time K14, the blocked Sinkhorn's streamed passes, at stage S's shape on
one NVIDIA card, for an A/B of two checkouts.

    python3 scripts/torch_k14_ab.py [--root DIR] [--size 100000] [--tile 2500] [--iters 20]

Imports ``protocol_tpu_torch`` from ``--root`` (default: this checkout), so
that one call can time a parent and a change in turn (parent, change,
change, parent). Works on the per-cell K14 (passes without a bitmap) and
on the bitmap K14 (passes that take the feasibility launch's bitmaps).
Builds the kernels, makes stage S's instance (seed 42, providers first,
default weights), then times with CUDA events, three runs after a
warm-up each: the feasibility launch, the row and the column pass (v and
u drawn from seeds 1 and 2, masked as the solve masks them), the same
three at one D = 4 shard (the first P / 4 providers: the feasibility
launch, the row pass and the column pass's partial mode), and 40
``torch.logsumexp`` calls over one materialised [P, tile] block beside
each pass; then the one-device potentials (``--iters`` iterations) by
host clock to the end of the device work, with their peak device
memory, the plan-guided rounding from their u (k = 32), and the D = 4
sharded potentials on four views of the card. The sha256 of both
feasibility launches' bitmaps and masks, of both potentials and of the
rounding's matching are printed, so that two checkouts' outputs can be
compared. Prints the card's name and power limit and one JSON line.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
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


def sha(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--size", type=int, default=100_000)
    ap.add_argument("--tile", type=int, default=2_500)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops import blocked as bl
    from protocol_tpu_torch.ops.cost import CostWeights
    from protocol_tpu_torch.parallel import sinkhorn as psk
    from protocol_tpu_torch.parallel.mesh import make_mesh
    from protocol_tpu_torch.trace.synth import synth_providers, synth_requirements
    from protocol_tpu_torch.utils import platform

    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"root: {kernels.__file__}", flush=True)
    bitmaps = "bits" in inspect.signature(kernels.blocked_row_lse).parameters
    build_s = kernels.build()
    n, tile, eps = args.size, args.tile, 0.05
    rng = np.random.default_rng(42)
    ep = synth_providers(rng, n, device="cuda")
    er = synth_requirements(rng, n, device="cuda")
    w = CostWeights()
    feas = kernels.blocked_feasibility(ep, er, w)
    row_any, col_any = feas[0], feas[1]
    sha_feas = {"masks": sha(row_any, col_any)}
    if bitmaps:
        sha_feas.update(rows=sha(feas[2].rows), cols=sha(feas[2].cols))
    extra = (feas[2],) if bitmaps else ()
    v = torch.from_numpy(np.random.default_rng(1).normal(0, 3, n).astype(np.float32)).cuda()
    v = torch.where(col_any, v, -1e18)
    u = torch.from_numpy(np.random.default_rng(2).normal(0, 3, n).astype(np.float32)).cuda()
    u = torch.where(row_any, u, -1e18)
    out = {"root": os.path.abspath(args.root), "card": card, "k14": "bitmaps" if bitmaps
           else "per-cell", "size": n, "tile": tile, "build_s": build_s,
           "feasibility_sha256": sha_feas}
    out["feasibility_ms"] = cuda_ms(torch, lambda: kernels.blocked_feasibility(ep, er, w))
    out["row_ms"] = cuda_ms(torch, lambda: kernels.blocked_row_lse(ep, er, w, eps, v, *extra))
    out["col_ms"] = cuda_ms(torch, lambda: kernels.blocked_col_lse(ep, er, w, eps, u, *extra))
    k_block = bl.make_k_block(ep, er, w, eps, tile)
    n_tiles = n // tile
    x = k_block(0) + v[None, :tile]
    out["library_row_ms"] = cuda_ms(
        torch, lambda: [torch.logsumexp(x, dim=1) for _ in range(n_tiles)], 1)
    x = k_block(0) + u[:, None]
    out["library_col_ms"] = cuda_ms(
        torch, lambda: [torch.logsumexp(x, dim=0) for _ in range(n_tiles)], 1)
    del x, feas, extra

    prev = platform.force_virtual_devices(4, "cuda")
    try:
        mesh = make_mesh(4, "cuda")
        ep0 = psk._shard_providers(ep, mesh)[0]
        pl = n // 4
        u0 = u[:pl].contiguous()
        feas0 = kernels.blocked_feasibility(ep0, er, w)
        extra = (feas0[2],) if bitmaps else ()
        out["shard_feasibility_sha256"] = dict(
            masks=sha(feas0[0], feas0[1]),
            **({"rows": sha(feas0[2].rows), "cols": sha(feas0[2].cols)} if bitmaps else {}))
        del feas0
        out["shard_feasibility_ms"] = cuda_ms(
            torch, lambda: kernels.blocked_feasibility(ep0, er, w))
        out["shard_partial_ms"] = cuda_ms(
            torch, lambda: kernels.blocked_col_partial(ep0, er, w, eps, u0, *extra))
        out["shard_row_ms"] = cuda_ms(
            torch, lambda: kernels.blocked_row_lse(ep0, er, w, eps, v, *extra))
        k0 = bl.make_k_block(ep0, er, w, eps, tile)
        x = k0(0) + u0[:, None]
        out["shard_library_col_ms"] = cuda_ms(
            torch, lambda: [torch.logsumexp(x, dim=0) for _ in range(n_tiles)], 1)
        x = k0(0) + v[None, :tile]
        out["shard_library_row_ms"] = cuda_ms(
            torch, lambda: [torch.logsumexp(x, dim=1) for _ in range(n_tiles)], 1)
        del x, extra, k0

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pu, pv = bl.sinkhorn_potentials_blocked(ep, er, w, eps=eps, num_iters=args.iters,
                                                tile=tile)
        torch.cuda.synchronize()
        out["potentials_s"] = time.perf_counter() - t0
        out["potentials_peak_bytes"] = torch.cuda.max_memory_allocated()
        out["potentials_sha256"] = sha(pu, pv)
        res = bl.plan_guided_rounding(ep, er, pu, w, eps=eps, tile=tile, k=32)
        out["rounding_sha256"] = sha(res.provider_for_task)
        out["rounding_assigned"] = int((res.provider_for_task >= 0).sum())
        t0 = time.perf_counter()
        su, sv = psk.sinkhorn_potentials_sharded(ep, er, mesh, w, eps=eps,
                                                 num_iters=args.iters, tile=tile)
        torch.cuda.synchronize()
        out["sharded_potentials_s"] = time.perf_counter() - t0
        out["sharded_potentials_sha256"] = sha(su, sv)
    finally:
        platform.force_virtual_devices(prev, "cuda")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
