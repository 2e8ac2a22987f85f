#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand kernels from ``protocol_tpu_torch/csrc`` (nvcc, sm_90a),
prints K1's registers and local memory per instantiation, holds each
kernel against its plain torch version on the card at the main path's
shapes (K1's fused cold pass also against its forward and reverse
launches, all six arrays bit for bit), and drives the main path at 65,536 providers x 65,536 tasks from
the synthetic generators, in two runs, each with every launch counter set
to 0 just before it and read just after:

  - three cold solve ticks (TorchSolveArena(cold_every=0)), checked
    against the CPU's cold tick at 2,048^2 first;
  - a warm chain on one TorchSolveArena (default cold_every): a cold
    prime, three ticks at 1% requirement churn, one at 1% provider churn,
    an apply_rows event repricing 8 providers, a churned tick that takes
    the dual refresh, and reconcile(). After every warm tick the carried
    parts must equal a fresh cold pass on the current columns bit for bit
    (repaired == regen), and reconcile() on a copy of the arena must equal
    a fresh arena's cold tick.

The kernels the warm chain adds (K1's forward launch on the dirty rows,
its blocks variant, K3, K4, K5) and K2 from a carried state are then held against their plain
versions on the arguments of their first call in the chain, and K9 (the
greedy cleanup) on its first call in the cold ticks and on a state with
thousands of open tasks. Before the ticks K2, which runs a phase on one
thread-block cluster, is held bit for bit at 65,536^2 (cold, eps 4, B
4,096; carried, eps 0.02, B 512) at cluster sizes 1, 8 and its default
and timed at both; during the cold ticks and the warm chain every launch
is also timed in place (kernels.time_in_place: a CUDA event pair a
launch, summed per kernel), and those sums are printed and ranked; K5's
first launch in the process, which loads its module, is made before the
chain, untimed. K5 is also timed against one torch.sort of its pools
(its library_ms).

Then the batch matcher (TorchBatchMatcher) on an in-memory store built
from the port's own models, in two more runs with the counts set to 0
just before each:

  - the dense route at its full width, p_bucket x s_bucket = 2^24 =
    dense_cell_budget: 4,096 nodes (12 GPU classes, half located), 192
    bounded tasks x 16 replicas = 3,072 slots and 1,024 unbounded tasks,
    two refreshes (1% of the nodes repriced and two tasks replaced in
    between), timed in place (kernels.time_in_place; the sums printed):
    K6 + K7 (phase 1) and K8 (phase 2), each held against its plain
    version on the first refresh's inputs, K8 also on them with a NaN
    price and a NaN priority (nan_columns: a provider with a NaN cell
    gets -1);
  - the torch route (native_engine="torch") at 65,536 nodes x 65,536
    slots (4,096 tasks x 16 replicas): a cold refresh, then a warm one
    after 1% node churn.

The card's matcher must equal the port's CPU matcher on a 1,024-node x
768-slot pool, every assigned pair must meet its requirements, and every
node left to phase 2 with a compatible unbounded task must get one.

Then the matcher's anti-affinity and colocation phases (0 and 0.5), in
three more runs with the counts set to 0 just before each, each timed in
place (kernels.time_in_place) and its sums printed:

  - the torch route on the 65,536-node pool above, its located nodes at
    256 shared sites, plus 64 location-spread and 64 provider-spread tasks
    x 32 replicas over six GPU classes and 512 colocated tasks x 8
    one-GPU slices over the other six (model, per-GPU-memory, CPU, RAM and
    storage gates): a cold refresh, then a warm one after 1% node churn;
    the cold refresh must place at least half the colocated slots;
  - the dense route on the 4,096-node pool with the same mix at 1/8;
  - the dense route on that pool with 640 provider-spread tasks x 4
    replicas, whose phase-0 occupancy bitmask outgrows shared memory:
    K11's device instantiation.
K10 (the dense cost block) and K11 (the FFD bin-pack) must equal their
plain versions bit for bit on every call of the cold refresh (K11 in
every instantiation that fits the call; each call's shapes and
instantiation printed), and K1 its
plain version on the colocation phase's reverse call (several tasks per
tile) and phase 0's forward call; every spread task's replicas must sit on distinct
providers or location classes, every colocated provider's summed demand
must fit its capacity in all five resources, no provider claimed by
phase 0 or 0.5 may hold a phase-1 or phase-2 task, every placed pair must
meet its (relaxed, for colocation) requirement, and the card's matcher
must equal the CPU's on a 1,024-node store with every task kind, on both
routes.

Then the matcher's default route above dense_cell_budget: the card
against the CPU on 2,048 nodes x 2,048 slots under a lowered budget
(cold, 1% node churn, a task replaced; the dicts and the candidate
cache's prepared lists bit-identical), then on the torch route's pool
(65,536 nodes x 65,536 slots), in two more runs with the counts set to 0
just before each:

  - the stateless sparse route (warm_start=False), cold;
  - the candidate-cache route with the reference's defaults: cold (a
    rebuild), warm after 1% node churn (joins of new specs, departures,
    price drift under the stale tolerance; the delta rows are the joins),
    two tasks replaced (a fresh forward pass at the cache's non-zero
    jitter cursor), then the phase-task mix added (phases 0 and 0.5 over
    the cache's rows, their claims out of phase 1).
The cold cached refresh must seat at least 98% of the stateless route's
bounded slots, and every K1 launch of the cache at a non-zero cursor
must equal its plain version bit for bit; K1 is also held bit for bit
with a jitter offset of 123,456,789 at 65,536 x 65,536 and timed with and
without it.

Then the scheduler backend (services/scheduler_grpc.py), in one more run
with the counts set to 0 just before it and every launch timed in place
(the sums printed and carried into the K7, K12 and K13 rows with the
dense route's; K12's and K13's first launches in the process, which load
their modules, are made and timed before it, untimed and uncounted): the
port's gRPC server on a free
localhost port, driven through the port's client, on the synthetic
marketplace (new arrays for every kernel): greedy, sinkhorn (eps 0.05, 200
rounds) and auction (eps 0.01, 500 rounds) at 4,096 x 4,096 and best at
4,096 providers x 1,024 tasks, each over wire v1 and v2; topk (k = 64) at
65,536 x 65,536 cold (v2), a byte-identical repeat (v1, a candidate memo
hit), then warm from the cold answer's prices and seeds after 1% of the
providers are repriced. Every answer must pair compatible rows only, be a
matching (best: one task a provider), agree across the wires and equal the
kernel dispatch run in process on the card. K12 (the greedy) must equal its
plain version bit for bit on its first call, and K13 (the Sinkhorn) its
plain version within the stated tolerances, its rounding the plain one's
wherever no decision is closer than the plan tolerance (the ties it
excluded are printed).
Then stage S, BASELINE ladder #3 (protocol_tpu_torch/stage_s.py): the
blocked Sinkhorn's potentials on the card against the CPU's at 2,048^2
(tile 256, 20 iterations, proximity 0; masks equal, finite entries within
BLOCKED_ATOL) and the plan-guided rounding of both fed the card's u
(identical matchings); then, in one more run with the counts set to 0
just before it and every launch timed in place (the sums printed and
carried into the K14 rows), stage S at P = T = 100,000 (tile 2,500, 20
iterations):
the potentials (K14), the rounding (K1's biased forward launch, K2, K9)
and the auction referee (K1, K2, K9), each measured through cost_pairs
(K15). Both matchings must be injective with no infeasible pair, and u
and v finite on every row and column with a feasible cell; the
potentials' peak device memory is printed. K14's three launches are then
held against their plain versions at full width on the arguments of
their first calls: the feasibility launch's masks exactly and its two
bitmaps word for word against the plain packer's (built a chunk of tasks
at a time), the passes within BLOCKED_ATOL of the plain passes on the
run's bitmaps; K1's biased launch on the rounding's call, K2 on its first
call at the referee's frontier (B 8,192, T 100,000) and K15 on the
referee's matching bit for bit.
Then the provider mesh (parallel/mesh.py) at D = 4 views of the one card
(utils/platform.py's virtual count; NCCL puts no two ranks on one card,
so every D = 4 time is four shards sharing one card, not a multi-card
speed): sharded generation at 65,536^2 bit for bit equal to D = 1 and to
the one-device pass (candidate lists, forward lists, pools); then, in two
more runs with the counts set to 0 just before each, a
TorchSolveArena(devices=4) chain (cold, 3 x 1% requirement churn, 1%
provider churn), after every tick equal to TorchSolveArena(devices=1)
(matching, prices, every part) and to a fresh cold pass at D = 4
(repaired == regen), sharded, with at least 0.99 assigned; and
TorchBatchMatcher(use_mesh=True) on the torch route's pool, the stateless
route and the cached default route each cold and after 1% node churn,
every refresh sharded (mesh_sharded; mesh_gen_sharded on the stateless
route) by K16's segment launch (mesh_route), its matching checked, the
cold cached refresh seating at least 98% of the one-device cached route's
bounded slots; both runs timed in place, neither launching K16's
three-launch rounds. K1 per shard at its offset (proximity 0, bit for
bit), K3 at shard 3's offset 49,152 and K5 at 4 and 8 lanes on the
chain's calls, and K16 over one 256-round segment of the sharded scaled
ladder (the whole state), by the segment launch and by the three launches
a round, are held against their plain versions.
Then, at D = 4 views of the card again, the provider-sharded dense
auction and blocked Sinkhorn (parallel/auction.py, parallel/sinkhorn.py),
in two more runs with the counts set to 0 just before each:

  - mesh_dense: assign_auction_sharded on the jittered cost of the
    synthetic marketplace at 32,768 x 32,768 (eps 0.05, 500 rounds, the
    settings of the reference's dryrun_multichip dense path), whose
    matching must be injective, pair only feasible cells and equal K7's
    one-device assign_auction on the same cost bit for bit; K17 is first
    held bit for bit against its plain rounds at 4,096^2;
  - mesh_sinkhorn: sinkhorn_potentials_sharded on stage S's instance at
    100,000^2 (tile 2,500, 20 iterations), timed in place (the sums
    printed and carried into the sharded K14 rows), u and v within
    BLOCKED_ATOL of
    stage S's one-device potentials with equal masks, and the plan-guided
    rounding from the sharded u within stage S's 2% mean-cost bar of the
    referee; K14's partial column mode is held against its plain
    per-shard version at 2,048^2 and at full width on its first call,
    and shard 0's bitmaps against the plain packer's word for word.
Prints:

  - the card's name and power limit (nvidia-smi),
  - one JSON line ``{"kernels": [...]}``: per kernel its launches on the
    main path, its agreement with the plain version, its time, the plain
    version's time and the least time the card could take (bound_ms),
  - last, ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device, outside a
checkout of the repository, or when any phase fails. Imports nothing of
JAX or of the reference package.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import types

N = 65_536  # providers = tasks: the repo's one-chip ladder rung
SECOND = (24_576, 20_000)  # (P, T): T not a multiple of 1024 (tile 1000)
SMALL = 2_048  # the CUDA-vs-CPU agreement check
SEED = 2  # providers; requirements SEED + 1; churn rows SEED + 1 (own stream)
CHURN = 0.01  # rows per warm tick, as the reference's warm bench
EVENT_ROWS = 8  # providers repriced by the apply_rows event
COLD_KERNELS = ("candidates_bidir", "auction_phase", "greedy_cleanup")
WARM_KERNELS = COLD_KERNELS + (
    "candidates_forward_rows", "candidates_reverse_blocks", "repair_enter", "repair_tile_min",
    "repair_refold",
)
DENSE_KERNELS = ("dense_value_base", "dense_auction", "unbounded_best")
PHASE_KERNELS = ("cost_block", "binpack_ffd")  # wrappers; K11's device launch key:
K11_DEVICE = "binpack_ffd_device"
SRC_K1 = "protocol_tpu_torch/csrc/candidates.cu"
SRC_REPAIR = "protocol_tpu_torch/csrc/repair.cu"
SRC_DENSE = "protocol_tpu_torch/csrc/dense.cu"
SRC_K9 = "protocol_tpu_torch/csrc/cleanup.cu"
SRC_K11 = "protocol_tpu_torch/csrc/binpack.cu"
SRC_K12 = "protocol_tpu_torch/csrc/greedy.cu"
SRC_K13 = "protocol_tpu_torch/csrc/sinkhorn.cu"
# the scheduler backend: greedy, sinkhorn and auction at the dense route's
# 2^24-cell budget, best at 4,096 providers x 1,024 tasks, topk at N x N
BACKEND_N = 4_096
BACKEND_BEST = (4_096, 1_024)
BACKEND_TOP_K = 64
SINKHORN_EPS, SINKHORN_ITERS = 0.05, 200
AUCTION_EPS, AUCTION_ITERS = 0.01, 500
BACKEND_KERNELS = ("greedy_assign", "sinkhorn", "cost_block", "dense_value_base",
                   "dense_auction", "unbounded_best", "candidates_bidir", "auction_phase",
                   "greedy_cleanup")
# K13 against its plain version, as tests/test_torch_kernels_cuda.py states
# the bounds: the sums run in another order on the card
SINKHORN_UV_ATOL = 1e-3
SINKHORN_PLAN_ATOL = 2e-5
# the matcher's pools: the dense route at its budget, the torch route at
# the one-chip rung, the card-vs-CPU check
DENSE_POOL = (4_096, 192, 16, 1_024)  # nodes, bounded tasks, replicas, unbounded tasks
ARENA_POOL = (N, 4_096, 16, 64)
SMALL_POOL = (1_024, 48, 16, 64)
# phases 0 and 0.5: (location-spread tasks, provider-spread tasks,
# colocated tasks) beside a pool's tasks; replicas of each kind; the
# shared sites of the located nodes
PHASE_MIX = (64, 64, 512)
PHASE_DENSE_MIX = (8, 8, 64)  # the same mix at 1/8 on the dense route
PHASE_SMALL_MIX = (4, 4, 32)
# the dense route's pool with (provider-spread tasks, replicas): phase 0's
# occupancy bitmask (its rows x the group bucket, 2,048 x 1,024 bits and
# more) outgrows the block's shared memory, so K11 takes its device
# instantiation
PHASE_WIDE = (640, 4)
# the default route above dense_cell_budget (the candidate cache): the
# torch route's pool at full width, and the card-vs-CPU check on 2,048
# nodes x 2,048 slots under a lowered budget
ROUTE_SMALL_POOL = (2_048, 128, 16, 16)
ROUTE_SMALL_BUDGET = 1 << 20
ROUTE_KERNELS = ("candidates_forward_rows", "candidates_reverse", "auction_phase",
                 "greedy_cleanup", "unbounded_best")
# the stateless route generates through CandidateMemo: K1's fused launch
STATELESS_KERNELS = ("candidates_bidir", "auction_phase", "greedy_cleanup", "unbounded_best")
ROUTE_SEATS_FLOOR = 0.98  # cold cached seats against the stateless route's
K1_OFFSET = 123_456_789  # a jitter offset K1 is held at, bit for bit
AA_REPLICAS, COLO_REPLICAS = 32, 8
SITES = 256
K9_MIN_OPEN = 1_000  # open tasks K9 must sweep on the cut-auction state
GPU_CLASSES = (  # 12 model classes with their per-card memory (MB)
    ("H100", 80_000), ("H200", 141_000), ("A100", 40_000), ("A6000", 48_000),
    ("L40S", 48_000), ("L4", 24_000), ("RTX 4090", 24_000), ("RTX 3090", 24_000),
    ("V100", 32_000), ("T4", 16_000), ("MI300X", 192_000), ("B200", 180_000),
)
# the spread tasks ask for the first six classes and the colocated ones
# for the other six, so that phase 0 does not take the rows phase 0.5
# would stack on
ALL_CLASSES = tuple(range(len(GPU_CLASSES)))
SPREAD_CLASSES, COLO_CLASSES = ALL_CLASSES[:6], ALL_CLASSES[6:]
COST_TOL = 1e-3  # |cost| tolerance at default weights (haversine ulps)
# stage S (BASELINE ladder #3): the blocked Sinkhorn at the reference's
# shape, and the card against the CPU at (size, tile, iterations)
STAGE_S = (100_000, 2_500, 20)
STAGE_S_SMALL = (2_048, 256, 20)
STAGE_S_K2_B = 8_192  # the referee's frontier (stage_s.py): K2 is held on its first call
STAGE_S_KERNELS = ("blocked_feasibility", "blocked_row_lse", "blocked_col_lse",
                   "candidates_forward_rows_biased", "candidates_bidir", "auction_phase",
                   "pair_cost")
# K14's passes against their plain versions, and the card's potentials
# against the CPU's, on the finite entries (the masks exactly): the sums
# run in another order, as K13's, so K13's bound
BLOCKED_ATOL = 1e-3
SRC_BLOCKED = "protocol_tpu_torch/csrc/blocked.cu"
DEVICE = "cuda"

# published H100 SXM peaks (NVIDIA data sheet), full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

# operations per (provider, task) cell of the candidate pass, counted low
# (each transcendental as one operation): the capability check on every
# cell; the cost, haversine and jitter on feasible cells
OPS_PER_CELL = 12
OPS_PER_FEASIBLE_CELL = 30


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def launch_ms(torch, kernels, call, reps: int) -> float:
    """Device ms of the launch a wrapper call makes, alone: ``call()`` runs
    the wrapper once, and its C entry is then launched ``reps`` times more
    back to back between two CUDA events while the wrapper's buffers are
    alive (each rewrites the same outputs), uncounted. The wrapper's host
    checks and syncs are left out."""
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


def sha16(torch, *tensors) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


NAN_TASK, NAN_PROVIDER = 5, 7  # the NaN edits' rows


def nan_columns(torch, ep, er, ram_mb: int | None = None):
    """The NaN edits of the RPCs' unchecked wire columns, on copies of
    encoded columns: a NaN price on NAN_PROVIDER, and a NaN priority on
    NAN_TASK, every limit of it cleared but a RAM minimum of ``ram_mb`` (-1:
    none, so every provider fits it; default the providers' median, which
    about half of them fit). Returns (ep, er)."""
    import dataclasses

    if ram_mb is None:
        ram_mb = int(ep.ram_mb.float().median())
    price, prio = ep.price.clone(), er.priority.clone()
    price[NAN_PROVIDER], prio[NAN_TASK] = float("nan"), float("nan")
    cols = {"priority": prio}
    for name, v in (("cpu_required", 0), ("cpu_cores", -1), ("storage_gb", -1),
                    ("gpu_opt_valid", 0), ("valid", 1), ("ram_mb", ram_mb)):
        a = getattr(er, name).clone()
        a[NAN_TASK] = v
        cols[name] = a
    return dataclasses.replace(ep, price=price), dataclasses.replace(er, **cols)


def bits_equal(torch, a, b) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def check_k1(torch, sp, ep, er, weights, tile, k, r, exact: bool, label: str,
             offset: int = 0) -> dict:
    """K1 (the forward and reverse launches, the jitter keyed on task id +
    ``offset``) against the plain scans on the same inputs, and the fused
    launch against the two, all six arrays bit for bit at every weight,
    and against the plain scans as the two are held."""
    fwd = sp.candidates_forward(ep, er, weights, k, tile, task_offset=offset)
    rev = sp.candidates_reverse(ep, er, weights, tile, r, 1, task_offset=offset)
    fused = sp.candidates_fused(ep, er, weights, k, tile, r, 1, task_offset=offset)
    pf = sp._forward_plain(ep, er, weights, k, tile, task_offset=offset)
    pr = sp._reverse_plain(ep, er, weights, tile, r, 1, task_offset=offset)
    torch.cuda.synchronize()
    names = ("fwd_p", "fwd_c", "rev_t", "rev_c", "pool_t", "pool_c")
    got, ref = (*fwd, *rev), (*pf, *pr)
    res = {"label": label}
    bad = [n for n, a, b in zip(names, fused, got) if not bits_equal(torch, a, b)]
    if bad:
        raise AssertionError(f"K1 {label}: the fused launch differs from the forward and "
                             f"reverse launches: {bad}")
    res["fused_equals_separate"] = True
    if exact:
        for what, out in (("separate", got), ("fused", fused)):
            bad = [n for n, a, b in zip(names, out, ref) if not bits_equal(torch, a, b)]
            if bad:
                raise AssertionError(f"K1 {label}: the {what} launches are not bit-identical "
                                     f"to the plain version: {bad}")
        res["fwd_max_abs_err"] = res["rev_max_abs_err"] = res["bidir_max_abs_err"] = 0.0
    else:
        def err(out, plain):  # the cost arrays: fwd_c, rev_c, pool_c
            return max(float((a - b).abs().max()) for a, b in zip(out[1::2], plain[1::2]))

        fwd_err, rev_err, bidir_err = err(fwd, pf), err(rev, pr), err(fused, ref)
        res.update(fwd_max_abs_err=fwd_err, rev_max_abs_err=rev_err, bidir_max_abs_err=bidir_err)
        res["fwd_rows_differing"] = int((fwd[0] != pf[0]).any(dim=1).sum())
        res["pool_entries_differing"] = int((rev[2] != pr[2]).sum())
        if max(fwd_err, rev_err, bidir_err) > COST_TOL:
            raise AssertionError(f"K1 {label}: cost error {max(fwd_err, rev_err, bidir_err)} "
                                 f"> {COST_TOL}")
    print(f"K1 {label}: {json.dumps(res)}", flush=True)
    return res



def in_place_run(kernels, launches: dict, label: str) -> dict:
    """R0: switch in-place timing off and print and return the run's device
    ms and launches per kernel; each kernel's timed launches must be the
    launches the run counted."""
    sums = kernels.in_place_ms()
    kernels.time_in_place(False)
    counted = {name: n for name, n in launches.items() if n}
    if {name: v["launches"] for name, v in sums.items()} != counted:
        raise AssertionError(f"in place ({label}): timed launches {sums} differ from the "
                             f"counted {counted}")
    print(f"in place ({label}): " + "; ".join(
        f"{name} {v['ms']:.3f} ms ({v['launches']})"
        for name, v in sorted(sums.items(), key=lambda kv: -kv[1]["ms"])), flush=True)
    return sums


@contextlib.contextmanager
def uncounted(kernels, *counts: dict):
    """Launches made inside (the checks of the warm chain) do not count, in
    kernels.LAUNCHES nor in the further ``counts``."""
    saved = [dict(c) for c in (kernels.LAUNCHES, *counts)]
    yield
    for c, old in zip((kernels.LAUNCHES, *counts), saved):
        c.update(old)


@contextlib.contextmanager
def count_inside(kernels, modules, fn_name: str, names, into: dict, key: str):
    """While open, every call of ``fn_name`` (looked up in each of
    ``modules`` at call time) adds the launches of the wrappers ``names``
    made inside it to ``into[key]``: the launches of a kernel at the
    arguments one pass gives it, counted at their source."""
    orig = getattr(modules[0], fn_name)

    def wrapped(*args, **kw):
        before = sum(kernels.LAUNCHES[n] for n in names)
        out = orig(*args, **kw)
        into[key] += sum(kernels.LAUNCHES[n] for n in names) - before
        return out

    for m in modules:
        setattr(m, fn_name, wrapped)
    try:
        yield
    finally:
        for m in modules:
            setattr(m, fn_name, orig)


# wrappers whose first call in the warm chain is recorded, and the
# positional arguments each writes in place (cloned when recorded)
RECORDED = {
    "candidates_forward_rows": (), "candidates_reverse_blocks": (6, 7),
    "repair_enter": (), "repair_tile_min": (), "repair_refold": (), "auction_phase": (),
}


def record_first_calls(kernels, names: dict = RECORDED) -> tuple[dict, dict]:
    """Wrap the kernel wrappers ``names`` (name -> positional arguments
    written in place) so that the arguments of each one's first call are
    kept; the wrapped call (and its count) is unchanged. Returns
    (recorded, originals)."""
    seen: dict = {}
    originals = {name: getattr(kernels, name) for name in names}
    for name, written in names.items():
        def wrapped(*args, _orig=originals[name], _name=name, _written=written, **kw):
            if _name not in seen:
                kept = [a.clone() if i in _written else a for i, a in enumerate(args)]
                seen[_name] = (kept, dict(kw))
            return _orig(*args, **kw)

        setattr(kernels, name, wrapped)
    return seen, originals


def row_bytes(enc) -> int:
    """Bytes of one row over every column of an encoded dataclass."""
    total = 0
    for f in enc.__dataclass_fields__:
        t = getattr(enc, f)
        total += t.element_size() * t.numel() // t.shape[0]
    return total


def feasible_cells(torch, compat_mask, gp, gr, ep, er, p_ids=None, t_ids=None) -> int:
    """Feasible cells of providers ``p_ids`` x tasks ``t_ids`` (all when
    None), counted in task chunks of 1,024."""
    eps = ep if p_ids is None else gp(ep, p_ids)
    t_all = torch.arange(er.num, device=er.cpu_cores.device) if t_ids is None else t_ids
    return sum(
        int(compat_mask(eps, gr(er, t_all[i:i + 1024])).sum())
        for i in range(0, t_all.numel(), 1024)
    )


def row(name, src, replaces, err, ms, plain, bytes_, ops) -> dict:
    """One entry of the kernels line; ``launches`` is filled in from the
    main-path runs. The bound is the larger of the bytes over the memory
    rate and the operations over the f32 rate."""
    b_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    b_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return {
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain,
        "bound_ms": max(b_bytes, b_ops),
        "bound_by": "bytes" if b_bytes >= b_ops else "operations",
        "library_ms": None,
    }


class _Nodes:
    def __init__(self, nodes):
        self.nodes = list(nodes)

    def get_nodes(self):
        return list(self.nodes)


class _Tasks:
    def __init__(self, tasks):
        self.tasks = {t.id: t for t in tasks}

    def get_all_tasks(self):
        return list(self.tasks.values())

    def get_task(self, task_id):
        return self.tasks.get(task_id)


def mem_store(nodes, tasks):
    """An in-memory store with what the matcher reads of one."""
    return types.SimpleNamespace(node_store=_Nodes(nodes), task_store=_Tasks(tasks))


def pool_dsl(rng, classes=ALL_CLASSES) -> str:
    """A requirement in the DSL over GPU_CLASSES[classes]: one GPU
    alternative (70%) or two, each with a count and one model (80%) or two,
    sometimes a per-card memory minimum; sometimes CPU and RAM minima."""
    parts = []
    for _ in range(1 if rng.random() < 0.7 else 2):
        models = rng.choice(len(classes), 1 if rng.random() < 0.8 else 2, replace=False)
        parts.append(f"gpu:count={rng.choice([1, 2, 4, 8])}")
        parts.append("gpu:model=" + ",".join(GPU_CLASSES[classes[m]][0] for m in models))
        if rng.random() < 0.2:
            parts.append(f"gpu:memory_mb_min={rng.choice([16_000, 24_000, 40_000])}")
    if rng.random() < 0.5:
        parts.append(f"cpu:cores={rng.choice([4, 8, 16])}")
    if rng.random() < 0.3:
        parts.append(f"ram_mb={rng.choice([16_384, 65_536])}")
    return ";".join(parts)


def pool_task(rng, name: str, replicas=None):
    from protocol_tpu_torch.models.task import (
        SchedulingConfig,
        Task,
        _validate_tpu_scheduler_plugin,
    )

    plug = {"compute_requirements": [pool_dsl(rng)]}
    if replicas:
        plug["replicas"] = [str(replicas)]
    cfg = SchedulingConfig(plugins={"tpu_scheduler": plug})
    _validate_tpu_scheduler_plugin(cfg)
    return Task(name=name, created_at=int(rng.integers(1_000_000)), scheduling_config=cfg)


def make_pool(rng, n_nodes: int, n_bounded: int, replicas: int, n_unbounded: int,
              sites: int = 0, first: int = 0):
    """(nodes, tasks) of a marketplace drawn from ``rng``: nodes of the 12
    GPU_CLASSES with counts {1, 2, 4, 8}, CPU, RAM, storage, price and load,
    every other one located (with ``sites``, at one of that many shared
    coordinates), addressed from index ``first``; bounded tasks of
    ``replicas`` replicas and unbounded ones, each with a requirement DSL
    string."""
    from protocol_tpu_torch.models.node import ComputeSpecs, CpuSpecs, GpuSpecs, NodeLocation
    from protocol_tpu_torch.store.node_store import NodeStatus, OrchestratorNode

    import numpy as np

    site_rng = np.random.default_rng(SEED + 99)
    site_xy = np.stack([site_rng.uniform(-60, 60, sites), site_rng.uniform(-170, 170, sites)], 1)
    nodes = []
    for i in range(n_nodes):
        name, mem = GPU_CLASSES[int(rng.integers(len(GPU_CLASSES)))]
        if i % 2 and sites:
            loc = NodeLocation(*map(float, site_xy[int(rng.integers(sites))]))
        elif i % 2:
            loc = NodeLocation(float(rng.uniform(-60, 60)), float(rng.uniform(-170, 170)))
        else:
            loc = None
        nodes.append(OrchestratorNode(
            address=f"0x{first + i:06x}", status=NodeStatus.HEALTHY,
            compute_specs=ComputeSpecs(
                gpu=GpuSpecs(count=int(rng.choice([1, 2, 4, 8])), model=name, memory_mb=mem),
                cpu=CpuSpecs(cores=int(rng.choice([8, 16, 32, 64]))),
                ram_mb=int(rng.choice([32_768, 65_536, 262_144])),
                storage_gb=int(rng.choice([500, 2_000, 8_000])),
            ),
            location=loc, price=float(rng.uniform(0.5, 4.0)), load=float(rng.uniform(0, 1)),
        ))
    tasks = [pool_task(rng, f"b{j}", replicas) for j in range(n_bounded)]
    tasks += [pool_task(rng, f"u{j}") for j in range(n_unbounded)]
    return nodes, tasks


def colo_dsl(rng, classes=COLO_CLASSES) -> str:
    """A one-GPU slice of GPU_CLASSES[classes]: one model (70%) or two,
    sometimes a per-GPU memory minimum; sometimes CPU, RAM and storage
    minima, which the slice also reserves. The minima split each model's
    nodes into nested subsets, so the slices' cheapest candidates spread
    over thousands of nodes."""
    models = rng.choice(len(classes), 1 if rng.random() < 0.7 else 2, replace=False)
    parts = ["gpu:count=1", "gpu:model=" + ",".join(GPU_CLASSES[classes[m]][0] for m in models)]
    if rng.random() < 0.4:
        parts.append(f"gpu:memory_mb_min={rng.choice([16_000, 24_000, 40_000])}")
    if rng.random() < 0.5:
        parts.append(f"cpu:cores={rng.choice([8, 16, 32])}")
    if rng.random() < 0.5:
        parts.append(f"ram_mb={rng.choice([16_384, 65_536, 131_072])}")
    if rng.random() < 0.4:
        parts.append(f"storage_gb={rng.choice([1_000, 4_000])}")
    return ";".join(parts)


def phase_tasks(rng, n_loc: int, n_task: int, n_colo: int, replicas: int = AA_REPLICAS) -> list:
    """Spread tasks (``anti_affinity: location`` and ``task``, ``replicas``
    replicas, pool_dsl requirements over SPREAD_CLASSES) and colocated
    one-GPU tasks (COLO_REPLICAS replicas over COLO_CLASSES)."""
    from protocol_tpu_torch.models.task import (
        SchedulingConfig,
        Task,
        _validate_tpu_scheduler_plugin,
    )

    def task(name, dsl, replicas, **plug):
        cfg = SchedulingConfig(plugins={"tpu_scheduler": {
            "compute_requirements": [dsl], "replicas": [str(replicas)],
            **{k: [v] for k, v in plug.items()}}})
        _validate_tpu_scheduler_plugin(cfg)
        return Task(name=name, created_at=int(rng.integers(1_000_000)), scheduling_config=cfg)

    def spread_dsl():
        # a storage minimum (60%) splits each model-and-count class again,
        # so that the spread tasks' cheapest candidates differ
        dsl = pool_dsl(rng, SPREAD_CLASSES)
        return dsl + (f";storage_gb={rng.choice([1_000, 4_000])}" if rng.random() < 0.6 else "")

    out = [task(f"al{j}", spread_dsl(), replicas, anti_affinity="location")
           for j in range(n_loc)]
    out += [task(f"at{j}", spread_dsl(), replicas, anti_affinity="task") for j in range(n_task)]
    out += [task(f"co{j}", colo_dsl(rng), COLO_REPLICAS, colocate="true") for j in range(n_colo)]
    return out


def churn_pool(rng, store, frac: float, replace_tasks: int) -> None:
    """Reprice ``frac`` of the nodes and replace ``replace_tasks`` bounded
    tasks by new ones of as many replicas."""
    from protocol_tpu_torch.sched.torch_backend import task_replicas

    nodes = store.node_store.nodes
    for i in rng.choice(len(nodes), max(1, int(len(nodes) * frac)), replace=False):
        nodes[i].price = float(rng.uniform(0.5, 4.0))
    tasks = store.task_store.tasks
    bounded = [t for t in tasks.values() if task_replicas(t)]
    for j, old in enumerate(bounded[:replace_tasks]):
        del tasks[old.id]
        new = pool_task(rng, f"r{j}", task_replicas(old))
        tasks[new.id] = new


def churn_nodes(rng, store, frac: float, first: int) -> dict:
    """Node churn under the candidate cache's stale tolerance: frac/2 of
    the nodes leave, as many join with new specs (addressed from
    ``first``), and frac of the rest drift in price by up to 3%. Returns
    the counts."""
    nodes = store.node_store.nodes
    n = max(1, int(len(nodes) * frac / 2))
    gone = set(rng.choice(len(nodes), n, replace=False).tolist())
    nodes[:] = [x for i, x in enumerate(nodes) if i not in gone]
    joins, _ = make_pool(rng, n, 0, 0, 0, sites=SITES, first=first)
    drift = rng.choice(len(nodes), max(1, int(len(nodes) * frac)), replace=False)
    for i in drift:
        nodes[i].price = float(nodes[i].price * rng.uniform(0.97, 1.03))
    nodes.extend(joins)
    return {"left": n, "joined": n, "repriced": int(drift.size)}


def relaxed_requirement(req):
    """A colocated slot's compat requirement: GPU count and whole-provider
    memory maximum dropped (the slice is reserved by its demand)."""
    import dataclasses

    return dataclasses.replace(req, gpu=[
        dataclasses.replace(g, count=None, total_memory_max=None) for g in req.gpu])


def check_matching(torch, compat_mask, store, matcher) -> dict:
    """Every assigned pair meets its task's requirements (relaxed for a
    colocated task), no bounded task holds more than its replicas, and
    every node left to phase 2 that has a compatible unbounded task got
    one (compat by the plain torch mask)."""
    from protocol_tpu_torch.ops.encoding import FeatureEncoder
    from protocol_tpu_torch.sched.torch_backend import (
        task_colocate,
        task_replicas,
        task_requirements,
    )

    nodes = store.node_store.get_nodes()
    tasks = store.task_store.tasks
    unbounded = [t for t in tasks.values() if task_replicas(t) is None]
    reqs = {tid: relaxed_requirement(task_requirements(t)) if task_colocate(t)
            else task_requirements(t) for tid, t in tasks.items()}
    held: dict = {}
    for n in nodes:
        tid = matcher._assignment.get(n.address)
        if tid is None:
            continue
        if not n.compute_specs.meets(reqs[tid]):
            raise AssertionError(f"{n.address} holds {tid} but does not meet its requirements")
        held[tid] = held.get(tid, 0) + 1
    for n in nodes:
        for tid in matcher._assignment_multi.get(n.address, ()):
            if not n.compute_specs.meets(reqs[tid]):
                raise AssertionError(f"{n.address} stacks {tid} but does not meet it")
    over = [t for t, c in held.items() if task_replicas(tasks[t]) and c > task_replicas(tasks[t])]
    if over:
        raise AssertionError(f"bounded tasks over their replicas: {over[:5]}")
    bounded_ids = {tid for tid, t in tasks.items() if task_replicas(t)}
    in_phase2 = [i for i, n in enumerate(nodes)
                 if matcher._assignment.get(n.address) not in bounded_ids]
    n_bounded = len(nodes) - len(in_phase2)
    n_compat = n_swarm = 0
    if unbounded and in_phase2:
        enc = FeatureEncoder()
        ep = enc.encode_providers([nodes[i].compute_specs for i in in_phase2], device=DEVICE)
        er = enc.encode_requirements([reqs[t.id] for t in unbounded], device=DEVICE)
        has = compat_mask(ep, er).any(dim=1).cpu().tolist()
        unb_ids = {t.id for t in unbounded}
        for i, h in zip(in_phase2, has):
            got = matcher._assignment.get(nodes[i].address) in unb_ids
            n_compat += h
            n_swarm += got
            if h and not got:
                raise AssertionError(f"{nodes[i].address} has a compatible unbounded task "
                                     "but phase 2 gave it none")
    return {"bounded_seats": n_bounded, "phase2_nodes": len(in_phase2),
            "phase2_compatible": n_compat, "phase2_assigned": n_swarm}


def record_calls(kernels, names) -> tuple[dict, dict]:
    """Wrap the kernel wrappers ``names`` so that every call's arguments
    and result are kept (the call and its count are unchanged). Returns
    ({name: [(args, kwargs, out), ...]}, originals)."""
    calls: dict = {name: [] for name in names}
    originals = {name: getattr(kernels, name) for name in names}
    for name in names:
        def wrapped(*args, _orig=originals[name], _name=name, **kw):
            out = _orig(*args, **kw)
            calls[_name].append((args, kw, out))
            return out

        setattr(kernels, name, wrapped)
    return calls, originals


def spy_phases(matcher) -> dict:
    """Keep the arguments and placements of the matcher's last phase 0 and
    phase 0.5 (``_solve_anti_affinity`` / ``_solve_colocation``)."""
    seen: dict = {}
    for name in ("_solve_anti_affinity", "_solve_colocation"):
        def wrapped(*args, _orig=getattr(matcher, name), _name=name):
            out = _orig(*args)
            seen[_name] = (args, out[0])
            return out

        setattr(matcher, name, wrapped)
    return seen


def slot_demand(req) -> list:
    """A colocated replica's reservation [gpu, vram, cpu, ram, storage]:
    the element-wise maximum over its GPU options."""
    gcount = vram = 0.0
    for g in req.gpu:
        c = float(g.count or 0)
        v = float(g.total_memory_min) if g.total_memory_min is not None else (
            c * float(g.memory_mb or g.memory_mb_min or 0))
        gcount, vram = max(gcount, c), max(vram, v)
    return [gcount, vram, float(req.cpu.cores or 0) if req.cpu else 0.0,
            float(req.ram_mb or 0), float(req.storage_gb or 0)]


def node_capacity(specs) -> list:
    gpu = specs.gpu
    count = float(gpu.count or 0) if gpu else 0.0
    return [count, count * float(gpu.memory_mb or 0) if gpu else 0.0,
            float(specs.cpu.cores or 0) if specs.cpu else 0.0,
            float(specs.ram_mb or 0), float(specs.storage_gb or 0)]


def check_phases(store, matcher, seen, addr_of_row=None) -> dict:
    """Phases 0 and 0.5 of the last refresh: every spread task's replicas
    on distinct providers (``task``) or location classes (``location``),
    each meeting its requirement; every colocated provider's summed demand
    within its capacity in all five resources, each slot meeting its
    relaxed requirement; every claimed provider still holding its phase's
    task (no phase-1 or phase-2 task) and the stats counting them. A row
    is the node's index in the store, or ``addr_of_row[row]`` is its
    address (the candidate cache's rows)."""
    from protocol_tpu_torch.sched.torch_backend import (
        task_anti_affinity,
        task_replicas,
        task_requirements,
    )

    nodes = store.node_store.get_nodes()
    if addr_of_row is not None:
        by_addr = {n.address: n for n in nodes}
        nodes = [by_addr.get(a) for a in addr_of_row]
    st = matcher.last_solve_stats
    claims = placed = {}
    tasks = None
    if "_solve_anti_affinity" in seen:
        args, claims = seen["_solve_anti_affinity"]
        tasks = args[3]
    if "_solve_colocation" in seen:
        args, placed = seen["_solve_colocation"]
        tasks = args[2]
    by_task: dict = {}
    for row, i in claims.items():
        by_task.setdefault(i, []).append(row)
        node = nodes[row]
        if not node.compute_specs.meets(task_requirements(tasks[i])):
            raise AssertionError(f"{node.address} holds spread task {tasks[i].id} unmet")
        if matcher._assignment.get(node.address) != tasks[i].id:
            raise AssertionError(f"{node.address}, claimed by phase 0, holds another task")
    n_loc_tasks = 0
    for i, rows in by_task.items():
        if len(rows) > task_replicas(tasks[i]):
            raise AssertionError(f"spread task {tasks[i].id} over its replicas")
        if task_anti_affinity(tasks[i]) == "location":
            n_loc_tasks += 1
            keys = [(round(nodes[r].location.latitude, 3), round(nodes[r].location.longitude, 3))
                    if nodes[r].location is not None else ("solo", r) for r in rows]
            if len(set(keys)) != len(keys):
                raise AssertionError(f"spread task {tasks[i].id}: two replicas at one location")
    if set(claims) & set(placed):
        raise AssertionError("a provider claimed by both phase 0 and phase 0.5")
    n_slots = max_stack = 0
    for row, idxs in placed.items():
        node = nodes[row]
        cap = node_capacity(node.compute_specs)
        used = [0.0] * 5
        for i in idxs:
            req = task_requirements(tasks[i])
            if not node.compute_specs.meets(relaxed_requirement(req)):
                raise AssertionError(f"{node.address} stacks {tasks[i].id} unmet")
            used = [u + d for u, d in zip(used, slot_demand(req))]
        if any(u > c for u, c in zip(used, cap)):
            raise AssertionError(f"{node.address}: stacked demand {used} over capacity {cap}")
        want = list(dict.fromkeys(tasks[i].id for i in idxs))
        if (matcher._assignment.get(node.address) != tasks[idxs[0]].id
                or matcher._assignment_multi.get(node.address) != want):
            raise AssertionError(f"{node.address}, claimed by phase 0.5, holds another task")
        n_slots += len(idxs)
        max_stack = max(max_stack, len(idxs))
    if st["anti_affinity_assigned"] != len(claims) or st["colocated_slots"] != n_slots:
        raise AssertionError("the phase stats do not count the phases' placements")
    return {"spread_rows": len(claims), "spread_tasks": len(by_task),
            "location_spread_tasks": n_loc_tasks, "colocated_rows": len(placed),
            "colocated_slots": n_slots, "max_slots_per_row": max_stack,
            "colocated_unplaced": st["colocated_unplaced"]}


def check_phase_kernels(torch, kernels, bp, cost_matrix, calls, label: str) -> list:
    """K10 and K11 against their plain versions, bit for bit, on every
    recorded call, K11 in every instantiation that fits the call's shapes
    (the one it took, and the device one, which fits every shape); K11's
    picks keep the groups apart and the capacity. Returns each K11 call's
    shapes and instantiation."""
    shapes = []
    with uncounted(kernels), kernels.untimed():
        # (a recorded K10 block itself may since carry phase 0's taken-row
        # mask: the call is made again)
        for args, kw, _ in calls["cost_block"]:
            got = kernels.cost_block(*args, **kw)
            ref = cost_matrix(*args, **kw)[0].T.contiguous()
            torch.cuda.synchronize()
            if not bits_equal(torch, got, ref):
                raise AssertionError(f"{label}: K10 differs from its plain version")
        for n_call, (args, kw, out) in enumerate(calls["binpack_ffd"]):
            cost_tp, demand, capacity, order, anti, loc, L, G = args
            (T, P), R = cost_tp.shape, demand.shape[1]
            took = kw.get("route") or kernels.binpack_route(P, R, L, G)
            ref = bp._binpack_plain(cost_tp.T, demand, capacity,
                                    bp.ffd_demand_order(demand) if order is None else order,
                                    anti, loc, L, G)
            held = [r for r in kernels.K11_ROUTES if kernels.binpack_slots(P, R, L, G,
                                                                           r == "shared")]
            for route in held:
                got = kernels.binpack_ffd(*args, route=route)
                torch.cuda.synchronize()
                if not all(bits_equal(torch, a, b) for a, b in zip(got, ref)):
                    raise AssertionError(f"{label}: K11 ({route}) differs from its plain version "
                                         f"on call {n_call}")
            if not all(bits_equal(torch, a, b) for a, b in zip(out, ref)):
                raise AssertionError(f"{label}: K11's call {n_call} ({took}) differs from its "
                                     "plain version")
            pft = ref[0]
            seated = torch.nonzero(pft >= 0).flatten()
            p = pft[seated].long()
            use = torch.zeros(capacity.shape, dtype=torch.float64, device=capacity.device)
            use.index_add_(0, p, demand[seated].double())
            if bool((use > capacity.double()).any()):
                raise AssertionError(f"{label}: K11 placed over a provider's capacity")
            g = anti[seated].long()
            grouped = g >= 0
            pairs = loc[p][grouped].long() * G + g[grouped]
            if torch.unique(pairs).numel() != pairs.numel():
                raise AssertionError(f"{label}: K11 put two members of a group in one domain")
            shapes.append({"T": T, "P": P, "R": R, "LG": L * G, "route": took, "held": held})
            print(f"{label}: K11 call {n_call}: {T} slots x {P} rows, R={R}, L x G = {L * G}, "
                  f"route {took}, held bit for bit as {held}", flush=True)
    ranked = sum(args[3] is None for args, _, _ in calls["binpack_ffd"])
    if ranked == 0:
        raise AssertionError(f"{label}: no K11 call ranked the FFD order in its launch")
    print(f"{label}: K10 x {len(calls['cost_block'])} and K11 x {len(calls['binpack_ffd'])} "
          f"calls ({ranked} ranking the FFD order in the launch) bit-identical to their plain "
          "versions; groups and capacity hold", flush=True)
    return shapes


def refresh_matcher(torch, compat_mask, matcher, store, label: str, kernel: str) -> dict:
    """One refresh, timed by the host clock to the end of the device work;
    its stats printed, its kernel route and matching checked."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    matcher.refresh()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    st = dict(matcher.last_solve_stats)
    print(f"matcher {label}: refresh wall_ms {wall:.1f} solve_ms {st['solve_ms']:.1f} "
          f"encode_ms {st['encode_ms']:.1f} phase0_ms {st['phase0_ms']:.1f} "
          f"phase05_ms {st['phase05_ms']:.1f} phase1_ms {st['phase1_ms']:.1f} "
          f"phase2_ms {st['phase2_ms']:.1f} anti_affinity_assigned "
          f"{st['anti_affinity_assigned']} colocated_slots {st['colocated_slots']} "
          f"colocated_unplaced {st['colocated_unplaced']} "
          f"auction_rounds {st.get('auction_rounds')} "
          f"arena_cold {st.get('arena_cold')} arena_gen_ms {st.get('arena_gen_ms')} "
          f"arena_solve_ms {st.get('arena_solve_ms')} assigned {st['assigned']}/{st['nodes']} "
          f"kernel {st['kernel']}", flush=True)
    if st["kernel"] == "sparse_topk":
        print(f"matcher {label}: " + json.dumps({x: st.get(x) for x in (
            "prepare_ms", "warm", "warm_seeded_slots", "stall_exit", "cache_rebuilt",
            "cache_delta_rows", "cache_delta_tasks", "cache_uncovered_rows",
            "cache_stale_frac")}), flush=True)
    if st["kernel"] != kernel:
        raise AssertionError(f"matcher {label}: kernel {st['kernel']}, not {kernel}")
    checked = check_matching(torch, compat_mask, store, matcher)
    print(f"matcher {label}: {json.dumps(checked)}", flush=True)
    st["checked"] = checked
    return st


def run_phases(torch, kernels, refresh) -> tuple[list, dict, dict]:
    """The matcher's phases 0 and 0.5 on the card: the card against the
    CPU on a small store with every task kind; the dense route with the
    mix at 1/8, the dense route with PHASE_WIDE's spread tasks (K11's
    device instantiation), and the torch route at full width (cold, then
    warm), each run with the counts set to 0 just before it and timed in
    place. Returns (the kernels-line rows of K10 and K11's two
    instantiations, {run name: launches}, {run name: in-place sums});
    raises on any failed check."""
    import numpy as np

    from protocol_tpu_torch.ops import binpack as bp
    from protocol_tpu_torch.ops import sparse as sp
    from protocol_tpu_torch.ops.cost import cost_matrix
    from protocol_tpu_torch.sched import torch_backend as tb

    dev = DEVICE

    # the card against the CPU on a small store with every task kind
    nodes, tasks = make_pool(np.random.default_rng(SEED + 40), *SMALL_POOL, sites=SITES)
    tasks += phase_tasks(np.random.default_rng(SEED + 41), *PHASE_SMALL_MIX)
    small = mem_store(nodes, tasks)
    for engine in ("native", "torch"):
        on_card = tb.TorchBatchMatcher(small, native_engine=engine, device=dev)
        on_cpu = tb.TorchBatchMatcher(small, native_engine=engine, device="cpu")
        on_card.refresh()
        on_cpu.refresh()
        keys = ("anti_affinity_assigned", "colocated_slots", "colocated_unplaced")
        same = (on_card._assignment == on_cpu._assignment
                and on_card._assignment_multi == on_cpu._assignment_multi
                and all(on_card.last_solve_stats[x] == on_cpu.last_solve_stats[x] for x in keys))
        print(f"matcher with phase tasks, {SMALL_POOL[0]} nodes, {engine} route, card vs cpu: "
              f"identical {same}, assigned {len(on_card._assignment)}, "
              f"{json.dumps({x: on_card.last_solve_stats[x] for x in keys})}", flush=True)
        if not same:
            raise AssertionError(f"the card's matcher differs from the CPU's with phase "
                                 f"tasks ({engine} route)")
    del on_card, on_cpu, small

    # the dense route with the mix at 1/8
    nodes, tasks = make_pool(np.random.default_rng(SEED + 20), *DENSE_POOL, sites=SITES)
    tasks += phase_tasks(np.random.default_rng(SEED + 22), *PHASE_DENSE_MIX)
    store = mem_store(nodes, tasks)
    dense_p = tb.TorchBatchMatcher(store, device=dev)
    seen = spy_phases(dense_p)
    torch.cuda.synchronize()
    kernels.reset_launches()
    kernels.time_in_place(True)
    pd_calls, pd_originals = record_calls(kernels, PHASE_KERNELS)
    refresh(dense_p, store, "phases-dense", "dense_auction")
    for name, fn in pd_originals.items():
        setattr(kernels, name, fn)
    launches_pdense = dict(kernels.LAUNCHES)
    print(f"kernels (matcher phases, dense route): {json.dumps(launches_pdense)}", flush=True)
    in_place = {"phases-dense": in_place_run(kernels, launches_pdense, "matcher phases, dense")}
    missing = [n for n in PHASE_KERNELS + DENSE_KERNELS if launches_pdense[n] == 0]
    if missing:
        raise AssertionError(f"the dense route with phase tasks launched no {missing}")
    print(f"matcher phases-dense: {json.dumps(check_phases(store, dense_p, seen))}", flush=True)
    check_phase_kernels(torch, kernels, bp, cost_matrix, pd_calls, "phases-dense")
    del dense_p, store, pd_calls, seen

    # the dense route with many provider-spread tasks: K11's device
    # instantiation on phase 0's call
    nodes, tasks = make_pool(np.random.default_rng(SEED + 20), *DENSE_POOL, sites=SITES)
    tasks += phase_tasks(np.random.default_rng(SEED + 24), 0, PHASE_WIDE[0], 0,
                         replicas=PHASE_WIDE[1])
    store = mem_store(nodes, tasks)
    wide_p = tb.TorchBatchMatcher(store, device=dev)
    seen = spy_phases(wide_p)
    torch.cuda.synchronize()
    kernels.reset_launches()
    kernels.time_in_place(True)
    pw_calls, pw_originals = record_calls(kernels, PHASE_KERNELS)
    wide_stats = refresh(wide_p, store, "phases-wide", "dense_auction")
    for name, fn in pw_originals.items():
        setattr(kernels, name, fn)
    launches_pwide = dict(kernels.LAUNCHES)
    print(f"kernels (matcher phases, wide): {json.dumps(launches_pwide)}", flush=True)
    in_place["phases-wide"] = in_place_run(kernels, launches_pwide, "matcher phases, wide")
    if launches_pwide[K11_DEVICE] == 0 or "device" not in wide_stats.get("binpack_routes", ()):
        raise AssertionError(f"the wide phase run took no K11 device launch "
                             f"({wide_stats.get('binpack_routes')})")
    print(f"matcher phases-wide: {json.dumps(check_phases(store, wide_p, seen))}", flush=True)
    wide_shapes = check_phase_kernels(torch, kernels, bp, cost_matrix, pw_calls, "phases-wide")
    wide_call = [i for i, sh in enumerate(wide_shapes) if sh["route"] == "device"][0]
    a11_dev = pw_calls["binpack_ffd"][wide_call][0]
    del wide_p, store, seen

    # the torch route at full width: cold, then warm after 1% node churn
    nodes, tasks = make_pool(np.random.default_rng(SEED + 30), *ARENA_POOL, sites=SITES)
    tasks += phase_tasks(np.random.default_rng(SEED + 32), *PHASE_MIX)
    rng = np.random.default_rng(SEED + 31)
    store = mem_store(nodes, tasks)
    arena_p = tb.TorchBatchMatcher(store, native_engine="torch", device=dev)
    seen = spy_phases(arena_p)
    torch.cuda.synchronize()
    kernels.reset_launches()
    kernels.time_in_place(True)
    pt_calls, pt_originals = record_calls(
        kernels, PHASE_KERNELS + ("candidates_bidir", "candidates_forward_rows"))
    phase_torch_stats = [refresh(arena_p, store, "phases-torch-cold", "torch_arena")]
    for name, fn in pt_originals.items():
        setattr(kernels, name, fn)
    with uncounted(kernels), kernels.untimed():
        cold_phases = check_phases(store, arena_p, seen)
    print(f"matcher phases-torch-cold: {json.dumps(cold_phases)}", flush=True)
    # the colocated tasks ask for models the spread tasks do not: phase
    # 0.5 must stack most of its slots, or its capacity path went untried
    if cold_phases["colocated_slots"] < PHASE_MIX[2] * COLO_REPLICAS // 2:
        raise AssertionError(f"phase 0.5 placed only {cold_phases['colocated_slots']} of "
                             f"{PHASE_MIX[2] * COLO_REPLICAS} colocated slots")
    churn_pool(rng, store, CHURN, replace_tasks=0)
    phase_torch_stats.append(refresh(arena_p, store, "phases-torch-warm", "torch_arena"))
    launches_ptorch = dict(kernels.LAUNCHES)
    print(f"kernels (matcher phases, torch route): {json.dumps(launches_ptorch)}", flush=True)
    in_place["phases-torch"] = in_place_run(kernels, launches_ptorch, "matcher phases, torch")
    missing = [n for n in PHASE_KERNELS + COLD_KERNELS + ("unbounded_best",)
               if launches_ptorch[n] == 0]
    if missing:
        raise AssertionError(f"the torch route with phase tasks launched no {missing}")
    if not phase_torch_stats[0]["arena_cold"] or phase_torch_stats[1]["arena_cold"]:
        raise AssertionError("the torch route's phase refreshes were not cold then warm")
    print(f"matcher phases-torch-warm: {json.dumps(check_phases(store, arena_p, seen))}",
          flush=True)
    check_phase_kernels(torch, kernels, bp, cost_matrix, pt_calls, "phases-torch-cold")

    # K1 on the phases' calls: the colocation phase's fused launch (rt
    # tasks per tile) and phase 0's forward launch (2,048 rows) against
    # their plain versions
    colo = [c for c in pt_calls["candidates_bidir"] if c[1]["rt"] > 1]
    if not colo:
        raise AssertionError("phase 0.5 made no fused K1 call at several tasks per tile")
    (rv_ep, rv_er, rv_w), rv_kw, rv_out = colo[0]
    rv_tile, rv_r, rv_rt = rv_kw["tile"], rv_kw["r"], rv_kw["rt"]
    rv_ref = sp._bidir_plain(rv_ep, rv_er, rv_w, rv_kw["k"], rv_tile, rv_r, rv_rt,
                             rv_kw.get("offset", 0))
    (fr_ep, fr_er, fr_w, fr_k, fr_ids), _, fr_out = pt_calls["candidates_forward_rows"][0]
    fr_ref = sp._forward_plain(fr_ep, fr_er, fr_w, fr_k, min(1024, fr_er.num))
    torch.cuda.synchronize()
    k1_phase = {
        "fused_rt": rv_rt, "fused_tiles": rv_er.num // rv_tile,
        "fused_bits": all(bits_equal(torch, a, b) for a, b in zip(rv_out, rv_ref)),
        "forward_rows_bits": all(bits_equal(torch, a, b) for a, b in zip(fr_out, fr_ref)),
    }
    print(f"K1 on the phases' calls ({fr_er.num} and {rv_er.num} slots x {rv_ep.num} "
          f"providers): {json.dumps(k1_phase)}", flush=True)
    if rv_rt < 2 or not all(v for x, v in k1_phase.items() if x.endswith("bits")):
        raise AssertionError(f"K1 on the phases' calls: {k1_phase}")

    # K10 and K11 timed on each call of the cold refresh; the kernels line
    # takes the colocation call (K11 with the five resources, the shared
    # instantiation) and the wide run's phase 0 call (the device one)
    k10_times, k11_times = [], []
    for (a10, _, c10), (a11, kw11, _) in zip(pt_calls["cost_block"], pt_calls["binpack_ffd"]):
        t10 = cuda_ms(torch, lambda: kernels.cost_block(*a10), 3)
        t11 = cuda_ms(torch, lambda: kernels.binpack_ffd(*a11, **kw11), 2)
        k10_times.append(t10)
        k11_times.append(t11)
        print(f"K10 / K11 on {c10.shape[0]} slots x {c10.shape[1]} rows "
              f"(R={a11[1].shape[1]}, {kw11.get('route')}): {t10:.4f} / {t11:.3f} ms, "
              f"K11 {t11 * 1e3 / c10.shape[0]:.3f} us a step", flush=True)
    colo = [i for i, (a, _, _) in enumerate(pt_calls["binpack_ffd"]) if a[1].shape[1] == 5]
    if len(colo) != 1:
        raise AssertionError(f"the cold refresh made {len(colo)} five-resource K11 calls, not 1")
    call = colo[0]
    (ep10, er10, w10), _, c10 = pt_calls["cost_block"][call]
    a11, kw11, _ = pt_calls["binpack_ffd"][call]
    if kw11.get("route") != "shared":
        raise AssertionError(f"the colocation call took K11's {kw11.get('route')} instantiation")
    k10_ms, k11_ms = k10_times[call], k11_times[call]
    k10_plain_ms = cuda_ms(torch, lambda: cost_matrix(ep10, er10, w10)[0], 3)
    k11_plain_ms = cuda_ms(torch, lambda: bp._binpack_plain(
        a11[0].T, a11[1], a11[2], bp.ffd_demand_order(a11[1]), *a11[4:]), 1)
    T10, P10 = c10.shape
    finite = int((c10 < 5e8).sum())
    k10_bytes = P10 * row_bytes(ep10) + T10 * row_bytes(er10) + T10 * P10 * 4
    k10_ops = T10 * P10 * OPS_PER_CELL + finite * OPS_PER_FEASIBLE_CELL
    R11 = a11[1].shape[1]
    k11_bytes = T10 * P10 * 4 + T10 * (R11 * 4 + 4 + 4) + P10 * (2 * R11 * 4 + 4)
    k11_ops = T10 * P10 + finite * (R11 + 2)  # a compare per cell, the fit on finite ones
    print(f"K10 / K11 in the kernels line: call {call} of the cold refresh (colocation), "
          f"{T10} slots x {P10} rows, {finite} finite cells", flush=True)
    # the device instantiation on the wide run's phase 0 call
    Td, Pd = a11_dev[0].shape
    Rd = a11_dev[1].shape[1]
    kd_ms = cuda_ms(torch, lambda: kernels.binpack_ffd(*a11_dev, route="device"), 2)
    kd_plain_ms = cuda_ms(torch, lambda: bp._binpack_plain(
        a11_dev[0].T, a11_dev[1], a11_dev[2], bp.ffd_demand_order(a11_dev[1]), *a11_dev[4:]), 1)
    finite_d = int((a11_dev[0] < 5e8).sum())
    kd_bytes = Td * Pd * 4 + Td * (Rd * 4 + 4 + 4) + Pd * (2 * Rd * 4 + 4)
    kd_ops = Td * Pd + finite_d * (Rd + 2)
    print(f"K11 device instantiation in the kernels line: the wide run's call {wide_call}, "
          f"{Td} slots x {Pd} rows, L x G = {a11_dev[6] * a11_dev[7]}: {kd_ms:.3f} ms, "
          f"{kd_ms * 1e3 / Td:.3f} us a step", flush=True)
    del arena_p, store, nodes, tasks, pt_calls, pw_calls, seen
    k11_row = row("binpack_ffd", SRC_K11, "protocol_tpu/ops/binpack.py:61", 0.0, k11_ms,
                  k11_plain_ms, k11_bytes, k11_ops)
    k11_row.update(us_per_step=k11_ms * 1e3 / T10, steps=T10, rows=P10, resources=R11,
                   instantiation="shared")
    kd_row = row(K11_DEVICE, SRC_K11, "protocol_tpu/ops/binpack.py:61", 0.0, kd_ms,
                 kd_plain_ms, kd_bytes, kd_ops)
    kd_row.update(us_per_step=kd_ms * 1e3 / Td, steps=Td, rows=Pd, resources=Rd,
                  instantiation="device")
    rows = [
        row("cost_block", SRC_K1, "protocol_tpu/sched/tpu_backend.py:184", 0.0, k10_ms,
            k10_plain_ms, k10_bytes, k10_ops),
        k11_row,
        kd_row,
    ]
    return rows, {"matcher_phases_dense": launches_pdense, "matcher_phases_wide": launches_pwide,
                  "matcher_phases_torch": launches_ptorch}, in_place


def spy_prepare(matcher) -> list:
    """Keep every PreparedSolve the matcher's candidate cache returns."""
    kept: list = []
    orig = matcher._cache.prepare

    def wrapped(*args):
        kept.append(orig(*args))
        return kept[-1]

    matcher._cache.prepare = wrapped
    return kept


def run_default_route(torch, kernels, refresh) -> dict:
    """The matcher's default route above dense_cell_budget on the card:
    the card against the CPU on 2,048 nodes x 2,048 slots (cold, node
    churn, a task replaced); then at full width on the torch route's pool
    (65,536 nodes x 65,536 slots), the stateless route (warm_start=False)
    cold, and the candidate-cache route with the reference's defaults:
    cold, warm after 1% node churn, two tasks replaced, the phase-task mix
    added; each run with the counts set to 0 just before it. The cache's
    K1 calls at a non-zero cursor are held bit for bit against their plain
    versions. Returns {run name: launches}; raises on any failed check."""
    import numpy as np

    from protocol_tpu_torch.ops import sparse as sp
    from protocol_tpu_torch.ops.cost import CostWeights
    from protocol_tpu_torch.sched import torch_backend as tb

    dev = DEVICE

    # the card against the CPU, proximity 0, under a lowered budget
    nodes, tasks = make_pool(np.random.default_rng(SEED + 50), *ROUTE_SMALL_POOL, sites=SITES)
    small = mem_store(nodes, tasks)
    w0 = CostWeights(priority=1.0, proximity=0.0)
    pair = [tb.TorchBatchMatcher(small, weights=w0, dense_cell_budget=ROUTE_SMALL_BUDGET,
                                 device=d) for d in (dev, "cpu")]
    kept = [spy_prepare(m) for m in pair]
    rng = np.random.default_rng(SEED + 51)
    for step in ("cold", "node-churn", "task-replaced"):
        if step == "node-churn":
            churn_nodes(rng, small, CHURN, first=len(nodes))
        elif step == "task-replaced":
            churn_pool(rng, small, 0.0, replace_tasks=1)
        for m in pair:
            m.refresh()
        a, b = kept[0][-1], kept[1][-1]
        same = (pair[0]._assignment == pair[1]._assignment
                and bool(np.array_equal(a.cand_p, b.cand_p))
                and bool(np.array_equal(a.cand_c.view(np.uint32), b.cand_c.view(np.uint32))))
        st = pair[0].last_solve_stats
        print(f"default route, {ROUTE_SMALL_POOL[0]} nodes x {a.num_slots} slots, {step}, card "
              f"vs cpu: identical {same}, kernel {st['kernel']}, warm {st['warm']}, cursor "
              f"{pair[0]._cache._jitter_cursor}, assigned {st['assigned']}", flush=True)
        if not same or st["kernel"] != "sparse_topk":
            raise AssertionError(f"the card's default route differs from the CPU's ({step})")
    if not pair[0].last_solve_stats["warm"]:
        raise AssertionError("the small default route's last refresh was not warm")
    del pair, kept, small

    # full width: the stateless route, then the cache's route, same pool
    nodes, tasks = make_pool(np.random.default_rng(SEED + 30), *ARENA_POOL, sites=SITES)
    store = mem_store(nodes, tasks)
    stateless = tb.TorchBatchMatcher(store, warm_start=False, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    stateless_seats = refresh(stateless, store, "default-stateless-cold",
                              "sparse_topk")["checked"]["bounded_seats"]
    launches_stateless = dict(kernels.LAUNCHES)
    print(f"kernels (matcher, stateless sparse route): {json.dumps(launches_stateless)}",
          flush=True)
    missing = [n for n in STATELESS_KERNELS if launches_stateless[n] == 0]
    if missing:
        raise AssertionError(f"the stateless sparse route launched no {missing}")
    del stateless

    m = tb.TorchBatchMatcher(store, device=dev)  # the reference's defaults
    seen = spy_phases(m)
    rng = np.random.default_rng(SEED + 52)
    torch.cuda.synchronize()
    kernels.reset_launches()
    k1_calls, k1_originals = record_calls(kernels, ("candidates_forward_rows",
                                                    "candidates_reverse"))
    route_stats = []

    def step(label):
        before = dict(kernels.LAUNCHES)
        st = refresh(m, store, label, "sparse_topk")
        k1 = {n: kernels.LAUNCHES[n] - before[n] for n in ("candidates_forward_rows",
                                                          "candidates_reverse")}
        print(f"matcher {label}: K1 launches {json.dumps(k1)}, cursor "
              f"{m._cache._jitter_cursor}", flush=True)
        route_stats.append(st)
        return st

    st = step("default-cold")
    if not st["cache_rebuilt"] or st["warm"]:
        raise AssertionError("the first refresh of the default route was not a cold rebuild")
    cold_seats = st["checked"]["bounded_seats"]
    print(f"default route cold: {cold_seats} bounded seats, the stateless route "
          f"{stateless_seats}", flush=True)
    if cold_seats < ROUTE_SEATS_FLOOR * stateless_seats:
        raise AssertionError(f"the cold cached refresh seats {cold_seats}, under "
                             f"{ROUTE_SEATS_FLOOR} x the stateless route's {stateless_seats}")
    churned = churn_nodes(rng, store, CHURN, first=len(nodes))
    st = step("default-warm-node-churn")
    print(f"default-warm-node-churn: {json.dumps(churned)}", flush=True)
    if not st["warm"] or st["cache_rebuilt"] or st["cache_delta_rows"] != churned["joined"]:
        raise AssertionError(f"the refresh after node churn was not warm over the joined rows: "
                             f"warm {st['warm']}, delta rows {st['cache_delta_rows']}")
    cursor = m._cache._jitter_cursor
    churn_pool(rng, store, 0.0, replace_tasks=2)
    st = step("default-tasks-replaced")
    offsets = [c[1].get("offset", 0) for c in k1_calls["candidates_forward_rows"][-2:]]
    if st["cache_delta_tasks"] != 2 or cursor not in offsets:
        raise AssertionError(f"the replaced tasks took no fresh forward pass at cursor {cursor} "
                             f"(delta tasks {st['cache_delta_tasks']}, offsets {offsets})")
    store.task_store.tasks.update(
        {t.id: t for t in phase_tasks(np.random.default_rng(SEED + 53), *PHASE_MIX)})
    step("default-phase-mix")
    for name, fn in k1_originals.items():
        setattr(kernels, name, fn)
    launches_route = dict(kernels.LAUNCHES)
    print(f"kernels (matcher, default route): {json.dumps(launches_route)}", flush=True)
    missing = [n for n in ROUTE_KERNELS + PHASE_KERNELS if launches_route[n] == 0]
    if missing:
        raise AssertionError(f"the default route launched no {missing}")
    with uncounted(kernels):
        phases = check_phases(store, m, seen, addr_of_row=m._cache.addr_of_row)
    print(f"matcher default-phase-mix: {json.dumps(phases)}", flush=True)
    if not phases["spread_rows"] or not phases["colocated_slots"]:
        raise AssertionError("phases 0 and 0.5 placed nothing on the default route")

    # K1 at the cache's cursor against its plain versions, bit for bit
    # (the matcher's tasks carry no location: no haversine term)
    held = 0
    for (c_ep, c_er, c_w, c_k, c_ids), kw, out in k1_calls["candidates_forward_rows"]:
        off = kw.get("offset", 0)
        if off == 0:
            continue
        if not torch.equal(c_ids.long(), torch.arange(c_er.num, device=c_ids.device)):
            raise AssertionError("a cache forward pass did not launch over every task id")
        ref = sp._forward_plain(c_ep, c_er, c_w, c_k, min(1024, c_er.num), task_offset=off)
        if not all(bits_equal(torch, a, b) for a, b in zip(out, ref)):
            raise AssertionError(f"K1 forward at cursor {off} differs from its plain version")
        held += 1
    for (c_ep, c_er, c_w), kw, out in k1_calls["candidates_reverse"]:
        off = kw.get("offset", 0)
        ref = sp._reverse_plain(c_ep, c_er, c_w, kw["tile"], kw["r"], kw["rt"], task_offset=off)
        if not all(bits_equal(torch, a, b) for a, b in zip(out, ref)):
            raise AssertionError(f"K1 reverse at cursor {off} differs from its plain version")
        held += off != 0
    torch.cuda.synchronize()
    print(f"K1 on the cache's calls: {held} launches at a non-zero cursor bit-identical to "
          f"their plain versions ({len(k1_calls['candidates_forward_rows'])} forward, "
          f"{len(k1_calls['candidates_reverse'])} reverse calls)", flush=True)
    if held == 0:
        raise AssertionError("no cache launch at a non-zero cursor was held")
    del m, store, nodes, tasks, k1_calls, seen
    return {"matcher_stateless": launches_stateless, "matcher_default": launches_route}


def pairs_compatible(torch, compat_mask, gp, gr, ep, er, p_idx, t_idx) -> bool:
    """Whether every pair (p_idx[i], t_idx[i]) is compatible: the diagonal
    of the plain torch mask, 1,024 pairs at a time."""
    for i in range(0, p_idx.numel(), 1024):
        m = compat_mask(gp(ep, p_idx[i:i + 1024]), gr(er, t_idx[i:i + 1024]))
        if not bool(torch.diagonal(m).all()):
            return False
    return True


def check_answer(torch, compat_mask, gp, gr, ep, er, res, num_assigned: int, kernel: str) -> int:
    """An RPC's answer: every pair compatible; for a matching kernel the
    matching is injective and ``task_for_provider`` is its inverse; the
    reported count is the pairs'. Returns the pairs."""
    import numpy as np

    dev = ep.gpu_count.device
    p4t = torch.from_numpy(np.asarray(res.p4t, np.int64)).to(dev)
    t4p = torch.from_numpy(np.asarray(res.t4p, np.int64)).to(dev)
    if p4t.shape != (er.num,) or t4p.shape != (ep.num,):
        raise AssertionError(f"{kernel}: answer shapes {tuple(p4t.shape)}, {tuple(t4p.shape)}")
    if kernel == "best":  # each provider's cheapest task: not a matching
        p_idx = torch.nonzero(t4p >= 0).flatten()
        t_idx = t4p[p_idx]
    else:
        t_idx = torch.nonzero(p4t >= 0).flatten()
        p_idx = p4t[t_idx]
        if torch.unique(p_idx).numel() != p_idx.numel():
            raise AssertionError(f"{kernel}: a provider holds two tasks")
        if int((t4p >= 0).sum()) != t_idx.numel() or not bool((t4p[p_idx] == t_idx).all()):
            raise AssertionError(f"{kernel}: task_for_provider is not the matching's inverse")
    if num_assigned != t_idx.numel() or t_idx.numel() == 0:
        raise AssertionError(f"{kernel}: num_assigned {num_assigned}, {t_idx.numel()} pairs")
    if not pairs_compatible(torch, compat_mask, gp, gr, ep, er, p_idx, t_idx):
        raise AssertionError(f"{kernel}: an assigned pair is not compatible")
    return t_idx.numel()


def rounding_near_ties(torch, rcost_tp, order, colmax, tol: float):
    """The plain rounding replayed step by step, counting the decisions
    that a difference below ``tol`` could turn: adjacent entries of the
    visit order whose plan maxima are closer than ``tol``, and steps whose
    two best free candidates are. Returns (p4t, order ties, a bool [T] of
    the steps that tie, in visit order)."""
    T, P = rcost_tp.shape
    dev = rcost_tp.device
    keys = colmax[order.long()]
    order_ties = int(((keys[:-1] - keys[1:]).abs() < tol).sum())
    avail = torch.ones(P, dtype=torch.bool, device=dev)
    p4t = torch.full((T,), -1, dtype=torch.int32, device=dev)
    step_tie = torch.zeros(T, dtype=torch.bool)
    for s, t in enumerate(order.tolist()):
        masked = torch.where(avail, rcost_tp[t], 1e9) + 0.0
        two = torch.topk(masked, min(2, P), largest=False).values.tolist()
        p = int(torch.argmin(masked))
        if two[0] < 5e8:
            avail[p] = False
            p4t[t] = p
            step_tie[s] = len(two) == 2 and two[1] - two[0] < tol
    return p4t, order_ties, step_tie


def first_launches(torch, kernels, calls: dict, shape: str) -> None:
    """A kernel's first launch in a process loads its module inside the C
    entry, between in-place timing's event pair, so a run timed in place
    must not make it. Make each of ``calls`` (name -> a call of its wrapper
    at the run's shape) here twice, untimed and uncounted, and print the
    first and the second launch as timed by events around the wrapper: the
    difference is the load."""
    ms = {}
    with uncounted(kernels), kernels.untimed():
        for name, fn in calls.items():
            ms[name] = []
            for _ in range(2):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                ms[name].append(start.elapsed_time(end))
    print(f"first launches in the process ({shape}, events around the wrapper): " + "; ".join(
        f"{name} {a:.3f} ms, then {b:.3f} ms" for name, (a, b) in ms.items()), flush=True)


def backend_first_launches(torch, kernels, n: int) -> None:
    """K12's and K13's first launches, which the backend run would make, at
    its shape (n x n, a seeded cost on the card)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 57)
    cost = torch.rand((n, n), generator=gen, device=DEVICE)
    order = torch.arange(n, dtype=torch.int32, device=DEVICE)
    first_launches(torch, kernels, {
        "greedy_assign": lambda: kernels.greedy_assign(cost, order),
        "sinkhorn": lambda: kernels.sinkhorn(cost, SINKHORN_EPS, SINKHORN_ITERS),
    }, f"{n} x {n}")


def refold_first_launch(torch, kernels) -> None:
    """K5's first launch, which the warm chain's first refold would make
    (its library holds no other kernel; the chain's in-place sum was then
    ~3 ms over 6 launches of ~0.04), at the chain's shape: N providers x 64
    entries, r 8, seeded costs on the card."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 59)
    pool_c = torch.rand((N, 64), generator=gen, device=DEVICE)
    pool_t = torch.zeros((N, 64), dtype=torch.int32, device=DEVICE)
    first_launches(torch, kernels, {
        "repair_refold": lambda: kernels.repair_refold(pool_t, pool_c, 8),
    }, f"{N} x 64")


def run_backend(torch, kernels) -> tuple[list, dict]:
    """The scheduler backend on the card: the port's server on a free
    localhost port, driven through the port's client over both wires with
    the counts set to 0 just before. Every answer is checked (compatible,
    a matching, v1 == v2, equal to the dispatch in process), every launch
    timed in place after K12's and K13's first launches (backend_first_launches);
    K12 and K13 are held against their plain versions on their first
    calls. Returns (the kernels-line rows of K12 and K13,
    {"backend": launches}, the in-place sums)."""
    import numpy as np

    from protocol_tpu_torch.ops import assign as da
    from protocol_tpu_torch.ops.cost import CostWeights
    from protocol_tpu_torch.ops.encoding import (
        compat_mask,
        gather_providers,
        gather_requirements,
        providers_from_numpy,
        requirements_from_numpy,
    )
    from protocol_tpu_torch.services import scheduler_grpc as sg
    from protocol_tpu_torch.services.assign_kernels import KernelDispatch
    from protocol_tpu_torch.trace.synth import synth_provider_arrays, synth_requirement_arrays

    weights = CostWeights()
    n = BACKEND_N

    def market(seed, P, T):
        rng = np.random.default_rng(seed)
        return (types.SimpleNamespace(**synth_provider_arrays(rng, P)),
                types.SimpleNamespace(**synth_requirement_arrays(rng, T)))

    markets = {
        "greedy": market(SEED + 50, n, n),
        "sinkhorn": market(SEED + 51, n, n),
        "auction": market(SEED + 52, n, n),
        "best": market(SEED + 53, *BACKEND_BEST),
        "topk": market(SEED + 54, N, N),
    }
    params = {  # kernel -> (top_k, eps, max_iters) as the requests carry them
        "greedy": (0, 0.0, 0), "sinkhorn": (0, SINKHORN_EPS, SINKHORN_ITERS),
        "auction": (0, AUCTION_EPS, AUCTION_ITERS), "best": (0, 0.0, 0),
        "topk": (BACKEND_TOP_K, 0.0, 0),
    }

    server = sg.serve("127.0.0.1:0", device=DEVICE)
    client = sg.SchedulerBackendClient(f"127.0.0.1:{server.port}")

    def rpc(label, kernel, wire, ep, er, warm=None):
        top_k, eps, iters = params[kernel]
        t0 = time.perf_counter()
        if wire == "v1":
            req = sg.encoded_to_proto(ep, er, weights, kernel=kernel, top_k=top_k, eps=eps,
                                      max_iters=iters)
            if warm is not None:
                req.warm_price.extend(warm[0])
                req.seed_provider_for_task.extend(warm[1])
            resp = client.assign(req, timeout=600.0)
            res, decode_ms = sg._res_v1(resp), None
        else:
            req = sg.encoded_to_proto_v2(ep, er, weights, kernel=kernel, top_k=top_k, eps=eps,
                                         max_iters=iters)
            if warm is not None:
                req.warm_price.CopyFrom(sg.blob(warm[0], np.float32))
                req.seed_provider_for_task.CopyFrom(sg.blob(warm[1], np.int32))
            resp = client.assign_v2(req, timeout=600.0)
            res, decode_ms = sg._res_v2(resp), resp.decode_ms
        timing = {"rtt_ms": (time.perf_counter() - t0) * 1e3, "server_ms": resp.solve_ms,
                  "decode_ms": decode_ms, "bytes_in": req.ByteSize(),
                  "bytes_out": resp.ByteSize()}
        print(f"backend {label} ({kernel}, {wire}, {len(res.t4p)} x {len(res.p4t)}): "
              f"{json.dumps(timing)} assigned {resp.num_assigned}", flush=True)
        return {"label": label, "kernel": kernel, "wire": wire, "res": res,
                "num": resp.num_assigned, "ep": ep, "er": er, "warm": warm, **timing}

    answers = []
    try:
        health = client.health(timeout=60.0)
        print(f"backend health: status {health.status} platform {health.platform} "
              f"devices {health.device_count}", flush=True)
        if (health.status, health.platform) != ("ok", "gpu"):
            raise AssertionError("the backend's Health does not report a GPU")
        backend_first_launches(torch, kernels, n)
        torch.cuda.synchronize()
        kernels.reset_launches()
        kernels.time_in_place(True)
        calls, originals = record_calls(kernels, ("greedy_assign", "sinkhorn"))
        for kernel in ("greedy", "sinkhorn", "auction", "best"):
            for wire in ("v1", "v2"):
                answers.append(rpc(kernel, kernel, wire, *markets[kernel]))
        ep, er = markets["topk"]
        cold = rpc("topk-cold", "topk", "v2", ep, er)
        repeat = rpc("topk-repeat", "topk", "v1", ep, er)
        rows = np.random.default_rng(SEED + 55).choice(N, int(N * CHURN), replace=False)
        price = ep.price.copy()  # a new array: the repriced providers
        price[rows] = np.random.default_rng(SEED + 56).uniform(0.5, 4.0, rows.size).astype(
            np.float32)
        ep_warm = types.SimpleNamespace(**{**vars(ep), "price": price})
        warm = rpc("topk-warm", "topk", "v2", ep_warm, er,
                   warm=(cold["res"].price, cold["res"].p4t))
        answers += [cold, repeat, warm]
        launches = dict(kernels.LAUNCHES)
        for name, fn in originals.items():
            setattr(kernels, name, fn)
        backend_in_place = in_place_run(kernels, launches, "backend")
        memo = server.servicer.kernels.memo
        print(f"kernels (backend): {json.dumps(launches)}; candidate memo hits {memo.hits} "
              f"misses {memo.misses}", flush=True)
        seam = {m.name: m.value for m in client.health(timeout=60.0).seam_metrics}
        print(f"backend seam metrics: {json.dumps(seam)}", flush=True)
    finally:
        client.close()
        server.stop(grace=None)
    missing = [k for k in BACKEND_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"the backend's RPCs launched no {missing}")
    if memo.hits != 1:
        raise AssertionError(f"the byte-identical topk repeat was not a memo hit ({memo.hits})")

    with uncounted(kernels):
        # every answer: compatible pairs, a matching; v1 == v2; the same
        # bits as the dispatch in process on the card
        dispatch = KernelDispatch()
        for a in answers:
            ep_d = providers_from_numpy(a["ep"], DEVICE)
            er_d = requirements_from_numpy(a["er"], DEVICE)
            pairs = check_answer(torch, compat_mask, gather_providers, gather_requirements,
                                 ep_d, er_d, a["res"], a["num"], a["kernel"])
            top_k, eps, iters = params[a["kernel"]]
            carried = a["warm"] or (None, None)
            local = dispatch.solve(ep_d, er_d, weights, a["kernel"], top_k,
                                   float(np.float32(eps)), iters, *carried)
            same = (np.array_equal(local.p4t, a["res"].p4t)
                    and np.array_equal(local.t4p, a["res"].t4p)
                    and (local.price is None) == (a["res"].price is None)
                    and (local.price is None or local.price.tobytes() == a["res"].price.tobytes()))
            print(f"backend {a['label']} ({a['wire']}): {pairs} compatible pairs, equal to "
                  f"the dispatch in process {same}", flush=True)
            if not same:
                raise AssertionError(f"backend {a['label']} ({a['wire']}) differs from the "
                                     "dispatch in process")
        for x, y in zip(answers[0:8:2], answers[1:8:2]):
            if not (np.array_equal(x["res"].p4t, y["res"].p4t)
                    and np.array_equal(x["res"].t4p, y["res"].t4p)):
                raise AssertionError(f"backend {x['kernel']}: v1 and v2 differ")
        if not (np.array_equal(cold["res"].p4t, repeat["res"].p4t)
                and cold["res"].price.tobytes() == repeat["res"].price.tobytes()):
            raise AssertionError("backend topk: the repeat (v1) differs from the cold call (v2)")
        print(f"backend: v1 == v2 for greedy, sinkhorn, auction, best and topk; topk warm "
              f"assigned {warm['num']} of {N} (cold {cold['num']})", flush=True)
        if warm["num"] / N < 0.99 or cold["num"] / N < 0.99:
            raise AssertionError("backend topk assigned fewer than 99% of the tasks")

        # K12 on its first call (the greedy RPC over K10's block) and K13 on
        # its first (the sinkhorn RPC), against their plain versions
        (g_cost, g_order), _, g_out = calls["greedy_assign"][0]
        g_ref = da._greedy_plain(g_cost, g_order)
        torch.cuda.synchronize()
        if not bits_equal(torch, g_out, g_ref):
            raise AssertionError("K12 differs from its plain version on its first call")
        (s_cost, s_eps, s_iters), _, s_out = calls["sinkhorn"][0]
        plan_k, rcost_k, colmax_k, u_k, v_k = s_out
        cost = s_cost.T  # the reference's [P, T]
        K, u_p, v_p = da._sinkhorn_plain(cost, s_eps, s_iters)
        plan_p = da._plan_plain(K, u_p, v_p)
        errs = {}
        for name, got, ref in (("u", u_k, u_p), ("v", v_k, v_p)):
            masked = ref < -1e17
            if not (torch.equal(got < -1e17, masked) and bool((got[masked] == -1e18).all())):
                raise AssertionError(f"K13: {name} is masked elsewhere than the plain version's")
            errs[name] = float((got - ref)[~masked].abs().max())
        errs["plan"] = float((plan_k.T - plan_p).abs().max())
        if errs["u"] > SINKHORN_UV_ATOL or errs["v"] > SINKHORN_UV_ATOL \
                or errs["plan"] > SINKHORN_PLAN_ATOL:
            raise AssertionError(f"K13 outside its tolerance: {errs}")
        # the rounding: K13's own inputs give the plain rounding's, bit for
        # bit; against the plain plan's rounding, the first difference must
        # sit on a decision closer than the plan tolerance
        r_tp, r_order = da._rounding_inputs(cost, plan_k.T)
        k_order = torch.sort(-colmax_k, stable=True).indices.to(torch.int32)
        k_p4t = kernels.greedy_assign(rcost_k, k_order)
        exact = (bits_equal(torch, rcost_k, r_tp) and torch.equal(k_order, r_order)
                 and bits_equal(torch, k_p4t, da._greedy_plain(r_tp, r_order)))
        if not exact:
            raise AssertionError("K13's rounding inputs or K12 on them differ from the plain "
                                 "rounding of K13's plan")
        p_rcost, p_order = da._rounding_inputs(cost, plan_p)
        p_p4t, order_ties, step_tie = rounding_near_ties(torch, p_rcost, p_order,
                                                         plan_p.amax(dim=0), SINKHORN_PLAN_ATOL)
        if not bits_equal(torch, p_p4t, da._greedy_plain(p_rcost, p_order)):
            raise AssertionError("the rounding replay differs from the plain rounding")
        diverge = None
        differ = torch.nonzero(k_order != p_order).flatten()
        first_order = int(differ[0]) if differ.numel() else len(p_order)
        picks_k, picks_p = k_p4t[p_order.long()], p_p4t[p_order.long()]
        differ = torch.nonzero(picks_k[:first_order] != picks_p[:first_order]).flatten()
        if differ.numel():
            diverge = ("step", int(differ[0]), bool(step_tie[int(differ[0])]))
        elif first_order < len(p_order):
            keys = plan_p.amax(dim=0)
            gap = abs(float(keys[int(k_order[first_order])] - keys[int(p_order[first_order])]))
            diverge = ("order", first_order, gap < SINKHORN_PLAN_ATOL)
        same_rounding = bits_equal(torch, k_p4t, p_p4t)
        print(f"K13 against its plain version ({cost.shape[0]} x {cost.shape[1]}, eps {s_eps}, "
              f"{s_iters} rounds): max_abs_err {json.dumps(errs)}; rounding equal {same_rounding}, "
              f"ties excluded: {order_ties} in the visit order, {int(step_tie.sum())} steps "
              f"(tolerance {SINKHORN_PLAN_ATOL}); first difference {diverge}", flush=True)
        if not same_rounding and (diverge is None or not diverge[2]):
            raise AssertionError(f"K13's rounding differs from the plain one away from a tie: "
                                 f"{diverge}")

        # times on the first calls' inputs
        k12_ms = cuda_ms(torch, lambda: kernels.greedy_assign(g_cost, g_order), 3)
        k12_plain_ms = cuda_ms(torch, lambda: da._greedy_plain(g_cost, g_order), 1)
        k13_ms = cuda_ms(torch, lambda: kernels.sinkhorn(s_cost, s_eps, s_iters), 3)

        def k13_plain():
            plan = da._plan_plain(*da._sinkhorn_plain(cost, s_eps, s_iters))
            return da._rounding_inputs(cost, plan)

        k13_plain_ms = cuda_ms(torch, k13_plain, 1)
        x = K + v_p[None, :]
        lse_ms = cuda_ms(torch, lambda: torch.logsumexp(x, dim=1), 5)

        def lse_passes():
            for _ in range(s_iters):
                torch.logsumexp(x, dim=1)
                torch.logsumexp(x, dim=0)

        lse_passes_ms = cuda_ms(torch, lse_passes, 1)
        del x, K, plan_p, p_rcost
    Tg, Pg = g_cost.shape
    Ts, Ps = s_cost.shape
    cells = Ts * Ps
    s_feasible = int((s_cost < 5e8).sum())
    rows = [
        # K12: the cost block read once, the order and the picks; a compare
        # and a select per cell
        dict(row("greedy_assign", SRC_K12, "protocol_tpu/ops/assign.py:70", 0.0, k12_ms,
                 k12_plain_ms, Tg * Pg * 4 + Tg * 8, Tg * Pg * 2),
             us_per_step=k12_ms * 1e3 / max(Tg, 1)),
        # K13: the cost in, the plan and the rounding cost out; per feasible
        # cell and round two passes of five operations (add, max, subtract,
        # exp, add): the rounds skip the infeasible cells exactly; nine a
        # cell in the prep and the final pass
        row("sinkhorn", SRC_K13, "protocol_tpu/ops/assign.py:111", errs["plan"], k13_ms,
            k13_plain_ms, cells * 12 + (Ts + Ps) * 8,
            s_feasible * 10 * s_iters + cells * 9),
    ]
    rows[1]["bound_ms_all_cells"] = max(
        (cells * 12 + (Ts + Ps) * 8) / PEAK_BYTES_PER_S,
        cells * (10 * s_iters + 9) / PEAK_F32_OPS_PER_S) * 1e3
    layout = kernels.sinkhorn_layout(s_feasible, Ts, Ps)
    rows[1].update(feasible_share=s_feasible / cells, layout=layout,
                   block_bytes=2 * (6 * s_feasible if layout == "packed" else 4 * cells))
    rows[1]["library_ms"] = lse_passes_ms
    rows[1]["library_call"] = (f"torch.logsumexp on the [P, T] block, two passes a round "
                               f"x {s_iters} rounds (the nearest call: the passes only)")
    rows[1]["logsumexp_pass_ms"] = lse_ms
    rows[1]["uv_max_abs_err"] = max(errs["u"], errs["v"])
    print(f"K12 timed on the greedy RPC's call ({Tg} steps x {Pg} providers); K13 on the "
          f"sinkhorn RPC's ({Ts} x {Ps}, {s_iters} rounds); one torch.logsumexp pass "
          f"{lse_ms:.4f} ms", flush=True)
    return rows, {"backend": launches}, backend_in_place


def finite_err(torch, got, ref, keep) -> float:
    """Largest |got - ref| over ``keep`` (0 where it is empty)."""
    return float((got - ref)[keep].abs().max()) if bool(keep.any()) else 0.0


def check_cells(torch, compat_mask, slice_requirements, ep, er, w, tile: int) -> tuple[int, int]:
    """(compatible cells, compatible cells whose cost bracket straddles
    INFEASIBLE/2) of ep x er, a tile of tasks at a time: the bracket of
    csrc/blocked.cu's feasibility launch, fsub(fadd(base, near), prio) at
    near = min / max(0, proximity x 20,016 km) for a located pair, 0 for
    another; those cells are the ones it runs the haversine on."""
    f32 = torch.float32
    prox = torch.tensor(w.proximity, dtype=f32, device=ep.price.device)
    far = prox * 20016.0
    near_lo, near_hi = torch.clamp(far, max=0.0), torch.clamp(far, min=0.0)
    if not bool(torch.isfinite(prox)):
        near_lo = near_hi = torch.full_like(prox, float("nan"))
    base = w.price * ep.price + w.load * ep.load
    b0 = base + 0.0
    p_loc = ep.has_location.bool()
    blo = torch.where(p_loc, base + near_lo, b0)
    bhi = torch.where(p_loc, base + near_hi, b0)
    compat = straddle = 0
    for t in range(0, er.num, tile):
        er_t = slice_requirements(er, t, tile)
        mask = compat_mask(ep, er_t)
        t_loc, prio = er_t.has_location.bool()[None, :], w.priority * er_t.priority
        lo = torch.where(t_loc, blo[:, None], b0[:, None]) - prio
        hi = torch.where(t_loc, bhi[:, None], b0[:, None]) - prio
        compat += int(mask.sum())
        straddle += int((mask & ~(hi < 5e8) & ~(lo >= 5e8)).sum())
    return compat, straddle


def check_floor(r_: dict, cells: int, bracket_open: int, bytes_: int) -> None:
    """The feasibility launch's row: its bound counts 30 operations more on
    every feasible cell, which it runs only where the cost bracket is open;
    the check's own floor (12 operations a cell and the bytes) beside it."""
    floor_ops = cells * OPS_PER_CELL + bracket_open * OPS_PER_FEASIBLE_CELL
    r_["bracket_open_cells"] = bracket_open
    r_["check_floor_ms"] = max(bytes_ / PEAK_BYTES_PER_S, floor_ops / PEAK_F32_OPS_PER_S) * 1e3
    r_["bound_note"] = ("bound_ms counts 30 operations on every feasible cell; the launch runs "
                        "the haversine only on the bracket_open_cells, so check_floor_ms (12 "
                        "a cell, 30 a bracket-open cell, and the bytes) is its own floor")


def check_bitmaps(torch, bl, bits, ep, er, w, label: str) -> None:
    """K14's feasibility bitmaps against the plain packer's, word for word;
    the packer builds its mask a chunk of tasks at a time, so no [P, T]
    mask exists."""
    ref = bl.pack_feasibility(ep, er, w)
    same = torch.equal(bits.rows, ref.rows) and torch.equal(bits.cols, ref.cols)
    print(f"K14 bitmaps at {label} ({bl.FeasibilityBits.nbytes(*bits.shape)} bytes) against "
          f"the plain packer: equal word for word {same}", flush=True)
    if not same:
        raise AssertionError(f"K14 bitmaps at {label}: not the plain packer's words")


def run_stage_s(torch, kernels) -> tuple[list, dict, dict]:
    """BASELINE ladder #3 on the card (protocol_tpu_torch/stage_s.py): the
    blocked Sinkhorn's potentials and rounding against the CPU's at
    STAGE_S_SMALL, then stage S at STAGE_S with the counts set to 0 just
    before; K14's three launches, K1's biased forward launch and K15 are
    then held against their plain versions at full width on the
    arguments of the run's calls. Returns (the kernels-line rows of K14,
    K1 biased and K15, {"stage_s": launches}, the one-device reference
    for run_mesh_sinkhorn: the instance, u, v and the referee's mean
    cost)."""
    import numpy as np

    from protocol_tpu_torch import stage_s
    from protocol_tpu_torch.ops import blocked as bl
    from protocol_tpu_torch.ops import cost as oc
    from protocol_tpu_torch.ops import sparse as sp
    from protocol_tpu_torch.ops.cost import CostWeights
    from protocol_tpu_torch.ops.encoding import compat_mask, slice_requirements
    from protocol_tpu_torch.trace.synth import synth_providers, synth_requirements

    eps = stage_s.EPS

    # ---- the card against the CPU (the CPU run is the plain torch path
    # the CPU tests hold against the reference), proximity 0
    n, tile, iters = STAGE_S_SMALL
    zero = CostWeights(proximity=0.0)

    def instance(device):  # stage S's own draws: one generator, providers first
        rng = np.random.default_rng(42)
        return synth_providers(rng, n, device=device), synth_requirements(rng, n, device=device)

    (ep_c, er_c), (ep_g, er_g) = instance("cpu"), instance(DEVICE)
    gu, gv = bl.sinkhorn_potentials_blocked(ep_g, er_g, zero, eps=eps, num_iters=iters, tile=tile)
    cu, cv = bl.sinkhorn_potentials_blocked(ep_c, er_c, zero, eps=eps, num_iters=iters, tile=tile)
    gu, gv = gu.cpu(), gv.cpu()
    small = {}
    for name, g, c in (("u", gu, cu), ("v", gv, cv)):
        keep = c > -5e17
        if not torch.equal(g > -5e17, keep) or not bool((g[~keep] == c[~keep]).all()):
            raise AssertionError(f"stage S {n}^2: the card's {name} mask differs from the CPU's")
        small[name] = finite_err(torch, g, c, keep)
    res_g = bl.plan_guided_rounding(ep_g, er_g, gu.to(DEVICE), zero, eps=eps, tile=tile, k=32)
    res_c = bl.plan_guided_rounding(ep_c, er_c, gu, zero, eps=eps, tile=tile, k=32)
    same = bool(torch.equal(res_g.provider_for_task.cpu(), res_c.provider_for_task))
    print(f"stage S {n}x{n} (tile {tile}, {iters} iterations, proximity 0) card vs cpu: "
          f"u/v max_abs_err {json.dumps(small)} (tolerance {BLOCKED_ATOL}), masks equal; "
          f"rounding on the card's u identical {same}, assigned "
          f"{int((res_g.provider_for_task >= 0).sum())}", flush=True)
    if max(small.values()) > BLOCKED_ATOL or not same:
        raise AssertionError(f"stage S {n}^2: the card differs from the CPU")
    del ep_g, er_g, res_g, res_c

    # ---- stage S at full width, the counts set to 0 just before
    size, tile, iters = STAGE_S
    torch.cuda.synchronize()
    kernels.reset_launches()
    recorded, originals = record_first_calls(kernels, {
        "blocked_feasibility": (), "blocked_row_lse": (), "blocked_col_lse": (),
        "candidates_forward_rows": (),
    })
    keep: dict = {}
    peak: dict = {}
    potentials = stage_s.sinkhorn_potentials_blocked

    def measured_potentials(*args, **kw):  # the potentials' peak device memory
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = potentials(*args, **kw)
        torch.cuda.synchronize()
        peak["bytes"] = torch.cuda.max_memory_allocated()
        return out

    k2_first: dict = {}
    k2 = kernels.auction_phase

    def k2_recorded(*args, **kw):  # the first call at the referee's frontier
        if kw.get("B") == STAGE_S_K2_B and not k2_first:
            k2_first["call"] = (args, dict(kw))
        return k2(*args, **kw)

    stage_s.sinkhorn_potentials_blocked = measured_potentials
    kernels.auction_phase = k2_recorded
    kernels.time_in_place(True)
    t0 = time.perf_counter()
    try:
        summary = stage_s.run(size=size, tile=tile, iters=iters, device=DEVICE, keep=keep,
                              emit=lambda row_: print(f"stage S: {json.dumps(row_)}", flush=True))
    finally:
        stage_s.sinkhorn_potentials_blocked = potentials
        kernels.auction_phase = k2
    wall = time.perf_counter() - t0
    for name, fn in originals.items():
        setattr(kernels, name, fn)
    launches = dict(kernels.LAUNCHES)
    stage_in_place = in_place_run(kernels, launches, "stage S")
    print(f"kernels (stage S): {json.dumps(launches)}", flush=True)
    missing = [k_ for k_ in STAGE_S_KERNELS if launches[k_] == 0]
    if missing:
        raise AssertionError(f"stage S launched no {missing}")
    s_row, a_row = summary["rows"]
    for prefix, r_ in (("sinkhorn", s_row), ("auction", a_row)):
        if not r_[f"{prefix}_injective"] or r_[f"{prefix}_infeasible_pairs"] != 0:
            raise AssertionError(f"stage S: the {prefix} matching is not injective or pairs "
                                 f"an infeasible cell: {r_}")
    ep, er, w, u, v = keep["ep"], keep["er"], keep["weights"], keep["u"], keep["v"]
    row_any, col_any, bits = kernels.blocked_feasibility(ep, er, w)
    if not (bool(torch.isfinite(u[row_any]).all()) and bool(torch.isfinite(v[col_any]).all())):
        raise AssertionError("stage S: a potential on a row or column with a feasible cell "
                             "is not finite")
    timings = summary["timings_s"]
    print(f"stage S at {size}x{size} (tile {tile}, {iters} iterations): potentials_s "
          f"{timings['potentials']:.3f} end_to_end_s {timings['end_to_end']:.3f} gen_s "
          f"{timings['gen']:.3f} solve_s {timings['solve']:.3f}; assigned "
          f"{s_row['sinkhorn_assigned']} / {a_row['auction_assigned']}, mean cost "
          f"{s_row['sinkhorn_mean_cost']} / {a_row['auction_mean_cost']}, delta "
          f"{summary['sinkhorn_vs_auction_mean_cost_delta_pct']} %; wall {wall:.3f} s",
          flush=True)
    print(f"stage S potentials at {size}x{size}: peak device memory {peak['bytes']} bytes "
          f"(torch.cuda.max_memory_allocated; K14's bitmaps "
          f"{bl.FeasibilityBits.nbytes(size, size)} bytes of it) on {card_line()}", flush=True)

    # ---- the kernels against their plain versions at full width, on the
    # arguments of the run's calls
    (f_ep, f_er, f_w), _ = recorded["blocked_feasibility"]
    k_block = bl.make_k_block(f_ep, f_er, f_w, eps, tile)
    starts = range(0, size, tile)
    p_row, p_col = bl.feasibility_scan(k_block, size, starts)
    if not (torch.equal(row_any, p_row) and torch.equal(col_any, p_col.reshape(size))):
        raise AssertionError("K14 feasibility: the masks differ from the plain scan")
    check_bitmaps(torch, bl, bits, f_ep, f_er, f_w, f"{size}x{size}")
    (r_ep, r_er, r_w, r_eps, r_v, r_bits), _ = recorded["blocked_row_lse"]
    (c_ep, c_er, c_w, c_eps, c_u, c_bits), _ = recorded["blocked_col_lse"]
    kb_rows = bl.make_k_block_bits(r_ep, r_er, r_w, r_eps, tile, r_bits, "rows")
    kb_cols = bl.make_k_block_bits(c_ep, c_er, c_w, c_eps, tile, c_bits, "cols")
    got_r = kernels.blocked_row_lse(r_ep, r_er, r_w, r_eps, r_v, r_bits)
    ref_r = bl.streaming_row_logsumexp(kb_rows, r_v, starts, size, tile)
    got_c = kernels.blocked_col_lse(c_ep, c_er, c_w, c_eps, c_u, c_bits)
    ref_c = bl.column_logsumexp(kb_cols, c_u, starts)
    torch.cuda.synchronize()
    k14_err = {"row": finite_err(torch, got_r, ref_r, row_any),
               "col": finite_err(torch, got_c, ref_c, col_any)}
    print(f"K14 at {size}x{size} against the plain passes on the run's bitmaps (first calls): "
          f"feasibility equal, lse max_abs_err {json.dumps(k14_err)} (tolerance "
          f"{BLOCKED_ATOL})", flush=True)
    if max(k14_err.values()) > BLOCKED_ATOL:
        raise AssertionError(f"K14: lse error {k14_err} > {BLOCKED_ATOL}")
    (b_ep, b_er, b_w, b_k, b_ids), b_kw = recorded["candidates_forward_rows"]
    bias = b_kw.get("bias")
    if bias is None:
        raise AssertionError("stage S: K1's first forward call was not the biased rounding's")
    got_b = kernels.candidates_forward_rows(b_ep, b_er, b_w, b_k, b_ids, bias=bias)
    ref_b = sp._forward_plain(b_ep, b_er, b_w, b_k, tile, provider_offset=bias)
    torch.cuda.synchronize()
    if not all(bits_equal(torch, a, b) for a, b in zip(got_b, ref_b)):
        raise AssertionError("K1 biased: not bit-identical to the plain biased selection")
    if "call" not in k2_first:
        raise AssertionError(f"stage S: no K2 call at B = {STAGE_S_K2_B}")
    (k_args, k_kw) = k2_first["call"]
    k_work: dict = {}
    got_k, g_stall = kernels.auction_phase(*k_args, **k_kw, work_out=k_work)
    ref_k, r_stall = sp._auction_rounds_plain(*k_args, k_kw["P"], k_kw["eps"], k_kw["max_iters"],
                                              k_kw["B"], k_kw["stall_limit"])
    torch.cuda.synchronize()
    same = all(bits_equal(torch, a.to(b.dtype), b) for a, b in zip(got_k, ref_k))
    same &= int(g_stall) == int(r_stall)
    print(f"K2 at stage S's shape (T {k_args[1].shape[0]}, K {k_args[1].shape[1]}, B "
          f"{k_kw['B']}, eps {k_kw['eps']}; first call): rounds {int(got_k[0])} frontier rows "
          f"{int(k_work['frontier_rows'])} assigned {int((got_k[3] >= 0).sum())} "
          f"bit-identical {same}", flush=True)
    if not same:
        raise AssertionError("K2 at stage S's shape: not bit-identical to the plain version")
    del k2_first, k_args, got_k, ref_k
    p4t_a = keep["auction"].provider_for_task
    got_p = kernels.pair_cost(ep, er, w, p4t_a)
    ref_p = oc._cost_pairs_plain(ep, er, p4t_a, w)
    torch.cuda.synchronize()
    if not bits_equal(torch, got_p, ref_p):
        raise AssertionError("K15: not bit-identical to the plain cost_pairs on the referee's p4t")
    print("K1 biased (the rounding's call) and K15 (the referee's p4t) at full width: "
          f"bit-identical; K15's sha256 {sha16(torch, got_p)}", flush=True)
    del got_r, ref_r, got_c, ref_c, got_b, ref_b, got_p, ref_p

    # ---- times on those arguments, the plain versions' and the nearest
    # library call's: torch.logsumexp over a materialised [P, tile] block,
    # once per task tile
    feas_ms = cuda_ms(torch, lambda: kernels.blocked_feasibility(f_ep, f_er, f_w), 3)
    row_ms = cuda_ms(torch, lambda: kernels.blocked_row_lse(r_ep, r_er, r_w, r_eps, r_v, r_bits),
                     3)
    col_ms = cuda_ms(torch, lambda: kernels.blocked_col_lse(c_ep, c_er, c_w, c_eps, c_u, c_bits),
                     3)
    bias_ms = cuda_ms(torch, lambda: kernels.candidates_forward_rows(
        b_ep, b_er, b_w, b_k, b_ids, bias=bias), 3)
    unbiased_ms = cuda_ms(torch, lambda: kernels.candidates_forward_rows(
        b_ep, b_er, b_w, b_k, b_ids), 3)
    pair_ms = cuda_ms(torch, lambda: kernels.pair_cost(ep, er, w, p4t_a), 10)
    pair_launch_ms = launch_ms(torch, kernels, lambda: kernels.pair_cost(ep, er, w, p4t_a), 50)
    feas_plain = cuda_ms(torch, lambda: bl.feasibility_scan(k_block, size, starts), 1)
    row_plain = cuda_ms(torch, lambda: bl.streaming_row_logsumexp(kb_rows, r_v, starts, size,
                                                                   tile), 1)
    col_plain = cuda_ms(torch, lambda: bl.column_logsumexp(kb_cols, c_u, starts), 1)
    bias_plain = cuda_ms(torch, lambda: sp._forward_plain(b_ep, b_er, b_w, b_k, tile,
                                                          provider_offset=bias), 1)
    pair_plain = cuda_ms(torch, lambda: oc._cost_pairs_plain(ep, er, p4t_a, w), 1)
    # the library pass: one materialised [P, tile] block (1 GB, far above
    # L2, so each call reads it from memory) reduced once per task tile
    n_tiles = size // tile
    x = k_block(0) + r_v[None, :tile]
    lse_row_ms = cuda_ms(torch, lambda: [torch.logsumexp(x, dim=1) for _ in range(n_tiles)], 1)
    x = k_block(0) + c_u[:, None]
    lse_col_ms = cuda_ms(torch, lambda: [torch.logsumexp(x, dim=0) for _ in range(n_tiles)], 1)
    del x
    print(f"K14 at {size}x{size}: feasibility {feas_ms:.3f} ms, row pass {row_ms:.3f} ms, "
          f"column pass {col_ms:.3f} ms (plain {feas_plain:.3f} / {row_plain:.3f} / "
          f"{col_plain:.3f}; {n_tiles} torch.logsumexp calls over a materialised [P, {tile}] "
          f"block, timed as one pass "
          f"{lse_row_ms:.3f} / {lse_col_ms:.3f}); K1 forward at {size}x{size} biased "
          f"{bias_ms:.3f} ms, unbiased {unbiased_ms:.3f} ms; K15 {pair_ms:.4f} ms", flush=True)

    # bounds: the cells of the pass (feasible ones counted on this run's
    # data); the cells whose cost the feasibility launch's bracket leaves
    # to the haversine
    feasible, bracket_open = check_cells(torch, compat_mask, slice_requirements, ep, er, w, tile)
    cells = size * size
    p_row_b, r_row_b = row_bytes(ep), row_bytes(er)
    cols_bytes = size * p_row_b + size * r_row_b
    ops_scan = cells * OPS_PER_CELL + feasible * OPS_PER_FEASIBLE_CELL
    # a pass scores the feasible cells only: the cost, the division, the
    # add, the exp and the online sum; it reads one of the two bitmaps
    ops_lse = feasible * (OPS_PER_FEASIBLE_CELL + 5)
    bitmaps = bl.FeasibilityBits.nbytes(size, size)
    assigned = int((p4t_a >= 0).sum())
    print(f"stage S cells {cells}, feasible {feasible} ({feasible / cells:.4f})", flush=True)
    rows = [
        row("blocked_feasibility", SRC_BLOCKED, "protocol_tpu/ops/blocked.py:54", 0.0,
            feas_ms, feas_plain, cols_bytes + size + size // 8 + bitmaps, ops_scan),
        row("blocked_row_lse", SRC_BLOCKED, "protocol_tpu/ops/blocked.py:64",
            k14_err["row"], row_ms, row_plain, cols_bytes + size * 8 + bitmaps // 2, ops_lse),
        row("blocked_col_lse", SRC_BLOCKED, "protocol_tpu/ops/blocked.py:133",
            k14_err["col"], col_ms, col_plain, cols_bytes + size * 8 + bitmaps // 2, ops_lse),
        row("candidates_forward_rows_biased", SRC_K1, "protocol_tpu/ops/sparse.py:150", 0.0,
            bias_ms, bias_plain, cols_bytes + size * 8 + size * b_k * 8,
            ops_scan + feasible),
        row("pair_cost", SRC_BLOCKED, "protocol_tpu/ops/cost.py:137", 0.0, pair_ms, pair_plain,
            size * (r_row_b + 8) + assigned * p_row_b,
            size * OPS_PER_CELL + assigned * OPS_PER_FEASIBLE_CELL),
    ]
    for r_, b_ in zip(rows[:3], (bitmaps, bitmaps // 2, bitmaps // 2)):
        r_["runs"] = ("stage_s",)  # the sharded run's launches are a shard's: their own rows
        r_["bitmap_bytes"] = b_  # of bytes_ in the bound: written (feasibility) or read
        r_["in_place_ms_stage_s"] = stage_in_place[r_["name"]]["ms"]
    check_floor(rows[0], cells, bracket_open, cols_bytes + size + size // 8 + bitmaps)
    for r_, lib in ((rows[1], lse_row_ms), (rows[2], lse_col_ms)):
        r_["library_ms"] = lib
        r_["library_call"] = (f"{n_tiles} calls of torch.logsumexp over a materialised "
                              f"[P, {tile}] block of K + the potential, timed as one pass "
                              f"(the nearest call: the block is not recomputed)")
    rows[4]["launch_ms"] = pair_launch_ms  # ms: the wrapper's, with its read of max(p4t)
    rows[4]["plain_cells"] = (f"the plain cost_pairs scores a [{oc._PAIR_CHUNK}, "
                              f"{oc._PAIR_CHUNK}] block per chunk of tasks and keeps its "
                              f"diagonal: {oc._PAIR_CHUNK}x the {size} cells K15 scores")
    rows[3]["unbiased_ms"] = unbiased_ms
    rows[0]["stage_s"] = {"size": size, "tile": tile, "iters": iters, **timings,
                          "wall_s": wall, "card_vs_cpu_small": small,
                          "potentials_peak_bytes": peak["bytes"],
                          "mean_cost_delta_pct": summary["sinkhorn_vs_auction_mean_cost_delta_pct"],
                          "rows": summary["rows"]}
    reference = {"ep": ep, "er": er, "weights": w, "u": u, "v": v,
                 "referee_mean_cost": a_row["auction_mean_cost"],
                 "sinkhorn_mean_cost": s_row["sinkhorn_mean_cost"]}
    del keep, k_block, kb_rows, kb_cols, bits
    return rows, {"stage_s": launches}, reference


# the provider mesh: D = 4 views of the one card (utils/platform.py)
MESH_D = 4
MESH_SHARD_OFFSET = 16_384 * 3  # shard 3's first row at N / 4 tasks a shard
MESH_KERNELS = ("candidates_bidir", "candidates_forward_rows", "repair_enter", "repair_refold")
# K16 where every shard lies on one card: its segment launch; across cards
# its three launches a round, which no run on one card may launch
K16 = ("mesh_segment",)
K16_ROUNDS = ("mesh_round_bid", "mesh_round_resolve", "mesh_round_apply")
MESH_MATCHER_KERNELS = ("candidates_bidir",) + K16
SRC_K16 = "protocol_tpu_torch/csrc/auction.cu"
SRC_K16_ROUNDS = "protocol_tpu_torch/csrc/mesh_auction.cu"


def run_mesh(torch, kernels, refresh) -> tuple[list, dict, dict]:
    """The provider mesh on the card at D = 4 views of it: sharded
    generation at 65,536^2 against D = 1 and the one-device pass; then, in
    two runs with the counts set to 0 just before each, each timed in
    place, a TorchSolveArena(devices=4) chain (cold, 3 x 1% requirement
    churn, 1% provider churn) held tick by tick against
    TorchSolveArena(devices=1) and a fresh cold pass at D = 4 (repaired ==
    regen), and TorchBatchMatcher(use_mesh=True) on the torch route's
    pool, the stateless route and the cached default route, each cold and
    after 1% node churn; then K1 per shard, K3 at a shard's offset, K5 at
    4 and 8 lanes and K16 over a 256-round segment (the segment launch and
    the three-launch rounds) against their plain versions. Returns (rows,
    {run name: launches}, {run name: in-place sums}); raises on any failed
    check."""
    import numpy as np

    from protocol_tpu_torch.ops import sparse as sp
    from protocol_tpu_torch.ops.cost import CostWeights
    from protocol_tpu_torch.ops.encoding import (
        compat_mask,
        gather_providers,
        gather_requirements,
        providers_from_numpy,
        requirements_from_numpy,
        slice_requirements,
    )
    from protocol_tpu_torch.parallel import sparse as ps
    from protocol_tpu_torch.parallel import torch_arena
    from protocol_tpu_torch.parallel.mesh import make_mesh
    from protocol_tpu_torch.parallel.torch_arena import TorchSolveArena
    from protocol_tpu_torch.sched import torch_backend as tb
    from protocol_tpu_torch.trace.synth import synth_provider_arrays, synth_requirement_arrays
    from protocol_tpu_torch.utils import platform

    dev = DEVICE
    default, zero_prox = CostWeights(), CostWeights(proximity=0.0)
    k, r, extra = 64, 8, 16
    prev = platform.force_virtual_devices(MESH_D, torch.device(dev).type)
    # K1's launches inside the sharded pass, wherever the arena or the
    # matcher calls it (the cached route's and the repair's unsharded K1
    # calls are not among them)
    gen_count = {"candidates_sharded": 0}
    counting = count_inside(kernels, (ps, torch_arena, tb), "candidates_topk_bidir_sharded",
                            ("candidates_bidir",), gen_count, "candidates_sharded")
    counting.__enter__()
    try:
        mesh = make_mesh(MESH_D, dev)
        pa = synth_provider_arrays(np.random.default_rng(SEED + 60), N)
        ra = synth_requirement_arrays(np.random.default_rng(SEED + 61), N)
        ep, er = providers_from_numpy(pa, dev), requirements_from_numpy(ra, dev)
        tile = sp.pick_tile(N, cap=min(1024, max(1, N // 8)))
        Tl = N // MESH_D

        # ---- sharded generation: D = 4 against D = 1 and the one-device pass
        names = ("cand_p", "cand_c", "fwd_p", "fwd_c", "pool_t", "pool_c")
        g4 = ps.candidates_topk_bidir_sharded(ep, er, default, mesh=mesh, k=k, tile=tile,
                                              reverse_r=r, extra=extra, with_parts=True)
        g1 = ps.candidates_topk_bidir_sharded(ep, er, default, mesh=make_mesh(1, dev), k=k,
                                              tile=tile, reverse_r=r, extra=extra,
                                              with_parts=True)
        fp, fc, rt_, rc, pt, pc = sp.candidates_topk_reverse(ep, er, default, k=k, tile=tile,
                                                             reverse_r=r, with_pools=True)
        one = (*sp.merge_reverse_candidates(fp, fc, rt_, rc, extra=extra), fp, fc, pt, pc)
        torch.cuda.synchronize()
        bad = [n for n, a, b, c in zip(names, g4, g1, one)
               if not (bits_equal(torch, a, b) and bits_equal(torch, a, c))]
        print(f"mesh generation at {N}x{N}, D={MESH_D} vs D=1 vs one device: bit-identical "
              f"{not bad}", flush=True)
        if bad:
            raise AssertionError(f"sharded generation differs at D={MESH_D}: {bad}")
        gen4_ms = cuda_ms(torch, lambda: ps.candidates_topk_bidir_sharded(
            ep, er, default, mesh=mesh, k=k, tile=tile, reverse_r=r, extra=extra), 2)
        gen1_ms = cuda_ms(torch, lambda: sp.merge_reverse_candidates(
            *sp.candidates_topk_reverse(ep, er, default, k=k, tile=tile, reverse_r=r),
            extra=extra), 2)
        print(f"mesh generation: {gen4_ms:.3f} ms at D={MESH_D} (four shards on one card), "
              f"{gen1_ms:.3f} ms on one device", flush=True)
        cand_p, cand_c = g4[0], g4[1]
        del g1, one, fp, fc, rt_, rc, pt, pc

        # ---- the arena chain at D = 4 against D = 1 and a fresh regen
        def ns(cols):
            return types.SimpleNamespace(**cols)

        churn = np.random.default_rng(SEED + 62)
        n_churn = int(N * CHURN)
        cols = {"pa": dict(pa), "ra": dict(ra)}

        def req_churn():
            rows = churn.choice(N, n_churn, replace=False)
            ram = cols["ra"]["ram_mb"].copy()
            ram[rows] = np.maximum(256, (ram[rows] * churn.uniform(0.8, 1.25, rows.size))
                                   .astype(np.int32))
            cols["ra"]["ram_mb"] = ram

        def prov_churn():
            rows = churn.choice(N, n_churn, replace=False)
            price, load = cols["pa"]["price"].copy(), cols["pa"]["load"].copy()
            price[rows] = churn.uniform(0.5, 4.0, rows.size).astype(np.float32)
            load[rows] = churn.uniform(0, 1, rows.size).astype(np.float32)
            cols["pa"]["price"], cols["pa"]["load"] = price, load

        a4 = TorchSolveArena(devices=MESH_D, device=dev)
        a1 = TorchSolveArena(devices=1, device=dev)
        parts = ("cand_p", "cand_c", "fwd_p", "fwd_c", "pool_t", "pool_c")
        torch.cuda.synchronize()
        kernels.reset_launches()
        gen_count["candidates_sharded"] = 0
        calls, originals = record_calls(kernels, ("repair_enter", "repair_refold"))
        kernels.time_in_place(True)
        arena_ticks = []
        for label, step in (("prime", None), ("req-churn-0", req_churn),
                            ("req-churn-1", req_churn), ("req-churn-2", req_churn),
                            ("prov-churn", prov_churn)):
            if step is not None:
                step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p4 = a4.solve(ns(cols["pa"]), ns(cols["ra"]), default)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            st = dict(a4.last_stats)
            with uncounted(kernels, gen_count), kernels.untimed():
                t0 = time.perf_counter()
                p1 = a1.solve(ns(cols["pa"]), ns(cols["ra"]), default)
                torch.cuda.synchronize()
                wall_1 = (time.perf_counter() - t0) * 1e3
                st_1 = a1.last_stats
                fresh = TorchSolveArena(devices=MESH_D, cold_every=0, device=dev)
                fresh.solve(ns(a4._p_fields), ns(a4._r_fields), default)
                torch.cuda.synchronize()
            same_1 = bool(np.array_equal(p4, p1)) and a4.price.tobytes() == a1.price.tobytes() \
                and all(getattr(a4, f"_{n}").tobytes() == getattr(a1, f"_{n}").tobytes()
                        for n in parts)
            regen = all(getattr(a4, f"_{n}").tobytes() == getattr(fresh, f"_{n}").tobytes()
                        for n in parts)
            seated = p4[p4 >= 0]
            print(f"mesh arena {label}: wall_ms {wall:.1f} gen_ms {st.get('gen_ms')} solve_ms "
                  f"{st.get('solve_ms')} torch_devices {st['torch_devices']} gen_sharded "
                  f"{st['gen_sharded']} cand_cold_passes {st['cand_cold_passes']} repair_rows "
                  f"{st.get('repair_rows')} assigned {st['assigned']}/{N}; D=1: wall_ms "
                  f"{wall_1:.1f} gen_ms {st_1.get('gen_ms')} solve_ms {st_1.get('solve_ms')}; "
                  f"equal to D=1 {same_1}, repaired == regen {regen}", flush=True)
            arena_ticks.append(st)
            if not (same_1 and regen) or st["torch_devices"] != MESH_D or not st["gen_sharded"]:
                raise AssertionError(f"mesh arena {label}: D={MESH_D} differs from D=1 or regen, "
                                     "or did not shard")
            if (label == "prime") != bool(st["cold"]) or np.unique(seated).size != seated.size:
                raise AssertionError(f"mesh arena {label}: cold/warm or matching wrong")
            if st["assigned"] / N < 0.99:
                raise AssertionError(f"mesh arena {label}: only {st['assigned']} of {N} assigned")
            del fresh
        for name, fn in originals.items():
            setattr(kernels, name, fn)
        launches_arena = dict(kernels.LAUNCHES, **gen_count)
        in_place = {"mesh_arena": in_place_run(kernels, kernels.LAUNCHES, "mesh arena")}
        print(f"kernels (mesh arena): {json.dumps(launches_arena)}", flush=True)
        missing = [n for n in MESH_KERNELS + ("candidates_sharded",) if launches_arena[n] == 0]
        if missing:
            raise AssertionError(f"the mesh arena launched no {missing}")
        if any(launches_arena[n] for n in K16_ROUNDS):
            raise AssertionError("the mesh arena launched K16's three-launch rounds on one card")
        del a1

        # ---- the matcher over the mesh on the torch route's pool
        nodes, tasks = make_pool(np.random.default_rng(SEED + 30), *ARENA_POOL, sites=SITES)
        store = mem_store(nodes, tasks)
        rng = np.random.default_rng(SEED + 63)
        torch.cuda.synchronize()
        kernels.reset_launches()
        gen_count["candidates_sharded"] = 0
        kernels.time_in_place(True)
        matcher_stats = []
        for warm_start in (False, True):
            m = tb.TorchBatchMatcher(store, use_mesh=True, warm_start=warm_start, device=dev)
            route = "cached" if warm_start else "stateless"
            if warm_start:
                # the one-device cached route's cold seats
                with uncounted(kernels, gen_count), kernels.untimed():
                    single = tb.TorchBatchMatcher(store, device=dev)
                    single_seats = refresh(single, store, "mesh-reference-one-device-cold",
                                           "sparse_topk")["checked"]["bounded_seats"]
                    del single
            for step in ("cold", "node-churn"):
                if step == "node-churn":
                    churn_nodes(rng, store, CHURN, first=N * (2 + int(warm_start)))
                st = refresh(m, store, f"mesh-{route}-{step}", "sparse_topk")
                print(f"matcher mesh-{route}-{step}: mesh_sharded {st['mesh_sharded']} "
                      f"mesh_gen_sharded {st['mesh_gen_sharded']} mesh_route "
                      f"{st.get('mesh_route')}", flush=True)
                matcher_stats.append(st)
                if not st["mesh_sharded"] or (not warm_start and not st["mesh_gen_sharded"]):
                    raise AssertionError(f"mesh-{route}-{step}: the mesh did not engage")
                if st.get("mesh_route") != "segment":
                    raise AssertionError(f"mesh-{route}-{step}: phase 1 ran the "
                                         f"{st.get('mesh_route')} route, not K16's segment launch")
                if warm_start and step == "cold":
                    seats = st["checked"]["bounded_seats"]
                    print(f"mesh cached cold: {seats} bounded seats, one device {single_seats}",
                          flush=True)
                    if seats < ROUTE_SEATS_FLOOR * single_seats:
                        raise AssertionError(f"the mesh's cold cached refresh seats {seats}, "
                                             f"under {ROUTE_SEATS_FLOOR} x {single_seats}")
            del m
        launches_matcher = dict(kernels.LAUNCHES, **gen_count)
        in_place["mesh_matcher"] = in_place_run(kernels, kernels.LAUNCHES, "mesh matcher")
        print(f"kernels (mesh matcher): {json.dumps(launches_matcher)}", flush=True)
        missing = [n for n in MESH_MATCHER_KERNELS + ("candidates_sharded",)
                   if launches_matcher[n] == 0]
        if missing:
            raise AssertionError(f"the mesh matcher launched no {missing}")
        if any(launches_matcher[n] for n in K16_ROUNDS):
            raise AssertionError("the mesh matcher launched K16's three-launch rounds on one card")
        del store, nodes, tasks

        # ---- the kernels against their plain versions (uncounted)
        rows_out = []
        p_row, r_row = row_bytes(ep), row_bytes(er)
        with uncounted(kernels):
            # K1 per shard, at proximity 0 bit for bit, at the shard's offset
            for s_ in range(MESH_D):
                er_s = slice_requirements(er, s_ * Tl, Tl)
                check_k1(torch, sp, ep, er_s, zero_prox, tile, k, r, True,
                         f"shard {s_} of {MESH_D} ({N}x{Tl}) proximity=0", offset=s_ * Tl)
            shards_s = [slice_requirements(er, s_ * Tl, Tl) for s_ in range(MESH_D)]

            def k1_shards():
                for s_, er_s in enumerate(shards_s):
                    sp.candidates_fused(ep, er_s, default, k, tile, r, 1, task_offset=s_ * Tl)

            def k1_shards_plain():
                for s_, er_s in enumerate(shards_s):
                    sp._bidir_plain(ep, er_s, default, k, tile, r, 1, task_offset=s_ * Tl)

            k1_ms = cuda_ms(torch, k1_shards, 2)
            k1_plain_ms = cuda_ms(torch, k1_shards_plain, 1)
            feas = sum(int(compat_mask(ep, slice_requirements(er, t0, tile)).sum())
                       for t0 in range(0, N, tile))
            k1_row = row("candidates_sharded", SRC_K1, "protocol_tpu/parallel/sparse.py:533",
                         0.0, k1_ms, k1_plain_ms,
                         MESH_D * N * p_row + N * r_row + N * k * 8 + N * (N // tile + r * MESH_D) * 8,
                         N * N * OPS_PER_CELL + feas * OPS_PER_FEASIBLE_CELL)
            k1_row.update(runs=("mesh_arena", "mesh_matcher"), launches_timed=MESH_D,
                          note=f"K1's fused launch over {MESH_D} shards of {Tl} tasks at "
                               f"their offsets ({MESH_D} launches), four shards on one "
                               f"card; launches: K1's launches inside the sharded pass only")
            rows_out.append(k1_row)

            # K3 at shard 3's offset, on the chain's call
            k3 = [c for c in calls["repair_enter"] if c[1].get("offset") == MESH_SHARD_OFFSET]
            if not k3:
                raise AssertionError(f"no K3 launch at offset {MESH_SHARD_OFFSET} in the chain")
            (en_ep, en_er, _, en_ids, en_th), en_kw, _ = k3[0]
            err = 0.0
            for w in (zero_prox, default):
                got = kernels.repair_enter(en_ep, en_er, w, en_ids, en_th, **en_kw)
                ref = ps._enter_plain(en_ep, en_er, w, en_ids.long(), en_th,
                                      en_kw["offset"])
                torch.cuda.synchronize()
                if not bool(torch.equal(got, ref)):
                    raise AssertionError(f"K3 at offset {MESH_SHARD_OFFSET} (proximity "
                                         f"{w.proximity}): not identical to its plain version")
            print(f"K3 at offset {MESH_SHARD_OFFSET}: {en_ids.numel()} dirty providers x "
                  f"{en_er.num} tasks, identical to its plain version", flush=True)
            ms = cuda_ms(torch, lambda: kernels.repair_enter(en_ep, en_er, default, en_ids, en_th,
                                                             **en_kw), 5)
            plain = cuda_ms(torch, lambda: ps._enter_plain(en_ep, en_er, default, en_ids.long(),
                                                           en_th, en_kw["offset"]), 1)
            feas = feasible_cells(torch, compat_mask, gather_providers, gather_requirements,
                                  en_ep, en_er, p_ids=en_ids.long())
            k3_row = row("repair_enter_sharded", SRC_K1, "protocol_tpu/parallel/sparse.py:740",
                         err, ms, plain, en_ids.numel() * (p_row + 4) + en_er.num * (r_row + 5),
                         en_ids.numel() * en_er.num * OPS_PER_CELL + feas * OPS_PER_FEASIBLE_CELL)
            k3_row.update(counter="repair_enter", runs=("mesh_arena",),
                          note=f"one shard: {en_ids.numel()} providers x {en_er.num} tasks at "
                               f"offset {MESH_SHARD_OFFSET}")
            rows_out.append(k3_row)

            # K5 at 4 and 8 lanes, on the chain's pools
            lanes = [c for c in calls["repair_refold"] if c[1].get("d_fold") == MESH_D]
            if not lanes:
                raise AssertionError(f"the chain's refold never ran at {MESH_D} lanes")
            (rf_pt, rf_pc, rf_r), rf_kw, _ = lanes[0]
            for d in (4, 8):
                got = kernels.repair_refold(rf_pt, rf_pc, rf_r, d_fold=d)
                ref = ps._refold_plain(rf_pt, rf_pc, rf_r, 1, d)
                torch.cuda.synchronize()
                if not all(bits_equal(torch, a, b) for a, b in zip(got, ref)):
                    raise AssertionError(f"K5 at {d} lanes: not bit-identical to its plain version")
            print("K5 at 4 and 8 lanes: bit-identical to its plain version", flush=True)
            def k5_lanes():
                return kernels.repair_refold(rf_pt, rf_pc, rf_r, d_fold=MESH_D)

            ms = cuda_ms(torch, k5_lanes, 10)
            plain = cuda_ms(torch, lambda: ps._refold_plain(rf_pt, rf_pc, rf_r, 1, MESH_D), 1)
            n_tiles_rf = rf_pc.shape[1]
            k5_row = row("repair_refold_lanes", SRC_REPAIR, "protocol_tpu/parallel/sparse.py:835",
                         0.0, ms, plain, N * n_tiles_rf * 8 + N * rf_r * 8,
                         N * (n_tiles_rf + MESH_D * rf_r) * rf_r)
            k5_row.update(counter="repair_refold", runs=("mesh_arena",),
                          launch_ms=launch_ms(torch, kernels, k5_lanes, 50),
                          library_ms=cuda_ms(torch, lambda: torch.sort(rf_pc, dim=1, stable=True),
                                             10),
                          library_call="torch.sort(pool_c, dim=1, stable=True)",
                          sha256=sha16(torch, *k5_lanes()),
                          note=f"{N} providers x {n_tiles_rf} tiles in {MESH_D} lanes")
            rows_out.append(k5_row)

            # K16: one 256-round segment of the sharded scaled ladder (its
            # first phase, eps 4.0) at D = 4, the whole state compared, by
            # the segment launch and by the three launches a round (forced)
            T = N
            B = min(4096, T // MESH_D)
            zeros = (torch.zeros(N, device=dev), torch.full((N,), -1, dtype=torch.int32, device=dev),
                     torch.full((T,), -1, dtype=torch.int32, device=dev),
                     torch.zeros(T, dtype=torch.bool, device=dev))

            def shards():
                return ps._make_shards(mesh, cand_p, cand_c, True, *zeros, B)

            if ps.segment_route(mesh.devices, Tl, cand_c.shape[1], B) != "segment":
                raise AssertionError("K16: the mesh of views does not take the segment launch")
            ref_sh = shards()
            out_p = ps._segment(mesh, *ref_sh, T, 4.0, B, 256, 0, "plain")
            fields = ("price", "owner", "p4t", "retired", "ctl", "win_key", "win_task")
            k16_ms, k16_launches = {}, {}
            for route, keys in (("segment", K16), ("rounds", K16_ROUNDS)):
                got_sh = shards()
                out_k = ps._segment(mesh, *got_sh, T, 4.0, B, 256, 0, route)
                torch.cuda.synchronize()
                bad = [n for n in fields
                       if not bits_equal(torch, getattr(got_sh[1], n), getattr(ref_sh[1], n))]
                rows_k16 = int(got_sh[1].ctl[:, kernels.CTL_ROWS].sum())
                # the data the segment launch must write: each provider
                # seated at least once (its price moved off the start's
                # 0), each row assigned or retired at the end
                seated = int((got_sh[1].price[0] != 0).sum())
                assigned_k16 = int((got_sh[1].p4t >= 0).sum())
                retired_k16 = int(got_sh[1].retired.sum())
                print(f"K16 one segment at D={MESH_D}, {route} route: (it, stall, open) kernel "
                      f"{out_k} plain {out_p}; frontier rows {rows_k16}, assigned "
                      f"{assigned_k16}, seated providers {seated}; differing {bad}", flush=True)
                if bad or out_k != out_p:
                    raise AssertionError(f"K16 ({route} route): the segment differs from the "
                                         f"plain rounds: {bad}")
                seg = []
                for _ in range(3):
                    sh = shards()
                    torch.cuda.synchronize()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    before = sum(kernels.LAUNCHES[k_] for k_ in keys)
                    start.record()
                    ps._segment(mesh, *sh, T, 4.0, B, 256, 0, route)
                    end.record()
                    torch.cuda.synchronize()
                    seg.append(start.elapsed_time(end))
                    k16_launches[route] = sum(kernels.LAUNCHES[k_] for k_ in keys) - before
                k16_ms[route] = sum(seg) / len(seg)
            sh = shards()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ps._segment(mesh, *sh, T, 4.0, B, 256, 0, "plain")
            torch.cuda.synchronize()
            k16_plain_ms = (time.perf_counter() - t0) * 1e3
            K = cand_c.shape[1]
            rounds = out_p[0]
            # the bytes each route moves: both read the candidate arrays
            # and gather the frontier rows' candidates and prices; the three
            # launches also scan each shard's rows and reset and combine
            # the [P] key, winner, price and owner arrays of every shard
            # every round, where the segment launch reads the rows' state
            # once and writes the D replicas only at a seat
            frontier_bytes = N * K * 8 + rows_k16 * (K * 12 + 16)
            k16_bytes = frontier_bytes + MESH_D * rounds * (Tl * 6 + N * 24)
            seg_bytes = (frontier_bytes + T * 6 + seated * MESH_D * 8 + assigned_k16 * 4
                         + retired_k16)
            what = (f"one 256-round segment ({rounds} live rounds) at eps 4.0, B {B}, over "
                    f"{MESH_D} shards on one card; ms the mean of 3 (CUDA events), plain ms "
                    f"host clock")
            k16_row = row("mesh_segment", SRC_K16, "protocol_tpu/parallel/sparse.py:81",
                          0.0, k16_ms["segment"], k16_plain_ms, seg_bytes, rows_k16 * K * 3)
            k16_row.update(counter=K16, runs=("mesh_matcher",),
                           launches_timed=k16_launches["segment"],
                           rounds_ms=k16_ms["rounds"],
                           note=f"{what}; the segment launch (K2's cluster kernel over the "
                                f"shards), rounds_ms the three launches a round")
            rows_out.append(k16_row)
            k16r_row = row("mesh_auction_round", SRC_K16_ROUNDS,
                           "protocol_tpu/parallel/sparse.py:81", 0.0, k16_ms["rounds"],
                           k16_plain_ms, k16_bytes, rows_k16 * K * 3)
            k16r_row.update(counter=K16_ROUNDS, runs=("mesh_matcher",),
                            launches_timed=k16_launches["rounds"],
                            note=f"{what}; three launches a shard a round, the route of "
                                 f"shards on several cards (no launch on one card)")
            rows_out.append(k16r_row)
            print(f"K16 segment: {k16_ms['segment']:.3f} ms by the segment launch "
                  f"({k16_launches['segment']} launches), {k16_ms['rounds']:.3f} ms by the "
                  f"three-launch rounds ({k16_launches['rounds']} launches), plain "
                  f"{k16_plain_ms:.1f} ms; bound {k16_row['bound_ms']:.4f} ms by the segment "
                  f"launch's {seg_bytes} bytes, {k16r_row['bound_ms']:.4f} ms by the three "
                  f"launches' {k16_bytes}", flush=True)
    finally:
        counting.__exit__(None, None, None)
        platform.force_virtual_devices(prev, torch.device(dev).type)
    return rows_out, {"mesh_arena": launches_arena, "mesh_matcher": launches_matcher}, in_place


# the provider-sharded dense auction (B9 dense) at D = 4 views of the card
MESH_DENSE_N = 32_768  # P = T: the f32 cost is 64 x the dense route's 2^24-cell budget
MESH_DENSE_SMALL = 4_096  # K17 against its plain rounds
MESH_DENSE_EPS, MESH_DENSE_ITERS = 0.05, 500  # dryrun_multichip's dense path
K17 = ("mesh_dense_scan", "mesh_dense_combine", "mesh_dense_resolve", "mesh_dense_apply",
       "mesh_dense_finish")
SRC_K17 = "protocol_tpu_torch/csrc/mesh_dense.cu"
# the provider-sharded blocked Sinkhorn (B9 Sinkhorn) on stage S's instance
MESH_SINKHORN_KERNELS = ("blocked_feasibility", "blocked_row_lse", "blocked_col_partial")
STAGE_S_BAR_PCT = 2.0  # stage S's mean-cost bar against the referee (SCALING.md:75)


def mesh_dense_cost(torch, n: int, seed: int):
    """The jittered cost [n, n] of the synthetic marketplace (what
    _solve_bounded feeds assign_auction), built shard by shard on the card:
    cost_matrix over each shard's provider rows plus the tie jitter keyed
    on the global ids."""
    import numpy as np

    from protocol_tpu_torch.ops.cost import INFEASIBLE, CostWeights, cost_matrix, tie_jitter_ids
    from protocol_tpu_torch.ops.encoding import (
        gather_providers,
        providers_from_numpy,
        requirements_from_numpy,
    )
    from protocol_tpu_torch.trace.synth import synth_provider_arrays, synth_requirement_arrays

    ep = providers_from_numpy(synth_provider_arrays(np.random.default_rng(seed), n), DEVICE)
    er = requirements_from_numpy(synth_requirement_arrays(np.random.default_rng(seed + 1), n),
                                 DEVICE)
    pl = n // MESH_D
    t_ids = torch.arange(n, device=DEVICE)
    cost = torch.empty((n, n), dtype=torch.float32, device=DEVICE)
    for s in range(MESH_D):
        p_ids = torch.arange(s * pl, (s + 1) * pl, device=DEVICE)
        c, _ = cost_matrix(gather_providers(ep, p_ids), er, CostWeights())
        cost[s * pl:(s + 1) * pl] = torch.where(c < INFEASIBLE * 0.5,
                                                c + tie_jitter_ids(p_ids, t_ids), c)
        del c
    return cost


def run_mesh_dense(torch, kernels) -> tuple[list, dict]:
    """The provider-sharded dense auction (parallel/auction.py) at D = 4
    views of the card: K17 against its plain rounds at MESH_DENSE_SMALL^2
    (every state array, bit for bit); then, with the counts set to 0 just
    before, assign_auction_sharded at MESH_DENSE_N^2 (eps 0.05, 500
    rounds), whose matching must be injective, pair only feasible cells
    and equal K7's one-device assign_auction on the same cost bit for bit;
    then K17's timed rounds on that cost against the plain rounds timed
    beside them, every state array bit for bit. Returns (the K17 row, {"mesh_dense": launches}); raises on any failed
    check."""
    from protocol_tpu_torch.ops.assign import assign_auction
    from protocol_tpu_torch.ops.cost import INFEASIBLE
    from protocol_tpu_torch.parallel import assign_auction_sharded
    from protocol_tpu_torch.parallel import auction as pa
    from protocol_tpu_torch.parallel.mesh import make_mesh
    from protocol_tpu_torch.utils import platform

    eps, iters = MESH_DENSE_EPS, MESH_DENSE_ITERS
    prev = platform.force_virtual_devices(MESH_D, torch.device(DEVICE).type)
    try:
        mesh = make_mesh(MESH_D, DEVICE)

        # ---- K17 against its plain rounds (uncounted)
        with uncounted(kernels):
            small = mesh_dense_cost(torch, MESH_DENSE_SMALL, SEED + 70)
            got, ref = pa._make_shards(mesh, small), pa._make_shards(mesh, small)
            p_k, c_k = pa._rounds(mesh, *got, eps, iters)
            p_p, c_p = pa._rounds(mesh, *ref, eps, iters, plain=True)
            torch.cuda.synchronize()
        bad = [n for n, a, b in (("p4t", p_k, p_p), ("ctl", c_k, c_p))
               if not bits_equal(torch, a, b)]
        bad += [n for n in ("price", "owner", "win_key")
                if not bits_equal(torch, getattr(got[1], n), getattr(ref[1], n))]
        print(f"K17 at {MESH_DENSE_SMALL}^2, D={MESH_D}: (rounds, go, open, open rows) kernel "
              f"{c_k.tolist()} plain {c_p.tolist()}; differing {bad}", flush=True)
        if bad:
            raise AssertionError(f"K17: the rounds differ from the plain rounds: {bad}")
        del got, ref, small

        # ---- the main path, the counts set to 0 just before
        n = MESH_DENSE_N
        cost = mesh_dense_cost(torch, n, SEED + 72)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = assign_auction_sharded(cost, mesh, eps=eps, max_iters=iters)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches = dict(kernels.LAUNCHES)
        print(f"kernels (mesh dense): {json.dumps(launches)}", flush=True)
        missing = [k_ for k_ in K17 if launches[k_] == 0]
        if missing:
            raise AssertionError(f"the sharded dense auction launched no {missing}")
        p4t = res.provider_for_task
        seated = torch.nonzero(p4t >= 0).flatten()
        pos = p4t[seated].long()
        injective = torch.unique(pos).numel() == pos.numel()
        feasible = bool((cost[pos, seated] < INFEASIBLE * 0.5).all())
        with uncounted(kernels):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one = assign_auction(cost, eps=eps, max_iters=iters)
            torch.cuda.synchronize()
            one_wall = (time.perf_counter() - t0) * 1e3
            same = bits_equal(torch, p4t, one.provider_for_task)
            shards = pa._make_shards(mesh, cost)
            _, ctl = pa._rounds(mesh, *shards, eps, iters)
            rounds, _, n_open, open_rows = ctl.tolist()
        print(f"mesh dense at {n}x{n}, D={MESH_D} (four shards on one card), eps {eps}: "
              f"{rounds} rounds, {seated.numel()} assigned, {n_open} feasible rows open, "
              f"{open_rows} open rows summed over the rounds; injective {injective}, pairs "
              f"feasible {feasible}, equal to K7 bit for bit {same}; wall {wall:.1f} ms "
              f"(K7 one device {one_wall:.1f} ms)", flush=True)
        if not (injective and feasible and same):
            raise AssertionError("the sharded dense auction's matching is wrong or differs "
                                 "from K7's")
        del one, res

        # ---- times on that cost (uncounted): K17's rounds, their plain
        # version, K7 on one device; the last timed K17 run held against
        # the plain run bit for bit (every state array), at the main path's
        # shapes
        with uncounted(kernels):
            seg = []
            for _ in range(2):
                got = pa._make_shards(mesh, cost)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                before = sum(kernels.LAUNCHES[k_] for k_ in K17)
                start.record()
                p_k, c_k = pa._rounds(mesh, *got, eps, iters)
                end.record()
                torch.cuda.synchronize()
                seg.append(start.elapsed_time(end))
                run_launches = sum(kernels.LAUNCHES[k_] for k_ in K17) - before
            ref = pa._make_shards(mesh, cost)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p_p, c_p = pa._rounds(mesh, *ref, eps, iters, plain=True)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            bad = [n_ for n_, a, b in (("p4t", p_k, p_p), ("ctl", c_k, c_p))
                   if not bits_equal(torch, a, b)]
            bad += [n_ for n_ in ("price", "owner", "win_key")
                    if not bits_equal(torch, getattr(got[1], n_), getattr(ref[1], n_))]
            print(f"K17 at {n}^2, D={MESH_D}: (rounds, go, open, open rows) kernel "
                  f"{c_k.tolist()} plain {c_p.tolist()}; differing {bad}", flush=True)
            if bad:
                raise AssertionError(f"K17 at {n}^2: the rounds differ from the plain rounds: "
                                     f"{bad}")
            del got, ref
            k7_ms = cuda_ms(torch, lambda: assign_auction(cost, eps=eps, max_iters=iters), 2)
        # the scan reads each open task's value row of every shard (open
        # rows x P x 4 bytes over the run); the combine reads the D scan
        # buffers and the finish the D deltas and p4t, once a round
        k17_bytes = open_rows * n * 4 + rounds * (MESH_D * 5 * 4 * n + 8 * n)
        k17_row = row("mesh_dense_round", SRC_K17, "protocol_tpu/parallel/auction.py:38", 0.0,
                      sum(seg) / len(seg), plain_ms, k17_bytes, open_rows * n * 2)
        k17_row.update(counter=K17, runs=("mesh_dense",), launches_timed=run_launches,
                       one_device_k7_ms=k7_ms,
                       note=f"the whole run at {n}x{n}: {rounds} rounds of {3 * MESH_D + 2} "
                            f"launches, {open_rows} open rows, over {MESH_D} shards on one "
                            f"card; ms the mean of {len(seg)} (CUDA events), plain ms host "
                            f"clock; K7 on one device beside it")
        print(f"K17 at {n}x{n}: {k17_row['ms']:.3f} ms, plain {plain_ms:.1f} ms, K7 one device "
              f"{k7_ms:.3f} ms, bound {k17_row['bound_ms']:.3f} ms", flush=True)
        del cost
    finally:
        platform.force_virtual_devices(prev, torch.device(DEVICE).type)
    return [k17_row], {"mesh_dense": launches}


def run_mesh_sinkhorn(torch, kernels, reference: dict) -> tuple[list, dict]:
    """The provider-sharded blocked Sinkhorn (parallel/sinkhorn.py) at D = 4
    views of the card: K14's partial column mode against its plain
    per-shard version at STAGE_S_SMALL (empty columns exact, the logsumexp
    within BLOCKED_ATOL); then, with the counts set to 0 just before,
    stage S's instance (``reference``, from run_stage_s) at STAGE_S: the
    sharded potentials within BLOCKED_ATOL of the one-device ones with equal
    masks, and the plan-guided rounding from the sharded u within stage S's
    2% mean-cost bar of the referee. Returns (the partial mode's row,
    {"mesh_sinkhorn": launches}); raises on any failed check."""
    import numpy as np

    from protocol_tpu_torch import stage_s
    from protocol_tpu_torch.ops import blocked as bl
    from protocol_tpu_torch.ops.encoding import compat_mask, slice_requirements
    from protocol_tpu_torch.parallel import sinkhorn as psk
    from protocol_tpu_torch.parallel.mesh import make_mesh
    from protocol_tpu_torch.trace.synth import synth_providers, synth_requirements
    from protocol_tpu_torch.utils import platform

    eps = stage_s.EPS
    w = reference["weights"]
    prev = platform.force_virtual_devices(MESH_D, torch.device(DEVICE).type)
    try:
        mesh = make_mesh(MESH_D, DEVICE)

        def partial_err(ep_l, er_l, u_l, bits_l, starts, tile, label):
            """The partial mode against its plain version on one shard's
            bitmaps: the empty columns exactly, m + log(s) within
            BLOCKED_ATOL."""
            m, sm = kernels.blocked_col_partial(ep_l, er_l, w, eps, u_l, bits_l)
            pm_, ps_ = psk._col_partial_plain(
                bl.make_k_block_bits(ep_l, er_l, w, eps, tile, bits_l, "cols"), u_l, starts)
            torch.cuda.synchronize()
            empty = torch.isneginf(pm_)
            if not (torch.equal(torch.isneginf(m), empty) and bool((sm[empty] == 0).all())):
                raise AssertionError(f"K14 partial, {label}: the empty columns differ")
            d = (m + torch.log(torch.clamp(sm, min=1e-30))
                 - pm_ - torch.log(torch.clamp(ps_, min=1e-30)))
            err_ = finite_err(torch, d, 0.0, ~empty)
            if err_ > BLOCKED_ATOL:
                raise AssertionError(f"K14 partial, {label}: lse error {err_} > {BLOCKED_ATOL}")
            return err_

        # ---- the partial mode against its plain per-shard version (uncounted)
        n, tile, _ = STAGE_S_SMALL
        rng = np.random.default_rng(42)
        ep_s = synth_providers(rng, n, device=DEVICE)
        er_s = synth_requirements(rng, n, device=DEVICE)
        pl = n // MESH_D
        with uncounted(kernels):
            row_any = kernels.blocked_feasibility(ep_s, er_s, w)[0]
            u = torch.from_numpy(np.random.default_rng(1).normal(0, 3, n).astype(np.float32))
            u = torch.where(row_any, u.to(DEVICE), -1e18)
            err = max(partial_err(ep_l, er_s, u[s_ * pl:(s_ + 1) * pl],
                                  kernels.blocked_feasibility(ep_l, er_s, w)[2],
                                  range(0, n, tile), tile, f"shard {s_} at {n}x{n}")
                      for s_, ep_l in enumerate(psk._shard_providers(ep_s, mesh)))
        print(f"K14 partial at {n}x{n}, {MESH_D} shards: empty columns equal, lse max_abs_err "
              f"{err} (tolerance {BLOCKED_ATOL})", flush=True)
        del ep_s, er_s

        # ---- the main path on stage S's instance, the counts set to 0 just before
        size, tile, iters = STAGE_S
        ep, er, u1, v1 = reference["ep"], reference["er"], reference["u"], reference["v"]
        torch.cuda.synchronize()
        kernels.reset_launches()
        recorded, originals = record_first_calls(kernels, {
            "blocked_feasibility": (), "blocked_row_lse": (), "blocked_col_partial": ()})
        kernels.time_in_place(True)
        t0 = time.perf_counter()
        u, v = psk.sinkhorn_potentials_sharded(ep, er, mesh, w, eps=eps, num_iters=iters,
                                               tile=tile)
        torch.cuda.synchronize()
        pot_s = time.perf_counter() - t0
        res = bl.plan_guided_rounding(ep, er, u, w, eps=eps, tile=tile, k=32)
        q = stage_s.quality(ep, er, res.provider_for_task, w)
        wall = time.perf_counter() - t0
        for name, fn in originals.items():
            setattr(kernels, name, fn)
        launches = dict(kernels.LAUNCHES)
        mesh_in_place = in_place_run(kernels, launches, "mesh sinkhorn")
        print(f"kernels (mesh sinkhorn): {json.dumps(launches)}", flush=True)
        missing = [k_ for k_ in MESH_SINKHORN_KERNELS if launches[k_] == 0]
        if missing:
            raise AssertionError(f"the sharded Sinkhorn launched no {missing}")
        diff = {}
        for name, g, o in (("u", u, u1), ("v", v, v1)):
            keep = o > -5e17
            if not torch.equal(g > -5e17, keep) or not bool((g[~keep] == o[~keep]).all()):
                raise AssertionError(f"mesh sinkhorn: the {name} mask differs from one device's")
            diff[name] = finite_err(torch, g, o, keep)
        referee = reference["referee_mean_cost"]
        delta = 100.0 * (q["mean_cost"] - referee) / referee
        print(f"mesh sinkhorn at {size}x{size}, D={MESH_D} (four shards on one card; tile "
              f"{tile}, {iters} iterations): potentials {pot_s:.3f} s, with the rounding "
              f"{wall:.3f} s; against one device: masks equal, max_abs_err {json.dumps(diff)} "
              f"(tolerance {BLOCKED_ATOL}); rounding from the sharded u: {json.dumps(q)}, mean "
              f"cost {delta:+.3f}% against the referee's {referee} (one device's rounding "
              f"{reference['sinkhorn_mean_cost']})", flush=True)
        if max(diff.values()) > BLOCKED_ATOL:
            raise AssertionError(f"mesh sinkhorn: the potentials differ from one device's by "
                                 f"{diff} > {BLOCKED_ATOL}")
        if not q["injective"] or q["infeasible_pairs"] or delta > STAGE_S_BAR_PCT:
            raise AssertionError(f"mesh sinkhorn: the rounding fails stage S's bar: {q}, "
                                 f"{delta:+.3f}%")
        del res

        # ---- K14's three launches at one shard's shape, on their first
        # calls' arguments (shard 0): the checks, their times, the plain
        # versions' and the library passes'
        (p_ep, p_er, p_w, p_eps, p_u, p_bits), _ = recorded["blocked_col_partial"]
        (r_ep, r_er, r_w, r_eps, r_v, r_bits), _ = recorded["blocked_row_lse"]
        (f_ep, f_er, f_w), _ = recorded["blocked_feasibility"]
        k_block = bl.make_k_block(p_ep, p_er, p_w, p_eps, tile)
        kb_cols = bl.make_k_block_bits(p_ep, p_er, p_w, p_eps, tile, p_bits, "cols")
        kb_rows = bl.make_k_block_bits(r_ep, r_er, r_w, r_eps, tile, r_bits, "rows")
        starts = range(0, size, tile)
        pl = p_ep.num
        n_tiles = size // tile
        with uncounted(kernels):
            full_err = partial_err(p_ep, p_er, p_u, p_bits, starts, tile,
                                   f"shard 0 at {size}x{size}")
            f_row, f_col, f_bits = kernels.blocked_feasibility(f_ep, f_er, f_w)
            pf_row, pf_col = bl.feasibility_scan(k_block, pl, starts)
            got_r = kernels.blocked_row_lse(r_ep, r_er, r_w, r_eps, r_v, r_bits)
            ref_r = bl.streaming_row_logsumexp(kb_rows, r_v, starts, pl, tile)
            torch.cuda.synchronize()
            if not (torch.equal(f_row, pf_row) and torch.equal(f_col, pf_col.reshape(size))):
                raise AssertionError("K14 feasibility on shard 0: the masks differ")
            check_bitmaps(torch, bl, f_bits, f_ep, f_er, f_w, f"shard 0, {pl}x{size}")
            del f_bits
            row_err = finite_err(torch, got_r, ref_r, f_row)
            if row_err > BLOCKED_ATOL:
                raise AssertionError(f"K14 row pass on shard 0: lse error {row_err}")
            del got_r, ref_r
            ms = cuda_ms(torch, lambda: kernels.blocked_col_partial(p_ep, p_er, p_w, p_eps, p_u,
                                                                     p_bits), 3)
            plain = cuda_ms(torch, lambda: psk._col_partial_plain(kb_cols, p_u, starts), 1)
            x = k_block(0) + p_u[:, None]
            lib_ms = cuda_ms(torch, lambda: [torch.logsumexp(x, dim=0) for _ in range(n_tiles)],
                             1)
            row_ms = cuda_ms(torch, lambda: kernels.blocked_row_lse(r_ep, r_er, r_w, r_eps, r_v,
                                                                     r_bits), 3)
            row_plain = cuda_ms(torch, lambda: bl.streaming_row_logsumexp(kb_rows, r_v, starts,
                                                                           pl, tile), 1)
            x = k_block(0) + r_v[None, :tile]
            row_lib = cuda_ms(torch, lambda: [torch.logsumexp(x, dim=1) for _ in range(n_tiles)],
                              1)
            del x
            feas_ms = cuda_ms(torch, lambda: kernels.blocked_feasibility(f_ep, f_er, f_w), 3)
            feas_plain = cuda_ms(torch, lambda: bl.feasibility_scan(k_block, pl, starts), 1)
        feasible, bracket_open = check_cells(torch, compat_mask, slice_requirements, f_ep, f_er,
                                             f_w, tile)
        cols_bytes = pl * row_bytes(p_ep) + size * row_bytes(p_er)
        ops_scan = pl * size * OPS_PER_CELL + feasible * OPS_PER_FEASIBLE_CELL
        ops_pass = feasible * (OPS_PER_FEASIBLE_CELL + 5)  # feasible cells only
        row_bits = 4 * pl * ((size + 31) // 32)  # the row-major bitmap a row pass reads
        col_bits = 4 * size * ((pl + 31) // 32)  # the column-major one the partial mode reads
        shard = f"one shard's launch ({pl} providers x {size} tasks, its first call)"
        part_row = row("blocked_col_partial", SRC_BLOCKED, "protocol_tpu/parallel/sinkhorn.py:42",
                       full_err, ms, plain, cols_bytes + pl * 4 + size * 8 + col_bits, ops_pass)
        row_row = row("blocked_row_lse_sharded", SRC_BLOCKED,
                      "protocol_tpu/parallel/sinkhorn.py:95", row_err, row_ms, row_plain,
                      cols_bytes + size * 4 + pl * 4 + row_bits, ops_pass)
        feas_row = row("blocked_feasibility_sharded", SRC_BLOCKED,
                       "protocol_tpu/parallel/sinkhorn.py:75", 0.0, feas_ms, feas_plain,
                       cols_bytes + pl + size // 8 + row_bits + col_bits, ops_scan)
        for r_, b_ in ((part_row, col_bits), (row_row, row_bits), (feas_row, row_bits + col_bits)):
            r_["bitmap_bytes"] = b_
        for r_, lib, what in ((part_row, lib_ms, "K + u, dim 0"), (row_row, row_lib, "K + v, dim 1")):
            r_["library_ms"] = lib
            r_["library_call"] = (f"{n_tiles} calls of torch.logsumexp over a materialised "
                                  f"[{pl}, {tile}] block of {what} (one shard), timed as one "
                                  f"pass (the nearest call: the block is not recomputed)")
        for r_, counter in ((row_row, "blocked_row_lse"), (feas_row, "blocked_feasibility")):
            r_.update(counter=counter, runs=("mesh_sinkhorn",))
        for r_, counter in ((part_row, "blocked_col_partial"), (row_row, "blocked_row_lse"),
                            (feas_row, "blocked_feasibility")):
            r_["in_place_ms_mesh_sinkhorn"] = mesh_in_place[counter]["ms"]
        check_floor(feas_row, pl * size, bracket_open,
                    cols_bytes + pl + size // 8 + row_bits + col_bits)
        for r_ in (part_row, row_row, feas_row):
            r_["note"] = (f"{shard}; the sharded potentials at {size}x{size}: {pot_s:.3f} s over "
                          f"{MESH_D} shards on one card")
        part_row["mesh_sinkhorn"] = {"potentials_s": pot_s, "wall_s": wall, "max_abs_err": diff,
                                     "rounding": q, "mean_cost_delta_pct": delta,
                                     "partial_small_err": err}
        print(f"K14 at {pl}x{size} (one shard): partial {ms:.3f} ms (plain {plain:.3f}, library "
              f"pass {lib_ms:.3f}, bound {part_row['bound_ms']:.3f}); row pass {row_ms:.3f} ms "
              f"(plain {row_plain:.3f}, library pass {row_lib:.3f}); feasibility {feas_ms:.3f} "
              f"ms (plain {feas_plain:.3f})", flush=True)
        del k_block, kb_cols, kb_rows
    finally:
        platform.force_virtual_devices(prev, torch.device(DEVICE).type)
    return [part_row, row_row, feas_row], {"mesh_sinkhorn": launches}


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device: this smoke run needs one card")
    try:
        import numpy as np

        from protocol_tpu_torch import kernels
        from protocol_tpu_torch.ops import sparse as sp
        from protocol_tpu_torch.ops.cost import CostWeights
        from protocol_tpu_torch.ops.encoding import compat_mask, slice_requirements
        from protocol_tpu_torch.parallel.torch_arena import TorchSolveArena
        from protocol_tpu_torch.trace.synth import synth_providers, synth_requirements
    except ImportError as e:
        return fail(f"the port is not importable here ({e}): run from a checkout")

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)
    dev = DEVICE

    # ---- build
    t0 = time.perf_counter()
    build_s = kernels.build()
    print(f"build: {build_s:.1f} s (wall {time.perf_counter() - t0:.1f} s)", flush=True)
    for name, log in kernels.BUILD_LOG.items():
        entry = ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else ""
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name} {entry}: {line.split(':', 1)[-1].strip()}", flush=True)
    k2_c = kernels.k2_cluster(torch.device(dev, torch.cuda.current_device()))
    print(f"K2: one cluster of {k2_c} blocks of 1,024 threads (cudaOccupancyMaxActiveClusters); "
          f"block 0 alone from {kernels.K2_ONE_BLOCK_OPEN} open tasks", flush=True)

    k, r, extra = 64, 8, 16
    ep = synth_providers(np.random.default_rng(2), N, device=dev)
    er = synth_requirements(np.random.default_rng(3), N, device=dev)
    tile = sp.pick_tile(N, cap=min(1024, max(1, N // 8)))
    zero_prox, default = CostWeights(proximity=0.0), CostWeights()

    # ---- K1 against its plain version: bit-identical without the
    # haversine term, within COST_TOL with it; at a second size too
    check_k1(torch, sp, ep, er, zero_prox, tile, k, r, True, f"{N}x{N} proximity=0")
    check_k1(torch, sp, ep, er, zero_prox, tile, k, r, True,
             f"{N}x{N} proximity=0 jitter offset {K1_OFFSET}", offset=K1_OFFSET)
    k1_default = check_k1(torch, sp, ep, er, default, tile, k, r, False, f"{N}x{N} default")
    p2, t2 = SECOND
    ep2 = synth_providers(np.random.default_rng(5), p2, device=dev)
    er2 = synth_requirements(np.random.default_rng(6), t2, device=dev)
    tile2 = sp.pick_tile(t2, cap=min(1024, max(1, t2 // 8)))
    check_k1(torch, sp, ep2, er2, zero_prox, tile2, k, r, True, f"{p2}x{t2} tile {tile2} proximity=0")
    check_k1(torch, sp, ep2, er2, default, tile2, k, r, False, f"{p2}x{t2} tile {tile2} default")
    del ep2, er2

    fwd_ms = cuda_ms(torch, lambda: sp.candidates_forward(ep, er, default, k, tile), 3)
    rev_ms = cuda_ms(torch, lambda: sp.candidates_reverse(ep, er, default, tile, r, 1), 3)
    # the same launches keyed on a jitter offset (the candidate cache's)
    fwd_off_ms = cuda_ms(torch, lambda: sp.candidates_forward(ep, er, default, k, tile,
                                                              task_offset=K1_OFFSET), 3)
    rev_off_ms = cuda_ms(torch, lambda: sp.candidates_reverse(ep, er, default, tile, r, 1,
                                                              task_offset=K1_OFFSET), 3)
    bidir_ms = cuda_ms(torch, lambda: sp.candidates_fused(ep, er, default, k, tile, r, 1), 3)
    bidir_off_ms = cuda_ms(torch, lambda: sp.candidates_fused(ep, er, default, k, tile, r, 1,
                                                              task_offset=K1_OFFSET), 3)
    print(f"K1 at {N}x{N}: forward {fwd_ms:.3f} ms, {fwd_off_ms:.3f} ms with a jitter offset; "
          f"reverse {rev_ms:.3f} ms, {rev_off_ms:.3f} ms with a jitter offset; fused "
          f"{bidir_ms:.3f} ms, {bidir_off_ms:.3f} ms with a jitter offset", flush=True)
    fwd_plain_ms = cuda_ms(torch, lambda: sp._forward_plain(ep, er, default, k, tile), 1)
    rev_plain_ms = cuda_ms(torch, lambda: sp._reverse_plain(ep, er, default, tile, r, 1), 1)
    bidir_plain_ms = cuda_ms(torch, lambda: sp._bidir_plain(ep, er, default, k, tile, r, 1), 1)
    feasible = sum(
        int(compat_mask(ep, slice_requirements(er, t, tile)).sum()) for t in range(0, N, tile)
    )
    cells = N * N
    k1_ops = cells * OPS_PER_CELL + feasible * OPS_PER_FEASIBLE_CELL
    p_bytes = sum(getattr(ep, f).element_size() * getattr(ep, f).numel() for f in ep.__dataclass_fields__)
    r_bytes = sum(getattr(er, f).element_size() * getattr(er, f).numel() for f in er.__dataclass_fields__)
    fwd_bytes = p_bytes + r_bytes + N * 4 + N * k * 8  # the task ids too
    n_tiles = N // tile
    rev_bytes = p_bytes + r_bytes + N * n_tiles * 8 + N * r * 8
    bidir_bytes = p_bytes + r_bytes + N * k * 8 + N * n_tiles * 8 + N * r * 8
    print(f"K1 cells {cells}, feasible {feasible} ({feasible / cells:.4f}), ops {k1_ops}", flush=True)

    # ---- K2 against its plain version, on the main path's candidate arrays
    fwd_p, fwd_c, rev_t, rev_c = sp.candidates_topk_reverse(ep, er, default, k=k, tile=tile,
                                                           reverse_r=r)
    cand_p, cand_c = sp.merge_reverse_candidates(fwd_p, fwd_c, rev_t, rev_c, extra=extra)
    cand_safe, value_base, feas, give_up = sp._phase_inputs(cand_p, cand_c, True)
    # the cold case (eps 4, B 4,096, from scratch) and the carried one (eps
    # 0.02, B 512, from the cold case's state), each held at every cluster
    # size K2 runs at here: 1, 8 and the default where the card fits them
    k2_cases = [(None, 4.0, 4096), ("carried", 0.02, 512)]
    k2_sizes = sorted({1, 8, k2_c})
    state0 = sp._initial_state(N, N, cand_c.device)
    carried = None
    for tag, eps, B in k2_cases:
        st = state0 if tag is None else carried
        ref, r_stall = sp._auction_rounds_plain(cand_safe, value_base, feas, give_up, st,
                                                N, eps, 256, B, 0)
        for c in k2_sizes:
            work: dict = {}
            got, g_stall = kernels.auction_phase(cand_safe, value_base, feas, give_up, st, P=N,
                                                 eps=eps, max_iters=256, B=B, stall_limit=0,
                                                 work_out=work, cluster=c)
            torch.cuda.synchronize()
            same = all(bits_equal(torch, a.to(b.dtype), b) for a, b in zip(got, ref))
            same &= int(g_stall) == int(r_stall)
            print(f"K2 eps={eps} B={B} ({tag or 'cold'}) cluster {c}: rounds {int(got[0])} "
                  f"stall {int(g_stall)} frontier rows {int(work['frontier_rows'])} assigned "
                  f"{int((got[3] >= 0).sum())} bit-identical {same}", flush=True)
            if not same:
                return fail(f"K2 eps={eps} cluster {c}: not bit-identical to the plain version")
        if tag is None:
            k2_rows = int(work["frontier_rows"])
            k2_rounds = int(got[0])
            cold_state = got
        else:
            k2_rows_512 = int(work["frontier_rows"])
            k2_rounds_512 = int(got[0])
        carried = got
    k2_ms = cuda_ms(torch, lambda: kernels.auction_phase(
        cand_safe, value_base, feas, give_up, state0, P=N, eps=4.0, max_iters=256, B=4096,
        stall_limit=0), 3)
    k2_ms_512 = cuda_ms(torch, lambda: kernels.auction_phase(
        cand_safe, value_base, feas, give_up, cold_state, P=N, eps=0.02, max_iters=256, B=512,
        stall_limit=0), 3)
    print(f"K2 timed (cluster of {k2_c}): B 4096 cold {k2_ms:.3f} ms ({k2_rounds} rounds, "
          f"{k2_ms * 1e3 / k2_rounds:.2f} us a round); B 512 carried {k2_ms_512:.3f} ms "
          f"({k2_rounds_512} rounds, {k2_ms_512 * 1e3 / k2_rounds_512:.2f} us a round)",
          flush=True)
    k2_plain_ms = cuda_ms(torch, lambda: sp._auction_rounds_plain(
        cand_safe, value_base, feas, give_up, state0, N, 4.0, 256, 4096, 0), 1)
    # K9 on a state with thousands of open tasks: the cold auction cut
    # after two rounds, its first 4,096 open tasks (the reference sweeps a
    # prefix of the open set too, flatnonzero(size=budget))
    cut, _ = kernels.auction_phase(cand_safe, value_base, feas, give_up, state0, P=N, eps=4.0,
                                   max_iters=2, B=4096, stall_limit=0)
    cut_owner, cut_p4t = cut[2], cut[3]
    cut_open = torch.nonzero(cut_p4t < 0).flatten()[:4096]
    k9_got = kernels.greedy_cleanup(cand_p, cand_c, cut_owner, cut_p4t, cut_open)
    k9_ref = sp._greedy_cleanup_plain(cand_p, cand_c, cut_owner, cut_p4t, cut_open)
    torch.cuda.synchronize()
    k9_seated = int((k9_got[cut_open] >= 0).sum())
    print(f"K9 on a cut auction: {cut_open.numel()} open tasks swept, {k9_seated} seated, "
          f"bit-identical {bits_equal(torch, k9_got, k9_ref.to(torch.int32))}", flush=True)
    if cut_open.numel() < K9_MIN_OPEN or not bits_equal(torch, k9_got, k9_ref.to(torch.int32)):
        return fail("K9 on a cut auction: too few open tasks or not bit-identical")
    k9_ms = cuda_ms(torch, lambda: kernels.greedy_cleanup(cand_p, cand_c, cut_owner, cut_p4t,
                                                          cut_open), 5)
    k9_plain_ms = cuda_ms(torch, lambda: sp._greedy_cleanup_plain(cand_p, cand_c, cut_owner,
                                                                  cut_p4t, cut_open), 1)
    k9_bytes = cut_open.numel() * (cand_c.shape[1] * 8 + 4 + 4) + N * 4 + N * 8
    del cut, cut_owner, cut_p4t, k9_got, k9_ref, cold_state, carried

    k9_row = row("greedy_cleanup", SRC_K9, "protocol_tpu/ops/sparse.py:545", 0.0, k9_ms,
                 k9_plain_ms, k9_bytes, 0)
    k9_row.update(ns_per_row=k9_ms * 1e6 / cut_open.numel(), open_rows=cut_open.numel())
    K = cand_c.shape[1]
    k2_bytes = N * K * 8 + N * 2 + N * 2 * 4 + N * 4 + 2 * (N * 2 * 4 + N * 4 + N)
    k2_ops = k2_rows * K * 3  # per candidate: subtract, compare, max
    del fwd_p, fwd_c, rev_t, rev_c, cand_safe, value_base, feas

    # ---- the card against the CPU on a small input (the CPU run is the
    # plain torch path the CPU tests hold against the reference)
    eps_small = synth_providers(np.random.default_rng(7), SMALL, device="cpu")
    ers_small = synth_requirements(np.random.default_rng(8), SMALL, device="cpu")
    a_gpu, a_cpu = TorchSolveArena(device=dev), TorchSolveArena(device="cpu")
    p_gpu = a_gpu.solve(eps_small, ers_small, zero_prox)
    p_cpu = a_cpu.solve(eps_small, ers_small, zero_prox)
    s_gpu, s_cpu = a_gpu.export_state(), a_cpu.export_state()
    same_small = bool(np.array_equal(p_gpu, p_cpu)) and all(
        np.array_equal(s_gpu[n], s_cpu[n])
        for n in ("cand_p", "cand_c", "fwd_p", "fwd_c", "pool_t", "pool_c", "price", "retired")
    )
    print(f"{SMALL}x{SMALL} card vs cpu (proximity=0): bit-identical {same_small}, "
          f"assigned {int((p_gpu >= 0).sum())}", flush=True)
    if not same_small:
        return fail("the card's cold tick differs from the CPU's on the small input")

    # ---- the main path: three cold ticks at full width
    arena = TorchSolveArena(device=dev, cold_every=0)
    torch.cuda.synchronize()
    kernels.reset_launches()
    kernels.time_in_place(True)
    k9_recorded, k9_originals = record_first_calls(kernels, {"greedy_cleanup": ()})
    ticks = []
    for i in range(3):
        t_tick = time.perf_counter()
        p4t = arena.solve(ep, er, default)
        wall = time.perf_counter() - t_tick
        st = arena.last_stats
        ticks.append(st)
        print(f"tick {i}: wall_ms {wall * 1e3:.1f} gen_ms {st['gen_ms']} solve_ms {st['solve_ms']} "
              f"eng_rounds_total {st.get('eng_rounds_total')} "
              f"assigned {st['assigned']}/{N} ({st['assigned'] / N:.6f}) "
              f"plan_cost {st.get('plan_cost')} gap_per_task {st.get('gap_per_task')}", flush=True)
    launches = dict(kernels.LAUNCHES)
    in_place = {"cold_ticks": in_place_run(kernels, launches, "cold ticks")}
    for name, fn in k9_originals.items():
        setattr(kernels, name, fn)
    print(f"kernels (cold ticks): {json.dumps(launches)}", flush=True)
    missing = [n for n in COLD_KERNELS if launches[n] == 0]
    if missing:
        return fail(f"the cold ticks launched no {missing}")

    # ---- the result is right: shape, range, a matching, finite duals
    price = arena.price
    if p4t.shape != (N,) or p4t.min() < -1 or p4t.max() >= N:
        return fail("provider_for_task has the wrong shape or range")
    seated = p4t[p4t >= 0]
    if np.unique(seated).size != seated.size:
        return fail("a provider holds two tasks")
    if not np.isfinite(price).all() or price.shape != (N,):
        return fail("prices are not finite")
    if ticks[-1]["assigned"] / N < 0.99:
        return fail(f"only {ticks[-1]['assigned']} of {N} tasks assigned")
    if len({t["assigned"] for t in ticks}) != 1 or len({t.get("plan_cost") for t in ticks}) != 1:
        return fail("three cold ticks on the same input disagree")
    del arena

    # ---- the main path, warm: one arena with the default cold_every
    from protocol_tpu_torch.ops.encoding import gather_providers, gather_requirements
    from protocol_tpu_torch.trace.synth import synth_provider_arrays, synth_requirement_arrays

    pa = synth_provider_arrays(np.random.default_rng(SEED), N)
    ra = synth_requirement_arrays(np.random.default_rng(SEED + 1), N)
    churn = np.random.default_rng(SEED + 1)
    n_churn = int(N * CHURN)

    # churn writes new column arrays: the arena keeps the arrays it was
    # given as its baseline, so an in-place edit would look byte-identical
    def req_churn():
        rows = churn.choice(N, n_churn, replace=False)
        ram = ra["ram_mb"].copy()
        ram[rows] = np.maximum(256, (ram[rows] * churn.uniform(0.8, 1.25, rows.size)).astype(np.int32))
        ra["ram_mb"] = ram

    def prov_churn():
        rows = churn.choice(N, n_churn, replace=False)
        price, load = pa["price"].copy(), pa["load"].copy()
        price[rows] = churn.uniform(0.5, 4.0, rows.size).astype(np.float32)
        load[rows] = churn.uniform(0, 1, rows.size).astype(np.float32)
        pa["price"], pa["load"] = price, load

    def ns(cols):
        return types.SimpleNamespace(**cols)

    # dual_refresh_every=4: the sixth tick (after four warm solves) takes
    # the dual refresh through the ladder
    warm = TorchSolveArena(device=dev, dual_refresh_every=4)

    def check_tick(label: str, p4t) -> None:
        """repaired == regen, reconcile == a fresh cold tick, seats, assigned."""
        st = warm.last_stats
        if label != "reconcile" and (st["cold"] or st["cand_cold_passes"] != 0):
            raise AssertionError(f"{label}: not a warm repair tick ({st['cand_cold_passes']} cold passes)")
        seated = p4t[p4t >= 0]
        if np.unique(seated).size != seated.size:
            raise AssertionError(f"{label}: a provider holds two tasks")
        if st["assigned"] / N < 0.99:
            raise AssertionError(f"{label}: only {st['assigned']} of {N} tasks assigned")
        with uncounted(kernels), kernels.untimed():
            fresh = TorchSolveArena(device=dev, cold_every=0)
            f_p4t = fresh.solve(ns(warm._p_fields), ns(warm._r_fields), default)
            for name in ("cand_p", "cand_c", "fwd_p", "fwd_c", "pool_t", "pool_c"):
                a, b = getattr(warm, f"_{name}"), getattr(fresh, f"_{name}")
                if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                    raise AssertionError(f"{label}: repaired {name} differs from a fresh cold pass")
            copy = TorchSolveArena(device=dev)
            copy.restore_state(None, None, warm.export_state())
            c_p4t = copy.reconcile()
            if not (np.array_equal(c_p4t, f_p4t) and copy.price.tobytes() == fresh.price.tobytes()):
                raise AssertionError(f"{label}: reconcile differs from a fresh arena's cold tick")
            del fresh, copy

    def warm_tick(label: str, step) -> dict:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p4t = step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        st = dict(warm.last_stats)
        print(f"warm {label}: wall_ms {wall:.1f} gen_ms {st.get('gen_ms')} "
              f"solve_ms {st.get('solve_ms')} repair_rows {st.get('repair_rows')} "
              f"repair_providers {st.get('repair_providers')} repair_blocks "
              f"{st.get('repair_blocks')} repair_enter_rows {st.get('repair_enter_rows')} "
              f"visited_cells_frac {st.get('visited_cells_frac')} changed_rows "
              f"{st.get('changed_rows')} eng_rounds_total {st.get('eng_rounds_total')} "
              f"dual_refresh {st.get('dual_refresh')} assigned {st['assigned']}/{N} "
              f"({st['assigned'] / N:.6f})", flush=True)
        if label == "prime" and not st["cold"]:
            raise AssertionError("the prime tick was not cold")
        if label != "prime":
            check_tick(label, p4t)
        return st

    def event():
        rows = np.sort(churn.choice(N, EVENT_ROWS, replace=False)).astype(np.int32)
        vals = {n: warm._p_fields[n][rows].copy() for n in warm._p_fields}
        vals["price"] = churn.uniform(0.5, 4.0, rows.size).astype(np.float32)
        return warm.apply_rows(rows, vals, None, None, default)

    def solve_req():
        req_churn()
        return warm.solve(ns(pa), ns(ra), default)

    def solve_prov():
        prov_churn()
        return warm.solve(ns(pa), ns(ra), default)

    refold_first_launch(torch, kernels)
    torch.cuda.synchronize()
    kernels.reset_launches()
    kernels.time_in_place(True)
    warm_ticks = [warm_tick("prime", lambda: warm.solve(ns(pa), ns(ra), default))]
    recorded, originals = record_first_calls(kernels)
    for i in range(3):
        warm_ticks.append(warm_tick(f"req-churn-{i}", solve_req))
    warm_ticks.append(warm_tick("prov-churn", solve_prov))
    warm_ticks.append(warm_tick("event", event))
    warm_ticks.append(warm_tick("dual-refresh", solve_req))
    warm_ticks.append(warm_tick("reconcile", warm.reconcile))
    for name, fn in originals.items():
        setattr(kernels, name, fn)
    launches_warm = dict(kernels.LAUNCHES)
    in_place["warm_chain"] = in_place_run(kernels, launches_warm, "warm chain")
    print(f"kernels (warm chain): {json.dumps(launches_warm)}", flush=True)
    missing = [n for n in WARM_KERNELS if launches_warm[n] == 0]
    if missing:
        return fail(f"the warm chain launched no {missing}")
    if not warm_ticks[-2].get("dual_refresh"):
        return fail("the dual-refresh tick did not take the dual refresh")
    del warm

    # ---- the warm chain's kernels against their plain versions, on the
    # arguments of their first call in the chain
    from protocol_tpu_torch.parallel import sparse as ps

    def args_of(name):
        args, kw = recorded[name]
        return list(args), kw

    new_rows = []
    row_extra: dict = {}  # more keys for a row of new_rows, by name
    p_row = row_bytes(ep)
    r_row = row_bytes(er)

    def cmp_cells(name, kernel_fn, plain_fn, out_names):
        """A cell kernel and its plain version: bit-identical at proximity 0
        on the same ids, cost error within COST_TOL at the chain's weights."""
        errs, same = [], True
        for w in (zero_prox, default):
            got, ref = kernel_fn(w), plain_fn(w)
            torch.cuda.synchronize()
            for on, a, b in zip(out_names, got, ref):
                eq = bits_equal(torch, a, b)
                if w is zero_prox and not eq:
                    raise AssertionError(f"{name}: {on} not bit-identical to the plain version")
                if w is default:
                    same &= eq
                    if a.dtype == torch.float32:
                        errs.append(float((a - b).abs().max()) if a.numel() else 0.0)
                    elif not eq:
                        print(f"{name}: {on} differs at default weights in "
                              f"{int((a != b).sum())} entries", flush=True)
        err = max(errs) if errs else 0.0
        print(f"{name}: bit-identical at proximity 0; at default weights bit-identical {same}, "
              f"max_abs_err {err}", flush=True)
        if err > COST_TOL:
            raise AssertionError(f"{name}: cost error {err} > {COST_TOL}")
        return err

    # K1 forward on the repair's dirty rows
    (fr_ep, fr_er, _, fr_k, fr_ids), _ = args_of("candidates_forward_rows")
    err = cmp_cells("candidates_forward_rows",
                    lambda w: kernels.candidates_forward_rows(fr_ep, fr_er, w, fr_k, fr_ids),
                    lambda w: ps._forward_rows_plain(fr_ep, fr_er, w, fr_k, fr_ids.long()),
                    ("p", "c"))
    ms = cuda_ms(torch, lambda: kernels.candidates_forward_rows(fr_ep, fr_er, default, fr_k, fr_ids), 3)
    ms_unsplit = cuda_ms(torch, lambda: kernels.candidates_forward_rows(
        fr_ep, fr_er, default, fr_k, fr_ids, rows_per_warp=8, split=1), 3)
    plain = cuda_ms(torch, lambda: ps._forward_rows_plain(fr_ep, fr_er, default, fr_k, fr_ids.long()), 1)
    R = fr_ids.numel()
    print(f"candidates_forward_rows: {R} rows in {ms:.3f} ms with the default layout "
          f"{kernels.k1_rows_layout(R)}, {ms_unsplit:.3f} ms at 8 rows a warp", flush=True)
    feas = feasible_cells(torch, compat_mask, gather_providers, gather_requirements, fr_ep, fr_er,
                          t_ids=fr_ids.long())
    fwd_repair = row("candidates_forward_rows", SRC_K1, "protocol_tpu/parallel/sparse.py:702",
                     err, ms, plain, N * p_row + R * (r_row + 4) + R * fr_k * 8,
                     R * N * OPS_PER_CELL + feas * OPS_PER_FEASIBLE_CELL)
    fwd_repair = {"rows": R, **{x: fwd_repair[x] for x in (
        "replaces", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")},
        "ms_unsplit": ms_unsplit}

    # K1 reverse, blocks variant (writes the pools in place: fresh copies per call)
    (rb_ep, rb_er, _, rb_tile, rb_p, rb_j, rb_pt, rb_pc), _ = args_of("candidates_reverse_blocks")

    def rb_kernel(w):
        out = (rb_pt.clone(), rb_pc.clone())
        kernels.candidates_reverse_blocks(rb_ep, rb_er, w, rb_tile, rb_p, rb_j, *out)
        return out

    def rb_plain(w):
        out = (rb_pt.clone(), rb_pc.clone())
        ps._reverse_blocks_plain(rb_ep, rb_er, w, rb_tile, 1, rb_p.long(), rb_j.long(), *out)
        return out

    err = cmp_cells("candidates_reverse_blocks", rb_kernel, rb_plain, ("pool_t", "pool_c"))
    scratch = (rb_pt.clone(), rb_pc.clone())
    ms = cuda_ms(torch, lambda: kernels.candidates_reverse_blocks(
        rb_ep, rb_er, default, rb_tile, rb_p, rb_j, *scratch), 3)
    plain = cuda_ms(torch, lambda: ps._reverse_blocks_plain(
        rb_ep, rb_er, default, rb_tile, 1, rb_p.long(), rb_j.long(), *scratch), 1)
    n_blk = rb_p.numel()
    feas = 0
    for j in torch.unique(rb_j).tolist():
        sj = rb_p[rb_j == j].long()
        feas += int(compat_mask(gather_providers(rb_ep, sj),
                                slice_requirements(rb_er, j * rb_tile, rb_tile)).sum())
    n_prov = int(torch.unique(rb_p).numel())
    n_tile_rows = int(torch.unique(rb_j).numel()) * rb_tile
    new_rows.append(("candidates_reverse_blocks", SRC_K1, "protocol_tpu/parallel/sparse.py:794",
                     err, ms, plain, n_prov * p_row + n_tile_rows * r_row + n_blk * 16,
                     n_blk * rb_tile * OPS_PER_CELL + feas * OPS_PER_FEASIBLE_CELL,
                     f"{n_blk} blocks x {rb_tile} tasks"))

    # K3 enter
    (en_ep, en_er, _, en_ids, en_th), _ = args_of("repair_enter")
    err = cmp_cells("repair_enter",
                    lambda w: (kernels.repair_enter(en_ep, en_er, w, en_ids, en_th),),
                    lambda w: (ps._enter_plain(en_ep, en_er, w, en_ids.long(), en_th),),
                    ("enter",))
    ms = cuda_ms(torch, lambda: kernels.repair_enter(en_ep, en_er, default, en_ids, en_th), 5)
    plain = cuda_ms(torch, lambda: ps._enter_plain(en_ep, en_er, default, en_ids.long(), en_th), 1)
    n_p = en_ids.numel()
    feas = feasible_cells(torch, compat_mask, gather_providers, gather_requirements, en_ep, en_er,
                          p_ids=en_ids.long())
    new_rows.append(("repair_enter", SRC_K1, "protocol_tpu/parallel/sparse.py:659", err, ms,
                     plain, n_p * (p_row + 4) + N * (r_row + 4 + 1),
                     n_p * N * OPS_PER_CELL + feas * OPS_PER_FEASIBLE_CELL,
                     f"{n_p} providers x {N} tasks"))

    # K4 tile minima (K1's list launch over the dirty ids)
    (tm_ep, tm_er, _, tm_ids, tm_tile, tm_pad), _ = args_of("repair_tile_min")
    err = cmp_cells("repair_tile_min",
                    lambda w: (kernels.repair_tile_min(tm_ep, tm_er, w, tm_ids, tm_tile, tm_pad),),
                    lambda w: (ps._tile_min_plain(tm_ep, tm_er, w, tm_ids.long(), tm_tile, tm_pad),),
                    ("min_tile",))
    ms = cuda_ms(torch, lambda: kernels.repair_tile_min(tm_ep, tm_er, default, tm_ids, tm_tile,
                                                        tm_pad), 5)
    plain = cuda_ms(torch, lambda: ps._tile_min_plain(tm_ep, tm_er, default, tm_ids.long(),
                                                      tm_tile, tm_pad), 1)
    n_t = tm_ids.numel()
    feas = feasible_cells(torch, compat_mask, gather_providers, gather_requirements, tm_ep, tm_er,
                          t_ids=tm_ids.long())
    new_rows.append(("repair_tile_min", SRC_K1, "protocol_tpu/parallel/sparse.py:702", err, ms,
                     plain, N * p_row + n_t * (r_row + 4) + N * (N // tm_tile) * 4,
                     N * n_t * OPS_PER_CELL + feas * OPS_PER_FEASIBLE_CELL,
                     f"{N} providers x {n_t} tasks"))

    # K5 refold: structure only, bit-identical; its library yardstick is
    # one stable sort of the pool costs, which orders each row's entries
    # as K5's selection does among the finite costs
    (rf_pt, rf_pc, rf_r), _ = args_of("repair_refold")
    got = kernels.repair_refold(rf_pt, rf_pc, rf_r)
    ref = ps._refold_plain(rf_pt, rf_pc, rf_r, 1)
    torch.cuda.synchronize()
    if not all(bits_equal(torch, a, b) for a, b in zip(got, ref)):
        return fail("repair_refold: not bit-identical to the plain version")
    print(f"repair_refold: bit-identical, sha256 {sha16(torch, *got)}", flush=True)
    ms = cuda_ms(torch, lambda: kernels.repair_refold(rf_pt, rf_pc, rf_r), 10)
    plain = cuda_ms(torch, lambda: ps._refold_plain(rf_pt, rf_pc, rf_r, 1), 1)
    n_tiles_rf = rf_pc.shape[1]
    row_extra["repair_refold"] = {
        "launch_ms": launch_ms(torch, kernels, lambda: kernels.repair_refold(rf_pt, rf_pc, rf_r),
                               50),
        "library_ms": cuda_ms(torch, lambda: torch.sort(rf_pc, dim=1, stable=True), 10),
        "library_call": "torch.sort(pool_c, dim=1, stable=True)",
        "lanes_a_provider": kernels.refold_group(n_tiles_rf),
    }
    new_rows.append(("repair_refold", SRC_REPAIR, "protocol_tpu/parallel/sparse.py:835", 0.0, ms,
                     plain, N * n_tiles_rf * 8 + N * rf_r * 8, N * n_tiles_rf * rf_r,
                     f"{N} providers x {n_tiles_rf} tiles"))

    # K2 from a carried state: the first launch of the first warm tick
    (a2, kw2) = args_of("auction_phase")
    w_work: dict = {}
    got, g_stall = kernels.auction_phase(*a2, **{**kw2, "work_out": w_work})
    ref, r_stall = sp._auction_rounds_plain(*a2[:5], kw2["P"], kw2["eps"], kw2["max_iters"],
                                            kw2["B"], kw2["stall_limit"])
    torch.cuda.synchronize()
    same = all(bits_equal(torch, a.to(b.dtype), b) for a, b in zip(got, ref))
    same &= int(g_stall) == int(r_stall)
    warm_price0 = a2[4][1]
    print(f"K2 warm (carried state, eps={kw2['eps']} B={kw2['B']}): rounds {int(got[0])} "
          f"frontier rows {int(w_work['frontier_rows'])} seeded {int((a2[4][3] >= 0).sum())} "
          f"min carried price {float(warm_price0.min()):.4f} bit-identical {same}", flush=True)
    if not same:
        return fail("K2 from the warm chain's carried state: not bit-identical to the plain version")

    # ---- K9 on the first call of the cold ticks
    k9_args, _ = k9_recorded["greedy_cleanup"]
    got = kernels.greedy_cleanup(*k9_args)
    ref = sp._greedy_cleanup_plain(*k9_args)
    torch.cuda.synchronize()
    print(f"K9 first cold-tick call: {k9_args[4].numel()} open tasks, "
          f"bit-identical {bits_equal(torch, got, ref.to(torch.int32))}", flush=True)
    if not bits_equal(torch, got, ref.to(torch.int32)):
        return fail("K9 on the cold tick's call: not bit-identical to the plain version")

    # ---- the batch matcher
    from protocol_tpu_torch.ops import assign as da
    from protocol_tpu_torch.ops.cost import cost_matrix, with_tie_jitter
    from protocol_tpu_torch.sched import torch_backend as tb

    m_default = CostWeights(priority=1.0)  # the matcher's default weights
    m_zero = CostWeights(priority=1.0, proximity=0.0)

    def refresh(matcher, store, label: str, kernel: str) -> dict:
        return refresh_matcher(torch, compat_mask, matcher, store, label, kernel)

    # the card against the CPU on a small pool (dense route on both)
    nodes, tasks = make_pool(np.random.default_rng(SEED + 10), *SMALL_POOL)
    small = mem_store(nodes, tasks)
    on_card = tb.TorchBatchMatcher(small, device=dev)
    on_cpu = tb.TorchBatchMatcher(small, device="cpu")
    on_card.refresh()
    on_cpu.refresh()
    same_small = on_card._assignment == on_cpu._assignment
    print(f"matcher {SMALL_POOL[0]} nodes x {SMALL_POOL[1] * SMALL_POOL[2]} slots, card vs cpu: "
          f"identical {same_small}, assigned {len(on_card._assignment)}", flush=True)
    if not same_small:
        return fail("the card's matcher differs from the CPU's on the small pool")
    del on_card, on_cpu, small

    # the dense route at its budget: two refreshes
    nodes, tasks = make_pool(np.random.default_rng(SEED + 20), *DENSE_POOL)
    rng = np.random.default_rng(SEED + 21)
    store = mem_store(nodes, tasks)
    dense = tb.TorchBatchMatcher(store, device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    kernels.time_in_place(True)
    d_recorded, d_originals = record_first_calls(
        kernels, {name: () for name in DENSE_KERNELS})
    dense_stats = [refresh(dense, store, "dense-0", "dense_auction")]
    churn_pool(rng, store, CHURN, replace_tasks=2)
    dense_stats.append(refresh(dense, store, "dense-1", "dense_auction"))
    for name, fn in d_originals.items():
        setattr(kernels, name, fn)
    launches_dense = dict(kernels.LAUNCHES)
    print(f"kernels (matcher, dense route): {json.dumps(launches_dense)}", flush=True)
    dense_in_place = in_place_run(kernels, launches_dense, "dense route")
    missing = [n for n in DENSE_KERNELS if launches_dense[n] == 0]
    if missing:
        return fail(f"the dense route launched no {missing}")

    # K6, K7 (fed K6's output) and K8 against their plain versions on the
    # first refresh's inputs, at proximity 0 and at the matcher's weights
    (ep6, er6, _), _ = d_recorded["dense_value_base"]
    (ep8, er8, _), _ = d_recorded["unbounded_best"]

    def plain_value_base(w):
        return da._value_base(with_tie_jitter(cost_matrix(ep6, er6, w)[0]))

    for w in (m_zero, m_default):
        vb, feas = kernels.dense_value_base(ep6, er6, w)
        pvb, pfeas = plain_value_base(w)
        work: dict = {}
        got = kernels.dense_auction(vb, feas, 0.05, 300, work)
        ref = da._auction_dense_plain(vb, feas, 0.05, 300)
        best = kernels.unbounded_best(ep8, er8, w)
        pbest = tb._solve_unbounded_plain(ep8, er8, w)
        torch.cuda.synchronize()
        checks = {
            "K6": bits_equal(torch, vb, pvb) and bool(torch.equal(feas, pfeas)),
            "K7": all(bits_equal(torch, a, b) for a, b in zip(got[:3], ref[:3]))
            and int(got[3]) == int(ref[3]) and int(work["open_rows"]) == ref[4],
            "K8": bits_equal(torch, best, pbest),
        }
        print(f"dense kernels (proximity {w.proximity}): bit-identical {json.dumps(checks)}; "
              f"K7 rounds {int(got[3])} open rows {int(work['open_rows'])} "
              f"seated {int((got[0] >= 0).sum())}/{int(feas.sum())} feasible slots", flush=True)
        if not all(checks.values()):
            return fail(f"dense kernels differ from their plain versions: {checks}")
    # K8 on the NaN edits' cells: a provider with a NaN cell gets -1, as the
    # plain argmin's first NaN fails its test
    n_ep8, n_er8 = nan_columns(torch, ep8, er8)
    for w in (m_zero, m_default):
        best = kernels.unbounded_best(n_ep8, n_er8, w)
        pbest = tb._solve_unbounded_plain(n_ep8, n_er8, w)
        nan_row = torch.isnan(cost_matrix(n_ep8, n_er8, w)[0]).any(dim=1)
        torch.cuda.synchronize()
        ok = bits_equal(torch, best, pbest) and bool((best[nan_row] == -1).all())
        print(f"K8 on NaN cells (proximity {w.proximity}): {int(nan_row.sum())} providers with a "
              f"NaN cell, {int((best >= 0).sum())} seated, bit-identical {ok}", flush=True)
        if not ok or not bool(nan_row.any()):
            return fail("K8 on NaN cells differs from its plain version")
    del n_ep8, n_er8
    k7_rounds, k7_open_rows = int(got[3]), int(work["open_rows"])
    k6_ms = cuda_ms(torch, lambda: kernels.dense_value_base(ep6, er6, m_default), 5)
    k6_plain_ms = cuda_ms(torch, lambda: plain_value_base(m_default), 3)
    k7_ms = cuda_ms(torch, lambda: kernels.dense_auction(vb, feas, 0.05, 300), 3)
    k7_plain_ms = cuda_ms(torch, lambda: da._auction_dense_plain(vb, feas, 0.05, 300), 1)
    k8_ms = cuda_ms(torch, lambda: kernels.unbounded_best(ep8, er8, m_default), 5)
    k8_launch_ms = launch_ms(torch, kernels, lambda: kernels.unbounded_best(ep8, er8, m_default),
                             50)
    k8_plain_ms = cuda_ms(torch, lambda: tb._solve_unbounded_plain(ep8, er8, m_default), 3)
    Pd, Td, Tu = ep6.num, er6.num, er8.num
    k6_feasible = int((vb > -5e17).sum())
    k6_bytes = Pd * row_bytes(ep6) + Td * row_bytes(er6) + Td * Pd * 4 + Td
    k6_ops = Pd * Td * OPS_PER_CELL + k6_feasible * OPS_PER_FEASIBLE_CELL
    k7_bytes = k7_open_rows * Pd * 4
    k7_ops = k7_open_rows * Pd * 3  # per cell: subtract, compare, max
    k8_feasible = int(compat_mask(ep8, er8).sum())
    k8_bytes = Pd * row_bytes(ep8) + Tu * row_bytes(er8) + Pd * 4
    k8_ops = Pd * Tu * OPS_PER_CELL + k8_feasible * OPS_PER_FEASIBLE_CELL
    print(f"dense route: {Pd} x {Td} cells ({k6_feasible} feasible), K8 {Pd} x {Tu} cells "
          f"({k8_feasible} feasible)", flush=True)
    del vb, feas, pvb, pfeas, got, ref, dense, store, d_recorded

    # the torch route at the one-chip rung: a cold refresh, then a warm one
    nodes, tasks = make_pool(np.random.default_rng(SEED + 30), *ARENA_POOL)
    rng = np.random.default_rng(SEED + 31)
    store = mem_store(nodes, tasks)
    arena_m = tb.TorchBatchMatcher(store, native_engine="torch", device=dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch_stats = [refresh(arena_m, store, "torch-cold", "torch_arena")]
    churn_pool(rng, store, CHURN, replace_tasks=0)
    torch_stats.append(refresh(arena_m, store, "torch-warm", "torch_arena"))
    launches_torch = dict(kernels.LAUNCHES)
    print(f"kernels (matcher, torch route): {json.dumps(launches_torch)}", flush=True)
    missing = [n for n in COLD_KERNELS + ("unbounded_best",) if launches_torch[n] == 0]
    if missing:
        return fail(f"the torch route launched no {missing}")
    if not torch_stats[0]["arena_cold"] or torch_stats[1]["arena_cold"]:
        return fail("the torch route's refreshes were not cold then warm")
    del arena_m, store, nodes, tasks

    # ---- phases 0 and 0.5 (anti-affinity and colocation)
    phase_rows, phase_runs, phase_in_place = run_phases(torch, kernels, refresh)

    # ---- the default route above dense_cell_budget (the candidate cache)
    route_runs = run_default_route(torch, kernels, refresh)

    # ---- the scheduler backend's stateless RPCs
    backend_rows, backend_runs, backend_in_place = run_backend(torch, kernels)

    # ---- stage S: the blocked Sinkhorn at 100,000^2 (BASELINE ladder #3)
    stage_rows, stage_runs, stage_ref = run_stage_s(torch, kernels)

    # ---- the provider mesh: four views of the card
    mesh_rows, mesh_runs, mesh_in_place = run_mesh(torch, kernels, refresh)

    # ---- the provider-sharded dense auction and blocked Sinkhorn
    dense_rows, dense_runs = run_mesh_dense(torch, kernels)
    sink_rows, sink_runs = run_mesh_sinkhorn(torch, kernels, stage_ref)
    del stage_ref

    runs = {"cold_ticks": launches, "warm_chain": launches_warm,
            "matcher_dense": launches_dense, "matcher_torch": launches_torch, **phase_runs,
            **route_runs, **backend_runs, **stage_runs, **mesh_runs, **dense_runs, **sink_runs}

    # K1's forward launch timed over every task id; its call on the warm
    # repair's dirty rows rides along as "repair_call"
    fwd_row = row("candidates_forward_rows", SRC_K1, "protocol_tpu/ops/sparse.py:131",
                  k1_default["fwd_max_abs_err"], fwd_ms, fwd_plain_ms, fwd_bytes, k1_ops)
    fwd_row["repair_call"] = fwd_repair
    fwd_row["offset_ms"] = fwd_off_ms  # task_offset (B1o), held bit for bit above
    rev_row = row("candidates_reverse", SRC_K1, "protocol_tpu/ops/sparse.py:172",
                  k1_default["rev_max_abs_err"], rev_ms, rev_plain_ms, rev_bytes, k1_ops)
    rev_row["offset_ms"] = rev_off_ms
    # the cold pass: one fused launch, each cell scored once for both directions
    bidir_row = row("candidates_bidir", SRC_K1, "protocol_tpu/ops/sparse.py:172",
                    k1_default["bidir_max_abs_err"], bidir_ms,
                    bidir_plain_ms, bidir_bytes, k1_ops)
    bidir_row["offset_ms"] = bidir_off_ms
    k2_row = row("auction_phase", "protocol_tpu_torch/csrc/auction.cu",
                 "protocol_tpu/ops/sparse.py:418", 0.0, k2_ms, k2_plain_ms, k2_bytes, k2_ops)
    k2_row.update(cluster=k2_c, one_block_open=kernels.K2_ONE_BLOCK_OPEN,
                  us_per_round=k2_ms * 1e3 / k2_rounds, ms_b512=k2_ms_512,
                  us_per_round_b512=k2_ms_512 * 1e3 / k2_rounds_512)
    rows = [
        bidir_row,
        fwd_row,
        rev_row,
        k2_row,
    ]
    for name, src, repl, err, ms, plain, bytes_, ops, work in new_rows:
        rows.append(dict(row(name, src, repl, err, ms, plain, bytes_, ops),
                         **row_extra.get(name, {})))
        print(f"{name} timed on its first-call arguments: {work}", flush=True)
    rows += [
        row("dense_value_base", SRC_K1, "protocol_tpu/sched/tpu_backend.py:172", 0.0,
            k6_ms, k6_plain_ms, k6_bytes, k6_ops),
        dict(row("dense_auction", SRC_DENSE, "protocol_tpu/ops/assign.py:176", 0.0, k7_ms,
                 k7_plain_ms, k7_bytes, k7_ops),
             price_route=kernels.dense_route(Pd), us_per_round=k7_ms * 1e3 / max(k7_rounds, 1)),
        dict(row("unbounded_best", SRC_K1, "protocol_tpu/sched/tpu_backend.py:189", 0.0, k8_ms,
                 k8_plain_ms, k8_bytes, k8_ops), launch_ms=k8_launch_ms),
        k9_row,
    ] + phase_rows + backend_rows + stage_rows + mesh_rows + dense_rows + sink_rows
    for r_ in rows:
        # a row may count another wrapper's launches (a kernel at new
        # arguments: the mesh's rows), or several, in some runs only; the
        # mesh runs also carry "candidates_sharded", K1's launches inside
        # the sharded pass (count_inside)
        counter = r_.pop("counter", r_["name"])
        counter = (counter,) if isinstance(counter, str) else counter
        only = r_.pop("runs", runs)
        for run, counts in runs.items():
            if run in only:
                r_[f"launches_{run}"] = sum(counts[c] for c in counter)
        r_["launches"] = sum(r_[f"launches_{run}"] for run in runs if run in only)
        # an estimate of the time the main path spent above the bound in
        # this kernel: its launches over the launches one timed ms covers
        # (a K16 segment, a K17 run: many), times (ms - bound_ms). The ms
        # is timed at one shape per row; a row whose launches run at other
        # shapes (most of the matcher's and the mesh's) is scaled from it
        r_["excess_ms"] = (r_["launches"] / r_.get("launches_timed", 1)
                           * (r_["ms"] - r_["bound_ms"]))
    order = sorted(rows, key=lambda r_: -r_["excess_ms"])
    print("kernels by launches x (ms - bound_ms), ms at one timed shape a row: " + "; ".join(
        f"{r_['name']} {r_['excess_ms']:.1f}" for r_ in order), flush=True)
    # R0: the device ms each wrapper's launches took in place, summed over
    # the cold ticks and the warm chain
    total: dict = {}
    for run in in_place.values():
        for name, v in run.items():
            total[name] = total.get(name, 0.0) + v["ms"]
    for r_ in rows:
        if r_["name"] in total:
            r_["in_place_ms"] = total[r_["name"]]
    print("kernels by in-place device ms, the cold ticks and the warm chain: " + "; ".join(
        f"{name} {ms:.3f}" for name, ms in sorted(total.items(), key=lambda kv: -kv[1])),
        flush=True)
    # the same for the mesh arena chain and the mesh matcher (D = 4 views)
    mesh_total: dict = {}
    for run in mesh_in_place.values():
        for name, v in run.items():
            mesh_total[name] = mesh_total.get(name, 0.0) + v["ms"]
    for r_ in rows:
        if r_["name"] in mesh_total:
            r_["in_place_ms_mesh"] = mesh_total[r_["name"]]
    print("kernels by in-place device ms, the mesh arena chain and the mesh matcher: "
          + "; ".join(f"{name} {ms:.3f}"
                      for name, ms in sorted(mesh_total.items(), key=lambda kv: -kv[1])),
          flush=True)
    # the same for the matcher's phase runs (dense, wide, torch route)
    phase_total: dict = {}
    for run in phase_in_place.values():
        for name, v in run.items():
            phase_total[name] = phase_total.get(name, 0.0) + v["ms"]
    for r_ in rows:
        if r_["name"] in phase_total:
            r_["in_place_ms_phases"] = phase_total[r_["name"]]
    print("kernels by in-place device ms, the matcher's phase runs: " + "; ".join(
        f"{name} {ms:.3f}" for name, ms in sorted(phase_total.items(), key=lambda kv: -kv[1])),
        flush=True)
    # the same for the backend's RPCs and the dense route's two refreshes
    for label, key, sums in (("the backend", "in_place_ms_backend", backend_in_place),
                             ("the dense route", "in_place_ms_dense_route", dense_in_place)):
        for r_ in rows:
            if r_["name"] in sums:
                r_[key] = sums[r_["name"]]["ms"]
        print(f"kernels by in-place device ms, {label}: " + "; ".join(
            f"{name} {v['ms']:.3f} ({v['launches']})"
            for name, v in sorted(sums.items(), key=lambda kv: -kv[1]["ms"])), flush=True)
    print(f"K2 timed launch: eps 4.0, B 4096, {k2_rounds} rounds, {k2_rows} frontier rows; "
          f"eps 0.02, B 512 (carried), {k2_rounds_512} rounds, {k2_rows_512} frontier rows",
          flush=True)
    print(f"K7 timed launch: {Td} slots x {Pd} providers, eps 0.05, {k7_rounds} rounds, "
          f"{k7_open_rows} open rows; K9 timed on {cut_open.numel()} open tasks "
          f"({k9_ms * 1e6 / cut_open.numel():.1f} ns a row)", flush=True)
    print(f"elapsed: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception as e:  # any phase failing fails the run, with its traceback
        import traceback

        traceback.print_exc()
        rc = fail(f"{type(e).__name__}: {e}")
    sys.exit(rc)
