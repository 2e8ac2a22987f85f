"""Batch matcher of the port (``protocol_tpu/sched/tpu_backend.py``).

One batched solve per population change: encode every schedulable node
and every task once, solve on the device, and serve per-heartbeat lookups
from a host dict. The task semantics are the reference's: a task with a
``replicas`` bound (``plugins["tpu_scheduler"]["replicas"]``) is expanded
into replica slots that compete in an auction over [nodes x slots]
(phase 1); every node left over then takes its cheapest compatible
unbounded task (phase 2, a row argmin: the swarm semantics). Shapes are
padded to power-of-two buckets as in the reference.

Phase 1 routes:
  ``native_engine="native"`` (the default): the dense auction for pools
      with p_bucket x s_bucket <= ``dense_cell_budget``
      (:func:`solve_bounded`: K6 then K7 on a card);
  ``native_engine="torch"`` / ``"torch:1"``: every size through one
      persistent :class:`~protocol_tpu_torch.parallel.torch_arena.
      TorchSolveArena` (the twin of the reference's ``"jax[:D]"``).
Phase 2 is :func:`solve_unbounded` (K8 on a card).

What the port does not carry yet raises ``NotImplementedError`` naming
its ROADMAP.md item, never a silently different solve: the candidate-cache
and stateless sparse routes above the dense budget, anti-affinity and
colocation (phases 0 and 0.5), node groups, the reference's native C++
engines, multi-card engines, ``approx_recall``, and the trace and profile
hooks.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import types
from typing import Optional

import numpy as np
import torch

from protocol_tpu_torch.device import resolve_device
from protocol_tpu_torch.models.node import ComputeRequirements
from protocol_tpu_torch.ops.assign import auction_dense, auction_value_base
from protocol_tpu_torch.ops.cost import INFEASIBLE, CostWeights, cost_matrix
from protocol_tpu_torch.ops.encoding import (
    FeatureEncoder,
    providers_from_numpy,
    requirements_from_numpy,
)
from protocol_tpu_torch.store.node_store import NodeStatus

# compared by value, so either package's NodeStatus (a str enum) passes
SCHEDULABLE = (NodeStatus.HEALTHY.value, NodeStatus.WAITING_FOR_HEARTBEAT.value)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


def _pow2_bucket(n: int, floor: int = 8) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def task_replicas(task) -> Optional[int]:
    cfg = task.scheduling_config
    if cfg and cfg.plugins:
        vals = cfg.plugins.get("tpu_scheduler", {}).get("replicas")
        if vals:
            r = int(vals[0])
            if r <= 0:
                raise ValueError(f"replicas must be positive, got {r}")
            return r
    return None


def task_requirements(task) -> ComputeRequirements:
    cfg = task.scheduling_config
    if cfg and cfg.plugins:
        vals = cfg.plugins.get("tpu_scheduler", {}).get("compute_requirements")
        if vals:
            return ComputeRequirements.parse(vals[0])
    return ComputeRequirements()


def task_anti_affinity(task) -> Optional[str]:
    """Replica-spread constraint: ``"task"`` = replicas on distinct
    providers, ``"location"`` = on distinct geographic locations."""
    cfg = task.scheduling_config
    if cfg and cfg.plugins:
        vals = cfg.plugins.get("tpu_scheduler", {}).get("anti_affinity")
        if vals:
            mode = str(vals[0])
            if mode not in ("task", "location"):
                raise ValueError(f"anti_affinity must be task|location, got {mode!r}")
            return mode
    return None


def task_colocate(task) -> bool:
    """Capacity-sharing opt-in: colocated replicas stack on one provider
    while its capacity holds (the reference's bin-pack phase 0.5)."""
    cfg = task.scheduling_config
    if cfg and cfg.plugins:
        vals = cfg.plugins.get("tpu_scheduler", {}).get("colocate")
        if vals:
            v = str(vals[0]).lower()
            if v not in ("true", "false"):
                raise ValueError(f"colocate must be true|false, got {vals[0]!r}")
            return v == "true"
    return False


def validate_tpu_scheduler_config(task) -> None:
    """Reject malformed tpu_scheduler plugin config at task-creation time so
    user input can never break the batch solve (raises ValueError)."""
    try:
        replicas = task_replicas(task)
        task_requirements(task)
        if task_anti_affinity(task) is not None and replicas is None:
            raise ValueError(
                "anti_affinity requires a replicas bound (unbounded swarm "
                "tasks have no replica set to spread)"
            )
        if task_colocate(task):
            if replicas is None:
                raise ValueError(
                    "colocate requires a replicas bound (the capacity "
                    "bin-pack places a finite replica set)"
                )
            if task_anti_affinity(task) is not None:
                raise ValueError(
                    "colocate and anti_affinity are mutually exclusive "
                    "(stacking vs spreading)"
                )
    except Exception as e:
        raise ValueError(f"invalid tpu_scheduler config: {e}") from e


def solve_bounded(ep, er, weights, stats_out: Optional[dict] = None) -> torch.Tensor:
    """Phase 1's dense solve (``_solve_bounded``): the auction at eps 0.05,
    300 rounds at most, over the tie-jittered cost (the jitter keeps
    identically-specced providers from drawing every open slot's bid to
    one provider per round). K6 then K7 on a card. Returns
    task_for_provider [P] i32; ``stats_out["auction_rounds"]`` receives
    the rounds (0-d tensor)."""
    value_base, task_feasible = auction_value_base(ep, er, weights)
    _, t4p, _, rounds = auction_dense(value_base, task_feasible, eps=0.05, max_iters=300)
    if stats_out is not None:
        stats_out["auction_rounds"] = rounds
    return t4p


def _solve_unbounded_plain(ep, er, weights) -> torch.Tensor:
    """K8's plain version: the first argmin of each provider's cost row
    (no tie jitter), -1 where that cost is >= INFEASIBLE/2."""
    cost, _ = cost_matrix(ep, er, weights)
    best = torch.argmin(cost, dim=1)  # first minimum
    feas = torch.gather(cost, 1, best[:, None])[:, 0] < INFEASIBLE * 0.5
    return torch.where(feas, best.to(torch.int32), -1)


def solve_unbounded(ep, er, weights) -> torch.Tensor:
    """Phase 2 (``_solve_unbounded``): each provider's cheapest compatible
    unbounded task, best [P] i32 (-1 = none). K8 on a card."""
    if ep.gpu_count.is_cuda:
        from protocol_tpu_torch import kernels

        return kernels.unbounded_best(ep, er, weights)
    return _solve_unbounded_plain(ep, er, weights)


class TorchBatchMatcher:
    """The reference's ``TpuBatchMatcher`` on one card: the same
    constructor arguments, names and defaults, plus ``device``.
    ``top_k``, ``warm_start`` and ``native_threads`` are taken for the
    reference's signature: only its unported routes read them."""

    def __init__(
        self,
        store,
        weights: Optional[CostWeights] = None,
        min_solve_interval: float = 1.0,
        max_replica_slots: int = 1 << 20,
        dense_cell_budget: int = 1 << 24,
        top_k: int = 64,
        warm_start: bool = True,
        native_fallback: bool = False,
        native_engine: str = "native",
        native_threads: int = 0,
        use_mesh: bool = False,
        approx_recall: Optional[float] = None,
        time_fn=time.monotonic,
        device: str | torch.device = "cuda",
    ):
        if native_fallback:
            raise _not_ported(
                "native_fallback (the reference's native C++ engine)", "queue A, M5"
            )
        name, _, suffix = native_engine.partition(":")
        if name in ("native-mt", "sinkhorn-mt"):
            raise _not_ported(
                f"native_engine={native_engine!r} (the reference's native C++ engines)",
                "queue A, M5",
            )
        if name == "torch":
            try:
                cards = int(suffix) if suffix else 1
            except ValueError:
                raise ValueError(
                    f"bad torch card suffix in {native_engine!r} (want torch[:1])"
                ) from None
            if cards != 1:
                raise _not_ported(
                    f"native_engine={native_engine!r} (a solve over several cards)",
                    "queue A item 5, queue B9",
                )
        elif native_engine != "native":
            raise ValueError(
                f"native_engine must be native|torch[:1], got {native_engine!r}"
            )
        if use_mesh:
            raise _not_ported("use_mesh (the sharded mesh solve)", "queue A item 5, queue B9")
        if approx_recall is not None:
            raise _not_ported("approx_recall (approximate top-k)", "queue A item 4")
        if os.environ.get("PROTOCOL_TPU_TRACE"):
            raise _not_ported("PROTOCOL_TPU_TRACE (the solve flight recorder)", "queue A, M6")
        self.device = resolve_device(device)
        self.store = store
        self.weights = weights or CostWeights(priority=1.0)
        self.min_solve_interval = min_solve_interval
        self.max_replica_slots = max_replica_slots
        # [providers x slots] cost cells up to which phase 1 solves dense:
        # 2^24 cells = 64 MB f32
        self.dense_cell_budget = dense_cell_budget
        self.cold_every = 256
        self.native_engine = native_engine
        self._arena_engine = name == "torch"
        self._native_arena = None
        self._last_arena_stats: dict = {}
        self._time = time_fn
        self._dirty = True
        self._last_solve = float("-inf")
        self._assignment: dict[str, str] = {}  # node address -> task id
        self._covered: set[str] = set()  # addresses the last solve considered
        # heartbeats arrive from worker threads: one lock serializes solves
        # and makes (_assignment, _covered) swaps atomic
        self._solve_lock = threading.Lock()
        self.encoder = FeatureEncoder()
        self.last_solve_stats: dict = {}
        self._solve_seq = 0

    # ----- invalidation hooks (wire to TaskStore observers + node changes)

    def mark_dirty(self) -> None:
        self._dirty = True

    def attach_observers(self) -> None:
        self.store.task_store.subscribe_created(lambda t: self.mark_dirty())
        self.store.task_store.subscribe_deleted(lambda t: self.mark_dirty())

    def attach_groups(self, plugin) -> None:
        raise _not_ported("attach_groups (the group phase)", "queue A, M3")

    # ----- lookup

    def lookup(self, node) -> tuple[Optional[object], bool]:
        """Returns (task, covered). ``covered`` means the last batch solve
        considered this node, so an empty assignment is a deliberate verdict
        (infeasible or capacity-excluded), not a gap to paper over."""
        self._ensure_fresh()
        covered = node.address in self._covered
        tid = self._assignment.get(node.address)
        task = self.store.task_store.get_task(tid) if tid else None
        return task, covered

    def task_for_node(self, node):
        return self.lookup(node)[0]

    def assigned_task_ids(self, address: str) -> list[str]:
        """Multi-assignment ids of a colocated node: always [] here, since
        colocation (which stacks several tasks on a node) is not ported."""
        return []

    def tasks_for_node(self, node) -> list:
        """All tasks assigned to this node in the last solve: one at most
        (colocation is not ported)."""
        task, _ = self.lookup(node)
        return [task] if task is not None else []

    def _ensure_fresh(self) -> None:
        # re-solve only when something changed, and never more often than
        # min_solve_interval
        if self._dirty and self._time() - self._last_solve >= self.min_solve_interval:
            with self._solve_lock:
                if self._dirty and (
                    self._time() - self._last_solve >= self.min_solve_interval
                ):
                    self.refresh()

    # ----- device solves

    def _bounded_t4p_arena(self, ep_host, er_host) -> np.ndarray:
        """Phase 1 through the persistent arena (the ``jax[:D]`` twin):
        every size, warm ticks carried between solves."""
        from protocol_tpu_torch.parallel.torch_arena import TorchSolveArena

        n_providers = int(ep_host.gpu_count.shape[0])
        if self._native_arena is None:
            self._native_arena = TorchSolveArena(cold_every=self.cold_every, device=self.device)
        p4s = self._native_arena.solve(ep_host, er_host, self.weights)
        self._last_arena_stats = {
            f"arena_{k}": v for k, v in self._native_arena.last_stats.items()
        }
        t4p = np.full(n_providers, -1, np.int32)
        seated = p4s >= 0
        t4p[p4s[seated]] = np.flatnonzero(seated)
        return t4p

    # ----- batch solve

    def refresh(self) -> None:
        """One batch solve."""
        if os.environ.get("PROTOCOL_TPU_PROFILE_DIR"):
            raise _not_ported("PROTOCOL_TPU_PROFILE_DIR (per-solve profiles)", "queue A, M6")
        self._refresh()

    def _refresh(self) -> None:
        t_start = time.perf_counter()
        # clear the dirty flag BEFORE reading state: a concurrent mark_dirty
        # landing mid-read must trigger another solve, not be erased
        self._dirty = False
        self._last_solve = self._time()
        nodes = [
            n for n in self.store.node_store.get_nodes()
            if getattr(n.status, "value", n.status) in SCHEDULABLE
        ]
        tasks = self.store.task_store.get_all_tasks()
        # drop tasks with malformed plugin config (validated at creation;
        # this guards direct store writes)
        ok_tasks = []
        for t in tasks:
            try:
                task_replicas(t)
                task_requirements(t)
                task_anti_affinity(t)
                task_colocate(t)
            except Exception:
                continue
            ok_tasks.append(t)
        tasks = ok_tasks
        # newest-first priority, matching NewestTaskPlugin ordering:
        # created_at normalized to [0, 1]
        if tasks:
            created = np.asarray([t.created_at for t in tasks], np.float64)
            span = max(created.max() - created.min(), 1.0)
            prio = ((created - created.min()) / span).astype(np.float32)
        else:
            prio = np.zeros(0, np.float32)

        assignment: dict[str, str] = {}
        covered = {n.address for n in nodes}
        if not nodes or not tasks:
            self._assignment, self._covered = assignment, covered
            self._solve_seq += 1
            self.last_solve_stats = {
                "nodes": len(nodes),
                "tasks": len(tasks),
                "group_assignments": 0,
                "seq": self._solve_seq,
            }
            return

        bounded: list[tuple[int, int]] = []  # (task idx, replicas)
        unbounded: list[int] = []
        for i, t in enumerate(tasks):
            r = task_replicas(t)
            if r is None:
                unbounded.append(i)
            elif task_colocate(t) or task_anti_affinity(t):
                self._dirty = True
                raise _not_ported(
                    "tasks with anti_affinity or colocate (phases 0 and 0.5)",
                    "queue A, M2",
                )
            else:
                bounded.append((i, r))

        P = len(nodes)
        p_bucket = _pow2_bucket(P)
        truncated_slots = 0

        # ---- replica-slot expansion for bounded tasks (host-side)
        slot_task: list[int] = []
        req_by_task: dict[int, ComputeRequirements] = {}
        if bounded:
            req_by_task = {i: task_requirements(tasks[i]) for i, _ in bounded}
            slot_cap = self.max_replica_slots
            for i, r in bounded:
                take = min(min(r, P), slot_cap - len(slot_task))
                slot_task.extend([i] * take)
                if len(slot_task) >= slot_cap:
                    break
            truncated_slots = sum(min(r, P) for _, r in bounded) - len(slot_task)
            if truncated_slots:
                # never a silent cap: dropped replica slots are a capacity
                # decision the operator must see
                logging.getLogger(__name__).warning(
                    "replica demand exceeds max_replica_slots=%d: "
                    "%d slots dropped this solve",
                    self.max_replica_slots,
                    truncated_slots,
                )
        s_bucket = _pow2_bucket(len(slot_task)) if slot_task else 0
        if slot_task and not self._arena_engine and p_bucket * s_bucket > self.dense_cell_budget:
            self._dirty = True
            raise _not_ported(
                f"the default route above dense_cell_budget ({p_bucket} x {s_bucket} "
                f"cells > {self.dense_cell_budget}: the CandidateCache and stateless "
                "sparse routes)",
                "queue A, M1",
            )
        self._last_arena_stats = {}

        t_enc = time.perf_counter()
        p_arrays = self.encoder.provider_arrays(
            [n.compute_specs for n in nodes],
            locations=[n.location for n in nodes],
            prices=[n.price or 0.0 for n in nodes],
            loads=[n.load or 0.0 for n in nodes],
            pad_to=p_bucket,
        )
        ep = providers_from_numpy(p_arrays, self.device)
        idx_addrs = [n.address for n in nodes]
        assigned = np.zeros(P, bool)
        encode_ms = (time.perf_counter() - t_enc) * 1e3

        # ---- phase 1: bounded tasks -> replica slots -> auction
        kernel_used = "none"
        solve_stats: dict = {}
        phase1_ms = 0.0
        if slot_task:
            t_enc = time.perf_counter()
            r_arrays = self.encoder.requirement_arrays(
                [req_by_task[i] for i in slot_task],
                priorities=[prio[i] for i in slot_task],
                pad_to=s_bucket,
            )
            t1 = time.perf_counter()
            encode_ms += (t1 - t_enc) * 1e3
            if self._arena_engine:
                kernel_used = "torch_arena"
                t4p = self._bounded_t4p_arena(
                    types.SimpleNamespace(**p_arrays), types.SimpleNamespace(**r_arrays)
                )
            else:
                kernel_used = "dense_auction"
                er = requirements_from_numpy(r_arrays, self.device)
                t4p = solve_bounded(ep, er, self.weights, solve_stats).cpu().numpy()
            for p_idx, s_idx in enumerate(t4p[:P]):
                if 0 <= s_idx < len(slot_task):
                    assignment[idx_addrs[p_idx]] = tasks[slot_task[s_idx]].id
                    assigned[p_idx] = True
            phase1_ms = (time.perf_counter() - t1) * 1e3

        # ---- phase 2: remaining nodes -> cheapest compatible unbounded task
        phase2_ms = 0.0
        if unbounded and not assigned.all():
            t_enc = time.perf_counter()
            er = self.encoder.encode_requirements(
                [task_requirements(tasks[i]) for i in unbounded],
                priorities=[prio[i] for i in unbounded],
                pad_to=_pow2_bucket(len(unbounded)),
                device=self.device,
            )
            t2 = time.perf_counter()
            encode_ms += (t2 - t_enc) * 1e3
            best = solve_unbounded(ep, er, self.weights).cpu().numpy()[:P]
            for p_idx in range(P):
                if not assigned[p_idx] and 0 <= best[p_idx] < len(unbounded):
                    assignment[idx_addrs[p_idx]] = tasks[unbounded[best[p_idx]]].id
            phase2_ms = (time.perf_counter() - t2) * 1e3

        self._assignment, self._covered = assignment, covered
        self._solve_seq += 1
        self.last_solve_stats = {
            "nodes": P,
            "tasks": len(tasks),
            "bounded_tasks": len(bounded),
            "assigned": len(assignment),
            "colocated_slots": 0,
            "colocated_unplaced": 0,
            "truncated_colocate_slots": 0,
            "solve_ms": (time.perf_counter() - t_start) * 1e3,
            "truncated_replica_slots": truncated_slots,
            "kernel": kernel_used,  # dense_auction | torch_arena | none
            "mesh_sharded": False,
            "mesh_gen_sharded": False,
            "warm": False,
            "warm_seeded_slots": 0,
            "stall_exit": False,
            "anti_affinity_assigned": 0,
            "truncated_aa_slots": 0,
            "group_assignments": 0,
            "seq": self._solve_seq,
            # the port's split of solve_ms: host encoding, then each phase's
            # solve up to its readback and dict build
            "encode_ms": encode_ms,
            "phase1_ms": phase1_ms,
            "phase2_ms": phase2_ms,
            **({"auction_rounds": int(solve_stats["auction_rounds"])} if solve_stats else {}),
            **self._last_arena_stats,
        }
