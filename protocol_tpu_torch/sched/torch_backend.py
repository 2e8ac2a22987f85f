"""Batch matcher of the port (``protocol_tpu/sched/tpu_backend.py``).

One batched solve per population change: encode every schedulable node
and every task once, solve on the device, and serve per-heartbeat lookups
from a host dict. The task semantics are the reference's: a task with a
``replicas`` bound (``plugins["tpu_scheduler"]["replicas"]``) is expanded
into replica slots. Anti-affinity tasks (``anti_affinity: task|location``)
are placed first, one replica per provider and per domain, by the
bin-pack over the union of their slots' forward candidates (phase 0);
colocated tasks (``colocate: true``) then stack on providers while their
[gpu, vram, cpu, ram, storage] capacity holds, by the bin-pack over
their bidirectional candidates (phase 0.5). The providers those phases
claim leave the pool; the other bounded slots compete in an auction over
[nodes x slots] (phase 1); every node left over then takes its cheapest
compatible unbounded task (phase 2, a row argmin: the swarm semantics).
Shapes are padded to power-of-two buckets as in the reference.

Phases 0 and 0.5 score with :func:`cost_only` (K10 on a card) and place
with ``ops/binpack.py::assign_binpack_ffd`` (K11 on a card).

Phase 1 routes:
  ``native_engine="native"`` (the default): the dense auction for pools
      with p_bucket x s_bucket <= ``dense_cell_budget``
      (:func:`solve_bounded`: K6 then K7 on a card); above it the sparse
      top-k route (``kernel == "sparse_topk"``):
      - with ``warm_start`` (the default) over the persistent
        :class:`~protocol_tpu_torch.sched.cand_cache.CandidateCache`,
        which owns the provider rows (phases 0, 0.5 and 2 run over them,
        dead rows invalid): its delta passes (K1 under the cache's jitter
        cursor), then the warm auction from the carried prices, matching
        and retirement (K2, K9), or the eps-scaled ladder when cold;
      - without it, stateless: bidirectional candidates through the
        :class:`~protocol_tpu_torch.sched.cand_cache.CandidateMemo` (K1)
        and the scaled ladder (K2, K9);
      with ``use_mesh`` over several visible devices, the sparse route's
      auctions shard the slots over the provider mesh (K16) where the slot
      count divides by D, and the stateless route's generation shards too
      (K1 per shard); otherwise they solve on one device, as the
      reference does (``mesh_sharded`` / ``mesh_gen_sharded`` say which);
  ``native_engine="torch[:D]"``: every size through one persistent
      :class:`~protocol_tpu_torch.parallel.torch_arena.TorchSolveArena`
      with ``devices=D`` (0 or none = every visible device), the twin of
      the reference's ``"jax[:D]"``.
Phase 2 is :func:`solve_unbounded` (K8 on a card).

What the port does not carry yet raises ``NotImplementedError`` naming
its ROADMAP.md item, never a silently different solve: node groups, the
reference's native C++ engines, ``approx_recall``, and the trace and
profile hooks.
"""

from __future__ import annotations

import dataclasses
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
from protocol_tpu_torch.ops.binpack import assign_binpack_ffd
from protocol_tpu_torch.ops.cost import INFEASIBLE, CostWeights, cost_matrix
from protocol_tpu_torch.ops.encoding import (
    FeatureEncoder,
    gather_providers,
    providers_from_numpy,
    requirements_from_numpy,
)
from protocol_tpu_torch.ops.sparse import (
    assign_auction_sparse_scaled,
    assign_auction_sparse_warm,
    candidates_forward,
)
from protocol_tpu_torch.parallel.mesh import make_mesh
from protocol_tpu_torch.parallel.sparse import (
    assign_auction_sparse_scaled_sharded,
    assign_auction_sparse_warm_sharded,
    candidates_topk_bidir_sharded,
    segment_route,
)
from protocol_tpu_torch.sched.cand_cache import (
    CandidateCache,
    CandidateMemo,
    ProviderItem,
    TaskItem,
)
from protocol_tpu_torch.store.node_store import NodeStatus
from protocol_tpu_torch.utils.platform import visible_devices

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


def cost_only(ep, er, weights) -> torch.Tensor:
    """The unjittered dense cost of phases 0 and 0.5 (``_cost_only``):
    ``cost_matrix(ep, er, weights)[0]``, [P, T] f32. On a card this is K10,
    whose block is slot-major: the result is its transposed view, which
    ``assign_binpack_ffd`` reads without a copy."""
    if ep.gpu_count.is_cuda:
        from protocol_tpu_torch import kernels

        return kernels.cost_block(ep, er, weights).T
    return cost_matrix(ep, er, weights)[0]


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
    constructor arguments, names and defaults, plus ``device`` (the card
    when not given). ``native_fallback`` is served with the arena engine
    (``torch[:D]``) and then runs the matcher on the CPU, the device it
    defaults to and the only one it accepts; ``native_threads`` is read only by
    :class:`~protocol_tpu_torch.services.scheduler_grpc.RemoteBatchMatcher`'s
    kernel string. The device solves are the methods a remote matcher
    overrides: :meth:`_bounded_t4p` (phase 1, dense or the arena),
    :meth:`_bounded_t4p_sparse` (the stateless sparse route) and
    :meth:`_unbounded_best` (phase 2)."""

    # the candidate cache is an in-process structure; a matcher whose
    # candidates live behind a wire turns it off
    use_candidate_cache = True

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
        device: Optional[str | torch.device] = None,
    ):
        name, _, suffix = native_engine.partition(":")
        if native_fallback and name != "torch":
            # the reference's fallback runs its native C++ engines; with the
            # arena engine it means the CPU (below)
            raise _not_ported(
                f"native_fallback with native_engine={native_engine!r} (the reference's "
                "native C++ engine)", "queue A, M5"
            )
        if name in ("native-mt", "sinkhorn-mt"):
            raise _not_ported(
                f"native_engine={native_engine!r} (the reference's native C++ engines)",
                "queue A, M5",
            )
        # "torch[:D]": the arena over D devices of the mesh (0 or none =
        # every visible device), the twin of the reference's "jax[:D]"
        self._torch_devices = 0
        if name == "torch":
            try:
                self._torch_devices = int(suffix) if suffix else 0
            except ValueError:
                raise ValueError(
                    f"bad torch device suffix in {native_engine!r} (want torch[:D])"
                ) from None
        elif native_engine != "native":
            raise ValueError(
                f"native_engine must be native|torch[:D], got {native_engine!r}"
            )
        if approx_recall is not None:
            raise _not_ported("approx_recall (approximate top-k)", "queue A item 4")
        if os.environ.get("PROTOCOL_TPU_TRACE"):
            raise _not_ported("PROTOCOL_TPU_TRACE (the solve flight recorder)", "queue A, M6")
        # native_fallback with the arena engine is the reference's jax[:D]
        # under fallback: the caller asks for the CPU, where the arena runs
        # on the one CPU device (a larger D clamps, flagged, as the
        # reference's does), phase 1 keeps the 4,096-slot cap and the
        # sparse route is off (tpu_backend.py:265-272, :308-314,
        # :1270-1302)
        self.native_fallback = native_fallback
        if device is None:
            device = "cpu" if native_fallback else "cuda"
        if native_fallback and torch.device(device).type != "cpu":
            raise ValueError(
                f"native_fallback runs the matcher on the CPU; device={str(device)!r} "
                "asks for a card (drop native_fallback to solve there)"
            )
        self.device = resolve_device(device)
        # phase 1's sparse route over the provider mesh of every visible
        # device (opt-in: the sharded frontier is a different, equally
        # valid auction order)
        self.use_mesh = use_mesh
        self._mesh = None
        self._last_sharded = False
        self._last_gen_sharded = False
        self._mesh_fallback_logged = False
        if use_mesh and not native_fallback:
            n_dev = len(visible_devices(self.device.type))
            if n_dev > 1:
                self._mesh = make_mesh(n_dev, self.device)
            else:
                logging.getLogger(__name__).warning(
                    "use_mesh requested but only one device is visible; solving single-device"
                )
        self.store = store
        self.weights = weights or CostWeights(priority=1.0)
        self.min_solve_interval = min_solve_interval
        self.max_replica_slots = max_replica_slots
        # [providers x slots] cost cells up to which phase 1 solves dense:
        # 2^24 cells = 64 MB f32
        self.dense_cell_budget = dense_cell_budget
        self.top_k = top_k  # candidates per slot of the sparse route and phases 0, 0.5
        # carry auction prices and the previous matching across solves, so
        # population churn re-bids only the delta frontier
        self.warm_start = warm_start
        self._warm_price_by_addr: dict[str, float] = {}
        # retirement mask carried between warm solves, keyed to the slot
        # layout it was computed under (see _solve_slots_cached)
        self._warm_retired: np.ndarray | None = None
        self._warm_retired_fp: tuple | None = None
        # claim-masked slot rows (phases 0 and 0.5) of the current and the
        # previous solve: both dirty the carried retirement mask
        self._claim_rows_now: np.ndarray | None = None
        self._claim_rows_prev: np.ndarray | None = None
        # the schedule backstop of the warm chain: forward auctions never
        # lower prices, so after cold_every warm solves the cache and the
        # prices are re-grounded
        self.cold_every = 256
        self._warm_solves_since_cold = 0
        self._cand_memo = CandidateMemo()
        self.native_engine = native_engine
        self.native_threads = int(native_threads)
        self._arena_engine = name == "torch"
        self._native_arena = None
        self._last_arena_stats: dict = {}
        self._time = time_fn
        self._dirty = True
        self._last_solve = float("-inf")
        self._assignment: dict[str, str] = {}  # node address -> task id
        # colocated node address -> its distinct task ids, placement order
        self._assignment_multi: dict[str, list[str]] = {}
        self._covered: set[str] = set()  # addresses the last solve considered
        # heartbeats arrive from worker threads: one lock serializes solves
        # and makes (_assignment, _covered) swaps atomic
        self._solve_lock = threading.Lock()
        self.encoder = FeatureEncoder()
        self._cache = CandidateCache(self.encoder, self.weights, k=top_k, device=self.device)
        self._last_warm_used = False
        self._last_warm_seeded = 0
        self._last_stall: dict = {}
        self._last_mesh_route: str | None = None
        self.last_solve_stats: dict = {}
        self._dense_stats: dict = {}  # the dense auction's rounds, a refresh
        self._solve_seq = 0
        # per-solve counters of phases 0 and 0.5
        self._aa_truncated = self._colo_truncated = self._colo_requested = 0
        self._binpack_routes: list[str] = []

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
        """Multi-assignment ids from the last solve, no refresh; [] for a
        node that is not colocated."""
        return list(self._assignment_multi.get(address, ()))

    def tasks_for_node(self, node) -> list:
        """All tasks assigned to this node in the last solve: one for an
        auction or swarm node, several for a colocated node, in placement
        order (the first is what ``lookup`` serves)."""
        self._ensure_fresh()
        tids = self._assignment_multi.get(node.address)
        if not tids:
            task, _ = self.lookup(node)
            return [task] if task is not None else []
        found = (self.store.task_store.get_task(t) for t in tids)
        return [t for t in found if t is not None]

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

    def _bounded_t4p(self, ep, er, ep_device=None) -> np.ndarray:
        """Phase 1 below the sparse route: the slot per provider [P_pad].
        ``ep`` and ``er`` are the padded host columns (namespaces of numpy
        arrays, claimed providers invalid), ``ep_device`` the same providers
        on the matcher's device. The arena engine (the ``jax[:D]`` twin)
        takes every size and carries its warm ticks between solves; else the
        dense auction (K6, K7 on a card)."""
        if self._arena_engine:
            from protocol_tpu_torch.parallel.torch_arena import TorchSolveArena

            n_providers = int(ep.gpu_count.shape[0])
            if self._native_arena is None:
                self._native_arena = TorchSolveArena(
                    cold_every=self.cold_every, devices=self._torch_devices, device=self.device,
                )
            p4s = self._native_arena.solve(ep, er, self.weights)
            self._last_arena_stats = {
                f"arena_{k}": v for k, v in self._native_arena.last_stats.items()
            }
            t4p = np.full(n_providers, -1, np.int32)
            seated = p4s >= 0
            t4p[p4s[seated]] = np.flatnonzero(seated)
            return t4p
        er_device = requirements_from_numpy(vars(er), self.device)
        return solve_bounded(ep_device, er_device, self.weights, self._dense_stats).cpu().numpy()

    def _unbounded_best(self, ep, er) -> np.ndarray:
        """Phase 2 over encoded batches on the matcher's device: each
        provider's cheapest compatible unbounded task [P_pad], -1 for none
        (K8 on a card)."""
        return solve_unbounded(ep, er, self.weights).cpu().numpy()

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        """A copy of a host array on the matcher's device."""
        return torch.tensor(a, device=self.device)

    def _warm_gate(self, seeded: int, rebuilt: bool = False) -> bool:
        """Warm eligibility and the periodic-cold counter, for both sparse
        routes."""
        warm = (
            self.warm_start
            and seeded > 0
            and not rebuilt
            and self._warm_solves_since_cold < self.cold_every
        )
        if warm:
            self._warm_solves_since_cold += 1
        else:
            self._warm_solves_since_cold = 0
        return warm

    def _seed_slots(self, p4s0: np.ndarray, row_of_addr: dict, tasks, bounded, slot_range) -> int:
        """Seat the previous solve's holders back into their task's replica
        slots (rows in ``row_of_addr``'s space). Seeds that no longer meet
        eps-CS are evicted by the warm auction's repair. Returns the seeds."""
        tidx_by_id = {tasks[i].id: i for i, _ in bounded}
        prev_by_task: dict[int, list[int]] = {}
        for addr, tid in self._assignment.items():
            row = row_of_addr.get(addr)
            i = tidx_by_id.get(tid)
            if row is not None and i is not None and i in slot_range:
                prev_by_task.setdefault(i, []).append(row)
        for i, holders in prev_by_task.items():
            start, take = slot_range[i]
            for j, row in enumerate(holders[:take]):
                p4s0[start + j] = row
        return int((p4s0 >= 0).sum())

    def _sparse_solve(self, cand_p, cand_c, num_providers: int, warm: bool, price0, p4t0,
                      stats_out=None, retired0=None):
        """Phase 1's sparse solve: the warm auction from the carried duals,
        else the eps-scaled ladder; over the mesh (K16) when ``use_mesh``
        found devices and the slot count divides by D, else on one device
        (the mesh's route kept for the stats). Returns (result, prices,
        retired)."""
        D = self._mesh.size if self._mesh is not None else 0
        self._last_sharded = D > 1 and cand_p.shape[0] % D == 0
        if self._last_sharded:
            T, K = cand_c.shape
            # the sharded ladders' default frontier of 4,096, cut to a shard
            self._last_mesh_route = segment_route(self._mesh.devices, T // D, K,
                                                  min(4096, T // D))
            if warm:
                return assign_auction_sparse_warm_sharded(
                    cand_p, cand_c, num_providers, self._mesh, price0=price0, p4t0=p4t0,
                    stats_out=stats_out, frontier_ladder=True, retired0=retired0,
                    with_state=True,
                )
            return assign_auction_sparse_scaled_sharded(
                cand_p, cand_c, num_providers, self._mesh, stats_out=stats_out,
                frontier_ladder=True, with_state=True,
            )
        if D > 1 and not self._mesh_fallback_logged:
            # a mesh that was asked for and does not engage is logged once
            self._mesh_fallback_logged = True
            logging.getLogger(__name__).warning(
                "mesh solve requested but slot count %d is not divisible by the %d-device "
                "mesh; solving single-device", int(cand_p.shape[0]), D,
            )
        if warm:
            return assign_auction_sparse_warm(
                cand_p, cand_c, num_providers, price0=price0, p4t0=p4t0,
                stats_out=stats_out, retired0=retired0, with_state=True,
            )
        return assign_auction_sparse_scaled(
            cand_p, cand_c, num_providers, stats_out=stats_out, with_state=True
        )

    def _bounded_t4p_sparse(self, ep, er, price0: np.ndarray, p4s0: np.ndarray,
                            warm: bool) -> tuple[np.ndarray, np.ndarray]:
        """The stateless sparse route: bidirectional candidates (memoised on
        the encoded bytes; K1 on a card, per shard over the mesh when the
        slot count divides by D), then the auction. Returns (slot per
        provider [P_pad], prices [P_pad])."""
        s_bucket = er.num
        tile = min(1024, s_bucket)
        gen = None
        D = self._mesh.size if self._mesh is not None else 0
        if D > 1 and s_bucket % D == 0:
            # bit-identical to one device's pass at the same tile: it shares
            # the memo key
            tile = min(tile, s_bucket // D)

            def gen(ep_, er_, w_, **kw):
                return candidates_topk_bidir_sharded(ep_, er_, w_, mesh=self._mesh, **kw)

        misses_before = self._cand_memo.misses
        cand_p, cand_c = self._cand_memo.get(
            ep, er, self.weights, k=self.top_k, tile=tile, reverse_r=8, extra=16, gen=gen,
        )
        # sharded generation ran (a memo hit generates nothing)
        self._last_gen_sharded = gen is not None and self._cand_memo.misses > misses_before
        res, price, _retired = self._sparse_solve(
            cand_p, cand_c, ep.num, warm, self._tensor(price0), self._tensor(p4s0)
        )
        return res.task_for_provider.cpu().numpy(), price.cpu().numpy()

    def _solve_slots_stateless(self, ep, er, addrs, tasks, bounded, slot_range,
                               p_bucket: int, s_bucket: int) -> tuple[np.ndarray, bool, int]:
        """Phase 1 on the stateless sparse route: with ``warm_start`` the
        prices (by address) and the matching of the previous solve seed it.
        Returns (slot per provider [P], warm, seeds)."""
        P = len(addrs)
        price0 = np.zeros(p_bucket, np.float32)
        p4s0 = np.full(s_bucket, -1, np.int32)
        seeded = 0
        if self.warm_start:
            get_price = self._warm_price_by_addr.get
            price0[:P] = np.fromiter((get_price(a, 0.0) for a in addrs), np.float32, count=P)
            seeded = self._seed_slots(
                p4s0, {a: i for i, a in enumerate(addrs)}, tasks, bounded, slot_range
            )
        warm = self._warm_gate(seeded)
        t4p, price = self._bounded_t4p_sparse(ep, er, price0, p4s0, warm=warm)
        if self.warm_start:
            self._warm_price_by_addr = dict(zip(addrs, np.asarray(price[:P], np.float64).tolist()))
        return t4p[:P], warm, seeded

    def _solve_slots_cached(self, prepared, tasks, bounded, slot_range) -> np.ndarray:
        """Phase 1 over the candidate cache: the warm auction when seeds
        exist, the scaled ladder otherwise; the prices go back to the cache
        by row, so the next solve re-bids only its delta."""
        p4s0 = np.full(prepared.cand_p.shape[0], -1, np.int32)
        seeded = self._seed_slots(p4s0, prepared.row_of_addr, tasks, bounded, slot_range)
        warm = self._warm_gate(seeded, rebuilt=prepared.rebuilt)
        # the retirement carry holds only while the slot layout (task ids ->
        # slot ranges) is unchanged
        slot_fp = (
            tuple(sorted((tasks[i].id,) + tuple(slot_range[i]) for i, _ in bounded)),
            int(p4s0.shape[0]),
        )
        retired0 = None
        if warm and self._warm_retired is not None and self._warm_retired_fp == slot_fp:
            carried = np.asarray(self._warm_retired)
            if prepared.dirty_slots is None:
                carried = None  # unknown provenance: drop the whole mask
            else:
                # rows whose candidates changed are cleared (the warm
                # auction's contract); claim masking of this solve and the
                # last edits lists after the cache compared them
                dirty = prepared.dirty_slots.copy()
                for claim_rows in (self._claim_rows_now, self._claim_rows_prev):
                    if claim_rows is not None:
                        if claim_rows.shape == dirty.shape:
                            dirty |= claim_rows
                        else:
                            carried = None
                if carried is not None and dirty.shape == carried.shape:
                    carried = carried & ~dirty
                else:
                    carried = None
            if carried is not None:
                retired0 = self._tensor(carried)
        self._claim_rows_prev = self._claim_rows_now
        stall_stats: dict = {}
        res, price, retired = self._sparse_solve(
            self._tensor(prepared.cand_p), self._tensor(prepared.cand_c), prepared.p_bucket,
            warm, self._tensor(prepared.price0), self._tensor(p4s0),
            stats_out=stall_stats, retired0=retired0,
        )
        self._cache.store_prices(price.cpu().numpy())
        self._warm_retired = retired.cpu().numpy()
        self._warm_retired_fp = slot_fp
        self._last_warm_used = warm
        self._last_warm_seeded = seeded
        self._last_stall = stall_stats
        return res.task_for_provider.cpu().numpy()[: prepared.num_rows]

    def _gather_rows(self, ep, rows: np.ndarray):
        """The provider rows ``rows`` (sorted global ids) as new columns,
        padded with row 0 to a pow-2 bucket whose padding is invalid.
        Returns (sub_ep, rpad)."""
        rpad = _pow2_bucket(len(rows))
        gather = np.concatenate([rows, np.zeros(rpad - len(rows), np.int64)])
        idx = torch.from_numpy(gather).to(self.device)
        valid = torch.zeros(rpad, dtype=torch.uint8, device=self.device)
        valid[: len(rows)] = ep.valid[idx[: len(rows)]]
        return dataclasses.replace(gather_providers(ep, idx), valid=valid), rpad

    def _encode_slots(self, reqs, slot_task, prio, s_pad: int):
        """The slots' encoded requirements and the host time taken (ms)."""
        t0 = time.perf_counter()
        er = self.encoder.encode_requirements(
            reqs, priorities=[float(prio[i]) for i in slot_task], pad_to=s_pad,
            device=self.device,
        )
        return er, (time.perf_counter() - t0) * 1e3

    def _solve_anti_affinity(
        self, ep, N: int, aa, tasks, prio, idx_addrs, loc_by_addr
    ) -> tuple[dict[int, int], float]:
        """Phase 0 (``_solve_anti_affinity``): anti-affinity replicas
        through the bin-pack with unit capacity (one replica per provider)
        and exclusion groups over the declared domain: providers
        (``"task"``) or location classes (``"location"``), one mode after
        the other. The bin-pack runs over the sorted union of the slots'
        forward top-k candidates, not all N providers. Returns ({provider
        row -> task idx}, the host encoding time in ms)."""
        results: dict[int, int] = {}
        encode_ms = 0.0
        for mode in ("task", "location"):
            items = [(i, r, m) for (i, r, m) in aa if m == mode]
            if not items:
                continue
            slot_task: list[int] = []
            groups: list[int] = []
            for gi, (i, r, _m) in enumerate(items):
                take = min(r, N, 4096)
                if take < min(r, N):
                    # never a silent cap, as the phase-1 slot cap
                    self._aa_truncated += min(r, N) - take
                    logging.getLogger(__name__).warning(
                        "anti-affinity replica demand for task %s capped at "
                        "4096 slots (%d dropped this solve)",
                        tasks[i].id, min(r, N) - take,
                    )
                slot_task.extend([i] * take)
                groups.extend([gi] * take)
            S = len(slot_task)
            if S == 0:
                continue
            s_pad = _pow2_bucket(S)
            er, ms = self._encode_slots(
                [task_requirements(tasks[i]) for i in slot_task], slot_task, prio, s_pad
            )
            encode_ms += ms
            cand_p, _ = candidates_forward(
                ep, er, self.weights, min(self.top_k, ep.num), min(1024, s_pad)
            )
            # sorted: a lower subset row is a lower global row, the
            # bin-pack's tie order
            rows = np.unique(cand_p.cpu().numpy())
            rows = rows[rows >= 0].astype(np.int64)
            if rows.size == 0:
                continue
            sub_ep, rpad = self._gather_rows(ep, rows)
            cost = cost_only(sub_ep, er, self.weights)
            # rows claimed by the mode before are taken (cost is this
            # call's own block)
            taken = np.flatnonzero(np.isin(rows, np.fromiter(results, np.int64, len(results))))
            if taken.size:
                cost[torch.from_numpy(taken).to(self.device)] = INFEASIBLE
            if mode == "location":
                loc_local, L = self._location_classes(rows, idx_addrs, loc_by_addr)
                loc = np.zeros(rpad, np.int32)
                loc[: len(rows)] = loc_local
            else:
                loc = np.arange(rpad, dtype=np.int32)
                L = rpad
            anti = np.concatenate(
                [np.asarray(groups, np.int32), np.full(s_pad - S, -1, np.int32)]
            )
            res = assign_binpack_ffd(
                cost,
                torch.ones((s_pad, 1), dtype=torch.float32, device=self.device),
                torch.ones((rpad, 1), dtype=torch.float32, device=self.device),
                anti_group=torch.from_numpy(anti).to(self.device),
                loc_id=torch.from_numpy(loc).to(self.device),
                # pow-2 buckets, as the reference sizes its [L, G] carry
                num_locations=_pow2_bucket(int(L)),
                num_groups=_pow2_bucket(len(items)),
            )
            self._binpack_routes.append(res.route)
            p4s = res.provider_for_task[:S].cpu().numpy()
            for s_idx, r_local in enumerate(p4s):
                if 0 <= r_local < len(rows):
                    results[int(rows[r_local])] = slot_task[s_idx]
        return results, encode_ms

    def _solve_colocation(
        self, ep, colo, tasks, prio, taken_rows
    ) -> tuple[dict[int, list[int]], float]:
        """Phase 0.5 (``_solve_colocation``): colocated replicas through the
        bin-pack with the providers' real capacity [gpu count, gpu count x
        per-GPU memory, cpu cores, ram, storage], so several replicas (of
        one task or several) stack on one provider while it holds. The
        bin-pack runs over the sorted union of the slots' bidirectional
        candidates, less the rows phase 0 took. Returns ({provider row ->
        [task idx, ...]} in placement order, the host encoding time in
        ms)."""
        slot_task: list[int] = []
        for i, r in colo:
            take = min(r, 4096)
            if take < r:
                self._colo_truncated += r - take
                logging.getLogger(__name__).warning(
                    "colocate replica demand for task %s capped at 4096 "
                    "slots (%d dropped this solve)", tasks[i].id, r - take,
                )
            slot_task.extend([i] * take)
        S = len(slot_task)
        self._colo_requested = S
        if S == 0:
            return {}, 0.0
        s_pad = _pow2_bucket(S)
        req_of = {i: task_requirements(tasks[i]) for i, _ in colo}
        # a colocated slot claims a slice of a provider: the compat side
        # drops the exact GPU count and the whole-provider memory maximum,
        # and the demand (from the unrelaxed requirement) reserves the
        # slice against the remaining capacity
        relaxed = {
            i: dataclasses.replace(r, gpu=[
                dataclasses.replace(g, count=None, total_memory_max=None) for g in r.gpu
            ])
            for i, r in req_of.items()
        }
        er, encode_ms = self._encode_slots(
            [relaxed[i] for i in slot_task], slot_task, prio, s_pad
        )
        cand_p, _ = self._cand_memo.get(
            ep, er, self.weights, k=self.top_k, tile=min(1024, s_pad), reverse_r=8, extra=16,
        )
        rows = np.unique(cand_p.cpu().numpy())
        rows = rows[rows >= 0].astype(np.int64)
        if taken_rows:
            rows = rows[~np.isin(rows, np.fromiter(taken_rows, np.int64))]
        if rows.size == 0:
            return {}, encode_ms
        sub_ep, rpad = self._gather_rows(ep, rows)
        cost = cost_only(sub_ep, er, self.weights)

        # capacity from the encoded columns in f32 (-1, unreported, is 0:
        # a provider cannot host what it does not report)
        def col(x):
            return torch.clamp(x.to(torch.float32), min=0.0)

        pg = col(sub_ep.gpu_count)
        capacity = torch.stack(
            [pg, pg * col(sub_ep.gpu_mem_mb), col(sub_ep.cpu_cores), col(sub_ep.ram_mb),
             col(sub_ep.storage_gb)],
            dim=1,
        )
        # with GPU alternatives, reserve the element-wise maximum over the
        # options: compat may match any of them
        demand_of = {}
        for i, r in req_of.items():
            gcount = vram = 0.0
            for g in r.gpu:
                c = float(g.count or 0)
                if g.total_memory_min is not None:
                    v = float(g.total_memory_min)
                else:
                    v = c * float(g.memory_mb or g.memory_mb_min or 0)
                gcount = max(gcount, c)
                vram = max(vram, v)
            demand_of[i] = (
                gcount,
                vram,
                float(r.cpu.cores or 0) if r.cpu else 0.0,
                float(r.ram_mb or 0),
                float(r.storage_gb or 0),
            )
        demand = np.zeros((s_pad, 5), np.float32)
        demand[:S] = np.asarray([demand_of[i] for i in slot_task], np.float32)
        res = assign_binpack_ffd(cost, torch.from_numpy(demand).to(self.device), capacity)
        self._binpack_routes.append(res.route)
        p4s = res.provider_for_task[:S].cpu().numpy()
        placed: dict[int, list[int]] = {}
        for s_idx, r_local in enumerate(p4s):
            if 0 <= r_local < len(rows):
                placed.setdefault(int(rows[r_local]), []).append(slot_task[s_idx])
        return placed, encode_ms

    @staticmethod
    def _location_classes(rows: np.ndarray, idx_addrs, loc_by_addr) -> tuple[np.ndarray, int]:
        """Location class id per subset row: nodes at one (rounded to 3
        decimals) lat/lon share a class, ids in order of first appearance;
        a node without a location is its own class (it cannot be shown to
        share a failure domain)."""
        keys = []
        for r in rows:
            loc = loc_by_addr.get(idx_addrs[r]) if r < len(idx_addrs) else None
            if loc is not None:
                keys.append((round(loc.latitude, 3), round(loc.longitude, 3)))
            else:
                keys.append(("solo", int(r)))
        uniq = {k: i for i, k in enumerate(dict.fromkeys(keys))}
        return np.asarray([uniq[k] for k in keys], np.int32), len(uniq)

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
            self._assignment_multi = {}
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
        aa: list[tuple[int, int, str]] = []  # (task idx, replicas, mode)
        colo: list[tuple[int, int]] = []  # (task idx, replicas), capacity-sharing
        for i, t in enumerate(tasks):
            r = task_replicas(t)
            if r is None:
                unbounded.append(i)
            elif task_colocate(t):
                colo.append((i, r))
            else:
                mode = task_anti_affinity(t)
                if mode:
                    aa.append((i, r, mode))
                else:
                    bounded.append((i, r))

        P = len(nodes)
        p_bucket = _pow2_bucket(P)
        truncated_slots = 0

        # ---- replica-slot expansion for bounded tasks (host-side)
        slot_task: list[int] = []
        slot_range: dict[int, tuple[int, int]] = {}  # task idx -> (start, n)
        req_by_task: dict[int, ComputeRequirements] = {}
        if bounded:
            req_by_task = {i: task_requirements(tasks[i]) for i, _ in bounded}
            # under native_fallback phase 1 keeps the reference's 4,096-slot
            # envelope of its host engines
            slot_cap = (min(self.max_replica_slots, 4096) if self.native_fallback
                        else self.max_replica_slots)
            for i, r in bounded:
                take = min(min(r, P), slot_cap - len(slot_task))
                slot_range[i] = (len(slot_task), take)
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
        self._last_sharded = False  # set by _sparse_solve when it engages
        self._last_arena_stats = {}
        self._claim_rows_now = None  # set by the claim masking below
        s_bucket = _pow2_bucket(len(slot_task)) if slot_task else 0
        use_sparse = (
            bool(slot_task) and not self.native_fallback and not self._arena_engine
            and p_bucket * s_bucket > self.dense_cell_budget
        )
        # the candidate cache owns the provider rows on the cached route:
        # stable across solves (dead rows masked invalid), so a solve
        # encodes O(churn) providers and the candidates persist
        cached_path = use_sparse and self.warm_start and self.use_candidate_cache

        t_enc = time.perf_counter()
        prepared = None
        p_arrays = None
        cache_stats: dict = {}
        if cached_path:
            if self._warm_solves_since_cold >= self.cold_every:
                # periodic re-ground: fresh selection and fresh prices
                self._cache.invalidate()
            pitems = [
                ProviderItem(addr=n.address, specs=n.compute_specs, location=n.location,
                             price=n.price or 0.0, load=n.load or 0.0)
                for n in nodes
            ]
            titems = [
                TaskItem(task_id=tasks[i].id, requirement=req_by_task[i],
                         take=slot_range[i][1], prio=float(prio[i]))
                for i, _ in bounded
                if i in slot_range and slot_range[i][1] > 0
            ]
            prepared = self._cache.prepare(pitems, titems)
            ep = prepared.ep
            idx_addrs = prepared.addr_of_row
            N = prepared.num_rows
            cache_stats = {
                "cache_rebuilt": prepared.rebuilt,
                "cache_delta_rows": prepared.delta_rows,
                "cache_delta_tasks": prepared.delta_tasks,
                "cache_uncovered_rows": prepared.uncovered_rows,
                "cache_stale_frac": round(prepared.stale_frac, 4),
                # the port's: the cache's host work and its candidate
                # launches, up to their readbacks
                "prepare_ms": (time.perf_counter() - t_enc) * 1e3,
            }
            encode_ms = 0.0
        else:
            p_arrays = self.encoder.provider_arrays(
                [n.compute_specs for n in nodes],
                locations=[n.location for n in nodes],
                prices=[n.price or 0.0 for n in nodes],
                loads=[n.load or 0.0 for n in nodes],
                pad_to=p_bucket,
            )
            ep = providers_from_numpy(p_arrays, self.device)
            idx_addrs = [n.address for n in nodes]
            N = P
            encode_ms = (time.perf_counter() - t_enc) * 1e3
        assigned = np.zeros(N, bool)

        # ---- phase 0: anti-affinity replicas spread over providers or
        # location classes by the bin-pack; the providers they claim leave
        # the auction and phase 2
        t0, enc_ms = time.perf_counter(), 0.0
        self._aa_truncated = 0
        self._binpack_routes = []
        claims: dict[int, int] = {}
        if aa:
            loc_by_addr = {n.address: n.location for n in nodes}
            claims, enc_ms = self._solve_anti_affinity(
                ep, N, aa, tasks, prio, idx_addrs, loc_by_addr
            )
            for row, i in claims.items():
                assignment[idx_addrs[row]] = tasks[i].id
                assigned[row] = True
        phase0_ms = (time.perf_counter() - t0) * 1e3 - enc_ms
        encode_ms += enc_ms

        # ---- phase 0.5: colocated replicas stack on providers while their
        # capacity holds
        t0, enc_ms = time.perf_counter(), 0.0
        colo_slots = 0
        self._colo_truncated = 0
        self._colo_requested = 0
        assignment_multi: dict[str, list[str]] = {}
        placed: dict[int, list[int]] = {}
        if colo:
            placed, enc_ms = self._solve_colocation(ep, colo, tasks, prio, set(claims))
            for row, tidxs in placed.items():
                addr = idx_addrs[row]
                assignment[addr] = tasks[tidxs[0]].id
                # replicas of one task stacked on a provider reserve that
                # many slices, but a node runs one instance per distinct
                # task: the wire list carries distinct ids
                assignment_multi[addr] = list(dict.fromkeys(tasks[j].id for j in tidxs))
                assigned[row] = True
                colo_slots += len(tidxs)
            if colo_slots < self._colo_requested:
                logging.getLogger(__name__).warning(
                    "colocation placed %d/%d replica slots (insufficient "
                    "fleet capacity for the rest)",
                    colo_slots, self._colo_requested,
                )
        phase05_ms = (time.perf_counter() - t0) * 1e3 - enc_ms
        encode_ms += enc_ms

        claimed_rows = list(claims) + list(placed)
        arena_p_arrays = p_arrays
        if claimed_rows:
            # the auction and phase 2 must not re-assign a claimed
            # provider: drop it from the compatibility domain and from the
            # cache's assembled lists. The arena gets a NEW valid array: it
            # keeps the arrays it is given as its baseline, so an edit in
            # place would read as no change.
            claimed = np.zeros(ep.num, bool)
            claimed[claimed_rows] = True
            if p_arrays is not None:
                arena_p_arrays = dict(p_arrays, valid=p_arrays["valid"] & ~claimed)
            keep = torch.from_numpy((~claimed).astype(np.uint8)).to(self.device)
            ep = dataclasses.replace(ep, valid=ep.valid & keep)
            if prepared is not None:
                cp = prepared.cand_p
                masked = (cp >= 0) & claimed[np.maximum(cp, 0)]
                prepared.cand_p = np.where(masked, -1, cp)
                self._claim_rows_now = masked.any(axis=1)

        # ---- phase 1: bounded tasks -> replica slots -> auction
        kernel_used = "none"
        warm_used = False
        warm_seeded = 0
        self._dense_stats = solve_stats = {}
        phase1_ms = 0.0
        if slot_task:
            t1 = time.perf_counter()
            if cached_path:
                kernel_used = "sparse_topk"
                t4p = self._solve_slots_cached(prepared, tasks, bounded, slot_range)
                warm_used = self._last_warm_used
                warm_seeded = self._last_warm_seeded
            else:
                r_arrays = self.encoder.requirement_arrays(
                    [req_by_task[i] for i in slot_task],
                    priorities=[prio[i] for i in slot_task],
                    pad_to=s_bucket,
                )
                t_enc, t1 = t1, time.perf_counter()
                encode_ms += (t1 - t_enc) * 1e3
                if use_sparse:
                    kernel_used = "sparse_topk"
                    t4p, warm_used, warm_seeded = self._solve_slots_stateless(
                        ep, requirements_from_numpy(r_arrays, self.device), idx_addrs,
                        tasks, bounded, slot_range, p_bucket, s_bucket,
                    )
                else:
                    kernel_used = "torch_arena" if self._arena_engine else "dense_auction"
                    t4p = self._bounded_t4p(
                        types.SimpleNamespace(**arena_p_arrays),
                        types.SimpleNamespace(**r_arrays), ep_device=ep,
                    )
            for p_idx, s_idx in enumerate(t4p[:N]):
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
            best = self._unbounded_best(ep, er)[:N]
            for p_idx in range(N):
                if not assigned[p_idx] and 0 <= best[p_idx] < len(unbounded):
                    assignment[idx_addrs[p_idx]] = tasks[unbounded[best[p_idx]]].id
            phase2_ms = (time.perf_counter() - t2) * 1e3

        # multi first: a lock-free reader racing the swap (tasks_for_node
        # reads _assignment_multi, then _assignment) serves the previous
        # solve whole, never a new-solve/old-multi mix
        self._assignment_multi = assignment_multi
        self._assignment, self._covered = assignment, covered
        self._solve_seq += 1
        self.last_solve_stats = {
            "nodes": P,
            "tasks": len(tasks),
            "bounded_tasks": len(bounded),
            "assigned": len(assignment),
            "colocated_slots": colo_slots,
            "colocated_unplaced": self._colo_requested - colo_slots,
            "truncated_colocate_slots": self._colo_truncated,
            "solve_ms": (time.perf_counter() - t_start) * 1e3,
            "truncated_replica_slots": truncated_slots,
            "kernel": kernel_used,  # dense_auction | sparse_topk | torch_arena | none
            # phase 1 ran the sharded kernels (engaged, not merely asked for)
            "mesh_sharded": self._last_sharded,
            # how a sharded phase 1 ran its rounds (parallel/sparse.py::
            # segment_route): "segment", "rounds" or "plain"
            **({"mesh_route": self._last_mesh_route} if self._last_sharded else {}),
            "mesh_gen_sharded": self._last_gen_sharded,
            "warm": warm_used,
            "warm_seeded_slots": warm_seeded,
            # the binding phase's stall breaker: True means the tail fell
            # to the greedy cleanup (the cached route's last solve)
            "stall_exit": self._last_stall.get("stall_exit", False),
            "anti_affinity_assigned": len(claims),
            "truncated_aa_slots": self._aa_truncated,
            # K11's instantiation on each bin-pack call of phases 0 and 0.5
            # ("shared" / "device"; "plain" on the CPU), in call order
            **({"binpack_routes": list(self._binpack_routes)} if self._binpack_routes else {}),
            "group_assignments": 0,
            "seq": self._solve_seq,
            **cache_stats,
            # the port's split of solve_ms: host encoding (every phase's),
            # then each phase's solve up to its readback and dict build
            "encode_ms": encode_ms,
            "phase0_ms": phase0_ms,
            "phase05_ms": phase05_ms,
            "phase1_ms": phase1_ms,
            "phase2_ms": phase2_ms,
            **({"auction_rounds": int(solve_stats["auction_rounds"])} if solve_stats else {}),
            **self._last_arena_stats,
        }
