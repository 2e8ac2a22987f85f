"""The port's matcher on its default route above ``dense_cell_budget``
(``TorchBatchMatcher(device="cpu")``: the ``CandidateCache`` route, and
the stateless sparse route without ``warm_start`` or without the cache)
held against the reference's ``TpuBatchMatcher`` on the same store.

A seeded marketplace with every task kind (phases 0 and 0.5 run over the
cache's rows) goes through a churn chain that reaches ``cold_every`` (3 on
both) and a departure of more than a quarter of the nodes (a compaction);
after every refresh the dicts, the shared stats, the carried retirement
mask, the cache's prices and its jitter cursor must be identical. The
matcher encodes tasks without a location, so its costs carry no haversine
term and the dicts are identical at default weights too. Then the ports of
``tests/test_sparse_matcher.py``'s sparse-path tests."""

import dataclasses
import random

import numpy as np
import pytest

from protocol_tpu.models import ComputeSpecs, CpuSpecs, GpuSpecs
from protocol_tpu.sched import TpuBatchMatcher
from protocol_tpu.store import NodeStatus, StoreContext
from protocol_tpu_torch.sched.torch_backend import TorchBatchMatcher

from tests.test_sparse_matcher import mk_bounded_task, mk_node, populate
from tests.test_torch_dense import MODELS, random_dsl
from tests.test_torch_matcher import (
    WEIGHTS,
    aa_task,
    assert_same_solve,
    bounded_task,
    mixed_node,
    port_weights,
    sc_all_kinds,
)

# the stats both matchers report on this route (solve_ms is a wall time)
SHARED_STATS = (
    "nodes", "tasks", "bounded_tasks", "assigned", "kernel", "truncated_replica_slots",
    "warm", "warm_seeded_slots", "stall_exit", "anti_affinity_assigned", "colocated_slots",
    "colocated_unplaced", "seq", "cache_rebuilt", "cache_delta_rows", "cache_delta_tasks",
    "cache_uncovered_rows", "cache_stale_frac",
)
# the port's own stats; binpack_routes (K11's instantiation a call) where
# phase 0 or 0.5 ran, as in sc_all_kinds
PORT_ONLY = {"encode_ms", "phase0_ms", "phase05_ms", "phase1_ms", "phase2_ms", "binpack_routes"}
MODES = {
    "cached": {},
    "stateless": {"warm_start": False},
    "no_cache": {"use_candidate_cache": False},
}


def pair(ctx, jw, mode: str, **kw):
    """The reference's and the port's matcher on ``ctx`` at the sparse
    route (dense_cell_budget 0), cold_every 3."""
    opts = dict(MODES[mode])
    use_cache = opts.pop("use_candidate_cache", True)
    ref = TpuBatchMatcher(ctx, weights=jw, dense_cell_budget=0, **opts, **kw)
    got = TorchBatchMatcher(ctx, weights=port_weights(jw), dense_cell_budget=0, device="cpu",
                            **opts, **kw)
    for m in (ref, got):
        m.cold_every = 3
        m.use_candidate_cache = use_cache
    return ref, got


def chain_store():
    ctx = sc_all_kinds(seed=31, n_nodes=72)
    rng = random.Random(7)
    for j in range(3):  # more auction demand than the fleet meets
        ctx.task_store.add_task(bounded_task(f"w{j}", 10_000 + j, 12, random_dsl(rng)))
    return ctx


def healthy(ctx):
    return [n for n in ctx.node_store.get_nodes() if n.status == NodeStatus.HEALTHY]


def chain_step(ctx, rng: random.Random, step: int) -> None:
    """One step of the chain: 1 reprices; 2 adds nodes of new specs and
    changes one node's specs; 3 adds and deletes a bounded task and loses
    a node; 4 changes nothing (the fourth warm solve: cold_every); 5 loses
    30% of the nodes (a compaction); 6 reprices again."""
    nodes = healthy(ctx)
    if step in (1, 6):
        for n in rng.sample(nodes, 6):
            n.price = round((n.price or 1.0) * rng.uniform(0.97, 1.03), 4)
            ctx.node_store.update_node(n)
    elif step == 2:
        for i in range(3):
            n = mixed_node(rng, 200 + i, located=True)
            n.status = NodeStatus.HEALTHY
            ctx.node_store.add_node(n)
        n = rng.choice(nodes)
        n.compute_specs = ComputeSpecs(
            gpu=GpuSpecs(count=4, model=rng.choice(MODELS), memory_mb=40000),
            cpu=CpuSpecs(cores=32), ram_mb=65536, storage_gb=1000,
        )
        ctx.node_store.update_node(n)
    elif step == 3:
        ctx.task_store.add_task(bounded_task("late", 20_000, 5, random_dsl(rng)))
        ctx.task_store.delete_task(next(t.id for t in ctx.task_store.get_all_tasks()
                                        if t.name == "b1"))
        ctx.node_store.update_node_status(rng.choice(nodes).address, NodeStatus.DEAD)
    elif step == 5:
        for n in rng.sample(nodes, int(len(nodes) * 0.3)):
            ctx.node_store.update_node_status(n.address, NodeStatus.DEAD)


def assert_same_state(got, ref, label):
    rs, gs = ref.last_solve_stats, got.last_solve_stats
    for key in SHARED_STATS:
        assert gs.get(key) == rs.get(key), (label, key, gs.get(key), rs.get(key))
    assert got._warm_solves_since_cold == ref._warm_solves_since_cold, label
    if ref._warm_retired is None:
        assert got._warm_retired is None, label
    else:
        np.testing.assert_array_equal(got._warm_retired, np.asarray(ref._warm_retired),
                                      err_msg=label)
        assert got._warm_retired_fp == ref._warm_retired_fp, label
    np.testing.assert_array_equal(got._cache.prices.view(np.uint32),
                                  ref._cache.prices.view(np.uint32), err_msg=label)
    assert got._cache._jitter_cursor == ref._cache._jitter_cursor, label
    assert got._warm_price_by_addr == ref._warm_price_by_addr, label


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("weights", list(WEIGHTS))
def test_sparse_route_equals_the_reference_along_a_churn_chain(weights, mode):
    ctx = chain_store()
    # top_k 8 < the fleet: the coverage repair and the new-row merges run
    ref, got = pair(ctx, WEIGHTS[weights], mode, top_k=8)
    rng = random.Random(5)
    seen = []
    for step in range(7):
        if step:
            chain_step(ctx, rng, step)
        ref.refresh()
        got.refresh()
        assert_same_solve(ctx, got, ref)
        assert_same_state(got, ref, f"step {step}")
        st = got.last_solve_stats
        assert st["kernel"] == "sparse_topk", step
        seen.append((st["warm"], st.get("cache_rebuilt")))
    if mode == "cached":
        # cold, three warm solves, the cold_every re-ground, the
        # compaction, warm again
        assert seen == [(False, True), (True, False), (True, False), (True, False),
                        (False, True), (False, True), (True, False)]
        assert got.last_solve_stats["anti_affinity_assigned"] > 0
        assert got.last_solve_stats["colocated_slots"] > 0
        assert got.last_solve_stats["cache_uncovered_rows"] > 0
    elif mode == "no_cache":
        assert [w for w, _ in seen] == [False, True, True, True, False, True, True]
    else:
        assert not any(w for w, _ in seen)


def test_stats_keys_on_the_sparse_routes_mirror_the_reference():
    for mode, extra in (("cached", {"prepare_ms"}), ("stateless", set())):
        ref, got = pair(sc_all_kinds(seed=33, n_nodes=48), WEIGHTS["default"], mode)
        ref.refresh()
        got.refresh()
        assert set(got.last_solve_stats) == set(ref.last_solve_stats) | PORT_ONLY | extra, mode
        assert got.last_solve_stats["kernel"] == "sparse_topk"


def test_claims_leave_the_cached_lists_and_dirty_the_carry():
    """Claimed rows are masked out of the cache's assembled lists and
    recorded as dirty slot rows for the next solve's retirement carry."""
    ctx = StoreContext.new_test()
    populate(ctx, 10, [])
    ctx.task_store.add_task(aa_task("spread", 100, 4, "task"))
    ctx.task_store.add_task(mk_bounded_task("auction", 200, 12))
    ref, got = pair(ctx, WEIGHTS["default"], "cached")
    for _ in range(2):
        ref.refresh()
        got.refresh()
        assert_same_solve(ctx, got, ref)
        assert_same_state(got, ref, "claims")
        np.testing.assert_array_equal(got._claim_rows_now, ref._claim_rows_now)
    assert got._claim_rows_now.any() and got.last_solve_stats["warm"]


# ---------------------------------------------------------------- the reference's
# sparse-path tests (tests/test_sparse_matcher.py), on the port


def port_matcher(ctx, **kw):
    return TorchBatchMatcher(ctx, min_solve_interval=0, device="cpu", **kw)


class TestSparseProductionPath:
    def test_sparse_path_engages_above_budget(self):
        ctx = StoreContext.new_test()
        populate(ctx, 24, [mk_bounded_task("t", 100, replicas=16)])
        m = port_matcher(ctx, dense_cell_budget=0)
        m.refresh()
        assert m.last_solve_stats["kernel"] == "sparse_topk"
        assert m.last_solve_stats["assigned"] == 16

    def test_dense_path_below_budget(self):
        ctx = StoreContext.new_test()
        populate(ctx, 24, [mk_bounded_task("t", 100, replicas=16)])
        m = port_matcher(ctx)
        m.refresh()
        assert m.last_solve_stats["kernel"] == "dense_auction"
        assert m.last_solve_stats["assigned"] == 16

    def test_sparse_dense_same_count(self):
        tasks = [mk_bounded_task("a", 100, replicas=10), mk_bounded_task("b", 200, replicas=7)]
        counts = {}
        for label, budget in (("dense", 1 << 24), ("sparse", 0)):
            ctx = StoreContext.new_test()
            populate(ctx, 32, tasks)
            m = port_matcher(ctx, dense_cell_budget=budget)
            m.refresh()
            counts[label] = m.last_solve_stats["assigned"]
        assert counts["dense"] == counts["sparse"] == 17

    def test_requirements_respected_on_sparse_path(self):
        ctx = StoreContext.new_test()
        for i in range(8):
            ctx.node_store.add_node(mk_node(f"0xa{i:039x}", gpu_model="H100"))
        for i in range(8):
            ctx.node_store.add_node(mk_node(f"0xb{i:039x}", gpu_model="RTX4090"))
        ctx.task_store.add_task(
            mk_bounded_task("h100only", 100, replicas=12, requirements="gpu:model=H100")
        )
        m = port_matcher(ctx, dense_cell_budget=0)
        m.refresh()
        assert m.last_solve_stats["assigned"] == 8
        assert all(addr.startswith("0xa") for addr in m._assignment)


class TestWarmStart:
    def test_second_solve_is_warm_and_stable(self):
        ctx = StoreContext.new_test()
        populate(ctx, 24, [mk_bounded_task("t", 100, replicas=16)])
        m = port_matcher(ctx, dense_cell_budget=0)
        m.refresh()
        first = dict(m._assignment)
        assert m.last_solve_stats["warm"] is False
        m.mark_dirty()
        m.refresh()
        assert m.last_solve_stats["warm"] is True
        assert m.last_solve_stats["warm_seeded_slots"] == 16
        assert m._assignment == first

    def test_warm_solve_after_churn_assigns_new_node(self):
        ctx = StoreContext.new_test()
        populate(ctx, 16, [mk_bounded_task("t", 100, replicas=17)])
        m = port_matcher(ctx, dense_cell_budget=0)
        m.refresh()
        assert m.last_solve_stats["assigned"] == 16  # supply-capped
        ctx.node_store.add_node(mk_node("0x" + "f" * 40))
        m.mark_dirty()
        m.refresh()
        assert m.last_solve_stats["warm"] is True
        assert m.last_solve_stats["assigned"] == 17
        assert "0x" + "f" * 40 in m._assignment

    def test_warm_disabled(self):
        ctx = StoreContext.new_test()
        populate(ctx, 24, [mk_bounded_task("t", 100, replicas=16)])
        m = port_matcher(ctx, dense_cell_budget=0, warm_start=False)
        m.refresh()
        m.mark_dirty()
        m.refresh()
        assert m.last_solve_stats["warm"] is False

    def test_task_deleted_frees_nodes_for_remaining_task(self):
        ctx = StoreContext.new_test()
        a = mk_bounded_task("a", 100, replicas=12)
        b = mk_bounded_task("b", 200, replicas=12)
        populate(ctx, 12, [a, b])
        m = port_matcher(ctx, dense_cell_budget=0)
        m.attach_observers()
        m.refresh()
        ctx.task_store.delete_task(a.id)
        m.refresh()
        assert m.last_solve_stats["assigned"] == 12
        assert set(m._assignment.values()) == {b.id}


def test_claimed_excluded_on_cached_sparse_path():
    ctx = StoreContext.new_test()
    populate(ctx, 8, [])
    ctx.task_store.add_task(aa_task("spread", 100, 4, "task"))
    ctx.task_store.add_task(mk_bounded_task("auction", 200, 8))
    m = port_matcher(ctx, dense_cell_budget=0)
    m.refresh()
    st = m.last_solve_stats
    assert st["kernel"] == "sparse_topk"
    assert st["anti_affinity_assigned"] == 4
    assert st["assigned"] == 8
    m.mark_dirty()
    m.refresh()
    assert m.last_solve_stats["assigned"] == 8


class TestWarmRetirementInvalidation:
    """The carried retirement mask survives a clean population and is
    cleared on the slots whose candidates churned (the mask is injected;
    what is under test is the carry and its invalidation)."""

    @staticmethod
    def _spy_retired0(m, captured):
        orig = m._sparse_solve

        def spy(*args, **kwargs):
            captured.append(kwargs.get("retired0"))
            return orig(*args, **kwargs)

        m._sparse_solve = spy

    @staticmethod
    def _cold_solved_matcher():
        ctx = StoreContext.new_test()
        # demand 4 replicas on a 2-node fleet: two slots stay unseated
        populate(ctx, 2, [mk_bounded_task("t", 100, replicas=4)])
        m = port_matcher(ctx, dense_cell_budget=0)
        m.refresh()
        assert m.last_solve_stats["assigned"] == 2
        return ctx, m

    def test_unchanged_population_keeps_carried_retirement(self):
        ctx, m = self._cold_solved_matcher()
        m._warm_retired = np.ones_like(np.asarray(m._warm_retired))
        captured = []
        self._spy_retired0(m, captured)
        m.mark_dirty()
        m.refresh()
        assert m.last_solve_stats["warm"] is True
        assert captured[0] is not None and bool(captured[0].all())

    def test_churn_clears_carried_retirement(self):
        ctx, m = self._cold_solved_matcher()
        m._warm_retired = np.ones_like(np.asarray(m._warm_retired))
        ctx.node_store.add_node(mk_node("0xnew"))
        captured = []
        self._spy_retired0(m, captured)
        m.mark_dirty()
        m.refresh()
        assert m.last_solve_stats["warm"] is True
        assert len(captured) == 1
        assert captured[0] is None or not bool(captured[0].any())
        assert m.last_solve_stats["assigned"] == 3


def test_backstop_counter_and_cache_defaults_like_the_reference():
    ref = TpuBatchMatcher(StoreContext.new_test())
    got = TorchBatchMatcher(StoreContext.new_test(), device="cpu")
    assert got.cold_every == ref.cold_every == 256
    assert got._cache.max_stale_frac == ref._cache.max_stale_frac == 0.10
    assert got.use_candidate_cache and got.warm_start
    for name in ("k", "reverse_r", "extra", "max_invalid_frac", "stale_rel_tol", "stale_abs_tol"):
        assert getattr(got._cache, name) == getattr(ref._cache, name), name
    assert dataclasses.asdict(got._cache.weights) == dataclasses.asdict(ref._cache.weights)
