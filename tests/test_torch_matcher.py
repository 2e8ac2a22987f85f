"""The port's batch matcher (``TorchBatchMatcher(device="cpu")``) held
against the reference's ``TpuBatchMatcher`` on the same ``StoreContext``:
the scenarios of ``tests/test_scheduler.py::TestTpuBatchMatcher`` and a
seeded mixed marketplace, on the dense route and on the arena route
(``"torch"`` against ``"jax:1"`` along a churn chain); stores with
anti-affinity tasks (phase 0, nodes at shared sites) and colocated tasks
(phase 0.5) on both routes; plus every case the port refuses.

The matcher encodes tasks without a location, so its proximity term is 0
whatever the nodes' locations: the assignment dicts must be identical at
default weights with located nodes too, which is within the reference's
``jax_ab_*`` bounds (``scripts/perf_floor.json``) by construction."""

import dataclasses
import random

import pytest
import torch

from protocol_tpu.models import ComputeSpecs, CpuSpecs, GpuSpecs, NodeLocation
from protocol_tpu.ops.cost import CostWeights as JCostWeights
from protocol_tpu.sched import Scheduler, TpuBatchMatcher
from protocol_tpu.store import NodeStatus, OrchestratorNode, StoreContext
from protocol_tpu_torch.ops.cost import CostWeights
from protocol_tpu_torch.sched import torch_backend as tb
from protocol_tpu_torch.sched.torch_backend import TorchBatchMatcher

from tests.test_colocation import ONE_GPU, mk_colo_task
from tests.test_colocation import mk_node as mk_colo_node
from tests.test_scheduler import mk_node, mk_task
from tests.test_torch_dense import MODELS, random_dsl

# ---------------------------------------------------------------- scenarios
# (the stores of tests/test_scheduler.py::TestTpuBatchMatcher, and more)


def sc_unbounded_newest():
    ctx = StoreContext.new_test()
    for i in range(4):
        ctx.node_store.add_node(mk_node(f"0x{i}", gpu_model="H100", gpu_count=8))
    ctx.task_store.add_task(mk_task("old", created_at=100))
    ctx.task_store.add_task(mk_task("new", created_at=200))
    return ctx


def sc_requirements_gate():
    ctx = StoreContext.new_test()
    ctx.node_store.add_node(mk_node("0xh", gpu_model="H100", gpu_count=8))
    ctx.node_store.add_node(mk_node("0xa", gpu_model="A100", gpu_count=8))
    ctx.task_store.add_task(mk_task("any", created_at=100))
    ctx.task_store.add_task(mk_task("h100-only", created_at=300, sched_plugins={
        "tpu_scheduler": {"compute_requirements": ["gpu:count=8;gpu:model=H100"]}}))
    return ctx


def sc_bounded_replicas():
    ctx = StoreContext.new_test()
    for i in range(5):
        ctx.node_store.add_node(mk_node(f"0x{i}", gpu_model="H100", gpu_count=8))
    ctx.task_store.add_task(mk_task("swarm", created_at=100))
    ctx.task_store.add_task(mk_task("bounded", created_at=300,
                                    sched_plugins={"tpu_scheduler": {"replicas": ["2"]}}))
    return ctx


def sc_identical_nodes():
    ctx = StoreContext.new_test()
    for i in range(450):
        ctx.node_store.add_node(mk_node(f"0x{i:03d}", gpu_model="H100", gpu_count=8))
    ctx.task_store.add_task(mk_task("wide", created_at=100,
                                    sched_plugins={"tpu_scheduler": {"replicas": ["350"]}}))
    return ctx


def sc_no_schedulable():
    ctx = StoreContext.new_test()
    ctx.node_store.add_node(mk_node("0xa", status=NodeStatus.DEAD))
    ctx.task_store.add_task(mk_task("t", created_at=1))
    return ctx


def mixed_node(rng: random.Random, i: int, located: bool) -> OrchestratorNode:
    status = rng.choice([NodeStatus.HEALTHY] * 6 + [NodeStatus.WAITING_FOR_HEARTBEAT,
                                                     NodeStatus.DEAD, NodeStatus.UNHEALTHY])
    specs = None
    if rng.random() < 0.95:
        specs = ComputeSpecs(
            gpu=GpuSpecs(count=rng.choice([1, 2, 4, 8]), model=rng.choice(MODELS),
                         memory_mb=rng.choice([24000, 40000, 80000])),
            cpu=CpuSpecs(cores=rng.choice([8, 32, 64])),
            ram_mb=rng.choice([32768, 65536, 262144]),
            storage_gb=rng.choice([100, 1000, 4000]),
        )
    loc = NodeLocation(rng.uniform(-60, 60), rng.uniform(-170, 170)) if located and i % 2 else None
    return OrchestratorNode(address=f"0xm{i:03d}", status=status, compute_specs=specs,
                            location=loc, price=rng.choice([None, rng.uniform(0.5, 4)]),
                            load=rng.random())


def sc_mixed(seed=5, n_nodes=72, n_bounded=9, n_unbounded=4, located=True):
    rng = random.Random(seed)
    ctx = StoreContext.new_test()
    for i in range(n_nodes):
        ctx.node_store.add_node(mixed_node(rng, i, located))
    for j in range(n_bounded + n_unbounded):
        plug = {"compute_requirements": [random_dsl(rng)]}
        if j < n_bounded:
            plug["replicas"] = [str(rng.randint(1, 9))]
        ctx.task_store.add_task(mk_task(f"t{j}", created_at=rng.randint(0, 10_000),
                                        sched_plugins={"tpu_scheduler": plug}))
    return ctx


SCENARIOS = {
    "unbounded_newest": sc_unbounded_newest,
    "requirements_gate": sc_requirements_gate,
    "bounded_replicas": sc_bounded_replicas,
    "identical_nodes": sc_identical_nodes,
    "no_schedulable": sc_no_schedulable,
    "mixed_located": sc_mixed,
    "mixed_unlocated": lambda: sc_mixed(seed=6, located=False),
    "bounded_only": lambda: sc_mixed(seed=7, n_unbounded=0),
    "unbounded_only": lambda: sc_mixed(seed=8, n_bounded=0),
}
WEIGHTS = {"default": JCostWeights(priority=1.0), "proximity0": JCostWeights(priority=1.0,
                                                                             proximity=0.0)}


def port_weights(jw):
    return CostWeights(**dataclasses.asdict(jw))


@pytest.mark.parametrize("weights", list(WEIGHTS))
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_matcher_assignment_equals_the_reference(scenario, weights):
    ctx = SCENARIOS[scenario]()
    jw = WEIGHTS[weights]
    ref = TpuBatchMatcher(ctx, weights=jw)
    ref.refresh()
    got = TorchBatchMatcher(ctx, weights=port_weights(jw), device="cpu")
    got.refresh()
    assert got._assignment == ref._assignment
    assert got._covered == ref._covered
    rs, gs = ref.last_solve_stats, got.last_solve_stats
    for key in ("nodes", "tasks", "bounded_tasks", "assigned", "kernel",
                "truncated_replica_slots", "seq"):
        assert gs.get(key) == rs.get(key), key
    # the lookup surface serves the same tasks
    for n in ctx.node_store.get_nodes():
        a, b = got.lookup(n), ref.lookup(n)
        assert (a[0].id if a[0] else None, a[1]) == (b[0].id if b[0] else None, b[1])


def test_matcher_stats_keys_mirror_the_reference():
    ctx = sc_mixed()
    ref = TpuBatchMatcher(ctx)
    ref.refresh()
    got = TorchBatchMatcher(ctx, device="cpu")
    got.refresh()
    extra = {"encode_ms", "phase0_ms", "phase05_ms", "phase1_ms", "phase2_ms", "auction_rounds"}
    assert set(got.last_solve_stats) == set(ref.last_solve_stats) | extra
    assert got.last_solve_stats["kernel"] == "dense_auction"
    assert 0 < got.last_solve_stats["auction_rounds"] <= 300


def test_replica_truncation_warns_like_the_reference(caplog):
    ctx = sc_bounded_replicas()
    ref = TpuBatchMatcher(ctx, max_replica_slots=1)
    ref.refresh()
    got = TorchBatchMatcher(ctx, max_replica_slots=1, device="cpu")
    with caplog.at_level("WARNING"):
        got.refresh()
    assert "max_replica_slots=1" in caplog.text
    assert got.last_solve_stats["truncated_replica_slots"] == 1
    assert got._assignment == ref._assignment


def test_scheduler_serves_the_port_matcher():
    """The reference's Scheduler drives the port's matcher duck-typed: a
    task added after the first solve dirties it through the observers."""
    ctx = StoreContext.new_test()
    ctx.node_store.add_node(mk_node("0xa", gpu_model="H100", gpu_count=8))
    matcher = TorchBatchMatcher(ctx, min_solve_interval=0.0, device="cpu")
    matcher.attach_observers()
    sched = Scheduler(ctx, batch_matcher=matcher)
    assert sched.get_task_for_node("0xa") is None
    ctx.task_store.add_task(mk_task("late", created_at=100))
    got = sched.get_task_for_node("0xa")
    assert got is not None and got.name == "late"
    assert [t.name for t in matcher.tasks_for_node(ctx.node_store.get_node("0xa"))] == ["late"]
    assert matcher.assigned_task_ids("0xa") == []


def churn_chain_store():
    return sc_mixed(seed=12, n_nodes=96, n_bounded=10, n_unbounded=3, located=True)


def churn(ctx, rng: random.Random, step: int) -> None:
    """One step of churn: reprice a few nodes (rows change in place, a
    warm tick); at step 3 also add a task and retire a node (the slot and
    provider rows shift)."""
    nodes = ctx.node_store.get_nodes()
    for n in rng.sample(nodes, 4):
        n.price = rng.uniform(0.5, 4)
        ctx.node_store.update_node(n)
    if step == 3:
        ctx.node_store.update_node_status(rng.choice(nodes).address, NodeStatus.DEAD)
        ctx.task_store.add_task(mk_task(f"c{step}", created_at=5_000, sched_plugins={
            "tpu_scheduler": {"compute_requirements": [random_dsl(rng)], "replicas": ["3"]}}))


def test_torch_route_equals_jax1_along_a_churn_chain():
    ctx = churn_chain_store()
    jw = JCostWeights(priority=1.0, proximity=0.0)
    ref = TpuBatchMatcher(ctx, weights=jw, native_engine="jax:1")
    got = TorchBatchMatcher(ctx, weights=port_weights(jw), native_engine="torch", device="cpu")
    rng = random.Random(3)
    for step in range(4):
        if step:
            churn(ctx, rng, step)
        ref.refresh()
        got.refresh()
        assert got._assignment == ref._assignment, step
        rs, gs = ref.last_solve_stats, got.last_solve_stats
        assert gs["kernel"] == "torch_arena" and rs["kernel"] == "jax_arena"
        for key in ("arena_cold", "arena_assigned", "arena_changed_rows", "arena_plan_cost"):
            assert gs[key] == rs[key], (step, key)
        assert gs["arena_cold"] == (step in (0, 3)), step  # steps 1-2 are warm ticks
    # an unchanged store re-solves to the carried matching
    ref.mark_dirty()
    got.mark_dirty()
    ref.refresh()
    got.refresh()
    assert got._assignment == ref._assignment
    assert got.last_solve_stats["arena_changed_rows"] == 0


@pytest.mark.parametrize("engine", ["torch", "torch:1"])
def test_torch_route_takes_every_size(engine):
    ctx = sc_mixed(seed=9)
    got = TorchBatchMatcher(ctx, native_engine=engine, dense_cell_budget=1, device="cpu")
    got.refresh()
    assert got.last_solve_stats["kernel"] == "torch_arena"
    assert got.last_solve_stats["assigned"] > 0


@pytest.mark.parametrize("kwargs,item", [
    ({"native_fallback": True}, "M5"),
    ({"native_engine": "native-mt"}, "M5"),
    ({"native_engine": "sinkhorn-mt:4"}, "M5"),
    ({"approx_recall": 0.95}, "item 4"),
])
def test_unported_options_raise_naming_their_roadmap_item(kwargs, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md .*{item}"):
        TorchBatchMatcher(StoreContext.new_test(), device="cpu", **kwargs)


@pytest.fixture
def eight_cpu_views():
    """The port's mesh over eight views of the CPU, as the reference's
    conftest gives JAX eight host devices; restored after the test."""
    from protocol_tpu_torch.utils import platform

    prev = platform.force_virtual_devices(8, "cpu")
    yield
    platform.force_virtual_devices(prev, "cpu")


@pytest.mark.parametrize("ref_kwargs,kwargs", [
    ({"native_engine": "jax:4"}, {"native_engine": "torch:4"}),
    ({"native_engine": "jax:0"}, {"native_engine": "torch:0"}),
    ({"use_mesh": True, "dense_cell_budget": 1}, {"use_mesh": True, "dense_cell_budget": 1}),
])
def test_mesh_options_run_and_equal_the_reference(eight_cpu_views, ref_kwargs, kwargs):
    """The arena over D devices, over every visible device, and the
    sharded sparse route run over the port's mesh and equal the
    reference's over its own, on a mixed marketplace and after a churn
    step."""
    ctx = sc_mixed(seed=21, n_nodes=96, n_bounded=8, n_unbounded=3)
    jw = JCostWeights(priority=1.0, proximity=0.0)
    ref = TpuBatchMatcher(ctx, weights=jw, **ref_kwargs)
    got = TorchBatchMatcher(ctx, weights=port_weights(jw), device="cpu", **kwargs)
    rng = random.Random(4)
    for step in range(2):
        if step:
            churn(ctx, rng, step)
        ref.refresh()
        got.refresh()
        assert got._assignment == ref._assignment, step
        rs, gs = ref.last_solve_stats, got.last_solve_stats
        if "use_mesh" in kwargs:
            assert gs["kernel"] == rs["kernel"] == "sparse_topk"
            assert gs["mesh_sharded"] is rs["mesh_sharded"] is True
        else:
            assert gs["arena_torch_devices"] == rs["arena_jax_devices"] > 1
            assert gs["arena_gen_sharded"] == rs["arena_gen_sharded"]
            assert gs["arena_cold"] == rs["arena_cold"]


@pytest.mark.parametrize("engine", ["jax:1", "bogus", "torch:x"])
def test_unknown_engines_are_refused(engine):
    with pytest.raises(ValueError, match="native_engine|suffix"):
        TorchBatchMatcher(StoreContext.new_test(), native_engine=engine, device="cpu")


def test_default_route_above_the_dense_budget_raises():
    """The default route above ``dense_cell_budget`` no longer raises (it
    was refused, naming ROADMAP.md queue A M1, until the port had the
    candidate cache): it runs the sparse top-k route and equals the
    reference; at the budget the dense route still runs."""
    ctx = sc_identical_nodes()  # 512 x 512 bucketed cells
    ref = TpuBatchMatcher(ctx, dense_cell_budget=512 * 256)
    ref.refresh()
    got = TorchBatchMatcher(ctx, dense_cell_budget=512 * 256, device="cpu")
    got.refresh()
    assert got.last_solve_stats["kernel"] == ref.last_solve_stats["kernel"] == "sparse_topk"
    assert got._assignment == ref._assignment
    assert got.last_solve_stats["assigned"] == 350
    dense = TorchBatchMatcher(ctx, dense_cell_budget=512 * 512, device="cpu")
    dense.refresh()
    assert dense.last_solve_stats["kernel"] == "dense_auction"


def test_groups_and_hooks_raise(monkeypatch):
    m = TorchBatchMatcher(sc_bounded_replicas(), device="cpu")
    with pytest.raises(NotImplementedError, match="M3"):
        m.attach_groups(object())
    monkeypatch.setenv("PROTOCOL_TPU_PROFILE_DIR", "/nonexistent")
    with pytest.raises(NotImplementedError, match="M6"):
        m.refresh()
    monkeypatch.delenv("PROTOCOL_TPU_PROFILE_DIR")
    monkeypatch.setenv("PROTOCOL_TPU_TRACE", "/nonexistent")
    with pytest.raises(NotImplementedError, match="M6"):
        TorchBatchMatcher(StoreContext.new_test(), device="cpu")


def test_validate_tpu_scheduler_config_like_the_reference():
    from protocol_tpu.sched.tpu_backend import validate_tpu_scheduler_config as j_validate

    cases = [
        {"replicas": ["2"]}, {"replicas": ["0"]}, {"replicas": ["x"]},
        {"anti_affinity": ["task"]}, {"replicas": ["2"], "anti_affinity": ["zone"]},
        {"colocate": ["true"]}, {"replicas": ["2"], "colocate": ["maybe"]},
        {"replicas": ["2"], "colocate": ["true"], "anti_affinity": ["task"]},
        {"compute_requirements": ["gpu:count=x"]}, {"compute_requirements": ["cpu:cores=4"]},
    ]
    for plug in cases:
        task = mk_task("v", 1, {"tpu_scheduler": plug})
        try:
            j_validate(task)
            ref_ok = True
        except ValueError:
            ref_ok = False
        if ref_ok:
            tb.validate_tpu_scheduler_config(task)
        else:
            with pytest.raises(ValueError, match="invalid tpu_scheduler config"):
                tb.validate_tpu_scheduler_config(task)


def test_port_models_drive_the_matcher():
    """A store built only from the port's own copies (as chip_smoke.py
    builds it) solves like the reference's objects."""
    from protocol_tpu_torch.models.node import ComputeSpecs as TSpecs
    from protocol_tpu_torch.models.node import GpuSpecs as TGpu
    from protocol_tpu_torch.models.task import SchedulingConfig, Task, _validate_tpu_scheduler_plugin
    from protocol_tpu_torch.store.node_store import NodeStatus as TStatus
    from protocol_tpu_torch.store.node_store import OrchestratorNode as TNode

    class Store:
        def __init__(self, nodes, tasks):
            self.node_store = type("N", (), {"get_nodes": lambda s: nodes})()
            self.task_store = type("T", (), {"get_all_tasks": lambda s: tasks,
                                             "get_task": lambda s, i: {t.id: t for t in tasks}[i]})()

    nodes = [TNode(address=f"0x{i}", status=TStatus.HEALTHY,
                   compute_specs=TSpecs(gpu=TGpu(count=8, model="H100", memory_mb=80000)))
             for i in range(5)]
    cfg = SchedulingConfig(plugins={"tpu_scheduler": {"replicas": ["2"]}})
    _validate_tpu_scheduler_plugin(cfg)
    tasks = [Task(name="b", created_at=300, scheduling_config=cfg), Task(name="s", created_at=1)]
    m = TorchBatchMatcher(Store(nodes, tasks), device="cpu")
    m.refresh()
    names = sorted(m.task_for_node(n).name for n in nodes)
    assert names == ["b", "b", "s", "s", "s"]
    assert tasks[0].allowed_topologies() == []


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card rule cannot be exercised")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBatchMatcher(StoreContext.new_test())


# ---------------------------------------------------------------- phases 0 and 0.5
# (anti-affinity and colocation: the stores of tests/test_sparse_matcher.py::
# TestAntiAffinityMatcher and tests/test_colocation.py, and a seeded mix)

SITES = [(10.0, 10.0), (50.0, 50.0), (-33.9, 151.2), (40.7, -74.0), (35.7, 139.7)]


def aa_task(name, created_at, replicas, mode, dsl=None):
    plug = {"replicas": [str(replicas)], "anti_affinity": [mode]}
    if dsl:
        plug["compute_requirements"] = [dsl]
    return mk_task(name, created_at, {"tpu_scheduler": plug})


def bounded_task(name, created_at, replicas, dsl=None):
    plug = {"replicas": [str(replicas)]}
    if dsl:
        plug["compute_requirements"] = [dsl]
    return mk_task(name, created_at, {"tpu_scheduler": plug})


def sc_aa_sites():
    """20 nodes at 5 shared sites plus 4 unlocated ones (each its own
    class), a location-spread task wider than the sites, a provider-spread
    task, an auction task and a swarm task."""
    ctx = StoreContext.new_test()
    for i in range(24):
        n = mk_node(f"0xs{i:02d}", gpu_model="H100", gpu_count=8)
        n.price = 1.0 + (i % 7) * 0.25
        if i < 20:
            n.location = NodeLocation(*SITES[i % 5])
        ctx.node_store.add_node(n)
    ctx.task_store.add_task(aa_task("spread-loc", 300, 12, "location"))
    ctx.task_store.add_task(aa_task("spread-loc-2", 250, 3, "location"))
    ctx.task_store.add_task(aa_task("spread-task", 200, 4, "task"))
    ctx.task_store.add_task(bounded_task("auction", 100, 5))
    ctx.task_store.add_task(mk_task("swarm", 50))
    return ctx


def sc_aa_task_only():
    """Provider spread only (no location mode), with an auction competing
    for the rest: the claimed providers must leave phase 1."""
    ctx = StoreContext.new_test()
    for i in range(6):
        ctx.node_store.add_node(mk_node(f"0x{i}", gpu_model="H100", gpu_count=8))
    ctx.task_store.add_task(aa_task("spread", 100, 3, "task"))
    ctx.task_store.add_task(bounded_task("auction", 200, 6))
    return ctx


def sc_colocation():
    """Multi-GPU nodes holding 1-GPU slices of several tasks, a 2-GPU task,
    a task too large for any node (unplaced), an auction and a swarm."""
    ctx = StoreContext.new_test()
    for i, g in enumerate([2, 2, 4, 8, 1, 2]):
        ctx.node_store.add_node(mk_colo_node(f"0xc{i}", gpu_count=g))
    ctx.node_store.add_node(mk_colo_node("0xa100", gpu_count=4, model="A100"))
    ctx.task_store.add_task(mk_colo_task("a", 1.0, 3, ONE_GPU))
    ctx.task_store.add_task(mk_colo_task("b", 2.0, 5, ONE_GPU))
    ctx.task_store.add_task(mk_colo_task("pair", 3.0, 2, "gpu:count=2;gpu:model=H100"))
    ctx.task_store.add_task(mk_colo_task("cpu", 4.0, 2, "gpu:count=1;cpu:cores=16;ram_mb=32768"))
    ctx.task_store.add_task(mk_colo_task("huge", 5.0, 1, "gpu:count=16;gpu:model=H100"))
    ctx.task_store.add_task(bounded_task("auction", 6.0, 2))
    ctx.task_store.add_task(mk_task("swarm", 0.5))
    return ctx


def sc_all_kinds(seed=21, n_nodes=80):
    """The seeded marketplace of sc_mixed with nodes at shared sites and
    every task kind: anti-affinity in both modes, colocation, bounded and
    unbounded, each with a random requirement."""
    rng = random.Random(seed)
    ctx = StoreContext.new_test()
    for i in range(n_nodes):
        n = mixed_node(rng, i, located=False)
        if i % 3:
            n.location = NodeLocation(*SITES[rng.randrange(len(SITES))])
        ctx.node_store.add_node(n)
    for j in range(3):
        ctx.task_store.add_task(aa_task(f"al{j}", rng.randint(0, 10_000), rng.randint(2, 7),
                                        "location", random_dsl(rng)))
        ctx.task_store.add_task(aa_task(f"at{j}", rng.randint(0, 10_000), rng.randint(2, 7),
                                        "task", random_dsl(rng)))
    for j in range(4):
        ctx.task_store.add_task(mk_colo_task(f"co{j}", rng.randint(0, 10_000),
                                             rng.randint(1, 6), random_dsl(rng)))
    for j in range(4):
        ctx.task_store.add_task(bounded_task(f"b{j}", rng.randint(0, 10_000),
                                             rng.randint(1, 6), random_dsl(rng)))
    for j in range(2):
        ctx.task_store.add_task(mk_task(f"u{j}", rng.randint(0, 10_000), {
            "tpu_scheduler": {"compute_requirements": [random_dsl(rng)]}}))
    return ctx


PHASE_SCENARIOS = {
    "aa_sites": sc_aa_sites,
    "aa_task_only": sc_aa_task_only,
    "colocation": sc_colocation,
    "all_kinds": sc_all_kinds,
    "all_kinds_2": lambda: sc_all_kinds(seed=22, n_nodes=64),
}
PHASE_STATS = ("anti_affinity_assigned", "truncated_aa_slots", "colocated_slots",
               "colocated_unplaced", "truncated_colocate_slots")
ROUTES = {"dense": ("native", "native"), "torch": ("torch", "jax:1")}


def assert_same_solve(ctx, got, ref):
    assert got._assignment == ref._assignment
    assert got._assignment_multi == ref._assignment_multi
    assert got._covered == ref._covered
    rs, gs = ref.last_solve_stats, got.last_solve_stats
    for key in PHASE_STATS + ("assigned", "bounded_tasks", "truncated_replica_slots"):
        assert gs[key] == rs[key], key
    for n in ctx.node_store.get_nodes():
        assert [t.id for t in got.tasks_for_node(n)] == [t.id for t in ref.tasks_for_node(n)]
        assert got.assigned_task_ids(n.address) == ref.assigned_task_ids(n.address)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("weights", list(WEIGHTS))
@pytest.mark.parametrize("scenario", list(PHASE_SCENARIOS))
def test_phases_zero_and_half_equal_the_reference(scenario, weights, route):
    ctx = PHASE_SCENARIOS[scenario]()
    jw = WEIGHTS[weights]
    port_engine, ref_engine = ROUTES[route]
    ref = TpuBatchMatcher(ctx, weights=jw, native_engine=ref_engine)
    ref.refresh()
    got = TorchBatchMatcher(ctx, weights=port_weights(jw), native_engine=port_engine,
                            device="cpu")
    got.refresh()
    assert_same_solve(ctx, got, ref)
    gs = got.last_solve_stats
    assert gs["anti_affinity_assigned"] + gs["colocated_slots"] > 0
    assert gs["phase0_ms"] >= 0 and gs["phase05_ms"] >= 0


def test_phase_zero_spreads_and_claims_leave_the_auction():
    ctx = sc_aa_sites()
    m = TorchBatchMatcher(ctx, device="cpu")
    m.refresh()
    by_task: dict = {}
    for addr, tid in m._assignment.items():
        by_task.setdefault(ctx.task_store.get_task(tid).name, []).append(addr)

    def domain(addr):
        lc = ctx.node_store.get_node(addr).location
        return (lc.latitude, lc.longitude) if lc else addr  # unlocated: its own class

    sites = {}
    for name in ("spread-loc", "spread-loc-2"):
        keys = [domain(a) for a in by_task[name]]
        assert len(set(keys)) == len(keys)  # one replica per location class
        sites[name] = len(keys)
    # the provider-spread mode runs first; the classes left among the
    # other nodes (5 sites + 4 unlocated nodes at most) cap the 12 replicas
    assert len(by_task["spread-task"]) == 4
    free = {domain(n.address) for n in ctx.node_store.get_nodes()
            if n.address not in by_task["spread-task"]}
    assert sites["spread-loc"] == min(12, len(free))
    st = m.last_solve_stats
    assert st["anti_affinity_assigned"] == sum(sites.values()) + 4
    assert len(by_task["auction"]) == 5  # the auction took only free nodes


def test_colocation_stacks_within_capacity():
    ctx = sc_colocation()
    m = TorchBatchMatcher(ctx, device="cpu")
    m.refresh()
    st = m.last_solve_stats
    assert st["colocated_unplaced"] >= 1  # "huge" fits no node
    stacked = [a for a, tids in m._assignment_multi.items() if len(tids) > 1]
    assert stacked  # several tasks share a node
    for addr, tids in m._assignment_multi.items():
        node = ctx.node_store.get_node(addr)
        gpus = sum(tb.task_requirements(ctx.task_store.get_task(t)).gpu[0].count for t in tids)
        assert gpus <= node.compute_specs.gpu.count


def test_colocation_cap_warns_like_the_reference(caplog):
    ctx = StoreContext.new_test()
    for i in range(4):
        ctx.node_store.add_node(mk_colo_node(f"0xw{i}", gpu_count=8))
    ctx.task_store.add_task(mk_colo_task("wide", 1.0, 4100, ONE_GPU))
    ref = TpuBatchMatcher(ctx)
    with caplog.at_level("WARNING"):
        ref.refresh()
    ref_lines = [r.getMessage() for r in caplog.records]
    caplog.clear()
    got = TorchBatchMatcher(ctx, device="cpu")
    with caplog.at_level("WARNING"):
        got.refresh()
    got_lines = [r.getMessage() for r in caplog.records]
    assert got_lines == ref_lines
    assert any("capped at 4096 slots (4 dropped this solve)" in line for line in got_lines)
    assert any("colocation placed 32/4096" in line for line in got_lines)
    assert_same_solve(ctx, got, ref)
    assert got.last_solve_stats["truncated_colocate_slots"] == 4


def test_torch_route_equals_jax1_along_a_churn_chain_with_phase_tasks():
    ctx = sc_all_kinds(seed=31, n_nodes=72)
    jw = JCostWeights(priority=1.0, proximity=0.0)
    ref = TpuBatchMatcher(ctx, weights=jw, native_engine="jax:1")
    got = TorchBatchMatcher(ctx, weights=port_weights(jw), native_engine="torch", device="cpu")
    rng = random.Random(4)
    for step in range(4):
        if step:
            churn(ctx, rng, step)
        ref.refresh()
        got.refresh()
        assert_same_solve(ctx, got, ref)
        for key in ("arena_cold", "arena_assigned", "arena_changed_rows"):
            assert got.last_solve_stats[key] == ref.last_solve_stats[key], (step, key)
    assert got.last_solve_stats["anti_affinity_assigned"] > 0
    assert got.last_solve_stats["colocated_slots"] > 0


def test_candidate_memo_hits_on_a_repeat_and_misses_on_a_change():
    ctx = sc_colocation()
    m = TorchBatchMatcher(ctx, device="cpu")
    m.refresh()
    m.refresh()
    assert (m._cand_memo.misses, m._cand_memo.hits) == (1, 1)
    n = ctx.node_store.get_node("0xc3")
    n.price = 3.5
    ctx.node_store.update_node(n)
    m.refresh()
    assert (m._cand_memo.misses, m._cand_memo.hits) == (2, 1)
