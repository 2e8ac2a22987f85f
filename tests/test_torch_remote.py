"""The port's client half of the seam: ``RemoteBatchMatcher``
(``protocol_tpu_torch/services/scheduler_grpc.py``) and the ``Scheduler``
(``protocol_tpu_torch/sched/scheduler.py``), held against the reference's,
and C8 (``native_fallback`` with the arena engine).

- C8: ``TorchBatchMatcher(native_fallback=True, native_engine="torch:1")``
  equals the reference's ``jax:1`` under fallback on a cold and a churned
  refresh (on the CPU, the 4,096-slot cap, no sparse route); the native
  engines are still refused naming M5.
- C9: the remote matcher on stores whose providers phases 0 and 0.5
  claim equals the in-process matcher.
- The reference's scenarios (``tests/test_scheduler_grpc.py:118, :159``,
  ``tests/test_wire_v2.py:388, :403, :472, :489, :503``) with the port's
  matcher against the port's server; the port's matcher against the
  reference's server and the reference's against the port's, with the
  same assignments; the backoff schedule equal to the reference's.
- The port's ``Scheduler`` through the scenarios of
  ``tests/test_scheduler.py``.

Servers are loopback, module-scoped, on the CPU; arenas run with one
torch thread."""

import random
import socket
from collections import Counter

import grpc
import pytest
import torch

from protocol_tpu.models import VolumeMount as RefVolumeMount
from protocol_tpu.ops.cost import CostWeights as JCostWeights
from protocol_tpu.sched import Scheduler as RefScheduler
from protocol_tpu.sched import TpuBatchMatcher
from protocol_tpu.services import scheduler_grpc as ref_grpc
from protocol_tpu.store import NodeStatus, StoreContext
from protocol_tpu_torch.dfleet.topology import FleetTopology
from protocol_tpu_torch.fleet.fabric import FleetConfig
from protocol_tpu_torch.models.task import Task, VolumeMount
from protocol_tpu_torch.ops.cost import CostWeights
from protocol_tpu_torch.sched.scheduler import NewestTaskPlugin, Scheduler, expand_task_for_node
from protocol_tpu_torch.sched.torch_backend import TorchBatchMatcher
from protocol_tpu_torch.services import scheduler_grpc as tg

from tests.test_scheduler import mk_node, mk_task
from tests.test_scheduler_grpc import _pool_world
from tests.test_torch_matcher import PHASE_SCENARIOS, churn, churn_chain_store
from tests.test_wire_v2 import _FlakyClient

FALLBACK = {"native_fallback": True, "native_engine": "torch:1"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def servers():
    """(port server, its address, reference server, its address)."""
    port = tg.serve("127.0.0.1:0", device="cpu", fleet=FleetConfig(shards=2))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        ref_port = s.getsockname()[1]
    ref_addr = f"127.0.0.1:{ref_port}"
    ref = ref_grpc.serve(address=ref_addr)
    yield port, f"127.0.0.1:{port.port}", ref, ref_addr
    port.stop(grace=None)
    ref.stop(grace=None)


def _claims(store, task_id) -> bool:
    """Whether the task is one of phase 0's or 0.5's (it claims providers)."""
    cfg = store.task_store.get_task(task_id).scheduling_config
    plug = (cfg.plugins if cfg else {}).get("tpu_scheduler", {})
    return "anti_affinity" in plug or "colocate" in plug


def _names(store, assignment):
    return {a: store.task_store.get_task(t).name for a, t in assignment.items()}


# ---------------- C8: native_fallback with the arena engine ----------------


def test_fallback_arena_engine_equals_the_reference():
    """The reference's jax:1 under native_fallback against the port's
    torch:1: the same assignment on a cold and a churned refresh, both on
    the CPU through their arenas. The fallback defaults to the CPU and
    refuses a card: it never moves a solve off a device it was given."""
    ctx = churn_chain_store()
    jw = JCostWeights(priority=1.0, proximity=0.0)
    ref = TpuBatchMatcher(ctx, weights=jw, native_fallback=True, native_engine="jax:1")
    for card in ("cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(ValueError, match="native_fallback runs the matcher on the CPU"):
            TorchBatchMatcher(ctx, device=card, **FALLBACK)
    got = TorchBatchMatcher(ctx, weights=CostWeights(priority=1.0, proximity=0.0), **FALLBACK)
    assert got.device.type == "cpu"  # the fallback asks for the CPU
    rng = random.Random(3)
    for step in range(2):
        if step:
            churn(ctx, rng, step)
        ref.refresh()
        got.refresh()
        assert got._assignment == ref._assignment, step
        assert got.last_solve_stats["kernel"] == "torch_arena"
        assert ref.last_solve_stats["kernel"] == "jax_arena"
        assert got.last_solve_stats["arena_cold"] == (step == 0)


def test_fallback_keeps_the_slot_cap():
    """Under fallback phase 1 keeps the reference's 4,096-slot envelope
    (520 tasks x 8 replicas on 8 nodes: 4,160 slots, 64 dropped)."""
    ctx = StoreContext.new_test()
    for i in range(8):
        ctx.node_store.add_node(mk_node(f"0x{i}", gpu_model="H100", gpu_count=8))
    for j in range(520):
        ctx.task_store.add_task(mk_task(f"b{j}", j, {"tpu_scheduler": {"replicas": ["8"]}}))
    got = TorchBatchMatcher(ctx, **FALLBACK)
    ref = TpuBatchMatcher(ctx, native_fallback=True, native_engine="jax:1")
    got.refresh()
    ref.refresh()
    assert got.last_solve_stats["truncated_replica_slots"] == 64
    assert ref.last_solve_stats["truncated_replica_slots"] == 64
    assert got.last_solve_stats["kernel"] == "torch_arena"
    assert got._assignment == ref._assignment and len(got._assignment) == 8


@pytest.mark.parametrize("engine", ["native", "native-mt", "sinkhorn-mt:2"])
def test_fallback_native_engines_are_refused_naming_m5(engine):
    with pytest.raises(NotImplementedError, match="ROADMAP.md .*M5"):
        TorchBatchMatcher(StoreContext.new_test(), native_fallback=True, native_engine=engine)


# ---------------- the remote matcher against the port's server ----------------


def test_remote_matcher_end_to_end_parity_and_rtt(servers):
    _, addr, _, _ = servers
    store = _pool_world()
    local = TorchBatchMatcher(store, min_solve_interval=0.0, device="cpu")
    remote = tg.RemoteBatchMatcher(store, addr, min_solve_interval=0.0, device="cpu")
    sched = Scheduler(store, batch_matcher=remote)
    assignments = {}
    for node in store.node_store.get_nodes():
        task = sched.get_task_for_node(node.address)
        if task is not None:
            assignments[node.address] = task.name
    local.refresh()
    assert assignments == _names(store, local._assignment) and assignments
    stats = remote.last_solve_stats
    assert stats["remote_calls"] >= 1 and stats["remote_rtt_ms"] > 0
    assert stats["remote_backend_ms"] > 0
    assert stats["remote_rtt_ms"] - stats["remote_backend_ms"] < 1000, stats


def test_remote_matcher_replica_bounds_respected(servers):
    _, addr, _, _ = servers
    store = _pool_world(n_nodes=10, n_tasks=3)
    remote = tg.RemoteBatchMatcher(store, addr, min_solve_interval=0.0, device="cpu")
    remote.refresh()
    by_task: dict = {}
    for a, name in _names(store, remote._assignment).items():
        by_task.setdefault(name, []).append(a)
    for name, nodes in by_task.items():
        if int(name.split("-")[1]) % 2 == 0:
            assert len(nodes) <= 2, (name, nodes)


def test_remote_matcher_v2_parity_with_v1(servers):
    _, addr, _, _ = servers
    store = _pool_world()
    m1 = tg.RemoteBatchMatcher(store, addr, min_solve_interval=0.0, wire="v1", device="cpu")
    m2 = tg.RemoteBatchMatcher(store, addr, min_solve_interval=0.0, wire="v2", device="cpu")
    m1.refresh()
    m2.refresh()
    assert m1._assignment == m2._assignment and m2._assignment
    assert m2.last_solve_stats["wire"] == "v2"
    assert m2.last_solve_stats["remote_bytes_out"] > 0


def test_remote_matcher_session_reuse_and_recovery(servers):
    server, addr, _, _ = servers
    store = _pool_world()
    m = tg.RemoteBatchMatcher(store, addr, min_solve_interval=0.0, wire="v2", **FALLBACK)
    local = TorchBatchMatcher(store, min_solve_interval=0.0, **FALLBACK)
    m.refresh()
    local.refresh()
    assert m._session is not None and m._session["tick"] == 0
    assert m._assignment == local._assignment
    assert m._native_kernel() == "jax:1"
    m.refresh()
    assert m._session["tick"] == 1  # a delta tick, not a new snapshot
    server.servicer.sessions.drop(m._session["id"])
    m.refresh()
    assert m._session["tick"] == 0
    assert m.seam.snapshot().get("session_session_reopen", 0) >= 1
    assert m._assignment == local._assignment


@pytest.mark.parametrize("scenario", ["aa_sites", "colocation", "all_kinds"])
@pytest.mark.parametrize("mode", ["v1", "v2-arena"])
def test_remote_matcher_with_claimed_providers_equals_in_process(servers, scenario, mode):
    """C9: providers that phase 0 (anti-affinity) or 0.5 (colocation) claims
    are marked invalid in the middle of the rows. Wire v2 keeps them (and
    every row after them, with their valid column) and drops only the
    padding tail, so phases 1 and 2 answer for every provider and the remote
    matcher equals the in-process one, on a cold and a repriced refresh.
    Wire v1 has no valid column, so the claimed rows stay home: the claims
    are kept, each task seats as many providers, and an exact tie of the
    auction may fall to another provider, as the rows it sees are others."""
    _, addr, _, _ = servers
    ctx = PHASE_SCENARIOS[scenario]()
    kw = dict(FALLBACK) if mode == "v2-arena" else {"device": "cpu"}
    wire = "v2" if mode == "v2-arena" else "v1"
    remote = tg.RemoteBatchMatcher(ctx, addr, min_solve_interval=0.0, wire=wire, **kw)
    local = TorchBatchMatcher(ctx, min_solve_interval=0.0, **kw)
    local.use_candidate_cache = False  # the remote's route: dense phase 1
    rng = random.Random(11)
    try:
        for step in range(2):
            if step:
                for n in rng.sample(ctx.node_store.get_nodes(), 3):
                    n.price = rng.uniform(0.5, 4)
                    ctx.node_store.update_node(n)
            remote.refresh()
            local.refresh()
            st = remote.last_solve_stats
            assert st["anti_affinity_assigned"] + st["colocated_slots"] > 0, st
            assert remote._assignment_multi == local._assignment_multi, step
            if mode == "v1":
                claims = {a: t for a, t in local._assignment.items() if _claims(ctx, t)}
                assert claims and all(remote._assignment.get(a) == t for a, t in claims.items())
                assert Counter(remote._assignment.values()) == Counter(local._assignment.values())
            else:
                assert remote._assignment == local._assignment, step
        if mode == "v2-arena":
            # sessions served it (a refresh whose claims move the last
            # unclaimed row re-opens: the row count is a session parameter)
            assert remote._session is not None and not remote._session_refused
    finally:
        remote.client.close()


def test_transient_unavailable_is_retried(servers):
    _, addr, _, _ = servers
    m = tg.RemoteBatchMatcher(_pool_world(n_nodes=6, n_tasks=2), addr, min_solve_interval=0.0,
                              wire="v1", retries=2, retry_base_s=0.01, device="cpu")
    real = m.client
    m.client = _FlakyClient(real, fail_n=1)
    m._reconnect = lambda **kw: None
    m.refresh()
    assert m._assignment and m.seam.snapshot().get("session_retry", 0) >= 1
    real.close()


def test_retry_budget_exhausted_raises(servers):
    _, addr, _, _ = servers
    m = tg.RemoteBatchMatcher(_pool_world(n_nodes=4, n_tasks=2), addr, min_solve_interval=0.0,
                              wire="v1", retries=1, retry_base_s=0.01, device="cpu")
    real = m.client
    m.client = _FlakyClient(real, fail_n=5)
    m._reconnect = lambda **kw: None
    with pytest.raises(grpc.RpcError):
        m.refresh()
    real.close()


def test_unimplemented_v2_falls_back_to_v1(servers):
    _, addr, _, _ = servers
    m = tg.RemoteBatchMatcher(_pool_world(n_nodes=6, n_tasks=2), addr, min_solve_interval=0.0,
                              wire="v2", device="cpu")
    real = m.client
    m.client = _FlakyClient(real, fail_n=99, code=grpc.StatusCode.UNIMPLEMENTED,
                            only={"assign_v2", "assign_delta", "open_session"})
    m._reconnect = lambda **kw: None
    m.refresh()
    assert m.wire == "v1" and m._assignment
    assert m.seam.snapshot().get("session_fallback_v1", 0) >= 1
    real.close()


# ---------------- across packages ----------------


@pytest.mark.parametrize("wire", ["v1", "v2"])
def test_port_and_reference_matchers_across_servers(servers, wire):
    """The port's matcher against the reference's server and the reference's
    matcher against the port's, with the arena engine under fallback
    (sessions on v2): the same assignments on a cold and a churned
    refresh."""
    _, addr, _, ref_addr = servers
    ctx = churn_chain_store()
    jw = JCostWeights(priority=1.0, proximity=0.0)
    mine = tg.RemoteBatchMatcher(ctx, ref_addr, min_solve_interval=0.0, wire=wire,
                                 weights=CostWeights(priority=1.0, proximity=0.0), **FALLBACK)
    theirs = ref_grpc.RemoteBatchMatcher(ctx, addr, min_solve_interval=0.0, wire=wire,
                                         weights=jw, native_fallback=True,
                                         native_engine="jax:1")
    rng = random.Random(5)
    try:
        for step in range(2):
            if step:
                churn(ctx, rng, step)
            mine.refresh()
            theirs.refresh()
            assert mine._assignment == theirs._assignment and mine._assignment, step
        if wire == "v2":
            assert mine._session["tick"] == theirs._session["tick"] == 1
    finally:
        mine.client.close()
        theirs.client.close()


def test_backoff_schedule_equals_the_reference(servers):
    _, addr, _, _ = servers
    mine = tg.RemoteBatchMatcher(StoreContext.new_test(), addr, retry_base_s=0.05,
                                 retry_max_s=2.0, device="cpu")
    theirs = ref_grpc.RemoteBatchMatcher(StoreContext.new_test(), addr, retry_base_s=0.05,
                                         retry_max_s=2.0)
    try:
        for uid in ("a" * 32, mine._session_uid, "t0@tenant"):
            mine._session_uid = theirs._session_uid = uid
            assert [mine._backoff_s(i) for i in range(8)] == [
                theirs._backoff_s(i) for i in range(8)]
    finally:
        mine.client.close()
        theirs.client.close()


def test_adopt_topology_is_generation_monotonic(servers):
    _, addr, _, _ = servers
    m = tg.RemoteBatchMatcher(StoreContext.new_test(), ["a:1", addr], device="cpu")
    try:
        topo = FleetTopology(["a:1", addr], generation=2)
        assert m.adopt_topology(topo, session_id="t@s")
        assert m.endpoints == topo.failover_order("t@s")
        assert not m.adopt_topology(FleetTopology(["a:1"], generation=1))
        assert m.seam.snapshot()["session_stale_topology_refused"] == 1
        # the bound endpoint ejected: failover to the new ring's home
        m._endpoint_i = m.endpoints.index("a:1")
        assert m.adopt_topology(topo.without("a:1"))
        assert m.endpoints == [addr] and m.client.address == addr
        assert m.seam.snapshot()["session_endpoint_failover"] == 1
    finally:
        m.client.close()


# ---------------- the Scheduler ----------------


def test_scheduler_greedy_chain_as_the_reference():
    ctx = StoreContext.new_test()
    ctx.node_store.add_node(mk_node("0xa"))
    ctx.task_store.add_task(mk_task("old", created_at=100))
    ctx.task_store.add_task(mk_task("new", created_at=200))
    assert Scheduler(ctx).get_task_for_node("0xa").name == "new"
    assert RefScheduler(ctx).get_task_for_node("0xa").name == "new"
    empty = StoreContext.new_test()
    empty.node_store.add_node(mk_node("0xa"))
    assert Scheduler(empty).get_task_for_node("0xa") is None
    assert Scheduler(StoreContext.new_test()).get_task_for_node("0xmissing") is None
    tasks = [mk_task("a", 1), mk_task("b", 3), mk_task("c", 2)]
    assert [t.name for t in NewestTaskPlugin().filter_tasks(tasks, None)] == ["b", "c", "a"]


@pytest.mark.parametrize("task_pkg", ["port", "reference"])
def test_env_cmd_volume_expansion(task_pkg):
    if task_pkg == "port":
        t = Task(name="t", image="img", env_vars={"OUT": "/data/${TASK_ID}/${NODE_ADDRESS}"},
                 cmd=["run", "--id=${TASK_ID}"], entrypoint=["${NODE_ADDRESS}"],
                 volume_mounts=[VolumeMount("/h/${TASK_ID}", "/c/${NODE_ADDRESS}")])
    else:
        from protocol_tpu.models import Task as RefTask

        t = RefTask(name="t", image="img", env_vars={"OUT": "/data/${TASK_ID}/${NODE_ADDRESS}"},
                    cmd=["run", "--id=${TASK_ID}"], entrypoint=["${NODE_ADDRESS}"],
                    volume_mounts=[RefVolumeMount("/h/${TASK_ID}", "/c/${NODE_ADDRESS}")])
    out = expand_task_for_node(t, "0xabc")
    assert out.env_vars["OUT"] == f"/data/{t.id}/0xabc"
    assert out.cmd[1] == f"--id={t.id}" and out.entrypoint == ["0xabc"]
    assert (out.volume_mounts[0].host_path, out.volume_mounts[0].container_path) == (
        f"/h/{t.id}", "/c/0xabc")
    assert "${TASK_ID}" in t.env_vars["OUT"]


def test_scheduler_serves_the_matchers_as_the_reference():
    """The scenarios of tests/test_scheduler.py::TestTpuBatchMatcher through
    the port's Scheduler and matcher, against the reference's pair."""
    ctx = StoreContext.new_test()
    ctx.node_store.add_node(mk_node("0xh", gpu_model="H100", gpu_count=8))
    ctx.node_store.add_node(mk_node("0xa", gpu_model="A100", gpu_count=8))
    for i in range(3):
        ctx.node_store.add_node(mk_node(f"0x{i}", gpu_model="H100", gpu_count=8))
    ctx.node_store.add_node(mk_node("0xdead", status=NodeStatus.DEAD))
    ctx.task_store.add_task(mk_task("any", created_at=100))
    ctx.task_store.add_task(mk_task("h100-only", created_at=300, sched_plugins={
        "tpu_scheduler": {"compute_requirements": ["gpu:count=8;gpu:model=H100"]}}))
    ctx.task_store.add_task(mk_task("bounded", created_at=200,
                                    sched_plugins={"tpu_scheduler": {"replicas": ["2"]}}))
    mine = Scheduler(ctx, batch_matcher=TorchBatchMatcher(ctx, device="cpu"))
    theirs = RefScheduler(ctx, batch_matcher=TpuBatchMatcher(ctx))
    for node in ctx.node_store.get_nodes():
        a, b = mine.get_task_for_node(node.address), theirs.get_task_for_node(node.address)
        assert (a.name if a else None) == (b.name if b else None), node.address
        assert [t.name for t in mine.get_tasks_for_node(node.address)] == [
            t.name for t in theirs.get_tasks_for_node(node.address)]
    names = [mine.get_task_for_node(a) for a in ("0x0", "0x1", "0x2", "0xh")]
    assert sum(t.name == "bounded" for t in names if t) == 2


def test_scheduler_dirty_on_task_change():
    ctx = StoreContext.new_test()
    ctx.node_store.add_node(mk_node("0xa", gpu_model="H100", gpu_count=8))
    matcher = TorchBatchMatcher(ctx, min_solve_interval=0.0, device="cpu")
    matcher.attach_observers()
    sched = Scheduler(ctx, batch_matcher=matcher)
    assert sched.get_task_for_node("0xa") is None
    ctx.task_store.add_task(mk_task("late", created_at=100))
    got = sched.get_task_for_node("0xa")
    assert got is not None and got.name == "late"
