"""The port's orchestrator (``protocol_tpu_torch/services/orchestrator.py``)
held against the reference's (``protocol_tpu/services/orchestrator.py``).

Two services, one built from each package, get the same seeded world
(``tests/test_services.py::make_world``'s shape: a ledger with a started
pool, a manager wallet, nodes joined through signed invites) and the same
sequence of signed heartbeats and admin calls through aiohttp's
``TestClient(TestServer(svc.make_app()))``. The reference's matcher is
``TpuBatchMatcher(ctx, min_solve_interval=0)`` on the CPU's JAX, the port's
``TorchBatchMatcher(ctx, min_solve_interval=0, device="cpu")``, each behind
its package's ``Scheduler`` with its task observers attached. Every answer
(status code, error, ``current_task`` and ``assigned_tasks``) must be the
same: on the dense route, on the default route (``dense_cell_budget=0``),
with colocated tasks, across a task created and one deleted through the
routes, a ban, and three ``status_update_once`` ticks after the beats
expire that take two nodes Dead and eject them from the pool.

Tolerance: none, by the rule of ``tests/test_torch_matcher.py``. Half the
nodes (every odd one) carry a location of their own; the matchers encode
tasks without a location, so the haversine term, the only one whose ulps
differ between the packages, is 0 in every cell whatever the nodes'
coordinates, and a location reaches the solve only through the
location-spread task's classes (equal coordinates, compared exactly). So
the answers are compared for equality. Route-created tasks get a new uuid in each service,
so answers name tasks; the seeded tasks' ids are equal in both worlds.

Also the refusals (node groups naming M3; ``--kv-url``, ``--mode api``,
``S3_CREDENTIALS`` naming M4c), and ``handle_heartbeat`` answering as the
route does without a transport."""

import asyncio
import random
import types

import pytest
from aiohttp.test_utils import TestClient, TestServer

import protocol_tpu.chain as r_chain
import protocol_tpu.models as r_models
import protocol_tpu.models.task as r_task_mod
import protocol_tpu.sched as r_sched
import protocol_tpu.security as r_sec
import protocol_tpu.services.orchestrator as r_orch
import protocol_tpu.store as r_store
import protocol_tpu.utils.storage as r_storage
import protocol_tpu_torch.chain as t_chain
import protocol_tpu_torch.models as t_models
import protocol_tpu_torch.models.task as t_task_mod
import protocol_tpu_torch.security as t_sec
import protocol_tpu_torch.services.orchestrator as t_orch
import protocol_tpu_torch.store as t_store
import protocol_tpu_torch.utils.storage as t_storage
from protocol_tpu_torch import serve as t_serve
from protocol_tpu_torch.sched.scheduler import Scheduler as TScheduler
from protocol_tpu_torch.sched.torch_backend import TorchBatchMatcher

N_NODES = 64
DEAD = (5, 17)  # nodes whose beats expire: Dead after three FSM ticks, then ejected
BANNED = 9
CREATED_AT_MS = 1_700_000_000_000  # Task.from_request's clock, pinned in both packages
MODELS = ("H100", "A100", "L40S")


class Clock:
    def __init__(self, t: float):
        self.t = t

    def __call__(self) -> float:
        return self.t


def node_specs(rng) -> dict:
    return {"gpu": {"count": rng.choice([1, 2, 4, 8]), "model": rng.choice(MODELS),
                    "memory_mb": 80_000},
            "cpu": {"cores": rng.choice([8, 16, 32])}, "ram_mb": rng.choice([32_768, 65_536]),
            "storage_gb": 2_000}


def task_dicts(rng, colocated: bool) -> list[dict]:
    """Bounded tasks (replicas over a requirement), unbounded ones, one
    spread over distinct locations (anti-affinity), and with
    ``colocated`` one-GPU tasks that share a provider's capacity."""
    out = []
    for j in range(6):
        plug = {"compute_requirements": [
            f"gpu:count={rng.choice([1, 2, 4])};gpu:model={rng.choice(MODELS)}"],
            "replicas": [str(rng.choice([2, 3, 5]))]}
        out.append(("b", j, plug))
    for j in range(3):
        out.append(("u", j, {"compute_requirements": [f"gpu:model={rng.choice(MODELS)}"]}))
    out.append(("a", 0, {"replicas": ["4"], "anti_affinity": ["location"]}))
    if colocated:
        for j in range(4):
            out.append(("c", j, {"compute_requirements": ["gpu:count=1;gpu:model=H100"],
                                 "replicas": ["3"], "colocate": ["true"]}))
    return [{"name": f"{kind}{j}", "id": f"00000000-0000-4000-8000-{len(out[:i]):012d}",
             "image": "img", "state": "PENDING", "created_at": 1_000 + 37 * i,
             "env_vars": {"NODE": "${NODE_ADDRESS}"},
             "scheduling_config": {"plugins": {"tpu_scheduler": plug}}}
            for i, (kind, j, plug) in enumerate(out)]


def make_world(pkg: str, route: str, colocated: bool, clock: Clock):
    """(service, matcher, node wallets, ledger, pool id) of one package."""
    if pkg == "ref":
        chain, models, sec, store_mod, orch, storage = (
            r_chain, r_models, r_sec, r_store, r_orch, r_storage)
    else:
        chain, models, sec, store_mod, orch, storage = (
            t_chain, t_models, t_sec, t_store, t_orch, t_storage)
    ledger = chain.Ledger()
    creator, manager, provider = (sec.Wallet.from_seed(s)
                                  for s in (b"creator", b"manager", b"provider-1"))
    wallets = [sec.Wallet.from_seed(f"node-{i}".encode()) for i in range(N_NODES)]
    ledger.mint(provider.address, 100_000)
    did = ledger.create_domain("synth")
    pid = ledger.create_pool(did, creator.address, manager.address, "")
    ledger.start_pool(pid, creator.address)
    ledger.register_provider(provider.address, 10 * (N_NODES + 1))
    ledger.whitelist_provider(provider.address)
    for w in wallets:
        ledger.add_compute_node(provider.address, w.address)
        ledger.validate_node(w.address)
        exp = clock.t + 600
        sig = manager.sign_message(chain.ledger.invite_digest(did, pid, w.address, "n", exp))
        ledger.join_compute_pool(pid, provider.address, w.address, "n", exp, sig)

    ctx = store_mod.StoreContext(store_mod.KVStore(time_fn=clock))
    rng = random.Random(7)
    for i, w in enumerate(wallets):
        rec = {"address": w.address, "status": "Healthy", "first_seen": 1.0,
               "compute_specs": node_specs(rng), "price": round(rng.uniform(0.5, 4.0), 3),
               "load": round(rng.uniform(0, 1), 3)}
        if i % 2:
            rec["location"] = {"latitude": rng.uniform(-60, 60),
                               "longitude": rng.uniform(-170, 170)}
        ctx.node_store.add_node(store_mod.OrchestratorNode.from_dict(rec))
    for d in task_dicts(random.Random(11), colocated):
        ctx.task_store.add_task(models.Task.from_dict(d))
    budget = {} if route == "dense" else {"dense_cell_budget": 0}
    if pkg == "ref":
        matcher = r_sched.TpuBatchMatcher(ctx, min_solve_interval=0, **budget)
        scheduler = r_sched.Scheduler(ctx, batch_matcher=matcher)
    else:
        matcher = TorchBatchMatcher(ctx, min_solve_interval=0, device="cpu", **budget)
        scheduler = TScheduler(ctx, batch_matcher=matcher)
    matcher.attach_observers()
    svc = orch.OrchestratorService(ledger, pid, manager, store=ctx, scheduler=scheduler,
                                   storage=storage.MockStorageProvider(), time_fn=clock)
    return svc, matcher, wallets, ledger, pid


def answer(status: int, body: dict, names: dict) -> tuple:
    """A reply reduced to what both services must share: the status, the
    error, and the tasks by name (ids checked equal to the store's)."""
    if status != 200:
        return status, body.get("error")
    data = body["data"]
    cur = data["current_task"]
    if cur is not None:
        assert names[cur["id"]] == cur["name"]
        if cur["env_vars"]:
            assert cur["env_vars"]["NODE"].startswith("0x")  # expanded for the node
    return (status, cur and cur["name"],
            [t["name"] for t in data.get("assigned_tasks", [])])


async def drive(pkg: str, route: str, colocated: bool) -> dict:
    clock = Clock(1_800_000_000.0)
    svc, matcher, wallets, ledger, pid = make_world(pkg, route, colocated, clock)
    sec, models = (r_sec, r_models) if pkg == "ref" else (t_sec, t_models)
    auth = {"Authorization": "Bearer admin"}
    out: dict = {"answers": []}

    def names():
        return {t.id: t.name for t in svc.store.task_store.get_all_tasks()}

    async def beat_round(client, label):
        for i, w in enumerate(wallets):
            headers, body = sec.sign_request("/heartbeat", w, {
                "address": w.address, "task_state": "RUNNING", "p2p_id": f"p2p-{i}",
                "metrics": [{"key": {"task_id": "t", "label": "loss"}, "value": 0.1 * i}]})
            r = await client.post("/heartbeat", json=body, headers=headers)
            out["answers"].append((label, i, answer(r.status, await r.json(), names())))

    async with TestClient(TestServer(svc.make_app())) as client:
        await beat_round(client, "cold")
        out["solves_cold"] = matcher.last_solve_stats["seq"]
        r = await client.post("/tasks", headers=auth, json={
            "name": "late", "image": "img", "scheduling_config": {"plugins": {"tpu_scheduler": {
                "compute_requirements": ["gpu:count=1"], "replicas": ["4"]}}}})
        out["create"] = (r.status, (await r.json())["data"]["name"])
        r = await client.post("/tasks", headers=auth, json={"name": "late", "image": "img"})
        out["create_again"] = r.status
        gone = next(t for t in svc.store.task_store.get_all_tasks() if t.name == "b1")
        r = await client.delete(f"/tasks/{gone.id}", headers=auth)
        out["delete"] = r.status
        r = await client.post(f"/nodes/{wallets[BANNED].address}/ban", headers=auth)
        out["ban"] = r.status

        # the beats expire; every node but DEAD beats again through the
        # store's own verb; three FSM ticks take DEAD to Dead and eject it
        clock.t += 91.0
        for i, w in enumerate(wallets):
            if i not in DEAD:
                svc.store.heartbeat_store.beat(models.HeartbeatRequest(address=w.address))
        for _ in range(3):
            await svc.status_update_once()
        out["status"] = {i: svc.store.node_store.get_node(w.address).status.value
                         for i, w in enumerate(wallets)}
        out["in_pool"] = [ledger.is_node_in_pool(pid, w.address) for w in wallets]

        await beat_round(client, "warm")
        r = await client.get("/tasks", headers=auth)
        out["tasks"] = sorted(t["name"] for t in (await r.json())["data"])
        r = await client.get("/groups", headers=auth)
        out["groups"] = (r.status, (await r.json())["data"])
        r = await client.get("/scheduler/stats", headers=auth)
        out["stats_seq"] = (await r.json())["data"]["seq"]
        r = await client.get("/metrics", headers=auth)
        out["metrics"] = (await r.json())["data"]
    out["solves"] = matcher.last_solve_stats["seq"]
    return out


@pytest.fixture
def pinned_task_clock(monkeypatch):
    """``Task.from_request`` stamps ``created_at`` from the wall clock, a
    matcher input: pin it in both packages so route-created tasks rank
    alike."""
    fixed = types.SimpleNamespace(time=lambda: CREATED_AT_MS / 1e3)
    monkeypatch.setattr(r_task_mod, "time", fixed)
    monkeypatch.setattr(t_task_mod, "time", fixed)


@pytest.mark.parametrize("route,colocated", [("dense", False), ("default", False),
                                             ("dense", True)])
def test_heartbeats_answer_as_the_reference(pinned_task_clock, route, colocated):
    got = {pkg: asyncio.run(drive(pkg, route, colocated)) for pkg in ("ref", "port")}
    ref, port = got["ref"], got["port"]
    assert port["answers"] == ref["answers"]
    for key in ("create", "create_again", "delete", "ban", "status", "in_pool", "tasks",
                "groups", "metrics"):
        assert port[key] == ref[key], key
    assert (port["solves_cold"], port["solves"]) == (ref["solves_cold"], ref["solves"])
    # the sequence exercised what it is for
    served = [a for _, _, a in port["answers"] if a[0] == 200 and a[1]]
    assert len(served) > N_NODES // 2
    banned = [a for label, i, a in port["answers"] if label == "warm" and i == BANNED]
    assert banned == [(401, "address rejected")]
    assert [port["status"][i] for i in DEAD] == ["Dead", "Dead"]
    assert [port["in_pool"][i] for i in DEAD] == [False, False] and sum(port["in_pool"]) == (
        N_NODES - len(DEAD))
    warm_dead = [a for label, i, a in port["answers"] if label == "warm" and i in DEAD]
    assert all(a[1] is None for a in warm_dead)  # a Dead node is not in the solve
    assert port["groups"] == (200, [])
    if colocated:
        assert any(a[2] for _, _, a in port["answers"] if a[0] == 200)


def test_handle_heartbeat_answers_without_a_transport():
    """The transport-free section gives the route's answers: a task, a
    mismatched address, a banned node."""
    clock = Clock(1_800_000_000.0)
    svc, matcher, wallets, _, _ = make_world("port", "dense", False, clock)
    matcher.refresh()
    a = next(w.address for w in wallets if w.address in matcher._assignment)

    async def flow():
        ok = await svc.handle_heartbeat(t_models.HeartbeatRequest(address=a), a)
        bad = await svc.handle_heartbeat(t_models.HeartbeatRequest(address=a), "0xother")
        svc.store.kv.set(t_orch.BAN_KEY.format(a), "1")
        banned = await svc.handle_heartbeat(t_models.HeartbeatRequest(address=a), a)
        return ok, bad, banned

    ok, bad, banned = asyncio.run(flow())
    task, _ = matcher.lookup(svc.store.node_store.get_node(a))
    assert ok == (200, {"success": True, "data": {"current_task": ok[1]["data"]["current_task"]}})
    assert ok[1]["data"]["current_task"]["id"] == task.id
    assert bad == (401, {"success": False, "error": "address mismatch"})
    assert banned == (401, {"success": False, "error": "node is banned"})


def test_unported_options_are_refused_naming_their_roadmap_items(monkeypatch, capsys, tmp_path):
    ledger = t_chain.Ledger()
    manager = t_sec.Wallet.from_seed(b"manager")
    with pytest.raises(NotImplementedError, match=r"queue A, M3"):
        t_orch.OrchestratorService(ledger, 0, manager, t_store.StoreContext(t_store.KVStore()),
                                   groups_plugin=object())
    base = ["orchestrator", "--ledger-url", "http://127.0.0.1:9", "--pool-id", "0"]
    for extra, item in ((["--kv-url", "http://kv"], "--kv-url"), (["--mode", "api"], "--mode api"),
                        (["--mode", "processor"], "--mode processor")):
        with pytest.raises(SystemExit):
            t_serve.parse_args(base + extra)
        err = capsys.readouterr().err
        assert item in err and "ROADMAP queue A, M4c" in err
    args = t_serve.parse_args(base + ["--device", "cpu", "--state-dir", str(tmp_path)])
    monkeypatch.setenv("MANAGER_KEY", manager.private_key_hex())
    monkeypatch.setenv("NODE_GROUP_CONFIGS", '[{"name": "pair"}]')
    with pytest.raises(SystemExit, match=r"NODE_GROUP_CONFIGS.*queue A, M3"):
        t_serve.build_orchestrator(args)
    monkeypatch.delenv("NODE_GROUP_CONFIGS")
    monkeypatch.setenv("S3_CREDENTIALS", "e30=")
    with pytest.raises(SystemExit, match=r"S3_CREDENTIALS.*queue A, M4c"):
        t_serve.build_orchestrator(args)
    monkeypatch.delenv("S3_CREDENTIALS")
    with pytest.raises(SystemExit, match="unknown --scheduler-backend"):
        t_serve.build_orchestrator(t_serve.parse_args(base + ["--scheduler-backend", "gpu"]))


def test_serve_builds_the_reference_shape_and_reloads_its_journal(monkeypatch, tmp_path):
    """``serve orchestrator``'s service: the KV journal under --state-dir,
    the local matcher on the asked device with its observers, the
    scheduler around it; a second build on the same directory reads the
    first one's tasks and nodes back."""
    manager = t_sec.Wallet.from_seed(b"manager")
    monkeypatch.setenv("MANAGER_KEY", manager.private_key_hex())
    monkeypatch.setenv("PROTOCOL_TPU_DENSE_CELL_BUDGET", "4096")
    args = t_serve.parse_args(["orchestrator", "--ledger-url", "http://127.0.0.1:9",
                               "--pool-id", "3", "--device", "cpu", "--state-dir",
                               str(tmp_path)])
    svc = t_serve.build_orchestrator(args)
    m = svc.scheduler.batch_matcher
    assert isinstance(m, TorchBatchMatcher) and m.device.type == "cpu"
    assert m.dense_cell_budget == 4096 and svc.wallet.address == manager.address
    m._dirty = False
    svc.store.task_store.add_task(t_models.Task(name="t", image="i"))
    assert m._dirty  # the observers are attached
    svc.store.node_store.add_node(t_store.OrchestratorNode(address="0xa"))
    again = t_serve.build_orchestrator(args)
    assert [t.name for t in again.store.task_store.get_all_tasks()] == ["t"]
    assert again.store.node_store.get_node("0xa") is not None
    assert (tmp_path / "orchestrator.aof").exists()
