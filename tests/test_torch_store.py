"""The port's state store, wallet, signed requests and ledger held against
the reference's (``protocol_tpu/store``, ``security``, ``chain``): the KV
store's verbs, TTLs and glob scans answer alike on one op sequence; each
domain store's record written by one package reads the same in the other;
a journal written by either package's ``KVStore`` reloads in the other;
a request signed by either package's wallet (ed25519, evm, evm-recovery)
passes the other's middleware, and a tampered body or a replayed nonce is
refused by both; the invite digest is the same and an invite signed by
either package's wallet joins the other's ledger."""

import asyncio
import time

import pytest
from aiohttp import web
from aiohttp.test_utils import TestClient, TestServer

import protocol_tpu.chain.ledger as r_ledger
import protocol_tpu.models as r_models
import protocol_tpu.security as r_sec
import protocol_tpu.security.middleware as r_mw
import protocol_tpu.store as r_store
import protocol_tpu_torch.chain.ledger as t_ledger
import protocol_tpu_torch.models as t_models
import protocol_tpu_torch.security as t_sec
import protocol_tpu_torch.security.middleware as t_mw
import protocol_tpu_torch.store as t_store

PKG = {"ref": (r_store, r_models, r_sec, r_mw, r_ledger),
       "port": (t_store, t_models, t_sec, t_mw, t_ledger)}
SCHEMES = {"ed25519": "Wallet", "evm": "EvmWallet", "evm-recovery": "EvmRecoveryWallet"}


class Clock:
    def __init__(self, t: float = 1_000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def kv_script(kv, clock: Clock) -> list:
    """One op sequence over every verb family, the TTLs and the glob scans;
    returns every answer."""
    out = [kv.set("s:a", "1"), kv.set("s:a", "2", nx=True), kv.set("s:b", "x", ex=10),
           kv.get("s:a"), kv.mget(["s:a", "s:b", "s:none"]), kv.incr("c"), kv.incr("c", 5),
           kv.exists("s:b"), kv.ttl("s:b"), kv.expire("s:a", 30), kv.expire("s:none", 5),
           kv.hset("h", "f", "1"), kv.hset_mapping("h", {"g": "2", "f": "3"}), kv.hget("h", "f"),
           kv.hgetall("h"), kv.hincrby("h", "n", 4), kv.hdel("h", "g", "nope"),
           kv.sadd("st", "a", "b", "a"), kv.srem("st", "a"), sorted(kv.smembers("st")),
           kv.sismember("st", "b"), kv.scard("st"),
           kv.zadd("z", {"m1": 2.0, "m2": 1.0, "m3": 3.0}), kv.zscore("z", "m1"),
           kv.zrangebyscore("z", 1.5, 9.0), kv.zremrangebyscore("z", 0.0, 1.5), kv.zcard("z"),
           kv.rpush("l", "a", "b", "a"), kv.lpush("l", "z"), kv.lrange("l"), kv.lrange("l", 1, 2),
           kv.lrem("l", 1, "a"), kv.llen("l"),
           kv.pipeline_execute([("set", ["p:1", "v"], {}), ("incr", ["p:n"], {}),
                                ("sadd", ["p:s", "m"], {})]),
           sorted(kv.keys("s:*")), sorted(kv.keys("p:?"))]
    with pytest.raises(TypeError, match="WRONGTYPE"):
        kv.hget("s:a", "f")
    clock.t += 11  # s:b expires, s:a (30 s) does not
    out += [kv.get("s:b"), kv.exists("s:b"), kv.ttl("s:a"), sorted(kv.keys("*"))]
    clock.t += 30
    out += [kv.get("s:a"), sorted(kv.keys("*")), kv.delete("c", "h", "gone")]
    return out


def test_kv_verbs_ttls_and_scans_answer_as_the_reference():
    answers = {}
    for name, (store, *_) in PKG.items():
        clock = Clock()
        answers[name] = kv_script(store.KVStore(time_fn=clock), clock)
    assert answers["port"] == answers["ref"]


def journal_state(kv) -> tuple:
    kv.keys("*")  # expiry is lazy: drop what has expired first
    return ({k: (sorted(v) if isinstance(v, set) else v) for k, v in kv._data.items()},
            dict(kv._expiry))


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_a_journal_reloads_in_the_other_package(tmp_path, writer, reader):
    """Every type, TTLs as absolute deadlines, a compaction mid-way (the
    threshold is low) and ops after it; the reader's state equals the
    writer's, and so does the journal it rewrites at load."""
    path = str(tmp_path / "orchestrator.aof")
    clock = Clock(time.time())
    kv = PKG[writer][0].KVStore(time_fn=clock, persist_path=path, compact_threshold=20)
    kv_script(kv, clock)
    kv.set("ttl:live", "v", ex=3_600)
    kv.set("ttl:gone", "v", ex=1)
    kv.expire("s:none", 5)
    kv.zadd("z2", {"a": 0.5})
    kv.hset_mapping("h2", {"x": "1"})
    kv.set("ttl:gone", "w", ex=1)
    clock.t += 2
    want = journal_state(kv)
    other = PKG[reader][0].KVStore(time_fn=clock, persist_path=path)
    assert journal_state(other) == want
    assert other.get("ttl:gone") is None and other.ttl("ttl:live") > 3_000
    other.close()
    again = PKG[writer][0].KVStore(time_fn=clock, persist_path=path)
    assert journal_state(again) == want


def specs_dict() -> dict:
    return {"gpu": {"count": 8, "model": "H100", "memory_mb": 80_000},
            "cpu": {"cores": 32}, "ram_mb": 65_536, "storage_gb": 2_000}


def node_dict(i: int) -> dict:
    d = {"address": f"0x{i:040x}", "ip_address": f"10.0.0.{i}", "port": 8091,
         "status": "Healthy", "first_seen": 1_700_000_000.5, "compute_specs": specs_dict(),
         "location": {"latitude": 40.0 + i, "longitude": -3.5, "city": "Madrid",
                      "region": None, "country": "ES"},
         "price": 1.25 * i, "load": 0.25, "p2p_id": f"p2p-{i}",
         "p2p_addresses": [f"http://10.0.0.{i}:9000"], "task_id": "t0",
         "task_state": "RUNNING", "version": "1.2", "last_status_change": 1_700_000_100.0}
    return d


TASK = {"name": "train", "id": "3c1f0b56-0000-4000-8000-000000000001", "image": "img:1",
        "env_vars": {"A": "${TASK_ID}"}, "cmd": ["run", "${NODE_ADDRESS}"], "entrypoint": None,
        "state": "PENDING", "created_at": 1_700_000_000_123, "updated_at": None,
        "scheduling_config": {"plugins": {"tpu_scheduler": {
            "compute_requirements": ["gpu:count=8;gpu:model=H100"], "replicas": ["2"]}}},
        "storage_config": {"file_name_template": "${ORIGINAL_NAME}-${CURRENT_FILE_INDEX}"},
        "metadata": {"labels": {"team": "a"}},
        "volume_mounts": [{"host_path": "/d/${TASK_ID}", "container_path": "/data"}]}


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_domain_records_read_the_same_in_the_other_package(writer, reader):
    """One KV store, the writer's domain stores write, the reader's read:
    nodes, tasks (with the observers firing on each side's own store),
    heartbeats with their TTL and unhealthy counters, metrics."""
    w_store, w_models = PKG[writer][:2]
    r_store_, _ = PKG[reader][:2]
    clock = Clock()
    kv = w_store.KVStore(time_fn=clock)
    w = w_store.StoreContext(kv, heartbeat_ttl=90.0)
    r = r_store_.StoreContext(kv, heartbeat_ttl=90.0)
    for i in range(3):
        w.node_store.add_node(w_store.OrchestratorNode.from_dict(node_dict(i)))
    w.node_store.update_node_status(node_dict(1)["address"], w_store.NodeStatus.DEAD)
    assert [n.to_dict() for n in r.node_store.get_nodes()] == [
        n.to_dict() for n in w.node_store.get_nodes()]
    assert r.node_store.get_node(node_dict(2)["address"]).to_dict() == (
        w_store.OrchestratorNode.from_dict(node_dict(2)).to_dict())
    assert [n.address for n in r.node_store.get_uninvited_nodes()] == []

    seen = []
    r.task_store.subscribe_deleted(lambda t: seen.append(("deleted", t.id)))
    w.task_store.add_task(w_models.Task.from_dict(TASK))
    w.task_store.add_task(w_models.Task.from_dict({**TASK, "id": "t2", "name": "other"}))
    assert [t.to_dict() for t in r.task_store.get_all_tasks()] == [
        t.to_dict() for t in w.task_store.get_all_tasks()]
    assert r.task_store.get_task(TASK["id"]).to_dict() == w_models.Task.from_dict(TASK).to_dict()
    assert r.task_store.name_exists("train") and not r.task_store.name_exists("nope")
    r.task_store.delete_task("t2")
    assert seen == [("deleted", "t2")] and not w.task_store.name_exists("other")

    addr = node_dict(0)["address"]
    hb = {"address": addr, "task_id": "t0", "task_state": "RUNNING", "p2p_id": "p",
          "metrics": [{"key": {"task_id": "t0", "label": "loss"}, "value": 0.5}], "load": 0.3,
          "task_details": {"container_id": "c", "container_status": "up", "exit_code": None,
                           "error_message": None}, "extra_task_states": {"t9": "RUNNING"}}
    w.heartbeat_store.beat(w_models.HeartbeatRequest.from_dict(hb))
    assert r.heartbeat_store.get_heartbeat(addr).to_dict() == hb
    assert w.heartbeat_store.increment_unhealthy_counter(addr) == 1
    assert r.heartbeat_store.increment_unhealthy_counter(addr) == 2
    clock.t += 91
    assert r.heartbeat_store.get_heartbeat(addr) is None

    w.metrics_store.store_metrics([w_models.MetricEntry.from_dict(m) for m in hb["metrics"]],
                                  addr)
    assert r.metrics_store.get_all_metrics() == {"t0": {"loss": {addr: 0.5}}}
    r.metrics_store.delete_metrics_for_node(addr)
    assert w.metrics_store.get_all_metrics() == {}


def middleware_app(pkg: str, kv) -> web.Application:
    mw = PKG[pkg][3]

    async def ok(request):
        return web.json_response({"address": request["auth_address"]})

    app = web.Application(middlewares=[mw.validate_signature_middleware(kv, ["/heartbeat"])])
    app.router.add_post("/heartbeat", ok)
    app.router.add_get("/heartbeat", ok)
    return app


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@pytest.mark.parametrize("signer,verifier", [("ref", "port"), ("port", "ref")])
def test_signed_requests_cross_between_the_packages(scheme, signer, verifier):
    """A body signed by the signer's wallet passes the verifier's
    middleware as the same address; the same body replayed, a tampered
    body and a GET replayed are refused."""
    sec = PKG[signer][2]
    wallet = getattr(sec, SCHEMES[scheme]).from_seed(b"node-1")
    twin = getattr(PKG[verifier][2], SCHEMES[scheme]).from_seed(b"node-1")
    assert wallet.address == twin.address
    kv = PKG[verifier][0].KVStore()

    async def flow():
        async with TestClient(TestServer(middleware_app(verifier, kv))) as client:
            headers, body = sec.sign_request("/heartbeat", wallet, {"address": wallet.address})
            r1 = await client.post("/heartbeat", json=body, headers=headers)
            got = (await r1.json())["address"]
            r2 = await client.post("/heartbeat", json=body, headers=headers)
            h3, b3 = sec.sign_request("/heartbeat", wallet, {"address": wallet.address})
            r3 = await client.post("/heartbeat", json={**b3, "load": 0.9}, headers=h3)
            h4, _ = sec.sign_request("/heartbeat", wallet)
            r4 = await client.get("/heartbeat", headers=h4)
            r5 = await client.get("/heartbeat", headers=h4)
            return got, [r.status for r in (r1, r2, r3, r4, r5)], (await r2.json())["error"]

    got, statuses, replay = asyncio.run(flow())
    assert got == wallet.address.lower()
    assert statuses == [200, 401, 401, 200, 401]
    assert replay == "nonce replay"
    # the message-level verifiers agree too, either way round
    message = "/heartbeat1700000000.000000{}"
    sig = wallet.sign_message(message)
    assert PKG[verifier][2].verify_signature(message, sig, wallet.address)
    assert sec.verify_signature(message, twin.sign_message(message), wallet.address)


@pytest.mark.parametrize("signer,ledger", [("ref", "port"), ("port", "ref")])
def test_invites_cross_between_the_packages(signer, ledger):
    """``invite_digest`` is byte-equal; an invite the signer's manager
    wallet signs joins the other package's ledger, and a forged one is
    refused with its ``LedgerError``."""
    assert t_ledger.invite_digest(3, 7, "0xAbC", "n1", 1e12 + 0.7) == r_ledger.invite_digest(
        3, 7, "0xabc", "n1", 1e12 + 0.7)
    lmod = PKG[ledger][4]
    wallets = PKG[signer][2]
    led = lmod.Ledger()
    creator, manager = (wallets.Wallet.from_seed(s) for s in (b"creator", b"manager"))
    provider, node = (wallets.Wallet.from_seed(s) for s in (b"provider-1", b"node-1"))
    led.mint(provider.address, 1_000)
    did = led.create_domain("synth")
    pid = led.create_pool(did, creator.address, manager.address, "")
    led.start_pool(pid, creator.address)
    led.register_provider(provider.address, 100)
    led.add_compute_node(provider.address, node.address)
    led.validate_node(node.address)
    exp = time.time() + 60
    forged = wallets.Wallet.from_seed(b"rogue").sign_message(
        lmod.invite_digest(did, pid, node.address, "n", exp))
    with pytest.raises(lmod.LedgerError, match="invalid invite signature"):
        led.join_compute_pool(pid, provider.address, node.address, "n", exp, forged)
    sig = manager.sign_message(lmod.invite_digest(did, pid, node.address, "n", exp))
    led.join_compute_pool(pid, provider.address, node.address, "n", exp, sig)
    assert led.is_node_in_pool(pid, node.address)
