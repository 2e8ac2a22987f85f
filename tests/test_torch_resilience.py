"""The port's session checkpoints, drain, ``Migrate`` and the fleet router
(``protocol_tpu_torch/faults/checkpoint.py``, ``fleet/fabric.py``,
``dfleet/topology.py`` and the servicer's router in
``services/scheduler_grpc.py``), held against the reference's
(``protocol_tpu/faults``, ``fleet``, ``dfleet``).

- The endpoint ring: ``FleetTopology`` routes 1,000 session ids as the
  reference's does (``endpoint_for``, ``failover_order``, ``without``, a
  dict round trip), and the fabric's shards hash the same way.
- The reference's scenarios (``tests/test_dfleet.py``: the journal
  namespace, the handoff, the live migration bit for bit against a replay,
  the stale redirect, the re-open redirect, the eviction tombstone, the
  matcher's moved redirect, the fences and the zombie;
  ``tests/test_faults.py``: the drain's transient refusal, the drain and
  the warm restart, unloadable journals), re-run against the port's
  servers at ``jax:1`` on the CPU, over loopback, with the port's client
  and with the reference's.
- The journal: a port journal read frame by frame has the META keys of a
  reference journal written for the same session, and a reference journal
  restores in the port as a cold re-ground.
- The tick watchdog serves the previous plan flagged stale, at most
  ``max_stale_ticks`` in a row.

Sizes are 64² traces; arenas run with one torch thread, as in
tests/test_torch_trace.py."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from protocol_tpu.dfleet.topology import FleetTopology as RefTopology
from protocol_tpu.faults import checkpoint as ref_ckpt
from protocol_tpu.fleet.fabric import FleetConfig as RefFleetConfig
from protocol_tpu.fleet.fabric import SessionFabric as RefFabric
from protocol_tpu.services import scheduler_grpc as ref_grpc
from protocol_tpu_torch.dfleet.topology import FleetTopology
from protocol_tpu_torch.faults.checkpoint import (
    SessionCheckpointer,
    handoff_orphans,
    journal_session_id,
    read_fence,
    stamp_fence,
)
from protocol_tpu_torch.fleet.fabric import FleetConfig, SessionFabric, _h
from protocol_tpu_torch.proto import scheduler_pb2 as pb
from protocol_tpu_torch.proto import wire
from protocol_tpu_torch.services import scheduler_grpc as tg
from protocol_tpu_torch.trace import format as tfmt
from protocol_tpu_torch.trace.replay import iter_input_ticks, replay
from protocol_tpu_torch.trace.synth import synth_trace

from tests.test_faults import _assert_shadow_matches_server
from tests.test_scheduler_grpc import _pool_world

KERNEL = "jax:1"
TIMEOUT = 120.0


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def trace6(tmp_path_factory):
    """A 64² trace of 6 ticks (5% churn) and its fault-free replay's plans."""
    path = str(tmp_path_factory.mktemp("trace") / "dfleet.trace")
    synth_trace(path, n_providers=64, n_tasks=64, ticks=6, churn=0.05, seed=3, kernel=KERNEL)
    baseline = replay(path, engine=KERNEL, verify=False, keep_p4t=True, device="cpu")["p4ts"]
    return tfmt.read_trace(path), baseline


def _serve(root, proc_id, **kw):
    """A port server on a free loopback port with its journal root and
    proc id; its endpoint is the bound address."""
    server = tg.serve("127.0.0.1:0", device="cpu",
                      fleet=FleetConfig(shards=2, ckpt_dir=root, proc_id=proc_id, **kw))
    addr = f"127.0.0.1:{server.port}"
    server.servicer.endpoint = addr
    return addr, server


def _serve_pair(root):
    return _serve(root, "p0"), _serve(root, "p1")


def _open_session(client, snap, sid, p_cols, r_cols):
    w = tfmt._as_ns(dict(zip(("price", "load", "proximity", "priority"), snap.weights)))
    fp = wire.epoch_fingerprint(p_cols, r_cols, w, KERNEL, max(int(snap.top_k) or 64, 1),
                                snap.eps, snap.max_iters)
    req = pb.AssignRequestV2(
        providers=wire.encode_providers_v2(tfmt._as_ns(p_cols)),
        requirements=wire.encode_requirements_v2(tfmt._as_ns(r_cols)),
        weights=pb.CostWeights(price=snap.weights[0], load=snap.weights[1],
                               proximity=snap.weights[2], priority=snap.weights[3]),
        kernel=KERNEL, top_k=snap.top_k, eps=snap.eps, max_iters=snap.max_iters,
    )
    chunks = list(wire.chunk_snapshot(sid, fp, req))
    return fp, client.open_session(iter(chunks), timeout=TIMEOUT)


def _delta_request(sid, fp, tick, delta):
    req = pb.AssignDeltaRequest(session_id=sid, epoch_fingerprint=fp, tick=tick)
    if delta.provider_rows.size:
        req.provider_rows.CopyFrom(wire.blob(delta.provider_rows, np.int32))
        req.providers.CopyFrom(wire.encode_providers_v2(tfmt._as_ns(delta.p_cols)))
    if delta.task_rows.size:
        req.task_rows.CopyFrom(wire.blob(delta.task_rows, np.int32))
        req.requirements.CopyFrom(wire.encode_requirements_v2(tfmt._as_ns(delta.r_cols)))
    return req


def _stop(*servers):
    for s in servers:
        s.stop(grace=None)


# ---------------- the endpoint ring ----------------


def test_topology_routes_as_the_reference():
    eps = ["a:1", "b:2", "c:3", "d:4"]
    mine, ref = FleetTopology(eps, vnodes=32), RefTopology(eps, vnodes=32)
    sids = [f"t{i % 7}@sess-{i}" for i in range(1000)]
    assert [mine.endpoint_for(s) for s in sids] == [ref.endpoint_for(s) for s in sids]
    assert [mine.failover_order(s) for s in sids] == [ref.failover_order(s) for s in sids]
    gone_m, gone_r = mine.without("b:2"), ref.without("b:2")
    assert gone_m.generation == gone_r.generation == 1
    assert [gone_m.endpoint_for(s) for s in sids] == [gone_r.endpoint_for(s) for s in sids]
    assert gone_m.to_dict() == gone_r.to_dict()
    rt = FleetTopology.from_dict(json.loads(json.dumps(ref.with_endpoint("e:5", "p9").to_dict())))
    assert rt.procs["e:5"] == "p9" and rt.generation == 1
    assert [rt.endpoint_for(s) for s in sids[:64]] == [
        ref.with_endpoint("e:5", "p9").endpoint_for(s) for s in sids[:64]]
    # the in-process shards hash the same way too
    f_m, f_r = SessionFabric(shards=4), RefFabric(shards=4)
    assert [f_m.shard_index(s) for s in sids] == [f_r.shard_index(s) for s in sids]
    from protocol_tpu.fleet.fabric import _h as ref_h

    assert all(_h(s) == ref_h(s) for s in sids[:100])


def test_fleet_config_reads_the_reference_environment(monkeypatch):
    for name, value in (("SHARDS", "3"), ("MAX_BYTES", "1000"), ("QUEUE_DEPTH", "2"),
                        ("CKPT_DIR", "/j"), ("CKPT_EVERY", "3"), ("TICK_DEADLINE_MS", "7.5"),
                        ("MAX_STALE", "4"), ("PROC_ID", "p7"), ("ENDPOINT", "10.0.0.7:50061")):
        monkeypatch.setenv(f"PROTOCOL_TPU_FLEET_{name}", value)
    mine, theirs = FleetConfig.from_env(), dict(vars(RefFleetConfig.from_env()))
    # the reference's weighted thread budget of its native engines (M5),
    # which no variable sets and the port does not carry
    assert theirs.pop("tenant_weights") is None
    assert vars(mine) == theirs


# ---------------- the journal namespace and the handoff ----------------


@pytest.fixture()
def flushed(tmp_path, trace6):
    """A journal in p0's namespace, written over the wire (ticks 0 and 1)."""
    trace, _ = trace6
    root = str(tmp_path / "journals")
    (addr_a, a), (_addr_b, b) = _serve_pair(root)
    sid = "t0@ns-test"
    client = tg.SchedulerBackendClient(addr_a)
    try:
        ticks = list(iter_input_ticks(trace))
        fp, resp = _open_session(client, trace.snapshot, sid, ticks[0][1], ticks[0][2])
        assert resp.ok, resp.error
        resp = client.assign_delta(_delta_request(sid, fp, 1, ticks[1][3]), timeout=TIMEOUT)
        assert resp.session_ok, resp.error
        yield root, sid, 1
    finally:
        client.close()
        _stop(a, b)


def test_namespace_is_exclusive(flushed):
    root, sid, tick = flushed
    p0 = SessionCheckpointer(root, proc_id="p0", device="cpu")
    p1 = SessionCheckpointer(root, proc_id="p1", device="cpu")
    assert journal_session_id(p0.path_for(sid)) == sid
    assert p1.load_one(sid) is None
    restored = p0.load_one(sid)
    assert restored is not None and restored.tick == tick


def test_handoff_moves_ownership_atomically(flushed):
    root, sid, tick = flushed
    p0 = SessionCheckpointer(root, proc_id="p0", device="cpu")
    p1 = SessionCheckpointer(root, proc_id="p1", device="cpu")
    assert p0.handoff(sid, "p1") is True
    assert p0.handoff(sid, "p1") is False
    assert p0.load_one(sid) is None
    restored = p1.load_one(sid)
    assert restored is not None and restored.tick == tick and restored.last_p4t is not None
    # concurrent loads from the other side never break exclusivity
    for i in range(4):
        owner, other = (p1, p0) if i % 2 == 0 else (p0, p1)
        got = []
        th = threading.Thread(target=lambda: got.append(other.load_one(sid)))
        th.start()
        assert owner.handoff(sid, other.proc_id) is True
        th.join()
        assert owner.load_one(sid) is None
        assert other.load_one(sid).session_id == sid
        assert all(r is None or r.session_id == sid for r in got)
    # orphans re-route by their META's session id
    assert handoff_orphans(root, "p1", lambda s: "p2") == [(sid, "p2")]
    assert SessionCheckpointer(root, proc_id="p2", device="cpu").load_one(sid).tick == tick
    assert handoff_orphans(root, "p2", lambda s: None) == []


def test_journal_meta_keys_equal_the_reference(flushed, tmp_path):
    """The port's journal, read frame by frame with the port's reader, has
    the META keys (and arena keys) of the reference's journal for the same
    session, and the reference's restores in the port as a cold re-ground
    (another provenance tag), then solves."""
    root, sid, tick = flushed
    mine = SessionCheckpointer(root, proc_id="p0", device="cpu")
    port_session = mine.load_one(sid)
    frames = list(tfmt.read_frames(mine.path_for(sid)))
    kinds = [k for k, _ in frames]
    assert kinds == [tfmt.KIND_META, tfmt.KIND_SNAPSHOT, tfmt.KIND_ARENA, tfmt.KIND_OUTCOME]
    port_meta = json.loads(frames[0][1])
    # the reference's checkpointer writes the same session: its arena from
    # the same columns at the same cursor
    from protocol_tpu.ops.cost import CostWeights as JW
    from protocol_tpu.services.session_store import SolveSession as RefSession
    from protocol_tpu.services.session_store import make_solve_arena as ref_arena

    arena = ref_arena("jax", k=port_session.top_k, threads=1)
    arena.solve(tfmt._as_ns(port_session.p_cols), tfmt._as_ns(port_session.r_cols),
                JW(*[float(x) for x in port_meta["weights"]]))
    ref_session = RefSession(
        session_id=sid, fingerprint=port_session.fingerprint,
        weights=JW(*port_meta["weights"]), kernel=port_session.kernel, threads=1,
        top_k=port_session.top_k, p_cols=port_session.p_cols, r_cols=port_session.r_cols,
        n_providers=port_session.n_providers, n_tasks=port_session.n_tasks, arena=arena,
        tick=tick,
    )
    ref_session.last_p4t = port_session.last_p4t
    ref_session.last_delta_crc = port_session.last_delta_crc
    ref_session.delta_rows_total = port_session.delta_rows_total
    ref_root = str(tmp_path / "ref")
    theirs = ref_ckpt.SessionCheckpointer(ref_root, proc_id="p0")
    assert theirs.flush_locked(ref_session)
    ref_frames = list(tfmt.read_frames(theirs.path_for(sid)))
    assert [k for k, _ in ref_frames] == kinds
    ref_meta = json.loads(ref_frames[0][1])
    assert set(port_meta) == set(ref_meta)
    assert set(port_meta["arena"]) == set(ref_meta["arena"])
    for key in ("kind", "session_id", "fingerprint", "kernel", "threads", "top_k", "weights",
                "n_providers", "n_tasks", "tick", "last_delta_crc", "delta_rows_total",
                "version"):
        assert port_meta[key] == ref_meta[key], key
    assert port_meta["arena"]["native_isa"] == "torch:cpu"
    assert set(tfmt.unpack_arrays(frames[2][1])) == set(tfmt.unpack_arrays(ref_frames[2][1]))
    # the reference's journal in the port: a cold re-ground, never an error
    port_reader = SessionCheckpointer(ref_root, proc_id="p0", device="cpu")
    restored = port_reader.load_one(sid)
    assert restored is not None and restored.tick == tick
    assert restored.arena._p4t is None  # the carry was not honoured
    p4t, _, _ = restored.solve()
    assert restored.arena.last_stats["cold"] is True and (p4t >= 0).any()


def test_unloadable_checkpoints_are_skipped_not_fatal(tmp_path):
    ckpt = SessionCheckpointer(str(tmp_path), device="cpu")
    ns = tmp_path / "p0"
    (ns / "torn.ckpt").write_bytes(b"PTTRACE1garbage")
    (ns / "empty.ckpt").write_bytes(b"")
    with tfmt.TraceWriter(str(ns / "native.ckpt"), meta={
            "kind": "session-checkpoint", "session_id": "x", "kernel": "native-mt:2"}) as w:
        w.write_snapshot("x", "fp", pb.AssignRequestV2())
    assert ckpt.load_all() == []
    assert ckpt.journals_skipped == 3
    assert ckpt.due(0) and ckpt.due(1)
    every3 = SessionCheckpointer(str(tmp_path), every=3, device="cpu")
    assert [t for t in range(7) if every3.due(t)] == [0, 3, 6]


# ---------------- live migration over the wire ----------------


@pytest.mark.parametrize("client_pkg", ["port", "reference"])
def test_mid_stream_migration_is_warm_and_bit_identical(tmp_path, trace6, client_pkg):
    """A session mid-stream is migrated (A -> B) after tick 2 and resumed
    at B: every plan equals the fault-free replay bit for bit, the last
    tick's retransmit replays its twin across the boundary, and B repaired
    the carried candidates warm."""
    trace, baseline = trace6
    client_cls = (tg.SchedulerBackendClient if client_pkg == "port"
                  else ref_grpc.SchedulerBackendClient)
    root = str(tmp_path / "journals")
    (addr_a, a), (addr_b, b) = _serve_pair(root)
    sid = "t0@mig"
    client = client_cls(addr_a)
    redirects = server_tick = 0
    last_req = last_p4t = fp = None
    try:
        for tick, p_cols, r_cols, delta in iter_input_ticks(trace):
            if tick == 0:
                fp, resp = _open_session(client, trace.snapshot, sid, p_cols, r_cols)
                assert resp.ok, resp.error
                p4t = wire.unblob(resp.result.provider_for_task, np.int32)
            else:
                if tick == 3:
                    if client_pkg == "port":
                        mresp = client.migrate(pb.MigrateRequest(
                            target_endpoint=addr_b, target_proc_id="p1"))
                        assert mresp.ok and mresp.moved == 1
                    else:
                        assert a.servicer.migrate_out(addr_b, "p1") == 1
                req = _delta_request(sid, fp, server_tick + 1, delta)
                resp = client.assign_delta(req, timeout=TIMEOUT)
                if not resp.session_ok and resp.error.startswith("moved:"):
                    assert resp.error == f"moved:{addr_b}"
                    redirects += 1
                    client.close()
                    client = client_cls(addr_b)
                    resp = client.assign_delta(req, timeout=TIMEOUT)
                assert resp.session_ok and not resp.replayed, f"tick {tick}: {resp.error}"
                server_tick += 1
                p4t = wire.unblob(resp.result.provider_for_task, np.int32)
                last_req, last_p4t = req, p4t
            assert np.array_equal(p4t, baseline[tick]), f"tick {tick}"
        assert redirects == 1
        resp = client.assign_delta(last_req, timeout=TIMEOUT)
        assert resp.session_ok and resp.replayed
        assert np.array_equal(wire.unblob(resp.result.provider_for_task, np.int32), last_p4t)
        seam_a, seam_b = a.servicer.seam.snapshot(), b.servicer.seam.snapshot()
        assert seam_a.get("session_session_migrated_out") == 1
        assert seam_a.get("session_moved_refused") == 1
        assert seam_b.get("session_session_rehydrated") == 1
        assert seam_a.get("session_session_open") == 1 and "session_session_open" not in seam_b
        session, _ = b.servicer.sessions.get(sid, fp)
        assert session.arena.last_stats["cold"] is False
        assert session.arena.last_stats["cand_cold_passes"] == 0
    finally:
        client.close()
        _stop(a, b)


def test_rerouted_journal_clears_stale_redirect(tmp_path, trace6):
    trace, _ = trace6
    root = str(tmp_path / "journals")
    (addr_a, a), (addr_b, b) = _serve_pair(root)
    sid = "t0@boomerang"
    client = tg.SchedulerBackendClient(addr_a)
    try:
        ticks = list(iter_input_ticks(trace))
        fp, resp = _open_session(client, trace.snapshot, sid, ticks[0][1], ticks[0][2])
        assert resp.ok
        assert a.servicer.migrate_out(addr_b, "p1") == 1
        client_b = tg.SchedulerBackendClient(addr_b)
        resp = client_b.assign_delta(_delta_request(sid, fp, 1, ticks[1][3]), timeout=TIMEOUT)
        assert resp.session_ok, resp.error
        client_b.close()
        b.stop(grace=None)
        assert handoff_orphans(root, "p1", lambda s: "p0") == [(sid, "p0")]
        resp = client.assign_delta(_delta_request(sid, fp, 2, ticks[2][3]), timeout=TIMEOUT)
        assert resp.session_ok, resp.error
        seam_a = a.servicer.seam.snapshot()
        assert seam_a.get("session_session_rehydrated") == 1
        assert "session_moved_refused" not in seam_a
    finally:
        client.close()
        _stop(a, b)


def test_reopen_at_old_home_is_redirected(tmp_path, trace6):
    trace, _ = trace6
    root = str(tmp_path / "journals")
    (addr_a, a), (addr_b, b) = _serve_pair(root)
    sid = "t0@reopen"
    client = ref_grpc.SchedulerBackendClient(addr_a)  # the reference's client
    try:
        ticks = list(iter_input_ticks(trace))
        _fp, resp = _open_session(client, trace.snapshot, sid, ticks[0][1], ticks[0][2])
        assert resp.ok
        assert a.servicer.migrate_out(addr_b, "p1") == 1
        _fp, resp = _open_session(client, trace.snapshot, sid, ticks[0][1], ticks[0][2])
        assert not resp.ok and resp.error == f"moved:{addr_b}"
    finally:
        client.close()
        _stop(a, b)


def test_eviction_tombstone_preserves_reopen_contract(tmp_path, trace6):
    trace, _ = trace6
    root = str(tmp_path / "journals")
    (addr_a, a), (_addr_b, b) = _serve_pair(root)
    sid = "t0@evict"
    client = tg.SchedulerBackendClient(addr_a)
    try:
        ticks = list(iter_input_ticks(trace))
        fp, resp = _open_session(client, trace.snapshot, sid, ticks[0][1], ticks[0][2])
        assert resp.ok
        assert a.servicer.sessions.shard_of(sid).evict(sid, "chaos")
        resp = client.assign_delta(_delta_request(sid, fp, 1, ticks[1][3]), timeout=TIMEOUT)
        assert not resp.session_ok and "unknown session" in resp.error
        assert "session_session_rehydrated" not in a.servicer.seam.snapshot()
        _fp, resp = _open_session(client, trace.snapshot, sid, ticks[0][1], ticks[0][2])
        assert resp.ok
    finally:
        client.close()
        _stop(a, b)


# ---------------- fences ----------------


def test_fence_stamp_is_monotonic_and_adopted(tmp_path):
    root = str(tmp_path)
    assert read_fence(root, "p0")["epoch"] == 0
    assert stamp_fence(root, "p0") == 1
    assert stamp_fence(root, "p0", topology={"g": 1}) == 2
    ck = SessionCheckpointer(root, proc_id="p0", device="cpu")
    assert ck.fence_epoch == 2 and not ck.fence_superseded()
    # the reference's stamp is read the same way (one file, one counter)
    assert ref_ckpt.stamp_fence(root, "p0") == 3
    assert ck.fence_superseded() and ck.fence_state()["epoch"] == 3
    assert read_fence(root, "p0") == ref_ckpt.read_fence(root, "p0")


def test_superseded_fence_refuses_flush(tmp_path, trace6):
    trace, _ = trace6
    root = str(tmp_path / "journals")
    (addr_a, a), (_addr_b, b) = _serve_pair(root)
    sid = "t0@flushfence"
    client = tg.SchedulerBackendClient(addr_a)
    try:
        ticks = list(iter_input_ticks(trace))
        _fp, resp = _open_session(client, trace.snapshot, sid, ticks[0][1], ticks[0][2])
        assert resp.ok, resp.error
        stamp_fence(root, "p0")
        assert a.servicer.finish_drain() == 0
        assert a.servicer.ckpt.fence_refusals >= 1
    finally:
        client.close()
        _stop(a, b)


def test_zombie_is_fence_refused_and_survivor_serves_warm(tmp_path, trace6):
    trace, _ = trace6
    root = str(tmp_path / "journals")
    (addr_a, a), (addr_b, b) = _serve_pair(root)
    sid = "t0@zombie"
    client = tg.SchedulerBackendClient(addr_a)
    try:
        ticks = list(iter_input_ticks(trace))
        fp, resp = _open_session(client, trace.snapshot, sid, ticks[0][1], ticks[0][2])
        assert resp.ok, resp.error
        resp = client.assign_delta(_delta_request(sid, fp, 1, ticks[1][3]), timeout=TIMEOUT)
        assert resp.session_ok, resp.error
        topo = FleetTopology([addr_b], procs={addr_b: "p1"}, generation=1)
        stats: dict = {}
        moved = handoff_orphans(root, "p0", lambda s: "p1", topology=topo.to_dict(), stats=stats)
        assert moved == [(sid, "p1")] and stats["fence_epoch"] == 1
        resp = client.assign_delta(_delta_request(sid, fp, 2, ticks[2][3]), timeout=TIMEOUT)
        assert not resp.session_ok and resp.error == f"moved:{addr_b}"
        _fp2, resp2 = _open_session(client, trace.snapshot, sid, ticks[0][1], ticks[0][2])
        assert not resp2.ok and resp2.error == f"moved:{addr_b}"
        assert a.servicer.seam.snapshot().get("session_fence_refused") == 2
        assert a.servicer.finish_drain() == 0
        cb = tg.SchedulerBackendClient(addr_b)
        try:
            resp = cb.assign_delta(_delta_request(sid, fp, 2, ticks[2][3]), timeout=TIMEOUT)
            assert resp.session_ok, resp.error
            seam_b = b.servicer.seam.snapshot()
            assert seam_b.get("session_session_rehydrated") == 1
            assert "session_session_open" not in seam_b
        finally:
            cb.close()
    finally:
        client.close()
        _stop(a, b)


# ---------------- the tick watchdog ----------------


def test_tick_watchdog_serves_stale_within_its_bound(tmp_path, trace6):
    """A spent deadline serves the previous plan flagged stale (the delta
    applied), at most max_stale_ticks in a row, then solves regardless."""
    trace, _ = trace6
    addr, server = _serve(str(tmp_path), "p0", tick_deadline_ms=1e-6, max_stale_ticks=2)
    client = tg.SchedulerBackendClient(addr)
    sid = "t0@stale"
    try:
        ticks = list(iter_input_ticks(trace))
        fp, resp = _open_session(client, trace.snapshot, sid, ticks[0][1], ticks[0][2])
        assert resp.ok
        flags = []
        for tick in range(1, 5):
            r = client.assign_delta(_delta_request(sid, fp, tick, ticks[tick][3]),
                                    timeout=TIMEOUT)
            assert r.session_ok, r.error
            flags.append((r.stale, r.staleness_ticks))
        # the first delta has no solve wall yet (EWMA 0) but the deadline
        # is already spent: stale; two in a row, then a solve, then stale
        assert flags == [(True, 1), (True, 2), (False, 0), (True, 1)]
        assert server.servicer.seam.snapshot().get("session_stale_served") == 3
        session, _ = server.servicer.sessions.get(sid, fp)
        assert session.tick == 4 and session.stale_streak == 1
    finally:
        client.close()
        server.stop(grace=None)


# ---------------- drain and the warm restart, through the matchers ----------------


def _remote(store, addr, pkg="port", **kw):
    if pkg == "port":
        return tg.RemoteBatchMatcher(store, addr, min_solve_interval=0.0, wire="v2",
                                     native_fallback=True, native_engine="torch:1", **kw)
    return ref_grpc.RemoteBatchMatcher(store, addr, min_solve_interval=0.0, wire="v2",
                                       native_fallback=True, native_engine="jax:1", **kw)


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_draining_refusal_is_transient_on_the_ladder(tmp_path, pkg):
    addr, server = _serve(str(tmp_path), "p0")
    m = _remote(_pool_world(), addr, pkg)
    try:
        server.servicer.draining = True
        m.refresh()
        snap = m.seam.snapshot()
        assert snap.get("session_session_transient_refusal") == 1
        assert m._session is None and not m._session_refused and m._assignment
        assert server.servicer.seam.snapshot().get("session_drain_refused") == 1
        server.servicer.draining = False
        m.refresh()
        assert m._session is not None and m._session["tick"] == 0
    finally:
        m.client.close()
        server.stop(grace=None)


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_drain_flushes_and_restart_resumes_warm(tmp_path, pkg):
    fleet = FleetConfig(shards=2, ckpt_dir=str(tmp_path))
    server = tg.serve("127.0.0.1:0", device="cpu", fleet=fleet)
    addr = f"127.0.0.1:{server.port}"
    m = _remote(_pool_world(), addr, pkg, retry_base_s=0.01)
    try:
        m.refresh()
        m.refresh()
        assert m._session["tick"] == 1
        assert tg.drain(server) == 1
        assert list(tmp_path.glob("**/*.ckpt"))
        server = tg.serve(addr, device="cpu", fleet=fleet)
        assert server.servicer.seam.snapshot().get("session_session_restored") == 1
        m.refresh()
        assert m._session["tick"] == 2
        assert "session_session_reopen" not in m.seam.snapshot()
        assert m._assignment
        _assert_shadow_matches_server(m, server)
        health = {s.name: s.value for s in tg.SchedulerBackendClient(addr).health().seam_metrics}
        assert health["ckpt_flushes"] >= 1 and health["sessions_active"] == 1
        server.servicer.sessions.drop(m._session["id"])
        assert not list(tmp_path.glob("**/*.ckpt"))
    finally:
        m.client.close()
        server.stop(grace=None)


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_moved_redirect_resumes_warm_without_reopen(tmp_path, pkg):
    root = str(tmp_path / "journals")
    (addr_a, a), (addr_b, b) = _serve_pair(root)
    m = _remote(_pool_world(), [addr_a, addr_b], pkg, retry_base_s=0.01)
    try:
        m.refresh()
        m.refresh()
        assert m._session["tick"] == 1
        assert a.servicer.migrate_out(addr_b, "p1") == 1
        m.refresh()
        snap = m.seam.snapshot()
        assert snap.get("session_moved_redirect") == 1
        assert "session_session_reopen" not in snap
        assert m._session["tick"] == 2 and m._assignment
        assert b.servicer.seam.snapshot().get("session_session_rehydrated") == 1
    finally:
        m.client.close()
        _stop(a, b)


def test_kill_plus_handoff_fails_over_warm(tmp_path):
    root = str(tmp_path / "journals")
    (addr_a, a), (addr_b, b) = _serve_pair(root)
    m = _remote(_pool_world(), [addr_a, addr_b], retry_base_s=0.01, retries=4)
    try:
        m.refresh()
        m.refresh()
        a.stop(grace=None)
        assert handoff_orphans(root, "p0", lambda s: "p1") == [(m._session["id"], "p1")]
        m.refresh()
        snap = m.seam.snapshot()
        assert "session_session_reopen" not in snap and m._session["tick"] == 2
        assert b.servicer.seam.snapshot().get("session_session_rehydrated") == 1
    finally:
        m.client.close()
        _stop(a, b)


def test_servicer_journals_stay_in_their_namespace(tmp_path, trace6):
    """Two servicers on one root write only under their own proc id, and a
    restarted one restores only its own."""
    trace, _ = trace6
    root = str(tmp_path)
    (addr_a, a), (addr_b, b) = _serve_pair(root)
    try:
        ticks = list(iter_input_ticks(trace))
        for addr, sid in ((addr_a, "t0@x"), (addr_b, "t0@y")):
            c = tg.SchedulerBackendClient(addr)
            assert _open_session(c, trace.snapshot, sid, ticks[0][1], ticks[0][2])[1].ok
            c.close()
        assert sorted(os.listdir(os.path.join(root, "p0"))) == [
            os.path.basename(a.servicer.ckpt.path_for("t0@x"))]
        assert sorted(os.listdir(os.path.join(root, "p1"))) == [
            os.path.basename(b.servicer.ckpt.path_for("t0@y"))]
    finally:
        _stop(a, b)
    _addr, again = _serve(root, "p1")
    try:
        assert [s.session_id for s in again.servicer.sessions.snapshot_sessions()] == ["t0@y"]
    finally:
        again.stop(grace=None)


# ---------------- the fabric (tests/test_fleet.py's scenarios, both packages) ----------------


def _fabric_kit(pkg):
    """(SessionFabric, a session maker) of either package."""
    if pkg == "port":
        from protocol_tpu_torch.services.session_store import SolveSession
    else:
        from protocol_tpu.services.session_store import SolveSession
    cls = SessionFabric if pkg == "port" else RefFabric

    def mk(sid, nbytes=1000):
        return SolveSession(session_id=sid, fingerprint="fp", weights=None, kernel="jax:1",
                            threads=1, top_k=16, p_cols={}, r_cols={}, n_providers=0, n_tasks=0,
                            arena=None, arena_bytes=nbytes)

    return cls, mk


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_fabric_lru_budgets_and_sweep_as_the_reference(pkg):
    Fabric, mk = _fabric_kit(pkg)
    f = Fabric(shards=1, max_sessions=2)
    a, b, c = mk("a"), mk("b"), mk("c")
    for s in (a, b, c):
        f.put(s)
    assert len(f) == 2 and a.evicted and not c.evicted
    f = Fabric(shards=3, max_sessions=8)
    s = mk("ten@x")
    f.put(s)
    assert f.get("ten@x", "fp") == (s, "")
    assert "fingerprint" in f.get("ten@x", "other")[1]
    f.drop("ten@x")
    assert len(f) == 0 and s.evicted
    # the count cap evicts the least recently used session on any shard
    f = Fabric(shards=4, max_sessions=3)
    ss = [mk(f"s{i}") for i in range(4)]
    for s in ss[:3]:
        f.put(s)
    f.get("s0", "fp")
    f.put(ss[3])
    assert len(f) == 3 and ss[1].evicted and not ss[0].evicted and not ss[3].evicted
    # the byte roll-up, its release, and a drop is no eviction
    f = Fabric(shards=2, max_sessions=64)
    for sid, n in (("a@1", 1000), ("a@2", 500), ("b@1", 2000)):
        f.put(mk(sid, n))
    assert (f.total_bytes, f.tenant_bytes("a"), f.tenant_bytes("b")) == (3500, 1500, 2000)
    f.drop("a@1")
    f.drop("a@2")
    assert f.total_bytes == 2000 and "a" not in f.snapshot()["tenant_bytes"]
    assert f.snapshot()["evictions_by_tenant"] == {}
    # the fleet's byte budget evicts the global LRU, never the new session
    f = Fabric(shards=2, max_sessions=64, max_bytes=2500)
    first, newest = mk("a@1"), mk("b@1")
    f.put(first)
    f.put(mk("a@2"))
    f.put(newest)
    assert f.total_bytes == 2000 and first.evicted and not newest.evicted
    assert f.snapshot()["pressure_evictions"] == 1
    assert f.snapshot()["evictions_by_tenant"] == {"a": 1}
    # a tenant's budget evicts that tenant's LRU
    f = Fabric(shards=2, max_sessions=64, tenant_max_bytes=1500)
    a1, b1, a2 = mk("a@1"), mk("b@1"), mk("a@2")
    for s in (a1, b1, a2):
        f.put(s)
    assert a1.evicted and not b1.evicted and not a2.evicted and f.tenant_bytes("a") == 1000
    # the sweep releases an idle session's bytes with no access
    f = Fabric(shards=4, max_sessions=64)
    live, idle = mk("live@1", 700), mk("idle@1", 900)
    f.put(live)
    f.put(idle)
    idle.last_used -= 10_000.0
    assert f.sweep() == 1 and idle.evicted and not live.evicted
    assert f.total_bytes == 700 and f.tenant_bytes("idle") == 0


def test_arena_byte_estimate_equals_the_reference():
    from protocol_tpu.fleet.fabric import estimate_arena_bytes as ref_estimate
    from protocol_tpu_torch.fleet.fabric import estimate_arena_bytes

    for n, k in ((64, 16), (1024, 16), (1000, 64)):
        p = {name: np.zeros(n, dt) for name, dt in wire.P_WIRE_DTYPES.items()}
        r = {name: np.zeros(n, dt) for name, dt in wire.R_WIRE_DTYPES.items()}
        assert estimate_arena_bytes(p, r, k) == ref_estimate(p, r, k) > 0
