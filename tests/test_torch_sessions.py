"""The port's v2 sessions on the CPU (``protocol_tpu_torch/services/
session_store.py`` and the session RPCs of ``services/scheduler_grpc.py``),
held against the reference's (``protocol_tpu/services/``).

- The store: LRU and TTL eviction, drop, targeted eviction, the LRU
  candidate, the lookup's refusal reasons; a session's copy-on-write delta
  application and its checks; the queued-tick bound.
- The RPCs: one request sequence goes to the reference's ``serve()`` and to
  the port's ``serve(device="cpu")`` over loopback channels: an
  ``OpenSession`` at ``jax:1``, three ``AssignDelta`` ticks of provider and
  task churn, a byte-identical retransmit (replayed from the cache), then
  each refusal: an unknown session, a fingerprint mismatch, a tick out of
  step, a retransmit with other bytes (the CRC check), a kernel sessions
  cannot serve, a bad row index. Every answer agrees: the same ``ok`` /
  ``session_ok`` / ``replayed`` / error text, and at proximity 0 the same
  ``provider_for_task``.
- What only the port refuses: the native engines and stream sessions
  (ROADMAP queue A, M5), and event-typed deltas on a batch session.

Arenas run with one torch thread, as in tests/test_torch_trace.py."""

import socket

import grpc
import numpy as np
import pytest
import torch

from protocol_tpu.proto import scheduler_pb2 as rpb
from protocol_tpu.services import scheduler_grpc as ref_grpc
from protocol_tpu_torch.ops.cost import CostWeights
from protocol_tpu_torch.proto import scheduler_pb2 as pb
from protocol_tpu_torch.proto import wire
from protocol_tpu_torch.services import scheduler_grpc as tg
from protocol_tpu_torch.services import session_store as ss
from protocol_tpu_torch.trace.synth import synth_provider_arrays, synth_requirement_arrays

TIMEOUT = 120.0
P, T = 96, 128
ZERO_PROX = CostWeights(proximity=0.0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def servers():
    """(the port's client, the reference's client) on loopback servers."""
    port = tg.serve("127.0.0.1:0", device="cpu")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        ref_port = s.getsockname()[1]
    ref = ref_grpc.serve(address=f"127.0.0.1:{ref_port}")
    clients = (tg.SchedulerBackendClient(f"127.0.0.1:{port.port}"),
               ref_grpc.SchedulerBackendClient(f"127.0.0.1:{ref_port}"))
    yield clients
    for c in clients:
        c.close()
    port.stop(grace=None)
    ref.stop(grace=None)


def columns(seed: int = 1):
    p = {n: np.ascontiguousarray(a, wire.P_WIRE_DTYPES[n])
         for n, a in synth_provider_arrays(np.random.default_rng(seed), P).items()}
    r = {n: np.ascontiguousarray(a, wire.R_WIRE_DTYPES[n])
         for n, a in synth_requirement_arrays(np.random.default_rng(seed + 1), T).items()}
    return p, r


def open_request(p_cols, r_cols, kernel="jax:1", session_id="s1@tenant", fp=None,
                 stream_mode=False):
    req = pb.AssignRequestV2(
        providers=wire.encode_providers_v2(ss._as_ns(p_cols)),
        requirements=wire.encode_requirements_v2(ss._as_ns(r_cols)),
        weights=pb.CostWeights(price=1.0, load=1.0, proximity=0.0, priority=0.0),
        kernel=kernel, top_k=16, eps=0.02, stream_mode=stream_mode,
    )
    if fp is None:
        fp = wire.epoch_fingerprint(p_cols, r_cols, ZERO_PROX, kernel, 16, 0.02, 0)
    return list(wire.chunk_snapshot(session_id, fp, req, chunk_bytes=4096)), fp


def delta_request(session_id, fp, tick, prow=None, p_rows=None, trow=None, r_rows=None):
    req = pb.AssignDeltaRequest(session_id=session_id, epoch_fingerprint=fp, tick=tick)
    if prow is not None:
        req.provider_rows.CopyFrom(wire.blob(prow, np.int32))
        req.providers.CopyFrom(wire.encode_providers_v2(ss._as_ns(p_rows)))
    if trow is not None:
        req.task_rows.CopyFrom(wire.blob(trow, np.int32))
        req.requirements.CopyFrom(wire.encode_requirements_v2(ss._as_ns(r_rows)))
    return req


def both(servers, msg):
    """The same request to the port's server and the reference's: the two
    answers, or the two status codes where the call fails."""
    out = []
    for client, mod in zip(servers, (pb, rpb)):
        if isinstance(msg, list):  # a snapshot stream
            req = [getattr(mod, "SnapshotChunk").FromString(m.SerializeToString()) for m in msg]
            fn = lambda r: client.open_session(iter(r), timeout=TIMEOUT)  # noqa: E731
        else:
            req = getattr(mod, type(msg).__name__).FromString(msg.SerializeToString())
            fn = lambda r: client.assign_delta(r, timeout=TIMEOUT)  # noqa: E731
        try:
            out.append(fn(req))
        except grpc.RpcError as e:
            out.append(e.code())
    return out


def p4t_of(resp):
    return np.frombuffer(resp.result.provider_for_task.data, np.int32)


def test_session_rpcs_answer_as_the_reference(servers):
    p_cols, r_cols = columns()
    chunks, fp = open_request(p_cols, r_cols)
    mine, ref = both(servers, chunks)
    assert mine.ok and ref.ok and mine.epoch_fingerprint == ref.epoch_fingerprint == fp
    assert mine.session_id == ref.session_id == "s1@tenant"
    np.testing.assert_array_equal(p4t_of(mine), p4t_of(ref))
    rng = np.random.default_rng(3)
    sent = []
    for tick in (1, 2, 3):
        prow = np.sort(rng.choice(P, 4, replace=False)).astype(np.int32)
        p_rows = {n: a[prow].copy() for n, a in p_cols.items()}
        p_rows["price"] = rng.uniform(0.5, 4.0, prow.size).astype(np.float32)
        trow = r_rows = None
        if tick == 2:  # requirement churn too
            trow = np.array([3, 77], np.int32)
            r_rows = {n: a[trow].copy() for n, a in r_cols.items()}
            r_rows["ram_mb"] = np.int32([65536, -1])
        req = delta_request("s1@tenant", fp, tick, prow, p_rows, trow, r_rows)
        sent.append(req)
        mine, ref = both(servers, req)
        assert mine.session_ok and ref.session_ok, (mine.error, ref.error)
        assert not mine.replayed and not ref.replayed
        np.testing.assert_array_equal(p4t_of(mine), p4t_of(ref))
    # a byte-identical retransmit of tick 3 replays the cached answer
    mine, ref = both(servers, sent[-1])
    assert mine.session_ok and ref.session_ok and mine.replayed and ref.replayed
    np.testing.assert_array_equal(p4t_of(mine), p4t_of(ref))
    # the refusals
    other = delta_request("s1@tenant", fp, 3, np.array([0], np.int32),
                          {n: a[:1].copy() for n, a in p_cols.items()})
    cases = [
        delta_request("nobody", fp, 4),  # an unknown session
        delta_request("s1@tenant", "0" * 40, 4),  # a fingerprint mismatch
        delta_request("s1@tenant", fp, 6),  # a tick out of step
        other,  # tick 3 again with other bytes: the CRC differs
    ]
    for req in cases:
        mine, ref = both(servers, req)
        assert not mine.session_ok and not ref.session_ok
        assert mine.error == ref.error and mine.error
    bad = delta_request("s1@tenant", fp, 4, np.array([P + 5], np.int32),
                        {n: a[:1].copy() for n, a in p_cols.items()})
    assert both(servers, bad) == [grpc.StatusCode.INVALID_ARGUMENT] * 2
    # the session still answers at its cursor after every refusal
    mine, ref = both(servers, delta_request("s1@tenant", fp, 4))
    assert mine.session_ok and ref.session_ok
    np.testing.assert_array_equal(p4t_of(mine), p4t_of(ref))
    chunks, _ = open_request(p_cols, r_cols, kernel="topk", session_id="s2@tenant")
    mine, ref = both(servers, chunks)
    assert not mine.ok and not ref.ok and mine.error == ref.error
    assert "not session-servable" in mine.error
    chunks, _ = open_request(p_cols, r_cols, session_id="s3@tenant", fp="f" * 40)
    mine, ref = both(servers, chunks)
    assert not mine.ok and not ref.ok and mine.error == ref.error


def test_unary_arena_equals_the_session_open(servers):
    """The v1 and v2 unary ``jax:1`` arena's cold solve and a session's open
    solve the same padded columns: the same p4t, on the port and on the
    reference."""
    p_cols, r_cols = columns(seed=9)
    chunks, fp = open_request(p_cols, r_cols, session_id="u@tenant")
    mine, ref = both(servers, chunks)
    want = p4t_of(ref)
    np.testing.assert_array_equal(p4t_of(mine), want)
    port_client = servers[0]
    req = tg.encoded_to_proto(ss._as_ns(p_cols), ss._as_ns(r_cols), ZERO_PROX, kernel="jax:1",
                              top_k=16, eps=0.02)
    got = np.asarray(port_client.assign(req, timeout=TIMEOUT).provider_for_task, np.int32)
    np.testing.assert_array_equal(got, want)
    req2 = tg.encoded_to_proto_v2(ss._as_ns(p_cols), ss._as_ns(r_cols), ZERO_PROX,
                                  kernel="jax:1", top_k=16, eps=0.02)
    got2 = port_client.assign_v2(req2, timeout=TIMEOUT)
    np.testing.assert_array_equal(wire.unblob(got2.provider_for_task, np.int32), want)
    assert got2.HasField("price")


def test_the_port_refuses_native_and_stream_sessions(servers):
    port_client = servers[0]
    p_cols, r_cols = columns(seed=4)
    for kernel in ("native-mt:2", "sinkhorn-mt"):
        chunks, _ = open_request(p_cols, r_cols, kernel=kernel, session_id="n@t")
        resp = port_client.open_session(iter(chunks), timeout=TIMEOUT)
        assert not resp.ok and "M5" in resp.error
    chunks, _ = open_request(p_cols, r_cols, session_id="st@t", stream_mode=True)
    resp = port_client.open_session(iter(chunks), timeout=TIMEOUT)
    assert not resp.ok and "M5" in resp.error
    chunks, fp = open_request(p_cols, r_cols, session_id="b@t")
    assert port_client.open_session(iter(chunks), timeout=TIMEOUT).ok
    ev = delta_request("b@t", fp, 1)
    ev.event_source = "src"
    resp = port_client.assign_delta(ev, timeout=TIMEOUT)
    assert not resp.session_ok and "not stream-servable" in resp.error


# ---------------- the store ----------------


def _session(sid: str, arena=None) -> ss.SolveSession:
    p_cols, r_cols = columns()
    return ss.SolveSession(session_id=sid, fingerprint="fp", weights=ZERO_PROX, kernel="jax:1",
                           threads=1, top_k=16, p_cols=ss._pad_cols(p_cols, P),
                           r_cols=ss._pad_cols(r_cols, T), n_providers=P, n_tasks=T,
                           arena=arena)


def test_store_lru_ttl_drop_and_evict():
    store = ss.SessionStore(max_sessions=2)
    a, b, c = _session("a@x"), _session("b@y"), _session("c@x")
    store.put(a)
    store.put(b)
    assert store.get("a@x", "fp") == (a, "")  # a is now the most recent
    store.put(c)  # evicts b, the least recently used
    assert b.evicted and not a.evicted and store.evictions == 1 and len(store) == 2
    assert store.get("b@y", "fp") == (None, "unknown session")
    assert store.get("a@x", "other") == (None, "epoch fingerprint mismatch")
    assert store.lru_candidate() == ("a@x", a.last_used)
    assert store.lru_candidate(exclude={"a@x"}) == ("c@x", c.last_used)
    assert store.lru_candidate(tenant="y") is None
    store.put(_session("a@x"))  # a same-id replacement lets the old one go
    assert a.evicted
    assert store.evict("c@x") and not store.evict("c@x") and c.evicted
    store.drop("a@x")
    assert len(store) == 0
    ttl = ss.SessionStore(ttl_s=0.0)
    d = _session("d")
    ttl.put(d)
    assert ttl.sweep() == 1 and d.evicted and ttl.expirations == 1
    assert ss.tenant_of("t@pool") == "t" and ss.tenant_of("plain") == "plain"


def test_apply_delta_is_copy_on_write_and_checked():
    s = _session("s")
    price, load = s.p_cols["price"], s.p_cols["load"]
    rows = np.array([2, 5], np.int32)
    delta = {n: a[rows].copy() for n, a in s.p_cols.items()}
    delta["price"] = np.float32([9.0, 8.0])
    assert s.apply_delta(rows, delta, np.zeros(0, np.int32), {}) == 2
    assert s.p_cols["price"] is not price and s.p_cols["load"] is load
    assert price[2] != 9.0 and s.p_cols["price"][5] == 8.0
    with pytest.raises(ValueError, match="out of range"):
        s.apply_delta(np.array([P], np.int32), delta, np.zeros(0, np.int32), {})
    short = dict(delta, load=delta["load"][:1])
    with pytest.raises(ValueError, match="rows for 2 row indices"):
        s.apply_delta(rows, short, np.zeros(0, np.int32), {})
    assert s.delta_rows_total == 2 and s.p_cols["price"][2] == 9.0
    assert s.enter_tick(2) and s.enter_tick(2) and not s.enter_tick(2)
    s.exit_tick()
    assert s.enter_tick(2) and s.enter_tick(0)


def test_kernel_parsing_and_the_arena_factory():
    assert ss.parse_session_kernel("jax") == ("jax", 0)
    assert ss.parse_session_kernel("jax:4") == ("jax", 4)
    assert ss.parse_session_kernel("torch:2") == ("jax", 2)
    assert ss.parse_session_kernel("native-mt:8") == ("auction", 8)
    assert ss.parse_session_kernel("topk") is None
    assert ss.parse_session_kernel("jax:x") is None
    arena = ss.make_solve_arena("jax", k=16, threads=2, device="cpu")
    assert arena.k == 16 and arena.devices == 2 and arena.device.type == "cpu"
    with pytest.raises(ss.KernelNotServed, match="M5"):
        ss.make_solve_arena("auction", k=16, threads=1, device="cpu")
    padded = ss._pad_cols({"valid": np.ones(5, bool), "x": np.arange(5)}, 5)
    assert padded["x"].tolist() == [0, 1, 2, 3, 4, 0, 0, 0]
    assert padded["valid"].tolist() == [True] * 5 + [False] * 3


def test_wire_session_helpers_are_the_references():
    from protocol_tpu.proto import wire as rwire

    p_cols, r_cols = columns(seed=6)
    args = (ZERO_PROX, "jax:2", 0, 0.02, 7)
    assert wire.epoch_fingerprint(p_cols, r_cols, *args) == rwire.epoch_fingerprint(
        p_cols, r_cols, *args)
    q = dict(p_cols, price=p_cols["price"].copy())
    q["price"][[4, 9]] += 1.0
    np.testing.assert_array_equal(wire.dirty_rows(q, p_cols), rwire.dirty_rows(q, p_cols))
    chunks, _ = open_request(p_cols, r_cols)
    ref_chunks = list(rwire.chunk_snapshot("s1@tenant", chunks[0].epoch_fingerprint,
                                           rpb.AssignRequestV2.FromString(
                                               wire.assemble_snapshot(chunks)[2]
                                               .SerializeToString()),
                                           chunk_bytes=4096))
    assert [c.SerializeToString() for c in chunks] == [c.SerializeToString()
                                                        for c in ref_chunks]
    with pytest.raises(ValueError, match="empty"):
        wire.assemble_snapshot([])
    with pytest.raises(ValueError, match="exceeds|declares"):
        wire.assemble_snapshot(chunks, max_bytes=100)
    rows = wire.take_rows(p_cols, np.array([1, 3]))
    np.testing.assert_array_equal(rows.price, p_cols["price"][[1, 3]])
