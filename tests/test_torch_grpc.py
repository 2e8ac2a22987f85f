"""The port's scheduler backend (``protocol_tpu_torch/services/``), its
stateless RPCs on the CPU over real localhost channels, held against the
reference's server (``protocol_tpu/services/scheduler_grpc.py``) and the
reference's clients.

Costs are bit-identical between the two packages at proximity 0, so the
cross-server comparisons send ``CostWeights(proximity=0.0)``; the
reference's matcher runs on nodes without a location. Servers bind port
0 (the port's) or a free port found first (the reference's), and every
RPC has a timeout."""

import random
import socket
import types

import grpc
import numpy as np
import pytest
import torch

from protocol_tpu.ops.cost import CostWeights as JCostWeights
from protocol_tpu.ops.encoding import FeatureEncoder
from protocol_tpu.proto import scheduler_pb2 as rpb
from protocol_tpu.services import scheduler_grpc as ref_grpc
from protocol_tpu_torch.ops.cost import CostWeights
from protocol_tpu_torch.ops.encoding import providers_from_numpy, requirements_from_numpy
from protocol_tpu_torch.proto import scheduler_pb2 as pb
from protocol_tpu_torch.proto import wire
from protocol_tpu_torch.services import scheduler_grpc as tg
from protocol_tpu_torch.services.assign_kernels import KernelDispatch, _pad_pow2
from protocol_tpu_torch.trace.synth import synth_provider_arrays, synth_requirement_arrays

from tests.test_encoding import random_requirements, random_specs
from tests.test_scheduler_grpc import _pool_world

TIMEOUT = 60.0
KERNELS = ["greedy", "auction", "sinkhorn", "topk", "best"]
ZERO_PROX = CostWeights(proximity=0.0)


@pytest.fixture(scope="module")
def port_server():
    server = tg.serve("127.0.0.1:0", device="cpu")
    client = tg.SchedulerBackendClient(f"127.0.0.1:{server.port}")
    yield server, client
    client.close()
    server.stop(grace=None)


@pytest.fixture(scope="module")
def ref_server():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server = ref_grpc.serve(address=f"127.0.0.1:{port}")
    client = ref_grpc.SchedulerBackendClient(f"127.0.0.1:{port}")
    yield client
    client.close()
    server.stop(grace=None)


def build_batch(seed=0, P=24, T=16):
    """The reference suite's scenario: random specs and requirements
    through the reference's encoder (numpy columns)."""
    rng = random.Random(seed)
    enc = FeatureEncoder()
    specs = [random_specs(rng) for _ in range(P)]
    reqs = [random_requirements(rng) for _ in range(T)]
    return enc.encode_providers(specs), enc.encode_requirements(reqs), specs, reqs


def market(seed, P, T):
    """The synthetic marketplace's encoded columns (numpy)."""
    rng = np.random.default_rng(seed)
    return (types.SimpleNamespace(**synth_provider_arrays(rng, P)),
            types.SimpleNamespace(**synth_requirement_arrays(rng, T)))


def test_health(port_server):
    _, client = port_server
    ep, er, _, _ = build_batch(seed=3, P=6, T=5)
    client.assign(tg.encoded_to_proto(ep, er, kernel="greedy"), timeout=TIMEOUT)
    h = client.health(timeout=TIMEOUT)
    assert (h.status, h.platform, h.device_count) == ("ok", "cpu", 1)
    seam = {m.name: m.value for m in h.seam_metrics}
    assert seam["solve_count"] >= 1 and seam["bytes_in"] > 0 and seam["bytes_out"] > 0


@pytest.mark.parametrize("kernel", KERNELS)
def test_every_kernel_feasible(port_server, kernel):
    _, client = port_server
    ep, er, specs, reqs = build_batch()
    resp = client.assign(tg.encoded_to_proto(ep, er, kernel=kernel, top_k=8), timeout=TIMEOUT)
    p4t, t4p = list(resp.provider_for_task), list(resp.task_for_provider)
    assert len(p4t) == 16 and len(t4p) == 24 and resp.solve_ms > 0
    if kernel == "best":  # each provider's cheapest compatible task, not a matching
        assert all(specs[p].meets(reqs[t]) for p, t in enumerate(t4p) if t >= 0)
        assert resp.num_assigned == sum(1 for t in t4p if t >= 0) > 0
        return
    used = set()
    for t, p in enumerate(p4t):
        if p >= 0:
            assert specs[p].meets(reqs[t]), f"incompatible {kernel} match t={t} p={p}"
            assert p not in used and t4p[p] == t
            used.add(p)
    assert resp.num_assigned == len(used) > 0


@pytest.mark.parametrize("kernel,code", [
    ("magic", grpc.StatusCode.INVALID_ARGUMENT),
    ("native", grpc.StatusCode.FAILED_PRECONDITION),
    ("native-mt", grpc.StatusCode.FAILED_PRECONDITION),
    ("native-mt:2", grpc.StatusCode.FAILED_PRECONDITION),
    ("sinkhorn-mt:4", grpc.StatusCode.FAILED_PRECONDITION),
])
def test_unserved_kernels_fail_with_a_status(port_server, kernel, code):
    _, client = port_server
    ep, er, _, _ = build_batch(seed=2, P=4, T=4)
    for call, req in ((client.assign, tg.encoded_to_proto(ep, er, kernel=kernel)),
                      (client.assign_v2, tg.encoded_to_proto_v2(ep, er, kernel=kernel))):
        with pytest.raises(grpc.RpcError) as e:
            call(req, timeout=TIMEOUT)
        assert e.value.code() == code
        if code == grpc.StatusCode.FAILED_PRECONDITION:
            assert "ROADMAP" in e.value.details()


@pytest.mark.parametrize("kernel", ["jax:1", "torch:1"])
def test_arena_kernels_are_served_on_both_wires(port_server, kernel):
    """The unary arena kernel (the servicer's persistent warm arena) answers
    on v1 and v2 with a valid matching and its prices; the same columns
    again take the arena's short circuit, with the same answer."""
    _, client = port_server
    ep, er, specs, reqs = build_batch(seed=2, P=12, T=10)
    v1 = client.assign(tg.encoded_to_proto(ep, er, kernel=kernel), timeout=TIMEOUT)
    v2 = client.assign_v2(tg.encoded_to_proto_v2(ep, er, kernel=kernel), timeout=TIMEOUT)
    p4t = list(v1.provider_for_task)
    assert wire.unblob(v2.provider_for_task, np.int32).tolist() == p4t
    assert len(v1.price) == 12 and v2.HasField("price") and v1.num_assigned > 0
    used = set()
    for t, p in enumerate(p4t):
        if p >= 0:
            assert specs[p].meets(reqs[t]) and p not in used and v1.task_for_provider[p] == t
            used.add(p)


def test_session_rpcs_are_not_served(port_server):
    """``Migrate`` answers as the reference's does (it was ``UNIMPLEMENTED``
    before the journals were ported): without a journal root it is
    ``ok=false`` "no checkpoint journal", and without a target it names the
    missing fields. An empty snapshot stream to ``OpenSession`` answers
    ``ok=false``, not an RPC error."""
    server, _ = port_server
    channel = grpc.insecure_channel(f"127.0.0.1:{server.port}")
    migrate = channel.unary_unary(
        f"/{tg.SERVICE_NAME}/Migrate",
        request_serializer=pb.MigrateRequest.SerializeToString,
        response_deserializer=pb.MigrateResponse.FromString,
    )
    resp = migrate(pb.MigrateRequest(target_endpoint="x:1", target_proc_id="p"), timeout=TIMEOUT)
    assert not resp.ok and resp.moved == 0
    assert resp.error.startswith("UNAVAILABLE: no checkpoint journal")
    resp = migrate(pb.MigrateRequest(), timeout=TIMEOUT)
    assert not resp.ok and "target_endpoint and target_proc_id" in resp.error
    open_session = channel.stream_unary(
        f"/{tg.SERVICE_NAME}/OpenSession",
        request_serializer=pb.SnapshotChunk.SerializeToString,
        response_deserializer=pb.OpenSessionResponse.FromString,
    )
    resp = open_session(iter([pb.SnapshotChunk(session_id="s")]), timeout=TIMEOUT)
    channel.close()
    assert not resp.ok and resp.error


@pytest.mark.parametrize("kernel", KERNELS)
def test_v1_equals_v2(port_server, kernel):
    _, client = port_server
    ep, er = market(1, 96, 64)
    r1 = tg._res_v1(client.assign(tg.encoded_to_proto(ep, er, kernel=kernel, top_k=16),
                                  timeout=TIMEOUT))
    r2 = tg._res_v2(client.assign_v2(tg.encoded_to_proto_v2(ep, er, kernel=kernel, top_k=16),
                                     timeout=TIMEOUT))
    np.testing.assert_array_equal(r1.p4t, r2.p4t)
    np.testing.assert_array_equal(r1.t4p, r2.t4p)
    assert (r1.price is None) == (r2.price is None) == (kernel != "topk")
    if r1.price is not None:
        np.testing.assert_array_equal(r1.price.view(np.int32), r2.price.view(np.int32))


def test_warm_topk_wire_parity(port_server):
    """The stateless warm path (prices and seeds riding the wire) is
    codec-independent too (``tests/test_wire_v2.py:117``)."""
    _, client = port_server
    ep, er = market(2, 96, 64)
    cold = client.assign(tg.encoded_to_proto(ep, er, kernel="topk", top_k=16), timeout=TIMEOUT)
    warm_price = np.asarray(cold.price, np.float32)
    seeds = np.asarray(cold.provider_for_task, np.int32)
    req1 = tg.encoded_to_proto(ep, er, kernel="topk", top_k=16)
    req1.warm_price.extend(warm_price)
    req1.seed_provider_for_task.extend(seeds)
    req2 = tg.encoded_to_proto_v2(ep, er, kernel="topk", top_k=16)
    req2.warm_price.CopyFrom(wire.blob(warm_price, np.float32))
    req2.seed_provider_for_task.CopyFrom(wire.blob(seeds, np.int32))
    warm1 = client.assign(req1, timeout=TIMEOUT)
    warm2 = client.assign_v2(req2, timeout=TIMEOUT)
    np.testing.assert_array_equal(np.asarray(warm1.provider_for_task, np.int32),
                                  wire.unblob(warm2.provider_for_task, np.int32))
    assert warm1.num_assigned == cold.num_assigned > 0


def _ref_request(ep, er, kernel, top_k, warm=None):
    req = ref_grpc.encoded_to_proto(ep, er, JCostWeights(proximity=0.0), kernel=kernel,
                                    top_k=top_k)
    if warm is not None:
        req.warm_price.extend(warm[0])
        req.seed_provider_for_task.extend(warm[1])
    return req


@pytest.mark.parametrize("P,T", [(96, 64), (100, 50)])
@pytest.mark.parametrize("kernel", ["greedy", "auction", "topk", "best"])
def test_same_bits_as_the_reference_server(port_server, ref_server, kernel, P, T):
    """The same request to both servers: the same matching, inverse and
    prices, bit for bit (``topk`` cold, then warm from the cold answer's
    prices and seeds after 10% of the providers are repriced)."""
    _, client = port_server
    ep, er = market(7 + P, P, T)
    got = [client.assign(tg.encoded_to_proto(ep, er, ZERO_PROX, kernel=kernel, top_k=16),
                         timeout=TIMEOUT)]
    ref = [ref_server.assign(_ref_request(ep, er, kernel, 16), timeout=TIMEOUT)]
    if kernel == "topk":
        warm = (np.asarray(ref[0].price, np.float32),
                np.asarray(ref[0].provider_for_task, np.int32))
        rows = np.random.default_rng(P).choice(P, P // 10, replace=False)
        price = ep.price.copy()
        price[rows] *= np.float32(1.25)
        ep = types.SimpleNamespace(**{**vars(ep), "price": price})
        req = _ref_request(ep, er, kernel, 16, warm)
        ref.append(ref_server.assign(req, timeout=TIMEOUT))
        got.append(client.assign(pb.AssignRequest.FromString(req.SerializeToString()),
                                 timeout=TIMEOUT))
    for g, r in zip(got, ref):
        for field in ("provider_for_task", "task_for_provider"):
            np.testing.assert_array_equal(np.asarray(getattr(g, field), np.int32),
                                          np.asarray(getattr(r, field), np.int32), err_msg=field)
        np.testing.assert_array_equal(np.asarray(g.price, np.float32).view(np.int32),
                                      np.asarray(r.price, np.float32).view(np.int32))
        assert g.num_assigned == r.num_assigned


@pytest.mark.parametrize("P,T", [(96, 64), (100, 50)])
def test_sinkhorn_within_tolerance_of_the_reference_server(port_server, ref_server, P, T):
    """Sinkhorn over both servers. The marketplace's costs repeat (a few
    distinct values a task), so plan entries tie to within the plan
    tolerance and the greedy rounding may take another of them: the plan
    is held within PLAN_ATOL, the port's answer equals its in-process
    rounding exactly, both seat the same number of tasks, and the plan
    mass the port's matching takes (under the reference's plan) is the
    reference's within T x PLAN_ATOL."""
    from protocol_tpu.ops.assign import sinkhorn_plan as j_plan
    from protocol_tpu_torch.ops import assign as ta
    from protocol_tpu_torch.ops.cost import cost_matrix

    from tests.test_torch_assign_rest import PLAN_ATOL

    _, client = port_server
    ep, er = market(7 + P, P, T)
    eps = float(np.float32(0.01))  # the requests' eps, at wire precision
    got = client.assign(tg.encoded_to_proto(ep, er, ZERO_PROX, kernel="sinkhorn", eps=eps),
                        timeout=TIMEOUT)
    ref = ref_server.assign(_ref_request(ep, er, "sinkhorn", 0), timeout=TIMEOUT)
    cost, _ = cost_matrix(_pad_pow2(providers_from_numpy(ep, "cpu"), P),
                          _pad_pow2(requirements_from_numpy(er, "cpu"), T), ZERO_PROX)
    plan = ta.sinkhorn_plan(cost, eps).numpy()
    ref_plan = np.asarray(j_plan(cost.numpy(), eps))
    np.testing.assert_allclose(plan, ref_plan, rtol=0, atol=PLAN_ATOL)
    local = ta.assign_sinkhorn(cost, eps).provider_for_task.numpy()[:T]
    g4t = np.asarray(got.provider_for_task, np.int32)
    r4t = np.asarray(ref.provider_for_task, np.int32)
    np.testing.assert_array_equal(g4t, local)
    assert got.num_assigned == ref.num_assigned == int((g4t >= 0).sum()) > 0

    def mass(p4t):
        seated = np.flatnonzero(p4t >= 0)
        assert (cost.numpy()[p4t[seated], seated] < 5e8).all()
        assert np.unique(p4t[seated]).size == seated.size
        return float(ref_plan[p4t[seated], seated].astype(np.float64).sum())

    assert abs(mass(g4t) - mass(r4t)) <= T * PLAN_ATOL


def test_the_dispatch_in_process_equals_the_rpc(port_server):
    _, client = port_server
    ep, er = market(4, 100, 50)
    dispatch = KernelDispatch()
    ept = providers_from_numpy(ep, "cpu")
    ert = requirements_from_numpy(er, "cpu")
    for kernel in KERNELS:
        resp = tg._res_v2(client.assign_v2(
            tg.encoded_to_proto_v2(ep, er, kernel=kernel, top_k=16), timeout=TIMEOUT))
        # the request's defaults: CostWeights(), eps 0.01 at wire precision
        out = dispatch.solve(ept, ert, CostWeights(), kernel, top_k=16,
                             eps=float(np.float32(0.01)))
        np.testing.assert_array_equal(out.p4t, resp.p4t)
        np.testing.assert_array_equal(out.t4p, resp.t4p)


def test_pad_pow2_marks_padding_rows_invalid():
    ep, er = market(5, 100, 50)
    ept = _pad_pow2(providers_from_numpy(ep, "cpu"), 100)
    ert = _pad_pow2(requirements_from_numpy(er, "cpu"), 50)
    assert ept.num == 128 and ert.num == 64
    assert ept.valid.tolist() == [1] * 100 + [0] * 28
    assert ert.gpu_model_mask.shape[0] == 64 and int(ert.gpu_model_mask[50:].sum()) == 0
    torch.testing.assert_close(ept.price[:100], torch.from_numpy(ep.price))
    assert _pad_pow2(ert, 64) is ert


@pytest.mark.parametrize("wire_version", ["v1", "v2"])
def test_reference_remote_matcher_over_the_port(port_server, wire_version):
    """The reference's RemoteBatchMatcher pointed at the port's server
    gives TpuBatchMatcher's dicts (``test_scheduler_grpc.py::_pool_world``)."""
    from protocol_tpu.sched.tpu_backend import TpuBatchMatcher

    server, _ = port_server
    store = _pool_world()
    local = TpuBatchMatcher(store, min_solve_interval=0.0)
    remote = ref_grpc.RemoteBatchMatcher(store, f"127.0.0.1:{server.port}",
                                         min_solve_interval=0.0, wire=wire_version,
                                         request_timeout=TIMEOUT)
    local.refresh()
    remote.refresh()
    assert remote.wire == wire_version  # no demotion to v1
    assert remote._assignment and remote._assignment == local._assignment
    assert remote._assignment_multi == local._assignment_multi
    assert remote.last_solve_stats["remote_calls"] >= 1


def test_admission_refusal_is_resource_exhausted():
    from protocol_tpu_torch.fleet.admission import TenantAdmission

    server = tg.serve("127.0.0.1:0", device="cpu")
    server.servicer.admission = TenantAdmission(rate=1e-6, burst=1.0)
    client = tg.SchedulerBackendClient(f"127.0.0.1:{server.port}")
    try:
        ep, er, _, _ = build_batch(seed=1, P=4, T=4)
        client.assign(tg.encoded_to_proto(ep, er, kernel="greedy"), timeout=TIMEOUT)
        with pytest.raises(grpc.RpcError) as e:
            client.assign(tg.encoded_to_proto(ep, er, kernel="greedy"), timeout=TIMEOUT)
        assert e.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
        seam = {m.name: m.value for m in client.health(timeout=TIMEOUT).seam_metrics}
        assert seam["session_admission_refused"] == 1.0
    finally:
        client.close()
        server.stop(grace=None)


def test_malformed_v2_frames_are_invalid_argument(port_server):
    _, client = port_server
    ep, er, _, _ = build_batch(seed=1, P=4, T=4)
    req = tg.encoded_to_proto_v2(ep, er, kernel="greedy")
    req.providers.columns[0].tensor.dtype = "float32"  # gpu_count is int32
    with pytest.raises(grpc.RpcError) as e:
        client.assign_v2(req, timeout=TIMEOUT)
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    assert "dtype mismatch" in e.value.details()


def test_rpc_spans_adopt_the_callers_context(port_server):
    from protocol_tpu_torch.obs.spans import TRACER

    _, client = port_server
    ep, er, _, _ = build_batch(seed=1, P=4, T=4)
    mark = TRACER.mark()
    with TRACER.span("client.tick") as root:
        client.assign(tg.encoded_to_proto(ep, er, kernel="greedy"), timeout=TIMEOUT)
    spans = TRACER.since(mark, trace=root["trace"])
    by_name = {s["name"]: s for s in spans}
    assert {"rpc.Assign", "wire.decode", "engine.solve", "wire.encode"} <= set(by_name)
    assert by_name["rpc.Assign"]["parent"] == root["span"]
    assert by_name["engine.solve"]["parent"] == by_name["rpc.Assign"]["span"]


def test_both_scheduler_pb2_modules_in_one_process():
    """The port's descriptor is the reference's, in a private pool: the
    same file, package and service names, and each side parses the
    other's bytes."""
    assert pb.DESCRIPTOR.serialized_pb == rpb.DESCRIPTOR.serialized_pb
    assert pb.DESCRIPTOR.name == "protocol_tpu/proto/scheduler.proto"
    assert pb.DESCRIPTOR.package == "protocol_tpu.scheduler.v1"
    assert tg.SERVICE_NAME == ref_grpc.SERVICE_NAME
    assert pb.DESCRIPTOR.services_by_name["SchedulerBackend"].full_name == tg.SERVICE_NAME
    assert pb.AssignRequest is not rpb.AssignRequest
    ep, er = market(6, 9, 7)
    for make, parse in ((tg.encoded_to_proto, rpb.AssignRequest),
                        (tg.encoded_to_proto_v2, rpb.AssignRequestV2)):
        msg = make(ep, er, kernel="topk", top_k=5)
        back = parse.FromString(msg.SerializeToString())
        assert back.SerializeToString() == msg.SerializeToString()
    ref_msg = ref_grpc.encoded_to_proto(ep, er, kernel="greedy", top_k=3)
    mine = pb.AssignRequest.FromString(ref_msg.SerializeToString())
    assert mine.SerializeToString() == ref_msg.SerializeToString()
    assert (mine.kernel, mine.top_k) == ("greedy", 3)


def test_wire_codecs_round_trip():
    ep, er = market(8, 10, 6)
    ep_t = providers_from_numpy(ep, "cpu")
    cols = wire.decode_providers_v2(wire.encode_providers_v2(ep_t))
    for name, dt in wire.P_WIRE_DTYPES.items():
        assert cols[name].dtype == dt
        np.testing.assert_array_equal(cols[name], np.asarray(getattr(ep, name), dt))
    rcols = wire.decode_requirements_v2(wire.encode_requirements_v2(er))
    np.testing.assert_array_equal(rcols["gpu_model_mask"], er.gpu_model_mask)
    bad = wire.encode_requirements_v2(er)
    bad.columns[-1].tensor.CopyFrom(wire.blob(np.ones(5, bool)))  # valid: 5 rows, not 6
    with pytest.raises(ValueError, match="row-count mismatch"):
        wire.decode_requirements_v2(bad)
    canon = wire.canon_columns(ep_t, wire.P_WIRE_DTYPES)
    assert canon["has_gpu"].dtype == np.bool_
    padded = _pad_pow2(ep_t, 10)
    stripped = wire.strip_padding(padded)
    assert stripped.gpu_count.shape == (10,) and isinstance(stripped.price, np.ndarray)


def test_serve_refuses_the_fleet_flags(monkeypatch):
    """``--metrics-port`` (the obs endpoint, ROADMAP queue A, M6) is still
    refused; the three fleet flags parse into the servicer's FleetConfig with
    the reference's precedence: the flag, then PROTOCOL_TPU_FLEET_*, then the
    bind address for the endpoint."""
    from protocol_tpu_torch import serve

    with pytest.raises(SystemExit):
        serve.main(["scheduler", "--device", "cpu", "--metrics-port=9"])
    args = serve.parse_args(["scheduler", "--device", "cpu", "--address", "127.0.0.1:7",
                             "--ckpt-dir=/x", "--proc-id=p1", "--endpoint=a:1"])
    cfg = serve.fleet_config(args)
    assert (cfg.ckpt_dir, cfg.proc_id, cfg.endpoint) == ("/x", "p1", "a:1")
    monkeypatch.setenv("PROTOCOL_TPU_FLEET_ENDPOINT", "10.0.0.7:50061")
    cfg = serve.fleet_config(serve.parse_args(["scheduler", "--address", "0.0.0.0:7",
                                               "--proc-id=p2"]))
    assert (cfg.proc_id, cfg.endpoint, cfg.ckpt_dir) == ("p2", "10.0.0.7:50061", None)
    monkeypatch.delenv("PROTOCOL_TPU_FLEET_ENDPOINT")
    cfg = serve.fleet_config(serve.parse_args(["scheduler", "--address", "0.0.0.0:7",
                                               "--ckpt-dir=/y"]))
    assert (cfg.proc_id, cfg.endpoint) == ("p0", "0.0.0.0:7")
    assert serve.fleet_config(serve.parse_args(["scheduler"])) is None
