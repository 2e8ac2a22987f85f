"""The scheduler gRPC backend (``protocol_tpu/services/scheduler_grpc.py``)
on one device: ``Assign`` (wire v1, repeated-scalar columns), ``AssignV2``
(tensor frames) and ``Health``, serving every kernel of
:mod:`.assign_kernels` (the stateless kernels and the persistent warm
``jax[:D]`` arena), and the v2 sessions: ``OpenSession`` (a client-streamed
snapshot) and ``AssignDelta`` (churned rows only), which pin a warm arena
behind a ``(session_id, epoch_fingerprint)`` key
(:mod:`.session_store`). A refused delta (an unknown session, a
fingerprint or tick cursor out of step, an evicted session) answers
``session_ok=false`` with the reference's reasons, and the client falls
back down its ladder.

The wire contract is the reference's: the service name, the messages
(``protocol_tpu_torch.proto.scheduler_pb2``, the reference's descriptor)
and the codecs (``proto/wire.py``), so the reference's client and
``RemoteBatchMatcher`` drive this server unchanged. Service stubs are
generic method handlers, as in the reference.

``Migrate`` answers ``UNIMPLEMENTED``: live migration, drain, session
checkpoints and the fleet router come later (ROADMAP queue A, M4b), and
so do stream sessions (``stream_mode``, the stream engine; queue A, M5).
Not here yet either: the per-session obs registry, the SLO engine, the
flight recorder, the ``/metrics`` endpoint and the chaos interceptor
(queue A, M6).
"""

from __future__ import annotations

import time
import uuid
import zlib
from concurrent import futures
from typing import NamedTuple, Optional

import grpc
import numpy as np
import torch

from protocol_tpu_torch.device import resolve_device
from protocol_tpu_torch.fleet.admission import TenantAdmission
from protocol_tpu_torch.obs.spans import TRACER as _tracer
from protocol_tpu_torch.ops.cost import CostWeights
from protocol_tpu_torch.ops.encoding import providers_from_numpy, requirements_from_numpy
from protocol_tpu_torch.proto import scheduler_pb2 as pb
from protocol_tpu_torch.proto.wire import (
    assemble_snapshot,
    blob,
    decode_providers_v2,
    decode_requirements_v2,
    encode_providers_v2,
    encode_requirements_v2,
    epoch_fingerprint,
    host,
    unblob,
)
from protocol_tpu_torch.services.assign_kernels import (
    KernelDispatch,
    KernelNotServed,
    UnknownKernel,
    _SolveOut,
)
from protocol_tpu_torch.services.session_store import (
    SessionStore,
    SolveSession,
    _pad_cols,
    make_solve_arena,
    parse_session_kernel,
    tenant_of,
)
from protocol_tpu_torch.utils.metrics import SeamMetrics

SERVICE_NAME = "protocol_tpu.scheduler.v1.SchedulerBackend"


def _np(arr, dtype):
    # repeated-scalar containers support the sequence protocol: fromiter
    # fills the destination buffer directly
    return np.fromiter(arr, dtype=dtype, count=len(arr))


def providers_from_proto(msg: pb.ProviderBatch, device="cuda"):
    """A v1 provider batch as the port's ``EncodedProviders`` on ``device``
    (every row valid: the wire carries real rows only)."""
    n = len(msg.gpu_count)
    return providers_from_numpy({
        "gpu_count": _np(msg.gpu_count, np.int32),
        "gpu_mem_mb": _np(msg.gpu_mem_mb, np.int32),
        "gpu_model_id": _np(msg.gpu_model_id, np.int32),
        "has_gpu": _np(msg.has_gpu, bool),
        "has_cpu": _np(msg.has_cpu, bool),
        "cpu_cores": _np(msg.cpu_cores, np.int32),
        "ram_mb": _np(msg.ram_mb, np.int32),
        "storage_gb": _np(msg.storage_gb, np.int32),
        "lat": _np(msg.lat, np.float32),
        "lon": _np(msg.lon, np.float32),
        "has_location": _np(msg.has_location, bool),
        "price": _np(msg.price, np.float32),
        "load": _np(msg.load, np.float32),
        "valid": np.ones(n, bool),
    }, device)


def requirements_from_proto(msg: pb.RequirementBatch, device="cuda"):
    """A v1 requirement batch as the port's ``EncodedRequirements`` on
    ``device``."""
    t = len(msg.cpu_cores)
    k = max(int(msg.max_gpu_options), 1)
    w = max(int(msg.model_words), 1)
    return requirements_from_numpy({
        "cpu_required": _np(msg.cpu_required, bool),
        "cpu_cores": _np(msg.cpu_cores, np.int32),
        "ram_mb": _np(msg.ram_mb, np.int32),
        "storage_gb": _np(msg.storage_gb, np.int32),
        "gpu_opt_valid": _np(msg.gpu_opt_valid, bool).reshape(t, k),
        "gpu_count": _np(msg.gpu_count, np.int32).reshape(t, k),
        "gpu_mem_min": _np(msg.gpu_mem_min, np.int32).reshape(t, k),
        "gpu_mem_max": _np(msg.gpu_mem_max, np.int32).reshape(t, k),
        "gpu_total_mem_min": _np(msg.gpu_total_mem_min, np.int32).reshape(t, k),
        "gpu_total_mem_max": _np(msg.gpu_total_mem_max, np.int32).reshape(t, k),
        "gpu_model_mask": _np(msg.gpu_model_mask, np.uint32).reshape(t, k, w),
        "gpu_model_constrained": _np(msg.gpu_model_constrained, bool).reshape(t, k),
        "lat": _np(msg.lat, np.float32),
        "lon": _np(msg.lon, np.float32),
        "has_location": _np(msg.has_location, bool),
        "priority": _np(msg.priority, np.float32),
        "valid": np.ones(t, bool),
    }, device)


def _delta_crc(request: pb.AssignDeltaRequest) -> int:
    """Byte-exact identity of one delta tick without re-serializing it: a
    CRC over the tick cursor and every blob's raw bytes, the only payload a
    retransmitted delta can differ in."""
    crc = zlib.crc32(int(request.tick).to_bytes(8, "little"))
    for b in (request.provider_rows, request.task_rows):
        crc = zlib.crc32(b.data, crc)
    for batch in (request.providers, request.requirements):
        for nt in batch.columns:
            crc = zlib.crc32(nt.name.encode(), crc)
            crc = zlib.crc32(nt.tensor.data, crc)
    return crc


# ticks a session may hold inside the servicer (the reference's fleet
# default, ``delta_queue_depth``); past it a delta is refused
DELTA_QUEUE_DEPTH = 8


class SchedulerBackendServicer:
    """The backend on one device (``"cuda"`` by default; it raises without
    a card unless asked for ``"cpu"``). Every solve on the device, unary
    or session, runs under ``kernels.lock``."""

    def __init__(self, device="cuda", max_sessions: int = 8, session_ttl_s: float = 900.0):
        self.device = resolve_device(device)
        self.kernels = KernelDispatch()
        self.sessions = SessionStore(max_sessions=max_sessions, ttl_s=session_ttl_s)
        self.admission = TenantAdmission()  # rate=None: admits all, counts
        self.seam = SeamMetrics(role="server")

    def _solve(self, ep, er, weights, kernel, top_k, eps, max_iters, warm_price, seed_p4t,
               context) -> _SolveOut:
        try:
            return self.kernels.solve(ep, er, weights, kernel, top_k, eps, max_iters,
                                      warm_price, seed_p4t)
        except UnknownKernel as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        except KernelNotServed as e:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION, str(e))

    @staticmethod
    def _weights_of(request) -> CostWeights:
        if request.HasField("weights"):
            # submessage presence is real in proto3: a set weights message
            # is used verbatim, so a legitimate 0.0 weight survives the wire
            return CostWeights(
                price=request.weights.price, load=request.weights.load,
                proximity=request.weights.proximity, priority=request.weights.priority,
            )
        return CostWeights()

    def _rpc_span(self, name: str, context, **attrs):
        """Root span for one RPC, adopting the client's trace context from
        the ``x-pt-span`` metadata header."""
        md = (context.invocation_metadata()
              if context is not None and hasattr(context, "invocation_metadata") else None)
        return _tracer.span(name, remote_parent=_tracer.extract(md), **attrs)

    def _admit_unary(self, context) -> None:
        """Admission gate of the stateless RPCs (one "unary" bucket;
        rate=None, the default, admits all): a refusal is an explicit
        ``RESOURCE_EXHAUSTED``."""
        if not self.admission.admit("unary"):
            self.seam.count("admission_refused")
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, "unary admission rate exceeded")

    def _check_deadline(self, context, where: str) -> None:
        """A caller that hung up, or whose deadline is spent, gets no solve:
        its answer is undeliverable either way."""
        if context is None:
            return
        is_active = getattr(context, "is_active", None)
        if callable(is_active) and not context.is_active():
            self.seam.count("deadline_refused")
            context.abort(grpc.StatusCode.CANCELLED, f"client cancelled before the {where} solve")
        time_remaining = getattr(context, "time_remaining", None)
        if callable(time_remaining):
            remaining = context.time_remaining()
            if remaining is not None and remaining <= 0:
                self.seam.count("deadline_refused")
                context.abort(grpc.StatusCode.DEADLINE_EXCEEDED,
                              f"deadline burned before the {where} solve")

    # ---------------- v1 unary (frozen contract) ----------------

    def Assign(self, request: pb.AssignRequest, context) -> pb.AssignResponse:
        with self._rpc_span("rpc.Assign", context, wire="v1"):
            return self._assign_v1(request, context)

    def _assign_v1(self, request: pb.AssignRequest, context) -> pb.AssignResponse:
        self._admit_unary(context)
        t0 = time.perf_counter()
        with _tracer.span("wire.decode", wire="v1"):
            ep = providers_from_proto(request.providers, self.device)
            er = requirements_from_proto(request.requirements, self.device)
        t_dec = time.perf_counter()
        warm = seeds = None
        if len(request.warm_price) or len(request.seed_provider_for_task):
            warm = _np(request.warm_price, np.float32)
            seeds = _np(request.seed_provider_for_task, np.int32)
        kernel = request.kernel or "auction"
        self._check_deadline(context, "v1 unary")
        with _tracer.span("engine.solve", kernel=kernel):
            out = self._solve(ep, er, self._weights_of(request), kernel, int(request.top_k),
                              request.eps, int(request.max_iters), warm, seeds, context)
        t_solve = time.perf_counter()
        self.seam.observe_ms("decode", (t_dec - t0) * 1e3)
        self.seam.observe_ms("solve", (t_solve - t_dec) * 1e3)
        self.seam.add_bytes("in", request.ByteSize())
        with _tracer.span("wire.encode", wire="v1"):
            resp = pb.AssignResponse(
                provider_for_task=out.p4t.astype(np.int32),
                task_for_provider=out.t4p.astype(np.int32),
                num_assigned=out.num_assigned,
                solve_ms=(time.perf_counter() - t0) * 1e3,
            )
            if out.price is not None:
                resp.price.extend(out.price)
        self.seam.add_bytes("out", resp.ByteSize())
        return resp

    # ---------------- v2 unary: tensor frames ----------------

    def AssignV2(self, request: pb.AssignRequestV2, context) -> pb.AssignResponseV2:
        with self._rpc_span("rpc.AssignV2", context, wire="v2"):
            return self._assign_v2(request, context)

    def _assign_v2(self, request: pb.AssignRequestV2, context) -> pb.AssignResponseV2:
        self._admit_unary(context)
        t0 = time.perf_counter()
        try:
            with _tracer.span("wire.decode", wire="v2"):
                ep = providers_from_numpy(decode_providers_v2(request.providers), self.device)
                er = requirements_from_numpy(decode_requirements_v2(request.requirements),
                                             self.device)
                warm = (unblob(request.warm_price, np.float32)
                        if request.HasField("warm_price") else None)
                seeds = (unblob(request.seed_provider_for_task, np.int32)
                         if request.HasField("seed_provider_for_task") else None)
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        t_dec = time.perf_counter()
        kernel = request.kernel or "auction"
        self._check_deadline(context, "v2 unary")
        with _tracer.span("engine.solve", kernel=kernel):
            out = self._solve(ep, er, self._weights_of(request), kernel, int(request.top_k),
                              request.eps, int(request.max_iters), warm, seeds, context)
        t_solve = time.perf_counter()
        self.seam.observe_ms("decode", (t_dec - t0) * 1e3)
        self.seam.observe_ms("solve", (t_solve - t_dec) * 1e3)
        self.seam.add_bytes("in", request.ByteSize())
        with _tracer.span("wire.encode", wire="v2"):
            resp = self._result_v2(out, t0, t_dec - t0)
        self.seam.add_bytes("out", resp.ByteSize())
        return resp

    @staticmethod
    def _result_v2(out: _SolveOut, t0: float, decode_s: float) -> pb.AssignResponseV2:
        resp = pb.AssignResponseV2(
            provider_for_task=blob(out.p4t, np.int32),
            task_for_provider=blob(out.t4p, np.int32),
            num_assigned=out.num_assigned,
            solve_ms=(time.perf_counter() - t0) * 1e3,
            decode_ms=decode_s * 1e3,
        )
        if out.price is not None:
            resp.price.CopyFrom(blob(out.price, np.float32))
        return resp

    # ---------------- v2 sessions ----------------

    def OpenSession(self, request_iterator, context) -> pb.OpenSessionResponse:
        with self._rpc_span("rpc.OpenSession", context):
            return self._open_session(request_iterator, context)

    def _open_session(self, request_iterator, context) -> pb.OpenSessionResponse:
        t0 = time.perf_counter()
        try:
            with _tracer.span("wire.decode", wire="v2-session"):
                session_id, claimed_fp, req, wire_bytes = assemble_snapshot(request_iterator)
        except ValueError as e:
            return pb.OpenSessionResponse(ok=False, error=str(e))
        self.seam.add_bytes("in", wire_bytes)
        # tenant admission before the decode and the cold solve; a refusal
        # is a protocol answer, and the client's ladder falls to unary v2
        tenant = tenant_of(session_id) if session_id else "unknown"
        if not self.admission.admit(tenant):
            self.seam.count("admission_refused")
            return pb.OpenSessionResponse(
                ok=False,
                error=f"RESOURCE_EXHAUSTED: tenant {tenant!r} over admission rate (OpenSession)")
        kernel = req.kernel or "native-mt"
        parsed = parse_session_kernel(kernel)
        if parsed is None:
            return pb.OpenSessionResponse(
                ok=False,
                error=f"kernel {kernel!r} is not session-servable "
                      "(want native-mt[:N] | sinkhorn-mt[:N] | jax[:D])")
        if req.stream_mode:
            return pb.OpenSessionResponse(
                ok=False,
                error="stream_mode: stream sessions are not served by the port (the stream "
                      "engine binds the native arena; ROADMAP queue A, M5)")
        engine, threads = parsed
        try:  # the columns at their wire dtypes, by name
            p_cols = decode_providers_v2(req.providers)
            r_cols = decode_requirements_v2(req.requirements)
        except ValueError as e:
            return pb.OpenSessionResponse(ok=False, error=str(e))
        weights = self._weights_of(req)
        top_k = max(int(req.top_k) or 64, 1)
        fp = epoch_fingerprint(p_cols, r_cols, weights, kernel, top_k, req.eps,
                               int(req.max_iters))
        if claimed_fp and claimed_fp != fp:
            self.seam.count("fingerprint_mismatch")
            return pb.OpenSessionResponse(
                ok=False, error="epoch fingerprint mismatch between client and server codecs")
        try:
            arena = make_solve_arena(engine, k=top_k, threads=threads, device=self.device)
        except KernelNotServed as e:
            return pb.OpenSessionResponse(ok=False, error=f"kernel {kernel!r}: {e}")
        n_p = p_cols["gpu_count"].shape[0]
        n_t = r_cols["cpu_cores"].shape[0]
        session = SolveSession(
            session_id=session_id or uuid.uuid4().hex, fingerprint=fp, weights=weights,
            kernel=kernel, threads=threads, top_k=top_k, p_cols=_pad_cols(p_cols, n_p),
            r_cols=_pad_cols(r_cols, n_t), n_providers=n_p, n_tasks=n_t, arena=arena,
        )
        t_dec = time.perf_counter()
        self._check_deadline(context, "session-open")
        with _tracer.span("engine.solve", kernel=kernel, cold=True):
            with session.lock, self.kernels.lock:
                p4t, t4p, price = session.solve()
                session.last_p4t = np.asarray(p4t, np.int32)
        t_solve = time.perf_counter()
        self.sessions.put(session)
        self.seam.count("session_open")
        self.seam.observe_ms("decode", (t_dec - t0) * 1e3)
        self.seam.observe_ms("solve", (t_solve - t_dec) * 1e3)
        out = _SolveOut(p4t, t4p, int((p4t >= 0).sum()), price)
        resp = pb.OpenSessionResponse(
            ok=True, session_id=session.session_id, epoch_fingerprint=fp,
            result=self._result_v2(out, t0, t_dec - t0),
        )
        self.seam.add_bytes("out", resp.ByteSize())
        return resp

    def AssignDelta(self, request: pb.AssignDeltaRequest, context) -> pb.AssignDeltaResponse:
        with self._rpc_span("rpc.AssignDelta", context, session=request.session_id,
                            tick=int(request.tick)):
            return self._assign_delta(request, context)

    def _assign_delta(self, request: pb.AssignDeltaRequest, context) -> pb.AssignDeltaResponse:
        t0 = time.perf_counter()
        if not self.admission.admit(tenant_of(request.session_id)):
            self.seam.count("admission_refused")
            return pb.AssignDeltaResponse(
                session_ok=False,
                error="RESOURCE_EXHAUSTED: tenant over admission rate (AssignDelta)")
        session, reason = self.sessions.get(request.session_id, request.epoch_fingerprint)
        if session is None:
            self.seam.count("session_miss")
            return pb.AssignDeltaResponse(session_ok=False, error=reason)
        # the queued-tick bound is checked before parking on the session's lock
        if not session.enter_tick(DELTA_QUEUE_DEPTH):
            self.seam.count("backpressure_refused")
            return pb.AssignDeltaResponse(
                session_ok=False,
                error=f"RESOURCE_EXHAUSTED: session delta queue over depth {DELTA_QUEUE_DEPTH}")
        try:
            return self._assign_delta_admitted(request, context, t0, session)
        finally:
            session.exit_tick()

    def _assign_delta_admitted(self, request: pb.AssignDeltaRequest, context, t0: float,
                               session: SolveSession) -> pb.AssignDeltaResponse:
        self.seam.count("session_hit")
        self.seam.add_bytes("in", request.ByteSize())
        try:
            with _tracer.span("wire.decode", wire="v2-session"):
                prow = (unblob(request.provider_rows, np.int32)
                        if request.HasField("provider_rows") else np.zeros(0, np.int32))
                trow = (unblob(request.task_rows, np.int32)
                        if request.HasField("task_rows") else np.zeros(0, np.int32))
                p_delta = decode_providers_v2(request.providers) if prow.size else {}
                r_delta = decode_requirements_v2(request.requirements) if trow.size else {}
        except ValueError as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        # decode ends here: the wait on the session's lock counts as solve
        t_dec = time.perf_counter()
        with _tracer.span("engine.solve", kernel=session.kernel,
                          delta_rows=int(prow.size + trow.size)), session.lock:
            if session.evicted:
                # lost the race with an eviction between the lookup and the lock
                self.seam.count("session_evicted_inflight")
                return pb.AssignDeltaResponse(session_ok=False, error="session evicted")
            if (int(request.tick) == session.tick and session.tick > 0
                    and session.last_p4t is not None
                    and _delta_crc(request) == session.last_delta_crc):
                # the idempotent retransmit: the same bytes for the tick
                # this session applied last; its cached answer replays
                self.seam.count("delta_replayed")
                cached = np.asarray(session.last_p4t, np.int32)
                return pb.AssignDeltaResponse(
                    session_ok=True, replayed=True,
                    result=pb.AssignResponseV2(
                        provider_for_task=blob(cached, np.int32),
                        num_assigned=int((cached >= 0).sum()),
                        solve_ms=(time.perf_counter() - t0) * 1e3,
                    ),
                )
            if int(request.tick) != session.tick + 1:
                # a replayed or skipped tick: the client's shadow copy and
                # the session's columns have diverged
                self.seam.count("tick_mismatch")
                return pb.AssignDeltaResponse(
                    session_ok=False,
                    error=f"tick cursor mismatch (have {session.tick}, got {int(request.tick)})")
            # the deadline before the delta is applied: an abort after it
            # would let the client's retry apply the tick twice
            self._check_deadline(context, "delta")
            if request.event_source:
                self.seam.count("stream_refused")
                return pb.AssignDeltaResponse(
                    session_ok=False,
                    error="not stream-servable (session opened without stream_mode)")
            try:
                session.apply_delta(prow, p_delta, trow, r_delta)
            except ValueError as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            with self.kernels.lock:
                p4t_out, _, _ = session.solve()
            session.tick += 1
            session.last_p4t = p4t_out
            session.last_delta_crc = _delta_crc(request)
            if session.evicted:
                # the eviction landed during the solve: no ack
                self.seam.count("session_evicted_inflight")
                return pb.AssignDeltaResponse(session_ok=False, error="session evicted")
        self.seam.observe_ms("decode", (t_dec - t0) * 1e3)
        self.seam.observe_ms("solve", (time.perf_counter() - t_dec) * 1e3)
        # a slim answer, p4t only: t4p is derivable and the prices are
        # session state
        resp = pb.AssignDeltaResponse(
            session_ok=True, stale=False, staleness_ticks=0,
            result=pb.AssignResponseV2(
                provider_for_task=blob(p4t_out, np.int32),
                num_assigned=int((p4t_out >= 0).sum()),
                solve_ms=(time.perf_counter() - t0) * 1e3,
                decode_ms=(t_dec - t0) * 1e3,
            ),
        )
        self.seam.add_bytes("out", resp.ByteSize())
        return resp

    def Migrate(self, request: pb.MigrateRequest, context) -> pb.MigrateResponse:
        context.abort(grpc.StatusCode.UNIMPLEMENTED,
                      "Migrate: live migration, drain and session checkpoints are not served "
                      "by the port yet (ROADMAP queue A, M4b)")

    def Health(self, request: pb.HealthRequest, context) -> pb.HealthResponse:
        gpu = self.device.type == "cuda"
        resp = pb.HealthResponse(
            status="ok",
            platform="gpu" if gpu else "cpu",
            device_count=torch.cuda.device_count() if gpu else 1,
        )
        seam = self.seam.snapshot()
        for name in sorted(seam):
            resp.seam_metrics.add(name=name, value=seam[name])
        return resp


def _handlers(servicer: SchedulerBackendServicer) -> grpc.GenericRpcHandler:
    return grpc.method_handlers_generic_handler(SERVICE_NAME, {
        "Assign": grpc.unary_unary_rpc_method_handler(
            servicer.Assign,
            request_deserializer=pb.AssignRequest.FromString,
            response_serializer=pb.AssignResponse.SerializeToString,
        ),
        "AssignV2": grpc.unary_unary_rpc_method_handler(
            servicer.AssignV2,
            request_deserializer=pb.AssignRequestV2.FromString,
            response_serializer=pb.AssignResponseV2.SerializeToString,
        ),
        "OpenSession": grpc.stream_unary_rpc_method_handler(
            servicer.OpenSession,
            request_deserializer=pb.SnapshotChunk.FromString,
            response_serializer=pb.OpenSessionResponse.SerializeToString,
        ),
        "AssignDelta": grpc.unary_unary_rpc_method_handler(
            servicer.AssignDelta,
            request_deserializer=pb.AssignDeltaRequest.FromString,
            response_serializer=pb.AssignDeltaResponse.SerializeToString,
        ),
        "Health": grpc.unary_unary_rpc_method_handler(
            servicer.Health,
            request_deserializer=pb.HealthRequest.FromString,
            response_serializer=pb.HealthResponse.SerializeToString,
        ),
        "Migrate": grpc.unary_unary_rpc_method_handler(
            servicer.Migrate,
            request_deserializer=pb.MigrateRequest.FromString,
            response_serializer=pb.MigrateResponse.SerializeToString,
        ),
    })


# Columnar batches scale with the population (~60 B a provider): the 4 MB
# gRPC default tops out near 70k providers. 1 GiB is a cap, not an
# allocation.
MAX_MESSAGE_BYTES = 1 << 30
_CHANNEL_OPTIONS = [
    ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
    ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
]


def serve(address: str = "127.0.0.1:50061", max_workers: int = 4, device="cuda",
          max_sessions: int = 8, session_ttl_s: float = 900.0) -> grpc.Server:
    """Start the backend server (non-blocking; call
    ``.wait_for_termination()``). The servicer rides on the returned
    server as ``.servicer`` and the bound port as ``.port`` (so that
    ``"127.0.0.1:0"`` takes a free port)."""
    servicer = SchedulerBackendServicer(device=device, max_sessions=max_sessions,
                                        session_ttl_s=session_ttl_s)
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers),
                         options=_CHANNEL_OPTIONS)
    server.add_generic_rpc_handlers((_handlers(servicer),))
    server.servicer = servicer
    server.port = server.add_insecure_port(address)
    if server.port == 0:
        raise RuntimeError(f"could not bind the scheduler backend to {address!r}")
    server.start()
    return server


class SchedulerBackendClient:
    """Thin client stub of the unary and session RPCs."""

    def __init__(self, address: str = "127.0.0.1:50061"):
        self.address = address
        self.channel = grpc.insecure_channel(address, options=_CHANNEL_OPTIONS)
        self._assign = self.channel.unary_unary(
            f"/{SERVICE_NAME}/Assign",
            request_serializer=pb.AssignRequest.SerializeToString,
            response_deserializer=pb.AssignResponse.FromString,
        )
        self._assign_v2 = self.channel.unary_unary(
            f"/{SERVICE_NAME}/AssignV2",
            request_serializer=pb.AssignRequestV2.SerializeToString,
            response_deserializer=pb.AssignResponseV2.FromString,
        )
        self._open_session = self.channel.stream_unary(
            f"/{SERVICE_NAME}/OpenSession",
            request_serializer=pb.SnapshotChunk.SerializeToString,
            response_deserializer=pb.OpenSessionResponse.FromString,
        )
        self._assign_delta = self.channel.unary_unary(
            f"/{SERVICE_NAME}/AssignDelta",
            request_serializer=pb.AssignDeltaRequest.SerializeToString,
            response_deserializer=pb.AssignDeltaResponse.FromString,
        )
        self._health = self.channel.unary_unary(
            f"/{SERVICE_NAME}/Health",
            request_serializer=pb.HealthRequest.SerializeToString,
            response_deserializer=pb.HealthResponse.FromString,
        )

    def assign(self, request: pb.AssignRequest, timeout: float = 60.0,
               metadata=None) -> pb.AssignResponse:
        return self._assign(request, timeout=timeout, metadata=_tracer.inject(metadata))

    def assign_v2(self, request: pb.AssignRequestV2, timeout: float = 60.0,
                  metadata=None) -> pb.AssignResponseV2:
        return self._assign_v2(request, timeout=timeout, metadata=_tracer.inject(metadata))

    def open_session(self, chunks, timeout: float = 300.0,
                     metadata=None) -> pb.OpenSessionResponse:
        return self._open_session(chunks, timeout=timeout, metadata=_tracer.inject(metadata))

    def assign_delta(self, request: pb.AssignDeltaRequest, timeout: float = 60.0,
                     metadata=None) -> pb.AssignDeltaResponse:
        return self._assign_delta(request, timeout=timeout, metadata=_tracer.inject(metadata))

    def health(self, timeout: float = 10.0) -> pb.HealthResponse:
        return self._health(pb.HealthRequest(), timeout=timeout)

    def close(self) -> None:
        self.channel.close()


def _weights_msg(weights: Optional[CostWeights]) -> pb.CostWeights:
    w = weights or CostWeights()
    return pb.CostWeights(price=float(w.price), load=float(w.load),
                          proximity=float(w.proximity), priority=float(w.priority))


def encoded_to_proto(ep, er, weights: Optional[CostWeights] = None, kernel: str = "topk",
                     top_k: int = 64, eps: float = 0.01, max_iters: int = 0) -> pb.AssignRequest:
    """Pack encoded batches (numpy- or torch-backed, the reference's or the
    port's) into a v1 AssignRequest."""

    def _c(a, dtype):
        return np.ascontiguousarray(host(a), dtype)

    t, k = host(er.gpu_opt_valid).shape
    words = host(er.gpu_model_mask).shape[-1]
    return pb.AssignRequest(
        providers=pb.ProviderBatch(
            gpu_count=_c(ep.gpu_count, np.int32),
            gpu_mem_mb=_c(ep.gpu_mem_mb, np.int32),
            gpu_model_id=_c(ep.gpu_model_id, np.int32),
            has_gpu=_c(ep.has_gpu, bool),
            has_cpu=_c(ep.has_cpu, bool),
            cpu_cores=_c(ep.cpu_cores, np.int32),
            ram_mb=_c(ep.ram_mb, np.int32),
            storage_gb=_c(ep.storage_gb, np.int32),
            lat=_c(ep.lat, np.float32),
            lon=_c(ep.lon, np.float32),
            has_location=_c(ep.has_location, bool),
            price=_c(ep.price, np.float32),
            load=_c(ep.load, np.float32),
        ),
        requirements=pb.RequirementBatch(
            cpu_required=_c(er.cpu_required, bool),
            cpu_cores=_c(er.cpu_cores, np.int32),
            ram_mb=_c(er.ram_mb, np.int32),
            storage_gb=_c(er.storage_gb, np.int32),
            max_gpu_options=k,
            model_words=words,
            gpu_opt_valid=_c(er.gpu_opt_valid, bool).reshape(-1),
            gpu_count=_c(er.gpu_count, np.int32).reshape(-1),
            gpu_mem_min=_c(er.gpu_mem_min, np.int32).reshape(-1),
            gpu_mem_max=_c(er.gpu_mem_max, np.int32).reshape(-1),
            gpu_total_mem_min=_c(er.gpu_total_mem_min, np.int32).reshape(-1),
            gpu_total_mem_max=_c(er.gpu_total_mem_max, np.int32).reshape(-1),
            gpu_model_mask=_c(er.gpu_model_mask, np.uint32).reshape(-1),
            gpu_model_constrained=_c(er.gpu_model_constrained, bool).reshape(-1),
            lat=_c(er.lat, np.float32),
            lon=_c(er.lon, np.float32),
            has_location=_c(er.has_location, bool),
            priority=_c(er.priority, np.float32),
        ),
        weights=_weights_msg(weights),
        kernel=kernel, top_k=top_k, eps=eps, max_iters=max_iters,
    )


def encoded_to_proto_v2(ep, er, weights: Optional[CostWeights] = None, kernel: str = "topk",
                        top_k: int = 64, eps: float = 0.01,
                        max_iters: int = 0) -> pb.AssignRequestV2:
    """v2 twin of :func:`encoded_to_proto`: tensor-frame columns."""
    return pb.AssignRequestV2(
        providers=encode_providers_v2(ep),
        requirements=encode_requirements_v2(er),
        weights=_weights_msg(weights),
        kernel=kernel, top_k=top_k, eps=eps, max_iters=max_iters,
    )


class _WireResult(NamedTuple):
    """Version-independent view of an assign response."""

    p4t: np.ndarray
    t4p: np.ndarray
    price: Optional[np.ndarray]
    solve_ms: float


def _res_v1(resp: pb.AssignResponse) -> _WireResult:
    return _WireResult(
        _np(resp.provider_for_task, np.int32),
        _np(resp.task_for_provider, np.int32),
        _np(resp.price, np.float32) if len(resp.price) else None,
        resp.solve_ms,
    )


def _res_v2(resp: pb.AssignResponseV2) -> _WireResult:
    return _WireResult(
        unblob(resp.provider_for_task, np.int32),
        unblob(resp.task_for_provider, np.int32),
        unblob(resp.price, np.float32) if resp.HasField("price") else None,
        resp.solve_ms,
    )
