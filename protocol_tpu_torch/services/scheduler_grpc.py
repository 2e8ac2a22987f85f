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

The fleet layer: sessions live in a sharded
:class:`~protocol_tpu_torch.fleet.fabric.SessionFabric` under the
:class:`~protocol_tpu_torch.fleet.fabric.FleetConfig` budgets. With a
journal root (``FleetConfig.ckpt_dir``), each session's journal
(:mod:`protocol_tpu_torch.faults.checkpoint`) is flushed before a tick on
the cadence is acknowledged, and a servicer that starts on the root
rehydrates its namespace. The router: ``Migrate`` / :meth:`migrate_out`
hands sessions to another process (a redirect, an eviction, a flush, a
journal rename), whose next delta miss rehydrates them lazily; a migrated
session's deltas and re-opens answer ``moved:<endpoint>``; a superseded
journal fence refuses every delta, open and flush. :func:`drain` stops
admitting sessions, lets in-flight ticks finish and flushes every journal.
The tick watchdog (``tick_deadline_ms``) serves the previous plan, flagged
stale, when a tick's budget is already spent.

The client half is :class:`RemoteBatchMatcher`: the port's batch matcher
with its device solves over this wire, the session protocol on wire v2,
the reference's retry, failover and refusal ladder.

The wire contract is the reference's: the service name, the messages
(``protocol_tpu_torch.proto.scheduler_pb2``, the reference's descriptor)
and the codecs (``proto/wire.py``), so the reference's client and
``RemoteBatchMatcher`` drive this server unchanged, and the port's client
drives the reference's. Service stubs are generic method handlers, as in
the reference.

Not here: stream sessions (``stream_mode``, the stream engine; ROADMAP
queue A, M5); the per-session obs registry, the SLO engine, the flight
recorder, the ``/metrics`` endpoint, the chaos interceptor and the shard
blackout (queue A, M6).
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
import uuid
import zlib
from collections import OrderedDict
from concurrent import futures
from typing import NamedTuple, Optional

import grpc
import numpy as np
import torch

from protocol_tpu_torch.device import resolve_device
from protocol_tpu_torch.dfleet.topology import FleetTopology
from protocol_tpu_torch.faults.checkpoint import SessionCheckpointer
from protocol_tpu_torch.fleet.admission import TenantAdmission
from protocol_tpu_torch.fleet.fabric import FleetConfig, SessionFabric, estimate_arena_bytes
from protocol_tpu_torch.obs.spans import TRACER as _tracer
from protocol_tpu_torch.ops.cost import CostWeights
from protocol_tpu_torch.ops.encoding import providers_from_numpy, requirements_from_numpy
from protocol_tpu_torch.proto import scheduler_pb2 as pb
from protocol_tpu_torch.proto.wire import (
    P_WIRE_DTYPES,
    R_WIRE_DTYPES,
    assemble_snapshot,
    blob,
    canon_columns,
    chunk_snapshot,
    decode_providers_v2,
    decode_requirements_v2,
    dirty_rows,
    encode_providers_v2,
    encode_requirements_v2,
    epoch_fingerprint,
    host,
    real_rows,
    select_rows,
    strip_padding,
    take_rows,
    unblob,
)
from protocol_tpu_torch.sched.torch_backend import TorchBatchMatcher
from protocol_tpu_torch.services.assign_kernels import (
    KernelDispatch,
    KernelNotServed,
    UnknownKernel,
    _SolveOut,
)
from protocol_tpu_torch.services.session_store import (
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


class SchedulerBackendServicer:
    """The backend on one device (``"cuda"`` by default; it raises without
    a card unless asked for ``"cpu"``). Every solve on the device, unary
    or session, runs under ``kernels.lock``. ``fleet`` is a
    :class:`FleetConfig`; None reads ``PROTOCOL_TPU_FLEET_*``."""

    # bound of the redirect and tombstone maps (client-minted session ids)
    _ROUTER_CAP = 4096

    def __init__(self, device="cuda", max_sessions: int = 8, session_ttl_s: float = 900.0,
                 fleet: Optional[FleetConfig] = None):
        self.device = resolve_device(device)
        self.kernels = KernelDispatch()
        cfg = fleet if fleet is not None else FleetConfig.from_env()
        self.fleet_config = cfg
        self.sessions = SessionFabric(
            shards=cfg.shards, max_sessions=max_sessions, ttl_s=session_ttl_s,
            max_bytes=cfg.max_bytes, tenant_max_bytes=cfg.tenant_max_bytes, vnodes=cfg.vnodes,
        )
        self.admission = TenantAdmission(rate=cfg.admit_rate, burst=cfg.admit_burst)
        self.seam = SeamMetrics(role="server")
        # the SIGTERM drain: OpenSession stops admitting
        self.draining = False
        self.ckpt = None
        # the router: _moved maps a session migrated away to its new home
        # (the "moved:" answer); _no_rehydrate tombstones the sessions this
        # process evicted itself (an eviction releases memory, so the lazy
        # rehydration must not bring the victim back). A leaf lock guards
        # both (dict work only, taken under a shard lock by the hook).
        self._router_lock = threading.Lock()
        self._moved: OrderedDict[str, str] = OrderedDict()
        self._no_rehydrate: OrderedDict[str, bool] = OrderedDict()
        self._rehydrating: set = set()
        self._migrating: set = set()
        self.proc_id = cfg.proc_id
        self.endpoint = cfg.endpoint
        if cfg.ckpt_dir:
            self.ckpt = SessionCheckpointer(cfg.ckpt_dir, every=cfg.ckpt_every,
                                            proc_id=cfg.proc_id, device=self.device)
            # newest first, capped at the session budget
            for session in self.ckpt.load_all(limit=max_sessions):
                self.sessions.put(session)
                self.seam.count("session_restored")

            def _ckpt_gc(session, reason: str) -> None:
                # a TTL-expired or dropped session's client is gone: its
                # journal goes too. Every other involuntary let-go keeps the
                # journal and tombstones the session against lazy rehydration.
                if reason in ("ttl", "drop"):
                    self.ckpt.drop(session.session_id)
                elif reason not in ("migrate", "replace"):
                    self._router_tombstone(session.session_id)

            self.sessions.on_let_go = _ckpt_gc

    # ---------------- the router ----------------

    def _router_tombstone(self, session_id: str) -> None:
        with self._router_lock:
            self._no_rehydrate[session_id] = True
            while len(self._no_rehydrate) > self._ROUTER_CAP:
                self._no_rehydrate.popitem(last=False)

    def _router_adopt(self, session_id: str) -> None:
        """The session was opened or rehydrated here: clear a stale
        redirect or tombstone."""
        with self._router_lock:
            self._moved.pop(session_id, None)
            self._no_rehydrate.pop(session_id, None)

    def _moved_to(self, session_id: str) -> Optional[str]:
        """Where the session was migrated to, or None. The journal's place
        is the authority and the redirect a cache: a journal back in this
        namespace (the target died and the ring re-routed it here) adopts
        the session back, unless its migration is still in flight."""
        with self._router_lock:
            moved = self._moved.get(session_id)
            in_flight = session_id in self._migrating
        if moved is None:
            return None
        if (not in_flight and self.ckpt is not None
                and os.path.exists(self.ckpt.path_for(session_id))):
            self._router_adopt(session_id)
            return None
        return moved

    def _fence_route(self, session_id: str) -> Optional[str]:
        """None while this namespace's fence holds (one stat). Else the
        process was ejected: the session's new home by the stamped
        topology, or "" where the stamp has no usable route."""
        if self.ckpt is None or not self.ckpt.fence_superseded():
            return None
        self.seam.count("fence_refused")
        topo = self.ckpt.fence_state().get("topology")
        if topo:
            try:
                ep = FleetTopology.from_dict(topo).endpoint_for(session_id)
                if ep and ep != self.endpoint:
                    return ep
            except Exception:  # a torn or foreign stamp
                pass
        return ""

    def _rehydrate(self, session_id: str, fingerprint: str):
        """The lazy restore behind a delta miss: a journal of this session
        in this namespace (a handoff landed it, or the start-up cap skipped
        it) is loaded and adopted. None when there is none; one load at a
        time a session (a concurrent miss gets None)."""
        if self.ckpt is None:
            return None
        with self._router_lock:
            if (session_id in self._no_rehydrate or session_id in self._moved
                    or session_id in self._rehydrating):
                return None
            self._rehydrating.add(session_id)
        try:
            loaded = self.ckpt.load_one(session_id)
            if loaded is None:
                return None
            self.sessions.put(loaded)
            self.seam.count("session_rehydrated")
        finally:
            with self._router_lock:
                self._rehydrating.discard(session_id)
        session, _ = self.sessions.get(session_id, fingerprint)
        return session

    def migrate_out(self, target_endpoint: str, target_proc_id: str, session_ids=None) -> int:
        """Hand sessions to another process: the redirect first (a delta
        racing the eviction is answered "moved:", never "unknown"), then
        the eviction (an in-flight solve refuses), the flush at the final
        tick and the journal's rename into the target's namespace. The
        target rehydrates each on its first redirected delta. Returns the
        sessions moved."""
        if self.ckpt is None:
            return 0
        wanted = set(session_ids) if session_ids else None
        moved = 0
        for session in self.sessions.snapshot_sessions():
            sid = session.session_id
            if wanted is not None and sid not in wanted:
                continue
            with self._router_lock:
                self._moved[sid] = target_endpoint
                self._migrating.add(sid)
                while len(self._moved) > self._ROUTER_CAP:
                    self._moved.popitem(last=False)
            try:
                self.sessions.shard_of(sid).evict(sid, reason="migrate")
                with session.lock:
                    flushed = self.ckpt.flush_locked(session)
                if not flushed or not self.ckpt.handoff(sid, target_proc_id):
                    # no journal to move: no redirect either, the client
                    # re-opens at the target
                    with self._router_lock:
                        self._moved.pop(sid, None)
                    continue
            finally:
                with self._router_lock:
                    self._migrating.discard(sid)
            moved += 1
            self.seam.count("session_migrated_out")
        return moved

    def Migrate(self, request: pb.MigrateRequest, context) -> pb.MigrateResponse:
        """The live migration's admin RPC (not on a client's hot path)."""
        with self._rpc_span("rpc.Migrate", context):
            if not request.target_endpoint or not request.target_proc_id:
                return pb.MigrateResponse(
                    ok=False, error="UNAVAILABLE: migrate needs target_endpoint and "
                                    "target_proc_id")
            if self.ckpt is None:
                return pb.MigrateResponse(
                    ok=False, error="UNAVAILABLE: no checkpoint journal configured (ckpt_dir "
                                    "unset) — nothing to hand off")
            moved = self.migrate_out(request.target_endpoint, request.target_proc_id,
                                     list(request.session_ids) or None)
            return pb.MigrateResponse(ok=True, moved=moved)

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
        if self.draining:
            # the SIGTERM drain: a transient refusal, the client's ladder
            # takes unary for this tick and re-opens at the replacement
            self.seam.count("drain_refused")
            return pb.OpenSessionResponse(
                ok=False,
                error="UNAVAILABLE: draining, not admitting new sessions (retry against the "
                      "replacement)")
        if session_id:
            refused = self._route_refusal(session_id, pb.OpenSessionResponse, "ok")
            if refused is not None:
                return refused
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
        padded_p, padded_r = _pad_cols(p_cols, n_p), _pad_cols(r_cols, n_t)
        session = SolveSession(
            session_id=session_id or uuid.uuid4().hex, fingerprint=fp, weights=weights,
            kernel=kernel, threads=threads, top_k=top_k, p_cols=padded_p, r_cols=padded_r,
            n_providers=n_p, n_tasks=n_t, arena=arena,
            arena_bytes=estimate_arena_bytes(padded_p, padded_r, top_k),
        )
        t_dec = time.perf_counter()
        self._check_deadline(context, "session-open")
        with _tracer.span("engine.solve", kernel=kernel, cold=True):
            with session.lock:
                with self.kernels.lock:
                    p4t, t4p, price = session.solve()
                session.last_p4t = np.asarray(p4t, np.int32)
                # tick 0's journal: a crash before the first delta restores
                # the session too (flush before the ack)
                if self.ckpt is not None:
                    self.ckpt.flush_locked(session)
        # an open that raced an ejection is not acknowledged
        if session_id:
            refused = self._fence_refusal(session_id, pb.OpenSessionResponse, "ok")
            if refused is not None:
                return refused
        t_solve = time.perf_counter()
        self.sessions.put(session)
        self._router_adopt(session.session_id)
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

    def _fence_refusal(self, session_id: str, response, ok_field: str):
        """The refusal of a superseded fence (``moved:<home>``, or "unknown
        session" where the stamp names none) as ``response``, or None."""
        fenced = self._fence_route(session_id)
        if fenced is None:
            return None
        error = f"moved:{fenced}" if fenced else "unknown session (journal fence superseded)"
        return response(**{ok_field: False, "error": error})

    def _route_refusal(self, session_id: str, response, ok_field: str):
        """The fence's refusal, else a migrated session's ``moved:``
        (opening or serving it here would fork its ownership), or None."""
        refused = self._fence_refusal(session_id, response, ok_field)
        if refused is not None:
            return refused
        moved = self._moved_to(session_id)
        if moved is None:
            return None
        self.seam.count("moved_refused")
        return response(**{ok_field: False, "error": f"moved:{moved}"})

    def AssignDelta(self, request: pb.AssignDeltaRequest, context) -> pb.AssignDeltaResponse:
        with self._rpc_span("rpc.AssignDelta", context, session=request.session_id,
                            tick=int(request.tick)):
            return self._assign_delta(request, context)

    def _assign_delta(self, request: pb.AssignDeltaRequest, context) -> pb.AssignDeltaResponse:
        t0 = time.perf_counter()
        # the fence first (one stat): an ejected process refuses every delta
        # before it spends a token or a lookup
        refused = self._fence_refusal(request.session_id, pb.AssignDeltaResponse, "session_ok")
        if refused is not None:
            return refused
        if not self.admission.admit(tenant_of(request.session_id)):
            self.seam.count("admission_refused")
            return pb.AssignDeltaResponse(
                session_ok=False,
                error="RESOURCE_EXHAUSTED: tenant over admission rate (AssignDelta)")
        session, reason = self.sessions.get(request.session_id, request.epoch_fingerprint)
        if session is None and reason == "unknown session":
            # a session migrated away answers with its new home (the client
            # rebinds and resends the same delta); one whose journal was
            # handed here rehydrates and the delta goes on
            moved = self._moved_to(request.session_id)
            if moved is not None:
                self.seam.count("moved_refused")
                return pb.AssignDeltaResponse(session_ok=False, error=f"moved:{moved}")
            session = self._rehydrate(request.session_id, request.epoch_fingerprint)
        if session is None:
            self.seam.count("session_miss")
            return pb.AssignDeltaResponse(session_ok=False, error=reason)
        # the queued-tick bound is checked before parking on the session's lock
        depth = self.fleet_config.delta_queue_depth
        if not session.enter_tick(depth):
            self.seam.count("backpressure_refused")
            return pb.AssignDeltaResponse(
                session_ok=False,
                error=f"RESOURCE_EXHAUSTED: session delta queue over depth {depth}")
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
            # the tick watchdog: when the lock wait, the decode and the EWMA
            # of recent solves would overrun the tick's deadline, the previous
            # plan is served, flagged stale (the delta stays applied), at most
            # max_stale_ticks in a row
            deadline_ms = self.fleet_config.tick_deadline_ms
            stale = (deadline_ms is not None and session.last_p4t is not None
                     and session.stale_streak < self.fleet_config.max_stale_ticks
                     and (time.perf_counter() - t0) * 1e3 + session.solve_ewma_ms
                     > deadline_ms)
            if stale:
                session.stale_streak += 1
                staleness = session.stale_streak
                p4t_out = np.array(session.last_p4t, np.int32)
                self.seam.count("stale_served")
            else:
                staleness = 0
                t_s0 = time.perf_counter()
                with self.kernels.lock:
                    p4t_out, _, _ = session.solve()
                solve_ms = (time.perf_counter() - t_s0) * 1e3
                session.solve_ewma_ms = (solve_ms if session.solve_ewma_ms == 0.0
                                         else 0.5 * session.solve_ewma_ms + 0.5 * solve_ms)
                session.stale_streak = 0
            session.tick += 1
            session.last_p4t = p4t_out
            session.last_delta_crc = _delta_crc(request)
            if session.evicted:
                # the eviction landed during the solve: no ack
                self.seam.count("session_evicted_inflight")
                return pb.AssignDeltaResponse(session_ok=False, error="session evicted")
            if self.ckpt is not None and self.ckpt.due(session.tick):
                # flush before the ack: a crash leaves the journal at or one
                # behind the client's cursor (a resume, or a replayed twin)
                self.ckpt.flush_locked(session)
            # the fence again, after the flush and just before the ack: an
            # ejection while this thread was frozen withholds the ack
            refused = self._fence_refusal(request.session_id, pb.AssignDeltaResponse,
                                          "session_ok")
            if refused is not None:
                return refused
        self.seam.observe_ms("decode", (t_dec - t0) * 1e3)
        self.seam.observe_ms("solve", (time.perf_counter() - t_dec) * 1e3)
        # a slim answer, p4t only: t4p is derivable and the prices are
        # session state
        resp = pb.AssignDeltaResponse(
            session_ok=True, stale=bool(staleness), staleness_ticks=staleness,
            result=pb.AssignResponseV2(
                provider_for_task=blob(p4t_out, np.int32),
                num_assigned=int((p4t_out >= 0).sum()),
                solve_ms=(time.perf_counter() - t0) * 1e3,
                decode_ms=(t_dec - t0) * 1e3,
            ),
        )
        self.seam.add_bytes("out", resp.ByteSize())
        return resp

    def finish_drain(self) -> int:
        """The drain's tail: flush every live session's journal, after the
        server stopped taking RPCs (each session's lock is then free).
        Returns the sessions flushed."""
        flushed = 0
        if self.ckpt is not None:
            for session in self.sessions.snapshot_sessions():
                with session.lock:
                    if not session.evicted and self.ckpt.flush_locked(session):
                        flushed += 1
        return flushed

    def Health(self, request: pb.HealthRequest, context) -> pb.HealthResponse:
        # health probes are the periodic traffic every deployment has: idle
        # expired sessions release their bytes here
        self.sessions.sweep()
        gpu = self.device.type == "cuda"
        resp = pb.HealthResponse(
            status="ok",
            platform="gpu" if gpu else "cpu",
            device_count=torch.cuda.device_count() if gpu else 1,
        )
        seam = dict(self.seam.snapshot())
        seam["sessions_active"] = float(len(self.sessions))
        seam["session_evictions"] = float(self.sessions.evictions)
        seam["session_expirations"] = float(self.sessions.expirations)
        seam["draining"] = 1.0 if self.draining else 0.0
        if self.ckpt is not None:
            seam["ckpt_flushes"] = float(self.ckpt.flushes)
            seam["ckpt_flush_failures"] = float(self.ckpt.flush_failures)
            seam["ckpt_handoffs"] = float(self.ckpt.handoffs)
            seam["ckpt_fence_epoch"] = float(self.ckpt.fence_epoch)
            seam["ckpt_fence_refusals"] = float(self.ckpt.fence_refusals)
            seam["ckpt_journals_skipped"] = float(self.ckpt.journals_skipped)
        with self._router_lock:
            seam["sessions_moved_out"] = float(len(self._moved))
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


def drain(server: grpc.Server, grace_s: float = 5.0) -> int:
    """The graceful drain (the SIGTERM path): stop admitting sessions, stop
    taking RPCs and let in-flight ticks finish (``grace_s``), then flush
    every session's journal. Returns the sessions flushed; a servicer that
    starts on the same journal root then rehydrates them warm."""
    servicer = server.servicer
    servicer.draining = True
    server.stop(grace=grace_s).wait()
    return servicer.finish_drain()


def serve(address: str = "127.0.0.1:50061", max_workers: int = 4, device="cuda",
          max_sessions: int = 8, session_ttl_s: float = 900.0,
          fleet: Optional[FleetConfig] = None) -> grpc.Server:
    """Start the backend server (non-blocking; call
    ``.wait_for_termination()``). The servicer rides on the returned
    server as ``.servicer`` and the bound port as ``.port`` (so that
    ``"127.0.0.1:0"`` takes a free port). ``fleet`` is a
    :class:`FleetConfig` (shards, budgets, admission, queue depth, the
    journal root, proc id and endpoint); None reads
    ``PROTOCOL_TPU_FLEET_*``."""
    servicer = SchedulerBackendServicer(device=device, max_sessions=max_sessions,
                                        session_ttl_s=session_ttl_s, fleet=fleet)
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
        self._migrate = self.channel.unary_unary(
            f"/{SERVICE_NAME}/Migrate",
            request_serializer=pb.MigrateRequest.SerializeToString,
            response_deserializer=pb.MigrateResponse.FromString,
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

    def migrate(self, request: pb.MigrateRequest, timeout: float = 120.0) -> pb.MigrateResponse:
        return self._migrate(request, timeout=timeout)

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


def _res_v2(resp: pb.AssignResponseV2, n_providers: Optional[int] = None) -> _WireResult:
    p4t = unblob(resp.provider_for_task, np.int32)
    if resp.HasField("task_for_provider"):
        t4p = unblob(resp.task_for_provider, np.int32)
    else:
        # a slim delta answer: the inverse matching is a local scatter
        t4p = np.full(int(n_providers), -1, np.int32)
        seated = np.flatnonzero((p4t >= 0) & (p4t < int(n_providers)))
        t4p[p4t[seated]] = seated.astype(np.int32)
    return _WireResult(
        p4t,
        t4p,
        unblob(resp.price, np.float32) if resp.HasField("price") else None,
        resp.solve_ms,
    )


def _widen(res: _WireResult, rows: np.ndarray, n_providers: int) -> _WireResult:
    """An answer about the providers ``rows`` of ``n_providers``, spoken of
    them by their rank in ``rows``, as an answer about all of them (the
    others seated nowhere, priced 0)."""
    t4p = np.full(n_providers, -1, np.int32)
    t4p[rows] = res.t4p[:rows.size]
    p4t = np.asarray(res.p4t, np.int32)
    seated = (p4t >= 0) & (p4t < rows.size)
    p4t = np.where(seated, rows[np.where(seated, p4t, 0)] if rows.size else -1, -1)
    price = None
    if res.price is not None:
        price = np.zeros(n_providers, np.float32)
        price[rows] = res.price[:rows.size]
    return _WireResult(p4t.astype(np.int32), t4p, price, res.solve_ms)


_RETRYABLE = (grpc.StatusCode.UNAVAILABLE, grpc.StatusCode.DEADLINE_EXCEEDED)

# OpenSession refusals that are capability answers (the server will never
# serve the session protocol for these parameters): only these demote the
# client's ladder for good; anything else (a torn stream, a draining
# server, a corrupted frame) is transient
_PERMANENT_REFUSALS = ("not session-servable", "fingerprint mismatch")


class RemoteBatchMatcher(TorchBatchMatcher):
    """The port's batch matcher with its device solves over the gRPC
    scheduler backend (``protocol_tpu/services/scheduler_grpc.py:2095``): the
    control plane stays a thin host process and the kernels run where the
    backend's card is. Phases 0, 0.5 and the dict build run here, on
    ``device``; phase 1 and phase 2 ride the wire (:meth:`_bounded_t4p`,
    :meth:`_bounded_t4p_sparse`, :meth:`_unbounded_best`).

    ``wire="v1"`` speaks the repeated-scalar contract. ``wire="v2"`` speaks
    tensor frames and, for an arena kernel (``native_fallback`` with
    ``native_engine="torch[:D]"``, sent as the reference's ``jax[:D]``), the
    session protocol: one streamed snapshot, then ``AssignDelta`` messages
    with the rows whose columns changed since the last acknowledged tick. A
    refused delta climbs the refusal ladder (throttle, ``moved:`` redirect,
    an evicted session's one resend, the handoff wait) and re-opens last;
    an ``UNIMPLEMENTED`` v2 RPC drops the client to v1 for good; transient
    transport failures retry with jittered backoff, a reconnect, then
    failover down ``address`` (one endpoint, a comma-separated list or a
    sequence).

    ``last_solve_stats`` gains ``remote_rtt_ms`` (client-observed) beside
    ``remote_backend_ms`` (the server's ``solve_ms``), the calls, the bytes
    and the degraded ticks (``stale_ticks``, ``replayed_ticks``)."""

    # the candidates are generated behind the wire
    use_candidate_cache = False

    def __init__(self, store, address="127.0.0.1:50061", request_timeout: float = 300.0,
                 wire: str = "v1", chunk_bytes: int = 1 << 20, gzip_snapshots: bool = True,
                 retries: int = 3, retry_base_s: float = 0.05, retry_max_s: float = 2.0,
                 tick_timeout_s: Optional[float] = None, **kwargs):
        super().__init__(store, **kwargs)
        if wire not in ("v1", "v2"):
            raise ValueError(f"wire must be v1|v2, got {wire!r}")
        if isinstance(address, (list, tuple)):
            endpoints = [str(a) for a in address]
        else:
            endpoints = [a.strip() for a in str(address).split(",")]
        # the ordered endpoint list is the failover ladder
        self.endpoints = [e for e in endpoints if e] or ["127.0.0.1:50061"]
        self._endpoint_i = 0
        self.request_timeout = request_timeout
        # the deadline of the steady-state RPCs (unary and AssignDelta): a
        # wedged server fails this tick fast; the cold OpenSession keeps
        # request_timeout. None: request_timeout for all
        self.tick_timeout_s = tick_timeout_s
        self.wire = wire
        self.chunk_bytes = chunk_bytes
        self.gzip_snapshots = gzip_snapshots
        self.retries = retries
        self.retry_base_s = retry_base_s
        self.retry_max_s = retry_max_s
        self.client = SchedulerBackendClient(self.endpoints[0])
        # the highest topology generation adopted (a stale view loses)
        self._topology_generation: Optional[int] = None
        self.seam = SeamMetrics(role="client")
        self._rtt_ms: list[float] = []
        self._backend_ms: list[float] = []
        self._bytes_out = 0
        self._bytes_in = 0
        # the session protocol's client half: the columns of the last
        # snapshot or delta the server acknowledged, keyed by solve params
        self._session: Optional[dict] = None
        self._session_uid = uuid.uuid4().hex
        self._session_refused = False
        self._stale_ticks = 0
        self._replayed_ticks = 0

    def refresh(self) -> None:
        self._rtt_ms, self._backend_ms = [], []
        self._bytes_out = self._bytes_in = 0
        self._stale_ticks = self._replayed_ticks = 0
        # one trace a scheduler tick: every RPC of this refresh carries it
        with _tracer.span("seam.tick", wire=self.wire):
            super().refresh()
        if self._rtt_ms:
            self.last_solve_stats["wire"] = self.wire
            self.last_solve_stats["remote_calls"] = len(self._rtt_ms)
            self.last_solve_stats["remote_rtt_ms"] = round(sum(self._rtt_ms), 3)
            self.last_solve_stats["remote_backend_ms"] = round(sum(self._backend_ms), 3)
            self.last_solve_stats["remote_bytes_out"] = self._bytes_out
            self.last_solve_stats["remote_bytes_in"] = self._bytes_in
            if self._stale_ticks:
                self.last_solve_stats["stale_ticks"] = self._stale_ticks
            if self._replayed_ticks:
                self.last_solve_stats["replayed_ticks"] = self._replayed_ticks

    # ---------------- transport: retry, reconnect, failover ----------------

    def rebind(self, endpoint: Optional[str] = None) -> None:
        """Reconnect: to ``endpoint`` when given (a ``moved:`` redirect; a
        new one joins the failover list), else to the current endpoint."""
        if endpoint:
            if endpoint not in self.endpoints:
                self.endpoints.append(endpoint)
            self._endpoint_i = self.endpoints.index(endpoint)
        try:
            self.client.close()
        except Exception:
            pass
        self.client = SchedulerBackendClient(self.endpoints[self._endpoint_i])

    def adopt_topology(self, topology, session_id=None) -> bool:
        """Take a fleet topology's ring walk for this client's session as the
        failover list. Generation-monotonic: a topology no newer than the
        one adopted is refused (False, counted). An ejected current endpoint
        fails over at once."""
        gen = int(getattr(topology, "generation", 0))
        if self._topology_generation is not None and gen <= self._topology_generation:
            self.seam.count("stale_topology_refused")
            return False
        self._topology_generation = gen
        sid = session_id or ((self._session or {}).get("id") or self._session_uid)
        current = self.endpoints[self._endpoint_i]
        self.endpoints = list(topology.failover_order(sid))
        if current in self.endpoints:
            self._endpoint_i = self.endpoints.index(current)
        else:
            self._endpoint_i = 0
            self.seam.count("endpoint_failover")
            self.rebind()
        self.seam.count("topology_adopted")
        return True

    def _reconnect(self, failover: bool = False) -> None:
        """A fresh channel; with ``failover`` the next endpoint of the list."""
        if failover and len(self.endpoints) > 1:
            self._endpoint_i = (self._endpoint_i + 1) % len(self.endpoints)
            self.seam.count("endpoint_failover")
        self.rebind()

    def _backoff_s(self, attempt: int) -> float:
        """Retry ``attempt``'s wait: ``retry_base_s * 2^attempt`` capped at
        ``retry_max_s``, scaled into [0.5x, 1.5x) by the sha1 of the session
        uid and the attempt (the reference's schedule, a pure function)."""
        base = min(self.retry_base_s * (2.0 ** attempt), self.retry_max_s)
        digest = hashlib.sha1(f"{self._session_uid}:{attempt}".encode()).digest()
        frac = int.from_bytes(digest[:8], "big") / 2.0 ** 64
        return min(base * (0.5 + frac), self.retry_max_s)

    def _rpc(self, make_call):
        """``make_call()`` with jittered backoff on transient transport
        failures, a reconnect on the first retry and failover after it; a
        ``RESOURCE_EXHAUSTED`` (the unary admission gate) backs off without
        reconnecting."""
        for attempt in range(self.retries + 1):
            try:
                return make_call()
            except grpc.RpcError as e:
                code = e.code()
                if attempt >= self.retries:
                    raise
                if code == grpc.StatusCode.RESOURCE_EXHAUSTED:
                    self.seam.count("throttled_retry")
                    time.sleep(self._backoff_s(attempt))
                    continue
                if code not in _RETRYABLE:
                    raise
                self.seam.count("retry")
                time.sleep(self._backoff_s(attempt))
                self._reconnect(failover=attempt >= 1)

    # ---------------- v1 / v2 unary ----------------

    def _timed(self, make_call, bytes_out: int):
        t0 = time.perf_counter()
        with _tracer.span("seam.rpc", wire=self.wire):
            resp = self._rpc(make_call)
        self._rtt_ms.append((time.perf_counter() - t0) * 1e3)
        self._bytes_out += bytes_out
        self._bytes_in += resp.ByteSize()
        return resp

    def _serialized(self, t0: float) -> None:
        t_ser = time.perf_counter()
        _tracer.record_span("wire.encode", int(t0 * 1e9), int((t_ser - t0) * 1e9),
                            wire=self.wire)
        self.seam.observe_ms("serialize", (t_ser - t0) * 1e3)

    def _call(self, ep, er, kernel: str, eps: float, max_iters: int, warm_price=None,
              seed_p4t=None, top_k: int = 64) -> _WireResult:
        sp = strip_padding(ep)
        sr = strip_padding(er)
        if self.wire == "v2":
            try:
                return self._call_v2(sp, sr, kernel, eps, max_iters, warm_price, seed_p4t, top_k)
            except grpc.RpcError as e:
                if e.code() != grpc.StatusCode.UNIMPLEMENTED:
                    raise
                # an old server: the v1 contract for good
                self.wire = "v1"
                self.seam.count("fallback_v1")
        t0 = time.perf_counter()
        # the v1 wire has no valid column: a provider that phase 0 or 0.5
        # claimed (invalid amid the real rows) stays home, and the answer is
        # widened back to every row
        n_p = sp.valid.shape[0]
        rows = np.flatnonzero(sp.valid)
        if rows.size < n_p:
            sp = select_rows(sp, rows)
            if warm_price is not None and seed_p4t is not None:
                warm_price = np.asarray(warm_price)[rows]
                rank = np.full(n_p, -1, np.int32)
                rank[rows] = np.arange(rows.size, dtype=np.int32)
                seed_p4t = np.asarray(seed_p4t, np.int32)
                seed_p4t = np.where(seed_p4t >= 0, rank[np.maximum(seed_p4t, 0)], -1)
        req = encoded_to_proto(sp, sr, self.weights, kernel=kernel, top_k=top_k, eps=eps,
                               max_iters=max_iters)
        if warm_price is not None and seed_p4t is not None:
            req.warm_price.extend(np.asarray(warm_price, np.float32))
            req.seed_provider_for_task.extend(np.asarray(seed_p4t, np.int32))
        self._serialized(t0)
        resp = self._timed(lambda: self.client.assign(req, timeout=self.request_timeout),
                           req.ByteSize())
        self._backend_ms.append(resp.solve_ms)
        res = _res_v1(resp)
        return _widen(res, rows, n_p) if rows.size < n_p else res

    def _call_v2(self, sp, sr, kernel, eps, max_iters, warm_price, seed_p4t,
                 top_k) -> _WireResult:
        if parse_session_kernel(kernel) is not None and not self._session_refused:
            res = self._session_call(sp, sr, kernel, eps, max_iters, top_k)
            if res is not None:
                return res
        t0 = time.perf_counter()
        req = encoded_to_proto_v2(sp, sr, self.weights, kernel=kernel, top_k=top_k, eps=eps,
                                  max_iters=max_iters)
        if warm_price is not None and seed_p4t is not None:
            req.warm_price.CopyFrom(blob(warm_price, np.float32))
            req.seed_provider_for_task.CopyFrom(blob(seed_p4t, np.int32))
        self._serialized(t0)
        resp = self._timed(lambda: self.client.assign_v2(req, timeout=self.request_timeout),
                           req.ByteSize())
        self._backend_ms.append(resp.solve_ms)
        return _res_v2(resp)

    # ---------------- the session protocol's client half ----------------

    def _session_call(self, sp, sr, kernel, eps, max_iters, top_k) -> Optional[_WireResult]:
        """A delta tick against the open session, or a fresh snapshot when
        there is none, the population reshaped or the server lost it. None
        when the server refuses the session protocol (unary v2 then)."""
        t0 = time.perf_counter()
        p_cols = canon_columns(sp, P_WIRE_DTYPES)
        r_cols = canon_columns(sr, R_WIRE_DTYPES)
        params = (
            kernel, int(top_k), float(eps), int(max_iters),
            float(self.weights.price), float(self.weights.load),
            float(self.weights.proximity), float(self.weights.priority),
            p_cols["gpu_count"].shape[0], r_cols["cpu_cores"].shape[0],
        )
        st = self._session
        if st is None or st["params"] != params:
            return self._open_session(p_cols, r_cols, kernel, eps, max_iters, top_k, params, t0)
        prow = dirty_rows(p_cols, st["p_cols"])
        trow = dirty_rows(r_cols, st["r_cols"])
        if (prow.size + trow.size) > 0.5 * (params[-2] + params[-1]):
            # more than half the rows changed: a new epoch is cheaper
            return self._open_session(p_cols, r_cols, kernel, eps, max_iters, top_k, params, t0)
        req = pb.AssignDeltaRequest(session_id=st["id"], epoch_fingerprint=st["fp"],
                                    tick=st["tick"] + 1)
        if prow.size:
            req.provider_rows.CopyFrom(blob(prow, np.int32))
            req.providers.CopyFrom(encode_providers_v2(take_rows(p_cols, prow)))
        if trow.size:
            req.task_rows.CopyFrom(blob(trow, np.int32))
            req.requirements.CopyFrom(encode_requirements_v2(take_rows(r_cols, trow)))
        self._serialized(t0)
        # the tick's deadline, not the snapshot's
        tick_timeout = self.tick_timeout_s or self.request_timeout
        try:
            resp = self._timed(lambda: self.client.assign_delta(req, timeout=tick_timeout),
                               req.ByteSize())
        except grpc.RpcError as e:
            if e.code() != grpc.StatusCode.INVALID_ARGUMENT:
                raise
            # a frame mangled in transit is refused at decode, before any
            # state moved: one resend is safe; a second raises
            self.seam.count("corrupt_resend")
            resp = self._timed(lambda: self.client.assign_delta(req, timeout=tick_timeout),
                               req.ByteSize())
        if not resp.session_ok:
            resp = self._delta_refusal_ladder(resp, req, tick_timeout)
        if not resp.session_ok:
            # evicted, expired, or a replica that never saw the snapshot:
            # re-open from this client's columns
            self.seam.count("session_reopen")
            self._session = None
            return self._open_session(p_cols, r_cols, kernel, eps, max_iters, top_k, params, t0)
        st["p_cols"], st["r_cols"] = p_cols, r_cols
        st["tick"] += 1
        if resp.stale:
            # the server served the previous plan, flagged; the delta was
            # applied (the shadow update above holds)
            self.seam.count("stale_served")
            self._stale_ticks += 1
        if resp.replayed:
            # the answer to a retransmit of an applied tick
            self.seam.count("delta_replayed")
            self._replayed_ticks += 1
        self._backend_ms.append(resp.result.solve_ms)
        return _res_v2(resp.result, n_providers=params[-2])

    def _delta_refusal_ladder(self, resp, req, tick_timeout):
        """One refused delta's rungs, each bounded; returns the last answer
        (still refused: the caller re-opens).

        throttle   RESOURCE_EXHAUSTED: the same delta after a backoff.
        moved      "moved:<endpoint>": rebind there, resend the same delta
                   (the session rehydrates warm from its journal).
        evicted    one resend of the same delta (a migration racing it is
                   answered "moved:" next).
        handoff    "unknown session" with more than one endpoint: a backoff
                   and the next endpoint, a few times (the journal's rename
                   may be in flight)."""
        throttles = redirects = waits = 0
        evict_retried = False
        # the redirect bound from before the loop: rebind() grows the list
        redirect_limit = len(self.endpoints) + 1
        while not resp.session_ok:
            err = resp.error
            if "RESOURCE_EXHAUSTED" in err:
                if throttles >= self.retries:
                    break
                self.seam.count("throttled_retry")
                time.sleep(self._backoff_s(throttles))
                throttles += 1
            elif err.startswith("moved:"):
                if redirects >= redirect_limit:
                    break  # a redirect loop: re-open
                self.seam.count("moved_redirect")
                self.rebind(err[len("moved:"):].strip())
                redirects += 1
            elif "session evicted" in err and not evict_retried:
                evict_retried = True
            elif "unknown session" in err and len(self.endpoints) > 1:
                if waits >= max(self.retries, len(self.endpoints)):
                    break
                self.seam.count("handoff_wait")
                time.sleep(self._backoff_s(waits))
                waits += 1
                self._reconnect(failover=True)
            else:
                break
            resp = self._timed(lambda: self.client.assign_delta(req, timeout=tick_timeout),
                               req.ByteSize())
        return resp

    def _open_session(self, p_cols, r_cols, kernel, eps, max_iters, top_k, params,
                      t0) -> Optional[_WireResult]:
        fp = epoch_fingerprint(p_cols, r_cols, self.weights, kernel, int(top_k), eps,
                               int(max_iters))
        req = encoded_to_proto_v2(take_rows(p_cols, slice(None)), take_rows(r_cols, slice(None)),
                                  self.weights, kernel=kernel, top_k=top_k, eps=eps,
                                  max_iters=max_iters)
        chunks = list(chunk_snapshot(self._session_uid, fp, req, chunk_bytes=self.chunk_bytes,
                                     use_gzip=self.gzip_snapshots))
        n_bytes = sum(len(c.payload) for c in chunks)
        self._serialized(t0)
        resp = self._timed(
            lambda: self.client.open_session(iter(chunks), timeout=self.request_timeout), n_bytes)
        redirects = 0
        redirect_limit = len(self.endpoints) + 1
        while not resp.ok and resp.error.startswith("moved:") and redirects < redirect_limit:
            # the open itself redirected: the session's journal lives there
            self.seam.count("moved_redirect")
            self.rebind(resp.error[len("moved:"):].strip())
            redirects += 1
            resp = self._timed(
                lambda: self.client.open_session(iter(chunks), timeout=self.request_timeout),
                n_bytes)
        if not resp.ok:
            self._session = None
            if "RESOURCE_EXHAUSTED" in resp.error:
                # a throttle, not a capability answer: unary for this tick
                self.seam.count("session_throttled")
                return None
            if not any(marker in resp.error for marker in _PERMANENT_REFUSALS):
                # transient (a torn stream, a draining server): unary for
                # this tick, the session protocol again next tick
                self.seam.count("session_transient_refusal")
                return None
            # a capability answer: every later tick goes to unary
            self.seam.count("session_refused")
            self._session_refused = True
            return None
        self._session = {
            "id": resp.session_id,
            "fp": resp.epoch_fingerprint,
            "tick": 0,
            "p_cols": p_cols,
            "r_cols": r_cols,
            "params": params,
        }
        self._backend_ms.append(resp.result.solve_ms)
        return _res_v2(resp.result)

    # ---------------- the matcher's device solves ----------------

    def _native_kernel(self) -> str:
        """The arena engine's kernel string on the wire: the port's
        ``torch[:D]`` rides as the reference's ``jax[:D]`` (a bare engine
        takes its suffix from ``native_threads``)."""
        name, _, suffix = self.native_engine.partition(":")
        if name == "torch":
            if suffix:
                return f"jax:{suffix}"
            return f"jax:{self.native_threads}" if self.native_threads else "jax"
        return "native"

    def _bounded_t4p(self, ep, er, ep_device=None) -> np.ndarray:
        if self.native_fallback:
            # the arena engine rides the kernel string (the backend's warm
            # arena does the work); on wire v2 the session protocol
            res = self._call(ep, er, self._native_kernel(), eps=0.02, max_iters=0)
            return np.asarray(res.t4p, np.int32)
        res = self._call(ep, er, "auction", eps=0.05, max_iters=300)
        return np.asarray(res.t4p, np.int32)

    def _bounded_t4p_sparse(self, ep, er, price0: np.ndarray, p4s0: np.ndarray,
                            warm: bool) -> tuple[np.ndarray, np.ndarray]:
        """The sparse route over the wire: the backend's "topk" kernel, the
        warm prices and the previous matching riding the request, so the
        backend stays stateless across replicas."""
        n_p = real_rows(ep)
        n_s = real_rows(er)
        warm_price = seed = None
        if warm:
            warm_price = np.asarray(price0[:n_p], np.float32)
            seed = np.asarray(p4s0[:n_s], np.int32)
        res = self._call(ep, er, "topk", eps=0.02, max_iters=0, warm_price=warm_price,
                         seed_p4t=seed, top_k=self.top_k)
        price = res.price if res.price is not None else np.zeros(n_p, np.float32)
        return np.asarray(res.t4p, np.int32), np.asarray(price, np.float32)

    def _unbounded_best(self, ep, er) -> np.ndarray:
        res = self._call(ep, er, "best", eps=0.0, max_iters=0)
        return np.asarray(res.t4p, np.int32)
