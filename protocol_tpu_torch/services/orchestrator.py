"""The orchestrator: pool coordination, the health FSM, scheduling and
storage (``protocol_tpu/services/orchestrator.py``, ported).

Reference: crates/orchestrator (SURVEY.md §2.4). Surface:

  POST /heartbeat                worker-signed; ban check, task-state + p2p
                                 update, TTL'd beat, metric storage, reply
                                 carries the scheduled task
                                 (api/routes/heartbeat.rs:16-170)
  /tasks CRUD                    admin; name uniqueness (task.rs:46-80)
  /nodes, /nodes/{id}/ban        admin node views + ban
  /groups, /groups/configs       admin group views, answered as the
                                 reference answers without a groups plugin
  /metrics, /metrics/prometheus  pool metrics
  /scheduler/stats               the batch matcher's last-solve stats
  POST /storage/request-upload   worker-signed; 100 MB cap; per-address
                                 hourly rate limit; file-name template
                                 expansion with upload counters; mapping
                                 file + signed URL (api/routes/storage.rs)
  /health                        loop-watchdog gated
                                 (utils/loop_heartbeats.rs:77-137)

Loops (tickable, async-loop-wrapped in serve()):
  discovery_monitor_once   discovery sync + status reconciliation
                           (discovery/monitor.rs:90-420)
  invite_once              invite Discovered nodes with a ledger-verifiable
                           signed invite (node/invite.rs:73-223)
  status_update_once       heartbeat health FSM + dead-node ejection
                           (status_update/mod.rs:118-350)

The scheduling hot path is a worker's signed heartbeat: the route verifies
it and calls :meth:`OrchestratorService.handle_heartbeat`, which runs the
store section and then ``Scheduler.get_tasks_for_node`` on a worker thread;
behind the scheduler the port's batch matcher
(:class:`~protocol_tpu_torch.sched.torch_backend.TorchBatchMatcher`, or
:class:`~protocol_tpu_torch.services.scheduler_grpc.RemoteBatchMatcher`)
solves on the card. ``handle_heartbeat`` takes a parsed heartbeat and the
authenticated address, so it runs without a transport; the route is a thin
wrapper over it.

``aiohttp`` is imported where routes are built or served, not at import.
Node groups (``groups_plugin``) are refused: ROADMAP queue A, M3.
"""

from __future__ import annotations

import asyncio
import json
import logging
import posixpath
import re
import time
import uuid
from typing import Awaitable, Callable, Optional

from protocol_tpu_torch.chain import Ledger, LedgerError
from protocol_tpu_torch.chain.ledger import invite_digest
from protocol_tpu_torch.models.heartbeat import HeartbeatRequest
from protocol_tpu_torch.models.metric import MetricEntry
from protocol_tpu_torch.models.node import DiscoveryNode
from protocol_tpu_torch.models.task import Task, TaskRequest
from protocol_tpu_torch.sched.scheduler import Scheduler
from protocol_tpu_torch.security.middleware import (
    api_key_middleware,
    validate_signature_middleware,
)
from protocol_tpu_torch.security.wallet import Wallet
from protocol_tpu_torch.store.context import StoreContext
from protocol_tpu_torch.store.kv import LockLostError
from protocol_tpu_torch.store.domains.node_store import NodeStatus, OrchestratorNode
from protocol_tpu_torch.utils.metrics import OrchestratorMetrics
from protocol_tpu_torch.utils.storage import StorageProvider

BAN_KEY = "orchestrator:banned:{}"
UPLOAD_RATE_KEY = "orchestrator:upload_rate:{}"
UPLOAD_SHA_OWNER_KEY = "orchestrator:upload_sha_owner:{}"
# the upload counters' key (``protocol_tpu/sched/node_groups.py:55``): addr,
# group, file-name template
UPLOAD_COUNTER_KEY = "upload:{}:{}:{}"

MAX_UPLOAD_BYTES = 100 * 1024 * 1024  # storage.rs:10
DEAD_MISS_THRESHOLD = 3  # status_update/mod.rs:43
WAITING_GIVE_UP_MISSES = 360  # status_update/mod.rs:295
LOOP_STALE_SECONDS = 120.0  # loop_heartbeats.rs
# signed-URL validity AND the takeover-refusal window: a claim may be seized
# only once no URL issued for it can still be in flight. It matches the
# providers' 1 h expiry (100 MiB on a slow link legitimately takes minutes).
# Claims refreshed by own-sha re-requests are still takeover-able after 4x
# this (total-age cap), so a live node cannot squat a never-uploaded sha
# forever by re-requesting.
UPLOAD_CLAIM_GRACE = 3600.0
# the loops' intervals, the reference's: discovery 10 s, invites 10 s,
# status 15 s
MONITOR_INTERVAL = 10.0
INVITE_INTERVAL = 10.0
STATUS_INTERVAL = 15.0


def _web():
    from aiohttp import web

    return web


DiscoveryFetcher = Callable[[], Awaitable[list[DiscoveryNode]]]
InviteSender = Callable[[OrchestratorNode, dict], Awaitable[bool]]


def _parse_owner_claim(raw) -> Optional[dict]:
    """Owner-key value -> {"addr", "ts", "first"} ("ts" = last refresh,
    "first" = original claim time, for the total-age squat cap). Journals
    written before claims carried timestamps hold a bare address; treat
    those as epoch-old so they stay takeover-able exactly as they were."""
    if raw is None:
        return None
    try:
        rec = json.loads(raw)
        ts = float(rec["ts"])
        return {
            "addr": str(rec["addr"]),
            "ts": ts,
            "first": float(rec.get("first", ts)),
        }
    except (ValueError, TypeError, KeyError):
        return {"addr": str(raw), "ts": 0.0, "first": 0.0}


class OrchestratorService:
    def __init__(
        self,
        ledger: Ledger,
        pool_id: int,
        wallet: Wallet,  # the pool's compute-manager key
        store: StoreContext,
        scheduler: Optional[Scheduler] = None,
        groups_plugin=None,  # refused: node groups are ROADMAP queue A, M3
        storage: Optional[StorageProvider] = None,
        discovery_fetcher: Optional[DiscoveryFetcher] = None,
        invite_sender: Optional[InviteSender] = None,
        admin_api_key: str = "admin",
        uploads_per_hour: int = 3,  # main.rs:76-78
        heartbeat_url: str = "http://localhost:8090",
        webhook=None,  # WebhookPlugin (plugins/webhook/mod.rs)
        control_http=None,  # aiohttp session for worker control-plane calls
        time_fn=time.time,
    ):
        if groups_plugin is not None:
            raise NotImplementedError(
                "groups_plugin (node groups) is not ported yet (ROADMAP.md queue A, M3)")
        self.ledger = ledger
        self.pool_id = pool_id
        self.wallet = wallet
        self.store = store
        self.scheduler = scheduler or Scheduler(self.store)
        self.storage = storage
        self.discovery_fetcher = discovery_fetcher
        self.invite_sender = invite_sender
        self.admin_api_key = admin_api_key
        self.uploads_per_hour = uploads_per_hour
        self.heartbeat_url = heartbeat_url
        self.webhook = webhook
        self.control_http = control_http
        self._time = time_fn
        self.loop_beats: dict[str, float] = {}
        self.metrics = OrchestratorMetrics(pool_id)
        self._observed_solve = 0  # last seen matcher solve seq

    async def _kv_section(self, fn, attempts: int = 3):
        """Run a KV atomic section off the event loop (each op is a
        blocking HTTP round trip on RemoteKVStore deployments). A section
        can lose its advisory lock mid-flight (kv-api restart, >lock_ttl
        stall); per the LockLostError contract the whole section — not the
        single op — is retried."""
        for attempt in range(attempts):
            try:
                return await asyncio.to_thread(fn)
            except LockLostError:
                if attempt == attempts - 1:
                    raise

    def _set_status(self, address: str, status: NodeStatus) -> None:
        """Status transition + webhook notification (the reference's
        StatusUpdatePlugin dispatch, plugins/mod.rs:17-34)."""
        node = self.store.node_store.get_node(address)
        old = node.status if node else None
        self.store.node_store.update_node_status(address, status)
        if self.webhook is not None and old is not None and old != status:
            self.webhook.handle_status_change(address, old.value, status.value)

    # ================= HTTP =================

    def make_app(self) -> "web.Application":
        def _node_known_sync(address: str) -> bool:
            if self.store.kv.exists(BAN_KEY.format(address)):
                return False
            node = self.store.node_store.get_node(address)
            return node is not None and node.status not in (
                NodeStatus.EJECTED,
                NodeStatus.BANNED,
            )

        async def node_known(address: str) -> bool:
            # async validator: node exists and is not ejected/banned
            # (api/server.rs:170-185) — gates BOTH /heartbeat and /storage.
            # Store ops run in a thread: with a RemoteKVStore (api-mode
            # replicas) each is a blocking HTTP round-trip that must not
            # pin the event loop.
            return await asyncio.to_thread(_node_known_sync, address)

        web = _web()
        app = web.Application(
            # raise aiohttp's 1 MiB default so the advertised 100 MB upload
            # cap is actually reachable (the handlers enforce it themselves)
            client_max_size=MAX_UPLOAD_BYTES + 65536,
            middlewares=[
                # NB: /storage/upload is NOT signature-gated — like a GCS
                # signed URL, its auth is the time-limited HMAC token bound
                # to the object name, issued by /storage/request-upload
                validate_signature_middleware(
                    self.store.kv,
                    ["/heartbeat", "/storage/request-upload"],
                    validator=node_known,
                ),
                api_key_middleware(
                    self.admin_api_key,
                    ["/tasks", "/nodes", "/groups", "/metrics", "/scheduler"],
                ),
            ]
        )
        app.router.add_post("/heartbeat", self.heartbeat)
        app.router.add_post("/storage/request-upload", self.request_upload)
        app.router.add_put("/storage/upload/{object_name:.+}", self.upload_object)
        app.router.add_post("/tasks", self.create_task)
        app.router.add_get("/tasks", self.list_tasks)
        app.router.add_delete("/tasks/{task_id}", self.delete_task)
        app.router.add_get("/nodes", self.list_nodes)
        app.router.add_post("/nodes/{address}/ban", self.ban_node)
        app.router.add_get("/nodes/{address}/logs", self.node_logs)
        app.router.add_post("/nodes/{address}/restart", self.node_restart)
        app.router.add_get("/groups/{group_id}/logs", self.group_logs)
        app.router.add_get("/groups", self.list_groups)
        app.router.add_get("/groups/configs", self.list_group_configs)
        app.router.add_post("/groups/force-regroup", self.force_regroup)
        app.router.add_get("/metrics", self.get_metrics)
        app.router.add_get("/metrics/prometheus", self.get_prometheus)
        app.router.add_get("/scheduler/stats", self.get_scheduler_stats)
        app.router.add_get("/health", self.health)
        app.router.add_get("/openapi.json", self.openapi)
        # interactive explorer over the spec (reference: Swagger UI at
        # api/server.rs:46-97; here a self-contained zero-egress page)
        from protocol_tpu_torch.utils.api_docs import docs_handler

        app.router.add_get("/docs", docs_handler())
        return app

    async def openapi(self, request: web.Request) -> web.Response:
        """OpenAPI document generated from the live route table (the
        reference serves utoipa-generated Swagger, api/server.rs:46-97)."""
        paths: dict = {}
        for route in request.app.router.routes():
            if route.method in ("HEAD", "*") or route.resource is None:
                continue
            info = route.resource.get_info()
            path = info.get("path") or info.get("formatter")
            if not path or path in ("/openapi.json", "/docs"):
                continue
            doc = (route.handler.__doc__ or "").strip().splitlines()
            params = [
                {
                    "name": m.group(1),
                    "in": "path",
                    "required": True,
                    "schema": {"type": "string"},
                }
                for m in re.finditer(r"\{(\w+)(?::[^}]*)?\}", path)
            ]
            entry = {
                "summary": doc[0] if doc else "",
                "responses": {"200": {"description": "OK"}},
            }
            if params:
                entry["parameters"] = params
            paths.setdefault(re.sub(r"\{(\w+):[^}]*\}", r"{\1}", path), {})[
                route.method.lower()
            ] = entry
        return _web().json_response(
            {
                "openapi": "3.0.3",
                "info": {
                    "title": "protocol_tpu orchestrator",
                    "version": "1.0",
                    "description": (
                        f"Pool {self.pool_id} coordination API "
                        "(heartbeats, tasks, nodes, groups, storage, metrics)"
                    ),
                },
                "paths": dict(sorted(paths.items())),
            }
        )

    async def health(self, request: web.Request) -> web.Response:
        now = time.monotonic()
        stale = {
            name: round(now - t, 1)
            for name, t in self.loop_beats.items()
            if now - t > LOOP_STALE_SECONDS
        }
        if stale:
            return _web().json_response(
                {"status": "unhealthy", "stale_loops": stale}, status=503
            )
        return _web().json_response({"status": "ok"})

    # ----- heartbeat (the hot path) -----

    def _heartbeat_store_ops(self, hb: HeartbeatRequest, address: str) -> bool:
        """Synchronous store section of the heartbeat; returns banned."""
        if self.store.kv.exists(BAN_KEY.format(address)):
            return True
        node = self.store.node_store.get_node(address)
        if node is not None:
            self.store.node_store.update_node_task(
                address, hb.task_id, hb.task_state_enum()
            )
            if hb.p2p_id and node.p2p_id != hb.p2p_id:
                self.store.node_store.update_node_p2p(
                    address, hb.p2p_id, hb.p2p_addresses
                )
            if hb.load is not None:
                # live load for the matcher's cost term. Clamp BEFORE the
                # comparison (a worker reporting >1.0 must not rewrite an
                # unchanged 1.0 every beat) and debounce at 0.01 — loadavg
                # jitters every beat and this is the heartbeat hot path
                clamped = min(max(float(hb.load), 0.0), 1.0)
                if abs((node.load or 0.0) - clamped) > 0.01:
                    node.load = clamped
                    self.store.node_store.update_node(node)
        self.store.heartbeat_store.beat(hb)
        if hb.metrics:
            entries = []
            for m in hb.metrics:
                try:
                    entries.append(MetricEntry.from_dict(m))
                except (KeyError, ValueError, TypeError):
                    continue
            if entries:
                self.store.metrics_store.store_metrics(entries, address)
        return False

    async def heartbeat(self, request: web.Request) -> web.Response:
        body = request.get("auth_body") or {}
        status, reply = await self.handle_heartbeat(
            HeartbeatRequest.from_dict(body), request["auth_address"])
        return _web().json_response(reply, status=status)

    async def handle_heartbeat(self, hb: HeartbeatRequest, address: str) -> tuple[int, dict]:
        """The heartbeat section after the signature check: ``address`` is
        the authenticated one. Returns (HTTP status, JSON body) as the
        route answers them."""
        if hb.address.lower() != address:
            return 401, _err_body("address mismatch")

        # all store writes in one thread hop: with a RemoteKVStore these
        # are HTTP round-trips that must not pin the event loop
        banned = await asyncio.to_thread(self._heartbeat_store_ops, hb, address)
        if banned:
            return 401, _err_body("node is banned")

        self.metrics.record_heartbeat(address)
        # the batch solve runs device work; keep it off the event loop
        multi = getattr(self.scheduler, "get_tasks_for_node", None)
        if multi is not None:
            assigned = await asyncio.to_thread(multi, address)
        else:
            t = await asyncio.to_thread(self.scheduler.get_task_for_node, address)
            assigned = [t] if t is not None else []
        task = assigned[0] if assigned else None
        matcher = getattr(self.scheduler, "batch_matcher", None)
        if matcher is not None and matcher.last_solve_stats:
            stats = matcher.last_solve_stats
            seq = stats.get("seq", 0)
            if seq > self._observed_solve and "solve_ms" in stats:
                self._observed_solve = seq
                self.metrics.solve_duration.labels(
                    backend=type(matcher).__name__,
                    pool_id=str(self.pool_id),
                ).observe(stats["solve_ms"] / 1e3)
        data: dict = {"current_task": task.to_dict() if task else None}
        if len(assigned) > 1:
            # colocated node (ladder #5): several tasks share this
            # provider's capacity concurrently; multi-task-aware workers
            # run them all, legacy workers run current_task only
            data["assigned_tasks"] = [t.to_dict() for t in assigned]
        return 200, {"success": True, "data": data}

    # ----- storage (api/routes/storage.rs:24-309) -----

    async def request_upload(self, request: web.Request) -> web.Response:
        if self.storage is None:
            return _err("storage not configured", 501)
        body = request.get("auth_body") or {}
        address = request["auth_address"]

        try:
            file_name = str(body["file_name"])
            file_size = int(body["file_size"])
            sha256 = str(body["sha256"])
        except (KeyError, ValueError, TypeError):
            return _err("missing file_name/file_size/sha256", 400)
        # counted at ENTRY so the counter still moves when requests fail —
        # a flatlining upload counter during a storage outage would read as
        # "no traffic" exactly when the operator needs the opposite signal
        _mtask = (
            self.store.task_store.get_task(str(body.get("task_id")))
            if body.get("task_id")
            else None
        )
        self.metrics.record_upload_request(
            address, str(body.get("task_id") or ""), _mtask.name if _mtask else ""
        )
        # the sha becomes a storage object name (mapping/{sha}) and a KV key:
        # anything but plain LOWERCASE hex is rejected — mixed case would
        # alias one digest to multiple owner keys / mapping objects (a
        # case-variant sha could remap a victim's resolution), and honest
        # clients send hexdigest() output which is lowercase
        if not re.fullmatch(r"[0-9a-f]{64}", sha256):
            return _err("sha256 must be 64 lowercase hex chars", 400)
        task_id = body.get("task_id")

        if file_size > MAX_UPLOAD_BYTES:
            return _err("file too large", 400)

        # rate limit N/hour/address (storage.rs:80-104)
        rate_key = UPLOAD_RATE_KEY.format(address)
        count = self.store.kv.incr(rate_key)
        if count == 1:
            self.store.kv.expire(rate_key, 3600)
        if count > self.uploads_per_hour:
            return _err("upload rate exceeded", 429)

        object_name = file_name
        task = self.store.task_store.get_task(task_id) if task_id else None
        if task and task.storage_config and task.storage_config.file_name_template:
            object_name = self._expand_file_template(
                task.storage_config.file_name_template, file_name, address
            )

        # The reference leaves the object-name surface open; close it here:
        # a node must not write under mapping/ (the validator's sha ->
        # file-name resolution namespace) or it could misdirect validation
        # of a victim's pending work (hard invalidation + slash).
        norm = posixpath.normpath(object_name)
        if posixpath.isabs(norm) or norm == ".." or norm.startswith("../"):
            # provider-independent: escaping names must die here, not rely
            # on each StorageProvider's own path checks
            return _err("invalid object name", 400)
        if norm == "mapping" or norm.startswith("mapping/"):
            return _err("object name under mapping/ is reserved", 400)

        try:
            # URL first: an invalid object name must fail before any state
            # (sha ownership, mapping) is written. The URL's validity is
            # capped to the claim grace window: a claim may only be taken
            # over once NO signed URL issued for it can still be in flight
            url = await self.storage.generate_upload_signed_url(
                object_name,
                expires_in=UPLOAD_CLAIM_GRACE,
                max_bytes=file_size,
            )
        except ValueError as e:  # e.g. path-escaping object names
            return _err(str(e), 400)

        # One sha, one owner: refuse re-mapping a sha another node already
        # claimed (prevents overwriting a victim's pending-work resolution).
        # Claimed only AFTER the object name validated; released if the
        # mapping write itself fails, so a failed request cannot squat a
        # victim's sha. The claim records a timestamp: between a legitimate
        # claimant's request-upload response and its signed-URL PUT neither
        # the mapping nor the object exists yet, so "object missing" alone
        # must not read as stale — takeover additionally requires the claim
        # to be older than the signed-URL expiry (UPLOAD_CLAIM_GRACE).
        # KV ops run off the event loop (each is a blocking HTTP round trip
        # on RemoteKVStore deployments) and inside one atomic section so a
        # racing claimant cannot interleave with the read-modify-write.
        owner_key = UPLOAD_SHA_OWNER_KEY.format(sha256)

        def _claim_attempt():
            # lock-free fast path: set-nx is already atomic, and the common
            # case (fresh sha) must not serialize every upload on the
            # store-wide advisory lock
            now = self._time()
            mine = {"addr": address, "ts": now, "first": now}
            if self.store.kv.set(owner_key, json.dumps(mine), nx=True):
                return "claimed", mine
            with self.store.kv.atomic():
                now = self._time()
                mine = {"addr": address, "ts": now, "first": now}
                if self.store.kv.set(owner_key, json.dumps(mine), nx=True):
                    return "claimed", mine
                cur = _parse_owner_claim(self.store.kv.get(owner_key))
                if cur is None:  # released between set-nx and get: re-claim
                    self.store.kv.set(owner_key, json.dumps(mine))
                    return "claimed", mine
                if cur["addr"] == address:
                    # refresh the timestamp (this request issues a FRESH
                    # signed URL, so the takeover grace restarts — else a
                    # retried PUT could be seized mid-flight) but keep
                    # "first": the total-age cap below is what stops a
                    # live node from refresh-squatting a sha forever
                    mine = {"addr": address, "ts": now, "first": cur["first"]}
                    self.store.kv.set(owner_key, json.dumps(mine))
                    return "own", mine
                return "foreign", cur

        try:
            status, rec = await self._kv_section(_claim_attempt)
        except LockLostError:
            return _err("store contention, retry", 503)
        claimed_now = status == "claimed"
        if status == "foreign":
            # another node holds the claim — honored while it is live: only
            # if the mapped object never materialized (claimant crashed
            # before its PUT) AND the claim has outlived every signed URL
            # issued for it is it stale and takeover-able, so a dead node
            # cannot squat a deterministic artifact's sha forever while an
            # in-flight first upload cannot be seized mid-PUT. The total-age
            # cap bounds refresh-squatting: past 4x the grace with still no
            # object, the claim falls regardless of re-request refreshes.
            mapped = await self.storage.resolve_mapping_for_sha(sha256)
            uploaded = mapped is not None and await self.storage.file_exists(mapped)
            now = self._time()
            stale = (
                now - rec["ts"] >= UPLOAD_CLAIM_GRACE
                or now - rec["first"] >= 4 * UPLOAD_CLAIM_GRACE
            )
            if uploaded or not stale:
                return _err("sha256 already mapped by another node", 409)

            def _takeover():
                with self.store.kv.atomic():
                    latest = _parse_owner_claim(self.store.kv.get(owner_key))
                    if latest is not None and latest != rec:
                        return None  # a concurrent takeover moved first
                    t = self._time()
                    mine = {"addr": address, "ts": t, "first": t}
                    self.store.kv.set(owner_key, json.dumps(mine))
                    return mine

            try:
                rec = await self._kv_section(_takeover)
            except LockLostError:
                return _err("store contention, retry", 503)
            if rec is None:
                return _err("sha256 already mapped by another node", 409)
            claimed_now = True  # owns the claim now; release on failure below

        async def _release_if_mine():
            # only delete OUR record: an unconditional delete could drop a
            # successor's live claim if this request stalled past the grace
            # and lost a takeover race while its storage call was in flight.
            # Best-effort — a release lost to store trouble merely leaves a
            # claim that goes stale after the grace window
            def release():
                with self.store.kv.atomic():
                    latest = _parse_owner_claim(self.store.kv.get(owner_key))
                    if latest == rec:
                        self.store.kv.delete(owner_key)

            try:
                await self._kv_section(release)
            except Exception:
                logging.getLogger(__name__).warning(
                    "upload claim release failed for %s", owner_key, exc_info=True
                )

        try:
            await self.storage.generate_mapping_file(sha256, object_name)
        except ValueError as e:
            if claimed_now:
                await _release_if_mine()
            return _err(str(e), 400)
        except Exception:
            if claimed_now:
                await _release_if_mine()
            return _err("storage backend failure", 500)
        return _web().json_response(
            {"success": True, "data": {"signed_url": url, "object_name": object_name}}
        )

    async def upload_object(self, request: web.Request) -> web.Response:
        """Signed-URL upload endpoint for the LocalDir provider (the dev
        stand-in for GCS's signed PUT)."""
        from protocol_tpu_torch.utils.storage import LocalDirStorageProvider

        if not isinstance(self.storage, LocalDirStorageProvider):
            return _err("uploads not served by this deployment", 501)
        object_name = request.match_info["object_name"]
        try:
            expires = int(request.query.get("expires", "0"))
            max_bytes = int(request.query.get("max_bytes", "0"))
        except ValueError:
            return _err("invalid expires/max_bytes", 400)
        token = request.query.get("token", "")
        try:
            if not self.storage.verify_upload_url(
                object_name, expires, token, max_bytes=max_bytes
            ):
                return _err("invalid or expired upload token", 403)
        except ValueError:
            return _err("invalid object name", 400)
        # the HMAC binds the approved size; 0 means "global cap only"
        cap = min(max_bytes or MAX_UPLOAD_BYTES, MAX_UPLOAD_BYTES)
        if request.content_length and request.content_length > cap:
            return _err("file larger than approved size", 413)
        # stream to disk in chunks: concurrent 100 MB uploads must not
        # buffer whole bodies in orchestrator memory
        try:
            total = await self.storage.put_stream(
                object_name, request.content.iter_chunked(1 << 20), cap
            )
        except ValueError as e:  # size overflow or path-escaping name
            status = 413 if "approved size" in str(e) else 400
            return _err(str(e), status)
        return _web().json_response({"success": True, "data": {"bytes": total}})

    def _expand_file_template(
        self, template: str, original_name: str, address: str
    ) -> str:
        """Template vars incl. upload counters (storage.rs:127-215); the
        group variables expand as for a node in no group (node groups are
        ROADMAP queue A, M3)."""
        counter_key = UPLOAD_COUNTER_KEY.format(address, "-", template)
        total_after = self.store.kv.incr(counter_key)
        out = template.replace("${ORIGINAL_NAME}", original_name)
        out = out.replace("${NODE_GROUP_ID}", "")
        out = out.replace("${NODE_GROUP_SIZE}", "0")
        out = out.replace("${NODE_GROUP_INDEX}", "0")
        out = out.replace("${TOTAL_UPLOAD_COUNT_AFTER}", str(total_after))
        out = out.replace("${CURRENT_FILE_INDEX}", str(max(0, total_after - 1)))
        return out

    # ----- tasks (api/routes/task.rs) -----

    async def create_task(self, request: web.Request) -> web.Response:
        try:
            body = await request.json()
        except json.JSONDecodeError:
            return _err("invalid json", 400)
        req = TaskRequest.from_dict(body)
        if not req.name or not req.image:
            return _err("name and image required", 400)
        if self.store.task_store.name_exists(req.name):
            return _err("task name already exists", 409)
        try:
            task = Task.from_request(req)
        except ValueError as e:
            return _err(str(e), 400)
        self.store.task_store.add_task(task)
        return _web().json_response({"success": True, "data": task.to_dict()}, status=201)

    async def list_tasks(self, request: web.Request) -> web.Response:
        tasks = [t.to_dict() for t in self.store.task_store.get_all_tasks()]
        return _web().json_response({"success": True, "data": tasks})

    async def delete_task(self, request: web.Request) -> web.Response:
        task = self.store.task_store.delete_task(request.match_info["task_id"])
        if task is None:
            return _err("task not found", 404)
        self.store.metrics_store.delete_metrics_for_task(task.id)
        return _web().json_response({"success": True, "data": task.to_dict()})

    # ----- nodes -----

    async def list_nodes(self, request: web.Request) -> web.Response:
        status_filter = request.query.get("status")
        nodes = self.store.node_store.get_nodes()
        if status_filter:
            nodes = [n for n in nodes if n.status.value == status_filter]
        return _web().json_response(
            {"success": True, "data": [n.to_dict() for n in nodes]}
        )

    async def ban_node(self, request: web.Request) -> web.Response:
        address = request.match_info["address"].lower()
        self.store.kv.set(BAN_KEY.format(address), "1")
        node = self.store.node_store.get_node(address)
        if node is not None:
            self._set_status(address, NodeStatus.BANNED)
            self.store.metrics_store.delete_metrics_for_node(address)
        return _web().json_response({"success": True, "data": "banned"})

    # ----- node control proxies (reference: /nodes/{id}/logs|restart via
    # the p2p GetTaskLogs/Restart channels, api/routes/nodes.rs) -----

    async def _control_call(
        self, node: OrchestratorNode, method: str, path: str, timeout: float = 10.0
    ):
        """Signed control-plane call to a worker (the p2p channel analog).
        Non-2xx / success=false responses surface as errors — a rejected
        restart must not read as a successful one."""
        if self.control_http is None:
            return None, "control client not configured"
        url = (node.p2p_addresses or [None])[0]
        if not url:
            return None, "node has no control address"
        import aiohttp as _aiohttp

        from protocol_tpu_torch.security.signer import sign_request

        req_timeout = _aiohttp.ClientTimeout(total=timeout)
        try:
            if method == "GET":
                headers, _ = sign_request(path, self.wallet)
                async with self.control_http.get(
                    f"{url}{path.removeprefix('/control')}",
                    headers=headers,
                    timeout=req_timeout,
                ) as resp:
                    data = await resp.json()
            else:
                headers, body = sign_request(path, self.wallet, {})
                async with self.control_http.post(
                    f"{url}{path.removeprefix('/control')}",
                    json=body,
                    headers=headers,
                    timeout=req_timeout,
                ) as resp:
                    data = await resp.json()
            if resp.status >= 400 or data.get("success") is False:
                return None, data.get("error", f"worker returned {resp.status}")
            return data, None
        except Exception as e:
            return None, str(e)

    async def node_logs(self, request: web.Request) -> web.Response:
        node = self.store.node_store.get_node(request.match_info["address"].lower())
        if node is None:
            return _err("node not found", 404)
        data, err = await self._control_call(node, "GET", "/control/logs")
        if err:
            return _err(err, 502)
        return _web().json_response({"success": True, "data": data.get("logs", [])})

    async def node_restart(self, request: web.Request) -> web.Response:
        node = self.store.node_store.get_node(request.match_info["address"].lower())
        if node is None:
            return _err("node not found", 404)
        data, err = await self._control_call(node, "POST", "/control/restart")
        if err:
            return _err(err, 502)
        return _web().json_response({"success": True})

    # ----- groups: answered as the reference answers without a groups
    # plugin (node groups are ROADMAP queue A, M3)

    async def group_logs(self, request: web.Request) -> web.Response:
        """Per-member log fan-out (reference groups.rs:217-318)."""
        return _err("grouping not enabled", 400)

    async def list_groups(self, request: web.Request) -> web.Response:
        return _web().json_response({"success": True, "data": []})

    async def list_group_configs(self, request: web.Request) -> web.Response:
        return _web().json_response({"success": True, "data": []})

    async def force_regroup(self, request: web.Request) -> web.Response:
        return _err("grouping not enabled", 400)

    # ----- metrics -----

    async def get_metrics(self, request: web.Request) -> web.Response:
        return _web().json_response(
            {"success": True, "data": self.store.metrics_store.get_all_metrics()}
        )

    async def get_scheduler_stats(self, request: web.Request) -> web.Response:
        """Admin view of the batch matcher's last-solve stats (kernel,
        warm usage, cache deltas, stall/truncation counters) — the
        observability handle soak runs and operators assert against."""
        matcher = getattr(self.scheduler, "batch_matcher", None)
        stats = dict(matcher.last_solve_stats) if matcher is not None else {}
        return _web().json_response({"success": True, "data": stats})

    async def get_prometheus(self, request: web.Request) -> web.Response:
        """Prometheus exposition over the full metric-family registry
        (metrics/mod.rs:6-126); the store -> registry rebuild
        (metrics/sync_service.rs:37-180) runs at scrape time instead of on
        a 10 s loop."""
        self.metrics.sync(self.store)
        return _web().Response(
            body=self.metrics.render(), content_type="text/plain"
        )

    # ================= loops =================

    def _beat(self, loop_name: str) -> None:
        self.loop_beats[loop_name] = time.monotonic()

    INACTIVE_GRACE_SECONDS = 300.0  # monitor.rs:298-334 (5 min)

    async def discovery_monitor_once(self) -> int:
        """Sync nodes from discovery + reconcile statuses. Rule set mirrors
        discovery/monitor.rs:236-420, in its order:

        1. a non-Healthy node sharing its endpoint with a Healthy one -> Dead
        2. validated but provider no longer whitelisted -> Ejected
        3. Ejected + provider re-whitelisted -> Dead (so it can recover)
        4. inactive-on-ledger while Healthy, past a 5-min grace since the
           last status change -> Ejected (or Dead when still whitelisted)
        5. IP changes and missing locations are absorbed
        6. Dead + newer discovery update -> Discovered (+ spec refresh)
        7. zero balance -> LowBalance
        8. unknown nodes are added as Discovered unless their endpoint is
           already taken by a Healthy node
        """
        if self.discovery_fetcher is None:
            return 0
        discovered = await self.discovery_fetcher()
        seen: dict[str, DiscoveryNode] = {}
        for dn in discovered:  # dedup by id (monitor.rs:202-215)
            seen.setdefault(dn.node.id.lower(), dn)

        # one store read per tick, not per node; the healthy-endpoint index
        # is maintained incrementally for the only in-loop mutation that can
        # affect it (a HEALTHY node leaving HEALTHY)
        known = {n.address: n for n in self.store.node_store.get_nodes()}
        healthy_endpoints: dict[tuple[str, int], set[str]] = {}
        for o in known.values():
            if o.status == NodeStatus.HEALTHY:
                healthy_endpoints.setdefault((o.ip_address, o.port), set()).add(
                    o.address
                )

        def demote_healthy(address: str, status: NodeStatus) -> None:
            n = known.get(address)
            if n is not None and n.status == NodeStatus.HEALTHY:
                healthy_endpoints.get((n.ip_address, n.port), set()).discard(address)
            self._set_status(address, status)
            if n is not None:
                n.status = status
                n.last_status_change = time.time()

        changed = 0
        for addr, dn in seen.items():
            node = known.get(addr)
            owners = healthy_endpoints.get(
                (dn.node.ip_address, dn.node.port), set()
            )
            healthy_same_endpoint = len(owners - {addr})
            # start-of-iteration snapshot for rule 6 (monitor.rs:359-383
            # evaluates against the pre-tick node state, so a node marked
            # Dead earlier in this same tick can never be lifted here)
            orig_status = node.status if node else None
            orig_last_change = node.last_status_change if node else None

            if node is None:
                # rule 8: endpoint already owned by a healthy node -> skip
                if healthy_same_endpoint > 0:
                    continue
                fresh = OrchestratorNode(
                    address=addr,
                    ip_address=dn.node.ip_address,
                    port=dn.node.port,
                    status=NodeStatus.DISCOVERED,
                    compute_specs=dn.node.compute_specs,
                    p2p_id=dn.node.worker_p2p_id,
                    p2p_addresses=dn.node.worker_p2p_addresses,
                    location=dn.location,
                    price=dn.node.price,
                )
                self.store.node_store.add_node(fresh)
                known[addr] = fresh
                changed += 1
                continue

            # rule 1: endpoint squatting by a non-healthy node
            if healthy_same_endpoint > 0 and node.status != NodeStatus.HEALTHY:
                demote_healthy(addr, NodeStatus.DEAD)
                changed += 1
                continue

            # rule 2: whitelist revoked
            if dn.is_validated and not dn.is_provider_whitelisted:
                if node.status != NodeStatus.EJECTED:
                    demote_healthy(addr, NodeStatus.EJECTED)
                    changed += 1
            # rule 3: ejected + re-whitelisted -> dead (recoverable)
            if (
                dn.is_validated
                and dn.is_provider_whitelisted
                and node.status == NodeStatus.EJECTED
            ):
                demote_healthy(addr, NodeStatus.DEAD)
                changed += 1

            node = self.store.node_store.get_node(addr) or node
            known[addr] = node

            # rule 4: inactive on ledger while healthy, past the grace
            if not dn.is_active and node.status == NodeStatus.HEALTHY:
                past_grace = (
                    node.last_status_change is None
                    or time.time() - node.last_status_change
                    > self.INACTIVE_GRACE_SECONDS
                )
                if past_grace:
                    target = (
                        NodeStatus.DEAD
                        if dn.is_provider_whitelisted
                        else NodeStatus.EJECTED
                    )
                    demote_healthy(addr, target)
                    changed += 1
                    node = self.store.node_store.get_node(addr) or node
                    known[addr] = node

            # rule 5: absorb IP changes + missing locations (single write)
            dirty = False
            if node.ip_address != dn.node.ip_address:
                node.ip_address = dn.node.ip_address
                dirty = True
            if node.location is None and dn.location is not None:
                node.location = dn.location
                dirty = True
            # a LIVE cost-model input, not just a registration snapshot: a
            # provider re-registering with a new ask must reach the matcher
            # without dying first (rule 6 only covers Dead -> Discovered)
            if node.price != dn.node.price:
                node.price = dn.node.price
                dirty = True

            # rule 6: dead -> discovered on a newer discovery update, judged
            # against the START-of-tick snapshot: a node marked Dead earlier
            # in this very tick is not lifted (and, per the reference, both
            # timestamps must be present)
            if (
                orig_status == NodeStatus.DEAD
                and orig_last_change is not None
                and dn.last_updated
                and dn.last_updated > orig_last_change
            ):
                # spec refresh first, then the transition through _set_status
                # so webhook observers see Dead -> Discovered like every
                # other transition in this loop (monitor.rs:359-383)
                node.compute_specs = dn.node.compute_specs
                node.price = dn.node.price
                if dirty or node.compute_specs is not None:
                    self.store.node_store.update_node(node)
                    dirty = False
                self._set_status(addr, NodeStatus.DISCOVERED)
                node = self.store.node_store.get_node(addr) or node
                known[addr] = node
                changed += 1
            # rule 7: zero balance -> LowBalance
            elif dn.latest_balance == 0 and node.status == NodeStatus.HEALTHY:
                if dirty:
                    self.store.node_store.update_node(node)
                    dirty = False
                demote_healthy(addr, NodeStatus.LOW_BALANCE)
                changed += 1
            elif (
                node.status == NodeStatus.LOW_BALANCE
                and (dn.latest_balance or 0) > 0
            ):
                if dirty:
                    self.store.node_store.update_node(node)
                    dirty = False
                self._set_status(addr, NodeStatus.UNHEALTHY)
                changed += 1
            if dirty:
                self.store.node_store.update_node(node)
        return changed

    async def invite_once(self) -> int:
        """Invite Discovered nodes (node/invite.rs:73-223): build a signed,
        ledger-verifiable invite and deliver it via the pluggable sender
        (the reference's libp2p Invite protocol)."""
        if self.invite_sender is None:
            return 0
        invited = 0
        # possibly-remote ledger read off the event loop
        pool = await asyncio.to_thread(self.ledger.get_pool_info, self.pool_id)
        for node in self.store.node_store.get_uninvited_nodes():
            nonce = uuid.uuid4().hex
            expiration = time.time() + 600
            digest = invite_digest(
                pool.domain_id, self.pool_id, node.address, nonce, expiration
            )
            # NB: field name is invite_nonce — the request signer injects its
            # own replay "nonce" into every signed body, which must not
            # collide with the invite's ledger nonce
            payload = {
                "pool_id": self.pool_id,
                "domain_id": pool.domain_id,
                "invite_nonce": nonce,
                "expiration": expiration,
                "invite_signature": self.wallet.sign_message(digest),
                "heartbeat_url": self.heartbeat_url,
            }
            ok = await self.invite_sender(node, payload)
            if ok:
                self._set_status(node.address, NodeStatus.WAITING_FOR_HEARTBEAT)
                self.store.heartbeat_store.clear_unhealthy_counter(node.address)
                invited += 1
        return invited

    async def status_update_once(self) -> None:
        """Health FSM (status_update/mod.rs:215-312) + chain sync
        (:118-142)."""
        _t0 = time.perf_counter()
        try:
            # await-free body + possibly-remote ledger calls: run in a
            # thread so a stalled ledger API cannot pin the event loop
            # (and /health with it)
            await asyncio.to_thread(self._status_update_once)
        finally:
            self.metrics.status_update_execution_time.labels(
                pool_id=str(self.pool_id)
            ).observe(time.perf_counter() - _t0)

    def _status_update_once(self) -> None:
        hs = self.store.heartbeat_store
        for node in self.store.node_store.get_nodes():
            addr = node.address
            if node.status in (NodeStatus.BANNED, NodeStatus.EJECTED):
                continue
            beat = hs.get_heartbeat(addr)
            if beat is not None:
                if node.status in (
                    NodeStatus.UNHEALTHY,
                    NodeStatus.WAITING_FOR_HEARTBEAT,
                    NodeStatus.DISCOVERED,
                    NodeStatus.DEAD,
                    NodeStatus.HEALTHY,
                ):
                    in_pool = self.ledger.is_node_in_pool(self.pool_id, addr)
                    target = NodeStatus.HEALTHY if in_pool else NodeStatus.UNHEALTHY
                    if node.status != target:
                        self._set_status(addr, target)
                    hs.clear_unhealthy_counter(addr)
            else:
                if node.status == NodeStatus.HEALTHY:
                    self._set_status(addr, NodeStatus.UNHEALTHY)
                    hs.increment_unhealthy_counter(addr)
                elif node.status == NodeStatus.UNHEALTHY:
                    misses = hs.increment_unhealthy_counter(addr)
                    if misses >= DEAD_MISS_THRESHOLD:
                        self._mark_dead(node)
                elif node.status == NodeStatus.WAITING_FOR_HEARTBEAT:
                    misses = hs.increment_unhealthy_counter(addr)
                    if misses >= WAITING_GIVE_UP_MISSES:
                        self._mark_dead(node)

        # dead + in-pool -> eject (status_update/mod.rs:118-142)
        for node in self.store.node_store.get_nodes():
            if node.status == NodeStatus.DEAD and self.ledger.is_node_in_pool(
                self.pool_id, node.address
            ):
                try:
                    self.ledger.eject_node(
                        self.pool_id, node.address, self.wallet.address
                    )
                except LedgerError:
                    pass

    def _mark_dead(self, node: OrchestratorNode) -> None:
        self._set_status(node.address, NodeStatus.DEAD)
        # dead nodes lose their metrics (status_update/mod.rs:314-350)
        self.store.metrics_store.delete_metrics_for_node(node.address)

    # ================= runner =================

    async def serve(
        self, host: str = "127.0.0.1", port: int = 8090, ssl_context=None
    ) -> "web.AppRunner":
        """Start the HTTP server (TLS where ``ssl_context`` is given) and the
        background loops, which are parked on the app as ``app["loops"]``
        (the event loop holds tasks weakly). Node groups have no loop here
        (ROADMAP queue A, M3)."""
        web = _web()
        app = self.make_app()
        runner = web.AppRunner(app)
        await runner.setup()
        await web.TCPSite(runner, host, port, ssl_context=ssl_context).start()
        app["loops"] = self.start_loops()
        return runner

    def start_loops(self) -> list:
        """Start the service loops (the reference's processor-mode work);
        returns the task objects — hold them, or GC stops the pool."""
        log = logging.getLogger("protocol_tpu_torch.orchestrator")

        async def loop(name, fn, interval):
            while True:
                try:
                    await fn()
                    # beat only on success so /health surfaces a loop that
                    # fails every tick (loop_heartbeats.rs semantics)
                    self._beat(name)
                except Exception:
                    log.exception("loop %s tick failed", name)
                await asyncio.sleep(interval)

        return [
            asyncio.create_task(
                loop("discovery_monitor", self.discovery_monitor_once, MONITOR_INTERVAL)
            ),
            asyncio.create_task(loop("inviter", self.invite_once, INVITE_INTERVAL)),
            asyncio.create_task(
                loop("status_updater", self.status_update_once, STATUS_INTERVAL)
            ),
        ]


def _err_body(msg: str) -> dict:
    return {"success": False, "error": msg}


def _err(msg: str, status: int) -> "web.Response":
    return _web().json_response(_err_body(msg), status=status)
