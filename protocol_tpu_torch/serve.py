"""Service entry points of the port (``protocol_tpu/serve.py``, in part).

    python -m protocol_tpu_torch.serve scheduler --address 0.0.0.0:50061 \\
        [--max-workers 4] [--device cuda|cpu] \\
        [--ckpt-dir DIR] [--proc-id ID] [--endpoint HOST:PORT]
    MANAGER_KEY=<hex> python -m protocol_tpu_torch.serve orchestrator \\
        --ledger-url URL --pool-id N [--port 8090] [--state-dir DIR] \\
        [--scheduler-backend local|remote|remote:HOST:PORT] [--device cuda|cpu]

``scheduler`` is the gRPC kernel backend (``serve_scheduler``,
``protocol_tpu/serve.py:566``) on one card: the ``Assign`` / ``AssignV2``
/ ``Health`` RPCs, the v2 sessions (``OpenSession``, ``AssignDelta``) and
``Migrate``. ``--ckpt-dir`` is the journal root shared by the fleet's
processes (warm restarts and the live migration's handoff), ``--proc-id``
this process's namespace under it, ``--endpoint`` the address its
``moved:`` redirects name; each overrides its ``PROTOCOL_TPU_FLEET_*``
variable, and the endpoint falls back to the bind address. SIGTERM drains:
no new sessions, in-flight ticks finish, every journal is flushed, and the
count is printed. ``--metrics-port`` is refused: the obs endpoint is not
ported (ROADMAP queue A, M6).

``orchestrator`` is the pool's coordinator (``serve_orchestrator``,
``protocol_tpu/serve.py:184``): the HTTP API a worker's signed heartbeats
reach, its loops, and the batch matcher behind the ``Scheduler``:
``--scheduler-backend local`` solves in process on the card (``--device
cpu`` asks for the CPU), ``remote:HOST:PORT`` over the port's gRPC backend
there, a bare ``remote`` on one booted in process. ``--state-dir`` holds the
KV journal (``orchestrator.aof``). Secrets and knobs come from the
environment as the reference's: ``MANAGER_KEY`` (the pool's key; its
scheme from ``PROTOCOL_TPU_WALLET_SCHEME``), ``ADMIN_API_KEY``,
``LEDGER_API_KEY``, ``STORAGE_DIR`` / ``STORAGE_PUBLIC_URL``,
``DISCOVERY_URLS``, ``WEBHOOK_CONFIGS``, ``HEARTBEAT_URL``,
``UPLOADS_PER_HOUR`` and the matcher's ``PROTOCOL_TPU_NATIVE_*``,
``PROTOCOL_TPU_DENSE_CELL_BUDGET``, ``PROTOCOL_TPU_USE_MESH``,
``PROTOCOL_TPU_APPROX_RECALL`` and ``PROTOCOL_TPU_WIRE``. Refused, each
naming its ROADMAP item: ``NODE_GROUP_CONFIGS`` (node groups, queue A, M3);
``--kv-url`` and ``--mode api|processor`` (the kv-api pod and the mode
split), ``S3_CREDENTIALS`` (cloud storage) (queue A, M4c).
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import os
import signal
import sys

VERSION = os.environ.get("PROTOCOL_TPU_VERSION", "dev")
_UNPORTED_FLAGS = ("--metrics-port",)
_TRUE = ("1", "true", "yes")


def fleet_config(args):
    """The servicer's FleetConfig from the fleet flags, or None (the
    servicer then reads ``PROTOCOL_TPU_FLEET_*``) when none is given.
    Precedence: the flag, then the environment, then the bind address for
    the endpoint (``protocol_tpu/serve.py:574-592``)."""
    if not (args.proc_id or args.ckpt_dir or args.endpoint):
        return None
    from protocol_tpu_torch.fleet.fabric import FleetConfig

    fleet = FleetConfig.from_env()
    overrides = {"endpoint": args.endpoint or fleet.endpoint or args.address}
    if args.proc_id:
        overrides["proc_id"] = args.proc_id
    if args.ckpt_dir:
        overrides["ckpt_dir"] = args.ckpt_dir
    return dataclasses.replace(fleet, **overrides)


def serve_scheduler(args) -> None:
    """The gRPC kernel backend: serves until SIGTERM (a drain) or SIGINT."""
    from protocol_tpu_torch.services.scheduler_grpc import drain, serve

    server = serve(address=args.address, max_workers=args.max_workers, device=args.device,
                   fleet=fleet_config(args))
    print(f"scheduler backend on {args.address} (port {server.port}, device {args.device})",
          flush=True)

    def _on_sigterm(signum, frame):
        flushed = drain(server)
        print(f"drained: {flushed} session checkpoint(s) flushed", flush=True)
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        server.wait_for_termination()
    except KeyboardInterrupt:
        server.stop(grace=5.0).wait()


def _wallet_from_env(var: str):
    """The pod's identity from ``var``; ``PROTOCOL_TPU_WALLET_SCHEME``
    selects the scheme (``ed25519``, the default; ``evm``; ``evm-recovery``).
    All three verify through one seam, so pods of different schemes
    interoperate."""
    from protocol_tpu_torch.security import EvmRecoveryWallet, EvmWallet, Wallet

    key = os.environ.get(var, "")
    if not key:
        raise SystemExit(f"{var} env var required")
    scheme = os.environ.get("PROTOCOL_TPU_WALLET_SCHEME", "ed25519")
    cls = {"ed25519": Wallet, "evm": EvmWallet, "evm-recovery": EvmRecoveryWallet}.get(scheme)
    if cls is None:
        raise SystemExit(f"unknown PROTOCOL_TPU_WALLET_SCHEME {scheme!r}")
    return cls.from_hex(key)


def _storage():
    """The upload storage from the environment: a local directory
    (``STORAGE_DIR``), or none."""
    if os.environ.get("S3_CREDENTIALS", ""):
        raise SystemExit("S3_CREDENTIALS: cloud storage (utils/cloud_storage.py) is not ported "
                         "(ROADMAP queue A, M4c); use STORAGE_DIR")
    root = os.environ.get("STORAGE_DIR", "")
    if not root:
        return None
    from protocol_tpu_torch.utils.storage import LocalDirStorageProvider

    return LocalDirStorageProvider(root, public_base_url=os.environ.get("STORAGE_PUBLIC_URL", ""))


def _server_ssl(args):
    """The TLS server context from --tls-cert / --tls-key (or TLS_CERT /
    TLS_KEY); None serves plaintext."""
    cert = args.tls_cert or os.environ.get("TLS_CERT", "")
    key = args.tls_key or os.environ.get("TLS_KEY", "")
    if not cert and not key:
        return None
    if not (cert and key):
        raise SystemExit("--tls-cert and --tls-key must be given together")
    from protocol_tpu_torch.utils.tls import server_ssl_context

    return server_ssl_context(cert, key)


def build_matcher(args, store):
    """The batch matcher behind the orchestrator's scheduler, from
    ``--scheduler-backend`` and the reference's environment knobs
    (``protocol_tpu/serve.py:245-330``). Returns (matcher, in-process gRPC
    server or None)."""
    backend = args.scheduler_backend
    if backend != "local" and not (backend == "remote" or backend.startswith("remote:")):
        raise SystemExit(f"unknown --scheduler-backend {backend!r} "
                         "(want local | remote | remote:HOST:PORT)")
    engine = dict(
        native_fallback=os.environ.get("PROTOCOL_TPU_NATIVE_FALLBACK", "").lower() in _TRUE,
        native_engine=os.environ.get("PROTOCOL_TPU_NATIVE_ENGINE", "native"),
        native_threads=int(os.environ.get("PROTOCOL_TPU_NATIVE_THREADS") or 0),
    )
    if backend != "local":
        from protocol_tpu_torch.services import scheduler_grpc

        addr = backend.partition(":")[2]
        grpc_server = None
        if not addr:
            # a bare "remote" boots the backend in process; hold the server
            # or it is collected and stops
            addr = "127.0.0.1:50061"
            grpc_server = scheduler_grpc.serve(addr, device=args.device or "cuda")
        matcher = scheduler_grpc.RemoteBatchMatcher(
            store, addr, wire=os.environ.get("PROTOCOL_TPU_WIRE", "v2"), device=args.device,
            **engine)
        return matcher, grpc_server
    from protocol_tpu_torch.sched.torch_backend import TorchBatchMatcher

    approx = os.environ.get("PROTOCOL_TPU_APPROX_RECALL")
    matcher = TorchBatchMatcher(
        store,
        dense_cell_budget=int(os.environ.get("PROTOCOL_TPU_DENSE_CELL_BUDGET", 1 << 24)),
        use_mesh=os.environ.get("PROTOCOL_TPU_USE_MESH", "").lower() in _TRUE,
        approx_recall=float(approx) if approx else None,
        device=args.device,
        **engine,
    )
    return matcher, None


def build_orchestrator(args, session=None):
    """The orchestrator service of ``serve orchestrator`` (without its
    transport): the KV store (journaled under ``--state-dir``), the matcher
    with its task observers, the ``Scheduler`` over it, the ledger client
    and the environment's wallet, storage, webhooks and discovery URLs.
    ``session`` is the aiohttp client session of the control calls, the
    discovery fetch and the invites."""
    if os.environ.get("NODE_GROUP_CONFIGS", ""):
        raise SystemExit("NODE_GROUP_CONFIGS: node groups are not ported "
                         "(ROADMAP queue A, M3)")
    storage = _storage()
    from protocol_tpu_torch.chain.remote import RemoteLedger
    from protocol_tpu_torch.models.node import DiscoveryNode
    from protocol_tpu_torch.sched.scheduler import Scheduler
    from protocol_tpu_torch.security import sign_request
    from protocol_tpu_torch.services.orchestrator import OrchestratorService
    from protocol_tpu_torch.store import StoreContext
    from protocol_tpu_torch.store.kv import KVStore

    wallet = _wallet_from_env("MANAGER_KEY")
    ledger = RemoteLedger(args.ledger_url, admin_api_key=os.environ.get("LEDGER_API_KEY", ""))
    store = StoreContext(KVStore(persist_path=(
        os.path.join(args.state_dir, "orchestrator.aof") if args.state_dir else None)))
    matcher, grpc_server = build_matcher(args, store)
    matcher.attach_observers()
    scheduler = Scheduler(store, batch_matcher=matcher)

    webhook = None
    if os.environ.get("WEBHOOK_CONFIGS", ""):
        from protocol_tpu_torch.sched.webhook import WebhookConfig, WebhookPlugin

        webhook = WebhookPlugin(WebhookConfig.from_json_env(os.environ["WEBHOOK_CONFIGS"]),
                                http=session)
    discovery_urls = [u for u in os.environ.get("DISCOVERY_URLS", "").split(",") if u]

    async def discovery_fetcher():
        for url in discovery_urls:
            headers, _ = sign_request(f"/api/pool/{args.pool_id}", wallet)
            try:
                async with session.get(f"{url}/api/pool/{args.pool_id}",
                                       headers=headers) as resp:
                    data = await resp.json()
                    return [DiscoveryNode.from_dict(d) for d in data.get("data", [])]
            except Exception:
                continue
        return []

    async def invite_sender(node, payload):
        url = (node.p2p_addresses or [None])[0]
        if not url:
            return False
        headers, body = sign_request("/control/invite", wallet, payload)
        try:
            async with session.post(f"{url}/invite", json=body, headers=headers) as resp:
                return resp.status == 200
        except Exception:
            return False

    scheme = "https" if _server_ssl(args) is not None else "http"
    svc = OrchestratorService(
        ledger, args.pool_id, wallet, store=store, scheduler=scheduler, storage=storage,
        discovery_fetcher=discovery_fetcher if discovery_urls else None,
        invite_sender=invite_sender,
        admin_api_key=os.environ.get("ADMIN_API_KEY", "admin"),
        # an https listener behind an http:// invite URL is unreachable
        heartbeat_url=os.environ.get("HEARTBEAT_URL", f"{scheme}://localhost:{args.port}"),
        uploads_per_hour=int(os.environ.get("UPLOADS_PER_HOUR", "3")),
        control_http=session, webhook=webhook,
    )
    svc.grpc_server = grpc_server  # keeps the in-process backend alive
    return svc


async def serve_orchestrator(args) -> None:
    """The orchestrator's HTTP API and loops, until cancelled."""
    from protocol_tpu_torch.utils.tls import env_client_session

    session = env_client_session()
    runner = None
    try:
        svc = build_orchestrator(args, session)
        if svc.webhook is not None:
            svc.webhook.start()
        # the runner's app holds the loops (app["loops"]) while it is served
        runner = await svc.serve("0.0.0.0", args.port, ssl_context=_server_ssl(args))
        print(f"orchestrator on :{args.port} (version {VERSION}, scheduler "
              f"{args.scheduler_backend}, device {svc.scheduler.batch_matcher.device})",
              flush=True)
        while True:
            await asyncio.sleep(3600)
    finally:
        if runner is not None:
            await runner.cleanup()
        await session.close()


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m protocol_tpu_torch.serve")
    sub = parser.add_subparsers(dest="service", required=True)
    p = sub.add_parser("orchestrator", help="the pool's coordinator: heartbeats, tasks, loops")
    # flags win; the environment is the default
    p.add_argument("--ledger-url", default=os.environ.get("LEDGER_URL", ""))
    p.add_argument("--pool-id", type=int, default=int(os.environ.get("COMPUTE_POOL_ID", "-1")))
    p.add_argument("--state-dir", default=os.environ.get("STATE_DIR", ""),
                   help="the KV journal's directory (orchestrator.aof)")
    p.add_argument("--tls-cert", default=os.environ.get("TLS_CERT", ""))
    p.add_argument("--tls-key", default=os.environ.get("TLS_KEY", ""))
    p.add_argument("--port", type=int, default=8090)
    p.add_argument("--scheduler-backend", default="local",
                   help="local | remote | remote:HOST:PORT")
    p.add_argument("--device", default=None, choices=("cuda", "cpu"),
                   help="the matcher's device (default: the card)")
    p.add_argument("--mode", choices=("full", "api", "processor"), default="full",
                   help="api and processor are not ported (ROADMAP queue A, M4c)")
    p.add_argument("--kv-url", default=os.environ.get("KV_URL", ""),
                   help="not ported (ROADMAP queue A, M4c)")

    p = sub.add_parser("scheduler", help="the gRPC kernel backend")
    p.add_argument("--address", default="0.0.0.0:50061")
    p.add_argument("--max-workers", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--proc-id", default=None,
                   help="this process's journal namespace under --ckpt-dir (also "
                        "PROTOCOL_TPU_FLEET_PROC_ID)")
    p.add_argument("--ckpt-dir", default=None,
                   help="the shared journal root: warm restarts and the migration's handoff "
                        "(also PROTOCOL_TPU_FLEET_CKPT_DIR)")
    p.add_argument("--endpoint", default=None,
                   help="the address moved:<endpoint> redirects name (default: --address; "
                        "also PROTOCOL_TPU_FLEET_ENDPOINT)")
    args, unknown = parser.parse_known_args(argv)
    refused = [u for u in unknown if u.split("=")[0] in _UNPORTED_FLAGS]
    if refused:
        parser.error(f"{', '.join(refused)}: the obs endpoint is not ported "
                     "(ROADMAP queue A, M6)")
    if unknown:
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    if args.service == "orchestrator":
        if args.kv_url:
            parser.error("--kv-url: the remote KV store and the kv-api pod are not ported "
                         "(ROADMAP queue A, M4c)")
        if args.mode != "full":
            parser.error(f"--mode {args.mode}: the api / processor split is not ported "
                         "(ROADMAP queue A, M4c)")
        if not args.ledger_url:
            parser.error("--ledger-url (or LEDGER_URL env) required")
        if args.pool_id < 0:
            parser.error("--pool-id (or COMPUTE_POOL_ID env) required")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.service == "orchestrator":
        try:
            asyncio.run(serve_orchestrator(args))
        except KeyboardInterrupt:
            pass
        return 0
    serve_scheduler(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
