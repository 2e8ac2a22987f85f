"""Service entry points of the port (``protocol_tpu/serve.py``, in part).

    python -m protocol_tpu_torch.serve scheduler --address 0.0.0.0:50061 \\
        [--max-workers 4] [--device cuda|cpu] \\
        [--ckpt-dir DIR] [--proc-id ID] [--endpoint HOST:PORT]

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
"""

from __future__ import annotations

import argparse
import dataclasses
import signal
import sys

_UNPORTED_FLAGS = ("--metrics-port",)


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


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m protocol_tpu_torch.serve")
    sub = parser.add_subparsers(dest="service", required=True)
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
    return args


def main(argv=None) -> int:
    serve_scheduler(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
