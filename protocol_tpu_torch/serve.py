"""Service entry points of the port (``protocol_tpu/serve.py``, in part).

    python -m protocol_tpu_torch.serve scheduler --address 0.0.0.0:50061 \\
        [--max-workers 4] [--device cuda|cpu]

``scheduler`` is the gRPC kernel backend (``serve_scheduler``,
``protocol_tpu/serve.py:566``) on one card: the ``Assign`` / ``AssignV2``
/ ``Health`` RPCs and the v2 sessions (``OpenSession``, ``AssignDelta``).
The reference's fleet flags
(``--metrics-port``, ``--proc-id``, ``--ckpt-dir``, ``--endpoint``) are
refused: their layers (the obs endpoint, checkpointed sessions, the
distributed fleet) are not ported yet.
"""

from __future__ import annotations

import argparse
import signal
import sys

_UNPORTED_FLAGS = ("--metrics-port", "--proc-id", "--ckpt-dir", "--endpoint")


def serve_scheduler(args) -> None:
    """The gRPC kernel backend: serves until SIGTERM or SIGINT, then
    stops, letting in-flight RPCs finish for up to five seconds."""
    from protocol_tpu_torch.services.scheduler_grpc import serve

    server = serve(address=args.address, max_workers=args.max_workers, device=args.device)
    print(f"scheduler backend on {args.address} (port {server.port}, device {args.device})",
          flush=True)

    def _on_sigterm(signum, frame):
        server.stop(grace=5.0).wait()
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        server.wait_for_termination()
    except KeyboardInterrupt:
        server.stop(grace=5.0).wait()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m protocol_tpu_torch.serve")
    sub = parser.add_subparsers(dest="service", required=True)
    p = sub.add_parser("scheduler", help="the gRPC kernel backend")
    p.add_argument("--address", default="0.0.0.0:50061")
    p.add_argument("--max-workers", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args, unknown = parser.parse_known_args(argv)
    refused = [u for u in unknown if u.split("=")[0] in _UNPORTED_FLAGS]
    if refused:
        parser.error(f"{', '.join(refused)}: the fleet layers are not ported "
                     "(ROADMAP queue A, M4b / M6)")
    if unknown:
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    serve_scheduler(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
