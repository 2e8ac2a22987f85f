"""Flight-recorder CLI of the port: ``python -m protocol_tpu_torch.trace
<verb>`` (``protocol_tpu/trace/__main__.py``).

  synth    write a parameterized synthetic workload trace (inputs only)
  record   replay an input trace through the port's arena and write a new
           trace with the outcomes (how golden traces are made)
  replay   replay a trace, verify the recorded outcomes bit for bit and
           print the (empty or localised) divergence report; --compare
           runs an A/B of two configs over the same trace
  info     summarize a trace (shape, ticks, frames, truncation, timings)

Every verb prints one JSON document on stdout; replay exits non-zero on a
divergence. Replays run on the card (``--device cuda``, the default) or on
the CPU with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys


def _cmd_synth(args) -> int:
    from protocol_tpu_torch.trace import format as tfmt
    from protocol_tpu_torch.trace.synth import synth_trace

    path = synth_trace(
        args.out, n_providers=args.providers, n_tasks=args.tasks, ticks=args.ticks,
        churn=args.churn, task_churn=args.task_churn, seed=args.seed, kernel=args.kernel,
        top_k=args.top_k, eps=args.eps, headroom=args.headroom, growth=args.growth,
        hotspot_every=args.hotspot_every, hotspot_frac=args.hotspot_frac,
        disconnect_at=args.disconnect_at, disconnect_frac=args.disconnect_frac,
        reconnect_after=args.reconnect_after,
    )
    print(json.dumps(tfmt.info(path), indent=1))
    return 0


def _cmd_record(args) -> int:
    from protocol_tpu_torch.trace.replay import replay

    rep = replay(args.trace, engine=args.engine, threads=args.threads,
                 transport=args.transport, verify=False, record_path=args.out,
                 max_ticks=args.max_ticks, device=args.device)
    print(json.dumps(rep, indent=1))
    return 0


def _cmd_replay(args) -> int:
    from protocol_tpu_torch.trace.replay import compare, replay

    if args.compare:
        eng_b, _, thr_b = args.compare.partition(":")
        rep = compare(
            args.trace,
            {"engine": args.engine, "threads": args.threads, "transport": args.transport},
            {"engine": eng_b or None, "threads": int(thr_b) if thr_b else None,
             "transport": args.compare_transport or args.transport},
            max_ticks=args.max_ticks, device=args.device,
        )
        print(json.dumps(rep, indent=1))
        return 0
    rep = replay(args.trace, engine=args.engine, threads=args.threads,
                 transport=args.transport, verify=not args.no_verify, record_path=args.out,
                 max_ticks=args.max_ticks, device=args.device)
    print(json.dumps(rep, indent=1))
    if rep["divergence"] is not None:
        d = rep["divergence"]
        print(f"DIVERGENCE at tick {d['tick']}: {d['n_rows']} rows differ "
              f"(first {d['rows'][:8]})", file=sys.stderr)
        return 1
    return 0


def _cmd_info(args) -> int:
    from protocol_tpu_torch.trace import format as tfmt

    print(json.dumps(tfmt.info(args.trace), indent=1))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m protocol_tpu_torch.trace")
    sub = ap.add_subparsers(dest="verb", required=True)

    sp = sub.add_parser("synth", help="generate a synthetic workload trace")
    sp.add_argument("out")
    sp.add_argument("--providers", type=int, default=1024)
    sp.add_argument("--tasks", type=int, default=1024)
    sp.add_argument("--ticks", type=int, default=16)
    sp.add_argument("--churn", type=float, default=0.01)
    sp.add_argument("--task-churn", type=float, default=0.0)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--kernel", default="native-mt")
    sp.add_argument("--top-k", type=int, default=64)
    sp.add_argument("--eps", type=float, default=0.02)
    sp.add_argument("--headroom", type=float, default=0.0)
    sp.add_argument("--growth", type=float, default=0.0)
    sp.add_argument("--hotspot-every", type=int, default=0)
    sp.add_argument("--hotspot-frac", type=float, default=0.05)
    sp.add_argument("--disconnect-at", type=int, default=0)
    sp.add_argument("--disconnect-frac", type=float, default=0.25)
    sp.add_argument("--reconnect-after", type=int, default=0)
    sp.set_defaults(fn=_cmd_synth)

    def _replay_args(p, with_out_required: bool):
        p.add_argument("trace")
        p.add_argument("--engine", default=None,
                       help="jax[:D] | torch[:D] (default: the trace's recorded kernel)")
        p.add_argument("--threads", type=int, default=None)
        p.add_argument("--transport", default="inproc",
                       choices=["inproc", "wire-v1", "wire-v2"])
        p.add_argument("--max-ticks", type=int, default=None)
        p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
        if with_out_required:
            p.add_argument("--out", required=True,
                           help="write the replayed trace (with outcomes)")
        else:
            p.add_argument("--out", default=None,
                           help="also write a trace with this replay's outcomes")

    rp = sub.add_parser("record", help="replay + write outcomes (golden)")
    _replay_args(rp, with_out_required=True)
    rp.set_defaults(fn=_cmd_record)

    pp = sub.add_parser("replay", help="replay + verify bit for bit")
    _replay_args(pp, with_out_required=False)
    pp.add_argument("--no-verify", action="store_true")
    pp.add_argument("--compare", default=None, metavar="ENGINE[:THREADS]",
                    help="A/B: replay again under this engine and diff")
    pp.add_argument("--compare-transport", default=None)
    pp.set_defaults(fn=_cmd_replay)

    ip = sub.add_parser("info", help="summarize a trace file")
    ip.add_argument("trace")
    ip.set_defaults(fn=_cmd_info)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
