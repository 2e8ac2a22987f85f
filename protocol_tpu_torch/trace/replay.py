"""Deterministic trace replay (``protocol_tpu/trace/replay.py``): feed a
recorded workload through the port's arena over a transport, verify the
recorded outcomes bit for bit, and localise the first divergence.

A trace fixes each tick's solve inputs (the epoch snapshot and the churned
rows of each delta). Replaying it through

  * ``inproc``: the arena in this process (the session path without the
    wire: the same padding and the same arena factory),
  * ``wire-v1``: the v1 unary wire, a full snapshot a tick, solved by the
    servicer's persistent warm arena, or
  * ``wire-v2``: the v2 session wire (a streamed snapshot, then
    AssignDelta ticks),

gives the same ``provider_for_task`` on every tick. Against a trace that
the port recorded, the replay verifies every tick (``divergence`` None);
against one the reference recorded, the haversine's ulps may move a few
rows (ROADMAP "Known differences"), and the report names the first
divergent tick and its rows, while :func:`compare` and the quality
roll-up say by how much the plans differ.

The engine names are the reference's, since traces and the wire carry
them: ``jax[:D]`` (or the port's ``torch[:D]``) is served by
:class:`~protocol_tpu_torch.parallel.torch_arena.TorchSolveArena` over D
views of ``device``; the native engines (``native-mt``, ``sinkhorn-mt``)
are refused (ROADMAP queue A, M5), and so the reference's native ISA pin
has no counterpart here. Replays run on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from protocol_tpu_torch.obs.spans import TRACER as _tracer
from protocol_tpu_torch.obs.spans import span_dicts_compact
from protocol_tpu_torch.proto import scheduler_pb2 as pb
from protocol_tpu_torch.proto import wire
from protocol_tpu_torch.trace import format as tfmt

_ENGINES = ("native-mt", "sinkhorn-mt", "jax", "torch")
_TRANSPORTS = ("inproc", "wire-v1", "wire-v2")


def parse_engine(kernel: str) -> tuple[str, int]:
    """``native-mt[:N]`` / ``sinkhorn-mt[:N]`` / ``jax[:D]`` / ``torch[:D]``
    -> (engine, threads; for the arena engines its device count D)."""
    base, _, suffix = kernel.partition(":")
    if base not in _ENGINES:
        raise ValueError(f"engine must be one of {_ENGINES}, got {kernel!r}")
    return base, (int(suffix) if suffix else 0)


def _kernel_str(engine: str, threads: int) -> str:
    return f"{engine}:{threads}" if threads else engine


def iter_input_ticks(trace: tfmt.Trace):
    """Yield ``(tick, p_cols, r_cols, delta_or_None)`` with the columns
    updated through each recorded delta (tick 0 is the snapshot). Columns
    are fresh copies per churned column, so callers may hold references
    across ticks."""
    snap = trace.snapshot
    if snap is None:
        raise ValueError(f"{trace.path}: no snapshot frame (empty trace?)")
    p_cols = dict(snap.p_cols)
    r_cols = dict(snap.r_cols)
    yield 0, p_cols, r_cols, None
    for i, d in enumerate(trace.deltas, start=1):
        # fresh dicts before the writes: the dicts yielded before never change
        p_cols, r_cols = dict(p_cols), dict(r_cols)
        for rows, delta, cols in ((d.provider_rows, d.p_cols, p_cols),
                                  (d.task_rows, d.r_cols, r_cols)):
            if not rows.size:
                continue
            for name, vals in delta.items():
                col = cols[name].copy()
                col[rows] = vals
                cols[name] = col
        yield i, p_cols, r_cols, d


class _InprocArena:
    """Transport "inproc": the session path without the wire, the same
    pow2 padding (``session_store._pad_cols``) and the same arena factory,
    so in-process and wire-v2 replays are bit-identical by construction."""

    def __init__(self, snap: tfmt.Snapshot, engine: str, threads: int, device):
        from protocol_tpu_torch.services.session_store import make_solve_arena

        self.top_k = max(int(snap.top_k) or 64, 1)
        self.arena = make_solve_arena(engine, k=self.top_k, threads=threads, device=device)

    def solve(self, snap, p_cols, r_cols) -> tuple[np.ndarray, dict]:
        from protocol_tpu_torch.ops.cost import CostWeights
        from protocol_tpu_torch.services.session_store import _pad_cols

        n_p, n_t = snap.n_providers, snap.n_tasks
        pp = _pad_cols(p_cols, n_p)
        rp = _pad_cols(r_cols, n_t)
        p4t = self.arena.solve(tfmt._as_ns(pp), tfmt._as_ns(rp), CostWeights(*snap.weights))
        return np.asarray(p4t, np.int32)[:n_t], self.arena.last_stats

    def close(self) -> None:
        pass


class _WireTransport:
    """Loopback gRPC replay against the port's own server: "wire-v1" ships a
    full v1 snapshot a tick (the servicer's warm unary arena solves the
    churn); "wire-v2" runs the session protocol (a streamed snapshot, then
    AssignDelta)."""

    def __init__(self, snap: tfmt.Snapshot, engine: str, threads: int, wire_version: str,
                 device):
        from protocol_tpu_torch.services.scheduler_grpc import SchedulerBackendClient, serve

        self.kernel = _kernel_str(engine, threads)
        self.top_k = max(int(snap.top_k) or 64, 1)
        self.wire_version = wire_version
        self.server = serve("127.0.0.1:0", device=device)
        self.client = SchedulerBackendClient(f"127.0.0.1:{self.server.port}")
        self._fp: Optional[str] = None
        self._tick = 0
        self.bytes_out = 0
        self.bytes_in = 0
        self.delta_split: list = []  # wire-v2's delta ticks, see solve()

    def _request_v2(self, snap, p_cols, r_cols) -> pb.AssignRequestV2:
        return pb.AssignRequestV2(
            providers=wire.encode_providers_v2(tfmt._as_ns(p_cols)),
            requirements=wire.encode_requirements_v2(tfmt._as_ns(r_cols)),
            weights=pb.CostWeights(price=snap.weights[0], load=snap.weights[1],
                                   proximity=snap.weights[2], priority=snap.weights[3]),
            kernel=self.kernel, top_k=self.top_k, eps=snap.eps, max_iters=snap.max_iters,
        )

    def solve(self, snap, p_cols, r_cols, delta=None):
        if self.wire_version == "v1":
            from protocol_tpu_torch.ops.cost import CostWeights
            from protocol_tpu_torch.services.scheduler_grpc import encoded_to_proto

            req = encoded_to_proto(tfmt._as_ns(p_cols), tfmt._as_ns(r_cols),
                                   CostWeights(*snap.weights), kernel=self.kernel,
                                   top_k=self.top_k, eps=snap.eps, max_iters=snap.max_iters)
            resp = self.client.assign(req, timeout=600)
            self.bytes_out += req.ByteSize()
            self.bytes_in += resp.ByteSize()
            p4t = np.fromiter(resp.provider_for_task, np.int32, count=len(resp.provider_for_task))
            return p4t, {"solve_ms": resp.solve_ms}

        if self._fp is None:  # the v2 session's open
            w = tfmt._as_ns(dict(zip(("price", "load", "proximity", "priority"), snap.weights)))
            self._fp = wire.epoch_fingerprint(p_cols, r_cols, w, self.kernel, self.top_k,
                                              snap.eps, snap.max_iters)
            chunks = list(wire.chunk_snapshot("replay", self._fp,
                                              self._request_v2(snap, p_cols, r_cols)))
            resp = self.client.open_session(iter(chunks), timeout=600)
            if not resp.ok:
                raise RuntimeError(f"OpenSession refused: {resp.error}")
            self.bytes_out += sum(len(c.payload) for c in chunks)
            self.bytes_in += resp.ByteSize()
            self._tick = 0
            p4t = wire.unblob(resp.result.provider_for_task, np.int32)
            return p4t, {"solve_ms": resp.result.solve_ms}

        self._tick += 1
        t0 = time.perf_counter()
        req = pb.AssignDeltaRequest(session_id="replay", epoch_fingerprint=self._fp,
                                    tick=self._tick)
        if delta is not None and delta.provider_rows.size:
            req.provider_rows.CopyFrom(wire.blob(delta.provider_rows, np.int32))
            req.providers.CopyFrom(wire.encode_providers_v2(tfmt._as_ns(delta.p_cols)))
        if delta is not None and delta.task_rows.size:
            req.task_rows.CopyFrom(wire.blob(delta.task_rows, np.int32))
            req.requirements.CopyFrom(wire.encode_requirements_v2(tfmt._as_ns(delta.r_cols)))
        t_ser = time.perf_counter()
        resp = self.client.assign_delta(req, timeout=600)
        t_rpc = time.perf_counter()
        if not resp.session_ok:
            raise RuntimeError(f"AssignDelta tick {self._tick} refused: {resp.error}")
        self.bytes_out += req.ByteSize()
        self.bytes_in += resp.ByteSize()
        p4t = wire.unblob(resp.result.provider_for_task, np.int32)
        # a delta tick's wall split: the client's packing, the round trip,
        # and inside it the server's time (its decode, the session's lock,
        # the delta's apply and the solve) and decode alone
        self.delta_split.append({
            "serialize_ms": round((t_ser - t0) * 1e3, 3),
            "rpc_ms": round((t_rpc - t_ser) * 1e3, 3),
            "server_ms": round(resp.result.solve_ms, 3),
            "server_decode_ms": round(resp.result.decode_ms, 3),
        })
        return p4t, {"solve_ms": resp.result.solve_ms}

    def close(self) -> None:
        self.client.close()
        self.server.stop(grace=None)


def replay(
    trace_path: str,
    engine: Optional[str] = None,
    threads: Optional[int] = None,
    transport: str = "inproc",
    verify: bool = True,
    record_path: Optional[str] = None,
    max_ticks: Optional[int] = None,
    keep_p4t: bool = False,
    device="cuda",
) -> dict:
    """Replay a trace; returns the report dict. ``report["divergence"]`` is
    None when every verified tick reproduced the recorded assignments bit
    for bit, else it names the first divergent tick and its rows.

    ``engine`` / ``threads`` default to the trace's recorded kernel
    string; ``transport`` is inproc | wire-v1 | wire-v2. ``record_path``
    writes a new trace with this replay's outcomes (how golden traces are
    made)."""
    if transport not in _TRANSPORTS:
        raise ValueError(f"transport must be one of {_TRANSPORTS}, got {transport!r}")
    trace = tfmt.read_trace(trace_path)
    snap = trace.snapshot
    if snap is None:
        raise ValueError(f"{trace_path}: no snapshot frame")
    if engine:
        eng, eng_threads = parse_engine(engine)
    else:
        try:
            eng, eng_threads = parse_engine(snap.kernel or "native-mt")
        except ValueError:
            raise ValueError(
                f"{trace_path} records kernel {snap.kernel!r}, which has no replay engine; "
                f"pass engine= (one of {_ENGINES}) to replay it through an explicit engine "
                "(outcome verification will then report the divergence)")
    n_threads = eng_threads if threads is None else int(threads)

    if transport == "inproc":
        backend = _InprocArena(snap, eng, n_threads, device)
    else:
        backend = _WireTransport(snap, eng, n_threads, transport.split("-")[1], device)

    writer = None
    if record_path is not None:
        meta = dict(trace.meta)
        meta.pop("version", None)
        meta.update(recorded_engine=eng, recorded_threads=n_threads,
                    recorded_transport=transport, source_trace=trace_path)
        writer = tfmt.TraceWriter(record_path, meta=meta)
        # the recorded epoch carries the kernel that solved it
        rsnap = tfmt.Snapshot(
            trace_id=snap.trace_id, fingerprint="", p_cols=snap.p_cols, r_cols=snap.r_cols,
            weights=snap.weights, kernel=_kernel_str(eng, n_threads), top_k=snap.top_k,
            eps=snap.eps, max_iters=snap.max_iters,
        )
        fp = wire.epoch_fingerprint(
            snap.p_cols, snap.r_cols,
            tfmt._as_ns(dict(zip(("price", "load", "proximity", "priority"), snap.weights))),
            rsnap.kernel, max(int(snap.top_k) or 64, 1), snap.eps, snap.max_iters,
        )
        writer.write_snapshot(snap.trace_id, fp, rsnap.request_v2())

    report: dict = {
        "trace": trace_path,
        "engine": eng,
        "threads": n_threads,
        "transport": transport,
        "recorded_kernel": snap.kernel,
        "providers": snap.n_providers,
        "tasks": snap.n_tasks,
        "ticks": 0,
        "verified_ticks": 0,
        "divergence": None,
        "tick_wall_ms": [],
        "assigned": [],
    }
    p4ts: list = []
    tick_stats: list = []  # scalar per-tick stats (the quality plane)
    try:
        for tick, p_cols, r_cols, delta in iter_input_ticks(trace):
            if max_ticks is not None and tick >= max_ticks:
                break
            t0 = time.perf_counter()
            # a root span per tick: the arena's and the servicer's spans
            # stitch under it, and a recording replay keeps them
            mark = _tracer.mark()
            with _tracer.span("replay.tick", tick=tick) as root:
                if isinstance(backend, _WireTransport):
                    p4t, stats = backend.solve(snap, p_cols, r_cols, delta)
                else:
                    p4t, stats = backend.solve(snap, p_cols, r_cols)
            wall_ms = (time.perf_counter() - t0) * 1e3
            report["ticks"] += 1
            report["tick_wall_ms"].append(round(wall_ms, 3))
            report["assigned"].append(int((p4t >= 0).sum()))
            tick_stats.append({k: v for k, v in (stats or {}).items()
                               if isinstance(v, (int, float, bool))})
            if keep_p4t:
                p4ts.append(p4t)
            if writer is not None:
                if delta is not None:
                    writer.write_delta_cols(tick, delta.provider_rows, delta.p_cols,
                                            delta.task_rows, delta.r_cols, events=delta.events)
                metrics = {"wall_ms": round(wall_ms, 3)}
                metrics.update({k: v for k, v in (stats or {}).items()
                                if isinstance(v, (int, float, bool, str))})
                if root is not None:
                    spans = _tracer.since(mark, trace=root["trace"])
                    if spans:
                        metrics["trace_id"] = root["trace"]
                        metrics["spans"] = span_dicts_compact(spans)
                writer.write_outcome(tick, p4t, metrics=metrics)
            if verify:
                rec = trace.outcome_for(tick)
                if rec is not None:
                    report["verified_ticks"] += 1
                    if not np.array_equal(p4t, rec.provider_for_task):
                        rows = np.flatnonzero(p4t != rec.provider_for_task)
                        report["divergence"] = {
                            "tick": tick,
                            "n_rows": int(rows.size),
                            "rows": rows[:64].tolist(),
                            "recorded_assigned": rec.num_assigned,
                            "replayed_assigned": int((p4t >= 0).sum()),
                        }
                        break  # localised: the first divergent tick and its rows
    finally:
        backend.close()
        if writer is not None:
            writer.close()

    walls = report["tick_wall_ms"]
    if walls:
        report["cold_ms"] = walls[0]
        if len(walls) > 1:
            from protocol_tpu_torch.obs.metrics import percentiles_ms

            report["warm_mean_ms"] = round(float(np.mean(walls[1:])), 3)
            report["warm_median_ms"] = round(float(np.median(walls[1:])), 3)
            report["warm_percentiles"] = percentiles_ms(walls[1:])
    quality = _aggregate_quality(tick_stats)
    if quality is not None:
        report["quality"] = quality
    if isinstance(backend, _WireTransport):
        report["wire_bytes_out"] = backend.bytes_out
        report["wire_bytes_in"] = backend.bytes_in
        if backend.delta_split:
            report["wire_delta_split_ms"] = backend.delta_split
    if keep_p4t:
        report["p4ts"] = p4ts
    return report


def _aggregate_quality(tick_stats: list) -> Optional[dict]:
    """The per-tick quality scalars (the arena's last_stats through the
    inproc transport; the wire transports carry none) rolled up by the
    shared :func:`~protocol_tpu_torch.obs.quality.aggregate_quality`."""
    from protocol_tpu_torch.obs.quality import aggregate_quality

    return aggregate_quality(tick_stats)


def compare(trace_path: str, config_a: dict, config_b: dict, max_ticks: Optional[int] = None,
            device="cuda") -> dict:
    """Replay one trace under two configs side by side (the A/B harness).
    Each config is {engine, threads, transport}. Reports both replays'
    timing and assignment stats and a tick-wise diff of the matchings."""
    a = replay(trace_path, verify=False, keep_p4t=True, max_ticks=max_ticks, device=device,
               **config_a)
    b = replay(trace_path, verify=False, keep_p4t=True, max_ticks=max_ticks, device=device,
               **config_b)
    n = min(len(a["p4ts"]), len(b["p4ts"]))
    first_diff = None
    diff_rows = 0
    for t in range(n):
        d = int((a["p4ts"][t] != b["p4ts"][t]).sum())
        diff_rows += d
        if d and first_diff is None:
            first_diff = t
    out = {
        "trace": trace_path,
        "a": {k: v for k, v in a.items() if k != "p4ts"},
        "b": {k: v for k, v in b.items() if k != "p4ts"},
        "identical": first_diff is None,
        "first_divergent_tick": first_diff,
        "divergent_rows_total": diff_rows,
    }
    if a.get("warm_mean_ms") and b.get("warm_mean_ms"):
        out["warm_speedup_b_over_a"] = round(a["warm_mean_ms"] / b["warm_mean_ms"], 3)
    # quality deltas: by how much the plans differ, and who pays
    qa, qb = a.get("quality"), b.get("quality")
    if qa and qb:
        delta = {
            "gap_per_task_delta": round(qb["gap_per_task_mean"] - qa["gap_per_task_mean"], 6),
            "starve_max_delta": qb["starve_max"] - qa["starve_max"],
        }
        if qa.get("plan_cost_mean"):
            delta["plan_cost_ratio_b_over_a"] = round(
                qb["plan_cost_mean"] / qa["plan_cost_mean"], 6)
        if qa.get("churn_ratio_mean") is not None and qb.get("churn_ratio_mean") is not None:
            delta["churn_ratio_delta"] = round(qb["churn_ratio_mean"] - qa["churn_ratio_mean"], 6)
        out["quality_delta"] = delta
    if a.get("assigned") and b.get("assigned"):
        out["assigned_min_delta"] = min(b["assigned"]) - min(a["assigned"])
    return out
