"""The flight recorder's trace format (``protocol_tpu/trace/format.py``,
copied so that the port reads and writes the reference's files): a
versioned, append-only file of framed records.

A trace is the bit-reproducible record of one scheduler-seam workload:
one epoch SNAPSHOT frame (the full columnar marketplace and every solve
parameter, the wire-v2 ``AssignRequestV2``), then per-tick DELTA frames
(churned provider and task rows as full row replacements, the wire-v2
``AssignDeltaRequest``, with optional lifecycle events) and OUTCOME frames
(the solve's assignments, carried duals and per-tick metrics). Replaying
it through an engine reproduces the recorded matching bit for bit or
localises the first divergent tick
(:mod:`protocol_tpu_torch.trace.replay`).

File layout (all integers little-endian)::

    magic   b"PTTRACE1"                                (8 bytes)
    frame*  u8 kind | u8 flags | u32 len | u32 crc32   (10-byte header)
            payload[len]                               (deflate if flags&1)

Frames are written and flushed one at a time, so a killed run leaves a
valid prefix: the reader stops at a truncated header, a short payload or a
CRC mismatch and reports ``truncated=True``. Compression is per-frame
DEFLATE (zlib), deterministic, so recording the same workload twice gives
byte-identical files. Payloads reuse the wire-v2 ``TensorBlob`` codecs
(:mod:`protocol_tpu_torch.proto.wire`); the trace keeps its own copy of the
column dtypes (:data:`P_TRACE_DTYPES` / :data:`R_TRACE_DTYPES`), checked
against the wire's at import of a reader or writer.
"""

from __future__ import annotations

import dataclasses
import json
import struct
import zlib
from typing import Iterator, Optional

import numpy as np

from protocol_tpu_torch.proto import scheduler_pb2 as pb
from protocol_tpu_torch.proto import wire

MAGIC = b"PTTRACE1"
VERSION = 1

# frame kinds
KIND_META = 1      # JSON: trace provenance + generator knobs
KIND_SNAPSHOT = 2  # pb.SnapshotChunk: epoch header + AssignRequestV2 payload
KIND_DELTA = 3     # u32 n | pb.AssignDeltaRequest[n] | JSON events
KIND_OUTCOME = 4   # u32 n | pb.AssignResponseV2[n] | JSON {tick, metrics}
KIND_EVENT = 5     # JSON {tick, events}: out-of-band structured events
#                    (SLO burn-rate alerts) — NOT solve inputs, so the
#                    replayer ignores them; old readers skip the kind
KIND_ARENA = 6     # named-ndarray pack (pack_arrays): carried solver
#                    state, used by session checkpoint files, never by
#                    workload traces; the replayer skips the kind

_FLAG_DEFLATE = 1
_HEADER = struct.Struct("<BBII")

# Canonical trace-frame column dtypes. They must match the wire tables
# (proto/wire.py) column for column, which _check_tables() checks. The
# duplication is deliberate: a trace on disk is decoded by this table, so a
# wire revision that drifts a column fails here instead of reinterpreting
# archived bytes.
P_TRACE_DTYPES: dict[str, np.dtype] = {
    "gpu_count": np.dtype(np.int32),
    "gpu_mem_mb": np.dtype(np.int32),
    "gpu_model_id": np.dtype(np.int32),
    "has_gpu": np.dtype(np.bool_),
    "has_cpu": np.dtype(np.bool_),
    "cpu_cores": np.dtype(np.int32),
    "ram_mb": np.dtype(np.int32),
    "storage_gb": np.dtype(np.int32),
    "lat": np.dtype(np.float32),
    "lon": np.dtype(np.float32),
    "has_location": np.dtype(np.bool_),
    "price": np.dtype(np.float32),
    "load": np.dtype(np.float32),
    "valid": np.dtype(np.bool_),
}
R_TRACE_DTYPES: dict[str, np.dtype] = {
    "cpu_required": np.dtype(np.bool_),
    "cpu_cores": np.dtype(np.int32),
    "ram_mb": np.dtype(np.int32),
    "storage_gb": np.dtype(np.int32),
    "gpu_opt_valid": np.dtype(np.bool_),
    "gpu_count": np.dtype(np.int32),
    "gpu_mem_min": np.dtype(np.int32),
    "gpu_mem_max": np.dtype(np.int32),
    "gpu_total_mem_min": np.dtype(np.int32),
    "gpu_total_mem_max": np.dtype(np.int32),
    "gpu_model_mask": np.dtype(np.uint32),
    "gpu_model_constrained": np.dtype(np.bool_),
    "lat": np.dtype(np.float32),
    "lon": np.dtype(np.float32),
    "has_location": np.dtype(np.bool_),
    "priority": np.dtype(np.float32),
    "valid": np.dtype(np.bool_),
}


def _check_tables() -> None:
    for name, mine, theirs in (
        ("P", P_TRACE_DTYPES, wire.P_WIRE_DTYPES),
        ("R", R_TRACE_DTYPES, wire.R_WIRE_DTYPES),
    ):
        if list(mine.items()) != list(theirs.items()):
            raise AssertionError(
                f"{name}_TRACE_DTYPES drifted from the wire table — archived "
                "traces would decode at the wrong widths"
            )


# ---------------- named-ndarray pack (ARENA frames) ----------------


def pack_arrays(named: dict[str, Optional[np.ndarray]]) -> bytes:
    """Deterministic bytes for a dict of (optionally None) ndarrays:
    a sorted JSON manifest (name -> dtype/shape/offset) followed by the
    C-order little-endian raw buffers: the checkpoint codec, byte-exact as
    the TensorBlob columns are, without protobuf."""
    manifest: dict = {}
    buffers: list[bytes] = []
    off = 0
    for name in sorted(named):
        a = named[name]
        if a is None:
            manifest[name] = None
            continue
        a = np.ascontiguousarray(a)
        raw = a.tobytes()
        manifest[name] = {
            "dtype": a.dtype.name,
            "shape": list(a.shape),
            "offset": off,
        }
        buffers.append(raw)
        off += len(raw)
    head = json.dumps(manifest, sort_keys=True).encode()
    return struct.pack("<I", len(head)) + head + b"".join(buffers)


def unpack_arrays(payload: bytes) -> dict[str, Optional[np.ndarray]]:
    """Inverse of :func:`pack_arrays`. Raises ValueError on a short or
    inconsistent payload (a torn checkpoint must fail loudly at load,
    never decode at the wrong widths)."""
    if len(payload) < 4:
        raise ValueError("array pack too short for its header")
    (n,) = struct.unpack_from("<I", payload)
    head = payload[4:4 + n]
    if len(head) < n:
        raise ValueError("array pack manifest truncated")
    manifest = json.loads(head)
    base = 4 + n
    out: dict[str, Optional[np.ndarray]] = {}
    for name, m in manifest.items():
        if m is None:
            out[name] = None
            continue
        dt = np.dtype(m["dtype"])
        shape = tuple(int(s) for s in m["shape"])
        count = int(np.prod(shape)) if shape else 1
        start = base + int(m["offset"])
        end = start + count * dt.itemsize
        if end > len(payload):
            raise ValueError(f"array pack buffer {name!r} truncated")
        out[name] = np.frombuffer(
            payload[start:end], dtype=dt
        ).reshape(shape)
    return out


# ---------------- frame records ----------------


@dataclasses.dataclass
class DeltaRecord:
    """One recorded tick's inputs: churned rows + lifecycle events."""

    tick: int
    provider_rows: np.ndarray  # i32 [n]
    p_cols: dict[str, np.ndarray]  # churned rows only, trace dtypes
    task_rows: np.ndarray
    r_cols: dict[str, np.ndarray]
    events: list


@dataclasses.dataclass
class OutcomeRecord:
    """One recorded tick's solve result + provenance metrics."""

    tick: int
    provider_for_task: np.ndarray  # i32 [T]
    price: Optional[np.ndarray]  # f32 [P] (carried duals), may be absent
    num_assigned: int
    metrics: dict  # per-phase ms, wire bytes, arena stats


@dataclasses.dataclass
class Snapshot:
    """The epoch: full columns + every solve parameter."""

    trace_id: str
    fingerprint: str
    p_cols: dict[str, np.ndarray]
    r_cols: dict[str, np.ndarray]
    weights: tuple  # (price, load, proximity, priority) f32
    kernel: str
    top_k: int
    eps: float
    max_iters: int

    @property
    def n_providers(self) -> int:
        return int(self.p_cols["gpu_count"].shape[0])

    @property
    def n_tasks(self) -> int:
        return int(self.r_cols["cpu_cores"].shape[0])

    def request_v2(self) -> pb.AssignRequestV2:
        """Re-pack as the wire message (what the snapshot frame holds)."""
        return pb.AssignRequestV2(
            providers=wire.encode_providers_v2(
                _as_ns(self.p_cols)
            ),
            requirements=wire.encode_requirements_v2(
                _as_ns(self.r_cols)
            ),
            weights=pb.CostWeights(
                price=self.weights[0], load=self.weights[1],
                proximity=self.weights[2], priority=self.weights[3],
            ),
            kernel=self.kernel, top_k=self.top_k, eps=self.eps,
            max_iters=self.max_iters,
        )


@dataclasses.dataclass
class Trace:
    """A parsed trace: meta + snapshot + per-tick delta/outcome records."""

    path: str
    meta: dict
    snapshot: Optional[Snapshot]
    deltas: list  # DeltaRecord, tick order
    outcomes: list  # OutcomeRecord, tick order (tick 0 = snapshot solve)
    truncated: bool
    n_frames: int
    # EVENT frames ({tick, events}): an observational side channel,
    # never replay input
    events: list = dataclasses.field(default_factory=list)

    @property
    def ticks(self) -> int:
        """Input ticks: the snapshot plus every delta frame."""
        return (1 if self.snapshot is not None else 0) + len(self.deltas)

    def outcome_for(self, tick: int) -> Optional[OutcomeRecord]:
        # index built lazily: replay verifies one lookup per tick
        by_tick = self.__dict__.get("_outcome_by_tick")
        if by_tick is None or len(by_tick) != len(self.outcomes):
            by_tick = {o.tick: o for o in self.outcomes}
            self.__dict__["_outcome_by_tick"] = by_tick
        return by_tick.get(tick)


def _as_ns(cols: dict[str, np.ndarray]):
    ns = type("_Cols", (), {})()
    for name, arr in cols.items():
        setattr(ns, name, arr)
    return ns


# ---------------- writer ----------------


class TraceWriter:
    """Append-only frame writer. Every ``write_*`` call lands one fully
    flushed frame, so a SIGKILL can never lose more than the frame being
    written (the reader tolerates that torn tail)."""

    def __init__(self, path: str, meta: Optional[dict] = None,
                 compresslevel: int = 6):
        _check_tables()
        self.path = path
        self.compresslevel = compresslevel
        self._fh = open(path, "wb")
        self._fh.write(MAGIC)
        m = {"version": VERSION}
        m.update(meta or {})
        self._frame(KIND_META, json.dumps(m, sort_keys=True).encode())

    def _frame(self, kind: int, payload: bytes) -> None:
        flags = 0
        z = zlib.compress(payload, self.compresslevel)
        if len(z) < len(payload):
            payload, flags = z, _FLAG_DEFLATE
        self._fh.write(
            _HEADER.pack(kind, flags, len(payload), zlib.crc32(payload))
        )
        self._fh.write(payload)
        self._fh.flush()

    def write_snapshot(
        self, trace_id: str, fingerprint: str, request: pb.AssignRequestV2
    ) -> None:
        payload = request.SerializeToString()
        chunk = pb.SnapshotChunk(
            session_id=trace_id, epoch_fingerprint=fingerprint,
            payload=payload, total_bytes=len(payload),
        )
        self._frame(KIND_SNAPSHOT, chunk.SerializeToString())

    def write_delta(
        self, delta: pb.AssignDeltaRequest, events: Optional[list] = None
    ) -> None:
        body = delta.SerializeToString()
        ev = json.dumps(events or [], sort_keys=True).encode()
        self._frame(KIND_DELTA, struct.pack("<I", len(body)) + body + ev)

    def write_delta_cols(
        self,
        tick: int,
        provider_rows: np.ndarray,
        p_cols: Optional[dict[str, np.ndarray]],
        task_rows: np.ndarray,
        r_cols: Optional[dict[str, np.ndarray]],
        events: Optional[list] = None,
    ) -> None:
        """Column-dict convenience front end over :meth:`write_delta`."""
        req = pb.AssignDeltaRequest(tick=tick)
        if provider_rows is not None and provider_rows.size:
            req.provider_rows.CopyFrom(wire.blob(provider_rows, np.int32))
            req.providers.CopyFrom(wire.encode_providers_v2(_as_ns(p_cols)))
        if task_rows is not None and task_rows.size:
            req.task_rows.CopyFrom(wire.blob(task_rows, np.int32))
            req.requirements.CopyFrom(
                wire.encode_requirements_v2(_as_ns(r_cols))
            )
        self.write_delta(req, events)

    def write_events(self, tick: int, events: list) -> None:
        """Out-of-band structured events (SLO burn-rate alerts) tied to
        a tick. Never a solve input: the replayer skips EVENT frames,
        and pre-EVENT readers skip the unknown kind by contract."""
        self._frame(
            KIND_EVENT,
            json.dumps(
                {"tick": int(tick), "events": list(events)}, sort_keys=True
            ).encode(),
        )

    def write_arena(self, named: dict[str, Optional[np.ndarray]]) -> None:
        """Carried solver state as one ARENA frame (checkpoint files;
        workload traces never carry one, and the replayer skips it)."""
        self._frame(KIND_ARENA, pack_arrays(named))

    def write_outcome(
        self,
        tick: int,
        provider_for_task: np.ndarray,
        price: Optional[np.ndarray] = None,
        metrics: Optional[dict] = None,
    ) -> None:
        resp = pb.AssignResponseV2(
            provider_for_task=wire.blob(provider_for_task, np.int32),
            num_assigned=int((np.asarray(provider_for_task) >= 0).sum()),
        )
        if price is not None:
            resp.price.CopyFrom(wire.blob(price, np.float32))
        body = resp.SerializeToString()
        tail = json.dumps(
            {"tick": int(tick), "metrics": metrics or {}}, sort_keys=True
        ).encode()
        self._frame(KIND_OUTCOME, struct.pack("<I", len(body)) + body + tail)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------- reader ----------------


def read_frames(path: str) -> Iterator[tuple[int, bytes]]:
    """Yield (kind, payload) per intact frame; a torn tail (truncated
    header/payload, CRC mismatch) ends iteration cleanly — the final
    yield is the sentinel ``(-1, b"")`` ONLY when the tail was torn."""
    with open(path, "rb") as fh:
        if fh.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not a PTTRACE1 trace file")
        while True:
            head = fh.read(_HEADER.size)
            if not head:
                return  # clean EOF
            if len(head) < _HEADER.size:
                yield -1, b""
                return
            kind, flags, length, crc = _HEADER.unpack(head)
            payload = fh.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                yield -1, b""
                return
            if flags & _FLAG_DEFLATE:
                payload = zlib.decompress(payload)
            yield kind, payload


def _parse_snapshot(payload: bytes) -> Snapshot:
    chunk = pb.SnapshotChunk()
    chunk.ParseFromString(payload)
    req = pb.AssignRequestV2()
    req.ParseFromString(chunk.payload)
    p_cols = wire._decode_columns(req.providers, P_TRACE_DTYPES)
    r_cols = wire._decode_columns(req.requirements, R_TRACE_DTYPES)
    return Snapshot(
        trace_id=chunk.session_id,
        fingerprint=chunk.epoch_fingerprint,
        p_cols=p_cols,
        r_cols=r_cols,
        weights=(
            req.weights.price, req.weights.load,
            req.weights.proximity, req.weights.priority,
        ),
        kernel=req.kernel,
        top_k=int(req.top_k),
        eps=float(req.eps),
        max_iters=int(req.max_iters),
    )


def _parse_delta(payload: bytes) -> DeltaRecord:
    (n,) = struct.unpack_from("<I", payload)
    req = pb.AssignDeltaRequest()
    req.ParseFromString(payload[4:4 + n])
    events = json.loads(payload[4 + n:] or b"[]")
    prow = (
        wire.unblob(req.provider_rows, np.int32)
        if req.HasField("provider_rows") else np.zeros(0, np.int32)
    )
    trow = (
        wire.unblob(req.task_rows, np.int32)
        if req.HasField("task_rows") else np.zeros(0, np.int32)
    )
    p_cols = (
        wire._decode_columns(req.providers, P_TRACE_DTYPES)
        if prow.size else {}
    )
    r_cols = (
        wire._decode_columns(req.requirements, R_TRACE_DTYPES)
        if trow.size else {}
    )
    return DeltaRecord(
        tick=int(req.tick), provider_rows=prow, p_cols=p_cols,
        task_rows=trow, r_cols=r_cols, events=events,
    )


def _parse_outcome(payload: bytes) -> OutcomeRecord:
    (n,) = struct.unpack_from("<I", payload)
    resp = pb.AssignResponseV2()
    resp.ParseFromString(payload[4:4 + n])
    tail = json.loads(payload[4 + n:] or b"{}")
    return OutcomeRecord(
        tick=int(tail.get("tick", -1)),
        provider_for_task=wire.unblob(resp.provider_for_task, np.int32),
        price=(
            wire.unblob(resp.price, np.float32)
            if resp.HasField("price") else None
        ),
        num_assigned=int(resp.num_assigned),
        metrics=tail.get("metrics", {}),
    )


def read_trace(path: str) -> Trace:
    """Parse a trace file. Tolerant of torn tails: whatever frames are
    intact come back, with ``truncated=True`` flagging the tear."""
    _check_tables()
    meta: dict = {}
    snapshot: Optional[Snapshot] = None
    deltas: list[DeltaRecord] = []
    outcomes: list[OutcomeRecord] = []
    events: list = []
    truncated = False
    n_frames = 0
    for kind, payload in read_frames(path):
        if kind == -1:
            truncated = True
            break
        n_frames += 1
        if kind == KIND_META:
            meta = json.loads(payload)
        elif kind == KIND_SNAPSHOT:
            snapshot = _parse_snapshot(payload)
        elif kind == KIND_DELTA:
            deltas.append(_parse_delta(payload))
        elif kind == KIND_OUTCOME:
            outcomes.append(_parse_outcome(payload))
        elif kind == KIND_EVENT:
            events.append(json.loads(payload))
        # unknown kinds are skipped: future writers may append new frame
        # kinds without breaking old readers (the version rides in META)
    return Trace(
        path=path, meta=meta, snapshot=snapshot, deltas=deltas,
        outcomes=outcomes, truncated=truncated, n_frames=n_frames,
        events=events,
    )


def info(path: str) -> dict:
    """Human-facing summary (the ``trace info`` CLI verb)."""
    t = read_trace(path)
    out = {
        "path": path,
        "version": t.meta.get("version"),
        "meta": {k: v for k, v in t.meta.items() if k != "version"},
        "frames": t.n_frames,
        "truncated": t.truncated,
        "ticks": t.ticks,
        "outcomes": len(t.outcomes),
        "events": len(t.events),
    }
    if t.snapshot is not None:
        s = t.snapshot
        delta_rows = sum(
            int(d.provider_rows.size + d.task_rows.size) for d in t.deltas
        )
        out.update(
            providers=s.n_providers, tasks=s.n_tasks, kernel=s.kernel,
            top_k=s.top_k, eps=round(s.eps, 6), fingerprint=s.fingerprint,
            delta_rows_total=delta_rows,
        )
    if t.outcomes:
        out["assigned_last"] = t.outcomes[-1].num_assigned
        solve_ms = [
            o.metrics.get("solve_ms") for o in t.outcomes
            if o.metrics.get("solve_ms") is not None
        ]
        if solve_ms:
            out["mean_solve_ms"] = round(float(np.mean(solve_ms)), 3)
    return out
