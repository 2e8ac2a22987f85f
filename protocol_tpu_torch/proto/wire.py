"""Wire v2 codecs of the scheduler seam (``protocol_tpu/proto/wire.py``):
tensor frames (``TensorBlob``: ``ndarray.tobytes()`` on the producer,
``np.frombuffer`` on the consumer) and the column specs they carry.

Layout contract, as in the reference: blobs are C-order little-endian;
each encoded column rides under its dataclass field name with a fixed
canonical dtype (:data:`P_WIRE_DTYPES` / :data:`R_WIRE_DTYPES`), asserted
once at decode; the seam is the trust boundary. The codecs work on numpy,
as the reference's do: the servicer places decoded columns on its device
(``protocol_tpu_torch.services.scheduler_grpc``), and the encoders take
numpy or torch columns.

Session epochs, as in the reference: a snapshot's identity is
:func:`epoch_fingerprint` (sha1 over every column's bytes plus the solve
parameters); the servicer pins per-``(session_id, fingerprint)`` warm
state, and a delta tick against an unknown or mismatched session is
refused. Snapshots stream as bounded :func:`chunk_snapshot` frames and
are reassembled, within :data:`MAX_SNAPSHOT_BYTES`, by
:func:`assemble_snapshot`.
"""

from __future__ import annotations

import dataclasses
import gzip as _gzip
import hashlib
import zlib
from typing import Iterable, Iterator, Optional

import numpy as np

from protocol_tpu_torch.proto import scheduler_pb2 as pb

# canonical wire dtype per encoded column (bool stays 1-byte numpy bool_)
P_WIRE_DTYPES: dict[str, np.dtype] = {
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
R_WIRE_DTYPES: dict[str, np.dtype] = {
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


def host(a) -> np.ndarray:
    """A column as a numpy array: torch tensors are read back from their
    device, anything else goes through ``np.asarray``."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def blob(arr, dtype: Optional[np.dtype] = None) -> pb.TensorBlob:
    """Pack an array into a TensorBlob (one cast if needed, one memcpy)."""
    a = host(arr)
    a = np.ascontiguousarray(a, dtype) if dtype is not None else np.ascontiguousarray(a)
    return pb.TensorBlob(data=a.tobytes(), dtype=a.dtype.name, shape=list(a.shape))


def unblob(msg: pb.TensorBlob, expect: Optional[np.dtype] = None) -> np.ndarray:
    """Zero-copy view over the blob bytes. The seam's single dtype check:
    a blob whose dtype disagrees with the declared column dtype is a
    protocol violation (ValueError), not something to coerce quietly."""
    try:
        dt = np.dtype(msg.dtype)
    except TypeError:
        raise ValueError(f"tensor frame has invalid dtype {msg.dtype!r}")
    if expect is not None and dt != np.dtype(expect):
        raise ValueError(
            f"tensor frame dtype mismatch: got {dt.name}, want {np.dtype(expect).name}"
        )
    shape = tuple(msg.shape)
    n = int(np.prod(shape)) if shape else 0
    if len(msg.data) != n * dt.itemsize:
        raise ValueError(
            f"tensor frame size mismatch: {len(msg.data)} bytes for shape {shape} "
            f"dtype {dt.name}"
        )
    return np.frombuffer(msg.data, dtype=dt).reshape(shape)


def _encode_columns(enc, spec: dict[str, np.dtype], out) -> None:
    for name, dt in spec.items():
        nt = out.columns.add()
        nt.name = name
        nt.tensor.CopyFrom(blob(getattr(enc, name), dt))


def encode_providers_v2(ep) -> pb.ProviderBatchV2:
    m = pb.ProviderBatchV2()
    _encode_columns(ep, P_WIRE_DTYPES, m)
    return m


def encode_requirements_v2(er) -> pb.RequirementBatchV2:
    m = pb.RequirementBatchV2()
    _encode_columns(er, R_WIRE_DTYPES, m)
    return m


def _decode_columns(msg, spec: dict[str, np.dtype]) -> dict[str, np.ndarray]:
    cols = {nt.name: nt.tensor for nt in msg.columns}
    missing = set(spec) - set(cols)
    if missing:
        raise ValueError(f"tensor batch missing columns: {sorted(missing)}")
    out = {name: unblob(cols[name], dt) for name, dt in spec.items()}
    # a frame that decodes at the right dtypes can still be poison: ragged
    # row counts index out of sibling columns, and a NaN/Inf cost input
    # reaches every cell of its row; both are refused here
    n_rows = None
    for name, a in out.items():
        if a.ndim == 0:
            raise ValueError(f"column {name!r} is not row-shaped")
        if n_rows is None:
            n_rows = a.shape[0]
        elif a.shape[0] != n_rows:
            raise ValueError(
                f"column row-count mismatch: {name!r} has {a.shape[0]} rows, "
                f"expected {n_rows}"
            )
        if a.dtype.kind == "f" and a.size and not np.isfinite(a).all():
            raise ValueError(f"non-finite values in column {name!r}")
    return out


def decode_providers_v2(msg: pb.ProviderBatchV2) -> dict[str, np.ndarray]:
    """The provider columns of a v2 batch, by field name (numpy views)."""
    return _decode_columns(msg, P_WIRE_DTYPES)


def decode_requirements_v2(msg: pb.RequirementBatchV2) -> dict[str, np.ndarray]:
    """The requirement columns of a v2 batch, by field name (numpy views)."""
    return _decode_columns(msg, R_WIRE_DTYPES)


def canon_columns(enc, spec: dict[str, np.dtype]) -> dict[str, np.ndarray]:
    """Canonical contiguous numpy columns for diffing / fingerprinting."""
    return {name: np.ascontiguousarray(host(getattr(enc, name)), dt) for name, dt in spec.items()}


def real_rows(enc) -> int:
    """The rows before the pow2 padding: up to the last valid row. A row
    marked invalid before it (a provider that phase 0 or 0.5 claimed) is a
    real entity, and its index is the one the answer speaks of."""
    valid = np.flatnonzero(np.asarray(host(enc.valid), bool))
    return int(valid[-1]) + 1 if valid.size else 0


def strip_padding(enc):
    """Drop the pow2-padding tail (:func:`real_rows`) before the wire:
    padded rows would be real entities to the backend and dead weight on
    the wire. Rows marked invalid inside the real rows stay, with their
    ``valid`` column. Returns the same dataclass with numpy columns (a
    namespace of host columns stays a namespace)."""
    return select_rows(enc, slice(0, real_rows(enc)))


def select_rows(enc, rows):
    """``enc`` with the rows ``rows`` (a slice or indices) of every column,
    as numpy columns (a namespace of host columns stays a namespace)."""
    if not dataclasses.is_dataclass(enc):
        ns = type(enc)()
        for name, a in vars(enc).items():
            setattr(ns, name, host(a)[rows])
        return ns
    return dataclasses.replace(
        enc, **{f.name: host(getattr(enc, f.name))[rows] for f in dataclasses.fields(enc)}
    )


# ---------------- session epochs ----------------


def epoch_fingerprint(p_cols: dict[str, np.ndarray], r_cols: dict[str, np.ndarray], weights,
                      kernel: str, top_k: int, eps: float, max_iters: int) -> str:
    """Identity of a session epoch: the full snapshot content and every
    solve parameter. ``top_k`` is normalised as the servicer's dispatch
    normalises it (0 means the default 64), and the weights and eps are
    hashed at wire precision (f32), so a client and a server that decoded
    the same request agree."""
    top_k = max(int(top_k) or 64, 1)
    h = hashlib.sha1()
    for spec, cols in ((P_WIRE_DTYPES, p_cols), (R_WIRE_DTYPES, r_cols)):
        for name in spec:
            a = cols[name]
            h.update(name.encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
    params = np.array([weights.price, weights.load, weights.proximity, weights.priority, eps],
                      np.float32)
    h.update(params.tobytes())
    h.update(f"{kernel}:{int(top_k)}:{int(max_iters)}".encode())
    return h.hexdigest()


def dirty_rows(new: dict[str, np.ndarray], old: dict[str, np.ndarray]) -> np.ndarray:
    """Row indices whose value changed in any column (trailing axes
    collapsed): the client's churn detector for AssignDelta ticks."""
    names = list(new)
    n = new[names[0]].shape[0]
    dirty = np.zeros(n, bool)
    for name in names:
        diff = new[name] != old[name]
        dirty |= diff.reshape(n, -1).any(axis=1)
    return np.flatnonzero(dirty).astype(np.int32)


def take_rows(cols: dict[str, np.ndarray], rows: np.ndarray) -> object:
    """A duck-typed encoded view holding only the given rows (for packing a
    delta batch through ``encode_*_v2``)."""
    ns = type("_Rows", (), {})()
    for name, arr in cols.items():
        setattr(ns, name, arr[rows])
    return ns


# ---------------- streaming snapshots ----------------

DEFAULT_CHUNK_BYTES = 1 << 20


def chunk_snapshot(session_id: str, fingerprint: str, request: pb.AssignRequestV2,
                   chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                   use_gzip: bool = True) -> Iterator[pb.SnapshotChunk]:
    """A full-snapshot request as bounded SnapshotChunk frames, the first
    carrying the header; gzip (level 1) where it makes the payload
    smaller."""
    payload = request.SerializeToString()
    codec = ""
    if use_gzip:
        gz = _gzip.compress(payload, compresslevel=1)
        if len(gz) < len(payload):
            payload, codec = gz, "gzip"
    total = len(payload)
    first = True
    for off in range(0, max(total, 1), chunk_bytes):
        part = payload[off:off + chunk_bytes]
        if first:
            yield pb.SnapshotChunk(session_id=session_id, epoch_fingerprint=fingerprint,
                                   payload=part, codec=codec, total_bytes=total)
            first = False
        else:
            yield pb.SnapshotChunk(payload=part)


# the reassembled (and decompressed) snapshot has the unary paths' bound,
# the channel's 1 GiB message cap
MAX_SNAPSHOT_BYTES = 1 << 30


def assemble_snapshot(chunks: Iterable[pb.SnapshotChunk], max_bytes: int = MAX_SNAPSHOT_BYTES
                      ) -> tuple[str, str, pb.AssignRequestV2, int]:
    """The servicer's inverse of :func:`chunk_snapshot`: (session_id,
    claimed fingerprint, parsed request, wire bytes received).
    ``max_bytes`` bounds both the stream and the decompressed payload
    (ValueError past it)."""
    session_id = fingerprint = codec = None
    total = 0
    received = 0
    parts: list[bytes] = []
    for ch in chunks:
        if session_id is None:
            session_id = ch.session_id
            fingerprint = ch.epoch_fingerprint
            codec = ch.codec
            total = int(ch.total_bytes)
            if total > max_bytes:
                raise ValueError(f"snapshot stream declares {total} bytes (cap {max_bytes})")
        received += len(ch.payload)
        if received > max_bytes:
            raise ValueError(f"snapshot stream exceeds {max_bytes} bytes")
        parts.append(ch.payload)
    if session_id is None:
        raise ValueError("empty snapshot stream")
    payload = b"".join(parts)
    if total and len(payload) != total:
        raise ValueError(f"snapshot stream truncated: {len(payload)}/{total} bytes")
    if codec == "gzip":
        d = zlib.decompressobj(16 + zlib.MAX_WBITS)
        out = d.decompress(payload, max_bytes + 1)
        if len(out) > max_bytes:
            raise ValueError(f"decompressed snapshot exceeds {max_bytes} bytes")
        payload = out + d.flush()
    elif codec:
        raise ValueError(f"unknown snapshot codec {codec!r}")
    req = pb.AssignRequestV2()
    req.ParseFromString(payload)
    return session_id, fingerprint, req, received
