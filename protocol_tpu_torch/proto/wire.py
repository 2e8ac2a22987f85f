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

The session helpers (epoch fingerprints, dirty rows, snapshot chunks) are
not here yet: they come with the sessions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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


def strip_padding(enc):
    """Drop pow2-padding rows (the valid=False tail) before the wire:
    padded rows would be real entities to the backend and dead weight on
    the wire. Returns the same dataclass with numpy columns."""
    n = int(host(enc.valid).sum())
    return dataclasses.replace(
        enc, **{f.name: host(getattr(enc, f.name))[:n] for f in dataclasses.fields(enc)}
    )
