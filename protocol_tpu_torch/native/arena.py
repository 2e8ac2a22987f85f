"""Canonical column dtypes of the solve arenas and the row-wise dirty
test, copied from ``protocol_tpu/native/arena.py:54-105`` so the port
imports nothing of the reference package."""

from __future__ import annotations

import numpy as np

# canonical dtypes per encoded field (comparing cached vs incoming
# columns is exact under these coercions)
_P_SPEC = (
    ("gpu_count", np.int32), ("gpu_mem_mb", np.int32),
    ("gpu_model_id", np.int32), ("has_gpu", np.uint8),
    ("has_cpu", np.uint8), ("cpu_cores", np.int32), ("ram_mb", np.int32),
    ("storage_gb", np.int32), ("lat", np.float32), ("lon", np.float32),
    ("has_location", np.uint8), ("price", np.float32), ("load", np.float32),
    ("valid", np.uint8),
)
_R_SPEC = (
    ("cpu_required", np.uint8), ("cpu_cores", np.int32), ("ram_mb", np.int32),
    ("storage_gb", np.int32), ("gpu_opt_valid", np.uint8),
    ("gpu_count", np.int32), ("gpu_mem_min", np.int32),
    ("gpu_mem_max", np.int32), ("gpu_total_mem_min", np.int32),
    ("gpu_total_mem_max", np.int32), ("gpu_model_mask", np.uint32),
    ("gpu_model_constrained", np.uint8), ("lat", np.float32),
    ("lon", np.float32), ("has_location", np.uint8),
    ("priority", np.float32), ("valid", np.uint8),
)


def _host(a) -> np.ndarray:
    """numpy view of a column: tensors (on any device) come to the host."""
    if hasattr(a, "detach") and hasattr(a, "cpu"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _canon(enc, spec) -> dict[str, np.ndarray]:
    return {
        name: np.ascontiguousarray(_host(getattr(enc, name)), dtype)
        for name, dtype in spec
    }


def _dirty_rows(new: dict, old: dict, spec) -> np.ndarray:
    """Row-wise OR of per-field inequality (trailing axes collapsed)."""
    n = new[spec[0][0]].shape[0]
    dirty = np.zeros(n, bool)
    for name, _ in spec:
        diff = new[name] != old[name]
        dirty |= diff.reshape(n, -1).any(axis=1)
    return dirty
