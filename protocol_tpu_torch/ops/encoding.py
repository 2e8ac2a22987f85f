"""Encoded feature columns and the vectorized capability mask
(``protocol_tpu/ops/encoding.py:45-100, 324-391``).

The columns are plain dataclasses of tensors with the reference's field
names. ``FeatureEncoder`` (the host-side interning of GPU model strings)
is not ported yet: the port takes the reference's encoded arrays across
as numpy dicts (:func:`providers_from_numpy` /
:func:`requirements_from_numpy`), coerced to the arena's canonical
dtypes (``native/arena.py::_P_SPEC`` / ``_R_SPEC``): bool columns are
uint8, the model-class bitmask uint32.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Mapping

import numpy as np
import torch

from protocol_tpu_torch.device import resolve_device
from protocol_tpu_torch.native.arena import _P_SPEC, _R_SPEC


@dataclass
class EncodedProviders:
    """Fixed-width provider features, shape [P] each. -1 = absent."""

    gpu_count: torch.Tensor  # i32
    gpu_mem_mb: torch.Tensor  # i32, per card
    gpu_model_id: torch.Tensor  # i32, index into the model vocabulary; -1 = none
    has_gpu: torch.Tensor  # u8 (bool)
    has_cpu: torch.Tensor  # u8, node reports a CPU spec at all
    cpu_cores: torch.Tensor  # i32
    ram_mb: torch.Tensor  # i32
    storage_gb: torch.Tensor  # i32
    lat: torch.Tensor  # f32, radians
    lon: torch.Tensor  # f32, radians
    has_location: torch.Tensor  # u8 (an explicit flag: (0,0) is a valid coord)
    price: torch.Tensor  # f32, arbitrary cost units
    load: torch.Tensor  # f32, 0..1 current utilization
    valid: torch.Tensor  # u8, padding rows are 0

    @property
    def num(self) -> int:
        return int(self.gpu_count.shape[0])


@dataclass
class EncodedRequirements:
    """Fixed-width requirement features. Scalars are [T]; GPU OR-options are
    [T, K]; the model-class bitmask is [T, K, W] uint32."""

    cpu_required: torch.Tensor  # u8 [T], requirement carries a CPU block at all
    cpu_cores: torch.Tensor  # i32 [T], -1 = unconstrained
    ram_mb: torch.Tensor  # i32 [T]
    storage_gb: torch.Tensor  # i32 [T]
    gpu_opt_valid: torch.Tensor  # u8 [T, K]
    gpu_count: torch.Tensor  # i32 [T, K], -1 = unconstrained
    gpu_mem_min: torch.Tensor  # i32 [T, K]  (covers memory_mb and memory_mb_min)
    gpu_mem_max: torch.Tensor  # i32 [T, K]
    gpu_total_mem_min: torch.Tensor  # i32 [T, K]
    gpu_total_mem_max: torch.Tensor  # i32 [T, K]
    gpu_model_mask: torch.Tensor  # u32 [T, K, W]; all-ones = unconstrained
    gpu_model_constrained: torch.Tensor  # u8 [T, K]
    lat: torch.Tensor  # f32 [T], radians (task origin; 0 if none)
    lon: torch.Tensor  # f32 [T]
    has_location: torch.Tensor  # u8 [T]
    priority: torch.Tensor  # f32 [T] (newest-first ordering weight)
    valid: torch.Tensor  # u8 [T], padding rows are 0

    @property
    def num(self) -> int:
        return int(self.cpu_cores.shape[0])

    @property
    def max_gpu_options(self) -> int:
        return int(self.gpu_opt_valid.shape[1])


def _columns(arrays: Mapping, spec, device) -> dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {
        name: torch.tensor(np.asarray(arrays[name], dtype), device=dev)
        for name, dtype in spec
    }


def providers_from_numpy(arrays: Mapping, device="cuda") -> EncodedProviders:
    """Port-side providers from the reference's encoded arrays (a mapping
    or any object with the field names, numpy- or jax-backed), coerced to
    the ``_P_SPEC`` dtypes and placed on ``device``."""
    if not isinstance(arrays, Mapping):
        arrays = {name: getattr(arrays, name) for name, _ in _P_SPEC}
    return EncodedProviders(**_columns(arrays, _P_SPEC, device))


def requirements_from_numpy(arrays: Mapping, device="cuda") -> EncodedRequirements:
    """Port-side requirements from the reference's encoded arrays, coerced
    to the ``_R_SPEC`` dtypes and placed on ``device``."""
    if not isinstance(arrays, Mapping):
        arrays = {name: getattr(arrays, name) for name, _ in _R_SPEC}
    return EncodedRequirements(**_columns(arrays, _R_SPEC, device))


def slice_requirements(r: EncodedRequirements, start: int, size: int) -> EncodedRequirements:
    """Tile of the requirement columns along the task axis (views)."""
    return EncodedRequirements(
        **{f.name: getattr(r, f.name)[start:start + size] for f in fields(r)}
    )


def _ge_min(spec: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """'spec >= req' with Option semantics: no constraint passes; constraint
    on an absent spec fails (node.rs `is_none_or(|s| s < req)`)."""
    return (req < 0) | ((spec >= 0) & (spec >= req))


def _le_max(spec: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    return (req < 0) | ((spec >= 0) & (spec <= req))


def compat_mask(p: EncodedProviders, r: EncodedRequirements) -> torch.Tensor:
    """Vectorized ``ComputeSpecs.meets()``: bool [P, T]. The same rules,
    in the same order, as the reference's ``compat_mask``."""
    has_cpu = p.has_cpu.bool()
    has_gpu = p.has_gpu.bool()
    ok = ~r.cpu_required.bool()[None, :] | (
        has_cpu[:, None] & _ge_min(p.cpu_cores[:, None], r.cpu_cores[None, :])
    )
    ok &= _ge_min(p.ram_mb[:, None], r.ram_mb[None, :])
    ok &= _ge_min(p.storage_gb[:, None], r.storage_gb[None, :])

    # GPU OR alternatives: [P,1,1] vs [1,T,K] -> [P,T,K]
    pc = p.gpu_count[:, None, None]
    pm = p.gpu_mem_mb[:, None, None]
    rc = r.gpu_count[None, :, :]
    # exact count: None spec passes only req_count==0 (node.rs:445-459)
    count_ok = (rc < 0) | torch.where(pc < 0, rc == 0, pc == rc)
    mem_ok = _ge_min(pm, r.gpu_mem_min[None, :, :]) & _le_max(pm, r.gpu_mem_max[None, :, :])
    # total memory binds only when the provider reports count AND memory
    # (i32 product, wrapping as the reference's does)
    total = pc * pm
    have_total = (pc >= 0) & (pm >= 0)
    tmin = r.gpu_total_mem_min[None, :, :]
    tmax = r.gpu_total_mem_max[None, :, :]
    tot_ok = ((tmin < 0) | ~have_total | (total >= tmin)) & (
        (tmax < 0) | ~have_total | (total <= tmax)
    )

    # model bitmask: provider class id c sits at (word c>>5, bit c&31),
    # which is position c of the mask's bits laid out word by word; the
    # bits are unpacked per requirement ([T, K, W*32]) and gathered by
    # class id. uint32 words are read as int64 (torch has no uint32
    # shift on the CPU).
    mid = torch.clamp(p.gpu_model_id, min=0).long()  # [P]
    mask64 = r.gpu_model_mask.to(torch.int64)  # [T, K, W]
    shifts = torch.arange(32, dtype=torch.int64, device=mask64.device)
    bits = ((mask64[..., None] >> shifts) & 1).bool()  # [T, K, W, 32]
    bits = bits.reshape(bits.shape[0], bits.shape[1], -1)  # [T, K, W*32]
    model_hit = bits[:, :, mid].permute(2, 0, 1)  # [P, T, K]
    has_model = (p.gpu_model_id >= 0)[:, None, None]
    model_ok = ~r.gpu_model_constrained.bool()[None, :, :] | (has_model & model_hit)

    opt_ok = count_ok & mem_ok & tot_ok & model_ok
    opt_ok &= r.gpu_opt_valid.bool()[None, :, :]

    any_opt = r.gpu_opt_valid.bool().any(dim=1)  # [T]
    gpu_ok = torch.where(
        any_opt[None, :], has_gpu[:, None] & opt_ok.any(dim=2), True
    )
    ok &= gpu_ok
    ok &= p.valid.bool()[:, None] & r.valid.bool()[None, :]
    return ok


def _take(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    # CUDA has no uint32 gather: move the bits through int32
    if col.dtype == torch.uint32:
        return col.view(torch.int32)[idx].view(torch.uint32)
    return col[idx]


def gather_providers(p: EncodedProviders, idx: torch.Tensor) -> EncodedProviders:
    """The provider rows ``idx`` (global ids, any order), as new columns."""
    return EncodedProviders(**{f.name: _take(getattr(p, f.name), idx) for f in fields(p)})


def gather_requirements(r: EncodedRequirements, idx: torch.Tensor) -> EncodedRequirements:
    """The requirement rows ``idx`` (global ids, any order), as new columns."""
    return EncodedRequirements(**{f.name: _take(getattr(r, f.name), idx) for f in fields(r)})
