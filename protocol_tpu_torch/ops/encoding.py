"""Encoded feature columns, the host-side encoder and the vectorized
capability mask (``protocol_tpu/ops/encoding.py``).

The columns are plain dataclasses of tensors with the reference's field
names, in the arena's canonical dtypes (``native/arena.py::_P_SPEC`` /
``_R_SPEC``): bool columns are uint8, the model-class bitmask uint32.
:class:`FeatureEncoder` (the reference's :103-320) interns GPU model
strings and encodes specs and requirements in numpy on the host, with the
reference's arrays, padding included; :func:`providers_from_numpy` /
:func:`requirements_from_numpy` place such arrays (or the reference's
encoded arrays) on a device.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from protocol_tpu_torch.device import resolve_device
from protocol_tpu_torch.models.node import (
    ComputeRequirements,
    ComputeSpecs,
    NodeLocation,
    _models_fuzzy_match,
)
from protocol_tpu_torch.native.arena import _P_SPEC, _R_SPEC

# Number of padded GPU OR-alternatives per requirement set. The reference DSL
# rarely exceeds 2-3 alternatives; overflowing options raise at encode time.
DEFAULT_MAX_GPU_OPTIONS = 4


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


class FeatureEncoder:
    """Host-side interning + batch encoding (``protocol_tpu/ops/encoding.py:
    103-320``).

    The encoder owns the GPU-model vocabulary. It is incremental: new model
    strings get fresh class ids, and requirement bitmasks are resolved against
    the vocabulary *at encode time* (so encode requirements after the
    providers they will be matched with, or re-encode on vocab growth —
    ``vocab_version`` tracks this).

    ``provider_arrays`` / ``requirement_arrays`` return the reference's
    numpy arrays by field name; ``encode_providers`` /
    ``encode_requirements`` place them on ``device`` as port columns.
    """

    def __init__(self, model_words: int = 8, max_gpu_options: int = DEFAULT_MAX_GPU_OPTIONS):
        # W words of 32 bits each => capacity model_words*32 distinct models
        self._vocab: dict[str, int] = {}
        self._vocab_list: list[str] = []
        self.model_words = model_words
        self.max_gpu_options = max_gpu_options
        self.vocab_version = 0

    # ---------------- vocabulary ----------------

    def intern_model(self, model: Optional[str]) -> int:
        if model is None:
            return -1
        key = model.strip()
        mid = self._vocab.get(key)
        if mid is None:
            mid = len(self._vocab_list)
            if mid >= self.model_words * 32:
                raise ValueError(
                    f"GPU model vocabulary overflow (> {self.model_words * 32}); "
                    "construct the FeatureEncoder with more model_words"
                )
            self._vocab[key] = mid
            self._vocab_list.append(key)
            self.vocab_version += 1
        return mid

    def _model_csv_to_mask(self, csv: Optional[str]) -> tuple[np.ndarray, bool]:
        """Resolve a requirement's model CSV into a bitmask over vocab classes
        using the reference's fuzzy-match rule. Returns (mask[W] u32,
        constrained)."""
        mask = np.zeros(self.model_words, dtype=np.uint32)
        if csv is None:
            return mask, False
        for mid, spec_model in enumerate(self._vocab_list):
            if _models_fuzzy_match(spec_model, csv):
                mask[mid >> 5] |= np.uint32(1) << np.uint32(mid & 31)
        return mask, True

    # ---------------- providers ----------------

    def provider_arrays(
        self,
        specs: Sequence[Optional[ComputeSpecs]],
        locations: Optional[Sequence[Optional[NodeLocation]]] = None,
        prices: Optional[Sequence[float]] = None,
        loads: Optional[Sequence[float]] = None,
        pad_to: Optional[int] = None,
    ) -> dict[str, np.ndarray]:
        n = len(specs)
        p = pad_to if pad_to is not None else n
        if p < n:
            raise ValueError("pad_to smaller than provider count")

        gpu_count = np.full(p, -1, np.int32)
        gpu_mem = np.full(p, -1, np.int32)
        gpu_model = np.full(p, -1, np.int32)
        has_gpu = np.zeros(p, bool)
        has_cpu = np.zeros(p, bool)
        cpu_cores = np.full(p, -1, np.int32)
        ram = np.full(p, -1, np.int32)
        storage = np.full(p, -1, np.int32)
        lat = np.zeros(p, np.float32)
        lon = np.zeros(p, np.float32)
        has_loc = np.zeros(p, bool)
        price = np.zeros(p, np.float32)
        load = np.zeros(p, np.float32)
        valid = np.zeros(p, bool)

        for i, s in enumerate(specs):
            valid[i] = True
            if s is None:
                continue
            if s.gpu is not None:
                has_gpu[i] = True
                if s.gpu.count is not None:
                    gpu_count[i] = s.gpu.count
                if s.gpu.memory_mb is not None:
                    gpu_mem[i] = s.gpu.memory_mb
                gpu_model[i] = self.intern_model(s.gpu.model)
            if s.cpu is not None:
                has_cpu[i] = True
                if s.cpu.cores is not None:
                    cpu_cores[i] = s.cpu.cores
            if s.ram_mb is not None:
                ram[i] = s.ram_mb
            if s.storage_gb is not None:
                storage[i] = s.storage_gb
        if locations is not None:
            for i, lc in enumerate(locations):
                if lc is not None:
                    lat[i] = np.radians(lc.latitude)
                    lon[i] = np.radians(lc.longitude)
                    has_loc[i] = True
        if prices is not None:
            price[: len(prices)] = np.asarray(prices, np.float32)
        if loads is not None:
            load[: len(loads)] = np.asarray(loads, np.float32)

        return dict(
            gpu_count=gpu_count, gpu_mem_mb=gpu_mem, gpu_model_id=gpu_model,
            has_gpu=has_gpu, has_cpu=has_cpu, cpu_cores=cpu_cores, ram_mb=ram,
            storage_gb=storage, lat=lat, lon=lon, has_location=has_loc,
            price=price, load=load, valid=valid,
        )

    def encode_providers(self, specs, locations=None, prices=None, loads=None,
                         pad_to=None, device="cuda") -> EncodedProviders:
        return providers_from_numpy(
            self.provider_arrays(specs, locations, prices, loads, pad_to), device
        )

    # ---------------- requirements ----------------

    def requirement_arrays(
        self,
        reqs: Sequence[ComputeRequirements],
        locations: Optional[Sequence[Optional[NodeLocation]]] = None,
        priorities: Optional[Sequence[float]] = None,
        pad_to: Optional[int] = None,
    ) -> dict[str, np.ndarray]:
        n = len(reqs)
        t = pad_to if pad_to is not None else n
        if t < n:
            raise ValueError("pad_to smaller than requirement count")
        k, w = self.max_gpu_options, self.model_words

        cpu_required = np.zeros(t, bool)
        cpu_cores = np.full(t, -1, np.int32)
        ram = np.full(t, -1, np.int32)
        storage = np.full(t, -1, np.int32)
        opt_valid = np.zeros((t, k), bool)
        gcount = np.full((t, k), -1, np.int32)
        gmem_min = np.full((t, k), -1, np.int32)
        gmem_max = np.full((t, k), -1, np.int32)
        gtot_min = np.full((t, k), -1, np.int32)
        gtot_max = np.full((t, k), -1, np.int32)
        gmask = np.zeros((t, k, w), np.uint32)
        gconstrained = np.zeros((t, k), bool)
        lat = np.zeros(t, np.float32)
        lon = np.zeros(t, np.float32)
        has_loc = np.zeros(t, bool)
        prio = np.zeros(t, np.float32)
        valid = np.zeros(t, bool)

        for i, r in enumerate(reqs):
            valid[i] = True
            if r.cpu is not None:
                cpu_required[i] = True
                if r.cpu.cores is not None:
                    cpu_cores[i] = r.cpu.cores
            if r.ram_mb is not None:
                ram[i] = r.ram_mb
            if r.storage_gb is not None:
                storage[i] = r.storage_gb
            if len(r.gpu) > k:
                raise ValueError(
                    f"requirement has {len(r.gpu)} GPU alternatives > max {k}"
                )
            for j, g in enumerate(r.gpu):
                opt_valid[i, j] = True
                if g.count is not None:
                    gcount[i, j] = g.count
                # memory_mb is itself a lower bound (node.rs:480-500); when a
                # dict-deserialized requirement carries both (the DSL parser
                # rejects the combination but the wire path does not), the
                # effective bound is the stricter of the two.
                bounds = [b for b in (g.memory_mb, g.memory_mb_min) if b is not None]
                if bounds:
                    gmem_min[i, j] = max(bounds)
                if g.memory_mb_max is not None:
                    gmem_max[i, j] = g.memory_mb_max
                if g.total_memory_min is not None:
                    gtot_min[i, j] = g.total_memory_min
                if g.total_memory_max is not None:
                    gtot_max[i, j] = g.total_memory_max
                gmask[i, j], gconstrained[i, j] = self._model_csv_to_mask(g.model)
        if locations is not None:
            for i, lc in enumerate(locations):
                if lc is not None:
                    lat[i] = np.radians(lc.latitude)
                    lon[i] = np.radians(lc.longitude)
                    has_loc[i] = True
        if priorities is not None:
            prio[: len(priorities)] = np.asarray(priorities, np.float32)

        return dict(
            cpu_required=cpu_required, cpu_cores=cpu_cores, ram_mb=ram,
            storage_gb=storage, gpu_opt_valid=opt_valid, gpu_count=gcount,
            gpu_mem_min=gmem_min, gpu_mem_max=gmem_max,
            gpu_total_mem_min=gtot_min, gpu_total_mem_max=gtot_max,
            gpu_model_mask=gmask, gpu_model_constrained=gconstrained,
            lat=lat, lon=lon, has_location=has_loc, priority=prio, valid=valid,
        )

    def encode_requirements(self, reqs, locations=None, priorities=None, pad_to=None,
                            device="cuda") -> EncodedRequirements:
        return requirements_from_numpy(
            self.requirement_arrays(reqs, locations, priorities, pad_to), device
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
