"""Provider x task cost (``protocol_tpu/ops/cost.py``).

  cost[p, t] = w_price * price[p] + w_load * load[p]
             + w_proximity * haversine(provider, task origin)  (0 if either
                                                                side has no
                                                                location)
             - w_priority * priority[t]
             + INFEASIBLE where !compat_mask[p, t]

Every term is f32 and is evaluated in the reference's order, one rounding
per operation, so the integer and order-only parts of the pipeline are
bit-identical to the reference; the haversine's transcendentals differ by
a few ulps between libraries.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from protocol_tpu_torch.ops.encoding import (
    EncodedProviders,
    EncodedRequirements,
    compat_mask,
    gather_providers,
    slice_requirements,
)

# large-but-finite infeasibility penalty (exact in f32)
INFEASIBLE = 1e9

EARTH_RADIUS_KM = 6371.0

# tie-jitter hash constants (uint32 multiplies that wrap around)
_JITTER_P = 2654435761
_JITTER_T = 40503


@dataclass
class CostWeights:
    price: float = 1.0
    load: float = 1.0
    proximity: float = 0.001  # per km
    priority: float = 0.0


def haversine_km(
    lat1: torch.Tensor, lon1: torch.Tensor, lat2: torch.Tensor, lon2: torch.Tensor
) -> torch.Tensor:
    """Great-circle distance in km; inputs in radians, broadcastable shapes."""
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    a = torch.sin(dlat / 2) ** 2 + torch.cos(lat1) * torch.cos(lat2) * torch.sin(dlon / 2) ** 2
    # clip for numerical safety at antipodes
    return 2.0 * EARTH_RADIUS_KM * torch.asin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


def _jitter_hash(p_idx: torch.Tensor, t_idx: torch.Tensor) -> torch.Tensor:
    """((p*2654435761) ^ (t*40503)) & 1023 * 1e-7 in f32, with the uint32
    products wrapping: computed in int64, whose low 32 bits are the
    uint32 results."""
    h = (p_idx * _JITTER_P) ^ (t_idx * _JITTER_T)
    return (h & 1023).to(torch.float32) * 1e-7


def tie_jitter(
    num_providers: int,
    num_tasks: int,
    provider_offset: int = 0,
    task_offset: int = 0,
    device=None,
) -> torch.Tensor:
    """Deterministic hash(p, t) epsilon grid [P, T] in [0, ~1e-4): breaks
    the exact ties of identically-priced providers while preserving any
    real cost gap > 1e-4."""
    p_idx = (provider_offset + torch.arange(num_providers, dtype=torch.int64, device=device)) & 0xFFFFFFFF
    t_idx = (task_offset + torch.arange(num_tasks, dtype=torch.int64, device=device)) & 0xFFFFFFFF
    return _jitter_hash(p_idx[:, None], t_idx[None, :])


def tie_jitter_ids(p_ids: torch.Tensor, t_ids: torch.Tensor) -> torch.Tensor:
    """:func:`tie_jitter` for gathered index sets, keyed on explicit
    global ids: [len(p_ids), len(t_ids)]."""
    p_idx = p_ids.to(torch.int64) & 0xFFFFFFFF
    t_idx = t_ids.to(torch.int64) & 0xFFFFFFFF
    return _jitter_hash(p_idx[:, None], t_idx[None, :])


def with_tie_jitter(cost: torch.Tensor) -> torch.Tensor:
    """Apply :func:`tie_jitter` to the feasible cells of a dense [P, T]
    cost matrix (``protocol_tpu/ops/cost.py:100``); with
    :func:`cost_matrix` it is the plain version of the dense route's K6."""
    return torch.where(
        cost < INFEASIBLE * 0.5,
        cost + tie_jitter(cost.shape[0], cost.shape[1], device=cost.device),
        cost,
    )


def cost_matrix(
    p: EncodedProviders,
    r: EncodedRequirements,
    weights: CostWeights | None = None,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (cost [P, T] f32, compat [P, T] bool)."""
    if weights is None:
        weights = CostWeights()
    if mask is None:
        mask = compat_mask(p, r)

    base = weights.price * p.price + weights.load * p.load  # [P]
    cost = base[:, None].expand(mask.shape).to(torch.float32)

    dist = haversine_km(p.lat[:, None], p.lon[:, None], r.lat[None, :], r.lon[None, :])
    has_loc = p.has_location.bool()[:, None] & r.has_location.bool()[None, :]
    cost = cost + torch.where(has_loc, weights.proximity * dist, 0.0)
    cost = cost - weights.priority * r.priority[None, :]
    cost = torch.where(mask, cost, INFEASIBLE)
    return cost, mask


# tasks a chunk of the plain cost_pairs scores at once ([C, C] cells)
_PAIR_CHUNK = 512


def _cost_pairs_plain(p: EncodedProviders, r: EncodedRequirements, p4t: torch.Tensor,
                      weights: CostWeights) -> torch.Tensor:
    """Plain torch version of K15: the reference's gather of the chosen
    provider rows (at max(p4t, 0)) and :func:`cost_matrix` of each pair,
    a chunk of tasks at a time as the diagonal of the chunk's [C, C]
    block; INFEASIBLE where p4t < 0."""
    T = p4t.shape[0]
    parts = []
    for lo in range(0, T, _PAIR_CHUNK):
        n = min(_PAIR_CHUNK, T - lo)
        rows = gather_providers(p, torch.clamp(p4t[lo:lo + n], min=0).long())
        parts.append(torch.diagonal(cost_matrix(rows, slice_requirements(r, lo, n), weights)[0]))
    cost = torch.cat(parts) if parts else torch.empty(0, dtype=torch.float32, device=p4t.device)
    return torch.where(p4t >= 0, cost, INFEASIBLE)


def cost_pairs(
    p: EncodedProviders,
    r: EncodedRequirements,
    provider_for_task,
    weights: CostWeights | None = None,
) -> torch.Tensor:
    """Per-pair cost of an assignment (``protocol_tpu/ops/cost.py:149``):
    [T] f32, INFEASIBLE where the task is unassigned or the pair is
    incompatible; O(T) cells, so assignment quality is measurable at
    shapes where [P, T] cannot exist. On a CUDA tensor this is K15
    (``csrc/blocked.cu``), else :func:`_cost_pairs_plain`."""
    from protocol_tpu_torch import kernels

    if weights is None:
        weights = CostWeights()
    p4t = torch.as_tensor(provider_for_task, device=p.gpu_count.device).to(torch.int32)
    if p4t.is_cuda:
        return kernels.pair_cost(p, r, weights, p4t)
    return _cost_pairs_plain(p, r, p4t, weights)
