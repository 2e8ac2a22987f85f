"""Multi-resource vector bin-pack with anti-affinity
(``protocol_tpu/ops/binpack.py``).

Providers expose a capacity vector [P, R] and tasks a demand vector
[T, R]; several tasks may land on one provider while its capacity holds.
Anti-affinity is a set of exclusion groups over placement domains:
``anti_group[t]`` (-1 = none) names a group whose members must land on
distinct domains, and ``loc_id[p]`` maps providers to domains (the
default ``arange(P)`` makes every provider its own domain).

First-fit-decreasing: the tasks go in ``task_order`` (default: L1 demand
descending, stable), and each takes the cheapest provider that is
compatible (finite cost), still has capacity >= its demand in every
resource and does not break its group on the provider's domain; ties go
to the lowest provider index. On a CUDA tensor :func:`assign_binpack_ffd`
is kernel K11 (``csrc/binpack.cu``, the instantiation
``kernels.binpack_route`` picks from the shapes); on a CPU tensor it is
:func:`_binpack_plain`, a loop over the steps of the reference's
``lax.scan``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from protocol_tpu_torch.ops.cost import INFEASIBLE


@dataclass
class BinpackResult:
    provider_for_task: torch.Tensor  # i32 [T], -1 = unassigned
    remaining_capacity: torch.Tensor  # f32 [P, R]
    route: str = "plain"  # K11's instantiation on a card ("shared" / "device")


def _l1_demand(demand: torch.Tensor) -> torch.Tensor:
    """Each row's f32 sum over the resources, left to right."""
    total = demand[:, 0].to(torch.float32).clone()
    for j in range(1, demand.shape[1]):
        total = total + demand[:, j]
    return total


def ffd_demand_order(demand: torch.Tensor) -> torch.Tensor:
    """Classic FFD visit order: largest total demand first (L1 over the
    resource axis), the lower index first among equal totals. i32 [T]."""
    return torch.sort(-_l1_demand(demand), stable=True).indices.to(torch.int32)


def _binpack_plain(cost, demand, capacity, task_order, anti_group, loc_id, L: int, G: int):
    """K11's plain version: the reference's scan, one step per task in
    visit order, then the scatter back to task order."""
    P, T = cost.shape
    dev = cost.device
    cols = cost.T[task_order.long()]  # [T, P] in visit order
    dem = demand.to(torch.float32)[task_order.long()]
    grp = anti_group[task_order.long()]
    loc = loc_id.long()
    cap = capacity.to(torch.float32).clone()
    used = torch.zeros((L, G), dtype=torch.bool, device=dev)
    picks = torch.empty(T, dtype=torch.int32, device=dev)
    for i in range(T):
        d, g = dem[i], grp[i]
        g_safe = torch.clamp(g, min=0).long()
        fits = (cap >= d[None, :]).all(dim=1)
        excluded = (g >= 0) & used[loc, g_safe]
        masked = torch.where(fits & ~excluded, cols[i], INFEASIBLE)
        p = torch.argmin(masked)  # the first minimum
        feasible = masked[p] < INFEASIBLE * 0.5
        cap[p] += -torch.where(feasible, d, torch.zeros_like(d))
        used[loc[p], g_safe] |= feasible & (g >= 0)
        picks[i] = torch.where(feasible, p.to(torch.int32), -1)
    out = torch.full((T,), -1, dtype=torch.int32, device=dev)
    out[task_order.long()] = picks
    return out, cap


def assign_binpack_ffd(
    cost: torch.Tensor,  # f32 [P, T]; INFEASIBLE marks incompatibility
    demand: torch.Tensor,  # f32 [T, R]
    capacity: torch.Tensor,  # f32 [P, R]
    task_order: torch.Tensor | None = None,  # i32 [T]
    anti_group: torch.Tensor | None = None,  # i32 [T], -1 = unconstrained
    loc_id: torch.Tensor | None = None,  # i32 [P] -> [0, num_locations)
    num_locations: int = 0,  # 0 = one domain per provider
    num_groups: int = 0,  # 0 = no anti-affinity tracking
) -> BinpackResult:
    """First-fit-decreasing vector bin-pack (the reference's
    ``assign_binpack_ffd``, same arguments). On a card the cost may be a
    transposed view of a slot-major [T, P] block (as ``cost_only``
    returns one): K11 reads that block without a copy, and ranks the
    default FFD order itself."""
    P, T = cost.shape
    dev = cost.device
    if anti_group is None:
        anti_group = torch.full((T,), -1, dtype=torch.int32, device=dev)
    if loc_id is None:
        loc_id = torch.arange(P, dtype=torch.int32, device=dev)
    L = num_locations or P
    G = max(num_groups, 1)
    if cost.is_cuda:
        from protocol_tpu_torch import kernels

        route = kernels.binpack_route(P, demand.shape[1], L, G)
        return BinpackResult(*kernels.binpack_ffd(
            cost.T, demand, capacity, task_order, anti_group, loc_id, L, G, route=route), route)
    if task_order is None:
        task_order = ffd_demand_order(demand)
    return BinpackResult(*_binpack_plain(cost, demand, capacity, task_order, anti_group,
                                         loc_id, L, G))


def binpack_oracle(cost, demand, capacity, task_order=None, anti_group=None, loc_id=None):
    """Host-side reference implementation (numpy, same tie-breaking): the
    reference's parity oracle, copied for the tests."""
    import numpy as np

    cost = np.asarray(cost)
    demand = np.asarray(demand, np.float64)
    cap = np.asarray(capacity, np.float64).copy()
    P, T = cost.shape
    if task_order is None:
        task_order = np.argsort(-demand.sum(axis=1), kind="stable")
    if anti_group is None:
        anti_group = np.full(T, -1, np.int64)
    if loc_id is None:
        loc_id = np.arange(P)
    used: set[tuple[int, int]] = set()
    out = np.full(T, -1, np.int64)
    for t in task_order:
        d = demand[t]
        g = int(anti_group[t])
        best, best_cost = -1, INFEASIBLE
        for p in range(P):
            if cost[p, t] >= INFEASIBLE * 0.5:
                continue
            if not (cap[p] >= d - 1e-9).all():
                continue
            if g >= 0 and (int(loc_id[p]), g) in used:
                continue
            if cost[p, t] < best_cost:
                best, best_cost = p, cost[p, t]
        if best >= 0:
            out[t] = best
            cap[best] -= d
            if g >= 0:
                used.add((int(loc_id[best]), g))
    return out, cap
