"""Dense assignment (``protocol_tpu/ops/assign.py``): the result
container and the Bertsekas auction over a dense [P, T] cost.

Conventions as in the reference: cost f32 [P, T] with INFEASIBLE (1e9)
marking incompatibility; ``provider_for_task`` i32 [T] (-1 = unassigned),
``task_for_provider`` i32 [P] (-1 = idle).

Two functions hold hand kernels for Hopper (``csrc/dense.cu``); each
dispatches on the device of its inputs, with no fallback:

  auction_value_base -> K6: the auction's value rows straight from the
        encoded columns (cost_matrix + with_tie_jitter + value_base), a
        CPU tensor takes the plain torch ops;
  auction_dense      -> K7: every round of :func:`assign_auction` in one
        launch, a CPU tensor takes the plain round loop below.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from protocol_tpu_torch.ops.cost import INFEASIBLE, cost_matrix, with_tie_jitter

# -inf stand-in that survives arithmetic (f32-rounded where it meets f32)
_NEG = -1e18


@dataclass
class AssignResult:
    provider_for_task: torch.Tensor  # i32 [T], -1 = unassigned
    task_for_provider: torch.Tensor  # i32 [P], -1 = idle

    def num_assigned(self) -> torch.Tensor:
        return (self.provider_for_task >= 0).sum()


def _invert(provider_for_task: torch.Tensor, num_providers: int) -> torch.Tensor:
    """task_for_provider from provider_for_task (both injective over >=0)."""
    p4t = provider_for_task
    t_idx = torch.arange(p4t.shape[0], dtype=torch.int32, device=p4t.device)
    out = torch.full((num_providers + 1,), -1, dtype=torch.int32, device=p4t.device)
    safe = torch.where(p4t >= 0, p4t, num_providers).long()
    out[safe] = torch.where(p4t >= 0, t_idx, -1)
    return out[:num_providers]


def _value_base(cost: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(value_base [T, P] = -cost where cost < INFEASIBLE/2, else _NEG;
    task_feasible [T]), as ``assign_auction`` builds them."""
    value_base = torch.where(cost < INFEASIBLE * 0.5, -cost, _NEG).T.contiguous()
    return value_base, (value_base > _NEG * 0.5).any(dim=1)


def auction_value_base(ep, er, weights) -> tuple[torch.Tensor, torch.Tensor]:
    """The dense auction's inputs from the encoded columns: (value_base
    [T, P] f32 over the jittered cost, task_feasible [T] bool). K6 on a
    card; on the CPU, ``cost_matrix`` + ``with_tie_jitter``."""
    if ep.gpu_count.is_cuda:
        from protocol_tpu_torch import kernels

        return kernels.dense_value_base(ep, er, weights)
    cost, _ = cost_matrix(ep, er, weights)
    return _value_base(with_tie_jitter(cost))


def _auction_dense_plain(value_base, task_feasible, eps: float, max_iters: int):
    """K7's plain version: ``assign_auction``'s while_loop, one round per
    iteration. Only open rows bid, so only they are scanned; the bids, the
    winners and the updates are the reference's. Returns (p4t, t4p, price,
    rounds, open rows summed over the rounds)."""
    T, P = value_base.shape
    dev = value_base.device
    price = torch.zeros(P, dtype=torch.float32, device=dev)
    owner = torch.full((P,), -1, dtype=torch.int32, device=dev)
    p4t = torch.full((T,), -1, dtype=torch.int32, device=dev)
    eps32 = torch.tensor(eps, dtype=torch.float32, device=dev)
    cols = torch.arange(P, device=dev)
    it = 0
    open_rows = 0
    while it < max_iters:
        rows = torch.nonzero((p4t < 0) & task_feasible).flatten()
        if rows.numel() == 0:
            break
        open_rows += rows.numel()
        value = value_base[rows] - price[None, :]
        p1 = torch.argmax(value, dim=1)  # first max: lowest p
        v1 = torch.gather(value, 1, p1[:, None])[:, 0]
        v2 = torch.where(cols[None, :] == p1[:, None], _NEG, value).amax(dim=1)
        v2 = torch.clamp(v2, min=-1e8)  # single-option floor: finite bid
        bid = price[p1] + (v1 - v2) + eps32
        # provider-side winner: the highest bid, ties to the lowest task
        win_bid = torch.full((P,), -torch.inf, dtype=torch.float32, device=dev)
        win_bid = win_bid.scatter_reduce(0, p1, bid, "amax")
        top = bid == win_bid[p1]
        win_t = torch.full((P,), T, dtype=torch.int64, device=dev)
        win_t = win_t.scatter_reduce(0, p1[top], rows[top], "amin")
        got = torch.nonzero(win_t < T).flatten()
        prev = owner[got]
        p4t[prev[prev >= 0].long()] = -1  # evict previous owners
        p4t[win_t[got]] = got.to(torch.int32)
        owner[got] = win_t[got].to(torch.int32)
        price[got] = win_bid[got]
        it += 1
    return p4t, _invert(p4t, P), price, torch.tensor(it, device=dev), open_rows


def auction_dense(value_base, task_feasible, eps: float, max_iters: int,
                  work_out: dict | None = None):
    """The dense Jacobi auction from scratch duals over ``value_base``
    [T, P] (see :func:`auction_value_base`). Returns (p4t [T] i32, t4p [P]
    i32, price [P] f32, rounds 0-d); ``work_out["open_rows"]`` receives
    the open rows summed over the rounds. K7 on a card."""
    if value_base.is_cuda:
        from protocol_tpu_torch import kernels

        return kernels.dense_auction(value_base, task_feasible, eps, max_iters, work_out)
    p4t, t4p, price, rounds, open_rows = _auction_dense_plain(
        value_base, task_feasible, eps, max_iters
    )
    if work_out is not None:
        work_out["open_rows"] = torch.tensor(open_rows)
    return p4t, t4p, price, rounds


def assign_auction(cost: torch.Tensor, eps: float = 0.01, max_iters: int = 500) -> AssignResult:
    """Forward auction (``protocol_tpu/ops/assign.py:176``): unassigned
    tasks bid for their best-value provider.

    value[t, p] = -cost[p, t] - price[p]. Each round every unassigned task
    bids price[p1] + (v1 - v2) + eps on its best provider p1; each provider
    takes the highest bid (ties -> lowest task index), evicting the previous
    owner. eps fixed per call. Near-optimal: within n*eps of the optimal
    assignment value. Every round runs on the device (K7 on a card)."""
    value_base, task_feasible = _value_base(cost)
    p4t, t4p, _, _ = auction_dense(value_base, task_feasible, eps, max_iters)
    return AssignResult(p4t, t4p)


def assign_auction_scaled(
    cost: torch.Tensor,
    eps_start: float = 1.0,
    eps_end: float = 0.01,
    scale: float = 0.2,
    max_iters_per_phase: int = 300,
) -> AssignResult:
    """eps-scaling wrapper (``protocol_tpu/ops/assign.py:244``): auction
    phases with geometrically shrinking eps, each from scratch prices,
    over the tie-jittered cost. A host loop over a few phases."""
    cost = with_tie_jitter(cost)
    eps = eps_start
    while True:
        result = assign_auction(cost, eps=eps, max_iters=max_iters_per_phase)
        if eps <= eps_end:
            return result
        eps = max(eps * scale, eps_end)
