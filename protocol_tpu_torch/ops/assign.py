"""Dense assignment (``protocol_tpu/ops/assign.py``): the result
container, the sequential greedy, the log-domain Sinkhorn with its
rounding, and the Bertsekas auction over a dense [P, T] cost.

Conventions as in the reference: cost f32 [P, T] with INFEASIBLE (1e9)
marking incompatibility; ``provider_for_task`` i32 [T] (-1 = unassigned),
``task_for_provider`` i32 [P] (-1 = idle).

Five functions hold hand kernels for Hopper; each dispatches on the
device of its inputs, with no fallback:

  auction_value_base -> K6 (``csrc/candidates.cu``): the auction's value rows
        straight from the encoded columns (cost_matrix + with_tie_jitter +
        value_base), a CPU tensor takes the plain torch ops;
  auction_dense      -> K7 (``csrc/dense.cu``): every round of
        :func:`assign_auction` in one launch over a compacted list of the
        open slots, a CPU tensor takes the plain round loop below;
  assign_greedy      -> K12 (``csrc/greedy.cu``): the whole scan over the
        tasks in one block, producer warps reducing each coming row to a
        short sorted list and one warp taking a step a ballot, a CPU
        tensor takes :func:`_greedy_plain`;
  sinkhorn_plan / assign_sinkhorn -> K13 (``csrc/sinkhorn.cu``): the
        potentials, the plan and the rounding cost, then K12 for the
        rounding; a CPU tensor takes :func:`_sinkhorn_plain`.

The Sinkhorn plan flushes subnormal entries to +0, on both paths: XLA
flushes subnormals (the TPU does too, and so does JAX on the CPU), and
the rounding is a greedy on -plan with first-index ties, so a subnormal
where the reference has 0 can change which provider wins.
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


# --------------------------------------------------------------------------
# Greedy / first-fit-decreasing
# --------------------------------------------------------------------------


def _greedy_plain(cost_tp: torch.Tensor, task_order: torch.Tensor) -> torch.Tensor:
    """K12's plain version: the reference's scan, one step per entry of
    ``task_order`` over the slot-major cost ``cost_tp`` [T, P]. Each task
    takes the first minimum over the still-free providers (-0 counted as
    +0) if it is < INFEASIBLE/2. Returns provider_for_task [T] i32."""
    T, P = cost_tp.shape
    avail = torch.ones(P, dtype=torch.bool, device=cost_tp.device)
    p4t = torch.full((T,), -1, dtype=torch.int32, device=cost_tp.device)
    for t in task_order.tolist():
        masked = torch.where(avail, cost_tp[t], INFEASIBLE) + 0.0  # -0 -> +0
        p = int(torch.argmin(masked))  # first minimum
        if float(masked[p]) < INFEASIBLE * 0.5:
            avail[p] = False
            p4t[t] = p
    return p4t


def assign_greedy(cost: torch.Tensor, task_order: torch.Tensor | None = None) -> AssignResult:
    """Sequential greedy matching (``protocol_tpu/ops/assign.py:70``).

    Visits tasks in ``task_order`` (default: ascending index); each takes
    the cheapest still-available compatible provider, ties to the lowest
    provider index. The scan reads the cost slot-major ([T, P], one row a
    step): ``cost.T`` is used without a copy where it is contiguous, as
    :func:`~protocol_tpu_torch.sched.torch_backend.cost_only` gives it on a
    card. K12 on a CUDA tensor."""
    P, T = cost.shape
    if task_order is None:
        task_order = torch.arange(T, dtype=torch.int32, device=cost.device)
    cost_tp = cost.T.contiguous()  # a view where cost is a transposed block
    if cost.is_cuda:
        from protocol_tpu_torch import kernels

        p4t = kernels.greedy_assign(cost_tp, task_order)
    else:
        p4t = _greedy_plain(cost_tp, task_order)
    return AssignResult(p4t, _invert(p4t, P))


def ffd_order(demand: torch.Tensor) -> torch.Tensor:
    """First-fit-DECREASING visit order (``protocol_tpu/ops/assign.py:99``):
    biggest demand first, stable among equal demands. i32."""
    return torch.sort(-demand, stable=True).indices.to(torch.int32)


# --------------------------------------------------------------------------
# Sinkhorn entropic OT
# --------------------------------------------------------------------------


def _lse(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jax.nn.logsumexp``'s arithmetic: the max (0 where not finite),
    then log(sum(exp(x - max))) + max."""
    amax = x.amax(dim=dim, keepdim=True)
    amax = torch.where(torch.isfinite(amax), amax, 0.0)
    return torch.log(torch.exp(x - amax).sum(dim=dim)) + amax.squeeze(dim)


def _sinkhorn_plain(cost: torch.Tensor, eps: float, num_iters: int):
    """K13's plain version, the reference's ``sinkhorn_plan`` transcribed:
    returns (K [P, T], u [P], v [T]) after ``num_iters`` rounds, each a
    row pass then a column pass of max-then-sum logsumexp."""
    P, T = cost.shape
    dev = cost.device
    feasible = cost < INFEASIBLE * 0.5
    feas_row = feasible.any(dim=1)
    feas_col = feasible.any(dim=0)
    np_valid = torch.clamp(feas_row.sum(), min=1)
    nt_valid = torch.clamp(feas_col.sum(), min=1)
    m = torch.minimum(np_valid, nt_valid).to(torch.float32)
    log_a = torch.where(feas_row, torch.log(m / np_valid.to(torch.float32)), _NEG)
    log_b = torch.where(feas_col, torch.log(m / nt_valid.to(torch.float32)), _NEG)
    # a 0-d tensor on the cost's device: a true f32 division, as the
    # kernel's (a CPU scalar makes CUDA multiply by its reciprocal)
    eps_t = torch.tensor(eps, dtype=torch.float32, device=dev)
    K = torch.where(feasible, -cost / eps_t, _NEG)
    u = torch.zeros(P, dtype=torch.float32, device=dev)
    v = torch.zeros(T, dtype=torch.float32, device=dev)
    for _ in range(num_iters):
        u = torch.where(feas_row, log_a - _lse(K + v[None, :], 1), _NEG)
        v = torch.where(feas_col, log_b - _lse(K + u[:, None], 0), _NEG)
    return K, u, v


def _plan_plain(K: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """exp(K + u + v) with subnormal entries flushed to +0, as XLA gives it."""
    plan = torch.exp(K + u[:, None] + v[None, :])
    return torch.where(plan < torch.finfo(torch.float32).tiny, 0.0, plan)


def sinkhorn_plan(cost: torch.Tensor, eps: float = 0.05, num_iters: int = 200) -> torch.Tensor:
    """Log-domain Sinkhorn (``protocol_tpu/ops/assign.py:111``): the soft
    transport plan [P, T] with marginals equalized to min(P_valid,
    T_valid); infeasible pairs end with zero mass. K13 on a CUDA tensor
    (the result is then a transposed view of its slot-major plan)."""
    if cost.is_cuda:
        from protocol_tpu_torch import kernels

        return kernels.sinkhorn(cost.T.contiguous(), eps, num_iters)[0].T
    return _plan_plain(*_sinkhorn_plain(cost, eps, num_iters))


def _rounding_inputs(cost: torch.Tensor, plan: torch.Tensor):
    """The rounding's slot-major cost, where(feasible, -plan, INFEASIBLE)
    [T, P], and its visit order: tasks by their largest plan entry,
    descending, stable."""
    rcost_tp = torch.where(cost < INFEASIBLE * 0.5, -plan, INFEASIBLE).T.contiguous()
    order = torch.sort(-plan.amax(dim=0), stable=True).indices.to(torch.int32)
    return rcost_tp, order


def assign_sinkhorn(cost: torch.Tensor, eps: float = 0.05, num_iters: int = 200) -> AssignResult:
    """Sinkhorn plan + feasible rounding (``protocol_tpu/ops/assign.py:150``):
    a greedy matching on -plan, tasks visited by their best plan mass
    descending. On a CUDA tensor K13 writes the rounding cost and the
    column maxima with the plan, and K12 rounds."""
    P, T = cost.shape
    if cost.is_cuda:
        from protocol_tpu_torch import kernels

        _, rcost_tp, colmax, _, _ = kernels.sinkhorn(cost.T.contiguous(), eps, num_iters)
        order = torch.sort(-colmax, stable=True).indices.to(torch.int32)
        p4t = kernels.greedy_assign(rcost_tp, order)
    else:
        rcost_tp, order = _rounding_inputs(cost, sinkhorn_plan(cost, eps, num_iters))
        p4t = _greedy_plain(rcost_tp, order)
    return AssignResult(p4t, _invert(p4t, P))


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
