"""Sparse (top-K candidate) assignment (``protocol_tpu/ops/sparse.py``).

  candidates_topk
        one pass over the [P, T] cost in task tiles: each task's k cheapest
        providers (the candidate cache's delta passes).
  candidates_topk_reverse
        one pass over the [P, T] cost in task tiles, never materialising
        [P, T]: each task's k cheapest providers (forward lists) and each
        provider's per-tile cheapest task (the pools), folded into its best
        r tasks (reverse edges).
  merge_reverse_candidates
        reverse edges scattered into ``extra`` columns per task.
  assign_auction_sparse_scaled
        the eps-scaled frontier auction on the candidate graph, its phases
        run in segments by ``_phase_adaptive`` with the host readbacks of
        the reference.
  assign_auction_sparse_warm
        the delta-frontier auction from carried duals (prices, matching,
        retirement): one fine-eps phase through the same kernel K2.
  assign_auction_sparse, assign_topk
        one auction phase at a fixed eps; candidates_topk followed by it.

The candidate passes take the reference's ``task_offset``: the jitter's
task key is (row + task_offset) mod 2^32 while the requirement row read
stays the row, so delta batches generated under a persistent cursor stay
decorrelated. The forward pass also takes its ``provider_offset`` [P], a
selection bias (the blocked Sinkhorn's rounding passes -eps * u): the
selection runs on cost + offset[p] over the feasible cells while the
returned costs stay the true (jittered) costs.

Three functions hold hand kernels for Hopper (``csrc/``); each dispatches
on the device of its inputs, with no fallback:

  candidates_forward / candidates_reverse -> K1 (``csrc/candidates.cu``),
        its forward and reverse launches: a CPU tensor takes the plain
        torch scans below, a CUDA tensor the fused kernel (the forward
        launch over every task id).
  _sparse_auction_phase   -> K2 (``csrc/auction.cu``): a CPU tensor takes the
        plain round loop below, a CUDA tensor the persistent kernel.
  _greedy_cleanup_compacted -> K9 (``csrc/cleanup.cu``): a CPU tensor takes
        the plain loop below, a CUDA tensor the one-block sweep.

Every structure op (selection, fold, merge, auction) reproduces the
reference's tie order: among equal values the lower index comes first, as
``lax.top_k`` / ``argmax`` order them.
"""

from __future__ import annotations

import logging

import torch

from protocol_tpu_torch.ops.assign import _NEG, AssignResult, _invert
from protocol_tpu_torch.ops.cost import INFEASIBLE, CostWeights, cost_matrix, tie_jitter
from protocol_tpu_torch.ops.encoding import (
    EncodedProviders,
    EncodedRequirements,
    slice_requirements,
)


def frontier_bids(cand_safe, value_base, price, f_idx, f_ok, num_options: int):
    """The auction's per-frontier bid computation.

    Returns (p1 best provider, v1 best value, v2 runner-up value [floored]).
    """
    f_safe = torch.where(f_ok, f_idx, 0).long()
    cp = cand_safe[f_safe]  # [B, K]
    value = value_base[f_safe] - price[cp.long()]
    k1 = torch.argmax(value, dim=1)
    v1 = torch.gather(value, 1, k1[:, None])[:, 0]
    cols = torch.arange(num_options, device=value.device)
    v2 = torch.where(cols[None, :] == k1[:, None], _NEG, value).amax(dim=1)
    v2 = torch.clamp(v2, min=-1e8)  # single-option floor
    p1 = torch.gather(cp, 1, k1[:, None])[:, 0]
    return p1, v1, v2


def _jittered_tile_cost(ep, er, weights, t0: int, tile: int, task_offset: int = 0):
    """The jittered [P, tile] cost block of tasks [t0, t0 + tile), the
    jitter keyed on task t0 + j + task_offset."""
    P = ep.gpu_count.shape[0]
    r_tile = slice_requirements(er, t0, tile)
    cost, _mask = cost_matrix(ep, r_tile, weights)  # [P, tile]
    jitter = tie_jitter(P, tile, task_offset=t0 + task_offset, device=cost.device)
    return torch.where(cost < INFEASIBLE * 0.5, cost + jitter, cost)


def _forward_tile_select(ep, er, weights, t0: int, tile: int, k: int, task_offset: int = 0,
                         provider_offset: torch.Tensor | None = None):
    """One [P, tile] step of forward candidate selection, selecting on
    cost + ``provider_offset`` over the feasible cells when given. Returns
    (provider [tile, k], true cost_k [tile, k], the jittered [P, tile]
    cost block)."""
    cost = _jittered_tile_cost(ep, er, weights, t0, tile, task_offset)
    if provider_offset is None:
        selection = cost
    else:
        selection = torch.where(cost < INFEASIBLE * 0.5, cost + provider_offset[:, None], cost)
    # lax.top_k(-selection.T, k): the k smallest, lower index first among ties
    idx = _smallest_stable(selection.T, k)
    cost_k = torch.gather(cost.T, 1, idx)  # true costs
    sel_k = torch.gather(selection.T, 1, idx)
    provider = torch.where(sel_k < INFEASIBLE * 0.5, idx.to(torch.int32), -1)
    return provider, cost_k, cost


def _smallest_stable(c: torch.Tensor, n: int) -> torch.Tensor:
    """Column indices of each row's n smallest values, earlier column
    first among ties (``lax.top_k`` of the negation)."""
    return torch.sort(c, dim=1, stable=True).indices[:, :n]


def _forward_plain(ep, er, weights, k: int, tile: int, task_offset: int = 0,
                   provider_offset: torch.Tensor | None = None):
    """Plain torch version of K1's forward launch: (fwd_p, fwd_c) [T, k]."""
    T = er.cpu_cores.shape[0]
    parts = [_forward_tile_select(ep, er, weights, t0, tile, k, task_offset, provider_offset)[:2]
             for t0 in range(0, T, tile)]
    return torch.cat([p for p, _ in parts]), torch.cat([c for _, c in parts])


def _reverse_plain(ep, er, weights, tile: int, r: int, rt: int, task_offset: int = 0):
    """Plain torch version of K1's reverse launch: per tile, each
    provider's rt cheapest tasks (the pools, first index among ties),
    folded into a running best r where the carry wins ties. Returns
    (rev_t, rev_c) [P, r] unmasked and (pool_t, pool_c) [P, n_tiles*rt]."""
    P = ep.gpu_count.shape[0]
    T = er.cpu_cores.shape[0]
    dev = ep.gpu_count.device
    rev_c = torch.full((P, r), INFEASIBLE, dtype=torch.float32, device=dev)
    rev_t = torch.full((P, r), -1, dtype=torch.int32, device=dev)
    pool_t, pool_c = [], []
    for t0 in range(0, T, tile):
        cost = _jittered_tile_cost(ep, er, weights, t0, tile, task_offset)
        tid = t0 + torch.arange(tile, dtype=torch.int32, device=dev)
        if rt == 1:
            j = torch.argmin(cost, dim=1)[:, None]  # first index among ties
        else:
            j = _smallest_stable(cost, rt)
        tile_c = torch.gather(cost, 1, j)
        tile_t = tid[j]
        merged_c = torch.cat([rev_c, tile_c], dim=1)  # [P, r+rt]; carry first
        merged_t = torch.cat([rev_t, tile_t], dim=1)
        m = _smallest_stable(merged_c, r)
        rev_c = torch.gather(merged_c, 1, m)
        rev_t = torch.gather(merged_t, 1, m)
        pool_t.append(tile_t)
        pool_c.append(tile_c)
    return rev_t, rev_c, torch.cat(pool_t, dim=1), torch.cat(pool_c, dim=1)


def candidates_forward(ep, er, weights, k: int, tile: int, task_offset: int = 0,
                       provider_offset: torch.Tensor | None = None):
    """Each task's k cheapest providers, lower index first among ties:
    (fwd_p [T, k] i32 with -1 where infeasible, fwd_c [T, k]); with
    ``provider_offset`` [P] the selection is biased by it and fwd_c holds
    the true costs. On a CUDA tensor this is K1's forward launch over
    every task id (one to 32 lanes per task; the biased instantiation
    with an offset), else :func:`_forward_plain`."""
    from protocol_tpu_torch import kernels

    kernels.jitter_offset(task_offset)  # refuses what does not fit in int32
    if provider_offset is not None:
        provider_offset = provider_offset.to(torch.float32).contiguous()
        if provider_offset.shape != (ep.num,) or provider_offset.device != ep.gpu_count.device:
            raise ValueError(f"provider_offset must be a [{ep.num}] tensor on "
                             f"{ep.gpu_count.device}")
    if ep.gpu_count.is_cuda:
        ids = torch.arange(er.num, dtype=torch.int32, device=ep.gpu_count.device)
        return kernels.candidates_forward_rows(ep, er, weights, k, ids, offset=task_offset,
                                               bias=provider_offset)
    return _forward_plain(ep, er, weights, k, tile, task_offset, provider_offset)


def candidates_reverse(ep, er, weights, tile: int, r: int, rt: int, task_offset: int = 0):
    """The tile-pooled reverse selection: (rev_t, rev_c, pool_t, pool_c).
    On a CUDA tensor this is K1's reverse launch, else
    :func:`_reverse_plain`."""
    from protocol_tpu_torch import kernels

    kernels.jitter_offset(task_offset)
    if ep.gpu_count.is_cuda:
        return kernels.candidates_reverse(ep, er, weights, tile=tile, r=r, rt=rt,
                                          offset=task_offset)
    return _reverse_plain(ep, er, weights, tile, r, rt, task_offset)


def _refuse_unported(approx_recall) -> None:
    if approx_recall is not None:
        raise NotImplementedError(
            "approx_recall: lax.approx_max_k (the TPU's PartialReduce) has "
            "no Hopper counterpart; the port selects exactly"
        )


def _tiles(T: int, tile: int) -> int:
    if T % tile != 0:
        raise ValueError(f"T={T} not divisible by tile={tile}; pad requirements")
    return T // tile


def candidates_topk(
    ep: EncodedProviders,
    er: EncodedRequirements,
    weights: CostWeights | None = None,
    k: int = 64,
    tile: int = 1024,
    provider_offset: torch.Tensor | None = None,
    task_offset: int = 0,
    approx_recall: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each task's top-k cheapest compatible providers (k clamped to P):
    (cand_provider i32 [T, k] with -1 padding, cand_cost f32 [T, k]). T
    must be divisible by ``tile``. ``provider_offset`` [P] biases the
    selection (the returned costs stay the true costs; a provider is -1
    where its selection value is >= INFEASIBLE/2). ``task_offset`` shifts
    the jitter's task index (a delta batch's persistent cursor). On a CUDA
    tensor this is K1's forward launch (``csrc/candidates.cu``)."""
    _refuse_unported(approx_recall)
    if weights is None:
        weights = CostWeights()
    _tiles(er.cpu_cores.shape[0], tile)
    k = min(k, int(ep.gpu_count.shape[0]))
    return candidates_forward(ep, er, weights, k, tile, task_offset, provider_offset)


def reverse_candidates(ep, er, weights, tile: int, reverse_r: int, task_offset: int = 0):
    """The reverse half of :func:`candidates_topk_reverse`: each provider's
    best ``reverse_r`` tasks from per-tile pools of ceil(r / n_tiles)
    tasks. Returns (rev_t [P, r] with -1 where infeasible, rev_c [P, r],
    pool_t, pool_c)."""
    n_tiles = _tiles(er.cpu_cores.shape[0], tile)
    r = min(reverse_r, er.cpu_cores.shape[0])
    rt = max(1, -(-r // n_tiles))  # per-tile contribution (ceil div)
    rev_t, rev_c, pool_t, pool_c = candidates_reverse(ep, er, weights, tile, r, rt, task_offset)
    return torch.where(rev_c < INFEASIBLE * 0.5, rev_t, -1), rev_c, pool_t, pool_c


def candidates_topk_reverse(
    ep: EncodedProviders,
    er: EncodedRequirements,
    weights: CostWeights | None = None,
    k: int = 64,
    tile: int = 1024,
    reverse_r: int = 8,
    provider_offset: torch.Tensor | None = None,
    task_offset: int = 0,
    approx_recall: float | None = None,
    with_pools: bool = False,
):
    """Bidirectional candidate generation: per-task top-k providers plus
    per-provider top-``reverse_r`` tasks in one pass over the cost.

    Reverse selection is tile-pooled as in the reference: each tile
    contributes its per-provider top-``ceil(r / n_tiles)`` tasks (the
    pools) and the reverse edges are the best r of the pool, carry first
    among ties. Returns (cand_p [T,k] i32 with -1 padding, cand_c [T,k],
    rev_t [P,r] i32 with -1 padding, rev_c [P,r]) and, with
    ``with_pools``, (pool_t, pool_c) [P, n_tiles*rt] in tile order.

    On a CUDA tensor this is kernel K1 (``csrc/candidates.cu``), both
    launches keyed on ``task_offset``.
    """
    if weights is None:
        weights = CostWeights()
    fwd_p, fwd_c = candidates_topk(
        ep, er, weights, k=k, tile=tile, provider_offset=provider_offset,
        task_offset=task_offset, approx_recall=approx_recall,
    )
    rev_t, rev_c, pool_t, pool_c = reverse_candidates(ep, er, weights, tile, reverse_r, task_offset)
    res = (fwd_p, fwd_c, rev_t, rev_c)
    if with_pools:
        res = res + (pool_t, pool_c)
    return res


def merge_reverse_candidates(
    cand_p: torch.Tensor,
    cand_c: torch.Tensor,
    rev_t: torch.Tensor,
    rev_c: torch.Tensor,
    extra: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter reverse (provider -> task) edges into up to ``extra`` extra
    candidate columns per task: ([T, K+extra] provider ids, costs).

    Edges duplicating a forward candidate are dropped; the rest are sorted
    by (task, cost) (two stable sorts = ``jnp.lexsort``), ranked within
    their task by a running max, and ranks >= ``extra`` dropped.
    """
    T = cand_p.shape[0]
    P, r = rev_t.shape
    dev = cand_p.device
    t_flat = torch.where(rev_t.reshape(-1) >= 0, rev_t.reshape(-1), T).long()
    p_flat = torch.arange(P, dtype=torch.int32, device=dev).repeat_interleave(r)
    c_flat = rev_c.reshape(-1)
    dup = (cand_p[torch.clamp(t_flat, max=T - 1)] == p_flat[:, None]).any(dim=1)
    t_flat = torch.where(dup, T, t_flat)
    order = torch.sort(c_flat, stable=True).indices
    order = order[torch.sort(t_flat[order], stable=True).indices]
    t_s, p_s, c_s = t_flat[order], p_flat[order], c_flat[order]
    n = t_s.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    new_seg = torch.ones(n, dtype=torch.bool, device=dev)
    new_seg[1:] = t_s[1:] != t_s[:-1]
    run_start = torch.cummax(torch.where(new_seg, pos, -1), dim=0).values
    rank = pos - run_start
    keep = (t_s < T) & (rank < extra)
    ti = torch.where(keep, t_s, T)
    ri = torch.where(keep, rank, 0)
    extra_p = torch.full((T + 1, extra), -1, dtype=torch.int32, device=dev)
    extra_p[ti, ri] = p_s
    extra_c = torch.full((T + 1, extra), INFEASIBLE, dtype=torch.float32, device=dev)
    extra_c[ti, ri] = c_s
    return (
        torch.cat([cand_p, extra_p[:T]], dim=1),
        torch.cat([cand_c, extra_c[:T]], dim=1),
    )


def pick_tile(n_tasks: int, cap: int = 1024) -> int:
    """Largest tile <= ``cap`` that divides ``n_tasks`` exactly."""
    if n_tasks <= 0:
        return 1
    tile = min(cap, n_tasks)
    while n_tasks % tile != 0:
        tile -= 1
    return tile


def candidates_topk_bidir(
    ep: EncodedProviders,
    er: EncodedRequirements,
    weights: CostWeights | None = None,
    k: int = 64,
    tile: int = 1024,
    reverse_r: int = 8,
    extra: int = 16,
    approx_recall: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward top-k + reverse top-r candidates, merged: ([T, k+extra]
    provider ids, costs)."""
    cand_p, cand_c, rev_t, rev_c = candidates_topk_reverse(
        ep, er, weights, k=k, tile=tile, reverse_r=reverse_r,
        approx_recall=approx_recall,
    )
    return merge_reverse_candidates(cand_p, cand_c, rev_t, rev_c, extra=extra)


def _phase_inputs(cand_provider, cand_cost, retire: bool):
    """The per-phase constants of the auction, in the reference's order:
    (cand_safe, value_base, task_feasible, give_up as a 0-d f32 tensor)."""
    cand_valid = cand_provider >= 0
    value_base = torch.where(cand_valid, -cand_cost, _NEG)  # [T, K]
    task_feasible = cand_valid.any(dim=1)
    cand_safe = torch.where(cand_valid, cand_provider, 0).to(torch.int32)
    if retire:
        finite_max = torch.where(cand_valid, cand_cost, 0.0).amax()
        give_up = -(2.0 * finite_max + 10.0)
    else:
        give_up = torch.tensor(_NEG, dtype=torch.float32, device=cand_cost.device)
    return cand_safe, value_base, task_feasible, give_up


def _initial_state(T: int, P: int, device):
    return (
        torch.zeros((), dtype=torch.int32, device=device),
        torch.zeros(P, dtype=torch.float32, device=device),
        torch.full((P,), -1, dtype=torch.int32, device=device),
        torch.full((T,), -1, dtype=torch.int32, device=device),
        torch.zeros(T, dtype=torch.bool, device=device),
    )


def _auction_rounds_plain(
    cand_safe, value_base, task_feasible, give_up, state,
    P: int, eps: float, max_iters: int, B: int, stall_limit: int,
):
    """Plain torch version of K2: the reference's ``while_loop``, one
    round per iteration, its condition read back on the host."""
    T, K = value_base.shape
    dev = value_base.device
    _, price, owner, p4t, retired = state
    price, owner, p4t, retired = price.clone(), owner.clone(), p4t.clone(), retired.clone()
    p_idx = torch.arange(P, dtype=torch.int32, device=dev)
    best = int((p4t >= 0).sum())
    stall = 0
    it = 0
    while it < max_iters and (stall_limit <= 0 or stall < stall_limit):
        open_mask = (p4t < 0) & task_feasible & ~retired
        open_idx = torch.nonzero(open_mask).flatten()[:B].to(torch.int32)
        if open_idx.numel() == 0:
            break
        # frontier: the first B open tasks in index order, padded with T
        f_idx = torch.full((B,), T, dtype=torch.int32, device=dev)
        f_idx[: open_idx.numel()] = open_idx
        f_ok = f_idx < T
        p1, v1, v2 = frontier_bids(cand_safe, value_base, price, f_idx, f_ok, K)

        newly_retired = f_ok & (v1 < give_up)
        retired_ext = torch.cat([retired, retired.new_zeros(1)])
        retired_ext[torch.where(newly_retired, f_idx, T).long()] = True
        retired = retired_ext[:T]

        bidding = f_ok & ~newly_retired & (v1 > _NEG * 0.5)
        bid_amt = price[p1.long()] + (v1 - v2) + eps  # [B]
        tgt = torch.where(bidding, p1, P).long()
        win_bid = torch.full((P + 1,), _NEG, dtype=torch.float32, device=dev)
        win_bid = win_bid.scatter_reduce(
            0, tgt, torch.where(bidding, bid_amt, _NEG), "amax"
        )[:P]
        # among max bidders per provider, lowest task index wins
        is_winner_bid = bidding & (bid_amt >= win_bid[p1.long()])
        win_task = torch.full((P + 1,), T, dtype=torch.int32, device=dev)
        win_task = win_task.scatter_reduce(
            0, tgt, torch.where(is_winner_bid, f_idx, T), "amin"
        )[:P]
        got_bid = (win_bid > _NEG * 0.5) & (win_task < T)

        p4t_ext = torch.cat([p4t, p4t.new_full((1,), -1)])
        evict_t = torch.where(got_bid & (owner >= 0), owner, T).long()
        p4t_ext[evict_t] = -1
        win_t_safe = torch.where(got_bid, win_task, T).long()
        p4t_ext[win_t_safe] = torch.where(got_bid, p_idx, -1)
        p4t = p4t_ext[:T]
        owner = torch.where(got_bid, win_task, owner)
        price = torch.where(got_bid, win_bid, price)
        n_now = int((p4t >= 0).sum())
        stall = 0 if n_now > best else stall + 1
        best = max(best, n_now)
        it += 1
    state = (torch.tensor(it, dtype=torch.int32, device=dev), price, owner, p4t, retired)
    return state, torch.tensor(stall, dtype=torch.int32, device=dev)


def _sparse_auction_phase(
    cand_provider: torch.Tensor,
    cand_cost: torch.Tensor,
    num_providers: int,
    state: tuple | None,
    eps: float = 0.01,
    max_iters: int = 10000,
    frontier: int = 4096,
    retire: bool = True,
    stall_limit: int = 0,
):
    """One eps phase of the frontier auction; ``state`` carries
    (it, price, owner, p4t, retired) across phases for warm starts.
    Returns (state, stall) with ``it`` and ``stall`` as 0-d int32 tensors.

    Each round bids for up to ``frontier`` open tasks (the first ones in
    index order), retires tasks whose best value fell below the give-up
    level, resolves one winner per provider (highest bid, lowest task
    among equal bids), evicts its old owner and seats it.
    ``stall_limit`` > 0 also ends the phase after that many rounds with
    no net assignment progress.

    On a CUDA tensor this is kernel K2 (``csrc/auction.cu``): all rounds in
    one launch of one persistent block, with no host sync per round.
    """
    T, K = cand_cost.shape
    P = num_providers
    B = min(frontier, T)
    dev = cand_cost.device
    if state is None:
        state = _initial_state(T, P, dev)
    cand_safe, value_base, task_feasible, give_up = _phase_inputs(
        cand_provider, cand_cost, retire
    )
    if cand_cost.is_cuda:
        from protocol_tpu_torch import kernels

        return kernels.auction_phase(
            cand_safe, value_base, task_feasible, give_up, state,
            P=P, eps=eps, max_iters=max_iters, B=B, stall_limit=stall_limit,
        )
    return _auction_rounds_plain(
        cand_safe, value_base, task_feasible, give_up, state,
        P, eps, max_iters, B, stall_limit,
    )


def assign_auction_sparse(
    cand_provider: torch.Tensor,
    cand_cost: torch.Tensor,
    num_providers: int,
    eps: float = 0.01,
    max_iters: int = 10000,
    frontier: int = 4096,
    retire: bool = True,
) -> AssignResult:
    """The frontier auction on the candidate graph at one eps, from
    scratch duals: one :func:`_sparse_auction_phase` (K2 on a card), no
    stall breaker. ``frontier >= T`` with ``retire=False`` is the dense
    Jacobi schedule."""
    state, _stall = _sparse_auction_phase(
        cand_provider, cand_cost, num_providers, None,
        eps=eps, max_iters=max_iters, frontier=frontier, retire=retire,
    )
    p4t = state[3]
    return AssignResult(p4t, _invert(p4t, num_providers))


def assign_topk(
    ep: EncodedProviders,
    er: EncodedRequirements,
    weights: CostWeights | None = None,
    k: int = 64,
    tile: int = 1024,
    eps: float = 0.01,
    max_iters: int = 1000,
) -> AssignResult:
    """The forward-only sparse pipeline: :func:`candidates_topk` then
    :func:`assign_auction_sparse`."""
    cand_p, cand_c = candidates_topk(ep, er, weights, k=k, tile=tile)
    return assign_auction_sparse(cand_p, cand_c, num_providers=ep.num, eps=eps,
                                 max_iters=max_iters)


def _unassign_unhappy(cand_provider, cand_cost, price, owner, p4t, eps_next):
    """eps-CS repair between phases: holders whose assignment violates the
    tighter eps re-enter the auction (with the reference's float-dust
    tolerance at the eps-CS boundary)."""
    cand_valid = cand_provider >= 0
    cand_safe = torch.where(cand_valid, cand_provider, 0).long()
    value = torch.where(cand_valid, -cand_cost - price[cand_safe], _NEG)  # [T,K]
    v1 = value.amax(dim=1)
    held = p4t
    vcur = torch.where(
        cand_safe == torch.clamp(held, min=0).long()[:, None], value, _NEG
    ).amax(dim=1)
    finite_max = torch.where(cand_valid, cand_cost, 0.0).amax()
    tol = 1e-5 * (1.0 + finite_max + price.abs().amax())
    unhappy = (held >= 0) & (vcur < v1 - eps_next - tol)
    P = owner.shape[0]
    owner_ext = torch.cat([owner, owner.new_full((1,), -1)])
    owner_ext[torch.where(unhappy, held, P).long()] = -1
    p4t = torch.where(unhappy, -1, p4t)
    return owner_ext[:P], p4t


def _greedy_cleanup_compacted(cand_provider, cand_cost, owner, p4t, open_idx):
    """Sweep the open tasks ``open_idx`` (index order) greedily: each takes
    its cheapest free candidate. Sequential by nature: K9 on a card (one
    block, ``csrc/cleanup.cu``), the plain loop below on the CPU."""
    if cand_cost.is_cuda:
        from protocol_tpu_torch import kernels

        return kernels.greedy_cleanup(cand_provider, cand_cost, owner, p4t, open_idx)
    return _greedy_cleanup_plain(cand_provider, cand_cost, owner, p4t, open_idx)


def _greedy_cleanup_plain(cand_provider, cand_cost, owner, p4t, open_idx):
    """K9's plain version: one masked argmin per open row, in order; the
    loop runs over the open rows only and never reads a value back to the
    host."""
    T, K = cand_cost.shape
    free = owner < 0  # [P]
    cand_valid = cand_provider >= 0
    cand_safe = torch.where(cand_valid, cand_provider, 0).long()
    rows = open_idx.long()
    rows_p, rows_c, rows_v = cand_safe[rows], cand_cost[rows], cand_valid[rows]
    n = rows.shape[0]
    picks = torch.full((n,), -1, dtype=torch.int64, device=cand_cost.device)
    for i in range(n):
        cp = rows_p[i]
        cost_row = torch.where(rows_v[i] & free[cp], rows_c[i], INFEASIBLE)
        c, j = cost_row.min(dim=0, keepdim=True)  # first index among ties
        feasible = c < INFEASIBLE * 0.5
        p = cp.gather(0, j)
        free.scatter_(0, p, free.gather(0, p) & ~feasible)
        picks[i:i + 1] = torch.where(feasible, p, -1)
    p4t_ext = torch.cat([p4t, p4t.new_full((1,), -1)])
    p4t_ext[torch.where(picks >= 0, rows, T)] = torch.where(
        picks >= 0, picks, -1
    ).to(p4t.dtype)
    return p4t_ext[:T]


def _greedy_cleanup(cand_provider, cand_cost, owner, p4t):
    """Host wrapper: one readback (the open set) decides whether cleanup
    is needed."""
    open_idx = torch.nonzero(p4t < 0).flatten()
    if open_idx.numel() == 0:
        return p4t
    return _greedy_cleanup_compacted(cand_provider, cand_cost, owner, p4t, open_idx)


def assign_auction_sparse_scaled(
    cand_provider: torch.Tensor,
    cand_cost: torch.Tensor,
    num_providers: int,
    eps_start: float = 4.0,
    eps_end: float = 0.02,
    scale: float = 0.25,
    max_iters_per_phase: int = 4000,
    frontier: int = 4096,
    stall_limit: int = 64,
    stats_out: dict | None = None,
    with_state: bool = False,
):
    """eps-scaling auction: geometric eps ladder with warm-started prices.

    Retirement runs in every phase as a circuit breaker, but non-final
    retirements are reversed between phases (un-retire + eps-CS repair),
    so only the final phase's retirement binds; the final phase gets 8x
    the stall budget; a greedy cleanup seats stranded pairs at the end.
    ``with_state=True`` returns (result, prices, retired [T]).
    """
    state = None
    eps = eps_start
    rounds_total = 0
    while True:
        final = eps <= eps_end
        state, stall = _phase_adaptive(
            cand_provider, cand_cost, num_providers, state,
            eps=eps, max_iters=max_iters_per_phase, frontier=frontier,
            retire=True,
            stall_limit=stall_limit * (8 if final else 1),
        )
        if stats_out is not None:
            rounds_total += int(state[0])
        if final:
            _report_stall("scaled", stall, stall_limit * 8, stats_out)
            if stats_out is not None:
                stats_out["rounds_total"] = rounds_total
            break
        eps = max(eps * scale, eps_end)
        it, price, owner, p4t, retired = state
        owner, p4t = _unassign_unhappy(cand_provider, cand_cost, price, owner, p4t, eps)
        # un-retire: coarse-phase retirement was only the circuit breaker
        retired = torch.zeros_like(retired)
        state = (it, price, owner, p4t, retired)

    _, price, owner, p4t, retired = state
    p4t = _greedy_cleanup(cand_provider, cand_cost, owner, p4t)
    res = AssignResult(p4t, _invert(p4t, num_providers))
    if with_state:
        # a retired task the greedy cleanup managed to seat is assigned
        return res, price, retired & (p4t < 0)
    return res


def _phase_adaptive(
    cand_provider,
    cand_cost,
    num_providers: int,
    state,
    eps,
    max_iters: int,
    frontier: int,
    retire: bool,
    stall_limit: int,
):
    """One eps phase run in segments of 256 rounds with a frontier that
    shrinks to the live open set (smallest pow2 >= 512 covering it,
    monotone). The stall circuit breaker and the phase budget act at
    segment granularity, as in the reference; each segment is one
    ``_sparse_auction_phase`` call, and between segments the host reads
    back the round count, the stall count and the open count."""
    seg_rounds = 256
    T = cand_cost.shape[0]
    task_feasible = (cand_provider >= 0).any(dim=1)
    iters_left = max_iters
    total_it = 0
    B = min(frontier, T)
    carried_stall = 0
    while iters_left > 0:
        state, stall = _sparse_auction_phase(
            cand_provider, cand_cost, num_providers, state,
            eps=eps, max_iters=seg_rounds, frontier=B, retire=retire,
            stall_limit=0,
        )
        it = int(state[0])
        total_it += it
        iters_left -= it
        s = int(stall)
        carried_stall = carried_stall + it if s >= it else s
        if it < seg_rounds:
            break  # converged or emptied
        if stall_limit > 0 and carried_stall >= stall_limit:
            break  # circuit breaker (segment-boundary granularity)
        open_count = int(((state[3] < 0) & ~state[4] & task_feasible).sum())
        if open_count == 0:
            break
        fit = 512
        while fit < open_count and fit < B:
            fit *= 2
        B = min(B, fit)
    dev = cand_cost.device
    state = (torch.tensor(total_it, dtype=torch.int32, device=dev),) + tuple(state[1:])
    return state, torch.tensor(carried_stall, dtype=torch.int32, device=dev)


def _report_stall(kind: str, stall, limit: int, stats_out: dict | None) -> None:
    """Record (and log) a binding-phase stall termination."""
    stalled = bool(limit > 0 and int(stall) >= limit)
    if stats_out is not None:
        stats_out["stall_exit"] = stalled
        stats_out["stall_rounds"] = int(stall)
    if stalled:
        logging.getLogger(__name__).info(
            "sparse auction (%s) stall-terminated after %d no-progress "
            "rounds; tail quality falls to greedy cleanup (stall_limit=0 "
            "opts out)",
            kind,
            int(stall),
        )


def assign_auction_sparse_warm(
    cand_provider: torch.Tensor,
    cand_cost: torch.Tensor,
    num_providers: int,
    price0: torch.Tensor,
    p4t0: torch.Tensor,
    eps: float = 0.02,
    max_iters: int = 20000,
    frontier: int = 4096,
    stall_limit: int = 64,
    stats_out: dict | None = None,
    frontier_ladder: bool = True,
    retired0: torch.Tensor | None = None,
    with_state: bool = False,
):
    """Incremental (delta-frontier) auction from the previous solve's duals.

    ``price0`` [P] are the previous final prices, ``p4t0`` [T] the previous
    matching in the current index space (-1 for new or changed tasks,
    injective over >= 0), ``retired0`` [T] the previous retirement mask
    with the rows whose candidates or costs changed already cleared by
    the caller. Seeds of tasks without candidates are dropped; prices are
    shifted down uniformly until max(price) <= finite_max + 5 (a shift,
    not a clamp: it changes no value difference, and prices may go
    negative); seeds that violate eps-CS under the shifted prices are
    evicted; then one phase at ``eps`` with 8x the stall budget, and the
    greedy cleanup. Returns (AssignResult, prices), plus the retirement
    mask with ``with_state=True``.
    """
    task_has_cand = (cand_provider >= 0).any(dim=1)
    p4t0 = torch.where(task_has_cand, p4t0.to(torch.int32), -1)
    finite_max = torch.where(cand_provider >= 0, cand_cost, 0.0).amax()
    price0 = price0.to(torch.float32)
    shift = torch.clamp(price0.amax() - (finite_max + 5.0), min=0.0)
    price0 = price0 - shift
    owner0 = _invert(p4t0, num_providers)
    owner0, p4t0 = _unassign_unhappy(cand_provider, cand_cost, price0, owner0, p4t0, eps)
    if retired0 is None:
        retired_seed = torch.zeros(cand_cost.shape[0], dtype=torch.bool, device=cand_cost.device)
    else:
        # a seeded assignment outranks a stale retirement flag
        retired_seed = retired0.to(torch.bool) & (p4t0 < 0)
    state = (
        torch.zeros((), dtype=torch.int32, device=cand_cost.device),
        price0, owner0, p4t0, retired_seed,
    )
    phase_fn = _phase_adaptive if frontier_ladder else _sparse_auction_phase
    state, stall = phase_fn(
        cand_provider, cand_cost, num_providers, state,
        eps=eps, max_iters=max_iters, frontier=frontier, retire=True,
        stall_limit=stall_limit * 8,
    )
    _report_stall("warm", stall, stall_limit * 8, stats_out)
    if stats_out is not None:
        stats_out["rounds_total"] = int(state[0])
    _, price, owner, p4t, retired = state
    p4t = _greedy_cleanup(cand_provider, cand_cost, owner, p4t)
    res = AssignResult(p4t, _invert(p4t, num_providers))
    if with_state:
        return res, price, retired & (p4t < 0)
    return res, price
