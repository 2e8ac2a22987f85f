"""The port's sequential greedy and log-domain Sinkhorn
(``protocol_tpu_torch/ops/assign.py``: the plain versions of kernels K12
and K13), held against ``protocol_tpu/ops/assign.py`` on the same numpy
inputs; and models of the rules the card's K12 (a short sorted list a
step, built ahead of the chain) and K7 (rounds over a compacted open
list) run, held against the plain versions and the reference.

The greedy is comparisons only, so it is held bit for bit. The Sinkhorn
runs ``exp`` / ``log``, whose XLA and torch versions differ by ulps, and
sums in another order, so its plan is held within ``PLAN_ATOL`` (the
largest difference seen on these cases is 2e-6). Its rounding is held
exactly: a greedy on -plan, which these cases show is not moved by
differences of that size once subnormal plan entries are flushed to +0
as XLA flushes them; ``test_subnormal_flush_decides_a_matching`` shows a
case where it would be moved without the flush."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protocol_tpu.ops.assign import assign_auction as j_auction
from protocol_tpu.ops.assign import assign_greedy as j_greedy
from protocol_tpu.ops.assign import assign_sinkhorn as j_sinkhorn
from protocol_tpu.ops.assign import ffd_order as j_ffd_order
from protocol_tpu.ops.assign import sinkhorn_plan as j_plan
from protocol_tpu.ops.cost import INFEASIBLE
from protocol_tpu_torch.ops import assign as ta

from tests.test_assign import check_feasible, greedy_oracle, random_cost
from tests.test_torch_kernels_cuda import K7_KINDS, K12_KINDS, k7_case, k12_case

# |plan - reference plan|: exp/log ulps and summation order
PLAN_ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The plain loops run many small ops: one intra-op thread keeps them
    from contending with the other test workers' threads."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def greedy_both(cost, order=None):
    """(port p4t, port t4p), (reference p4t, reference t4p) as numpy."""
    got = ta.assign_greedy(torch.from_numpy(cost),
                           None if order is None else torch.from_numpy(order))
    ref = j_greedy(jnp.asarray(cost), None if order is None else jnp.asarray(order))
    return ((got.provider_for_task.numpy(), got.task_for_provider.numpy()),
            (np.asarray(ref.provider_for_task), np.asarray(ref.task_for_provider)))


def assert_greedy_same(cost, order=None):
    (gp, gt), (rp, rt) = greedy_both(cost, order)
    assert gp.dtype == np.int32 and gt.dtype == np.int32
    np.testing.assert_array_equal(gp, rp)
    np.testing.assert_array_equal(gt, rt)
    return gp


@pytest.mark.parametrize("seed,P,T", [(0, 16, 16), (1, 64, 256), (2, 256, 64)])
def test_greedy_random_costs_bit_for_bit(seed, P, T):
    cost = random_cost(np.random.default_rng(seed), P, T)
    p4t = assert_greedy_same(cost)
    np.testing.assert_array_equal(p4t, greedy_oracle(cost))


def test_greedy_given_task_order():
    rng = np.random.default_rng(3)
    cost = random_cost(rng, 32, 48)
    order = rng.permutation(48).astype(np.int32)
    p4t = assert_greedy_same(cost, order)
    np.testing.assert_array_equal(p4t, greedy_oracle(cost, order=list(order)))


@pytest.mark.parametrize("shape", [(4, 4), (12, 20)])
def test_greedy_infeasible_columns(shape):
    cost = random_cost(np.random.default_rng(4), *shape, p_infeasible=0.3)
    cost[:, 1] = INFEASIBLE  # one all-infeasible column
    p4t = assert_greedy_same(cost)
    assert p4t[1] == -1
    assert (assert_greedy_same(np.full(shape, INFEASIBLE, np.float32))[0] == -1).all()


def test_greedy_equal_costs_take_the_first_free_index():
    cost = np.ones((6, 9), np.float32)
    p4t = assert_greedy_same(cost)
    np.testing.assert_array_equal(p4t, [0, 1, 2, 3, 4, 5, -1, -1, -1])


def test_greedy_negative_zero_ties_with_positive_zero():
    # the rounding cost of a Sinkhorn plan is -plan: -0.0 wherever the
    # plan underflowed; argmin counts -0 and +0 as equal (first index)
    cost = np.full((5, 4), INFEASIBLE, np.float32)
    cost[:, 0] = [0.0, -0.0, 0.0, -0.0, 0.0]
    cost[:, 1] = [-0.0, 0.0, -0.0, 0.0, 1.0]
    cost[:, 2] = [5.0, -0.0, 0.0, -0.0, -0.0]
    cost[:, 3] = [-0.0, -1.0, -0.0, -1.0, 0.0]
    p4t = assert_greedy_same(cost)
    np.testing.assert_array_equal(p4t, [0, 1, 2, 3])
    order = np.array([3, 2, 1, 0], np.int32)
    assert_greedy_same(cost, order)


def test_ffd_order():
    np.testing.assert_array_equal(ta.ffd_order(torch.tensor([1.0, 5.0, 3.0, 5.0])).numpy(),
                                  [1, 3, 2, 0])
    demand = np.random.default_rng(5).integers(0, 6, 200).astype(np.float32)
    got = ta.ffd_order(torch.from_numpy(demand))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_ffd_order(jnp.asarray(demand))))


def assert_plan_close(cost, eps=0.05, num_iters=200):
    plan = ta.sinkhorn_plan(torch.from_numpy(cost), eps=eps, num_iters=num_iters).numpy()
    ref_plan = np.asarray(j_plan(jnp.asarray(cost), eps=eps, num_iters=num_iters))
    assert plan.shape == ref_plan.shape and plan.dtype == np.float32
    np.testing.assert_allclose(plan, ref_plan, rtol=0, atol=PLAN_ATOL)


def assert_sinkhorn_same(cost, eps=0.05, num_iters=200):
    """The matching and its inverse equal the reference's; returns p4t."""
    got = ta.assign_sinkhorn(torch.from_numpy(cost), eps=eps, num_iters=num_iters)
    ref = j_sinkhorn(jnp.asarray(cost), eps=eps, num_iters=num_iters)
    np.testing.assert_array_equal(got.provider_for_task.numpy(),
                                  np.asarray(ref.provider_for_task))
    np.testing.assert_array_equal(got.task_for_provider.numpy(),
                                  np.asarray(ref.task_for_provider))
    return check_feasible(ta.AssignResult(*(np.asarray(x) for x in (
        got.provider_for_task, got.task_for_provider))), cost)


def test_sinkhorn_identity_structure():
    n = 16
    cost = np.full((n, n), 5.0, np.float32)
    np.fill_diagonal(cost, 0.1)
    assert_plan_close(cost, 0.05, 300)
    np.testing.assert_array_equal(assert_sinkhorn_same(cost, 0.05, 300), np.arange(n))


@pytest.mark.parametrize("seed", [0, 1])
def test_sinkhorn_quality_case(seed):
    cost = np.random.default_rng(seed).uniform(0.0, 10.0, size=(32, 32)).astype(np.float32)
    assert_plan_close(cost, 0.02, 500)
    assert (assert_sinkhorn_same(cost, 0.02, 500) >= 0).all()


def test_sinkhorn_rectangular_with_infeasibility():
    cost = random_cost(np.random.default_rng(9), 48, 24, p_infeasible=0.2)
    assert_plan_close(cost, 0.05, 300)
    p4t = assert_sinkhorn_same(cost, 0.05, 300)
    assert (p4t[(cost < INFEASIBLE * 0.5).any(axis=0)] >= 0).all()


@pytest.mark.parametrize("n", [32, 64, 256])
def test_sinkhorn_plan_uniform_costs(n):
    """The plan within PLAN_ATOL on a uniform-cost case of each size."""
    assert_plan_close(random_cost(np.random.default_rng(0), n, n, p_infeasible=0.3))


@pytest.mark.parametrize("n", [32, 64, 256])
@pytest.mark.parametrize("seed", range(6))
def test_sinkhorn_uniform_costs_with_infeasibility(n, seed):
    """Uniform [0, 10) costs, 30% infeasible, at the defaults (eps 0.05,
    200 rounds): the matching exactly."""
    assert_sinkhorn_same(random_cost(np.random.default_rng(seed), n, n, p_infeasible=0.3))


def test_subnormal_flush_decides_a_matching():
    """Without the flush, the plan's subnormal entries (where XLA has 0)
    move the rounding: the matching then differs from the reference's."""
    cost = random_cost(np.random.default_rng(0), 256, 256, p_infeasible=0.3)
    K, u, v = ta._sinkhorn_plain(torch.from_numpy(cost), 0.05, 200)
    raw = torch.exp(K + u[:, None] + v[None, :])
    tiny = torch.finfo(torch.float32).tiny
    assert int(((raw > 0) & (raw < tiny)).sum()) > 0
    flushed = ta._plan_plain(K, u, v)
    assert float(flushed[(flushed > 0)].min()) >= tiny
    ref = np.asarray(j_sinkhorn(jnp.asarray(cost)).provider_for_task)

    def rounded(plan):
        rcost_tp, order = ta._rounding_inputs(torch.from_numpy(cost), plan)
        return ta._greedy_plain(rcost_tp, order).numpy()

    np.testing.assert_array_equal(rounded(flushed), ref)
    assert not np.array_equal(rounded(raw), ref)


# --------------------------------------------------------------------------
# Models of the rules the card's K12 and K7 run (csrc/greedy.cu,
# csrc/dense.cu), held against the plain versions and the reference
# --------------------------------------------------------------------------


def _ordered(c: np.float32) -> int:
    """The order-preserving bits of a non-NaN f32, -0 taken as +0."""
    u = int(np.array(c + np.float32(0.0), np.float32).view(np.uint32))
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else u | 0x80000000


def k12_list_model(cost_tp: np.ndarray, order: np.ndarray, m: int, lag, rng=None,
                   pre: bool = False) -> np.ndarray:
    """K12's rule: step s's list is the m least keys ((ordered cost bits)
    << 32 | provider; a NaN keys as the provider) among the candidates
    (cost < INFEASIBLE/2, or NaN) free in a snapshot taken once the first
    s - m + 1 ... s steps were done, ``lag`` = s - (steps done) in [0, m),
    or "cells": a lag drawn per cell, as a snapshot read bit by bit; the
    step takes the first listed provider free now, unless its cell is NaN.
    ``pre``: the list also drops every cell above a bound v (a NaN counts
    as -inf) that at least m candidates free in the snapshot lie at or
    below, and is read from a second snapshot, the same or later (the
    kernel's first pass). Returns provider_for_task [T] i32."""
    T, P = cost_tp.shape
    free = np.ones(P, bool)
    after = np.ones((len(order) + 1, P), bool)  # row k: the free set after k steps
    cols = np.arange(P)
    p4t = np.full(T, -1, np.int32)
    for s, t in enumerate(order):
        row = cost_tp[t]
        lags = rng.integers(0, m, P) if lag == "cells" else np.full(P, lag)
        snap = after[np.maximum(s - lags, 0), cols]
        cand = ~(row >= INFEASIBLE * 0.5)  # below INFEASIBLE/2, or NaN
        bound = np.inf
        if pre:
            vals = np.sort(np.where(np.isnan(row), -np.inf, row)[snap & cand])
            if vals.size >= m:
                bound = vals[min(m - 1 + int(rng.integers(0, 3)), vals.size - 1)]
            later = rng.integers(0, lags + 1)
            snap = after[np.maximum(s - later, 0), cols]
        ps = np.flatnonzero(snap & cand)
        c = row[ps]
        nan = np.isnan(c)
        keep = nan | (c <= bound)
        ps, c, nan = ps[keep], c[keep], nan[keep]
        u = (c + np.float32(0.0)).astype(np.float32).view(np.uint32)
        hi = np.where(nan, 0, np.where(u & 0x80000000, ~u, u | 0x80000000)).astype(np.uint64)
        listed = ps[np.argsort((hi << np.uint64(32)) | ps.astype(np.uint64))][:m]
        pick = next((int(p) for p in listed if free[p]), -1)
        if pick >= 0 and not np.isnan(row[pick]):
            free[pick] = False
            p4t[t] = pick
        after[s + 1] = free
    return p4t


def k12_rule_cost(seed: int, P: int = 48, T: int = 48):
    """A [P, T] cost with eighths (ties), -0 / +0, NaN and infeasible cells,
    an all-infeasible column, and a visit order: rows with more than 32
    candidates, so that a list of 32 can run out before the row does."""
    rng = np.random.default_rng(300 + seed)
    cost = (rng.integers(0, 16, (P, T)) / 8).astype(np.float32)
    cost[rng.uniform(size=(P, T)) < 0.15] = -0.0
    cost[rng.uniform(size=(P, T)) < 0.03] = np.nan
    cost[rng.uniform(size=(P, T)) < 0.2] = INFEASIBLE
    cost[:, 2] = INFEASIBLE
    return cost, rng.permutation(T).astype(np.int32)


@pytest.fixture(scope="module")
def k12_rule_refs():
    """seed -> (cost, order, the plain loop's p4t), the plain loop held
    against the reference's assign_greedy once a seed."""
    refs = {}
    for seed in (0, 1):
        cost, order = k12_rule_cost(seed)
        (gp, _), (rp, _) = greedy_both(cost, order)
        np.testing.assert_array_equal(gp, rp)
        refs[seed] = (cost, order, gp)
    return refs


@pytest.mark.parametrize("pre", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize(
    "m,lag", [(1, 0), (2, 0), (2, 1), (2, "cells")] + [(32, lag) for lag in range(32)]
    + [(32, "cells")])
def test_k12_list_rule_matches_plain_and_reference(k12_rule_refs, seed, m, lag, pre):
    """The producers' lists decide every step exactly: at list lengths 1, 2
    and 32, every snapshot lag from 0 to m - 1 and per-cell lags, with and
    without the first pass's bound, the rule gives the plain loop's picks
    and so the reference's, bit for bit."""
    cost, order, ref = k12_rule_refs[seed]
    got = k12_list_model(cost.T.copy(), order, m, lag, np.random.default_rng(seed), pre)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", K12_KINDS)
def test_k12_list_rule_on_the_card_cases(kind):
    """The rule at the kernel's list length (32) and per-cell lags on the
    card tests' K12 cases (small sizes) against the plain loop."""
    cost, order = k12_case(kind, small=True)
    cost_tp = cost.T.copy()
    ref = ta._greedy_plain(torch.from_numpy(cost_tp), torch.from_numpy(order)).numpy()
    got = k12_list_model(cost_tp, order, 32, "cells", np.random.default_rng(7), pre=True)
    np.testing.assert_array_equal(got, ref)


def k7_list_model(vb: np.ndarray, feasible: np.ndarray, eps: float, max_iters: int, rng):
    """K7's rounds over a compacted open list: the open slots bid in a
    shuffled order, each row's top two taken over a random split of its
    cells and merged by the kernel's rule, bids kept per provider by the
    largest (bid bits << 32 | ~slot); then the bidders only, in another
    order: winners seat (evicting), losers and the evicted make the next
    list. Returns (p4t, t4p, price, rounds, open rows summed)."""
    T, P = vb.shape
    f32 = np.float32
    price = np.zeros(P, f32)
    owner = np.full(P, -1, np.int32)
    p4t = np.full(T, -1, np.int32)
    lst = list(np.flatnonzero(feasible))
    it = rows = 0
    while it < max_iters and lst:
        rows += len(lst)
        rng.shuffle(lst)
        best, bids = {}, []
        for t in lst:
            v = (vb[t] - price).astype(f32)
            cuts = np.sort(rng.integers(0, P + 1, rng.integers(0, 4)))
            parts = []
            for a, b in zip(np.r_[0, cuts], np.r_[cuts, P]):
                b1, i1, b2 = -np.inf, P, -np.inf
                for p in range(a, b):  # a lane's rule, p ascending
                    if v[p] > b1:
                        b1, b2, i1 = v[p], b1, p
                    else:
                        b2 = max(b2, v[p])
                parts.append((b1, i1, b2))
            rng.shuffle(parts)
            b1, i1, b2 = parts[0]
            for c1, k1, c2 in parts[1:]:  # the kernel's merge
                if c1 > b1 or (c1 == b1 and k1 < i1):
                    b1, i1, b2 = c1, k1, max(b1, b2, c2)
                else:
                    b2 = max(b2, c1, c2)
            v2 = max(f32(b2), f32(-1e8))
            bid = f32(f32(price[i1] + f32(f32(b1) - v2)) + f32(eps))
            key = (_ordered(bid) << 32) | (~int(t) & 0xFFFFFFFF)
            best[i1] = max(best.get(i1, 0), key)
            bids.append((t, i1, key, bid))
        rng.shuffle(bids)
        nxt = []
        for t, p, key, bid in bids:
            if best[p] == key:
                old = owner[p]
                if old >= 0:
                    p4t[old] = -1
                    nxt.append(old)
                p4t[t], owner[p], price[p] = p, t, bid
            else:
                nxt.append(t)
        lst = nxt
        it += 1
    return p4t, owner, price, it, rows


@pytest.mark.parametrize("kind", K7_KINDS)
def test_k7_list_rounds_match_plain_and_reference(kind):
    """K7's rounds over the compacted open list, in any order of the list
    and any split of the rows, give the plain loop's p4t, t4p, prices,
    rounds and open rows, bit for bit, and the reference's matching, on
    the card tests' K7 cases (small sizes)."""
    cost = k7_case(kind, small=True)
    vb, feas = ta._value_base(torch.from_numpy(cost))
    iters = 40
    got = k7_list_model(vb.numpy(), feas.numpy(), 0.05, iters, np.random.default_rng(5))
    p4t, t4p, price, rounds, open_rows = ta._auction_dense_plain(vb, feas, 0.05, iters)
    np.testing.assert_array_equal(got[0], p4t.numpy())
    np.testing.assert_array_equal(got[1], t4p.numpy())
    assert got[2].view(np.int32).tolist() == price.numpy().view(np.int32).tolist()
    assert (got[3], got[4]) == (int(rounds), open_rows)
    ref = j_auction(jnp.asarray(cost), eps=0.05, max_iters=iters)
    np.testing.assert_array_equal(got[0], np.asarray(ref.provider_for_task))
