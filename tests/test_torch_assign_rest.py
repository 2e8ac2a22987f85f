"""The port's sequential greedy and log-domain Sinkhorn
(``protocol_tpu_torch/ops/assign.py``: the plain versions of kernels K12
and K13), held against ``protocol_tpu/ops/assign.py`` on the same numpy
inputs.

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

from protocol_tpu.ops.assign import assign_greedy as j_greedy
from protocol_tpu.ops.assign import assign_sinkhorn as j_sinkhorn
from protocol_tpu.ops.assign import ffd_order as j_ffd_order
from protocol_tpu.ops.assign import sinkhorn_plan as j_plan
from protocol_tpu.ops.cost import INFEASIBLE
from protocol_tpu_torch.ops import assign as ta

from tests.test_assign import check_feasible, greedy_oracle, random_cost

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
