"""The port's FFD vector bin-pack (``protocol_tpu_torch/ops/binpack.py``,
the plain version of kernel K11) and the matcher's dense cost block
(``sched/torch_backend.py::cost_only``, the plain version of K10), held
against the JAX reference on the same numpy inputs.

Demands and capacities are integer-valued floats, as the matcher's are:
the L1 demand sums are then exact whatever the summation order, so the
FFD visit order cannot differ between the two libraries."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protocol_tpu.ops.binpack import assign_binpack_ffd as j_binpack
from protocol_tpu.ops.binpack import ffd_demand_order as j_order
from protocol_tpu.ops.cost import INFEASIBLE
from protocol_tpu.ops.cost import CostWeights as JCostWeights
from protocol_tpu.sched.tpu_backend import _cost_only
from protocol_tpu.trace import synth as j_synth
from protocol_tpu_torch.ops.binpack import (
    assign_binpack_ffd,
    binpack_oracle,
    ffd_demand_order,
)
from protocol_tpu_torch.ops.cost import CostWeights
from protocol_tpu_torch.sched.torch_backend import cost_only

from tests.test_binpack import check_feasible, random_instance
from tests.test_torch_kernels_cuda import BINPACK_KINDS, binpack_case, binpack_limit_L
from tests.test_torch_dense import markets
from tests.test_torch_encoding_cost import COST_ATOL, encode_random, to_port


def both(cost, demand, capacity, **kw):
    """(port result, reference result) as numpy arrays: provider_for_task
    and the remaining capacity's bits."""
    tkw = {k: torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    got = assign_binpack_ffd(torch.from_numpy(cost), torch.from_numpy(demand),
                             torch.from_numpy(capacity), **tkw)
    ref = j_binpack(jnp.asarray(cost), jnp.asarray(demand), jnp.asarray(capacity), **jkw)
    return ((got.provider_for_task.numpy(), got.remaining_capacity.numpy().view(np.int32)),
            (np.asarray(ref.provider_for_task), np.asarray(ref.remaining_capacity).view(np.int32)))


def assert_same(cost, demand, capacity, **kw):
    (gp, gc), (rp, rc) = both(cost, demand, capacity, **kw)
    np.testing.assert_array_equal(gp, rp)
    np.testing.assert_array_equal(gc, rc)
    return gp


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_randomized_parity_with_the_reference(seed):
    rng = np.random.default_rng(seed)
    cost, demand, capacity, anti, loc, G, L = random_instance(rng, P=48, T=96, group_frac=0.4,
                                                              n_locs=12 if seed % 2 else None)
    got = assert_same(cost, demand, capacity, anti_group=anti, loc_id=loc, num_locations=L,
                      num_groups=G)
    check_feasible(cost, demand, capacity, anti, loc, got)
    want, _ = binpack_oracle(cost, demand, capacity, anti_group=anti, loc_id=loc)
    np.testing.assert_array_equal(got, want)


def test_several_tasks_per_provider():
    cost = np.full((1, 4), 1.0, np.float32)
    got = assert_same(cost, np.ones((4, 1), np.float32), np.array([[3.0]], np.float32))
    assert (got >= 0).sum() == 3


def test_group_spreads_and_surplus_stays_unassigned():
    anti = np.zeros(3, np.int32)
    got = assert_same(np.full((3, 3), 1.0, np.float32), np.ones((3, 2), np.float32),
                      np.full((3, 2), 100.0, np.float32), anti_group=anti, num_groups=1)
    assert sorted(got.tolist()) == [0, 1, 2]
    got = assert_same(np.full((2, 3), 1.0, np.float32), np.ones((3, 1), np.float32),
                      np.full((2, 1), 100.0, np.float32), anti_group=anti, num_groups=1)
    assert (got >= 0).sum() == 2


def test_location_level_exclusion():
    cost = np.full((4, 2), 1.0, np.float32)
    cost[2:, :] = 0.5
    loc = np.array([0, 0, 1, 1], np.int32)
    got = assert_same(cost, np.ones((2, 1), np.float32), np.full((4, 1), 100.0, np.float32),
                      anti_group=np.zeros(2, np.int32), loc_id=loc, num_locations=2,
                      num_groups=1)
    assert {int(loc[p]) for p in got} == {0, 1}


def test_all_infeasible_column_touches_no_row():
    """argmin of an all-INFEASIBLE column is row 0: nothing may be taken
    from it, and nothing marked."""
    cost = np.full((4, 3), 2.0, np.float32)
    cost[:, 1] = INFEASIBLE
    demand = np.array([[1.0], [5.0], [1.0]], np.float32)  # the infeasible task goes first
    capacity = np.full((4, 1), 1.0, np.float32)
    got = assert_same(cost, demand, capacity, anti_group=np.array([0, 0, 0], np.int32),
                      num_groups=1)
    assert got[1] == -1
    assert got[0] == 0 and got[2] == 1  # row 0 kept its capacity and its group bit


def test_padded_slots_like_phase_zero():
    """Phase 0's layout: unit demand for every slot, padding included;
    the padding columns are infeasible and keep the identity order."""
    rng = np.random.default_rng(3)
    S, s_pad, rpad = 11, 16, 32
    cost = rng.integers(1, 5, (rpad, s_pad)).astype(np.float32)
    cost[:, S:] = INFEASIBLE
    cost[rpad - 7:, :] = INFEASIBLE  # padding rows
    anti = np.concatenate([np.repeat(np.arange(3, dtype=np.int32), [4, 4, 3]),
                           np.full(s_pad - S, -1, np.int32)])
    got = assert_same(cost, np.ones((s_pad, 1), np.float32), np.ones((rpad, 1), np.float32),
                      anti_group=anti, loc_id=np.arange(rpad, dtype=np.int32),
                      num_locations=rpad, num_groups=8)
    assert (got[S:] == -1).all() and (got[:S] >= 0).all()
    np.testing.assert_array_equal(ffd_demand_order(torch.ones(s_pad, 1)).numpy(),
                                  np.arange(s_pad))


def test_colocation_capacity_vectors_and_explicit_order():
    """Five integer-valued resources (gpu, gpu x vram, cpu, ram, storage),
    and a caller-given visit order."""
    rng = np.random.default_rng(11)
    P, T = 24, 40
    gpus = rng.choice([1, 2, 4, 8], P).astype(np.float32)
    capacity = np.stack([gpus, gpus * np.float32(80_000), rng.choice([8, 32], P),
                         rng.choice([65_536, 262_144], P), np.full(P, 1_000)], 1).astype(np.float32)
    g = rng.choice([1, 2], T).astype(np.float32)
    demand = np.stack([g, g * 40_000, rng.choice([0, 4], T), rng.choice([0, 16_384], T),
                       np.zeros(T)], 1).astype(np.float32)
    cost = rng.uniform(0.5, 4.0, (P, T)).astype(np.float32)
    cost[rng.uniform(size=(P, T)) > 0.6] = INFEASIBLE
    got = assert_same(cost, demand, capacity)
    assert (got >= 0).sum() > T // 2
    order = rng.permutation(T).astype(np.int32)
    assert_same(cost, demand, capacity, task_order=order)


@pytest.mark.parametrize("kind", BINPACK_KINDS)
def test_plain_matches_the_reference_on_k11_cases(kind):
    """K11's card cases at a small size: the plain step loop, the card's
    referee, against the reference, so that the kernel = the plain loop =
    the reference on each seam (a long visit order, one step, equal costs,
    -0.0 / +0.0, wide occupancy bitmasks on each side of the route's
    limit)."""
    cost, demand, capacity, order, anti, loc, L, G = binpack_case(kind, small=True)
    got = assert_same(cost, demand, capacity, task_order=order, anti_group=anti, loc_id=loc,
                      num_locations=L, num_groups=G)
    assert (got >= 0).any()


def test_k11_route_picks_by_shape():
    """K11's instantiation from the shapes alone: the matcher's calls on
    the card (colocation, phase 0, the wide phase-0 run), each side of the
    shared instantiation's limit, and the device one fitting every P."""
    from protocol_tpu_torch import kernels

    assert kernels.binpack_route(4096, 5, 4096, 1) == "shared"
    assert kernels.binpack_slots(4096, 5, 4096, 1, True) == 6
    assert kernels.binpack_route(2048, 1, 2048, 64) == "shared"
    assert kernels.binpack_route(2048, 1, 2048, 1024) == "device"
    assert kernels.binpack_route(65_536, 5, 65_536, 1) == "device"
    for P, R, G in ((1000, 1, 16), (3000, 5, 1), (60, 8, 4)):
        L = binpack_limit_L(P, R, G)
        assert kernels.binpack_route(P, R, L, G) == "shared"
        assert kernels.binpack_route(P, R, L + 1, G) == "device"
    for P in (1, 15_872, 15_873, 1_000_000):
        assert kernels.binpack_slots(P, 8, 1 << 20, 64, False) >= kernels.K11_MIN_SLOTS


@pytest.mark.parametrize("seed", [0, 1])
def test_ffd_order_matches_the_reference(seed):
    demand = np.random.default_rng(seed).integers(0, 4, (200, 5)).astype(np.float32)
    np.testing.assert_array_equal(ffd_demand_order(torch.from_numpy(demand)).numpy(),
                                  np.asarray(j_order(jnp.asarray(demand))))
    assert ffd_demand_order(torch.tensor([[1.0, 1], [5, 5], [3, 3]])).tolist() == [1, 2, 0]


def edge_markets():
    """The shapes K10's card tests use at their edges: one provider, one
    slot, 65 providers (a lane pair and one more), every cell infeasible."""
    yield "p1", encode_random(21, 1, 40)
    yield "t1", encode_random(22, 70, 1)
    yield "p65", (j_synth.synth_providers(np.random.default_rng(23), 65),
                  j_synth.synth_requirements(np.random.default_rng(24), 30))
    ep, er = encode_random(25, 50, 20)
    yield "infeasible", (ep, dataclasses.replace(er, valid=np.zeros_like(np.asarray(er.valid))))


@pytest.mark.parametrize("kind", ["synth", "encoded", "skew", "p1", "t1", "p65", "infeasible"])
@pytest.mark.parametrize("proximity", [0.0, 0.001])
def test_cost_only_matches_the_reference(kind, proximity):
    ep, er = {**dict(markets()), **dict(edge_markets())}[kind]
    tp, tr = to_port(ep, er)
    jw = JCostWeights(priority=1.0, proximity=proximity)
    got = cost_only(tp, tr, CostWeights(**dataclasses.asdict(jw))).numpy()
    ref = np.asarray(_cost_only(ep, er, jw))
    if proximity == 0.0:
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    else:
        np.testing.assert_array_equal(got >= INFEASIBLE * 0.5, ref >= INFEASIBLE * 0.5)
        np.testing.assert_allclose(got, ref, rtol=0, atol=COST_ATOL)
