"""The port's candidate passes with a jitter offset, its one-phase sparse
auction, and its ``CandidateCache`` held against the JAX reference on the
same inputs (``protocol_tpu/ops/sparse.py``, ``protocol_tpu/sched/
cand_cache.py``).

Candidate passes: bit-identical at proximity 0, costs within the
haversine tolerance (``COST_ATOL``) at default weights. The cache encodes
its tasks without a location, so its costs carry no haversine term: every
``PreparedSolve`` field and the jitter cursor must be identical, step by
step, along the scenarios of ``tests/test_cand_cache.py`` and a seeded
churn chain."""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protocol_tpu import models as jm
from protocol_tpu.ops.cost import INFEASIBLE
from protocol_tpu.ops.cost import CostWeights as JCostWeights
from protocol_tpu.ops.encoding import FeatureEncoder as JFeatureEncoder
from protocol_tpu.ops.sparse import assign_auction_sparse as j_assign_auction_sparse
from protocol_tpu.ops.sparse import assign_topk as j_assign_topk
from protocol_tpu.ops.sparse import candidates_topk as j_candidates_topk
from protocol_tpu.ops.sparse import candidates_topk_reverse as j_candidates_topk_reverse
from protocol_tpu.sched import cand_cache as jcc
from protocol_tpu_torch.models import node as tm
from protocol_tpu_torch.ops.cost import CostWeights
from protocol_tpu_torch.ops.encoding import FeatureEncoder
from protocol_tpu_torch.ops.sparse import (
    assign_auction_sparse,
    assign_topk,
    candidates_topk,
    candidates_topk_reverse,
)
from protocol_tpu_torch.sched import cand_cache as tcc

from tests.test_assign import random_cost
from tests.test_sparse import encode_random_marketplace
from tests.test_torch_candidates import bits, synth
from tests.test_torch_dense import MODELS, random_dsl
from tests.test_torch_encoding_cost import COST_ATOL, to_port

# ---------------------------------------------------------------- candidate passes

T_SYNTH = 64
OFFSETS = [0, 1, 1023, 65_536, 2**31 - T_SYNTH]


@pytest.mark.parametrize("offset", OFFSETS)
def test_candidates_topk_with_offset_bit_identical_without_proximity(offset):
    ep, er = synth(96, T_SYNTH)
    ref = j_candidates_topk(ep, er, JCostWeights(proximity=0.0), k=16, tile=16,
                            task_offset=offset)
    tp, tr = to_port(ep, er)
    got = candidates_topk(tp, tr, CostWeights(proximity=0.0), k=16, tile=16, task_offset=offset)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(bits(a.numpy()), bits(b))


@pytest.mark.parametrize("offset", OFFSETS)
def test_candidates_topk_reverse_with_offset_bit_identical_without_proximity(offset):
    ep, er = synth(80, T_SYNTH)
    w = JCostWeights(proximity=0.0)
    ref = j_candidates_topk_reverse(ep, er, w, k=8, tile=32, reverse_r=6, task_offset=offset,
                                    with_pools=True)
    tp, tr = to_port(ep, er)
    got = candidates_topk_reverse(tp, tr, CostWeights(proximity=0.0), k=8, tile=32, reverse_r=6,
                                  task_offset=offset, with_pools=True)
    for name, a, b in zip(("fwd_p", "fwd_c", "rev_t", "rev_c", "pool_t", "pool_c"), got, ref):
        np.testing.assert_array_equal(bits(a.numpy()), bits(b), err_msg=name)


@pytest.mark.parametrize("offset", OFFSETS)
def test_offset_costs_within_haversine_tolerance_at_default_weights(offset):
    ep, er = synth(96, T_SYNTH)
    ref = j_candidates_topk_reverse(ep, er, JCostWeights(), k=16, tile=16, reverse_r=8,
                                    task_offset=offset)
    tp, tr = to_port(ep, er)
    got = candidates_topk_reverse(tp, tr, CostWeights(), k=16, tile=16, reverse_r=8,
                                  task_offset=offset)
    for idx in (1, 3):  # fwd_c, rev_c
        np.testing.assert_allclose(got[idx].numpy(), np.asarray(ref[idx]), rtol=0, atol=COST_ATOL)


def test_offset_moves_the_jitter_not_the_rows():
    """A non-zero offset keys the jitter on shifted task ids: the selected
    costs change by jitter only (< 1024e-7), the feasible sets not at all."""
    ep, er = synth(96, T_SYNTH)
    tp, tr = to_port(ep, er)
    w = CostWeights(proximity=0.0)
    p0, c0 = candidates_topk(tp, tr, w, k=16, tile=16)
    p1, c1 = candidates_topk(tp, tr, w, k=16, tile=16, task_offset=12_345)
    assert not torch.equal(c0, c1)
    assert torch.equal(p0 >= 0, p1 >= 0)
    feas = p0 >= 0
    assert float((c0 - c1)[feas].abs().max()) < 1024e-7


def test_k_above_the_provider_count_is_clamped_like_the_reference():
    ep, er = synth(12, 16)
    ref = j_candidates_topk(ep, er, JCostWeights(proximity=0.0), k=64, tile=8, task_offset=7)
    tp, tr = to_port(ep, er)
    got = candidates_topk(tp, tr, CostWeights(proximity=0.0), k=64, tile=8, task_offset=7)
    assert got[0].shape == (16, 12)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(bits(a.numpy()), bits(b))


def test_tile_divisibility_enforced():
    ep, er = synth(8, 10)
    tp, tr = to_port(ep, er)
    with pytest.raises(ValueError, match="divisible"):
        j_candidates_topk(ep, er, k=4, tile=4)
    with pytest.raises(ValueError, match="divisible"):
        candidates_topk(tp, tr, k=4, tile=4)


def test_provider_offset_is_accepted_and_equals_the_reference():
    """Both candidate passes take a provider offset (a selection bias) and
    return the reference's bits at proximity 0; the reverse half ignores
    it, as the reference's does."""
    ep, er = synth(16, 16)
    tp, tr = to_port(ep, er)
    bias = np.random.default_rng(3).normal(0.0, 1.0, 16).astype(np.float32)
    w, jw = CostWeights(proximity=0.0), JCostWeights(proximity=0.0)
    for fn, j_fn in ((candidates_topk, j_candidates_topk),
                     (candidates_topk_reverse, j_candidates_topk_reverse)):
        got = fn(tp, tr, w, k=4, tile=8, provider_offset=torch.from_numpy(bias))
        ref = j_fn(ep, er, jw, k=4, tile=8, provider_offset=jnp.asarray(bias))
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(bits(a.numpy()), bits(b))


@pytest.mark.parametrize("offset", [2**31, 2**32 - 1, -(2**31) - 1])
def test_an_offset_beyond_int32_is_refused_like_the_reference(offset):
    ep, er = synth(16, 16)
    tp, tr = to_port(ep, er)
    with pytest.raises(OverflowError):
        j_candidates_topk(ep, er, k=4, tile=8, task_offset=offset)
    for fn in (candidates_topk, candidates_topk_reverse):
        with pytest.raises(OverflowError):
            fn(tp, tr, k=4, tile=8, task_offset=offset)


def test_a_negative_offset_wraps_like_the_reference():
    ep, er = synth(32, 16)
    w = JCostWeights(proximity=0.0)
    ref = j_candidates_topk_reverse(ep, er, w, k=8, tile=8, reverse_r=4, task_offset=-5)
    tp, tr = to_port(ep, er)
    got = candidates_topk_reverse(tp, tr, CostWeights(proximity=0.0), k=8, tile=8, reverse_r=4,
                                  task_offset=-5)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(bits(a.numpy()), bits(b))


# ---------------------------------------------------------------- one-phase auction
# (the cases of tests/test_sparse.py::TestSparseAuction and TestEndToEndTopk)


def full_lists(cost: np.ndarray, k: int | None = None):
    order = np.argsort(cost, axis=0, kind="stable").T[:, :k]  # [T, k]
    cand_c = np.take_along_axis(cost.T, order, axis=1).astype(np.float32)
    cand_p = np.where(cand_c < INFEASIBLE * 0.5, order.astype(np.int32), -1)
    return cand_p, cand_c


def assert_same_result(got, ref):
    np.testing.assert_array_equal(got.provider_for_task.numpy(), np.asarray(ref.provider_for_task))
    np.testing.assert_array_equal(got.task_for_provider.numpy(), np.asarray(ref.task_for_provider))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assign_auction_sparse_full_k_like_the_reference(seed):
    rng = np.random.default_rng(seed)
    cost = random_cost(rng, 32, 32, p_infeasible=0.2)
    cand_p, cand_c = full_lists(cost)
    kw = dict(num_providers=32, eps=0.05, max_iters=5000, frontier=32, retire=False)
    ref = j_assign_auction_sparse(jnp.asarray(cand_p), jnp.asarray(cand_c), **kw)
    got = assign_auction_sparse(torch.from_numpy(cand_p), torch.from_numpy(cand_c), **kw)
    assert_same_result(got, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_assign_auction_sparse_restricted_like_the_reference(seed):
    rng = np.random.default_rng(seed)
    cost = rng.uniform(0.0, 10.0, size=(64, 64)).astype(np.float32)
    order = np.argsort(cost, axis=0, kind="stable").T[:, :16]
    cand_c = np.take_along_axis(cost.T, order, axis=1).astype(np.float32)
    cand_p = order.astype(np.int32)
    kw = dict(num_providers=64, eps=0.01, max_iters=5000, frontier=16)
    ref = j_assign_auction_sparse(jnp.asarray(cand_p), jnp.asarray(cand_c), **kw)
    got = assign_auction_sparse(torch.from_numpy(cand_p), torch.from_numpy(cand_c), **kw)
    assert_same_result(got, ref)
    assert int((got.provider_for_task >= 0).sum()) >= 62


def test_assign_topk_identical_providers_like_the_reference():
    specs = [jm.ComputeSpecs(gpu=jm.GpuSpecs(count=8, model="H100", memory_mb=80000),
                             cpu=jm.CpuSpecs(cores=32), ram_mb=65536, storage_gb=1000)] * 16
    enc = JFeatureEncoder()
    ep = enc.encode_providers(specs)
    er = enc.encode_requirements([jm.ComputeRequirements.parse("gpu:count=8;gpu:model=H100")] * 8)
    ref = j_assign_topk(ep, er, k=4, tile=8, eps=0.01)
    got = assign_topk(*to_port(ep, er), k=4, tile=8, eps=0.01)
    assert_same_result(got, ref)
    assert int((got.provider_for_task >= 0).sum()) == 8


def test_assign_topk_pipeline_like_the_reference():
    ep, er = encode_random_marketplace(3, 48, 32)
    ref = j_assign_topk(ep, er, k=8, tile=8, eps=0.05, max_iters=3000)
    got = assign_topk(*to_port(ep, er), k=8, tile=8, eps=0.05, max_iters=3000)
    assert_same_result(got, ref)
    assert int((got.provider_for_task >= 0).sum()) > 0


# ---------------------------------------------------------------- the candidate cache

W = dict(priority=1.0)


class Side:
    """One package's models, items and cache, built from the same calls."""

    def __init__(self, ref: bool, **cache_kw):
        self.ref = ref
        self.m = jm if ref else tm
        self.cc = jcc if ref else tcc
        enc = JFeatureEncoder() if ref else FeatureEncoder()
        weights = (JCostWeights if ref else CostWeights)(**W)
        extra = {} if ref else {"device": "cpu"}
        self.cache = self.cc.CandidateCache(enc, weights, **cache_kw, **extra)

    def specs(self, model="H100", count=8, cores=32, ram=65536, storage=1000):
        m = self.m
        return m.ComputeSpecs(gpu=m.GpuSpecs(count=count, model=model, memory_mb=80000),
                              cpu=m.CpuSpecs(cores=cores), ram_mb=ram, storage_gb=storage)

    def p(self, addr, model="H100", price=0.0, loc=None, load=0.0, **spec_kw):
        where = self.m.NodeLocation(*loc) if loc else None
        return self.cc.ProviderItem(addr=addr, specs=self.specs(model, **spec_kw), location=where,
                                    price=price, load=load)

    def t(self, tid, take, req="", prio=0.0):
        r = self.m.ComputeRequirements.parse(req) if req else self.m.ComputeRequirements()
        return self.cc.TaskItem(task_id=tid, requirement=r, take=take, prio=prio)


def column(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.astype(np.uint8) if a.dtype == bool else a


def assert_same_prepared(got, ref, label):
    for f in dataclasses.fields(ref.ep):
        a, b = column(getattr(got.ep, f.name)), column(getattr(ref.ep, f.name))
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=f"{label}: ep.{f.name}")
    for name in ("cand_p", "cand_c", "price0"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype, (label, name)
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=f"{label}: {name}")
    for name in ("row_of_addr", "addr_of_row", "num_rows", "p_bucket", "num_slots", "rebuilt",
                 "delta_tasks", "delta_rows", "uncovered_rows", "stale_frac"):
        assert getattr(got, name) == getattr(ref, name), (label, name)
    if ref.dirty_slots is None:
        assert got.dirty_slots is None, label
    else:
        np.testing.assert_array_equal(got.dirty_slots, ref.dirty_slots, err_msg=label)


def run_both(steps, **cache_kw):
    """Run ``steps(side)`` on both packages: a generator that yields
    (providers, tasks) per prepare, or ("prices", fn) to call
    ``store_prices(fn(prepared))``. Every prepare's fields and the jitter
    cursor must agree. Returns the reference side and its PreparedSolves."""
    sides = [Side(True, **cache_kw), Side(False, **cache_kw)]
    gens = [steps(s) for s in sides]
    preps: list = [None, None]
    out = []
    for step, (a, b) in enumerate(zip(*gens)):
        if a[0] == "prices":
            for s, item, prep in zip(sides, (a, b), preps):
                s.cache.store_prices(item[1](prep))
            continue
        preps = [s.cache.prepare(*item) for s, item in zip(sides, (a, b))]
        assert_same_prepared(preps[1], preps[0], f"step {step}")
        assert sides[1].cache._jitter_cursor == sides[0].cache._jitter_cursor, step
        np.testing.assert_array_equal(bits(sides[1].cache.prices), bits(sides[0].cache.prices))
        out.append(preps[0])
    return sides[0], out


def sc_rows_stable(s):
    provs = [s.p(f"0x{i}") for i in range(6)]
    yield provs, [s.t("t1", 4)]
    yield provs, [s.t("t1", 4)]


def sc_departure(s):
    provs = [s.p(f"0x{i}") for i in range(6)]
    yield provs, [s.t("t1", 4)]
    yield provs[1:], [s.t("t1", 4)]


def sc_spec_change(s):
    provs = [s.p(f"0x{i}") for i in range(4)]
    yield provs, [s.t("t1", 2, "gpu:model=H100")]
    yield [s.p("0x0", model="RTX4090")] + provs[1:], [s.t("t1", 2, "gpu:model=H100")]


def sc_compaction(s):
    provs = [s.p(f"0x{i}") for i in range(8)]
    yield provs, [s.t("t1", 4)]
    yield provs[:4], [s.t("t1", 4)]  # 50% departed > 25%


def sc_new_cheap_provider(s):
    provs = [s.p(f"0x{i}", price=10.0) for i in range(6)]
    yield provs, [s.t("t1", 3)]
    yield provs + [s.p("0xcheap", price=0.5)], [s.t("t1", 3)]


def sc_new_task(s):
    provs = [s.p(f"0x{i}") for i in range(6)]
    yield provs, [s.t("t1", 2)]
    yield provs, [s.t("t1", 2), s.t("t2", 3)]


def sc_replica_growth(s):
    provs = [s.p(f"0x{i}") for i in range(6)]
    yield provs, [s.t("t1", 2)]
    yield provs, [s.t("t1", 5)]


def sc_requirement_change(s):
    provs = [s.p(f"0x{i}") for i in range(6)]
    yield provs, [s.t("t1", 2)]
    yield provs, [s.t("t1", 2, "gpu:model=H100")]


def sc_vocab_growth(s):
    provs = [s.p(f"0x{i}") for i in range(4)]
    yield provs, [s.t("t1", 2, "gpu:model=A100")]
    yield provs + [s.p("0xa100", model="A100")], [s.t("t1", 2, "gpu:model=A100")]


def sc_price_drift(s):
    yield [s.p("0xa", price=1.0), s.p("0xb", price=2.0)], [s.t("t1", 1)]
    yield [s.p("0xa", price=5.0), s.p("0xb", price=2.0)], [s.t("t1", 1)]


def sc_prices_survive(s):
    provs = [s.p(f"0x{i}") for i in range(4)]
    yield provs, [s.t("t1", 2)]

    def prices(prep):
        price = np.zeros(prep.p_bucket, np.float32)
        price[prep.row_of_addr["0x1"]] = 3.5
        return price

    yield "prices", prices
    yield provs + [s.p("0xnew")], [s.t("t1", 2)]


def sc_priced_out(s):
    yield [s.p(f"0x{i}", price=float(i)) for i in range(8)], [s.t(f"t{i}", 1) for i in range(8)]


def sc_full_coverage(s):
    yield [s.p(f"0x{i}", price=float(i)) for i in range(6)], [s.t("t0", 2)]


def sc_repair_priority(s):
    yield [s.p("0xcheap", price=0.0), s.p("0xdear", price=5.0)], [s.t("t0", 1, prio=2.0)]


def sc_coverage_under_churn(s):
    provs = [s.p(f"0x{i}", price=float(i)) for i in range(8)]
    tasks = [s.t(f"t{i}", 1) for i in range(8)]
    yield provs, tasks
    yield provs[1:] + [s.p("0xnew", price=9.0)], tasks


def sc_uniform_inflation(s):
    yield [s.p(f"0x{i}", price=float(p)) for i, p in enumerate([1, 2, 3, 4, 5, 6])], [s.t("t0", 1)]
    yield ([s.p(f"0x{i}", price=float(p)) for i, p in enumerate([101, 102, 103, 104, 105, 106])],
           [s.t("t0", 1)])


def sc_reranking_drift(s):
    yield [s.p(f"0x{i}", price=float(p)) for i, p in enumerate([1, 2, 3, 4, 5, 6])], [s.t("t0", 1)]
    yield ([s.p(f"0x{i}", price=float(p)) for i, p in enumerate([50, 60, 3, 4, 5, 0.5])],
           [s.t("t0", 1)])


def sc_dirty_first(s):
    yield [s.p("a"), s.p("b")], [s.t("t", 2)]


def sc_dirty_unchanged(s):
    provs, tasks = [s.p("a"), s.p("b")], [s.t("t", 2)]
    yield provs, tasks
    yield provs, tasks


def sc_dirty_new_provider(s):
    yield [s.p("a"), s.p("b")], [s.t("t", 2)]
    yield [s.p("a"), s.p("b"), s.p("c")], [s.t("t", 2)]


def sc_dirty_departure(s):
    fleet = [s.p(f"p{i}") for i in range(8)]
    yield fleet, [s.t("t", 2)]
    yield fleet[:-1], [s.t("t", 2)]


def sc_churn_chain(s, seed=17, steps=7):
    """A seeded chain over a mixed fleet (12 located sites, four models,
    varied capacity, prices and loads): joins, departures, spec changes,
    price and load drift, tasks added, dropped, regrown and re-required,
    and at step 4 a reprice that re-ranks a quarter of the fleet."""
    rng = random.Random(seed)
    sites = [(rng.uniform(-60, 60), rng.uniform(-170, 170)) for _ in range(12)]

    def node(i, gen=0):
        r = random.Random(seed * 1000 + i * 7 + gen)
        return s.p(f"0xn{i:03d}", model=r.choice(MODELS[:4]), price=round(r.uniform(0.5, 4), 3),
                   loc=r.choice(sites) if i % 3 else None, load=round(r.random(), 3),
                   count=r.choice([1, 2, 4, 8]), cores=r.choice([8, 32, 64]),
                   ram=r.choice([32768, 65536]), storage=r.choice([500, 2000]))

    fleet = {i: node(i) for i in range(40)}
    reqs = {f"t{j}": random_dsl(rng) for j in range(9)}
    takes = {tid: rng.randint(1, 6) for tid in reqs}
    nxt = 40
    for step in range(steps):
        if step:
            for i in rng.sample(sorted(fleet), 5):  # drift under the stale tolerance
                it = fleet[i]
                it.price = round(it.price * rng.uniform(0.95, 1.05), 4)
                it.load = round(min(1.0, max(0.0, it.load + rng.uniform(-0.05, 0.05))), 3)
            if step == 4:  # a re-ranking reprice: the adaptive re-ground
                for i in rng.sample(sorted(fleet), 10):
                    fleet[i].price = round(rng.uniform(0.5, 4), 3)
            for _ in range(rng.randint(1, 3)):  # joins
                fleet[nxt] = node(nxt)
                nxt += 1
            for i in rng.sample(sorted(fleet), rng.randint(0, 2)):  # departures
                del fleet[i]
            for i in rng.sample(sorted(fleet), 1):  # a spec change
                fleet[i] = node(i, gen=step)
            if step % 2:
                tid = rng.choice(sorted(reqs))
                del reqs[tid]
                reqs[f"n{step}"] = random_dsl(rng)
                takes[f"n{step}"] = rng.randint(1, 6)
            if step % 3 == 0:
                takes[rng.choice(sorted(reqs))] = rng.randint(1, 6)
                reqs[rng.choice(sorted(reqs))] = random_dsl(rng)
        tasks = [s.t(tid, takes[tid], reqs[tid], prio=takes[tid] / 7) for tid in sorted(reqs)]
        yield [fleet[i] for i in sorted(fleet)], tasks


CACHE_SCENARIOS = {
    # TestProviderRegistry
    "rows_stable": (sc_rows_stable, {}),
    "departure": (sc_departure, {}),
    "spec_change": (sc_spec_change, {}),
    "compaction": (sc_compaction, {"max_invalid_frac": 0.25}),
    # TestCandidateMaintenance
    "new_cheap_provider": (sc_new_cheap_provider, {"k": 4}),
    "new_task": (sc_new_task, {}),
    "replica_growth": (sc_replica_growth, {}),
    "requirement_change": (sc_requirement_change, {}),
    "vocab_growth": (sc_vocab_growth, {}),
    "price_drift": (sc_price_drift, {"max_stale_frac": None}),
    # TestPrices
    "prices_survive": (sc_prices_survive, {}),
    # TestCoverageRepair
    "priced_out": (sc_priced_out, {"k": 2, "reverse_r": 4, "extra": 4}),
    "full_coverage": (sc_full_coverage, {"k": 8, "reverse_r": 4, "extra": 4}),
    "repair_priority": (sc_repair_priority, {"k": 1, "reverse_r": 2, "extra": 2}),
    "coverage_under_churn": (sc_coverage_under_churn, {"k": 2, "reverse_r": 4, "extra": 4}),
    # TestAdaptiveReGround
    "uniform_inflation": (sc_uniform_inflation, {"k": 2, "max_stale_frac": 0.10}),
    "reranking_drift": (sc_reranking_drift, {"k": 2, "max_stale_frac": 0.10}),
    "frozen_selection": (sc_reranking_drift, {"k": 2, "max_stale_frac": None}),
    # TestDirtySlots
    "dirty_first": (sc_dirty_first, {}),
    "dirty_unchanged": (sc_dirty_unchanged, {}),
    "dirty_new_provider": (sc_dirty_new_provider, {}),
    "dirty_departure": (sc_dirty_departure, {}),
    # a longer seeded chain
    "churn_chain": (sc_churn_chain, {"k": 6, "reverse_r": 4, "extra": 4}),
    "churn_chain_wide": (sc_churn_chain, {"k": 64}),
}


def run_scenario(name):
    steps, kw = CACHE_SCENARIOS[name]
    return run_both(steps, **kw)


@pytest.mark.parametrize("scenario", list(CACHE_SCENARIOS))
def test_cache_equals_the_reference(scenario):
    _, preps = run_scenario(scenario)
    assert preps[0].rebuilt


def test_cache_scenarios_show_what_they_cover():
    """The properties the reference's tests assert, read off the shared
    runs (so a scenario that drifts from its purpose fails here)."""
    _, p = run_scenario("compaction")
    assert p[1].rebuilt and p[1].num_rows == 4
    side, p = run_scenario("new_cheap_provider")
    row = p[1].row_of_addr["0xcheap"]
    assert p[1].delta_rows == 1 and (p[1].cand_p[: p[1].num_slots, 0] == row).all()
    _, p = run_scenario("priced_out")
    assert p[0].uncovered_rows == 6 and p[0].cand_p.shape[1] == 6
    _, p = run_scenario("reranking_drift")
    assert p[1].rebuilt and p[1].stale_frac > 0.10
    _, p = run_scenario("uniform_inflation")
    assert not p[1].rebuilt and p[1].stale_frac == 0.0
    _, p = run_scenario("dirty_departure")
    assert not p[1].rebuilt and p[1].dirty_slots[: p[1].num_slots].all()
    side, p = run_scenario("churn_chain")
    assert sum(x.delta_rows for x in p[1:]) > 0 and sum(x.delta_tasks for x in p[1:]) > 0
    assert any(x.uncovered_rows for x in p) and side.cache._jitter_cursor > 2 * p[0].cand_p.shape[0]
    assert [x.rebuilt for x in p] == [True, False, False, False, True, False, False]


def test_cache_prices_survive_churn():
    _, p = run_scenario("prices_survive")
    assert p[1].price0[p[1].row_of_addr["0x1"]] == 3.5
    assert p[1].price0[p[1].row_of_addr["0xnew"]] == 0.0


def test_cursor_overflow_is_refused_like_the_reference():
    """A cursor at 2^31 no longer fits the jitter's int32 task key: both
    caches refuse the next delta pass rather than wrap silently."""
    for ref in (True, False):
        s = Side(ref)
        provs = [s.p(f"0x{i}") for i in range(6)]
        s.cache.prepare(provs, [s.t("t1", 2)])
        s.cache._jitter_cursor = 2**31
        with pytest.raises(OverflowError):
            s.cache.prepare(provs, [s.t("t1", 2), s.t("t2", 3)])


def test_cache_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card rule cannot be exercised")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcc.CandidateCache(FeatureEncoder(), CostWeights())
