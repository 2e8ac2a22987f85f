"""The port's hand kernels against their plain torch versions on the card
(``python -m pytest --noconftest tests/test_torch_kernels_cuda.py`` on a
machine with an NVIDIA Hopper card and nvcc; the repo's conftest sets up
JAX, which this file does not need). Without a card every test skips with
its reason; the CPU tests hold the plain versions against the reference."""

import numpy as np
import pytest
import torch

from protocol_tpu_torch.ops import sparse as sp
from protocol_tpu_torch.ops.cost import CostWeights
from protocol_tpu_torch.parallel.torch_arena import TorchSolveArena
from protocol_tpu_torch.trace.synth import synth_providers, synth_requirements

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from protocol_tpu_torch import kernels

    kernels.build()
    return "cuda"


def same_bits(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.parametrize("P,T", [(3000, 2000), (1024, 4096)])
def test_candidate_kernel_matches_plain_bits(card, P, T):
    ep = synth_providers(np.random.default_rng(5), P, device=card)
    er = synth_requirements(np.random.default_rng(6), T, device=card)
    tile = sp.pick_tile(T, cap=min(1024, max(1, T // 8)))
    w = CostWeights(proximity=0.0)
    got = (*sp.candidates_forward(ep, er, w, 64, tile), *sp.candidates_reverse(ep, er, w, tile, 8, 1))
    ref = (*sp._forward_plain(ep, er, w, 64, tile), *sp._reverse_plain(ep, er, w, tile, 8, 1))
    assert all(same_bits(a, b) for a, b in zip(got, ref))


def test_auction_kernel_matches_plain_bits(card):
    n = 4096
    ep = synth_providers(np.random.default_rng(2), n, device=card)
    er = synth_requirements(np.random.default_rng(3), n, device=card)
    cp, cc = sp.candidates_topk_bidir(ep, er, CostWeights(), k=64, tile=512)
    inputs = sp._phase_inputs(cp, cc, True)
    state = sp._initial_state(n, n, card)
    from protocol_tpu_torch import kernels

    for eps, B in ((4.0, 4096), (0.02, 512)):
        got, g_stall = kernels.auction_phase(*inputs, state, P=n, eps=eps, max_iters=256, B=B,
                                             stall_limit=0)
        ref, r_stall = sp._auction_rounds_plain(*inputs, state, n, eps, 256, B, 0)
        assert all(same_bits(a.to(b.dtype), b) for a, b in zip(got, ref))
        assert int(g_stall) == int(r_stall)
        state = got


def test_card_cold_tick_matches_cpu(card):
    ep = synth_providers(np.random.default_rng(7), 1024, device="cpu")
    er = synth_requirements(np.random.default_rng(8), 1024, device="cpu")
    a_gpu, a_cpu = TorchSolveArena(device=card), TorchSolveArena(device="cpu")
    np.testing.assert_array_equal(
        a_gpu.solve(ep, er, CostWeights(proximity=0.0)),
        a_cpu.solve(ep, er, CostWeights(proximity=0.0)),
    )
    np.testing.assert_array_equal(a_gpu.price, a_cpu.price)


def churned_parts(card, weights, P=3000, T=2048, tile=256):
    """A cold pass's parts on the card under ``weights``, then 1% provider
    and requirement churn: (churned columns, parts, dirty_p, dirty_t)."""
    from protocol_tpu_torch.ops.encoding import providers_from_numpy, requirements_from_numpy
    from protocol_tpu_torch.trace.synth import synth_provider_arrays, synth_requirement_arrays

    pa = synth_provider_arrays(np.random.default_rng(5), P)
    ra = synth_requirement_arrays(np.random.default_rng(6), T)
    ep, er = providers_from_numpy(pa, card), requirements_from_numpy(ra, card)
    fp, fc, _, _, pt, pc = sp.candidates_topk_reverse(ep, er, weights, k=64, tile=tile,
                                                      reverse_r=8, with_pools=True)
    rng = np.random.default_rng(7)
    dirty_p = np.sort(rng.choice(P, P // 100, replace=False))
    dirty_t = np.sort(rng.choice(T, T // 100, replace=False))
    pa["price"][dirty_p] = rng.uniform(0.5, 4.0, dirty_p.size).astype(np.float32)
    ra["ram_mb"][dirty_t] = 256
    ep, er = providers_from_numpy(pa, card), requirements_from_numpy(ra, card)
    return ep, er, (fp, fc, pt, pc), dirty_p, dirty_t


def test_repair_kernels_match_plain_bits(card):
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.parallel import sparse as ps

    w, tile = CostWeights(proximity=0.0), 256
    ep, er, (fp, fc, pt, pc), dirty_p, dirty_t = churned_parts(card, w, tile=tile)
    p_ids = torch.from_numpy(dirty_p).to(card)
    t_ids = torch.from_numpy(dirty_t).to(card)
    thresh = fc[:, -1].contiguous()
    assert same_bits(kernels.repair_enter(ep, er, w, p_ids, thresh),
                     ps._enter_plain(ep, er, w, p_ids, thresh))
    rows = torch.arange(0, er.num, 7, device=card).flip(0)
    plain = ps._forward_rows_plain(ep, er, w, 64, rows)
    for lanes in (None, 1, 4, 32):  # None: 32 lanes for these 293 rows
        got = kernels.candidates_forward_rows(ep, er, w, 64, rows, lanes=lanes)
        assert all(same_bits(a, b) for a, b in zip(got, plain)), lanes
    assert same_bits(kernels.repair_tile_min(ep, er, w, t_ids, tile, ps._PAD_COST),
                     ps._tile_min_plain(ep, er, w, t_ids, tile, ps._PAD_COST))
    gen = torch.Generator(device=card).manual_seed(0)
    pick = torch.rand(ep.num, er.num // tile, device=card, generator=gen) < 0.05
    blk_j, blk_p = torch.nonzero(pick.T, as_tuple=True)
    got = (pt.clone(), pc.clone())
    ref = (pt.clone(), pc.clone())
    kernels.candidates_reverse_blocks(ep, er, w, tile, blk_p, blk_j, *got)
    ps._reverse_blocks_plain(ep, er, w, tile, 1, blk_p, blk_j, *ref)
    assert all(same_bits(a, b) for a, b in zip(got, ref))
    assert all(same_bits(a, b) for a, b in zip(kernels.repair_refold(pt, pc, 8),
                                                ps._refold_plain(pt, pc, 8, 1)))


def test_card_repair_equals_card_regen(card):
    """repaired == regen on the card, bit for bit, at default weights: the
    repair kernels and K1 score every cell with the same device function."""
    from protocol_tpu_torch.parallel import sparse as ps

    w, tile = CostWeights(), 256
    ep, er, (fp, fc, pt, pc), dirty_p, dirty_t = churned_parts(card, w, tile=tile)
    got = ps.repair_topk_bidir(ep, er, w, fwd_p=fp, fwd_c=fc, pool_t=pt, pool_c=pc,
                               dirty_p=dirty_p, dirty_t=dirty_t, tile=tile)
    f2p, f2c, r2t, r2c, p2t, p2c = sp.candidates_topk_reverse(ep, er, w, k=64, tile=tile,
                                                              reverse_r=8, with_pools=True)
    m2p, m2c = sp.merge_reverse_candidates(f2p, f2c, r2t, r2c, extra=16)
    assert all(same_bits(a, b) for a, b in zip(got[:6], (m2p, m2c, f2p, f2c, p2t, p2c)))
    assert got[6]["repair_enter_rows"] > 0 and got[6]["repair_blocks"] > 0


def test_card_warm_chain_matches_cpu(card):
    """A short warm chain (provider churn, requirement churn, an event) on
    the card equals the CPU's, tick for tick, at proximity 0."""
    import dataclasses

    from protocol_tpu_torch.native.arena import _P_SPEC, _canon

    ep = synth_providers(np.random.default_rng(7), 1024, device="cpu")
    er = synth_requirements(np.random.default_rng(8), 1024, device="cpu")
    w = CostWeights(proximity=0.0)
    a_gpu, a_cpu = TorchSolveArena(device=card), TorchSolveArena(device="cpu")
    for a in (a_gpu, a_cpu):
        a.solve(ep, er, w)
    price = ep.price.clone()
    price[:10] += 0.5
    ep1 = dataclasses.replace(ep, price=price)
    ram = er.ram_mb.clone()
    ram[100:110] = 256
    er1 = dataclasses.replace(er, ram_mb=ram)
    pf = _canon(ep1, _P_SPEC)
    rows = np.array([3, 900], np.int32)
    vals = {n: pf[n][rows].copy() for n in pf}
    vals["price"] += np.float32(0.75)
    steps = [
        lambda a: a.solve(ep1, er, w),
        lambda a: a.solve(ep1, er1, w),
        lambda a: a.apply_rows(rows, vals, None, None, w),
    ]
    for step in steps:
        outs = [step(a) for a in (a_gpu, a_cpu)]
        assert a_gpu.last_stats["cand_cold_passes"] == 0
        np.testing.assert_array_equal(*outs)
        np.testing.assert_array_equal(a_gpu.price, a_cpu.price)
        for name in ("cand_p", "cand_c", "fwd_p", "fwd_c", "pool_t", "pool_c"):
            np.testing.assert_array_equal(getattr(a_gpu, f"_{name}"), getattr(a_cpu, f"_{name}"))


@pytest.mark.parametrize("proximity", [0.0, 0.001])
def test_dense_kernels_match_plain_bits(card, proximity):
    """K6 against cost_matrix + with_tie_jitter, K7 (fed K6's output)
    against the plain auction loop, K8 against cost_matrix + argmin: the
    same bits, rounds and work counters, at proximity 0 and at default
    weights (torch's CUDA sin/cos/asin are the kernels')."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops import assign as da
    from protocol_tpu_torch.ops.cost import cost_matrix, with_tie_jitter
    from protocol_tpu_torch.sched import torch_backend as tb

    ep = synth_providers(np.random.default_rng(11), 1000, device=card)
    er = synth_requirements(np.random.default_rng(12), 700, device=card)
    w = CostWeights(priority=1.0, proximity=proximity)
    vb, feas = kernels.dense_value_base(ep, er, w)
    cost, _ = cost_matrix(ep, er, w)
    pvb, pfeas = da._value_base(with_tie_jitter(cost))
    assert same_bits(vb, pvb) and torch.equal(feas, pfeas)
    work: dict = {}
    got = kernels.dense_auction(vb, feas, 0.05, 300, work)
    p4t, t4p, price, rounds, open_rows = da._auction_dense_plain(vb, feas, 0.05, 300)
    assert all(same_bits(a, b) for a, b in zip(got[:3], (p4t, t4p, price)))
    assert int(got[3]) == int(rounds) and int(work["open_rows"]) == open_rows
    cut = kernels.dense_auction(vb, feas, 0.05, 3)  # cut at max_iters
    ref = da._auction_dense_plain(vb, feas, 0.05, 3)
    assert all(same_bits(a, b) for a, b in zip(cut[:3], ref[:3])) and int(cut[3]) == 3
    assert same_bits(kernels.unbounded_best(ep, er, w), tb._solve_unbounded_plain(ep, er, w))


def test_greedy_cleanup_kernel_matches_plain_bits(card):
    """K9 on the state an auction cut after a few rounds leaves (many open
    tasks contending for the same free providers)."""
    from protocol_tpu_torch import kernels

    n = 3000
    ep = synth_providers(np.random.default_rng(2), n, device=card)
    er = synth_requirements(np.random.default_rng(3), n, device=card)
    cp, cc = sp.candidates_topk_bidir(ep, er, CostWeights(), k=64, tile=250)
    state, _ = sp._sparse_auction_phase(cp, cc, n, None, eps=4.0, max_iters=2, frontier=4096,
                                        retire=True, stall_limit=0)
    _, _, owner, p4t, _ = state
    open_idx = torch.nonzero(p4t < 0).flatten()
    assert open_idx.numel() >= 1000
    got = kernels.greedy_cleanup(cp, cc, owner, p4t, open_idx)
    ref = sp._greedy_cleanup_plain(cp, cc, owner, p4t, open_idx)
    assert same_bits(got, ref.to(torch.int32))


@pytest.mark.parametrize("offset", [123_456_789, 2**31 - 1, -5])
@pytest.mark.parametrize("tile", [256, 1024])
def test_candidate_kernel_with_a_jitter_offset_matches_plain_bits(card, offset, tile):
    """K1's forward and reverse launches with the jitter keyed on (task id
    + offset) mod 2^32, as the candidate cache's delta passes launch them;
    at 1,024-task tiles the reverse takes several tasks per tile."""
    from protocol_tpu_torch import kernels

    ep = synth_providers(np.random.default_rng(25), 3000, device=card)
    er = synth_requirements(np.random.default_rng(26), 2048, device=card)
    w = CostWeights(proximity=0.0)
    rt = -(-8 // (2048 // tile))
    before = dict(kernels.LAUNCHES)
    got = (*sp.candidates_forward(ep, er, w, 64, tile, task_offset=offset),
           *sp.candidates_reverse(ep, er, w, tile, 8, rt, task_offset=offset))
    assert kernels.LAUNCHES["candidates_forward_rows"] == before["candidates_forward_rows"] + 1
    assert kernels.LAUNCHES["candidates_reverse"] == before["candidates_reverse"] + 1
    ref = (*sp._forward_plain(ep, er, w, 64, tile, task_offset=offset),
           *sp._reverse_plain(ep, er, w, tile, 8, rt, task_offset=offset))
    assert all(same_bits(a, b) for a, b in zip(got, ref))
    plain0 = sp._forward_plain(ep, er, w, 64, tile)
    assert not same_bits(got[1], plain0[1])  # the offset moved the jitter


def test_card_cached_route_matches_cpu(card):
    """The default route above dense_cell_budget (the candidate cache, K1
    at the cache's cursor, K2, K9) on the card equals the CPU's along a
    cold, a churned and a task-replaced refresh, with its prepared lists."""
    import random

    from protocol_tpu_torch.models.node import ComputeSpecs, CpuSpecs, GpuSpecs
    from protocol_tpu_torch.models.task import SchedulingConfig, Task
    from protocol_tpu_torch.sched.torch_backend import TorchBatchMatcher
    from protocol_tpu_torch.store.node_store import NodeStatus, OrchestratorNode

    rng = random.Random(3)
    models = ["H100", "A100", "L40S", "RTX 4090"]

    def node(i):
        return OrchestratorNode(
            address=f"0x{i:04d}", status=NodeStatus.HEALTHY, price=rng.uniform(0.5, 4),
            compute_specs=ComputeSpecs(gpu=GpuSpecs(count=rng.choice([1, 2, 4, 8]),
                                                    model=rng.choice(models), memory_mb=80000),
                                       cpu=CpuSpecs(cores=32), ram_mb=65536, storage_gb=1000))

    def task(j):
        return Task(name=f"b{j}", created_at=j, scheduling_config=SchedulingConfig(plugins={
            "tpu_scheduler": {"replicas": [str(rng.randint(1, 30))], "compute_requirements": [
                f"gpu:count={rng.choice([1, 2, 4, 8])};gpu:model={rng.choice(models)}"]}}))

    nodes = [node(i) for i in range(300)]
    tasks = {t.id: t for t in [task(j) for j in range(20)] + [Task(name="swarm", created_at=0)]}
    store = type("S", (), {})()
    store.node_store = type("N", (), {"get_nodes": lambda s: list(nodes)})()
    store.task_store = type("T", (), {"get_all_tasks": lambda s: list(tasks.values()),
                                      "get_task": lambda s, i: tasks[i]})()
    w = CostWeights(priority=1.0, proximity=0.0)
    pair = [TorchBatchMatcher(store, weights=w, dense_cell_budget=0, top_k=16, device=d)
            for d in (card, "cpu")]
    prepared = {id(m): [] for m in pair}
    for m in pair:
        orig = m._cache.prepare
        m._cache.prepare = lambda *a, _o=orig, _k=id(m): prepared[_k].append(_o(*a)) or \
            prepared[_k][-1]
    for step in range(3):
        if step == 1:
            nodes[:3] = []
            nodes.extend(node(1000 + i) for i in range(4))
            for n in rng.sample(nodes, 6):
                n.price *= 1.02
        elif step == 2:
            old = next(iter(tasks))
            del tasks[old]
            t = task(99)
            tasks[t.id] = t
        for m in pair:
            m.refresh()
        a, b = pair
        assert a.last_solve_stats["kernel"] == "sparse_topk"
        assert a._assignment == b._assignment, step
        pa, pb = prepared[id(a)][-1], prepared[id(b)][-1]
        assert np.array_equal(pa.cand_p, pb.cand_p) and np.array_equal(
            pa.cand_c.view(np.uint32), pb.cand_c.view(np.uint32)), step
    assert pair[0].last_solve_stats["warm"] and pair[0]._cache._jitter_cursor > 0


def test_card_matcher_matches_cpu(card):
    """TorchBatchMatcher on the card (K6, K7, K8) equals the CPU's on a
    mixed pool, on the dense route and on the torch route (K9 in it)."""
    import random

    from protocol_tpu_torch.models.node import ComputeSpecs, CpuSpecs, GpuSpecs
    from protocol_tpu_torch.models.task import SchedulingConfig, Task
    from protocol_tpu_torch.sched.torch_backend import TorchBatchMatcher
    from protocol_tpu_torch.store.node_store import NodeStatus, OrchestratorNode

    rng = random.Random(1)
    models = ["H100", "A100", "L40S", "RTX 4090"]
    nodes = [OrchestratorNode(
        address=f"0x{i:04d}", status=NodeStatus.HEALTHY, price=rng.uniform(0.5, 4),
        compute_specs=ComputeSpecs(gpu=GpuSpecs(count=rng.choice([1, 2, 4, 8]),
                                                model=rng.choice(models), memory_mb=80000),
                                   cpu=CpuSpecs(cores=32), ram_mb=65536, storage_gb=1000))
        for i in range(300)]
    tasks = [Task(name=f"b{j}", created_at=j, scheduling_config=SchedulingConfig(plugins={
        "tpu_scheduler": {"replicas": [str(rng.randint(1, 30))], "compute_requirements": [
            f"gpu:count={rng.choice([1, 2, 4, 8])};gpu:model={rng.choice(models)}"]}}))
        for j in range(20)] + [Task(name="swarm", created_at=0)]
    by_id = {t.id: t for t in tasks}
    store = type("S", (), {})()
    store.node_store = type("N", (), {"get_nodes": lambda s: nodes})()
    store.task_store = type("T", (), {"get_all_tasks": lambda s: tasks,
                                      "get_task": lambda s, i: by_id[i]})()
    for engine, kernel in (("native", "dense_auction"), ("torch", "torch_arena")):
        w = CostWeights(priority=1.0, proximity=0.0)
        on_card = TorchBatchMatcher(store, weights=w, native_engine=engine, device=card)
        on_cpu = TorchBatchMatcher(store, weights=w, native_engine=engine, device="cpu")
        on_card.refresh()
        on_cpu.refresh()
        assert on_card.last_solve_stats["kernel"] == kernel
        assert on_card._assignment == on_cpu._assignment


@pytest.mark.parametrize("proximity", [0.0, 0.001])
def test_cost_block_matches_plain_bits(card, proximity):
    """K10 (through the matcher's cost_only, a view of its slot-major
    block) against cost_matrix: the same bits at both weights."""
    from protocol_tpu_torch.ops.cost import cost_matrix
    from protocol_tpu_torch.sched import torch_backend as tb

    ep = synth_providers(np.random.default_rng(13), 1000, device=card)
    er = synth_requirements(np.random.default_rng(14), 700, device=card)
    w = CostWeights(priority=1.0, proximity=proximity)
    got = tb.cost_only(ep, er, w)
    assert got.shape == (1000, 700) and got.T.is_contiguous()
    assert same_bits(got.contiguous(), cost_matrix(ep, er, w)[0])


def binpack_case(kind: str, card):
    """Integer-valued bin-pack inputs: unit demand with groups over
    domains (phase 0's shape), five resources (phase 0.5's), or a given
    visit order; every case has an all-infeasible column."""
    rng = np.random.default_rng({"unit": 1, "capacity": 2, "order": 3}[kind])
    P, T = 3000, 700
    cost = rng.integers(1, 2000, (P, T)).astype(np.float32) / 8
    cost[rng.uniform(size=(P, T)) > 0.3] = 1e9
    cost[:, 5] = 1e9
    if kind == "unit":
        demand, capacity = np.ones((T, 1), np.float32), np.ones((P, 1), np.float32)
        anti = np.where(np.arange(T) < 600, np.arange(T) // 40, -1).astype(np.int32)
        loc = rng.integers(0, 64, P).astype(np.int32)
        L, G, order = 64, 16, None
    else:
        demand = rng.integers(0, 4, (T, 5)).astype(np.float32)
        capacity = rng.integers(0, 9, (P, 5)).astype(np.float32)
        anti, loc = np.full(T, -1, np.int32), np.arange(P, dtype=np.int32)
        L, G = P, 1
        order = rng.permutation(T).astype(np.int32) if kind == "order" else None

    def dev(x):
        return None if x is None else torch.from_numpy(x).to(card)

    return dev(cost), dev(demand), dev(capacity), dev(order), dev(anti), dev(loc), L, G


@pytest.mark.parametrize("kind", ["unit", "capacity", "order"])
def test_binpack_kernel_matches_plain_bits(card, kind):
    """K11 (its rank launch included) against the plain step loop."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops import binpack as bp

    cost, demand, capacity, order, anti, loc, L, G = binpack_case(kind, card)
    got = kernels.binpack_ffd(cost.T.contiguous(), demand, capacity, order, anti, loc, L, G)
    ref = bp._binpack_plain(cost, demand, capacity,
                            bp.ffd_demand_order(demand) if order is None else order,
                            anti, loc, L, G)
    assert same_bits(got[0], ref[0]) and same_bits(got[1], ref[1])
    assert int(got[0][5]) == -1 and int((got[0] >= 0).sum()) > 0
    # the public entry point launches K11 on a card (ranking the default
    # order in the launch), from a transposed view as the matcher's K10 gives
    before = kernels.LAUNCHES["binpack_ffd"]
    res = bp.assign_binpack_ffd(cost.T.contiguous().T, demand, capacity, task_order=order,
                                anti_group=anti, loc_id=loc, num_locations=L, num_groups=G)
    assert kernels.LAUNCHES["binpack_ffd"] == before + 1
    assert same_bits(res.provider_for_task, ref[0]) and same_bits(res.remaining_capacity, ref[1])


@pytest.mark.parametrize("tile", [256, 512, 1024])
def test_candidate_reverse_several_per_tile_matches_plain_bits(card, tile):
    """K1 reverse with rt = ceil(8 / n_tiles) > 1 tasks per tile (the
    colocation phase's bidirectional candidates at few tiles)."""
    ep = synth_providers(np.random.default_rng(15), 3000, device=card)
    er = synth_requirements(np.random.default_rng(16), 1024, device=card)
    rt = -(-8 // (1024 // tile))
    w = CostWeights(proximity=0.0)
    got = sp.candidates_reverse(ep, er, w, tile, 8, rt)
    ref = sp._reverse_plain(ep, er, w, tile, 8, rt)
    assert got[2].shape == (3000, 1024 // tile * rt)
    assert all(same_bits(a, b) for a, b in zip(got, ref))


# K13 against its plain version: the potentials and the plan are summed in
# another order on the card, so they agree within these bounds (f32 ulps of
# potentials up to ~200 at eps 0.05, over 200 rounds); chip_smoke.py holds
# K13 to the same bounds
SINKHORN_UV_ATOL = 1e-3
SINKHORN_PLAN_ATOL = 2e-5


def greedy_cost(rng, P, T, card):
    """A [P, T] cost with integer-valued eighths (many exact ties), -0.0
    and +0.0 entries, 30% infeasible cells and an all-infeasible column."""
    cost = rng.integers(0, 64, (P, T)).astype(np.float32) / 8
    cost[rng.uniform(size=(P, T)) < 0.1] = -0.0
    cost[rng.uniform(size=(P, T)) < 0.3] = 1e9
    cost[:, 3] = 1e9
    return torch.from_numpy(cost).to(card)


@pytest.mark.parametrize("P,T", [(700, 1000), (4096, 512), (33, 2000)])
def test_greedy_kernel_matches_plain_bits(card, P, T):
    """K12 against the plain step loop: ascending order and a given one."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops import assign as da

    rng = np.random.default_rng(P + T)
    cost = greedy_cost(rng, P, T, card)
    cost_tp = cost.T.contiguous()
    for order in (torch.arange(T, device=card), torch.from_numpy(rng.permutation(T)).to(card)):
        got = kernels.greedy_assign(cost_tp, order)
        ref = da._greedy_plain(cost_tp, order)
        assert same_bits(got, ref) and int(got[3]) == -1 and int((got >= 0).sum()) > 0
    before = kernels.LAUNCHES["greedy_assign"]
    res = da.assign_greedy(cost)  # the public entry point launches K12 on a card
    assert kernels.LAUNCHES["greedy_assign"] == before + 1
    assert same_bits(res.provider_for_task, da._greedy_plain(cost_tp, torch.arange(T)))


@pytest.mark.parametrize("P,T,eps", [(1000, 700, 0.05), (512, 2048, 0.02)])
def test_sinkhorn_kernel_matches_plain(card, P, T, eps):
    """K13 against the plain Sinkhorn within the stated bounds; its
    rounding cost and column maxima are the plain rounding's inputs from
    its own plan, bit for bit; K12 then rounds as the plain loop does."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops import assign as da

    rng = np.random.default_rng(P)
    cost = rng.uniform(0.0, 10.0, (P, T)).astype(np.float32)
    cost[rng.uniform(size=(P, T)) < 0.3] = 1e9
    cost[:, 7] = 1e9
    cost[11, :] = 1e9
    cost = torch.from_numpy(cost).to(card)
    plan_tp, rcost_tp, colmax, u, v = kernels.sinkhorn(cost.T.contiguous(), eps, 200)
    K, pu, pv = da._sinkhorn_plain(cost, eps, 200)
    pplan = da._plan_plain(K, pu, pv)
    for got, ref in ((u, pu), (v, pv)):
        masked = ref < -1e17
        assert torch.equal(got < -1e17, masked) and bool((got[masked] == -1e18).all())
        assert float((got - ref)[~masked].abs().max()) <= SINKHORN_UV_ATOL
    assert float((plan_tp.T - pplan).abs().max()) <= SINKHORN_PLAN_ATOL
    tiny = torch.finfo(torch.float32).tiny
    assert not bool(((plan_tp > 0) & (plan_tp < tiny)).any())
    r_tp, order = da._rounding_inputs(cost, plan_tp.T)
    assert same_bits(rcost_tp, r_tp) and same_bits(colmax, plan_tp.amax(dim=1))
    assert torch.equal(torch.sort(-colmax, stable=True).indices.to(torch.int32), order)
    assert same_bits(kernels.greedy_assign(rcost_tp, order), da._greedy_plain(r_tp, order))
    res = da.assign_sinkhorn(cost, eps, 200)
    p4t = res.provider_for_task
    seated = p4t >= 0
    assert int(seated.sum()) > 0 and bool((cost[p4t[seated].long(), seated.nonzero()[:, 0]]
                                           < 5e8).all())


BLOCKED_ATOL = 1e-3  # K14's lse against the plain passes: another summation order


@pytest.mark.parametrize("P,T,tile", [(1500, 1024, 256), (700, 2000, 400)])
@pytest.mark.parametrize("proximity", [0.0, 0.001])
def test_blocked_sinkhorn_kernels_match_plain(card, P, T, tile, proximity):
    """K14's three launches against the plain passes on the card: the
    masks exactly, the row and column logsumexps within BLOCKED_ATOL on the
    rows and columns with a feasible cell; then, at proximity 0, the
    card's potentials against the CPU's end to end."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops import blocked as bl

    ep = synth_providers(np.random.default_rng(P), P, device=card)
    er = synth_requirements(np.random.default_rng(T), T, device=card)
    ep_c = synth_providers(np.random.default_rng(P), P, device="cpu")
    er_c = synth_requirements(np.random.default_rng(T), T, device="cpu")
    w = CostWeights(proximity=proximity)
    kb = bl.make_k_block(ep, er, w, 0.05, tile)
    starts = range(0, T, tile)
    row_any, col_any, bits = kernels.blocked_feasibility(ep, er, w)
    p_row, p_col = bl.feasibility_scan(kb, P, starts)
    assert torch.equal(row_any, p_row) and torch.equal(col_any, p_col.reshape(T))
    rng = np.random.default_rng(1)
    v = torch.from_numpy(rng.normal(0, 3, T).astype(np.float32)).to(card)
    v = torch.where(col_any, v, -1e18)
    got = kernels.blocked_row_lse(ep, er, w, 0.05, v, bits)
    ref = bl.streaming_row_logsumexp(kb, v, starts, P, tile)
    assert float((got - ref)[row_any].abs().max()) <= BLOCKED_ATOL
    u = torch.from_numpy(rng.normal(0, 3, P).astype(np.float32)).to(card)
    u = torch.where(row_any, u, -1e18)
    got = kernels.blocked_col_lse(ep, er, w, 0.05, u, bits)
    ref = bl.column_logsumexp(kb, u, starts)
    assert float((got - ref)[col_any].abs().max()) <= BLOCKED_ATOL
    if proximity != 0.0:  # the CPU's haversine differs from the card's by ulps
        return
    gu, gv = bl.sinkhorn_potentials_blocked(ep, er, w, eps=0.05, num_iters=10, tile=tile)
    pu, pv = bl.sinkhorn_potentials_blocked(ep_c, er_c, w, eps=0.05, num_iters=10, tile=tile)
    for g, r in ((gu.cpu(), pu), (gv.cpu(), pv)):
        masked = r < -1e17
        assert torch.equal(g < -1e17, masked) and bool((g[masked] == -1e18).all())
        assert float((g - r)[~masked].abs().max()) <= BLOCKED_ATOL


@pytest.mark.parametrize("lanes", [None, 1, 8])
def test_candidate_kernel_with_a_provider_bias_matches_plain_bits(card, lanes):
    """K1's biased forward launch against the plain biased selection, bit
    for bit at proximity 0, with ties made by a bias of -1000 on a third
    of the providers; the unbiased launch keeps its bits."""
    from protocol_tpu_torch import kernels

    P, T, tile = 3000, 1024, 256
    ep = synth_providers(np.random.default_rng(5), P, device=card)
    er = synth_requirements(np.random.default_rng(6), T, device=card)
    w = CostWeights(proximity=0.0)
    ids = torch.arange(T, dtype=torch.int32, device=card)
    rng = np.random.default_rng(2)
    for bias in (rng.normal(0, 1, P), np.where(np.arange(P) % 3 == 0, -1000.0, 0.0)):
        bias = torch.from_numpy(bias.astype(np.float32)).to(card)
        got = kernels.candidates_forward_rows(ep, er, w, 64, ids, lanes=lanes, offset=77,
                                              bias=bias)
        ref = sp._forward_plain(ep, er, w, 64, tile, task_offset=77, provider_offset=bias)
        assert all(same_bits(a, b) for a, b in zip(got, ref))
    got = kernels.candidates_forward_rows(ep, er, w, 64, ids, lanes=lanes)
    ref = sp._forward_plain(ep, er, w, 64, tile)
    assert all(same_bits(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("proximity", [0.0, 0.001])
def test_pair_cost_kernel_matches_plain(card, proximity):
    """K15 against the plain cost_pairs: bit for bit at proximity 0,
    within the haversine tolerance (1e-3) otherwise."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops import cost as oc

    P, T = 2000, 3000
    ep = synth_providers(np.random.default_rng(8), P, device=card)
    er = synth_requirements(np.random.default_rng(9), T, device=card)
    p4t = torch.from_numpy(np.random.default_rng(0).integers(-1, P, T).astype(np.int32)).to(card)
    w = CostWeights(proximity=proximity)
    got = kernels.pair_cost(ep, er, w, p4t)
    ref = oc._cost_pairs_plain(ep, er, p4t, w)
    if proximity == 0.0:
        assert same_bits(got, ref)
    else:
        assert float((got - ref).abs().max()) <= 1e-3
    before = kernels.LAUNCHES["pair_cost"]
    oc.cost_pairs(ep, er, p4t, w)  # the public entry point launches K15 on a card
    assert kernels.LAUNCHES["pair_cost"] == before + 1


# ---------------- the provider mesh: four views of the card ----------------


@pytest.fixture
def mesh4(card):
    """A mesh of four views of the card (utils/platform.py), restored after."""
    from protocol_tpu_torch.parallel.mesh import make_mesh
    from protocol_tpu_torch.utils import platform

    prev = platform.force_virtual_devices(4, "cuda")
    yield make_mesh(4, card)
    platform.force_virtual_devices(prev, "cuda")


def test_enter_kernel_at_a_jitter_offset_matches_plain_bits(card):
    """K3 over one shard's rows at its offset (the sharded enter scan)."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.parallel import sparse as ps

    w = CostWeights(proximity=0.0)
    ep, er, (fp, fc, pt, pc), dirty_p, _ = churned_parts(card, w, T=4096)
    p_ids = torch.from_numpy(dirty_p).to(card)
    for off in (1024, 3072):
        er_s = sp.slice_requirements(er, off, 1024)
        thresh = fc[off:off + 1024, -1].contiguous()
        got = kernels.repair_enter(ep, er_s, w, p_ids, thresh, offset=off)
        assert same_bits(got, ps._enter_plain(ep, er_s, w, p_ids, thresh, off))
        assert same_bits(got, kernels.repair_enter(ep, er, w, p_ids, fc[:, -1].contiguous())
                         [off:off + 1024])


@pytest.mark.parametrize("d_fold", [2, 4, 8])
def test_refold_kernel_with_lanes_matches_plain_bits(card, d_fold):
    """K5 at D lanes, 8 tiles a lane at D = 8: at 2,048 tasks / tile 256
    one tile a lane, fewer than r."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.parallel import sparse as ps

    for T in (2048, 16384):
        _, _, (fp, fc, pt, pc), _, _ = churned_parts(card, CostWeights(proximity=0.0), T=T)
        got = kernels.repair_refold(pt, pc, 8, d_fold)
        assert all(same_bits(a, b) for a, b in zip(got, ps._refold_plain(pt, pc, 8, 1, d_fold)))


def test_sharded_generation_on_the_card_matches_plain_and_one_device(card, mesh4):
    """K1 per shard at the shards' offsets: the sharded pass on the card,
    its plain version on the card and the one-device pass, bit for bit."""
    from protocol_tpu_torch.parallel import sparse as ps

    ep = synth_providers(np.random.default_rng(5), 3000, device=card)
    er = synth_requirements(np.random.default_rng(6), 4096, device=card)
    w = CostWeights(proximity=0.0)
    got = ps.candidates_topk_bidir_sharded(ep, er, w, mesh=mesh4, k=64, tile=256, with_parts=True)
    fp, fc, rt_, rc, pt, pc = sp.candidates_topk_reverse(ep, er, w, k=64, tile=256,
                                                         with_pools=True)
    one = (*sp.merge_reverse_candidates(fp, fc, rt_, rc), fp, fc, pt, pc)
    assert all(same_bits(a, b) for a, b in zip(got, one))
    for s in range(4):
        er_s = sp.slice_requirements(er, s * 1024, 1024)
        k_rev = sp.candidates_reverse(ep, er_s, w, 256, 8, 1, task_offset=s * 1024)
        p_rev = sp._reverse_plain(ep, er_s, w, 256, 8, 1, task_offset=s * 1024)
        assert all(same_bits(a, b) for a, b in zip(k_rev, p_rev))


def test_mesh_round_kernels_match_plain_bits(card, mesh4):
    """K16 over 256-round segments of the sharded phase at D = 4 views (a
    cold segment, then one from the carried state at a smaller frontier),
    the whole state compared with the plain rounds on the same inputs."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.parallel import sparse as ps

    n = 4096
    ep = synth_providers(np.random.default_rng(2), n, device=card)
    er = synth_requirements(np.random.default_rng(3), n, device=card)
    cp, cc = sp.candidates_topk_bidir(ep, er, CostWeights(), k=64, tile=512)
    state = (torch.zeros(n, device=card), torch.full((n,), -1, dtype=torch.int32, device=card),
             torch.full((n,), -1, dtype=torch.int32, device=card),
             torch.zeros(n, dtype=torch.bool, device=card))
    got = ps._make_shards(mesh4, cp, cc, True, *state, 1024)
    ref = ps._make_shards(mesh4, cp, cc, True, *state, 1024)
    before = kernels.LAUNCHES["mesh_round_bid"]
    for eps, B in ((4.0, 1024), (1.0, 256)):
        out_k = ps._segment(mesh4, *got, n, eps, B, 256, 0)
        out_p = ps._segment(mesh4, *ref, n, eps, B, 256, 0, plain=True)
        assert out_k == out_p
        for name in ("price", "owner", "p4t", "retired", "ctl", "win_key", "win_task"):
            assert same_bits(getattr(got[1], name), getattr(ref[1], name)), (eps, name)
    assert kernels.LAUNCHES["mesh_round_bid"] > before
    assert int((got[1].p4t >= 0).sum()) > 0


@pytest.fixture
def views(card):
    """A function giving a mesh of D views of the card (utils/platform.py);
    the count is restored after."""
    from protocol_tpu_torch.parallel.mesh import make_mesh
    from protocol_tpu_torch.utils import platform

    prev = platform.force_virtual_devices(8, "cuda")
    yield lambda D: make_mesh(D, card)
    platform.force_virtual_devices(prev, "cuda")


def jittered_cost(card, P, T, seed=11):
    from protocol_tpu_torch.ops.cost import cost_matrix, with_tie_jitter

    ep = synth_providers(np.random.default_rng(seed), P, device=card)
    er = synth_requirements(np.random.default_rng(seed + 1), T, device=card)
    return with_tie_jitter(cost_matrix(ep, er, CostWeights())[0])


@pytest.mark.parametrize("D", [2, 4])
def test_mesh_dense_kernels_match_plain_bits(card, views, D):
    """K17 over the provider-sharded dense auction at D views: the run ends
    inside its first 256-round segment and the second segment's launches
    do nothing; the whole state compared with the plain rounds on the same
    inputs."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.parallel import auction as pa

    mesh = views(D)
    cost = jittered_cost(card, 2048, 1536)
    got, ref = pa._make_shards(mesh, cost), pa._make_shards(mesh, cost)
    before = kernels.LAUNCHES["mesh_dense_scan"]
    p_k, c_k = pa._rounds(mesh, *got, 0.05, 500)
    p_p, c_p = pa._rounds(mesh, *ref, 0.05, 500, plain=True)
    assert same_bits(p_k, p_p) and same_bits(c_k, c_p)
    for name in ("price", "owner", "win_key"):
        assert same_bits(getattr(got[1], name), getattr(ref[1], name)), name
    assert 0 < int(c_k[kernels.DCTL_IT]) < 256 and int(c_k[kernels.DCTL_GO]) == 0
    assert kernels.LAUNCHES["mesh_dense_scan"] - before == 256 * D
    assert int((p_k >= 0).sum()) > 0


def test_sharded_dense_auction_matches_k7_bits(card, views):
    """The provider-sharded auction at D = 4 views against the one-device
    dense auction (K7) on the same cost: the same matching, bit for bit."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops.assign import assign_auction
    from protocol_tpu_torch.parallel import assign_auction_sharded

    cost = jittered_cost(card, 4096, 3072, seed=13)
    before = kernels.LAUNCHES["dense_auction"]
    one = assign_auction(cost, eps=0.05, max_iters=500)
    assert kernels.LAUNCHES["dense_auction"] == before + 1
    got = assign_auction_sharded(cost, views(4), eps=0.05, max_iters=500)
    assert same_bits(got.provider_for_task, one.provider_for_task)
    assert same_bits(got.task_for_provider, one.task_for_provider)


@pytest.mark.parametrize("P,T,tile", [(1536, 1024, 256), (800, 2000, 400)])
@pytest.mark.parametrize("proximity", [0.0, 0.001])
def test_blocked_col_partial_matches_plain(card, views, P, T, tile, proximity):
    """K14's partial column mode over each of four shards' rows against the
    plain partials: m = -inf exactly where the shard has no feasible cell
    in the column, m + log(s) within BLOCKED_ATOL elsewhere; combined, the
    partials give the one-device column pass within BLOCKED_ATOL. Then the
    sharded potentials on the card against the one-device ones (K14)."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops import blocked as bl
    from protocol_tpu_torch.parallel import sinkhorn as psk

    mesh = views(4)
    ep = synth_providers(np.random.default_rng(P), P, device=card)
    er = synth_requirements(np.random.default_rng(T), T, device=card)
    w = CostWeights(proximity=proximity)
    starts = range(0, T, tile)
    row_any, col_any, _ = kernels.blocked_feasibility(ep, er, w)
    u = torch.from_numpy(np.random.default_rng(1).normal(0, 3, P).astype(np.float32)).to(card)
    u = torch.where(row_any, u, -1e18)
    Pl = P // 4
    ms, ss = [], []
    for s, ep_s in enumerate(psk._shard_providers(ep, mesh)):
        bits_s = kernels.blocked_feasibility(ep_s, er, w)[2]
        m, sm = kernels.blocked_col_partial(ep_s, er, w, 0.05, u[s * Pl:(s + 1) * Pl], bits_s)
        pm_, ps_ = psk._col_partial_plain(bl.make_k_block(ep_s, er, w, 0.05, tile),
                                         u[s * Pl:(s + 1) * Pl], starts)
        empty = torch.isneginf(pm_)
        assert torch.equal(torch.isneginf(m), empty) and bool((sm[empty] == 0).all())
        lse_k = m + torch.log(torch.clamp(sm, min=1e-30))
        lse_p = pm_ + torch.log(torch.clamp(ps_, min=1e-30))
        assert float((lse_k - lse_p)[~empty].abs().max()) <= BLOCKED_ATOL
        ms.append(m)
        ss.append(sm)
    lse = psk._combine_col_partials(ms, ss, mesh)
    ref = bl.column_logsumexp(bl.make_k_block(ep, er, w, 0.05, tile), u, starts)
    assert float((lse - ref)[col_any].abs().max()) <= BLOCKED_ATOL
    assert bool(torch.isneginf(lse[~col_any]).all())
    gu, gv = psk.sinkhorn_potentials_sharded(ep, er, mesh, w, eps=0.05, num_iters=10, tile=tile)
    ou, ov = bl.sinkhorn_potentials_blocked(ep, er, w, eps=0.05, num_iters=10, tile=tile)
    for g, o in ((gu, ou), (gv, ov)):
        masked = o < -1e17
        assert torch.equal(g < -1e17, masked) and bool((g[masked] == -1e18).all())
        assert float((g - o)[~masked].abs().max()) <= BLOCKED_ATOL


@pytest.mark.parametrize("P,T", [(1000, 777), (65, 2000), (32, 64)])
@pytest.mark.parametrize("proximity", [0.0, 0.001])
def test_blocked_feasibility_bitmaps_match_the_plain_packer(card, P, T, proximity):
    """K14's feasibility bitmaps against the plain packer's, word for word
    (pad bits 0), at P and T that are not multiples of 32 and at a 32-word
    chunk of the packer; row_any / col_any are the bitmaps' any()."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops import blocked as bl

    ep = synth_providers(np.random.default_rng(P), P, device=card)
    er = synth_requirements(np.random.default_rng(T), T, device=card)
    w = CostWeights(proximity=proximity)
    row_any, col_any, bits = kernels.blocked_feasibility(ep, er, w)
    ref = bl.pack_feasibility(ep, er, w, chunk=64)
    assert bits.shape == (P, T) and bits.device == torch.device(card, 0)
    assert torch.equal(bits.rows, ref.rows) and torch.equal(bits.cols, ref.cols)
    mask = bl.unpack_words(bits.rows, T)
    assert torch.equal(mask.T, bl.unpack_words(bits.cols, P))
    assert torch.equal(row_any, mask.any(dim=1)) and torch.equal(col_any, mask.any(dim=0))
    assert 0 < int(mask.sum()) < P * T


def test_shard_bitmaps_match_the_one_device_rows(card, views):
    """At D = 4 views of the card (shards of 200 providers, not a multiple of
    32), each shard's bitmaps equal the plain packer's on the shard and
    the rows at its offset of the one-device bitmaps."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops import blocked as bl
    from protocol_tpu_torch.parallel import sinkhorn as psk

    P, T = 800, 1000
    ep = synth_providers(np.random.default_rng(5), P, device=card)
    er = synth_requirements(np.random.default_rng(6), T, device=card)
    w = CostWeights()
    one = bl.unpack_words(kernels.blocked_feasibility(ep, er, w)[2].rows, T)
    for s, ep_s in enumerate(psk._shard_providers(ep, views(4))):
        bits = kernels.blocked_feasibility(ep_s, er, w)[2]
        ref = bl.pack_feasibility(ep_s, er, w)
        assert torch.equal(bits.rows, ref.rows) and torch.equal(bits.cols, ref.cols)
        assert torch.equal(bl.unpack_words(bits.cols, P // 4).T, one[s * 200:(s + 1) * 200])


def test_blocked_passes_refuse_a_mismatched_bitmap(card):
    """A pass given the bitmaps of another shape or device raises and
    launches nothing: it has no per-cell fallback."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops import blocked as bl

    ep = synth_providers(np.random.default_rng(1), 96, device=card)
    er = synth_requirements(np.random.default_rng(2), 64, device=card)
    w = CostWeights()
    _, _, bits = kernels.blocked_feasibility(ep, er, w)
    other = kernels.blocked_feasibility(ep, bl.slice_requirements(er, 0, 63), w)[2]
    on_cpu = bl.FeasibilityBits(bits.rows.cpu(), bits.cols.cpu())
    u, v = torch.zeros(96, device=card), torch.zeros(64, device=card)
    before = dict(kernels.LAUNCHES)
    for wrong in (other, on_cpu):
        with pytest.raises(ValueError, match="feasibility bitmaps"):
            kernels.blocked_row_lse(ep, er, w, 0.05, v, wrong)
        with pytest.raises(ValueError, match="feasibility bitmaps"):
            kernels.blocked_col_lse(ep, er, w, 0.05, u, wrong)
        with pytest.raises(ValueError, match="feasibility bitmaps"):
            kernels.blocked_col_partial(ep, er, w, 0.05, u, wrong)
    assert kernels.LAUNCHES == before
