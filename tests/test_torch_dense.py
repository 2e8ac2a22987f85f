"""The matcher's dense route in the port, held against the JAX reference on
the same seeded inputs: the model and requirement-DSL copies, the host
encoder, the tie jitter, the dense auction (K7's plain version), and the
phase-1 / phase-2 solves (``_solve_bounded`` / ``_solve_unbounded``)."""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from protocol_tpu.models import node as j_node
from protocol_tpu.ops.assign import assign_auction as j_assign_auction
from protocol_tpu.ops.assign import assign_auction_scaled as j_assign_auction_scaled
from protocol_tpu.ops.cost import CostWeights as JCostWeights
from protocol_tpu.ops.cost import with_tie_jitter as j_with_tie_jitter
from protocol_tpu.ops.encoding import FeatureEncoder as JFeatureEncoder
from protocol_tpu.sched.tpu_backend import _solve_bounded, _solve_unbounded
from protocol_tpu.trace import synth as j_synth
from protocol_tpu_torch.models import node as t_node
from protocol_tpu_torch.native.arena import _P_SPEC, _R_SPEC
from protocol_tpu_torch.ops.assign import (
    _auction_dense_plain,
    _value_base,
    assign_auction,
    assign_auction_scaled,
    auction_dense,
)
from protocol_tpu_torch.ops.cost import CostWeights, cost_matrix, with_tie_jitter
from protocol_tpu_torch.ops.encoding import FeatureEncoder
from protocol_tpu_torch.sched.torch_backend import (
    _solve_unbounded_plain,
    solve_bounded,
    solve_unbounded,
)

from tests.test_encoding import random_requirements, random_specs
from tests.test_torch_candidates import bits, k1_order_key
from tests.test_torch_encoding_cost import encode_random, to_port

MODELS = ["H100", "A100", "RTX 4090", "L40S", "H200", "A6000"]


def random_dsl(rng: random.Random) -> str:
    """A requirement DSL string: 0-2 GPU alternatives over MODELS (CSV
    lists, memory bounds), CPU, RAM and storage minima."""
    parts = []
    for _ in range(rng.choice([0, 1, 1, 2])):
        parts.append(f"gpu:count={rng.choice([1, 2, 4, 8])}")
        if rng.random() < 0.7:
            parts.append("gpu:model=" + ",".join(rng.sample(MODELS, rng.choice([1, 2]))))
        if rng.random() < 0.3:
            parts.append(f"gpu:memory_mb_min={rng.choice([16000, 40000])}")
        if rng.random() < 0.2:
            parts.append(f"gpu:total_memory_max={rng.choice([160000, 640000])}")
    if rng.random() < 0.5:
        parts.append(f"cpu:cores={rng.choice([2, 8, 32])}")
    if rng.random() < 0.4:
        parts.append(f"ram_mb={rng.choice([4096, 65536])}")
    if rng.random() < 0.3:
        parts.append(f"storage_gb={rng.choice([50, 2000])}")
    return ";".join(parts)


DSL_CASES = [
    "gpu:count=8;gpu:model=H100;gpu:memory_mb=80000;cpu:cores=32;ram_mb=65536",
    "gpu:count=1;gpu:model=A100,H100;gpu:count=2;gpu:model=RTX 4090",
    "gpu:memory_mb_min=16000;gpu:memory_mb_max=40000;storage_gb=100",
    "gpu:total_memory_min=100;gpu:total_memory_max=640000",
    " ; cpu:cores=4 ;",
    "",
    "gpu:memory_mb=1;gpu:memory_mb_min=2",  # exact and min conflict
    "gpu:memory_mb_min=5;gpu:memory_mb_max=4",  # min > max
    "gpu:count=-1",
    "gpu:count=x",
    "bogus=1",
    "ram_mb",
]


@pytest.mark.parametrize("dsl", DSL_CASES)
def test_requirements_dsl_parses_like_the_reference(dsl):
    try:
        ref = j_node.ComputeRequirements.parse(dsl)
    except j_node.RequirementsParseError as e:
        with pytest.raises(t_node.RequirementsParseError, match=str(e)[:20]):
            t_node.ComputeRequirements.parse(dsl)
        return
    got = t_node.ComputeRequirements.parse(dsl)
    assert got.to_dict() == ref.to_dict()


def test_requirements_dsl_random_strings_parse_like_the_reference():
    rng = random.Random(11)
    for _ in range(200):
        dsl = random_dsl(rng)
        assert t_node.ComputeRequirements.parse(dsl).to_dict() == (
            j_node.ComputeRequirements.parse(dsl).to_dict()
        ), dsl


def test_meets_and_fuzzy_match_like_the_reference():
    rng = random.Random(3)
    for _ in range(300):
        s, r = random_specs(rng), random_requirements(rng)
        ts = t_node.ComputeSpecs.from_dict(s.to_dict())
        tr = t_node.ComputeRequirements.from_dict(r.to_dict())
        assert ts.meets(tr) == s.meets(r)
    for spec in MODELS:
        for req in ("h100", "RTX_4090", "a100,l40s", "NVIDIA H200 SXM", "6000"):
            assert t_node._models_fuzzy_match(spec, req) == j_node._models_fuzzy_match(spec, req)


def _encoded_pair(seed: int, pad: int):
    """The same specs, locations, prices and DSL requirements through both
    encoders (the reference's objects: the port's encoder reads them by
    attribute)."""
    rng = random.Random(seed)
    P, T = 37, 23
    specs = [random_specs(rng) if i % 9 else None for i in range(P)]
    locs = [j_node.NodeLocation(rng.uniform(-80, 80), rng.uniform(-179, 179)) if i % 2 else None
            for i in range(P)]
    prices = [rng.uniform(0.5, 4) for _ in range(P)]
    loads = [rng.random() for _ in range(P - 3)]  # shorter than P, as allowed
    reqs = [j_node.ComputeRequirements.parse(random_dsl(rng)) for _ in range(T)]
    prios = [rng.random() for _ in range(T)]
    outs = []
    for enc in (JFeatureEncoder(), FeatureEncoder()):
        kw = {} if isinstance(enc, JFeatureEncoder) else {"device": "cpu"}
        ep = enc.encode_providers(specs, locations=locs, prices=prices, loads=loads,
                                  pad_to=P + pad, **kw)
        er = enc.encode_requirements(reqs, locations=locs[:T], priorities=prios,
                                     pad_to=T + pad, **kw)
        outs.append((ep, er))
    return outs


@pytest.mark.parametrize("seed,pad", [(0, 0), (1, 5), (2, 27)])
def test_feature_encoder_matches_the_reference(seed, pad):
    (jp, jr), (tp, tr) = _encoded_pair(seed, pad)
    for spec, j, t in ((_P_SPEC, jp, tp), (_R_SPEC, jr, tr)):
        for name, dtype in spec:
            ref = np.asarray(getattr(j, name)).astype(dtype)
            got = getattr(t, name).numpy()
            assert got.dtype == dtype, name
            np.testing.assert_array_equal(got, ref, err_msg=name)


def test_feature_encoder_vocabulary_and_overflow_like_the_reference():
    j, t = JFeatureEncoder(model_words=1), FeatureEncoder(model_words=1)
    for i in range(32):
        assert t.intern_model(f" M{i} ") == j.intern_model(f" M{i} ")
    assert t.vocab_version == j.vocab_version == 32
    with pytest.raises(ValueError, match="overflow"):
        t.intern_model("one-too-many")
    tm, tc = t._model_csv_to_mask("m1,M3")
    jm, jc = j._model_csv_to_mask("m1,M3")
    np.testing.assert_array_equal(tm, jm)
    assert tc == jc
    with pytest.raises(ValueError, match="GPU alternatives"):
        FeatureEncoder(max_gpu_options=1).requirement_arrays(
            [t_node.ComputeRequirements.parse("gpu:count=1;gpu:count=2")])


def test_with_tie_jitter_matches_the_reference():
    rng = np.random.default_rng(4)
    cost = np.where(rng.random((70, 45)) < 0.3, 1e9, rng.random((70, 45)) * 5).astype(np.float32)
    got = with_tie_jitter(torch.tensor(cost)).numpy()
    ref = np.asarray(j_with_tie_jitter(jnp.asarray(cost)))
    np.testing.assert_array_equal(bits(got), bits(ref))


def auction_case(kind: str) -> tuple[np.ndarray, int]:
    """(cost [P, T] f32, max_iters) for the dense auction's hard cases."""
    rng = np.random.default_rng(7)
    if kind == "ties":  # few distinct costs: every bid meets ties
        return rng.integers(0, 3, (48, 40)).astype(np.float32), 300
    if kind == "infeasible":  # 80% of the cells infeasible, some tasks with none
        c = np.where(rng.random((40, 64)) < 0.8, 1e9, rng.random((40, 64)))
        c[:, :3] = 1e9
        return c.astype(np.float32), 300
    if kind == "single":  # one option per task: v2 takes the -1e8 floor
        c = np.full((24, 16), 1e9, np.float32)
        c[np.arange(16), np.arange(16)] = rng.random(16)
        c[0, 0] = 0.0
        return c, 300
    # contested: more tasks than providers; the auction is cut at max_iters
    return rng.random((12, 60)).astype(np.float32), 40


@pytest.mark.parametrize("kind", ["ties", "infeasible", "single", "contested"])
def test_plain_dense_auction_matches_the_reference_bits(kind):
    cost, iters = auction_case(kind)
    for eps in (0.05, 0.5):
        ref = j_assign_auction(jnp.asarray(cost), eps=eps, max_iters=iters)
        got = assign_auction(torch.tensor(cost), eps=eps, max_iters=iters)
        np.testing.assert_array_equal(got.provider_for_task.numpy(),
                                      np.asarray(ref.provider_for_task))
        np.testing.assert_array_equal(got.task_for_provider.numpy(),
                                      np.asarray(ref.task_for_provider))
    if kind == "contested":
        vb, feas = _value_base(torch.tensor(cost))
        p4t, _, _, rounds, open_rows = _auction_dense_plain(vb, feas, 0.05, iters)
        assert int(rounds) == iters and open_rows >= iters  # cut, not converged
        assert int((p4t >= 0).sum()) == cost.shape[0]


def test_auction_dense_reports_rounds_and_open_rows():
    cost, _ = auction_case("ties")
    vb, feas = _value_base(torch.tensor(cost))
    work: dict = {}
    p4t, t4p, price, rounds = auction_dense(vb, feas, 0.05, 300, work)
    assert 0 < int(rounds) < 300 and int(work["open_rows"]) >= feas.sum()
    assert price.dtype == torch.float32 and (price >= 0).all()
    seated = p4t[p4t >= 0].long()
    assert torch.equal(t4p[seated], torch.nonzero(p4t >= 0).flatten().to(torch.int32))


def test_assign_auction_scaled_matches_the_reference():
    cost, _ = auction_case("infeasible")
    ref = j_assign_auction_scaled(jnp.asarray(cost))
    got = assign_auction_scaled(torch.tensor(cost))
    np.testing.assert_array_equal(got.provider_for_task.numpy(), np.asarray(ref.provider_for_task))


def markets():
    yield "synth", (j_synth.synth_providers(np.random.default_rng(2), 256),
                    j_synth.synth_requirements(np.random.default_rng(3), 128))
    yield "encoded", encode_random(9, 96, 200)
    yield "skew", (j_synth.synth_providers(np.random.default_rng(4), 64),
                   j_synth.synth_requirements(np.random.default_rng(5), 256))
    yield "dup", dup_market()


DUP_ROWS = 12  # the dup market's distinct requirement rows
DUP_NO_FIT = 3  # its provider that fits no task


def dup_market():
    """40 providers x 36 tasks whose requirement rows repeat every DUP_ROWS
    tasks (exact ties in each provider's row: the argmin takes the first
    copy), and one provider, DUP_NO_FIT, that fits no task."""
    ep, er = encode_random(13, 40, DUP_ROWS)
    idx = np.arange(3 * DUP_ROWS) % DUP_ROWS
    er = dataclasses.replace(er, **{f.name: getattr(er, f.name)[idx]
                                    for f in dataclasses.fields(er)})
    return dataclasses.replace(ep, valid=ep.valid.at[DUP_NO_FIT].set(False)), er


@pytest.mark.parametrize("kind", ["synth", "encoded", "skew", "dup"])
@pytest.mark.parametrize("proximity", [0.0, 0.001])
def test_solve_bounded_and_unbounded_match_the_reference_bits(kind, proximity):
    ep, er = dict(markets())[kind]
    tp, tr = to_port(ep, er)
    jw = JCostWeights(priority=1.0, proximity=proximity)
    tw = CostWeights(**dataclasses.asdict(jw))
    stats: dict = {}
    got = solve_bounded(tp, tr, tw, stats).numpy()
    ref = np.asarray(_solve_bounded(ep, er, jw))
    if proximity == 0.0:
        np.testing.assert_array_equal(got, ref)
    else:  # haversine ulps may reorder near-ties; the seat count holds
        assert abs(int((got >= 0).sum()) - int((ref >= 0).sum())) <= max(1, ref.size // 50)
    assert 0 < int(stats["auction_rounds"]) <= 300
    got_u = solve_unbounded(tp, tr, tw).numpy()
    ref_u = np.asarray(_solve_unbounded(ep, er, jw)[0])
    if proximity == 0.0:
        np.testing.assert_array_equal(got_u, ref_u)
    else:
        np.testing.assert_array_equal(got_u >= 0, ref_u >= 0)
    if kind == "dup":
        assert got_u[DUP_NO_FIT] == -1 and (got_u < DUP_ROWS).all() and (got_u >= 0).sum() >= 10


# ---------------- K8's key combine, modelled on the CPU ----------------
# csrc/candidates.cu's K8 splits each provider's tasks into ranges, keeps
# the least (order_bits(cost), task) key of the range's feasible cells
# (cost < INFEASIBLE/2) with -0 folded to +0, and meets the ranges by the
# least key; a provider without a key gets -1.


NO_KEY = torch.iinfo(torch.int64).max  # the all-ones key in the mirror's signed order


def zeros_market():
    """24 providers x 40 tasks, every pair compatible, costs of -0 (odd,
    located tasks at proximity -0) and +0 (even, unlocated ones): the
    argmin holds them equal and takes task 0."""
    ep = j_synth.synth_providers(np.random.default_rng(6), 24)
    er = j_synth.synth_requirements(np.random.default_rng(7), 40)
    ones = lambda a: np.ones(np.shape(a), bool)  # noqa: E731
    loc = np.array(er.has_location, copy=True)
    loc[0::2] = False
    ep = dataclasses.replace(ep, valid=ones(ep.valid), price=np.full(24, -0.0, np.float32),
                             load=np.full(24, -0.0, np.float32))
    er = dataclasses.replace(
        er, valid=ones(er.valid), cpu_required=~ones(er.cpu_required),
        cpu_cores=np.full(40, -1, np.int32), ram_mb=np.full(40, -1, np.int32),
        storage_gb=np.full(40, -1, np.int32), gpu_opt_valid=~ones(er.gpu_opt_valid),
        priority=np.zeros(40, np.float32), has_location=loc)
    return ep, er


@pytest.mark.parametrize("kind", ["dup", "zeros"])
def test_unbounded_keys_split_anywhere_equal_plain_and_reference(kind):
    """Each provider's tasks split at random points, each part reduced to
    its least key over the feasible cells (-0 as +0) and the parts met by
    the least key: the plain K8 and the reference's _solve_unbounded."""
    ep, er = dup_market() if kind == "dup" else zeros_market()
    jw = JCostWeights(priority=1.0, proximity=0.0 if kind == "dup" else -0.0)
    tw = CostWeights(**dataclasses.asdict(jw))
    tp, tr = to_port(ep, er)
    cost, _ = cost_matrix(tp, tr, tw)
    P, T = cost.shape
    tasks = torch.arange(T, dtype=torch.int32)
    folded = torch.where(cost == 0.0, torch.zeros_like(cost), cost)
    rng = np.random.default_rng(1)
    got = np.full(P, -1, np.int32)
    for p in range(P):
        keys = torch.where(cost[p] < 5e8, k1_order_key(folded[p], tasks), NO_KEY)
        cuts = np.sort(rng.choice(np.arange(1, T), rng.integers(0, 6), replace=False))
        best = min(int(part.min()) for part in torch.tensor_split(keys, cuts.tolist()))
        if best != NO_KEY:
            got[p] = best & 0xFFFFFFFF
    np.testing.assert_array_equal(got, _solve_unbounded_plain(tp, tr, tw).numpy())
    np.testing.assert_array_equal(got, np.asarray(_solve_unbounded(ep, er, jw)[0]))
    if kind == "zeros":  # the fold decides: unfolded keys put task 1's -0 first
        assert bool(torch.signbit(cost[:, 1]).all()) and (got == 0).all()
        raw = k1_order_key(cost, tasks.expand(P, T)).argmin(dim=1)
        assert bool((raw == 1).all())
    else:
        assert got[DUP_NO_FIT] == -1 and (got < DUP_ROWS).all()

