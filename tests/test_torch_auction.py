"""The port's sparse frontier auction fed the JAX reference's candidate
arrays: every function returns the reference's bits (f32 adds, subtracts
and max only, with deterministic scatter-max/min)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from protocol_tpu.ops.cost import CostWeights as JCostWeights
from protocol_tpu.ops.sparse import (
    _greedy_cleanup as j_greedy_cleanup,
    _phase_adaptive as j_phase_adaptive,
    _sparse_auction_phase as j_sparse_auction_phase,
    _unassign_unhappy as j_unassign_unhappy,
    assign_auction_sparse_scaled as j_assign_auction_sparse_scaled,
    assign_auction_sparse_warm as j_assign_auction_sparse_warm,
    candidates_topk_bidir as j_candidates_topk_bidir,
    frontier_bids as j_frontier_bids,
)
from protocol_tpu.trace import synth as j_synth
from protocol_tpu_torch import kernels
from protocol_tpu_torch.ops.sparse import (
    _greedy_cleanup,
    _phase_adaptive,
    _sparse_auction_phase,
    _unassign_unhappy,
    assign_auction_sparse_scaled,
    assign_auction_sparse_warm,
    frontier_bids,
)

from tests.test_torch_candidates import bits
from tests.test_torch_kernels_cuda import (  # shared with the card tests
    K9_KINDS,
    k2_cluster_cases,
    k9_case,
)

K2_CASES = k2_cluster_cases()


def cands(n_p, n_t, seed=2, k=16, r=8, extra=8):
    ep = j_synth.synth_providers(np.random.default_rng(seed), n_p)
    er = j_synth.synth_requirements(np.random.default_rng(seed + 1), n_t)
    tile = max(1, n_t // 8)
    while n_t % tile:
        tile -= 1
    cp, cc = j_candidates_topk_bidir(ep, er, JCostWeights(), k=k, tile=tile, reverse_r=r,
                                     extra=extra)
    return np.asarray(cp), np.asarray(cc)


def unfillable(seed=0, n_t=96, n_p=40, k=6):
    """More tasks than providers, some tasks with no candidate at all, and
    heavy contention: the tail can never be filled."""
    rng = np.random.default_rng(seed)
    cp = rng.integers(0, n_p, (n_t, k)).astype(np.int32)
    cc = rng.uniform(0.0, 5.0, (n_t, k)).astype(np.float32)
    cp[rng.random((n_t, k)) < 0.2] = -1
    cp[::17] = -1
    return cp, cc


def to_t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def assert_state_equal(got, ref):
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(bits(a.numpy()), bits(np.asarray(b)), err_msg=f"slot {i}")


MARKETS = {
    "synth": lambda: cands(96, 128),
    "unfillable": unfillable,
    "wide": lambda: cands(160, 96, seed=5, k=32, extra=16),
}


@pytest.mark.parametrize("market", sorted(MARKETS))
@pytest.mark.parametrize("eps,max_iters,frontier", [(4.0, 10000, 4096), (0.02, 37, 16)])
def test_phase_bits(market, eps, max_iters, frontier):
    cp, cc = MARKETS[market]()
    P = int(cp.max()) + 1
    ref_state, ref_stall = j_sparse_auction_phase(
        jnp.asarray(cp), jnp.asarray(cc), P, None, eps=eps, max_iters=max_iters,
        frontier=frontier, retire=True, stall_limit=0,
    )
    state, stall = _sparse_auction_phase(
        *to_t(cp, cc), P, None, eps=eps, max_iters=max_iters, frontier=frontier,
        retire=True, stall_limit=0,
    )
    assert_state_equal(state, ref_state)
    assert int(stall) == int(ref_stall)


def test_phase_bits_from_a_carried_state():
    cp, cc = cands(96, 128)
    P = int(cp.max()) + 1
    s1, _ = j_sparse_auction_phase(jnp.asarray(cp), jnp.asarray(cc), P, None, eps=1.0,
                                   max_iters=20, frontier=32)
    ref_state, ref_stall = j_sparse_auction_phase(
        jnp.asarray(cp), jnp.asarray(cc), P, s1, eps=0.25, max_iters=500, frontier=32
    )
    state, stall = _sparse_auction_phase(
        *to_t(cp, cc), P, to_t(*s1), eps=0.25, max_iters=500, frontier=32
    )
    assert_state_equal(state, ref_state)
    assert int(stall) == int(ref_stall)


@pytest.mark.parametrize("stall_limit,max_iters", [(16, 5000), (0, 300)])
def test_contended_tail_stall(stall_limit, max_iters):
    """3 tasks fighting over 2 providers: one permanent hole (the reference's
    stall-detection cases)."""
    cp = np.asarray([[0, 1], [0, 1], [0, 1]], np.int32)
    cc = np.asarray([[1.0, 2.0], [1.1, 2.1], [1.2, 2.2]], np.float32)
    ref_state, ref_stall = j_sparse_auction_phase(
        jnp.asarray(cp), jnp.asarray(cc), 2, None, eps=0.5, max_iters=max_iters,
        frontier=4, retire=False, stall_limit=stall_limit,
    )
    state, stall = _sparse_auction_phase(
        *to_t(cp, cc), 2, None, eps=0.5, max_iters=max_iters, frontier=4,
        retire=False, stall_limit=stall_limit,
    )
    assert_state_equal(state, ref_state)
    assert int(stall) == int(ref_stall)
    assert int((state[3] >= 0).sum()) == 2


def test_frontier_bids_bits():
    cp, cc = cands(64, 64)
    rng = np.random.default_rng(1)
    P = int(cp.max()) + 1
    price = rng.uniform(0, 3, P).astype(np.float32)
    valid = cp >= 0
    vb = np.where(valid, -cc, np.float32(-1e18)).astype(np.float32)
    safe = np.where(valid, cp, 0).astype(np.int32)
    f_idx = np.asarray(list(range(0, 64, 3)) + [64] * 5, np.int32)
    f_ok = f_idx < 64
    ref = j_frontier_bids(jnp.asarray(safe), jnp.asarray(vb), jnp.asarray(price),
                          jnp.asarray(f_idx), jnp.asarray(f_ok), cp.shape[1])
    got = frontier_bids(*to_t(safe, vb, price, f_idx, f_ok), cp.shape[1])
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(bits(a.numpy()), bits(np.asarray(b)))


def test_unassign_unhappy_and_cleanup_bits():
    cp, cc = unfillable(3)
    P = int(cp.max()) + 1
    state, _ = j_sparse_auction_phase(jnp.asarray(cp), jnp.asarray(cc), P, None, eps=4.0,
                                      max_iters=50, frontier=64)
    _, price, owner, p4t, _ = state
    ref_owner, ref_p4t = j_unassign_unhappy(jnp.asarray(cp), jnp.asarray(cc), price, owner,
                                            p4t, 0.25)
    got_owner, got_p4t = _unassign_unhappy(*to_t(cp, cc, price, owner, p4t), 0.25)
    np.testing.assert_array_equal(got_owner.numpy(), np.asarray(ref_owner))
    np.testing.assert_array_equal(got_p4t.numpy(), np.asarray(ref_p4t))
    assert (np.asarray(ref_p4t) != np.asarray(p4t)).any()  # the repair did evict

    ref_clean = j_greedy_cleanup(jnp.asarray(cp), jnp.asarray(cc), ref_owner, ref_p4t)
    got_clean = _greedy_cleanup(*to_t(cp, cc, ref_owner, ref_p4t))
    np.testing.assert_array_equal(got_clean.numpy(), np.asarray(ref_clean))


@pytest.mark.parametrize("kind", K9_KINDS)
def test_cleanup_matches_the_reference_on_k9_cases(kind):
    """K9's card cases at a small size: the plain sweep, the card's
    referee, against the reference, so that the kernel = the plain sweep =
    the reference on each hazard (merged rows, K = 128 and 80, a provider
    twice in a row, -0.0 / +0.0 ties, equal costs, one open row, rows with
    no free candidate, more than a million providers)."""
    cp, cc, owner, p4t = k9_case(kind, small=True)
    ref = j_greedy_cleanup(jnp.asarray(cp), jnp.asarray(cc), jnp.asarray(owner),
                           jnp.asarray(p4t))
    got = _greedy_cleanup(*to_t(cp, cc, owner, p4t))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got.numpy() != p4t).any()  # the sweep seated someone


@pytest.mark.parametrize("market", sorted(MARKETS))
def test_scaled_ladder_bits_and_stats(market):
    cp, cc = MARKETS[market]()
    P = int(cp.max()) + 1
    ref_stats, got_stats = {}, {}
    ref_res, ref_price, ref_ret = j_assign_auction_sparse_scaled(
        jnp.asarray(cp), jnp.asarray(cc), P, stats_out=ref_stats, with_state=True
    )
    res, price, ret = assign_auction_sparse_scaled(
        *to_t(cp, cc), P, stats_out=got_stats, with_state=True
    )
    np.testing.assert_array_equal(res.provider_for_task.numpy(),
                                  np.asarray(ref_res.provider_for_task))
    np.testing.assert_array_equal(res.task_for_provider.numpy(),
                                  np.asarray(ref_res.task_for_provider))
    np.testing.assert_array_equal(bits(price.numpy()), bits(np.asarray(ref_price)))
    np.testing.assert_array_equal(ret.numpy(), np.asarray(ref_ret))
    assert got_stats == ref_stats


# ---------------- K2's cluster cases (tests/test_torch_kernels_cuda.py) ----------------


@pytest.mark.parametrize("name", sorted(K2_CASES))
def test_k2_cluster_case_has_its_property(name):
    case = K2_CASES[name]
    case["check"](case)


def _j_state(state):
    return None if state is None else tuple(jnp.asarray(a) for a in state)


def _t_state(state):
    return None if state is None else to_t(*state)


@pytest.mark.parametrize("name", sorted(K2_CASES))
def test_k2_cluster_case_phase_bits(name):
    """The port's plain phase against the reference's on each case: the
    state K2 must reproduce at every cluster size."""
    c = K2_CASES[name]
    kw = dict(eps=c["eps"], max_iters=c["max_iters"], frontier=c["frontier"],
              retire=c["retire"], stall_limit=0)
    ref_state, ref_stall = j_sparse_auction_phase(
        jnp.asarray(c["cp"]), jnp.asarray(c["cc"]), c["P"], _j_state(c["state"]), **kw)
    state, stall = _sparse_auction_phase(*to_t(c["cp"], c["cc"]), c["P"], _t_state(c["state"]),
                                         **kw)
    assert_state_equal(state, ref_state)
    assert int(stall) == int(ref_stall)


@pytest.mark.parametrize("name", ["ragged", "retire_first", "negative_prices"])
def test_phase_adaptive_with_hoisted_inputs_bits(name):
    """_phase_adaptive builds _phase_inputs once a phase and hands them to
    its 256-round segments: the reference's segments, stall and rounds."""
    c = K2_CASES[name]
    kw = dict(eps=c["eps"], max_iters=600, frontier=c["frontier"], retire=True, stall_limit=8)
    ref_state, ref_stall = j_phase_adaptive(
        jnp.asarray(c["cp"]), jnp.asarray(c["cc"]), c["P"], _j_state(c["state"]), **kw)
    state, stall = _phase_adaptive(*to_t(c["cp"], c["cc"]), c["P"], _t_state(c["state"]), **kw)
    assert_state_equal(state, ref_state)
    assert int(stall) == int(ref_stall)


@pytest.mark.parametrize("ladder", [True, False])
def test_warm_auction_on_negative_prices_bits(ladder):
    """The warm auction from the carried negative-price case's duals."""
    c = K2_CASES["negative_prices"]
    _, price, _, p4t, retired = c["state"]
    js, ts = {}, {}
    jres, jprice, jret = j_assign_auction_sparse_warm(
        jnp.asarray(c["cp"]), jnp.asarray(c["cc"]), c["P"], jnp.asarray(price), jnp.asarray(p4t),
        retired0=jnp.asarray(retired), stats_out=js, frontier_ladder=ladder, with_state=True)
    tres, tprice, tret = assign_auction_sparse_warm(
        *to_t(c["cp"], c["cc"]), c["P"], *to_t(price, p4t), retired0=torch.from_numpy(retired),
        stats_out=ts, frontier_ladder=ladder, with_state=True)
    np.testing.assert_array_equal(tres.provider_for_task.numpy(),
                                  np.asarray(jres.provider_for_task))
    np.testing.assert_array_equal(bits(tprice.numpy()), bits(np.asarray(jprice)))
    np.testing.assert_array_equal(tret.numpy(), np.asarray(jret))
    assert ts == js


# ---------------- the launch counter and the in-place sums (kernels.py) ----------------


def test_launch_counts_only_a_launch_and_a_refusal_raises():
    before = kernels.LAUNCHES["auction_phase"]
    kernels._launch("auction_phase", lambda *a: 0, 1, 2)
    assert kernels.LAUNCHES["auction_phase"] == before + 1
    with pytest.raises(RuntimeError, match=r"cudaError 912"):
        kernels._launch("auction_phase", lambda *a: 912, what="auction_phase (cluster of 32)")
    assert kernels.LAUNCHES["auction_phase"] == before + 1
    kernels.LAUNCHES["auction_phase"] = before


def _k9_args(T=8, K=16, P=32):
    return (torch.zeros((T, K), dtype=torch.int32), torch.zeros((T, K)),
            torch.full((P,), -1, dtype=torch.int32), torch.full((T,), -1, dtype=torch.int32),
            torch.arange(T, dtype=torch.int32))


def _k11_args(P=6, T=4, R=1, L=6, G=2):
    return [torch.zeros((T, P)), torch.ones((T, R)), torch.ones((P, R)), None,
            torch.full((T,), -1, dtype=torch.int32), torch.arange(P, dtype=torch.int32), L, G]


def _k11_bad(i, value, **kw):
    args = _k11_args()
    args[i] = value
    return lambda: kernels.binpack_ffd(*args, **kw)


CHAIN_REFUSALS = {
    "k9 K > 128": lambda: kernels.greedy_cleanup(*_k9_args(K=129)),
    "k9 P > 1,638,400": lambda: kernels.greedy_cleanup(*_k9_args(P=1_638_401)),
    "k9 p4t shape": lambda: kernels.greedy_cleanup(
        *_k9_args()[:3], torch.zeros(7, dtype=torch.int32), torch.arange(8, dtype=torch.int32)),
    "k11 R > 8": _k11_bad(1, torch.ones((4, 9))),
    "k11 capacity shape": _k11_bad(2, torch.ones((5, 1))),
    "k11 group range": _k11_bad(4, torch.tensor([0, 1, 2, -1], dtype=torch.int32)),
    "k11 domain range": _k11_bad(5, torch.tensor([0, 1, 2, 3, 4, 6], dtype=torch.int32)),
    "k11 order range": _k11_bad(3, torch.tensor([0, 1, 2, 4], dtype=torch.int32)),
    "k11 order shape": _k11_bad(3, torch.tensor([0, 1, 2], dtype=torch.int32)),
    "k11 shared does not fit": _k11_bad(6, 1 << 22, route="shared"),
    "k11 unknown route": _k11_bad(6, 6, route="registers"),
}


@pytest.mark.parametrize("case", sorted(CHAIN_REFUSALS))
def test_chain_kernels_refuse_bad_inputs_before_loading(case, monkeypatch):
    """K9's and K11's wrappers check shapes, ranges and the instantiation
    before they load a library (here there is none to load)."""
    monkeypatch.setattr(kernels, "_lib", lambda name: pytest.fail(f"loaded {name}"))
    with pytest.raises(ValueError):
        CHAIN_REFUSALS[case]()


class _Event:
    """A stand-in for a CUDA event: a time stamp, done or not yet."""

    def __init__(self, t: float, done: bool = True):
        self.t, self.done = t, done

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return end.t - self.t


def test_in_place_sums_fold_finished_pairs_then_all():
    assert kernels._TIMED is None  # off by default
    kernels.time_in_place(True)
    try:
        kernels._TIMED.extend([
            ("auction_phase", _Event(0.0), _Event(1.5)),
            ("greedy_cleanup", _Event(2.0), _Event(2.25)),
            ("auction_phase", _Event(3.0), _Event(5.0, done=False)),
        ])
        kernels._fold(wait=False)  # only the finished pairs
        assert len(kernels._TIMED) == 1
        assert kernels._IN_PLACE == {"auction_phase": [1.5, 1], "greedy_cleanup": [0.25, 1]}
        assert kernels.in_place_ms() == {"auction_phase": {"ms": 3.5, "launches": 2},
                                         "greedy_cleanup": {"ms": 0.25, "launches": 1}}
    finally:
        kernels.time_in_place(False)
    assert kernels._TIMED is None and kernels.in_place_ms()["auction_phase"]["launches"] == 2
    kernels.time_in_place(True)  # on again: every sum back to 0
    assert kernels.in_place_ms() == {}
    kernels.time_in_place(False)
