"""The port's blocked (matrix-free) Sinkhorn, its plan-guided rounding, the
biased candidate pass and the pairwise cost, held against the JAX
reference on the same inputs (``protocol_tpu/ops/blocked.py``,
``protocol_tpu/ops/sparse.py::candidates_topk(provider_offset=)``,
``protocol_tpu/ops/cost.py::cost_pairs``), and stage S
(``protocol_tpu_torch/stage_s.py``) against ``scripts/stage_s_100k.py``.

Tolerances:
  - UV_ATOL (1e-3, as the card holds K13 and K14): the potentials on their
    finite entries. Both sides sum the exps in their own order, so u and v
    differ by ulps of their magnitude (~1e-5 at |u| ~ 200 here); XLA also
    flushes subnormal exp terms and torch keeps them, which in a
    log-domain sum is far below this tolerance. The masks (the entries at
    -1e18) are compared exactly.
  - PLAN_ATOL (1e-4, the reference's own bar for the blocked plan against
    the dense one): exp(K + u + v).
  - COST_ATOL (1e-3): costs at default weights, where the haversine's
    transcendentals differ by ulps between XLA and torch. At proximity 0
    the costs carry no transcendental and are compared bit for bit.
"""

import dataclasses
import json
import pathlib
import runpy
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from protocol_tpu.ops import blocked as jb
from protocol_tpu.ops.cost import INFEASIBLE
from protocol_tpu.ops.cost import CostWeights as JCostWeights
from protocol_tpu.ops.cost import cost_matrix as j_cost_matrix
from protocol_tpu.ops.cost import cost_pairs as j_cost_pairs
from protocol_tpu.ops.encoding import EncodedProviders as JEncodedProviders
from protocol_tpu.ops.encoding import EncodedRequirements as JEncodedRequirements
from protocol_tpu.ops.encoding import compat_mask as j_compat_mask
from protocol_tpu.ops.sparse import assign_auction_sparse_scaled as j_scaled
from protocol_tpu.ops.sparse import candidates_topk as j_candidates_topk
from protocol_tpu.ops.sparse import candidates_topk_reverse as j_candidates_topk_reverse
from protocol_tpu_torch import stage_s
from protocol_tpu_torch.ops import blocked as tb
from protocol_tpu_torch.ops.cost import CostWeights, cost_matrix, cost_pairs
from protocol_tpu_torch.ops.encoding import compat_mask
from protocol_tpu_torch.ops.sparse import candidates_topk, candidates_topk_reverse

from tests.test_assign import check_feasible, matching_cost
from tests.test_sparse import encode_random_marketplace
from tests.test_torch_candidates import bits, synth
from tests.test_torch_encoding_cost import COST_ATOL, to_port
from tests.test_torch_kernels_cuda import (  # shared with the card tests
    NAN_PROVIDER,
    NAN_TASK,
    feasibility_cases,
    nan_edit,
)

UV_ATOL = 1e-3
PLAN_ATOL = 1e-4
NEG = -1e18

# (seed, P, T, tile, eps, iterations): the reference's parity case
# (tests/test_blocked.py:21), its quality case's shape, and P != T
POTENTIAL_CASES = [
    (0, 32, 32, 8, 0.1, 80),
    (3, 48, 48, 8, 0.05, 100),
    (1, 96, 64, 16, 0.1, 80),
]


def _finite_close(got: torch.Tensor, ref, atol: float) -> None:
    """The masks (entries at -1e18) equal, the finite entries within atol."""
    got, ref = got.numpy(), np.asarray(ref)
    np.testing.assert_array_equal(got > NEG * 0.5, ref > NEG * 0.5)
    np.testing.assert_array_equal(bits(got[ref <= NEG * 0.5]), bits(ref[ref <= NEG * 0.5]))
    keep = ref > NEG * 0.5
    np.testing.assert_allclose(got[keep], ref[keep], rtol=0, atol=atol)


@pytest.mark.parametrize("seed,P,T,tile,eps,iters", POTENTIAL_CASES)
@pytest.mark.parametrize("proximity", [0.0, 0.001])
def test_potentials_within_tolerance_masks_exact(seed, P, T, tile, eps, iters, proximity):
    ep, er = encode_random_marketplace(seed, P, T)
    ju, jv = jb.sinkhorn_potentials_blocked(ep, er, JCostWeights(proximity=proximity), eps=eps,
                                            num_iters=iters, tile=tile)
    tp, tr = to_port(ep, er)
    u, v = tb.sinkhorn_potentials_blocked(tp, tr, CostWeights(proximity=proximity), eps=eps,
                                          num_iters=iters, tile=tile)
    _finite_close(u, ju, UV_ATOL)
    _finite_close(v, jv, UV_ATOL)


@pytest.mark.parametrize("seed,P,T,tile,eps,iters", POTENTIAL_CASES)
def test_plan_within_tolerance_of_the_reference(seed, P, T, tile, eps, iters):
    ep, er = encode_random_marketplace(seed, P, T)
    w = JCostWeights()
    ju, jv = jb.sinkhorn_potentials_blocked(ep, er, w, eps=eps, num_iters=iters, tile=tile)
    cost, _ = j_cost_matrix(ep, er, w)
    ref = np.asarray(jnp.exp(jnp.where(cost < 5e8, -cost / eps, NEG) + ju[:, None] + jv[None, :]))
    tp, tr = to_port(ep, er)
    u, v = tb.sinkhorn_potentials_blocked(tp, tr, CostWeights(), eps=eps, num_iters=iters,
                                          tile=tile)
    k = torch.cat([tb.make_k_block(tp, tr, CostWeights(), eps, tile)(t0)
                   for t0 in range(0, T, tile)], dim=1)
    plan = torch.exp(k + u[:, None] + v[None, :]).numpy()
    np.testing.assert_allclose(plan, ref, rtol=0, atol=PLAN_ATOL)
    assert ref.sum() > 1.0  # the plan carries mass


@pytest.mark.parametrize("proximity", [0.0, 0.001])
def test_k_block_and_feasibility_scan_match_the_reference(proximity):
    """K = -cost/eps is an IEEE division on both sides (the plain version
    divides by a 0-d tensor): bit-identical at proximity 0; the masks are
    exact at both weights."""
    ep, er = synth(40, 48)
    jw, w = JCostWeights(proximity=proximity), CostWeights(proximity=proximity)
    tp, tr = to_port(ep, er)
    j_kb = jb.make_k_block(ep, er, jw, 0.05, 16)
    t_kb = tb.make_k_block(tp, tr, w, 0.05, 16)
    for t0 in (0, 16, 32):
        got, ref = t_kb(t0).numpy(), np.asarray(j_kb(jnp.int32(t0)))
        if proximity == 0.0:
            np.testing.assert_array_equal(bits(got), bits(ref))
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=COST_ATOL / 0.05)
    j_row, j_col = jb.feasibility_scan(j_kb, 40, jnp.arange(3, dtype=jnp.int32) * 16)
    t_row, t_col = tb.feasibility_scan(t_kb, 40, range(0, 48, 16))
    np.testing.assert_array_equal(t_row.numpy(), np.asarray(j_row))
    np.testing.assert_array_equal(t_col.numpy(), np.asarray(j_col))


def test_streaming_row_logsumexp_within_tolerance():
    ep, er = synth(40, 48)
    v = np.random.default_rng(4).normal(0, 3, 48).astype(np.float32)
    v[::7] = NEG  # columns without a feasible cell
    w = JCostWeights(proximity=0.0)
    ref = jb.streaming_row_logsumexp(jb.make_k_block(ep, er, w, 0.05, 16), jnp.asarray(v),
                                     jnp.arange(3, dtype=jnp.int32) * 16, 40, 16)
    tp, tr = to_port(ep, er)
    got = tb.streaming_row_logsumexp(tb.make_k_block(tp, tr, CostWeights(proximity=0.0), 0.05, 16),
                                     torch.from_numpy(v), range(0, 48, 16), 40, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=UV_ATOL)


def test_tile_divisibility():
    ep, er = encode_random_marketplace(2, 8, 10)
    tp, tr = to_port(ep, er)
    with pytest.raises(ValueError, match="divisible"):
        jb.sinkhorn_potentials_blocked(ep, er, tile=4)
    with pytest.raises(ValueError, match="divisible"):
        tb.sinkhorn_potentials_blocked(tp, tr, tile=4)


# (seed, P, T, tile, k): the quality case's shape, k > P, P != T
ROUNDING_CASES = [(3, 48, 48, 8, 16), (5, 24, 32, 8, 32), (1, 96, 64, 16, 32)]


@pytest.mark.parametrize("seed,P,T,tile,k", ROUNDING_CASES)
def test_rounding_fed_the_reference_potentials_is_bit_identical(seed, P, T, tile, k):
    """The plan-guided rounding on the reference's own u, at proximity 0:
    the offset, the biased candidates and the auction's matching are the
    reference's bits (its potentials alone differ by exp/log ulps)."""
    ep, er = encode_random_marketplace(seed, P, T)
    jw = JCostWeights(proximity=0.0)
    ju, _ = jb.sinkhorn_potentials_blocked(ep, er, jw, eps=0.05, num_iters=60, tile=tile)
    offset = -0.05 * jnp.where(ju > NEG * 0.5, ju, 0.0)
    jcp, jcc = j_candidates_topk(ep, er, jw, k=k, tile=tile, provider_offset=offset)
    ref = j_scaled(jcp, jcc, num_providers=P, eps_start=1.0, eps_end=0.02)
    tp, tr = to_port(ep, er)
    u = torch.from_numpy(np.array(ju))
    t_off = -0.05 * torch.where(u > NEG * 0.5, u, 0.0)
    np.testing.assert_array_equal(bits(t_off.numpy()), bits(offset))
    w = CostWeights(proximity=0.0)
    cp, cc = candidates_topk(tp, tr, w, k=k, tile=tile, provider_offset=t_off)
    np.testing.assert_array_equal(cp.numpy(), np.asarray(jcp))
    np.testing.assert_array_equal(bits(cc.numpy()), bits(jcc))
    res = tb.plan_guided_rounding(tp, tr, u, w, eps=0.05, tile=tile, k=k)
    np.testing.assert_array_equal(res.provider_for_task.numpy(), np.asarray(ref.provider_for_task))
    np.testing.assert_array_equal(res.task_for_provider.numpy(), np.asarray(ref.task_for_provider))


def test_blocked_assignment_quality():
    """End to end, held to the reference's own bars
    (tests/test_blocked.py::test_blocked_assignment_quality)."""
    ep, er = encode_random_marketplace(3, 48, 48)
    tp, tr = to_port(ep, er)
    res = tb.assign_sinkhorn_blocked(tp, tr, eps=0.05, num_iters=100, tile=8, k=16)
    cost = np.asarray(j_cost_matrix(ep, er, JCostWeights())[0])
    p4t = check_feasible(res, cost)
    big = np.where(cost < 5e8, cost, 1e6).astype(np.float64)
    ri, ci = linear_sum_assignment(big)
    opt = sum(big[r, c] for r, c in zip(ri, ci) if big[r, c] < 1e5)
    n_opt = sum(1 for r, c in zip(ri, ci) if big[r, c] < 1e5)
    got = matching_cost(cost, p4t)
    assert (p4t >= 0).sum() >= n_opt - 2
    assert got <= opt * 1.25 + 2.0, f"blocked sinkhorn {got} vs optimal {opt}"
    ref = jb.assign_sinkhorn_blocked(ep, er, eps=0.05, num_iters=100, tile=8, k=16)
    assert (p4t >= 0).sum() == (np.asarray(ref.provider_for_task) >= 0).sum()


# ---------------------------------------------------------------- K14's bitmaps (plain versions)

# (data, seed, P, T): P and T that are not multiples of 32 among them
BITMAP_CASES = [("marketplace", 0, 40, 48), ("marketplace", 1, 33, 70),
                ("marketplace", 2, 96, 31), ("synth", 2, 64, 100)]


def _instance(data, seed, P, T):
    return encode_random_marketplace(seed, P, T) if data == "marketplace" else synth(P, T, seed)


def _words_np(mask: np.ndarray) -> np.ndarray:
    """[n, m] bool -> [n, ceil(m/32)] u32, bit j of word w = mask[:, 32w + j]."""
    n, m = mask.shape
    padded = np.zeros((n, -(-m // 32) * 32), bool)
    padded[:, :m] = mask
    return np.packbits(padded, axis=1, bitorder="little").view("<u4")


@pytest.mark.parametrize("data,seed,P,T", BITMAP_CASES)
@pytest.mark.parametrize("proximity", [0.0, 0.001])
def test_packed_bitmaps_equal_the_reference_mask(data, seed, P, T, proximity):
    """The plain packer's words, both layouts, against the reference's
    make_k_block mask packed in numpy (pad bits 0), at 32- and 64-task
    chunks; the mask is the reference's compat_mask here and its any()
    the reference's feasibility_scan."""
    ep, er = _instance(data, seed, P, T)
    jw = JCostWeights(proximity=proximity)
    mask = np.asarray(jb.make_k_block(ep, er, jw, 0.05, T)(jnp.int32(0)) > NEG * 0.5)
    np.testing.assert_array_equal(mask, np.asarray(j_compat_mask(ep, er)))
    assert 0 < mask.sum() < P * T
    tp, tr = to_port(ep, er)
    for chunk in (32, 64):
        got = tb.pack_feasibility(tp, tr, CostWeights(proximity=proximity), chunk=chunk)
        assert got.shape == (P, T)
        np.testing.assert_array_equal(got.rows.numpy().view(np.uint32), _words_np(mask))
        np.testing.assert_array_equal(got.cols.numpy().view(np.uint32), _words_np(mask.T))
        np.testing.assert_array_equal(tb.unpack_words(got.rows, T).numpy(), mask)
        np.testing.assert_array_equal(tb.unpack_words(got.cols, P).numpy(), mask.T)
    j_row, j_col = jb.feasibility_scan(jb.make_k_block(ep, er, jw, 0.05, T), P,
                                       jnp.zeros(1, dtype=jnp.int32))
    np.testing.assert_array_equal(mask.any(axis=1), np.asarray(j_row))
    np.testing.assert_array_equal(mask.any(axis=0), np.asarray(j_col).reshape(T))


FEAS_CASES = feasibility_cases()
# the cases whose cells must reach the exact cost: the bracket straddles
# INFEASIBLE/2, or a located cell's proximity is not finite
EXACT_CASES = ("straddle", "straddle_far", "negative", "half_located", "nan_inf", "inf_proximity",
               "nan_proximity", "ragged")


def feasibility_rule(ep, er, w: CostWeights):
    """A model of K14's feasibility launch (csrc/blocked.cu), from the
    port's columns on the CPU: compat, then the cost bracket lo / hi (the
    cost at near = near_lo and near_hi, near_lo / near_hi = min / max(0,
    proximity x 20,016 km), NaN for a proximity that is not finite, [0, 0]
    off a located pair): feasible where hi < INFEASIBLE/2, infeasible where
    lo >= INFEASIBLE/2, else the exact cost decides. Returns (mask [P, T],
    the cells the exact cost decided)."""
    f32 = torch.float32
    compat = compat_mask(ep, er)
    base = w.price * ep.price + w.load * ep.load
    prio = w.priority * er.priority
    prox = torch.tensor(w.proximity, dtype=f32)
    far = prox * torch.tensor(20016.0, dtype=f32)
    nan = torch.tensor(float("nan"), dtype=f32)
    near_lo = torch.clamp(far, max=0.0) if bool(torch.isfinite(prox)) else nan
    near_hi = torch.clamp(far, min=0.0) if bool(torch.isfinite(prox)) else nan
    b0 = base + 0.0
    p_loc, t_loc = ep.has_location.bool(), er.has_location.bool()[None, :]
    lo = torch.where(t_loc, torch.where(p_loc, base + near_lo, b0)[:, None], b0[:, None]) - prio
    hi = torch.where(t_loc, torch.where(p_loc, base + near_hi, b0)[:, None], b0[:, None]) - prio
    sure, never = hi < INFEASIBLE * 0.5, lo >= INFEASIBLE * 0.5
    exact = cost_matrix(ep, er, w)[0] < INFEASIBLE * 0.5
    open_ = compat & ~sure & ~never
    return compat & (sure | (open_ & exact)), int(open_.sum())


@pytest.mark.parametrize("name", sorted(FEAS_CASES))
def test_feasibility_rule_matches_the_reference_and_the_packer(name):
    """The feasibility launch's rule (feasibility_rule) on each of its cases
    equals the reference's cost_matrix(...)[0] < INFEASIBLE/2 and the plain
    packer's bitmaps; the cases meant to reach the exact cost do."""
    pa, ra, wk = FEAS_CASES[name]
    ep, er = to_port(pa, ra)
    w = CostWeights(**wk)
    mask, n_exact = feasibility_rule(ep, er, w)
    jp, jr = JEncodedProviders(**pa), JEncodedRequirements(**ra)
    ref = np.asarray(j_cost_matrix(jp, jr, JCostWeights(**wk))[0]) < INFEASIBLE * 0.5
    np.testing.assert_array_equal(mask.numpy(), ref)
    packed = tb.pack_feasibility(ep, er, w, chunk=64)
    np.testing.assert_array_equal(tb.unpack_words(packed.rows, er.num).numpy(), ref)
    np.testing.assert_array_equal(tb.unpack_words(packed.cols, ep.num).numpy(), ref.T)
    assert (n_exact > 0) == (name in EXACT_CASES)
    assert 0 < ref.sum() < ref.size


@pytest.mark.parametrize("tile", [16, 12, 48])
@pytest.mark.parametrize("layout", ["rows", "cols"])
def test_bitmap_k_block_equals_make_k_block(tile, layout):
    """make_k_block_bits is make_k_block with the mask read from the words,
    bit for bit, at tiles that do and do not start on a word."""
    ep, er = synth(40, 48)
    tp, tr = to_port(ep, er)
    w = CostWeights()
    words = tb.pack_feasibility(tp, tr, w, chunk=32)
    ref = tb.make_k_block(tp, tr, w, 0.05, tile)
    got = tb.make_k_block_bits(tp, tr, w, 0.05, tile, words, layout)
    for t0 in range(0, 48, tile):
        np.testing.assert_array_equal(bits(got(t0).numpy()), bits(ref(t0).numpy()))


@pytest.mark.parametrize("proximity", [0.0, 0.001])
def test_bitmap_passes_equal_the_plain_passes_and_the_reference(proximity):
    """The row pass on the row-major words and the column pass on the
    column-major ones equal the plain passes on make_k_block bit for bit
    (the same mask, block and order); through them they agree with the
    reference's streaming_row_logsumexp and its v step within UV_ATOL."""
    ep, er = synth(40, 48)
    rng = np.random.default_rng(4)
    v = rng.normal(0, 3, 48).astype(np.float32)
    v[::7] = NEG
    u = rng.normal(0, 3, 40).astype(np.float32)
    u[::5] = NEG
    jw, w = JCostWeights(proximity=proximity), CostWeights(proximity=proximity)
    tp, tr = to_port(ep, er)
    bits = tb.pack_feasibility(tp, tr, w)
    starts = range(0, 48, 16)
    kb = tb.make_k_block(tp, tr, w, 0.05, 16)
    row = tb.streaming_row_logsumexp(tb.make_k_block_bits(tp, tr, w, 0.05, 16, bits, "rows"),
                                     torch.from_numpy(v), starts, 40, 16)
    col = tb.column_logsumexp(tb.make_k_block_bits(tp, tr, w, 0.05, 16, bits, "cols"),
                              torch.from_numpy(u), starts)
    assert torch.equal(row, tb.streaming_row_logsumexp(kb, torch.from_numpy(v), starts, 40, 16))
    assert torch.equal(col, tb.column_logsumexp(kb, torch.from_numpy(u), starts))
    j_kb = jb.make_k_block(ep, er, jw, 0.05, 16)
    j_starts = jnp.arange(3, dtype=jnp.int32) * 16
    ref_row = jb.streaming_row_logsumexp(j_kb, jnp.asarray(v), j_starts, 40, 16)
    ref_col = []
    for t0 in j_starts:  # the reference's v step (protocol_tpu/ops/blocked.py:133)
        k = j_kb(t0) + jnp.asarray(u)[:, None]
        m = jnp.max(k, axis=0)
        ref_col.append(m + jnp.log(jnp.maximum(jnp.sum(jnp.exp(k - m[None, :]), axis=0), 1e-30)))
    np.testing.assert_allclose(row.numpy(), np.asarray(ref_row), rtol=0, atol=UV_ATOL)
    np.testing.assert_allclose(col.numpy(), np.concatenate([np.asarray(c) for c in ref_col]),
                               rtol=0, atol=UV_ATOL)


def test_bitmaps_of_another_solve_and_bad_chunks_are_refused():
    ep, er = synth(40, 48)
    tp, tr = to_port(ep, er)
    bits = tb.pack_feasibility(tp, tr, CostWeights())
    other = tb.pack_feasibility(tp, tb.slice_requirements(tr, 0, 47), CostWeights())
    with pytest.raises(ValueError, match="feasibility bitmaps"):
        tb.make_k_block_bits(tp, tr, CostWeights(), 0.05, 16, other)
    with pytest.raises(ValueError, match="layout"):
        tb.make_k_block_bits(tp, tr, CostWeights(), 0.05, 16, bits, "diagonal")
    for chunk in (0, 48):
        with pytest.raises(ValueError, match="multiple of 32"):
            tb.pack_feasibility(tp, tr, CostWeights(), chunk=chunk)
    # 2 x 100,000 x 3,125 words at stage S's shape: 2.5 GB
    assert tb.FeasibilityBits.nbytes(100_000, 100_000) == 2_500_000_000


# ---------------------------------------------------------------- biased candidate passes


def _offset(kind: str, P: int) -> np.ndarray:
    rng = np.random.default_rng(11)
    if kind == "negative":
        return -rng.uniform(0.0, 3.0, P).astype(np.float32)
    if kind == "positive":
        return rng.uniform(0.0, 3.0, P).astype(np.float32)
    if kind == "mixed":
        return rng.normal(0.0, 2.0, P).astype(np.float32)
    # "ties": shifting a third of the providers by -1000 rounds their
    # selection values to multiples of 2^-14, so many providers tie
    return np.where(np.arange(P) % 3 == 0, -1000.0, 0.0).astype(np.float32)


OFFSET_KINDS = ["negative", "positive", "mixed", "ties"]


@pytest.mark.parametrize("kind", OFFSET_KINDS)
@pytest.mark.parametrize("task_offset", [0, 65_536])
def test_candidates_topk_with_provider_offset_bit_identical_without_proximity(kind, task_offset):
    ep, er = synth(96, 64)
    off = _offset(kind, 96)
    jw = JCostWeights(proximity=0.0)
    ref = j_candidates_topk(ep, er, jw, k=16, tile=16, provider_offset=jnp.asarray(off),
                            task_offset=task_offset)
    tp, tr = to_port(ep, er)
    got = candidates_topk(tp, tr, CostWeights(proximity=0.0), k=16, tile=16,
                          provider_offset=torch.from_numpy(off), task_offset=task_offset)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(bits(a.numpy()), bits(b))
    if kind == "ties":  # the case does hold ties among the chosen
        p = got[0].numpy()
        sel = got[1].numpy() + np.where(p >= 0, off[np.maximum(p, 0)], 0)
        assert (np.diff(sel, axis=1) == 0).any()


@pytest.mark.parametrize("kind", OFFSET_KINDS)
def test_candidates_topk_reverse_passes_the_offset_to_the_forward_half(kind):
    ep, er = synth(80, 64)
    off = _offset(kind, 80)
    jw = JCostWeights(proximity=0.0)
    ref = j_candidates_topk_reverse(ep, er, jw, k=8, tile=32, reverse_r=6,
                                    provider_offset=jnp.asarray(off), task_offset=7,
                                    with_pools=True)
    tp, tr = to_port(ep, er)
    got = candidates_topk_reverse(tp, tr, CostWeights(proximity=0.0), k=8, tile=32, reverse_r=6,
                                  provider_offset=torch.from_numpy(off), task_offset=7,
                                  with_pools=True)
    for name, a, b in zip(("fwd_p", "fwd_c", "rev_t", "rev_c", "pool_t", "pool_c"), got, ref):
        np.testing.assert_array_equal(bits(a.numpy()), bits(b), err_msg=name)


def test_provider_offset_with_k_above_the_provider_count():
    ep, er = synth(12, 16)
    off = _offset("mixed", 12)
    ref = j_candidates_topk(ep, er, JCostWeights(proximity=0.0), k=64, tile=8,
                            provider_offset=jnp.asarray(off), task_offset=3)
    tp, tr = to_port(ep, er)
    got = candidates_topk(tp, tr, CostWeights(proximity=0.0), k=64, tile=8,
                          provider_offset=torch.from_numpy(off), task_offset=3)
    assert got[0].shape == (16, 12)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(bits(a.numpy()), bits(b))


@pytest.mark.parametrize("kind", OFFSET_KINDS)
def test_provider_offset_costs_within_tolerance_at_default_weights(kind):
    """At default weights a haversine ulp may swap two candidates whose
    selection values nearly tie: the selection values are held at every
    slot, the true costs wherever both sides chose the same provider."""
    ep, er = synth(96, 64)
    off = _offset(kind, 96)
    jp, jc = j_candidates_topk(ep, er, JCostWeights(), k=16, tile=16,
                               provider_offset=jnp.asarray(off))
    tp, tr = to_port(ep, er)
    p, c = candidates_topk(tp, tr, CostWeights(), k=16, tile=16,
                           provider_offset=torch.from_numpy(off))
    jp, jc, p, c = np.asarray(jp), np.asarray(jc), p.numpy(), c.numpy()

    def selection(pp, cc):
        return np.where(pp >= 0, cc + off[np.maximum(pp, 0)], cc)

    np.testing.assert_allclose(selection(p, c), selection(jp, jc), rtol=0, atol=COST_ATOL)
    same = p == jp
    assert same.mean() > 0.9
    np.testing.assert_allclose(c[same], jc[same], rtol=0, atol=COST_ATOL)


def test_provider_offset_of_the_wrong_shape_is_refused():
    ep, er = synth(16, 16)
    tp, tr = to_port(ep, er)
    with pytest.raises(ValueError, match="provider_offset"):
        candidates_topk(tp, tr, k=4, tile=8, provider_offset=torch.zeros(15))


# ---------------------------------------------------------------- pairwise cost


@pytest.mark.parametrize("data", ["marketplace", "synth", "nan"])
@pytest.mark.parametrize("proximity", [0.0, 0.001])
def test_cost_pairs_matches_the_reference(data, proximity):
    """As tests/test_blocked.py::TestCostPairs: unassigned rows and a T
    that is no multiple of the plain version's chunk included; nan: the
    NaN price and priority of nan_edit and an inf price and priority, each
    on an assigned compatible pair (the priority's weight is 0 by default:
    0 x -inf is NaN too)."""
    if data == "marketplace":
        ep, er = encode_random_marketplace(3, 96, 100)
    else:
        ep, er = synth(96, 1100)
    T = np.asarray(er.cpu_cores).shape[0]
    p4t = np.random.default_rng(0).integers(-1, 96, size=T).astype(np.int32)
    if data == "nan":  # each edited row on a compatible pair
        ep, er = nan_edit(ep, er)
        ep = dataclasses.replace(ep, price=np.where(np.arange(96) == 11, np.float32(np.inf),
                                                    ep.price))
        er = dataclasses.replace(er, priority=np.where(np.arange(T) == 9, np.float32(-np.inf),
                                                       er.priority))
        fits = cost_matrix(*to_port(ep, er), CostWeights())[1].numpy()
        t_nan_p = next(t for t in range(10, T) if fits[NAN_PROVIDER, t])
        t_inf_p = next(t for t in range(t_nan_p + 1, T) if fits[11, t])
        p4t[[NAN_TASK, t_nan_p, t_inf_p, 9]] = [3, NAN_PROVIDER, 11, int(fits[:, 9].argmax())]
        edited = [NAN_TASK, t_nan_p, t_inf_p, 9]
    ref = np.asarray(j_cost_pairs(ep, er, jnp.asarray(p4t), JCostWeights(proximity=proximity)))
    tp, tr = to_port(ep, er)
    got = cost_pairs(tp, tr, torch.from_numpy(p4t), CostWeights(proximity=proximity)).numpy()
    assert ((got >= INFEASIBLE * 0.5) == (ref >= INFEASIBLE * 0.5)).all()
    assert (got[p4t < 0] == INFEASIBLE).all()
    if proximity == 0.0:
        np.testing.assert_array_equal(bits(got), bits(ref))
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=COST_ATOL)
    if data == "nan":
        assert np.isnan(got[edited[:2]]).all() and np.isinf(got[edited[2]])


def test_cost_pairs_accepts_numpy_and_defaults_its_weights():
    ep, er = encode_random_marketplace(3, 24, 30)
    p4t = np.random.default_rng(1).integers(-1, 24, size=30).astype(np.int32)
    tp, tr = to_port(ep, er)
    got = cost_pairs(tp, tr, p4t).numpy()
    ref = np.asarray(j_cost_pairs(ep, er, jnp.asarray(p4t)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=COST_ATOL)


# ---------------------------------------------------------------- stage S


def test_stage_s_at_512_has_the_reference_rows(monkeypatch, tmp_path):
    """``stage_s.run`` on the CPU at 512^2 (tile 64, 5 iterations): the
    reference's row keys, both matchings injective, no infeasible pair,
    and mean costs within 1% of the reference script's on the same
    instance."""
    out = tmp_path / "ref.json"
    monkeypatch.setattr(sys, "argv", [
        "stage_s_100k.py", "--size", "512", "--tile", "64", "--iters", "5",
        "--artifact", "", "--json-out", str(out),
    ])
    script = pathlib.Path(__file__).resolve().parent.parent / "scripts" / "stage_s_100k.py"
    runpy.run_path(str(script), run_name="__main__")
    ref = json.loads(out.read_text())
    got = stage_s.run(size=512, tile=64, iters=5, device="cpu")
    assert [list(r) for r in got["rows"]] == [list(r) for r in ref["rows"]]
    s_row, a_row = got["rows"]
    for prefix, row in (("sinkhorn", s_row), ("auction", a_row)):
        assert row[f"{prefix}_injective"] is True
        assert row[f"{prefix}_infeasible_pairs"] == 0
        assert row[f"{prefix}_assigned"] >= 0.99 * 512
    for got_row, ref_row, key in ((s_row, ref["rows"][0], "sinkhorn_mean_cost"),
                                  (a_row, ref["rows"][1], "auction_mean_cost")):
        assert abs(got_row[key] - ref_row[key]) <= 0.01 * ref_row[key]
    assert got["sinkhorn_vs_auction_mean_cost_delta_pct"] is not None


def test_stage_s_refuses_the_native_engine_and_a_card_it_lacks(capsys):
    with pytest.raises(SystemExit) as exc:
        stage_s.main(["--engine", "sparse-mt", "--device", "cpu", "--size", "64", "--tile", "8"])
    assert exc.value.code == 2
    assert "M5" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            stage_s.run(size=64, tile=8, iters=1)
