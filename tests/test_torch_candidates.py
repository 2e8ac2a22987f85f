"""The port's candidate generation (selection, reverse pools and fold,
merge) held against the JAX reference: bit-identical where the costs are
(no haversine term), within the haversine tolerance otherwise."""

import numpy as np
import pytest
import torch

from protocol_tpu.ops.cost import CostWeights as JCostWeights
from protocol_tpu.ops.sparse import (
    _forward_tile_select as j_forward_tile_select,
    candidates_topk_bidir as j_candidates_topk_bidir,
    candidates_topk_reverse as j_candidates_topk_reverse,
    merge_reverse_candidates as j_merge_reverse_candidates,
    pick_tile as j_pick_tile,
)
from protocol_tpu.trace import synth as j_synth
from protocol_tpu_torch.kernels import (
    K1_MAX_SPLIT,
    K1_TARGET_WARPS,
    _k1_reverse_out,
    k1_rows_layout,
    k1_tile_rows,
)
from protocol_tpu_torch.ops.cost import CostWeights
from protocol_tpu_torch.ops.sparse import (
    _bidir_plain,
    _forward_plain,
    _forward_tile_select,
    _reverse_plain,
    candidates_topk_bidir,
    candidates_topk_reverse,
    merge_reverse_candidates,
    pick_tile,
)

from tests.test_torch_encoding_cost import COST_ATOL, encode_random, encode_wide_vocab, to_port
from tests.test_torch_kernels_cuda import NAN_TASK, nan_edit  # shared with the card tests


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def synth(n_p, n_t, seed=2):
    return (
        j_synth.synth_providers(np.random.default_rng(seed), n_p),
        j_synth.synth_requirements(np.random.default_rng(seed + 1), n_t),
    )


# (P, T, k, tile, r): rt = ceil(r / (T / tile)) is 1 except the last two
GEN_CASES = [
    (96, 128, 16, 16, 8),
    (64, 48, 64, 8, 4),
    (24, 16, 4, 8, 3),  # n_tiles 2, rt 2
    (40, 60, 8, 30, 5),  # n_tiles 2, rt 3
]


@pytest.mark.parametrize("P,T,k,tile,r", GEN_CASES)
def test_reverse_with_pools_bit_identical_without_proximity(P, T, k, tile, r):
    ep, er = synth(P, T)
    ref = j_candidates_topk_reverse(
        ep, er, JCostWeights(proximity=0.0), k=k, tile=tile, reverse_r=r, with_pools=True
    )
    tp, tr = to_port(ep, er)
    got = candidates_topk_reverse(
        tp, tr, CostWeights(proximity=0.0), k=k, tile=tile, reverse_r=r, with_pools=True
    )
    assert len(got) == 6
    for name, a, b in zip(("fwd_p", "fwd_c", "rev_t", "rev_c", "pool_t", "pool_c"), got, ref):
        np.testing.assert_array_equal(bits(a.numpy()), bits(b), err_msg=name)


@pytest.mark.parametrize("P,T,k,tile,r", [(96, 128, 16, 16, 8), (20, 64, 20, 16, 8)])
def test_reverse_with_pools_on_nan_cells_matches_the_reference(P, T, k, tile, r):
    """NaN cells (nan_edit: a NaN price, a NaN priority on a task every
    provider fits) through the plain fused pass (the topk RPC's cold pass
    on the CPU) and the plain forward rows against the reference: the NaN
    task's forward row is k places of (-1, NaN), NaN cells last in both."""
    ep, er = nan_edit(*synth(P, T))
    ref = j_candidates_topk_reverse(
        ep, er, JCostWeights(proximity=0.0), k=k, tile=tile, reverse_r=r, with_pools=True
    )
    tp, tr = to_port(ep, er)
    w = CostWeights(proximity=0.0)
    got = candidates_topk_reverse(tp, tr, w, k=k, tile=tile, reverse_r=r, with_pools=True)
    for name, a, b in zip(("fwd_p", "fwd_c", "rev_t", "rev_c", "pool_t", "pool_c"), got, ref):
        np.testing.assert_array_equal(bits(a.numpy()), bits(b), err_msg=name)
    fwd = _forward_plain(tp, tr, w, k, tile)
    for a, b in zip(fwd, got[:2]):
        np.testing.assert_array_equal(bits(a.numpy()), bits(b.numpy()))
    assert (got[0][NAN_TASK] == -1).all() and torch.isnan(got[1][NAN_TASK]).all()


@pytest.mark.parametrize("maker", [encode_random, encode_wide_vocab])
def test_reverse_bit_identical_on_encoded_marketplaces(maker):
    """Encoded marketplaces carry no coordinates, so default weights hold
    no transcendental: bit-identical, including absent specs, 4 options
    and infeasible rows."""
    ep, er = maker(5, 48, 40) if maker is encode_random else maker()
    T = np.asarray(er.cpu_cores).shape[0]
    tile = pick_tile(T, cap=max(1, T // 8))
    ref = j_candidates_topk_reverse(ep, er, JCostWeights(), k=16, tile=tile, reverse_r=8,
                                    with_pools=True)
    tp, tr = to_port(ep, er)
    got = candidates_topk_reverse(tp, tr, CostWeights(), k=16, tile=tile, reverse_r=8,
                                  with_pools=True)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(bits(a.numpy()), bits(b))


def test_forward_tile_select_bits():
    ep, er = synth(80, 64)
    w = JCostWeights(proximity=0.0, priority=0.5)
    p_ref, c_ref, cost_ref = j_forward_tile_select(ep, er, w, 32, 32, 12, None, 0, None)
    tp, tr = to_port(ep, er)
    p_got, c_got, cost_got = _forward_tile_select(
        tp, tr, CostWeights(proximity=0.0, priority=0.5), 32, 32, 12
    )
    np.testing.assert_array_equal(p_got.numpy(), np.asarray(p_ref))
    np.testing.assert_array_equal(bits(c_got.numpy()), bits(c_ref))
    np.testing.assert_array_equal(bits(cost_got.numpy()), bits(cost_ref))


def test_default_weights_select_within_haversine_tolerance():
    """With the haversine term, costs move by ulps; the k smallest costs of
    two arrays that differ by at most d elementwise differ by at most d."""
    ep, er = synth(128, 96)
    ref = j_candidates_topk_reverse(ep, er, JCostWeights(), k=32, tile=12, reverse_r=8,
                                    with_pools=True)
    tp, tr = to_port(ep, er)
    got = candidates_topk_reverse(tp, tr, CostWeights(), k=32, tile=12, reverse_r=8,
                                  with_pools=True)
    for idx in (1, 3, 5):  # fwd_c, rev_c, pool_c
        np.testing.assert_allclose(got[idx].numpy(), np.asarray(ref[idx]), rtol=0, atol=COST_ATOL)


@pytest.mark.parametrize("extra", [16, 2])
def test_merge_fed_reference_arrays_is_bit_identical(extra):
    ep, er = synth(96, 64)
    fwd_p, fwd_c, rev_t, rev_c = j_candidates_topk_reverse(
        ep, er, JCostWeights(), k=8, tile=8, reverse_r=6
    )
    ref_p, ref_c = j_merge_reverse_candidates(fwd_p, fwd_c, rev_t, rev_c, extra=extra)
    got_p, got_c = merge_reverse_candidates(
        *(torch.from_numpy(np.array(a)) for a in (fwd_p, fwd_c, rev_t, rev_c)), extra=extra
    )
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref_p))
    np.testing.assert_array_equal(bits(got_c.numpy()), bits(ref_c))


def test_bidir_bit_identical_without_proximity():
    ep, er = synth(64, 64)
    w = JCostWeights(proximity=0.0)
    ref_p, ref_c = j_candidates_topk_bidir(ep, er, w, k=16, tile=8, reverse_r=8, extra=16)
    tp, tr = to_port(ep, er)
    got_p, got_c = candidates_topk_bidir(
        tp, tr, CostWeights(proximity=0.0), k=16, tile=8, reverse_r=8, extra=16
    )
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref_p))
    np.testing.assert_array_equal(bits(got_c.numpy()), bits(ref_c))


@pytest.mark.parametrize("n,cap", [(0, 8), (7, 8), (96, 12), (512, 64), (100, 1024)])
def test_pick_tile_matches(n, cap):
    assert pick_tile(n, cap) == j_pick_tile(n, cap)


def test_approx_recall_is_refused():
    ep, er = synth(16, 16)
    tp, tr = to_port(ep, er)
    with pytest.raises(NotImplementedError, match="approx_max_k"):
        candidates_topk_reverse(tp, tr, k=4, tile=8, approx_recall=0.95)


def test_tile_divisibility_enforced():
    ep, er = synth(8, 10)
    tp, tr = to_port(ep, er)
    with pytest.raises(ValueError):
        candidates_topk_reverse(tp, tr, k=4, tile=4)


# the fused cold pass's plain version (candidates_topk_reverse without a
# provider_offset): (P, T, k, tile, r, task_offset); tile 250 does not
# divide a warp group's 8 rows, rt > 1 at few tiles, P < 32 with k = P
FUSED_CASES = [
    (40, 2000, 16, 250, 8, 0),
    (24, 16, 4, 8, 3, 0),
    (40, 60, 8, 30, 5, 0),
    (20, 64, 20, 16, 8, 0),
    (48, 128, 16, 32, 8, 123_456_789),
]


@pytest.mark.parametrize("P,T,k,tile,r,offset", FUSED_CASES)
def test_fused_plain_pass_bit_identical_without_proximity(P, T, k, tile, r, offset):
    ep, er = synth(P, T)
    ref = j_candidates_topk_reverse(ep, er, JCostWeights(proximity=0.0), k=k, tile=tile,
                                    reverse_r=r, task_offset=offset, with_pools=True)
    tp, tr = to_port(ep, er)
    got = candidates_topk_reverse(tp, tr, CostWeights(proximity=0.0), k=k, tile=tile,
                                  reverse_r=r, task_offset=offset, with_pools=True)
    for name, a, b in zip(("fwd_p", "fwd_c", "rev_t", "rev_c", "pool_t", "pool_c"), got, ref):
        np.testing.assert_array_equal(bits(a.numpy()), bits(b), err_msg=name)


@pytest.mark.parametrize("P,T,k,tile,r,offset", FUSED_CASES[::2])
def test_fused_plain_pass_within_haversine_tolerance(P, T, k, tile, r, offset):
    ep, er = synth(P, T)
    ref = j_candidates_topk_reverse(ep, er, JCostWeights(), k=k, tile=tile, reverse_r=r,
                                    task_offset=offset, with_pools=True)
    tp, tr = to_port(ep, er)
    got = candidates_topk_reverse(tp, tr, CostWeights(), k=k, tile=tile, reverse_r=r,
                                  task_offset=offset, with_pools=True)
    for idx in (1, 3, 5):  # fwd_c, rev_c, pool_c
        np.testing.assert_allclose(got[idx].numpy(), np.asarray(ref[idx]), rtol=0, atol=COST_ATOL)


def test_fused_plain_pass_equals_the_two_plain_scans():
    """The fused route's plain version scores each tile once for both
    directions; the forward and reverse plain scans give the same bits."""
    ep, er = synth(40, 2000)
    tp, tr = to_port(ep, er)
    w = CostWeights()
    got = _bidir_plain(tp, tr, w, 16, 250, 8, 1, task_offset=7)
    apart = (*_forward_plain(tp, tr, w, 16, 250, task_offset=7),
             *_reverse_plain(tp, tr, w, 250, 8, 1, task_offset=7))
    for a, b in zip(got, apart):
        np.testing.assert_array_equal(bits(a.numpy()), bits(b.numpy()))


def test_candidates_topk_reverse_refusals_on_the_fused_route():
    ep, er = synth(16, 16)
    tp, tr = to_port(ep, er)
    with pytest.raises(OverflowError):
        candidates_topk_reverse(tp, tr, k=4, tile=8, task_offset=1 << 31)
    with pytest.raises(ValueError):
        candidates_topk_reverse(tp, tr, k=4, tile=5)


def k1_order_key(cost, idx):
    """A mirror, written here, of K1's 64-bit selection key
    (``csrc/candidates.cu``: order_bits(cost) << 32 | index, compared
    unsigned) as an int64 whose signed order is the same: order_bits sets
    the sign bit of a non-negative float and flips every bit of a negative
    one; the high word's top bit is flipped here so that int64's signed
    compare orders as K1's unsigned one. The tests over this mirror only
    document the key's order: they cannot see a fault in the kernel's own
    key, which the card tests reach through their bit-for-bit checks."""
    u = cost.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    hi = torch.where(u >= 1 << 31, u ^ 0xFFFFFFFF, u | (1 << 31))
    return ((hi - (1 << 31)) << 32) | idx.to(torch.int64)


def k1_key_cost(keys):
    """The cost a key holds (csrc's order_float), bit for bit."""
    hi = (keys >> 32) + (1 << 31)
    u = torch.where(hi >= 1 << 31, hi & 0x7FFFFFFF, ~hi & 0xFFFFFFFF)
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32).view(torch.float32)


@pytest.mark.parametrize("costs,order", [
    ([1e9, 0.0, -0.5, 3.25, -1e9, 5e8], [4, 2, 1, 3, 5, 0]),
    ([2.0, 2.0, 2.0, -1.0], [3, 0, 1, 2]),  # ties by index
    ([float("inf"), 1e9, 1e9, 0.0], [3, 1, 2, 0]),
])
def test_k1_key_orders_as_cost_then_index(costs, order):
    c = torch.tensor(costs, dtype=torch.float32)
    keys = k1_order_key(c, torch.arange(c.numel(), dtype=torch.int32))
    assert torch.argsort(keys).tolist() == order
    assert torch.equal(k1_key_cost(keys).view(torch.int32), c.view(torch.int32))


def test_k1_key_puts_minus_zero_before_plus_zero():
    """K1 keys no -0 (every feasible cost gets + jitter >= +0); the key map
    is a bijection that would order -0 first, as lax.top_k does."""
    keys = k1_order_key(torch.tensor([0.0, -0.0]), torch.tensor([0, 1], dtype=torch.int32))
    assert int(keys[1]) < int(keys[0])


@pytest.mark.parametrize("rows,layout", [
    (65_536, (8, 1)), (100_000, (8, 1)), (4_096, (2, 1)), (655, (1, 2)), (293, (1, 2)),
    (1, (1, 2)), (2_048, (1, 1)),
])
def test_k1_rows_layout(rows, layout):
    """The rows launch's (rows a warp group, warps a group): the fewest that
    bring the launch to K1_TARGET_WARPS warps, 2 warps a group at most."""
    assert k1_rows_layout(rows) == layout
    rw, split = layout
    assert -(-rows // rw) * split >= K1_TARGET_WARPS or (rw, split) == (1, K1_MAX_SPLIT)


@pytest.mark.parametrize("tile,rw", [(1024, 8), (250, 2), (2500, 4), (1000, 8), (30, 2),
                                     (7, 1), (1, 1), (48, 8)])
def test_k1_tile_rows_divide_the_tile(tile, rw):
    assert k1_tile_rows(tile) == rw and tile % rw == 0


def test_k1_reverse_buffers_and_refusals():
    """The reverse side's key buffer and pools: [P, n_tiles * rt], 8 bytes a
    key (32 MB at 65,536^2 with tile 1,024); bad shapes raise."""
    rkey, pool_t, pool_c, rev_t, rev_c = _k1_reverse_out(100, 96, 48, 8, 4, "cpu", "K1")
    assert rkey.shape == pool_t.shape == pool_c.shape == (100, 8)
    assert rkey.dtype == torch.int64 and rev_t.shape == rev_c.shape == (100, 8)
    assert 65_536 * (65_536 // 1024) * 8 == 32 << 20
    for tile, r, rt in ((50, 8, 1), (48, 9, 1), (48, 8, 9), (2, 8, 4), (48, 8, 0)):
        with pytest.raises(ValueError):
            _k1_reverse_out(100, 96, tile, r, rt, "cpu", "K1")
