"""The port's churn-masked candidate repair (protocol_tpu_torch/parallel/
sparse.py, plain torch versions on the CPU) held against the reference's
repair_topk_bidir_sharded(mesh=None) on the same numpy inputs, bit for bit
at CostWeights(proximity=0.0): outputs and scope stats. The cases are
those of tests/test_parallel_sparse.py::TestCandidateRepair, on encoded
marketplaces and on synthetic ones that tie heavily (identical prices share
1,024 jitter levels), so a jitter keyed on a local index would show. The
repair is also held against the port's own from-scratch pass."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from protocol_tpu.ops.cost import CostWeights as JCostWeights
from protocol_tpu.ops.encoding import EncodedProviders
from protocol_tpu.ops.sparse import candidates_topk_reverse as j_candidates_topk_reverse
from protocol_tpu.parallel.sparse import _build_repair_enter as j_build_repair_enter
from protocol_tpu.parallel.sparse import _build_repair_forward as j_build_repair_forward
from protocol_tpu.parallel.sparse import _build_repair_refold as j_build_repair_refold
from protocol_tpu.parallel.sparse import _build_repair_tile as j_build_repair_tile
from protocol_tpu.parallel.sparse import repair_topk_bidir_sharded as j_repair
from protocol_tpu_torch.ops.cost import CostWeights
from protocol_tpu_torch.ops.sparse import candidates_topk_reverse, merge_reverse_candidates
from protocol_tpu_torch.parallel import sparse as ps

from tests.test_torch_candidates import bits, k1_key_cost, synth
from tests.test_torch_encoding_cost import encode_random, to_port
from tests.test_torch_kernels_cuda import (  # shared with the card tests
    K5_TILES,
    NAN_LAT_PROVIDER,
    NAN_PROVIDER,
    k5_pool,
    nan_arrays,
    repair_list_cases,
)

PARTS = ("cand_p", "cand_c", "fwd_p", "fwd_c", "pool_t", "pool_c")
ZERO_PROX = (JCostWeights(proximity=0.0), CostWeights(proximity=0.0))


def marketplace(kind, P, T, seed):
    return encode_random(seed, P, T) if kind == "encoded" else synth(P, T, seed)


def bump(ep, er, dirty_p, dirty_t):
    price = np.array(ep.price, copy=True)
    price[list(dirty_p)] += 0.25
    cores = np.array(er.cpu_cores, copy=True)
    cores[list(dirty_t)] = np.maximum(1, cores[list(dirty_t)] + 1)
    return dataclasses.replace(ep, price=price), dataclasses.replace(er, cpu_cores=cores)


def full_pass(ep, er, k, tile, r, extra):
    """The port's from-scratch parts on the CPU, in PARTS order."""
    tp, tr = to_port(ep, er)
    fp, fc, rt_, rc, pt, pc = candidates_topk_reverse(
        tp, tr, ZERO_PROX[1], k=k, tile=tile, reverse_r=r, with_pools=True
    )
    mp, mc = merge_reverse_candidates(fp, fc, rt_, rc, extra=extra)
    return [a.numpy() for a in (mp, mc, fp, fc, pt, pc)]


def repair_both(kind, P, T, k, tile, r, extra, dirty_p, dirty_t, seed):
    ep, er = marketplace(kind, P, T, seed)
    jw, tw = ZERO_PROX
    fp, fc, _, _, pt, pc = (np.asarray(a) for a in j_candidates_topk_reverse(
        ep, er, jw, k=k, tile=tile, reverse_r=r, with_pools=True))
    ep2, er2 = bump(ep, er, dirty_p, dirty_t)
    ref = j_repair(ep2, er2, jw, fwd_p=fp, fwd_c=fc, pool_t=pt, pool_c=pc,
                   dirty_p=np.asarray(dirty_p, np.int64), dirty_t=np.asarray(dirty_t, np.int64),
                   reverse_r=r, mesh=None, tile=tile, extra=extra)
    got = ps.repair_topk_bidir(*to_port(ep2, er2), tw, fwd_p=fp, fwd_c=fc, pool_t=pt, pool_c=pc,
                               dirty_p=dirty_p, dirty_t=dirty_t, reverse_r=r, tile=tile,
                               extra=extra)
    return ref, got, (ep2, er2)


# (P, T, k, tile, r, extra, dirty_p, dirty_t): TestCandidateRepair's cases
CASES = [
    (96, 128, 16, 16, 8, 8, [5, 17, 40], []),       # provider-side churn only
    (96, 128, 16, 16, 8, 8, [], [3, 60, 100, 101]),  # requirement-side churn only
    (96, 128, 16, 16, 8, 8, [2, 90], [0, 127]),     # both sides
    (96, 128, 16, 16, 8, 8, [], []),                # empty event: a no-op
    (24, 256, 24, 16, 4, 8, [1, 20], [4, 200]),     # rt = 1 over 16 tiles, k clamped at P
    (24, 16, 4, 8, 3, 4, [2, 7], [5, 12]),          # two tiles: rt = 2 (plain path only)
]


@pytest.mark.parametrize("kind", ["encoded", "synth"])
@pytest.mark.parametrize("P,T,k,tile,r,extra,dirty_p,dirty_t", CASES)
def test_repair_matches_reference_bit_for_bit(kind, P, T, k, tile, r, extra, dirty_p, dirty_t):
    ref, got, _ = repair_both(kind, P, T, k, tile, r, extra, dirty_p, dirty_t, seed=11)
    for name, g, o in zip(PARTS, got[:6], ref[:6]):
        np.testing.assert_array_equal(bits(g.numpy()), bits(o), err_msg=name)
    ref_stats = {key: v for key, v in ref[6].items() if key != "pad_hw"}
    assert got[6] == ref_stats
    if not dirty_p and not dirty_t:
        assert got[6]["repair_rows"] == got[6]["repair_blocks"] == 0
        assert got[6]["visited_cells_frac"] == 0.0
    else:
        assert got[6]["visited_cells_frac"] > 0.0
        # churn-bounded work, not a rebuild (the two-tile case visits its
        # few cells more than once)
        assert T < 32 or got[6]["visited_cells_frac"] < 1.0


@pytest.mark.parametrize("P,T,k,tile,r,extra,dirty_p,dirty_t", CASES)
def test_repair_equals_the_ports_own_regen(P, T, k, tile, r, extra, dirty_p, dirty_t):
    _, got, (ep2, er2) = repair_both("synth", P, T, k, tile, r, extra, dirty_p, dirty_t, seed=5)
    oracle = full_pass(ep2, er2, min(k, P), tile, r, extra)
    for name, g, o in zip(PARTS, got[:6], oracle):
        np.testing.assert_array_equal(bits(g.numpy()), bits(o), err_msg=name)


def test_repair_scope_is_churn_bounded():
    """Requirement-side churn repairs O(churned rows): the forward scope
    is exactly the dirty tasks, no enter scan runs."""
    _, got, _ = repair_both("encoded", 96, 256, 16, 16, 8, 8, [], [10, 77], seed=5)
    stats = got[6]
    assert stats["repair_rows"] == 2 and stats["repair_enter_rows"] == 0
    assert stats["visited_cells_frac"] < 0.5


def test_repair_does_not_modify_the_stored_parts():
    ep, er = synth(64, 128, 3)
    fp, fc, _, _, pt, pc = (a.numpy() for a in candidates_topk_reverse(
        *to_port(ep, er), ZERO_PROX[1], k=16, tile=16, reverse_r=8, with_pools=True))
    keep = [a.copy() for a in (fp, fc, pt, pc)]
    ep2, er2 = bump(ep, er, [3], [7])
    ps.repair_topk_bidir(*to_port(ep2, er2), ZERO_PROX[1], fwd_p=fp, fwd_c=fc, pool_t=pt,
                         pool_c=pc, dirty_p=[3], dirty_t=[7], reverse_r=8, tile=16, extra=8)
    for a, b in zip((fp, fc, pt, pc), keep):
        np.testing.assert_array_equal(a, b)


def test_repair_refuses_a_pool_of_another_width():
    ep, er = synth(32, 64, 3)
    tp, tr = to_port(ep, er)
    fp, fc, _, _, pt, pc = candidates_topk_reverse(tp, tr, ZERO_PROX[1], k=8, tile=8,
                                                   reverse_r=8, with_pools=True)
    with pytest.raises(ValueError, match="pool width"):
        ps.repair_topk_bidir(tp, tr, ZERO_PROX[1], fwd_p=fp, fwd_c=fc, pool_t=pt, pool_c=pc,
                             dirty_p=[1], dirty_t=[], reverse_r=4, tile=4, extra=8)


# ---------------- each kernel's plain version against the reference ------


@pytest.mark.parametrize("kind", ["encoded", "synth"])
def test_enter_plain_matches_reference_enter_scan(kind):
    ep, er = marketplace(kind, 80, 96, 7)
    jw, tw = ZERO_PROX
    fwd_c = np.asarray(j_candidates_topk_reverse(ep, er, jw, k=16, tile=12, reverse_r=8)[1])
    dirty_p = np.array([4, 33, 79], np.int64)
    ep2, _ = bump(ep, er, dirty_p, [])
    thresh = fwd_c[:, -1]
    tp, tr = to_port(ep2, er)
    got = ps.repair_enter(tp, tr, tw, torch.tensor(dirty_p), torch.tensor(thresh))
    ep_dirty = EncodedProviders(**{f.name: jnp.asarray(np.asarray(getattr(ep2, f.name))[dirty_p])
                                   for f in dataclasses.fields(ep2)})
    run = j_build_repair_enter(dataclasses.astuple(jw), 12, 8, 3, jax.tree.structure(ep_dirty),
                               jax.tree.structure(er))
    ref = run(ep_dirty, jnp.asarray(dirty_p.astype(np.uint32)), jnp.ones(3, bool),
              jax.tree.map(jnp.asarray, er), jnp.asarray(thresh))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.any()


@pytest.mark.parametrize("case", ["ties", "duplicates", "infeasible_thresh", "offset"])
def test_enter_plain_matches_reference_on_edge_cases(case):
    """The plain enter scan on the seams K3's card tests use: thresholds set
    exactly to a row's least fresh cost (``<=`` flags the tie) or one ulp
    below it, repeated dirty ids, INFEASIBLE thresholds, and a shard's rows
    at their jitter offset (the reference's scan over every row, sliced)."""
    from protocol_tpu_torch.ops.encoding import gather_providers

    P, T = 80, 96
    ep, er = marketplace("synth", P, T, 11)
    jw, tw = ZERO_PROX
    fwd_c = np.asarray(j_candidates_topk_reverse(ep, er, jw, k=16, tile=12, reverse_r=8)[1])
    dirty_p = np.array([4, 4, 33, 79, 79, 79] if case == "duplicates" else [4, 33, 79], np.int64)
    ep2, _ = bump(ep, er, dirty_p, [])
    tp, tr = to_port(ep2, er)
    ids = torch.tensor(dirty_p)
    fresh = ps._jittered(gather_providers(tp, ids), tr, tw, ids, torch.arange(T)).numpy()
    best = fresh.min(axis=0)
    thresh = fwd_c[:, -1].copy()
    if case == "ties":
        thresh[::2] = best[::2]
        thresh[1::2] = np.nextafter(best[1::2], np.float32(-np.inf))
    elif case == "infeasible_thresh":
        thresh[::3] = np.float32(1e9)
    ep_dirty = EncodedProviders(**{f.name: jnp.asarray(np.asarray(getattr(ep2, f.name))[dirty_p])
                                   for f in dataclasses.fields(ep2)})
    n = dirty_p.size
    run = j_build_repair_enter(dataclasses.astuple(jw), 12, 8, n, jax.tree.structure(ep_dirty),
                               jax.tree.structure(er))
    ref = np.asarray(run(ep_dirty, jnp.asarray(dirty_p.astype(np.uint32)), jnp.ones(n, bool),
                         jax.tree.map(jnp.asarray, er), jnp.asarray(thresh)))
    if case == "offset":
        off = 48
        tr_s = ps.slice_requirements(tr, off, T - off)
        got = ps.repair_enter(tp, tr_s, tw, ids, torch.tensor(thresh[off:]), offset=off)
        np.testing.assert_array_equal(got.numpy(), ref[off:])
        return
    got = ps.repair_enter(tp, tr, tw, ids, torch.tensor(thresh)).numpy()
    np.testing.assert_array_equal(got, ref)
    feasible = best < 5e8
    if case == "ties":  # every tie flags; one ulp below flags nothing
        assert got[::2][feasible[::2]].all() and feasible[::2].any()
        assert not got[1::2].any()
    if case == "infeasible_thresh":
        np.testing.assert_array_equal(got[::3], feasible[::3])


def test_refold_plain_matches_reference_refold():
    ep, er = synth(48, 64, 9)
    _, _, rev_t, rev_c, pt, pc = (np.asarray(a) for a in j_candidates_topk_reverse(
        ep, er, ZERO_PROX[0], k=8, tile=8, reverse_r=6, with_pools=True))
    ref_t, ref_c = j_build_repair_refold(48, 8, 1, 6, 1)(jnp.asarray(pt), jnp.asarray(pc))
    got_t, got_c = ps.repair_refold(torch.from_numpy(pt.copy()), torch.from_numpy(pc.copy()), 6, 1)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))
    np.testing.assert_array_equal(bits(got_c.numpy()), bits(np.asarray(ref_c)))
    # the refold replays the cold pass's own fold
    np.testing.assert_array_equal(got_t.numpy(), np.where(rev_c < 5e8, rev_t, -1))


# ---------------- K5's key order, modelled on the CPU ----------------
# csrc/repair.cu's K5 keys each pool entry (order_bits(cost) << 32 |
# position), the all-ones key where it does not enter (at or above
# INFEASIBLE in the total order); a group of refold_group(n_tiles) lanes
# takes positions g, g + G, ... in batches of 8, each lane sorts a batch
# with an odd-even network and keeps the least 8 of it and its list
# (min(a[i], b[7 - i]), then a bitonic merge), then the lanes meet over
# log2(G) shuffle rounds the same way. The model runs those networks over
# numpy arrays, every lane of every row at once.

K5_NO_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)


def k5_order2(k, i, j):
    lo, hi = np.minimum(k[..., i], k[..., j]), np.maximum(k[..., i], k[..., j])
    k[..., i], k[..., j] = lo, hi


def k5_bitonic_merge(k):
    for stride in (4, 2, 1):
        for i in range(8):
            if i ^ stride > i:
                k5_order2(k, i, i ^ stride)


# csrc/repair.cu's sort8: Batcher's odd-even merge sort of 8 keys
K5_SORT8 = ((0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6), (5, 7), (1, 2), (5, 6),
            (0, 4), (1, 5), (2, 6), (3, 7), (2, 4), (3, 5), (1, 2), (3, 4), (5, 6))


def k5_sort8(k):
    for i, j in K5_SORT8:
        k5_order2(k, i, j)


def k5_keep_least(a, b):
    a[...] = np.minimum(a, b[..., ::-1])
    k5_bitonic_merge(a)


def k5_model(pool_t, pool_c, r):
    """K5's (rev_t, rev_c) by the kernel's groups, batches and rounds."""
    from protocol_tpu_torch.kernels import refold_group

    P, n = pool_c.shape
    G = refold_group(n)
    u = pool_c.view(np.uint32).astype(np.uint64)
    order = np.where(u >= 1 << 31, u ^ 0xFFFFFFFF, u | (1 << 31))
    cap = np.uint64(np.float32(1e9).view(np.uint32) | (1 << 31))
    keys = np.where(order < cap, order << np.uint64(32) | np.arange(n, dtype=np.uint64), K5_NO_KEY)
    batches = -(-n // (8 * G))
    padded = np.full((P, batches * 8 * G), K5_NO_KEY, np.uint64)
    padded[:, :n] = keys
    lanes = padded.reshape(P, batches, 8, G).transpose(0, 3, 1, 2)  # entry b 8G + e G + g
    best = None
    for b in range(batches):
        k = lanes[:, :, b].copy()
        k5_sort8(k)
        if best is None:
            best = k
        else:
            k5_keep_least(best, k)
    off = 1
    while off < G:
        k5_keep_least(best, best[:, np.arange(G) ^ off].copy())
        off *= 2
    assert (best == best[:, :1]).all()  # every lane of a group holds the group's list
    top = best[:, 0, :r]
    hit = top != K5_NO_KEY
    at = np.where(hit, top & 0xFFFFFFFF, 0).astype(np.int64)
    rev_c = np.where(hit, np.take_along_axis(pool_c, at, 1), np.float32(1e9))
    rev_t = np.where(hit, np.take_along_axis(pool_t, at, 1), -1)
    return np.where(rev_c < 5e8, rev_t, -1).astype(np.int32), rev_c.astype(np.float32)


@pytest.mark.parametrize("r", [1, 8])
@pytest.mark.parametrize("n_tiles", K5_TILES)
def test_refold_key_model_and_plain_match_the_reference(n_tiles, r):
    """K5's CPU model and the plain refold against the reference's
    _build_repair_refold at d_fold 1, 2 and 4 (where they divide n_tiles) on
    k5_pool's rows: ties across batches and lanes, -0 / +0, INFEASIBLE,
    [INFEASIBLE/2, INFEASIBLE), above, +inf, +NaN and -NaN, -inf, fewer
    entries than r. The reference ranks by the IEEE total order: -0 before
    +0, a negative NaN before every cost (rev_t -1 there)."""
    pt, pc = k5_pool(n_tiles, seed=n_tiles)
    got_t, got_c = k5_model(pt, pc, r)
    plain = ps._refold_plain(torch.from_numpy(pt), torch.from_numpy(pc), r, 1)
    np.testing.assert_array_equal(got_t, plain[0].numpy())
    np.testing.assert_array_equal(bits(got_c), bits(plain[1].numpy()))
    for d_fold in (d for d in (1, 2, 4) if n_tiles % d == 0):
        ref_t, ref_c = j_build_repair_refold(pt.shape[0], n_tiles, 1, r, d_fold)(
            jnp.asarray(pt), jnp.asarray(pc))
        np.testing.assert_array_equal(got_t, np.asarray(ref_t), err_msg=str(d_fold))
        np.testing.assert_array_equal(bits(got_c), bits(np.asarray(ref_c)), err_msg=str(d_fold))
        lanes = ps._refold_plain(torch.from_numpy(pt), torch.from_numpy(pc), r, 1, d_fold)
        np.testing.assert_array_equal(bits(lanes[1].numpy()), bits(got_c))
    if n_tiles >= 8 and r == 8:  # the edges are reached
        neg0 = got_c.view(np.uint32) == 0x80000000
        assert neg0.any() and (got_t[np.isnan(got_c)] == -1).all() and np.isnan(got_c).any()


def test_tile_min_plain_is_the_dirty_column_minimum():
    ep, er = synth(40, 64, 2)
    tp, tr = to_port(ep, er)
    dirty_t = torch.tensor([1, 5, 40, 41, 63])
    got = ps.tile_min(tp, tr, ZERO_PROX[1], dirty_t, 16)
    cost = ps._jittered(tp, tr, ZERO_PROX[1], torch.arange(40), torch.arange(64))
    want = torch.full((40, 4), ps._PAD_COST, dtype=torch.float32)
    for t in dirty_t.tolist():
        want[:, t // 16] = torch.minimum(want[:, t // 16], cost[:, t])
    np.testing.assert_array_equal(bits(got.numpy()), bits(want.numpy()))
    assert (got[:, 1] == torch.tensor(ps._PAD_COST, dtype=torch.float32)).all()


def test_forward_rows_plain_are_the_full_pass_rows():
    ep, er = synth(72, 96, 4)
    tp, tr = to_port(ep, er)
    fp, fc, *_ = candidates_topk_reverse(tp, tr, ZERO_PROX[1], k=12, tile=12, reverse_r=8)
    rows = torch.tensor([95, 0, 13, 14, 60])  # any order: global ids carry the jitter
    p, c = ps.forward_rows(tp, tr, ZERO_PROX[1], 12, rows)
    np.testing.assert_array_equal(p.numpy(), fp[rows].numpy())
    np.testing.assert_array_equal(bits(c.numpy()), bits(fc[rows].numpy()))


# ---------------- the list launches' exactness, modelled on the CPU ------
# csrc/candidates.cu's reverse blocks split a tile's cells over row slices
# and combine them by the least rev_key at rt = 1 ((order_bits(cost) + 1)
# << 32 | task: the card's NaN, 0x7fffffff, keys below every cost); K4
# cuts the dirty ids into ranges at tile boundaries and keeps a running
# NaN-propagating min per tile. Both are modelled here in numpy / torch.

CARD_NAN = np.uint32(0x7FFFFFFF).view(np.float32)  # every NaN the card's arithmetic makes


def k1_rev_key(cost, idx):
    """A mirror of K1's rt = 1 reverse key (``csrc/candidates.cu``
    rev_key<false>) in k1_order_key's signed int64 order: the high word
    order_bits(cost) + 1 mod 2^32. A NaN is taken as the card's NaN, whose
    high word becomes 0."""
    c = torch.where(torch.isnan(cost), torch.tensor(CARD_NAN), cost.to(torch.float32))
    u = c.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    hi = (torch.where(u >= 1 << 31, u ^ 0xFFFFFFFF, u | (1 << 31)) + 1) & 0xFFFFFFFF
    return ((hi - (1 << 31)) << 32) | idx.to(torch.int64)


def k1_rev_key_cost(keys):
    """The cost a k1_rev_key holds (csrc's rev_cost<false>), NaN for a high
    word 0."""
    hi = (keys >> 32) + (1 << 31)
    nan = hi == 0
    c = k1_key_cost(((hi - 1 - (1 << 31)) << 32) | (keys & 0xFFFFFFFF))
    return torch.where(nan, torch.tensor(float("nan")), c)


@pytest.mark.parametrize("case", ["synth", "ties", "infeasible_tile", "nan"])
def test_block_keys_split_anywhere_equal_plain_and_reference(case):
    """Each (provider, tile) block's cells split at random points, each part
    reduced to its least key and the parts combined by the least key: the
    plain blocks and the reference's _build_repair_tile (first argmin, so
    the first NaN of a block with one, the first +inf of a block of +inf)."""
    P, T, tile = 24, 64, 16
    ep, er = synth(P, T, 3)
    if case == "nan":  # nan_arrays' NaN price, priority and coordinates, the +inf block
        pa, ra = dataclasses.asdict(ep), dataclasses.asdict(er)
        pa = {n: np.array(a, copy=True) for n, a in pa.items()}
        ra = {n: np.array(a, copy=True) for n, a in ra.items()}
        nan_arrays(pa, ra, tile)
        ep, er = type(ep)(**pa), type(er)(**ra)
    if case == "ties":  # no jitter above INFEASIBLE/2, equal priorities: whole rows tie
        price = np.array(ep.price, copy=True)
        price[::3] = np.float32(6e8)
        ep = dataclasses.replace(ep, price=price)
        er = dataclasses.replace(er, priority=np.zeros_like(np.asarray(er.priority)))
    elif case == "infeasible_tile":  # every cell of tile 1 at INFEASIBLE
        valid = np.array(er.valid, copy=True)
        valid[tile:2 * tile] = False
        er = dataclasses.replace(er, valid=valid)
    jw, tw = ZERO_PROX
    tp, tr = to_port(ep, er)
    cost = ps._jittered(tp, tr, tw, torch.arange(P), torch.arange(T))
    n_tiles = T // tile
    rng = np.random.default_rng(0)
    got_t = np.zeros((P, n_tiles), np.int32)
    got_c = np.zeros((P, n_tiles), np.float32)
    for p in range(P):
        for j in range(n_tiles):
            tasks = torch.arange(j * tile, (j + 1) * tile, dtype=torch.int32)
            c = cost[p, j * tile:(j + 1) * tile]
            keys = k1_rev_key(c, tasks)
            cuts = np.sort(rng.choice(np.arange(1, tile), rng.integers(0, 5), replace=False))
            best = min(int(part.min()) for part in torch.tensor_split(keys, cuts.tolist()))
            got_t[p, j] = best & 0xFFFFFFFF
            got_c[p, j] = k1_rev_key_cost(torch.tensor([best]))[0]
    blk_j, blk_p = torch.nonzero(torch.ones(n_tiles, P, dtype=torch.bool), as_tuple=True)
    pool_t = torch.zeros((P, n_tiles), dtype=torch.int32)
    pool_c = torch.zeros((P, n_tiles), dtype=torch.float32)
    ps._reverse_blocks_plain(tp, tr, tw, tile, 1, blk_p, blk_j, pool_t, pool_c)
    np.testing.assert_array_equal(got_t, pool_t.numpy())
    np.testing.assert_array_equal(nan_bits(got_c), nan_bits(pool_c.numpy()))
    ep_rows = jax.tree.map(jnp.asarray, ep)
    for j in range(n_tiles):
        er_tile = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[j * tile:(j + 1) * tile]), er)
        run = j_build_repair_tile(dataclasses.astuple(jw), tile, 1, P, jax.tree.structure(ep_rows),
                                  jax.tree.structure(er_tile))
        tt, tc = run(ep_rows, jnp.arange(P, dtype=jnp.uint32), er_tile, jnp.uint32(j * tile))
        np.testing.assert_array_equal(got_t[:, j], np.asarray(tt)[:, 0])
        np.testing.assert_array_equal(nan_bits(got_c[:, j]), nan_bits(np.asarray(tc)[:, 0]))
    if case == "nan":
        assert np.isnan(got_c[NAN_PROVIDER]).any() and np.isnan(got_c[NAN_LAT_PROVIDER]).any()
        assert got_c[11, 2] == np.inf and got_t[11, 2] == 2 * tile
    if case == "ties":
        assert (got_c[::3] >= 5e8).all() and (got_t[::3] % tile == 0).any()
    if case == "infeasible_tile":
        assert (got_c[:, 1] == np.float32(1e9)).all() and (got_t[:, 1] == tile).all()


def nan_bits(a):
    """f32 bits with every NaN as one value: the reference's, the CPU's and
    the card's NaNs carry different payloads, and a comparison of bits
    holds only where the value is not NaN."""
    a = np.asarray(a, np.float32)
    return np.where(np.isnan(a), np.uint32(0x7FFFFFFF), a.view(np.uint32))


def test_repair_plain_versions_on_nan_cells_match_the_reference():
    """C4 on repair_list_cases()["nan"]: the plain reverse blocks (every
    block, rt 1), tile minima and forward rows against the reference's
    _build_repair_tile (jnp.argmin: a block's first NaN; a block of +inf
    its first task) and _build_repair_forward (its dirty-column block,
    reduced as the reference's repair reduces it: np.minimum from the pad,
    which a NaN cell makes NaN; its rows, NaN cells last), at proximity 0.
    The card holds the list launches against these plain versions on the
    same case (test_repair_list_kernels_cases_match_plain_bits[nan])."""
    from protocol_tpu.ops.encoding import EncodedProviders, EncodedRequirements

    pa, ra, tile, _, ids = repair_list_cases()["nan"]
    ep, er = EncodedProviders(**pa), EncodedRequirements(**ra)
    tp, tr = to_port(ep, er)
    jw, tw = ZERO_PROX
    P, T = ep.gpu_count.shape[0], er.cpu_cores.shape[0]
    n_tiles = T // tile
    blk_j, blk_p = torch.nonzero(torch.ones(n_tiles, P, dtype=torch.bool), as_tuple=True)
    pool_t = torch.zeros((P, n_tiles), dtype=torch.int32)
    pool_c = torch.zeros((P, n_tiles), dtype=torch.float32)
    ps._reverse_blocks_plain(tp, tr, tw, tile, 1, blk_p, blk_j, pool_t, pool_c)
    ep_rows = jax.tree.map(jnp.asarray, ep)
    for j in range(n_tiles):
        er_tile = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[j * tile:(j + 1) * tile]), er)
        run = j_build_repair_tile(dataclasses.astuple(jw), tile, 1, P, jax.tree.structure(ep_rows),
                                  jax.tree.structure(er_tile))
        tt, tc = run(ep_rows, jnp.arange(P, dtype=jnp.uint32), er_tile, jnp.uint32(j * tile))
        np.testing.assert_array_equal(pool_t[:, j].numpy(), np.asarray(tt)[:, 0])
        np.testing.assert_array_equal(nan_bits(pool_c[:, j]), nan_bits(np.asarray(tc)[:, 0]))
    assert torch.isnan(pool_c[NAN_PROVIDER]).any() and torch.isnan(pool_c[NAN_LAT_PROVIDER]).any()
    assert int(pool_t[11, 2]) == 2 * tile and float(pool_c[11, 2]) == np.inf
    ids = np.asarray(ids)
    er_rows = EncodedRequirements(**{n: np.asarray(a)[ids] for n, a in ra.items()})
    er_rows_j = jax.tree.map(jnp.asarray, er_rows)
    k = 16
    run = j_build_repair_forward(dataclasses.astuple(jw), P, k, ids.size,
                                 jax.tree.structure(ep_rows), jax.tree.structure(er_rows_j))
    prov, cost_k, dc = run(ep_rows, er_rows_j, jnp.asarray(ids.astype(np.uint32)),
                           jnp.ones(ids.size, bool))
    want = np.full((P, n_tiles), ps._PAD_COST, np.float32)
    dc = np.asarray(dc)
    for j in np.unique(ids // tile):
        sel = ids // tile == j
        np.minimum(want[:, j], dc[:, sel].min(axis=1), out=want[:, j])
    got = ps._tile_min_plain(tp, tr, tw, torch.from_numpy(ids), tile, ps._PAD_COST)
    np.testing.assert_array_equal(nan_bits(got), nan_bits(want))
    assert np.isnan(want[:, 0]).any() and np.isnan(want[NAN_PROVIDER]).any()
    p, c = ps._forward_rows_plain(tp, tr, tw, k, torch.from_numpy(ids))
    np.testing.assert_array_equal(p.numpy(), np.asarray(prov))
    np.testing.assert_array_equal(nan_bits(c), nan_bits(np.asarray(cost_k)))


def tile_cut(ids, i, tile):
    """K4's cut: the least index >= i where a tile starts among the ascending
    ids (0, len(ids), or an id in another tile than the one before it)."""
    if i <= 0 or i >= len(ids):
        return min(max(i, 0), len(ids))
    prev = ids[i - 1] // tile
    later = np.flatnonzero(ids[i:] // tile != prev)
    return i + int(later[0]) if later.size else len(ids)


def tile_min_ranges_model(ranges, ep, er):
    """K4's ranges of the dirty ids, cut at tile boundaries, each reduced by
    a running NaN-propagating min from the pad per (provider, tile) over
    its rows in order, stored when the tile changes: (model, plain)."""
    P, T, tile = 16, 96, 8
    tp, tr = to_port(ep, er)
    tw = ZERO_PROX[1]
    ids = np.array([0, 1, 7, 8, 15, 16, 17, 23, 40, 41, 42, 43, 44, 45, 46, 47, 48, 90, 95])
    cost = ps._jittered(tp, tr, tw, torch.arange(P), torch.arange(T)).numpy()
    pad = np.float32(ps._PAD_COST)
    got = np.full((P, T // tile), pad, np.float32)
    n = len(ids)
    bounds = [(tile_cut(ids, n * y // ranges, tile), tile_cut(ids, n * (y + 1) // ranges, tile))
              for y in range(ranges)]
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    seen = set()
    for r0, r1 in bounds:
        tiles = set((ids[r0:r1] // tile).tolist())
        assert not tiles & seen
        seen |= tiles
        for p in range(P):
            cur, m = -1, pad
            for t in ids[r0:r1]:
                if t // tile != cur:
                    if cur >= 0:
                        got[p, cur] = m
                    cur, m = t // tile, pad
                m = np.minimum(m, cost[p, t])  # min.NaN: a NaN cell's tile is NaN
            if cur >= 0:
                got[p, cur] = m
    return got, ps._tile_min_plain(tp, tr, tw, torch.from_numpy(ids), tile, ps._PAD_COST).numpy()


@pytest.mark.parametrize("ranges", [1, 3, 7, 40])
def test_tile_min_over_ranges_cut_at_tile_boundaries_equals_plain(ranges):
    """K4's ranges of the dirty ids partition the ids with no tile in two
    ranges, and their running minima equal the plain tile minima."""
    got, want = tile_min_ranges_model(ranges, *synth(16, 96, 4))
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("ranges", [1, 7])
def test_tile_min_over_ranges_on_nan_cells_equals_plain(ranges):
    """The same on nan_arrays' NaN cells (C4): a tile with a NaN dirty cell
    has a NaN minimum in the model (K4's min.NaN) and in the plain
    scatter_reduce "amin", as in the reference's np.minimum."""
    ep, er = synth(16, 96, 4)
    pa = {n: np.array(a, copy=True) for n, a in dataclasses.asdict(ep).items()}
    ra = {n: np.array(a, copy=True) for n, a in dataclasses.asdict(er).items()}
    nan_arrays(pa, ra, 8)
    got, want = tile_min_ranges_model(ranges, type(ep)(**pa), type(er)(**ra))
    np.testing.assert_array_equal(nan_bits(got), nan_bits(want))
    assert np.isnan(want[:, 0]).any() and np.isnan(want[NAN_PROVIDER]).any()
