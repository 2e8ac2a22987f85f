"""The port's provider-sharded dense auction and blocked Sinkhorn
(protocol_tpu_torch/parallel/auction.py, parallel/sinkhorn.py, plain torch
versions on the CPU) held against the reference's shard_map kernels
(protocol_tpu/parallel/auction.py, parallel/sinkhorn.py) on its virtual
8-device CPU mesh, at the same D, on the same numpy inputs.

The cases are tests/test_parallel.py's and tests/test_parallel_sinkhorn.py's
at their seeds, shapes and D. Tolerances:
  - the dense auction: bit for bit, against the reference's sharded
    auction and against the port's one-device assign_auction;
  - the potentials: masks (the entries at -1e18) exact; the finite entries
    within UV_ATOL_ZERO = 1e-5 at proximity 0 (the two sides sum the exps
    of a column in their own orders) and UV_ATOL = 1e-3 at default weights
    (the haversine's transcendentals differ by ulps between XLA and torch,
    ROADMAP §C), as tests/test_torch_blocked.py holds the one-device
    potentials.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import protocol_tpu.parallel as jpar
import protocol_tpu_torch.parallel as tpar
from protocol_tpu.ops.cost import CostWeights as JCostWeights
from protocol_tpu.parallel import assign_auction_sharded as j_auction_sharded
from protocol_tpu.parallel import make_mesh as j_make_mesh
from protocol_tpu.parallel import sinkhorn_potentials_sharded as j_sinkhorn_sharded
from protocol_tpu_torch.ops import blocked as tb
from protocol_tpu_torch.ops.assign import assign_auction
from protocol_tpu_torch.ops.cost import CostWeights
from protocol_tpu_torch.parallel import auction as pa
from protocol_tpu_torch.parallel import mesh as pm
from protocol_tpu_torch.parallel import sinkhorn as psk
from protocol_tpu_torch.utils import platform

from tests.test_assign import check_feasible, random_cost
from tests.test_sparse import encode_random_marketplace
from tests.test_torch_encoding_cost import to_port

UV_ATOL_ZERO = 1e-5
UV_ATOL = 1e-3
NEG = -1e18


@pytest.fixture
def mesh8():
    """Eight views of the CPU, as the reference's conftest gives JAX eight
    host devices; restored after the test."""
    prev = platform.force_virtual_devices(8, "cpu")
    yield
    platform.force_virtual_devices(prev, "cpu")


def port_mesh(D):
    return pm.make_mesh(D, "cpu")


def test_the_port_exports_the_reference_names():
    assert sorted(tpar.__all__) == sorted(set(jpar.__all__) - {"JaxSolveArena"}
                                          | {"TorchSolveArena"})


# ---------------------------------------------------------------- the dense auction


@pytest.mark.parametrize("seed,P,T,D", [(0, 64, 48, 8), (1, 128, 64, 4), (2, 64, 96, 2)])
def test_sharded_auction_matches_the_reference_and_one_device(mesh8, seed, P, T, D):
    rng = np.random.default_rng(seed)
    cost = random_cost(rng, P, T, p_infeasible=0.15)
    ref = j_auction_sharded(jnp.asarray(cost), j_make_mesh(D), eps=0.05, max_iters=2000)
    got = tpar.assign_auction_sharded(torch.from_numpy(cost), port_mesh(D), eps=0.05,
                                      max_iters=2000)
    one = assign_auction(torch.from_numpy(cost), eps=0.05, max_iters=2000)
    check_feasible(got, cost)
    p4t = got.provider_for_task.numpy()
    np.testing.assert_array_equal(p4t, np.asarray(ref.provider_for_task))
    np.testing.assert_array_equal(got.task_for_provider.numpy(), np.asarray(ref.task_for_provider))
    np.testing.assert_array_equal(p4t, one.provider_for_task.numpy())
    assert (p4t >= 0).sum() > 0


def test_sharded_auction_requires_divisible(mesh8):
    with pytest.raises(ValueError, match="not divisible by mesh size 8"):
        tpar.assign_auction_sharded(torch.zeros((10, 4)), port_mesh(8))


def test_sharded_auction_full_square_matching(mesh8):
    rng = np.random.default_rng(3)
    n = 64
    cost = rng.uniform(0, 10, size=(n, n)).astype(np.float32)
    ref = j_auction_sharded(jnp.asarray(cost), j_make_mesh(8), eps=0.02, max_iters=5000)
    got = tpar.assign_auction_sharded(torch.from_numpy(cost), port_mesh(8), eps=0.02,
                                      max_iters=5000)
    p4t = check_feasible(got, cost)
    assert (p4t >= 0).all()
    np.testing.assert_array_equal(p4t, np.asarray(ref.provider_for_task))


def test_sharded_auction_stops_at_max_iters_like_one_device(mesh8):
    """A cut run (max_iters rounds with tasks still open) stops where the
    one-device auction stops; the loop state counts the rounds and the open
    rows the one-device plain rounds count."""
    from protocol_tpu_torch.ops.assign import _auction_dense_plain, _value_base

    cost = random_cost(np.random.default_rng(4), 96, 80, p_infeasible=0.1)
    c = torch.from_numpy(cost)
    shards, stacked, feasible = pa._make_shards(port_mesh(4), c)
    p4t, ctl = pa._rounds(port_mesh(4), shards, stacked, feasible, 0.05, 7)
    one, _, price, rounds, open_rows = _auction_dense_plain(*_value_base(c), 0.05, 7)
    np.testing.assert_array_equal(p4t.numpy(), one.numpy())
    np.testing.assert_array_equal(stacked.price.reshape(-1).numpy(), price.numpy())
    assert int(ctl[pa.DCTL_IT]) == int(rounds) == 7 and int(ctl[pa.DCTL_GO]) == 0
    assert int(ctl[pa.DCTL_ROWS]) == open_rows and int(ctl[pa.DCTL_OPEN]) > 0


# ---------------------------------------------------------------- the blocked Sinkhorn


def _finite_close(got: torch.Tensor, ref, atol: float) -> None:
    """The masks (entries at -1e18) equal, the finite entries within atol."""
    got, ref = got.numpy(), np.asarray(ref)
    keep = ref > NEG * 0.5
    np.testing.assert_array_equal(got > NEG * 0.5, keep)
    np.testing.assert_array_equal(got[~keep], ref[~keep])
    np.testing.assert_allclose(got[keep], ref[keep], rtol=0, atol=atol)


@pytest.mark.parametrize("seed,P,T,D", [(0, 32, 32, 8), (1, 64, 16, 4)])
@pytest.mark.parametrize("proximity,atol", [(0.0, UV_ATOL_ZERO), (None, UV_ATOL)])
def test_sharded_potentials_match_the_reference(mesh8, seed, P, T, D, proximity, atol):
    ep, er = encode_random_marketplace(seed, P, T)
    jw, w = ((JCostWeights(), CostWeights()) if proximity is None
             else (JCostWeights(proximity=proximity), CostWeights(proximity=proximity)))
    ju, jv = j_sinkhorn_sharded(ep, er, j_make_mesh(D), jw, eps=0.1, num_iters=40, tile=8)
    tp, tr = to_port(ep, er)
    u, v = tpar.sinkhorn_potentials_sharded(tp, tr, port_mesh(D), w, eps=0.1, num_iters=40,
                                            tile=8)
    _finite_close(u, ju, atol)
    _finite_close(v, jv, atol)
    assert (u.numpy() > NEG * 0.5).any() and (v.numpy() > NEG * 0.5).any()


def test_sharded_potentials_require_divisible(mesh8):
    ep, er = to_port(*encode_random_marketplace(2, 30, 16))
    with pytest.raises(ValueError, match="not divisible by mesh size 8"):
        tpar.sinkhorn_potentials_sharded(ep, er, port_mesh(8), tile=8)
    ep, er = to_port(*encode_random_marketplace(2, 32, 20))
    with pytest.raises(ValueError, match="not divisible by tile=8"):
        tpar.sinkhorn_potentials_sharded(ep, er, port_mesh(8), tile=8)


@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_sharded_potentials_are_D_invariant(mesh8, D):
    """The port's sharded potentials against its one-device blocked ones at
    default weights: bit for bit at D = 1 (the same ops), within
    UV_ATOL_ZERO at D > 1 (the column sums combine in shard order)."""
    ep, er = to_port(*encode_random_marketplace(5, 32, 24))
    w = CostWeights()
    u1, v1 = tb.sinkhorn_potentials_blocked(ep, er, w, eps=0.05, num_iters=20, tile=8)
    u, v = tpar.sinkhorn_potentials_sharded(ep, er, port_mesh(D), w, eps=0.05, num_iters=20,
                                            tile=8)
    if D == 1:
        assert torch.equal(u, u1) and torch.equal(v, v1)
    _finite_close(u, u1, UV_ATOL_ZERO)
    _finite_close(v, v1, UV_ATOL_ZERO)


def test_a_column_feasible_in_one_shard_only_combines_from_the_partials(mesh8):
    """K14's partial mode leaves a column with no feasible cell in a shard
    at (m = -inf, s = 0); the combine adds 0 for that shard, so a column
    feasible in one shard only gets that shard's logsumexp, and a column
    feasible nowhere ends at -inf, not NaN. The plain partials combined
    equal the one-device column pass, and the whole sharded run on such an
    instance equals the reference."""
    ep, er = to_port(*encode_random_marketplace(7, 16, 24))
    mesh = port_mesh(4)
    w = CostWeights(proximity=0.0)
    starts = range(0, 24, 8)
    shards = psk._shard_providers(ep, mesh)
    feas = torch.stack([tb.feasibility_scan(tb.make_k_block(e, er, w, 0.1, 8), 4, starts)[1]
                        .reshape(24) for e in shards])
    n_shards = feas.sum(dim=0)
    assert bool((n_shards == 1).any()), "the instance needs a column feasible in one shard"
    u = torch.from_numpy(np.random.default_rng(0).normal(0, 2, 16).astype(np.float32))
    parts = [psk._col_partial_plain(tb.make_k_block(e, er, w, 0.1, 8), u[4 * s:4 * s + 4], starts)
             for s, e in enumerate(shards)]
    for (m, s), f in zip(parts, feas):
        assert bool(torch.isneginf(m[~f]).all()) and bool((s[~f] == 0).all())
    lse = psk._combine_col_partials([p[0] for p in parts], [p[1] for p in parts], mesh)
    ref = tb.column_logsumexp(tb.make_k_block(ep, er, w, 0.1, 8), u, starts)
    keep = n_shards > 0
    assert not bool(torch.isnan(lse).any())
    assert bool(torch.isneginf(lse[~keep]).all())
    np.testing.assert_allclose(lse[keep].numpy(), ref[keep].numpy(), rtol=0, atol=UV_ATOL_ZERO)
    one = n_shards == 1
    np.testing.assert_array_equal(lse[one].numpy(), torch.stack([
        torch.where(f, m + torch.log(torch.clamp(s, min=1e-30)), 0.0)
        for (m, s), f in zip(parts, feas)]).sum(dim=0)[one].numpy())

    ju, jv = j_sinkhorn_sharded(*encode_random_marketplace(7, 16, 24), j_make_mesh(4),
                                JCostWeights(proximity=0.0), eps=0.1, num_iters=20, tile=8)
    u, v = tpar.sinkhorn_potentials_sharded(ep, er, mesh, w, eps=0.1, num_iters=20, tile=8)
    _finite_close(u, ju, UV_ATOL_ZERO)
    _finite_close(v, jv, UV_ATOL_ZERO)


def test_the_float_psum_adds_in_shard_order(mesh8):
    """((p0 + p1) + p2) in f32, whose bits another order would change:
    (1e8 + 1) - 1e8 is 0 in f32, (1e8 - 1e8) + 1 is 1."""
    mesh = port_mesh(3)
    a = np.array([[1e8, 1e8], [1.0, -1e8], [-1e8, 1.0]], np.float32)
    parts = [torch.from_numpy(r.copy()) for r in a]
    out = pm.psum_float(parts, mesh)
    assert len(out) == 3 and all(o is out[0] for o in out)
    np.testing.assert_array_equal(out[0].numpy(), (a[0] + a[1]) + a[2])
    assert out[0].tolist() == [0.0, 1.0] and ((a[0] + a[2]) + a[1]).tolist() == [1.0, 0.0]
    assert all(np.array_equal(p.numpy(), r) for p, r in zip(parts, a))  # inputs untouched
    with pytest.raises(TypeError, match="psum_float"):
        pm.psum(parts, mesh)
