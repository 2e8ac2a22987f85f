"""The port's provider mesh (protocol_tpu_torch/parallel/mesh.py and the
sharded passes of parallel/sparse.py, plain torch versions on the CPU) held
against the reference's shard_map kernels on its virtual 8-device CPU mesh,
at the same D, on the same numpy inputs, bit for bit at proximity 0.

The port's mesh over the CPU is D views of the one CPU device
(utils/platform.py::force_virtual_devices, set by the ``mesh8`` fixture
and restored after). The cases mirror tests/test_parallel_sparse.py
(sharded generation, the sharded repair, the plain / scaled / warm sharded
auctions), tests/test_jax_engine.py::TestDeviceInvarianceAndDegradation
(TorchSolveArena(devices=D) against JaxSolveArena(devices=D)) and
tests/test_sparse_matcher.py::TestMeshMatcher (the matcher's use_mesh and
"torch:D" against TpuBatchMatcher's use_mesh and "jax:D")."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from protocol_tpu.native.arena import _P_SPEC as J_P_SPEC
from protocol_tpu.native.arena import _canon as j_canon
from protocol_tpu.ops.cost import CostWeights as JCostWeights
from protocol_tpu.ops.sparse import candidates_topk_reverse as j_topk_reverse
from protocol_tpu.parallel import assign_auction_sparse_scaled_sharded as j_scaled_sharded
from protocol_tpu.parallel import assign_auction_sparse_sharded as j_sharded
from protocol_tpu.parallel import assign_auction_sparse_warm_sharded as j_warm_sharded
from protocol_tpu.parallel import candidates_topk_bidir_sharded as j_gen_sharded
from protocol_tpu.parallel import make_mesh as j_make_mesh
from protocol_tpu.parallel import pad_to_multiple
from protocol_tpu.parallel.jax_arena import JaxSolveArena
from protocol_tpu.parallel.sparse import repair_topk_bidir_sharded as j_repair
from protocol_tpu.sched import TpuBatchMatcher
from protocol_tpu.store import StoreContext
from protocol_tpu_torch.ops import sparse as osp
from protocol_tpu_torch.ops.cost import CostWeights
from protocol_tpu_torch.parallel import mesh as pm
from protocol_tpu_torch.parallel import sparse as ps
from protocol_tpu_torch.parallel.torch_arena import TorchSolveArena
from protocol_tpu_torch.sched.torch_backend import TorchBatchMatcher
from protocol_tpu_torch.utils import platform

from tests.test_assign import random_cost
from tests.test_parallel_sparse import build_candidates
from tests.test_sparse_matcher import mk_bounded_task, populate
from tests.test_torch_candidates import bits
from tests.test_torch_encoding_cost import encode_random, to_port
from tests.test_torch_matcher import port_weights, sc_mixed
from tests.test_torch_repair import bump

ZERO_PROX = (JCostWeights(proximity=0.0), CostWeights(proximity=0.0))


@pytest.fixture
def mesh8():
    """Eight views of the CPU, as the reference's conftest gives JAX eight
    host devices; restored after the test."""
    prev = platform.force_virtual_devices(8, "cpu")
    yield
    platform.force_virtual_devices(prev, "cpu")


def port_mesh(D):
    return pm.make_mesh(D, "cpu")


def synth_market(seed, P, T):
    """The synthetic marketplace's columns on the CPU: every row located,
    so the cost's haversine term is live."""
    from protocol_tpu_torch.ops.encoding import providers_from_numpy, requirements_from_numpy
    from protocol_tpu_torch.trace.synth import synth_provider_arrays, synth_requirement_arrays

    rng = np.random.default_rng(seed)
    return (providers_from_numpy(synth_provider_arrays(rng, P), "cpu"),
            requirements_from_numpy(synth_requirement_arrays(rng, T), "cpu"))


def t(a):
    return torch.from_numpy(np.array(a))


def same(got, ref, what=""):
    np.testing.assert_array_equal(bits(np.asarray(got)), bits(np.asarray(ref)), err_msg=what)


# ---------------------------------------------------------------- the mesh


def test_visible_devices_follow_the_virtual_count():
    prev = platform.force_virtual_devices(None, "cpu")
    try:
        assert platform.visible_devices("cpu") == (torch.device("cpu"),)
        assert platform.force_virtual_devices(4, "cpu") is None
        assert platform.visible_devices("cpu") == (torch.device("cpu"),) * 4
        assert platform.force_virtual_devices(None, "cpu") == 4
        assert len(platform.visible_devices("cpu")) == 1
    finally:
        platform.force_virtual_devices(prev, "cpu")


def test_make_mesh_shape_and_overask(mesh8):
    mesh = pm.make_mesh(device="cpu")
    assert mesh.shape == {"p": 8} and mesh.size == 8
    assert pm.make_mesh(3, "cpu").shape["p"] == 3
    with pytest.raises(ValueError, match="requested 9 devices, only 8 available"):
        pm.make_mesh(9, "cpu")
    assert pad_to_multiple(97, 16) == pm.pad_to_multiple(97, 16) == 112


def test_a_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a host without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pm.make_mesh(1, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchSolveArena(devices=4)


def test_collectives_are_exact_and_never_alias(mesh8):
    mesh = port_mesh(4)
    rng = np.random.default_rng(0)
    parts = [t(rng.integers(-50, 50, 16).astype(np.int32)) for _ in range(4)]
    stack = np.stack([p.numpy() for p in parts])
    for fn, ref in ((pm.pmax, stack.max(0)), (pm.pmin, stack.min(0)), (pm.psum, stack.sum(0))):
        out = fn(parts, mesh)
        assert len(out) == 4 and all(o.dtype == torch.int32 for o in out)
        for o in out:
            np.testing.assert_array_equal(o.numpy(), ref)
            assert all(o.data_ptr() != p.data_ptr() for p in parts)
    np.testing.assert_array_equal(pm.all_gather(parts, mesh).numpy(), stack.reshape(-1))
    reps = pm.replicate(parts[0], mesh)
    assert len({r.data_ptr() for r in reps} | {parts[0].data_ptr()}) == 5
    rows = pm.shard_rows(t(np.arange(12)), port_mesh(3))
    assert [r.tolist() for r in rows] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]


def test_every_launch_wrapper_makes_its_inputs_card_current(monkeypatch):
    """A mesh's shards on several cards launch in turn from one thread, and
    CUDA refuses a launch into another device's stream: every kernel
    wrapper runs with its first argument's card (a tensor's, or encoded
    columns') as the current device, and leaves the CPU alone."""
    from protocol_tpu_torch import kernels

    current = []

    class Guard:  # stands in for torch.cuda.device on a host without cards
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            current.append(self.dev)

        def __exit__(self, *exc):
            current.pop()

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    seen = []
    probe = kernels._on_device(lambda first, x: seen.append((list(current), x)) or x)
    card0, card1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert probe(types.SimpleNamespace(device=card1), 7) == 7
    probe(types.SimpleNamespace(gpu_count=types.SimpleNamespace(device=card1)), x=8)
    probe(types.SimpleNamespace(device=card0), 9)  # already current: no switch
    probe(torch.zeros(1), 10)
    assert seen == [([card1], 7), ([card1], 8), ([], 9), ([], 10)] and current == []
    # keys of a wrapper's other instantiations: K1's biased launch, K11's
    # device one
    wrappers = [n for n in kernels.LAUNCHES
                if n not in ("candidates_forward_rows_biased", "binpack_ffd_device")]
    assert [n for n in wrappers if not hasattr(getattr(kernels, n), "__wrapped__")] == []


# ---------------------------------------------------------------- generation


GEN_CASES = [
    (512, 1024, 8, 64, 16, 8, 8),
    (256, 512, 4, 128, 8, 4, 4),   # rt > 1 (two local tiles)
    (128, 256, 2, 128, 8, 1, 2),   # rt == 1, the argmin branch
    (96, 128, 8, 16, 16, 8, 8),    # one local tile: fewer pool entries than r per shard
]


@pytest.mark.parametrize("P,T,D,tile,k,r,extra,with_parts",
                         [c + (True,) for c in GEN_CASES] + [GEN_CASES[0] + (False,)])
def test_sharded_generation_equals_the_reference(mesh8, P, T, D, tile, k, r, extra, with_parts):
    ep, er = encode_random(5, P, T)
    jw, tw = ZERO_PROX
    ref = j_gen_sharded(ep, er, jw, mesh=j_make_mesh(D), k=k, tile=tile, reverse_r=r,
                        extra=extra, with_parts=with_parts)
    got = ps.candidates_topk_bidir_sharded(*to_port(ep, er), tw, mesh=port_mesh(D), k=k,
                                           tile=tile, reverse_r=r, extra=extra,
                                           with_parts=with_parts)
    assert len(got) == len(ref)
    for name, g, o in zip(("cand_p", "cand_c", "fwd_p", "fwd_c", "pool_t", "pool_c"), got, ref):
        same(g, o, name)
    # D-invariant: the port's one-device pass gives the same bits
    tp, tr = to_port(ep, er)
    fp, fc, rt_, rc, pt, pc = osp.candidates_topk_reverse(tp, tr, tw, k=k, tile=tile,
                                                          reverse_r=r, with_pools=True)
    one = (*osp.merge_reverse_candidates(fp, fc, rt_, rc, extra=extra), fp, fc, pt, pc)
    for g, o in zip(got, one):
        same(g, o)


@pytest.mark.parametrize("D", [2, 4, 8])
def test_sharded_generation_is_D_invariant_at_default_weights(mesh8, D):
    """The port's own contract at CostWeights() (the haversine on): the
    sharded pass equals the one-device pass bit for bit, as the
    reference's test_bit_parity_with_single_device holds its own. (Against
    the reference the tests compare at proximity 0: XLA's and torch's
    transcendentals differ in the last bit.)"""
    P, T, tile, k, r, extra = 192, 512, 32, 16, 8, 8
    tp, tr = synth_market(11, P, T)
    assert bool(tp.has_location.all()) and bool(tr.has_location.all())
    tw = CostWeights()
    got = ps.candidates_topk_bidir_sharded(tp, tr, tw, mesh=port_mesh(D), k=k, tile=tile,
                                           reverse_r=r, extra=extra, with_parts=True)
    fp, fc, rt_, rc, pt, pc = osp.candidates_topk_reverse(tp, tr, tw, k=k, tile=tile,
                                                          reverse_r=r, with_pools=True)
    one = (*osp.merge_reverse_candidates(fp, fc, rt_, rc, extra=extra), fp, fc, pt, pc)
    for name, g, o in zip(("cand_p", "cand_c", "fwd_p", "fwd_c", "pool_t", "pool_c"), got, one):
        same(g, o, name)
    # what the contract rests on: the plain cost of a cell does not depend
    # on the slice it is scored in
    from protocol_tpu_torch.ops.cost import cost_matrix
    from protocol_tpu_torch.ops.encoding import slice_requirements

    full = cost_matrix(tp, tr, tw)[0]
    for width in (1, 7, tile, T // D):
        sliced = torch.cat([cost_matrix(tp, slice_requirements(tr, t0, min(width, T - t0)), tw)[0]
                            for t0 in range(0, T, width)], dim=1)
        same(sliced, full, f"slices of {width}")


def test_sharded_generation_refuses_what_does_not_divide(mesh8):
    tp, tr = to_port(*encode_random(5, 64, 96))
    with pytest.raises(ValueError, match="local task count 12 not divisible by tile=64"):
        ps.candidates_topk_bidir_sharded(tp, tr, mesh=port_mesh(8), k=8, tile=64)
    with pytest.raises(ValueError, match="not divisible by mesh size 5"):
        ps.candidates_topk_bidir_sharded(tp, tr, mesh=port_mesh(5), k=8, tile=8)


# ---------------------------------------------------------------- the repair


@pytest.mark.parametrize("D", [None, 1, 4])
@pytest.mark.parametrize("dirty_p,dirty_t", [
    ([5, 17, 40], []),          # provider-side churn only
    ([], [3, 60, 100, 101]),    # requirement-side churn only
    ([2, 90], [0, 127]),        # both sides
    ([], []),                   # an empty event: a no-op
])
def test_repair_matches_regen_bit_for_bit(mesh8, D, dirty_p, dirty_t):
    P, T, k, tile, r, extra = 96, 128, 16, 16, 8, 8
    jw, tw = ZERO_PROX
    ep, er = encode_random(5, P, T)
    if D is None:
        parts = j_topk_reverse(ep, er, jw, k=k, tile=tile, reverse_r=r, with_pools=True)
        fwd_p, fwd_c, pool_t, pool_c = (np.asarray(parts[i]) for i in (0, 1, 4, 5))
    else:
        parts = j_gen_sharded(ep, er, jw, mesh=j_make_mesh(D), k=k, tile=tile, reverse_r=r,
                              extra=extra, with_parts=True)
        fwd_p, fwd_c, pool_t, pool_c = (np.asarray(a) for a in parts[2:])
    ep2, er2 = bump(ep, er, dirty_p, dirty_t)
    ref = j_repair(ep2, er2, jw, fwd_p=fwd_p, fwd_c=fwd_c, pool_t=pool_t, pool_c=pool_c,
                   dirty_p=np.asarray(dirty_p, np.int64), dirty_t=np.asarray(dirty_t, np.int64),
                   reverse_r=r, mesh=None if D is None else j_make_mesh(D), tile=tile,
                   extra=extra)
    got = ps.repair_topk_bidir(*to_port(ep2, er2), tw, fwd_p=fwd_p, fwd_c=fwd_c, pool_t=pool_t,
                               pool_c=pool_c, dirty_p=dirty_p, dirty_t=dirty_t, reverse_r=r,
                               mesh=None if D is None else port_mesh(D), tile=tile, extra=extra)
    for name, g, o in zip(("cand_p", "cand_c", "fwd_p", "fwd_c", "pool_t", "pool_c"),
                          got[:6], ref[:6]):
        same(g, o, name)
    assert got[6] == {key: v for key, v in ref[6].items() if key != "pad_hw"}
    # repaired == regen at the same D
    if D is not None:
        regen = ps.candidates_topk_bidir_sharded(*to_port(ep2, er2), tw, mesh=port_mesh(D), k=k,
                                                 tile=tile, reverse_r=r, extra=extra,
                                                 with_parts=True)
        for g, o in zip(got[:6], regen):
            same(g, o)


@pytest.mark.parametrize("d_fold", [1, 2, 4, 8])
def test_refold_lanes_take_fewer_tiles_than_r(d_fold):
    """K5's plain version at D lanes of n_tiles / D tiles (fewer than r at
    D = 4, 8) against the reference's fold replay."""
    from protocol_tpu.parallel.sparse import _build_repair_refold

    rng = np.random.default_rng(d_fold)
    P, n_tiles, r = 40, 8, 6
    pool_c = rng.choice(np.float32([1.0, 2.0, 2.5, 1e9]), (P, n_tiles)).astype(np.float32)
    pool_t = rng.integers(0, 64, (P, n_tiles)).astype(np.int32)
    ref = _build_repair_refold(P, n_tiles, 1, r, d_fold)(jnp.asarray(pool_t), jnp.asarray(pool_c))
    got = ps.repair_refold(t(pool_t), t(pool_c), r, 1, d_fold)
    for g, o in zip(got, ref):
        same(g, o)


def test_enter_scan_at_a_shard_offset_keys_the_global_ids():
    """K3's plain version on a shard's rows at its offset equals the rows
    of the one-device scan."""
    P, T = 64, 96
    tp, tr = to_port(*encode_random(3, P, T))
    w = ZERO_PROX[1]
    p_ids = torch.tensor([1, 9, 33, 60])
    thresh = torch.full((T,), 3.0)
    full = ps.repair_enter(tp, tr, w, p_ids, thresh)
    for off in (0, 32, 64):
        part = ps.repair_enter(tp, osp.slice_requirements(tr, off, 32), w, p_ids,
                               thresh[off:off + 32], offset=off)
        assert torch.equal(part, full[off:off + 32])


# ---------------------------------------------------------------- the auction


def cands(seed, P, T, p_infeasible, k=16):
    rng = np.random.default_rng(seed)
    cost = random_cost(rng, P, T, p_infeasible=p_infeasible)
    return build_candidates(cost, k=min(k, P))


@pytest.mark.parametrize("seed,P,T,D", [(0, 48, 64, 8), (1, 64, 64, 4), (2, 32, 96, 2)])
def test_sharded_jacobi_parity(mesh8, seed, P, T, D):
    cp, cc = cands(seed, P, T, 0.15)
    kw = dict(num_providers=P, eps=0.05, max_iters=4000, frontier=T, retire=False)
    ref = j_sharded(jnp.asarray(cp), jnp.asarray(cc), mesh=j_make_mesh(D), **kw)
    got = ps.assign_auction_sparse_sharded(t(cp), t(cc), mesh=port_mesh(D), **kw)
    same(got.provider_for_task, ref.provider_for_task)
    same(got.task_for_provider, ref.task_for_provider)
    # the Jacobi schedule: the single-device auction's result
    one = osp.assign_auction_sparse(t(cp), t(cc), **kw)
    same(got.provider_for_task, one.provider_for_task)


@pytest.mark.parametrize("D", [2, 8])
def test_sharded_contention_with_retirement(mesh8, D):
    cp, cc = cands(5, 16, 64, 0.2)  # oversubscribed: retirement acts
    ref = j_sharded(jnp.asarray(cp), jnp.asarray(cc), 16, j_make_mesh(D), eps=0.05)
    got = ps.assign_auction_sparse_sharded(t(cp), t(cc), 16, port_mesh(D), eps=0.05)
    same(got.provider_for_task, ref.provider_for_task)
    assert int((got.provider_for_task >= 0).sum()) > 0


CPU, CARD0, CARD1 = torch.device("cpu"), torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.parametrize("devices,Tl,K,B,route", [
    ((CPU,) * 4, 256, 16, 64, "plain"),
    ((CARD0,) * 4, 16384, 80, 4096, "segment"),  # the mesh matcher's shape on one card
    ((CARD0, CARD1), 256, 16, 64, "rounds"),  # shards on two cards
    ((CARD0,) * 4, 256, 129, 64, "rounds"),  # more candidates than the launch takes
    ((CARD0,) * 33, 256, 16, 64, "rounds"),  # more shards than the launch takes
])
def test_segment_route_follows_the_devices_and_shapes(devices, Tl, K, B, route):
    """K16's route is decided from the mesh's devices and the shapes alone
    (no card is asked): the segment launch for one card repeated, the three
    launches a round across cards or for a shape the launch refuses, the
    plain rounds off a card."""
    assert ps.segment_route(devices, Tl, K, B) == route


@pytest.mark.parametrize("case", ["dtype", "frontier", "candidates"])
def test_mesh_segment_refuses_before_loading_a_library(monkeypatch, case):
    """K16's segment wrapper refuses a wrong dtype, B > Tl and K > 128 with
    ValueError before it builds or loads a kernel library."""
    from protocol_tpu_torch import kernels

    def no_library(name):
        raise AssertionError(f"the wrapper loaded {name} before refusing")

    monkeypatch.setattr(kernels, "_lib", no_library)
    monkeypatch.setattr(kernels, "k2_cluster", no_library)
    D, Tl, K, P, B = 2, 64, 8, 50, 16
    K = 129 if case == "candidates" else K
    B = Tl + 1 if case == "frontier" else B
    st = (  # the stacked shard fields, in the wrapper's order
        torch.zeros((D, Tl, K), dtype=torch.int32),
        torch.zeros((D, Tl, K), dtype=torch.float64 if case == "dtype" else torch.float32),
        torch.ones((D, Tl), dtype=torch.uint8), torch.zeros((D, 1)), torch.zeros((D, P)),
        torch.full((D, P), -1, dtype=torch.int32), torch.full((D, Tl), -1, dtype=torch.int32),
        torch.zeros((D, Tl), dtype=torch.uint8), torch.zeros((D, kernels.MESH_CTL),
                                                            dtype=torch.int32),
    )
    with pytest.raises(ValueError, match="segment"):
        kernels.mesh_segment(*st, eps=1.0, B=B, max_iters=8, stall_limit=0, fresh=True)


@pytest.mark.parametrize("route", ["segment", "plain"])
def test_segment_routes_of_one_device_refuse_unstacked_shards(mesh8, route):
    """The segment launch and the plain rounds run over the stacked shards
    of a mesh of views of one device: given none, ``_segment`` raises."""
    cp, cc = cands(3, 32, 64, 0.2)
    P = 32
    state = (torch.zeros(P), torch.full((P,), -1, dtype=torch.int32),
             torch.full((64,), -1, dtype=torch.int32), torch.zeros(64, dtype=torch.bool))
    mesh = port_mesh(4)
    shards, stacked = ps._make_shards(mesh, t(cp), t(cc), True, *state, 8)
    assert stacked is not None
    with pytest.raises(ValueError, match="views of one device"):
        ps._segment(mesh, shards, None, 64, 1.0, 8, 16, 0, route)


def test_auction_header_is_mirrored_by_the_wrapper():
    """kernels.py's CTL_* and the segment launch's limits are the values of
    csrc/auction.cuh, which both auction sources include."""
    import math
    import re

    from protocol_tpu_torch import kernels

    src = (kernels.CSRC / "auction.cuh").read_text()
    names = re.search(r"enum Ctl \{([^}]*)\}", src).group(1).replace(" ", "").split(",")
    assert names[-1] == "kCtl" and len(names) == kernels.MESH_CTL + 1
    for i, n in enumerate(names[:-1]):
        assert getattr(kernels, "CTL_" + re.sub(r"(?<!^)(?=[A-Z])", "_", n[1:]).upper()) == i
    limits = {n: math.prod(int(f) for f in v.split("*"))
              for n, v in re.findall(r"constexpr int (kMax\w+) = ([^;]+);", src)}
    assert limits["kMaxShards"] == kernels.MESH_SEGMENT_MAX_SHARDS
    assert limits["kMaxOpenBytes"] == kernels.MESH_SEGMENT_OPEN_BYTES
    for name in ("auction", "mesh_auction"):
        assert '#include "auction.cuh"' in (kernels.CSRC / f"{name}.cu").read_text()


def test_sharded_auctions_refuse_what_does_not_divide(mesh8):
    mesh = port_mesh(8)
    cp, cc = torch.zeros((12, 4), dtype=torch.int32), torch.zeros((12, 4))
    with pytest.raises(ValueError, match="not divisible by mesh size 8"):
        ps.assign_auction_sparse_sharded(cp, cc, 4, mesh)
    with pytest.raises(ValueError, match="not divisible by mesh size 8"):
        ps.assign_auction_sparse_scaled_sharded(cp, cc, 4, mesh)
    with pytest.raises(ValueError, match="not divisible by mesh size 8"):
        ps.assign_auction_sparse_warm_sharded(cp, cc, 4, mesh, price0=torch.zeros(4),
                                              p4t0=torch.full((12,), -1, dtype=torch.int32))


SCALED_CASES = [  # seed, P, T, D, p_infeasible, frontier, frontier_ladder
    (3, 96, 128, 4, 0.1, 128, False),   # the reference's Jacobi case
    (7, 128, 256, 8, 0.2, 64, True),    # the per-shard frontier refit
    (9, 40, 128, 2, 0.3, 4096, True),   # oversubscribed: binding retirement
]


@pytest.mark.parametrize("seed,P,T,D,p_inf,frontier,ladder", SCALED_CASES)
def test_scaled_and_warm_sharded_equal_the_reference(mesh8, seed, P, T, D, p_inf, frontier,
                                                     ladder):
    cp, cc = cands(seed, P, T, p_inf)
    kw = dict(num_providers=P, eps_start=2.0, eps_end=0.02, frontier=frontier,
              frontier_ladder=ladder, with_state=True)
    r_stats, g_stats = {}, {}
    ref = j_scaled_sharded(jnp.asarray(cp), jnp.asarray(cc), mesh=j_make_mesh(D),
                           stats_out=r_stats, **kw)
    got = ps.assign_auction_sparse_scaled_sharded(t(cp), t(cc), mesh=port_mesh(D),
                                                  stats_out=g_stats, **kw)
    for g, o in zip((got[0].provider_for_task, got[1], got[2]),
                    (ref[0].provider_for_task, ref[1], ref[2])):
        same(g, o)
    assert g_stats == r_stats
    # warm from the cold state with the first tenth re-opened, the
    # retirement carried
    p4t0 = np.asarray(ref[0].provider_for_task).copy()
    p4t0[: T // 10] = -1
    kw = dict(num_providers=P, price0=np.asarray(ref[1]), p4t0=p4t0, eps=0.02,
              frontier=frontier, frontier_ladder=ladder, retired0=np.asarray(ref[2]),
              with_state=True)
    ref_w = j_warm_sharded(jnp.asarray(cp), jnp.asarray(cc), mesh=j_make_mesh(D),
                           **{k_: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                              for k_, v in kw.items()})
    got_w = ps.assign_auction_sparse_warm_sharded(
        t(cp), t(cc), mesh=port_mesh(D),
        **{k_: t(v) if isinstance(v, np.ndarray) else v for k_, v in kw.items()})
    for g, o in zip((got_w[0].provider_for_task, got_w[1], got_w[2]),
                    (ref_w[0].provider_for_task, ref_w[1], ref_w[2])):
        same(g, o)


def test_scaled_sharded_jacobi_parity_with_one_device(mesh8):
    cp, cc = cands(3, 96, 128, 0.1)
    kw = dict(num_providers=96, eps_start=2.0, eps_end=0.02, frontier=128, with_prices=True)
    res, price = ps.assign_auction_sparse_scaled_sharded(t(cp), t(cc), mesh=port_mesh(4), **kw)
    kw.pop("with_prices")
    one, one_price, _ = osp.assign_auction_sparse_scaled(t(cp), t(cc), with_state=True, **kw)
    same(res.provider_for_task, one.provider_for_task)
    same(price, one_price)


def test_degenerate_all_equal_costs(mesh8):
    """Every bid ties: the global winner is the pmin of the shards' lowest
    global task ids, as one device's lowest-index rule."""
    cost = np.full((64, 64), 3.0, np.float32)
    cp, cc = build_candidates(cost, k=16)
    kw = dict(num_providers=64, eps=0.05, max_iters=500, frontier=64, retire=False)
    ref = j_sharded(jnp.asarray(cp), jnp.asarray(cc), mesh=j_make_mesh(8), **kw)
    got = ps.assign_auction_sparse_sharded(t(cp), t(cc), mesh=port_mesh(8), **kw)
    same(got.provider_for_task, ref.provider_for_task)
    assert int((got.provider_for_task >= 0).sum()) == 16


@pytest.mark.parametrize("T_real,D", [(97, 8)])
def test_uneven_tail_padding(mesh8, T_real, D):
    P = 128
    T_pad = pad_to_multiple(T_real, D * 16)
    cp, cc = cands(T_real, P, T_real, 0.1)
    cp = np.concatenate([cp, np.full((T_pad - T_real, 16), -1, np.int32)])
    cc = np.concatenate([cc, np.full((T_pad - T_real, 16), np.float32(1e9))])
    kw = dict(num_providers=P, eps_start=2.0, eps_end=0.02, max_iters_per_phase=4000,
              frontier=T_pad)
    ref = j_scaled_sharded(jnp.asarray(cp), jnp.asarray(cc), mesh=j_make_mesh(D), **kw)
    got = ps.assign_auction_sparse_scaled_sharded(t(cp), t(cc), mesh=port_mesh(D), **kw)
    same(got.provider_for_task, ref.provider_for_task)
    assert not (got.provider_for_task[T_real:] >= 0).any()


# ---------------------------------------------------------------- the arena


def arena_market():
    return encode_random(9, 128, 64)


def bump_price(ep, rows, delta=0.25):
    price = np.array(ep.price, copy=True)
    price[list(rows)] += delta
    return dataclasses.replace(ep, price=price)


@pytest.mark.parametrize("D", [2, 4, 8])
def test_arena_at_D_equals_the_reference_tick_by_tick(mesh8, D):
    """TorchSolveArena(devices=D) against JaxSolveArena(devices=D): a cold
    tick, a warm provider-churn tick, an apply_rows event; the structure,
    prices and matching at every step, and the same at devices=1."""
    ep, er = arena_market()
    jw, tw = ZERO_PROX
    ref, got, one = JaxSolveArena(k=16, devices=D), TorchSolveArena(k=16, devices=D, device="cpu"), \
        TorchSolveArena(k=16, devices=1, device="cpu")
    steps = [(ep, er), (bump_price(ep, [3]), er)]
    for i, (e, r_) in enumerate(steps):
        p_ref = ref.solve(e, r_, jw)
        p_got = got.solve(*to_port(e, r_), tw)
        p_one = one.solve(*to_port(e, r_), tw)
        np.testing.assert_array_equal(p_got, p_ref)
        np.testing.assert_array_equal(p_got, p_one)
        rs, gs = ref.last_stats, got.last_stats
        assert gs["gen_sharded"] is rs["gen_sharded"] is True
        assert gs["torch_devices"] == rs["jax_devices"] == D
        assert gs["cand_cold_passes"] == rs["cand_cold_passes"] == (1 if i == 0 else 0)
        assert one.last_stats["gen_sharded"] is False
        js, ts, os_ = ref.export_state(), got.export_state(), one.export_state()
        for name in ("cand_p", "cand_c", "fwd_p", "fwd_c", "pool_t", "pool_c", "price"):
            same(ts[name], js[name], name)
            same(ts[name], os_[name], name)
    pf = j_canon(ep, J_P_SPEC)
    rows = np.array([7], np.int32)
    vals = {n: np.asarray(pf[n][rows]) for n, _ in J_P_SPEC}
    vals["price"] = vals["price"] + 0.5
    p_ref = ref.apply_rows(rows, vals, None, None, jw)
    p_got = got.apply_rows(rows, vals, None, None, tw)
    np.testing.assert_array_equal(p_got, p_ref)
    assert got.last_stats["gen_sharded"] is True and got.last_stats["cand_cold_passes"] == 0
    same(got.export_state()["pool_c"], ref.export_state()["pool_c"])


def test_arena_at_default_weights_is_D_invariant_and_repairs_to_regen(mesh8):
    """TorchSolveArena(devices=4) at CostWeights() on the synthetic
    marketplace (every row located) over a cold tick, a requirement churn
    tick and a provider churn tick: every tick equals devices=1 and a
    fresh cold pass at D = 4 bit for bit (the chip run's chain, at a CPU
    size)."""
    from protocol_tpu_torch.trace.synth import synth_provider_arrays, synth_requirement_arrays

    n = 512
    pa = synth_provider_arrays(np.random.default_rng(13), n)
    ra = synth_requirement_arrays(np.random.default_rng(14), n)
    ticks = [(pa, ra)]
    ram = ra["ram_mb"].copy()
    ram[[3, 200, 511]] += 512
    ticks.append((pa, dict(ra, ram_mb=ram)))
    price = pa["price"].copy()
    price[[5, 77]] += np.float32(0.25)
    ticks.append((dict(pa, price=price), ticks[-1][1]))
    tw = CostWeights()
    a4 = TorchSolveArena(k=16, devices=4, device="cpu")
    a1 = TorchSolveArena(k=16, devices=1, device="cpu")
    for pcols, rcols in ticks:
        cols = (types.SimpleNamespace(**pcols), types.SimpleNamespace(**rcols))
        p4 = a4.solve(*cols, tw)
        np.testing.assert_array_equal(p4, a1.solve(*cols, tw))
        assert a4.last_stats["gen_sharded"] is True
        fresh = TorchSolveArena(k=16, devices=4, cold_every=0, device="cpu")
        fresh.solve(*cols, tw)
        s4, s1, sf = a4.export_state(), a1.export_state(), fresh.export_state()
        for name in ("cand_p", "cand_c", "fwd_p", "fwd_c", "pool_t", "pool_c", "price"):
            same(s4[name], s1[name], name)
        for name in ("cand_p", "cand_c", "fwd_p", "fwd_c", "pool_t", "pool_c"):
            same(s4[name], sf[name], name)
    assert a4.last_stats["cand_cold_passes"] == 0


def test_arena_overask_clamps_counted_never_another_engine(mesh8):
    ep, er = arena_market()
    jw, tw = ZERO_PROX
    got = TorchSolveArena(k=16, devices=64, device="cpu")
    p_got = got.solve(*to_port(ep, er), tw)
    assert got.device_degraded is True and got.device_degraded_events == 1
    s = got.last_stats
    assert s["engine"] == "torch" and s["device_degraded"] is True and s["torch_devices"] == 8
    all_ = TorchSolveArena(k=16, devices=0, device="cpu")  # 0 = every visible device
    np.testing.assert_array_equal(all_.solve(*to_port(ep, er), tw), p_got)
    assert all_.device_degraded is False and all_.last_stats["torch_devices"] == 8
    ref = JaxSolveArena(k=16, devices=64)
    np.testing.assert_array_equal(ref.solve(ep, er, jw), p_got)


def test_arena_indivisible_task_count_generates_on_one_device(mesh8):
    ep, er = encode_random(9, 96, 63)
    jw, tw = ZERO_PROX
    got = TorchSolveArena(k=16, devices=4, device="cpu")
    p_got = got.solve(*to_port(ep, er), tw)
    assert got.last_stats["gen_sharded"] is False and got.last_stats["torch_devices"] == 4
    ref = JaxSolveArena(k=16, devices=4)
    np.testing.assert_array_equal(p_got, ref.solve(ep, er, jw))
    same(got.export_state()["cand_p"], ref.export_state()["cand_p"])


# ---------------------------------------------------------------- the matcher


def mesh_store(n_nodes, tasks):
    ctx = StoreContext.new_test()
    populate(ctx, n_nodes, tasks)
    return ctx


@pytest.mark.parametrize("warm_start", [True, False])
def test_use_mesh_matcher_equals_the_reference(mesh8, warm_start):
    """TestMeshMatcher's stores on the sparse route: the cached route
    (warm_start) and the stateless one, whose generation shards too; cold
    then warm, the dicts and the mesh stats equal to the reference's."""
    ctx = mesh_store(64, [
        mk_bounded_task("a", 1.0, 24, "gpu:count=8;gpu:model=H100"),
        mk_bounded_task("b", 2.0, 24, "gpu:count=8;gpu:model=H100"),
    ])
    kw = dict(min_solve_interval=0.0, dense_cell_budget=1, use_mesh=True, warm_start=warm_start)
    ref = TpuBatchMatcher(ctx, **kw)
    got = TorchBatchMatcher(ctx, device="cpu", **kw)
    assert got._mesh is not None and got._mesh.size == 8
    for step in range(2):
        ref.mark_dirty()
        got.mark_dirty()
        ref._ensure_fresh()
        got._ensure_fresh()
        assert got._assignment == ref._assignment, step
        rs, gs = ref.last_solve_stats, got.last_solve_stats
        for key in ("kernel", "assigned", "mesh_sharded", "mesh_gen_sharded", "warm",
                    "warm_seeded_slots", "stall_exit"):
            assert gs[key] == rs[key], (step, key)
        assert gs["mesh_sharded"] is True and gs["assigned"] == 48
        assert gs["mesh_gen_sharded"] is (not warm_start and step == 0)


@pytest.mark.parametrize("warm_start", [True, False])
def test_use_mesh_matcher_reports_the_route(mesh8, warm_start):
    """Both sparse routes report how the sharded phase ran its rounds
    (mesh_route: the plain rounds on the CPU's views), and only when the
    mesh engaged."""
    ctx = mesh_store(64, [mk_bounded_task("a", 1.0, 24, "gpu:count=8;gpu:model=H100")])
    kw = dict(min_solve_interval=0.0, dense_cell_budget=1, warm_start=warm_start)
    got = TorchBatchMatcher(ctx, device="cpu", use_mesh=True, **kw)
    got.refresh()
    assert got.last_solve_stats["mesh_sharded"] is True
    assert got.last_solve_stats["mesh_route"] == "plain"
    one = TorchBatchMatcher(ctx, device="cpu", **kw)
    one.refresh()
    assert "mesh_route" not in one.last_solve_stats


def test_use_mesh_counts_match_unsharded(mesh8):
    def solve(use_mesh):
        ctx = mesh_store(96, [mk_bounded_task("a", 1.0, 40, "gpu:count=8;gpu:model=H100")])
        kw = dict(min_solve_interval=0.0, dense_cell_budget=1, use_mesh=use_mesh)
        ref = TpuBatchMatcher(ctx, **kw)
        got = TorchBatchMatcher(ctx, device="cpu", **kw)
        ref.refresh()
        got.refresh()
        assert got._assignment == ref._assignment
        assert got.last_solve_stats["mesh_sharded"] is ref.last_solve_stats["mesh_sharded"]
        assert got.last_solve_stats["mesh_sharded"] is use_mesh
        return got.last_solve_stats["assigned"]

    # the sharded frontier is another, equally valid auction order
    assert solve(True) == solve(False) == 40


def test_use_mesh_slot_count_that_does_not_divide_solves_on_one_device(caplog):
    """Six views and 64 slot rows: the auction solves on one device, logged
    once and reported (mesh_sharded False), equal to the matcher without
    the mesh; generation shards neither (64 % 6 != 0)."""
    prev = platform.force_virtual_devices(6, "cpu")
    try:
        ctx = mesh_store(96, [mk_bounded_task("a", 1.0, 40, "gpu:count=8;gpu:model=H100")])
        kw = dict(min_solve_interval=0.0, dense_cell_budget=1, warm_start=False)
        got = TorchBatchMatcher(ctx, device="cpu", use_mesh=True, **kw)
        one = TorchBatchMatcher(ctx, device="cpu", **kw)
        with caplog.at_level("WARNING"):
            got.refresh()
            got.mark_dirty()
            got.refresh()
        assert caplog.text.count("not divisible by the 6-device mesh") == 1
        one.refresh()
        assert got._assignment == one._assignment
        st = got.last_solve_stats
        assert st["mesh_sharded"] is False and st["mesh_gen_sharded"] is False
    finally:
        platform.force_virtual_devices(prev, "cpu")


def test_use_mesh_with_one_visible_device_solves_on_one_device(caplog):
    prev = platform.force_virtual_devices(None, "cpu")
    try:
        ctx = mesh_store(32, [mk_bounded_task("a", 1.0, 8, "gpu:count=8;gpu:model=H100")])
        with caplog.at_level("WARNING"):
            got = TorchBatchMatcher(ctx, device="cpu", use_mesh=True, dense_cell_budget=1)
        assert "only one device is visible" in caplog.text
        assert got._mesh is None
        got.refresh()
        assert got.last_solve_stats["mesh_sharded"] is False
        assert got.last_solve_stats["assigned"] == 8
    finally:
        platform.force_virtual_devices(prev, "cpu")


@pytest.mark.parametrize("engine", ["torch:2", "torch:4", "torch:0"])
def test_torch_D_matcher_equals_jax_D(mesh8, engine):
    D = engine.partition(":")[2]
    ctx = sc_mixed(seed=12, n_nodes=96, n_bounded=10, n_unbounded=3)
    jw = JCostWeights(priority=1.0, proximity=0.0)
    ref = TpuBatchMatcher(ctx, weights=jw, native_engine=f"jax:{D}")
    got = TorchBatchMatcher(ctx, weights=port_weights(jw), native_engine=engine, device="cpu")
    ref.refresh()
    got.refresh()
    assert got._assignment == ref._assignment
    rs, gs = ref.last_solve_stats, got.last_solve_stats
    assert gs["arena_torch_devices"] == rs["arena_jax_devices"] == (int(D) or 8)
    for key in ("arena_gen_sharded", "arena_assigned", "arena_cold", "arena_device_degraded"):
        assert gs[key] == rs[key], key
