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
from protocol_tpu_torch.trace.synth import (
    synth_provider_arrays,
    synth_providers,
    synth_requirement_arrays,
    synth_requirements,
)

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


# ---------------- NaN cells (shared with the CPU tests) ----------------
# The wire columns the backend's RPCs decode are not checked, so a NaN
# priority or price reaches the kernels. nan_edit makes both: a NaN price
# on one provider (every cell of its row that is compatible costs NaN) and
# a NaN priority on a task freed of every requirement (compatible with
# every valid provider, so its whole column is NaN, and K1's forward row
# of it has no cell that is not NaN). The CPU tests hold the plain
# versions against the reference on the edit; the card tests hold the
# kernels against the plain versions.

NAN_TASK, NAN_PROVIDER = 5, 7


def _with(cols, idx, **values):
    """A copy of encoded columns (the reference's numpy arrays or the
    port's tensors) with ``values`` set at row ``idx``."""
    import dataclasses

    out = {}
    for name, v in values.items():
        a = getattr(cols, name)
        a = a.clone() if torch.is_tensor(a) else np.array(a, copy=True)
        a[idx] = v
        out[name] = a
    return dataclasses.replace(cols, **out)


def nan_edit(ep, er, ram_mb: int = -1, task: int = NAN_TASK, provider: int = NAN_PROVIDER):
    """(ep, er) with a NaN price on ``provider`` and a NaN priority on
    ``task``, which asks for nothing but ``ram_mb`` (-1: no limit; the
    providers' median RAM: about half of them fit it)."""
    nan = float("nan")
    ep = _with(ep, provider, price=nan)
    er = _with(er, task, priority=nan, cpu_required=False, cpu_cores=-1, ram_mb=ram_mb,
               storage_gb=-1, gpu_opt_valid=False, valid=True)
    return ep, er


def median_ram(ep) -> int:
    ram = ep.ram_mb.cpu().numpy() if torch.is_tensor(ep.ram_mb) else np.asarray(ep.ram_mb)
    return int(np.median(ram))


# ---------------- K2's cluster cases (shared with tests/test_torch_auction.py) ----------------
# Each case is a phase call (candidates, state, eps, rounds, frontier) that
# stresses one seam of K2's cluster layout: the open set's words split into
# C contiguous slices, one a block, and the frontier, the bids and the
# seats spread over the blocks. The CPU tests hold the port's plain phase
# against the reference on each case; the card tests hold K2 against the
# plain rounds at every cluster size the card runs. Defined here, in a
# file that imports no JAX, so that the card tests can run without it.

K2_CLUSTER_SIZES = (8, 16)  # the sizes the wrapper picks; the card tests add C = 1


def k2_slice(t, T: int, C: int):
    """The block of a C-block cluster whose shared memory holds task t's
    open bit (t may be an array)."""
    wpb = -(-((T + 31) // 32) // C)
    return (np.asarray(t) // 32) // wpb


def _market(seed: int, T: int, P: int, K: int, hi: float = 5.0):
    rng = np.random.default_rng(seed)
    cp = np.stack([rng.choice(P, K, replace=False) for _ in range(T)]).astype(np.int32)
    cc = rng.uniform(0.0, hi, (T, K)).astype(np.float32)
    return cp, cc


def _state(P: int, T: int, price=None, owner=None, p4t=None, retired=None):
    return (
        np.int32(0),
        np.zeros(P, np.float32) if price is None else price.astype(np.float32),
        np.full(P, -1, np.int32) if owner is None else owner.astype(np.int32),
        np.full(T, -1, np.int32) if p4t is None else p4t.astype(np.int32),
        np.zeros(T, bool) if retired is None else retired.astype(bool),
    )


def _plain(case, rounds: int, state=None):
    """The port's plain rounds on a case (CPU), from ``state`` (default the
    case's), for ``rounds`` rounds: the state after them."""
    cp, cc = torch.from_numpy(case["cp"]), torch.from_numpy(case["cc"])
    st = case["state"] if state is None else state
    if st is None:
        st = _state(case["P"], cp.shape[0])
    st = tuple(torch.from_numpy(np.array(a)) for a in st)
    inputs = sp._phase_inputs(cp, cc, case["retire"])
    B = min(case["frontier"], cp.shape[0])
    out, _ = sp._auction_rounds_plain(*inputs, st, case["P"], case["eps"], rounds, B, 0)
    return tuple(a.numpy() for a in out)


def _open(case, state) -> np.ndarray:
    """Indices of the open tasks (unassigned, with a candidate, unretired)."""
    feasible = (case["cp"] >= 0).any(axis=1)
    return np.flatnonzero((state[3] < 0) & feasible & ~state[4])


def _check_ragged(case):
    T = case["cp"].shape[0]
    n_words = (T + 31) // 32
    assert T % 32 != 0, "the last word is ragged"
    for C in K2_CLUSTER_SIZES:
        slices = k2_slice(np.arange(T), T, C)
        assert np.unique(slices).size >= 2, f"tasks span several slices at C={C}"
    assert n_words % -(-n_words // 8) != 0, "the last slice is short at C=8"
    assert -(-n_words // 16) * 15 >= n_words, "some block owns no word at C=16"


def _check_ties(case):
    T = case["cp"].shape[0]
    valid = case["cp"] >= 0
    assert np.unique(case["cc"][valid]).size == 1, "every candidate at one cost"
    # the first round: every open task bids on its first candidate (all
    # values tie, the first argmax), all bids equal
    front = _open(case, _state(case["P"], T))[: case["frontier"]]
    p1 = case["cp"][front, 0]
    for C in K2_CLUSTER_SIZES:
        sl = k2_slice(front, T, C)
        cross = [p for p in np.unique(p1) if np.unique(sl[p1 == p]).size > 1]
        assert cross, f"equal bids from tasks of different slices at C={C}"


def _check_wide(case):
    T = case["cp"].shape[0]
    n_open = _open(case, _state(case["P"], T))
    for C in K2_CLUSTER_SIZES:
        first = (k2_slice(n_open, T, C) == 0).sum()
        assert first < min(case["frontier"], n_open.size), (
            f"the frontier is wider than the first slice's open count at C={C}")


def _check_evictions(case):
    T = case["cp"].shape[0]
    state = _state(case["P"], T)
    crossed = {C: 0 for C in K2_CLUSTER_SIZES}
    evictions = 0
    for _ in range(case["max_iters"]):
        nxt = _plain(case, 1, state)
        owner0, owner1 = state[2], nxt[2]
        moved = (owner0 >= 0) & (owner1 != owner0)
        evictions += int(moved.sum())
        for C in K2_CLUSTER_SIZES:
            crossed[C] += int((k2_slice(owner0[moved], T, C) != k2_slice(owner1[moved], T, C)).sum())
        state = nxt
    assert evictions > 0, "the phase evicts"
    for C in K2_CLUSTER_SIZES:
        assert crossed[C] > 0, f"an evicted task lies in another slice than its evictor at C={C}"


def _check_retire_first(case):
    T = case["cp"].shape[0]
    front = _open(case, case["state"])[: case["frontier"]]
    after = _plain(case, 1)
    newly = np.flatnonzero(after[4] & ~case["state"][4])
    assert newly.size > 0 and np.isin(newly, front).all(), "tasks retire in the first round"
    for C in K2_CLUSTER_SIZES:
        assert np.unique(k2_slice(newly, T, C)).size > 1, f"in several slices at C={C}"


def _check_negative(case):
    price, p4t = case["state"][1], case["state"][3]
    assert price.min() < 0 and (p4t >= 0).any() and _open(case, case["state"]).size > 0, (
        "a carried state with negative prices, seated and open tasks")


def k2_cluster_cases() -> dict:
    """name -> case: ``cp`` [T, K] i32 and ``cc`` [T, K] f32 candidates, ``P``,
    ``state`` (numpy (it, price, owner, p4t, retired), None = from
    scratch), ``eps``, ``max_iters``, ``frontier``, ``retire``, and
    ``check``, which asserts that the case has the property it is named
    for. T <= 1,200."""
    T = 32 * 16 * 2 + 7  # 1,031: 33 words, ragged last, slices of 5 / 3 words
    cases = {}
    cp, cc = _market(1, T, 700, 12)
    cases["ragged"] = dict(cp=cp, cc=cc, P=700, state=None, eps=1.0, max_iters=300,
                           frontier=512, check=_check_ragged)
    cp, _ = _market(2, T, 64, 8)
    cp[::9, 5:] = -1  # some shorter rows, still tied
    cases["ties"] = dict(cp=cp, cc=np.ones(cp.shape, np.float32), P=64, state=None, eps=0.25,
                         max_iters=200, frontier=256, check=_check_ties)
    cp, cc = _market(3, T, 900, 10)
    cp[:200] = -1  # the first slices' tasks have no candidate: never open
    cases["wide"] = dict(cp=cp, cc=cc, P=900, state=None, eps=2.0, max_iters=120,
                         frontier=512, check=_check_wide)
    cp, cc = _market(4, T, 200, 6)
    cases["evictions"] = dict(cp=cp, cc=cc, P=200, state=None, eps=0.05, max_iters=60,
                              frontier=128, check=_check_evictions)
    Tr, Pr = 600, 300
    cp, cc = _market(5, Tr, Pr, 8)
    pricey = np.arange(0, Tr, 12)  # tasks in every slice whose candidates are all dear
    rng = np.random.default_rng(6)
    cp[pricey] = np.stack([rng.choice(20, 8, replace=False) for _ in pricey])
    price = np.zeros(Pr, np.float32)
    price[:20] = 1000.0
    cases["retire_first"] = dict(cp=cp, cc=cc, P=Pr, state=_state(Pr, Tr, price=price),
                                 eps=0.5, max_iters=80, frontier=Tr, check=_check_retire_first)
    cp, cc = _market(7, T, 1100, 16)
    base = dict(cp=cp, cc=cc, P=1100, state=None, eps=1.0, max_iters=400, frontier=1024,
                retire=True)
    warm = _plain(base, 400)
    rng = np.random.default_rng(8)
    p4t = np.where(rng.random(T) < 0.1, -1, warm[3])
    owner = np.full(1100, -1, np.int32)
    owner[p4t[p4t >= 0]] = np.flatnonzero(p4t >= 0)
    price = warm[1] - (warm[1].max() + np.float32(5.0))  # the warm auction's shift
    cases["negative_prices"] = dict(cp=cp, cc=cc, P=1100,
                                    state=_state(1100, T, price, owner, p4t), eps=0.02,
                                    max_iters=200, frontier=64, check=_check_negative)
    for c in cases.values():
        c.setdefault("retire", True)
    return cases


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


def k2_sizes():
    """The cluster sizes K2 runs at on this card: 1, and each of
    K2_CLUSTER_SIZES of which the card fits one cluster."""
    import ctypes

    from protocol_tpu_torch import kernels

    n = ctypes.c_int(0)
    sizes = [1]
    for c in K2_CLUSTER_SIZES:
        rc = kernels._lib("auction").k2_active_clusters(c, ctypes.addressof(n))
        if rc == 0 and n.value >= 1:
            sizes.append(c)
    return sizes


@pytest.mark.parametrize("name", sorted(k2_cluster_cases()))
def test_auction_kernel_cluster_cases_match_plain_bits(card, name):
    """K2 against the plain rounds on each cluster case, at every cluster
    size the card runs, with the stall exit on and off, and with block 0
    taking over small open sets and without: every state tensor and the
    stall count bit for bit."""
    from protocol_tpu_torch import kernels

    c = k2_cluster_cases()[name]
    cp = torch.from_numpy(c["cp"]).to(card)
    cc = torch.from_numpy(c["cc"]).to(card)
    T = cp.shape[0]
    st = c["state"] if c["state"] is not None else _state(c["P"], T)
    st = tuple(torch.from_numpy(np.array(a)).to(card) for a in st)
    inputs = sp._phase_inputs(cp, cc, c["retire"])
    B = min(c["frontier"], T)
    sizes = k2_sizes()
    assert sizes[-1] == kernels.k2_cluster(cp.device)
    switch = kernels.K2_ONE_BLOCK_OPEN
    try:
        for stall_limit in (0, 8):
            ref, r_stall = sp._auction_rounds_plain(*inputs, st, c["P"], c["eps"],
                                                    c["max_iters"], B, stall_limit)
            # block 0 alone from the default open count on, and never
            for kernels.K2_ONE_BLOCK_OPEN in (switch, 0):
                for C in sizes:
                    got, g_stall = kernels.auction_phase(*inputs, st, P=c["P"], eps=c["eps"],
                                                         max_iters=c["max_iters"], B=B,
                                                         stall_limit=stall_limit, cluster=C)
                    what = (C, stall_limit, kernels.K2_ONE_BLOCK_OPEN)
                    assert all(same_bits(a.to(b.dtype), b) for a, b in zip(got, ref)), what
                    assert int(g_stall) == int(r_stall), what
    finally:
        kernels.K2_ONE_BLOCK_OPEN = switch


def test_auction_kernel_refused_cluster_raises(card):
    """A cluster size the card refuses raises with its cudaError, counts no
    launch and falls back to nothing; the next launch is unharmed."""
    from protocol_tpu_torch import kernels

    c = k2_cluster_cases()["ragged"]
    cp = torch.from_numpy(c["cp"]).to(card)
    cc = torch.from_numpy(c["cc"]).to(card)
    inputs = sp._phase_inputs(cp, cc, True)
    st = sp._initial_state(cp.shape[0], c["P"], card)
    before = kernels.LAUNCHES["auction_phase"]
    with pytest.raises(RuntimeError, match="cudaError"):
        kernels.auction_phase(*inputs, st, P=c["P"], eps=1.0, max_iters=8, B=256, stall_limit=0,
                              cluster=32)
    assert kernels.LAUNCHES["auction_phase"] == before
    got, _ = kernels.auction_phase(*inputs, st, P=c["P"], eps=1.0, max_iters=8, B=256,
                                   stall_limit=0)
    ref, _ = sp._auction_rounds_plain(*inputs, st, c["P"], 1.0, 8, 256, 0)
    assert all(same_bits(a.to(b.dtype), b) for a, b in zip(got, ref))


def test_in_place_sums_count_the_launches(card):
    """In-place timing over a cold tick: one sum a launched key, with the
    launches LAUNCHES counts and a positive device time."""
    from protocol_tpu_torch import kernels

    ep = synth_providers(np.random.default_rng(7), 1024, device="cpu")
    er = synth_requirements(np.random.default_rng(8), 1024, device="cpu")
    arena = TorchSolveArena(device=card, cold_every=0)
    torch.cuda.synchronize()
    kernels.reset_launches()
    kernels.time_in_place(True)
    try:
        arena.solve(ep, er, CostWeights())
        sums = kernels.in_place_ms()
    finally:
        kernels.time_in_place(False)
    launched = {k: n for k, n in kernels.LAUNCHES.items() if n}
    assert launched["auction_phase"] > 0
    assert {k: v["launches"] for k, v in sums.items()} == launched
    assert all(v["ms"] > 0 for v in sums.values())


def test_card_cold_tick_matches_cpu(card):
    ep = synth_providers(np.random.default_rng(7), 1024, device="cpu")
    er = synth_requirements(np.random.default_rng(8), 1024, device="cpu")
    a_gpu, a_cpu = TorchSolveArena(device=card), TorchSolveArena(device="cpu")
    np.testing.assert_array_equal(
        a_gpu.solve(ep, er, CostWeights(proximity=0.0)),
        a_cpu.solve(ep, er, CostWeights(proximity=0.0)),
    )
    np.testing.assert_array_equal(a_gpu.price, a_cpu.price)


# the fused cold pass: (P, T, k, tile, r, jitter offset); rt = ceil(r /
# n_tiles) > 1 in the third and fourth, tile 250 splits a warp group's rows
# at 2, P < 32 and k = P in the fifth, the last is a D = 4 shard's offset
BIDIR_CASES = [
    (3000, 2000, 64, 250, 8, 0),
    (1024, 2048, 64, 256, 8, 123_456_789),
    (3000, 1024, 64, 256, 8, 0),
    (500, 96, 32, 48, 8, 0),
    (20, 512, 20, 64, 8, 0),
    (3000, 1024, 64, 256, 8, 3072),
]


@pytest.mark.parametrize("P,T,k,tile,r,offset", BIDIR_CASES)
def test_fused_candidate_kernel_matches_plain_and_separate_launches(card, P, T, k, tile, r,
                                                                    offset):
    """K1's fused launch: bit for bit the plain fused pass at proximity 0,
    and the rows launch over every task plus the reverse launch at default
    weights, where the haversine's ulps keep the plain version apart."""
    from protocol_tpu_torch import kernels

    ep = synth_providers(np.random.default_rng(P), P, device=card)
    er = synth_requirements(np.random.default_rng(T), T, device=card)
    rt = max(1, -(-r // (T // tile)))
    for w in (CostWeights(proximity=0.0), CostWeights()):
        before = kernels.LAUNCHES["candidates_bidir"]
        got = sp.candidates_fused(ep, er, w, k, tile, r, rt, task_offset=offset)
        assert kernels.LAUNCHES["candidates_bidir"] == before + 1
        assert got[4].shape == (P, T // tile * rt)
        ids = torch.arange(T, dtype=torch.int32, device=card)
        apart = (*kernels.candidates_forward_rows(ep, er, w, k, ids, offset=offset),
                 *kernels.candidates_reverse(ep, er, w, tile, r, rt, offset=offset))
        assert all(same_bits(a, b) for a, b in zip(got, apart))
        if w.proximity == 0.0:
            ref = sp._bidir_plain(ep, er, w, k, tile, r, rt, offset)
            assert all(same_bits(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("rows", [1, 293, 655])
@pytest.mark.parametrize("biased", [False, True])
def test_rows_kernel_at_the_repairs_row_counts_matches_plain_bits(card, rows, biased):
    """K1's rows launch over 1, 293 and 655 scattered task ids at the
    default layout, biased and unbiased, against the plain selection."""
    from protocol_tpu_torch import kernels

    P, T = 3000, 2048
    ep = synth_providers(np.random.default_rng(5), P, device=card)
    er = synth_requirements(np.random.default_rng(6), T, device=card)
    w = CostWeights(proximity=0.0)
    rng = np.random.default_rng(rows)
    ids = torch.from_numpy(rng.permutation(T)[:rows].astype(np.int32)).to(card)
    bias = (torch.from_numpy(rng.normal(0, 1, P).astype(np.float32)).to(card) if biased
            else None)
    got = kernels.candidates_forward_rows(ep, er, w, 64, ids, bias=bias)
    fp, fc = sp._forward_plain(ep, er, w, 64, T, provider_offset=bias)
    assert same_bits(got[0], fp[ids.long()]) and same_bits(got[1], fc[ids.long()])


# K1 on nan_edit's cells: (P, T, k, tile); at k = P (the second) every row
# with a NaN cell has NaN places
K1_NAN_CASES = [(3000, 1024, 64, 256), (20, 512, 20, 64)]


@pytest.mark.parametrize("P,T,k,tile", K1_NAN_CASES)
def test_candidate_kernels_on_nan_cells_match_plain_bits(card, P, T, k, tile):
    """K1's fused launch (the topk RPC's cold pass), its rows launch over
    every task and its reverse launch, on nan_edit's cells, bit for bit
    against the plain fused pass at proximity 0: the NaN task's forward row
    is k places of (-1, NaN), where the plain stable sort puts NaN cells; at
    rt = 1 (the second case) a tile's pool is its first NaN where it has
    one, as the plain argmin's; no NaN cell enters a reverse list."""
    from protocol_tpu_torch import kernels

    ep, er = nan_edit(synth_providers(np.random.default_rng(P), P, device=card),
                      synth_requirements(np.random.default_rng(T), T, device=card))
    w = CostWeights(proximity=0.0)
    rt = max(1, -(-8 // (T // tile)))
    got = sp.candidates_fused(ep, er, w, k, tile, 8, rt)
    ref = sp._bidir_plain(ep, er, w, k, tile, 8, rt, 0)
    assert all(same_bits(a, b) for a, b in zip(got, ref))
    ids = torch.arange(T, dtype=torch.int32, device=card)
    rows = kernels.candidates_forward_rows(ep, er, w, k, ids)
    assert all(same_bits(a, b) for a, b in zip(rows, ref[:2]))
    rev = kernels.candidates_reverse(ep, er, w, tile, 8, rt)
    assert all(same_bits(a, b) for a, b in zip(rev, ref[2:]))
    fp, fc = got[:2]
    assert bool((fp[NAN_TASK] == -1).all()) and bool(torch.isnan(fc[NAN_TASK]).all())
    assert not bool(torch.isnan(got[3]).any())


def test_candidate_kernel_refuses_what_it_does_not_take(card):
    """A shape K1 does not take raises, from the wrapper or from the refused
    launch; no path falls back to a plain version."""
    from protocol_tpu_torch import kernels

    ep = synth_providers(np.random.default_rng(5), 300, device=card)
    er = synth_requirements(np.random.default_rng(6), 512, device=card)
    w = CostWeights()
    ids = torch.arange(512, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        kernels.candidates_forward_rows(ep, er, w, 64, ids, rows_per_warp=3)
    with pytest.raises(ValueError):
        kernels.candidates_forward_rows(ep, er, w, 65, ids)
    with pytest.raises(ValueError):
        kernels.candidates_bidir(ep, er, w, 64, 100, 8, 1)  # tile does not divide T
    with pytest.raises(ValueError):
        kernels.candidates_bidir(ep, er, w, 64, 64, 8, 9)  # rt > r
    from protocol_tpu_torch.kernels import _k1_setup, _lib

    dev, pcols, rcols, (P, T, K, W), wt, aux = _k1_setup(ep, er, w)
    out = torch.empty(64, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="refused"):  # rows a warp group must divide the tile
        kernels._check(_lib("candidates").k1_reverse(
            pcols, rcols, P, T, K, W, *wt, 64, 8, 1, 3, 0, aux.data_ptr(), out.data_ptr(),
            out.data_ptr(), out.data_ptr(), out.data_ptr(), out.data_ptr(),
            kernels._stream(out)), "k1_reverse")


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
    # (rows a warp group, warps a group); None: the default layout, (1, 2)
    # for these 293 rows
    for layout in ((None, None), (8, 1), (4, 2), (1, 1)):
        got = kernels.candidates_forward_rows(ep, er, w, 64, rows, *layout)
        assert all(same_bits(a, b) for a, b in zip(got, plain)), layout
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


def repair_list_cases() -> dict:
    """name -> (provider arrays, requirement arrays, tile, flagged [P, n_tiles]
    bool or None (5% at random), dirty task ids or None (2% at random)):
    the seams of the reverse blocks' and K4's list launches (a block of 256
    providers or flagged entries, task rows staged 8 a step, a tile's rows
    split into slices, the dirty ids cut into ranges at tile boundaries)."""
    from protocol_tpu_torch.trace.synth import synth_provider_arrays, synth_requirement_arrays

    def market(P, T, seed):
        return (synth_provider_arrays(np.random.default_rng(seed), P),
                synth_requirement_arrays(np.random.default_rng(seed + 1), T))

    cases = {}
    # every cell of tile 1 infeasible: (INFEASIBLE, the tile's first task)
    pa, ra = market(300, 1024, 1)
    ra["valid"][256:512] = False
    flag = np.zeros((300, 4), bool)
    flag[::3, 1] = flag[::7, 2] = True
    cases["infeasible_tile"] = (pa, ra, 256, flag, np.array([5, 260, 300, 511, 700]))
    # a third of the providers above INFEASIBLE/2 (no jitter) and every
    # priority 0: each of their feasible cells ties, across every slice
    pa, ra = market(600, 1024, 2)
    pa["price"][::3] = np.float32(6e8)
    ra["priority"][:] = 0.0
    cases["ties"] = (pa, ra, 256, None, None)
    # one tile holds most flagged providers, the others two or none
    pa, ra = market(2000, 2048, 3)
    flag = np.zeros((2000, 8), bool)
    flag[:1800, 3] = True
    flag[[5, 1999], 6] = True
    cases["skewed"] = (pa, ra, 256, flag, None)
    # a single flagged block, a single dirty task
    pa, ra = market(500, 1024, 4)
    flag = np.zeros((500, 4), bool)
    flag[321, 2] = True
    cases["single"] = (pa, ra, 256, flag, np.array([777]))
    # tile 1,000: not a multiple of the 8-row step
    pa, ra = market(1500, 3000, 5)
    cases["tile_1000"] = (pa, ra, 1000, None, None)
    # dirty ids crossing tile boundaries inside one 8-row step, 13 of them
    pa, ra = market(700, 1024, 6)
    ids = np.array([250, 251, 252, 253, 254, 255, 256, 257, 510, 511, 512, 767, 768])
    cases["cross_step"] = (pa, ra, 256, None, ids)
    return cases


@pytest.mark.parametrize("name", sorted(repair_list_cases()))
def test_repair_list_kernels_cases_match_plain_bits(card, name):
    """The reverse blocks and K4 against their plain versions, bit for bit at
    proximity 0, on each of repair_list_cases()."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops.encoding import providers_from_numpy, requirements_from_numpy
    from protocol_tpu_torch.parallel import sparse as ps

    pa, ra, tile, flag, t_ids = repair_list_cases()[name]
    ep, er = providers_from_numpy(pa, card), requirements_from_numpy(ra, card)
    P, T, w = ep.num, er.num, CostWeights(proximity=0.0)
    *_, pt, pc = sp.candidates_topk_reverse(ep, er, w, k=16, tile=tile, reverse_r=2,
                                            with_pools=True)
    rng = np.random.default_rng(0)
    if flag is None:
        flag = rng.random((P, T // tile)) < 0.05
    if t_ids is None:
        t_ids = np.sort(rng.choice(T, T // 50, replace=False))
    blk_j, blk_p = torch.nonzero(torch.from_numpy(flag).T.to(card), as_tuple=True)
    got, ref = (pt.clone(), pc.clone()), (pt.clone(), pc.clone())
    kernels.candidates_reverse_blocks(ep, er, w, tile, blk_p, blk_j, *got)
    ps._reverse_blocks_plain(ep, er, w, tile, 1, blk_p, blk_j, *ref)
    assert all(same_bits(a, b) for a, b in zip(got, ref))
    ids = torch.from_numpy(np.asarray(t_ids)).to(card)
    assert same_bits(kernels.repair_tile_min(ep, er, w, ids, tile, ps._PAD_COST),
                     ps._tile_min_plain(ep, er, w, ids.long(), tile, ps._PAD_COST))


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


# K6's and K8's cases: name -> (P, T, edit). The seams of their list
# launches: 256 providers a block, two a lane (255 and 257 straddle a
# chunk), rows staged 8 a step (7 and 9 straddle a step), single rows and
# columns, every pair of the sizes; then requirement rows repeated every 35
# tasks (exact ties across the ranges: K8 must take the first task),
# providers that fit no task (K8 gives -1), slots that no provider fits
# (K6's row all -1e18, not feasible), costs of -0 and +0 (K8 holds them
# equal, as the plain argmin does), and the backend's best RPC shape.
DENSE_CASES = {f"p{P}_t{T}": (P, T, None) for P in (1, 255, 257, 1000) for T in (1, 7, 9, 700)}
DENSE_CASES.update(dup=(1000, 700, "dup"), nofit=(257, 9, "nofit"), noslot=(255, 700, "noslot"),
                   zeros=(257, 700, "zeros"), best_rpc=(4096, 1024, None), nan=(1000, 700, "nan"))
DENSE_DUP_PERIOD = 35


def dense_case(name: str, proximity: float, card):
    """(ep, er, weights) of one of DENSE_CASES on the card."""
    import dataclasses

    from protocol_tpu_torch.ops.encoding import gather_requirements

    P, T, edit = DENSE_CASES[name]
    ep = synth_providers(np.random.default_rng(43), P, device=card)
    er = synth_requirements(np.random.default_rng(44), T, device=card)
    w = CostWeights(priority=1.0, proximity=proximity)
    if edit == "dup":
        er = gather_requirements(er, torch.arange(T, device=card) % DENSE_DUP_PERIOD)
    if edit == "nofit":
        valid = ep.valid.clone()
        valid[[0, 100, P - 1]] = False
        ep = dataclasses.replace(ep, valid=valid)
    if edit == "noslot":
        valid = er.valid.clone()
        valid[[0, 5, T - 1]] = False
        er = dataclasses.replace(er, valid=valid)
    if edit == "nan":  # nan_edit, the NaN task fitting about half the providers
        ep, er = nan_edit(ep, er, ram_mb=median_ram(ep))
    if edit == "zeros":
        # base -0 + (-0 x distance) - 0 is -0 on a located pair, +0 on the
        # others (the even tasks, from task 0 on); every pair compatible, so
        # at proximity -0 each provider's row ties at 0
        loc = er.has_location.clone()
        loc[0::2] = False
        ep = dataclasses.replace(ep, valid=torch.ones_like(ep.valid),
                                 price=torch.full_like(ep.price, -0.0),
                                 load=torch.full_like(ep.load, -0.0))
        er = dataclasses.replace(
            er, valid=torch.ones_like(er.valid), cpu_required=torch.zeros_like(er.cpu_required),
            cpu_cores=torch.full_like(er.cpu_cores, -1), ram_mb=torch.full_like(er.ram_mb, -1),
            storage_gb=torch.full_like(er.storage_gb, -1),
            gpu_opt_valid=torch.zeros_like(er.gpu_opt_valid),
            priority=torch.zeros_like(er.priority), has_location=loc)
        w = CostWeights(priority=1.0, proximity=-0.0 if proximity == 0.0 else proximity)
    return ep, er, w


@pytest.mark.parametrize("proximity", [0.0, 0.001])
@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_dense_kernels_cases_match_plain_bits(card, name, proximity):
    """K6 against cost_matrix + with_tie_jitter, K8 against cost_matrix +
    argmin and K7 fed K6's rows against the plain auction loop, bit for
    bit, on each of DENSE_CASES at both weights."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops import assign as da
    from protocol_tpu_torch.ops.cost import cost_matrix, with_tie_jitter
    from protocol_tpu_torch.sched import torch_backend as tb

    ep, er, w = dense_case(name, proximity, card)
    P, T, edit = DENSE_CASES[name]
    vb, feas = kernels.dense_value_base(ep, er, w)
    cost, _ = cost_matrix(ep, er, w)
    pvb, pfeas = da._value_base(with_tie_jitter(cost))
    assert vb.shape == (T, P) and same_bits(vb, pvb) and torch.equal(feas, pfeas)
    best = kernels.unbounded_best(ep, er, w)
    assert same_bits(best, tb._solve_unbounded_plain(ep, er, w))
    got = kernels.dense_auction(vb, feas, 0.05, 300)
    ref = da._auction_dense_plain(vb, feas, 0.05, 300)
    assert all(same_bits(a, b) for a, b in zip(got[:3], ref[:3])) and int(got[3]) == int(ref[3])
    if edit == "dup":  # every tie goes to the first copy of a row
        assert bool(((best >= 0) & (best < DENSE_DUP_PERIOD)).any())
        assert bool((best < DENSE_DUP_PERIOD).all())
    if edit == "nofit":
        assert best[[0, 100, P - 1]].tolist() == [-1, -1, -1]
    if edit == "noslot":
        assert not feas[[0, 5, T - 1]].any()
        assert bool((vb[[0, 5, T - 1]] == -1e18).all())
    if edit == "nan":  # a provider with a NaN cell gets -1; the NaN slot is infeasible
        nan_row = torch.isnan(cost).any(dim=1)
        assert bool(nan_row.any()) and bool((best[nan_row] == -1).all())
        assert bool((best[~nan_row] >= 0).any()) and not bool(feas[NAN_TASK])
    if edit == "zeros" and proximity == 0.0:  # +0 at task 0, -0 at task 1: the first wins
        assert bool((cost == 0.0).all()) and bool(torch.signbit(cost[:, 1]).all())
        assert not bool(torch.signbit(cost[:, 0]).any()) and bool((best == 0).all())


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


# K10's cases: name -> (P, T). The seams of its list launch: 256 providers
# a block, two a lane (65 and 300 straddle a lane pair and a chunk), slot
# rows staged 8 a step (13), single rows and columns; and the two extremes
# of the check, every cell infeasible and every cell feasible.
K10_CASES = {"p1": (1, 40), "t1": (70, 1), "p65": (65, 30), "p300": (300, 50), "t13": (500, 13),
             "infeasible": (300, 40), "feasible": (300, 40), "nan": (300, 50)}


@pytest.mark.parametrize("proximity", [0.0, 0.001])
@pytest.mark.parametrize("name", sorted(K10_CASES))
def test_cost_block_cases_match_plain_bits(card, name, proximity):
    """K10 against cost_matrix, bit for bit, on each of K10_CASES at both
    weights."""
    import dataclasses

    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops.cost import cost_matrix

    P, T = K10_CASES[name]
    ep = synth_providers(np.random.default_rng(41), P, device=card)
    er = synth_requirements(np.random.default_rng(42), T, device=card)
    if name == "infeasible":
        er = dataclasses.replace(er, valid=torch.zeros_like(er.valid))
    if name == "feasible":  # no limit on either side: every valid pair is compatible
        ep = dataclasses.replace(ep, valid=torch.ones_like(ep.valid))
        er = dataclasses.replace(
            er, valid=torch.ones_like(er.valid), cpu_required=torch.zeros_like(er.cpu_required),
            cpu_cores=torch.full_like(er.cpu_cores, -1), ram_mb=torch.full_like(er.ram_mb, -1),
            storage_gb=torch.full_like(er.storage_gb, -1),
            gpu_opt_valid=torch.zeros_like(er.gpu_opt_valid))
    if name == "nan":  # nan_edit: a NaN column and a NaN row stored as they are
        ep, er = nan_edit(ep, er)
    w = CostWeights(priority=1.0, proximity=proximity)
    got = kernels.cost_block(ep, er, w)
    ref = cost_matrix(ep, er, w)[0]
    assert got.shape == (T, P) and same_bits(got.T.contiguous(), ref)
    if name == "nan":
        assert bool(torch.isnan(got[NAN_TASK]).all())
        assert bool(torch.isnan(got[:, NAN_PROVIDER]).any())
    if name == "infeasible":
        assert bool((got == 1e9).all())
    if name == "feasible":
        assert bool((got < 5e8).all())


# ---------------- K11's cases (shared with tests/test_torch_binpack.py) ----------------
# Each case is a bin-pack call whose inputs stress one seam of K11's
# chain: the ring of column slots (a visit order far longer than the ring,
# a single step), the pick's key (equal costs across providers, -0.0 and
# +0.0), and the route between the two instantiations (an occupancy
# bitmask only device memory holds, a shape on each side of the limit).
# The CPU tests hold the plain step loop against the reference on the
# small sizes; the card tests hold K11 against the plain loop.

BINPACK_KINDS = ("unit", "capacity", "order", "wrap", "t1", "equal", "negzero", "wide",
                 "edge_in", "edge_out")


def binpack_limit_L(P: int, R: int, G: int) -> int:
    """The largest domain count L at which K11's shared instantiation still
    fits P providers, R resources and G groups."""
    from protocol_tpu_torch import kernels

    lo, hi = 1, 1 << 24
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if kernels.binpack_slots(P, R, mid, G, True):
            lo = mid
        else:
            hi = mid - 1
    return lo


def binpack_case(kind: str, small: bool = False):
    """Integer-valued bin-pack inputs as numpy arrays (cost [P, T],
    demand, capacity, order or None, anti_group, loc_id, L, G): unit
    demand with groups over domains (phase 0's shape), five resources
    (phase 0.5's), a given visit order, and the seams above; every case
    but ``t1`` has an all-infeasible column (5)."""
    rng = np.random.default_rng(1 + BINPACK_KINDS.index(kind))
    P, T = (60, 40) if small else (3000, 700)
    if kind == "wrap":
        P, T = (24, 96) if small else (700, 3000)  # 3,000 steps through a ring of 32 slots
    if kind == "t1":
        T = 1
    if kind in ("edge_in", "edge_out", "wide"):
        P = 200 if small else 1000
    cost = rng.integers(1, 2000, (P, T)).astype(np.float32) / 8
    if kind == "equal":
        cost[:] = 2.5
    if kind == "negzero":
        cost = np.where(rng.uniform(size=(P, T)) < 0.5, -0.0, 0.0).astype(np.float32)
    cost[rng.uniform(size=(P, T)) > 0.3] = 1e9
    if T > 5:
        cost[:, 5] = 1e9
    order = None
    if kind in ("unit", "equal", "negzero", "wide", "edge_in", "edge_out"):
        demand, capacity = np.ones((T, 1), np.float32), np.ones((P, 1), np.float32)
        G = 16
        n_grouped = T * 6 // 7
        anti = np.where(np.arange(T) < n_grouped, np.arange(T) // max(1, T // G), -1)
        anti = np.minimum(anti, G - 1).astype(np.int32)
        L = 64
        if kind == "wide":  # an occupancy bitmask of 4M bits: device memory only
            G, L = 64, 65_536
        elif kind in ("edge_in", "edge_out"):
            L = binpack_limit_L(P, 1, G) + (kind == "edge_out")
        loc = rng.integers(0, L, P).astype(np.int32)
    else:
        demand = rng.integers(0, 4, (T, 5)).astype(np.float32)
        capacity = rng.integers(0, 9, (P, 5)).astype(np.float32)
        if kind == "wrap":
            capacity *= 5
        anti, loc = np.full(T, -1, np.int32), np.arange(P, dtype=np.int32)
        L, G = P, 1
        if kind in ("order", "t1"):
            order = rng.permutation(T).astype(np.int32)
    return cost, demand, capacity, order, anti, loc, L, G


@pytest.mark.parametrize("route", ["shared", "device"])
@pytest.mark.parametrize("kind", BINPACK_KINDS)
def test_binpack_kernel_matches_plain_bits(card, kind, route):
    """K11 (its rank launch included) in each instantiation, forced,
    against the plain step loop; an instantiation that does not fit the
    shapes raises."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops import binpack as bp

    cost, demand, capacity, order, anti, loc, L, G = (
        x if isinstance(x, int) or x is None else torch.from_numpy(x).to(card)
        for x in binpack_case(kind))
    P, T = cost.shape
    R = demand.shape[1]
    fits = kernels.binpack_slots(P, R, L, G, route == "shared") > 0
    assert fits == (route == "device" or kind not in ("wide", "edge_out"))
    if kind.startswith("edge"):
        assert kernels.binpack_route(P, R, L, G) == ("shared" if kind == "edge_in" else "device")
    if not fits:
        with pytest.raises(ValueError, match="instantiation"):
            kernels.binpack_ffd(cost.T.contiguous(), demand, capacity, order, anti, loc, L, G,
                                route=route)
        return
    key = kernels.K11_ROUTES[route]
    before = kernels.LAUNCHES[key]
    got = kernels.binpack_ffd(cost.T.contiguous(), demand, capacity, order, anti, loc, L, G,
                              route=route)
    assert kernels.LAUNCHES[key] == before + 1
    ref = bp._binpack_plain(cost, demand, capacity,
                            bp.ffd_demand_order(demand) if order is None else order,
                            anti, loc, L, G)
    assert same_bits(got[0], ref[0]) and same_bits(got[1], ref[1])
    assert int((got[0] >= 0).sum()) > 0
    if T > 5:
        assert int(got[0][5]) == -1
    # the public entry point launches K11 on a card in the route's own
    # instantiation (ranking the default order in the launch), from a
    # transposed view as the matcher's K10 gives
    own = kernels.binpack_route(P, R, L, G)
    before = kernels.LAUNCHES[kernels.K11_ROUTES[own]]
    res = bp.assign_binpack_ffd(cost.T.contiguous().T, demand, capacity, task_order=order,
                                anti_group=anti, loc_id=loc, num_locations=L, num_groups=G)
    assert kernels.LAUNCHES[kernels.K11_ROUTES[own]] == before + 1 and res.route == own
    assert same_bits(res.provider_for_task, ref[0]) and same_bits(res.remaining_capacity, ref[1])


def test_binpack_layout_mirrors_the_library(card):
    """kernels.binpack_slots, which picks K11's route without a card,
    equals the library's own layout on both sides of every limit."""
    from protocol_tpu_torch import kernels

    lib = kernels._lib("binpack")
    for P in (1, 3, 992, 2048, 4096, 15_872, 15_873, 65_536):
        for R in (1, 5, 8):
            for L, G in ((P, 1), (2048, 64), (4096, 1024), (binpack_limit_L(P, R, 16), 16)):
                for shared in (True, False):
                    assert kernels.binpack_slots(P, R, L, G, shared) == lib.k11_slots(
                        P, R, L * G, int(shared)), (P, R, L, G, shared)


# ---------------- K9's cases (shared with tests/test_torch_auction.py) ----------------
# Each case is a cleanup call whose inputs stress one hazard of K9's sorted
# sweep: merged rows (64 sorted forward columns, 16 extras sorted only
# among themselves), K = 128 and K = 80 (not a multiple of 32), a provider
# twice in a row, -0.0 / +0.0 ties, equal costs, one open row, rows with no
# free candidate, and (on the card) more than a million providers. Every
# case has invalid entries (p < 0) with a finite cost and infeasible costs.

K9_KINDS = ("merged", "k128", "k80", "dup", "negzero", "equal", "one_open", "no_free",
            "p_above_1m")


def k9_case(kind: str, small: bool = False):
    """(cand_p [T, K] i32, cand_c [T, K] f32, owner [P] i32, p4t [T] i32)
    as numpy arrays."""
    rng = np.random.default_rng(40 + K9_KINDS.index(kind))
    T, P = (64, 120) if small else (6000, 20_000)
    if kind == "p_above_1m":
        P = 1_200_000
    K = {"k128": 128, "k80": 80, "merged": 80}.get(kind, 64)
    cp = rng.integers(0, P, (T, K)).astype(np.int32)
    cc = (rng.integers(0, 40, (T, K)) / 8).astype(np.float32)
    if kind == "merged":  # as merge_reverse_candidates leaves them
        cc[:, :64] = np.sort(cc[:, :64], axis=1)
        cc[:, 64:] = np.sort(cc[:, 64:], axis=1)
    elif kind == "dup":
        cp[:, 1::2] = cp[:, 0::2]
    elif kind == "negzero":
        cc = np.where(rng.uniform(size=(T, K)) < 0.5, -0.0, 0.0).astype(np.float32)
    elif kind == "equal":
        cc[:] = 1.5
    cp[rng.uniform(size=(T, K)) < 0.1] = -1  # invalid, with a finite cost
    cc[rng.uniform(size=(T, K)) < 0.05] = 1e9
    owner = np.where(rng.uniform(size=P) < 0.5, 0, -1).astype(np.int32)
    p4t = np.where(rng.uniform(size=T) < 0.6, -1, 0).astype(np.int32)
    if kind == "one_open":
        p4t[:] = 0
        p4t[T // 3] = -1
    elif kind == "no_free":  # half the rows' candidates are all taken or infeasible
        taken = np.flatnonzero(owner >= 0)
        cp[::2] = rng.choice(taken, (len(cp[::2]), K))
        cc[1::4] = 1e9
    return cp, cc, owner, p4t


@pytest.mark.parametrize("kind", ("cut_auction",) + K9_KINDS)
def test_greedy_cleanup_kernel_matches_plain_bits(card, kind):
    """K9 against the plain sweep on the state an auction cut after a few
    rounds leaves (many open tasks contending for the same free
    providers) and on each of K9's cases."""
    from protocol_tpu_torch import kernels

    if kind == "cut_auction":
        n = 3000
        ep = synth_providers(np.random.default_rng(2), n, device=card)
        er = synth_requirements(np.random.default_rng(3), n, device=card)
        cp, cc = sp.candidates_topk_bidir(ep, er, CostWeights(), k=64, tile=250)
        state, _ = sp._sparse_auction_phase(cp, cc, n, None, eps=4.0, max_iters=2,
                                            frontier=4096, retire=True, stall_limit=0)
        _, _, owner, p4t, _ = state
    else:
        cp, cc, owner, p4t = (torch.from_numpy(x).to(card) for x in k9_case(kind))
    open_idx = torch.nonzero(p4t < 0).flatten()
    assert open_idx.numel() >= (1 if kind == "one_open" else 1000)
    before = kernels.LAUNCHES["greedy_cleanup"]
    got = kernels.greedy_cleanup(cp, cc, owner, p4t, open_idx)
    assert kernels.LAUNCHES["greedy_cleanup"] == before + 1
    ref = sp._greedy_cleanup_plain(cp, cc, owner, p4t, open_idx)
    assert same_bits(got, ref.to(torch.int32))
    assert int((got[open_idx] >= 0).sum()) > 0


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


# ---------------- K7's and K12's cases (shared with tests/test_torch_assign_rest.py) ----------------
# Each K7 case is a dense cost [P, T] whose auction stresses one seam of
# K7's rounds: the open list's length on both sides of each row-split
# threshold (a group of g warps a row once n open x 2g <= the grid's warps:
# 4,224 on 132 SMs), P not a multiple of 4 (rows off their 16-byte
# granules), T >> P and P >> T, single-option rows (the -1e8 floor),
# identical rows (equal bids: the lowest slot wins), all-infeasible rows,
# and P on both sides of the shared-memory price route. Each K12 case is a
# greedy call (cost [P, T], visit order) that stresses the producers' lists:
# T = P (the lists run out late), rows with fewer than 32 candidates, heavy
# -0 / +0 ties, free NaN cells, P not a multiple of 32, wide rows and the
# widest the free bitmask takes (fewer producers fit beside it). The CPU
# tests hold models of the two kernels' rounds and steps against the plain
# versions and the reference on the small sizes; the card tests hold the
# kernels against the plain versions.

K7_KINDS = ("t2113", "t2112", "t1057", "t1056", "t529", "t528", "t265", "t264", "t133", "t132",
            "t8", "p_mod4", "tall", "wide", "single", "equal", "infeasible", "price_in",
            "price_out")
K7_PRICE_P = 51_200  # the largest P whose prices K7 stages in shared memory


def k7_case(kind: str, small: bool = False) -> np.ndarray:
    """A [P, T] f32 cost for K7 (INFEASIBLE = 1e9 off the mask)."""
    rng = np.random.default_rng(70 + K7_KINDS.index(kind))
    sizes = {  # (T, P) on the card; small: for the CPU
        "t2113": (2113, 2500), "t2112": (2112, 2500), "t1057": (1057, 1500),
        "t1056": (1056, 1500), "t529": (529, 900), "t528": (528, 900), "t265": (265, 600),
        "t264": (264, 600), "t133": (133, 600), "t132": (132, 600), "t8": (8, 4000),
        "p_mod4": (700, 1001),
        "tall": (3000, 300), "wide": (64, 20_000), "single": (500, 400), "equal": (600, 500),
        "infeasible": (700, 600), "price_in": (40, K7_PRICE_P), "price_out": (40, K7_PRICE_P + 1),
    }
    T, P = sizes[kind]
    if small:
        T, P = max(2, min(T // 8, 160)), max(3, min(P // 8, 240))
        if kind == "p_mod4":
            P = 123
    if kind in ("equal", "single"):
        cost = (rng.integers(0, 64, (P, T)) / 8).astype(np.float32)
    else:
        cost = rng.uniform(0.0, 10.0, (P, T)).astype(np.float32)
    cost[rng.uniform(size=(P, T)) < 0.3] = 1e9
    if kind == "single":  # every other slot has one option
        one = rng.integers(0, P, T)
        cost[:, ::2] = 1e9
        cost[one[::2], np.arange(0, T, 2)] = (rng.integers(0, 64, (T + 1) // 2) / 8)
    elif kind == "equal":  # slots in identical pairs
        cost[:, 1::2] = cost[:, 0:T - T % 2:2]
    elif kind == "infeasible":
        cost[:, ::5] = 1e9  # never open
        cost[::7, :] = 1e9
    return cost


def k7_value_rows(cost, device):
    """(value_base [T, P], task_feasible [T]) of a K7 case, as assign_auction
    builds them."""
    from protocol_tpu_torch.ops import assign as da

    return da._value_base(torch.from_numpy(cost).to(device))


K12_KINDS = ("square", "few", "ties", "nan", "p_mod32", "order", "wide_rows", "widest")


def k12_case(kind: str, small: bool = False):
    """(cost [P, T] f32, visit order [T] i32) for K12 as numpy arrays."""
    rng = np.random.default_rng(90 + K12_KINDS.index(kind))
    T, P = (700, 700) if not small else (300, 300)
    if kind == "square":
        T, P = (3000, 3000) if not small else (300, 300)
    elif kind in ("p_mod32", "order"):
        T, P = (2000, 743) if not small else (200, 103)
    elif kind == "wide_rows":
        T, P = (400, 70_000) if not small else (40, 2_000)
    elif kind == "widest":
        T, P = (24, 1_638_400) if not small else (20, 3_000)
    elif kind == "few":
        T = P // 2
    cost = (rng.integers(0, 64, (P, T)) / 8).astype(np.float32)
    if kind == "ties":
        cost = np.where(rng.uniform(size=(P, T)) < 0.5, -0.0, 0.0).astype(np.float32)
        cost[rng.uniform(size=(P, T)) < 0.2] = 1.0
    cost[rng.uniform(size=(P, T)) < 0.1] = -0.0
    cost[rng.uniform(size=(P, T)) < (0.97 if kind == "few" else 0.3)] = 1e9
    if kind == "nan":
        cost[rng.uniform(size=(P, T)) < 0.002] = np.nan
    cost[:, 3] = 1e9
    order = np.arange(T, dtype=np.int32)
    if kind in ("order", "nan", "square"):
        order = rng.permutation(T).astype(np.int32)
    return cost, order


@pytest.mark.parametrize("max_iters", [0, 1, 3, 300])
@pytest.mark.parametrize("kind", K7_KINDS)
def test_dense_auction_kernel_cases_match_plain_bits(card, kind, max_iters):
    """K7 against the plain auction loop on each of its cases: p4t, t4p,
    prices, rounds and open rows summed, bit for bit, at eps 0.05 and at
    max_iters 0, 1, 3 and 300."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops import assign as da

    cost = k7_case(kind)
    vb, feas = k7_value_rows(cost, card)
    P = vb.shape[1]
    if kind.startswith("price"):
        assert kernels.dense_route(P) == ("shared" if kind == "price_in" else "global")
    work: dict = {}
    before = kernels.LAUNCHES["dense_auction"]
    got = kernels.dense_auction(vb, feas, 0.05, max_iters, work)
    assert kernels.LAUNCHES["dense_auction"] == before + 1
    p4t, t4p, price, rounds, open_rows = da._auction_dense_plain(vb, feas, 0.05, max_iters)
    assert all(same_bits(a, b) for a, b in zip(got[:3], (p4t, t4p, price)))
    assert int(got[3]) == int(rounds) and int(work["open_rows"]) == open_rows
    if max_iters == 300 and kind != "tall":
        assert int((got[0] >= 0).sum()) > 0


def test_dense_route_mirrors_the_library(card):
    """kernels.dense_route, which names K7's route without a card, equals
    the library's own on both sides of the limit."""
    from protocol_tpu_torch import kernels

    lib = kernels._lib("dense")
    for P in (1, 4096, 32_768, K7_PRICE_P - 1, K7_PRICE_P, K7_PRICE_P + 1, 1 << 20):
        assert kernels.dense_route(P) == ("shared" if lib.k7_route(P) else "global"), P


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


@pytest.mark.parametrize("kind", K12_KINDS)
def test_greedy_kernel_cases_match_plain_bits(card, kind):
    """K12 against the plain step loop on each of its cases. A free NaN
    cell leaves its task at -1 and is never taken."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops import assign as da

    cost_np, order_np = k12_case(kind)
    cost = torch.from_numpy(cost_np).to(card)
    order = torch.from_numpy(order_np).to(card)
    cost_tp = cost.T.contiguous()
    before = kernels.LAUNCHES["greedy_assign"]
    got = kernels.greedy_assign(cost_tp, order)
    assert kernels.LAUNCHES["greedy_assign"] == before + 1
    ref = da._greedy_plain(cost_tp, order)
    assert same_bits(got, ref) and int(got[3]) == -1 and int((got >= 0).sum()) > 0
    if kind == "nan":
        seated = got >= 0
        assert not bool(torch.isnan(cost[got[seated].long(), seated.nonzero()[:, 0]]).any())
        assert bool(torch.isnan(cost_tp).any(dim=1)[~seated].any())


# ---------------- K13's cases (shared with tests/test_torch_assign_rest.py) ----------------
# Costs [P, T] that stress the blocks K13's rounds run over
# (csrc/sinkhorn.cu): every cell feasible and 1% feasible, a row and a
# column with no feasible cell in either layout (packed below four sevenths
# of the cells feasible, dense from there), T != P both ways, sizes off
# multiples of 32 and of 4 in both layouts, rows of thousands of cells and of
# a few, columns past 65,535 (dense), and 0 and 1 rounds in both layouts.
# Each case is (cost, eps, num_iters).


def k13_cases() -> dict:
    def cost(seed, P, T, p_feasible, hi=10.0):
        rng = np.random.default_rng(seed)
        c = rng.uniform(0.0, hi, (P, T)).astype(np.float32)
        c[rng.uniform(size=(P, T)) >= p_feasible] = 1e9
        return c

    cases = {
        "dense": (cost(1, 700, 500, 1.0), 0.05, 200),
        "sparse": (cost(2, 900, 1100, 0.01), 0.05, 200),
        "tall": (cost(4, 2100, 300, 0.3), 0.05, 100),
        "wide": (cost(5, 300, 2100, 0.3), 0.02, 100),
        "ragged": (cost(6, 33, 70, 0.5), 0.05, 200),
        "zero_rounds": (cost(7, 300, 200, 0.4), 0.05, 0),
        "one_round": (cost(8, 300, 200, 0.4), 0.05, 1),
        "many_chunks": (cost(9, 9000, 40, 0.1), 0.05, 50),
        "long_task_rows": (cost(10, 20000, 48, 0.05), 0.05, 50),
        "wide_columns": (cost(11, 70000, 8, 0.3), 0.05, 20),
        "ragged_dense": (cost(12, 33, 70, 0.9), 0.05, 200),
        "zero_rounds_dense": (cost(13, 301, 203, 0.8), 0.05, 0),
        "one_round_dense": (cost(14, 301, 203, 0.8), 0.05, 1),
    }
    for name, share in (("empty_lines", 0.7), ("empty_lines_packed", 0.2)):
        c = cost(3, 600, 800, share)
        c[11, :] = 1e9
        c[:, 7] = 1e9
        cases[name] = (c, 0.05, 200)
    # nan_edit's cells as K10 writes them for the sinkhorn RPC: a task with a NaN
    # priority fitting 90% of the providers (a NaN column there), a
    # provider with a NaN price (NaN on its feasible cells)
    c = cost(15, 300, 200, 0.5)
    fits = np.random.default_rng(16).uniform(size=300) < 0.9
    c[:, NAN_TASK] = np.where(fits, np.nan, 1e9)
    c[NAN_PROVIDER] = np.where(c[NAN_PROVIDER] < 5e8, np.nan, c[NAN_PROVIDER])
    cases["nan"] = (c.astype(np.float32), 0.05, 200)
    return cases


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



def check_k13(card, cost, eps, iters):
    """K13 on ``cost`` [P, T] against the plain Sinkhorn: u and v masked
    exactly where the plain ones are, within SINKHORN_UV_ATOL elsewhere
    (equal to 0 after 0 rounds), the plan within SINKHORN_PLAN_ATOL with no
    subnormal entry, the rounding inputs those of its own plan bit for bit,
    K12 on them the plain loop's; a second solve gives the same bits."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops import assign as da

    out = kernels.sinkhorn(cost.T.contiguous(), eps, iters)
    plan_tp, rcost_tp, colmax, u, v = out
    K, pu, pv = da._sinkhorn_plain(cost, eps, iters)
    pplan = da._plan_plain(K, pu, pv)
    for got, ref in ((u, pu), (v, pv)):
        masked = ref < -1e17
        assert torch.equal(got < -1e17, masked) and bool((got[masked] == -1e18).all())
        if iters == 0:
            assert same_bits(got, ref)
        elif bool((~masked).any()):
            assert float((got - ref)[~masked].abs().max()) <= SINKHORN_UV_ATOL
    assert float((plan_tp.T - pplan).abs().max()) <= SINKHORN_PLAN_ATOL
    tiny = torch.finfo(torch.float32).tiny
    assert not bool(((plan_tp > 0) & (plan_tp < tiny)).any())
    r_tp, order = da._rounding_inputs(cost, plan_tp.T)
    assert same_bits(rcost_tp, r_tp) and same_bits(colmax, plan_tp.amax(dim=1))
    assert same_bits(kernels.greedy_assign(rcost_tp, order), da._greedy_plain(r_tp, order))
    again = kernels.sinkhorn(cost.T.contiguous(), eps, iters)
    assert all(same_bits(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("name", sorted(k13_cases()))
def test_sinkhorn_kernel_cases_match_plain(card, name):
    """K13 on each of its cases (check_k13)."""
    cost, eps, iters = k13_cases()[name]
    check_k13(card, torch.from_numpy(cost).to(card), eps, iters)


def test_sinkhorn_kernel_beyond_l2_matches_plain(card):
    """K13 at 8,192^2 with every cell feasible: its dense block (268 MB a
    side) is far above the L2 (check_k13)."""
    gen = torch.Generator(device=card).manual_seed(5)
    cost = torch.rand((8192, 8192), generator=gen, device=card) * 10.0
    check_k13(card, cost, 0.05, 50)


def test_sinkhorn_layout_mirrors_the_library(card):
    """kernels.sinkhorn_layout, which names the layout of K13's rounds
    without a card, equals the library's on both sides of its threshold."""
    from protocol_tpu_torch import kernels

    lib = kernels._lib("sinkhorn")
    num, den = kernels.K13_DENSE_SHARE
    for T, P in ((1, 1), (700, 500), (4096, 4096), (8192, 8192), (70000, 8)):
        edge = -(-T * P * num // den)  # the fewest feasible cells of a dense solve
        for n in {0, 1, edge - 1, edge, edge + 1, T * P}:
            if 0 <= n <= T * P:
                want = "dense" if lib.k13_dense_layout(n, T, P) else "packed"
                assert kernels.sinkhorn_layout(n, T, P) == want, (n, T, P)
    assert kernels.sinkhorn_layout(0, 4096, 4096) == "packed"
    assert kernels.sinkhorn_layout(4096 * 4096, 4096, 4096) == "dense"
    assert kernels.sinkhorn_layout(0, 70000, 8) == "dense"


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


@pytest.mark.parametrize("layout", [(None, None), (8, 1), (1, 2)])
def test_candidate_kernel_with_a_provider_bias_matches_plain_bits(card, layout):
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
        got = kernels.candidates_forward_rows(ep, er, w, 64, ids, *layout, offset=77,
                                              bias=bias)
        ref = sp._forward_plain(ep, er, w, 64, tile, task_offset=77, provider_offset=bias)
        assert all(same_bits(a, b) for a, b in zip(got, ref))
    got = kernels.candidates_forward_rows(ep, er, w, 64, ids, *layout)
    ref = sp._forward_plain(ep, er, w, 64, tile)
    assert all(same_bits(a, b) for a, b in zip(got, ref))


# K15's cases: name -> (P, T). base: 2,000 providers under 3,000 tasks, a
# random p4t; repeats: 50 providers under 3,001 tasks (each provider on ~50
# pairs, a third of the tasks unassigned, T no multiple of the 256-thread
# block); nan_inf: nan_edit's NaN price and priority and an inf price and
# priority, each on a compatible pair; one provider, one task.
K15_CASES = {"base": (2000, 3000), "repeats": (50, 3001), "nan_inf": (300, 700), "p1": (1, 513),
             "t1": (1000, 1)}


def k15_case(name: str, card):
    """(ep, er, p4t) of one of K15_CASES on the card."""
    from protocol_tpu_torch.ops.cost import cost_matrix

    P, T = K15_CASES[name]
    ep = synth_providers(np.random.default_rng(60), P, device=card)
    er = synth_requirements(np.random.default_rng(61), T, device=card)
    rng = np.random.default_rng(62)
    p4t = rng.integers(-1, P, T).astype(np.int32)
    if name == "repeats":
        p4t[rng.uniform(size=T) < 0.3] = -1
    if name == "nan_inf":
        ep, er = nan_edit(ep, er)
        ep = _with(ep, 11, price=float("inf"))
        er = _with(er, 9, priority=float("inf"))
        fits = cost_matrix(ep, er, CostWeights())[1].cpu().numpy()
        t_nan_p = next(t for t in range(10, T) if fits[NAN_PROVIDER, t])
        t_inf_p = next(t for t in range(t_nan_p + 1, T) if fits[11, t])
        p4t[[NAN_TASK, t_nan_p, t_inf_p, 9]] = [3, NAN_PROVIDER, 11, int(fits[:, 9].argmax())]
    return ep, er, torch.from_numpy(p4t).to(card)


def pair_costs_close(got, ref, atol: float) -> bool:
    """NaN where ref is NaN, the same infinities, finite costs within atol."""
    nan, inf = torch.isnan(ref), torch.isinf(ref)
    if not torch.equal(torch.isnan(got), nan) or not torch.equal(got[inf], ref[inf]):
        return False
    fin = ~(nan | inf)
    return bool(torch.isfinite(got[fin]).all()) and float((got - ref)[fin].abs().max()) <= atol


@pytest.mark.parametrize("proximity", [0.0, 0.001])
@pytest.mark.parametrize("name", sorted(K15_CASES))
def test_pair_cost_kernel_matches_plain(card, name, proximity):
    """K15 on each of K15_CASES against the plain cost_pairs: bit for bit
    at proximity 0, within the haversine tolerance (1e-3) otherwise; the
    public entry point launches it."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops import cost as oc

    ep, er, p4t = k15_case(name, card)
    w = CostWeights(priority=1.0, proximity=proximity)
    got = kernels.pair_cost(ep, er, w, p4t)
    ref = oc._cost_pairs_plain(ep, er, p4t, w)
    if proximity == 0.0:
        assert same_bits(got, ref)
    else:
        assert pair_costs_close(got, ref, 1e-3)
    assert bool((got[p4t < 0] == 1e9).all())
    if name == "nan_inf":
        assert int(torch.isnan(got).sum()) >= 2 and bool(torch.isinf(got).any())
    before = kernels.LAUNCHES["pair_cost"]
    oc.cost_pairs(ep, er, p4t, w)
    assert kernels.LAUNCHES["pair_cost"] == before + 1


def test_pair_cost_kernel_refuses_a_provider_out_of_range(card):
    """A provider id at or above P raises before the launch; P - 1 runs."""
    from protocol_tpu_torch import kernels

    ep = synth_providers(np.random.default_rng(8), 40, device=card)
    er = synth_requirements(np.random.default_rng(9), 300, device=card)
    p4t = torch.full((300,), -1, dtype=torch.int32, device=card)
    p4t[17] = 39
    before = kernels.LAUNCHES["pair_cost"]
    kernels.pair_cost(ep, er, CostWeights(), p4t)
    p4t[18] = 40
    with pytest.raises(ValueError, match="out of range"):
        kernels.pair_cost(ep, er, CostWeights(), p4t)
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


# K3's cases: name -> (P, T, dirty ids (an int: that many drawn at
# random), jitter offset). The seams of its list launch: 256 dirty ids a
# block (1, 257 and 700 of them), repeats, task counts that are no multiple
# of the 8-row step, an offset whose keys reach 2^31 - 1.
K3_CASES = {
    "one": (500, 1000, [137], 0),
    "ids_257": (3000, 512, 257, 0),
    "ids_700": (3000, 512, 700, 0),
    "duplicates": (800, 600, [5, 5, 9, 300, 300, 300, 799, 5], 0),
    "t13": (300, 13, 40, 0),
    "t5": (300, 5, 40, 0),
    "offset_top": (600, 700, 60, (1 << 31) - 700),
}


@pytest.mark.parametrize("name", sorted(K3_CASES))
def test_enter_kernel_cases_match_plain_bits(card, name):
    """K3 against its plain version, bit for bit at proximity 0, on each of
    K3_CASES, with thresholds that try the test's edges: even rows at their
    least fresh cost exactly (``<=`` flags the tie), odd rows one ulp below
    it, every fifth row INFEASIBLE, every seventh NaN (flags nothing)."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops.encoding import gather_providers
    from protocol_tpu_torch.parallel import sparse as ps

    P, T, ids, offset = K3_CASES[name]
    ep = synth_providers(np.random.default_rng(31), P, device=card)
    er = synth_requirements(np.random.default_rng(32), T, device=card)
    w = CostWeights(proximity=0.0)
    if isinstance(ids, int):
        ids = np.random.default_rng(33).choice(P, ids, replace=False)
    p_ids = torch.tensor(np.asarray(ids), dtype=torch.int64, device=card)
    t_ids = torch.arange(offset, offset + T, device=card)
    best = ps._jittered(gather_providers(ep, p_ids), er, w, p_ids, t_ids).min(dim=0).values
    thresh = best.clone()
    thresh[1::2] = torch.nextafter(best[1::2], torch.tensor(-float("inf"), device=card))
    thresh[::5] = 1e9
    thresh[::7] = float("nan")
    got = kernels.repair_enter(ep, er, w, p_ids, thresh, offset=offset)
    assert same_bits(got, ps._enter_plain(ep, er, w, p_ids, thresh, offset))
    ties = torch.zeros(T, dtype=torch.bool, device=card)
    ties[::2] = True
    ties[::5] = ties[::7] = False
    feasible = best < 5e8
    assert bool(got[ties & feasible].all()) and not bool(got[::7].any())


# K5's cases (shared with tests/test_torch_repair.py): pools at the seams of
# its groups (n_tiles 1, 7, 8 and 9 around one lane's batch of 8, 64 at 8
# lanes, 256 at 32), rows of every kind below, at r 1 and 8.
K5_TILES = (1, 7, 8, 9, 64, 256)
K5_ROWS = ("ties", "zeros", "high", "nan", "neginf", "empty", "few", "mixed")


def k5_pool(n_tiles: int, seed: int = 0, rows_a_kind: int = 3):
    """(pool_t [P, n_tiles] i32, pool_c f32) with rows_a_kind rows of each of
    K5_ROWS: equal costs across a lane's batches and across lanes (ties);
    -0, +0 and 1 (zeros); entries equal to INFEASIBLE, in [INFEASIBLE/2,
    INFEASIBLE), above it, +inf, and one or two costs below (high: fewer
    entries than r); +NaN and -NaN among costs (nan); -inf (neginf); all
    INFEASIBLE (empty); one cost, the last entry (few); a mixture of all."""
    rng = np.random.default_rng(seed)
    pos_nan = np.array([0x7FC00000], np.uint32).view(np.float32)[0]
    neg_nan = np.array([0xFFC00000], np.uint32).view(np.float32)[0]
    special = np.float32([1e9, 7.5e8, 5e8, 9.9999994e8, 2e9, np.inf, pos_nan, neg_nan, -np.inf,
                          0.0, -0.0])
    n = n_tiles
    rows = []
    for kind in K5_ROWS:
        for _ in range(rows_a_kind):
            if kind == "ties":
                c = rng.choice(np.float32([0.5, 1.0, 1.5, 2.0]), n)
            elif kind == "zeros":
                c = rng.choice(np.float32([0.0, -0.0, 1.0]), n)
            elif kind == "high":
                c = rng.choice(special[:6], n)
                c[rng.choice(n, min(n, 2), replace=False)] = rng.uniform(0, 3, min(n, 2))
            elif kind == "nan":
                c = rng.choice(np.float32([pos_nan, neg_nan, 1.0, 3.0, 1e9]), n)
            elif kind == "neginf":
                c = rng.choice(np.float32([-np.inf, -np.inf, 0.25, 1e9]), n)
            elif kind == "empty":
                c = np.full(n, 1e9, np.float32)
            elif kind == "few":
                c = np.full(n, 1e9, np.float32)
                c[-1] = 2.5
            else:
                c = rng.uniform(-1, 4, n).astype(np.float32)
                pick = rng.uniform(size=n) < 0.4
                c[pick] = rng.choice(special, int(pick.sum()))
            rows.append(np.asarray(c, np.float32))
    pool_c = np.stack(rows)
    pool_t = rng.integers(0, 1 << 20, pool_c.shape).astype(np.int32)
    return pool_t, pool_c


@pytest.mark.parametrize("r", [1, 8])
@pytest.mark.parametrize("n_tiles", K5_TILES)
def test_refold_kernel_cases_match_plain_bits(card, n_tiles, r):
    """K5 on k5_pool's rows, at every d_fold of 1 and 4 that divides
    n_tiles, against the plain refold bit for bit."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.parallel import sparse as ps

    pt, pc = (torch.from_numpy(a).to(card) for a in k5_pool(n_tiles, seed=n_tiles))
    for d_fold in (d for d in (1, 4) if n_tiles % d == 0):
        got = kernels.repair_refold(pt, pc, r, d_fold)
        ref = ps._refold_plain(pt, pc, r, 1, d_fold)
        assert all(same_bits(a, b) for a, b in zip(got, ref)), d_fold


def test_refold_group_mirrors_the_library(card):
    """kernels.refold_group, K5's lanes a provider from the shape, equals
    the library's at and around every power of two."""
    from protocol_tpu_torch import kernels

    lib = kernels._lib("repair")
    for n in (1, 7, 8, 9, 15, 16, 17, 63, 64, 65, 128, 129, 255, 256, 257, 1000, 5000):
        assert kernels.refold_group(n) == lib.k5_group(n), n


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


@pytest.fixture
def views(card):
    """A function giving a mesh of D views of the card (utils/platform.py);
    the count is restored after."""
    from protocol_tpu_torch.parallel.mesh import make_mesh
    from protocol_tpu_torch.utils import platform

    prev = platform.force_virtual_devices(8, "cuda")
    yield lambda D: make_mesh(D, card)
    platform.force_virtual_devices(prev, "cuda")


def k16_check(mesh, cp, cc, state, B0, segments, route):
    """K16 by ``route`` against the plain rounds over ``segments`` of (eps,
    B, max_iters, stall_limit) from the same shards: the (it, stall, open)
    triple and the seven state fields after each, bit for bit. Returns the
    kernel's stacked shard."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.parallel import sparse as ps

    key = "mesh_segment" if route == "segment" else "mesh_round_bid"
    T = cp.shape[0]
    got = ps._make_shards(mesh, cp, cc, True, *state, B0)
    ref = ps._make_shards(mesh, cp, cc, True, *state, B0)
    before = kernels.LAUNCHES[key]
    for eps, B, max_iters, stall_limit in segments:
        out_k = ps._segment(mesh, *got, T, eps, B, max_iters, stall_limit, route)
        out_p = ps._segment(mesh, *ref, T, eps, B, max_iters, stall_limit, "plain")
        assert out_k == out_p, (eps, B)
        for name in ("price", "owner", "p4t", "retired", "ctl", "win_key", "win_task"):
            assert same_bits(getattr(got[1], name), getattr(ref[1], name)), (eps, B, name)
    assert kernels.LAUNCHES[key] > before
    return got[1]


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("route", ["segment", "rounds"])
def test_mesh_round_kernels_match_plain_bits(card, views, route, D):
    """K16 over 256-round segments of the sharded phase at D views (a cold
    segment, then one from the carried state at a smaller frontier), by
    the segment launch and by the three launches a round, the whole state
    compared with the plain rounds on the same inputs."""
    n = 4096
    ep = synth_providers(np.random.default_rng(2), n, device=card)
    er = synth_requirements(np.random.default_rng(3), n, device=card)
    cp, cc = sp.candidates_topk_bidir(ep, er, CostWeights(), k=64, tile=512)
    state = (torch.zeros(n, device=card), torch.full((n,), -1, dtype=torch.int32, device=card),
             torch.full((n,), -1, dtype=torch.int32, device=card),
             torch.zeros(n, dtype=torch.bool, device=card))
    Tl = n // D
    st = k16_check(views(D), cp, cc, state, min(1024, Tl),
                   ((4.0, min(1024, Tl), 256, 0), (1.0, 256, 256, 0)), route)
    assert int((st.p4t >= 0).sum()) > 0


def k16_market(seed: int, T: int, P: int, K: int, p_inf: float = 0.1, hi: float = 5.0):
    """Random candidate arrays [T, K] over P providers, a share ``p_inf`` of
    the entries absent (-1, infeasible cost)."""
    rng = np.random.default_rng(seed)
    cp = np.stack([rng.choice(P, K, replace=False) for _ in range(T)]).astype(np.int32)
    cc = rng.uniform(0.0, hi, (T, K)).astype(np.float32)
    drop = rng.random((T, K)) < p_inf
    cp[drop], cc[drop] = -1, np.float32(1e9)
    return cp, cc


# K16's seams: (D, T, P, K, p_inf, hi, B0, segments of (eps, B, max_iters,
# stall_limit)), each segment from the state the last one left
K16_CASES = {
    # every row seated after 13 rounds of a 600-round phase
    "stops_midway": (4, 2048, 3000, 8, 0.1, 5.0, 512, ((0.5, 512, 600, 0),)),
    # max_iters below a launch's 256 rounds ends both segments with rows open
    "few_rounds": (4, 2048, 2400, 8, 0.1, 5.0, 16, ((0.05, 16, 20, 0), (0.05, 8, 37, 0))),
    # a stall exit: 700 providers for 2,048 rows, 1,348 left open
    "stall_exit": (8, 2048, 700, 6, 0.1, 5.0, 64, ((0.001, 64, 4000, 8),)),
    # most rows retire: half the candidates absent, costs spread to 1e4
    "retirement": (4, 2048, 600, 6, 0.5, 1e4, 256, ((1.0, 256, 600, 0),)),
    # one round, then a frontier wider than the rows left open
    "wide_frontier": (2, 1024, 2000, 12, 0.1, 5.0, 512, ((4.0, 512, 1, 0), (0.5, 512, 300, 0))),
    # four bids a round: a phase of several launches, the loop state
    # carried from one to the next
    "many_launches": (2, 1024, 1100, 4, 0.1, 5.0, 2, ((0.01, 2, 900, 0),)),
    # 8 words a shard: a block of a 16- or 8-block cluster holds words of
    # two shards (3 or 6 words a block); fewer providers than rows, so rows
    # stay open, evictions cross shards, and the rows left over retire
    "shards_share_a_block": (6, 1536, 1400, 8, 0.1, 5.0, 256, ((1.0, 256, 300, 0),)),
    # 1,000 rows a shard, its last word ragged; 6 or 12 words a block, so a
    # block holds the end of one shard and the start of the next; 40
    # rounds, then a narrower frontier from the carried state to a stall
    "ragged_shards": (3, 3000, 2900, 8, 0.1, 5.0, 512, ((1.0, 512, 40, 0),
                                                         (0.2, 128, 300, 8))),
}


@pytest.mark.parametrize("name", sorted(K16_CASES))
@pytest.mark.parametrize("route", ["segment", "rounds"])
def test_mesh_round_kernels_cases_match_plain_bits(card, views, monkeypatch, route, name):
    """K16 by ``route`` against the plain rounds on each seam of K16_CASES;
    the segment launch at every cluster size K2 runs at on this card."""
    from protocol_tpu_torch import kernels

    D, T, P, K, p_inf, hi, B0, segments = K16_CASES[name]
    cp, cc = (torch.from_numpy(a).to(card) for a in k16_market(7, T, P, K, p_inf, hi))
    state = (torch.zeros(P, device=card), torch.full((P,), -1, dtype=torch.int32, device=card),
             torch.full((T,), -1, dtype=torch.int32, device=card),
             torch.zeros(T, dtype=torch.bool, device=card))
    for C in k2_sizes() if route == "segment" else [None]:
        if C is not None:
            monkeypatch.setattr(kernels, "k2_cluster", lambda dev, C=C: C)
        k16_check(views(D), cp, cc, state, B0, segments, route)


def test_mesh_segment_refused_cluster_raises(card, views):
    """A cluster size the card refuses raises with its cudaError and counts
    no launch; the segment route picks the launch on a mesh of views."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.parallel import sparse as ps

    mesh = views(4)
    cp, cc = (torch.from_numpy(a).to(card) for a in k16_market(3, 1024, 800, 8))
    state = (torch.zeros(800, device=card), torch.full((800,), -1, dtype=torch.int32, device=card),
             torch.full((1024,), -1, dtype=torch.int32, device=card),
             torch.zeros(1024, dtype=torch.bool, device=card))
    _, st = ps._make_shards(mesh, cp, cc, True, *state, 128)
    assert ps.segment_route(mesh.devices, 256, 8, 128) == "segment"
    before = kernels.LAUNCHES["mesh_segment"]
    with pytest.raises(RuntimeError, match="cudaError"):
        kernels.mesh_segment(st.cand_safe, st.value_base, st.feasible, st.give_up, st.price,
                             st.owner, st.p4t, st.retired, st.ctl, 1.0, 128, 8, 0, True,
                             cluster=32)
    assert kernels.LAUNCHES["mesh_segment"] == before


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


# ------------- K14's feasibility cases (shared with tests/test_torch_blocked.py) -------------
# Marketplaces on which the feasibility launch's cost bracket
# (csrc/blocked.cu) leaves cells to the exact cost, or whose shapes and
# values stress the launch's layout: prices within a few ulps of
# INFEASIBLE/2 (an ulp is 32 there), each sign of the proximity and 0, no
# row and every row located, non-finite prices, priorities and
# proximities, rows and columns without a compatible cell, P and T off
# multiples of 32, and 8 GPU options over 8 model-mask words. Each case
# is (provider arrays, requirement arrays, CostWeights keywords). The CPU
# tests hold a model of the launch's rule against the reference; the card
# tests hold the launch against the plain packer, word for word.

HALF_INFEASIBLE = np.float32(5e8)


def _feas_market(seed: int, P: int, T: int):
    rng = np.random.default_rng(seed)
    return rng, synth_provider_arrays(rng, P), synth_requirement_arrays(rng, T)


def _near_half(rng, pa, ra, spread: float, frac: float = 0.6, sign: float = -1.0):
    """Prices of ``frac`` of the providers at INFEASIBLE/2 + sign x [0,
    spread] (loads 0), and task priorities of 0 or +-1, 2 ulps there."""
    P, T = pa["price"].shape[0], ra["priority"].shape[0]
    on = rng.random(P) < frac
    off = sign * np.round(rng.uniform(0.0, spread, P) / 32.0) * 32.0 + 32.0 * rng.integers(-4, 5, P)
    pa["price"] = np.where(on, HALF_INFEASIBLE + off, pa["price"]).astype(np.float32)
    pa["load"] = np.where(on, 0.0, pa["load"]).astype(np.float32)
    ra["priority"] = rng.choice(np.float32([0.0, 32.0, -32.0, 64.0]), T)


def _wide_options(rng, pa, ra, K: int = 8, W: int = 8):
    """K GPU options a requirement over W model-mask words, provider models
    in [-1, 32 W)."""
    T, P = ra["priority"].shape[0], pa["price"].shape[0]
    valid = rng.random((T, K)) < 0.5
    valid[np.arange(T), rng.integers(0, K, T)] = True
    ra.update(
        gpu_opt_valid=valid,
        gpu_count=rng.choice(np.int32([-1, 1, 2, 4, 8]), (T, K)),
        gpu_mem_min=rng.choice(np.int32([-1, 16000, 40000]), (T, K)),
        gpu_mem_max=rng.choice(np.int32([-1, 40000, 80000]), (T, K)),
        gpu_total_mem_min=rng.choice(np.int32([-1, 32000, 160000]), (T, K)),
        gpu_total_mem_max=rng.choice(np.int32([-1, 320000]), (T, K)),
        gpu_model_mask=np.where(rng.random((T, K, W)) < 0.5,
                                rng.integers(0, 2**32, (T, K, W), dtype=np.uint64), 0
                                ).astype(np.uint32),
        gpu_model_constrained=valid & (rng.random((T, K)) < 0.7),
    )
    pa["gpu_model_id"] = rng.integers(-1, 32 * W, P).astype(np.int32)


def feasibility_cases() -> dict:
    cases = {}
    near = dict(priority=1.0)
    # the bracket [0, 20.016] at proximity 0.001: a cell at 5e8 - 32 straddles
    rng, pa, ra = _feas_market(1, 200, 170)
    _near_half(rng, pa, ra, 64.0)
    cases["straddle"] = (pa, ra, dict(near, proximity=0.001))
    # proximity 1: the bracket [0, 20,016]; every located row
    rng, pa, ra = _feas_market(2, 160, 200)
    _near_half(rng, pa, ra, 20_100.0)
    cases["straddle_far"] = (pa, ra, dict(near, proximity=1.0))
    # a negative proximity: the bracket [-20,016, 0], prices above 5e8
    rng, pa, ra = _feas_market(3, 170, 150)
    _near_half(rng, pa, ra, 20_100.0, sign=1.0)
    cases["negative"] = (pa, ra, dict(near, proximity=-1.0))
    # proximity 0: the bracket [0, 0], the exact cost, at the threshold
    rng, pa, ra = _feas_market(4, 150, 160)
    _near_half(rng, pa, ra, 128.0, sign=1.0)
    _near_half(rng, pa, ra, 128.0)
    cases["zero"] = (pa, ra, dict(near, proximity=0.0))
    # no row located, and half of each side located
    for name, frac, seed in (("unlocated", 0.0, 5), ("half_located", 0.5, 6)):
        rng, pa, ra = _feas_market(seed, 180, 140)
        _near_half(rng, pa, ra, 20_100.0)
        pa["has_location"] = rng.random(180) < frac
        ra["has_location"] = rng.random(140) < frac
        cases[name] = (pa, ra, dict(near, proximity=1.0))
    # NaN and infinite prices and priorities
    rng, pa, ra = _feas_market(7, 150, 130)
    _near_half(rng, pa, ra, 64.0)
    pa["price"][rng.choice(150, 30, replace=False)] = rng.choice(
        np.float32([np.nan, np.inf, -np.inf]), 30)
    ra["priority"][rng.choice(130, 25, replace=False)] = rng.choice(
        np.float32([np.nan, np.inf, -np.inf]), 25)
    cases["nan_inf"] = (pa, ra, dict(near, proximity=0.001))
    # a proximity that is not finite: every located cell takes the exact cost
    for name, prox, seed in (("inf_proximity", np.inf, 8), ("nan_proximity", np.nan, 9)):
        rng, pa, ra = _feas_market(seed, 120, 110)
        pa["has_location"] = rng.random(120) < 0.7
        cases[name] = (pa, ra, dict(proximity=float(prox)))
    # rows and columns with no compatible cell
    rng, pa, ra = _feas_market(10, 160, 150)
    pa["valid"][:9] = False
    pa["has_gpu"][9:20] = False
    ra["gpu_count"][:13, 0] = 99
    ra["valid"][13:17] = False
    cases["empty_lines"] = (pa, ra, dict(proximity=0.001))
    # P and T off multiples of 32, at the threshold
    rng, pa, ra = _feas_market(11, 97, 131)
    _near_half(rng, pa, ra, 64.0)
    cases["ragged"] = (pa, ra, dict(near, proximity=0.001))
    # 8 GPU options over 8 model-mask words
    rng, pa, ra = _feas_market(12, 190, 150)
    _wide_options(rng, pa, ra)
    cases["wide_options"] = (pa, ra, dict(proximity=0.001))
    return cases


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



def check_bitmaps_against_packer(ep, er, w):
    """K14's feasibility launch against the plain packer, word for word, and
    row_any / col_any the bitmaps' any()."""
    from protocol_tpu_torch import kernels
    from protocol_tpu_torch.ops import blocked as bl

    row_any, col_any, bits = kernels.blocked_feasibility(ep, er, w)
    ref = bl.pack_feasibility(ep, er, w, chunk=64)
    assert torch.equal(bits.rows, ref.rows) and torch.equal(bits.cols, ref.cols)
    mask = bl.unpack_words(ref.rows, er.num)
    assert torch.equal(row_any, mask.any(dim=1)) and torch.equal(col_any, mask.any(dim=0))
    return mask


@pytest.mark.parametrize("name", sorted(feasibility_cases()))
def test_blocked_feasibility_cases_match_the_plain_packer(card, name):
    """The feasibility launch on each of its cases (check_bitmaps_against_packer)."""
    from protocol_tpu_torch.ops.encoding import providers_from_numpy, requirements_from_numpy

    pa, ra, wk = feasibility_cases()[name]
    check_bitmaps_against_packer(providers_from_numpy(pa, card), requirements_from_numpy(ra, card),
                                 CostWeights(**wk))


@pytest.mark.parametrize("P,T", [(9000, 3000), (2100, 700)])
def test_blocked_feasibility_over_several_blocks_matches_the_plain_packer(card, P, T):
    """Several 256-task tiles and provider ranges (check_bitmaps_against_packer)."""
    ep = synth_providers(np.random.default_rng(P), P, device=card)
    er = synth_requirements(np.random.default_rng(T), T, device=card)
    mask = check_bitmaps_against_packer(ep, er, CostWeights())
    assert 0 < int(mask.sum()) < P * T


@pytest.mark.parametrize("name", ["straddle", "ragged", "wide_options", "empty_lines"])
def test_shard_bitmaps_on_the_cases_match_the_plain_packer(card, views, name):
    """Each of D = 4 shards of a feasibility case (the shards of the
    provider-sharded Sinkhorn) against the plain packer on the shard."""
    from protocol_tpu_torch.ops.encoding import providers_from_numpy, requirements_from_numpy
    from protocol_tpu_torch.parallel import sinkhorn as psk

    pa, ra, wk = feasibility_cases()[name]
    P = pa["price"].shape[0]
    keep = P // 4 * 4
    pa = {k_: v_[:keep] for k_, v_ in pa.items()}
    ep = providers_from_numpy(pa, card)
    er = requirements_from_numpy(ra, card)
    for ep_s in psk._shard_providers(ep, views(4)):
        check_bitmaps_against_packer(ep_s, er, CostWeights(**wk))


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
