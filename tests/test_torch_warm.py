"""The port's warm path: the delta-frontier warm auction fed the reference's
inputs, and a TorchSolveArena warm chain (default cold_every) held against
JaxSolveArena(devices=1) tick by tick on the same numpy inputs:
bit-identical at CostWeights(proximity=0.0), within the reference's own
jax A/B bounds (scripts/perf_floor.json) at default weights. Plus the port
twins of tests/test_jax_engine.py's warm-chain and export/restore cases."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from protocol_tpu.native.arena import _P_SPEC as J_P_SPEC
from protocol_tpu.native.arena import _R_SPEC as J_R_SPEC
from protocol_tpu.native.arena import _canon as j_canon
from protocol_tpu.ops.cost import CostWeights as JCostWeights
from protocol_tpu.ops.sparse import assign_auction_sparse_scaled as j_scaled
from protocol_tpu.ops.sparse import assign_auction_sparse_warm as j_warm
from protocol_tpu.parallel.jax_arena import JaxSolveArena
from protocol_tpu_torch.native.arena import _P_SPEC, _R_SPEC, _canon, _dirty_rows
from protocol_tpu_torch.ops.cost import CostWeights
from protocol_tpu_torch.ops.sparse import assign_auction_sparse_warm
from protocol_tpu_torch.parallel.torch_arena import TorchSolveArena

from tests.test_torch_arena import FLOOR, STATE_ARRAYS, market
from tests.test_torch_auction import cands, unfillable
from tests.test_torch_candidates import bits
from tests.test_torch_encoding_cost import encode_random, to_port


def unique_seats(p4t):
    seated = p4t[p4t >= 0]
    assert np.unique(seated).size == seated.size


def bump_price(ep, rows, delta=0.25):
    price = np.array(ep.price, copy=True)
    price[list(rows)] += delta
    return dataclasses.replace(ep, price=price)


def churn_ram(er, rows, rng):
    ram = np.array(er.ram_mb, copy=True)
    ram[rows] = np.maximum(256, (ram[rows] * rng.uniform(0.8, 1.25, len(rows))).astype(ram.dtype))
    return dataclasses.replace(er, ram_mb=ram)


# ---------------- the warm auction, fed the reference's inputs -------------


def warm_inputs(kind):
    """Candidate arrays and a warm state a cold ladder left on them, with
    the prices raised so the uniform down-shift acts and some seeds
    dropped or moved (what a churned tick hands the warm auction)."""
    cp, cc = cands(96, 128) if kind == "synth" else unfillable()
    P = int(cp.max()) + 1
    res, price, retired = j_scaled(jnp.asarray(cp), jnp.asarray(cc), num_providers=P,
                                   with_state=True)
    rng = np.random.default_rng(4)
    p4t = np.array(res.provider_for_task, np.int32)
    p4t[rng.random(p4t.size) < 0.2] = -1
    price = np.array(price, np.float32) + np.float32(40.0)  # above finite_max + 5
    retired = np.array(retired, bool) & (rng.random(p4t.size) < 0.5)
    return cp, cc, P, price, p4t, retired


@pytest.mark.parametrize("kind", ["synth", "unfillable"])
@pytest.mark.parametrize("ladder", [True, False])
def test_warm_auction_bit_identical(kind, ladder):
    """Same cand_*, price0, p4t0, retired0 in: the reference's bits out
    (matching, shifted and raised prices, retirement, rounds, stall)."""
    cp, cc, P, price, p4t, retired = warm_inputs(kind)
    js, ts = {}, {}
    jres, jprice, jret = j_warm(
        jnp.asarray(cp), jnp.asarray(cc), P, jnp.asarray(price), jnp.asarray(p4t),
        retired0=jnp.asarray(retired), stats_out=js, frontier_ladder=ladder, with_state=True,
    )
    tres, tprice, tret = assign_auction_sparse_warm(
        torch.tensor(cp), torch.tensor(cc), P, torch.tensor(price),
        torch.tensor(p4t), retired0=torch.tensor(retired), stats_out=ts,
        frontier_ladder=ladder, with_state=True,
    )
    np.testing.assert_array_equal(tres.provider_for_task.numpy(), np.asarray(jres.provider_for_task))
    np.testing.assert_array_equal(tres.task_for_provider.numpy(), np.asarray(jres.task_for_provider))
    np.testing.assert_array_equal(bits(tprice.numpy()), bits(np.asarray(jprice)))
    np.testing.assert_array_equal(tret.numpy(), np.asarray(jret))
    assert ts == js
    assert float(tprice.min()) < float(price.min())  # the shift acted


def test_warm_auction_without_retired_seed_or_state():
    cp, cc, P, price, p4t, _ = warm_inputs("unfillable")
    jres, jprice = j_warm(jnp.asarray(cp), jnp.asarray(cc), P, jnp.asarray(price),
                          jnp.asarray(p4t))
    tres, tprice = assign_auction_sparse_warm(torch.tensor(cp), torch.tensor(cc), P,
                                              torch.tensor(price), torch.tensor(p4t))
    np.testing.assert_array_equal(tres.provider_for_task.numpy(), np.asarray(jres.provider_for_task))
    np.testing.assert_array_equal(bits(tprice.numpy()), bits(np.asarray(jprice)))


# ---------------- the warm chain against the reference arena -------------


def chain_steps(ep, er, seed=11):
    """(label, call) steps of a warm chain: cold, provider churn,
    requirement churn, byte-identical, a churned tick that takes the dual
    refresh (dual_refresh_every=2), reconcile, then an apply_rows event."""
    rng = np.random.default_rng(seed)
    P = np.asarray(ep.price).shape[0]
    T = np.asarray(er.ram_mb).shape[0]
    ep1 = bump_price(ep, rng.choice(P, max(1, P // 100), replace=False))
    er2 = churn_ram(er, rng.choice(T, max(1, T // 100), replace=False), rng)
    er4 = churn_ram(er2, rng.choice(T, max(1, T // 50), replace=False), rng)
    ev_rows = np.sort(rng.choice(P, 3, replace=False)).astype(np.int32)
    return [
        ("cold", ("solve", ep, er)),
        ("provider churn", ("solve", ep1, er)),
        ("requirement churn", ("solve", ep1, er2)),
        ("byte-identical", ("solve", ep1, er2)),
        ("dual refresh", ("solve", ep1, er4)),
        ("reconcile", ("reconcile",)),
        ("apply_rows", ("apply_rows", ev_rows)),
    ]


def run_chain(arena, steps, weights, spec_canon, to_cols):
    out = []
    ep_cur = None
    for label, call in steps:
        if call[0] == "solve":
            ep_cur = call[1]
            p4t = arena.solve(*to_cols(call[1], call[2]), weights)
        elif call[0] == "reconcile":
            p4t = arena.reconcile()
        else:
            rows = call[1]
            pf = spec_canon(ep_cur)
            vals = {n: np.array(pf[n][rows], copy=True) for n in pf}
            vals["price"] = vals["price"] + np.float32(0.5)
            p4t = arena.apply_rows(rows, vals, None, None, weights)
        st = arena.export_state()
        out.append((label, np.array(p4t), st, dict(arena.last_stats)))
    return out


def both_chains(kind, proximity):
    ep, er = market(kind)
    steps = chain_steps(ep, er)
    ja = JaxSolveArena(devices=1, dual_refresh_every=2)
    ta = TorchSolveArena(device="cpu", dual_refresh_every=2)
    jw, tw = JCostWeights(proximity=proximity), CostWeights(proximity=proximity)
    jout = run_chain(ja, steps, jw, lambda e: j_canon(e, J_P_SPEC), lambda a, b: (a, b))
    tout = run_chain(ta, steps, tw, lambda e: _canon(e, _P_SPEC), to_port)
    return jout, tout


# stats both arenas report on every warm chain tick; only the reference's
# jit-witness keys and its device count differ (see the keys test below)
CHAIN_KEYS = ("cold", "cand_cold_passes", "dirty_providers", "dirty_tasks", "changed_rows",
              "assigned", "repair_rows", "repair_providers", "repair_blocks",
              "repair_enter_rows", "visited_cells_frac", "dual_refresh", "reconcile", "event",
              "warm_solves_since_cold", "eng_rounds_total", "eng_stall_exit", "plan_cost",
              "gap_per_task", "churn_rows", "starving")


@pytest.mark.parametrize("kind", ["synth512", "synth_skew", "encoded"])
def test_warm_chain_bit_identical_without_proximity(kind):
    jout, tout = both_chains(kind, 0.0)
    for (label, jp, js, jst), (_, tp, ts, tst) in zip(jout, tout):
        np.testing.assert_array_equal(tp, jp, err_msg=label)
        for name in STATE_ARRAYS:
            np.testing.assert_array_equal(bits(ts[name]), bits(js[name]), err_msg=f"{label} {name}")
        for key in CHAIN_KEYS:
            assert tst.get(key) == jst.get(key), (label, key)
    labels = [(lab, st["cold"], st["cand_cold_passes"]) for lab, _, _, st in tout]
    assert labels[0] == ("cold", True, 1)
    assert all(not cold and passes == 0 for _, cold, passes in labels[1:])
    assert tout[4][3]["dual_refresh"] is True
    assert tout[3][3]["changed_rows"] == 0 and tout[3][3]["warm_solves_since_cold"] == 3


@pytest.mark.parametrize("kind", ["synth512", "synth_skew"])
def test_warm_chain_within_jax_ab_bounds(kind):
    jout, tout = both_chains(kind, 0.001)
    for (label, _, _, jst), (_, tp, _, tst) in zip(jout, tout):
        unique_seats(tp)
        assert tst["cand_cold_passes"] == jst["cand_cold_passes"], label
        rows = jst["rows"]
        frac_delta = (jst["assigned"] - tst["assigned"]) / rows
        assert frac_delta <= FLOOR["jax_ab_assigned_min_frac_delta_max"], label
        if "plan_cost" in jst:
            assert tst["plan_cost"] / jst["plan_cost"] <= FLOOR["jax_ab_plan_cost_ratio_max"], label
            gap_delta = abs(tst["gap_per_task"] - jst["gap_per_task"])
            assert gap_delta <= FLOOR["jax_ab_gap_per_task_delta_max"], label


def test_warm_last_stats_keys_mirror_the_reference():
    """Per tick kind, the port's keys are the reference's, except: the
    reference's device count ``jax_devices`` is ``torch_devices`` here,
    its jit-witness keys (``jit_*``, only when armed) have no counterpart,
    and the repair's ``pad_hw`` (the JAX retrace pad ratchet) is gone,
    since the port pads nothing."""
    jout, tout = both_chains("synth_skew", 0.0)
    for (label, _, _, jst), (_, _, _, tst) in zip(jout, tout):
        ref = {k for k in jst if not k.startswith("jit_")} - {"jax_devices", "pad_hw"}
        assert set(tst) == ref | {"torch_devices"}, label
    assert "pad_hw" in jout[1][3]


# ---------------- port twins of tests/test_jax_engine.py ----------------


def _market(seed=3, P=96, T=64):
    return encode_random(seed, P, T)


def _solve(arena, ep, er, w=None):
    return arena.solve(*to_port(ep, er), w or CostWeights())


def test_warm_churn_repairs_without_cold_pass():
    ep, er = _market()
    a = TorchSolveArena(k=16, device="cpu")
    _solve(a, ep, er)
    p4t = _solve(a, bump_price(ep, [5]), er)
    unique_seats(p4t)
    s = a.last_stats
    assert s["cold"] is False and s["cand_cold_passes"] == 0
    assert s["dirty_providers"] == 1 and s["dirty_tasks"] == 0
    assert s["repair_providers"] >= 1 and 0.0 < s["visited_cells_frac"] < 1.0


def test_regen_equals_cold_rebuild_bit_for_bit():
    ep, er = _market()
    a = TorchSolveArena(k=16, device="cpu")
    _solve(a, ep, er)
    ep2 = bump_price(ep, [1, 7, 11])
    _solve(a, ep2, er)
    fresh = TorchSolveArena(k=16, device="cpu")
    _solve(fresh, ep2, er)
    for name in ("cand_p", "cand_c", "fwd_p", "fwd_c", "pool_t", "pool_c"):
        np.testing.assert_array_equal(getattr(a, f"_{name}"), getattr(fresh, f"_{name}"))


def test_byte_identical_marketplace_short_circuits():
    ep, er = _market()
    a = TorchSolveArena(k=16, device="cpu")
    first = _solve(a, ep, er)
    again = _solve(a, ep, er)
    np.testing.assert_array_equal(first, again)
    s = a.last_stats
    assert s["cold"] is False and s["cand_cold_passes"] == 0 and s["changed_rows"] == 0
    assert s["warm_solves_since_cold"] == 1


def test_heavy_churn_falls_back_to_cold():
    ep, er = _market()
    a = TorchSolveArena(k=16, max_dirty_frac=0.1, device="cpu")
    _solve(a, ep, er)
    _solve(a, bump_price(ep, range(48)), er)
    assert a.last_stats["cold"] is True


def test_weights_change_regrounds_cold():
    ep, er = _market()
    a = TorchSolveArena(k=16, device="cpu")
    _solve(a, ep, er)
    _solve(a, ep, er, CostWeights(price=2.0))
    assert a.last_stats["cold"] is True


def test_cold_every_forces_a_cold_tick():
    ep, er = _market()
    a = TorchSolveArena(k=16, cold_every=1, device="cpu")
    _solve(a, ep, er)
    _solve(a, bump_price(ep, [5]), er)
    assert a.last_stats["cold"] is False
    _solve(a, bump_price(ep, [6]), er)
    assert a.last_stats["cold"] is True


def test_apply_rows_refusals():
    ep, er = _market()
    a = TorchSolveArena(k=16, device="cpu")
    with pytest.raises(RuntimeError, match="not primed"):
        a.apply_rows(None, None, None, None, CostWeights())
    _solve(a, ep, er)
    with pytest.raises(ValueError, match="different weights"):
        a.apply_rows(None, None, None, None, CostWeights(price=3.0))
    pf = _canon(to_port(ep, er)[0], _P_SPEC)
    vals = {n: pf[n][[0]] for n, _ in _P_SPEC}
    with pytest.raises(ValueError, match="out of range"):
        a.apply_rows(np.array([96]), vals, None, None, CostWeights())


def test_apply_rows_event_flow():
    ep, er = _market()
    a = TorchSolveArena(k=16, device="cpu")
    base = _solve(a, ep, er)
    pf = _canon(to_port(ep, er)[0], _P_SPEC)
    rows = np.array([4], np.int32)
    vals = {n: np.asarray(pf[n][rows]) for n, _ in _P_SPEC}
    np.testing.assert_array_equal(a.apply_rows(rows, vals, None, None, CostWeights()), base)
    assert a.last_stats["dirty_providers"] == 0 and a.last_stats["cand_cold_passes"] == 0
    assert a.last_repair_mask is None

    vals["price"] = np.asarray(vals["price"]) + 0.5
    p4t = a.apply_rows(rows, vals, None, None, CostWeights())
    unique_seats(p4t)
    s = a.last_stats
    assert s["event"] is True and s["dirty_providers"] == 1 and s["cand_cold_passes"] == 0
    assert s["repair_providers"] >= 1 and s["visited_cells_frac"] < 1.0
    assert a.last_repair_mask is not None
    fresh = TorchSolveArena(k=16, device="cpu")
    _solve(fresh, bump_price(ep, [4], delta=0.5), er)
    np.testing.assert_array_equal(a._cand_p, fresh._cand_p)
    np.testing.assert_array_equal(a._cand_c, fresh._cand_c)


def test_apply_rows_task_event_matches_the_reference():
    """A requirement-row event: the dirty task is re-seated, the parts
    repaired, and the matching equals the reference's event."""
    ep, er = _market()
    ja, ta = JaxSolveArena(k=16, devices=1), TorchSolveArena(k=16, device="cpu")
    ja.solve(ep, er, JCostWeights())
    _solve(ta, ep, er)
    rf = j_canon(er, J_R_SPEC)
    rows = np.array([2, 9], np.int32)
    vals = {n: np.array(rf[n][rows], copy=True) for n in rf}
    vals["cpu_cores"] = np.maximum(1, vals["cpu_cores"] + 1).astype(np.int32)
    jp = ja.apply_rows(None, None, rows, vals, JCostWeights())
    tp = ta.apply_rows(None, None, rows, vals, CostWeights())
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ta.last_repair_mask, ja.last_repair_mask)
    assert ta.last_stats["dirty_tasks"] == 2
    np.testing.assert_array_equal(bits(ta.price), bits(ja.price))


def test_dirty_rows_copy_matches_the_reference():
    ep, er = _market()
    er2 = dataclasses.replace(er, cpu_cores=np.array(er.cpu_cores, copy=True))
    er2.cpu_cores[[3, 40]] += 1
    from protocol_tpu.native.arena import _dirty_rows as j_dirty_rows

    new, old = j_canon(er2, J_R_SPEC), j_canon(er, J_R_SPEC)
    np.testing.assert_array_equal(_dirty_rows(new, old, _R_SPEC), j_dirty_rows(new, old, J_R_SPEC))
    assert np.flatnonzero(_dirty_rows(new, old, _R_SPEC)).tolist() == [3, 40]


def test_restored_carry_continues_on_repair_path():
    ep, er = _market()
    a = TorchSolveArena(k=16, device="cpu")
    _solve(a, ep, er)
    state = a.export_state()
    for name in ("fwd_p", "fwd_c", "pool_t", "pool_c"):
        assert state[name] is not None
    b = TorchSolveArena(k=16, device="cpu")
    b.restore_state(*to_port(ep, er), state)
    ep2 = bump_price(ep, [3])
    got = _solve(b, ep2, er)
    assert b.last_stats["cand_cold_passes"] == 0 and b.last_stats["repair_providers"] >= 1
    want = _solve(a, ep2, er)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(b._fwd_p, a._fwd_p)
    np.testing.assert_array_equal(b._pool_c, a._pool_c)


def test_roundtrip_continues_bit_identically():
    ep, er = _market()
    a = TorchSolveArena(k=16, device="cpu")
    _solve(a, ep, er)
    ep2 = bump_price(ep, [5])
    _solve(a, ep2, er)
    state = a.export_state()
    b = TorchSolveArena(k=16, device="cpu")
    b.restore_state(*to_port(ep2, er), state)
    ep3 = bump_price(ep, [5, 9])
    got = _solve(b, ep3, er)
    want = _solve(a, ep3, er)
    np.testing.assert_array_equal(got, want)
    assert b.last_stats["cold"] is False
    np.testing.assert_array_equal(b.price, a.price)


def test_pre_repair_carry_regrounds_cold():
    ep, er = _market()
    a = TorchSolveArena(k=16, device="cpu")
    _solve(a, ep, er)
    state = a.export_state()
    for name in ("fwd_p", "fwd_c", "pool_t", "pool_c"):
        del state[name]
    b = TorchSolveArena(k=16, device="cpu")
    b.restore_state(*to_port(ep, er), state)
    _solve(b, ep, er)
    assert b.last_stats["cold"] is True
