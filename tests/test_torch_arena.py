"""The port's cold solve tick (TorchSolveArena on the CPU) held against the
reference's JaxSolveArena(devices=1, cold_every=0) on the same numpy
inputs: bit-identical without the haversine term, within the reference's
own jax A/B bounds (scripts/perf_floor.json) with it."""

import json
import pathlib

import numpy as np
import pytest
import torch

from protocol_tpu.ops.cost import CostWeights as JCostWeights
from protocol_tpu.parallel.jax_arena import JaxSolveArena
from protocol_tpu.trace import synth as j_synth
from protocol_tpu_torch.ops.cost import CostWeights
from protocol_tpu_torch.parallel.torch_arena import TorchSolveArena
from protocol_tpu_torch.trace import synth as t_synth

from tests.test_torch_candidates import bits
from tests.test_torch_encoding_cost import encode_random, to_port

FLOOR = json.loads(
    (pathlib.Path(__file__).resolve().parent.parent / "scripts" / "perf_floor.json").read_text()
)
STATE_ARRAYS = ("cand_p", "cand_c", "fwd_p", "fwd_c", "pool_t", "pool_c",
                "price", "retired", "p4t")


def market(kind):
    if kind == "synth512":
        return (j_synth.synth_providers(np.random.default_rng(2), 512),
                j_synth.synth_requirements(np.random.default_rng(3), 512))
    if kind == "synth_skew":  # more tasks than providers: an unfillable tail
        return (j_synth.synth_providers(np.random.default_rng(4), 160),
                j_synth.synth_requirements(np.random.default_rng(5), 256))
    return encode_random(9, 96, 200)  # absent specs, 4 options, no locations


def solve_both(kind, proximity):
    ep, er = market(kind)
    ja = JaxSolveArena(devices=1, cold_every=0)
    jp = ja.solve(ep, er, JCostWeights(proximity=proximity))
    ta = TorchSolveArena(device="cpu")
    tp_, tr_ = to_port(ep, er)
    tp = ta.solve(tp_, tr_, CostWeights(proximity=proximity))
    return ja, jp, ta, tp


@pytest.mark.parametrize("kind", ["synth512", "synth_skew", "encoded"])
def test_cold_tick_bit_identical_without_proximity(kind):
    ja, jp, ta, tp = solve_both(kind, 0.0)
    assert ja.last_stats["cold"] and ta.last_stats["cold"]
    np.testing.assert_array_equal(tp, jp)
    js, ts = ja.export_state(), ta.export_state()
    for name in STATE_ARRAYS:
        assert ts[name].dtype == js[name].dtype, name
        np.testing.assert_array_equal(bits(ts[name]), bits(js[name]), err_msg=name)
    for name in js:
        if name.startswith(("pf_", "rf_")):
            np.testing.assert_array_equal(ts[name], js[name], err_msg=name)
    for key in ("assigned", "eng_rounds_total", "eng_stall_exit", "eng_stall_rounds",
                "plan_cost", "gap_per_task", "dual_bound"):
        assert ta.last_stats[key] == ja.last_stats[key], key


@pytest.mark.parametrize("kind", ["synth512", "synth_skew"])
def test_cold_tick_within_jax_ab_bounds(kind):
    ja, _, ta, _ = solve_both(kind, 0.001)
    rows = ja.last_stats["rows"]
    ratio = ta.last_stats["plan_cost"] / ja.last_stats["plan_cost"]
    assert ratio <= FLOOR["jax_ab_plan_cost_ratio_max"]
    frac_delta = (ja.last_stats["assigned"] - ta.last_stats["assigned"]) / rows
    assert frac_delta <= FLOOR["jax_ab_assigned_min_frac_delta_max"]
    gap_delta = abs(ta.last_stats["gap_per_task"] - ja.last_stats["gap_per_task"])
    assert gap_delta <= FLOOR["jax_ab_gap_per_task_delta_max"]


def test_last_stats_keys_mirror_the_reference():
    ja, _, ta, _ = solve_both("synth_skew", 0.0)
    ref = {k for k in ja.last_stats if not k.startswith("jit_")} - {"jax_devices"}
    assert set(ta.last_stats) == ref | {"torch_devices"}
    assert ta.last_stats["native_isa"] == "torch:cpu"


def test_reconcile_and_restore_round_trip():
    ep, er = market("synth_skew")
    tp_, tr_ = to_port(ep, er)
    a = TorchSolveArena(device="cpu")
    p4t = a.solve(tp_, tr_, CostWeights())
    state = a.export_state()
    np.testing.assert_array_equal(a.reconcile(), p4t)
    assert a.last_stats["reconcile"] and a.last_stats["cand_cold_passes"] == 0

    b = TorchSolveArena(device="cpu")
    b.restore_state(tp_, tr_, state)
    again = b.export_state()
    for name in STATE_ARRAYS:
        np.testing.assert_array_equal(again[name], state[name], err_msg=name)
    np.testing.assert_array_equal(b.price, a.price)
    np.testing.assert_array_equal(b.reconcile(), p4t)


def test_restore_of_a_foreign_or_skewed_carry_invalidates():
    ep, er = market("synth_skew")
    ja = JaxSolveArena(devices=1, cold_every=0)
    ja.solve(ep, er, JCostWeights())
    tp_, tr_ = to_port(ep, er)
    a = TorchSolveArena(device="cpu")
    a.restore_state(tp_, tr_, ja.export_state())  # tag "jax:cpu"
    assert a.export_state() is None
    with pytest.raises(RuntimeError, match="not primed"):
        a.reconcile()

    a.solve(tp_, tr_, CostWeights())
    state = a.export_state()
    b = TorchSolveArena(device="cpu", k=32)  # candidate width skew
    b.restore_state(tp_, tr_, state)
    assert b.export_state() is None


def test_unported_options_raise():
    """Warm ticks are ported: cold_every and apply_rows take their
    reference meaning (apply_rows refuses an unprimed arena as the
    reference does); approx_recall is still refused."""
    a = TorchSolveArena(device="cpu", cold_every=256)
    assert a.cold_every == 256 and TorchSolveArena(device="cpu").cold_every == 256
    with pytest.raises(RuntimeError, match="not primed"):
        a.apply_rows(None, None, None, None, CostWeights())
    with pytest.raises(NotImplementedError, match="approx_recall"):
        TorchSolveArena(device="cpu", approx_recall=0.95)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card rule cannot be exercised")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchSolveArena()


def test_empty_marketplace():
    a = TorchSolveArena(device="cpu")
    ep = t_synth.synth_providers(np.random.default_rng(0), 0, device="cpu")
    er = t_synth.synth_requirements(np.random.default_rng(0), 5, device="cpu")
    np.testing.assert_array_equal(a.solve(ep, er, CostWeights()), np.full(5, -1, np.int32))
    assert a.last_stats["assigned"] == 0
