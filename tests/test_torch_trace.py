"""The port's flight recorder on the CPU (``protocol_tpu_torch/trace/``:
``format.py``, ``synth.py::synth_trace``, ``replay.py``, ``__main__.py``),
held against the reference's (``protocol_tpu/trace/``).

- Traces cross between the packages both ways: the port's synth_trace
  writes the reference's bytes, each package's reader reads the other's
  files to equal arrays, and iter_input_ticks yields the reference's
  columns tick by tick on the committed golden.
- Without the haversine term a replay is bit for bit: a 256 x 256 trace
  that the reference records at proximity 0 (``replay(engine="jax:1",
  record_path=...)``, 4 ticks) replays through the port with
  ``divergence`` None at D = 1 and D = 4 views and over inproc, wire-v1
  and wire-v2, and a trace the port records replays through the port the
  same way.
- The committed golden (``artifacts/golden_trace_512x512_jax.trace``, the
  North star's referee (b)): the port replays all 9 ticks at D = 1, and
  its quality roll-up stays within the ``jax_ab_*`` bounds of
  ``scripts/perf_floor.json`` against the roll-up of the trace's recorded
  outcome metrics. Its plans differ from the recorded ones in a few rows a
  tick (the haversine's ulps; ROADMAP "Known differences"), and a warm
  tick carries its own earlier plans: GOLDEN_DIVERGENT_ROWS states the
  counts a tick, and the test prints tick 0's rows.

Replays run with one torch thread (the arena's CPU path is many small
ops, which threads only slow down under the test workers)."""

import filecmp
import json
import pathlib

import numpy as np
import pytest
import torch

from protocol_tpu.trace import format as j_fmt
from protocol_tpu.trace.replay import iter_input_ticks as j_iter_input_ticks
from protocol_tpu.trace.replay import replay as j_replay
from protocol_tpu.trace import synth as j_synth
from protocol_tpu_torch.obs.quality import aggregate_quality
from protocol_tpu_torch.trace import format as t_fmt
from protocol_tpu_torch.trace import replay as t_replay
from protocol_tpu_torch.trace import synth as t_synth
from protocol_tpu_torch.trace.__main__ import main as cli_main
from protocol_tpu_torch.utils import platform

ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = str(ROOT / "artifacts" / "golden_trace_512x512_jax.trace")
FLOOR = json.loads((ROOT / "scripts" / "perf_floor.json").read_text())
# rows of each tick whose provider differs from the golden's recorded
# outcome, replayed on the CPU at D = 1 with one torch thread: 7 on the
# cold tick (the haversine's ulps move near-ties), then the carried plans'
# own drift
GOLDEN_DIVERGENT_ROWS = (7, 26, 21, 46, 7, 40, 10, 27, 60)
SYNTH_ARGS = [
    dict(n_providers=64, n_tasks=48, ticks=3),
    dict(n_providers=100, n_tasks=80, ticks=6, task_churn=0.05, headroom=0.2, growth=0.3,
         hotspot_every=2, disconnect_at=3, reconnect_after=2, kernel="jax:2"),
]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("traces")


@pytest.fixture(scope="module")
def ref_recorded(workdir):
    """A 256 x 256 trace, 4 ticks of provider and task churn, recorded by
    the reference's jax engine at proximity 0."""
    src = j_synth.synth_trace(str(workdir / "in.trace"), n_providers=256, n_tasks=256, ticks=3,
                              churn=0.02, task_churn=0.01, kernel="jax:1", seed=5,
                              weights=(1.0, 1.0, 0.0, 0.0))
    rec = str(workdir / "ref_rec.trace")
    j_replay(src, engine="jax:1", record_path=rec)
    return rec


@pytest.fixture(scope="module")
def golden_replay():
    return t_replay.replay(GOLDEN, engine="jax:1", verify=False, keep_p4t=True, device="cpu")


def _same_cols(a: dict, b: dict):
    assert list(a) == list(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def _same_traces(t, j):
    assert t.meta == j.meta and t.truncated == j.truncated and t.n_frames == j.n_frames
    ts, js = t.snapshot, j.snapshot
    assert (ts.trace_id, ts.fingerprint, ts.kernel, ts.top_k, ts.eps, ts.max_iters) == (
        js.trace_id, js.fingerprint, js.kernel, js.top_k, js.eps, js.max_iters)
    assert tuple(ts.weights) == tuple(js.weights)
    _same_cols(ts.p_cols, js.p_cols)
    _same_cols(ts.r_cols, js.r_cols)
    assert len(t.deltas) == len(j.deltas) and len(t.outcomes) == len(j.outcomes)
    for a, b in zip(t.deltas, j.deltas):
        assert a.tick == b.tick and a.events == b.events
        np.testing.assert_array_equal(a.provider_rows, b.provider_rows)
        np.testing.assert_array_equal(a.task_rows, b.task_rows)
        _same_cols(a.p_cols, b.p_cols)
        _same_cols(a.r_cols, b.r_cols)
    for a, b in zip(t.outcomes, j.outcomes):
        assert (a.tick, a.num_assigned, a.metrics) == (b.tick, b.num_assigned, b.metrics)
        np.testing.assert_array_equal(a.provider_for_task, b.provider_for_task)
        assert (a.price is None) == (b.price is None)


# ---------------- the format, both ways ----------------


@pytest.mark.parametrize("args", SYNTH_ARGS, ids=["plain", "every_knob"])
def test_synth_trace_writes_the_reference_bytes(workdir, args):
    a = j_synth.synth_trace(str(workdir / "j_synth.trace"), **args)
    b = t_synth.synth_trace(str(workdir / "t_synth.trace"), **args)
    assert filecmp.cmp(a, b, shallow=False)


def test_each_reader_reads_the_others_files(workdir):
    port_file = t_synth.synth_trace(str(workdir / "port.trace"), **SYNTH_ARGS[1])
    _same_traces(t_fmt.read_trace(port_file), j_fmt.read_trace(port_file))
    _same_traces(t_fmt.read_trace(GOLDEN), j_fmt.read_trace(GOLDEN))
    assert t_fmt.info(GOLDEN) == j_fmt.info(GOLDEN)


def test_a_torn_tail_reads_as_the_reference_reads_it(workdir):
    raw = pathlib.Path(GOLDEN).read_bytes()
    torn = workdir / "torn.trace"
    torn.write_bytes(raw[: len(raw) * 2 // 3])
    t, j = t_fmt.read_trace(str(torn)), j_fmt.read_trace(str(torn))
    assert t.truncated and j.truncated and t.ticks == j.ticks < 9
    _same_traces(t, j)


def test_array_packs_are_the_reference_bytes():
    named = {"b": np.arange(6, dtype=np.int32).reshape(2, 3), "a": None,
             "c": np.float32([1.5, -0.0, np.inf])}
    packed = t_fmt.pack_arrays(named)
    assert packed == j_fmt.pack_arrays(named)
    back = t_fmt.unpack_arrays(packed)
    assert back["a"] is None
    np.testing.assert_array_equal(back["b"], named["b"])
    with pytest.raises(ValueError):
        t_fmt.unpack_arrays(packed[:-3])


def test_iter_input_ticks_yields_the_reference_columns_on_the_golden():
    t_ticks = list(t_replay.iter_input_ticks(t_fmt.read_trace(GOLDEN)))
    j_ticks = list(j_iter_input_ticks(j_fmt.read_trace(GOLDEN)))
    assert [t[0] for t in t_ticks] == [j[0] for j in j_ticks] == list(range(9))
    for (_, tp, tr, _), (_, jp, jr, _) in zip(t_ticks, j_ticks):
        _same_cols(tp, jp)
        _same_cols(tr, jr)
    # copy-on-write: the columns yielded first are never written later
    snap = t_fmt.read_trace(GOLDEN).snapshot
    np.testing.assert_array_equal(t_ticks[0][1]["price"], snap.p_cols["price"])
    assert not np.array_equal(t_ticks[0][1]["price"], t_ticks[-1][1]["price"])


# ---------------- replays without the haversine: bit for bit ----------------


@pytest.mark.parametrize("engine,transport", [
    ("jax:1", "inproc"), ("jax:4", "inproc"), ("jax:1", "wire-v1"), ("jax:1", "wire-v2"),
])
def test_a_reference_recorded_trace_replays_bit_for_bit(ref_recorded, engine, transport):
    prev = platform.force_virtual_devices(4, "cpu")
    try:
        rep = t_replay.replay(ref_recorded, engine=engine, transport=transport, device="cpu")
    finally:
        platform.force_virtual_devices(prev, "cpu")
    assert rep["divergence"] is None and rep["verified_ticks"] == rep["ticks"] == 4
    if transport == "inproc":
        assert rep["quality"]["ticks"] == 4
        assert (engine == "jax:4") == (rep["engine"] == "jax" and rep["threads"] == 4)
    else:
        assert rep["wire_bytes_out"] > 0 and rep["wire_bytes_in"] > 0
    assert set(rep["warm_percentiles"]) >= {"count", "p50_ms", "p99_ms"}


def test_a_trace_the_port_records_replays_through_the_port(ref_recorded, workdir):
    rec = str(workdir / "port_rec.trace")
    first = t_replay.replay(ref_recorded, engine="torch:1", verify=False, record_path=rec,
                            device="cpu")
    again = t_replay.replay(rec, device="cpu")
    assert again["engine"] == "torch" and again["divergence"] is None
    assert again["verified_ticks"] == 4 and again["assigned"] == first["assigned"]
    meta = t_fmt.read_trace(rec).meta
    assert meta["recorded_engine"] == "torch" and meta["source_trace"] == ref_recorded


def test_compare_reports_identical_transports(ref_recorded):
    out = t_replay.compare(ref_recorded, {"engine": "jax:1", "transport": "inproc"},
                           {"engine": "jax:1", "transport": "wire-v2"}, max_ticks=3,
                           device="cpu")
    assert out["identical"] and out["first_divergent_tick"] is None
    assert out["divergent_rows_total"] == 0 and out["a"]["ticks"] == out["b"]["ticks"] == 3


def test_replay_refuses_what_the_port_does_not_serve(ref_recorded):
    with pytest.raises(RuntimeError, match="M5"):
        t_replay.replay(ref_recorded, engine="native-mt:2", device="cpu")
    with pytest.raises(ValueError, match="engine must be one of"):
        t_replay.replay(ref_recorded, engine="auction", device="cpu")
    with pytest.raises(ValueError, match="transport"):
        t_replay.replay(ref_recorded, transport="wire-v3", device="cpu")


# ---------------- the committed golden ----------------


def test_the_golden_replays_within_the_jax_ab_bounds(golden_replay, capsys):
    rep = golden_replay
    trace = t_fmt.read_trace(GOLDEN)
    assert rep["ticks"] == 9 and rep["providers"] == rep["tasks"] == 512
    rows = []
    for tick, p4t in enumerate(rep["p4ts"]):
        rec = trace.outcome_for(tick).provider_for_task
        rows.append(np.flatnonzero(p4t != rec).tolist())
        seated = p4t[p4t >= 0]
        assert np.unique(seated).size == seated.size
    with capsys.disabled():
        print(f"\ngolden divergent rows a tick against the recorded outcomes: "
              f"{[len(r) for r in rows]} (tick 0: {rows[0]})")
    assert tuple(len(r) for r in rows) == GOLDEN_DIVERGENT_ROWS
    recorded = aggregate_quality([
        {k: v for k, v in o.metrics.items() if isinstance(v, (int, float, bool))}
        for o in trace.outcomes
    ])
    q = rep["quality"]
    assert q["ticks"] == recorded["ticks"] == 9
    assert abs(q["gap_per_task_mean"] - recorded["gap_per_task_mean"]) <= (
        FLOOR["jax_ab_gap_per_task_delta_max"])
    assert q["plan_cost_mean"] / recorded["plan_cost_mean"] <= FLOOR["jax_ab_plan_cost_ratio_max"]
    assert abs(q["churn_ratio_mean"] - recorded["churn_ratio_mean"]) <= (
        FLOOR["jax_ab_churn_ratio_delta_max"])
    rec_min = min(o.num_assigned for o in trace.outcomes)
    assert (rec_min - min(rep["assigned"])) / 512 <= FLOOR["jax_ab_assigned_min_frac_delta_max"]


# ---------------- the CLI ----------------


def test_cli_info_and_replay(ref_recorded, workdir, capsys):
    assert cli_main(["info", GOLDEN]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["ticks"] == 9 and info["kernel"] == "jax" and info["providers"] == 512
    assert cli_main(["replay", ref_recorded, "--device", "cpu", "--max-ticks", "2"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["divergence"] is None and rep["verified_ticks"] == 2
    # the golden's first tick differs from the recorded one by the
    # haversine's ulps: a divergence report and a non-zero exit
    assert cli_main(["replay", GOLDEN, "--device", "cpu", "--max-ticks", "1"]) == 1
    captured = capsys.readouterr()
    assert json.loads(captured.out)["divergence"]["tick"] == 0
    assert "DIVERGENCE at tick 0" in captured.err
    out = str(workdir / "cli_synth.trace")
    assert cli_main(["synth", out, "--providers", "32", "--tasks", "16", "--ticks", "2"]) == 0
    assert json.loads(capsys.readouterr().out)["ticks"] == 3
