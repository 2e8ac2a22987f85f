"""Synthetic marketplace generators (``protocol_tpu/trace/synth.py:24-96``,
copied): numpy-only and seeded, so the same (seed, n) gives the same
population as the reference's generators, draw for draw.

``synth_provider_arrays`` / ``synth_requirement_arrays`` return numpy
dicts with the reference's dtypes; ``synth_providers`` /
``synth_requirements`` return the port's dataclasses on a device.
:func:`synth_trace` freezes a parameterized workload into a trace file
(``protocol_tpu/trace/synth.py:129``): the same arguments write the same
bytes as the reference's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from protocol_tpu_torch.ops.encoding import (
    EncodedProviders,
    EncodedRequirements,
    providers_from_numpy,
    requirements_from_numpy,
)

MODEL_CLASSES = 12
MODEL_WORDS = 8
MAX_GPU_OPTS = 2


def synth_provider_arrays(rng: np.random.Generator, n: int) -> dict[str, np.ndarray]:
    model = rng.integers(0, MODEL_CLASSES, n).astype(np.int32)
    count = rng.choice([1, 2, 4, 8], n).astype(np.int32)
    mem = rng.choice([16000, 24000, 40000, 80000], n).astype(np.int32)
    return dict(
        gpu_count=count,
        gpu_mem_mb=mem,
        gpu_model_id=model,
        has_gpu=np.ones(n, bool),
        has_cpu=np.ones(n, bool),
        cpu_cores=rng.choice([8, 16, 32, 64], n).astype(np.int32),
        ram_mb=rng.choice([32768, 65536, 131072], n).astype(np.int32),
        storage_gb=rng.choice([500, 1000, 4000], n).astype(np.int32),
        lat=np.radians(rng.uniform(-60, 60, n)).astype(np.float32),
        lon=np.radians(rng.uniform(-180, 180, n)).astype(np.float32),
        has_location=np.ones(n, bool),
        price=rng.uniform(0.5, 4.0, n).astype(np.float32),
        load=rng.uniform(0, 1, n).astype(np.float32),
        valid=np.ones(n, bool),
    )


def synth_requirement_arrays(rng: np.random.Generator, n: int) -> dict[str, np.ndarray]:
    k, w = MAX_GPU_OPTS, MODEL_WORDS
    # each task accepts a random subset of model classes (OR alternatives)
    mask = np.zeros((n, k, w), np.uint32)
    accept = rng.random((n, MODEL_CLASSES)) < 0.4
    accept[np.arange(n), rng.integers(0, MODEL_CLASSES, n)] = True  # >=1 class
    for c in range(MODEL_CLASSES):
        mask[:, 0, c >> 5] |= np.where(
            accept[:, c], np.uint32(1) << np.uint32(c & 31), 0
        ).astype(np.uint32)
    opt_valid = np.zeros((n, k), bool)
    opt_valid[:, 0] = True
    count = np.full((n, k), -1, np.int32)
    count[:, 0] = rng.choice(
        [-1, 1, 2, 4, 8], n, p=[0.4, 0.15, 0.15, 0.15, 0.15]
    )
    mem_min = np.full((n, k), -1, np.int32)
    mem_min[:, 0] = rng.choice([-1, 16000, 40000], n, p=[0.5, 0.3, 0.2])
    return dict(
        cpu_required=np.zeros(n, bool),
        cpu_cores=rng.choice([-1, 8, 16], n, p=[0.5, 0.3, 0.2]).astype(
            np.int32
        ),
        ram_mb=rng.choice([-1, 32768], n, p=[0.6, 0.4]).astype(np.int32),
        storage_gb=rng.choice([-1, 500], n, p=[0.7, 0.3]).astype(np.int32),
        gpu_opt_valid=opt_valid,
        gpu_count=count,
        gpu_mem_min=mem_min,
        gpu_mem_max=np.full((n, k), -1, np.int32),
        gpu_total_mem_min=np.full((n, k), -1, np.int32),
        gpu_total_mem_max=np.full((n, k), -1, np.int32),
        gpu_model_mask=mask,
        gpu_model_constrained=opt_valid.copy(),
        lat=np.radians(rng.uniform(-60, 60, n)).astype(np.float32),
        lon=np.radians(rng.uniform(-180, 180, n)).astype(np.float32),
        has_location=np.ones(n, bool),
        priority=np.zeros(n, np.float32),
        valid=np.ones(n, bool),
    )


def synth_providers(rng: np.random.Generator, n: int, device="cuda") -> EncodedProviders:
    return providers_from_numpy(synth_provider_arrays(rng, n), device)


def synth_requirements(rng: np.random.Generator, n: int, device="cuda") -> EncodedRequirements:
    return requirements_from_numpy(synth_requirement_arrays(rng, n), device)


# ---------------- trace factory ----------------


class _W:
    """Weights namespace for ``wire.epoch_fingerprint``."""

    def __init__(self, w: tuple):
        self.price, self.load, self.proximity, self.priority = (float(x) for x in w)


# CostWeights defaults (ops/cost.py) restated
DEFAULT_WEIGHTS = (1.0, 1.0, 0.001, 0.0)


def _canon(cols: dict, spec: dict) -> dict[str, np.ndarray]:
    return {name: np.ascontiguousarray(cols[name], dt) for name, dt in spec.items()}


def synth_trace(
    path: str,
    n_providers: int = 1024,
    n_tasks: int = 1024,
    ticks: int = 16,
    churn: float = 0.01,
    task_churn: float = 0.0,
    seed: int = 0,
    kernel: str = "native-mt",
    top_k: int = 64,
    eps: float = 0.02,
    max_iters: int = 0,
    weights: tuple = DEFAULT_WEIGHTS,
    headroom: float = 0.0,
    growth: float = 0.0,
    hotspot_every: int = 0,
    hotspot_frac: float = 0.05,
    disconnect_at: int = 0,
    disconnect_frac: float = 0.25,
    reconnect_after: int = 0,
    compresslevel: int = 6,
) -> str:
    """Write an input-only trace (no outcomes: a replay with
    ``record_path`` adds them) of a parameterized synthetic workload, draw
    for draw the reference's.

    Knobs:
      churn           fraction of live provider rows whose price and load
                      drift each tick
      task_churn      fraction of task rows re-rolled each tick
      headroom        fraction of provider rows that start valid=False
                      (the pool that growth draws from)
      growth          fraction of the remaining headroom activated per
                      tick; negative, a steady shrink
      hotspot_every   every N ticks, max out the load of the
                      hotspot_frac providers nearest a random center
      disconnect_at   at tick N, disconnect disconnect_frac of the live
                      providers; reconnect_after ticks later they return
                      with new prices

    Returns ``path``.
    """
    from protocol_tpu_torch.proto import scheduler_pb2 as pb
    from protocol_tpu_torch.proto import wire
    from protocol_tpu_torch.trace import format as tfmt

    rng = np.random.default_rng(seed)
    p_cols = _canon(synth_provider_arrays(rng, n_providers), tfmt.P_TRACE_DTYPES)
    r_cols = _canon(synth_requirement_arrays(rng, n_tasks), tfmt.R_TRACE_DTYPES)
    if headroom > 0:
        n_off = int(n_providers * headroom)
        if n_off:
            valid = p_cols["valid"].copy()
            valid[rng.choice(n_providers, n_off, replace=False)] = False
            p_cols["valid"] = valid

    wns = _W(weights)
    fp = wire.epoch_fingerprint(p_cols, r_cols, wns, kernel, top_k, eps, max_iters)
    req = pb.AssignRequestV2(
        providers=wire.encode_providers_v2(tfmt._as_ns(p_cols)),
        requirements=wire.encode_requirements_v2(tfmt._as_ns(r_cols)),
        weights=pb.CostWeights(price=wns.price, load=wns.load, proximity=wns.proximity,
                               priority=wns.priority),
        kernel=kernel, top_k=top_k, eps=eps, max_iters=max_iters,
    )
    meta = {
        "generator": "synth_trace",
        "seed": seed,
        "n_providers": n_providers,
        "n_tasks": n_tasks,
        "ticks": ticks,
        "churn": churn,
        "task_churn": task_churn,
        "headroom": headroom,
        "growth": growth,
        "hotspot_every": hotspot_every,
        "disconnect_at": disconnect_at,
    }
    disconnected: Optional[np.ndarray] = None
    with tfmt.TraceWriter(path, meta=meta, compresslevel=compresslevel) as w:
        w.write_snapshot(f"synth-{seed}", fp, req)
        for tick in range(1, ticks + 1):
            prev_p = dict(p_cols)
            prev_r = dict(r_cols)
            events: list = []

            # price and load drift on a random slice of the live fleet
            live = np.flatnonzero(p_cols["valid"])
            n_drift = int(live.size * churn)
            if n_drift:
                rows = rng.choice(live, n_drift, replace=False)
                price = p_cols["price"].copy()
                load = p_cols["load"].copy()
                price[rows] = rng.uniform(0.5, 4.0, rows.size).astype(np.float32)
                load[rows] = rng.uniform(0, 1, rows.size).astype(np.float32)
                p_cols["price"], p_cols["load"] = price, load
                events.append({"kind": "heartbeat_drift", "rows": n_drift})

            # requirement churn: re-roll a slice of tasks entirely
            n_tchurn = int(n_tasks * task_churn)
            if n_tchurn:
                rows = rng.choice(n_tasks, n_tchurn, replace=False)
                fresh = _canon(synth_requirement_arrays(rng, n_tchurn), tfmt.R_TRACE_DTYPES)
                for name in r_cols:
                    col = r_cols[name].copy()
                    col[rows] = fresh[name]
                    r_cols[name] = col
                events.append({"kind": "task_churn", "rows": n_tchurn})

            # pool growth or shrink through the validity headroom
            if growth > 0:
                off = np.flatnonzero(~p_cols["valid"])
                n_join = int(off.size * growth)
                if n_join:
                    rows = rng.choice(off, n_join, replace=False)
                    valid = p_cols["valid"].copy()
                    valid[rows] = True
                    p_cols["valid"] = valid
                    events.append({"kind": "node_join", "rows": n_join})
            elif growth < 0:
                on = np.flatnonzero(p_cols["valid"])
                n_leave = int(on.size * -growth)
                if n_leave:
                    rows = rng.choice(on, n_leave, replace=False)
                    valid = p_cols["valid"].copy()
                    valid[rows] = False
                    p_cols["valid"] = valid
                    events.append({"kind": "node_leave", "rows": n_leave})

            # hotspot burst: max out the load around a random center
            if hotspot_every and tick % hotspot_every == 0:
                lat0 = rng.uniform(-1.0, 1.0)
                lon0 = rng.uniform(-np.pi, np.pi)
                d2 = (p_cols["lat"] - lat0) ** 2 + (p_cols["lon"] - lon0) ** 2
                n_hot = max(int(n_providers * hotspot_frac), 1)
                rows = np.argsort(d2, kind="stable")[:n_hot]
                load = p_cols["load"].copy()
                load[rows] = np.float32(1.0)
                p_cols["load"] = load
                events.append({"kind": "hotspot_burst", "rows": n_hot})

            # mass disconnect, and the delayed reconnect
            if disconnect_at and tick == disconnect_at:
                on = np.flatnonzero(p_cols["valid"])
                n_down = int(on.size * disconnect_frac)
                if n_down:
                    disconnected = rng.choice(on, n_down, replace=False)
                    valid = p_cols["valid"].copy()
                    valid[disconnected] = False
                    p_cols["valid"] = valid
                    events.append({"kind": "mass_disconnect", "rows": n_down})
            if (disconnected is not None and reconnect_after
                    and tick == disconnect_at + reconnect_after):
                valid = p_cols["valid"].copy()
                valid[disconnected] = True
                p_cols["valid"] = valid
                price = p_cols["price"].copy()
                price[disconnected] = rng.uniform(0.5, 4.0, disconnected.size).astype(np.float32)
                p_cols["price"] = price
                events.append({"kind": "mass_reconnect", "rows": int(disconnected.size)})
                disconnected = None

            prow = wire.dirty_rows(p_cols, prev_p)
            trow = wire.dirty_rows(r_cols, prev_r)
            w.write_delta_cols(
                tick,
                prow,
                {n: a[prow] for n, a in p_cols.items()} if prow.size else None,
                trow,
                {n: a[trow] for n, a in r_cols.items()} if trow.size else None,
                events=events,
            )
    return path
