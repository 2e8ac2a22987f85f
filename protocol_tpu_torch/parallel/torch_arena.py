"""Solve arena of the port (``protocol_tpu/parallel/jax_arena.py``).

The arena keeps the reference's duck-typed surface (solve / apply_rows /
reconcile / export_state / restore_state / invalidate, ``.price`` /
``.retired`` / ``.last_stats``).

``devices`` is the reference's D: generation and the warm repair's enter
scan shard the tasks over a 1xD provider mesh
(:mod:`~protocol_tpu_torch.parallel.mesh`) of the visible devices of the
arena's device type (0 = all of them). Sharded generation is bit-identical
to one device's, so the structure, the warm carry and every solve are the
same at every D; the auctions run on the mesh's first device, as the
reference's do. Asking for more devices than are visible clamps to what
exists, flagged (``device_degraded``) and counted
(``device_degraded_events``), never a change of engine; a shape whose
per-shard task count is not a whole number of tiles generates at one
device, with the same tile, and says so (``gen_sharded``).

A cold tick (first solve, a shape or weights change, ``cold_every``, or
churn above ``max_dirty_frac``) runs

  1. candidate generation: the fused candidate pass
     (:func:`~protocol_tpu_torch.ops.sparse.candidates_topk_reverse`, kernel
     K1 on a card) with its generation parts (forward lists and per-tile
     reverse pools), then the reverse-edge merge;
  2. the eps-annealed frontier auction ladder
     (:func:`~protocol_tpu_torch.ops.sparse.assign_auction_sparse_scaled`,
     kernel K2 on a card), from scratch duals.

A warm tick finds the dirty rows, repairs the persisted parts for them
(:func:`~protocol_tpu_torch.parallel.sparse.repair_topk_bidir`, kernels
K1 rows/blocks, K3, K4, K5 on a card: bit-identical to a cold pass on the
current columns), and runs the delta-frontier auction from the carried
duals (:func:`~protocol_tpu_torch.ops.sparse.assign_auction_sparse_warm`,
K2), or the ladder every ``dual_refresh_every`` warm ticks. A
byte-identical marketplace short-circuits to the carried matching.
``apply_rows`` is the single-event entry of the same warm path.

The parts and the merged lists live on the arena's device between ticks
(no re-upload per tick); host copies, the reference's export contract,
are refreshed after each change. ``approx_recall`` is refused.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from protocol_tpu_torch import obs
from protocol_tpu_torch.device import resolve_device
from protocol_tpu_torch.native.arena import _P_SPEC, _R_SPEC, _canon, _dirty_rows
from protocol_tpu_torch.obs import quality as _quality
from protocol_tpu_torch.ops.cost import CostWeights
from protocol_tpu_torch.ops.encoding import providers_from_numpy, requirements_from_numpy
from protocol_tpu_torch.ops.sparse import (
    assign_auction_sparse_scaled,
    assign_auction_sparse_warm,
    candidates_topk_reverse,
    merge_reverse_candidates,
    pick_tile,
)
from protocol_tpu_torch.parallel.mesh import make_mesh
from protocol_tpu_torch.parallel.sparse import candidates_topk_bidir_sharded, repair_topk_bidir
from protocol_tpu_torch.utils.platform import visible_devices

# persisted candidate-structure dtypes: the reference's on-disk contract
# (``_JAX_STATE_DTYPES``), so checkpoints carry the same arrays
_TORCH_STATE_DTYPES = {
    "cand_p": np.int32,
    "cand_c": np.float32,
    "fwd_p": np.int32,
    "fwd_c": np.float32,
    "pool_t": np.int32,
    "pool_c": np.float32,
}

def torch_isa(device: torch.device) -> str:
    """Float-pipeline provenance tag: ``torch:<device type>``. A restore
    under another tag (another device type, or the reference's
    ``jax:*``) invalidates instead of continuing on costs another float
    pipeline produced."""
    return f"torch:{device.type}"


class TorchSolveArena:
    def __init__(
        self,
        k: int = 64,
        reverse_r: int = 8,
        extra: int = 16,
        cold_every: int = 256,
        max_dirty_frac: float = 0.25,
        eps_start: float = 4.0,
        eps_end: float = 0.02,
        dual_refresh_every: int = 16,
        devices: int = 0,
        approx_recall: Optional[float] = None,
        device: str | torch.device = "cuda",
    ):
        if approx_recall is not None:
            raise NotImplementedError(
                "approx_recall: lax.approx_max_k (the TPU's PartialReduce) has "
                "no Hopper counterpart in the port yet; the port selects exactly"
            )
        self.device = resolve_device(device)
        self.k = k
        self.reverse_r = reverse_r
        self.extra = extra
        self.cold_every = cold_every
        self.max_dirty_frac = max_dirty_frac
        self.eps_start = eps_start
        self.eps_end = eps_end
        self.dual_refresh_every = dual_refresh_every
        # the requested mesh size, resolved against the visible devices at
        # the first solve: 0 = all of them
        self.devices = int(devices)
        self.device_degraded = False
        self.device_degraded_events = 0
        self._mesh = None
        self._devices_effective: Optional[int] = None
        self.engine = "torch"
        self.last_stats: dict = {}
        self.invalidate()

    # ---------------- carried-state surface ----------------

    @property
    def price(self) -> Optional[np.ndarray]:
        """Carried auction prices [P] after the last solve (dual state)."""
        return self._price

    @property
    def retired(self) -> Optional[np.ndarray]:
        """Carried retirement mask [T] after the last solve."""
        return self._retired

    def invalidate(self) -> None:
        """Drop all carried state: the next solve is cold."""
        self._p_fields: Optional[dict] = None
        self._r_fields: Optional[dict] = None
        self._weights_key: Optional[tuple] = None
        self._cand_p: Optional[np.ndarray] = None
        self._cand_c: Optional[np.ndarray] = None
        self._fwd_p: Optional[np.ndarray] = None
        self._fwd_c: Optional[np.ndarray] = None
        self._pool_t: Optional[np.ndarray] = None
        self._pool_c: Optional[np.ndarray] = None
        self._price: Optional[np.ndarray] = None
        self._retired: Optional[np.ndarray] = None
        self._p4t: Optional[np.ndarray] = None
        self._warm_solves = 0
        self._dual_age = 0
        self._starve_age: Optional[np.ndarray] = None
        self._last_quality: dict = {}
        self.last_repair_mask: Optional[np.ndarray] = None
        self._owned_cols: set = set()
        # device copies of the six parts, keyed as _TORCH_STATE_DTYPES
        # (None until a tick or a repair needs them after a restore)
        self._dev: Optional[dict] = None

    # ---------------- export / restore ----------------

    def export_state(self) -> Optional[dict]:
        """The carried state as a flat dict of scalars and array copies,
        with the reference arena's keys and dtypes. None before any
        solve."""
        if self._cand_p is None:
            return None

        def _c(a):
            return None if a is None else np.array(a, copy=True)

        out = {
            "cand_p": _c(self._cand_p),
            "cand_c": _c(self._cand_c),
            "fwd_p": _c(self._fwd_p),
            "fwd_c": _c(self._fwd_c),
            "pool_t": _c(self._pool_t),
            "pool_c": _c(self._pool_c),
            "reverse_r": int(self.reverse_r),
            "price": _c(self._price),
            "retired": _c(self._retired),
            "p4t": _c(self._p4t),
            "starve_age": _c(self._starve_age),
            "warm_solves": int(self._warm_solves),
            "dual_age": int(self._dual_age),
            "weights_key": tuple(self._weights_key),
            "native_isa": torch_isa(self.device),
        }
        for name, _ in _P_SPEC:
            out[f"pf_{name}"] = _c(self._p_fields[name])
        for name, _ in _R_SPEC:
            out[f"rf_{name}"] = _c(self._r_fields[name])
        return out

    def restore_state(self, ep, er, state: dict) -> None:
        """Rehydrate from :meth:`export_state` output. A carry this arena
        cannot honour (another provenance tag, or candidate or part
        shapes that do not fit this configuration) invalidates: the next
        solve is an honest cold re-ground, never a hard error."""
        self.invalidate()
        if "pf_gpu_count" in state:
            self._p_fields = {
                name: np.array(state[f"pf_{name}"], copy=True) for name, _ in _P_SPEC
            }
            self._r_fields = {
                name: np.array(state[f"rf_{name}"], copy=True) for name, _ in _R_SPEC
            }
        else:
            self._p_fields = _canon(ep, _P_SPEC)
            self._r_fields = _canon(er, _R_SPEC)
        cand_p = np.asarray(state["cand_p"])
        n_p = self._p_fields["gpu_count"].shape[0]
        n_t = self._r_fields["cpu_cores"].shape[0]
        k_eff = min(self.k, n_p)
        r_eff = min(self.reverse_r, n_t)
        n_tiles = n_t // self._tile(n_t)
        rt_eff = max(1, -(-r_eff // n_tiles))
        fwd_p = state.get("fwd_p")
        if (
            state.get("native_isa") != torch_isa(self.device)
            or cand_p.ndim != 2
            or cand_p.shape != (n_t, k_eff + self.extra)
            or fwd_p is None
            or np.asarray(fwd_p).shape != (n_t, k_eff)
            or state.get("pool_t") is None
            or np.asarray(state["pool_t"]).shape != (n_p, n_tiles * rt_eff)
            or state.get("reverse_r") != self.reverse_r
        ):
            self.invalidate()
            return
        for name in _TORCH_STATE_DTYPES:
            setattr(
                self, f"_{name}",
                np.array(state[name], _TORCH_STATE_DTYPES[name], copy=True),
            )
        for name in ("price", "retired", "p4t", "starve_age"):
            v = state.get(name)
            setattr(self, f"_{name}", None if v is None else np.array(v, copy=True))
        self._warm_solves = int(state["warm_solves"])
        self._dual_age = int(state["dual_age"])
        self._weights_key = tuple(state["weights_key"])

    # ---------------- internals ----------------

    @staticmethod
    def _wkey(weights) -> tuple:
        return (
            float(weights.price), float(weights.load),
            float(weights.proximity), float(weights.priority),
        )

    def _shapes_compatible(self, pf: dict, rf: dict) -> bool:
        old_p, old_r = self._p_fields, self._r_fields
        if old_p is None or old_r is None:
            return False
        return all(pf[n].shape == old_p[n].shape for n, _ in _P_SPEC) and all(
            rf[n].shape == old_r[n].shape for n, _ in _R_SPEC
        )

    @staticmethod
    def _tile(T: int) -> int:
        """The arena's tile law (a function of T only), shared by the cold
        pass and the repair so a repair never runs under another tiling."""
        return pick_tile(T, cap=min(1024, max(1, T // 8)))

    def _ensure_devices(self) -> int:
        """The mesh size, resolved once against the visible devices of the
        arena's type. Over-asking clamps to what exists, counted and
        flagged, never fatal."""
        if self._devices_effective is None:
            avail = len(visible_devices(self.device.type))
            want = avail if self.devices <= 0 else self.devices
            if want > avail:
                self.device_degraded = True
                self.device_degraded_events += 1
                want = max(avail, 1)
            self._devices_effective = want
            if want > 1:
                self._mesh = make_mesh(want, self.device)
        return self._devices_effective

    def _gen_plan(self, T: int) -> tuple[int, bool]:
        """(tile, use_mesh) for T tasks: one decision shared by generation
        and the repair, so a repair never runs under another tiling or
        mesh than the pass that made its parts."""
        tile = self._tile(T)
        D = self._ensure_devices()
        use_mesh = self._mesh is not None and T % D == 0 and (T // D) % tile == 0
        return tile, use_mesh

    def _columns(self, pf: dict, rf: dict):
        return providers_from_numpy(pf, self.device), requirements_from_numpy(rf, self.device)

    def _set_parts(self, parts: dict) -> None:
        """Keep the parts (device tensors) and bring their host copies up to
        date. On a card only the entries that differ from the previous
        parts come back (a repair changes a few percent of them); the host
        copies then hold the same bits as a whole copy would."""
        old, self._dev = self._dev, parts
        for name, t in parts.items():
            host = getattr(self, f"_{name}")
            if self.device.type == "cpu" or old is None or host is None or host.shape != t.shape:
                setattr(self, f"_{name}", t.cpu().numpy())
                continue
            new_flat, old_flat = t.reshape(-1), old[name].reshape(-1)
            if new_flat.dtype == torch.float32:  # compare bits, not values
                diff = new_flat.view(torch.int32) != old_flat.view(torch.int32)
            else:
                diff = new_flat != old_flat
            idx = torch.nonzero(diff).flatten()
            if idx.numel():
                host.reshape(-1)[idx.cpu().numpy()] = new_flat[idx].cpu().numpy()

    def _dev_parts(self) -> dict:
        """The parts on the arena's device (uploaded once after a restore)."""
        if self._dev is None:
            self._dev = {
                name: torch.from_numpy(getattr(self, f"_{name}")).to(self.device)
                for name in _TORCH_STATE_DTYPES
            }
        return self._dev

    def _gen(self, pf: dict, rf: dict, weights) -> bool:
        """One candidate-generation pass, sharded over the mesh when the plan
        says so: stores the generation parts (forward lists, per-tile
        reverse pools) and the merged lists. Returns whether it sharded."""
        ep, er = self._columns(pf, rf)
        T = rf["cpu_cores"].shape[0]
        tile, use_mesh = self._gen_plan(T)
        if use_mesh:
            cand_p, cand_c, fwd_p, fwd_c, pool_t, pool_c = candidates_topk_bidir_sharded(
                ep, er, weights, mesh=self._mesh, k=self.k, tile=tile,
                reverse_r=self.reverse_r, extra=self.extra, with_parts=True,
            )
        else:
            fwd_p, fwd_c, rev_t, rev_c, pool_t, pool_c = candidates_topk_reverse(
                ep, er, weights, k=self.k, tile=tile,
                reverse_r=self.reverse_r, with_pools=True,
            )
            cand_p, cand_c = merge_reverse_candidates(
                fwd_p, fwd_c, rev_t, rev_c, extra=self.extra
            )
        self._set_parts(dict(
            cand_p=cand_p, cand_c=cand_c, fwd_p=fwd_p, fwd_c=fwd_c,
            pool_t=pool_t, pool_c=pool_c,
        ))
        return use_mesh

    def _repair(self, pf: dict, rf: dict, weights, dirty_p, dirty_t):
        """Churn-masked repair of the parts for the dirty global rows and
        the re-merge: bit-identical to :meth:`_gen` on the current columns.
        Returns (changed-row mask [T] against the previous merged lists,
        repair-scope stats)."""
        ep, er = self._columns(pf, rf)
        T = rf["cpu_cores"].shape[0]
        tile, use_mesh = self._gen_plan(T)
        d = self._dev_parts()
        cand_p, cand_c, fwd_p, fwd_c, pool_t, pool_c, stats = repair_topk_bidir(
            ep, er, weights,
            fwd_p=d["fwd_p"], fwd_c=d["fwd_c"], pool_t=d["pool_t"], pool_c=d["pool_c"],
            dirty_p=dirty_p, dirty_t=dirty_t, reverse_r=self.reverse_r,
            mesh=self._mesh if use_mesh else None, tile=tile, extra=self.extra,
        )
        changed = (
            (cand_p != d["cand_p"]).any(dim=1) | (cand_c != d["cand_c"]).any(dim=1)
        ).cpu().numpy()
        self._set_parts(dict(
            cand_p=cand_p, cand_c=cand_c, fwd_p=fwd_p, fwd_c=fwd_c,
            pool_t=pool_t, pool_c=pool_c,
        ))
        return changed, stats

    @staticmethod
    def _host_state(res, price, retired):
        # owned host copies: the carried state must stay writable
        return (
            res.provider_for_task.cpu().numpy().astype(np.int32),
            price.cpu().numpy().astype(np.float32),
            retired.cpu().numpy().astype(bool),
        )

    def _ladder(self, P: int, eng: Optional[dict]):
        """Cold/refresh solve stage: the eps-annealed auction ladder from
        scratch duals over the current candidate structure."""
        d = self._dev_parts()
        res, price, retired = assign_auction_sparse_scaled(
            d["cand_p"], d["cand_c"], num_providers=P, eps_start=self.eps_start,
            eps_end=self.eps_end, stats_out=eng, with_state=True,
        )
        return self._host_state(res, price, retired)

    def _warm(self, P: int, p4t0: np.ndarray, changed: np.ndarray, eng: Optional[dict]):
        """Warm solve stage: the delta-frontier auction from the carried
        duals, with retirement cleared for exactly the ``changed`` rows."""
        d = self._dev_parts()

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        res, price, retired = assign_auction_sparse_warm(
            d["cand_p"], d["cand_c"], num_providers=P,
            price0=up(self._price), p4t0=up(p4t0), eps=self.eps_end,
            retired0=up(self._retired & ~changed), stats_out=eng, with_state=True,
        )
        return self._host_state(res, price, retired)

    def _quality_pass(self, rf: dict, p4t, price, prev_p4t, eng: Optional[dict] = None) -> dict:
        t0 = time.perf_counter()
        stats, self._starve_age = _quality.tick_quality(
            self._cand_p, self._cand_c, p4t, price,
            valid=rf["valid"].astype(bool),
            prev_p4t=prev_p4t,
            starve_age=self._starve_age,
            outcomes=None,
            eng=eng,
        )
        stats["quality_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        self._last_quality = stats
        return stats

    def _base_stats(self, T: int, gen_sharded: bool) -> dict:
        return {
            "native_isa": torch_isa(self.device),
            "engine": self.engine,
            "torch_devices": int(self._devices_effective or 1),
            "gen_sharded": gen_sharded,
            "device_degraded": self.device_degraded,
            "rows": T,
        }

    def _cold(self, weights, pf, rf, P, T) -> np.ndarray:
        eng: Optional[dict] = {} if obs.enabled() else None
        t0 = time.perf_counter()
        sharded = self._gen(pf, rf, weights)
        t_gen = time.perf_counter()
        p4t, price, retired = self._ladder(P, eng)
        t_solve = time.perf_counter()
        self._p_fields, self._r_fields = pf, rf
        self._owned_cols = set()
        self._weights_key = self._wkey(weights)
        self._price, self._retired, self._p4t = price, retired, p4t
        self._warm_solves = 0
        self._dual_age = 0
        self._starve_age = None
        qual = self._quality_pass(rf, p4t, price, None, eng) if obs.enabled() else {}
        self.last_stats = {
            **self._base_stats(T, sharded),
            **qual,
            "cold": True,
            "cand_cold_passes": 1,
            "dirty_providers": P,
            "dirty_tasks": T,
            "changed_rows": T,
            "warm_solves_since_cold": 0,
            "assigned": int((p4t >= 0).sum()),
            "gen_ms": round((t_gen - t0) * 1e3, 3),
            "solve_ms": round((t_solve - t_gen) * 1e3, 3),
            **({f"eng_{k}": v for k, v in eng.items()} if eng else {}),
        }
        return p4t.copy()  # the carried p4t changes in place at the next tick

    def _unseat_lost(self, changed: np.ndarray) -> None:
        """Seat guard: a seat whose provider left its row's candidate list
        is unseated (only changed rows can have lost one)."""
        seat_check = np.flatnonzero(changed & (self._p4t >= 0))
        if seat_check.size:
            in_list = (self._cand_p[seat_check] == self._p4t[seat_check, None]).any(axis=1)
            lost = seat_check[~in_list]
            if lost.size:
                self._p4t[lost] = -1

    # ---------------- streaming entry points ----------------

    def apply_rows(
        self,
        provider_rows: Optional[np.ndarray],
        p_rows: Optional[dict],
        task_rows: Optional[np.ndarray],
        r_rows: Optional[dict],
        weights,
        event_eps_start: Optional[float] = None,
    ) -> np.ndarray:
        """Single-event entry (the stream engine's hot path): explicit
        churned rows; values equal to the current columns are dropped; the
        arena's columns are updated in place (copy-on-write) for the truly
        dirty rows, the parts repaired for them and the warm auction run.
        RuntimeError on an unprimed arena, ValueError on a weights mismatch
        or a bad event. ``event_eps_start`` is accepted for signature
        parity (the warm auction runs one fine-eps phase)."""
        if self._cand_p is None:
            raise RuntimeError(
                "arena not primed for apply_rows: run solve() first "
                "(the persistent candidate structure must exist)"
            )
        if self._weights_key != self._wkey(weights):
            raise ValueError(
                "apply_rows under different weights: the carried "
                "structure was scored under the old weights (re-prime "
                "with a batch solve)"
            )
        t_start = time.perf_counter()
        P = self._p_fields["gpu_count"].shape[0]
        T = self._r_fields["cpu_cores"].shape[0]

        def _narrow(rows, vals, fields, spec, n, side):
            if rows is None or vals is None:
                return np.zeros(0, np.int32)
            rows = np.asarray(rows, np.int64).ravel()
            if rows.size == 0:
                return np.zeros(0, np.int32)
            if rows.min() < 0 or rows.max() >= n:
                raise ValueError(f"event row index out of range [0, {n})")
            dirty = np.zeros(rows.size, bool)
            canon = {}
            for name, dtype in spec:
                v = np.ascontiguousarray(np.asarray(vals[name]), dtype)
                if v.shape[0] != rows.size:
                    raise ValueError(
                        f"event column {name!r} has {v.shape[0]} rows "
                        f"for {rows.size} row indices"
                    )
                canon[name] = v
                diff = fields[name][rows] != v
                dirty |= diff.reshape(rows.size, -1).any(axis=1)
            keep = np.flatnonzero(dirty)
            if keep.size:
                idx = rows[keep]
                for name, _ in spec:
                    key = (side, name)
                    if key not in self._owned_cols:
                        fields[name] = fields[name].copy()
                        self._owned_cols.add(key)
                    fields[name][idx] = canon[name][keep]
            return rows[keep].astype(np.int32)

        dirty_p = _narrow(provider_rows, p_rows, self._p_fields, _P_SPEC, P, "p")
        dirty_t = _narrow(task_rows, r_rows, self._r_fields, _R_SPEC, T, "r")
        n_dp, n_dt = int(dirty_p.size), int(dirty_t.size)
        if n_dp == 0 and n_dt == 0:
            self.last_repair_mask = None
            self.last_stats = {
                **self._base_stats(T, False),
                "cold": False, "event": True,
                "cand_cold_passes": 0, "dirty_providers": 0,
                "dirty_tasks": 0, "changed_rows": 0,
                "assigned": int((self._p4t >= 0).sum()),
            }
            return self._p4t.copy()

        eng: Optional[dict] = {} if obs.enabled() else None
        changed, rep = self._repair(self._p_fields, self._r_fields, weights, dirty_p, dirty_t)
        if n_dt:
            self._p4t[dirty_t] = -1
            changed[dirty_t] = True
        self._unseat_lost(changed)
        t_gen = time.perf_counter()
        p4t, price, retired = self._warm(P, self._p4t, changed, eng)
        t_solve = time.perf_counter()
        self._price, self._retired, self._p4t = price, retired, p4t
        self.last_repair_mask = changed
        self.last_stats = {
            **self._base_stats(T, self._gen_plan(T)[1]),
            "cold": False,
            "event": True,
            "cand_cold_passes": 0,
            # scope counters first: the stream-facing "repair_rows" (rows
            # whose merged lists changed) overrides the repair's
            # forward-scope counter of the same name, as in the reference
            **rep,
            "dirty_providers": n_dp,
            "dirty_tasks": n_dt,
            "changed_rows": int(changed.sum()),
            "repair_rows": int(changed.sum()),
            "assigned": int((p4t >= 0).sum()),
            "gen_ms": round((t_gen - t_start) * 1e3, 3),
            "solve_ms": round((t_solve - t_gen) * 1e3, 3),
            **({f"eng_{k}": v for k, v in eng.items()} if eng else {}),
        }
        return p4t.copy()  # the carried p4t changes in place at the next tick

    def reconcile(self) -> np.ndarray:
        """Full batch re-solve over the current candidate structure from
        scratch duals: bit-identical to a cold solve on the same columns
        (repaired == regen), without paying a generation pass."""
        if self._cand_p is None:
            raise RuntimeError("arena not primed for reconcile: run solve() first")
        t0 = time.perf_counter()
        P = self._p_fields["gpu_count"].shape[0]
        T = self._r_fields["cpu_cores"].shape[0]
        eng: Optional[dict] = {} if obs.enabled() else None
        prev_p4t = self._p4t.copy() if obs.enabled() and self._p4t is not None else None
        p4t, price, retired = self._ladder(P, eng)
        t_solve = time.perf_counter()
        self._price, self._retired, self._p4t = price, retired, p4t
        self._warm_solves = 0
        self._dual_age = 0
        self._starve_age = None
        qual = (
            self._quality_pass(self._r_fields, p4t, price, prev_p4t, eng)
            if obs.enabled() else {}
        )
        self.last_stats = {
            **self._base_stats(T, False),
            **qual,
            "cold": False,
            "reconcile": True,
            "cand_cold_passes": 0,
            "dirty_providers": 0,
            "dirty_tasks": 0,
            "changed_rows": 0,
            "assigned": int((p4t >= 0).sum()),
            "solve_ms": round((t_solve - t0) * 1e3, 3),
            **({f"eng_{k}": v for k, v in eng.items()} if eng else {}),
        }
        return p4t.copy()  # the carried p4t changes in place at the next tick

    # ---------------- the solve ----------------

    def solve(self, ep, er, weights: CostWeights) -> np.ndarray:
        """One marketplace solve. ``ep``/``er`` are encoded columns (the
        port's dataclasses, or any object with the same field names, numpy-
        or tensor-backed); returns provider_for_task [T] i32."""
        pf = _canon(ep, _P_SPEC)
        rf = _canon(er, _R_SPEC)
        P = pf["gpu_count"].shape[0]
        T = rf["cpu_cores"].shape[0]
        if P == 0 or T == 0:
            self.last_stats = {
                "native_isa": torch_isa(self.device), "engine": self.engine,
                "cold": True, "assigned": 0,
            }
            return np.full(T, -1, np.int32)

        if (
            not self._shapes_compatible(pf, rf)
            or self._weights_key != self._wkey(weights)
            or self._warm_solves >= self.cold_every
        ):
            return self._cold(weights, pf, rf, P, T)

        dirty_p = _dirty_rows(pf, self._p_fields, _P_SPEC)
        dirty_t = _dirty_rows(rf, self._r_fields, _R_SPEC)
        n_dp, n_dt = int(dirty_p.sum()), int(dirty_t.sum())
        if (n_dp + n_dt) / (P + T) > self.max_dirty_frac:
            return self._cold(weights, pf, rf, P, T)
        if n_dp == 0 and n_dt == 0:
            return self._short_circuit(rf, T)

        eng: Optional[dict] = {} if obs.enabled() else None
        prev_p4t = self._p4t.copy() if obs.enabled() else None
        t_start = time.perf_counter()
        self._p_fields, self._r_fields = pf, rf
        self._owned_cols = set()
        changed, rep = self._repair(
            pf, rf, weights, np.flatnonzero(dirty_p), np.flatnonzero(dirty_t)
        )
        if n_dt:
            # a dirty task's seat predates its new requirement: re-seat
            di = np.flatnonzero(dirty_t)
            self._p4t[di] = -1
            changed[di] = True
        self._unseat_lost(changed)
        t_gen = time.perf_counter()
        dual_refresh = (
            self.dual_refresh_every > 0 and self._dual_age >= self.dual_refresh_every
        )
        if dual_refresh:
            p4t, price, retired = self._ladder(P, eng)
            self._dual_age = 0
        else:
            p4t, price, retired = self._warm(P, self._p4t, changed, eng)
            self._dual_age += 1
        t_solve = time.perf_counter()
        self._price, self._retired, self._p4t = price, retired, p4t
        self._warm_solves += 1
        qual = self._quality_pass(rf, p4t, price, prev_p4t, eng) if obs.enabled() else {}
        self.last_stats = {
            **self._base_stats(T, self._gen_plan(T)[1]),
            **qual,
            "cold": False,
            "cand_cold_passes": 0,
            **rep,
            "dual_refresh": dual_refresh,
            "dirty_providers": n_dp,
            "dirty_tasks": n_dt,
            "changed_rows": int(changed.sum()),
            "warm_solves_since_cold": self._warm_solves,
            "assigned": int((p4t >= 0).sum()),
            "gen_ms": round((t_gen - t_start) * 1e3, 3),
            "solve_ms": round((t_solve - t_gen) * 1e3, 3),
            **({f"eng_{k}": v for k, v in eng.items()} if eng else {}),
        }
        return p4t.copy()  # the carried p4t changes in place at the next tick

    def _short_circuit(self, rf: dict, T: int) -> np.ndarray:
        """Byte-identical marketplace: the carried matching is the solve,
        with the carried quality certificate reused and the starvation
        ages advanced."""
        self._warm_solves += 1
        qual: dict = {}
        if obs.enabled():
            t_q = time.perf_counter()
            self._starve_age = _quality.starvation_update(
                self._starve_age, self._p4t, rf["valid"].astype(bool)
            )
            qual = dict(self._last_quality)
            qual["churn_rows"] = 0
            qual["churn_ratio"] = 0.0
            qual["starve_max"] = int(self._starve_age.max()) if self._starve_age.size else 0
            qual["starving"] = int((self._starve_age > 0).sum())
            qual["starve_hist"] = _quality.starvation_hist(self._starve_age)
            qual["quality_ms"] = round((time.perf_counter() - t_q) * 1e3, 3)
            self._last_quality = qual
        self.last_stats = {
            **self._base_stats(T, False),
            **qual,
            "cold": False,
            "cand_cold_passes": 0,
            "dirty_providers": 0,
            "dirty_tasks": 0,
            "changed_rows": 0,
            "warm_solves_since_cold": self._warm_solves,
            "assigned": int((self._p4t >= 0).sum()),
        }
        return self._p4t.copy()
