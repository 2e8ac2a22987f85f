"""Incremental candidate cache and candidate memo
(``protocol_tpu/sched/cand_cache.py``).

:class:`CandidateCache` is the delta-aware half of the matcher's warm
solve above ``dense_cell_budget``:

  - a row-stable provider registry: an address keeps its row until a
    compaction; a departed provider's row is masked invalid, a changed
    spec retires the row and takes a fresh one; the columns grow append
    only, so a prepare encodes O(churn) providers;
  - per-task candidate entries: each bounded task keeps its slots' top-k
    rows and the static part of their costs (the cost less the price and
    load terms and the priority, re-applied from current state at
    assembly); a new task gets fresh columns, new providers merge into
    the kept lists by a [delta-P x S] pass;
  - the auction's prices, kept per row across prepares;
  - a coverage repair: valid rows in no list get reverse edges in
    ``extra`` extra columns per slot.

The registry, entries, merges and scatters are numpy on the host, as in
the reference (stable sorts, lexsort, float32 drift statistics), so they
give its bits; only the assembled columns (:meth:`_assemble_ep`,
:meth:`_sub_ep`, :meth:`_tile_er`) and the candidate passes touch the
device, where K1 takes the cache's persistent jitter cursor as its
offset. :class:`CandidateMemo` memoises the uncached candidate paths.
"""

from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from protocol_tpu_torch.device import resolve_device
from protocol_tpu_torch.ops.cost import CostWeights
from protocol_tpu_torch.ops.encoding import (
    EncodedProviders,
    EncodedRequirements,
    FeatureEncoder,
    providers_from_numpy,
    requirements_from_numpy,
)
from protocol_tpu_torch.ops.sparse import candidates_topk, reverse_candidates

_P_FIELDS = (
    "gpu_count", "gpu_mem_mb", "gpu_model_id", "has_gpu", "has_cpu",
    "cpu_cores", "ram_mb", "storage_gb", "lat", "lon", "has_location",
    "price", "load", "valid",
)
# integer columns whose "absent" sentinel is -1 (a 0 fill would read as a
# real reported value to compat_mask, e.g. "0 cores")
_P_INT_FIELDS = frozenset(
    ("gpu_count", "gpu_mem_mb", "gpu_model_id", "cpu_cores", "ram_mb", "storage_gb")
)
# requirement columns padded with -1 (unconstrained) rather than 0
_R_NEG_FIELDS = frozenset(
    ("cpu_cores", "ram_mb", "storage_gb", "gpu_count", "gpu_mem_min", "gpu_mem_max",
     "gpu_total_mem_min", "gpu_total_mem_max")
)


def _pow2(n: int, floor: int = 8) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


@dataclass
class ProviderItem:
    addr: str
    specs: object  # Optional[ComputeSpecs]
    location: object  # Optional[NodeLocation]
    price: float = 0.0
    load: float = 0.0

    def fingerprint(self) -> tuple:
        """Structural identity for change detection: a hand-built field
        tuple (this runs once per provider per prepare)."""
        s = self.specs
        g = s.gpu if s is not None else None
        c = s.cpu if s is not None else None
        loc = self.location
        return (
            (g.count, g.model, g.memory_mb) if g is not None else None,
            (c.cores,) if c is not None else None,
            (s.ram_mb, s.storage_gb) if s is not None else None,
            (loc.latitude, loc.longitude) if loc is not None else None,
        )


@dataclass
class TaskItem:
    task_id: str
    requirement: object  # ComputeRequirements
    take: int  # replica slots this solve
    prio: float = 0.0

    def req_key(self) -> tuple:
        """Structural identity over the encoded requirement fields."""
        r = self.requirement
        return (
            (r.cpu.cores,) if r.cpu is not None else None,
            r.ram_mb,
            r.storage_gb,
            tuple(
                (g.count, g.model, g.memory_mb, g.memory_mb_min,
                 g.memory_mb_max, g.total_memory_min, g.total_memory_max)
                for g in r.gpu
            ),
        )


@dataclass
class _TaskEntry:
    req_key: tuple
    take: int
    vocab_version: int
    cand_p: np.ndarray  # [take, k] global rows, -1 pad
    cand_static: np.ndarray  # [take, k] f32 cost minus base minus priority
    er_row: dict  # single-row numpy requirement columns


@dataclass
class PreparedSolve:
    ep: EncodedProviders  # padded to p_bucket, on the cache's device
    cand_p: np.ndarray  # [S_pad, k + extra]
    cand_c: np.ndarray  # [S_pad, k + extra] current full costs
    price0: np.ndarray  # [p_bucket] f32
    row_of_addr: dict
    addr_of_row: list
    num_rows: int
    p_bucket: int
    num_slots: int
    rebuilt: bool
    delta_tasks: int
    delta_rows: int
    # valid rows in no task's cached top-k list, given reverse edges by the
    # coverage repair (0 = full coverage)
    uncovered_rows: int = 0
    # fraction of valid rows whose base drifted beyond the selection
    # tolerance since their candidates were chosen (measured before any
    # rebuild of this prepare)
    stale_frac: float = 0.0
    # [S_pad] bool: slots whose assembled lists differ from the previous
    # prepare's (the warm retirement carry clears them); None on the first
    # prepare or after a relayout (every slot dirty)
    dirty_slots: Optional[np.ndarray] = None


class CandidateCache:
    """The reference's ``CandidateCache`` with a ``device`` for the
    assembled columns and the candidate passes (K1 on a card)."""

    def __init__(
        self,
        encoder: FeatureEncoder,
        weights: CostWeights,
        k: int = 64,
        max_invalid_frac: float = 0.25,
        reverse_r: int = 8,
        extra: int = 16,
        stale_rel_tol: float = 0.25,
        stale_abs_tol: float = 0.05,
        max_stale_frac: float | None = 0.10,
        device: str | torch.device = "cuda",
    ):
        self.encoder = encoder
        self.device = resolve_device(device)
        # selection is priority-free: the priority term shifts a task's
        # whole row and cannot change its provider ranking
        self.weights = weights
        self._sel_weights = dataclasses.replace(weights, priority=0.0)
        self.k = k
        self.max_invalid_frac = max_invalid_frac
        # adaptive re-ground: a row is stale when its mean-centred base
        # drift exceeds stale_rel_tol x the fleet's base spread +
        # stale_abs_tol; a prepare that finds more than max_stale_frac
        # stale rows rebuilds (None disables the trigger)
        self.stale_rel_tol = stale_rel_tol
        self.stale_abs_tol = stale_abs_tol
        self.max_stale_frac = max_stale_frac
        # coverage repair: up to reverse_r reverse edges per uncovered row,
        # scattered into extra fixed columns per slot
        self.reverse_r = reverse_r
        self.extra = extra
        self._clear()

    # ---------------- provider registry ----------------

    def _clear(self) -> None:
        self.rows = 0
        self.row_of_addr: dict[str, int] = {}
        self.addr_of_row: list[Optional[str]] = []
        self.fp_of_addr: dict[str, tuple] = {}
        self.cols: dict[str, np.ndarray] = {}
        self.prices = np.zeros(0, np.float32)
        # base (price/load terms) as of each row's candidate selection:
        # the drift reference of the adaptive re-ground
        self.sel_base = np.zeros(0, np.float32)
        self.entries: dict[str, _TaskEntry] = {}
        # persistent jitter cursor: delta batches must not restart the
        # jitter's task index at 0, or tasks registered one per prepare on
        # a homogeneous fleet would all keep the same k providers
        self._jitter_cursor = 0
        # the previous prepare's assembled lists: the dirty_slots reference
        self._prev_cand_p: Optional[np.ndarray] = None
        self._prev_cand_c: Optional[np.ndarray] = None

    def invalidate(self) -> None:
        """Force a full rebuild on the next prepare."""
        self._clear()

    def _grow(self, need: int) -> None:
        cap = self.prices.shape[0]
        if need <= cap:
            return
        new_cap = _pow2(need)
        self.prices = np.concatenate([self.prices, np.zeros(new_cap - cap, np.float32)])
        self.sel_base = np.concatenate([self.sel_base, np.zeros(new_cap - cap, np.float32)])
        for name, arr in self.cols.items():
            pad = np.zeros((new_cap - cap,) + arr.shape[1:], arr.dtype)
            if name in _P_INT_FIELDS:
                pad.fill(-1)
            self.cols[name] = np.concatenate([arr, pad])

    def _register_batch(self, items: list[ProviderItem]) -> np.ndarray:
        """Encode a batch of new or changed providers and append rows.
        Returns the new global row indices."""
        n = len(items)
        enc = self.encoder.provider_arrays(
            [it.specs for it in items],
            locations=[it.location for it in items],
            prices=[it.price for it in items],
            loads=[it.load for it in items],
        )
        lo = self.rows
        self._grow(lo + n)
        if not self.cols:
            # first registration: the columns at the current capacity
            cap = self.prices.shape[0]
            for name in _P_FIELDS:
                a = enc[name]
                col = np.zeros((cap,) + a.shape[1:], a.dtype)
                if name in _P_INT_FIELDS:
                    col.fill(-1)
                self.cols[name] = col
        for name in _P_FIELDS:
            self.cols[name][lo:lo + n] = enc[name]
        w = self.weights
        self.sel_base[lo:lo + n] = [w.price * it.price + w.load * it.load for it in items]
        rows = np.arange(lo, lo + n, dtype=np.int32)
        for i, it in enumerate(items):
            old = self.row_of_addr.get(it.addr)
            if old is not None:
                self.cols["valid"][old] = False
            self.row_of_addr[it.addr] = lo + i
            self.fp_of_addr[it.addr] = it.fingerprint()
        self.addr_of_row.extend(it.addr for it in items)
        self.rows = lo + n
        return rows

    def _pad_k(self, cp: np.ndarray, cs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Normalise an entry to self.k columns (the pass clamps k to P)."""
        have = cp.shape[1]
        if have >= self.k:
            return cp[:, : self.k], cs[:, : self.k]
        padp = np.full((cp.shape[0], self.k - have), -1, np.int32)
        pads = np.zeros((cp.shape[0], self.k - have), np.float32)
        return np.concatenate([cp, padp], axis=1), np.concatenate([cs, pads], axis=1)

    def _base_now(self) -> np.ndarray:
        w = self.weights
        return (
            w.price * self.cols["price"][: self.rows] + w.load * self.cols["load"][: self.rows]
        ).astype(np.float32)

    def _padded_rows(self, rows, pad_to: int) -> dict[str, np.ndarray]:
        kw = {}
        for name in _P_FIELDS:
            col = self.cols[name][rows]
            pad = np.zeros((pad_to - col.shape[0],) + col.shape[1:], col.dtype)
            if name in _P_INT_FIELDS:
                pad.fill(-1)
            kw[name] = np.concatenate([col, pad])
        return kw

    def _assemble_ep(self, p_bucket: int) -> EncodedProviders:
        # new device columns every prepare: the host columns are edited in
        # place (prices, loads, valid)
        return providers_from_numpy(self._padded_rows(slice(0, self.rows), p_bucket), self.device)

    # ---------------- requirements tiling ----------------

    def _encode_req_row(self, item: TaskItem) -> dict:
        return self.encoder.requirement_arrays([item.requirement])

    def _tile_er(self, rows: list[tuple[dict, int, float]], pad_to: int) -> EncodedRequirements:
        """The requirement columns of cached single-row encodings, each
        repeated ``take`` times (a task's slots share its requirement;
        priority per slot), padded to ``pad_to``."""
        fields = {}
        for name in rows[0][0]:
            arr = np.concatenate([np.repeat(r[name], take, axis=0) for r, take, _ in rows])
            if pad_to > arr.shape[0]:
                pad = np.zeros((pad_to - arr.shape[0],) + arr.shape[1:], arr.dtype)
                if name in _R_NEG_FIELDS:
                    pad.fill(-1)
                arr = np.concatenate([arr, pad])
            fields[name] = arr
        prio = np.zeros(pad_to, np.float32)
        valid = np.zeros(pad_to, bool)
        off = 0
        for _r, take, p in rows:
            prio[off:off + take] = p
            valid[off:off + take] = True
            off += take
        fields["priority"] = prio
        fields["valid"] = valid
        return requirements_from_numpy(fields, self.device)

    def _topk(self, ep, er, k: int, n: int) -> tuple[np.ndarray, np.ndarray]:
        """The forward pass at the cursor, its first ``n`` rows read back;
        the cursor moves on by the padded slot count."""
        s_pad = er.num
        cp, cc = candidates_topk(
            ep, er, self._sel_weights, k=k, tile=min(1024, s_pad),
            task_offset=self._jitter_cursor,
        )
        self._jitter_cursor += s_pad
        return cp[:n].cpu().numpy(), cc[:n].cpu().numpy()

    # ---------------- the solve preparation ----------------

    def prepare(self, providers: list[ProviderItem], tasks: list[TaskItem]) -> PreparedSolve:
        """Sync the registry and entries with the current population and
        return the assembled solve inputs: O(churn x S) work, not
        O(P x S), when the population is mostly unchanged."""
        # ---- departures first: mask rows whose addr is gone
        current_addrs = {it.addr for it in providers}
        for addr, row in list(self.row_of_addr.items()):
            if addr not in current_addrs:
                self.cols["valid"][row] = False
                del self.row_of_addr[addr]
                self.fp_of_addr.pop(addr, None)
        # ---- compaction: too many dead rows -> full rebuild
        if self.rows:
            live = int(self.cols["valid"][: self.rows].sum())
            if (self.rows - live) / self.rows > self.max_invalid_frac:
                self._clear()
        rebuilt = self.rows == 0

        # ---- provider sync
        delta_items: list[ProviderItem] = []
        for it in providers:
            row = self.row_of_addr.get(it.addr)
            if row is None or self.fp_of_addr.get(it.addr) != it.fingerprint():
                delta_items.append(it)
            else:
                # per-prepare drift: price and load updated in place
                self.cols["price"][row] = it.price
                self.cols["load"][row] = it.load
        new_rows = self._register_batch(delta_items) if delta_items else np.zeros(0, np.int32)

        # ---- adaptive re-ground: if base drift re-ranked too much of the
        # fleet since selection, rebuild now (one recursion; the fresh
        # cache reports rebuilt=True and skips this check)
        stale_frac = self._stale_fraction()
        if not rebuilt and self.max_stale_frac is not None and stale_frac > self.max_stale_frac:
            self._clear()
            prep = self.prepare(providers, tasks)
            return dataclasses.replace(prep, stale_frac=stale_frac)

        p_bucket = _pow2(self.rows)
        ep = self._assemble_ep(p_bucket)
        base = self._base_now()

        # ---- task sync
        current_ids = {t.task_id for t in tasks}
        for tid in [t for t in self.entries if t not in current_ids]:
            del self.entries[tid]
        vocab = self.encoder.vocab_version
        delta_tasks = [
            t for t in tasks
            if (e := self.entries.get(t.task_id)) is None
            or e.take != t.take
            or e.req_key != t.req_key()
            or e.vocab_version != vocab
        ]
        fresh_ids = {t.task_id for t in delta_tasks}

        if delta_tasks:
            rows_meta = [(self._encode_req_row(t), t.take, 0.0) for t in delta_tasks]
            sd = sum(t.take for t in delta_tasks)
            cp, cc = self._topk(ep, self._tile_er(rows_meta, _pow2(sd)), self.k, sd)
            static = np.where(cp >= 0, cc - base[np.maximum(cp, 0)], 0.0).astype(np.float32)
            off = 0
            for (er_row, take, _), t in zip(rows_meta, delta_tasks):
                e_cp, e_cs = self._pad_k(cp[off:off + take], static[off:off + take])
                self.entries[t.task_id] = _TaskEntry(
                    req_key=t.req_key(), take=take, vocab_version=vocab,
                    cand_p=e_cp.copy(), cand_static=e_cs.copy(), er_row=er_row,
                )
                off += take

        # ---- merge new providers into unchanged cached tasks
        stale_tasks = [t for t in tasks if t.task_id not in fresh_ids]
        if len(new_rows) and stale_tasks:
            self._merge_new_rows(new_rows, stale_tasks, base)

        # ---- assembly
        S = sum(t.take for t in tasks)
        s_pad = _pow2(S)
        cand_p = np.full((s_pad, self.k), -1, np.int32)
        cand_c = np.zeros((s_pad, self.k), np.float32)
        slot_prio = np.zeros(s_pad, np.float32)
        valid_row = self.cols["valid"][: self.rows]
        wprio = self.weights.priority
        off = 0
        for t in tasks:
            e = self.entries[t.task_id]
            # departed and retired rows fall out of the matching here
            cp = np.where((e.cand_p >= 0) & valid_row[np.maximum(e.cand_p, 0)], e.cand_p, -1)
            cand_p[off:off + t.take] = cp
            cand_c[off:off + t.take] = np.where(
                cp >= 0, e.cand_static + base[np.maximum(cp, 0)] - wprio * t.prio, 0.0
            )
            slot_prio[off:off + t.take] = t.prio
            off += t.take

        # ---- coverage repair: valid rows in no list get reverse edges
        cand_p, cand_c, uncovered = self._repair_coverage(
            cand_p, cand_c, tasks, valid_row, slot_prio, s_pad, wprio
        )

        # dirty slots for the warm retirement carry: the assembled lists
        # against the previous prepare's; a material cost decrease (beyond
        # stale_abs_tol) dirties a row too, as it may un-retire a task
        if self._prev_cand_p is not None and self._prev_cand_p.shape == cand_p.shape:
            dirty_slots = (cand_p != self._prev_cand_p).any(axis=1)
            dirty_slots |= ((self._prev_cand_c - cand_c) > self.stale_abs_tol).any(axis=1)
        else:
            dirty_slots = None  # first prepare / slot relayout: all dirty
        self._prev_cand_p = cand_p.copy()
        self._prev_cand_c = cand_c.copy()

        return PreparedSolve(
            ep=ep,
            cand_p=cand_p,
            cand_c=cand_c,
            price0=np.concatenate(
                [self.prices[: self.rows], np.zeros(p_bucket - self.rows, np.float32)]
            ),
            row_of_addr=self.row_of_addr,
            addr_of_row=self.addr_of_row,
            num_rows=self.rows,
            p_bucket=p_bucket,
            num_slots=S,
            rebuilt=rebuilt,
            delta_tasks=len(delta_tasks),
            delta_rows=int(len(new_rows)),
            uncovered_rows=uncovered,
            stale_frac=stale_frac,
            dirty_slots=dirty_slots,
        )

    def _stale_fraction(self) -> float:
        """Fraction of valid rows whose base drifted beyond the selection
        tolerance: drift mean-centred (a uniform shift cannot re-rank) and
        scaled by the current base spread."""
        if self.rows == 0:
            return 0.0
        valid = self.cols["valid"][: self.rows]
        if not valid.any():
            return 0.0
        now = self._base_now()[valid]
        d = now - self.sel_base[: self.rows][valid]
        d = d - d.mean()
        tol = self.stale_rel_tol * float(np.std(now)) + self.stale_abs_tol
        return float((np.abs(d) > tol).mean())

    def _sub_ep(self, rows: np.ndarray) -> EncodedProviders:
        """The provider columns of a row subset, padded to a pow-2 bucket
        (the merge's and the coverage repair's pass run on it, their
        provider jitter keyed on the local index)."""
        return providers_from_numpy(self._padded_rows(rows, _pow2(len(rows))), self.device)

    def _repair_coverage(self, cand_p, cand_c, tasks, valid_row, slot_prio, s_pad: int,
                         wprio: float) -> tuple[np.ndarray, np.ndarray, int]:
        """Append ``self.extra`` candidate columns holding reverse edges for
        the valid rows in no list: one [U x S] reverse pass over only the
        uncovered rows (the reference's ``k=1`` forward output is unused,
        so only the reverse selection runs), then a host scatter capped at
        ``extra`` per slot, cheapest first."""
        extra_p = np.full((s_pad, self.extra), -1, np.int32)
        extra_c = np.zeros((s_pad, self.extra), np.float32)
        covered = np.zeros(self.rows, bool)
        flat = cand_p[cand_p >= 0]
        if flat.size:
            covered[flat] = True
        uncovered = np.flatnonzero(valid_row & ~covered)
        if uncovered.size and tasks:
            sub_ep = self._sub_ep(uncovered)
            rows_meta = [(self.entries[t.task_id].er_row, t.take, 0.0) for t in tasks]
            er = self._tile_er(rows_meta, s_pad)
            rev_t, rev_c, _, _ = reverse_candidates(
                sub_ep, er, self._sel_weights, min(1024, s_pad), min(self.reverse_r, s_pad),
                task_offset=self._jitter_cursor,
            )
            self._jitter_cursor += s_pad
            U = uncovered.size
            rt = rev_t[:U].cpu().numpy()
            rc = rev_c[:U].cpu().numpy()
            ok = rt >= 0
            slot = rt[ok]
            cost = rc[ok]
            prov = np.broadcast_to(uncovered[:, None].astype(np.int32), rt.shape)[ok]
            order = np.lexsort((cost, slot))
            slot, cost, prov = slot[order], cost[order], prov[order]
            idxs = np.arange(slot.size)
            first = np.r_[True, slot[1:] != slot[:-1]] if slot.size else np.zeros(0, bool)
            start = np.maximum.accumulate(np.where(first, idxs, 0))
            rank = idxs - start
            keep = rank < self.extra
            extra_p[slot[keep], rank[keep]] = prov[keep]
            extra_c[slot[keep], rank[keep]] = cost[keep] - wprio * slot_prio[slot[keep]]
        return (
            np.concatenate([cand_p, extra_p], axis=1),
            np.concatenate([cand_c, extra_c], axis=1),
            int(uncovered.size),
        )

    def _merge_new_rows(self, new_rows: np.ndarray, tasks: list[TaskItem],
                        base: np.ndarray) -> None:
        """Fold newly registered rows into the cached lists: one
        [delta-P x S] forward pass and a host merge per slot."""
        ep_d = self._sub_ep(new_rows)
        rows_meta = [(self.entries[t.task_id].er_row, t.take, 0.0) for t in tasks]
        S = sum(t.take for t in tasks)
        cp_d, cc_d = self._topk(ep_d, self._tile_er(rows_meta, _pow2(S)),
                                min(self.k, ep_d.num), S)
        valid_row = self.cols["valid"][: self.rows]
        cp_d = np.where(cp_d >= 0, new_rows[np.maximum(cp_d, 0)], -1)
        static_d = np.where(cp_d >= 0, cc_d - base[np.maximum(cp_d, 0)], 0.0).astype(np.float32)
        off = 0
        for t in tasks:
            e = self.entries[t.task_id]
            take = e.take
            allp = np.concatenate([e.cand_p, cp_d[off:off + take]], axis=1)
            alls = np.concatenate([e.cand_static, static_d[off:off + take]], axis=1)
            # rank by current total cost; -1 entries and dead rows sort
            # last (a departed provider must not hold a slot in the top-k
            # against a live newcomer)
            live = (allp >= 0) & valid_row[np.maximum(allp, 0)]
            key = np.where(live, alls + base[np.maximum(allp, 0)], np.inf)
            idx = np.argsort(key, axis=1, kind="stable")[:, : self.k]
            e.cand_p, e.cand_static = self._pad_k(
                np.take_along_axis(allp, idx, axis=1), np.take_along_axis(alls, idx, axis=1)
            )
            off += take

    def store_prices(self, price: np.ndarray) -> None:
        """Keep the auction's prices (indexed by row)."""
        self.prices[: self.rows] = np.asarray(price[: self.rows], np.float32)


class CandidateMemo:
    """Content-hash memo over bidirectional candidate generation: the
    generated [T, K_eff] structure is keyed on a hash of the ENCODED
    inputs plus every generation parameter, so a changed price, spec,
    priority or padding row changes the bytes and misses, and a
    byte-identical repeat hits. Hashing reads each column back from the
    device once (O(P + T) bytes) against generation's O(P x T) cells.

    A pure memo (LRU over :attr:`CAPACITY` keys): it cannot exploit
    partial overlap, only exact repeats."""

    CAPACITY = 4

    def __init__(self):
        self._slots: dict[tuple, tuple] = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _fingerprint(enc) -> bytes:
        h = hashlib.sha1()
        for f in dataclasses.fields(enc):
            col = getattr(enc, f.name).detach().contiguous().cpu()
            h.update(str((f.name, tuple(col.shape), col.dtype)).encode())
            h.update(col.view(torch.uint8).numpy().tobytes())
        return h.digest()

    def get(self, ep, er, weights, *, k, tile, reverse_r, extra, gen=None):
        """The memoised ``candidates_topk_bidir(ep, er, weights, ...)``.
        ``gen`` replaces the generator (the mesh's sharded pass); it shares
        the key, since it is bit-identical to the one-device pass."""
        from protocol_tpu_torch.ops.sparse import candidates_topk_bidir

        key = (
            self._fingerprint(ep), self._fingerprint(er),
            dataclasses.astuple(weights), k, tile, reverse_r, extra,
        )
        hit = self._slots.pop(key, None)
        if hit is not None:
            self.hits += 1
            self._slots[key] = hit  # re-insert: LRU order
            return hit
        self.misses += 1
        out = (gen or candidates_topk_bidir)(
            ep, er, weights, k=k, tile=tile, reverse_r=reverse_r, extra=extra
        )
        self._slots[key] = out
        while len(self._slots) > self.CAPACITY:
            self._slots.pop(next(iter(self._slots)))
        return out
