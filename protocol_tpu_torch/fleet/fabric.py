"""The sharded session fabric (``protocol_tpu/fleet/fabric.py``): the
multi-tenant registry behind the seam.

:class:`SessionFabric` spreads sessions over N
:class:`~protocol_tpu_torch.services.session_store.SessionStore` shards by
a sha1 ring with virtual nodes (:func:`_h`, the same bits as the
reference's, so a session lands on the same shard in either package and
the fleet's endpoint ring, :mod:`protocol_tpu_torch.dfleet.topology`,
hashes the same way), and presents the store's surface (``put``, ``get``,
``drop``, ``__len__``, ``evictions``, ``expirations``,
``snapshot_sessions``).

Above the shards sits the byte budget: each session's pinned bytes are
estimated once at open (:func:`estimate_arena_bytes`) and summed per tenant
and fleet-wide under one leaf lock. Past ``max_bytes``, a tenant past
``tenant_max_bytes`` or the fleet past ``max_sessions``, expired sessions
are swept first, then the least recently used session anywhere is evicted
(an in-flight delta on it refuses, and its client re-opens).

Lock order: shard locks never nest, and ``_budget_lock`` is a leaf (a
store calls the accounting hook under its own lock, and the hook takes
only the budget lock).

Left out: the shard blackout and its leave storms (``blackout``,
``drain_storms``), the chaos plane's store fault (ROADMAP queue A, M6).
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import os
import threading
from typing import Optional

import numpy as np

from protocol_tpu_torch.services.session_store import SessionStore, tenant_of


def _h(key: str) -> int:
    """The ring hash: the first 8 bytes of sha1, big-endian."""
    return int.from_bytes(hashlib.sha1(key.encode()).digest()[:8], "big")


# bound for the per-tenant counters, whose keys come from client-minted
# session ids
_MAX_TENANT_KEYS = 512


def estimate_arena_bytes(p_cols: dict, r_cols: dict, top_k: int, reverse_r: int = 8,
                         slack: int = 16) -> int:
    """Bytes of one session's pinned state, from rows x dtype widths: the
    padded columns twice (the session's and the arena's previous tick),
    the [T, K] candidates (i32 provider + f32 cost), the repair state
    ([P, reverse_r] keys and a [T, slack] shadow) and the duals. An
    estimate the budget can take at open, not an audit."""
    pb = sum(int(np.asarray(a).nbytes) for a in p_cols.values())
    rb = sum(int(np.asarray(a).nbytes) for a in r_cols.values())
    p_pad = int(np.asarray(p_cols["gpu_count"]).shape[0])
    t_pad = int(np.asarray(r_cols["cpu_cores"]).shape[0])
    k = min(max(int(top_k), 1), max(p_pad, 1))
    cand = t_pad * k * 8
    cand += p_pad * reverse_r * 8 + t_pad * slack * 8
    duals = p_pad * (4 + 1 + 4) + t_pad * 4
    return 2 * (pb + rb) + cand + duals


@dataclasses.dataclass
class FleetConfig:
    """The fleet's knobs, apart from the servicer's own. The defaults keep a
    lone servicer as it was: admission counts but admits all, no byte
    budget, and a fabric whose ``max_sessions`` pressure is the single
    store's LRU. ``PROTOCOL_TPU_FLEET_*`` variables set them for a served
    process (:meth:`from_env`).

    ``ckpt_dir`` turns on session checkpoints
    (:mod:`protocol_tpu_torch.faults.checkpoint`), flushed every
    ``ckpt_every`` ticks before the tick is acknowledged and rehydrated
    when a servicer starts. ``tick_deadline_ms`` arms the tick watchdog: a
    tick whose budget is already spent is served the previous plan,
    flagged stale, at most ``max_stale_ticks`` in a row. ``proc_id`` names
    this process's journal namespace under ``ckpt_dir``; ``endpoint`` is
    the address its ``moved:`` redirects name."""

    shards: int = 4
    vnodes: int = 64
    max_bytes: Optional[int] = None
    tenant_max_bytes: Optional[int] = None
    admit_rate: Optional[float] = None  # tokens/s a tenant; None = off
    admit_burst: float = 16.0
    delta_queue_depth: int = 8  # <= 0 turns the bound off
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 1
    tick_deadline_ms: Optional[float] = None
    max_stale_ticks: int = 2
    proc_id: str = "p0"
    endpoint: Optional[str] = None

    @classmethod
    def from_env(cls) -> "FleetConfig":
        env = os.environ.get

        def _opt(name, cast):
            raw = env(name)
            return cast(raw) if raw else None

        return cls(
            shards=int(env("PROTOCOL_TPU_FLEET_SHARDS", "4")),
            max_bytes=_opt("PROTOCOL_TPU_FLEET_MAX_BYTES", int),
            tenant_max_bytes=_opt("PROTOCOL_TPU_FLEET_TENANT_MAX_BYTES", int),
            admit_rate=_opt("PROTOCOL_TPU_FLEET_ADMIT_RATE", float),
            admit_burst=float(env("PROTOCOL_TPU_FLEET_ADMIT_BURST", "16")),
            delta_queue_depth=int(env("PROTOCOL_TPU_FLEET_QUEUE_DEPTH", "8")),
            ckpt_dir=env("PROTOCOL_TPU_FLEET_CKPT_DIR") or None,
            ckpt_every=int(env("PROTOCOL_TPU_FLEET_CKPT_EVERY", "1")),
            tick_deadline_ms=_opt("PROTOCOL_TPU_FLEET_TICK_DEADLINE_MS", float),
            max_stale_ticks=int(env("PROTOCOL_TPU_FLEET_MAX_STALE", "2")),
            proc_id=env("PROTOCOL_TPU_FLEET_PROC_ID", "p0"),
            endpoint=env("PROTOCOL_TPU_FLEET_ENDPOINT") or None,
        )


class SessionFabric:
    """Consistent-hash shards of :class:`SessionStore` under one byte and
    session budget (see the module docstring)."""

    def __init__(self, shards: int = 4, max_sessions: int = 8, ttl_s: float = 900.0,
                 max_bytes: Optional[int] = None, tenant_max_bytes: Optional[int] = None,
                 vnodes: int = 64):
        self.n_shards = max(1, int(shards))
        # the global count: each shard could hold the whole fleet, and the
        # fabric's pressure evicts the least recently used session anywhere
        self.max_sessions = int(max_sessions)
        self.max_bytes = max_bytes
        self.tenant_max_bytes = tenant_max_bytes
        self.shards = [
            SessionStore(max_sessions=self.max_sessions, ttl_s=ttl_s,
                         on_evict=self._on_store_evict)
            for _ in range(self.n_shards)
        ]
        ring = sorted((_h(f"shard-{i}/vnode-{j}"), i)
                      for i in range(self.n_shards) for j in range(max(1, int(vnodes))))
        self._ring_keys = [k for k, _ in ring]
        self._ring_shards = [s for _, s in ring]
        self._budget_lock = threading.Lock()  # a leaf
        self._by_session: dict[str, tuple] = {}  # sid -> (session, tenant, bytes)
        self._tenant_bytes: dict[str, int] = {}
        self._total_bytes = 0
        self._pressure_evictions = 0
        self._evictions_by_tenant: dict[str, int] = {}
        # the servicer's checkpoint collector: called on every let-go with
        # its reason, under the owning shard's lock (leaf work only)
        self.on_let_go = None

    # ---------------- the shard map ----------------

    def shard_index(self, session_id: str) -> int:
        i = bisect.bisect_right(self._ring_keys, _h(session_id))
        return self._ring_shards[i % len(self._ring_shards)]

    def shard_of(self, session_id: str) -> SessionStore:
        return self.shards[self.shard_index(session_id)]

    # ---------------- the store's surface ----------------

    def put(self, session) -> None:
        self.shard_of(session.session_id).put(session)
        self._account(session)
        self._apply_pressure(protect=session.session_id)

    def get(self, session_id: str, fingerprint: str):
        return self.shard_of(session_id).get(session_id, fingerprint)

    def drop(self, session_id: str) -> None:
        self.shard_of(session_id).drop(session_id)

    def snapshot_sessions(self) -> list:
        """The live sessions of every shard now."""
        out = []
        for shard in self.shards:
            out.extend(shard.snapshot_sessions())
        return out

    def __len__(self) -> int:
        return sum(len(s) for s in self.shards)

    @property
    def evictions(self) -> int:
        return sum(s.evictions for s in self.shards)

    @property
    def expirations(self) -> int:
        return sum(s.expirations for s in self.shards)

    # ---------------- the fleet's surface ----------------

    def sweep(self) -> int:
        """Expire the idle sessions of every shard now (their bytes are
        released by the eviction hook); returns how many."""
        return sum(shard.sweep() for shard in self.shards)

    @property
    def total_bytes(self) -> int:
        with self._budget_lock:
            return self._total_bytes

    def tenant_bytes(self, tenant: str) -> int:
        with self._budget_lock:
            return self._tenant_bytes.get(tenant, 0)

    def snapshot(self) -> dict:
        """Occupancy and budget gauges."""
        with self._budget_lock:
            tenant_bytes = {t: b for t, b in self._tenant_bytes.items() if b}
            total = self._total_bytes
            pressure = self._pressure_evictions
            by_tenant = dict(self._evictions_by_tenant)
        return {
            "shards": [len(s) for s in self.shards],
            "sessions": len(self),
            "max_sessions": self.max_sessions,
            "total_bytes": total,
            "max_bytes": self.max_bytes,
            "tenant_bytes": tenant_bytes,
            "tenant_max_bytes": self.tenant_max_bytes,
            "pressure_evictions": pressure,
            "evictions": self.evictions,
            "expirations": self.expirations,
            "evictions_by_tenant": by_tenant,
        }

    # ---------------- the byte budget ----------------

    def _account(self, session) -> None:
        with self._budget_lock:
            if session.evicted:
                # lost the race with the pressure before it was counted: its
                # bytes would never be released
                return
            tenant = tenant_of(session.session_id)
            est = int(session.arena_bytes)
            self._by_session[session.session_id] = (session, tenant, est)
            self._tenant_bytes[tenant] = self._tenant_bytes.get(tenant, 0) + est
            self._total_bytes += est

    def _on_store_evict(self, session, reason: str) -> None:
        # under the owning shard's lock: only the leaf budget lock here
        if self.on_let_go is not None:
            try:
                self.on_let_go(session, reason)
            except Exception:
                pass  # an observer's failure never fails an eviction
        with self._budget_lock:
            entry = self._by_session.get(session.session_id)
            if entry is None or entry[0] is not session:
                # never counted, or already replaced by a same-id re-open
                return
            del self._by_session[session.session_id]
            _, tenant, est = entry
            remaining = self._tenant_bytes.get(tenant, 0) - est
            if remaining > 0:
                self._tenant_bytes[tenant] = remaining
            else:
                self._tenant_bytes.pop(tenant, None)
            self._total_bytes -= est
            if reason in ("lru", "pressure"):
                # capacity evictions only: drop, replace and TTL have their
                # own counters
                self._evictions_by_tenant[tenant] = self._evictions_by_tenant.get(tenant, 0) + 1
                while len(self._evictions_by_tenant) > _MAX_TENANT_KEYS:
                    self._evictions_by_tenant.pop(next(iter(self._evictions_by_tenant)))
            if reason == "pressure":
                self._pressure_evictions += 1

    # ---------------- the eviction pressure ----------------

    def _over_budget(self) -> tuple[bool, Optional[str]]:
        with self._budget_lock:
            if self.max_bytes is not None and self._total_bytes > self.max_bytes:
                return True, None
            if self.tenant_max_bytes is not None:
                for t, b in self._tenant_bytes.items():
                    if b > self.tenant_max_bytes:
                        return True, t
        if len(self) > self.max_sessions:
            return True, None
        return False, None

    def _global_lru(self, exclude=(), tenant: Optional[str] = None):
        """(shard index, session id) of the least recently used session
        (each shard names its own; ties by session id), or None."""
        best = None
        for i, shard in enumerate(self.shards):
            cand = shard.lru_candidate(exclude=exclude, tenant=tenant)
            if cand is None:
                continue
            sid, last_used = cand
            key = (last_used, sid)
            if best is None or key < best[0]:
                best = (key, i, sid)
        if best is None:
            return None
        return best[1], best[2]

    def _apply_pressure(self, protect: str) -> None:
        """Evict until the fleet is within its budgets again, never
        ``protect`` (the session whose open brought the pressure): expired
        sessions first, then the least recently used, one a round."""
        swept = False
        for _ in range(self.max_sessions + len(self) + 8):
            over, tenant = self._over_budget()
            if not over:
                return
            if not swept:
                swept = True
                if self.sweep():
                    continue
            victim = self._global_lru(exclude=(protect,), tenant=tenant)
            if victim is None:
                # only the protected session is over: never evict it mid-open
                return
            shard_i, sid = victim
            self.shards[shard_i].evict(sid, reason="pressure")
