"""The servicer's session registry for wire v2
(``protocol_tpu/services/session_store.py``).

A session pins the per-marketplace state, the full columnar snapshot and a
persistent solve arena, behind a ``(session_id, epoch_fingerprint)`` key,
so that steady-state ticks ship only churned rows (``AssignDelta``) and the
warm candidate structure and auction duals never leave the servicer. A
delta against a session this process does not hold, or holds under
another fingerprint or tick cursor, is refused, never guessed at: the
client re-opens from its own state. Sessions are LRU-evicted beyond
``max_sessions`` and expire after ``ttl_s`` idle seconds.

Delta application is copy-on-write per column: the arena's dirty test
holds the previous tick's columns by reference, so a churned column is
replaced, never changed in place.

:func:`make_solve_arena` is the port's engine seam, shared by the
sessions, the servicer's unary arena and the trace replayer: the wire's
``jax[:D]`` (and the port's own spelling ``torch[:D]``) is a
:class:`~protocol_tpu_torch.parallel.torch_arena.TorchSolveArena` over D
views of the servicer's device. The reference's native engines
(``native-mt``, ``sinkhorn-mt``) are refused (ROADMAP queue A, M5).

The store serves the fleet layer (:mod:`protocol_tpu_torch.fleet.fabric`):
every let-go calls its ``on_evict`` hook, ``snapshot_sessions`` is the
drain's and the migration's walk, and a session carries its byte estimate
(``arena_bytes``) and the tick watchdog's state (``stale_streak``,
``solve_ewma_ms``).

Left out: the native engines' thread budget (``EngineThreadBudget``), the
flight recorder's capture and the stream engine. Locks are plain
``threading.Lock`` s (the reference's lock witness is ROADMAP queue A, L).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from protocol_tpu_torch.obs.spans import TRACER as _tracer
from protocol_tpu_torch.proto.wire import P_WIRE_DTYPES, R_WIRE_DTYPES

# session-servable kernel strings -> the arena engine behind them
_SESSION_ENGINES = {
    "native-mt": "auction",
    "sinkhorn-mt": "sinkhorn",
    "jax": "jax",
    "torch": "jax",
}


class KernelNotServed(RuntimeError):
    """A kernel or engine the reference serves and the port does not yet
    (gRPC ``FAILED_PRECONDITION``); the message names its ROADMAP item."""


def parse_session_kernel(kernel: str) -> Optional[tuple[str, int]]:
    """``native-mt[:N]`` / ``sinkhorn-mt[:N]`` / ``jax[:D]`` / ``torch[:D]``
    -> (arena engine, thread count or, for the arena, the device count; 0 =
    all). Any other kernel -> None: not session-servable, since a session's
    warm state lives in a solve arena."""
    base, _, suffix = kernel.partition(":")
    engine = _SESSION_ENGINES.get(base)
    if engine is None:
        return None
    try:
        return engine, (int(suffix) if suffix else 0)
    except ValueError:
        return None


def make_solve_arena(engine: str, k: int, threads: int, device="cuda", **kw):
    """The arena of a parsed kernel string: ``engine="jax"`` (or ``"torch"``)
    is a :class:`TorchSolveArena` with ``threads`` as its device count D (0
    = every visible device of ``device``'s type) on ``device``; the native
    engines raise :class:`KernelNotServed`."""
    if engine not in ("jax", "torch"):
        raise KernelNotServed(
            f"engine {engine!r}: the reference's native C++ engines are not served by the "
            "port (ROADMAP queue A, M5)")
    from protocol_tpu_torch.parallel.torch_arena import TorchSolveArena

    return TorchSolveArena(k=k, devices=threads, device=device, **kw)


def _pad_cols(cols: dict[str, np.ndarray], n_real: int) -> dict[str, np.ndarray]:
    """Columns padded to the next pow2 bucket with zero rows, valid=False:
    the servicer's unary padding (``assign_kernels._pad_pow2``), so session
    and unary solves see the same padded inputs."""
    if n_real <= 0:
        return dict(cols)
    target = 1 << (n_real - 1).bit_length()
    if target == n_real:
        return dict(cols)
    out = {}
    for name, a in cols.items():
        pad = [(0, target - n_real)] + [(0, 0)] * (a.ndim - 1)
        out[name] = np.pad(a, pad)
    out["valid"] = np.concatenate(
        [np.asarray(cols["valid"], bool)[:n_real], np.zeros(target - n_real, bool)])
    return out


def _as_ns(cols: dict[str, np.ndarray]) -> object:
    ns = type("_Cols", (), {})()
    for name, arr in cols.items():
        setattr(ns, name, arr)
    return ns


@dataclass
class SolveSession:
    session_id: str
    fingerprint: str
    weights: object  # CostWeights
    kernel: str
    threads: int
    top_k: int
    p_cols: dict  # padded, wire dtypes
    r_cols: dict
    n_providers: int  # real (unpadded) row counts
    n_tasks: int
    arena: object  # TorchSolveArena
    tick: int = 0
    last_used: float = field(default_factory=time.monotonic)
    lock: threading.Lock = field(default_factory=threading.Lock)
    delta_rows_total: int = 0
    # set, under the store's lock, when the store lets go of the session
    # (LRU, TTL, drop, same-id replacement): an AssignDelta that already
    # looked it up refuses instead of solving on an arena nobody owns
    evicted: bool = False
    # ticks inside the servicer for this session, the lock's waiters
    # included: the queue-depth bound is checked before parking on ``lock``
    inflight: int = 0
    inflight_lock: threading.Lock = field(default_factory=threading.Lock)
    # the idempotent retransmit: a delta whose answer was lost is re-sent
    # with the same tick; its CRC against the last applied delta's replays
    # the cached answer, so a tick is applied once
    last_delta_crc: int = 0
    last_p4t: object = None  # np.ndarray [n_tasks] i32 after any solve
    # the fleet's byte budget: the session's pinned state, estimated once
    # at open (fleet.fabric.estimate_arena_bytes)
    arena_bytes: int = 0
    # the tick watchdog: ticks served stale in a row, and the EWMA of the
    # solve walls it predicts the next solve by
    stale_streak: int = 0
    solve_ewma_ms: float = 0.0

    def enter_tick(self, max_depth: int) -> bool:
        """Claim one queued-tick slot; False past ``max_depth`` (refused as
        RESOURCE_EXHAUSTED). ``max_depth <= 0`` disables the bound."""
        with self.inflight_lock:
            if max_depth > 0 and self.inflight >= max_depth:
                return False
            self.inflight += 1
            return True

    def exit_tick(self) -> None:
        with self.inflight_lock:
            self.inflight -= 1

    def solve(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The warm arena over the current columns: (provider_for_task [T],
        task_for_provider [P], price [P]) over the real row counts."""
        p4t_full = self.arena.solve(_as_ns(self.p_cols), _as_ns(self.r_cols), self.weights)
        p4t = np.asarray(p4t_full)[: self.n_tasks]
        t4p = np.full(self.n_providers, -1, np.int32)
        seated = np.flatnonzero((p4t >= 0) & (p4t < self.n_providers))
        t4p[p4t[seated]] = seated.astype(np.int32)
        price = self.arena.price  # None: no provider or no task to price
        if price is None:
            price = np.zeros(self.n_providers, np.float32)
        return p4t, t4p, np.asarray(price)[: self.n_providers]

    def apply_delta(self, provider_rows: np.ndarray, p_delta: dict[str, np.ndarray],
                    task_rows: np.ndarray, r_delta: dict[str, np.ndarray]) -> int:
        """Write churned rows into the session's columns, copy-on-write per
        column; returns the rows applied. Row indices are checked against
        the real row space (padding rows are never addressable from the
        wire), and everything is checked before the first write, so a bad
        delta leaves the session as it was (ValueError)."""
        groups = (
            (provider_rows, p_delta, self.p_cols, self.n_providers, P_WIRE_DTYPES),
            (task_rows, r_delta, self.r_cols, self.n_tasks, R_WIRE_DTYPES),
        )
        for rows, delta, _cols, n_real, spec in groups:
            if rows.size == 0:
                continue
            if rows.min() < 0 or rows.max() >= n_real:
                raise ValueError(f"delta row index out of range [0, {n_real})")
            for name in spec:
                if np.asarray(delta[name]).shape[0] != rows.size:
                    # numpy would broadcast a 1-row payload into every row
                    raise ValueError(
                        f"delta column {name!r} has {np.asarray(delta[name]).shape[0]} "
                        f"rows for {rows.size} row indices")
        applied = 0
        for rows, delta, cols, _n_real, spec in groups:
            if rows.size == 0:
                continue
            for name in spec:
                new_vals = delta[name]
                if np.array_equal(cols[name][rows], new_vals):
                    continue  # column untouched by this delta
                col = cols[name].copy()
                col[rows] = new_vals
                cols[name] = col
            applied += int(rows.size)
        self.delta_rows_total += applied
        return applied


class SessionStore:
    """LRU + TTL registry of :class:`SolveSession`. ``on_evict(session,
    reason)`` runs on every let-go (lru, ttl, drop, replace, pressure,
    migrate), after ``evicted`` is set and under this store's lock: it may
    take only leaf locks and never call back into a store."""

    def __init__(self, max_sessions: int = 8, ttl_s: float = 900.0, on_evict=None):
        self.max_sessions = max_sessions
        self.ttl_s = ttl_s
        self._lock = threading.Lock()
        self._sessions: OrderedDict[str, SolveSession] = OrderedDict()
        self.evictions = 0
        self.expirations = 0
        self._on_evict = on_evict

    def _let_go_locked(self, session: SolveSession, reason: str) -> None:
        session.evicted = True
        _tracer.point("session.evict", session=session.session_id, reason=reason)
        if self._on_evict is not None:
            self._on_evict(session, reason)

    def _expire_locked(self) -> None:
        now = time.monotonic()
        dead = [sid for sid, s in self._sessions.items() if now - s.last_used > self.ttl_s]
        for sid in dead:
            s = self._sessions.pop(sid)
            self.expirations += 1
            self._let_go_locked(s, "ttl")

    def sweep(self) -> int:
        """Expire the idle sessions now; returns how many."""
        with self._lock:
            before = self.expirations
            self._expire_locked()
            return self.expirations - before

    def put(self, session: SolveSession) -> None:
        with self._lock:
            self._expire_locked()
            replaced = self._sessions.pop(session.session_id, None)
            if replaced is not None:
                self._let_go_locked(replaced, "replace")
            self._sessions[session.session_id] = session
            while len(self._sessions) > self.max_sessions:
                _sid, lru = self._sessions.popitem(last=False)
                self.evictions += 1
                self._let_go_locked(lru, "lru")

    def get(self, session_id: str, fingerprint: str) -> tuple[Optional[SolveSession], str]:
        """The session of a delta tick: (session, "") or (None, reason), the
        reason wire-safe text the client logs."""
        with _tracer.span("session.lookup", session=session_id):
            with self._lock:
                self._expire_locked()
                s = self._sessions.get(session_id)
                if s is None:
                    return None, "unknown session"
                if s.fingerprint != fingerprint:
                    return None, "epoch fingerprint mismatch"
                self._sessions.move_to_end(session_id)
                s.last_used = time.monotonic()
                return s, ""

    def drop(self, session_id: str) -> None:
        with self._lock:
            dropped = self._sessions.pop(session_id, None)
            if dropped is not None:
                self._let_go_locked(dropped, "drop")

    def evict(self, session_id: str, reason: str = "pressure") -> bool:
        """Let one session go (an in-flight delta on it then refuses); False
        if it was already gone."""
        with self._lock:
            s = self._sessions.pop(session_id, None)
            if s is None:
                return False
            self.evictions += 1
            self._let_go_locked(s, reason)
            return True

    def lru_candidate(self, exclude=(), tenant=None):
        """(session_id, last_used) of the least recently used session
        outside ``exclude`` (of ``tenant`` only, when given), or None."""
        with self._lock:
            for sid, s in self._sessions.items():
                if sid in exclude:
                    continue
                if tenant is not None and tenant_of(sid) != tenant:
                    continue
                return sid, s.last_used
        return None

    def snapshot_sessions(self) -> list:
        """The live sessions now (the drain's and the migration's walk; each
        is then locked on its own, never under the store's lock)."""
        with self._lock:
            return list(self._sessions.values())

    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)


def tenant_of(session_id: str) -> str:
    """Tenant key of a session id: the prefix before ``@``
    (``protocol_tpu/obs/metrics.py:158``)."""
    head, sep, _ = (session_id or "").partition("@")
    return head if sep else (session_id or "unknown")
