"""Deterministic-safe structured span tracer (``protocol_tpu/obs/spans.py``,
copied; its lock is a plain ``threading.Lock``).

A span is one timed region of the seam — candidate generation, an engine
solve, a wire encode/decode, a session-store lookup, a thread-budget
grant — recorded as a plain dict into a bounded ring buffer:

    {"name", "trace", "span", "parent", "t0_ns", "dur_ns", "attrs"}

Design constraints (the determinism lint's world view):

  * **Monotonic clock only** (``time.perf_counter_ns``): span timings
    ride NEXT TO results, never into them, and no wall-clock read ever
    happens on a solver path.
  * **Explicit IDs**: span ids come from a process-local counter and the
    trace id is ``<pid hex>.<root span id>`` — no randomness, no UUIDs,
    so two captures of the same workload produce structurally identical
    traces (timings differ, ids and nesting do not).
  * **Bounded memory**: the ring keeps the last ``capacity`` completed
    spans; producers never block and never allocate per-span beyond one
    small dict.

Nesting is thread-local (each thread has its own open-span stack), and
causality crosses the gRPC seam via one metadata header
(``x-pt-span: <trace>/<span id>``): the client injects its current
context, the servicer adopts it as the remote parent of its RPC root
span, and a client tick stitches into one causal trace across
processes. Cross-thread handoff inside a process works the same way —
pass ``header()`` and open the child with ``remote_parent=``.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Iterable, Optional

# gRPC metadata key (must be lowercase per the gRPC metadata contract)
METADATA_KEY = "x-pt-span"


class SpanTracer:
    """Ring-buffered span recorder. Thread-safe; cheap when disabled
    (one attribute check, no lock)."""

    def __init__(self, capacity: int = 4096, enabled: bool = True):
        self.enabled = enabled
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._next_id = 1
        self._seq = 0  # completed spans ever (ring-overflow-proof cursor)
        self._tls = threading.local()

    # ---------------- internals ----------------

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _alloc_id(self) -> int:
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            return sid

    def _record(self, rec: dict) -> None:
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            self._ring.append(rec)

    # ---------------- the span API ----------------

    @contextmanager
    def span(self, name: str, remote_parent: Optional[str] = None, **attrs):
        """Open a nested span. ``remote_parent`` is a ``header()`` string
        from another thread/process (wins over the thread-local stack —
        it's how the servicer adopts the client's context). Yields the
        open frame dict (callers may add attrs before exit)."""
        if not self.enabled:
            yield None
            return
        t0 = time.perf_counter_ns()
        stack = self._stack()
        trace = parent = None
        if remote_parent:
            trace, _, pspan = remote_parent.partition("/")
            try:
                parent = int(pspan)
            except ValueError:
                trace = parent = None
        if trace is None and stack:
            trace = stack[-1]["trace"]
            parent = stack[-1]["span"]
        sid = self._alloc_id()
        if trace is None:
            trace = f"{os.getpid():x}.{sid}"
        frame = {
            "name": name, "trace": trace, "span": sid,
            "parent": parent, "t0_ns": t0, "attrs": dict(attrs),
        }
        stack.append(frame)
        try:
            yield frame
        finally:
            t1 = time.perf_counter_ns()
            # pop by identity: a mismatched exit (generator abandoned
            # mid-span) must not corrupt an unrelated frame
            if stack and stack[-1] is frame:
                stack.pop()
            elif frame in stack:  # pragma: no cover - defensive
                stack.remove(frame)
            frame["dur_ns"] = t1 - t0
            self._record(frame)

    def record_span(
        self, name: str, t0_ns: int, dur_ns: int, **attrs
    ) -> None:
        """Record an ALREADY-TIMED region as a completed span, parented
        to the current thread's innermost open span. For callers whose
        region boundaries don't nest cleanly inside a ``with`` block
        (the arena's warm candidate-maintenance sweep)."""
        if not self.enabled:
            return
        stack = self._stack()
        trace = stack[-1]["trace"] if stack else None
        parent = stack[-1]["span"] if stack else None
        sid = self._alloc_id()
        self._record({
            "name": name, "trace": trace or f"{os.getpid():x}.{sid}",
            "span": sid, "parent": parent, "t0_ns": int(t0_ns),
            "dur_ns": int(dur_ns), "attrs": dict(attrs),
        })

    def point(self, name: str, **attrs) -> None:
        """Zero-duration event span (evictions, refusals, grants)."""
        if not self.enabled:
            return
        stack = self._stack()
        trace = stack[-1]["trace"] if stack else None
        parent = stack[-1]["span"] if stack else None
        sid = self._alloc_id()
        self._record({
            "name": name, "trace": trace or f"{os.getpid():x}.{sid}",
            "span": sid, "parent": parent,
            "t0_ns": time.perf_counter_ns(), "dur_ns": 0,
            "attrs": dict(attrs),
        })

    # ---------------- propagation ----------------

    def header(self) -> str:
        """``<trace>/<span>`` of the current thread's innermost open
        span, or "" when none is open (callers skip injection then)."""
        stack = self._stack()
        if not stack:
            return ""
        top = stack[-1]
        return f"{top['trace']}/{top['span']}"

    def inject(self, metadata=None) -> Optional[list]:
        """Append the propagation header to a gRPC metadata list.
        Returns the (possibly new) list, or the input unchanged when no
        span is open / tracing is off."""
        if not self.enabled:
            return metadata
        h = self.header()
        if not h:
            return metadata
        md = list(metadata or [])
        md.append((METADATA_KEY, h))
        return md

    @staticmethod
    def extract(metadata: Optional[Iterable]) -> Optional[str]:
        """Pull the propagation header out of gRPC invocation metadata
        (an iterable of (key, value) pairs); None when absent."""
        if metadata is None:
            return None
        for k, v in metadata:
            if k == METADATA_KEY:
                return v
        return None

    # ---------------- consumption ----------------

    def mark(self) -> int:
        """Cursor for :meth:`since` (count of spans completed so far)."""
        with self._lock:
            return self._seq

    def since(self, mark: int, trace: Optional[str] = None) -> list[dict]:
        """Completed spans with seq > ``mark`` (oldest first), optionally
        filtered to one trace id. Spans evicted by ring overflow between
        mark and now are gone — callers get what survived."""
        with self._lock:
            out = [r for r in self._ring if r["seq"] > mark]
        if trace is not None:
            out = [r for r in out if r["trace"] == trace]
        return out

    def drain(self) -> list[dict]:
        """Return and clear every buffered completed span."""
        with self._lock:
            out = list(self._ring)
            self._ring.clear()
        return out

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._ring)


# One process-global tracer: every seam layer (matcher, arena, servicer,
# client, replay) records into the same ring, and loopback tests see
# client + server spans side by side. Cross-process stitching happens
# through the metadata header + trace ids persisted in OUTCOME frames.
# The PROTOCOL_TPU_OBS flag has ONE owner — protocol_tpu_torch.obs.__init__
# parses it and sets TRACER.enabled (the package __init__ always runs
# before this module is reachable).
TRACER = SpanTracer(enabled=True)


def tracer() -> SpanTracer:
    return TRACER


def span_dicts_compact(spans: list[dict]) -> list[dict]:
    """Wire/trace-frame form of a span list: drop the ring-cursor seq and
    round timings to µs so OUTCOME frames stay small."""
    out = []
    for s in spans:
        d = {
            "name": s["name"], "trace": s["trace"], "span": s["span"],
            "parent": s["parent"], "us": round(s["dur_ns"] / 1e3, 1),
        }
        if s.get("attrs"):
            d["attrs"] = s["attrs"]
        out.append(d)
    return out
