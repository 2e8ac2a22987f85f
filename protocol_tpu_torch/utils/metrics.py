"""Per-phase instrumentation of the scheduler seam
(``protocol_tpu/utils/metrics.py:227 SeamMetrics``, copied).

The plain-dict mirror is authoritative (what rides in
``HealthResponse.seam_metrics``); a prometheus registry is kept beside it
when ``prometheus_client`` is installed, and left out when it is not.
"""

from __future__ import annotations

import threading

try:
    from prometheus_client import CollectorRegistry, Counter, Histogram, generate_latest
except ImportError:  # the seam stays measurable without it
    CollectorRegistry = Counter = Histogram = generate_latest = None

_WIRE_MS_BUCKETS = [
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
    500.0, 1000.0, 2500.0,
]


class SeamMetrics:
    """Phases ``serialize`` (client-side pack), ``decode`` (server-side
    unpack), ``solve`` (kernel), ``rpc`` (client-observed round trip) as
    millisecond sums and counts; bytes per direction; event counters
    (``admission_refused``, ``deadline_refused``, ...)."""

    def __init__(self, role: str = "server"):
        self.role = role
        self._lock = threading.Lock()
        self._ms_sum: dict[str, float] = {}
        self._ms_count: dict[str, int] = {}
        self._bytes: dict[str, int] = {}
        self._events: dict[str, int] = {}
        self.registry = None
        if CollectorRegistry is not None:
            self.registry = CollectorRegistry()
            self._h_phase = Histogram(
                "scheduler_seam_phase_ms", "Wire-seam per-phase latency (ms)",
                ["role", "phase"], buckets=_WIRE_MS_BUCKETS, registry=self.registry,
            )
            self._c_bytes = Counter(
                "scheduler_seam_wire_bytes", "Wire bytes through the scheduler seam",
                ["role", "direction"], registry=self.registry,
            )
            self._c_events = Counter(
                "scheduler_seam_session_events", "Session-protocol events at the scheduler seam",
                ["role", "event"], registry=self.registry,
            )

    def observe_ms(self, phase: str, ms: float) -> None:
        with self._lock:
            self._ms_sum[phase] = self._ms_sum.get(phase, 0.0) + float(ms)
            self._ms_count[phase] = self._ms_count.get(phase, 0) + 1
        if self.registry is not None:
            self._h_phase.labels(role=self.role, phase=phase).observe(ms)

    def add_bytes(self, direction: str, n: int) -> None:
        with self._lock:
            self._bytes[direction] = self._bytes.get(direction, 0) + int(n)
        if self.registry is not None:
            self._c_bytes.labels(role=self.role, direction=direction).inc(n)

    def count(self, event: str, n: int = 1) -> None:
        with self._lock:
            self._events[event] = self._events.get(event, 0) + int(n)
        if self.registry is not None:
            self._c_events.labels(role=self.role, event=event).inc(n)

    def snapshot(self) -> dict[str, float]:
        """Flat name->value view: ``<phase>_ms_sum`` / ``<phase>_count``,
        ``bytes_<direction>``, ``session_<event>``."""
        with self._lock:
            out: dict[str, float] = {}
            for phase, s in self._ms_sum.items():
                out[f"{phase}_ms_sum"] = round(s, 3)
                out[f"{phase}_count"] = float(self._ms_count[phase])
            for direction, n in self._bytes.items():
                out[f"bytes_{direction}"] = float(n)
            for event, n in self._events.items():
                out[f"session_{event}"] = float(n)
            return out

    def render(self) -> bytes:
        """The prometheus text of the registry (empty without one)."""
        return b"" if self.registry is None else generate_latest(self.registry)
