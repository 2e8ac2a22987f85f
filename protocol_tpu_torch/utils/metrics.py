"""Prometheus registries of the port (``protocol_tpu/utils/metrics.py``,
copied): the orchestrator's metric families (:class:`OrchestratorMetrics`,
``:50``) and the scheduler seam's per-phase instrumentation
(:class:`SeamMetrics`, ``:227``).

``SeamMetrics``' plain-dict mirror is authoritative (what rides in
``HealthResponse.seam_metrics``); a prometheus registry is kept beside it
when ``prometheus_client`` is installed, and left out when it is not. The
orchestrator's registry needs the package: without it the module imports
and ``OrchestratorMetrics`` raises at construction, as the reference's
does.
"""

from __future__ import annotations

import threading

try:
    from prometheus_client import CollectorRegistry, Counter, Gauge, Histogram, generate_latest
except ImportError:  # the seam stays measurable without it
    CollectorRegistry = Counter = Gauge = Histogram = generate_latest = None

_STATUS_BUCKETS = [
    0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 15.0, 30.0, 45.0,
    60.0, 90.0, 120.0,
]
_SOLVE_BUCKETS = [
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
]


class OrchestratorMetrics:
    """metrics/mod.rs:6-126 families on a private registry."""

    def __init__(self, pool_id: int):
        if CollectorRegistry is None:
            raise ImportError("prometheus_client is not installed: the orchestrator's "
                              "registry needs it")
        self.pool_id = str(pool_id)
        self.registry = CollectorRegistry()
        r = self.registry
        self.compute_task_gauges = Gauge(
            "compute_gauges",
            "Compute task gauge metrics",
            ["node_address", "task_id", "task_name", "label", "pool_id",
             "group_id", "group_config_name"],
            registry=r,
        )
        self.task_info = Gauge(
            "task_info",
            "Task information with metadata",
            ["task_id", "task_name", "pool_id", "metadata"],
            registry=r,
        )
        self.file_upload_requests_total = Counter(
            "orchestrator_file_upload_requests",
            "Total number of file upload requests",
            ["task_id", "task_name", "node_address", "pool_id"],
            registry=r,
        )
        self.nodes_total = Gauge(
            "orchestrator_nodes_total",
            "Total number of nodes by status",
            ["status", "pool_id"],
            registry=r,
        )
        self.tasks_total = Gauge(
            "orchestrator_tasks_total",
            "Total number of tasks",
            ["pool_id"],
            registry=r,
        )
        self.groups_total = Gauge(
            "orchestrator_groups_total",
            "Total number of node groups by configuration",
            ["configuration_name", "pool_id"],
            registry=r,
        )
        self.heartbeat_requests_total = Counter(
            "orchestrator_heartbeat_requests",
            "Total number of heartbeat requests per node",
            ["node_address", "pool_id"],
            registry=r,
        )
        self.nodes_per_task = Gauge(
            "orchestrator_nodes_per_task",
            "Number of nodes actively working on each task",
            ["task_id", "task_name", "pool_id"],
            registry=r,
        )
        self.task_state = Gauge(
            "orchestrator_task_state",
            "Task state reported from nodes (1 active, 0 inactive)",
            ["node_address", "task_id", "task_state", "pool_id"],
            registry=r,
        )
        self.status_update_execution_time = Histogram(
            "orchestrator_status_update_execution_time_seconds",
            "Duration of status update execution",
            ["pool_id"],
            buckets=_STATUS_BUCKETS,
            registry=r,
        )
        # framework addition: the on-device matcher's solve cost
        self.solve_duration = Histogram(
            "orchestrator_scheduler_solve_duration_seconds",
            "Duration of batch matcher solves",
            ["backend", "pool_id"],
            buckets=_SOLVE_BUCKETS,
            registry=r,
        )

    def record_heartbeat(self, node_address: str) -> None:
        self.heartbeat_requests_total.labels(
            node_address=node_address, pool_id=self.pool_id
        ).inc()

    def record_upload_request(
        self, node_address: str, task_id: str, task_name: str
    ) -> None:
        self.file_upload_requests_total.labels(
            task_id=task_id or "",
            task_name=task_name or "",
            node_address=node_address,
            pool_id=self.pool_id,
        ).inc()

    def sync(self, store) -> None:
        """Store -> registry rebuild (sync_service.rs:37-180), run at
        scrape time instead of on a 10 s loop. Without node groups
        (ROADMAP queue A, M3) the group gauge stays empty and no workload
        gauge names a group."""
        pid = self.pool_id
        self.nodes_total.clear()
        by_status: dict[str, int] = {}
        nodes = store.node_store.get_nodes()
        for n in nodes:
            by_status[n.status.value] = by_status.get(n.status.value, 0) + 1
        for status, count in by_status.items():
            self.nodes_total.labels(status=status, pool_id=pid).set(count)

        tasks = store.task_store.get_all_tasks()
        self.tasks_total.clear()
        self.tasks_total.labels(pool_id=pid).set(len(tasks))
        names = {t.id: t.name for t in tasks}
        self.task_info.clear()
        for t in tasks:
            self.task_info.labels(
                task_id=t.id, task_name=t.name, pool_id=pid, metadata=""
            ).set(1)

        self.groups_total.clear()

        # per-node task state + nodes-per-task from live heartbeats
        self.task_state.clear()
        self.nodes_per_task.clear()
        per_task: dict[str, int] = {}
        for n in nodes:
            hb = store.heartbeat_store.get_heartbeat(n.address)
            if hb is None or not hb.task_id:
                continue
            per_task[hb.task_id] = per_task.get(hb.task_id, 0) + 1
            self.task_state.labels(
                node_address=n.address,
                task_id=hb.task_id,
                task_state=hb.task_state or "UNKNOWN",
                pool_id=pid,
            ).set(1)
        for task_id, count in per_task.items():
            self.nodes_per_task.labels(
                task_id=task_id, task_name=names.get(task_id, ""), pool_id=pid
            ).set(count)

        # workload metrics (container -> bridge -> heartbeat -> store)
        self.compute_task_gauges.clear()
        for task_id, labels in store.metrics_store.get_all_metrics().items():
            for label, per_node in labels.items():
                for node_addr, value in per_node.items():
                    self.compute_task_gauges.labels(
                        node_address=node_addr,
                        task_id=task_id,
                        task_name=names.get(task_id, ""),
                        label=label,
                        pool_id=pid,
                        group_id="",
                        group_config_name="",
                    ).set(value)

    def render(self) -> bytes:
        return generate_latest(self.registry)


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
