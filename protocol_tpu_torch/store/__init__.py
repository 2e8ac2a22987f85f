"""The state store (``protocol_tpu/store``, copied): the in-process KV
store with its journal (:mod:`.kv`), the domain stores over its schema
(nodes, tasks with observer hooks, heartbeats with TTLs and unhealthy
counters, metrics; :mod:`.domains`) and the :class:`StoreContext` bundling
them. The remote KV client (``store/remote_kv.py``) is ROADMAP queue A,
M4c."""

from protocol_tpu_torch.store.context import StoreContext
from protocol_tpu_torch.store.domains.heartbeat_store import HeartbeatStore
from protocol_tpu_torch.store.domains.metrics_store import MetricsStore
from protocol_tpu_torch.store.domains.node_store import NodeStatus, NodeStore, OrchestratorNode
from protocol_tpu_torch.store.domains.task_store import TaskStore
from protocol_tpu_torch.store.kv import KVStore

__all__ = [
    "HeartbeatStore",
    "KVStore",
    "MetricsStore",
    "NodeStatus",
    "NodeStore",
    "OrchestratorNode",
    "StoreContext",
    "TaskStore",
]
