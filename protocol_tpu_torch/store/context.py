"""StoreContext: the bundle of domain stores each service holds
(``protocol_tpu/store/context.py``, copied).

Reference: crates/orchestrator/src/store/core/context.rs. ``new_test()``
mirrors the reference's embedded-redis fixture — a fresh hermetic store per
test (orchestrator/src/store/core/redis.rs:38-72).
"""

from __future__ import annotations

from protocol_tpu_torch.store.kv import KVStore
from protocol_tpu_torch.store.domains.heartbeat_store import HeartbeatStore
from protocol_tpu_torch.store.domains.metrics_store import MetricsStore
from protocol_tpu_torch.store.domains.node_store import NodeStore
from protocol_tpu_torch.store.domains.task_store import TaskStore


class StoreContext:
    def __init__(self, kv: KVStore | None = None, heartbeat_ttl: float = 90.0):
        self.kv = kv or KVStore()
        self.node_store = NodeStore(self.kv)
        self.task_store = TaskStore(self.kv)
        self.heartbeat_store = HeartbeatStore(self.kv, ttl_seconds=heartbeat_ttl)
        self.metrics_store = MetricsStore(self.kv)

    @classmethod
    def new_test(cls, heartbeat_ttl: float = 90.0) -> "StoreContext":
        return cls(KVStore(), heartbeat_ttl=heartbeat_ttl)
