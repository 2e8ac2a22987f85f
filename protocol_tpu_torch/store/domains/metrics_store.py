"""Metrics store: per (task, label) hashes of node -> value
(``protocol_tpu/store/domains/metrics_store.py``, copied).

Reference: crates/orchestrator/src/store/domains/metrics_store.rs. Metrics
flow worker TaskBridge -> heartbeat -> here -> Prometheus sync.
"""

from __future__ import annotations

from protocol_tpu_torch.models.metric import MetricEntry
from protocol_tpu_torch.store.kv import KVStore

METRIC_KEY = "orchestrator:metrics:{}:{}"  # task_id, label
METRIC_INDEX = "orchestrator:metrics_keys"


class MetricsStore:
    def __init__(self, kv: KVStore):
        self.kv = kv

    def store_metrics(self, entries: list[MetricEntry], node_address: str) -> None:
        # one pipelined batch: N metric entries cost one round trip on a
        # remote store instead of a lock + 2N calls
        ops = []
        for e in entries:
            key = METRIC_KEY.format(e.key.task_id, e.key.label)
            ops.append(("hset", [key, node_address, repr(e.value)], {}))
            ops.append(
                ("sadd", [METRIC_INDEX, f"{e.key.task_id}\x00{e.key.label}"], {})
            )
        if ops:
            self.kv.pipeline_execute(ops)

    def get_metrics_for_task(self, task_id: str) -> dict[str, dict[str, float]]:
        """label -> {node -> value}"""
        out: dict[str, dict[str, float]] = {}
        for entry in self.kv.smembers(METRIC_INDEX):
            tid, label = entry.split("\x00", 1)
            if tid != task_id:
                continue
            vals = self.kv.hgetall(METRIC_KEY.format(tid, label))
            out[label] = {n: float(v) for n, v in vals.items()}
        return out

    def get_all_metrics(self) -> dict[str, dict[str, dict[str, float]]]:
        """task_id -> label -> {node -> value}"""
        out: dict[str, dict[str, dict[str, float]]] = {}
        for entry in self.kv.smembers(METRIC_INDEX):
            tid, label = entry.split("\x00", 1)
            vals = self.kv.hgetall(METRIC_KEY.format(tid, label))
            out.setdefault(tid, {})[label] = {n: float(v) for n, v in vals.items()}
        return out

    def delete_metrics_for_node(self, node_address: str) -> None:
        """Purge a dead/ejected/banned node's metrics
        (status_update/mod.rs:314-350)."""
        with self.kv.atomic():
            for entry in list(self.kv.smembers(METRIC_INDEX)):
                tid, label = entry.split("\x00", 1)
                key = METRIC_KEY.format(tid, label)
                self.kv.hdel(key, node_address)
                if not self.kv.hgetall(key):
                    self.kv.srem(METRIC_INDEX, entry)

    def delete_metrics_for_task(self, task_id: str) -> None:
        with self.kv.atomic():
            for entry in list(self.kv.smembers(METRIC_INDEX)):
                tid, label = entry.split("\x00", 1)
                if tid == task_id:
                    self.kv.delete(METRIC_KEY.format(tid, label))
                    self.kv.srem(METRIC_INDEX, entry)
