"""The orchestrator's node record, copied from
``protocol_tpu/store/domains/node_store.py``: ``NodeStatus`` (:24, a
``str`` enum of the reference's 8 health states) and the
``OrchestratorNode`` dataclass (:45). The KV-backed store is left out: the
matcher reads any store duck-typed, through ``store.node_store.get_nodes()``
and ``store.task_store.get_all_tasks()`` / ``get_task(id)``.
"""

from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Optional

from protocol_tpu_torch.models.node import ComputeSpecs, NodeLocation
from protocol_tpu_torch.models.task import TaskState


class NodeStatus(str, enum.Enum):
    """Health FSM states (reference orchestrator/src/models/node.rs:74-85)."""

    DISCOVERED = "Discovered"
    WAITING_FOR_HEARTBEAT = "WaitingForHeartbeat"
    HEALTHY = "Healthy"
    UNHEALTHY = "Unhealthy"
    DEAD = "Dead"
    EJECTED = "Ejected"
    BANNED = "Banned"
    LOW_BALANCE = "LowBalance"

    @classmethod
    def parse(cls, s: str) -> "NodeStatus":
        for m in cls:
            if m.value == s:
                return m
        return cls.DISCOVERED


@dataclass
class OrchestratorNode:
    address: str
    ip_address: str = ""
    port: int = 0
    status: NodeStatus = NodeStatus.DISCOVERED
    task_id: Optional[str] = None
    task_state: Optional[TaskState] = None
    version: Optional[str] = None
    p2p_id: Optional[str] = None
    p2p_addresses: Optional[list[str]] = None
    compute_specs: Optional[ComputeSpecs] = None
    location: Optional[NodeLocation] = None
    first_seen: float = field(default_factory=time.time)
    last_status_change: Optional[float] = None
    # marketplace inputs to the batch matcher's cost terms: the provider's
    # advertised ask price (from discovery) and its self-reported host
    # utilization 0..1 (from heartbeats)
    price: Optional[float] = None
    load: float = 0.0
