"""Orchestrator node store
(``protocol_tpu/store/domains/node_store.py``, copied).

Reference: crates/orchestrator/src/store/domains/node_store.rs (hash per node
``orchestrator:node:{addr}`` + index set) and crates/orchestrator/src/models/
node.rs (OrchestratorNode, 8-state NodeStatus enum :74-85).
"""

from __future__ import annotations

import enum
import json
import time
from dataclasses import dataclass, field
from typing import Optional

from protocol_tpu_torch.models.node import ComputeSpecs, NodeLocation
from protocol_tpu_torch.models.task import TaskState
from protocol_tpu_torch.store.kv import KVStore

NODE_KEY = "orchestrator:node:{}"
NODE_INDEX = "orchestrator:nodes"


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
    # utilization 0..1 (from heartbeats — external to this pool's own
    # assignment, so the load term cannot feed back into the solve)
    price: Optional[float] = None
    load: float = 0.0

    def to_dict(self) -> dict:
        d: dict = {
            "address": self.address,
            "ip_address": self.ip_address,
            "port": self.port,
            "status": self.status.value,
            "first_seen": self.first_seen,
        }
        if self.task_id is not None:
            d["task_id"] = self.task_id
        if self.task_state is not None:
            d["task_state"] = self.task_state.value
        if self.version is not None:
            d["version"] = self.version
        if self.p2p_id is not None:
            d["p2p_id"] = self.p2p_id
        if self.p2p_addresses is not None:
            d["p2p_addresses"] = self.p2p_addresses
        if self.compute_specs is not None:
            d["compute_specs"] = self.compute_specs.to_dict()
        if self.location is not None:
            d["location"] = self.location.to_dict()
        if self.last_status_change is not None:
            d["last_status_change"] = self.last_status_change
        if self.price is not None:
            d["price"] = self.price
        if self.load:
            d["load"] = self.load
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "OrchestratorNode":
        return cls(
            address=d["address"],
            ip_address=d.get("ip_address", ""),
            port=int(d.get("port", 0)),
            status=NodeStatus.parse(d.get("status", "Discovered")),
            task_id=d.get("task_id"),
            task_state=TaskState.parse(d["task_state"]) if d.get("task_state") else None,
            version=d.get("version"),
            p2p_id=d.get("p2p_id"),
            p2p_addresses=d.get("p2p_addresses"),
            compute_specs=ComputeSpecs.from_dict(d["compute_specs"])
            if d.get("compute_specs")
            else None,
            location=NodeLocation.from_dict(d["location"]) if d.get("location") else None,
            first_seen=float(d.get("first_seen", 0.0)),
            last_status_change=d.get("last_status_change"),
            price=float(d["price"]) if d.get("price") is not None else None,
            load=float(d.get("load", 0.0)),
        )


class NodeStore:
    def __init__(self, kv: KVStore):
        self.kv = kv

    def add_node(self, node: OrchestratorNode) -> None:
        with self.kv.atomic():
            self.kv.set(NODE_KEY.format(node.address), json.dumps(node.to_dict()))
            self.kv.sadd(NODE_INDEX, node.address)

    def get_node(self, address: str) -> Optional[OrchestratorNode]:
        raw = self.kv.get(NODE_KEY.format(address))
        return OrchestratorNode.from_dict(json.loads(raw)) if raw else None

    def get_nodes(self) -> list[OrchestratorNode]:
        addrs = sorted(self.kv.smembers(NODE_INDEX))
        raws = self.kv.mget(NODE_KEY.format(a) for a in addrs)
        return [OrchestratorNode.from_dict(json.loads(r)) for r in raws if r]

    def remove_node(self, address: str) -> None:
        with self.kv.atomic():
            self.kv.delete(NODE_KEY.format(address))
            self.kv.srem(NODE_INDEX, address)

    def update_node(self, node: OrchestratorNode) -> None:
        self.add_node(node)

    def update_node_status(self, address: str, status: NodeStatus) -> None:
        """Status transition, stamping last_status_change (reference
        node_store.rs update path)."""
        with self.kv.atomic():
            node = self.get_node(address)
            if node is None:
                return
            if node.status != status:
                node.status = status
                node.last_status_change = time.time()
                self.add_node(node)

    def update_node_task(
        self,
        address: str,
        task_id: Optional[str],
        task_state: Optional[TaskState],
    ) -> None:
        with self.kv.atomic():
            node = self.get_node(address)
            if node is None:
                return
            node.task_id = task_id
            node.task_state = task_state
            self.add_node(node)

    def update_node_p2p(
        self, address: str, p2p_id: Optional[str], p2p_addresses: Optional[list[str]]
    ) -> None:
        with self.kv.atomic():
            node = self.get_node(address)
            if node is None:
                return
            node.p2p_id = p2p_id
            node.p2p_addresses = p2p_addresses
            self.add_node(node)

    def get_uninvited_nodes(self) -> list[OrchestratorNode]:
        """Nodes awaiting an invite (reference node/invite.rs: Discovered)."""
        return [n for n in self.get_nodes() if n.status == NodeStatus.DISCOVERED]
