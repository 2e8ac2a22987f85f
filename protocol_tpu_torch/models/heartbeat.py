"""Heartbeat payloads (reference: crates/shared/src/models/heartbeat.rs;
``protocol_tpu/models/heartbeat.py``, copied)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from protocol_tpu_torch.models.task import TaskState


@dataclass
class TaskDetails:
    """Container/runtime details reported alongside a heartbeat
    (heartbeat.rs:24-31)."""

    container_id: Optional[str] = None
    container_status: Optional[str] = None
    exit_code: Optional[int] = None
    error_message: Optional[str] = None

    def to_dict(self) -> dict:
        return {
            "container_id": self.container_id,
            "container_status": self.container_status,
            "exit_code": self.exit_code,
            "error_message": self.error_message,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TaskDetails":
        return cls(
            container_id=d.get("container_id"),
            container_status=d.get("container_status"),
            exit_code=d.get("exit_code"),
            error_message=d.get("error_message"),
        )


@dataclass
class HeartbeatRequest:
    """Worker -> orchestrator heartbeat body (heartbeat.rs:33-46)."""

    address: str = ""
    task_id: Optional[str] = None
    task_state: Optional[str] = None
    metrics: Optional[list[dict]] = None
    version: Optional[str] = None
    timestamp: Optional[float] = None
    p2p_id: Optional[str] = None
    p2p_addresses: Optional[list[str]] = None
    task_details: Optional[TaskDetails] = None
    # worker-reported host utilization 0..1 (external to this pool's own
    # assignment so the matcher's load term cannot feed back into itself)
    load: Optional[float] = None
    # colocated extras (ladder #5): {task_id: state} for every assigned
    # task running CONCURRENTLY beyond the primary current_task
    extra_task_states: Optional[dict] = None

    def task_state_enum(self) -> Optional[TaskState]:
        return TaskState.parse(self.task_state) if self.task_state else None

    def to_dict(self) -> dict:
        d: dict = {"address": self.address}
        for k in ("task_id", "task_state", "metrics", "version", "timestamp", "p2p_id", "p2p_addresses", "load", "extra_task_states"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        if self.task_details is not None:
            d["task_details"] = self.task_details.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "HeartbeatRequest":
        return cls(
            address=d.get("address", ""),
            task_id=d.get("task_id"),
            task_state=d.get("task_state"),
            metrics=d.get("metrics"),
            version=d.get("version"),
            timestamp=d.get("timestamp"),
            p2p_id=d.get("p2p_id"),
            p2p_addresses=d.get("p2p_addresses"),
            task_details=TaskDetails.from_dict(d["task_details"])
            if d.get("task_details")
            else None,
            load=float(d["load"]) if d.get("load") is not None else None,
            extra_task_states=d.get("extra_task_states"),
        )
