"""Task model, the part of ``protocol_tpu/models/task.py`` the batch
matcher and the scheduler read: ``TaskState`` (:28), ``SchedulingConfig``
(:47), ``VolumeMount`` (:67, its label expansion), ``_validate_tpu_
scheduler_plugin`` (:136) and ``Task`` (:213) with its id, creation time,
scheduling config, ``allowed_topologies()`` and the fields the scheduler
expands per node (env vars, cmd, entrypoint, volume mounts). The storage
config, metadata and the config hash are left out.
"""

from __future__ import annotations

import enum
import time
import uuid
from dataclasses import dataclass, field
from typing import Optional

from protocol_tpu_torch.models.node import ComputeRequirements


class TaskState(str, enum.Enum):
    PENDING = "PENDING"
    PULLING = "PULLING"
    RUNNING = "RUNNING"
    COMPLETED = "COMPLETED"
    FAILED = "FAILED"
    PAUSED = "PAUSED"
    RESTARTING = "RESTARTING"
    UNKNOWN = "UNKNOWN"

    @classmethod
    def parse(cls, s: str) -> "TaskState":
        try:
            return cls(s)
        except ValueError:
            return cls.UNKNOWN


@dataclass
class SchedulingConfig:
    """Free-form plugin config map (task.rs:58-61); the node-groups plugin
    reads ``plugins["node_groups"]["allowed_topologies"]``."""

    plugins: Optional[dict[str, dict[str, list[str]]]] = None

    def allowed_topologies(self) -> list[str]:
        if not self.plugins:
            return []
        return list(self.plugins.get("node_groups", {}).get("allowed_topologies", []))


@dataclass
class VolumeMount:
    host_path: str
    container_path: str

    def replace_labels(self, task_id: str, node_address: Optional[str] = None) -> "VolumeMount":
        """``${TASK_ID}``, ``${NODE_ADDRESS}`` and ``${TIMESTAMP}`` expanded in
        both paths."""
        host_path = self.host_path.replace("${TASK_ID}", task_id)
        container_path = self.container_path.replace("${TASK_ID}", task_id)
        if node_address is not None:
            host_path = host_path.replace("${NODE_ADDRESS}", node_address)
            container_path = container_path.replace("${NODE_ADDRESS}", node_address)
        ts = str(int(time.time()))
        host_path = host_path.replace("${TIMESTAMP}", ts)
        container_path = container_path.replace("${TIMESTAMP}", ts)
        return VolumeMount(host_path=host_path, container_path=container_path)


def _validate_tpu_scheduler_plugin(cfg: SchedulingConfig) -> None:
    """Malformed tpu_scheduler plugin config must be rejected at task
    creation — the batch matcher consumes these strings on its hot path."""
    if not cfg.plugins:
        return
    plug = cfg.plugins.get("tpu_scheduler")
    if not plug:
        return
    reps = plug.get("replicas")
    if reps:
        if not isinstance(reps[0], (str, int)):
            raise ValueError(f"invalid tpu_scheduler replicas: {reps[0]!r}")
        try:
            r = int(reps[0])
        except ValueError:
            raise ValueError(f"invalid tpu_scheduler replicas: {reps[0]!r}") from None
        if r <= 0:
            raise ValueError(f"tpu_scheduler replicas must be positive, got {r}")
    reqs = plug.get("compute_requirements")
    if reqs:
        if not isinstance(reqs[0], str):
            raise ValueError(
                f"invalid tpu_scheduler compute_requirements: {reqs[0]!r}"
            )
        ComputeRequirements.parse(reqs[0])


@dataclass
class Task:
    name: str = ""
    id: str = field(default_factory=lambda: str(uuid.uuid4()))
    image: str = ""
    env_vars: Optional[dict[str, str]] = None
    cmd: Optional[list[str]] = None
    entrypoint: Optional[list[str]] = None
    state: TaskState = TaskState.UNKNOWN
    created_at: int = 0  # ms since epoch
    scheduling_config: Optional[SchedulingConfig] = None
    volume_mounts: Optional[list[VolumeMount]] = None

    def allowed_topologies(self) -> list[str]:
        if self.scheduling_config is None:
            return []
        return self.scheduling_config.allowed_topologies()
