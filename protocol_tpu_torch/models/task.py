"""Task model, the part of ``protocol_tpu/models/task.py`` the batch
matcher reads: ``TaskState`` (:28), ``SchedulingConfig`` (:47),
``_validate_tpu_scheduler_plugin`` (:136) and ``Task`` (:213) with its id,
creation time, scheduling config and ``allowed_topologies()``. Volume
mounts, storage config, metadata and the config hash are not needed by
the matcher and are left out.
"""

from __future__ import annotations

import enum
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
    state: TaskState = TaskState.UNKNOWN
    created_at: int = 0  # ms since epoch
    scheduling_config: Optional[SchedulingConfig] = None

    def allowed_topologies(self) -> list[str]:
        if self.scheduling_config is None:
            return []
        return self.scheduling_config.allowed_topologies()
