"""Task model: states, scheduling config, volume mounts, variable expansion
(``protocol_tpu/models/task.py``, copied).

Parity with reference crates/shared/src/models/task.rs:
- ``TaskState`` 8-state enum (task.rs:11-22), string round-trip with unknown
  strings mapping to UNKNOWN.
- ``VolumeMount`` label expansion of ``${TASK_ID}/${GROUP_ID}/${TIMESTAMP}/
  ${NODE_ADDRESS}`` (task.rs:63-142) and validation of supported variables.
- ``StorageConfig.file_name_template`` variable validation (task.rs:244-273).
- ``Task`` with its JSON round trip and ``from_request`` validation; the
  worker runtime's ``generate_config_hash`` is left out (the worker is not
  ported).
"""

from __future__ import annotations

import enum
import json
import re
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

_VAR_RE = re.compile(r"\$\{[^}]+\}")


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

    def to_dict(self) -> dict:
        return {"plugins": self.plugins}

    @classmethod
    def from_dict(cls, d: dict) -> "SchedulingConfig":
        return cls(plugins=d.get("plugins"))


@dataclass
class VolumeMount:
    host_path: str
    container_path: str

    SUPPORTED_VARS = ("${TASK_ID}", "${GROUP_ID}", "${TIMESTAMP}", "${NODE_ADDRESS}")

    def replace_labels(
        self, task_id: str, node_address: Optional[str] = None
    ) -> "VolumeMount":
        host_path = self.host_path.replace("${TASK_ID}", task_id)
        container_path = self.container_path.replace("${TASK_ID}", task_id)
        if node_address is not None:
            host_path = host_path.replace("${NODE_ADDRESS}", node_address)
            container_path = container_path.replace("${NODE_ADDRESS}", node_address)
        ts = str(int(time.time()))
        host_path = host_path.replace("${TIMESTAMP}", ts)
        container_path = container_path.replace("${TIMESTAMP}", ts)
        return VolumeMount(host_path=host_path, container_path=container_path)

    def validate(self) -> None:
        if not self.host_path:
            raise ValueError("Host path cannot be empty")
        if not self.container_path:
            raise ValueError("Container path cannot be empty")
        for path, label in ((self.host_path, "host_path"), (self.container_path, "container_path")):
            for m in _VAR_RE.finditer(path):
                if m.group(0) not in self.SUPPORTED_VARS:
                    raise ValueError(
                        f"Volume mount {label} contains unsupported variable: "
                        f"{m.group(0)}. Supported variables: {list(self.SUPPORTED_VARS)}"
                    )

    def to_dict(self) -> dict:
        return {"host_path": self.host_path, "container_path": self.container_path}

    @classmethod
    def from_dict(cls, d: dict) -> "VolumeMount":
        return cls(host_path=d["host_path"], container_path=d["container_path"])


@dataclass
class StorageConfig:
    file_name_template: Optional[str] = None

    VALID_VARS = (
        "${ORIGINAL_NAME}",
        "${NODE_GROUP_ID}",
        "${NODE_GROUP_SIZE}",
        "${NODE_GROUP_INDEX}",
        "${TOTAL_UPLOAD_COUNT_AFTER}",
        "${CURRENT_FILE_INDEX}",
    )

    def validate(self) -> None:
        if self.file_name_template:
            for m in _VAR_RE.finditer(self.file_name_template):
                if m.group(0) not in self.VALID_VARS:
                    raise ValueError(
                        f"Storage config template contains invalid variable: {m.group(0)}"
                    )

    def to_dict(self) -> dict:
        return {"file_name_template": self.file_name_template}

    @classmethod
    def from_dict(cls, d: dict) -> "StorageConfig":
        return cls(file_name_template=d.get("file_name_template"))


def _validate_tpu_scheduler_plugin(cfg: "SchedulingConfig") -> None:
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
        from protocol_tpu_torch.models.node import ComputeRequirements

        ComputeRequirements.parse(reqs[0])


@dataclass
class TaskMetadata:
    labels: Optional[dict[str, str]] = None

    def to_dict(self) -> dict:
        return {"labels": self.labels}

    @classmethod
    def from_dict(cls, d: dict) -> "TaskMetadata":
        return cls(labels=d.get("labels"))


@dataclass
class TaskRequest:
    """API-facing task creation payload (task.rs:144-155)."""

    image: str = ""
    name: str = ""
    env_vars: Optional[dict[str, str]] = None
    cmd: Optional[list[str]] = None
    entrypoint: Optional[list[str]] = None
    scheduling_config: Optional[SchedulingConfig] = None
    storage_config: Optional[StorageConfig] = None
    metadata: Optional[TaskMetadata] = None
    volume_mounts: Optional[list[VolumeMount]] = None

    @classmethod
    def from_dict(cls, d: dict) -> "TaskRequest":
        return cls(
            image=d.get("image", ""),
            name=d.get("name", ""),
            env_vars=d.get("env_vars"),
            cmd=d.get("cmd"),
            entrypoint=d.get("entrypoint"),
            scheduling_config=SchedulingConfig.from_dict(d["scheduling_config"])
            if d.get("scheduling_config")
            else None,
            storage_config=StorageConfig.from_dict(d["storage_config"])
            if d.get("storage_config")
            else None,
            metadata=TaskMetadata.from_dict(d["metadata"]) if d.get("metadata") else None,
            volume_mounts=[VolumeMount.from_dict(v) for v in d["volume_mounts"]]
            if d.get("volume_mounts")
            else None,
        )


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
    updated_at: Optional[int] = None
    scheduling_config: Optional[SchedulingConfig] = None
    storage_config: Optional[StorageConfig] = None
    metadata: Optional[TaskMetadata] = None
    volume_mounts: Optional[list[VolumeMount]] = None

    @classmethod
    def from_request(cls, request: TaskRequest) -> "Task":
        """Validated TaskRequest -> Task (task.rs:276-309)."""
        if request.storage_config is not None:
            request.storage_config.validate()
        if request.volume_mounts:
            for vm in request.volume_mounts:
                vm.validate()
        if request.scheduling_config is not None:
            _validate_tpu_scheduler_plugin(request.scheduling_config)
        return cls(
            name=request.name,
            image=request.image,
            cmd=request.cmd,
            entrypoint=request.entrypoint,
            env_vars=dict(request.env_vars) if request.env_vars else None,
            state=TaskState.PENDING,
            created_at=int(time.time() * 1000),
            scheduling_config=request.scheduling_config,
            storage_config=request.storage_config,
            metadata=request.metadata,
            volume_mounts=list(request.volume_mounts) if request.volume_mounts else None,
        )

    def allowed_topologies(self) -> list[str]:
        if self.scheduling_config is None:
            return []
        return self.scheduling_config.allowed_topologies()

    def to_dict(self) -> dict:
        d: dict[str, Any] = {
            "name": self.name,
            "id": self.id,
            "image": self.image,
            "env_vars": self.env_vars,
            "cmd": self.cmd,
            "entrypoint": self.entrypoint,
            "state": self.state.value,
            "created_at": self.created_at,
            "updated_at": self.updated_at,
        }
        if self.scheduling_config is not None:
            d["scheduling_config"] = self.scheduling_config.to_dict()
        if self.storage_config is not None:
            d["storage_config"] = self.storage_config.to_dict()
        if self.metadata is not None:
            d["metadata"] = self.metadata.to_dict()
        if self.volume_mounts is not None:
            d["volume_mounts"] = [vm.to_dict() for vm in self.volume_mounts]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Task":
        return cls(
            name=d.get("name", ""),
            id=str(d.get("id") or uuid.uuid4()),
            image=d.get("image", ""),
            env_vars=d.get("env_vars"),
            cmd=d.get("cmd"),
            entrypoint=d.get("entrypoint"),
            state=TaskState.parse(d.get("state", "UNKNOWN")),
            created_at=int(d.get("created_at", 0)),
            updated_at=d.get("updated_at"),
            scheduling_config=SchedulingConfig.from_dict(d["scheduling_config"])
            if d.get("scheduling_config")
            else None,
            storage_config=StorageConfig.from_dict(d["storage_config"])
            if d.get("storage_config")
            else None,
            metadata=TaskMetadata.from_dict(d["metadata"]) if d.get("metadata") else None,
            volume_mounts=[VolumeMount.from_dict(v) for v in d["volume_mounts"]]
            if d.get("volume_mounts")
            else None,
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Task":
        return cls.from_dict(json.loads(s))
