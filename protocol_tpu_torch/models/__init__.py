"""Data models of the port: nodes and the capability algebra, tasks,
heartbeats and metrics (``protocol_tpu/models``, copied)."""

from protocol_tpu_torch.models.heartbeat import HeartbeatRequest, TaskDetails
from protocol_tpu_torch.models.metric import MetricEntry, MetricKey
from protocol_tpu_torch.models.node import (
    ComputeRequirements,
    ComputeSpecs,
    CpuSpecs,
    DiscoveryNode,
    GpuRequirements,
    GpuSpecs,
    Node,
    NodeLocation,
)
from protocol_tpu_torch.models.task import (
    SchedulingConfig,
    StorageConfig,
    Task,
    TaskRequest,
    TaskState,
    VolumeMount,
)

__all__ = [
    "ComputeRequirements",
    "ComputeSpecs",
    "CpuSpecs",
    "DiscoveryNode",
    "GpuRequirements",
    "GpuSpecs",
    "HeartbeatRequest",
    "MetricEntry",
    "MetricKey",
    "Node",
    "NodeLocation",
    "SchedulingConfig",
    "StorageConfig",
    "Task",
    "TaskDetails",
    "TaskRequest",
    "TaskState",
    "VolumeMount",
]
