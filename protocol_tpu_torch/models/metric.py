"""Metric entries (reference: crates/shared/src/models/metric.rs)
(``protocol_tpu/models/metric.py``, copied).

A metric is keyed by (task_id, label) and carries a finite f64 value;
non-finite values are rejected at construction (metric.rs:24-29).
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class MetricKey:
    task_id: str
    label: str


@dataclass
class MetricEntry:
    key: MetricKey
    value: float

    def __post_init__(self) -> None:
        if not math.isfinite(self.value):
            raise ValueError(f"Metric value must be finite, got {self.value}")

    def to_dict(self) -> dict:
        return {
            "key": {"task_id": self.key.task_id, "label": self.key.label},
            "value": self.value,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "MetricEntry":
        return cls(
            key=MetricKey(task_id=d["key"]["task_id"], label=d["key"]["label"]),
            value=float(d["value"]),
        )
