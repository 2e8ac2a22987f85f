"""Node, compute-spec and compute-requirement models, copied from
``protocol_tpu/models/node.py`` (the reference's node.rs:180-527
semantics): the requirements DSL (:meth:`ComputeRequirements.parse`), the
fuzzy GPU-model match and ``meets()``; ``Node`` and ``DiscoveryNode``, the
discovery service's view that the orchestrator's monitor loop reads. The
port keeps its own copy because it imports nothing of the reference
package; the encoder reads specs by attribute, so either package's objects
encode identically.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, asdict
from typing import Any, Optional


class RequirementsParseError(ValueError):
    """Raised for malformed requirement DSL strings."""


def _normalize_model(name: str) -> str:
    return name.lower().replace(" ", "_")


def _models_fuzzy_match(spec_model: str, req_models_csv: str) -> bool:
    """Fuzzy GPU-model match (node.rs:443-478): the requirement is a
    comma-separated list of acceptable models; normalization lowercases and
    underscores spaces; containment is checked in both directions, with and
    without underscores."""
    normalized_spec = _normalize_model(spec_model)
    spec_no_us = normalized_spec.replace("_", "")
    for raw in req_models_csv.split(","):
        normalized_req = _normalize_model(raw.strip())
        req_no_us = normalized_req.replace("_", "")
        if (
            normalized_req in normalized_spec
            or normalized_spec in normalized_req
            or req_no_us in spec_no_us
            or spec_no_us in req_no_us
        ):
            return True
    return False


@dataclass
class CpuSpecs:
    cores: Optional[int] = None
    model: Optional[str] = None

    def meets(self, requirement: "CpuSpecs") -> bool:
        if requirement.cores is not None:
            if self.cores is None or self.cores < requirement.cores:
                return False
        return True

    def to_dict(self) -> dict:
        return _drop_none(asdict(self))

    @classmethod
    def from_dict(cls, d: dict) -> "CpuSpecs":
        return cls(cores=d.get("cores"), model=d.get("model"))


@dataclass
class GpuSpecs:
    count: Optional[int] = None
    model: Optional[str] = None
    memory_mb: Optional[int] = None
    indices: Optional[list[int]] = None

    def meets(self, requirement: "GpuRequirements") -> bool:
        """Single-alternative GPU match (node.rs:443-527)."""
        if requirement.count is not None:
            # exact count match; a node with no count passes only a 0-count req
            if self.count is None:
                if requirement.count > 0:
                    return False
            elif self.count != requirement.count:
                return False

        if requirement.model is not None:
            if self.model is None or not _models_fuzzy_match(
                self.model, requirement.model
            ):
                return False

        if requirement.memory_mb is not None:
            if self.memory_mb is None or self.memory_mb < requirement.memory_mb:
                return False
        if requirement.memory_mb_min is not None:
            if self.memory_mb is None or self.memory_mb < requirement.memory_mb_min:
                return False
        if requirement.memory_mb_max is not None:
            if self.memory_mb is None or self.memory_mb > requirement.memory_mb_max:
                return False

        # Total-memory bounds apply only when the node reports both count and
        # per-card memory (node.rs:503-524).
        if (
            requirement.total_memory_min is not None
            and self.count is not None
            and self.memory_mb is not None
        ):
            if self.count * self.memory_mb < requirement.total_memory_min:
                return False
        if (
            requirement.total_memory_max is not None
            and self.count is not None
            and self.memory_mb is not None
        ):
            if self.count * self.memory_mb > requirement.total_memory_max:
                return False
        return True

    def to_dict(self) -> dict:
        return _drop_none(asdict(self))

    @classmethod
    def from_dict(cls, d: dict) -> "GpuSpecs":
        return cls(
            count=d.get("count"),
            model=d.get("model"),
            memory_mb=d.get("memory_mb"),
            indices=d.get("indices"),
        )


@dataclass
class GpuRequirements:
    count: Optional[int] = None
    model: Optional[str] = None
    memory_mb: Optional[int] = None  # per card
    memory_mb_min: Optional[int] = None
    memory_mb_max: Optional[int] = None
    total_memory_min: Optional[int] = None  # count * memory_mb
    total_memory_max: Optional[int] = None
    indices: Optional[list[int]] = None

    def any_set(self) -> bool:
        return any(
            v is not None
            for v in (
                self.count,
                self.model,
                self.memory_mb,
                self.memory_mb_min,
                self.memory_mb_max,
                self.total_memory_min,
                self.total_memory_max,
            )
        )

    def to_dict(self) -> dict:
        return _drop_none(asdict(self))

    @classmethod
    def from_dict(cls, d: dict) -> "GpuRequirements":
        return cls(**{k: d.get(k) for k in (
            "count", "model", "memory_mb", "memory_mb_min", "memory_mb_max",
            "total_memory_min", "total_memory_max", "indices")})


@dataclass
class ComputeSpecs:
    gpu: Optional[GpuSpecs] = None
    cpu: Optional[CpuSpecs] = None
    ram_mb: Optional[int] = None
    storage_gb: Optional[int] = None
    storage_path: str = "/var/lib/prime-worker"

    def meets(self, requirements: "ComputeRequirements") -> bool:
        """Capability gate (node.rs:377-441). CPU/RAM/storage are AND
        constraints; the GPU alternatives list is OR."""
        if requirements.cpu is not None:
            if self.cpu is None or not self.cpu.meets(requirements.cpu):
                return False
        if requirements.ram_mb is not None:
            if self.ram_mb is None or self.ram_mb < requirements.ram_mb:
                return False
        if requirements.storage_gb is not None:
            if self.storage_gb is None or self.storage_gb < requirements.storage_gb:
                return False
        if requirements.gpu:
            if self.gpu is None:
                return False
            if not any(self.gpu.meets(req) for req in requirements.gpu):
                return False
        return True

    def to_dict(self) -> dict:
        d: dict[str, Any] = {}
        if self.gpu is not None:
            d["gpu"] = self.gpu.to_dict()
        if self.cpu is not None:
            d["cpu"] = self.cpu.to_dict()
        if self.ram_mb is not None:
            d["ram_mb"] = self.ram_mb
        if self.storage_gb is not None:
            d["storage_gb"] = self.storage_gb
        d["storage_path"] = self.storage_path
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ComputeSpecs":
        return cls(
            gpu=GpuSpecs.from_dict(d["gpu"]) if d.get("gpu") else None,
            cpu=CpuSpecs.from_dict(d["cpu"]) if d.get("cpu") else None,
            ram_mb=d.get("ram_mb"),
            storage_gb=d.get("storage_gb"),
            storage_path=d.get("storage_path", "/var/lib/prime-worker"),
        )


@dataclass
class ComputeRequirements:
    gpu: list[GpuRequirements] = field(default_factory=list)
    cpu: Optional[CpuSpecs] = None
    ram_mb: Optional[int] = None
    storage_gb: Optional[int] = None

    @classmethod
    def parse(cls, s: str) -> "ComputeRequirements":
        """Parse the requirements DSL (node.rs:180-374).

        ``key=value`` pairs separated by ``;``. A fresh ``gpu:count`` key while
        the current GPU alternative already has a count starts a new OR
        alternative. Exact ``gpu:memory_mb`` conflicts with the min/max forms;
        min>max is rejected at parse time.
        """
        req = cls()
        current = GpuRequirements()
        gpu_started = False

        def _int(key: str, value: str) -> int:
            try:
                v = int(value)
            except ValueError as e:
                raise RequirementsParseError(
                    f"Invalid {key} value '{value}': {e}"
                ) from None
            if v < 0:
                raise RequirementsParseError(f"Invalid {key} value '{value}': negative")
            return v

        for part in s.split(";"):
            part = part.strip()
            if not part:
                continue
            kv = part.split("=", 1)
            if len(kv) != 2:
                raise RequirementsParseError(f"Invalid key-value pair format: '{part}'")
            key, value = kv[0].strip(), kv[1].strip()

            if key == "gpu:count":
                if gpu_started and current.count is not None:
                    req.gpu.append(current)
                    current = GpuRequirements()
                gpu_started = True
                current.count = _int(key, value)
            elif key == "gpu:model":
                gpu_started = True
                current.model = value
            elif key == "gpu:memory_mb":
                gpu_started = True
                if current.memory_mb_min is not None or current.memory_mb_max is not None:
                    raise RequirementsParseError(
                        "Cannot specify both exact memory and min/max memory"
                    )
                current.memory_mb = _int(key, value)
            elif key == "gpu:memory_mb_min":
                gpu_started = True
                if current.memory_mb is not None:
                    raise RequirementsParseError(
                        "Cannot specify both exact memory and min/max memory"
                    )
                v = _int(key, value)
                if current.memory_mb_max is not None and current.memory_mb_max < v:
                    raise RequirementsParseError(
                        f"Invalid gpu:memory_mb_min value '{value}': min value is greater than max value"
                    )
                current.memory_mb_min = v
            elif key == "gpu:memory_mb_max":
                gpu_started = True
                if current.memory_mb is not None:
                    raise RequirementsParseError(
                        "Cannot specify both exact memory and min/max memory"
                    )
                v = _int(key, value)
                if current.memory_mb_min is not None and current.memory_mb_min > v:
                    raise RequirementsParseError(
                        f"Invalid gpu:memory_mb_max value '{value}': max value is less than min value"
                    )
                current.memory_mb_max = v
            elif key == "gpu:total_memory_min":
                gpu_started = True
                v = _int(key, value)
                if current.total_memory_max is not None and current.total_memory_max < v:
                    raise RequirementsParseError(
                        f"Invalid gpu:total_memory_min value '{value}': min value is greater than max value"
                    )
                current.total_memory_min = v
            elif key == "gpu:total_memory_max":
                gpu_started = True
                v = _int(key, value)
                if current.total_memory_min is not None and current.total_memory_min > v:
                    raise RequirementsParseError(
                        f"Invalid gpu:total_memory_max value '{value}': max value is less than min value"
                    )
                current.total_memory_max = v
            elif key == "cpu:cores":
                cpu = req.cpu or CpuSpecs()
                cpu.cores = _int(key, value)
                req.cpu = cpu
            elif key == "ram_mb":
                req.ram_mb = _int(key, value)
            elif key == "storage_gb":
                req.storage_gb = _int(key, value)
            else:
                raise RequirementsParseError(f"Unknown requirement key: '{key}'")

        if gpu_started and current.any_set():
            req.gpu.append(current)
        return req

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"gpu": [g.to_dict() for g in self.gpu]}
        if self.cpu is not None:
            d["cpu"] = self.cpu.to_dict()
        if self.ram_mb is not None:
            d["ram_mb"] = self.ram_mb
        if self.storage_gb is not None:
            d["storage_gb"] = self.storage_gb
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ComputeRequirements":
        return cls(
            gpu=[GpuRequirements.from_dict(g) for g in d.get("gpu", [])],
            cpu=CpuSpecs.from_dict(d["cpu"]) if d.get("cpu") else None,
            ram_mb=d.get("ram_mb"),
            storage_gb=d.get("storage_gb"),
        )


@dataclass
class NodeLocation:
    latitude: float = 0.0
    longitude: float = 0.0
    city: Optional[str] = None
    region: Optional[str] = None
    country: Optional[str] = None

    def to_dict(self) -> dict:
        return _drop_none(asdict(self))

    @classmethod
    def from_dict(cls, d: dict) -> "NodeLocation":
        return cls(
            latitude=float(d.get("latitude", 0.0)),
            longitude=float(d.get("longitude", 0.0)),
            city=d.get("city"),
            region=d.get("region"),
            country=d.get("country"),
        )


def _drop_none(d: dict) -> dict:
    return {k: v for k, v in d.items() if v is not None}


@dataclass
class Node:
    """A registered worker node (node.rs:10-23). ``id`` is the node wallet
    address; ``provider_address`` the staking provider's address."""

    id: str = ""
    provider_address: str = ""
    ip_address: str = ""
    port: int = 0
    compute_pool_id: int = 0
    compute_specs: Optional[ComputeSpecs] = None
    worker_p2p_id: Optional[str] = None
    worker_p2p_addresses: Optional[list[str]] = None
    # provider-advertised ask price (cost units/hour); a live input to the
    # batch matcher's price cost term — the reference scores nothing, so
    # this field is the marketplace half of the redesign (ops/cost.py)
    price: Optional[float] = None

    def to_dict(self) -> dict:
        d: dict[str, Any] = {
            "id": self.id,
            "provider_address": self.provider_address,
            "ip_address": self.ip_address,
            "port": self.port,
            "compute_pool_id": self.compute_pool_id,
            "compute_specs": self.compute_specs.to_dict() if self.compute_specs else None,
        }
        if self.worker_p2p_id is not None:
            d["worker_p2p_id"] = self.worker_p2p_id
        if self.worker_p2p_addresses is not None:
            d["worker_p2p_addresses"] = self.worker_p2p_addresses
        if self.price is not None:
            d["price"] = self.price
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Node":
        return cls(
            id=d.get("id", ""),
            provider_address=d.get("provider_address", ""),
            ip_address=d.get("ip_address", ""),
            port=int(d.get("port", 0)),
            compute_pool_id=int(d.get("compute_pool_id", 0)),
            compute_specs=ComputeSpecs.from_dict(d["compute_specs"])
            if d.get("compute_specs")
            else None,
            worker_p2p_id=d.get("worker_p2p_id"),
            worker_p2p_addresses=d.get("worker_p2p_addresses"),
            price=float(d["price"]) if d.get("price") is not None else None,
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Node":
        return cls.from_dict(json.loads(s))


@dataclass
class DiscoveryNode:
    """Discovery-service view of a node plus chain-derived flags
    (node.rs:552-570)."""

    node: Node = field(default_factory=Node)
    is_validated: bool = False
    is_active: bool = False
    is_provider_whitelisted: bool = False
    is_blacklisted: bool = False
    last_updated: Optional[float] = None
    created_at: Optional[float] = None
    location: Optional[NodeLocation] = None
    latest_balance: Optional[int] = None

    def to_dict(self) -> dict:
        d = self.node.to_dict()
        d.update(
            {
                "is_validated": self.is_validated,
                "is_active": self.is_active,
                "is_provider_whitelisted": self.is_provider_whitelisted,
                "is_blacklisted": self.is_blacklisted,
            }
        )
        if self.last_updated is not None:
            d["last_updated"] = self.last_updated
        if self.created_at is not None:
            d["created_at"] = self.created_at
        if self.location is not None:
            d["location"] = self.location.to_dict()
        if self.latest_balance is not None:
            d["latest_balance"] = self.latest_balance
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "DiscoveryNode":
        return cls(
            node=Node.from_dict(d),
            is_validated=bool(d.get("is_validated", False)),
            is_active=bool(d.get("is_active", False)),
            is_provider_whitelisted=bool(d.get("is_provider_whitelisted", False)),
            is_blacklisted=bool(d.get("is_blacklisted", False)),
            last_updated=d.get("last_updated"),
            created_at=d.get("created_at"),
            location=NodeLocation.from_dict(d["location"]) if d.get("location") else None,
            latest_balance=d.get("latest_balance"),
        )

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "DiscoveryNode":
        return cls.from_dict(json.loads(s))


def _drop_none(d: dict) -> dict:
    return {k: v for k, v in d.items() if v is not None}
