"""The orchestrator's node record, re-exported from
:mod:`protocol_tpu_torch.store.domains.node_store` (the KV-backed store's
module) so that older imports keep working."""

from protocol_tpu_torch.store.domains.node_store import (
    NODE_INDEX,
    NODE_KEY,
    NodeStatus,
    NodeStore,
    OrchestratorNode,
)

__all__ = ["NODE_INDEX", "NODE_KEY", "NodeStatus", "NodeStore", "OrchestratorNode"]
