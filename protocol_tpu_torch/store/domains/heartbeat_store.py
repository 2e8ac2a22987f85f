"""Heartbeat store: TTL'd beats + unhealthy counters
(``protocol_tpu/store/domains/heartbeat_store.py``, copied).

Reference: crates/orchestrator/src/store/domains/heartbeat_store.rs —
beat key with 90 s expiry (:31-35) and per-node unhealthy counters consumed
by the status-update FSM.
"""

from __future__ import annotations

import json
from typing import Optional

from protocol_tpu_torch.models.heartbeat import HeartbeatRequest
from protocol_tpu_torch.store.kv import KVStore

BEAT_KEY = "orchestrator:heartbeat:{}"
UNHEALTHY_KEY = "orchestrator:unhealthy_counter:{}"

DEFAULT_TTL_SECONDS = 90.0


class HeartbeatStore:
    def __init__(self, kv: KVStore, ttl_seconds: float = DEFAULT_TTL_SECONDS):
        self.kv = kv
        self.ttl = ttl_seconds

    def beat(self, hb: HeartbeatRequest) -> None:
        self.kv.set(BEAT_KEY.format(hb.address), json.dumps(hb.to_dict()), ex=self.ttl)

    def get_heartbeat(self, address: str) -> Optional[HeartbeatRequest]:
        raw = self.kv.get(BEAT_KEY.format(address))
        return HeartbeatRequest.from_dict(json.loads(raw)) if raw else None

    def clear_heartbeat(self, address: str) -> None:
        self.kv.delete(BEAT_KEY.format(address))

    # ----- unhealthy counters (status_update/mod.rs miss counting)

    def increment_unhealthy_counter(self, address: str) -> int:
        return self.kv.incr(UNHEALTHY_KEY.format(address))

    def get_unhealthy_counter(self, address: str) -> int:
        raw = self.kv.get(UNHEALTHY_KEY.format(address))
        return int(raw) if raw else 0

    def clear_unhealthy_counter(self, address: str) -> None:
        self.kv.delete(UNHEALTHY_KEY.format(address))
