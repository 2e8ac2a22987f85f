"""Webhook plugin: async event delivery to external endpoints
(``protocol_tpu/sched/webhook.py``, copied).

Reference: crates/orchestrator/src/plugins/webhook/mod.rs — a bounded-
channel webhook sender fed by node status changes and group lifecycle
events, with per-pool configs from the WEBHOOK_CONFIGS env JSON.

Here: an asyncio bounded queue + drainer posting JSON events; drop-oldest
on overflow (delivery is best-effort in the reference too). Event shapes:
  {"type": "node_status_changed", "address", "old_status", "new_status"}
  {"type": "group_created" | "group_destroyed", "group": {...}}
  {"type": "metrics", "payload": {...}}   (metrics/webhook_sender.rs)
"""

from __future__ import annotations

import asyncio
import json
import time
from dataclasses import dataclass
from typing import Optional


@dataclass
class WebhookConfig:
    url: str
    # reference configs carry optional event filters per pool
    event_types: Optional[list[str]] = None

    @classmethod
    def from_json_env(cls, raw: str) -> list["WebhookConfig"]:
        """Parse the WEBHOOK_CONFIGS-style env JSON: a list of
        {"url": ..., "event_types": [...]} objects."""
        out = []
        for item in json.loads(raw):
            out.append(
                cls(url=item["url"], event_types=item.get("event_types"))
            )
        return out


class WebhookPlugin:
    def __init__(
        self,
        configs: list[WebhookConfig],
        http=None,  # aiohttp.ClientSession-compatible
        queue_size: int = 1000,
    ):
        self.configs = configs
        self.http = http
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=queue_size)
        self.dropped = 0
        self.delivered = 0
        self._drainer: Optional[asyncio.Task] = None

    # ----- event intake (sync-callable from store/status code) -----

    def emit(self, event_type: str, **payload) -> None:
        event = {"type": event_type, "at": time.time(), **payload}
        try:
            self.queue.put_nowait(event)
        except asyncio.QueueFull:
            # drop-oldest: best-effort delivery must not back-pressure the
            # status loops (bounded channel semantics of the reference)
            try:
                self.queue.get_nowait()
                self.dropped += 1
                self.queue.put_nowait(event)
            except asyncio.QueueEmpty:
                pass

    def handle_status_change(self, address: str, old_status: str, new_status: str) -> None:
        self.emit(
            "node_status_changed",
            address=address,
            old_status=old_status,
            new_status=new_status,
        )

    def handle_group_created(self, group_dict: dict) -> None:
        self.emit("group_created", group=group_dict)

    def handle_group_destroyed(self, group_dict: dict) -> None:
        self.emit("group_destroyed", group=group_dict)

    # ----- delivery -----

    async def drain_once(self) -> int:
        """Deliver everything currently queued (tests tick this)."""
        n = 0
        while not self.queue.empty():
            event = self.queue.get_nowait()
            for cfg in self.configs:
                if cfg.event_types and event["type"] not in cfg.event_types:
                    continue
                try:
                    async with self.http.post(cfg.url, json=event) as resp:
                        if resp.status < 400:
                            self.delivered += 1
                except Exception:
                    continue
            n += 1
        return n

    async def run(self, interval: float = 1.0) -> None:
        while True:
            await self.drain_once()
            await asyncio.sleep(interval)

    def start(self) -> None:
        self._drainer = asyncio.get_running_loop().create_task(self.run())

    def stop(self) -> None:
        if self._drainer:
            self._drainer.cancel()
