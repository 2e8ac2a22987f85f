"""Consistent-hash session -> process routing for the distributed fleet
(``protocol_tpu/dfleet/topology.py``).

The in-process fabric's sha1 ring one level up: keys are session ids,
values are process endpoints. Both rings hash with
:func:`protocol_tpu_torch.fleet.fabric._h` (the reference's bits), so a
port server and a reference server in one fleet route every session id to
the same home, and a session's shard does not depend on the process it
lands on.

The ring is immutable: a membership change builds a new topology with the
next ``generation`` (:meth:`FleetTopology.without`,
:meth:`FleetTopology.with_endpoint`), so a topology is shared across
threads without a lock and a client can tell an old view from a new one.
:meth:`FleetTopology.failover_order` is the ring walk from the session's
position, without repeats: the session's home first, then where its
journal goes if the home dies (the orphan handoff walks the same way, so
the client's failover and the journal's re-route agree).
"""

from __future__ import annotations

import bisect
from typing import Optional

from protocol_tpu_torch.fleet.fabric import _h


class FleetTopology:
    """Immutable endpoint ring. ``procs`` maps endpoint -> proc id (the
    journal namespace the process owns)."""

    def __init__(self, endpoints: list, procs: Optional[dict] = None, vnodes: int = 64,
                 generation: int = 0):
        self.endpoints = [str(e) for e in endpoints]
        if not self.endpoints:
            raise ValueError("topology needs at least one endpoint")
        if len(set(self.endpoints)) != len(self.endpoints):
            raise ValueError("duplicate endpoints in topology")
        self.procs = dict(procs) if procs else {e: f"p{i}" for i, e in enumerate(self.endpoints)}
        for e in self.endpoints:
            if e not in self.procs:
                raise ValueError(f"endpoint {e!r} has no proc id")
        self.vnodes = max(1, int(vnodes))
        self.generation = int(generation)
        ring = sorted((_h(f"{e}/vnode-{j}"), i)
                      for i, e in enumerate(self.endpoints) for j in range(self.vnodes))
        self._ring_keys = [k for k, _ in ring]
        self._ring_idx = [i for _, i in ring]

    # ---------------- routing ----------------

    def endpoint_for(self, session_id: str) -> str:
        i = bisect.bisect_right(self._ring_keys, _h(session_id))
        return self.endpoints[self._ring_idx[i % len(self._ring_idx)]]

    def proc_for(self, session_id: str) -> str:
        return self.procs[self.endpoint_for(session_id)]

    def failover_order(self, session_id: str) -> list:
        """The session's endpoints in ring order from its position, without
        repeats: its home first. The client's failover ladder and the
        journal's re-route order."""
        start = bisect.bisect_right(self._ring_keys, _h(session_id))
        seen: list = []
        n = len(self._ring_idx)
        for step in range(n):
            ep = self.endpoints[self._ring_idx[(start + step) % n]]
            if ep not in seen:
                seen.append(ep)
                if len(seen) == len(self.endpoints):
                    break
        return seen

    # ---------------- membership (copy on change) ----------------

    def without(self, endpoint: str) -> "FleetTopology":
        """A new topology without ``endpoint``, one generation on: only the
        sessions that lived there move, each to its ring successor."""
        remaining = [e for e in self.endpoints if e != endpoint]
        return FleetTopology(remaining, procs={e: self.procs[e] for e in remaining},
                             vnodes=self.vnodes, generation=self.generation + 1)

    def with_endpoint(self, endpoint: str, proc_id: str) -> "FleetTopology":
        """A new topology with ``endpoint`` added, one generation on."""
        if endpoint in self.endpoints:
            raise ValueError(f"endpoint {endpoint!r} already present")
        procs = dict(self.procs)
        procs[endpoint] = str(proc_id)
        return FleetTopology(self.endpoints + [endpoint], procs=procs, vnodes=self.vnodes,
                             generation=self.generation + 1)

    # ---------------- wire form ----------------

    def to_dict(self) -> dict:
        return {
            "generation": self.generation,
            "endpoints": list(self.endpoints),
            "procs": dict(self.procs),
            "vnodes": self.vnodes,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FleetTopology":
        return cls(d["endpoints"], procs=d.get("procs"), vnodes=d.get("vnodes", 64),
                   generation=d.get("generation", 0))
