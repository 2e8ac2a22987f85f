"""Ledger client over the ledger HTTP API
(``protocol_tpu/chain/remote.py``, copied).

The reference's services each hold alloy JSON-RPC contract wrappers against
the chain (crates/shared/src/web3/). Here, out-of-process services (the
Helm-deployed discovery/orchestrator/validator pods) hold a ``RemoteLedger``
speaking the LedgerApiService seam — same method surface as the in-process
``Ledger``, so every service constructor accepts either interchangeably.

Synchronous on purpose: ledger calls sit on control-plane paths that are
already synchronous (services call ``self.ledger.x(...)`` directly) and
volumes are tens of calls per loop tick; transport is the shared
per-thread keep-alive client (utils.http_client). Callers on the event
loop wrap service loops in ``asyncio.to_thread`` where latency matters.
"""

from __future__ import annotations

from typing import Optional

from protocol_tpu_torch.utils.http_client import KeepAliveJsonClient

from .ledger import (
    DomainInfo,
    LedgerError,
    NodeInfo,
    PoolInfo,
    PoolStatus,
    ProviderInfo,
    WorkInfo,
)


class RemoteLedger:
    def __init__(
        self,
        base_url: str,
        admin_api_key: str = "",
        timeout: float = 10.0,
        max_tries: int = 3,
        retry_delay: float = 2.0,
    ):
        self.base_url = base_url.rstrip("/")
        self.admin_api_key = admin_api_key
        self.timeout = timeout
        self.max_tries = max_tries
        self.retry_delay = retry_delay
        self._http = KeepAliveJsonClient(base_url, timeout, LedgerError)

    # ---- transport

    def _call(self, kind: str, op: str, params: dict):
        """Transport with the reference's retry_call semantics
        (crates/shared/src/web3/contracts/helpers/utils.rs:22-70): writes
        retry up to ``max_tries`` with a delay, and a per-call ``tx_id``
        makes the resend safe — if the earlier attempt actually landed
        but its response was lost, the ledger API replays the recorded
        outcome instead of double-applying (the receipt check's HTTP
        analog). Application errors (LedgerError from the ledger itself)
        never retry; only transport failures do."""
        import time as _time
        import uuid

        headers = {}
        write = kind == "write"
        if write and self.admin_api_key:
            headers["Authorization"] = f"Bearer {self.admin_api_key}"
        if write:
            params = {**params, "tx_id": uuid.uuid4().hex}
        tries = max(1, self.max_tries) if write else 1
        for attempt in range(tries):
            try:
                payload = self._http.post(
                    f"/ledger/{kind}/{op}",
                    params,
                    headers=headers,
                    # tx_id dedup makes write resends safe end-to-end
                    retry_response=True,
                )
                break
            except LedgerError:
                if attempt == tries - 1:
                    raise
                _time.sleep(self.retry_delay)
        if not payload.get("success"):
            raise LedgerError(payload.get("error", f"{op} failed"))
        return payload.get("data")

    def _read(self, op: str, **params):
        return self._call("read", op, params)

    def _write(self, op: str, **params):
        return self._call("write", op, params)

    # ---- AIToken

    def balance_of(self, address: str) -> int:
        return self._read("balance_of", address=address)

    def mint(self, address: str, amount: int) -> None:
        self._write("mint", address=address, amount=amount)

    def transfer(self, sender: str, to: str, amount: int) -> None:
        self._write("transfer", sender=sender, to=to, amount=amount)

    def approve(self, owner: str, spender: str, amount: int) -> None:
        self._write("approve", owner=owner, spender=spender, amount=amount)

    # ---- DomainRegistry / PrimeNetwork

    def create_domain(self, name: str, validation_logic: str = "") -> int:
        return self._write(
            "create_domain", name=name, validation_logic=validation_logic
        )

    def get_domain(self, domain_id: int) -> DomainInfo:
        return DomainInfo(**self._read("get_domain", domain_id=domain_id))

    def calculate_stake(self, compute_units: int) -> int:
        return self._read("calculate_stake", compute_units=compute_units)

    def register_provider(self, provider: str, stake: int) -> None:
        self._write("register_provider", provider=provider, stake=stake)

    def provider_exists(self, provider: str) -> bool:
        return self._read("provider_exists", provider=provider)

    def get_provider(self, provider: str) -> ProviderInfo:
        return ProviderInfo(**self._read("get_provider", provider=provider))

    def increase_stake(self, provider: str, amount: int) -> None:
        self._write("increase_stake", provider=provider, amount=amount)

    def reclaim_stake(self, provider: str, amount: int) -> None:
        self._write("reclaim_stake", provider=provider, amount=amount)

    def get_stake(self, provider: str) -> int:
        return self._read("get_stake", provider=provider)

    def whitelist_provider(self, provider: str) -> None:
        self._write("whitelist_provider", provider=provider)

    def is_provider_whitelisted(self, provider: str) -> bool:
        return self._read("is_provider_whitelisted", provider=provider)

    def add_compute_node(
        self, provider: str, node: str, compute_units: int = 1
    ) -> None:
        self._write(
            "add_compute_node",
            provider=provider,
            node=node,
            compute_units=compute_units,
        )

    def node_exists(self, node: str) -> bool:
        return self._read("node_exists", node=node)

    def get_node(self, node: str) -> NodeInfo:
        return NodeInfo(**self._read("get_node", node=node))

    def remove_compute_node(self, provider: str, node: str) -> None:
        self._write("remove_compute_node", provider=provider, node=node)

    def grant_validator_role(self, address: str) -> None:
        self._write("grant_validator_role", address=address)

    def revoke_validator_role(self, address: str) -> None:
        self._write("revoke_validator_role", address=address)

    def get_validator_role(self) -> list[str]:
        return self._read("get_validator_role")

    def validate_node(self, node: str) -> None:
        self._write("validate_node", node=node)

    def is_node_validated(self, node: str) -> bool:
        return self._read("is_node_validated", node=node)

    def get_provider_total_compute(self, provider: str) -> int:
        return self._read("get_provider_total_compute", provider=provider)

    # ---- ComputePool

    def create_pool(
        self,
        domain_id: int,
        creator: str,
        compute_manager_key: str,
        pool_data_uri: str = "",
    ) -> int:
        return self._write(
            "create_pool",
            domain_id=domain_id,
            creator=creator,
            compute_manager_key=compute_manager_key,
            pool_data_uri=pool_data_uri,
        )

    def get_pool_info(self, pool_id: int) -> PoolInfo:
        d = dict(self._read("get_pool_info", pool_id=pool_id))
        d["status"] = PoolStatus(d["status"])
        d["blacklist"] = set(d.get("blacklist", []))
        return PoolInfo(**d)

    def start_pool(self, pool_id: int, caller: str) -> None:
        self._write("start_pool", pool_id=pool_id, caller=caller)

    def join_compute_pool(
        self,
        pool_id: int,
        provider: str,
        node: str,
        nonce: str,
        expiration: float,
        invite_signature: str,
    ) -> None:
        self._write(
            "join_compute_pool",
            pool_id=pool_id,
            provider=provider,
            node=node,
            nonce=nonce,
            expiration=expiration,
            invite_signature=invite_signature,
        )

    def is_node_in_pool(self, pool_id: int, node: str) -> bool:
        return self._read("is_node_in_pool", pool_id=pool_id, node=node)

    def leave_compute_pool(self, pool_id: int, node: str) -> None:
        self._write("leave_compute_pool", pool_id=pool_id, node=node)

    def eject_node(self, pool_id: int, node: str, caller: str) -> None:
        self._write("eject_node", pool_id=pool_id, node=node, caller=caller)

    def blacklist_node(self, pool_id: int, node: str, caller: str) -> None:
        self._write("blacklist_node", pool_id=pool_id, node=node, caller=caller)

    # ---- work

    def submit_work(
        self, pool_id: int, node: str, work_key: str, work_units: int
    ) -> None:
        self._write(
            "submit_work",
            pool_id=pool_id,
            node=node,
            work_key=work_key,
            work_units=work_units,
        )

    def get_work_keys(self, pool_id: int) -> list[str]:
        return self._read("get_work_keys", pool_id=pool_id)

    def _work_info(self, d: Optional[dict]) -> Optional[WorkInfo]:
        return WorkInfo(**d) if d else None

    def get_work_info(self, pool_id: int, work_key: str) -> Optional[WorkInfo]:
        return self._work_info(
            self._read("get_work_info", pool_id=pool_id, work_key=work_key)
        )

    def get_work_since(self, pool_id: int, since: float) -> list[WorkInfo]:
        return [
            self._work_info(d)
            for d in self._read("get_work_since", pool_id=pool_id, since=since)
        ]

    def invalidate_work(
        self, pool_id: int, work_key: str, penalty: int = 0
    ) -> None:
        self._write(
            "invalidate_work", pool_id=pool_id, work_key=work_key, penalty=penalty
        )

    def soft_invalidate_work(self, pool_id: int, work_key: str) -> None:
        self._write("soft_invalidate_work", pool_id=pool_id, work_key=work_key)

    def get_rewards(self, node: str) -> int:
        return self._read("get_rewards", node=node)
