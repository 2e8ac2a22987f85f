"""In-process ledger implementing the reference's contract-wrapper surface
(``protocol_tpu/chain/ledger.py``, copied).

Operation map (reference wrapper -> method here), from
crates/shared/src/web3/contracts/implementations/:

  AIToken             balance_of / mint / approve / transfer
  PrimeNetwork        register_provider / stake / add_compute_node /
                      validate_node / whitelist_provider / invalidate_work /
                      soft_invalidate_work / create_domain
  ComputeRegistry     get_provider / get_node / get_provider_total_compute
  ComputePool         create_pool / get_pool_info / start_pool /
                      is_node_in_pool / join_compute_pool (orchestrator-
                      signed invite verified against the pool's compute
                      manager key) / eject_node / blacklist_node /
                      submit_work
  StakeManager        get_stake / calculate_stake / slash
  DomainRegistry      get_domain
  SyntheticDataWorkValidator  get_work_keys / get_work_info / get_work_since
  RewardsDistributor  rewards accounting per submitted work unit

Invites: the reference binds a pool join to
keccak(domain, pool, node, nonce, expiration) signed by the pool's
compute-manager key (orchestrator/src/node/invite.rs:86-115; verified
worker-side at worker/src/p2p/mod.rs:396-497). Here the invite digest is
sha256 over the same canonical fields and the signature is the wallet
scheme from protocol_tpu_torch.security.

Thread-safe; deterministic; state is plain dicts so a dev "devnet" is just
``Ledger()``. The reference's JSON snapshots (the devnet's and the
ledger-api pod's restart) are left out: no entry point of the port keeps a
ledger.
"""

from __future__ import annotations

import enum
import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from protocol_tpu_torch.security.wallet import verify_signature


class LedgerError(Exception):
    pass


class PoolStatus(str, enum.Enum):
    PENDING = "PENDING"
    ACTIVE = "ACTIVE"
    COMPLETED = "COMPLETED"


@dataclass
class ProviderInfo:
    address: str
    stake: int = 0
    whitelisted: bool = False
    nodes: list[str] = field(default_factory=list)


@dataclass
class NodeInfo:
    address: str
    provider: str
    validated: bool = False
    active_pool: Optional[int] = None
    compute_units: int = 1


@dataclass
class PoolInfo:
    pool_id: int
    domain_id: int
    creator: str
    compute_manager_key: str
    pool_data_uri: str = ""  # carries the ComputeRequirements DSL
    status: PoolStatus = PoolStatus.PENDING
    nodes: list[str] = field(default_factory=list)
    blacklist: set[str] = field(default_factory=set)


@dataclass
class WorkInfo:
    pool_id: int
    node: str
    provider: str
    work_key: str
    work_units: int
    timestamp: float
    invalidated: bool = False
    soft_invalidated: bool = False


@dataclass
class DomainInfo:
    domain_id: int
    name: str
    validation_logic: str = ""


def invite_digest(domain_id: int, pool_id: int, node: str, nonce: str, expiration: float) -> bytes:
    msg = f"invite|{domain_id}|{pool_id}|{node.lower()}|{nonce}|{int(expiration)}"
    return hashlib.sha256(msg.encode()).digest()


class Ledger:
    def __init__(self, min_stake_per_compute_unit: int = 10):
        self._lock = threading.RLock()
        self.balances: dict[str, int] = {}
        self.allowances: dict[tuple[str, str], int] = {}
        self.providers: dict[str, ProviderInfo] = {}
        self.nodes: dict[str, NodeInfo] = {}
        self.pools: dict[int, PoolInfo] = {}
        self.domains: dict[int, DomainInfo] = {}
        self.work: dict[tuple[int, str], WorkInfo] = {}  # (pool, work_key)
        self.rewards: dict[str, int] = {}
        self.validator_roles: set[str] = set()
        self.min_stake_per_compute_unit = min_stake_per_compute_unit
        self._next_pool_id = 0
        self._next_domain_id = 0

    # ------------- AIToken -------------

    def balance_of(self, address: str) -> int:
        return self.balances.get(address.lower(), 0)

    def mint(self, address: str, amount: int) -> None:
        with self._lock:
            self.balances[address.lower()] = self.balance_of(address) + amount

    def transfer(self, sender: str, to: str, amount: int) -> None:
        with self._lock:
            if self.balance_of(sender) < amount:
                raise LedgerError("insufficient balance")
            self.balances[sender.lower()] = self.balance_of(sender) - amount
            self.balances[to.lower()] = self.balance_of(to) + amount

    def approve(self, owner: str, spender: str, amount: int) -> None:
        with self._lock:
            self.allowances[(owner.lower(), spender.lower())] = amount

    # ------------- DomainRegistry / PrimeNetwork -------------

    def create_domain(self, name: str, validation_logic: str = "") -> int:
        with self._lock:
            did = self._next_domain_id
            self._next_domain_id += 1
            self.domains[did] = DomainInfo(did, name, validation_logic)
            return did

    def get_domain(self, domain_id: int) -> DomainInfo:
        info = self.domains.get(domain_id)
        if info is None:
            raise LedgerError(f"unknown domain {domain_id}")
        return info

    # ------------- provider registry -------------

    def calculate_stake(self, compute_units: int = 1) -> int:
        return self.min_stake_per_compute_unit * max(compute_units, 1)

    def register_provider(self, provider: str, stake: int) -> None:
        with self._lock:
            provider = provider.lower()
            if provider in self.providers:
                raise LedgerError("provider already registered")
            if self.balance_of(provider) < stake:
                raise LedgerError("insufficient balance for stake")
            if stake < self.calculate_stake(1):
                raise LedgerError("stake below minimum")
            self.balances[provider] -= stake
            self.providers[provider] = ProviderInfo(address=provider, stake=stake)

    def provider_exists(self, provider: str) -> bool:
        return provider.lower() in self.providers

    def get_provider(self, provider: str) -> ProviderInfo:
        info = self.providers.get(provider.lower())
        if info is None:
            raise LedgerError(f"unknown provider {provider}")
        return info

    def increase_stake(self, provider: str, amount: int) -> None:
        with self._lock:
            info = self.get_provider(provider)
            if self.balance_of(provider) < amount:
                raise LedgerError("insufficient balance")
            self.balances[provider.lower()] -= amount
            info.stake += amount

    def reclaim_stake(self, provider: str, amount: int) -> None:
        with self._lock:
            info = self.get_provider(provider)
            required = self.calculate_stake(
                sum(self.nodes[n].compute_units for n in info.nodes)
            )
            if info.stake - amount < required:
                raise LedgerError("cannot reclaim below required stake")
            info.stake -= amount
            self.balances[provider.lower()] = self.balance_of(provider) + amount

    def get_stake(self, provider: str) -> int:
        info = self.providers.get(provider.lower())
        return info.stake if info else 0

    def whitelist_provider(self, provider: str) -> None:
        with self._lock:
            self.get_provider(provider).whitelisted = True

    def is_provider_whitelisted(self, provider: str) -> bool:
        info = self.providers.get(provider.lower())
        return bool(info and info.whitelisted)

    # ------------- compute registry -------------

    def add_compute_node(
        self, provider: str, node: str, compute_units: int = 1
    ) -> None:
        with self._lock:
            info = self.get_provider(provider)
            node = node.lower()
            if node in self.nodes:
                raise LedgerError("node already registered")
            total_units = sum(self.nodes[n].compute_units for n in info.nodes)
            required = self.calculate_stake(total_units + compute_units)
            if info.stake < required:
                raise LedgerError("insufficient stake for node")
            self.nodes[node] = NodeInfo(
                address=node, provider=provider.lower(), compute_units=compute_units
            )
            info.nodes.append(node)

    def node_exists(self, node: str) -> bool:
        return node.lower() in self.nodes

    def get_node(self, node: str) -> NodeInfo:
        info = self.nodes.get(node.lower())
        if info is None:
            raise LedgerError(f"unknown node {node}")
        return info

    def remove_compute_node(self, provider: str, node: str) -> None:
        with self._lock:
            pinfo = self.get_provider(provider)
            ninfo = self.get_node(node)
            if ninfo.provider != provider.lower():
                raise LedgerError("node does not belong to provider")
            if ninfo.active_pool is not None:
                raise LedgerError("node is in a pool")
            del self.nodes[node.lower()]
            pinfo.nodes.remove(node.lower())

    def grant_validator_role(self, address: str) -> None:
        """Register a validator wallet on the substrate (reference
        prime_network.get_validator_role surface; workers derive their
        control-plane allowlist from this set, cli/command.rs:717-734)."""
        with self._lock:
            self.validator_roles.add(address.lower())

    def revoke_validator_role(self, address: str) -> None:
        with self._lock:
            self.validator_roles.discard(address.lower())

    def get_validator_role(self) -> list[str]:
        with self._lock:
            return sorted(self.validator_roles)

    def validate_node(self, node: str) -> None:
        """Validator attests hardware (reference
        prime_network.validate_node)."""
        with self._lock:
            self.get_node(node).validated = True

    def is_node_validated(self, node: str) -> bool:
        info = self.nodes.get(node.lower())
        return bool(info and info.validated)

    def get_provider_total_compute(self, provider: str) -> int:
        info = self.providers.get(provider.lower())
        if not info:
            return 0
        return sum(self.nodes[n].compute_units for n in info.nodes)

    # ------------- compute pool -------------

    def create_pool(
        self,
        domain_id: int,
        creator: str,
        compute_manager_key: str,
        pool_data_uri: str = "",
    ) -> int:
        with self._lock:
            self.get_domain(domain_id)
            pid = self._next_pool_id
            self._next_pool_id += 1
            self.pools[pid] = PoolInfo(
                pool_id=pid,
                domain_id=domain_id,
                creator=creator.lower(),
                compute_manager_key=compute_manager_key.lower(),
                pool_data_uri=pool_data_uri,
            )
            return pid

    def get_pool_info(self, pool_id: int) -> PoolInfo:
        info = self.pools.get(pool_id)
        if info is None:
            raise LedgerError(f"unknown pool {pool_id}")
        return info

    def start_pool(self, pool_id: int, caller: str) -> None:
        with self._lock:
            pool = self.get_pool_info(pool_id)
            if caller.lower() != pool.creator:
                raise LedgerError("only creator can start pool")
            pool.status = PoolStatus.ACTIVE

    def join_compute_pool(
        self,
        pool_id: int,
        provider: str,
        node: str,
        nonce: str,
        expiration: float,
        invite_signature: str,
    ) -> None:
        """Node joins with an orchestrator-signed invite
        (invite.rs:86-115 + worker/p2p/mod.rs:453-468)."""
        with self._lock:
            pool = self.get_pool_info(pool_id)
            if pool.status != PoolStatus.ACTIVE:
                raise LedgerError("pool not active")
            node_l = node.lower()
            ninfo = self.get_node(node_l)
            if ninfo.provider != provider.lower():
                raise LedgerError("node does not belong to provider")
            if not ninfo.validated:
                raise LedgerError("node not validated")
            if node_l in pool.blacklist:
                raise LedgerError("node blacklisted")
            if ninfo.active_pool is not None:
                raise LedgerError("node already in a pool")
            if expiration < time.time():
                raise LedgerError("invite expired")
            digest = invite_digest(pool.domain_id, pool_id, node_l, nonce, expiration)
            if not verify_signature(digest, invite_signature, pool.compute_manager_key):
                raise LedgerError("invalid invite signature")
            pool.nodes.append(node_l)
            ninfo.active_pool = pool_id

    def is_node_in_pool(self, pool_id: int, node: str) -> bool:
        pool = self.pools.get(pool_id)
        return bool(pool and node.lower() in pool.nodes)

    def leave_compute_pool(self, pool_id: int, node: str) -> None:
        with self._lock:
            pool = self.get_pool_info(pool_id)
            node_l = node.lower()
            if node_l in pool.nodes:
                pool.nodes.remove(node_l)
            ninfo = self.nodes.get(node_l)
            if ninfo and ninfo.active_pool == pool_id:
                ninfo.active_pool = None

    def eject_node(self, pool_id: int, node: str, caller: str) -> None:
        with self._lock:
            pool = self.get_pool_info(pool_id)
            if caller.lower() not in (pool.creator, pool.compute_manager_key):
                raise LedgerError("not authorized to eject")
            self.leave_compute_pool(pool_id, node)

    def blacklist_node(self, pool_id: int, node: str, caller: str) -> None:
        with self._lock:
            pool = self.get_pool_info(pool_id)
            if caller.lower() not in (pool.creator, pool.compute_manager_key):
                raise LedgerError("not authorized to blacklist")
            pool.blacklist.add(node.lower())
            self.leave_compute_pool(pool_id, node)

    # ------------- work submission / validation -------------

    def submit_work(
        self, pool_id: int, node: str, work_key: str, work_units: int
    ) -> None:
        """submitWork(poolId, node, workKey=sha256, workUnits=flops)
        (worker/src/docker/taskbridge/file_handler.rs submission path)."""
        with self._lock:
            pool = self.get_pool_info(pool_id)
            node_l = node.lower()
            if node_l not in pool.nodes:
                raise LedgerError("node not in pool")
            key = (pool_id, work_key)
            if key in self.work:
                raise LedgerError("work key already submitted")
            self.work[key] = WorkInfo(
                pool_id=pool_id,
                node=node_l,
                provider=self.get_node(node_l).provider,
                work_key=work_key,
                work_units=work_units,
                timestamp=time.time(),
            )
            self.rewards[node_l] = self.rewards.get(node_l, 0) + work_units

    def get_work_keys(self, pool_id: int) -> list[str]:
        return [k for (pid, k) in self.work if pid == pool_id]

    def get_work_info(self, pool_id: int, work_key: str) -> Optional[WorkInfo]:
        return self.work.get((pool_id, work_key))

    def get_work_since(self, pool_id: int, since: float) -> list[WorkInfo]:
        return sorted(
            (
                w
                for (pid, _), w in self.work.items()
                if pid == pool_id and w.timestamp >= since
            ),
            key=lambda w: w.timestamp,
        )

    def invalidate_work(self, pool_id: int, work_key: str, penalty: int = 0) -> None:
        """Hard invalidation + stake slash (prime_network.invalidate_work)."""
        with self._lock:
            info = self.work.get((pool_id, work_key))
            if info is None:
                raise LedgerError("unknown work key")
            info.invalidated = True
            self.rewards[info.node] = max(
                0, self.rewards.get(info.node, 0) - info.work_units
            )
            if penalty:
                pinfo = self.providers.get(info.provider)
                if pinfo:
                    pinfo.stake = max(0, pinfo.stake - penalty)

    def soft_invalidate_work(self, pool_id: int, work_key: str) -> None:
        """Reward clawback without slashing (soft_invalidate_work)."""
        with self._lock:
            info = self.work.get((pool_id, work_key))
            if info is None:
                raise LedgerError("unknown work key")
            info.soft_invalidated = True
            self.rewards[info.node] = max(
                0, self.rewards.get(info.node, 0) - info.work_units
            )

    def get_rewards(self, node: str) -> int:
        return self.rewards.get(node.lower(), 0)
