"""Economic/consensus substrate: an in-process ledger
(``protocol_tpu/chain/__init__.py``, copied).

The reference's economic layer is a set of Ethereum contracts (PrimeNetwork,
ComputeRegistry, ComputePool, StakeManager, AIToken, DomainRegistry,
SyntheticDataWorkValidator, RewardsDistributor) accessed through Rust
wrappers (crates/shared/src/web3/contracts/). The Solidity itself is an
EMPTY submodule in the reference (SURVEY.md §2.8), so this framework
provides the *operation surface those wrappers expose* as an in-process
ledger — the same API seam, swappable later for a real chain backend.
"""

from protocol_tpu_torch.chain.ledger import (
    Ledger,
    LedgerError,
    PoolStatus,
    WorkInfo,
)

__all__ = ["Ledger", "LedgerError", "PoolStatus", "WorkInfo"]
