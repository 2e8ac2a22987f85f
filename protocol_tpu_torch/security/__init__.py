"""Wallet identity, request signing, and signature-validation middleware
(``protocol_tpu/security``, copied).

The reference authenticates every HTTP request between untrusted parties
with an Ethereum wallet signature over ``endpoint + sorted-JSON body`` plus
a nonce (crates/shared/src/security/). This package keeps that protocol
shape — ``x-address`` / ``x-signature`` headers, nonce replay cache, rate
limiting, body caps — over three interchangeable schemes behind one
verifier: Ed25519 (:class:`Wallet`, the default), secp256k1/keccak with
an embedded pubkey (:class:`EvmWallet` — real Ethereum addresses, cheap
verification), and the reference's literal recovery wire
(:class:`EvmRecoveryWallet` — 0x + r||s||v over the EIP-191 digest,
verified by pure-Python public-key recovery, so signatures from alloy/
MetaMask-style clients authenticate verbatim).
"""

from protocol_tpu_torch.security.wallet import (
    EvmRecoveryWallet,
    EvmWallet,
    Wallet,
    verify_signature,
)
from protocol_tpu_torch.security.signer import sign_request, verify_request

__all__ = [
    "EvmRecoveryWallet",
    "EvmWallet",
    "Wallet",
    "sign_request",
    "verify_request",
    "verify_signature",
]
