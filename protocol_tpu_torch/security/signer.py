"""Request signing: nonce injection + sorted-key JSON + endpoint binding
(``protocol_tpu/security/signer.py``, copied).

Reference: crates/shared/src/security/request_signer.rs:22-68 —
``sign_request_with_nonce`` inserts a uuid nonce into the JSON body, sorts
object keys recursively, and signs ``endpoint + json``. Same scheme here;
the verifier recomputes the canonical JSON from the received body.

Oversized bodies sign a DIGEST instead of the raw JSON: the EVM wallet
schemes keccak the signed message in pure Python and therefore cap it at
EVM_MAX_MESSAGE_BYTES (64 KB) — which a hardware-challenge payload
(~254 KB of matrices at the default challenge_size=64) blows through,
aborting the whole validation tick under PROTOCOL_TPU_WALLET_SCHEME=evm.
Above ``BODY_DIGEST_THRESHOLD`` the signed message carries
``sha256:<hexdigest of the canonical JSON>`` in the body's place and the
``x-body-digest: sha256`` header tells the verifier to hash the received
body the same way. Binding is unchanged (the digest commits to every
body byte); the prefix cannot collide with a literal canonical JSON
(which always starts with a JSON token, never ``s``); and stripping or
adding the header just changes which message the verifier reconstructs,
so a tampered request still fails signature verification.
"""

from __future__ import annotations

import hashlib
import json
import uuid
from typing import Any, Optional

from protocol_tpu_torch.security.wallet import Wallet, verify_signature

# Stay comfortably under EVM_MAX_MESSAGE_BYTES (64 KB): the endpoint,
# timestamp, and digest prefix ride in the same signed message.
BODY_DIGEST_THRESHOLD = 48 * 1024
BODY_DIGEST_HEADER = "x-body-digest"


def canonical_json(body: Any) -> str:
    """Deterministic JSON: recursively sorted keys, compact separators."""
    return json.dumps(body, sort_keys=True, separators=(",", ":"))


def _body_digest(payload: str) -> str:
    return "sha256:" + hashlib.sha256(payload.encode()).hexdigest()


def sign_request(
    endpoint: str,
    wallet: Wallet,
    body: Optional[dict] = None,
) -> tuple[dict[str, str], Optional[dict]]:
    """Returns (headers, body-with-nonce).

    Signed message = endpoint + x-timestamp (+ canonical body JSON). The
    timestamp is signed so bodyless (GET-style) requests are replayable only
    within the middleware's freshness window — the body-nonce cache does not
    cover them.
    """
    import time

    timestamp = f"{time.time():.6f}"
    signed_body = None
    message = endpoint + timestamp
    headers = {"x-address": wallet.address, "x-timestamp": timestamp}
    if body is not None:
        signed_body = dict(body)
        signed_body["nonce"] = uuid.uuid4().hex  # 32 alnum chars
        payload = canonical_json(signed_body)
        if len(payload) > BODY_DIGEST_THRESHOLD:
            # digest mode: keeps large payloads (challenge matrices) off
            # the keccak-capped signing plane for every wallet scheme
            message += _body_digest(payload)
            headers[BODY_DIGEST_HEADER] = "sha256"
        else:
            message += payload
    headers["x-signature"] = wallet.sign_message(message)
    return headers, signed_body


def verify_request(
    endpoint: str,
    headers: dict[str, str],
    body: Optional[dict] = None,
) -> Optional[str]:
    """Validates headers against the endpoint+timestamp+body; returns the
    authenticated address, or None. Freshness of x-timestamp is enforced by
    the middleware, not here."""
    address = headers.get("x-address")
    signature = headers.get("x-signature")
    timestamp = headers.get("x-timestamp")
    if not address or not signature or timestamp is None:
        return None
    message = endpoint + timestamp
    if body is not None:
        payload = canonical_json(body)
        if headers.get(BODY_DIGEST_HEADER) == "sha256":
            # digest-signed body (see module docstring): hash the received
            # bytes the same way the signer did — a header added, removed,
            # or altered in transit reconstructs a different message and
            # the signature fails, so there is no downgrade path
            message += _body_digest(payload)
        else:
            message += payload
    if verify_signature(message, signature, address):
        return address.lower()
    return None
