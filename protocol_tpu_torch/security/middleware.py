"""aiohttp middlewares: signature validation and admin API key
(``protocol_tpu/security/middleware.py``, copied; ``aiohttp`` is imported
where a middleware is built).

Reference: crates/shared/src/security/auth_signature_middleware.rs —
actix ``ValidateSignature`` transform with nonce format check (16-64
alphanumeric, :135-140), Redis nonce replay cache with 60 s TTL (:159-180),
in-memory rate limit 100 req/min/address (:142-157), 10 MB body cap
(:27-35), plus optional per-service validators (e.g. "node exists and is
not ejected", orchestrator/src/api/server.rs:170-185) — and
api_key_middleware.rs (``Authorization: Bearer <admin key>``).
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Awaitable, Callable, Iterable, Optional

from protocol_tpu_torch.security.signer import verify_request
from protocol_tpu_torch.store.kv import KVStore

NONCE_TTL_SECONDS = 60.0
RATE_LIMIT_PER_MINUTE = 100
MAX_BODY_BYTES = 10 * 1024 * 1024

AddressValidator = Callable[[str], Awaitable[bool]]


def _nonce_valid(nonce: str) -> bool:
    return 16 <= len(nonce) <= 64 and nonce.isalnum()


class RateLimiter:
    """Fixed-window per-address counter (middleware.rs:142-157)."""

    def __init__(self, limit: int = RATE_LIMIT_PER_MINUTE, window: float = 60.0):
        self.limit = limit
        self.window = window
        self._counts: dict[str, tuple[int, float]] = {}

    def allow(self, address: str, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        count, start = self._counts.get(address, (0, now))
        if now - start >= self.window:
            count, start = 0, now
        if count >= self.limit:
            return False
        self._counts[address] = (count + 1, start)
        return True


def validate_signature_middleware(
    kv: KVStore,
    protected_prefixes: Iterable[str],
    validator: Optional[AddressValidator] = None,
    allowed_addresses: Optional[Iterable[str]] = None,
    rate_limiter: Optional[RateLimiter] = None,
    max_body_bytes: int = MAX_BODY_BYTES,
):
    """Middleware guarding the given path prefixes with wallet signatures.

    On success, the authenticated address is stored as
    ``request["auth_address"]``.
    """
    from aiohttp import web

    prefixes = tuple(protected_prefixes)
    limiter = rate_limiter or RateLimiter()
    # None = no address filtering; an EMPTY allowlist fails closed (rejects
    # every address) — callers that want an open surface must pass None
    # explicitly rather than an empty list.
    allow = (
        {a.lower() for a in allowed_addresses}
        if allowed_addresses is not None
        else None
    )

    @web.middleware
    async def middleware(request: web.Request, handler):
        if not any(request.path.startswith(p) for p in prefixes):
            return await handler(request)

        if request.content_length and request.content_length > max_body_bytes:
            return web.json_response(
                {"success": False, "error": "body too large"}, status=413
            )

        body = None
        if request.method in ("POST", "PUT", "PATCH", "DELETE") and request.can_read_body:
            raw = await request.read()
            if len(raw) > max_body_bytes:
                return web.json_response(
                    {"success": False, "error": "body too large"}, status=413
                )
            if raw:
                try:
                    body = json.loads(raw)
                except json.JSONDecodeError:
                    return web.json_response(
                        {"success": False, "error": "invalid json"}, status=400
                    )

        # signed-timestamp freshness: bounds replay of bodyless (GET) requests
        # to the skew window; body requests additionally carry the nonce cache
        try:
            ts = float(request.headers.get("x-timestamp", ""))
        except ValueError:
            return web.json_response(
                {"success": False, "error": "missing timestamp"}, status=401
            )
        if abs(time.time() - ts) > NONCE_TTL_SECONDS:
            return web.json_response(
                {"success": False, "error": "stale timestamp"}, status=401
            )

        # allowlist gate runs BEFORE verification on the CLAIMED address:
        # rejecting a never-allowed address needs no crypto, and the
        # secp/keccak verify path is CPU work an unauthenticated stranger
        # should not get to purchase
        claimed = (request.headers.get("x-address") or "").lower()
        if allow is not None and claimed not in allow:
            return web.json_response(
                {"success": False, "error": "address not allowed"}, status=401
            )

        # pass the CIMultiDict through: its .get is case-insensitive, so
        # clients sending X-Address/X-Signature (standard casing) still
        # authenticate. Verification runs in a thread: Ed25519 is
        # C-speed, but the EvmWallet path keccaks the full message in
        # Python (capped at EVM_MAX_MESSAGE_BYTES) — the event loop must
        # not stall behind it
        address = await asyncio.to_thread(
            verify_request, request.path, request.headers, body
        )
        if address is None:
            return web.json_response(
                {"success": False, "error": "invalid signature"}, status=401
            )

        if body is None:
            # replay-cache the signature itself for the freshness window.
            # kv.set runs in a thread: with a RemoteKVStore (api-mode
            # replicas) it is a blocking HTTP round-trip
            sig = request.headers.get("x-signature", "")
            fresh = await asyncio.to_thread(
                kv.set, f"sig:{sig}", "1", nx=True, ex=NONCE_TTL_SECONDS * 2
            )
            if not fresh:
                return web.json_response(
                    {"success": False, "error": "signature replay"}, status=401
                )

        if not limiter.allow(address):
            return web.json_response(
                {"success": False, "error": "rate limited"}, status=429
            )

        # nonce: required on signed bodies; format-checked and replay-cached
        if body is not None:
            nonce = body.get("nonce")
            if not nonce or not _nonce_valid(str(nonce)):
                return web.json_response(
                    {"success": False, "error": "invalid nonce"}, status=401
                )
            fresh = await asyncio.to_thread(
                kv.set, f"nonce:{nonce}", "1", nx=True, ex=NONCE_TTL_SECONDS
            )
            if not fresh:
                return web.json_response(
                    {"success": False, "error": "nonce replay"}, status=401
                )

        if validator is not None and not await validator(address):
            return web.json_response(
                {"success": False, "error": "address rejected"}, status=401
            )

        request["auth_address"] = address
        request["auth_body"] = body
        return await handler(request)

    return middleware


def api_key_middleware(api_key: str, protected_prefixes: Iterable[str]):
    """``Authorization: Bearer <key>`` guard for admin routes
    (api_key_middleware.rs)."""
    from aiohttp import web

    prefixes = tuple(protected_prefixes)

    @web.middleware
    async def middleware(request: web.Request, handler):
        if not any(request.path.startswith(p) for p in prefixes):
            return await handler(request)
        header = request.headers.get("Authorization", "")
        if header != f"Bearer {api_key}":
            return web.json_response(
                {"success": False, "error": "unauthorized"}, status=401
            )
        return await handler(request)

    return middleware
