"""Shared keep-alive JSON POST transport for the remote KV/ledger clients
(``protocol_tpu/utils/http_client.py``, copied).

One per-thread persistent connection (fresh TCP handshakes per op
dominated measured client latency), honoring any path prefix in the base
URL (ingress-routed deployments). No proxy support by design: these
clients speak pod-to-pod inside a cluster; HTTP(S)_PROXY env vars are
deliberately not consulted.

Retry policy — the part that must not be casual: a request that failed
while SENDING never reached the server and is always safe to resend
(including the stale kept-alive socket the server closed while idle). A
failure while READING the response is ambiguous — the server may have
applied the request — so it is retried only when the caller marks the
operation response-retryable. That flag is safe for reads always; for
WRITES it is safe only when the caller makes the resend idempotent
end-to-end (e.g. RemoteLedger attaches a per-call tx_id the ledger API
deduplicates — a resent applied-but-response-lost write replays the
recorded outcome). A write without such a peer-side guarantee must NOT
set it, or a lost response can double-apply.
"""

from __future__ import annotations

import http.client
import json
import threading
import urllib.parse
from typing import Optional, Type

from protocol_tpu_torch.utils.tls import env_client_ssl_context


class KeepAliveJsonClient:
    def __init__(
        self,
        base_url: str,
        timeout: float,
        error_cls: Type[Exception],
    ):
        parsed = urllib.parse.urlparse(base_url.rstrip("/"))
        self._https = parsed.scheme == "https"
        self._netloc = parsed.netloc
        self._prefix = parsed.path.rstrip("/")
        self.timeout = timeout
        self.error_cls = error_cls
        # https peers are verified against the deployment CA
        # (PROTOCOL_TPU_TLS_CA) or system trust — never unverified
        self._ssl_context = env_client_ssl_context() if self._https else None
        self._tlocal = threading.local()

    def _connection(self):
        conn = getattr(self._tlocal, "conn", None)
        if conn is None:
            if self._https:
                import ssl as _ssl

                conn = http.client.HTTPSConnection(
                    self._netloc,
                    timeout=self.timeout,
                    context=self._ssl_context or _ssl.create_default_context(),
                )
            else:
                conn = http.client.HTTPConnection(
                    self._netloc, timeout=self.timeout
                )
            self._tlocal.conn = conn
        return conn

    def drop_connection(self) -> None:
        conn = getattr(self._tlocal, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass
            self._tlocal.conn = None

    def post(
        self,
        path: str,
        payload: dict,
        headers: Optional[dict] = None,
        retry_response: bool = False,
    ) -> dict:
        """POST json, return the parsed body (also for error statuses —
        callers inspect {"success": ...}). ``retry_response=True`` marks
        the op safe to resend after a failure while reading the response
        (reads, or writes the peer deduplicates — see module docstring)."""
        body = json.dumps(payload)
        hdrs = {"Content-Type": "application/json", **(headers or {})}
        full_path = f"{self._prefix}{path}"
        for attempt in (0, 1):
            conn = self._connection()
            try:
                conn.request("POST", full_path, body=body, headers=hdrs)
            except (http.client.HTTPException, OSError) as e:
                # send phase: the request never completed transmission —
                # always safe to retry once on a fresh connection
                self.drop_connection()
                if attempt == 0:
                    continue
                raise self.error_cls(f"unreachable: {e}") from e
            try:
                resp = conn.getresponse()
                raw = resp.read()
            except (http.client.HTTPException, OSError) as e:
                self.drop_connection()
                if attempt == 0 and retry_response:
                    continue
                raise self.error_cls(
                    f"no response ({'retryable read' if retry_response else 'write; not retried'}): {e}"
                ) from e
            try:
                return json.loads(raw)
            except json.JSONDecodeError as e:
                self.drop_connection()
                raise self.error_cls(
                    f"bad response (HTTP {resp.status})"
                ) from e
        raise self.error_cls("unreachable")
