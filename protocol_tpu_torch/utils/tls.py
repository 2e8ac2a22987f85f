"""TLS for the wire: confidentiality to match the reference's transport
(``protocol_tpu/utils/tls.py``, its context and session helpers copied;
the public-trust session and the dev PKI generator are left out, as no
entry point of the port uses them).

The reference's control RPCs ride libp2p TCP+Noise+Yamux
(crates/p2p/src/lib.rs:324-335) — encrypted AND mutually authenticated.
Mutual authentication rides wallet signatures on every request
(security/signer.py); this module adds confidentiality: standard TLS on
every aiohttp server and keep-alive client, driven by cert/key paths in
serve.py's arguments.

  server_ssl_context(cert, key)   for aiohttp TCPSite
  client_ssl_context(ca)          verify servers against a deployment CA
                                  (PROTOCOL_TPU_TLS_CA env, or system trust)
  env_client_session()            the control plane's aiohttp client
"""

from __future__ import annotations

import os
import ssl
from typing import Optional


def server_ssl_context(cert_path: str, key_path: str) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_path, key_path)
    return ctx


def client_ssl_context(ca_path: Optional[str] = None) -> ssl.SSLContext:
    """Verifying client context. ``ca_path`` PINS a deployment CA — it
    REPLACES system trust, so only certs chaining to the operator's CA are
    accepted on the control plane (any public CA being able to mint an
    accepted cert would defeat pinning). None uses system trust. Public
    endpoints (GCS/S3 signed URLs, geolocation) must use a SEPARATE
    system-trust session (the reference's public_client_session)."""
    if ca_path:
        return ssl.create_default_context(cafile=ca_path)
    return ssl.create_default_context()


def env_client_ssl_context() -> Optional[ssl.SSLContext]:
    """The ambient client context: PROTOCOL_TPU_TLS_CA names the CA file.
    Returns None when unset (plaintext deployments stay plaintext)."""
    ca = os.environ.get("PROTOCOL_TPU_TLS_CA", "")
    return client_ssl_context(ca) if ca else None


def env_client_session():
    """aiohttp session for INTERNAL peers (discovery/orchestrator/worker/
    validator/ledger/kv): verifies against the pinned deployment CA when
    PROTOCOL_TPU_TLS_CA is set. The single construction point for the
    control plane's client transport (serve.py services and the operator
    CLI both use it)."""
    import aiohttp

    ctx = env_client_ssl_context()
    if ctx is None:
        return aiohttp.ClientSession()
    return aiohttp.ClientSession(connector=aiohttp.TCPConnector(ssl=ctx))
