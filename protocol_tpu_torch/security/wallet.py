"""Wallet: keypair identity with a derived on-ledger address
(``protocol_tpu/security/wallet.py``, copied; ``cryptography`` is imported
where a key is made, a message signed or a signature verified, not when the
module is imported).

Reference counterpart: crates/shared/src/web3/wallet.rs:28-68 (alloy
PrivateKeySigner, secp256k1 ECDSA + keccak addresses). Two schemes share
one wire format and one verifier here:

- :class:`Wallet` (default): Ed25519, address =
  ``0x + sha256(pubkey)[:20].hex()`` — the TPU-substrate native scheme.
- :class:`EvmWallet`: secp256k1 ECDSA over ``keccak256(message)``,
  address = ``0x + keccak256(uncompressed_pubkey[1:])[-20:].hex()`` —
  bit-identical to Ethereum address derivation, so this identity can sign
  for / be credited at a real EVM address.

Signatures travel as ``<pubkey_hex>:<sig_hex>``; :func:`verify_signature`
dispatches on the embedded pubkey's length (32 bytes = Ed25519, 65 bytes
= uncompressed secp256k1), checks the pubkey hashes to the claimed
address, then verifies — the same trust-nothing property ECDSA recovery
gives, without needing a recovery id on the wire. Every consumer
(signer, middleware, ledger invites) is scheme-agnostic through this one
seam, which is the adapter point for real-chain interop.
"""

from __future__ import annotations

import functools
import hashlib
from typing import Optional


def _address_from_pubkey(pub_bytes: bytes) -> str:
    return "0x" + hashlib.sha256(pub_bytes).digest()[:20].hex()


# ---------------------------------------------------------------------------
# keccak-256 (the ORIGINAL Keccak padding, 0x01 — NOT sha3-256's 0x06, which
# is why hashlib can't provide it). Pure Python; only hashes short control
# messages, so throughput is irrelevant.
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1
_KECCAK_RC = (
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
)
_KECCAK_ROT = (
    (0, 36, 3, 41, 18),
    (1, 44, 10, 45, 2),
    (62, 6, 43, 15, 61),
    (28, 55, 25, 21, 56),
    (27, 20, 39, 8, 14),
)


def _rol64(v: int, n: int) -> int:
    if n == 0:
        return v
    return ((v << n) | (v >> (64 - n))) & _MASK64


def _keccak_f(a: list[list[int]]) -> list[list[int]]:
    for rc in _KECCAK_RC:
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol64(c[(x + 1) % 5], 1) for x in range(5)]
        a = [[a[x][y] ^ d[x] for y in range(5)] for x in range(5)]
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rol64(a[x][y], _KECCAK_ROT[x][y])
        a = [
            [b[x][y] ^ ((~b[(x + 1) % 5][y]) & b[(x + 2) % 5][y])
             for y in range(5)]
            for x in range(5)
        ]
        a[0][0] ^= rc
    return a


def keccak256(data: bytes) -> bytes:
    rate = 136  # 1600 - 2*256 bits
    p = bytearray(data)
    pad = rate - (len(p) % rate)
    if pad == 1:
        p += b"\x81"
    else:
        p += b"\x01" + b"\x00" * (pad - 2) + b"\x80"
    a = [[0] * 5 for _ in range(5)]
    for off in range(0, len(p), rate):
        for i in range(rate // 8):
            a[i % 5][i // 5] ^= int.from_bytes(
                p[off + 8 * i: off + 8 * i + 8], "little"
            )
        a = _keccak_f(a)
    return b"".join(a[i % 5][i // 5].to_bytes(8, "little") for i in range(4))


def _evm_address(uncompressed_pubkey: bytes) -> str:
    """Ethereum address: last 20 bytes of keccak256 over the 64-byte
    public-key coordinates (the leading 0x04 SEC1 tag is dropped)."""
    return "0x" + keccak256(uncompressed_pubkey[1:]).hex()[-40:]


def _ed25519():
    from cryptography.hazmat.primitives.asymmetric import ed25519

    return ed25519


class Wallet:
    def __init__(self, private_key: Optional["Ed25519PrivateKey"] = None):
        self._key = private_key or _ed25519().Ed25519PrivateKey.generate()
        self._pub_bytes = self._key.public_key().public_bytes_raw()
        self.address = _address_from_pubkey(self._pub_bytes)

    @classmethod
    def from_seed(cls, seed: bytes) -> "Wallet":
        """Deterministic wallet from a 32-byte seed (dev/test fixtures)."""
        if len(seed) != 32:
            seed = hashlib.sha256(seed).digest()
        return cls(_ed25519().Ed25519PrivateKey.from_private_bytes(seed))

    @classmethod
    def from_hex(cls, hex_key: str) -> "Wallet":
        return cls(_ed25519().Ed25519PrivateKey.from_private_bytes(
            bytes.fromhex(hex_key.removeprefix("0x"))))

    def private_key_hex(self) -> str:
        return self._key.private_bytes_raw().hex()

    def sign_message(self, message: bytes | str) -> str:
        """Returns '<pubkey_hex>:<sig_hex>'."""
        if isinstance(message, str):
            message = message.encode()
        sig = self._key.sign(message)
        return f"{self._pub_bytes.hex()}:{sig.hex()}"


_SECP_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141


@functools.lru_cache(maxsize=None)
def _secp():
    """(the ``ec`` module, its SECP256K1 curve, the prehashed ECDSA
    algorithm). cryptography's Prehashed only length-checks the digest (32
    bytes), so it signs/verifies a keccak digest fine under the SHA256
    label."""
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.hazmat.primitives.asymmetric.utils import Prehashed

    return ec, ec.SECP256K1(), ec.ECDSA(Prehashed(hashes.SHA256()))

# The pure-Python keccak runs ~8 s/MB: an unauthenticated party must not be
# able to buy that much verifier CPU. Control-plane messages (endpoint +
# timestamp + canonical JSON) are far below this; larger payloads travel
# the signed-URL artifact path, never the signed-JSON plane.
EVM_MAX_MESSAGE_BYTES = 64 * 1024

# ---------------------------------------------------------------------------
# secp256k1 group math for ECDSA public-key RECOVERY — the reference's wire
# carries a 65-byte r||s||v signature and derives the signer by recovery
# (alloy recover_address_from_msg, auth_signature_middleware.rs:386), with
# the EIP-191 personal-message digest. `cryptography` exposes no recovery,
# so the few group operations live here (Jacobian coordinates, one field
# inverse per recovery; ~ms per verify — control-plane rates, off the event
# loop, and size-capped like every keccak path).
# ---------------------------------------------------------------------------

_FP = 2**256 - 2**32 - 977  # secp256k1 field prime
_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8


def _jac_double(p):
    x, y, z = p
    if y == 0:
        return (0, 1, 0)
    s = (4 * x * y * y) % _FP
    m = (3 * x * x) % _FP  # a = 0 for secp256k1
    x2 = (m * m - 2 * s) % _FP
    y2 = (m * (s - x2) - 8 * pow(y, 4, _FP)) % _FP
    z2 = (2 * y * z) % _FP
    return (x2, y2, z2)


def _jac_add(p, q):
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1s, z2s = (z1 * z1) % _FP, (z2 * z2) % _FP
    u1, u2 = (x1 * z2s) % _FP, (x2 * z1s) % _FP
    s1, s2 = (y1 * z2s * z2) % _FP, (y2 * z1s * z1) % _FP
    if u1 == u2:
        if s1 != s2:
            return (0, 1, 0)  # inverse points
        return _jac_double(p)
    h = (u2 - u1) % _FP
    r = (s2 - s1) % _FP
    h2 = (h * h) % _FP
    h3 = (h2 * h) % _FP
    x3 = (r * r - h3 - 2 * u1 * h2) % _FP
    y3 = (r * (u1 * h2 - x3) - s1 * h3) % _FP
    z3 = (h * z1 * z2) % _FP
    return (x3, y3, z3)


def _jac_mul(k, point_affine):
    acc = (0, 1, 0)
    add = (point_affine[0], point_affine[1], 1)
    while k:
        if k & 1:
            acc = _jac_add(acc, add)
        add = _jac_double(add)
        k >>= 1
    return acc


def _jac_to_affine(p):
    if p[2] == 0:
        return None
    zinv = pow(p[2], _FP - 2, _FP)
    zinv2 = (zinv * zinv) % _FP
    return ((p[0] * zinv2) % _FP, (p[1] * zinv2 * zinv) % _FP)


def ecrecover(digest: bytes, r: int, s: int, v: int) -> Optional[bytes]:
    """Recover the uncompressed secp256k1 public key (65 bytes) from an
    ECDSA signature over ``digest``; v is the recovery id (0/1, or the
    Ethereum 27/28 form). Returns None for any invalid input."""
    if v >= 27:
        v -= 27
    if v not in (0, 1) or not (1 <= r < _SECP_N and 1 <= s < _SECP_N):
        return None
    if len(digest) != 32:
        return None
    # R: the curve point whose x-coordinate is r (the r + n overflow case
    # requires x in [n, p), a ~2^-128 sliver — rejected, as most verifiers do)
    x = r
    y_sq = (pow(x, 3, _FP) + 7) % _FP
    y = pow(y_sq, (_FP + 1) // 4, _FP)
    if (y * y) % _FP != y_sq:
        return None
    if y % 2 != v:
        y = _FP - y
    z = int.from_bytes(digest, "big")
    rinv = pow(r, _SECP_N - 2, _SECP_N)
    # Q = r^-1 * (s*R - z*G); _jac_mul takes an AFFINE base point, so the
    # inner sum is normalized before the final scalar multiply
    sR = _jac_mul(s, (x, y))
    zG = _jac_mul(z, (_GX, _GY))
    neg_zG = (zG[0], (-zG[1]) % _FP, zG[2])
    inner = _jac_to_affine(_jac_add(sR, neg_zG))
    if inner is None:
        return None
    q = _jac_to_affine(_jac_mul(rinv, inner))
    if q is None:
        return None
    return b"\x04" + q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big")


def eip191_digest(message: bytes) -> bytes:
    """keccak256 of the EIP-191 personal-message envelope — what
    alloy/MetaMask ``sign_message`` actually signs."""
    prefix = b"\x19Ethereum Signed Message:\n" + str(len(message)).encode()
    return keccak256(prefix + message)


class EvmWallet:
    """secp256k1/keccak wallet — the reference's exact signing scheme
    (crates/shared/src/web3/wallet.rs:28-68), producing REAL Ethereum
    addresses. Drop-in for :class:`Wallet` everywhere (same duck-type,
    same wire format); recovery is replaced by the embedded 65-byte
    uncompressed pubkey, which the verifier hashes back to the address."""

    def __init__(self, private_key: Optional["ec.EllipticCurvePrivateKey"] = None):
        ec, curve, _ = _secp()
        self._key = private_key or ec.generate_private_key(curve)
        pub = self._key.public_key().public_numbers()
        self._pub_bytes = (
            b"\x04" + pub.x.to_bytes(32, "big") + pub.y.to_bytes(32, "big")
        )
        self.address = _evm_address(self._pub_bytes)

    @classmethod
    def from_seed(cls, seed: bytes) -> "EvmWallet":
        """Deterministic wallet from a seed (dev/test fixtures)."""
        d = int.from_bytes(hashlib.sha256(seed).digest(), "big") % (_SECP_N - 1) + 1
        ec, curve, _ = _secp()
        return cls(ec.derive_private_key(d, curve))

    @classmethod
    def from_hex(cls, hex_key: str) -> "EvmWallet":
        d = int(hex_key.removeprefix("0x"), 16)
        ec, curve, _ = _secp()
        return cls(ec.derive_private_key(d, curve))

    def private_key_hex(self) -> str:
        return format(self._key.private_numbers().private_value, "064x")

    def sign_message(self, message: bytes | str) -> str:
        """Returns '<uncompressed_pubkey_hex>:<r||s hex>' over
        keccak256(message), with s normalized to the low half-order
        (EIP-2): a high-s twin of a valid signature is itself valid ECDSA,
        which would let an attacker mint a second wire-distinct signature
        for a captured request — and real Ethereum nodes reject high-s."""
        if isinstance(message, str):
            message = message.encode()
        if len(message) > EVM_MAX_MESSAGE_BYTES:
            raise ValueError(
                f"message of {len(message)} bytes exceeds the "
                f"{EVM_MAX_MESSAGE_BYTES}-byte keccak signing cap"
            )
        der = self._key.sign(keccak256(message), _secp()[2])
        from cryptography.hazmat.primitives.asymmetric.utils import decode_dss_signature

        r, s = decode_dss_signature(der)
        if s > _SECP_N // 2:
            s = _SECP_N - s
        sig = r.to_bytes(32, "big") + s.to_bytes(32, "big")
        return f"{self._pub_bytes.hex()}:{sig.hex()}"

    def sign_message_eth(self, message: bytes | str) -> str:
        """The reference's EXACT wire: ``0x`` + 65-byte r||s||v over the
        EIP-191 personal-message digest (what alloy's ``sign_message``
        emits, request_signer.rs:55-63) — verifiable by any Ethereum
        tool, and by :func:`verify_signature` via public-key recovery."""
        if isinstance(message, str):
            message = message.encode()
        if len(message) > EVM_MAX_MESSAGE_BYTES:
            raise ValueError(
                f"message of {len(message)} bytes exceeds the "
                f"{EVM_MAX_MESSAGE_BYTES}-byte keccak signing cap"
            )
        digest = eip191_digest(message)
        der = self._key.sign(digest, _secp()[2])
        from cryptography.hazmat.primitives.asymmetric.utils import decode_dss_signature

        r, s = decode_dss_signature(der)
        if s > _SECP_N // 2:
            s = _SECP_N - s
        # recovery id: the v whose recovered key is ours
        v = None
        for cand in (0, 1):
            if ecrecover(digest, r, s, cand) == self._pub_bytes:
                v = cand
                break
        if v is None:  # unreachable for a signature we just made
            raise ValueError("could not derive recovery id")
        sig = r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([27 + v])
        return "0x" + sig.hex()


class EvmRecoveryWallet(EvmWallet):
    """An :class:`EvmWallet` whose DEFAULT wire is the reference's
    recovery format (``0x`` + r||s||v over the EIP-191 digest) — i.e.
    exactly what an alloy or MetaMask client sends
    (request_signer.rs:55-63). Dropping this into the signer/middleware
    suites proves the whole control plane authenticates reference-format
    clients verbatim."""

    def sign_message(self, message: bytes | str) -> str:
        return self.sign_message_eth(message)


def verify_signature(message: bytes | str, signature: str, expected_address: str) -> bool:
    """Checks the signature verifies AND its embedded pubkey hashes to the
    claimed address (the recovery-equivalent step). Scheme is dispatched on
    the pubkey length: 32 bytes = Ed25519, 65 bytes = secp256k1/keccak."""
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives.asymmetric.utils import encode_dss_signature

    if isinstance(message, str):
        message = message.encode()
    if ":" not in signature:
        # the reference's recovery wire: 0x + 65-byte r||s||v over the
        # EIP-191 digest (auth_signature_middleware.rs:386 recovers the
        # address instead of carrying a pubkey) — signatures from real
        # Ethereum wallets verify here verbatim. STRICT canonical form
        # only (mandatory 0x, lowercase hex, v in {27,28}): every
        # accepted signature must have exactly one wire encoding, or a
        # re-encoded capture (uppercased hex, v rewritten 27->0) would
        # slip past the middleware's signature-string replay cache
        if not signature.startswith("0x") or signature != signature.lower():
            return False
        try:
            raw = bytes.fromhex(signature[2:])
        except ValueError:
            return False
        if len(raw) != 65 or len(message) > EVM_MAX_MESSAGE_BYTES:
            return False
        if raw[64] not in (27, 28):
            return False
        s_int = int.from_bytes(raw[32:64], "big")
        # low-s only (EIP-2): the high-s twin is an equally-valid ECDSA
        # signature with a DIFFERENT wire encoding, which would defeat
        # signature-keyed replay caches; alloy emits low-s, nothing legit
        # is lost
        if s_int > _SECP_N // 2:
            return False
        pub = ecrecover(
            eip191_digest(message),
            int.from_bytes(raw[:32], "big"),
            s_int,
            raw[64],
        )
        return pub is not None and _evm_address(pub) == expected_address.lower()
    try:
        pub_hex, sig_hex = signature.split(":", 1)
        pub_bytes = bytes.fromhex(pub_hex)
        sig = bytes.fromhex(sig_hex)
    except ValueError:
        return False
    if len(pub_bytes) == 65 and pub_bytes[0] == 4 and len(sig) == 64:
        # the pure-Python keccak is ~8 s/MB: refuse to hash attacker-sized
        # messages (the signer enforces the same cap)
        if len(message) > EVM_MAX_MESSAGE_BYTES:
            return False
        if _evm_address(pub_bytes) != expected_address.lower():
            return False
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:], "big")
        # reject the malleable high-s twin (EIP-2): otherwise one captured
        # request yields a second wire-distinct valid signature, defeating
        # any signature-keyed replay cache
        if r == 0 or s == 0 or s > _SECP_N // 2:
            return False
        ec, curve, prehashed = _secp()
        try:
            pub = ec.EllipticCurvePublicKey.from_encoded_point(curve, pub_bytes)
            pub.verify(
                encode_dss_signature(r, s), keccak256(message), prehashed
            )
            return True
        except (InvalidSignature, ValueError):
            return False
    if _address_from_pubkey(pub_bytes) != expected_address.lower():
        return False
    try:
        _ed25519().Ed25519PublicKey.from_public_bytes(pub_bytes).verify(sig, message)
        return True
    except (InvalidSignature, ValueError):
        return False
