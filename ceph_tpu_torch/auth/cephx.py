"""cephx-style mutual authentication for messenger connections.

Reference: src/auth/cephx (CephxProtocol.h: challenge/proof exchange with
HMAC over a shared secret; src/msg ProtocolV2's auth frames carry it).

Two credential modes, mirroring the reference's split between
intra-cluster keys and mon-brokered service tickets:

- Shared-secret peers (daemons, admin clients holding the keyring): the
  wire exchange (server challenge -> client proof + counter-challenge ->
  server proof) matches CephxProtocol's session-key handshake; the
  per-connection frame key is derived from both nonces
  (`session_key_from_nonces`).
- Ticket clients (no cluster secret): the mon mints a per-service ticket
  (`auth get-ticket` -> `mint_ticket`); the client presents the sealed
  blob and proves possession of the session key inside it; the serving
  daemon opens the blob with its DERIVED service key at the OSDMap's
  current auth generation (`validate_ticket`), so `auth rotate` cuts
  stale tickets off cluster-wide through the normal map-propagation path
  (the CephxKeyServer rotating_secrets role).

Wire form (one line each, after the messenger banner/ident):

    S->C  auth-challenge <snonce-hex> <service>
    C->S  auth-proof <hmac-hex> <cnonce-hex>            (secret holders)
    C->S  auth-ticket <blob-hex> <hmac-hex> <cnonce-hex>  (ticket clients)
    S->C  auth-ok <hmac-hex>

proofs: HMAC-SHA256(key, nonce || peer-entity-name), key = cluster
secret or the ticket session key.  After an authenticated handshake
EVERY frame carries a 16-byte HMAC tag over (per-direction counter ||
body) under the negotiated session key (`frame_tag`) — the ProtocolV2
signed-frames role; a bad tag is connection-fatal.  A server with auth
disabled sends no challenge (wire-compatible with unauthenticated
peers); a client expecting auth then times out — the same hard failure a
cephx-required cluster gives unauthenticated clients.
"""
from __future__ import annotations

import base64
import hashlib
import hmac
import json as _json
import os
import struct as _struct
import time as _time


class AuthError(Exception):
    pass


def generate_secret() -> str:
    """A fresh base64 cluster secret (`ceph-authtool --gen-key` analog)."""
    return base64.b64encode(os.urandom(32)).decode()


def proof_hex(key: bytes, nonce_hex: str, name: str) -> str:
    """HMAC(key, nonce || name) — the handshake proof shape, shared by the
    shared-secret and ticket-session-key flows."""
    return hmac.new(
        key, bytes.fromhex(nonce_hex) + name.encode(), hashlib.sha256
    ).hexdigest()


def session_key_from_nonces(secret: bytes, snonce_hex: str,
                            cnonce_hex: str) -> bytes:
    """Per-connection frame-signing key for two shared-secret holders —
    both sides saw both handshake nonces, so both derive it without an
    extra round trip (the role CephxProtocol's session_key plays for
    intra-cluster peers)."""
    return hmac.new(
        secret,
        b"sess:" + bytes.fromhex(snonce_hex) + bytes.fromhex(cnonce_hex),
        hashlib.sha256,
    ).digest()


def frame_tag(key: bytes, ctr: int, body: bytes) -> bytes:
    """16-byte per-frame auth tag: HMAC(session key, counter || body).
    The counter is per-direction, per-socket-incarnation, so a frame can
    be neither tampered with nor replayed/reordered within a session
    (reference: ProtocolV2 signed frames' rx/tx segment signatures)."""
    return hmac.new(
        key, _struct.pack("<Q", ctr) + body, hashlib.sha256
    ).digest()[:16]


class CephxAuthenticator:
    """Per-messenger auth engine; stateless besides the secret."""

    def __init__(self, secret_b64: str):
        try:
            self._secret = base64.b64decode(secret_b64.encode(), validate=True)
        except Exception as e:
            raise AuthError(f"bad auth_shared_secret: {e}") from e
        if len(self._secret) < 16:
            raise AuthError("auth_shared_secret shorter than 16 bytes")

    @property
    def secret(self) -> bytes:
        return self._secret

    def make_nonce(self) -> str:
        return os.urandom(16).hex()

    def proof(self, nonce_hex: str, name: str) -> str:
        return proof_hex(self._secret, nonce_hex, name)

    def verify(self, nonce_hex: str, name: str, proof_hex_: str) -> bool:
        return hmac.compare_digest(self.proof(nonce_hex, name), proof_hex_)

    def session_key(self, snonce_hex: str, cnonce_hex: str) -> bytes:
        return session_key_from_nonces(self._secret, snonce_hex, cnonce_hex)


# -- tickets (reference: src/auth/cephx CephxKeyServer / CephXTicketBlob) --
#
# Service keys are DERIVED, not distributed: key(service, gen) =
# HMAC(cluster-secret, "svc:{service}:{gen}").  The current generation per
# service lives in the OSDMap (OSDMap.auth_gens), so `auth rotate` is a
# map change that reaches every daemon through the normal paxos/subscribe
# path — the role CephxKeyServer's rotating_secrets distribution plays.
# Daemons accept {gen, gen-1} (the reference keeps the previous rotating
# secret for a grace window); anything older unseals to nothing and the
# ticket is refused.


def _keystream(key: bytes, n: int) -> bytes:
    """SHA256-counter keystream (stand-in for the reference's AES-CBC —
    the properties the tests pin are integrity, expiry, and rotation
    refusal; the stream hides the session key from a passive reader)."""
    out = bytearray()
    ctr = 0
    while len(out) < n:
        out += hashlib.sha256(key + _struct.pack("<Q", ctr)).digest()
        ctr += 1
    return bytes(out[:n])


def seal(key: bytes, obj: dict) -> str:
    """Encrypt-then-MAC a JSON payload under `key`; hex blob."""
    pt = _json.dumps(obj, sort_keys=True).encode()
    iv = os.urandom(8)
    ct = bytes(a ^ b for a, b in zip(pt, _keystream(key + iv, len(pt))))
    tag = hmac.new(key, iv + ct, hashlib.sha256).digest()[:16]
    return (iv + tag + ct).hex()


def unseal(key: bytes, blob_hex: str) -> dict | None:
    """None on ANY failure (wrong key/generation, tamper, garbage)."""
    try:
        raw = bytes.fromhex(blob_hex)
        iv, tag, ct = raw[:8], raw[8:24], raw[24:]
        want = hmac.new(key, iv + ct, hashlib.sha256).digest()[:16]
        if not hmac.compare_digest(tag, want):
            return None
        pt = bytes(a ^ b for a, b in zip(ct, _keystream(key + iv, len(ct))))
        return _json.loads(pt.decode())
    except Exception:
        return None


def derive_service_key(secret: bytes, service: str, gen: int) -> bytes:
    return hmac.new(secret, f"svc:{service}:{gen}".encode(),
                    hashlib.sha256).digest()


def derive_s3_secret(secret: bytes, access_key: str, gen: int) -> str:
    """Hex S3 secret key for the RGW SigV4 surface — same
    derive-don't-store pattern as service keys, rotated by the "rgw"
    auth generation (used by the mon's `auth get-s3-key` and the
    gateway's verifier; reference: RGWUserInfo credentials, here backed
    by the cephx cluster secret instead of a user database)."""
    return hmac.new(
        secret, f"s3:{access_key}:{gen}".encode(), hashlib.sha256
    ).hexdigest()


def mint_ticket(secret: bytes, entity: str, service: str, gen: int,
                ttl: float) -> tuple[str, str]:
    """(sealed ticket blob, session_key_hex).  The blob is sealed under
    the SERVICE key — only daemons of that service can open it; the
    session key returns to the requesting client over its authenticated,
    frame-signed mon session (`auth get-ticket`), standing in for the
    reference's seal-under-client-key step."""
    session_key = os.urandom(32).hex()
    blob = seal(derive_service_key(secret, service, gen), {
        "entity": entity,
        "service": service,
        "session_key": session_key,
        "expires": _time.time() + ttl,
        "gen": gen,
    })
    return blob, session_key


def validate_ticket(secret: bytes, service: str, current_gen: int,
                    blob_hex: str) -> dict | None:
    """Daemon-side check: try the current generation and one before (the
    rotation grace window); enforce service binding and expiry.  None =
    refuse the connection."""
    for gen in (current_gen, current_gen - 1):
        if gen < 1:
            continue
        t = unseal(derive_service_key(secret, service, gen), blob_hex)
        if t is None:
            continue
        if t.get("service") != service or t.get("gen") != gen:
            return None
        if t.get("expires", 0) < _time.time():
            return None
        return t
    return None
