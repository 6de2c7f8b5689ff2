"""Authenticated encrypted channel: Noise-XX-pattern handshake, SIGMA-style auth.

The reference gets per-peer encryption from @hyperswarm/secret-stream (Noise XX
over libsodium; surfaced at src/types.ts:139,168-177 as `noiseStream`/`_encrypt`)
and does an *additional*, advisory-only challenge/signature verification of the
server (src/provider.ts:143-171 — logs ❌ but stays connected on failure).

This module provides the equivalent channel with the auth actually enforced:

  handshake (over length-framed plaintext frames):
    m1  I→R: eph_I                              (32B X25519 ephemeral)
    m2  R→I: eph_R ‖ Enc_k0(static_R ‖ sig_R)   sig over transcript hash
    m3  I→R: Enc_k0(static_I ‖ sig_I)

  k0 = HKDF(DH(eph, eph)) — so static identities travel encrypted (XX privacy
  property); each side signs the transcript hash with its Ed25519 identity
  (SIGMA-style explicit auth, stronger than implicit static-DH and reuses the
  node's one identity key). A handshake failure raises and the connection MUST
  be dropped by the caller — verification is not advisory.

  transport: ChaCha20-Poly1305 per direction, 64-bit counter nonces, with the
  transcript hash as the channel binding (used as AAD).

All primitives come from the `cryptography` package (OpenSSL-backed); a native
C++ cipher path for the streaming hot loop lives in native/.
"""

from __future__ import annotations

import hashlib
import hmac
import struct
from dataclasses import dataclass

from cryptography.hazmat.primitives.asymmetric.x25519 import (
    X25519PrivateKey,
    X25519PublicKey,
)
from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
from cryptography.hazmat.primitives import serialization

from symmetry_tpu_torch.identity.identity import Identity

_PROTO = b"symmetry-tpu/noise-xx-sigma/chacha20poly1305/blake2b:v1"


class HandshakeError(Exception):
    """Peer failed authentication or sent a malformed handshake. Drop the peer."""


def _hkdf(ikm: bytes, info: bytes, length: int) -> bytes:
    """HKDF-extract+expand over HMAC-BLAKE2b-512."""
    prk = hmac.new(b"\x00" * 64, ikm, hashlib.blake2b).digest()
    out = b""
    block = b""
    counter = 1
    while len(out) < length:
        block = hmac.new(prk, block + info + bytes([counter]), hashlib.blake2b).digest()
        out += block
        counter += 1
    return out[:length]


def _th(*parts: bytes) -> bytes:
    """Transcript hash."""
    h = hashlib.blake2b(digest_size=32)
    for p in parts:
        h.update(struct.pack(">I", len(p)))
        h.update(p)
    return h.digest()


@dataclass(repr=False)
class SecureSession:
    """Symmetric transport state after a completed handshake."""

    send_key: bytes
    recv_key: bytes
    remote_public_key: bytes  # authenticated remote Ed25519 identity
    channel_binding: bytes    # transcript hash; AAD for every transport frame

    def __repr__(self) -> str:  # never leak session keys into logs/tracebacks
        return f"SecureSession(remote={self.remote_public_key.hex()[:16]}…)"

    def __post_init__(self) -> None:
        self._send = ChaCha20Poly1305(self.send_key)
        self._recv = ChaCha20Poly1305(self.recv_key)
        self._send_n = 0
        self._recv_n = 0

    def _nonce(self, counter: int) -> bytes:
        return b"\x00\x00\x00\x00" + struct.pack("<Q", counter)

    def encrypt(self, plaintext: bytes) -> bytes:
        ct = self._send.encrypt(self._nonce(self._send_n), plaintext, self.channel_binding)
        self._send_n += 1
        return ct

    def decrypt(self, ciphertext: bytes) -> bytes:
        try:
            pt = self._recv.decrypt(self._nonce(self._recv_n), ciphertext, self.channel_binding)
        except Exception as exc:  # cryptography raises InvalidTag
            raise HandshakeError(f"transport decrypt failed: {exc}") from exc
        self._recv_n += 1
        return pt


def _session_keys(dh_ee: bytes, transcript: bytes, *, initiator: bool) -> tuple[bytes, bytes, bytes]:
    okm = _hkdf(dh_ee + transcript, _PROTO + b"/session", 64)
    k_i2r, k_r2i = okm[:32], okm[32:]
    if initiator:
        return k_i2r, k_r2i, transcript
    return k_r2i, k_i2r, transcript


def _auth_payload(identity: Identity, transcript: bytes, role: bytes) -> bytes:
    sig = identity.sign(_PROTO + role + transcript)
    return identity.public_key + sig


def _check_auth(payload: bytes, transcript: bytes, role: bytes,
                expected_remote_key: bytes | None) -> bytes:
    if len(payload) != 32 + 64:
        raise HandshakeError("malformed auth payload")
    static_pub, sig = payload[:32], payload[32:]
    if expected_remote_key is not None and static_pub != expected_remote_key:
        raise HandshakeError("remote static key does not match expected key")
    if not Identity.verify(_PROTO + role + transcript, sig, static_pub):
        raise HandshakeError("bad handshake signature")
    return static_pub


async def client_handshake(conn, identity: Identity,
                           expected_remote_key: bytes | None = None) -> SecureSession:
    """Initiator side. `conn` must expose async send(bytes)/recv()->bytes frames."""
    eph = X25519PrivateKey.generate()
    eph_pub = eph.public_key().public_bytes(
        serialization.Encoding.Raw, serialization.PublicFormat.Raw
    )
    await conn.send(eph_pub)

    m2 = await conn.recv()
    if m2 is None or len(m2) < 32:
        raise HandshakeError("handshake aborted")
    remote_eph_pub, ct = m2[:32], m2[32:]
    dh_ee = eph.exchange(X25519PublicKey.from_public_bytes(remote_eph_pub))
    k0 = ChaCha20Poly1305(_hkdf(dh_ee, _PROTO + b"/hs", 32))

    t1 = _th(_PROTO, eph_pub, remote_eph_pub)
    try:
        payload = k0.decrypt(b"\x00" * 11 + b"\x00", ct, t1)
    except Exception as exc:
        raise HandshakeError(f"m2 decrypt failed: {exc}") from exc
    remote_static = _check_auth(payload, t1, b"resp", expected_remote_key)

    t2 = _th(t1, payload)
    my_auth = _auth_payload(identity, t2, b"init")
    await conn.send(k0.encrypt(b"\x00" * 11 + b"\x01", my_auth, t2))

    transcript = _th(t2, my_auth)
    send_key, recv_key, binding = _session_keys(dh_ee, transcript, initiator=True)
    return SecureSession(send_key, recv_key, remote_static, binding)


async def server_handshake(conn, identity: Identity,
                           expected_remote_key: bytes | None = None) -> SecureSession:
    """Responder side."""
    m1 = await conn.recv()
    if m1 is None or len(m1) != 32:
        raise HandshakeError("bad m1")
    remote_eph_pub = m1
    eph = X25519PrivateKey.generate()
    eph_pub = eph.public_key().public_bytes(
        serialization.Encoding.Raw, serialization.PublicFormat.Raw
    )
    dh_ee = eph.exchange(X25519PublicKey.from_public_bytes(remote_eph_pub))
    k0 = ChaCha20Poly1305(_hkdf(dh_ee, _PROTO + b"/hs", 32))

    t1 = _th(_PROTO, remote_eph_pub, eph_pub)
    my_auth = _auth_payload(identity, t1, b"resp")
    await conn.send(eph_pub + k0.encrypt(b"\x00" * 11 + b"\x00", my_auth, t1))

    t2 = _th(t1, my_auth)
    m3 = await conn.recv()
    if m3 is None:
        raise HandshakeError("handshake aborted")
    try:
        payload = k0.decrypt(b"\x00" * 11 + b"\x01", m3, t2)
    except Exception as exc:
        raise HandshakeError(f"m3 decrypt failed: {exc}") from exc
    remote_static = _check_auth(payload, t2, b"init", expected_remote_key)

    transcript = _th(t2, payload)
    send_key, recv_key, binding = _session_keys(dh_ee, transcript, initiator=False)
    return SecureSession(send_key, recv_key, remote_static, binding)
