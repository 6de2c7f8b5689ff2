"""Node identity: seeded Ed25519 keypairs + discovery keys.

Capability parity with the reference's use of hypercore-crypto
(reference: src/provider.ts:41-44, global.d.ts:37-50):

  - `crypto.keyPair(seed)`      → `Identity.from_seed(seed)` (deterministic)
  - `crypto.discoveryKey(pub)`  → `discovery_key(pub)` = BLAKE2b-32 of the
                                   public key under a fixed personalization
  - `crypto.verify(msg,sig,pk)` → `Identity.verify(...)`

The reference seeds the keypair from the provider *name* padded to 32 bytes
(src/provider.ts:41-43) — deterministic but collision-prone and guessable.
We keep seeded determinism as a capability (stable identity across restarts)
but derive the seed from a name + a locally persisted random secret, or accept
an explicit 32-byte seed.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field

from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives import serialization
from cryptography.hazmat.primitives.asymmetric.ed25519 import (
    Ed25519PrivateKey,
    Ed25519PublicKey,
)

_DISCOVERY_PERSON = b"symmetry-tpu"  # blake2b personalization (≤16 bytes)


def discovery_key(public_key: bytes) -> bytes:
    """32-byte topic derived from a public key.

    Same shape as hypercore-crypto's discoveryKey (BLAKE2b(pub) under a fixed
    personalization): peers can rendezvous on the hash of a key without
    revealing the key to the DHT.
    """
    return hashlib.blake2b(public_key, digest_size=32, person=_DISCOVERY_PERSON).digest()


def derive_seed(name: str, secret: bytes = b"") -> bytes:
    """Deterministic 32-byte seed from a human name (+ optional local secret).

    The secret enters as the blake2b MAC key, not by concatenation, so
    ('ab', b'c') and ('a', b'bc') cannot collide.
    """
    return hashlib.blake2b(
        name.encode("utf-8"), digest_size=32, key=secret[:64],
        person=b"symmetry-seed",
    ).digest()


@dataclass(frozen=True)
class Identity:
    """An Ed25519 signing identity. Equality/hash are by public key."""

    _private: Ed25519PrivateKey = field(compare=False)
    public_key: bytes = b""  # 32 raw bytes

    @classmethod
    def from_seed(cls, seed: bytes) -> "Identity":
        if len(seed) != 32:
            raise ValueError("seed must be exactly 32 bytes")
        priv = Ed25519PrivateKey.from_private_bytes(seed)
        pub = priv.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw
        )
        return cls(priv, pub)

    @classmethod
    def from_name(cls, name: str, secret: bytes = b"") -> "Identity":
        return cls.from_seed(derive_seed(name, secret))

    @classmethod
    def generate(cls) -> "Identity":
        return cls.from_seed(os.urandom(32))

    def sign(self, message: bytes) -> bytes:
        return self._private.sign(message)

    @staticmethod
    def verify(message: bytes, signature: bytes, public_key: bytes) -> bool:
        """Verify a detached signature; False instead of raising on bad input."""
        try:
            Ed25519PublicKey.from_public_bytes(public_key).verify(signature, message)
            return True
        except (InvalidSignature, ValueError):
            return False

    @property
    def discovery_key(self) -> bytes:
        return discovery_key(self.public_key)

    @property
    def public_hex(self) -> str:
        return self.public_key.hex()

    def __repr__(self) -> str:  # never leak private material
        return f"Identity(pub={self.public_hex[:16]}…)"
