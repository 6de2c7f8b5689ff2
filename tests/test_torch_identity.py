"""Identity: seeded keypairs, discovery keys, signatures."""

from symmetry_tpu_torch.identity import Identity, discovery_key


def test_seeded_keypair_deterministic():
    # Capability parity: reference seeds identity from a fixed 32-byte buffer
    # (src/provider.ts:41-43) — same seed must yield the same identity.
    a = Identity.from_seed(b"\x01" * 32)
    b = Identity.from_seed(b"\x01" * 32)
    c = Identity.from_seed(b"\x02" * 32)
    assert a.public_key == b.public_key
    assert a.public_key != c.public_key


def test_from_name_deterministic_and_secret_salted():
    assert Identity.from_name("node").public_key == Identity.from_name("node").public_key
    assert (
        Identity.from_name("node", secret=b"s1").public_key
        != Identity.from_name("node", secret=b"s2").public_key
    )


def test_sign_verify():
    ident = Identity.generate()
    sig = ident.sign(b"challenge-bytes")
    assert Identity.verify(b"challenge-bytes", sig, ident.public_key)
    assert not Identity.verify(b"other-bytes", sig, ident.public_key)
    assert not Identity.verify(b"challenge-bytes", b"\x00" * 64, ident.public_key)
    assert not Identity.verify(b"challenge-bytes", sig, Identity.generate().public_key)
    assert not Identity.verify(b"challenge-bytes", sig, b"short")


def test_discovery_key_stable_and_hiding():
    ident = Identity.from_seed(b"\x07" * 32)
    dk = discovery_key(ident.public_key)
    assert len(dk) == 32
    assert dk == ident.discovery_key
    assert dk != ident.public_key  # topic must not reveal the key


def test_repr_leaks_nothing():
    ident = Identity.from_seed(b"\x09" * 32)
    assert "private" not in repr(ident).lower()
    assert ident.public_hex[:16] in repr(ident)
