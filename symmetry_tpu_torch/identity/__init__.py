from symmetry_tpu_torch.identity.identity import Identity, discovery_key
from symmetry_tpu_torch.identity.noise import (
    HandshakeError,
    SecureSession,
    client_handshake,
    server_handshake,
)

__all__ = [
    "Identity",
    "discovery_key",
    "HandshakeError",
    "SecureSession",
    "client_handshake",
    "server_handshake",
]
