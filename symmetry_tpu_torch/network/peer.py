"""Peer: an authenticated, encrypted, message-oriented connection.

The unit the whole control plane speaks over — equivalent to the reference's
hyperswarm `Peer` (src/types.ts:124-180: noise-encrypted duplex with
publicKey + write/on('data')), but message-framed and with enforced mutual
authentication (the reference's verification is advisory-only,
src/provider.ts:157-167).

    peer = await Peer.connect(conn, identity, initiator=True)
    await peer.send(MessageKey.PING)
    async for msg in peer:            # Message(key=..., data=...)
        ...
"""

from __future__ import annotations

from typing import Any, AsyncIterator

from symmetry_tpu_torch.identity import (
    Identity,
    SecureSession,
    client_handshake,
    discovery_key,
    server_handshake,
)
from symmetry_tpu_torch.protocol.framing import FrameError
from symmetry_tpu_torch.protocol.messages import Message, create_message, parse_message
from symmetry_tpu_torch.transport.base import Connection
from symmetry_tpu_torch.utils.logging import logger


class Peer:
    def __init__(self, conn: Connection, session: SecureSession) -> None:
        self._conn = conn
        self._session = session
        self.raw_bytes_written = 0  # wire counters, reference src/types.ts:148-149
        self.raw_bytes_read = 0

    @classmethod
    async def connect(
        cls,
        conn: Connection,
        identity: Identity,
        *,
        initiator: bool,
        expected_remote_key: bytes | None = None,
    ) -> "Peer":
        """Run the handshake; on any auth failure the connection is closed and
        the HandshakeError propagates (never stay connected unauthenticated)."""
        try:
            if initiator:
                session = await client_handshake(conn, identity, expected_remote_key)
            else:
                session = await server_handshake(conn, identity, expected_remote_key)
        except Exception:
            await conn.close()
            raise
        return cls(conn, session)

    @property
    def remote_public_key(self) -> bytes:
        return self._session.remote_public_key

    @property
    def remote_public_hex(self) -> str:
        return self._session.remote_public_key.hex()

    @property
    def remote_discovery_key(self) -> bytes:
        return discovery_key(self._session.remote_public_key)

    @property
    def remote_address(self) -> str:
        return self._conn.remote_address

    @property
    def closed(self) -> bool:
        return self._conn.closed

    @property
    def write_stats(self) -> dict | None:
        """The transport's emit-path write counters (transport/base.py
        WriteCork), when it tracks them."""
        return self._conn.write_stats

    async def send(self, key: str, data: Any = None) -> None:
        payload = create_message(key, data)
        ct = self._session.encrypt(payload)
        self.raw_bytes_written += len(ct)
        await self._conn.send(ct)

    async def send_raw(self, payload: bytes) -> None:
        """Send pre-encoded message bytes (hot path: token chunks)."""
        ct = self._session.encrypt(payload)
        self.raw_bytes_written += len(ct)
        await self._conn.send(ct)

    async def recv(self) -> Message | None:
        """Next message, or None on EOF. Malformed messages are skipped."""
        while True:
            try:
                frame = await self._conn.recv()
            except (FrameError, ConnectionError, OSError) as exc:
                logger.warning(f"dropping peer {self.remote_public_hex[:12]}: {exc}")
                await self.close()
                return None
            if frame is None:
                return None
            self.raw_bytes_read += len(frame)
            try:
                payload = self._session.decrypt(frame)
            except Exception as exc:
                logger.warning(f"dropping peer {self.remote_public_hex[:12]}: {exc}")
                await self.close()
                return None
            msg = parse_message(payload)
            if msg is None:
                logger.debug("skipping malformed message from", self.remote_public_hex[:12])
                continue
            return msg

    def __aiter__(self) -> AsyncIterator[Message]:
        return self._iter()

    async def _iter(self) -> AsyncIterator[Message]:
        while True:
            msg = await self.recv()
            if msg is None:
                return
            yield msg

    async def close(self) -> None:
        await self._conn.close()
