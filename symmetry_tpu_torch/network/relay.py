"""Server-spliced relay: the NAT fallback when even punching fails.

The reference inherits relaying from the hyperdht stack (SURVEY §2.2:
"NAT holepunching, relaying"). Here the Symmetry server plays the relay:

    client ──(Noise)── server ──(Noise)── provider
              RELAY_DATA splice (broker)

Each end wraps its encrypted channel TO THE SERVER in a RelayedConnection
— a transport.base.Connection whose frames travel as RELAY_DATA messages —
and then runs the normal client↔provider Noise handshake THROUGH it
(network/peer.py with the provider key pinned). The server forwards only
ciphertext: it can deny service, but cannot read or impersonate either
end (the reference's relay has the same property via hypercore
end-to-end encryption).

Flow (keys in protocol/keys.py):
  client   → server : relayConnect {providerKey}
  server   → provider(control) : relayOpen {relayId}
  provider → server (new conn) : relayAccept {relayId}
  server   → both  : relayReady {relayId}
  both     ↔ server: relayData {frame b64}  (spliced)
  either   → server: relayClose / disconnect → teardown both ends
"""

from __future__ import annotations

import asyncio
import base64
from typing import Any

from symmetry_tpu_torch.protocol.keys import MessageKey
from symmetry_tpu_torch.transport.base import Connection
from symmetry_tpu_torch.utils.logging import logger


class RelayedConnection(Connection):
    """A Connection tunneled in RELAY_DATA messages over a Peer channel.

    Takes EXCLUSIVE ownership of the underlying peer's read loop: after
    construction nothing else may recv on that peer."""

    def __init__(self, peer: Any, relay_id: str) -> None:
        self._peer = peer
        self._relay_id = relay_id
        self._inbox: asyncio.Queue[bytes | None] = asyncio.Queue()
        self._closed = False
        self._reader = asyncio.get_running_loop().create_task(self._pump())

    async def _pump(self) -> None:
        try:
            async for msg in self._peer:
                if msg.key == MessageKey.RELAY_DATA:
                    frame = (msg.data or {}).get("frame", "")
                    try:
                        self._inbox.put_nowait(
                            base64.b64decode(frame, validate=True))
                    except (ValueError, TypeError):
                        continue
                elif msg.key == MessageKey.RELAY_CLOSE:
                    break
                # anything else on a spliced channel is a stray; ignore
        except (ConnectionError, OSError) as exc:
            logger.debug(f"relay pump ended: {exc}")
        finally:
            self._inbox.put_nowait(None)

    async def send(self, frame: bytes) -> None:
        if self._closed:
            raise ConnectionError("relayed connection closed")
        await self._peer.send(
            MessageKey.RELAY_DATA,
            {"id": self._relay_id,
             "frame": base64.b64encode(frame).decode()})

    async def recv(self) -> bytes | None:
        if self._closed:
            return None
        frame = await self._inbox.get()
        if frame is None:
            self._closed = True
        return frame

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            await self._peer.send(MessageKey.RELAY_CLOSE,
                                  {"id": self._relay_id})
        except (ConnectionError, OSError):
            pass
        self._reader.cancel()
        await self._peer.close()

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def remote_address(self) -> str:
        return f"relay://{self._relay_id}"


async def await_ready(peer: Any, relay_id: str | None = None,
                      timeout: float = 10.0) -> str:
    """Consume messages until relayReady; returns the relay id.

    With `relay_id` set (provider side) only that id completes the wait;
    with None (client side, which learns the id FROM relayReady) the
    first ready wins. The one shared implementation keeps both roles'
    refusal handling identical."""
    async def _wait() -> str:
        async for msg in peer:
            if msg.key == MessageKey.RELAY_READY:
                got = str((msg.data or {}).get("id", ""))
                if relay_id is None or got == relay_id:
                    return got
            elif msg.key == MessageKey.RELAY_CLOSE:
                raise ConnectionError("relay refused")
            elif msg.key == MessageKey.INFERENCE_ERROR:
                raise ConnectionError(
                    (msg.data or {}).get("error", "relay failed"))
        raise ConnectionError("server closed during relay setup")

    return await asyncio.wait_for(_wait(), timeout)
