"""asyncio TCP transport with length-framed frames.

Production DCN/internet path. Where the reference rides UDX reliable-UDP
streams (dep udx-native; SURVEY §2.2), we use TCP via asyncio: same reliable
ordered byte-stream contract, with explicit 4-byte length framing restoring
message boundaries (symmetry_tpu.protocol.framing). Backpressure maps the
reference's `write()/drain` discipline (src/provider.ts:248-252) onto
`await writer.drain()`.
"""

from __future__ import annotations

import asyncio
from collections import deque

from symmetry_tpu_torch.protocol.framing import FrameReader, encode_frame
from symmetry_tpu_torch.transport.base import (
    Connection,
    ConnectionHandler,
    Listener,
    Transport,
    WriteCork,
)
from symmetry_tpu_torch.utils.logging import logger


def _parse(address: str) -> tuple[str, int]:
    """Parse 'tcp://host:port', including IPv6 literals like tcp://[::1]:9410."""
    addr = address.removeprefix("tcp://")
    host, sep, port = addr.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"bad tcp address {address!r}: expected tcp://host:port")
    if host.startswith("[") and host.endswith("]"):
        host = host[1:-1]
    return host or "127.0.0.1", int(port)


class TcpConnection(Connection):
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        self._reader = reader
        self._writer = writer
        self._frames = FrameReader()
        self._pending: deque[bytes] = deque()
        self._closed = False
        # Per-connection write cork: frames sent in the same event-loop
        # tick (the provider fan-out of one batched engine block to this
        # peer's streams) leave in one write+drain instead of one each.
        self._cork = WriteCork(self._write_drain)

    async def _write_drain(self, data: bytes) -> None:
        self._writer.write(data)
        await self._writer.drain()

    async def send(self, frame: bytes) -> None:
        if self._closed:
            raise ConnectionError("connection closed")
        await self._cork.send(encode_frame(frame))

    @property
    def write_stats(self) -> dict:
        return dict(self._cork.stats)

    async def recv(self) -> bytes | None:
        while not self._pending:
            try:
                chunk = await self._reader.read(65536)
            except (ConnectionResetError, BrokenPipeError):
                return None
            if not chunk:
                return None
            self._pending.extend(self._frames.feed(chunk))
        return self._pending.popleft()

    async def close(self) -> None:
        if not self._closed:
            self._closed = True  # set first: no new frames enter the cork
            try:
                # Settle the cork before closing the writer: a frame
                # send() accepted in this tick must reach the transport,
                # not be buffered-and-discarded by the teardown. Bounded:
                # a remote that stopped reading leaves the flusher wedged
                # in drain() forever — after the grace period, abort (the
                # writer.close() below breaks the stalled drain, whose
                # error path then fails any still-waiting senders).
                if self._cork.pending:
                    try:
                        await asyncio.wait_for(self._cork.settle(),
                                               timeout=5.0)
                    except asyncio.TimeoutError:
                        pass
                self._writer.close()
                await self._writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def remote_address(self) -> str:
        peer = self._writer.get_extra_info("peername")
        return f"tcp://{peer[0]}:{peer[1]}" if peer else "tcp://?"


class TcpListener(Listener):
    def __init__(self, server: asyncio.base_events.Server, address: str) -> None:
        self._server = server
        self._address = address

    @property
    def address(self) -> str:
        return self._address

    async def close(self) -> None:
        self._server.close()
        await self._server.wait_closed()


class TcpTransport(Transport):
    scheme = "tcp"

    async def listen(self, address: str, handler: ConnectionHandler) -> Listener:
        host, port = _parse(address)

        async def on_client(reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
            conn = TcpConnection(reader, writer)
            try:
                await handler(conn)
            except Exception as exc:
                # A misbehaving peer must cost one log line, not a traceback storm.
                logger.debug(f"peer {conn.remote_address} dropped: {exc}")
            finally:
                await conn.close()

        server = await asyncio.start_server(on_client, host, port)
        sock = server.sockets[0].getsockname()
        return TcpListener(server, f"tcp://{sock[0]}:{sock[1]}")

    async def dial(self, address: str) -> Connection:
        host, port = _parse(address)
        reader, writer = await asyncio.open_connection(host, port)
        return TcpConnection(reader, writer)
