"""In-memory transport: multi-node tests in one process, no sockets.

Implements the SURVEY §4 build implication — protocol/multi-node tests run as
multiple asyncio nodes over loopback pipes, the generalization of the
reference's mock-the-swarm test seam (__test__/cli.test.ts:4-13).
"""

from __future__ import annotations

import asyncio
from typing import Dict

from symmetry_tpu_torch.transport.base import Connection, ConnectionHandler, Listener, Transport

_MAX_QUEUE = 256  # frames buffered per direction before send() backpressures

# The event loop keeps only weak refs to tasks; hold fire-and-forget tasks
# strongly or they can be garbage-collected mid-run.
_BACKGROUND_TASKS: set = set()


class MemoryConnection(Connection):
    def __init__(self, rx: asyncio.Queue, tx: asyncio.Queue, peer_name: str) -> None:
        self._rx = rx
        self._tx = tx
        self._peer_name = peer_name
        self._peer: "MemoryConnection | None" = None  # set by memory_pair
        self._closed = False
        self._eof = False
        # Frame-queue transport: boundaries ARE the unit, so nothing can
        # coalesce — writes == frames. Tracked anyway so emit-path stats
        # aggregate uniformly across transports.
        self._write_stats = {"writes": 0, "frames": 0,
                             "coalesced_frames": 0, "bytes": 0}

    async def send(self, frame: bytes) -> None:
        if self._closed:
            raise ConnectionError("connection closed")
        if self._peer is not None and self._peer._closed:
            # Mirror TCP: writing to a reset connection raises, it doesn't
            # buffer into the void until the queue wedges.
            raise ConnectionError("connection reset by peer")
        self._write_stats["writes"] += 1
        self._write_stats["frames"] += 1
        self._write_stats["bytes"] += len(frame)
        await self._tx.put(frame)  # Queue(maxsize) gives natural backpressure

    @property
    def write_stats(self) -> dict:
        return dict(self._write_stats)

    async def recv(self) -> bytes | None:
        if self._eof or self._closed:
            return None
        frame = await self._rx.get()
        if frame is None:
            self._eof = True
            return None
        return frame

    async def close(self) -> None:
        if not self._closed:
            self._closed = True
            # EOF for the local reader: a task blocked in recv() must wake up,
            # matching TcpConnection semantics (reader sees EOF after close).
            try:
                self._rx.put_nowait(None)
            except asyncio.QueueFull:
                pass  # queue has data → no reader is blocked; recv checks _closed

            try:
                self._tx.put_nowait(None)  # EOF marker for the peer
            except asyncio.QueueFull:
                # Peer is slow; spill the EOF without blocking close().
                task = asyncio.ensure_future(self._tx.put(None))
                _BACKGROUND_TASKS.add(task)
                task.add_done_callback(_BACKGROUND_TASKS.discard)

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def remote_address(self) -> str:
        return self._peer_name


def memory_pair(a_name: str = "a", b_name: str = "b") -> tuple[MemoryConnection, MemoryConnection]:
    """A connected duplex pair — the unit-test workhorse."""
    q_ab: asyncio.Queue = asyncio.Queue(_MAX_QUEUE)
    q_ba: asyncio.Queue = asyncio.Queue(_MAX_QUEUE)
    a = MemoryConnection(rx=q_ba, tx=q_ab, peer_name=f"mem://{b_name}")
    b = MemoryConnection(rx=q_ab, tx=q_ba, peer_name=f"mem://{a_name}")
    a._peer, b._peer = b, a
    return a, b


class MemoryListener(Listener):
    def __init__(self, hub: "MemoryTransport", name: str) -> None:
        self._hub = hub
        self._name = name

    @property
    def address(self) -> str:
        return f"mem://{self._name}"

    async def close(self) -> None:
        self._hub._listeners.pop(self._name, None)


class MemoryTransport(Transport):
    """A process-local 'network': listeners keyed by name, dial by mem:// address."""

    scheme = "mem"

    def __init__(self) -> None:
        self._listeners: Dict[str, ConnectionHandler] = {}

    async def listen(self, address: str, handler: ConnectionHandler) -> Listener:
        name = address.removeprefix("mem://")
        if name in self._listeners:
            raise OSError(f"address in use: {address}")
        self._listeners[name] = handler
        return MemoryListener(self, name)

    async def dial(self, address: str) -> Connection:
        name = address.removeprefix("mem://")
        handler = self._listeners.get(name)
        if handler is None:
            raise ConnectionRefusedError(f"no listener at {address}")
        client_side, server_side = memory_pair(a_name="dialer", b_name=name)

        async def run_handler() -> None:
            try:
                await handler(server_side)
            except Exception as exc:
                from symmetry_tpu_torch.utils.logging import logger

                logger.debug(f"peer {server_side.remote_address} dropped: {exc}")
            finally:
                await server_side.close()

        task = asyncio.ensure_future(run_handler())
        _BACKGROUND_TASKS.add(task)
        task.add_done_callback(_BACKGROUND_TASKS.discard)
        return client_side
