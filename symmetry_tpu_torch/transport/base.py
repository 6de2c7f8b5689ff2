"""Transport abstractions.

The reference's transport is the hyperswarm native stack (UDX reliable-UDP →
Noise secret-stream → DHT; SURVEY §1 layers A–C), reached only through
`swarm.join` + connection events. We make the transport an explicit, injectable
seam — the one good idea in the reference's test (it mocks hyperswarm whole,
__test__/cli.test.ts:4-13), generalized: protocol and node logic run unchanged
over in-memory pipes (tests), TCP (production), or a future C++/UDP transport.

A Connection carries opaque *frames* (bytes in, bytes out, boundaries
preserved); encryption layers above it (see symmetry_tpu.network.peer).
"""

from __future__ import annotations

import abc
import asyncio
from typing import AsyncIterator, Awaitable, Callable


class WriteCork:
    """Same-tick write coalescing (app-level cork) for stream transports.

    Frames sent while one event-loop tick is in progress — e.g. every
    per-request pump woken by one batched host frame writing to the same
    peer — append to a shared buffer; a single flusher writes the whole
    buffer in ONE transport write and ONE drain. Senders all await the
    shared flush future, so the existing per-send backpressure discipline
    (send returns only after drain) is preserved, and the buffer is
    written in send-call order, so per-stream ordering is too.

    The owner supplies `write_drain(data)` — the uncorked write+drain.
    Counters feed Connection.write_stats: `writes` is actual transport
    writes, `frames` frames accepted, `coalesced_frames` frames that
    piggybacked on an already-pending flush, `bytes` payload bytes.
    """

    def __init__(self, write_drain: Callable[[bytes], Awaitable[None]]
                 ) -> None:
        self._write_drain = write_drain
        self._buf = bytearray()
        self._fut: asyncio.Future | None = None
        self._task: asyncio.Task | None = None
        self.stats = {"writes": 0, "frames": 0, "coalesced_frames": 0,
                      "bytes": 0}

    async def send(self, data: bytes) -> None:
        self.stats["frames"] += 1
        self.stats["bytes"] += len(data)
        self._buf += data
        if self._fut is None:
            self._fut = asyncio.get_running_loop().create_future()
        else:
            self.stats["coalesced_frames"] += 1
        fut = self._fut
        # At most ONE flusher ever runs: its while-loop picks up batches
        # that accumulate during an in-flight drain, so frame bytes reach
        # write_drain strictly in send-call order no matter where
        # write_drain first suspends. (The task has no suspension point
        # between its last buffer check and returning, so a done() task
        # can never still pick our batch up.)
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._flush())
        # shield: the future is shared by every sender coalesced into
        # this batch — one cancelled sender must not cancel the future
        # out from under the others (their bytes are still written; a
        # cancelled future would fail healthy streams on a healthy
        # connection). Cancellation still propagates to THIS sender.
        await asyncio.shield(fut)

    @property
    def pending(self) -> bool:
        """True while accepted frames may not have hit the transport yet."""
        return self._task is not None and not self._task.done()

    async def settle(self) -> None:
        """Close barrier: wait until every accepted frame has been
        written (or failed its senders). The owner calls this before
        tearing the transport down — a frame send() accepted must not
        be silently discarded by a same-tick close racing the flusher."""
        while self._task is not None and not self._task.done():
            # wait() rather than await: the flusher's own failure mode is
            # to fail the sender futures, not to raise at the closer.
            await asyncio.wait([self._task])

    async def _flush(self) -> None:
        # Runs after the current tick's sends have buffered. Batches that
        # accumulate while a drain is in flight go out on the next loop
        # iteration — still one write each.
        while self._buf:
            buf = bytes(self._buf)
            self._buf.clear()
            fut, self._fut = self._fut, None
            try:
                self.stats["writes"] += 1
                await self._write_drain(buf)
            except BaseException as exc:  # noqa: BLE001 — fail all awaiters
                err = exc if isinstance(exc, Exception) else \
                    ConnectionError(f"write failed: {exc!r}")
                for f in (fut, self._fut):
                    if f is not None and not f.done():
                        f.set_exception(err)
                        f.exception()  # mark retrieved: awaiters may be gone
                self._fut = None
                self._buf.clear()
                if not isinstance(exc, Exception):
                    raise  # CancelledError & co: cleanup done, propagate
                return
            if fut is not None and not fut.done():
                fut.set_result(None)


class Connection(abc.ABC):
    """A reliable, ordered, frame-boundary-preserving duplex channel."""

    @abc.abstractmethod
    async def send(self, frame: bytes) -> None:
        """Send one frame. Applies backpressure (awaits drain) when buffers fill."""

    @property
    def write_stats(self) -> dict | None:
        """Emit-path write counters (see WriteCork.stats); None when the
        transport doesn't track them."""
        return None

    @abc.abstractmethod
    async def recv(self) -> bytes | None:
        """Receive one frame, or None on clean EOF."""

    @abc.abstractmethod
    async def close(self) -> None: ...

    @property
    @abc.abstractmethod
    def closed(self) -> bool: ...

    @property
    def remote_address(self) -> str:
        return "?"

    async def __aiter__(self) -> AsyncIterator[bytes]:
        while True:
            frame = await self.recv()
            if frame is None:
                return
            yield frame


ConnectionHandler = Callable[[Connection], Awaitable[None]]


class Listener(abc.ABC):
    """An accepting endpoint bound to an address."""

    @property
    @abc.abstractmethod
    def address(self) -> str:
        """Dialable address string, e.g. 'tcp://10.0.0.2:31337' or 'mem://a'."""

    @abc.abstractmethod
    async def close(self) -> None: ...


class Transport(abc.ABC):
    """Factory for listeners and outbound connections."""

    scheme: str = "?"

    @abc.abstractmethod
    async def listen(self, address: str, handler: ConnectionHandler) -> Listener: ...

    @abc.abstractmethod
    async def dial(self, address: str) -> Connection: ...
