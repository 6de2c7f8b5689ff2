"""Per-connection write corking (transport/base.WriteCork + TCP).

The provider fan-out of one batched engine block wakes many per-request
pumps in the same event-loop tick, each sending a frame to (possibly)
the same peer. The cork must collapse those same-tick sends into ONE
transport write+drain while preserving send order and the per-send
backpressure contract (send returns only after its bytes drained).
"""

import asyncio

from symmetry_tpu_torch.transport.base import WriteCork
from symmetry_tpu_torch.transport.tcp import TcpTransport


def run(coro):
    return asyncio.new_event_loop().run_until_complete(
        asyncio.wait_for(coro, 30))


class TestWriteCork:
    def test_same_tick_sends_coalesce_into_one_write(self):
        sent: list[bytes] = []

        async def write_drain(data: bytes) -> None:
            sent.append(data)

        async def main():
            cork = WriteCork(write_drain)
            await asyncio.gather(cork.send(b"aa"), cork.send(b"bb"),
                                 cork.send(b"cc"))
            return cork.stats

        stats = run(main())
        assert sent == [b"aabbcc"]  # one write, send order preserved
        assert stats == {"writes": 1, "frames": 3, "coalesced_frames": 2,
                         "bytes": 6}

    def test_cross_tick_sends_write_separately(self):
        sent: list[bytes] = []

        async def write_drain(data: bytes) -> None:
            sent.append(data)

        async def main():
            cork = WriteCork(write_drain)
            for i in range(3):
                await cork.send(b"%d" % i)  # sequential: a tick each
            return cork.stats

        stats = run(main())
        assert b"".join(sent) == b"012"
        assert stats["frames"] == 3
        assert stats["writes"] == len(sent)

    def test_backpressure_holds_senders_until_drain(self):
        release = asyncio.Event()
        drained = []

        async def write_drain(data: bytes) -> None:
            await release.wait()
            drained.append(data)

        async def main():
            cork = WriteCork(write_drain)
            senders = [asyncio.ensure_future(cork.send(b"x"))
                       for _ in range(4)]
            await asyncio.sleep(0.05)
            assert not any(t.done() for t in senders)  # all backpressured
            release.set()
            await asyncio.gather(*senders)
            assert drained == [b"xxxx"]

        run(main())

    def test_sends_during_inflight_drain_keep_order_one_flusher(self):
        """Frames arriving while a drain is in flight batch onto the NEXT
        write of the SAME flusher task — ordering must hold even for a
        write_drain that suspends before touching the wire (TLS wrap, a
        relay splice), so it cannot rest on writer.write() being sync."""
        sent: list[bytes] = []

        async def write_drain(data: bytes) -> None:
            await asyncio.sleep(0.02)  # suspend BEFORE the bytes land
            sent.append(data)

        async def main():
            cork = WriteCork(write_drain)
            a = asyncio.ensure_future(cork.send(b"A"))
            await asyncio.sleep(0.01)  # A's drain now in flight
            b = asyncio.ensure_future(cork.send(b"B"))
            c = asyncio.ensure_future(cork.send(b"C"))
            await asyncio.gather(a, b, c)
            return cork.stats

        stats = run(main())
        assert sent == [b"A", b"BC"]  # second batch after, not interleaved
        assert stats == {"writes": 2, "frames": 3, "coalesced_frames": 1,
                         "bytes": 3}

    def test_cancelled_sender_does_not_poison_coalesced_peers(self):
        """The flush future is shared by every sender in a batch; one
        cancelled sender (its stream's pump torn down mid-flight) must
        not cancel the write out from under the others."""
        sent: list[bytes] = []

        async def write_drain(data: bytes) -> None:
            await asyncio.sleep(0.02)
            sent.append(data)

        async def main():
            cork = WriteCork(write_drain)
            a = asyncio.ensure_future(cork.send(b"A"))
            b = asyncio.ensure_future(cork.send(b"B"))
            await asyncio.sleep(0.01)  # both coalesced, drain in flight
            a.cancel()
            await b  # must complete cleanly, not raise CancelledError
            assert a.cancelled()
            assert sent == [b"AB"]  # the batch still hit the wire intact

        run(main())

    def test_write_failure_fails_every_awaiting_sender(self):
        async def write_drain(data: bytes) -> None:
            raise ConnectionResetError("peer gone")

        async def main():
            cork = WriteCork(write_drain)
            results = await asyncio.gather(
                cork.send(b"a"), cork.send(b"b"), return_exceptions=True)
            assert all(isinstance(r, ConnectionResetError)
                       for r in results)

        run(main())


class TestTcpCork:
    def test_burst_collapses_frames_and_preserves_order(self):
        async def main():
            received: list[bytes] = []
            done = asyncio.Event()

            async def handler(conn):
                while True:
                    frame = await conn.recv()
                    if frame is None:
                        return
                    received.append(frame)
                    if len(received) == 20:
                        done.set()

            transport = TcpTransport()
            listener = await transport.listen("tcp://127.0.0.1:0", handler)
            conn = await transport.dial(listener.address)
            frames = [b"frame-%02d" % i for i in range(20)]
            await asyncio.gather(*(conn.send(f) for f in frames))
            await asyncio.wait_for(done.wait(), 10)

            assert received == frames  # boundaries + order intact
            stats = conn.write_stats
            assert stats["frames"] == 20
            # the same-tick burst coalesces into (nearly) one write
            assert stats["writes"] <= 2
            assert stats["coalesced_frames"] >= 18
            await conn.close()
            await listener.close()
            await asyncio.sleep(0.02)  # let server-side handlers finish

        run(main())

    def test_close_settles_pending_corked_frames(self):
        """close() racing the flusher in the same tick must settle the
        cork first — a frame send() accepted (e.g. a stream's final
        done frame during a disconnect) must reach the wire, not be
        buffered-and-discarded by the writer teardown."""
        async def main():
            received: list[bytes] = []
            got2 = asyncio.Event()

            async def handler(conn):
                while True:
                    frame = await conn.recv()
                    if frame is None:
                        return
                    received.append(frame)
                    if len(received) == 2:
                        got2.set()

            transport = TcpTransport()
            listener = await transport.listen("tcp://127.0.0.1:0", handler)
            conn = await transport.dial(listener.address)
            s1 = asyncio.ensure_future(conn.send(b"final-1"))
            s2 = asyncio.ensure_future(conn.send(b"final-2"))
            await asyncio.sleep(0)  # senders buffered into the cork
            await conn.close()      # races the flusher
            await asyncio.gather(s1, s2)
            await asyncio.wait_for(got2.wait(), 10)
            assert received == [b"final-1", b"final-2"]
            await listener.close()
            await asyncio.sleep(0.02)  # let server-side handlers finish

        run(main())

    def test_sequential_sends_still_work(self):
        async def main():
            received: list[bytes] = []
            got3 = asyncio.Event()

            async def handler(conn):
                while True:
                    frame = await conn.recv()
                    if frame is None:
                        return
                    received.append(frame)
                    if len(received) == 3:
                        got3.set()

            transport = TcpTransport()
            listener = await transport.listen("tcp://127.0.0.1:0", handler)
            conn = await transport.dial(listener.address)
            for payload in (b"one", b"two", b"three"):
                await conn.send(payload)
            await asyncio.wait_for(got3.wait(), 10)
            assert received == [b"one", b"two", b"three"]
            await conn.close()
            await listener.close()
            await asyncio.sleep(0.02)  # let server-side handlers finish

        run(main())
