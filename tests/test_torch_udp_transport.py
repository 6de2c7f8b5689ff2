"""Native C++ udpstream transport: framing, fragmentation, multiplexing,
close semantics, and the full Noise-encrypted peer channel over UDP.

Skipped cleanly when no C++ toolchain is available to build the library.
"""

import asyncio
import os

import pytest

try:
    from symmetry_tpu_torch.transport.udp import UdpTransport, load_library

    load_library()
    HAVE_UDP = True
except Exception:  # noqa: BLE001 — no toolchain / build failure
    HAVE_UDP = False

pytestmark = pytest.mark.skipif(not HAVE_UDP,
                                reason="udpstream library unavailable")


def run(coro, timeout=60):
    return asyncio.new_event_loop().run_until_complete(
        asyncio.wait_for(coro, timeout))


def test_roundtrip_and_frame_boundaries():
    async def main():
        t = UdpTransport()
        inbox = asyncio.Queue()

        async def handler(conn):
            while True:
                f = await conn.recv()
                if f is None:
                    return
                await conn.send(b"echo:" + f)

        lst = await t.listen("udp://127.0.0.1:0", handler)
        conn = await t.dial(lst.address)
        # Distinct frames stay distinct (no coalescing/splitting).
        await conn.send(b"one")
        await conn.send(b"two")
        assert await conn.recv() == b"echo:one"
        assert await conn.recv() == b"echo:two"
        await conn.close()
        await lst.close()

    run(main())


def test_large_frame_fragmentation():
    """Frames far beyond the 1200-byte MTU segment size reassemble exactly."""
    async def main():
        t = UdpTransport()
        got = asyncio.Queue()

        async def handler(conn):
            f = await conn.recv()
            got.put_nowait(f)

        lst = await t.listen("udp://127.0.0.1:0", handler)
        conn = await t.dial(lst.address)
        payload = os.urandom(256 * 1024)  # ~220 segments
        await conn.send(payload)
        # Margin for a loaded machine (tests run in parallel workers):
        # ~220 segments through a 128-segment window, acked and
        # retransmitted by the library's background thread.
        received = await asyncio.wait_for(got.get(), 150)
        assert received == payload
        await conn.close()
        await lst.close()

    run(main(), timeout=180)


def test_many_connections_multiplexed():
    async def main():
        t = UdpTransport()

        async def handler(conn):
            f = await conn.recv()
            await conn.send(f[::-1])

        lst = await t.listen("udp://127.0.0.1:0", handler)

        async def one(i):
            conn = await t.dial(lst.address)
            msg = f"conn-{i}".encode()
            await conn.send(msg)
            out = await conn.recv()
            await conn.close()
            return out

        outs = await asyncio.gather(*[one(i) for i in range(8)])
        assert outs == [f"conn-{i}".encode()[::-1] for i in range(8)]
        await lst.close()

    run(main())


def test_clean_close_gives_eof():
    async def main():
        t = UdpTransport()
        done = asyncio.Queue()

        async def handler(conn):
            while True:
                f = await conn.recv()
                if f is None:
                    done.put_nowait("eof")
                    return

        lst = await t.listen("udp://127.0.0.1:0", handler)
        conn = await t.dial(lst.address)
        await conn.send(b"x")
        await conn.close()
        assert await asyncio.wait_for(done.get(), 20) == "eof"
        await lst.close()

    run(main())


def test_dial_nobody_fails():
    async def main():
        t = UdpTransport()
        with pytest.raises(ConnectionError):
            await t.dial("udp://127.0.0.1:9")  # discard port — no listener

    run(main())


def test_noise_peer_channel_over_udp():
    """The full encrypted peer handshake + message exchange over the native
    transport — what production uses (SURVEY layers A-E stacked)."""
    from symmetry_tpu_torch.identity import Identity
    from symmetry_tpu_torch.network.peer import Peer
    from symmetry_tpu_torch.protocol.keys import MessageKey

    async def main():
        t = UdpTransport()
        server_ident = Identity.from_name("udp-srv")
        client_ident = Identity.from_name("udp-cli")
        got = asyncio.Queue()

        async def handler(conn):
            peer = await Peer.connect(conn, server_ident, initiator=False)
            msg = await peer.recv()
            got.put_nowait((msg.key, msg.data))
            await peer.send(MessageKey.PONG, {"ok": True})

        lst = await t.listen("udp://127.0.0.1:0", handler)
        conn = await t.dial(lst.address)
        peer = await Peer.connect(conn, client_ident, initiator=True,
                                  expected_remote_key=server_ident.public_key)
        await peer.send(MessageKey.PING, {"n": 1})
        key, data = await asyncio.wait_for(got.get(), 20)
        assert key == MessageKey.PING and data == {"n": 1}
        reply = await peer.recv()
        assert reply.key == MessageKey.PONG
        await peer.close()
        await lst.close()

    run(main())
