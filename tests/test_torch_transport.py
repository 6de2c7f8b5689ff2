"""Transports + secure peer channel."""

import asyncio

import pytest

from symmetry_tpu_torch.identity import HandshakeError, Identity
from symmetry_tpu_torch.network.peer import Peer
from symmetry_tpu_torch.protocol.keys import MessageKey
from symmetry_tpu_torch.transport import MemoryTransport, TcpTransport, memory_pair


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


def test_memory_pair_duplex():
    async def main():
        a, b = memory_pair()
        await a.send(b"hello")
        await b.send(b"world")
        assert await b.recv() == b"hello"
        assert await a.recv() == b"world"
        await a.close()
        assert await b.recv() is None

    run(main())


def test_memory_transport_dial_listen():
    async def main():
        hub = MemoryTransport()
        got = asyncio.Queue()

        async def handler(conn):
            got.put_nowait(await conn.recv())

        await hub.listen("mem://srv", handler)
        conn = await hub.dial("mem://srv")
        await conn.send(b"ping")
        assert await asyncio.wait_for(got.get(), 2) == b"ping"
        with pytest.raises(ConnectionRefusedError):
            await hub.dial("mem://nobody")

    run(main())


def test_tcp_transport_roundtrip():
    async def main():
        t = TcpTransport()
        echoed = asyncio.Queue()

        async def handler(conn):
            while (frame := await conn.recv()) is not None:
                await conn.send(frame + b"!")
            echoed.put_nowait(True)

        listener = await t.listen("tcp://127.0.0.1:0", handler)
        conn = await t.dial(listener.address)
        await conn.send(b"abc")
        await conn.send(b"x" * 200_000)  # multi-read frame
        assert await conn.recv() == b"abc!"
        assert await conn.recv() == b"x" * 200_000 + b"!"
        await conn.close()
        await asyncio.wait_for(echoed.get(), 2)
        await listener.close()

    run(main())


def _handshake_pair(client_ident, server_ident, expected_server=None, expected_client=None):
    async def main():
        a, b = memory_pair()
        client_task = asyncio.create_task(
            Peer.connect(a, client_ident, initiator=True, expected_remote_key=expected_server)
        )
        server_task = asyncio.create_task(
            Peer.connect(b, server_ident, initiator=False, expected_remote_key=expected_client)
        )
        return await asyncio.gather(client_task, server_task)

    return run(main())


def test_secure_peer_mutual_auth_and_messages():
    ci, si = Identity.from_name("client"), Identity.from_name("server")
    cp, sp = _handshake_pair(ci, si, expected_server=si.public_key)
    # Both sides learned the authentic remote identity.
    assert cp.remote_public_key == si.public_key
    assert sp.remote_public_key == ci.public_key

    async def chat():
        await cp.send(MessageKey.INFERENCE, {"messages": []})
        msg = await sp.recv()
        assert msg.key == MessageKey.INFERENCE
        await sp.send(MessageKey.INFERENCE_ENDED, {"n": 1})
        msg2 = await cp.recv()
        assert msg2.key == MessageKey.INFERENCE_ENDED and msg2.data == {"n": 1}
        # Many messages in flight — framing keeps boundaries.
        for i in range(50):
            await cp.send(MessageKey.PING, i)
        for i in range(50):
            assert (await sp.recv()).data == i

    run(chat())


def test_secure_peer_rejects_wrong_server_key():
    # Unlike the reference (advisory verify, src/provider.ts:157-167) a key
    # mismatch must abort the connection.
    ci, si = Identity.from_name("client2"), Identity.from_name("server2")
    imposter = Identity.from_name("imposter")

    async def main():
        a, b = memory_pair()
        client = asyncio.create_task(
            Peer.connect(a, ci, initiator=True, expected_remote_key=imposter.public_key)
        )
        server = asyncio.create_task(Peer.connect(b, si, initiator=False))
        with pytest.raises(HandshakeError):
            await client
        server.cancel()

    run(main())


def test_wire_is_actually_encrypted():
    # Sniff the raw frames between the peers: plaintext must not appear.
    ci, si = Identity.from_name("c3"), Identity.from_name("s3")

    async def main():
        a, b = memory_pair()
        cp_t = asyncio.create_task(Peer.connect(a, ci, initiator=True))
        sp_t = asyncio.create_task(Peer.connect(b, si, initiator=False))
        cp, sp = await cp_t, await sp_t

        secret = "the quick brown fox"
        sniffed = []
        orig_send = a.send

        async def sniffing_send(frame):
            sniffed.append(frame)
            await orig_send(frame)

        a.send = sniffing_send
        await cp.send(MessageKey.INFERENCE, {"content": secret})
        msg = await sp.recv()
        assert msg.data["content"] == secret
        assert sniffed and all(secret.encode() not in f for f in sniffed)

    run(main())


def test_tampered_ciphertext_drops_peer():
    ci, si = Identity.from_name("c4"), Identity.from_name("s4")

    async def main():
        a, b = memory_pair()
        cp_t = asyncio.create_task(Peer.connect(a, ci, initiator=True))
        sp_t = asyncio.create_task(Peer.connect(b, si, initiator=False))
        cp, sp = await cp_t, await sp_t

        orig_send = a.send

        async def corrupting_send(frame):
            await orig_send(frame[:-1] + bytes([frame[-1] ^ 1]))

        a.send = corrupting_send
        await cp.send(MessageKey.PING)
        assert await sp.recv() is None  # tampering → peer dropped, not garbage

    run(main())
