"""NAT traversal: UDP hole punching (network/natpunch.py) and the
server-spliced relay fallback (network/relay.py).

The reference gets both legs from hyperdht (holepunching + relaying,
SURVEY §2.2). No real NAT exists on loopback (and this box has no
nftables to build one), so these tests verify the full traversal
CHOREOGRAPHY — reflexive-address learning, invite delivery, simultaneous
punch bursts, dialing through the punched path, and ciphertext-only
relay splicing — over real UDP/memory transports.
"""

import asyncio

import pytest

from symmetry_tpu_torch.client.client import ClientError, ProviderDetails, SymmetryClient
from symmetry_tpu_torch.identity import Identity
from symmetry_tpu_torch.network.natpunch import (
    PunchRendezvous,
    punch_dial,
    unwrap_raw,
    wrap_raw,
)
from symmetry_tpu_torch.provider.config import ConfigManager
from symmetry_tpu_torch.provider.provider import SymmetryProvider
from symmetry_tpu_torch.server.broker import SymmetryServer
from symmetry_tpu_torch.transport.memory import MemoryTransport


def run(coro, timeout=60):
    return asyncio.new_event_loop().run_until_complete(
        asyncio.wait_for(coro, timeout))


class TestRawFraming:
    def test_roundtrip(self):
        assert unwrap_raw(wrap_raw(b"hello")) == b"hello"

    def test_rejects_garbage(self):
        assert unwrap_raw(b"\xff\xff\xff\xffAAAA") is None
        assert unwrap_raw(b"") is None


def _udp_available():
    try:
        from symmetry_tpu_torch.transport.udp import load_library

        load_library()
        return True
    except Exception:  # noqa: BLE001
        return False


@pytest.mark.skipif(not _udp_available(), reason="udpstream lib unavailable")
class TestHolePunch:
    def test_punch_then_stream(self):
        """Full choreography: provider registers its reflexive address,
        client punches through the rendezvous, then opens a real
        udpstream connection on the punched path and exchanges frames."""
        async def main():
            from symmetry_tpu_torch.network.natpunch import ProviderPuncher
            from symmetry_tpu_torch.transport.udp import UdpTransport

            rdv = PunchRendezvous()
            await rdv.start("127.0.0.1", 0)

            got = asyncio.Queue()

            async def echo_handler(conn):
                frame = await conn.recv()
                await got.put(frame)
                await conn.send(b"pong:" + (frame or b""))

            ident = Identity.from_name("punch-prov")
            provider_t = UdpTransport()
            listener = await provider_t.listen("udp://127.0.0.1:0",
                                               echo_handler)
            puncher = ProviderPuncher(listener.raw_channel(),
                                      ("127.0.0.1", rdv.port), ident)
            puncher.start()
            await asyncio.sleep(0.3)  # registration datagram lands

            client_t = UdpTransport()
            address = await punch_dial(client_t, ("127.0.0.1", rdv.port),
                                       ident.public_hex)
            assert address == listener.address
            assert puncher.punched == 1  # the invite produced a burst

            conn = await client_t.dial(address)
            await conn.send(b"ping")
            assert await conn.recv() == b"pong:ping"
            await conn.close()

            # forged (unsigned) registration must NOT move the record
            import json as _json

            from symmetry_tpu_torch.network.natpunch import wrap_raw

            evil = _json.dumps({"op": "register",
                                "key": ident.public_hex}).encode()
            rdv._on_datagram(wrap_raw(evil), ("10.9.9.9", 9999))
            assert rdv._registry[ident.public_hex][0][0] == "127.0.0.1"

            # and a REPLAYED (validly signed, old ts) register from a
            # different address must not move it either
            import time as _time

            from symmetry_tpu_torch.network.natpunch import _register_sig_msg

            old_ts = rdv._last_ts[ident.public_hex]
            replay = _json.dumps({
                "op": "register", "key": ident.public_hex,
                "ts": old_ts,
                "sig": ident.sign(_register_sig_msg(
                    ident.public_hex, old_ts)).hex()}).encode()
            rdv._on_datagram(wrap_raw(replay), ("10.9.9.9", 9999))
            assert rdv._registry[ident.public_hex][0][0] == "127.0.0.1"

            await puncher.stop()
            await listener.close()
            await rdv.stop()

        run(main())

    def test_unknown_key_fails_fast(self):
        async def main():
            from symmetry_tpu_torch.transport.udp import UdpTransport

            rdv = PunchRendezvous()
            await rdv.start("127.0.0.1", 0)
            with pytest.raises(ConnectionError, match="does not know"):
                await punch_dial(UdpTransport(), ("127.0.0.1", rdv.port),
                                 "nobody", timeout_s=3.0)
            await rdv.stop()

        run(main())


class TestRelayFallback:
    def test_chat_through_relay_when_direct_dial_fails(self):
        """Provider reachable ONLY via the server splice (its advertised
        address is bogus — the behind-NAT case): the chat must complete
        through the relay, with the provider's key still pinned end to
        end."""
        async def main():
            hub = MemoryTransport()
            server_ident = Identity.from_name("relay-server")
            server = SymmetryServer(server_ident, hub, ping_interval_s=30.0)
            await server.start("mem://server")

            cfg = ConfigManager(config={
                "name": "relay-prov", "public": True,
                "serverKey": server_ident.public_hex,
                "modelName": "tiny:relay", "apiProvider": "echo",
                "dataCollectionEnabled": False,
            })
            prov_ident = Identity.from_name("relay-prov")
            provider = SymmetryProvider(cfg, transport=hub,
                                        identity=prov_ident,
                                        server_address="mem://server")
            await provider.start("mem://relay-prov")
            await provider.wait_registered()

            client = SymmetryClient(Identity.from_name("relay-cli"), hub)
            details = await client.request_provider(
                "mem://server", server_ident.public_key, "tiny:relay")
            # Simulate NAT: the advertised address is undialable.
            details = ProviderDetails(
                peer_key=details.peer_key, address="mem://unreachable",
                model_name=details.model_name,
                session_token=details.session_token,
                session_id=details.session_id)

            session = await client.connect(
                details,
                relay_via=("mem://server", server_ident.public_key))
            text = await session.chat_text(
                [{"role": "user", "content": "through the wall"}])
            assert text
            await session.close()
            await provider.stop(drain_timeout_s=2)
            await server.stop()

        run(main())

    def test_relay_refused_for_unknown_provider(self):
        async def main():
            hub = MemoryTransport()
            ident = Identity.from_name("relay-server2")
            server = SymmetryServer(ident, hub, ping_interval_s=30.0)
            await server.start("mem://server")
            client = SymmetryClient(Identity.from_name("relay-cli2"), hub)
            with pytest.raises(ClientError, match="cannot relay"):
                await client.connect_relay(
                    "mem://server", ident.public_key, "ab" * 32)
            await server.stop()

        run(main())

    def test_relay_cannot_be_hijacked_by_third_party(self):
        """A third peer must not be able to impersonate the provider on a
        pending relay: connecting and sending relayAccept for someone
        else's relayId gets relayClose, and the end-to-end pinning means
        even a successful splice to the wrong node fails the handshake."""
        async def main():
            from symmetry_tpu_torch.network.peer import Peer
            from symmetry_tpu_torch.protocol.keys import MessageKey

            hub = MemoryTransport()
            ident = Identity.from_name("relay-server3")
            server = SymmetryServer(ident, hub, ping_interval_s=30.0)
            await server.start("mem://server")

            evil = Identity.from_name("relay-evil")
            conn = await hub.dial("mem://server")
            peer = await Peer.connect(conn, evil, initiator=True,
                                      expected_remote_key=ident.public_key)
            await peer.send(MessageKey.RELAY_ACCEPT, {"id": "not-a-relay"})
            msg = await asyncio.wait_for(peer.recv(), 5)
            assert msg is not None and msg.key == MessageKey.RELAY_CLOSE
            await peer.close()
            await server.stop()

        run(main())


class TestRequestHardening:
    """The `request` op must not be a reflection primitive: a source must
    echo a cookie (proving it receives at its claimed address) before any
    punch is brokered, and even proven sources have an invite budget
    (round-3 advisor finding)."""

    @staticmethod
    async def _udp_probe():
        loop = asyncio.get_running_loop()
        inbox: asyncio.Queue = asyncio.Queue()

        class _P(asyncio.DatagramProtocol):
            def datagram_received(self, data, addr):
                inbox.put_nowait(data)

        transport, _ = await loop.create_datagram_endpoint(
            _P, local_addr=("127.0.0.1", 0))
        return transport, inbox

    def test_uncookied_request_gets_challenge_only(self):
        async def main():
            import json as _json
            import time as _time

            from symmetry_tpu_torch.network.natpunch import _msg, _register_sig_msg

            rdv = PunchRendezvous()
            await rdv.start("127.0.0.1", 0)
            prov = Identity.from_name("cookie-prov")
            ptrans, pinbox = await self._udp_probe()
            ts = _time.time()
            ptrans.sendto(
                wrap_raw(_msg("register", key=prov.public_hex,
                              ts=round(ts, 3),
                              sig=prov.sign(_register_sig_msg(
                                  prov.public_hex, ts)).hex())),
                ("127.0.0.1", rdv.port))
            assert _json.loads(unwrap_raw(
                await asyncio.wait_for(pinbox.get(), 5)))["op"] == "registered"

            ctrans, cinbox = await self._udp_probe()
            ctrans.sendto(wrap_raw(_msg("request", key=prov.public_hex)),
                          ("127.0.0.1", rdv.port))
            reply = _json.loads(unwrap_raw(
                await asyncio.wait_for(cinbox.get(), 5)))
            # no peer, no invite — only a challenge back to the source
            assert reply["op"] == "challenge" and reply["cookie"]
            assert pinbox.empty(), "provider must NOT be invited yet"

            # echoing the cookie completes the round-trip
            ctrans.sendto(
                wrap_raw(_msg("request", key=prov.public_hex,
                              cookie=reply["cookie"])),
                ("127.0.0.1", rdv.port))
            peer = _json.loads(unwrap_raw(
                await asyncio.wait_for(cinbox.get(), 5)))
            assert peer["op"] == "peer"
            invite = _json.loads(unwrap_raw(
                await asyncio.wait_for(pinbox.get(), 5)))
            assert invite["op"] == "invite"
            ptrans.close()
            ctrans.close()
            await rdv.stop()

        run(main())

    def test_invite_budget_per_source(self):
        from symmetry_tpu_torch.network.natpunch import MAX_INVITES_PER_SOURCE

        rdv = PunchRendezvous()
        addr = ("198.51.100.7", 40000)
        for _ in range(MAX_INVITES_PER_SOURCE):
            assert rdv._invite_allowed(addr)
        assert not rdv._invite_allowed(addr)
        # other sources are unaffected
        assert rdv._invite_allowed(("198.51.100.8", 40000))

    def test_retransmissions_charge_budget_once(self):
        """punch_dial resends its request every second while replies are
        lost; those retransmissions must not burn the invite budget (one
        lossy dial would otherwise hard-fail the next legitimate one)."""
        import time as _time

        rdv = PunchRendezvous()
        sent = []
        rdv._send = lambda payload, addr: sent.append((payload, addr))
        prov_addr = ("203.0.113.5", 50000)
        rdv._registry["provkey"] = (prov_addr, _time.monotonic())
        addr = ("198.51.100.7", 40000)
        from symmetry_tpu_torch.network.natpunch import _msg, wrap_raw

        cookie = rdv._cookie_for(addr)
        for _ in range(12):  # > MAX_INVITES_PER_SOURCE resends
            rdv._on_datagram(
                wrap_raw(_msg("request", key="provkey", cookie=cookie)),
                addr)
        import json as _json

        ops = [_json.loads(p.decode())["op"] for p, _ in sent]
        # every retransmission was ANSWERED (peer+invite), none rejected
        assert "busy" not in ops
        assert ops.count("peer") == 12 and ops.count("invite") == 12
        # and the budget was charged only once
        assert len(rdv._invites[addr]) == 1


class TestRelayCap:
    def test_relay_connect_capped_per_client(self):
        """One client key cannot hold more than MAX_RELAYS_PER_CLIENT
        pending/active splices (round-3 advisor: unbounded _relays growth
        + provider-side dial/task per RELAY_OPEN)."""
        async def main():
            from symmetry_tpu_torch.protocol.keys import MessageKey

            class _FakePeer:
                closed = False

                def __init__(self):
                    self.sent = []

                async def send(self, key, data=None):
                    self.sent.append((key, data))

            hub = MemoryTransport()
            ident = Identity.from_name("cap-server")
            server = SymmetryServer(ident, hub, ping_interval_s=30.0)
            control = _FakePeer()
            server._provider_peers["prov-key"] = control
            client = _FakePeer()
            for _ in range(server.MAX_RELAYS_PER_CLIENT):
                await server._handle_relay_connect(
                    client, "client-key", {"providerKey": "prov-key"})
            assert len(server._relays) == server.MAX_RELAYS_PER_CLIENT
            assert all(k == MessageKey.RELAY_OPEN for k, _ in control.sent)
            await server._handle_relay_connect(
                client, "client-key", {"providerKey": "prov-key"})
            assert len(server._relays) == server.MAX_RELAYS_PER_CLIENT
            assert client.sent[-1][0] == MessageKey.RELAY_CLOSE
            # a different client key is unaffected
            await server._handle_relay_connect(
                _FakePeer(), "other-key", {"providerKey": "prov-key"})
            assert len(server._relays) == server.MAX_RELAYS_PER_CLIENT + 1

        run(main())


class TestServerHostedRendezvous:
    def test_server_starts_punch_rendezvous(self):
        """The routing server hosts the punch rendezvous (punch_port=0
        binds ephemeral); a signed register round-trips against it."""
        async def main():
            import time as _time

            from symmetry_tpu_torch.network.natpunch import (
                _msg, _register_sig_msg, unwrap_raw)

            hub = MemoryTransport()
            ident = Identity.from_name("rdv-server")
            server = SymmetryServer(ident, hub, ping_interval_s=30.0,
                                    punch_port=0)
            await server.start("mem://server")
            assert server.punch_port

            prov = Identity.from_name("rdv-prov")
            loop = asyncio.get_running_loop()
            inbox: asyncio.Queue = asyncio.Queue()

            class _P(asyncio.DatagramProtocol):
                def datagram_received(self, data, addr):
                    inbox.put_nowait(data)

            transport, _ = await loop.create_datagram_endpoint(
                _P, local_addr=("127.0.0.1", 0))
            ts = _time.time()
            payload = _msg("register", key=prov.public_hex,
                           ts=round(ts, 3),
                           sig=prov.sign(_register_sig_msg(
                               prov.public_hex, ts)).hex())
            from symmetry_tpu_torch.network.natpunch import wrap_raw

            transport.sendto(wrap_raw(payload),
                             ("127.0.0.1", server.punch_port))
            reply = unwrap_raw(await asyncio.wait_for(inbox.get(), 5))
            import json as _json

            assert _json.loads(reply)["op"] == "registered"
            transport.close()
            await server.stop()

        run(main())
