"""The port's network stack interoperates with the JAX package's.

The port copies protocol/, identity/, transport/, network/, server/,
provider/ and client/ from the JAX package (tests/test_torch_copies.py
holds them to their originals). Here the two packages talk to each other:

- byte for byte: frames, messages and their keys, identities from one
  seed, and a Noise session whose handshake runs with one package on each
  side;
- over TCP loopback with the echo backend: the JAX client through the
  port's server and provider, the port's client through the JAX server
  and provider, and a port provider registered with a JAX server serving
  a JAX client.
"""

import asyncio
import importlib

import pytest

from symmetry_tpu.identity import Identity as JaxIdentity
from symmetry_tpu.identity import noise as jax_noise
from symmetry_tpu.protocol import framing as jax_framing
from symmetry_tpu.protocol import keys as jax_keys
from symmetry_tpu.protocol import messages as jax_messages
from symmetry_tpu.transport.memory import memory_pair as jax_memory_pair
from symmetry_tpu_torch.identity import Identity
from symmetry_tpu_torch.identity import noise
from symmetry_tpu_torch.protocol import framing, keys, messages

JAX, PORT = "symmetry_tpu", "symmetry_tpu_torch"
MESSAGES = [
    [{"role": "user", "content": "hello over the wire"}],
    [{"role": "user", "content": "naïve — ünïcödé ✓ 漢字 and emoji 🚀"}],
]


def run(coro, timeout=60):
    return asyncio.new_event_loop().run_until_complete(
        asyncio.wait_for(coro, timeout))


class TestBytes:
    def test_message_keys_are_the_same(self):
        def vocabulary(cls):
            return {k: v for k, v in vars(cls).items() if k.isupper()}

        for name in ("MessageKey", "HostOp", "LinkOp"):
            assert vocabulary(getattr(keys, name)) == vocabulary(
                getattr(jax_keys, name)), name
        for name in ("SERVER_MESSAGE_KEYS", "HOST_OPS", "LINK_OPS"):
            assert getattr(keys, name) == getattr(jax_keys, name), name

    @pytest.mark.parametrize("payload", [b"", b"x", bytes(range(256)) * 9])
    def test_frames_are_the_same(self, payload):
        frame = framing.encode_frame(payload)
        assert frame == jax_framing.encode_frame(payload)
        reader = jax_framing.FrameReader()
        assert list(reader.feed(frame)) == [payload]
        reader = framing.FrameReader()
        assert list(reader.feed(jax_framing.encode_frame(payload))) == [
            payload]

    @pytest.mark.parametrize("data", [None, {"a": 1, "b": [1, 2]},
                                      MESSAGES[1]])
    def test_messages_are_the_same(self, data):
        for key in (keys.MessageKey.INFERENCE, keys.MessageKey.JOIN):
            wire = messages.create_message(key, data)
            assert wire == jax_messages.create_message(key, data)
            got, want = (messages.parse_message(wire),
                         jax_messages.parse_message(wire))
            assert (got.key, got.data) == (want.key, want.data)

    def test_identities_from_one_seed(self):
        seed = bytes(range(32))
        a, b = Identity.from_seed(seed), JaxIdentity.from_seed(seed)
        assert a.public_key == b.public_key
        msg = b"signed by the port, checked by JAX"
        assert b.verify(msg, a.sign(msg), a.public_key)
        assert a.verify(msg, b.sign(msg), b.public_key)

    @pytest.mark.parametrize("port_dials", [True, False])
    def test_noise_handshake_and_session(self, port_dials):
        """One package dials, the other listens: the handshake completes
        with each side holding the other's static key, and records sealed
        on one side open on the other."""
        dialer_noise, listener_noise = ((noise, jax_noise) if port_dials
                                        else (jax_noise, noise))
        dialer_id = (Identity if port_dials else JaxIdentity).from_name("d")
        listener_id = (JaxIdentity if port_dials else Identity).from_name(
            "l")

        async def main():
            a, b = jax_memory_pair()
            server = asyncio.ensure_future(
                listener_noise.server_handshake(b, listener_id))
            client = await dialer_noise.client_handshake(
                a, dialer_id, expected_remote_key=listener_id.public_key)
            session = await server
            assert client.remote_public_key == listener_id.public_key
            assert session.remote_public_key == dialer_id.public_key
            assert client.channel_binding == session.channel_binding
            for text in (b"ping", "✓".encode() * 100):
                assert session.decrypt(client.encrypt(text)) == text
                assert client.decrypt(session.encrypt(text)) == text

        run(main())


def echo_config(pkg, name, server_ident, port):
    ConfigManager = importlib.import_module(
        f"{pkg}.provider.config").ConfigManager
    return ConfigManager(config={
        "name": name, "public": True, "serverKey": server_ident.public_hex,
        "serverAddress": f"tcp://127.0.0.1:{port}", "modelName": "echo:wire",
        "apiProvider": "echo", "dataCollectionEnabled": False,
        "privateSeed": ("07" if pkg == PORT else "09") * 32})


async def chat_over_tcp(client_pkg, server_pkg, provider_pkg):
    """An echo provider of `provider_pkg` registers with a server of
    `server_pkg` on TCP loopback; a client of `client_pkg` asks the server
    for it and chats: the texts it receives."""
    mod = lambda pkg, name: importlib.import_module(  # noqa: E731
        f"{pkg}.{name}")
    server_ident = mod(server_pkg, "identity").Identity.from_name(
        f"wire-server-{server_pkg}")
    server = mod(server_pkg, "server.broker").SymmetryServer(
        server_ident, mod(server_pkg, "transport.tcp").TcpTransport(),
        ping_interval_s=30.0)
    await server.start("tcp://127.0.0.1:0")
    port = int(server.address.rsplit(":", 1)[1])
    provider = mod(provider_pkg, "provider.provider").SymmetryProvider(
        echo_config(provider_pkg, f"wire-prov-{provider_pkg}",
                    server_ident, port),
        transport=mod(provider_pkg, "transport.tcp").TcpTransport())
    await provider.start("tcp://127.0.0.1:0")
    try:
        await provider.wait_registered()
        client = mod(client_pkg, "client.client").SymmetryClient(
            mod(client_pkg, "identity").Identity.from_name("wire-client"),
            mod(client_pkg, "transport.tcp").TcpTransport())
        details = await client.request_provider(
            server.address, server_ident.public_key, "echo:wire")
        assert details.model_name == "echo:wire"
        assert details.peer_key == provider.identity.public_hex
        session = await client.connect(details)
        try:
            texts = [await session.chat_text(m) for m in MESSAGES]
            stats = await session.stats()
        finally:
            await session.close()
        return texts, stats
    finally:
        await provider.stop()
        await server.stop()


@pytest.mark.parametrize("client_pkg,server_pkg,provider_pkg", [
    (JAX, PORT, PORT),
    (PORT, JAX, JAX),
    (JAX, JAX, PORT),
    (PORT, PORT, PORT),
], ids=["jax-client_port-server_port-provider",
        "port-client_jax-server_jax-provider",
        "jax-client_jax-server_port-provider",
        "port-client_port-server_port-provider"])
def test_cross_package_chat_over_tcp(client_pkg, server_pkg, provider_pkg):
    texts, stats = run(chat_over_tcp(client_pkg, server_pkg, provider_pkg))
    assert texts == [m[-1]["content"] for m in MESSAGES]
    assert stats["requests"] == len(MESSAGES)
