"""End-to-end: client → server → provider → backend → streamed response.

The full three-role system (SURVEY §7 stage 3 'minimum slice') running as
asyncio nodes over the in-memory transport — no sockets, no TPU.
"""

import asyncio

import pytest

from symmetry_tpu_torch.client.client import ClientError, SymmetryClient
from symmetry_tpu_torch.identity import Identity
from symmetry_tpu_torch.provider.backends.echo import EchoBackend
from symmetry_tpu_torch.provider.config import ConfigManager
from symmetry_tpu_torch.provider.provider import SymmetryProvider
from symmetry_tpu_torch.server.broker import SymmetryServer
from symmetry_tpu_torch.transport.memory import MemoryTransport


def run(coro):
    return asyncio.new_event_loop().run_until_complete(asyncio.wait_for(coro, 30))


def make_config(server_key_hex, *, name="prov-1", model="echo-model", public=True,
                **extra):
    return ConfigManager(config={
        "name": name,
        "public": public,
        "serverKey": server_key_hex,
        "modelName": model,
        "apiProvider": "echo",
        "dataCollectionEnabled": False,
        **extra,
    })


async def start_system(hub, *, model="echo-model", providers=1, ping_interval=30.0):
    server_ident = Identity.from_name("e2e-server")
    server = SymmetryServer(server_ident, hub, ping_interval_s=ping_interval)
    await server.start("mem://server")
    provs = []
    for i in range(providers):
        cfg = make_config(server_ident.public_hex, name=f"prov-{i}", model=model)
        p = SymmetryProvider(
            cfg, transport=hub, backend=EchoBackend(),
            identity=Identity.from_name(f"prov-{i}"),
            server_address="mem://server",
        )
        await p.start(f"mem://prov-{i}")
        await p.wait_registered()
        provs.append(p)
    return server, provs, server_ident


def test_full_flow_stream():
    async def main():
        hub = MemoryTransport()
        server, provs, server_ident = await start_system(hub)
        client = SymmetryClient(Identity.from_name("cli"), hub)
        details = await client.request_provider(
            "mem://server", server_ident.public_key, "echo-model"
        )
        assert details.model_name == "echo-model"
        assert details.address == "mem://prov-0"
        session = await client.connect(details)
        deltas = []
        async for d in session.chat([{"role": "user", "content": "hello distributed world"}]):
            deltas.append(d)
        assert "".join(deltas) == "hello distributed world"
        assert len(deltas) == 3  # streamed word-by-word, not one blob
        # Second request over the same session works.
        text = await session.chat_text([{"role": "user", "content": "again"}])
        assert text == "again"
        # Clients can query the provider's serving snapshot in-session.
        stats = await session.stats()
        assert stats["requests"] == 2
        assert stats["ttft_s"]["count"] == 2
        await session.close()
        for p in provs:
            await p.stop()
        await server.stop()

    run(main())


def test_no_provider_for_model():
    async def main():
        hub = MemoryTransport()
        server, provs, server_ident = await start_system(hub)
        client = SymmetryClient(Identity.from_name("cli2"), hub)
        with pytest.raises(ClientError, match="no provider"):
            await client.request_provider(
                "mem://server", server_ident.public_key, "gpt-17"
            )
        for p in provs:
            await p.stop()
        await server.stop()

    run(main())


def test_model_routing_two_providers():
    async def main():
        hub = MemoryTransport()
        server_ident = Identity.from_name("router-server")
        server = SymmetryServer(server_ident, hub)
        await server.start("mem://server")
        names = {}
        for model in ("llama3:8b", "mistral-7b"):
            cfg = make_config(server_ident.public_hex, name=f"p-{model}", model=model)
            p = SymmetryProvider(cfg, transport=hub, backend=EchoBackend(),
                                 identity=Identity.from_name(f"p-{model}"),
                                 server_address="mem://server")
            await p.start(f"mem://p-{model}")
            await p.wait_registered()
            names[model] = p
        client = SymmetryClient(Identity.from_name("cli3"), hub)
        # Routing: each model resolves to its own provider (BASELINE config 4).
        for model in ("llama3:8b", "mistral-7b"):
            details = await client.request_provider(
                "mem://server", server_ident.public_key, model
            )
            assert details.address == f"mem://p-{model}"
        models = await client.list_models("mem://server", server_ident.public_key)
        assert {m["model_name"] for m in models} == {"llama3:8b", "mistral-7b"}
        for p in names.values():
            await p.stop()
        await server.stop()

    run(main())


def test_session_token_required_and_enforced():
    async def main():
        hub = MemoryTransport()
        server, provs, server_ident = await start_system(hub)
        # A client that skips the server and fabricates no token must be refused.
        rogue = SymmetryClient(Identity.from_name("rogue"), hub)
        session = await rogue.connect_direct("mem://prov-0", model_name="echo-model")
        with pytest.raises(ClientError, match="session"):
            async for _ in session.chat([{"role": "user", "content": "free lunch"}]):
                pass
        await session.close()
        # With a legitimate token it works.
        legit = SymmetryClient(Identity.from_name("legit"), hub)
        details = await legit.request_provider(
            "mem://server", server_ident.public_key, "echo-model"
        )
        s2 = await legit.connect(details)
        assert await s2.chat_text([{"role": "user", "content": "paid lunch"}]) == "paid lunch"
        await s2.close()
        # A token minted for one client must not work for another (binding).
        thief = SymmetryClient(Identity.from_name("thief"), hub)
        stolen = await thief.connect(details)  # same details, different identity
        with pytest.raises(ClientError, match="session"):
            async for _ in stolen.chat([{"role": "user", "content": "stolen"}]):
                pass
        await stolen.close()
        for p in provs:
            await p.stop()
        await server.stop()

    run(main())


def test_private_provider_direct_connection():
    async def main():
        hub = MemoryTransport()
        ident = Identity.from_name("private-prov")
        cfg = make_config("ab" * 32, name="private", public=False)
        p = SymmetryProvider(cfg, transport=hub, backend=EchoBackend(),
                             identity=ident)
        await p.start("mem://private")
        client = SymmetryClient(Identity.from_name("direct-cli"), hub)
        session = await client.connect_direct(
            "mem://private", provider_key=ident.public_key
        )
        assert await session.chat_text([{"role": "user", "content": "direct hi"}]) == "direct hi"
        await session.close()
        await p.stop()

    run(main())


def test_provider_disconnect_marks_offline():
    async def main():
        hub = MemoryTransport()
        server, provs, server_ident = await start_system(hub)
        assert server.registry.select_provider("echo-model") is not None
        await provs[0].stop()  # graceful leave
        await asyncio.sleep(0.1)
        assert server.registry.select_provider("echo-model") is None
        await server.stop()

    run(main())


def test_data_collection_writes_conversation(tmp_path):
    async def main():
        hub = MemoryTransport()
        server_ident = Identity.from_name("dc-server")
        server = SymmetryServer(server_ident, hub)
        await server.start("mem://server")
        cfg = make_config(server_ident.public_hex, name="dc-prov",
                          dataCollectionEnabled=True, path=str(tmp_path))
        p = SymmetryProvider(cfg, transport=hub, backend=EchoBackend(),
                             identity=Identity.from_name("dc-prov"),
                             server_address="mem://server")
        await p.start("mem://dc-prov")
        await p.wait_registered()
        client = SymmetryClient(Identity.from_name("dc-cli"), hub)
        details = await client.request_provider(
            "mem://server", server_ident.public_key, "echo-model"
        )
        session = await client.connect(details)
        await session.new_conversation()
        await session.chat_text([{"role": "user", "content": "remember me"}])
        await session.close()
        await asyncio.sleep(0.2)
        files = list(tmp_path.glob("*.json"))
        assert len(files) == 1
        import json

        saved = json.loads(files[0].read_text())
        assert saved["messages"][0]["content"] == "remember me"
        assert saved["messages"][-1] == {"role": "assistant", "content": "remember me"}
        await p.stop()
        await server.stop()

    run(main())


def test_concurrent_clients_one_provider():
    async def main():
        hub = MemoryTransport()
        server, provs, server_ident = await start_system(hub)

        async def one_client(i):
            c = SymmetryClient(Identity.from_name(f"cc-{i}"), hub)
            details = await c.request_provider(
                "mem://server", server_ident.public_key, "echo-model"
            )
            s = await c.connect(details)
            text = await s.chat_text([{"role": "user", "content": f"msg {i}"}])
            await s.close()
            return text

        results = await asyncio.gather(*(one_client(i) for i in range(8)))
        assert results == [f"msg {i}" for i in range(8)]
        for p in provs:
            await p.stop()
        await server.stop()

    run(main())


def test_abandoned_stream_is_cancelled_not_poisoning():
    """Breaking out of a chat mid-stream cancels it provider-side
    (inferenceCancel by requestId) and the SAME session keeps working —
    the next chat gets the NEW completion, never the old stream's
    stragglers (those are dropped by the demultiplexing reader). This
    replaces the pre-multiplexing behavior where one abandoned stream
    desynced the whole session."""
    async def main():
        hub = MemoryTransport()
        server, provs, server_ident = await start_system(hub)
        client = SymmetryClient(Identity.from_name("cli-a"), hub)
        details = await client.request_provider(
            "mem://server", server_ident.public_key, "echo-model")
        session = await client.connect(details)
        agen = session.chat(
            [{"role": "user", "content": "one two three four"}])
        first = await agen.__anext__()
        assert first
        await agen.aclose()  # abandon mid-stream
        text = await session.chat_text(
            [{"role": "user", "content": "again"}])
        assert "again" in text  # echo backend: the NEW request's content
        assert "three" not in text  # and none of the old stream's
        await session.close()
        for p in provs:
            await p.stop()
        await server.stop()

    run(main())


def test_concurrent_chats_one_session_multiplex():
    """Two chats launched CONCURRENTLY on one session interleave on the
    wire and each receives its own completion (requestId routing)."""
    async def main():
        hub = MemoryTransport()
        server, provs, server_ident = await start_system(hub)
        client = SymmetryClient(Identity.from_name("cli-mux"), hub)
        details = await client.request_provider(
            "mem://server", server_ident.public_key, "echo-model")
        session = await client.connect(details)
        a, b = await asyncio.gather(
            session.chat_text([{"role": "user", "content": "alpha"}]),
            session.chat_text([{"role": "user", "content": "bravo"}]))
        assert "alpha" in a and "bravo" not in a
        assert "bravo" in b and "alpha" not in b
        await session.close()
        for p in provs:
            await p.stop()
        await server.stop()

    run(main())


def test_per_peer_concurrency_cap():
    """One peer's request flood is rejected past maxConcurrentRequests;
    other peers are unaffected."""
    async def main():
        hub = MemoryTransport()
        server_ident = Identity.from_name("cap-server")
        server = SymmetryServer(server_ident, hub, ping_interval_s=30.0)
        await server.start("mem://server")
        cfg = make_config(server_ident.public_hex, name="cap-prov",
                          model="echo-model")
        cfg._config["maxConcurrentRequests"] = 2
        # slow backend: streams stay in flight while the flood arrives, so
        # rejections are GUARANTEED (a fast echo could drain between
        # sends and pass this test without exercising the cap)
        from tests.test_failover import SlowBackend

        provider = SymmetryProvider(cfg, transport=hub,
                                    identity=Identity.from_name("cap-prov"),
                                    backend=SlowBackend(delay=0.05, n=10),
                                    server_address="mem://server")
        await provider.start("mem://cap-prov")
        await provider.wait_registered()
        client = SymmetryClient(Identity.from_name("cap-cli"), hub)
        details = await client.request_provider(
            "mem://server", server_ident.public_key, "echo-model")
        session = await client.connect(details)
        results = await asyncio.gather(
            *(session.chat_text([{"role": "user", "content": f"r{i}"}])
              for i in range(6)),
            return_exceptions=True)
        ok = [r for r in results if isinstance(r, str)]
        rejected = [r for r in results if isinstance(r, Exception)]
        assert ok, results  # some complete
        assert rejected, results  # and the cap actually fired
        assert all("too many concurrent" in str(r) for r in rejected)
        # a SECOND peer still works even while the first is flooding
        client2 = SymmetryClient(Identity.from_name("cap-cli2"), hub)
        other = await client2.connect(await client2.request_provider(
            "mem://server", server_ident.public_key, "echo-model"))
        assert await other.chat_text(
            [{"role": "user", "content": "hello"}])
        await other.close()
        await session.close()
        await provider.stop(drain_timeout_s=2)
        await server.stop()

    run(main())
