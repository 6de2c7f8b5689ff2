"""End-to-end with the port's engine: client → server → provider →
tpu_native, every role from symmetry_tpu_torch.

Copied from tests/test_e2e_tpu_native.py and moved onto the port: the full
three-role network path serving a real (tiny) model through the PyTorch
engine with continuous batching, on the CPU (`device="cpu"`; the process
leg runs the port's host with `--device cpu`).
"""

import asyncio

import pytest

from symmetry_tpu_torch.client.client import SymmetryClient
from symmetry_tpu_torch.identity import Identity
from symmetry_tpu_torch.provider.backends.base import get_backend
from symmetry_tpu_torch.provider.config import ConfigManager
from symmetry_tpu_torch.provider.provider import SymmetryProvider
from symmetry_tpu_torch.server.broker import SymmetryServer
from symmetry_tpu_torch.transport.memory import MemoryTransport


def run(coro):
    return asyncio.new_event_loop().run_until_complete(asyncio.wait_for(coro, 300))


def tpu_config(server_key_hex, isolation):
    return ConfigManager(config={
        "name": "tpu-prov",
        "public": True,
        "serverKey": server_key_hex,
        "modelName": "tiny:test",
        "apiProvider": "tpu_native",
        "dataCollectionEnabled": False,
        "tpu": {"model_preset": "tiny", "dtype": "float32",
                "max_batch_size": 4, "max_seq_len": 128,
                "prefill_buckets": [32, 64],
                # "process" exercises the production engine-host pipe
                # (engine/host.py); "inproc" the direct thread path.
                "engine_isolation": isolation},
    })


@pytest.mark.parametrize(
    "isolation",
    ["inproc",
     # the host-subprocess path recompiles the engine in a fresh process
     pytest.param("process", marks=pytest.mark.slow)])
def test_tpu_native_full_flow(isolation):
    async def main():
        hub = MemoryTransport()
        server_ident = Identity.from_name("tpu-e2e-server")
        server = SymmetryServer(server_ident, hub, ping_interval_s=30.0)
        await server.start("mem://server")

        cfg = tpu_config(server_ident.public_hex, isolation)
        provider = SymmetryProvider(
            cfg, transport=hub,
            identity=Identity.from_name("tpu-prov"),
            backend=get_backend(cfg, device="cpu"),
            server_address="mem://server",
        )
        await provider.start("mem://tpu-prov")
        await provider.wait_registered()

        client = SymmetryClient(Identity.from_name("tpu-cli"), hub)
        details = await client.request_provider(
            "mem://server", server_ident.public_key, "tiny:test")
        assert details.model_name == "tiny:test"
        session = await client.connect(details)

        # Two concurrent chats through one provider: continuous batching on
        # the network path. (Tiny random weights — assert streaming works and
        # text is non-trivial, not that it's sensible.)
        async def one_chat(text):
            deltas = []
            async for d in session.chat(
                    [{"role": "user", "content": text}], max_tokens=8):
                deltas.append(d)
            return "".join(deltas)

        texts = await asyncio.gather(one_chat("hello"), one_chat("world"))
        assert all(isinstance(t, str) for t in texts)

        await session.close()
        await provider.stop()
        await server.stop()

    run(main())
