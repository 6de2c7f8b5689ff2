"""Rank-0 process for the port's multi-host provider end-to-end test
(tests/test_torch_tp.py): runs the port's server, the rank-0 provider
(tpu_native; its engine host is rank 0 of a 2-process mesh) and a client
chat. Imports torch and the port only."""

import asyncio
import json
import sys


def main() -> None:
    port = sys.argv[1]

    from symmetry_tpu_torch.client.client import SymmetryClient
    from symmetry_tpu_torch.identity import Identity
    from symmetry_tpu_torch.provider.backends.base import get_backend
    from symmetry_tpu_torch.provider.config import ConfigManager
    from symmetry_tpu_torch.provider.provider import SymmetryProvider
    from symmetry_tpu_torch.server.broker import SymmetryServer
    from symmetry_tpu_torch.transport.memory import MemoryTransport

    async def run() -> None:
        hub = MemoryTransport()
        server_ident = Identity.from_name("mh-server")
        server = SymmetryServer(server_ident, hub, ping_interval_s=30.0)
        await server.start("mem://server")

        cfg = ConfigManager(config={
            "name": "mh-prov", "public": True,
            "serverKey": server_ident.public_hex,
            "modelName": "tiny:mh", "apiProvider": "tpu_native",
            "tpu": {
                "model_preset": "tiny", "dtype": "float32",
                "max_batch_size": 2, "max_seq_len": 64,
                "prefill_buckets": [32], "decode_block": 2,
                "compile_cache": False, "mesh": {"model": 2},
                "multihost": {"coordinator": f"127.0.0.1:{port}",
                              "num_processes": 2, "process_id": 0},
            },
        })
        provider = SymmetryProvider(cfg, transport=hub,
                                    identity=Identity.from_name("mh-prov"),
                                    server_address="mem://server",
                                    backend=get_backend(cfg, device="cpu"))
        await provider.start("mem://mh-prov")
        await provider.wait_registered()

        client = SymmetryClient(Identity.from_name("mh-cli"), hub)
        details = await client.request_provider(
            "mem://server", server_ident.public_key, "tiny:mh")
        session = await client.connect(details)
        deltas = []
        async for d in session.chat([{"role": "user", "content": "hi"}],
                                    max_tokens=6):
            deltas.append(d)
        await session.close()
        await provider.stop()   # also releases the worker rank
        await server.stop()
        print("RESULT " + json.dumps({"text_len": len("".join(deltas)),
                                      "ok": True}), flush=True)

    asyncio.run(asyncio.wait_for(run(), 240))


if __name__ == "__main__":
    main()
