"""Client CLI: one-shot or interactive chat through the Symmetry network.

    python -m symmetry_tpu.client --server tcp://host:4848 --server-key HEX \
        --model llama3:8b "why is the sky blue?"
"""

from __future__ import annotations

import argparse
import asyncio
import sys

from symmetry_tpu_torch.client.client import SymmetryClient


async def run(args: argparse.Namespace) -> None:
    from symmetry_tpu_torch.transport import transport_for

    client = SymmetryClient(transport=transport_for(args.server))
    server_key = bytes.fromhex(args.server_key)
    if args.list_models:
        for row in await client.list_models(args.server, server_key):
            print(row)
        return
    details = await client.request_provider(args.server, server_key, args.model)
    print(f"[assigned provider {details.peer_key[:12]}… at {details.address}]",
          file=sys.stderr)
    session = await client.connect(details)
    async with session:
        if args.prompt:
            async for delta in session.chat([{"role": "user", "content": args.prompt}]):
                print(delta, end="", flush=True)
            print()
            return
        history: list[dict[str, str]] = []
        while True:
            try:
                user = input("you> ")
            except (EOFError, KeyboardInterrupt):
                return
            if not user.strip():
                continue
            await session.new_conversation()
            history.append({"role": "user", "content": user})
            out = []
            async for delta in session.chat(history):
                out.append(delta)
                print(delta, end="", flush=True)
            print()
            history.append({"role": "assistant", "content": "".join(out)})


def main() -> None:
    parser = argparse.ArgumentParser(prog="symmetry-client")
    parser.add_argument("--server", required=True, help="tcp://host:port")
    parser.add_argument("--server-key", required=True, help="server public key (hex)")
    parser.add_argument("--model", default=None)
    parser.add_argument("--list-models", action="store_true")
    parser.add_argument("prompt", nargs="?", default=None)
    args = parser.parse_args()
    asyncio.run(run(args))


if __name__ == "__main__":
    main()
