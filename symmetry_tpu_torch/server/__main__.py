"""Server CLI: `python -m symmetry_tpu.server` (or `symmetry-tpu-server`)."""

import asyncio

from symmetry_tpu_torch.server.broker import main as _amain


def main() -> None:
    asyncio.run(_amain())


if __name__ == "__main__":
    main()
