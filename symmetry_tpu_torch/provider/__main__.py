"""Provider CLI: `python -m symmetry_tpu.provider [-c path]`.

Parity with the reference bin (src/symmetry.ts:1-24): `-c/--config` defaults
to ~/.config/symmetry/provider.yaml; constructs the provider and serves until
SIGINT, then drains gracefully.
"""

from __future__ import annotations

import argparse
import asyncio
import signal

from symmetry_tpu_torch.provider.backends.base import get_backend
from symmetry_tpu_torch.provider.config import ConfigManager, default_config_path
from symmetry_tpu_torch.provider.provider import SymmetryProvider
from symmetry_tpu_torch.utils.logging import logger


async def run(config_path: str, device: str = "cuda") -> None:
    config = ConfigManager(config_path)
    provider = SymmetryProvider(config,
                                backend=get_backend(config, device=device))
    await provider.start()
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    logger.info("draining and shutting down…")
    await provider.stop()


def run_worker(config_path: str, device: str = "cuda") -> None:
    """Non-rank-0 process of a multi-host provider: no networking — build
    the identical engine and mirror rank 0's engine calls until stopped."""
    from symmetry_tpu_torch.engine.engine import InferenceEngine
    from symmetry_tpu_torch.parallel.multihost import CommandLoop

    config = ConfigManager(config_path)
    mh = config.tpu.multihost
    if not mh or mh.get("process_id", 0) == 0:
        raise SystemExit("--worker requires tpu.multihost with process_id > 0")
    engine = InferenceEngine.from_tpu_config(config.tpu, device=device)
    logger.info(f"worker rank {mh['process_id']} following rank 0…")
    CommandLoop(engine, is_coordinator=False).follow_forever()
    logger.info("worker stopped")


def main() -> None:
    parser = argparse.ArgumentParser(prog="symmetry-provider")
    parser.add_argument("-c", "--config", default=default_config_path(),
                        help="path to provider.yaml")
    parser.add_argument("--worker", action="store_true",
                        help="run as a multi-host worker rank (no network)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of a tpu_native engine (default: "
                             "cuda; cpu runs the kernels' plain versions)")
    args = parser.parse_args()
    if args.worker:
        run_worker(args.config, args.device)
    else:
        asyncio.run(run(args.config, args.device))


if __name__ == "__main__":
    main()
