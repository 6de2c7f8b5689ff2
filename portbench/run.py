"""The benchmark of the PyTorch/CUDA port (symmetry_tpu_torch).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs one cell of BENCHMARK.json on the cards of the machine it is started
on, from the root of a checkout: builds the cell's engine with weights
drawn from the seed, warms it, ramps the closed-loop clients, measures for
`--seconds`, checks the served tokens against the float32 reference, and
prints one JSON line last on standard output. With `--trace 1` the line
holds the cell's per-layer metrics, read from a device trace of a stretch
of the window, and with `--trace 0` its end-to-end metrics. The numbers
compared for `correct` are printed last on standard error and last in the
line, each beside its limit.

The kernels build into `build/portbench/` in the checkout, once; the first
run in a checkout pays for it.

Exit codes: 0 with a result; 2 for bad arguments; 3 where the machine lacks
the cards the cell asks for; 4 where a JAX module was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "portbench"


def _caches() -> None:
    """Every build and kernel cache in fixed directories of the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _caches()
    sys.path.insert(0, str(ROOT))
    from portbench.lib import harness

    bad = harness.forbidden_modules()
    if bad:
        print(f"JAX modules loaded at start: {bad}", file=sys.stderr)
        return 4
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card",
              file=sys.stderr)
        return 3
    from symmetry_tpu_torch.ops import kernels

    kernels.set_build_dir(CACHE / "kernels")

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    try:
        result = harness.run(ROOT, args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start=T_START, log=log)
    except harness.NoChip as exc:
        log(str(exc))
        return 3
    bad = result.pop("forbidden_modules")
    if bad:
        log(f"JAX modules loaded once the window closed: {bad}")
        return 4
    for name, c in result["checks"].items():
        sense = "at most" if c["bound"] == "max" else "at least"
        log(f"check {name}: {c['value']} (limit: {sense} {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
