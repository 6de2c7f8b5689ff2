"""portbench's own tests: run from the repository root as
`python -m pytest portbench/tests -q`. Tests marked `gpu` need a CUDA card
and skip without one, decided inside the `card` fixture."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return "cuda"


def _tiny_tree(tmp: Path) -> Path:
    """A checkout-shaped tree in `tmp`: the real metric readers and mixes,
    the test configurations and mix, and a BENCHMARK.json whose cells are
    `tiny.mix` (bf16) and `tiny-moe.mix` (int8 MoE), each reporting every
    metric of BENCHMARK.json and of data/ttft-metrics.json."""
    import json
    import shutil

    bench = ROOT / "portbench"
    data = Path(__file__).resolve().parent / "data"
    root = tmp / "checkout"
    pb = root / "portbench"
    for sub in ("metrics", "traffic"):
        shutil.copytree(bench / sub, pb / sub)
    (pb / "configs").mkdir(parents=True)
    for name in ("tiny", "tiny-moe"):
        shutil.copy(data / f"{name}.json", pb / "configs" / f"{name}.json")
    shutil.copy(data / "tiny-mix.json", pb / "traffic" / "tiny-mix.json")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    # The readers of the time-to-first-token metrics, which no cell of
    # BENCHMARK.json reports yet, are exercised here too.
    ttft = json.loads((data / "ttft-metrics.json").read_text())
    spec["end_to_end"] += ttft["end_to_end"]
    spec["per_layer"] += ttft["per_layer"]
    cells = ["tiny.mix", "tiny-moe.mix"]
    spec["configs"] = [
        {"name": n, "source": "test", "file": f"portbench/configs/{n}.json",
         "reduced": [], "why": "test"} for n in ("tiny", "tiny-moe")]
    spec["workloads"] = [
        {"name": f"{n}.mix", "config": n, "traffic": "tiny-mix", "chips": 1,
         "why": "test"} for n in ("tiny", "tiny-moe")]
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    assert cells == [w["name"] for w in spec["workloads"]]
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return _tiny_tree(tmp_path)


def run_tiny(root: Path, cell: str = "tiny.mix", seed: int = 5,
             seconds: float = 2.0, trace: bool = False, **kw) -> dict:
    """One CPU run of a test cell through the whole harness."""
    import time

    from portbench.lib import harness

    return harness.run(root, cell, seed, seconds, trace,
                       t_start=time.perf_counter(), device="cpu",
                       bench_dir=root / "portbench", log=lambda m: None,
                       **kw)
