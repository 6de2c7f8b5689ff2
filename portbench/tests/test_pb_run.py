"""Whole runs of the harness on the CPU at test sizes (the look for a chip
skipped), with the timed path sound and broken underneath; and the control.
"""

import json
import shutil
import time

import pytest
import torch

from conftest import run_tiny
from portbench.lib import check, harness


def test_sound_run_is_correct(tiny_root):
    r = run_tiny(tiny_root, trace=False)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"output_tok_s", "ttft_p95_s", "setup_s"}
    assert r["checks"]["served_tokens_checked"]["value"] >= 40
    assert list(r)[-1] == "checks"


def test_traced_run_reads_the_per_layer_metrics(tiny_root):
    r = run_tiny(tiny_root, trace=True, seed=9)
    assert r["correct"], r["checks"]
    # on the CPU the trace holds no device operation; the counters' and
    # host spans' metrics are there
    assert {"admit_dispatch_ms.ttft", "decode_block_ms.tok",
            "prefix_hit_rate.ttft"} <= set(r["metrics"])
    assert r["device"]["window_s"] > 0
    assert "breakdown" in r


def _stale_step(monkeypatch):
    """A decode step that returns its state unchanged."""
    from symmetry_tpu_torch.engine.engine import InferenceEngine

    orig = InferenceEngine._decode_one

    def step(self):
        before = self.state
        toks = orig(self)
        self.state = before
        return toks

    monkeypatch.setattr(InferenceEngine, "_decode_one", step)


def _altered_token(monkeypatch):
    """Every sampled token altered where it is produced."""
    from symmetry_tpu_torch.engine import engine

    orig = engine.sample_tokens

    def sample(logits, *args, **kw):
        return (orig(logits, *args, **kw) + 1) % logits.shape[-1]

    monkeypatch.setattr(engine, "sample_tokens", sample)


def _half_batch(monkeypatch):
    """Half of the decode batch left out: its lanes take the other half's
    tokens."""
    from symmetry_tpu_torch.engine.engine import InferenceEngine

    orig = InferenceEngine._decode_one

    def step(self):
        toks = orig(self)
        half = toks.shape[0] // 2
        toks[half:] = toks[:half]
        return toks

    monkeypatch.setattr(InferenceEngine, "_decode_one", step)


@pytest.mark.parametrize("fault", [_stale_step, _altered_token, _half_batch])
def test_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault):
    # one chip: no exchange between chips to leave out
    fault(monkeypatch)
    r = run_tiny(tiny_root, seed=11)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", ["tiny.mix", "tiny-moe.mix"])
def test_control_fails_where_the_program_passes(tiny_root, cell):
    """The control in the program's place (the reference one precision
    below the configuration's: fp8 weights for bf16, int4 for int8), judged
    by the same numbers and limits over the same requests, is not correct
    on any seed, where the program is."""
    cpu = torch.device("cpu")
    for seed in (21, 22, 23):
        served = harness.measure(
            tiny_root, cell, seed, 2.0, False, t_start=time.perf_counter(),
            device="cpu", bench_dir=tiny_root / "portbench",
            log=lambda m: None)
        ctx = served.ctx
        judged = harness.judge(ctx.spec.cfg_file, ctx.spec.mix, ctx.records,
                               seed, cpu, lambda m: None)
        assert check.correct(judged.checks), (seed, judged.checks)
        _, control = check.control_checks(ctx.spec.cfg_file, seed,
                                          judged.picked, judged.ref, cpu)
        assert not check.correct(control), (seed, control)


def test_new_cell_config_and_metric_are_found_by_name(tiny_root):
    """A later change adds a configuration, a mix, a cell and a per-layer
    metric as new files and BENCHMARK.json entries, and edits no file."""
    pb = tiny_root / "portbench"
    shutil.copy(pb / "configs" / "tiny.json", pb / "configs" / "tiny2.json")
    mix = json.loads((pb / "traffic" / "tiny-mix.json").read_text())
    mix["clients"] = 2
    (pb / "traffic" / "tiny-pair.json").write_text(json.dumps(mix))
    (pb / "metrics" / "requests_in_window.x.py").write_text(
        "def read(ctx):\n    return float(len(ctx.window_requests()))\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny2", "source": "test",
                            "file": "portbench/configs/tiny2.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny2.pair", "config": "tiny2",
                              "traffic": "tiny-pair", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({
        "name": "requests_in_window.x", "unit": "requests",
        "better": "higher", "source": "host_clock", "layer": "scheduler",
        "moves": "ttft_p95_s", "workloads": ["tiny2.pair"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    s = harness.load_spec(tiny_root, "tiny2.pair", pb)
    assert s.mix["clients"] == 2
    assert [m["name"] for m in s.per_layer][-1] == "requests_in_window.x"
    r = run_tiny(tiny_root, cell="tiny2.pair", trace=True, seed=4)
    assert r["correct"]
    assert r["metrics"]["requests_in_window.x"]["value"] > 0


def test_moe_int8_cell_runs(tiny_root):
    r = run_tiny(tiny_root, cell="tiny-moe.mix", seed=12)
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == {"share_gap_over_0.05", "failed_requests",
                                "short_requests", "served_tokens_checked"}


@pytest.mark.gpu
def test_card_run_is_correct(tiny_root, card):
    """On the card: the bf16 test cell through the port's kernels."""
    from symmetry_tpu_torch.ops import kernels

    kernels.build_all()
    r = harness.run(tiny_root, "tiny.mix", 5, 3.0, True,
                    t_start=0.0, device=card,
                    bench_dir=tiny_root / "portbench", log=lambda m: None)
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
    assert torch.cuda.get_device_name(0) == r["device"]["kind"]
