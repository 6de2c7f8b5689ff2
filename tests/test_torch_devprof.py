"""symprof in the PyTorch port (symmetry_tpu_torch/utils/devprof.py).

- DeviceProfiler unit behaviour, as tests/test_devprof.py holds the JAX
  package's: inert when disabled, the disabled-mode overhead guard, the
  1-in-N cadence per kind, probe -> next-begin gap pairing, a probe that
  fails never raises (and books nothing: no host-clock guess), the Perfetto
  device component, the metric families, and the kind vocabulary (equal to
  the JAX package's).
- The engine: a `tiny` float32 engine with profile_sample=1 books every
  dispatch kind; its Scheduler stats carry the `devprof` block and the
  request ledger's `measured` source ("probed"); its greedy tokens equal
  those of the same engine with sampling off.
- capture_device_profile writes a Chrome trace on the CPU and refuses a
  second capture while one runs; utils/trace.py device_trace as a context.
"""

import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from symmetry_tpu.utils.devprof import DISPATCH_KINDS as JAX_KINDS
from symmetry_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from symmetry_tpu_torch.engine.scheduler import GenRequest, Scheduler
from symmetry_tpu_torch.engine.spec import SpecConfig
from symmetry_tpu_torch.engine.tokenizer import ByteTokenizer
from symmetry_tpu_torch.models.llama import init_params, preset
from symmetry_tpu_torch.utils.devprof import (
    DISPATCH_KINDS,
    DeviceProfiler,
    capture_device_profile,
)
from symmetry_tpu_torch.utils.metrics import METRICS, MetricName
from symmetry_tpu_torch.utils.trace import device_trace, export_perfetto


class TestDeviceProfiler:
    def test_disabled_is_inert(self):
        dp = DeviceProfiler(0)
        assert not dp.enabled
        dp.probe("decode_block", None, 0.0)
        assert dp.stats()["probes"] == {}
        assert dp.gap_share() is None

    def test_disabled_mode_overhead_guard(self):
        """The off-mode cost per dispatch is one attribute load + branch
        (`if dp.enabled:`), far under one dispatch's cost."""
        dp = DeviceProfiler(0)
        t0 = time.perf_counter()
        acc = 0.0
        for _ in range(200_000):
            if dp.enabled:  # the exact engine-side guard shape
                acc += dp.begin()
        dt = time.perf_counter() - t0
        assert acc == 0.0
        assert dt < 0.5, f"disabled-mode: {dt:.3f}s for 200k guards"
        assert (dt / 200_000) < 1e-7 * 100

    def test_cadence_probes_one_in_n_per_kind(self):
        dp = DeviceProfiler(4)
        for _ in range(12):
            t0 = dp.begin()
            dp.probe("decode_block", torch.zeros(2), t0)
        for _ in range(4):
            t0 = dp.begin()
            dp.probe("prefill", 1.23, t0)  # a host value: nothing pending
        stats = dp.stats()
        assert stats["dispatches"] == {"decode_block": 12, "prefill": 4}
        assert stats["probes"] == {"decode_block": 3, "prefill": 1}
        assert stats["device_s"]["decode_block"]["count"] == 3
        assert stats["device_s"]["prefill"]["count"] == 1

    def test_gap_pairs_probe_with_next_begin(self):
        dp = DeviceProfiler(1)
        t0 = dp.begin()
        dp.probe("prefill", 0.0, t0)
        assert dp.stats()["dispatch_gap_s"]["count"] == 0  # not yet
        time.sleep(0.01)
        dp.begin()  # closes the pending gap
        stats = dp.stats()
        assert stats["dispatch_gap_s"]["count"] == 1
        assert stats["dispatch_gap_s"]["p50"] >= 0.008
        share = dp.gap_share()
        assert share is not None and 0.0 < share <= 1.0
        # begin() without a pending probe adds no gap
        dp.begin()
        dp.begin()
        assert dp.stats()["dispatch_gap_s"]["count"] == 1

    class BadDevice:
        @property
        def device(self):
            raise RuntimeError("device lost")

    @pytest.mark.parametrize("value", [
        BadDevice(), SimpleNamespace(device="no-such-device")])
    def test_probe_failure_never_raises(self, value):
        """The wait fails: the probe swallows it and books nothing — no
        host-clock time stands in for a device time."""
        dp = DeviceProfiler(1)
        t0 = dp.begin()
        dp.probe("verify", value, t0)
        assert dp.stats()["probes"] == {}
        assert dp.stats()["device_s_total"] == 0.0

    def test_component_is_perfetto_ready(self):
        dp = DeviceProfiler(1)
        for kind in ("prefill", "decode_block"):
            t0 = dp.begin()
            dp.probe(kind, 7.0, t0)
        dp.begin()
        comp = dp.component("device")
        assert comp["name"] == "device"
        perfetto = export_perfetto([comp])
        names = {e["name"] for e in perfetto["traceEvents"]
                 if e.get("ph") == "X"}
        assert {"prefill", "decode_block", "dispatch_gap"} <= names
        assert all(e["ts"] >= 0 for e in perfetto["traceEvents"]
                   if e.get("ph") == "X")

    def test_metrics_families_emitted(self):
        dp = DeviceProfiler(1)
        t0 = dp.begin()
        dp.probe("decode_block", 0.5, t0)
        dp.begin()
        snap = METRICS.snapshot(compact=True)["families"]
        for family in (MetricName.DEVICE_DISPATCH, MetricName.DEVICE_PROBES,
                       MetricName.DISPATCH_GAP,
                       MetricName.DISPATCH_GAP_SHARE):
            assert family in snap
        assert MetricName.DEVICE_PROBES == "sym_device_probes_total"
        probes = snap[MetricName.DEVICE_PROBES]["series"]
        assert any(s["labels"].get("kind") == "decode_block"
                   for s in probes)

    def test_kind_vocabulary_documented(self):
        assert set(DISPATCH_KINDS) == {
            "prefill", "chunk", "decode_block", "verify", "adopt",
            "seed_gather", "scatter"}
        assert DISPATCH_KINDS == JAX_KINDS

    def test_stats_carry_device_s_total(self):
        dp = DeviceProfiler(1)
        for _ in range(3):
            t0 = dp.begin()
            time.sleep(0.002)
            dp.probe("chunk", torch.ones(1), t0)
        stats = dp.stats()
        assert stats["device_s_total"] >= 0.006
        assert stats["sample_every"] == 1


# ---------------------------------------------------------------------------
# The engine


@pytest.fixture(scope="module")
def params():
    return init_params(preset("tiny"), torch.Generator().manual_seed(0),
                       torch.float32)


def engine(params, sample, **kw):
    return InferenceEngine(
        preset("tiny"), params, ByteTokenizer(512), max_slots=2,
        max_seq_len=64, prefill_buckets=(16, 32), cache_dtype=torch.float32,
        decode_block=2, prefill_chunk=16, prefix_cache_bytes=2**20,
        prefix_block_tokens=8, speculative=SpecConfig(k_draft=2),
        profile_sample=sample, device="cpu", **kw)


def greedy(eng, prompts, max_new=6):
    sched = Scheduler(eng)
    sched.start()
    try:
        out = []
        for i, ids in enumerate(prompts):
            events, done = [], threading.Event()

            def emit(ev, events=events, done=done):
                events.append(ev)
                if ev.done:
                    done.set()

            sched.submit(GenRequest(prompt_ids=list(ids),
                                    sampling=SamplingParams(),
                                    max_new_tokens=max_new, emit=emit,
                                    id=f"r{i}"))
            assert done.wait(60)
            out.append([ev.token_id for ev in events])
        return out, sched.stats(), sched.ledger.source
    finally:
        sched.stop()


class TestEngineProbes:
    # 12 tokens: one dispatch and a stored block (scatter); 30: chunked;
    # the repeat hits the cache (seed_gather).
    PROMPTS = [list(range(100, 112)), list(range(200, 230)),
               list(range(100, 112))]

    def test_every_kind_is_booked(self, params):
        from symmetry_tpu_torch.engine.disagg import (decode_kv_handoff,
                                                      encode_kv_handoff)

        eng = engine(params, 1)
        eng.warmup()
        _, stats, source = greedy(eng, self.PROMPTS)
        eng.verify_step(np.zeros((2, 2), np.int64),
                        np.zeros((2,), np.int32))
        cfg = preset("tiny")
        rng = np.random.default_rng(0)
        planes = {k: rng.standard_normal(
            (cfg.num_layers, 1, 16, cfg.num_kv_heads, cfg.dim_per_head)
        ).astype(np.float32) for k in ("k", "v")}
        assert eng.adopt_prefix(decode_kv_handoff(encode_kv_handoff(
            "a", list(range(300, 320)), 16, planes, block_size=8)))
        probes = eng.devprof.stats()["probes"]
        assert set(probes) == set(DISPATCH_KINDS), probes
        assert "devprof" in stats
        assert stats["devprof"]["gap_share"] is not None
        assert stats["devprof"]["device_s"]["decode_block"]["p50"] \
            is not None
        assert source == "probed"

    def test_probes_leave_greedy_tokens_unchanged(self, params):
        on, _, _ = greedy(engine(params, 1), self.PROMPTS)
        off_engine = engine(params, 0)
        off, stats, source = greedy(off_engine, self.PROMPTS)
        assert on == off
        assert "devprof" not in stats and source == "blocked"
        assert off_engine.devprof.stats()["dispatches"] == {}


# ---------------------------------------------------------------------------
# On-demand capture


class TestCaptureDeviceProfile:
    def test_capture_writes_a_trace_and_single_flights(self, tmp_path):
        path = capture_device_profile(str(tmp_path), duration_s=0.05)
        with open(os.path.join(path, "trace.json")) as fh:
            assert "traceEvents" in json.load(fh)
        hold = threading.Thread(target=capture_device_profile,
                                args=(str(tmp_path),),
                                kwargs={"duration_s": 0.5})
        hold.start()
        time.sleep(0.15)
        with pytest.raises(RuntimeError, match="already running"):
            capture_device_profile(str(tmp_path), duration_s=0.05)
        hold.join(30)
        assert not hold.is_alive()
        assert len(os.listdir(tmp_path)) == 2

    def test_capture_starts_and_stops_under_the_gate(self, tmp_path):
        """With a gate, the profiler starts and stops only while no other
        thread holds it: a capture asked for while an engine call holds
        the gate waits for that call."""
        gate = threading.RLock()
        held = threading.Event()

        def engine_call():
            with gate:
                held.set()
                time.sleep(0.4)

        t = threading.Thread(target=engine_call)
        t.start()
        held.wait(5)
        t0 = time.monotonic()
        capture_device_profile(str(tmp_path), duration_s=0.0, gate=gate)
        assert time.monotonic() - t0 >= 0.3
        t.join(5)
        assert not t.is_alive()

    def test_device_trace_records_the_block(self, tmp_path):
        with device_trace(str(tmp_path / "t")):
            torch.ones(64, 64) @ torch.ones(64, 64)
        with open(tmp_path / "t" / "trace.json") as fh:
            names = {e.get("name") for e in json.load(fh)["traceEvents"]}
        assert any("mm" in (n or "") for n in names)
