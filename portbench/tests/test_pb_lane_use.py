"""decode_lane_use.tok reads the scheduler's counters: over a whole run it
equals the lane use of the scheduler's own `decode_block` spans (the
tokens each block streamed over its steps times the engine's slots), on a
schedule worked out by hand and on a longer one, and a traced run at test
size reports it."""

import json
import threading
import time
from types import SimpleNamespace

import pytest

from conftest import ROOT, run_tiny
from portbench.lib import harness, serve
from symmetry_tpu_torch.engine.engine import SamplingParams
from symmetry_tpu_torch.engine.scheduler import GenRequest

DATA = ROOT / "portbench" / "tests" / "data"
READ = harness.reader("decode_lane_use.tok")


def serve_budgets(budgets: list[int]):
    """Serve one request per budget on the `tiny-moe` engine (4 slots,
    blocks of 4 steps, two blocks in flight) to their ends: a context over
    the whole run, as the reader sees a window, and the scheduler's ring."""
    cfg = json.loads((DATA / "tiny-moe.json").read_text())
    engine = serve.build_engine(cfg, 3, "cpu")
    calls = serve.CallLog(engine)
    records = [serve.Record(client=i, index=0, prompt=list(range(5 + i, 20)),
                            max_new=n) for i, n in enumerate(budgets)]
    by_id = {f"r{i}": r for i, r in enumerate(records)}
    done = threading.Event()

    def sink(batch):
        t = time.perf_counter()
        for req, ev in batch:
            rec = by_id[req.id]
            if ev.text and rec.first is None:
                rec.first = t
            if ev.done:
                rec.done_at = t
        if all(r.done_at is not None for r in records):
            done.set()

    sched = serve.build_scheduler(engine, cfg, sink)
    c_open, t_open = dict(sched.metrics), time.perf_counter()
    for rid, rec in by_id.items():
        sched.submit(GenRequest(prompt_ids=rec.prompt,
                                sampling=SamplingParams(),
                                max_new_tokens=rec.max_new,
                                emit=lambda ev: None, id=rid))
    sched.start()
    try:
        assert done.wait(120)
    finally:
        sched.stop(timeout=60)
    ctx = SimpleNamespace(counters=(c_open, dict(sched.metrics)),
                          calls=calls.calls, records=records, t_open=t_open,
                          t_close=time.perf_counter())
    return ctx, sched.trace_export()["spans"], engine.max_slots


def ring_lane_use(spans: list[dict], slots: int) -> float:
    blocks = [s for s in spans if s["name"] == "decode_block"]
    return 100.0 * (sum(s["tokens"] for s in blocks)
                    / sum(s["steps"] * slots for s in blocks))


def test_hand_schedule():
    # Budgets 9 and 7 leave 8 and 6 tokens after each prompt's first, in
    # blocks of 4 on 4 slots: block 1 streams 4 + 4, block 2 4 + 2, and
    # block 3, dispatched before block 2's sync, streams nothing.
    ctx, spans, slots = serve_budgets([9, 7])
    assert slots == 4
    assert READ(ctx) == pytest.approx(100.0 * 14 / (3 * 4 * 4))
    assert READ(ctx) == pytest.approx(ring_lane_use(spans, slots))


def test_equals_the_ring_over_a_whole_run():
    # More requests than slots, budgets ending inside blocks: later
    # requests wait for a slot.
    ctx, spans, slots = serve_budgets([3, 10, 6, 13, 5, 8, 11])
    assert 0 < READ(ctx) < 100
    assert READ(ctx) == pytest.approx(ring_lane_use(spans, slots))


def test_nothing_to_read_without_a_decode_block():
    c = {"steps": 0, "tokens": 0}
    ctx = SimpleNamespace(counters=(c, dict(c)), calls=[], records=[],
                          t_open=0.0, t_close=1.0)
    assert READ(ctx) is None


def test_a_traced_run_reports_it(tiny_root):
    r = run_tiny(tiny_root, cell="tiny-moe.mix", trace=True, seed=2**31 + 7)
    assert r["correct"], r["checks"]
    assert 0 < r["metrics"]["decode_lane_use.tok"]["value"] <= 100
