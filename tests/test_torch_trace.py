"""The port's spans and profiler ranges (utils/trace.py), as the scheduler
and the model record them.

- Tracer.span writes a ring record whenever the ring is enabled, and opens
  a profiler range `<prefix>.<name>` whenever a profiler records on the
  calling thread; device_range opens the range alone.
- A `tiny-moe` decode under the profiler holds, per step, one
  `model.attention` and one `model.mlp` range for each layer, nested in
  the scheduler's `sched.decode_dispatch`.
- The scheduler's `decode_block` spans carry the tokens each block
  streamed and its live lanes: they sum to the tokens the decode blocks
  streamed, and a schedule worked out by hand gives its lane use. One
  `queue` span per admitted request.
- The provider's TTFT and end-to-end histograms still count, now that a
  span observes none.
"""

import asyncio
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from symmetry_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from symmetry_tpu_torch.engine.scheduler import GenRequest, Scheduler
from symmetry_tpu_torch.engine.tokenizer import ByteTokenizer
from symmetry_tpu_torch.models.llama import init_params, preset
from symmetry_tpu_torch.utils.trace import Tracer, device_range

ID_BASE = 0x4E00  # one printable character per token id


class IdTokenizer(ByteTokenizer):
    """Every id its own character, and no end-of-sequence id: each request
    runs to its token budget."""

    def __init__(self, vocab_size: int) -> None:
        super().__init__(vocab_size)
        self.eos_ids = frozenset()

    def decode(self, ids):
        return "".join(chr(ID_BASE + i) for i in ids)


def ranges(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of the recorded profiler ranges."""
    return sorted(((ev.name(), ev.start_ns(), ev.end_ns())
                   for ev in prof.profiler.kineto_results.events()
                   if ev.is_user_annotation()), key=lambda r: r[1])


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


# ------------------------------------------------------------- the Tracer


@pytest.mark.parametrize("profiling", [False, True])
@pytest.mark.parametrize("ring", [False, True])
def test_span_ranges_follow_the_profiler_and_records_the_ring(profiling,
                                                              ring):
    tracer = Tracer(prefix="sched")
    tracer.enabled = ring
    prof = cpu_profile()
    if profiling:
        prof.start()
    with tracer.span("decode_dispatch", steps=4) as attrs:
        torch.ones(3).sum()
        attrs["tokens"] = 7
    if profiling:
        prof.stop()
        names = [r[0] for r in ranges(prof)]
        assert names == ["sched.decode_dispatch"]
    spans = tracer.export()
    if ring:
        assert [(s["name"], s["steps"], s["tokens"]) for s in spans] == [
            ("decode_dispatch", 4, 7)]
        assert spans[0]["duration_s"] >= 0
    else:
        assert spans == []


def test_no_range_while_no_profiler_records_on_this_thread():
    # The profiler records the thread that started it: a span on another
    # thread meanwhile opens no range, and still writes its record.
    tracer = Tracer(prefix="sched")
    with cpu_profile() as prof:
        with tracer.span("elsewhere"):
            pass
        t = threading.Thread(target=_span_once, args=(tracer,))
        t.start()
        t.join()
    assert [r[0] for r in ranges(prof)] == ["sched.elsewhere"]
    assert sorted(s["name"] for s in tracer.export()) == ["elsewhere",
                                                         "other_thread"]


def _span_once(tracer: Tracer) -> None:
    with tracer.span("other_thread"):
        pass


def test_device_range_is_a_range_and_no_record():
    with device_range("model.mlp"):
        pass  # no profiler: nothing at all
    with cpu_profile() as prof:
        with device_range("model.attention"):
            with device_range("model.mlp"):
                torch.ones(2).sum()
    got = ranges(prof)
    assert [r[0] for r in got] == ["model.attention", "model.mlp"]
    outer, inner = got
    assert outer[1] <= inner[1] and inner[2] <= outer[2]


def test_a_span_open_across_the_profiler_stop_closes_cleanly():
    tracer = Tracer(prefix="sched")
    prof = cpu_profile()
    prof.start()
    with tracer.span("sync"):
        prof.stop()
    with tracer.span("sync"):
        pass
    assert [s["name"] for s in tracer.export()] == ["sync", "sync"]


# ------------------------------------------------- scheduler and model


def moe_engine(block: int = 4) -> InferenceEngine:
    cfg = preset("tiny-moe")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32)
    return InferenceEngine(cfg, params, IdTokenizer(cfg.vocab_size),
                           max_slots=2, max_seq_len=64,
                           prefill_buckets=(16, 32),
                           cache_dtype=torch.float32, decode_block=block,
                           device="cpu")


def request(i: int, max_new: int, events: dict) -> GenRequest:
    events[i] = []
    return GenRequest(prompt_ids=list(range(5 + i, 10 + 2 * i)),
                      sampling=SamplingParams(), max_new_tokens=max_new,
                      emit=events[i].append, id=f"r{i}")


def run_here(sched: Scheduler, requests: list[GenRequest]) -> None:
    """Serve `requests` to their ends with the scheduler's loop on this
    thread (the profiler records the thread that starts it), then stop."""
    for req in requests:
        sched.submit(req)
    sched._stopping.set()
    sched._inbox.put(None)
    sched._run()


def test_moe_decode_ranges_nest_in_the_dispatch():
    engine = moe_engine(block=4)
    L, K = engine.config.num_layers, engine.decode_block
    sched = Scheduler(engine)
    events: dict = {}
    with cpu_profile() as prof:
        run_here(sched, [request(0, 9, events), request(1, 7, events)])
    got = ranges(prof)
    dispatches = [r for r in got if r[0] == "sched.decode_dispatch"]
    assert len(dispatches) == 3
    for _, s, e in dispatches:
        inside = [r[0] for r in got if s <= r[1] and r[2] <= e]
        assert inside.count("model.attention") == L * K
        assert inside.count("model.mlp") == L * K
    # every other model range is the prompts' prefill, inside admission
    admits = [r for r in got if r[0] == "sched.admit"]
    for name, s, e in got:
        if name.startswith("model."):
            assert any(d[1] <= s and e <= d[2]
                       for d in dispatches + admits), name
    # and a layer's attention half ends before its MLP half starts
    att = [r for r in got if r[0] == "model.attention"]
    mlp = [r for r in got if r[0] == "model.mlp"]
    assert len(att) == len(mlp)
    assert all(a[2] <= m[1] for a, m in zip(att, mlp))
    assert {r[0] for r in got} >= {"sched.admit", "sched.sync",
                                   "sched.flush"}


def lane_use(spans: list[dict], max_slots: int) -> float:
    blocks = [s for s in spans if s["name"] == "decode_block"]
    return (sum(s["tokens"] for s in blocks)
            / sum(s["steps"] * max_slots for s in blocks))


@pytest.mark.parametrize("threads", [False, True])
def test_decode_blocks_count_the_tokens_they_streamed(threads):
    # Two requests on two slots, blocks of 4, two blocks in flight: the
    # budgets 9 and 7 leave 8 and 6 tokens after each prompt's first.
    # Block 1 streams 4 + 4; block 2 streams 4 + 2 (r1 ends two steps
    # in); block 3, dispatched before block 2 was synced, streams nothing
    # and has no live lane at its sync. Lane use: 14 / (3 × 4 × 2).
    engine = moe_engine(block=4)
    sched = Scheduler(engine)
    events: dict = {}
    reqs = [request(0, 9, events), request(1, 7, events)]
    if threads:
        done = threading.Event()
        reqs[1].emit = lambda ev: (events[1].append(ev),
                                   ev.done and done.set())
        for req in reqs:
            sched.submit(req)
        sched.start()
        try:
            assert done.wait(120)
            assert all(evs and evs[-1].done for evs in events.values())
        finally:
            sched.stop()
    else:
        run_here(sched, reqs)
    spans = sched.trace_export()["spans"]
    blocks = [s for s in spans if s["name"] == "decode_block"]
    assert [(s["tokens"], s["lanes"], s["slots"], s["steps"])
            for s in blocks] == [(8, 2, 2, 4), (6, 2, 2, 4), (0, 0, 2, 4)]
    streamed = {i: len("".join(ev.text for ev in evs))
                for i, evs in events.items()}
    assert streamed == {0: 9, 1: 7}
    # every token but each prompt's first came out of a decode block
    assert sum(s["tokens"] for s in blocks) == sum(streamed.values()) - 2
    assert lane_use(spans, engine.max_slots) == pytest.approx(14 / 24)
    queues = [s for s in spans if s["name"] == "queue"]
    assert sorted(s["request_id"] for s in queues) == ["r0", "r1"]
    names = {s["name"] for s in spans}
    assert {"decode_dispatch", "sync", "admit", "flush", "prefill",
            "queue", "prefill_dispatch"} <= names
    dispatches = [s for s in spans if s["name"] == "decode_dispatch"]
    assert len(dispatches) == len(blocks)


def test_decode_block_tokens_sum_over_many_requests():
    # More requests than slots, uneven budgets: each finishes somewhere
    # inside a block, and later ones wait in the queue for a slot.
    engine = moe_engine(block=4)
    sched = Scheduler(engine)
    events: dict = {}
    budgets = [3, 10, 6, 13, 5, 8]
    run_here(sched, [request(i, n, events) for i, n in enumerate(budgets)])
    spans = sched.trace_export()["spans"]
    blocks = [s for s in spans if s["name"] == "decode_block"]
    streamed = sum(len("".join(ev.text for ev in evs))
                   for evs in events.values())
    assert streamed == sum(budgets)
    assert sum(s["tokens"] for s in blocks) == streamed - len(budgets)
    assert sum(s["tokens"] for s in blocks) == (
        sched.metrics["tokens"] - len(budgets))
    assert all(0 <= s["lanes"] <= s["slots"] <= engine.max_slots
               for s in blocks)
    assert 0 < lane_use(spans, engine.max_slots) < 1
    queues = [s for s in spans if s["name"] == "queue"]
    assert sorted(s["request_id"] for s in queues) == sorted(
        f"r{i}" for i in range(len(budgets)))
    assert all(s["duration_s"] >= 0 for s in queues)


# ------------------------------------------------------------ provider


def test_provider_ttft_and_e2e_histograms_still_count():
    from symmetry_tpu_torch.client.client import SymmetryClient
    from symmetry_tpu_torch.identity import Identity
    from symmetry_tpu_torch.provider.backends.echo import EchoBackend
    from symmetry_tpu_torch.provider.config import ConfigManager
    from symmetry_tpu_torch.provider.provider import SymmetryProvider
    from symmetry_tpu_torch.server.broker import SymmetryServer
    from symmetry_tpu_torch.transport.memory import MemoryTransport

    async def main():
        hub = MemoryTransport()
        server_ident = Identity.from_name("trace-server")
        server = SymmetryServer(server_ident, hub)
        await server.start("mem://server")
        prov = SymmetryProvider(
            ConfigManager(config={
                "name": "prov-t", "public": True,
                "serverKey": server_ident.public_hex,
                "modelName": "echo-model", "apiProvider": "echo",
                "dataCollectionEnabled": False}),
            transport=hub, backend=EchoBackend(),
            identity=Identity.from_name("prov-t"),
            server_address="mem://server")
        await prov.start("mem://prov-t")
        await prov.wait_registered()
        client = SymmetryClient(Identity.from_name("cli-t"), hub)
        details = await client.request_provider(
            "mem://server", server_ident.public_key, "echo-model")
        session = await client.connect(details)
        for text in ("one two three", "four", "five six"):
            assert await session.chat_text(
                [{"role": "user", "content": text}]) == text
        stats = prov.stats()
        spans = prov.tracer.export()
        await session.close()
        await prov.stop()
        await server.stop()
        return stats, spans

    stats, spans = asyncio.new_event_loop().run_until_complete(
        asyncio.wait_for(main(), 30))
    assert stats["ttft_s"]["count"] == 3
    assert stats["e2e_s"]["count"] == 3
    assert stats["ttft_s"]["max"] <= stats["e2e_s"]["max"]
    assert sorted(s["name"] for s in spans
                  if s["name"] in ("ttft", "inference")) == (
        ["inference"] * 3 + ["ttft"] * 3)
    assert not hasattr(Tracer(), "histogram")
