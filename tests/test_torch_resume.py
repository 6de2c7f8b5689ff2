"""Resumable streams: crash-surviving generation.

Copied from tests/test_resume.py and moved onto the port: the engine is
the PyTorch one on the CPU (its plain versions), the backend the port's.
Three layers, all CPU / fake-host local (no crypto, no card):

  - ENGINE: a resumed request — prompt + already-emitted tokens, RNG
    lane fast-forwarded by `rng_skip` — continues token-identical to the
    uninterrupted run, for greedy AND seeded sampling (the RNG-chain
    restore is the part greedy can't exercise).
  - SCHEDULER: the resume admission path — resume_offset accounting
    (sym_resume_* counters), the radix-cache hit on the prompt+emitted
    prefix (tokens_reused > 0: a resume is a cheap seeded re-prefill,
    not a full regeneration), and the first-event resume riders.
  - HOST/BACKEND: the wire — EngineHost._submit's resume parsing, and
    TpuNativeBackend against the protocol-faithful fake host: crash
    mid-stream stamps the journal's emitted count into the restarting
    shed, a resume submit streams only the continuation, and the
    relay's offset dedup drops deliberately-overlapping events.
"""

from __future__ import annotations

import asyncio
import dataclasses
import os
import sys
import threading

import torch
import pytest

from symmetry_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from symmetry_tpu_torch.engine.host import EngineHost
from symmetry_tpu_torch.engine.scheduler import GenRequest, Scheduler
from symmetry_tpu_torch.engine.tokenizer import ByteTokenizer
from symmetry_tpu_torch.models import init_params, preset
from symmetry_tpu_torch.provider.backends.base import (
    BackendRestartingError,
    InferenceRequest,
    ResumeJournal,
)
from symmetry_tpu_torch.provider.backends.tpu_native import TpuNativeBackend
from symmetry_tpu_torch.provider.config import ConfigManager
from symmetry_tpu_torch.utils.faults import FAULTS

FAKE_HOST = os.path.join(os.path.dirname(__file__), "fake_host.py")


@pytest.fixture(autouse=True)
def clean_global_faults():
    FAULTS.clear()
    yield
    FAULTS.clear()


@pytest.fixture(scope="module")
def setup():
    cfg = preset("tiny")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32)
    return cfg, params


def make_engine(cfg, params, slots=4, cache_mb=16, chunk=8,
                buckets=(16, 32, 64), block=8):
    return InferenceEngine(
        cfg, params, ByteTokenizer(vocab_size=cfg.vocab_size),
        max_slots=slots, max_seq_len=128,
        prefill_buckets=buckets, cache_dtype=torch.float32,
        prefill_chunk=chunk, prefix_cache_bytes=cache_mb * 2**20,
        prefix_block_tokens=block, device="cpu")


def engine_generate(engine, slot, prompt_ids, sampling, n):
    """n sampled token ids for one request, engine-level (no scheduler):
    prefill then single-slot decode blocks. EOS is NOT cut — identity is
    judged on the raw sampled chain, which a resume must reproduce."""
    first = engine.prefill_and_insert(slot, prompt_ids, sampling)
    out = [first]
    while len(out) < n:
        toks = engine.decode_steps()  # [K, B]
        for k in range(toks.shape[0]):
            out.append(int(toks[k, slot]))
            if len(out) >= n:
                break
    engine.release_slot(slot)
    return out


PROMPT = list(b"resumable streams survive host crashes")  # 38 ids


class TestEngineResumeIdentity:
    """The tentpole contract at the engine: continuation == tail of the
    uninterrupted run. The resumed request conditions on prompt + the
    ACTUAL emitted ids (the host derives them from the client's text;
    here the id-level contract is pinned directly) with the RNG lane
    fast-forwarded by rng_skip."""

    N, K = 12, 5  # full length, interruption point

    def _roundtrip(self, setup, sampling):
        cfg, params = setup
        engine = make_engine(cfg, params)
        full = engine_generate(engine, 0, PROMPT, sampling, self.N)
        resumed_sampling = dataclasses.replace(sampling, rng_skip=self.K)
        cont = engine_generate(
            engine, 1, PROMPT + full[:self.K], resumed_sampling,
            self.N - self.K)
        assert cont == full[self.K:], (full, cont)

    def test_greedy_resume_token_identity(self, setup):
        self._roundtrip(setup, SamplingParams())

    def test_seeded_resume_token_identity(self, setup):
        # Temperature high enough that a wrong RNG position would
        # scramble the continuation immediately.
        self._roundtrip(setup, SamplingParams(temperature=0.9, top_p=0.95,
                                              seed=1234))

    def test_seeded_resume_wrong_skip_diverges(self, setup):
        """Negative control: the RNG fast-forward is load-bearing — an
        off-by-one lane position changes the sampled continuation."""
        cfg, params = setup
        engine = make_engine(cfg, params, cache_mb=0)
        sampling = SamplingParams(temperature=0.9, top_p=0.95, seed=1234)
        full = engine_generate(engine, 0, PROMPT, sampling, self.N)
        wrong = dataclasses.replace(sampling, rng_skip=self.K - 1)
        cont = engine_generate(
            engine, 1, PROMPT + full[:self.K], wrong, self.N - self.K)
        assert cont != full[self.K:]

    def test_rng_skip_zero_is_identity(self, setup):
        cfg, params = setup
        engine = make_engine(cfg, params, cache_mb=0)
        s0 = SamplingParams(temperature=0.7, seed=9)
        s_skip0 = dataclasses.replace(s0, rng_skip=0)
        a = engine_generate(engine, 0, PROMPT, s0, 6)
        b = engine_generate(engine, 1, PROMPT, s_skip0, 6)
        assert a == b

    def test_resume_survives_engine_restart(self, setup):
        """The cross-host case: the continuation runs on a FRESH engine
        (empty radix tree, fresh slot state) — exactly what a respawned
        or different provider sees — and is still token-identical."""
        cfg, params = setup
        engine1 = make_engine(cfg, params)
        sampling = SamplingParams(temperature=0.8, seed=77)
        full = engine_generate(engine1, 0, PROMPT, sampling, self.N)
        engine2 = make_engine(cfg, params)
        cont = engine_generate(
            engine2, 0, PROMPT + full[:self.K],
            dataclasses.replace(sampling, rng_skip=self.K),
            self.N - self.K)
        assert cont == full[self.K:]


def run_scheduler_requests(engine, requests):
    """requests: list of GenRequest kwargs dicts. Returns (sched,
    events-per-request)."""
    sched = Scheduler(engine, debug_invariants=True)
    results = {i: [] for i in range(len(requests))}
    done = {i: threading.Event() for i in range(len(requests))}
    for i, kwargs in enumerate(requests):
        def emit(ev, i=i):
            results[i].append(ev)
            if ev.done:
                done[i].set()
        sched.submit(GenRequest(emit=emit, id=f"r{i}", **kwargs))
    sched.start()
    for ev in done.values():
        assert ev.wait(120), "request did not complete"
    sched.stop()
    return sched, results


class TestSchedulerResumeAdmission:
    def test_resume_hits_radix_cache_and_books_counters(self, setup):
        """The cheap-resume contract: after an ordinary admission stored
        the prompt's blocks, a resume admission (prompt + emitted) HITS
        the radix cache (tokens_reused > 0 — seeded re-prefill, not full
        regeneration), books the sym_resume_* counters, and stamps the
        first event with the resume riders."""
        cfg, params = setup
        # One slot: the resume admits only after the first request
        # completed (and its admission stored the prompt blocks), so the
        # resume's lookup must hit — same serialization idiom as the
        # prefix-cache counter test.
        engine = make_engine(cfg, params, slots=1)
        sampling = SamplingParams()
        k = 5
        # The interrupted run: admits through the scheduler (populating
        # the radix tree with the prompt's whole blocks), emits k tokens.
        full = engine_generate(
            make_engine(cfg, params, cache_mb=0), 0, PROMPT, sampling, 10)
        sched, results = run_scheduler_requests(engine, [
            dict(prompt_ids=PROMPT, sampling=sampling, max_new_tokens=k),
            dict(prompt_ids=PROMPT + full[:k], sampling=sampling,
                 max_new_tokens=10 - k, resume_offset=k),
        ])
        stats = sched.stats()
        assert stats["resumes"] == 1
        assert stats["resumed_tokens"] == k
        # The resume admission reused at least the prompt's whole blocks
        # (the interrupted run's admission stored them).
        assert stats["resume_reused_tokens"] > 0
        first = results[1][0]
        assert first.resumed_from == k
        assert first.tokens_reused and first.tokens_reused > 0
        # And the continuation itself is the uninterrupted tail (token
        # ids, via tokens_generated accounting: 10 - k tokens total).
        last = results[1][-1]
        assert last.done and last.finish_reason in ("length", "stop")

    def test_non_resume_requests_book_nothing(self, setup):
        cfg, params = setup
        engine = make_engine(cfg, params, cache_mb=0)
        sched, _ = run_scheduler_requests(engine, [
            dict(prompt_ids=PROMPT, sampling=SamplingParams(),
                 max_new_tokens=3)])
        stats = sched.stats()
        assert stats["resumes"] == 0
        assert stats["resumed_tokens"] == 0
        assert stats["resume_reused_tokens"] == 0


class _StubScheduler:
    def __init__(self):
        self.submitted = []

    def submit(self, req):
        self.submitted.append(req)


class TestHostResumeParsing:
    """EngineHost._submit's resume leg: prompt extension, token-budget
    offset, RNG skip, and the derived-count fallback — no subprocess."""

    def _host(self):
        from types import SimpleNamespace

        host = EngineHost(config=None)
        host._engine = SimpleNamespace(tokenizer=ByteTokenizer(),
                                       prefix_block=0)
        host._scheduler = _StubScheduler()
        return host

    def test_resume_extends_prompt_and_offsets_budget(self):
        host = self._host()
        host._submit({"op": "submit", "id": "r1",
                      "messages": [{"role": "user", "content": "hi"}],
                      "max_new": 32,
                      "sampling": {"seed": 7},
                      "resume": {"text": "abcd", "tokens": 4}})
        (req,) = host._scheduler.submitted
        base = ByteTokenizer().apply_chat_template(
            [{"role": "user", "content": "hi"}])
        assert req.prompt_ids == base + list(b"abcd")
        assert req.max_new_tokens == 32 - 4
        assert req.resume_offset == 4
        assert req.sampling.rng_skip == 4
        assert req.sampling.seed == 7

    def test_resume_token_count_derived_from_text(self):
        host = self._host()
        host._submit({"op": "submit", "id": "r2",
                      "messages": [{"role": "user", "content": "hi"}],
                      "max_new": 32, "sampling": {},
                      "resume": {"text": "abcd"}})
        (req,) = host._scheduler.submitted
        assert req.resume_offset == 4  # byte tokenizer: 1 token per char
        assert req.max_new_tokens == 28

    def test_resume_exhausted_budget_completes_immediately(self):
        """The interrupted stream already spent max_tokens (only the
        finish frame was lost): the resume completes with a zero-token
        "length" finish instead of generating past the client's budget
        (which would also break identity with the uninterrupted run)."""
        host = self._host()
        writes = []
        host._write = lambda obj, events=0: writes.append(obj)
        host._submit({"op": "submit", "id": "r3",
                      "messages": [{"role": "user", "content": "hi"}],
                      "max_new": 3, "sampling": {},
                      "resume": {"text": "abcd", "tokens": 4}})
        assert host._scheduler.submitted == []  # never admitted
        (ev,) = writes
        assert ev["done"] and ev["finish_reason"] == "length"
        assert ev["tokens_new"] == 0 and ev["resume_from"] == 4

    def test_resume_negative_claim_rejected(self):
        host = self._host()
        writes = []
        host._write = lambda obj, events=0: writes.append(obj)
        host._submit({"op": "submit", "id": "r5",
                      "messages": [{"role": "user", "content": "hi"}],
                      "max_new": 8, "sampling": {},
                      "resume": {"text": "abcd", "tokens": -2}})
        assert host._scheduler.submitted == []
        (ev,) = writes
        assert ev["finish_reason"] == "error"
        assert "resume tokens" in ev["error"]

    def test_plain_submit_unchanged(self):
        host = self._host()
        host._submit({"op": "submit", "id": "r4",
                      "messages": [{"role": "user", "content": "hi"}],
                      "max_new": 8, "sampling": {}})
        (req,) = host._scheduler.submitted
        assert req.resume_offset == 0
        assert req.sampling.rng_skip == 0
        assert req.max_new_tokens == 8


class TestResumeJournal:
    def test_track_note_get_release(self):
        j = ResumeJournal()
        h = j.track("a")
        h.note(3)
        h.note(2)
        assert j.get("a") == 5
        assert j.get("missing") == 0
        h.release()
        assert j.get("a") == 0
        h.release()  # idempotent

    def test_merge_is_lower_bound(self):
        j = ResumeJournal()
        h = j.track("a")
        h.note(2)
        j.merge({"a": 7, "untracked": 9})
        assert j.get("a") == 7          # host journal ahead of relay
        assert j.get("untracked") == 0  # never tracked: not resurrected
        j.merge({"a": 3})
        assert j.get("a") == 7          # max-merge, never regresses
        h.release()


# --------------------------------------------------------------------
# Backend ⇄ fake host: the wire path (crash stamps, resume stream,
# offset dedup) — same harness as tests/test_supervisor.py.


class FakeHostBackend(TpuNativeBackend):
    def _host_argv(self, cfg_path):
        return [sys.executable, FAKE_HOST, cfg_path]


def fake_cfg(faults=None, fake_host=None):
    supervisor = {"heartbeat_s": 0.2, "wedge_timeout_s": 1.0,
                  "backoff_base_s": 0.05, "backoff_max_s": 0.2,
                  "max_respawns": 2, "spawn_timeout_s": 15.0,
                  "stop_grace_s": 0.5}
    return ConfigManager(config={
        "name": "resume-prov", "public": False, "serverKey": "00" * 32,
        "modelName": "fake:resume", "apiProvider": "tpu_native",
        "dataCollectionEnabled": False,
        "tpu": {"engine_isolation": "process", "max_batch_size": 4,
                "supervisor": supervisor},
        **({"faults": faults} if faults else {}),
        **({"fakeHost": fake_host} if fake_host else {}),
    })


def run(coro):
    return asyncio.new_event_loop().run_until_complete(
        asyncio.wait_for(coro, 60))


async def collect(backend, request):
    parts = []
    async for chunk in backend.stream(request):
        if chunk.text:
            parts.append(chunk.text)
    return parts


class TestBackendResume:
    def test_crash_shed_carries_journal_emitted(self):
        """Supervisor crash mid-stream: the restarting shed's `emitted`
        stamp equals the tokens this stream actually relayed — the
        client's resume anchor. (Write arithmetic: startup = ready +
        clock×5 = 6 writes; nth=11 kills the host on the stream's 5th
        event, so 4 full events relayed before the crash.)"""
        cfg = fake_cfg(faults={"host.pipe_write": "crash@nth=11"})

        async def main():
            backend = FakeHostBackend(cfg)
            await backend.start()
            try:
                got = []
                with pytest.raises(BackendRestartingError) as exc_info:
                    async for chunk in backend.stream(InferenceRequest(
                            messages=[{"role": "user", "content": "x"}],
                            max_tokens=40)):
                        if chunk.text:
                            got.append(chunk.text)
                assert got, "crash landed before anything streamed"
                assert exc_info.value.emitted == len(got)
            finally:
                await backend.stop()

        run(main())

    def test_resume_streams_continuation_only(self):
        """A resume submit against the fake host yields only t{R}… and
        the backend books resumes/resumed/reused (tokens_reused > 0 on
        the resume admission — the acceptance-gate counter)."""
        cfg = fake_cfg()

        async def main():
            backend = FakeHostBackend(cfg)
            await backend.start()
            try:
                full = await collect(backend, InferenceRequest(
                    messages=[{"role": "user", "content": "x"}],
                    max_tokens=9))
                assert full == [f"t{i} " for i in range(8)]
                cont = await collect(backend, InferenceRequest(
                    messages=[{"role": "user", "content": "x"}],
                    max_tokens=9,
                    resume_text="".join(full[:3]), resume_tokens=3))
                assert cont == full[3:], cont
                assert backend.resume_stats["resumes"] == 1
                assert backend.resume_stats["resumed_tokens"] == 3
                assert backend.resume_stats["reused_tokens"] > 0
                assert backend.resume_stats["dedup_dropped"] == 0
                stats = await backend.engine_stats()
                assert stats["resume"]["resumes"] == 1
            finally:
                await backend.stop()

        run(main())

    def test_offset_dedup_drops_overlap(self):
        """The host rewinds its continuation 2 tokens below the client's
        count (fakeHost.resumeOverlap) — the relay's offset dedup drops
        exactly the overlap, so the client never sees a replayed token."""
        cfg = fake_cfg(fake_host={"resumeOverlap": 2})

        async def main():
            backend = FakeHostBackend(cfg)
            await backend.start()
            try:
                full = [f"t{i} " for i in range(8)]
                cont = await collect(backend, InferenceRequest(
                    messages=[{"role": "user", "content": "x"}],
                    max_tokens=9,
                    resume_text="".join(full[:4]), resume_tokens=4))
                assert cont == full[4:], cont
                assert backend.resume_stats["dedup_dropped"] == 2
            finally:
                await backend.stop()

        run(main())

    def test_inproc_resume_continues_not_regenerates(self):
        """engine_isolation: inproc honors resume too (supports_resume
        is a class attribute, so the provider accepts resumes against
        this branch): the continuation stream carries exactly
        max_new − R tokens — a from-token-0 regeneration would emit the
        full budget and corrupt the client's splice."""
        cfg = ConfigManager(config={
            "name": "resume-inproc", "public": False,
            "serverKey": "00" * 32, "modelName": "tiny:resume",
            "apiProvider": "tpu_native", "dataCollectionEnabled": False,
            "tpu": {"engine_isolation": "inproc", "model_preset": "tiny",
                    "dtype": "float32", "max_batch_size": 2,
                    "max_seq_len": 128, "prefill_buckets": [32, 64],
                    "decode_block": 1, "prefill_chunk": 8,
                    "prefix_cache_mb": 16},
        })

        async def main():
            backend = TpuNativeBackend(cfg, device="cpu")
            await backend.start()
            try:
                full = []
                async for chunk in backend.stream(InferenceRequest(
                        messages=[{"role": "user", "content": "hi"}],
                        max_tokens=12)):
                    if chunk.tokens:
                        full.append(chunk)
                full_text = "".join(c.text for c in full)
                n_full = sum(c.tokens for c in full)
                cont_tokens = 0
                async for chunk in backend.stream(InferenceRequest(
                        messages=[{"role": "user", "content": "hi"}],
                        max_tokens=12, resume_text=full_text[:4],
                        resume_tokens=5)):
                    cont_tokens += chunk.tokens or 0
                # Budget honored: 12 − 5 = 7 tokens max (fewer only on
                # an early EOS, which the full run would have hit too).
                assert cont_tokens <= 12 - 5, cont_tokens
                assert n_full > cont_tokens
                assert backend.resume_stats["resumes"] == 1
                assert backend.resume_stats["resumed_tokens"] == 5
                stats = await backend.engine_stats()
                assert stats["resumes"] == 1
                assert stats["resumed_tokens"] == 5
                assert stats["resume"]["resumes"] == 1
            finally:
                await backend.stop()

        run(main())

    def test_journal_heartbeat_merge(self):
        """The host's stats-journal rider reaches the backend journal
        through the supervisor heartbeat: after a few relayed events the
        journal's count for the live stream is > 0 (and the entry is
        gone once the stream finishes)."""
        cfg = fake_cfg(fake_host={"tokenDelayS": 0.05})

        async def main():
            backend = FakeHostBackend(cfg)
            await backend.start()
            try:
                req = InferenceRequest(
                    messages=[{"role": "user", "content": "x"}],
                    max_tokens=30)
                seen = []
                agen = backend.stream(req)
                async for chunk in agen:
                    if chunk.text:
                        seen.append(chunk.text)
                    if len(seen) >= 4:
                        break
                # Mid-stream: the journal holds the relayed count.
                live = [k for k in backend._journal._emitted]
                assert live and backend._journal.get(live[0]) >= 4
                await agen.aclose()
                await asyncio.sleep(0.1)
                assert not backend._journal._emitted  # released
            finally:
                await backend.stop()

        run(main())
