"""Continuous batching scheduler: requests in, per-request token streams out.

The reference's hot loop pumped one HTTP response per peer with backpressure
(reference: src/provider.ts:240-258). Here the equivalent loop is the decode
step over a slot batch: requests are inserted the moment a slot frees
(insert-on-arrival), every step advances all active slots one token, and
slots are evicted on EOS / token budget / client cancellation — BASELINE
config 3 (16 concurrent clients, continuous batching).

Threading model: one dedicated engine thread owns all JAX calls (the engine
is single-threaded by contract); asyncio callers talk to it through
queue.Queue (in) and asyncio-loop-safe callbacks (out). This preserves the
reference's "all concurrency in one event loop" simplicity (SURVEY §5.2)
while keeping device dispatch off the loop.

Slot-accounting invariants are checked every step when `debug_invariants`
is on (SURVEY §5.2: an invariant-checking debug mode for the batch
scheduler): a slot is in exactly one of {free, active}; an active slot's
request has a live stream; cache length never exceeds capacity.
"""

from __future__ import annotations

import asyncio
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from symmetry_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from symmetry_tpu_torch.engine.ledger import RequestLedger
from symmetry_tpu_torch.engine.tokenizer import StreamDecoder
from symmetry_tpu_torch.utils.faults import FAULTS, InjectedFault
from symmetry_tpu_torch.utils.logging import logger as log


@dataclass
class GenRequest:
    """One generation job as the scheduler sees it."""

    prompt_ids: list[int]
    sampling: SamplingParams
    max_new_tokens: int
    # Called from the engine thread via loop.call_soon_threadsafe.
    emit: Callable[["TokenEvent"], None]
    cancelled: Callable[[], bool] = lambda: False
    id: str = ""
    # Per-request speculative-decoding override: False opts this request
    # out of drafting (its slot rides plain decode lanes); None/True defer
    # to the engine's tpu.speculative knob. No effect when the knob is off.
    speculative: bool | None = None
    # Request trace context: the id the client minted, threaded through
    # provider → host pipe → here, so scheduler spans for this request
    # land on the same Perfetto timeline as everyone else's.
    trace_id: str = ""
    # Decode-tier handoff adoption (engine/disagg/): called ONCE with
    # this request on the engine thread when admission first picks it,
    # BEFORE the prefix lookup — the radix index's mutation contract is
    # engine-thread-only, and the adoption's heavy work (frame decode,
    # device transfer) belongs next to the other admission device work,
    # not on the host's serial wire thread. The thunk fills
    # `prompt_ids` from the frame's tokens (the request is submitted
    # with an empty prompt) and seeds the store. Raising fails this
    # request with an error event (never the loop).
    adopt: Callable[["GenRequest"], None] | None = None
    # Absolute CLOCK_MONOTONIC deadline (client deadline_s mapped through
    # provider → host receipt). A request whose deadline has already
    # passed when admission picks it is shed with finish_reason
    # "expired" instead of prefilled — under backlog, prefilling work
    # nobody is waiting for steals device time from requests that still
    # have a live consumer. None = no deadline.
    deadline_at: float | None = None
    # Stream resumption: how many completion tokens the client already
    # holds (prompt_ids then carries prompt + re-encoded emitted text,
    # and sampling.rng_skip repositions a seeded lane). Admission books
    # it under the sym_resume_* families; the first event echoes it as
    # `resumed_from` so the relay can offset-dedup any overlap.
    resume_offset: int = 0
    # Radix-cache tokens this admission reused (stamped by _place_group
    # when a prefix hit covers the prompt): the first event carries it,
    # and a resume admission with reused > 0 is the cheap seeded
    # re-prefill the resume path exists for (vs a full re-prefill).
    reused_tokens: int = 0
    # symledger cost account (engine/ledger.py), opened by submit()
    # while tpu.ledger is on; None otherwise — every booking site is
    # then one `is not None` branch (the disabled-mode contract).
    ledger: Any = None
    enqueued_at: float = field(default_factory=time.monotonic)
    # Stamped when the request enters a placement group (the admission
    # moment); re-stamped on re-pick after a budget deferral, so
    # picked_at - enqueued_at is the true scheduler queue wait. Feeds the
    # per-stage TTFT breakdown (TokenEvent.stages).
    picked_at: float | None = None


@dataclass(slots=True)
class TokenEvent:
    """One streamed increment: text delta and/or terminal marker."""

    text: str
    token_id: int | None
    done: bool = False
    # "stop" | "length" | "cancelled" | "error" | "expired"
    finish_reason: str | None = None
    error: str | None = None
    # serving metrics (SURVEY §5.1: TTFT and tok/s are first-class)
    ttft_s: float | None = None
    tokens_generated: int = 0
    # Cumulative tokens actually EMITTED as text (pushed to the stream
    # decoder) — excludes the EOS token and anything a finishing block
    # discarded past it, so deltas of this field sum to exactly what the
    # client streamed (the host's tokens_new and the bench's
    # tokens_streamed both ride it; tokens_generated keeps the
    # budget-accounting convention of counting the EOS).
    tokens_emitted: int = 0
    # Per-stage monotonic stamps, attached ONCE per request (its first
    # event): {"recv": host received, "picked": entered a placement
    # group, "first": first token sampled}. The host adds its pipe-write
    # stamp and the provider closes the chain — the end-to-end TTFT
    # attribution of round-4 task #3 (CLOCK_MONOTONIC is one clock
    # across processes on Linux, same contract the bench workers use).
    stages: dict | None = None
    # First-event-only resume/reuse stamps (None elsewhere): tokens this
    # admission pulled from the radix cache, and — for a resumed request
    # — the completion offset generation continued from (the relay's
    # offset-dedup input).
    tokens_reused: int | None = None
    resumed_from: int | None = None
    # Terminal-event-only symledger cost block (engine/ledger.py):
    # device_s{phase} / queue_s / emit_s / wasted_s{reason} / saved_s,
    # attributed at dispatch granularity. None mid-stream, and None on
    # terminal events while tpu.ledger is off.
    costs: dict | None = None


@dataclass
class _ActiveSlot:
    req: GenRequest
    decoder: StreamDecoder
    generated: int = 0
    emitted: int = 0   # tokens pushed to the decoder (streamed as text)
    prompt_len: int = 0
    first_token_at: float | None = None
    stages_sent: bool = False


class Scheduler:
    """Drives an InferenceEngine from a request queue on its own thread."""

    def __init__(self, engine: InferenceEngine, *,
                 debug_invariants: bool = False,
                 prefill_chunks_per_block: int = 4,
                 admit_groups_per_block: int = 4,
                 admit_seconds_per_block: float = 0.65,
                 pipeline_depth: int = 2,
                 emit_queue_blocks: int = 8,
                 emit_batch: Callable[
                     [list[tuple[GenRequest, TokenEvent]]], None]
                 | None = None,
                 handoff: Callable[[int, GenRequest, int], None]
                 | None = None,
                 ledger_enabled: bool = True) -> None:
        self.engine = engine
        # Disaggregated tier role (engine/disagg/): mirrors the engine's.
        # "prefill" replaces slot activation with the handoff sink — a
        # request that would have started decoding is instead serialized
        # and shipped (the sink extracts + writes the frame, called on
        # the engine thread), its slot freed immediately. "decode" books
        # adopted-prefix suffix dispatches under adopt_* instead of
        # admit_* (a decode-tier host must report ZERO admission-prefill
        # wall — the prefill tier owns that work now). "unified" is
        # byte-identical to the pre-disagg scheduler.
        self._role = getattr(engine, "role", "unified")
        self._handoff = handoff
        if self._role == "prefill" and handoff is None:
            raise ValueError("role: prefill scheduler requires a handoff "
                             "sink — prefilled requests have nowhere to go")
        self._inbox: queue.Queue[GenRequest | None] = queue.Queue()
        # Budget-deferred admissions wait HERE, not at the inbox tail:
        # re-queuing a deferred subgroup behind later arrivals inverted
        # FIFO order every block it stayed deferred, unboundedly inflating
        # that request's TTFT under sustained load. Drained before the
        # inbox on the next _admit_new pass, so arrival order holds.
        self._deferred: deque[GenRequest] = deque()
        self._slots: dict[int, _ActiveSlot] = {}
        self._free: list[int] = list(range(engine.max_slots))[::-1]
        # Block-granular emit: events buffer on the engine thread and are
        # delivered at block boundaries — as ONE emit_batch call when a
        # sink is installed (the host pipe writes one frame per block), or
        # per-event through req.emit otherwise (AsyncSession, tests).
        self._emit_batch = emit_batch
        self._pending_events: list[tuple[GenRequest, TokenEvent]] = []
        # Overlapped pipeline (ROADMAP item 2): keep up to `pipeline_depth`
        # decode blocks dispatched-but-unsynced between iterations, so the
        # host's per-block work (detokenize, event encode, pipe emit,
        # bookkeeping) overlaps device execution instead of serializing
        # with it. Depth 1 reproduces the pre-pipeline double-buffer loop
        # exactly (the A/B baseline).
        self._depth = max(1, int(pipeline_depth))
        # Emit/bookkeep offload (depth >= 2): everything that is not a
        # device dispatch — push_many detokenize, TokenEvent construction,
        # stage-stamp decoration, emit_batch/req.emit delivery — runs on a
        # dedicated worker thread fed per-block job batches through a
        # BOUNDED queue. The bound is the backpressure contract: a slow
        # pipe consumer makes the blocking put below stall the dispatch
        # thread rather than queue events without limit. All events flow
        # through the queue while offload is on (never a mix of inline and
        # queued delivery), so per-request wire order is exactly the
        # engine-thread production order. `_emit_offload` is written ONLY
        # by start() before the threads exist; everywhere else reads it.
        self._emit_queue: queue.Queue[list[tuple] | None] = queue.Queue(
            maxsize=max(1, int(emit_queue_blocks)))
        self._emit_thread: threading.Thread | None = None
        self._emit_offload = False
        self._block_jobs: list[tuple] = []
        # Worker-owned counters (merged into stats() reads): the worker
        # never touches self.metrics — key ownership stays single-thread.
        self._wmetrics = {"offloaded_s": 0.0, "emit_flushes": 0,
                          "emit_events": 0}
        self._live_depth = 0
        # Vectorized terminal scan over each [K, B] block needs the EOS
        # set as an array once, not a per-token set probe.
        self._eos_arr = np.array(sorted(engine.tokenizer.eos_ids),
                                 dtype=np.int64)
        # Long prompts prefill chunk-by-chunk between decode blocks
        # (engine.ChunkedPrefill); short bursts are capped per block. Both
        # bound how long active streams stall on admission work — the
        # round-2 verdict's inter-token-p99 complaint.
        self._prefill_jobs: list[tuple[Any, GenRequest]] = []
        self._chunks_per_block = prefill_chunks_per_block
        self._admit_groups = admit_groups_per_block
        # The binding admission bound while streams are active is TIME, not
        # count, shared by burst admissions and chunked-prefill advances:
        # stop admitting once the block's admission work exceeds this many
        # seconds (one dispatch may overshoot — admissions are atomic).
        # Measured on-chip (round 4): prefill dispatches overlap the
        # in-flight decode block (async dispatch), so engine-side block
        # intervals stay <= ~1.6x block time even at 2 wide admissions
        # per block — while halving the budget to one dispatch per block
        # only stretched the ramp (TTFT p50 5.0 -> 7.0 s) without moving
        # the client-observed gap. 0.65 allows ~2 batch-16 prefills per
        # block; the count caps remain as secondary bounds.
        self._admit_budget_s = admit_seconds_per_block
        self._spent_this_block = 0.0
        self._debug = debug_invariants
        self._thread: threading.Thread | None = None
        self._stopping = threading.Event()
        # Speculative decoding (engine/spec/): when the engine was built
        # with tpu.speculative, the scheduler owns the host-side n-gram
        # drafter and interleaves verify dispatches with plain decode
        # blocks. Engine spec None => self._drafter None => every code
        # path below is byte-identical to the non-speculative scheduler.
        spec = getattr(engine, "spec", None)
        if spec is not None:
            from symmetry_tpu_torch.engine.spec import NGramDrafter

            self._drafter: NGramDrafter | None = NGramDrafter(spec)
        else:
            self._drafter = None
        # KV writes one dispatch can land for a slot: a verify dispatch
        # touches 1 + k_draft positions where a plain block touches
        # decode_block — the capacity guards must fence the larger.
        self._max_block_writes = max(
            engine.decode_block,
            (1 + spec.k_draft) if spec is not None else 0)
        self.metrics = {"requests": 0, "tokens": 0, "evictions": 0,
                        "steps": 0, "peak_occupancy": 0,
                        # Requests shed at admission because their
                        # end-to-end deadline had already expired (the
                        # overload-round accounting: prefill work saved).
                        "deadline_shed": 0,
                        # Stream resumption (all 0 without resumes):
                        # resume submissions, completion tokens they
                        # skipped regenerating, and the radix-cache
                        # tokens their admissions reused instead of
                        # re-prefilling (reused > 0 is the cheap-resume
                        # contract the kill-under-load round asserts).
                        "resumes": 0, "resumed_tokens": 0,
                        "resume_reused_tokens": 0,
                        # Per-phase wall accounting (round-3 verdict: a
                        # benchmark capture must carry its own explanation):
                        # admission prefill dispatches, chunked-prefill
                        # advances, decode-block syncs — each phase's count
                        # and cumulative seconds, read via stats().
                        "admit_dispatches": 0, "admit_s": 0.0,
                        "chunk_dispatches": 0, "chunk_s": 0.0,
                        "block_syncs": 0, "sync_s": 0.0,
                        # Emit-path accounting: flushes = batch deliveries
                        # (one per block boundary with events pending),
                        # events = TokenEvents carried. events/flushes is
                        # the coalescing ratio the batched host frame
                        # exists to raise.
                        "emit_flushes": 0, "emit_events": 0,
                        # Disaggregation (all 0 outside the tier roles):
                        # prefill tier — requests handed off + serialize/
                        # extract wall; decode tier — adopted-prefix
                        # suffix dispatches, booked HERE so admit_* stays
                        # zero on a host that does no admission prefill.
                        "handoffs": 0, "handoff_s": 0.0,
                        "adopt_dispatches": 0, "adopt_s": 0.0,
                        # Speculative decoding (all 0 with the knob off):
                        # verify dispatches, tokens the drafter proposed,
                        # tokens the target accepted, and tokens rolled
                        # back (drafted - accepted); spec_verify_s is the
                        # wall spent in verify dispatch+sync.
                        "spec_verify_blocks": 0, "spec_drafted": 0,
                        "spec_accepted": 0, "spec_rolled_back": 0,
                        "spec_tokens": 0, "spec_verify_s": 0.0,
                        # Dispatch-thread wall: non-idle loop-iteration
                        # seconds on the engine thread. Its counterpart,
                        # offloaded_s (emit-worker wall), lives in
                        # _wmetrics — the split is the CPU-verifiable
                        # proxy for dispatch_gap_share -> ~0.
                        "dispatch_thread_s": 0.0}
        from symmetry_tpu_torch.utils.metrics import METRICS, MetricName
        from symmetry_tpu_torch.utils.trace import Histogram, Tracer

        # Always-on time series (utils/metrics.py): the same counters the
        # stats() snapshot reports, but as registry families a Prometheus
        # scrape / symtop poll reads without a stats round-trip. Emitted
        # at block/dispatch granularity only — never per token — and
        # disabled-mode cost is one branch (metrics.enabled: false).
        self._m_requests = METRICS.counter(
            MetricName.SCHED_REQUESTS, "requests submitted to the scheduler")
        self._m_tokens = METRICS.counter(
            MetricName.SCHED_TOKENS, "tokens emitted by the engine")
        self._m_queue_depth = METRICS.gauge(
            MetricName.SCHED_QUEUE_DEPTH,
            "inbox + budget-deferred admission backlog")
        self._m_occupancy = METRICS.gauge(
            MetricName.SCHED_OCCUPANCY, "active decode slots")
        self._m_evictions = METRICS.counter(
            MetricName.SCHED_EVICTIONS, "slots released (request finished)")
        self._m_deadline_sheds = METRICS.counter(
            MetricName.SCHED_DEADLINE_SHEDS,
            "requests shed at admission on an expired deadline")
        self._m_handoffs = METRICS.counter(
            MetricName.SCHED_HANDOFFS,
            "prefill-tier requests handed off to the decode tier")
        self._m_dispatch = METRICS.histogram(
            MetricName.SCHED_DISPATCH,
            "device dispatch wall per kind", labels=("kind",))
        self._m_ttft = METRICS.histogram(
            MetricName.SCHED_TTFT,
            "engine-side TTFT (enqueue to first sampled token)")
        self._m_resumes = METRICS.counter(
            MetricName.SCHED_RESUMES,
            "resume submissions admitted (mid-stream recovery)")
        self._m_resumed_tokens = METRICS.counter(
            MetricName.SCHED_RESUMED_TOKENS,
            "completion tokens resumes skipped regenerating")
        self._m_resume_reused = METRICS.counter(
            MetricName.SCHED_RESUME_REUSED,
            "radix-cache tokens resume admissions reused")
        # The overlap split: time the dispatch thread actually spends per
        # non-idle iteration vs time the emit worker spends delivering the
        # offloaded per-block work. At depth >= 2 the first should approach
        # the bare dispatch cost; the second absorbs everything else.
        self._m_dispatch_thread = METRICS.histogram(
            MetricName.SCHED_DISPATCH_THREAD,
            "dispatch-thread wall per non-idle loop iteration")
        self._m_offloaded = METRICS.histogram(
            MetricName.SCHED_OFFLOADED,
            "emit-worker wall per delivered job batch")
        self._m_pipeline_depth = METRICS.gauge(
            MetricName.SCHED_PIPELINE_DEPTH,
            "decode blocks in flight between loop iterations")

        # Request-scoped tracing (dispatch granularity — never per token):
        # every device dispatch (prefill/chunk/decode block/verify) and
        # every request's queue → prefill → generate phases land as spans
        # in this bounded ring, with queue-depth/occupancy counter tracks
        # stamped at block boundaries. Read via trace_export() through the
        # host-pipe `trace` op — a ring snapshot off the hot loop, never a
        # blocking call inside it. ~10 records per block: noise next to
        # the device sync it sits beside. The loop's phases (decode
        # dispatch, sync, admission, chunks, flush) are spans too, and
        # profiler ranges `sched.<phase>` while a torch.profiler records
        # on the engine thread, around the model's own ranges.
        self.tracer = Tracer(capacity=8192, prefix="sched")
        # Engine-side latency distributions: TTFT as the scheduler saw it
        # (enqueue → first sampled token), admission dispatch wall, and the
        # interval between consecutive decode-block syncs while streams are
        # active (the engine-side bound on any client's inter-chunk gap —
        # if the client measures seconds and this says milliseconds, the
        # stall is in the relay/wire, not the engine).
        self._ttft_hist = Histogram()
        self._admit_hist = Histogram()
        self._adopt_hist = Histogram()
        # Block-sync intervals are PER KIND, and an interval is observed
        # only when the previous sync was the SAME kind: a decode_block ->
        # decode_block interval estimates block cadence, a verify ->
        # decode_block interval spans a one-forward dispatch and would
        # poison the percentiles (the old single histogram forced the
        # decode-floor metrics to be omitted whenever drafting was on).
        self._interval_hists = {"decode_block": Histogram(),
                                "verify": Histogram()}
        self._dispatch_thread_hist = Histogram()
        # Per-slot tokens emitted by each verify dispatch (1 = nothing
        # accepted, 1 + k_draft = the whole proposal) — the distribution
        # that says whether speculation is paying for its dispatches.
        self._spec_emit_hist = Histogram()
        self._last_sync_done: float | None = None
        self._last_sync_kind: str | None = None
        # symledger (engine/ledger.py, tpu.ledger): per-request device-
        # time attribution. Source flag: symprof sampling armed makes
        # the dispatch walls probe-synced ("probed"); otherwise they are
        # dispatch-thread block time ("blocked"). Disabled cost is one
        # guarded branch per dispatch — track() returns None, and every
        # booking site checks `req.ledger is not None` / ledger.enabled.
        dp0 = getattr(engine, "devprof", None)
        self.ledger = RequestLedger(
            enabled=ledger_enabled,
            measured=dp0 is not None and dp0.enabled)

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self._depth > 1:
            # Offload engages only while the worker is actually running:
            # white-box tests (and the engine-death path after join) drive
            # scheduler internals without start() and must keep the
            # inline emit path.
            self._emit_thread = threading.Thread(
                target=self._emit_worker_run, name="emit-worker",
                daemon=True)
            self._emit_offload = True
            self._emit_thread.start()
        self._thread = threading.Thread(target=self._run, name="engine-loop",
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 30.0) -> None:
        """Graceful drain: no new inserts, finish active slots, then join.

        (The reference never drained in-flight requests on shutdown —
        SURVEY §3.4 calls that out; we do.)
        """
        self._stopping.set()
        self._inbox.put(None)  # wake the loop
        if self._thread is not None:
            self._thread.join(timeout)

    def submit(self, req: GenRequest) -> None:
        if self._stopping.is_set():
            raise RuntimeError("scheduler is stopping")
        self.metrics["requests"] += 1
        self._m_requests.inc()
        if req.resume_offset > 0:
            # Booked at submit (same thread-ownership as "requests"):
            # the tokens this resume did NOT regenerate are the saved
            # work the kill-under-load round headlines.
            self.metrics["resumes"] += 1
            self.metrics["resumed_tokens"] += req.resume_offset
            self._m_resumes.inc()
            self._m_resumed_tokens.inc(req.resume_offset)
        # Cost account opens at submission (None while tpu.ledger is
        # off). Stored on the request: ownership rides the request
        # through every exit path, and the terminal-event seams
        # (_finish / _emit_cb) close it wherever the request dies.
        req.ledger = self.ledger.track(req.id)
        self._inbox.put(req)

    @property
    def occupancy(self) -> int:
        return len(self._slots)

    def stats(self) -> dict[str, Any]:
        """Counters + engine-side latency percentiles (host stats op)."""
        out: dict[str, Any] = dict(self.metrics)
        out["role"] = self._role
        out["occupancy"] = len(self._slots)
        if self._adopt_hist.count:
            out["adopt_dispatch_s"] = self._adopt_hist.to_dict()
        # Gauges for the two admission backlogs that were invisible in
        # host→provider stats: the budget-deferred deque and the
        # chunked-prefill jobs still building their prefixes.
        out["deferred_depth"] = len(self._deferred)
        out["prefill_jobs_active"] = len(self._prefill_jobs)
        # Total admission backlog (inbox + deferred) — the same number
        # the sym_sched_queue_depth gauge tracks, surfaced in the stats
        # reply so the pool router's heartbeat can feed placement with
        # REAL backlog instead of only its own in-flight counts.
        out["queue_depth"] = self._inbox.qsize() + len(self._deferred)
        out["engine_ttft_s"] = self._ttft_hist.to_dict()
        out["admit_dispatch_s"] = self._admit_hist.to_dict()
        out["block_interval_s"] = self._interval_hists["decode_block"].to_dict()
        if self._interval_hists["verify"].count:
            out["verify_interval_s"] = self._interval_hists["verify"].to_dict()
        # The overlap split (the tentpole's CPU-verifiable target): wall
        # the dispatch thread spends per non-idle iteration vs wall the
        # emit worker spends on the offloaded per-block work, plus the
        # configured and LIVE pipeline depth and the emit-queue backlog.
        out["pipeline_depth"] = self._depth
        out["pipeline_live_depth"] = self._live_depth
        # 6 decimals, not 4: a tiny-model CPU run's whole offloaded wall
        # is tens of microseconds, and the smoke asserts it is nonzero.
        out["offloaded_s"] = round(self._wmetrics["offloaded_s"], 6)
        out["emit_flushes"] = (self.metrics["emit_flushes"]
                               + self._wmetrics["emit_flushes"])
        out["emit_events"] = (self.metrics["emit_events"]
                              + self._wmetrics["emit_events"])
        out["emit_queue_depth"] = self._emit_queue.qsize()
        if self._dispatch_thread_hist.count:
            out["dispatch_thread_block_s"] = (
                self._dispatch_thread_hist.to_dict())
        # Decode-floor metrics (the convert-wall number, in EVERY driver
        # bench capture instead of only the engine-only bench): per-step
        # decode wall from the block-interval p50 (intervals spanning
        # admissions land in the upper percentiles, so p50 is the
        # steady-state estimate), and the weight bytes that step must
        # stream — their ratio is the effective weight-stream HBM GB/s.
        # Intervals are per-kind and same-kind-only, so speculative
        # verify dispatches no longer poison the decode_block histogram —
        # the metrics hold with drafting on (pre-pipeline they had to be
        # omitted in speculative mode).
        iv_p50 = self._interval_hists["decode_block"].percentile(50)
        wsb = getattr(self.engine, "weight_stream_bytes", None)
        if iv_p50:
            step_s = iv_p50 / self.engine.decode_block
            out["decode_step_ms"] = round(1e3 * step_s, 3)
            if wsb is not None:
                nbytes = int(wsb())
                out["weight_bytes_per_step"] = nbytes
                out["weight_stream_gbs"] = round(nbytes / step_s / 1e9, 1)
                # Per-device shard stream (sharded packed layout): the
                # per-chip HBM roofline number the TP A/B gate reads.
                wsbd = getattr(self.engine,
                               "weight_stream_bytes_per_device", None)
                if wsbd is not None:
                    out["weight_stream_gbs_per_device"] = round(
                        int(wsbd()) / step_s / 1e9, 1)
        # symprof device-time attribution (utils/devprof.py,
        # tpu.profile_sample): per-dispatch-kind DEVICE-duration
        # percentiles + the dispatch-gap distribution/share, riding the
        # same host stats op → provider engine block → bench JSON.
        # Annotated with the pipeline depth: a probe's sync serializes
        # behind every in-flight block, so at depth >= 2 the next gap
        # sample measures the post-drain refill — gap_share is then an
        # UPPER bound on true device idle, and consumers must read it
        # against this depth (the documented accounting rule).
        dp = getattr(self.engine, "devprof", None)
        if dp is not None and dp.enabled:
            out["devprof"] = dict(dp.stats())
            out["devprof"]["pipeline_depth"] = self._depth
        # Shared-prefix KV cache counters (hit/miss/evict/bytes) ride the
        # same host stats op so they surface provider- and bench-side.
        pc_stats = getattr(self.engine, "prefix_cache_stats", None)
        if pc_stats is not None:
            pc = pc_stats()
            if pc is not None:
                out["prefix_cache"] = pc
        # Speculative-decoding block (host stats → provider stats → bench):
        # drafted/accepted/rolled-back counters, the acceptance rate, and
        # the per-slot tokens-per-verify-dispatch distribution.
        if self._drafter is not None:
            drafted = self.metrics["spec_drafted"]
            out["speculative"] = {
                "k_draft": self._drafter.config.k_draft,
                "verify_blocks": self.metrics["spec_verify_blocks"],
                "drafted": drafted,
                "accepted": self.metrics["spec_accepted"],
                "rolled_back": self.metrics["spec_rolled_back"],
                "acceptance_rate": (
                    round(self.metrics["spec_accepted"] / drafted, 4)
                    if drafted else None),
                "spec_tokens": self.metrics["spec_tokens"],
                "verify_s": round(self.metrics["spec_verify_s"], 3),
                "tokens_per_dispatch": self._spec_emit_hist.to_dict(),
            }
        # symledger rider (engine/ledger.py): bounded finished-request
        # ring + cumulative attribution aggregates, riding the same
        # host STATS op → provider engine block → bench JSON as every
        # other block above. Absent entirely while tpu.ledger is off.
        if self.ledger.enabled:
            out["ledger"] = self.ledger.stats()
        return out

    def trace_export(self) -> dict[str, Any]:
        """Span/counter rings as one export_perfetto component (the
        host-pipe `trace` op's scheduler entry)."""
        return self.tracer.component("scheduler")

    # ------------------------------------------------------------- the loop

    def _run(self) -> None:
        """Thread target: contain crashes so no stream ever hangs open."""
        try:
            self._loop_forever()
        except BaseException as exc:  # noqa: BLE001 — fatal engine failure
            log.error(f"engine loop died: {exc!r}; failing open streams")
            for slot, active in list(self._slots.items()):
                ev = TokenEvent(
                    text="", token_id=None, done=True, finish_reason="error",
                    error=f"engine failure: {exc}")
                if active.req.ledger is not None:
                    # Engine death is an exit path too: the entry closes
                    # and the error event still carries its costs.
                    ev.costs = active.req.ledger.finish("error")
                self._emit(active, ev)
                del self._slots[slot]
            while self._deferred:
                self._emit_cb(self._deferred.popleft(), TokenEvent(
                    text="", token_id=None, done=True,
                    finish_reason="error", error=f"engine failure: {exc}"))
            for _job, req in self._prefill_jobs:
                self._emit_cb(req, TokenEvent(
                    text="", token_id=None, done=True,
                    finish_reason="error", error=f"engine failure: {exc}"))
            self._prefill_jobs.clear()
            while True:
                try:
                    item = self._inbox.get_nowait()
                except queue.Empty:
                    break
                if item is not None:
                    self._emit_cb(item, TokenEvent(
                        text="", token_id=None, done=True,
                        finish_reason="error", error=f"engine failure: {exc}"))
            self._flush_events()
            raise
        finally:
            # Runs AFTER the except block above, so the error events it
            # queued are delivered before the worker sees the sentinel.
            self._stop_emit_worker()

    def _stop_emit_worker(self) -> None:
        """Drain residual jobs, send the shutdown sentinel, and join the
        emit worker. Engine-thread only (the loop's exit path)."""
        if self._emit_thread is None:
            return
        if self._block_jobs:
            jobs, self._block_jobs = self._block_jobs, []
            self._emit_queue.put(jobs)
        self._emit_queue.put(None)
        self._emit_thread.join(timeout=10.0)

    # ------------------------------------------------------ emit offload

    def _emit_worker_run(self) -> None:
        """Worker thread target: deliver job batches until the sentinel.

        Every batch is exception-contained — a worker death with the
        queue full would deadlock the dispatch thread's blocking put, so
        nothing may escape this loop short of the sentinel."""
        while True:
            jobs = self._emit_queue.get()
            if jobs is None:
                return
            try:
                self._deliver_jobs(jobs)
            except Exception as exc:  # noqa: BLE001 — worker must not die
                log.error(f"emit worker batch failed: {exc}")

    def _deliver_jobs(self, jobs: list[tuple]) -> None:
        """Run one block's jobs (detokenize + event build) and deliver
        the resulting events exactly like the inline _flush_events path:
        one emit_batch call with a sink installed, else per-event
        req.emit. Worker thread; books into _wmetrics only."""
        t0 = time.monotonic()
        batch: list[tuple[GenRequest, TokenEvent]] = []
        for job in jobs:
            try:
                pair = self._run_job(job)
            except Exception as exc:  # noqa: BLE001 — fail one, not the batch
                log.error(f"emit job failed: {exc}")
                continue
            if pair is not None:
                batch.append(pair)
        if not batch:
            return
        self._wmetrics["emit_flushes"] += 1
        self._wmetrics["emit_events"] += len(batch)
        if self._emit_batch is not None:
            try:
                self._emit_batch(batch)
            except Exception as exc:  # noqa: BLE001 — must never kill the worker
                log.error(f"emit batch sink failed: {exc}")
            self.tracer.record("emit_flush", t0, time.monotonic() - t0,
                               events=len(batch))
        else:
            for req, ev in batch:
                try:
                    req.emit(ev)
                except Exception as exc:  # noqa: BLE001
                    log.error(
                        f"emit callback failed for request {req.id}: {exc}")
        dt = time.monotonic() - t0
        self._wmetrics["offloaded_s"] += dt
        self._m_offloaded.observe(dt)
        if self.ledger.enabled and dt > 0.0:
            # Best-effort emit attribution: this flush's wall splits
            # evenly over its events. A request whose finish rode this
            # very batch already closed its entry (book_emit no-ops) —
            # emit_s covers the pre-terminal flushes.
            per = dt / len(batch)
            for req, _ev in batch:
                if req.ledger is not None:
                    req.ledger.book_emit(per)

    def _submit_job(self, job: tuple) -> None:
        """Route one emit/bookkeep job: buffered for the worker while
        offload is on, else run inline right here (the pre-pipeline
        behavior, byte-identical — depth 1 and un-started schedulers)."""
        if self._emit_offload:
            self._block_jobs.append(job)
            return
        pair = self._run_job(job)
        if pair is not None:
            self._pending_events.append(pair)

    def _run_job(self, job: tuple
                 ) -> tuple[GenRequest, TokenEvent] | None:
        """Materialize one job into a deliverable (req, event) pair.

        Jobs carry tokens_generated/emitted BY VALUE: the engine thread
        keeps mutating the _ActiveSlot on later blocks while the worker
        processes earlier ones. The slot's StreamDecoder and stages_sent
        are owned by whichever side runs the jobs (exactly one — offload
        never mixes), in per-request FIFO order."""
        kind = job[0]
        if kind == "run":
            _k, active, run, last_tok, gen, emitted = job
            text = active.decoder.push_many(
                run.tolist() if hasattr(run, "tolist") else list(run))
            if not text:
                return None
            return self._decorate(active, TokenEvent(
                text=text, token_id=last_tok,
                tokens_generated=gen, tokens_emitted=emitted))
        if kind == "finish":
            _k, active, run, tok, reason, ttft, gen, emitted, costs = job
            toks = run.tolist() if hasattr(run, "tolist") else list(run)
            text = active.decoder.push_many(toks) if toks else ""
            tail = text + active.decoder.flush()
            return self._decorate(active, TokenEvent(
                text=tail, token_id=tok, done=True, finish_reason=reason,
                ttft_s=ttft, tokens_generated=gen, tokens_emitted=emitted,
                costs=costs))
        if kind == "first":
            _k, active, first, ttft = job
            text = active.decoder.push(first)
            if not text:
                return None
            return self._decorate(active, TokenEvent(
                text=text, token_id=first, tokens_generated=1,
                tokens_emitted=1, ttft_s=ttft))
        if kind == "emit":
            _k, active, ev = job
            return self._decorate(active, ev)
        # kind == "raw": pre-built event with no slot to decorate
        # (admission errors, queued cancels, deadline sheds).
        return job[1], job[2]

    def _loop_forever(self) -> None:
        # Pipelined decode (SURVEY §7 hard-part 3, ROADMAP item 2): up to
        # `pipeline_depth` blocks stay in flight on the device between
        # iterations while the host processes the oldest one. Each pending
        # entry is (kind, device tokens, slot snapshot at dispatch,
        # dispatch stamp, extra) — the snapshot attributes each lane's
        # tokens to the request that occupied it AT DISPATCH, so a lane
        # freed-and-reused between dispatch and sync never leaks the old
        # request's block into the new one (the stale-snapshot check in
        # _process_block), and a slot freed at block N is never
        # double-sampled by the already-in-flight block N+1: its lane
        # tokens there are simply discarded. Depth 1 degenerates to the
        # pre-pipeline double buffer: one dispatch ahead, processed the
        # next iteration.
        pending: deque[tuple] = deque()
        while True:
            t_iter = time.perf_counter()
            self._spent_this_block = 0.0
            # Dispatch the next block BEFORE this iteration's admission
            # work: decode blocks sit at the FRONT of the device queue and
            # admission prefills enqueue behind them, so a burst of
            # arrivals never delays the block active streams are waiting
            # on — the prefill lane is fully asynchronous to decode, and
            # prefix-cache seed gathers/scatters (cached-path admission,
            # decode-tier adoption) overlap every in-flight block.
            # (Measured motivation: steady wire throughput stuck at ~70%
            # of engine-only because prefill dispatches issued ahead of
            # the block stretched every block interval under continuous
            # admission — BASELINE.md rounds 3-4.) A slot admitted this
            # iteration joins the NEXT dispatch — its first token was
            # already sampled by its prefill dispatch, so TTFT is
            # untouched; only its second token waits the extra block(s).
            #
            # Speculative mode drains the pipeline before proposing: the
            # drafter extends continuations of the freshest emitted
            # context. The verify dispatch itself then joins the pipeline
            # like any block (the satellite fix for the old same-iteration
            # early sync); at depth 1 it is still synced in-iteration —
            # the pre-pipeline serial behavior, for the A/B.
            did_dispatch = False
            did_verify = False
            # Depth >= 2 syncs the OLDEST in-flight block FIRST — the
            # loop body the tentpole asks for: sync oldest -> sample
            # next -> dispatch. The pipeline still holds depth-1 newer
            # blocks through the sync, so the device never idles, and
            # every host decision below (drafter peek, verify drain,
            # admission) sees a context only ONE block stale instead of
            # `depth` — without this, the speculative peek at depth 2
            # lags the device by two blocks and misfires both ways
            # (drains that propose nothing, repetition spotted too late
            # to verify). Depth 1 cannot sync first without a device
            # bubble (nothing else would be in flight during the sync):
            # it keeps the pre-pipeline dispatch-then-process double
            # buffer at the bottom of the loop.
            if self._depth > 1 and len(pending) >= self._depth:
                self._process_pending(pending.popleft())
            if self._slots and self._drafter is not None:
                if pending and self._spec_peek():
                    while pending:
                        self._process_pending(pending.popleft())
                if self._slots and not pending:
                    vb = self._maybe_verify_block()
                    if vb is not None:
                        pending.append(vb)
                        did_dispatch = did_verify = True
            if self._slots and not did_dispatch and len(pending) <= self._depth:
                with self.tracer.span("decode_dispatch"):
                    toks = self.engine.decode_steps_dispatch()
                pending.append(("decode_block", toks, dict(self._slots),
                                time.monotonic(), None))
                self.metrics["steps"] += self.engine.decode_block
                did_dispatch = True
            with self.tracer.span("admit"):
                drained = self._admit_new()
            if not self._slots and not pending and not self._prefill_jobs:
                # Terminal/error events from the admission pass must reach
                # their consumers BEFORE blocking on an empty inbox.
                self._flush_events()
                # Idle boundary: the next block interval would span the
                # idle wait, which is not a serving stall.
                self._last_sync_done = None
                self._last_sync_kind = None
                self._live_depth = 0
                self._m_pipeline_depth.set(0)
                self.metrics["dispatch_thread_s"] += (
                    time.perf_counter() - t_iter)
                if self._stopping.is_set() and drained:
                    return
                # Idle: block until work arrives (no busy spin). Engines
                # with an idle_tick (multi-host rank 0) get a periodic
                # heartbeat so worker ranks' pending collective doesn't hit
                # the distributed runtime's timeout.
                tick = getattr(self.engine, "idle_tick", None)
                try:
                    item = self._inbox.get(
                        timeout=10.0 if tick is not None else None)
                except queue.Empty:
                    tick()
                    continue
                if item is None:
                    if self._stopping.is_set():
                        return
                    continue
                # Hand the popped item straight to admission (re-putting it
                # would reorder it BEHIND arrivals that raced in while we
                # were blocked — inverted FIFO for the earliest request).
                t_iter = time.perf_counter()
                with self.tracer.span("admit"):
                    self._admit_new(carry=item)
                self._flush_events()
                self.metrics["dispatch_thread_s"] += (
                    time.perf_counter() - t_iter)
                continue

            # (The next block was dispatched above, before admission;
            # syncing the oldest in-flight block below then overlaps the
            # newer blocks' device execution, while the admission
            # dispatches that just enqueued run after them, never ahead.)
            #
            # Chunked prefills ride between decode dispatches: a bounded
            # number of chunk dispatches per block keeps long-prompt
            # admission from stalling active streams for more than ~a
            # chunk's device time.
            if self._prefill_jobs:
                with self.tracer.span("chunks"):
                    self._advance_prefills()
            # Admission-time events (first tokens from placement, chunked-
            # prefill finishes, admission errors) leave NOW, before the
            # device sync below can hold them for up to a whole block —
            # first-token latency must not pay for block coalescing. One
            # extra pipe write per block at most: still O(1).
            self._flush_events()
            # Depth 1's process point (the pre-pipeline double buffer:
            # dispatch block N+1 above, sync block N here), and both
            # depths' drain path when nothing was dispatched (slots
            # emptied or stopping). A depth-1 verify syncs in the same
            # iteration — the pre-pipeline serial-verify behavior.
            # Depth >= 2 already synced its oldest block at the TOP of
            # the iteration, so len(pending) never exceeds depth here.
            if pending and (len(pending) > self._depth or not did_dispatch
                            or (did_verify and self._depth == 1)):
                self._process_pending(pending.popleft())
            # Block boundary: everything this iteration produced (block
            # deltas, finishes) leaves as one batch — the O(1)-writes-
            # per-block contract (one bounded-queue handoff per flush
            # point while offload is on).
            self._flush_events()
            self._live_depth = len(pending)
            self._m_pipeline_depth.set(len(pending))
            dt_iter = time.perf_counter() - t_iter
            self.metrics["dispatch_thread_s"] += dt_iter
            if did_dispatch:
                self._m_dispatch_thread.observe(dt_iter)
                self._dispatch_thread_hist.observe(dt_iter)
            if self._debug:
                self._check_invariants()

    def _process_pending(self, blk: tuple) -> None:
        """Sync + process one in-flight pipeline entry (FIFO order).

        Verify entries book their speculative accounting HERE, at sync
        time — the dispatch ran up to `pipeline_depth` iterations ago,
        overlapped with admission and emit work (spec_verify_s is
        therefore dispatch -> sync wall, not pure device time)."""
        kind, toks_dev, snapshot, t0m, extra = blk
        if kind == "verify":
            n_emit_dev, n_draft, proposed = extra
            n_emit = np.asarray(n_emit_dev)
            dt = time.monotonic() - t0m
            accepted = int(np.sum(np.minimum(n_emit - 1, n_draft)))
            self.tracer.record("verify_dispatch", t0m, dt,
                               drafted=proposed, accepted=accepted)
            self.metrics["spec_verify_blocks"] += 1
            self.metrics["spec_verify_s"] += dt
            self.metrics["spec_drafted"] += proposed
            self.metrics["spec_accepted"] += accepted
            self.metrics["spec_rolled_back"] += proposed - accepted
            for slot in snapshot:
                if n_draft[slot]:
                    self._spec_emit_hist.observe(int(n_emit[slot]))
                    self.metrics["spec_tokens"] += int(n_emit[slot])
            spec_reject = None
            if self.ledger.enabled:
                # Per-slot rejected-draft fraction: of the 1 + k_draft
                # positions this slot's verify lane computed, the ones
                # past the acceptance point were device work rolled
                # back — that share of the slot's block attribution is
                # booked wasted_s{spec_rejected} in _process_block.
                spec_reject = {}
                for slot in snapshot:
                    nd = int(n_draft[slot])
                    if nd:
                        rej = nd - (int(n_emit[slot]) - 1)
                        if rej > 0:
                            spec_reject[slot] = (rej / (1.0 + nd), rej)
            self._process_block(toks_dev, snapshot, n_valid=n_emit,
                                dispatched_at=t0m, kind="verify",
                                spec_reject=spec_reject)
        else:
            self._process_block(toks_dev, snapshot, dispatched_at=t0m)

    def _process_block(self, device_toks: Any,
                       snapshot: dict[int, _ActiveSlot],
                       n_valid: np.ndarray | None = None,
                       dispatched_at: float | None = None,
                       kind: str = "decode_block",
                       spec_reject: dict[int, tuple[float, int]]
                       | None = None) -> None:
        """Sync one decode block to host and stream its tokens out.

        Batched pass (the block-granular emit path): ONE vectorized EOS
        scan over the whole [K, B] block, then per live slot one
        finish-point computation, one push_many over its token run, and
        one buffered TokenEvent — per-token Python work is gone, and the
        block boundary flush coalesces every slot's event into a single
        host-pipe frame.

        `n_valid` [B] makes the block RAGGED: slot b produced only
        n_valid[b] tokens this dispatch (>= 1). Plain decode blocks pass
        None (every slot advanced all K steps); speculative verify
        dispatches pass their per-slot accepted counts, so variable
        accepted-tokens-per-slot rides the same EOS/budget scan, the same
        push_many detokenize, and the same block-granular event frames.

        Token accounting: metrics["tokens"] (and TokenEvent.
        tokens_emitted) count only tokens PUSHED to the detokenizer —
        the EOS token and anything the block produced past a finish are
        discarded from the counters too, so the engine-side number sums
        to exactly the bench's tokens_streamed. tokens_generated keeps
        counting the EOS (the budget convention)."""
        t0 = time.perf_counter()
        with self.tracer.span("sync"):
            toks = np.asarray(device_toks)  # blocks on THIS block only
        t1 = time.perf_counter()
        self.metrics["block_syncs"] += 1
        self.metrics["sync_s"] += t1 - t0
        # Same-kind-only intervals: a decode_block -> decode_block gap is
        # block cadence; an interval whose predecessor was a verify spans
        # a one-forward dispatch and lands in the verify histogram's
        # cadence instead — neither poisons the other's percentiles.
        if self._last_sync_done is not None and self._last_sync_kind == kind:
            self._interval_hists[kind].observe(t1 - self._last_sync_done)
        self._last_sync_done = t1
        self._last_sync_kind = kind
        if dispatched_at is not None:
            self._m_dispatch.observe(time.monotonic() - dispatched_at,
                                     kind=kind)
        # Block-boundary gauges: same cadence as the tracer's counter
        # tracks — a handful of registry ops per block, never per token.
        self._m_occupancy.set(len(self._slots))
        self._m_queue_depth.set(self._inbox.qsize() + len(self._deferred))
        t1m = time.monotonic()
        if self.tracer.enabled:
            # Block span covers dispatch → device done (the device-side
            # wall the double buffer hides host work behind); the gauge
            # tracks are stamped once per block — boundary-granular, so
            # the hot loop never pays more than a few ring appends.
            self.tracer.counter("occupancy", len(self._slots), t=t1m)
            self.tracer.counter(
                "queue_depth",
                self._inbox.qsize() + len(self._deferred), t=t1m)
        K = toks.shape[0]
        eos_mask = (np.isin(toks, self._eos_arr) if self._eos_arr.size
                    else np.zeros(toks.shape, dtype=bool))
        # symledger block attribution: the sync wall splits EQUALLY over
        # the snapshot lanes still live at sync (occupancy split — every
        # live lane's tokens rode the same device pass). One guarded
        # branch per dispatch when the ledger is off. A block whose
        # every lane went stale still burned the wall: booked
        # unattributed so conservation closes.
        led_share = 0.0
        led_phase = "verify" if kind == "verify" else "decode"
        n_live = sum(1 for s, a in snapshot.items()
                     if self._slots.get(s) is a)
        if self.ledger.enabled:
            wall = t1 - t0
            if n_live:
                led_share = wall / n_live
            else:
                self.ledger.book_unattributed(wall)
        block_tokens = 0
        for slot, active in snapshot.items():
            if self._slots.get(slot) is not active:
                continue  # finished in an earlier block; lane is stale
            if active.req.cancelled():
                # Discard the whole block remainder past the cancel.
                if active.req.ledger is not None:
                    # The cancelled lane's share of this block computed
                    # tokens the client will never see.
                    v_disc = K if n_valid is None else int(n_valid[slot])
                    active.req.ledger.book_device(led_phase, led_share)
                    active.req.ledger.book_wasted(
                        "cancelled", led_share, v_disc)
                self._finish(slot, active, "cancelled", None, ())
                continue
            # The request consumes tokens until the first EOS, its token
            # budget, or the block end — whichever comes first. An EOS at
            # the budget-exhausting position still finishes as "stop"
            # (EOS is checked before the length bound, matching the
            # per-token order this pass replaced). The EOS token counts
            # toward tokens_generated but is never detokenized or counted
            # as emitted.
            v = K if n_valid is None else int(n_valid[slot])
            budget = active.req.max_new_tokens - active.generated
            r = max(1, min(v, budget))
            hits = np.flatnonzero(eos_mask[:r, slot])
            if hits.size:
                e = int(hits[0])
                n_push, consumed, finish = e, e + 1, "stop"
            elif budget <= v:
                n_push = consumed = r
                finish = "length"
            else:
                n_push = consumed = v
                finish = None
            last_tok = int(toks[consumed - 1, slot])
            active.generated += consumed
            active.emitted += n_push
            block_tokens += n_push
            if active.req.ledger is not None:
                led = active.req.ledger
                led.book_device(led_phase, led_share, tokens=n_push)
                if spec_reject is not None and slot in spec_reject:
                    frac, rej = spec_reject[slot]
                    led.book_wasted("spec_rejected",
                                    led_share * frac, rej)
            # TWO dispatches' writes must stay within capacity after a
            # continue decision — the next block's (whose tokens we may
            # consume) plus one of margin (cache holds prompt_len +
            # generated - 1 entries after this block; a write is K
            # positions for a plain block, 1 + k_draft for a speculative
            # verify). The coefficient is depth-INDEPENDENT: any block we
            # continue INTO writes at <= c + writes <= c + 2*writes-worth
            # of positions by induction, while deeper pipelines only add
            # in-flight blocks whose tokens are discarded after a finish
            # (their past-capacity scatters are dropped against a lane
            # that is already released). Keeping the formula fixed keeps
            # finish="length" decisions — and therefore token identity —
            # bit-identical across pipeline depths.
            if finish is None and (
                    active.prompt_len + active.generated
                    + 2 * self._max_block_writes
                    > self.engine.slot_capacity + 1):
                finish = "length"
            if finish is None:
                if self._drafter is not None:
                    # Consumed tokens extend the slot's n-gram index (its
                    # context must track the device's conditioning).
                    # Engine-thread work: the next propose() reads it.
                    self._drafter.extend(slot, toks[:consumed, slot].tolist())
                if n_push:
                    # Counts snapshotted by value: the engine thread keeps
                    # advancing `active` on later blocks while the worker
                    # detokenizes this one.
                    self._submit_job(("run", active, toks[:n_push, slot],
                                      last_tok, active.generated,
                                      active.emitted))
            else:
                self._finish(slot, active, finish, last_tok,
                             toks[:n_push, slot])
        self.metrics["tokens"] += block_tokens
        if block_tokens:
            self._m_tokens.inc(block_tokens)
        if dispatched_at is not None and kind == "decode_block":
            # Recorded once the scan has counted what the block streamed:
            # `tokens` over `steps` × the engine's slots is the share of
            # lane-steps that produced a token; `lanes` are the snapshot's
            # lanes still live at sync. (Verify entries record their own
            # verify_dispatch span in _process_pending.)
            self.tracer.record("decode_block", dispatched_at,
                               t1m - dispatched_at, slots=len(snapshot),
                               steps=K, tokens=block_tokens, lanes=n_live)

    def _spec_peek(self) -> bool:
        """Would any active slot propose a draft from its CURRENT
        context? Used while a plain block is still in flight — the
        context is stale by that block, so this is a predictor, not the
        proposal itself: a few dict probes per slot, no device work. A
        miss here just means one more overlapped plain block."""
        return any(
            active.req.speculative is not False
            and self._drafter.propose(slot)
            for slot, active in self._slots.items())

    def _maybe_verify_block(self) -> tuple | None:
        """Collect every active slot's n-gram proposal; when at least one
        slot has a draft, issue ONE verify dispatch (fixed [B, 1+k]
        shape) and return it as a pipeline entry — it is synced and its
        ragged output processed through the block pipeline like any
        in-flight block, so the host work between dispatch and sync
        overlaps the verify's device execution (the old path synced
        immediately, eating the overlap). Returns None — letting the
        caller fall back to a plain decode block — when nothing was
        proposed."""
        engine = self.engine
        k = engine.spec.k_draft
        draft = np.zeros((engine.max_slots, k), np.int32)
        n_draft = np.zeros((engine.max_slots,), np.int32)
        proposed = 0
        for slot, active in self._slots.items():
            if active.req.speculative is False:
                continue  # per-request opt-out: plain decode lanes only
            prop = self._drafter.propose(slot)
            if prop:
                draft[slot, :len(prop)] = prop
                n_draft[slot] = len(prop)
                proposed += len(prop)
        if not proposed:
            return None
        snapshot = dict(self._slots)
        t0m = time.monotonic()
        dispatch = getattr(engine, "verify_step_dispatch", None)
        if dispatch is not None:
            toks, n_emit = dispatch(draft, n_draft)
        else:
            # Engine (or test fake) without the async surface: the
            # synchronous host arrays ride the pipeline unchanged
            # (np.asarray at sync time is idempotent).
            toks, n_emit = engine.verify_step(draft, n_draft)
        self.metrics["steps"] += 1  # one forward advanced every lane
        return ("verify", toks, snapshot, t0m, (n_emit, n_draft, proposed))

    def _admit_new(self, carry: GenRequest | None = None) -> bool:
        """Place queued requests into free slots. Returns True if inbox
        empty. Concurrent arrivals coalesce into ONE prefill dispatch when
        the engine supports it (prefill_and_insert_many) — per-dispatch
        round-trips would otherwise serialize into the tail TTFT. `carry`
        is an already-popped request admitted ahead of the queue.

        While streams are active, at most `admit_groups_per_block` prefill
        DEVICE DISPATCHES are spent per call (a group spanning buckets
        costs one per bucket chunk): an admission burst would otherwise
        freeze every active stream for the whole burst. With nothing
        active there is nobody to stall — drain freely."""
        many = getattr(self.engine, "prefill_and_insert_many", None)
        batches_for = getattr(self.engine, "prefill_batches_for", None)
        if many is None:
            batch_cap = 1
        elif batches_for is not None:
            # Widest batch ANY bucket allows (the smallest bucket's cap);
            # _place_group re-partitions by bucket before dispatching.
            batch_cap = max(batches_for(self.engine.prefill_buckets[0]))
        else:
            batch_cap = max(getattr(self.engine, "PREFILL_BATCHES", (1,)))
        groups_left = (self._admit_groups
                       if (self._slots or self._prefill_jobs) else None)
        # (An occupancy-scaled budget — admit more aggressively while most
        # slots are free — was tried in round 4 and measured INERT at the
        # 128-burst point: the ramp is arrival-limited through the host
        # pipe, not budget-limited; 9 near-full dispatches either way.)
        while self._free:
            if groups_left is not None and (
                    groups_left <= 0
                    or self._spent_this_block >= self._admit_budget_s):
                break
            group: list[tuple[int, GenRequest]] = []
            while self._free and len(group) < batch_cap:
                if carry is not None:
                    item, carry = carry, None
                elif self._deferred:
                    # Budget-deferred subgroups from earlier blocks go
                    # first: they were popped from the inbox BEFORE
                    # everything still in it, so draining them first is
                    # what preserves arrival order.
                    item = self._deferred.popleft()
                else:
                    try:
                        item = self._inbox.get_nowait()
                    except queue.Empty:
                        break
                if item is None:
                    continue
                if FAULTS.enabled:
                    # scheduler.admit seam: error → this request fails
                    # with an error event; drop_frame → it silently
                    # vanishes (lost work — exactly what the supervisor's
                    # watchdog exists to notice); crash/hang act on the
                    # engine thread itself.
                    try:
                        if FAULTS.point("scheduler.admit"):
                            continue
                    except InjectedFault as exc:
                        self._emit_cb(item, TokenEvent(
                            text="", token_id=None, done=True,
                            finish_reason="error", error=str(exc)))
                        continue
                if item.cancelled():
                    # Cancelled while queued still gets its terminal event —
                    # the consumer is awaiting it.
                    self._emit_cb(item, TokenEvent(
                        text="", token_id=None, done=True,
                        finish_reason="cancelled"))
                    continue
                if (item.deadline_at is not None
                        and time.monotonic() > item.deadline_at):
                    # Deadline shed: the client (or its caller) stopped
                    # waiting before we could even place the request —
                    # prefilling it would bill the device for an answer
                    # nobody reads. Covers inbox and deferred entries
                    # alike (both pop through here).
                    self.metrics["deadline_shed"] += 1
                    self._m_deadline_sheds.inc()
                    if item.ledger is not None:
                        # Zero device seconds by construction (the shed
                        # IS the work avoided) — booked so the waste
                        # class is visible, with the queue wait the
                        # request burned getting nothing.
                        item.ledger.book_queue(
                            time.monotonic() - item.enqueued_at)
                        item.ledger.book_wasted("deadline_shed", 0.0)
                    late = time.monotonic() - item.deadline_at
                    self._emit_cb(item, TokenEvent(
                        text="", token_id=None, done=True,
                        finish_reason="expired",
                        error=f"deadline expired {late:.2f}s before "
                              f"admission"))
                    continue
                group.append((self._free.pop(), item))
            if not group:
                return self._inbox.empty()
            done = self._place_group(group)
            if groups_left is not None:
                # Budgeted by DEVICE DISPATCH, not by group: a group that
                # spans buckets (or exceeds a bucket's batch cap) costs
                # several dispatches, and each one stalls active streams.
                groups_left -= max(done, 1)
            else:
                # Unbudgeted cold-burst drain (nothing was decoding): a
                # large burst spans many placement groups, so each
                # group's first tokens leave NOW rather than after the
                # whole drain — the earliest request's delivered TTFT
                # must not pay for the rest of the burst's admission.
                # Still one write per placement group, not per event.
                self._flush_events()
        if carry is not None:
            # No free slot took it (all busy): hold it at the deferred
            # tail rather than dropping it — every deferred entry was
            # popped before anything still in the inbox, so this keeps
            # arrival order too.
            self._deferred.append(carry)
        return not self._deferred and self._inbox.empty()

    def _place_group(self, group: list[tuple[int, GenRequest]]) -> int:
        """Admit `group`; returns the number of prefill DEVICE DISPATCHES
        performed (the unit the per-block admission budget counts)."""
        # Requests the engine would reject (e.g. prompt beyond the largest
        # bucket) must fail individually, not poison the whole batch.
        wants_chunked = getattr(self.engine, "wants_chunked", None)
        lookup = getattr(self.engine, "prefix_lookup", None)
        align = getattr(self.engine, "prefix_align", None)
        seeded_ok = getattr(self.engine, "seeded_chunk_ok", None)
        now = time.monotonic()
        ready: list[tuple[int, GenRequest]] = []
        # Prefix-cache hits partition into their OWN dispatch units keyed
        # by (bucket, (radix node, matched_len)): equal keys share one
        # block-gather seed, and a hit unit admits through the engine's
        # cached path (pool gather + suffix-only prefill) while miss
        # units pay the full coalesced prefill — mixing them would force
        # everyone onto the slower path.
        hit_units: dict[tuple, tuple[Any, list[tuple[int, GenRequest]]]] = {}
        for slot, req in group:
            req.picked_at = now
            if req.ledger is not None:
                # Set-not-add: a budget deferral re-picks, and the
                # latest pick is the true scheduler queue wait.
                req.ledger.book_queue(now - req.enqueued_at)
            hit = None
            try:
                if req.adopt is not None:
                    # Handoff adoption (decode tier): parse the frame,
                    # fill req.prompt_ids, and seed the prefix store
                    # now, on THIS thread, so the lookup below hits it.
                    # Run exactly once — a budget-deferred request
                    # re-picks next block and must not re-adopt.
                    adopt, req.adopt = req.adopt, None
                    adopt(req)
                if not req.prompt_ids:
                    raise ValueError("empty prompt")
                n = len(req.prompt_ids)
                bucket = self.engine.bucket_for(n)
                hit = lookup(req.prompt_ids) if lookup is not None else None
                if hit is not None:
                    if n - hit.length <= align:
                        # Short suffix: batched single-dispatch hit path.
                        req.reused_tokens = hit.length
                        key = (bucket, hit.group_key)
                        if key in hit_units:
                            hit.release()  # one pinned handle per unit
                            hit_units[key][1].append((slot, req))
                        else:
                            hit_units[key] = (hit, [(slot, req)])
                        continue
                    if seeded_ok is not None and seeded_ok(n):
                        # Long suffix: chunked prefill seeded from the
                        # cached prefix (the engine releases the hit).
                        req.reused_tokens = hit.length
                        job = self.engine.start_chunked_prefill(
                            slot, req.prompt_ids, req.sampling, hit=hit)
                        hit = None
                        self._prefill_jobs.append((job, req))
                        continue
                    # No compiled continuation shape fits — full prefill.
                    hit.release()
                    hit = None
                    req.reused_tokens = 0
                if wants_chunked is not None and wants_chunked(n):
                    # Long prompt: build its prefix chunk-by-chunk between
                    # decode blocks instead of one monolithic dispatch.
                    job = self.engine.start_chunked_prefill(
                        slot, req.prompt_ids, req.sampling)
                    self._prefill_jobs.append((job, req))
                    continue
            except Exception as exc:  # noqa: BLE001
                if hit is not None:
                    hit.release()
                self._free.append(slot)
                self._emit_cb(req, TokenEvent(
                    text="", token_id=None, done=True, finish_reason="error",
                    error=str(exc)))
                continue
            ready.append((slot, req))
        if not ready and not hit_units:
            return 0
        # Partition by prefill bucket: the engine dispatches one coalesced
        # prefill per bucket, and mixing a long prompt into a short-prompt
        # group would drag every member into the long prompt's bucket
        # (batch × big-bucket = the exact transient the per-bucket batch
        # budget exists to bound). Each bucket subgroup is further split
        # to the bucket's batch cap HERE (not inside the engine) so every
        # device dispatch is individually counted and timed — the
        # admission budget and the admit metrics both depend on it.
        by_bucket: dict[int, list[tuple[int, GenRequest]]] = {}
        for slot, req in ready:
            by_bucket.setdefault(
                self.engine.bucket_for(len(req.prompt_ids)), []).append(
                    (slot, req))
        batches_for = getattr(self.engine, "prefill_batches_for", None)
        # Each unit: (subgroup, prefix hit or None), ordered by the
        # EARLIEST arrival among its members — under a tight admission
        # budget the unstarted tail of `units` defers to the next block,
        # so any other order (e.g. cheapest-first) would let a sustained
        # stream of late cache-hit arrivals starve an earlier deferred
        # miss, the exact FIFO inversion the deferred deque exists to
        # prevent.
        arrival = {id(req): i for i, (_s, req) in enumerate(group)}
        units: list[tuple[list[tuple[int, GenRequest]], Any]] = []
        for bucket_key, (hit, subgroup) in hit_units.items():
            cap = (max(batches_for(bucket_key[0]))
                   if batches_for is not None else len(subgroup))
            for start in range(0, len(subgroup), cap):
                # Split units share one pinned handle; release() is
                # idempotent and the handle's entry ref keeps the buffer
                # alive for the later splits either way.
                units.append((subgroup[start:start + cap], hit))
        for bucket, subgroup in by_bucket.items():
            cap = (max(batches_for(bucket)) if batches_for is not None
                   else len(subgroup))
            for start in range(0, len(subgroup), cap):
                units.append((subgroup[start:start + cap], None))
        units.sort(key=lambda u: min(arrival[id(req)] for _s, req in u[0]))
        n_dispatches = 0
        for unit_idx, (sub, hit) in enumerate(units):
            if (unit_idx > 0 and self._slots
                    and self._spent_this_block >= self._admit_budget_s):
                # The shared per-block time budget ran out mid-group: a
                # 16-request group spanning the 512 bucket splits into
                # 4-5 dispatches, and running them all back-to-back would
                # overshoot the budget several-fold and stall every
                # active stream. Defer the unstarted subgroups — slots
                # back to the pool, requests to the deferred queue (NOT
                # the inbox tail, which would put them behind later
                # arrivals and invert FIFO order every deferral) — and
                # let the next block pick them up. (unit_idx > 0
                # guarantees forward progress: one dispatch always lands.)
                # A deferred hit re-resolves through prefix_lookup next
                # block, so its pinned handle is released now.
                for d_sub, d_hit in units[unit_idx:]:
                    if d_hit is not None:
                        d_hit.release()
                    for slot, req in d_sub:
                        self._free.append(slot)
                        self._deferred.append(req)
                break
            t0m = time.monotonic()
            t0 = time.perf_counter()
            try:
                if hit is not None:
                    firsts = self.engine.prefill_and_insert_cached(
                        [(slot, req.prompt_ids, req.sampling)
                         for slot, req in sub], hit)
                elif len(sub) > 1:
                    firsts = self.engine.prefill_and_insert_many(
                        [(slot, req.prompt_ids, req.sampling)
                         for slot, req in sub])
                else:
                    slot0, req0 = sub[0]
                    firsts = [self.engine.prefill_and_insert(
                        slot0, req0.prompt_ids, req0.sampling)]
            except Exception as exc:  # noqa: BLE001 — engine errors → stream error
                n_dispatches += 1  # a failed dispatch still cost time
                self._spent_this_block += time.perf_counter() - t0
                for slot, req in sub:
                    self._free.append(slot)
                    log.error(
                        f"prefill failed for request {req.id}: {exc}")
                    self._emit_cb(req, TokenEvent(
                        text="", token_id=None, done=True,
                        finish_reason="error", error=str(exc)))
                continue
            dt = time.perf_counter() - t0
            n_dispatches += 1
            self._spent_this_block += dt
            if hit is not None and self._role == "decode":
                # Decode tier: a cached-unit dispatch is handoff ADOPTION
                # (seed copy + suffix), not admission prefill — book it
                # apart so this host's admit_* wall reads zero and the
                # trace row names the work. (A p==0 routing-only handoff
                # still full-prefills here and rightly counts as admit.)
                self.metrics["adopt_dispatches"] += 1
                self.metrics["adopt_s"] += dt
                self._adopt_hist.observe(dt)
                self.tracer.record("adopt_dispatch", t0m, dt, n=len(sub))
                self._m_dispatch.observe(dt, kind="adopt")
            else:
                self.metrics["admit_dispatches"] += 1
                self.metrics["admit_s"] += dt
                self._admit_hist.observe(dt)
                self.tracer.record("prefill_dispatch", t0m, dt, n=len(sub),
                                   cached=hit is not None)
                self._m_dispatch.observe(dt, kind="prefill")
            if self.ledger.enabled and dt > 0.0:
                # Prefill/adopt attribution is EXACT (the dispatch names
                # its requests): the unit wall splits across members by
                # suffix length, and a radix hit's avoided prefix is
                # priced at this very dispatch's per-token rate.
                phase = ("adopt" if hit is not None
                         and self._role == "decode" else "prefill")
                sfx = [max(1, len(req.prompt_ids) - req.reused_tokens)
                       for _s, req in sub]
                rate = dt / sum(sfx)
                for (slot_i, req), n_sfx in zip(sub, sfx):
                    if req.ledger is not None:
                        req.ledger.book_device(phase, rate * n_sfx)
                        if req.reused_tokens:
                            req.ledger.book_saved(
                                rate * req.reused_tokens,
                                req.reused_tokens)
            for (slot, req), first in zip(sub, firsts):
                self._activate(slot, req, first)
        return n_dispatches

    def _advance_prefills(self) -> None:
        """Run up to `prefill_chunks_per_block` prompt chunks, FIFO (the
        earliest request reaches its first token first). With no active
        streams there is nothing to stall, so drain faster."""
        if not self._prefill_jobs:
            return
        budget = (self._chunks_per_block if self._slots
                  else max(16, self._chunks_per_block))
        progressed = 0
        while budget > 0 and self._prefill_jobs:
            if (self._slots and progressed > 0
                    and self._spent_this_block >= self._admit_budget_s):
                # Shared per-block admission time budget exhausted — but
                # only AFTER at least one chunk ran: _admit_new always
                # lands at least one group per block, so without this
                # floor a sustained arrival stream would starve in-flight
                # chunked prefills (their TTFT growing unboundedly while
                # later short prompts keep being admitted).
                break
            job, req = self._prefill_jobs[0]
            if req.cancelled():
                self._prefill_jobs.pop(0)
                self._free.append(job.slot)
                if req.ledger is not None:
                    # Killed in-flight partial prefill: every chunk
                    # dispatched so far built a prefix nobody will
                    # decode from — the whole accumulated device time
                    # is waste.
                    req.ledger.waste_all_device("killed_prefill")
                self._emit_cb(req, TokenEvent(
                    text="", token_id=None, done=True,
                    finish_reason="cancelled"))
                continue
            t0m = time.monotonic()
            t0 = time.perf_counter()
            try:
                first = self.engine.advance_chunked_prefill(job)
            except Exception as exc:  # noqa: BLE001 — fail one, not all
                self._prefill_jobs.pop(0)
                self._free.append(job.slot)
                log.error(f"chunked prefill failed for {req.id}: {exc}")
                self._emit_cb(req, TokenEvent(
                    text="", token_id=None, done=True, finish_reason="error",
                    error=str(exc)))
                continue
            dt = time.perf_counter() - t0
            self.metrics["chunk_dispatches"] += 1
            self.metrics["chunk_s"] += dt
            self._spent_this_block += dt
            self.tracer.record("chunk_dispatch", t0m, dt,
                               request_id=req.id, trace_id=req.trace_id)
            self._m_dispatch.observe(dt, kind="chunk")
            if req.ledger is not None:
                req.ledger.book_device("chunk", dt)
            progressed += 1
            budget -= 1
            if first is not None:
                self._prefill_jobs.pop(0)
                if req.ledger is not None and req.reused_tokens:
                    # Seeded chunked prefill (radix hit with a long
                    # suffix): the avoided prefix is priced at this
                    # request's own measured chunk rate, known only now
                    # that the chunks have run.
                    req.ledger.book_saved_at_phase_rate(
                        "chunk",
                        len(req.prompt_ids) - req.reused_tokens,
                        req.reused_tokens)
                self._activate(job.slot, req, first)

    def _activate(self, slot: int, req: GenRequest, first: int) -> None:
        if req.resume_offset > 0 and req.reused_tokens > 0:
            # Booked HERE (activation runs exactly once per request, even
            # across budget deferrals that re-resolve the lookup): the
            # radix tokens this resume admission did not re-prefill.
            self.metrics["resume_reused_tokens"] += req.reused_tokens
            self._m_resume_reused.inc(req.reused_tokens)
        if self._role == "prefill":
            # Prefill tier: the request's KV is built and installed in
            # the slot lane — instead of decoding, hand it off and free
            # the lane. (The sampled `first` token is discarded: the
            # decode tier's suffix dispatch re-samples it from identical
            # logits — exact for greedy, seeded lanes re-derive the same
            # keys from their seed.)
            self._handoff_request(slot, req, first)
            return
        active = _ActiveSlot(req=req, decoder=self.engine.tokenizer.stream_decoder(),
                             prompt_len=len(req.prompt_ids))
        active.first_token_at = time.monotonic()
        self._ttft_hist.observe(active.first_token_at - req.enqueued_at)
        self._m_ttft.observe(active.first_token_at - req.enqueued_at)
        if self.tracer.enabled:
            # The request's admission phases as spans: scheduler-queue
            # wait (enqueue → placement pick) and prefill (pick → first
            # sampled token) — the engine-side legs of the per-stage TTFT
            # chain, now on the merged timeline too.
            picked = req.picked_at or active.first_token_at
            self.tracer.record("queue", req.enqueued_at,
                               picked - req.enqueued_at,
                               request_id=req.id, trace_id=req.trace_id)
            self.tracer.record("prefill", picked,
                               active.first_token_at - picked,
                               request_id=req.id, trace_id=req.trace_id,
                               prompt_len=len(req.prompt_ids))
        self._slots[slot] = active
        self.metrics["peak_occupancy"] = max(self.metrics["peak_occupancy"],
                                             len(self._slots))
        active.generated = 1
        if first in self.engine.tokenizer.eos_ids:
            self._finish(slot, active, "stop", first, ())
            return
        active.emitted = 1
        self.metrics["tokens"] += 1
        self._m_tokens.inc()
        # Finish before the first decode block if (a) the request's token
        # budget is already spent by the prefill token, or (b) the prompt is
        # so long the cache can't absorb the TWO dispatches that may land
        # before this slot's tokens are next examined (one in-flight + one
        # lookahead; each writes up to _max_block_writes positions) —
        # otherwise KV writes land past capacity (silently dropped
        # scatters) and the client would stream garbage.
        if (active.generated >= req.max_new_tokens
                or active.prompt_len + active.generated
                + 2 * self._max_block_writes
                > self.engine.slot_capacity + 1):
            self._finish(slot, active, "length", first, (first,))
            return
        if self._drafter is not None and req.speculative is not False:
            self._drafter.begin(slot, req.prompt_ids, first)
        self._submit_job(("first", active, first,
                          active.first_token_at - req.enqueued_at))

    def _handoff_request(self, slot: int, req: GenRequest,
                         first: int) -> None:
        """Prefill-tier terminal: serialize + ship the prompt's KV (the
        installed sink extracts the slot lane and writes the handoff
        frame synchronously — by return, the lane is re-usable), then
        free the slot. A sink failure fails THIS request with an error
        event; it must never kill the admission loop."""
        t0m = time.monotonic()
        try:
            self._handoff(slot, req, first)
        except Exception as exc:  # noqa: BLE001 — fail one, not all
            log.error(f"handoff failed for request {req.id}: {exc}")
            self._emit_cb(req, TokenEvent(
                text="", token_id=None, done=True, finish_reason="error",
                error=f"handoff failed: {exc}"))
        else:
            dt = time.monotonic() - t0m
            self.metrics["handoffs"] += 1
            self.metrics["handoff_s"] += dt
            self._m_handoffs.inc()
            if self.tracer.enabled:
                # Same per-request spans a unified host records (queue,
                # prefill), plus the handoff leg — the request's prefill-
                # tier residency reads off the merged timeline directly.
                picked = req.picked_at or t0m
                self.tracer.record("queue", req.enqueued_at,
                                   picked - req.enqueued_at,
                                   request_id=req.id, trace_id=req.trace_id)
                self.tracer.record("prefill", picked, t0m - picked,
                                   request_id=req.id, trace_id=req.trace_id,
                                   prompt_len=len(req.prompt_ids))
                self.tracer.record("handoff", t0m, dt,
                                   request_id=req.id, trace_id=req.trace_id)
        finally:
            self._free.append(slot)
            self.engine.release_slot(slot)
            if req.ledger is not None:
                # Prefill-tier terminal: the decode tier owns the finish
                # event; this host's attribution folds into aggregates.
                # Idempotent after the error path's finish() above.
                req.ledger.release("handoff")

    def _finish(self, slot: int, active: _ActiveSlot, reason: str,
                tok: int | None, run) -> None:
        """Terminal for an active slot. `run` is the token-id sequence
        (numpy slice or tuple) still to be pushed through the decoder
        ahead of the flush — the push itself is emit work and rides the
        finish job, off-thread while offload is on. Slot accounting
        (free list, engine release, drafter release, eviction counters)
        stays on the engine thread: the lane must be reusable by the
        very next admission pass."""
        ttft = (active.first_token_at - active.req.enqueued_at
                if active.first_token_at else None)
        if self.tracer.enabled and active.first_token_at is not None:
            self.tracer.record("generate", active.first_token_at,
                               time.monotonic() - active.first_token_at,
                               request_id=active.req.id,
                               trace_id=active.req.trace_id,
                               tokens=active.generated, finish=reason)
        costs = None
        if active.req.ledger is not None:
            costs = active.req.ledger.finish(reason,
                                             tokens=active.emitted)
            if self.tracer.enabled:
                # Per-request attribution counter tracks: cumulative
                # attributed/wasted device seconds stamped at every
                # finish — the Perfetto cost staircase, one ring append
                # pair per request lifetime.
                dev_t, waste_t = self.ledger.totals_brief()
                self.tracer.counter("ledger_device_s", round(dev_t, 6))
                self.tracer.counter("ledger_wasted_s", round(waste_t, 6))
        self._submit_job(("finish", active, run, tok, reason, ttft,
                          active.generated, active.emitted, costs))
        del self._slots[slot]
        self._free.append(slot)
        if self._drafter is not None:
            self._drafter.release(slot)
        self.engine.release_slot(slot)
        self.metrics["evictions"] += 1
        self._m_evictions.inc()

    def _emit(self, active: _ActiveSlot, ev: TokenEvent) -> None:
        """Queue a pre-built event for an active slot (stage decoration
        happens where the job runs, preserving per-request order)."""
        self._submit_job(("emit", active, ev))

    def _decorate(self, active: _ActiveSlot, ev: TokenEvent
                  ) -> tuple[GenRequest, TokenEvent]:
        if not active.stages_sent:
            # First event of the request: attach the per-stage admission
            # stamps (host recv → placement pick → first token). The host
            # adds its pipe-out stamp, the provider the relay stamp — the
            # full TTFT chain then reads out per stage in bench.py.
            # stages_sent is owned by whichever side runs the jobs
            # (exactly one; see _run_job).
            active.stages_sent = True
            ev.stages = {
                "recv": active.req.enqueued_at,
                "picked": active.req.picked_at or active.first_token_at,
                "first": active.first_token_at,
            }
            # First-event riders: the admission's radix reuse and — for
            # resumes — the completion offset generation continued from
            # (the relay's offset-dedup anchor).
            ev.tokens_reused = active.req.reused_tokens
            if active.req.resume_offset > 0:
                ev.resumed_from = active.req.resume_offset
        return active.req, ev

    def _emit_cb(self, req: GenRequest, ev: TokenEvent) -> None:
        """Queue a pre-built event with no slot attached (admission
        errors, queued cancels, deadline sheds). All job submissions
        happen on the engine thread, so the buffers need no lock.

        Terminal events close the request's cost account HERE — the one
        choke point every slotless exit path already goes through — so
        a request that sheds, errors, or cancels on ANY path still
        releases its ledger entry and ships its costs block (finish()
        is idempotent; a path that closed earlier books nothing twice)."""
        if ev.done and req.ledger is not None:
            ev.costs = req.ledger.finish(ev.finish_reason or "error")
        self._submit_job(("raw", req, ev))

    def _flush_events(self) -> None:
        """Block-boundary flush. Offload on: hand the buffered jobs to
        the emit worker as ONE bounded-queue put (blocking when the queue
        is full — the backpressure that bounds memory under a slow
        pipe). Offload off: deliver everything buffered inline — one
        emit_batch call when a sink is installed (→ one host-pipe frame
        per block), else per-event req.emit delivery."""
        if self._emit_offload:
            if self._block_jobs:
                jobs, self._block_jobs = self._block_jobs, []
                with self.tracer.span("flush"):
                    self._emit_queue.put(jobs)
            return
        if not self._pending_events:
            return
        batch, self._pending_events = self._pending_events, []
        with self.tracer.span("flush"):
            self._deliver_inline(batch)

    def _deliver_inline(self, batch: list[tuple[GenRequest, TokenEvent]]
                        ) -> None:
        self.metrics["emit_flushes"] += 1
        self.metrics["emit_events"] += len(batch)
        if self._emit_batch is not None:
            t0 = time.monotonic()
            try:
                self._emit_batch(batch)
            except Exception as exc:  # noqa: BLE001 — must never kill the loop
                log.error(f"emit batch sink failed: {exc}")
            dt = time.monotonic() - t0
            self.tracer.record("emit_flush", t0, dt, events=len(batch))
            if self.ledger.enabled and dt > 0.0:
                per = dt / len(batch)
                for req, _ev in batch:
                    if req.ledger is not None:
                        req.ledger.book_emit(per)
            return
        for req, ev in batch:
            try:
                req.emit(ev)
            except Exception as exc:  # noqa: BLE001 — emit must never kill the loop
                log.error(f"emit callback failed for request {req.id}: {exc}")

    def _check_invariants(self) -> None:
        active = set(self._slots)
        free = set(self._free)
        prefilling = {job.slot for job, _ in self._prefill_jobs}
        assert not (active & free), f"slot in both active and free: {active & free}"
        assert not (active & prefilling), \
            f"slot both active and prefilling: {active & prefilling}"
        assert not (free & prefilling), \
            f"slot both free and prefilling: {free & prefilling}"
        assert active | free | prefilling == set(range(self.engine.max_slots)), \
            "slot leak: some slot neither active, free, nor prefilling"
        for slot in active:
            assert self.engine.slot_length(slot) <= self.engine.slot_capacity


class AsyncSession:
    """Asyncio-side handle: submit a request, async-iterate token events."""

    def __init__(self, scheduler: Scheduler, *,
                 loop: asyncio.AbstractEventLoop | None = None) -> None:
        self._scheduler = scheduler
        self._loop = loop or asyncio.get_event_loop()
        self._queue: asyncio.Queue[TokenEvent] = asyncio.Queue()
        self._cancelled = False

    def cancel(self) -> None:
        self._cancelled = True

    def submit(self, prompt_ids: list[int], sampling: SamplingParams,
               max_new_tokens: int, request_id: str = "",
               speculative: bool | None = None,
               trace_id: str = "",
               deadline_s: float | None = None,
               resume_offset: int = 0) -> None:
        def emit(ev: TokenEvent) -> None:
            self._loop.call_soon_threadsafe(self._queue.put_nowait, ev)

        self._scheduler.submit(GenRequest(
            prompt_ids=prompt_ids, sampling=sampling,
            max_new_tokens=max_new_tokens, emit=emit,
            cancelled=lambda: self._cancelled, id=request_id,
            speculative=speculative, trace_id=trace_id,
            resume_offset=resume_offset,
            deadline_at=(time.monotonic() + deadline_s
                         if deadline_s is not None else None)))

    async def events(self):
        while True:
            ev = await self._queue.get()
            yield ev
            if ev.done:
                return
