"""The Symmetry client: request a provider from the server, stream completions.

The reference's client was refactored out of the repo (the test still imports
`SymmetryClient` from ../src/client — __test__/cli.test.ts:1 — which no longer
exists; SURVEY §0.1). This is its re-creation against our wire protocol:

    client = SymmetryClient(identity, transport)
    details = await client.request_provider(server_addr, server_key, "llama3:8b")
    async with await client.connect(details) as session:
        async for delta in session.chat([{"role": "user", "content": "hi"}]):
            print(delta, end="")
"""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass, field
from typing import Any, AsyncIterator

from symmetry_tpu_torch.identity import Identity
from symmetry_tpu_torch.network.peer import Peer
from symmetry_tpu_torch.protocol.keys import MessageKey
from symmetry_tpu_torch.provider.backends.proxy import (
    get_chat_data_from_provider,
    safe_parse_stream_response,
)
from symmetry_tpu_torch.transport.base import Transport
from symmetry_tpu_torch.utils.logging import logger
from symmetry_tpu_torch.utils.trace import Tracer, new_trace_id


class ClientError(RuntimeError):
    pass


class ProviderGoneError(ClientError):
    """The assigned provider died or closed mid-stream — the retryable
    failure class. Request-level errors (bad messages, invalid session)
    stay plain ClientError: replaying those on another provider would
    burn the pool on a deterministically-bad request."""


class ProviderDiedMidStreamError(ProviderGoneError):
    """The provider died AFTER streaming part of the completion. Carries
    everything a resume needs: the text deltas the client already holds
    (`emitted_text` — authoritative: TCP ordering guarantees it is
    exactly the prefix the provider relayed) and the emitted TOKEN count
    when the wire managed to stamp one (`emitted_tokens`; None when the
    connection just dropped — the resume path then lets the serving host
    re-derive the count from the text). chat_failover turns this into a
    `resume` request instead of regenerating from token 0."""

    def __init__(self, message: str, emitted_text: str = "",
                 emitted_tokens: int | None = None) -> None:
        super().__init__(message)
        self.emitted_text = emitted_text
        self.emitted_tokens = emitted_tokens


class ProviderBusyError(ClientError):
    """The provider shed the request before serving it (its backlog is
    over queue_limit) — retryable on ANOTHER provider: nothing streamed,
    and the request itself is fine. Carries the provider's reported
    queue depth/limit for backoff decisions."""

    def __init__(self, message: str, queue_depth: int | None = None,
                 queue_limit: int | None = None,
                 draining: bool = False) -> None:
        super().__init__(message)
        self.queue_depth = queue_depth
        self.queue_limit = queue_limit
        # A draining provider is shutting down for good: fail over NOW
        # and don't come back — unlike a backlog shed, no backoff round
        # will ever find it admitting again.
        self.draining = draining


class ProviderRestartingError(ProviderBusyError):
    """The provider's engine host crashed/wedged mid-service and its
    supervisor is respawning it — retryable on ANOTHER provider now, and
    on this one after ~retry_after_s. Subclasses ProviderBusyError so it
    joins the existing busy-shed failover + backoff machinery (the
    provider is transiently unable, not dead — it must not be excluded
    from the pool as a corpse)."""

    def __init__(self, message: str, retry_after_s: float | None = None,
                 emitted_text: str = "",
                 emitted_tokens: int | None = None, **kw) -> None:
        super().__init__(message, **kw)
        self.retry_after_s = retry_after_s
        # Mid-stream restarting sheds carry what already streamed, same
        # contract as ProviderDiedMidStreamError: the structured shed
        # frame stamps the provider's EXACT relayed-token count (what
        # this client holds — TCP ordering), so a seeded resume restores
        # its RNG lane to the right position. The engine host's journal
        # rides separately as emittedEngine when it exceeds the relayed
        # count (tokens that died on the pipe — lost work, not resume
        # state).
        self.emitted_text = emitted_text
        self.emitted_tokens = emitted_tokens


class ResumeRefusedError(ClientError):
    """The provider refused to RESUME (its backend regenerates from
    scratch — splicing would duplicate the completion). The request
    itself is fine: chat_failover falls back to one from-scratch
    restart instead of failing the call."""


class DeadlineExceededError(ClientError):
    """The request's end-to-end deadline_s expired before it was served.
    Deliberately NOT retryable (plain ClientError lineage): nobody is
    waiting for the answer anymore, so replaying it on another provider
    would burn pool capacity for a result that gets thrown away."""


def busy_retry_backoff(queue_depth: int | None, queue_limit: int | None,
                       round_idx: int = 0,
                       retry_after_s: float | None = None,
                       rand=random.random) -> float:
    """Backoff before a busy-shed retry round.

    Base wait scales with how deep the shedding provider's backlog was
    relative to its limit (bounded at 2 s so a huge depth never becomes
    a stall of our own) and doubles per retry round. The ±50% JITTER is
    the point: a burst of clients shed together would otherwise sleep
    the same formula and re-stampede the recovering provider in
    lockstep. The provider's retry_after hint (a restarting provider
    knows its respawn backoff better than we do) is ADDED UNDER the
    jittered wait, never multiplied into it: retrying before the hint is
    guaranteed to be shed again, and jittering the hint downward would
    do exactly that — so everyone waits at least the hint, desynchronized
    beyond it.

    When the shed DID carry a hint, the per-round doubling is clamped to
    the round-0 base: the hint already encodes how long the provider
    needs (its own respawn backoff), and doubling our base on top of it
    would amplify a restarting provider's honest estimate into a wait
    that grows with OUR retry count — a resume round after a mid-stream
    crash must honor the hint, not punish it (the doubling exists for
    hint-LESS busy sheds, where depth is the only signal we have)."""
    depth = queue_depth or 0
    limit = queue_limit or 0
    over = depth / limit if limit > 0 else 1.0
    # Round-0 base is bounded at 2 s (a huge reported depth must never
    # become a stall of our own) and the per-round doubling has its own
    # ceiling (×16) for the same reason — a caller asking for many retry
    # rounds gets persistence, not quarter-hour sleeps.
    doubling = 1 if retry_after_s is not None else (
        2 ** min(max(0, round_idx), 4))
    base = min(2.0, 0.25 * (1.0 + over)) * doubling
    wait = base * (0.5 + rand())
    if retry_after_s is not None:
        wait += float(retry_after_s)
    return wait


@dataclass(slots=True)
class ProviderDetails:
    peer_key: str
    address: str | None
    model_name: str
    session_token: dict | None = None
    session_id: str | None = None
    data_collection: bool = False
    provider_dialect: str = "openai"  # chunk format hint for delta extraction
    raw: dict = field(default_factory=dict)


@dataclass(slots=True)
class ChatRestart:
    """Failover marker: a new provider took over and generation restarted —
    everything streamed before this event must be discarded.
    `discarded_tokens` is the emitted-token count of the voided partial
    (None when no attempt stamped one) — the wasted-work numerator the
    chaos bench compares against the resume path's."""

    attempt: int
    provider_key: str
    discarded_tokens: int | None = None


@dataclass(slots=True)
class ChatResume:
    """Failover marker: a new provider took over and generation RESUMED
    from the last token the client received — everything streamed before
    this event is still valid, and the deltas that follow splice onto it
    (token-identical to an uninterrupted run for greedy and seeded
    sampling). `resumed_tokens` is how many already-streamed tokens the
    resume skipped regenerating — the wasted-work the resume path saved."""

    attempt: int
    provider_key: str
    resumed_tokens: int | None = None


class ProviderSession:
    """A live connection to one provider.

    Requests are MULTIPLEXED: every chat carries a requestId the provider
    echoes on each stream message, and one reader task routes messages to
    per-request queues — so concurrent chat() calls on a single session
    interleave correctly (the round-2 verdict's per-session-serialization
    limit, rooted in the reference's id-less wire, src/provider.ts:195).
    An abandoned stream is cancelled provider-side (inferenceCancel) and
    its stragglers dropped, instead of desyncing the whole session."""

    def __init__(self, peer: Peer, details: ProviderDetails,
                 tracer: Tracer | None = None) -> None:
        self._peer = peer
        self._details = details
        # Usage of the last completed chat, from inferenceEnded:
        # {"tokens": N, "chunks": M} (engine backends count exact
        # tokens), plus — when the provider runs with tpu.ledger on —
        # a "costs" block: the request's symledger attribution
        # (device_s{phase}, wasted_s{reason}, queue_s, emit_s, saved_s)
        # as the scheduler booked it. See last_costs.
        self.last_usage: dict | None = None
        self._queues: dict[str, asyncio.Queue] = {}
        self._stats_q: asyncio.Queue = asyncio.Queue()
        self._stats_lock = asyncio.Lock()
        self._trace_q: asyncio.Queue = asyncio.Queue()
        self._trace_lock = asyncio.Lock()
        self._profile_q: asyncio.Queue = asyncio.Queue()
        self._profile_lock = asyncio.Lock()
        self._reader: asyncio.Task | None = None
        self._closed = False
        # Client-side spans (chat round trip, first delta) land in the
        # owning SymmetryClient's tracer so one merge covers every
        # session. The provider clock offset (provider monotonic − ours)
        # is estimated from the stream-start marker's tMono stamp
        # bracketed by our send/receive stamps — a piggybacked handshake;
        # the lowest-RTT estimate seen so far wins.
        self.tracer = tracer if tracer is not None else Tracer()
        self.clock_offset: float | None = None
        self._clock_rtt = float("inf")

    @property
    def last_costs(self) -> dict | None:
        """The last completed chat's symledger cost block — what the
        request actually cost in attributed device time, as stamped on
        its end frame. None when the provider serves with tpu.ledger
        off (or no chat has completed on this session)."""
        usage = self.last_usage
        costs = usage.get("costs") if isinstance(usage, dict) else None
        return costs if isinstance(costs, dict) else None

    def _ensure_reader(self) -> None:
        if self._reader is None:
            self._reader = asyncio.get_running_loop().create_task(
                self._read_loop())

    async def _read_loop(self) -> None:
        """Single reader: routes stream messages by requestId."""
        try:
            while True:
                msg = await self._peer.recv()
                if msg is None:
                    break
                data = msg.data or {}
                if msg.key == MessageKey.METRICS:
                    self._stats_q.put_nowait(data)
                    continue
                if msg.key == MessageKey.TRACE:
                    self._trace_q.put_nowait(data)
                    continue
                if msg.key == MessageKey.PROFILE:
                    self._profile_q.put_nowait(data)
                    continue
                req_id = str(data.get("requestId", ""))
                q = self._queues.get(req_id)
                if q is None and not req_id and self._queues:
                    if len(self._queues) == 1:
                        # version skew: a pre-multiplexing provider echoes
                        # no requestId — with exactly one request in
                        # flight the stream is unambiguous, so route it
                        # there instead of hanging the caller forever
                        q = next(iter(self._queues.values()))
                    else:
                        # multiple requests in flight against an id-less
                        # provider: attribution is impossible — fail them
                        # all loudly rather than dropping chunks and
                        # deadlocking every caller on queue.get()
                        logger.error(
                            "provider echoes no requestId but multiple "
                            "requests are in flight; failing them — use "
                            "one chat at a time with this provider")
                        for pending_q in self._queues.values():
                            pending_q.put_nowait(None)
                        self._queues.clear()
                        continue
                if q is not None:
                    q.put_nowait(msg)
                elif msg.key in (MessageKey.INFERENCE,
                                 MessageKey.TOKEN_CHUNK,
                                 MessageKey.INFERENCE_ENDED,
                                 MessageKey.INFERENCE_ERROR):
                    # straggler of an abandoned (cancelled) request — drop
                    logger.debug(f"client: dropping stray {msg.key!r} "
                                 f"for request {req_id or '?'}")
                else:
                    logger.debug(f"client: ignoring key {msg.key!r}")
        finally:
            self._closed = True
            for q in self._queues.values():
                q.put_nowait(None)  # wire gone
            self._stats_q.put_nowait(None)
            self._trace_q.put_nowait(None)
            self._profile_q.put_nowait(None)

    async def __aenter__(self) -> "ProviderSession":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def new_conversation(self) -> None:
        await self._peer.send(MessageKey.NEW_CONVERSATION)

    async def chat(
        self,
        messages: list[dict[str, str]],
        *,
        max_tokens: int | None = None,
        temperature: float | None = None,
        top_p: float | None = None,
        top_k: int | None = None,
        seed: int | None = None,
        speculative: bool | None = None,
        trace_id: str | None = None,
        deadline_s: float | None = None,
        resume_text: str | None = None,
        resume_tokens: int | None = None,
    ) -> AsyncIterator[str]:
        """Send one inference request; yield text deltas as they stream.
        Safe to call concurrently on one session (requestId multiplexing).

        `resume_text` marks this chat as a RESUME of an interrupted
        stream: the provider continues generation from the end of that
        text (conditioning on prompt + resume_text through its prefix
        cache) instead of regenerating it, and yields only the
        continuation. `resume_tokens` is the emitted-token count the
        text represents (from the shed's stamped journal count) — it
        positions a seeded request's RNG lane; None lets the serving
        host re-derive it from the text. A mid-stream failure raises
        ProviderDiedMidStreamError / ProviderRestartingError carrying
        the deltas yielded so far, so the caller can resume elsewhere.

        Every chat carries a trace id (minted here unless the caller
        brings one): the provider threads it through its backend and the
        engine host, so one id keys the request's spans in every
        component of the merged timeline (session.trace / export).

        `deadline_s` is the end-to-end deadline: it threads provider →
        engine, and a request whose deadline expires while still queued
        is shed (DeadlineExceededError, non-retryable) instead of being
        prefilled for nobody."""
        import uuid as _uuid

        self._check_usable()
        req_id = _uuid.uuid4().hex[:16]
        trace_id = trace_id or new_trace_id()
        payload: dict[str, Any] = {"key": "inference", "messages": messages,
                                   "requestId": req_id,
                                   "traceId": trace_id}
        if self._details.session_token is not None:
            payload["sessionToken"] = self._details.session_token
        for k, v in (("max_tokens", max_tokens), ("temperature", temperature),
                     ("top_p", top_p), ("top_k", top_k), ("seed", seed),
                     ("speculative", speculative),
                     ("deadline_s", deadline_s)):
            if v is not None:
                payload[k] = v
        if resume_text is not None:
            payload["resume"] = {"text": resume_text,
                                 **({"tokens": int(resume_tokens)}
                                    if resume_tokens is not None else {})}
        self._ensure_reader()
        queue: asyncio.Queue = asyncio.Queue()
        self._queues[req_id] = queue
        ended = False
        t_send = time.monotonic()
        t_first: float | None = None
        n_deltas = 0
        # Everything yielded so far, for the resume path: a mid-stream
        # death's error carries it, and the caller splices a continuation
        # onto it instead of discarding the work.
        emitted_parts: list[str] = []

        def _mid_stream(exc: ClientError) -> ClientError:
            """Attach the emitted state to a mid-stream retryable. A
            pre-first-delta failure stays the plain class (nothing to
            resume)."""
            if not emitted_parts:
                return exc
            if isinstance(exc, ProviderRestartingError):
                exc.emitted_text = "".join(emitted_parts)
                return exc
            if isinstance(exc, ProviderGoneError):
                return ProviderDiedMidStreamError(
                    str(exc), emitted_text="".join(emitted_parts))
            return exc

        try:
            await self._peer.send(MessageKey.INFERENCE, payload)
            dialect = self._details.provider_dialect
            while True:
                msg = await queue.get()
                if msg is None:
                    ended = True  # wire gone; nothing left to misroute
                    raise _mid_stream(ProviderGoneError(
                        "provider closed connection mid-stream"))
                if msg.key == MessageKey.INFERENCE:
                    # stream-start marker; carries the backend dialect —
                    # and the provider's monotonic stamp, bracketed by our
                    # send/receive stamps for the clock-offset estimate.
                    data = msg.data or {}
                    dialect = data.get("provider", dialect)
                    t_mono = data.get("tMono")
                    if isinstance(t_mono, (int, float)):
                        now = time.monotonic()
                        rtt = now - t_send
                        if rtt < self._clock_rtt:
                            self._clock_rtt = rtt
                            self.clock_offset = (
                                float(t_mono) - (t_send + now) / 2.0)
                elif msg.key == MessageKey.TOKEN_CHUNK:
                    raw = (msg.data or {}).get("raw", "")
                    parsed = safe_parse_stream_response(raw)
                    if parsed is None:
                        continue
                    delta = get_chat_data_from_provider(dialect, parsed)
                    if delta:
                        if t_first is None:
                            t_first = time.monotonic()
                            self.tracer.record(
                                "client_ttft", t_send, t_first - t_send,
                                request_id=req_id, trace_id=trace_id)
                        n_deltas += 1
                        emitted_parts.append(delta)
                        yield delta
                elif msg.key == MessageKey.INFERENCE_ENDED:
                    ended = True
                    data = msg.data or {}
                    if data.get("cancelled"):
                        # provider-side cancellation (shutdown/drain): a
                        # truncated stream must look like provider death —
                        # retryable — not a normal completion
                        raise _mid_stream(ProviderGoneError(
                            "provider cancelled the stream"))
                    self.last_usage = data
                    return
                elif msg.key == MessageKey.INFERENCE_ERROR:
                    ended = True
                    data = msg.data or {}
                    if data.get("resumeUnsupported"):
                        # Structured resume refusal (proxy backend):
                        # typed so failover can fall back to a restart
                        # without guessing from the message text.
                        raise ResumeRefusedError(
                            data.get("error", "resume not supported"))
                    if data.get("expired"):
                        # Deadline shed: terminal, not retryable — nobody
                        # is waiting for this answer anymore.
                        raise DeadlineExceededError(
                            data.get("error", "deadline expired"))
                    if data.get("restarting"):
                        # Engine-host crash/wedge, supervisor respawning:
                        # retryable — fail over now, optionally come back
                        # after retryAfterS. Mid-stream sheds stamp the
                        # relayed-token count ("emitted", journal-fed) so
                        # the resume can restore a seeded RNG lane.
                        emitted = data.get("emitted")
                        raise _mid_stream(ProviderRestartingError(
                            data.get("error", "provider restarting"),
                            retry_after_s=data.get("retryAfterS"),
                            emitted_tokens=(int(emitted)
                                            if isinstance(emitted, int)
                                            else None),
                            queue_depth=data.get("queueDepth"),
                            queue_limit=data.get("queueLimit")))
                    if data.get("busy"):
                        # Structured shed (provider over queue_limit, or
                        # draining): distinguishable so failover retries
                        # elsewhere instead of treating it as a bad
                        # request.
                        raise ProviderBusyError(
                            data.get("error", "provider busy"),
                            queue_depth=data.get("queueDepth"),
                            queue_limit=data.get("queueLimit"),
                            draining=bool(data.get("draining")))
                    raise ClientError(
                        data.get("error", "inference failed"))
        finally:
            self.tracer.record("client_request", t_send,
                               time.monotonic() - t_send,
                               request_id=req_id, trace_id=trace_id,
                               deltas=n_deltas, completed=ended)
            self._queues.pop(req_id, None)
            if not ended and not self._peer.closed:
                # Abandoned mid-stream: cancel provider-side (frees the
                # engine slot); any stragglers are dropped by the reader.
                try:
                    await self._peer.send(MessageKey.INFERENCE_CANCEL,
                                          {"requestId": req_id})
                except (ConnectionError, OSError):
                    pass

    def _check_usable(self) -> None:
        if self._closed:
            raise ProviderGoneError("session is closed")

    async def chat_text(self, messages: list[dict[str, str]], **kw) -> str:
        return "".join([d async for d in self.chat(messages, **kw)])

    async def stats(self) -> dict:
        """Query the provider's serving metrics snapshot (tok/s, TTFT/e2e
        percentiles, occupancy).

        Runs through the shared reader; concurrent with chats, serialized
        only against other stats calls (metrics replies carry no id)."""
        self._check_usable()
        self._ensure_reader()
        async with self._stats_lock:
            # The reader may have exited while we awaited the lock — its
            # single None sentinel would be eaten by the drain below and
            # the get() would hang forever on a closed session.
            self._check_usable()
            # a previously-timed-out stats() may have left its reply
            # queued; drain so this call gets ITS OWN snapshot
            while not self._stats_q.empty():
                if self._stats_q.get_nowait() is None:
                    raise ProviderGoneError("provider closed connection")
            await self._peer.send(MessageKey.METRICS)
            try:
                data = await asyncio.wait_for(self._stats_q.get(), 30.0)
            except asyncio.TimeoutError:
                raise ProviderGoneError(
                    "no stats reply within 30s") from None
            if data is None:
                raise ProviderGoneError("provider closed during stats query")
            return data

    async def trace(self) -> dict:
        """Query the provider's merged span-ring snapshot (provider +
        host + scheduler components, stamps on the provider's clock).
        Same reader/serialization discipline as stats()."""
        self._check_usable()
        self._ensure_reader()
        async with self._trace_lock:
            self._check_usable()
            while not self._trace_q.empty():
                if self._trace_q.get_nowait() is None:
                    raise ProviderGoneError("provider closed connection")
            await self._peer.send(MessageKey.TRACE)
            try:
                data = await asyncio.wait_for(self._trace_q.get(), 30.0)
            except asyncio.TimeoutError:
                raise ProviderGoneError(
                    "no trace reply within 30s") from None
            if data is None:
                raise ProviderGoneError("provider closed during trace query")
            return data

    async def capture_profile(self, duration_s: float = 2.0) -> dict:
        """Trigger one bounded on-device jax.profiler capture on the
        provider's engine and await the result: {"path": <trace dir>}
        on success, {"error": ...} otherwise (no device backend, or a
        capture already in progress). The reply arrives only after the
        capture window closes — the timeout budgets for it. Same
        reader/serialization discipline as stats()/trace()."""
        self._check_usable()
        self._ensure_reader()
        async with self._profile_lock:
            self._check_usable()
            while not self._profile_q.empty():
                if self._profile_q.get_nowait() is None:
                    raise ProviderGoneError("provider closed connection")
            await self._peer.send(MessageKey.PROFILE,
                                  {"durationS": float(duration_s)})
            try:
                # Budget the capture window PLUS the profiler's cold
                # init (the process's first capture can take tens of
                # seconds) and the provider's own probe margin.
                data = await asyncio.wait_for(self._profile_q.get(),
                                              duration_s + 150.0)
            except asyncio.TimeoutError:
                raise ProviderGoneError(
                    "no profile reply within the capture window") from None
            if data is None:
                raise ProviderGoneError(
                    "provider closed during profile capture")
            return data

    async def trace_components(self) -> list[dict]:
        """Provider-side components reconciled onto THIS client's clock:
        every component's clock_offset_s gains the session's measured
        provider offset, plus the client's own span ring at offset 0 —
        ready for utils.trace.export_perfetto."""
        payload = await self.trace()
        off = self.clock_offset or 0.0
        comps = []
        for comp in payload.get("components") or []:
            if isinstance(comp, dict):
                comps.append({**comp, "clock_offset_s":
                              float(comp.get("clock_offset_s", 0.0)) + off})
        comps.append(self.tracer.component("client"))
        return comps

    async def close(self) -> None:
        self._closed = True
        if self._reader is not None:
            self._reader.cancel()
        if not self._peer.closed:
            try:
                await self._peer.send(MessageKey.LEAVE)
            except (ConnectionError, OSError):
                pass
        await self._peer.close()


class SymmetryClient:
    def __init__(self, identity: Identity | None = None,
                 transport: Transport | None = None) -> None:
        self.identity = identity or Identity.generate()
        if transport is None:
            from symmetry_tpu_torch.transport.tcp import TcpTransport

            transport = TcpTransport()  # CLI passes transport_for(server)
        self._transport = transport
        # One span ring for all this client's sessions: chat round trips
        # and first-delta spans, merged with provider-side components by
        # export_trace / ProviderSession.trace_components.
        self.tracer = Tracer()

    async def export_trace(self, session: "ProviderSession") -> dict:
        """One request's (or session's) end-to-end timeline as Chrome
        trace-event JSON: the provider's merged components (provider,
        host, scheduler — reconciled through the measured clock offsets)
        plus this client's spans. Write it to a file and load it in
        Perfetto (ui.perfetto.dev) or chrome://tracing."""
        from symmetry_tpu_torch.utils.trace import export_perfetto

        return export_perfetto(await session.trace_components())

    async def request_provider(
        self, server_address: str, server_key: bytes, model_name: str | None = None,
        timeout: float = 10.0, exclude: list[str] | None = None,
    ) -> ProviderDetails:
        """Ask the server for a provider assignment (requestProvider →
        providerDetails, reference keys src/constants.ts:16,14). `exclude`
        lists peer keys the server must not hand back (failover re-request
        after a provider died)."""
        conn = await self._transport.dial(server_address)
        peer = await Peer.connect(
            conn, self.identity, initiator=True, expected_remote_key=server_key
        )
        try:
            req: dict[str, Any] = {"modelName": model_name}
            if exclude:
                req["excludePeers"] = list(exclude)
            await peer.send(MessageKey.REQUEST_PROVIDER, req)
            msg = await asyncio.wait_for(peer.recv(), timeout)
            if msg is None or msg.key != MessageKey.PROVIDER_DETAILS:
                raise ClientError(f"unexpected server reply: {msg and msg.key}")
            data = msg.data or {}
            if "error" in data:
                raise ClientError(data["error"])
            prov = data.get("provider") or {}
            return ProviderDetails(
                peer_key=prov.get("peerKey", ""),
                address=prov.get("address"),
                model_name=prov.get("modelName", model_name or ""),
                session_token=data.get("sessionToken"),
                session_id=data.get("sessionId"),
                data_collection=bool(prov.get("dataCollectionEnabled", False)),
                raw=data,
            )
        finally:
            await peer.close()

    async def list_models(self, server_address: str, server_key: bytes,
                          timeout: float = 10.0) -> list[dict]:
        conn = await self._transport.dial(server_address)
        peer = await Peer.connect(
            conn, self.identity, initiator=True, expected_remote_key=server_key
        )
        try:
            await peer.send(MessageKey.PROVIDER_LIST)
            msg = await asyncio.wait_for(peer.recv(), timeout)
            return (msg.data or {}).get("models", []) if msg else []
        finally:
            await peer.close()

    async def chat_failover(
        self,
        server_address: str,
        server_key: bytes,
        model_name: str,
        messages: list[dict[str, str]],
        *,
        attempts: int = 3,
        busy_retry_rounds: int = 1,
        resume: bool = True,
        **chat_kw,
    ) -> AsyncIterator[str | "ChatRestart" | "ChatResume"]:
        """Streaming chat with provider failover and mid-stream RESUME.

        If the assigned provider dies MID-STREAM (crash, wedge, link cut,
        pool-member loss — any retryable shed after the first delta), the
        next attempt issues a `resume` request instead of regenerating:
        the new provider continues from the last token this client
        received (conditioning on prompt + received text through its
        radix prefix cache), a ChatResume sentinel is yielded, and the
        continuation deltas SPLICE onto what was already yielded —
        token-identical to an uninterrupted run for greedy and seeded
        sampling. `resume=False` restores the old discard-and-restart
        behavior. A provider that refuses the resume (proxy backend, or
        a history that outgrew its prefill buckets) triggers ONE
        fallback to a from-scratch restart.

        If the assigned provider dies before anything streamed, the
        server is asked for a FRESH provider (the dead one excluded — its
        sessions were invalidated server-side) and generation restarts.
        A restart yields a ChatRestart sentinel first: text streamed from
        the dead provider is void and consumers must discard it.
        chat_text_failover does both bookkeepings for you.

        Busy-shed backoff: when busy (or restarting) sheds exhausted the
        pool — the providers are healthy, just over their backlog bound
        or mid-respawn, a transient — the busy providers are un-excluded
        and up to `busy_retry_rounds` extra rounds run, each after a
        JITTERED backoff (busy_retry_backoff: sized from the shed reply's
        queue_depth/queue_limit, doubled per round, on top of the
        provider's retryAfterS hint, ±50% jitter so synchronized clients
        don't re-stampede a recovering provider in lockstep).
        `busy_retry_rounds=0` disables the retry entirely.
        Genuinely-dead providers stay excluded throughout.

        `deadline_s` (via chat_kw) is END-TO-END across all attempts:
        each retry carries only the time remaining, and the loop raises
        DeadlineExceededError itself once the budget is spent — failing
        over with a reset deadline would admit work nobody awaits.
        """
        dead: list[str] = []
        busy: list[str] = []
        # Resume state: every delta yielded so far (still-valid text once
        # a resume splices onto it) and its emitted-token count (None
        # once any failed attempt couldn't stamp one — the serving host
        # then re-derives the count from the text). `resuming` arms the
        # NEXT attempt as a resume instead of a restart.
        acc_parts: list[str] = []
        acc_tokens: int | None = 0
        resuming = False
        last_exc: Exception | None = None
        # Tracked separately from last_exc: pool exhaustion surfaces as a
        # plain ClientError from request_provider AFTER the busy shed, so
        # gating the retry on last_exc would skip it exactly when the
        # sheds emptied the pool — the case the backoff exists for.
        last_busy: ProviderBusyError | None = None
        n_tries = 0
        # End-to-end deadline across ALL attempts: passing the original
        # deadline_s verbatim on each retry would re-anchor the window
        # at every provider's receipt, turning a 2 s budget into 2 s per
        # hop — the caller stopped waiting, but the pool keeps admitting.
        deadline_s = chat_kw.pop("deadline_s", None)
        t_deadline0 = time.monotonic()
        total_rounds = 1 + max(0, busy_retry_rounds)
        for round_idx in range(total_rounds):
            pool_exhausted = False
            for _ in range(attempts):
                kw = chat_kw
                if deadline_s is not None:
                    remaining = deadline_s - (time.monotonic()
                                              - t_deadline0)
                    if remaining <= 0:
                        raise DeadlineExceededError(
                            f"deadline_s={deadline_s} spent after "
                            f"{n_tries} provider attempt(s)")
                    kw = {**chat_kw, "deadline_s": remaining}
                try:
                    details = await self.request_provider(
                        server_address, server_key, model_name,
                        exclude=dead + busy)
                except ClientError as exc:
                    last_exc = exc
                    pool_exhausted = True
                    break  # no provider left to fail over to
                if n_tries > 0:
                    if resuming:
                        yield ChatResume(attempt=n_tries,
                                         provider_key=details.peer_key,
                                         resumed_tokens=acc_tokens)
                    else:
                        # From-scratch restart: the partial text is void
                        # (its token count rides the sentinel — the
                        # wasted work the resume path exists to save).
                        discarded = (acc_tokens if acc_parts else None)
                        acc_parts.clear()
                        acc_tokens = 0
                        yield ChatRestart(attempt=n_tries,
                                          provider_key=details.peer_key,
                                          discarded_tokens=discarded)
                n_tries += 1
                try:
                    # relay_via: a NAT-only provider (direct dial fails,
                    # the server splice works) is serviceable, not dead
                    session = await self.connect(
                        details, relay_via=(server_address, server_key))
                except (ClientError, ConnectionError, OSError) as exc:
                    last_exc = exc
                    if details.peer_key:
                        dead.append(details.peer_key)
                    continue
                before = len(acc_parts)
                try:
                    ckw = kw
                    if resuming:
                        ckw = {**kw, "resume_text": "".join(acc_parts),
                               "resume_tokens": acc_tokens}
                    async for delta in session.chat(messages, **ckw):
                        acc_parts.append(delta)
                        yield delta
                    return
                except DeadlineExceededError:
                    # Terminal by contract — never converted to a
                    # restart, resumed, or retried.
                    raise
                except (ProviderGoneError, ProviderBusyError,
                        ConnectionError, OSError) as exc:
                    # Provider-death AND busy-shed failures fail over (a
                    # shed provider is healthy but over its backlog bound
                    # — this request is excluded from it, not the
                    # provider from the pool). A request-level
                    # ClientError (bad messages, rejected params)
                    # propagates: replaying it elsewhere would fail
                    # identically while blacklisting healthy providers.
                    last_exc = exc
                    if (isinstance(exc, ProviderBusyError)
                            and not getattr(exc, "draining", False)):
                        # Tracked even for a keyless provider row (no
                        # exclusion possible): the shed itself is what
                        # makes the end-of-round backoff retry eligible.
                        last_busy = exc
                        if details.peer_key:
                            busy.append(details.peer_key)
                    elif details.peer_key:
                        # Dead — or DRAINING: a shutting-down provider
                        # will never admit again, so it is excluded like
                        # a corpse and earns no backoff retry round.
                        dead.append(details.peer_key)
                    if len(acc_parts) > before:
                        # Streamed something this attempt: fold its
                        # stamped token count into the running total (a
                        # missing stamp poisons the count to None — the
                        # host re-derives it from the text).
                        et = getattr(exc, "emitted_tokens", None)
                        acc_tokens = (acc_tokens + int(et)
                                      if acc_tokens is not None
                                      and et is not None else None)
                    # Everything yielded so far (this attempt's deltas
                    # included) is still valid — the next attempt
                    # CONTINUES it. The mid-stream provider is already
                    # excluded above (dead or busy), so the immediate
                    # resume round lands elsewhere when a peer exists.
                    resuming = resume and bool(acc_parts)
                except ClientError as exc:
                    # A failed RESUME attempt falls back ONCE to a plain
                    # restart — the next attempt regenerates from token
                    # 0 after a ChatRestart. Two flavors: the structured
                    # refusal (ResumeRefusedError — proxy backend,
                    # expected) and any other resume-time error (e.g.
                    # prompt+history beyond the host's prefill buckets,
                    # which only exists because of the resume — the
                    # original messages already streamed fine once, so
                    # this is not a deterministically-bad request).
                    # A non-resume ClientError keeps the old contract
                    # and propagates.
                    if not resuming:
                        raise
                    if isinstance(exc, ResumeRefusedError):
                        logger.info(f"resume refused ({exc}); falling "
                                    f"back to a from-scratch restart")
                    else:
                        logger.warning(
                            f"resume attempt failed ({exc}); falling "
                            f"back to a from-scratch restart")
                    last_exc = exc
                    resuming = False
                finally:
                    await session.close()
            # Retry only when busy sheds actually ended the round: the
            # pool ran dry with sheds among the exclusions, or the final
            # attempt itself was shed. A round that merely PASSED THROUGH
            # a busy provider before dying on dead ones gets no bonus
            # attempts beyond the caller's budget.
            if (round_idx + 1 < total_rounds and last_busy is not None
                    and (pool_exhausted
                         or isinstance(last_exc, ProviderBusyError))):
                # The backlog that shed us drains at roughly one slot
                # rotation; the jittered backoff (see busy_retry_backoff)
                # spreads the returning herd over it.
                backoff = busy_retry_backoff(
                    last_busy.queue_depth, last_busy.queue_limit,
                    round_idx=round_idx,
                    retry_after_s=getattr(last_busy, "retry_after_s",
                                          None))
                if deadline_s is not None:
                    remaining = deadline_s - (time.monotonic()
                                              - t_deadline0)
                    if remaining <= backoff:
                        # Sleeping through the rest of the budget just to
                        # raise on the next attempt is strictly worse
                        # than raising now.
                        raise DeadlineExceededError(
                            f"deadline_s={deadline_s}: {remaining:.2f}s "
                            f"left, retry backoff {backoff:.2f}s would "
                            f"overrun it")
                logger.debug(
                    f"pool exhausted on busy sheds "
                    f"(depth={last_busy.queue_depth} "
                    f"limit={last_busy.queue_limit}); retry round "
                    f"{round_idx + 1}/{total_rounds - 1} in {backoff:.2f}s")
                await asyncio.sleep(backoff)
                busy.clear()
                # Each retry round must earn the NEXT one with fresh
                # sheds — a stale shed from round 0 must not keep the
                # loop alive after a round of pure dial failures.
                last_busy = None
                continue
            break
        raise ClientError(
            f"chat failed after {n_tries or attempts} provider "
            f"attempt(s): {last_exc}")

    async def chat_text_failover(self, server_address: str, server_key: bytes,
                                 model_name: str,
                                 messages: list[dict[str, str]],
                                 **kw) -> str:
        """chat_failover collected to a final string (restart- and
        resume-aware: a ChatResume keeps the partial text — the
        continuation splices onto it; a ChatRestart voids it)."""
        parts: list[str] = []
        async for item in self.chat_failover(server_address, server_key,
                                             model_name, messages, **kw):
            if isinstance(item, ChatRestart):
                parts.clear()  # the dead provider's partial text is void
            elif isinstance(item, ChatResume):
                pass  # spliced continuation: everything so far is valid
            else:
                parts.append(item)
        return "".join(parts)

    async def connect(self, details: ProviderDetails,
                      *, relay_via: tuple[str, bytes] | None = None
                      ) -> ProviderSession:
        """Dial a provider directly, pinning its key from providerDetails.

        With `relay_via=(server_address, server_key)`, a failed direct
        dial falls back to the server-spliced relay (network/relay.py) —
        the reference's behind-NAT reachability leg."""
        if not details.address and relay_via is None:
            raise ClientError("provider has no dialable address")
        expected = bytes.fromhex(details.peer_key) if details.peer_key else None
        conn = None
        if details.address:
            try:
                conn = await self._transport.dial(details.address)
            except (ConnectionError, OSError) as exc:
                if relay_via is None:
                    raise
                logger.info(f"direct dial {details.address} failed ({exc}); "
                            f"falling back to relay")
        if conn is None:
            assert relay_via is not None
            if not details.peer_key:
                raise ClientError("relay requires the provider's key")
            conn = await self.connect_relay(relay_via[0], relay_via[1],
                                            details.peer_key)
        peer = await Peer.connect(
            conn, self.identity, initiator=True, expected_remote_key=expected
        )
        return ProviderSession(peer, details, tracer=self.tracer)

    async def connect_relay(self, server_address: str, server_key: bytes,
                            provider_key_hex: str):
        """Open a server-spliced relay channel to a provider (the Noise
        handshake with the provider then runs THROUGH it — the server
        carries only ciphertext)."""
        from symmetry_tpu_torch.network.relay import RelayedConnection, await_ready

        conn = await self._transport.dial(server_address)
        server_peer = await Peer.connect(
            conn, self.identity, initiator=True,
            expected_remote_key=server_key)
        try:
            await server_peer.send(MessageKey.RELAY_CONNECT,
                                   {"providerKey": provider_key_hex})
            # the relayId arrives in relayReady (shared wait helper —
            # one refusal-handling implementation for both roles)
            relay_id = await await_ready(server_peer)
        except ConnectionError as exc:
            await server_peer.close()
            raise ClientError(str(exc)) from exc
        except BaseException:
            # failed setup must not leak the dialed server connection —
            # failover retries would accumulate sockets
            await server_peer.close()
            raise
        return RelayedConnection(server_peer, relay_id)

    async def connect_direct(self, address: str, provider_key: bytes | None = None,
                             model_name: str = "") -> ProviderSession:
        """Direct connection to a known (possibly private) provider."""
        details = ProviderDetails(
            peer_key=provider_key.hex() if provider_key else "",
            address=address,
            model_name=model_name,
        )
        return await self.connect(details)

    async def discover(self, provider_key: bytes,
                       bootstrap: list[str]) -> ProviderDetails:
        """Decentralized discovery: resolve a provider by public key over
        the Kademlia DHT (network/dht.py) — no central server involved.
        Topic = discovery_key(provider_key), the reference's hyperswarm
        topic semantics. Raises ClientError when nobody has announced."""
        from symmetry_tpu_torch.identity import discovery_key
        from symmetry_tpu_torch.network.dht import DHTNode, parse_host_port

        try:
            boot = [parse_host_port(e) for e in bootstrap]
        except ValueError as exc:
            raise ClientError(str(exc)) from None
        node = DHTNode()
        await node.start("0.0.0.0", 0, bootstrap=boot)
        try:
            peers = await node.lookup(discovery_key(provider_key))
        finally:
            await node.stop()
        want = provider_key.hex()
        for peer in peers:
            if peer.get("publicKey") == want and peer.get("address"):
                return ProviderDetails(
                    peer_key=want,
                    address=peer["address"],
                    model_name=peer.get("modelName", ""),
                    raw=peer,
                )
        raise ClientError(
            f"provider {want[:12]}… not found on the DHT")
