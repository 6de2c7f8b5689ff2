"""Inference backend seam.

The reference has exactly one backend shape — an external OpenAI-compatible
HTTP server it proxies to (src/provider.ts:299-319) — selected by the
`apiProvider` config out of a fixed registry (src/constants.ts:22-29). Here the
backend is a first-class interface so `tpu_native` (in-process JAX engine) and
the HTTP proxies are interchangeable:

    backend = get_backend(config)
    async for chunk in backend.stream(request): ...

Each StreamChunk carries both the raw wire form (forwarded verbatim to the
client, preserving the reference's passthrough semantics, src/provider.ts:247)
and the extracted text delta (for data collection — the reference re-parses
every chunk to get this, src/provider.ts:243-246; we extract once).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, AsyncIterator


@dataclass(slots=True)
class InferenceRequest:
    """An `inference` message payload (reference: src/types.ts:28-31)."""

    messages: list[dict[str, str]]
    key: str = "inference"
    # Sampling controls (tpu_native; proxies forward what their API accepts).
    max_tokens: int | None = None
    temperature: float | None = None
    top_p: float | None = None
    top_k: int | None = None
    seed: int | None = None
    # Speculative decoding override (tpu_native with tpu.speculative on):
    # False opts this request out of drafting; None defers to the engine.
    speculative: bool | None = None
    # Request trace context (utils/trace.py): the client-minted trace id
    # from the inference frame's "traceId" field; engine backends thread
    # it through the host pipe so scheduler spans correlate with the
    # client's on one Perfetto timeline. "" = untraced.
    trace_id: str = ""
    # End-to-end deadline in seconds from provider receipt (client
    # "deadline_s"). Engine backends thread it to the scheduler, which
    # sheds an already-expired request at admission instead of prefilling
    # work nobody is waiting for. None = no deadline.
    deadline_s: float | None = None
    # Stream resumption (client "resume" payload): `resume_text` is the
    # completion prefix the client already received from a provider that
    # died mid-stream — the backend continues generation from its end
    # (conditioning on prompt + resume_text, radix-cache-seeded on the
    # engine) and yields ONLY the continuation. `resume_tokens` is the
    # emitted-token count that text represents (positions a seeded
    # request's RNG lane); None lets the engine re-derive it from the
    # text. None resume_text = an ordinary request.
    resume_text: str | None = None
    resume_tokens: int | None = None


@dataclass(slots=True)
class StreamChunk:
    raw: str          # exact chunk forwarded to the client (SSE line / JSON line)
    text: str         # extracted completion delta ("" for control chunks)
    done: bool = False
    # Tokens this chunk represents. Engine backends report the true count
    # (a block-decode chunk carries many tokens, a finish's flush tail may
    # carry zero); proxy backends leave None and the provider falls back
    # to chunk counting — the reference's accounting (one chunk ≈ one
    # token, src/provider.ts:243-246). None and 0 differ on purpose:
    # 0 is an exact "no new tokens", None is "unknown, estimate".
    tokens: int | None = None
    # symledger cost block (engine/ledger.py), stamped on the done
    # chunk only: device_s{phase}/queue_s/emit_s/wasted_s{reason}/
    # saved_s as attributed by the scheduler (source "probed"/"blocked")
    # or estimated by a proxy backend (source "estimated"). None
    # mid-stream, and None everywhere while tpu.ledger is off.
    costs: dict | None = None


class ResumeJournal:
    """Per-request emitted-token journal: the backend's record of how
    many tokens each in-flight stream has relayed, so a crash/wedge/
    link-loss shed can stamp an ACCURATE `emitted` count into its
    structured error — the count a seeded resume uses to restore its
    RNG lane position. Tracked per stream via a handle (acquire on
    admission, release on every exit path — the lifecycle-checker
    contract: a leaked handle is a request the death path would stamp
    forever after it finished). The engine host's own journal (the
    stats-heartbeat rider) is merged in as a lower bound for streams
    whose frames died on the pipe.

    Single-event-loop discipline: every mutation happens on the
    provider's loop (stream tasks, reader tasks, death paths), so no
    lock is needed — same ownership argument as the backend queues."""

    def __init__(self) -> None:
        self._emitted: dict[str, int] = {}

    def track(self, request_id: str) -> "ResumeJournalHandle":
        """Open the journal entry for one stream; the returned handle
        must be released on every exit path."""
        self._emitted.setdefault(request_id, 0)
        return ResumeJournalHandle(self, request_id)

    def note(self, request_id: str, tokens: int) -> None:
        if tokens and request_id in self._emitted:
            self._emitted[request_id] += int(tokens)

    def merge(self, counts: dict | None) -> None:
        """Fold the engine host's heartbeat journal in (host-side counts
        of tokens WRITTEN to the pipe): for a tracked stream the larger
        count wins — frames the relay never saw still happened, and the
        shed must not understate what the engine emitted. (The resume
        itself always conditions on the CLIENT's text; this count is the
        shed's observability stamp and the wasted-work numerator.)"""
        if not isinstance(counts, dict):
            return
        for req_id, n in counts.items():
            key = str(req_id)
            if key in self._emitted and isinstance(n, int):
                self._emitted[key] = max(self._emitted[key], n)

    def get(self, request_id: str) -> int:
        return self._emitted.get(request_id, 0)

    def release(self, request_id: str) -> None:
        self._emitted.pop(request_id, None)


class ResumeJournalHandle:
    """One stream's journal entry. note() folds relayed tokens in;
    release() closes the entry (idempotent — the death path may have
    already stamped and the stream's finally still runs)."""

    __slots__ = ("_journal", "_request_id")

    def __init__(self, journal: ResumeJournal, request_id: str) -> None:
        self._journal = journal
        self._request_id = request_id

    def note(self, tokens: int) -> None:
        self._journal.note(self._request_id, tokens)

    def release(self) -> None:
        self._journal.release(self._request_id)


class InferenceBackend(abc.ABC):
    """A source of streamed completions."""

    name: str = "?"
    # Stream resumption support: True when stream() honors
    # InferenceRequest.resume_text (continues from its end, yields only
    # the continuation). The provider REFUSES resume requests against a
    # backend that would regenerate from scratch — the client would
    # splice a full completion onto its partial text — with a structured
    # error the client turns into a from-scratch restart.
    supports_resume: bool = False
    # Admission capacity. `slots` = requests served concurrently without
    # queueing (engine decode slots); `queue_limit` = total in-flight
    # (serving + queued) beyond which the provider sheds new inference
    # with a structured busy error instead of letting every queued client
    # wait unboundedly. None = unbounded — the reference's behavior
    # (nothing in the reference's src/provider.ts rejects on backlog, only
    # maxConnections caps peers), kept for the proxy/echo backends.
    slots: int | None = None
    queue_limit: int | None = None
    # TTFT-bounded admission (provider sheds when its estimated
    # first-token wait exceeds this); None = disabled.
    admission_ttft_bound_s: float | None = None

    @abc.abstractmethod
    def stream(self, request: InferenceRequest) -> AsyncIterator[StreamChunk]:
        """Yield chunks for one completion. Raises BackendError on failure."""

    async def start(self) -> None:
        """Load weights / open pools. Called once before serving."""

    async def stop(self) -> None:
        """Release resources; called at provider shutdown."""

    async def healthy(self) -> bool:
        """Liveness for failure detection (SURVEY §5.3): engine wedge must
        unregister the provider."""
        return True

    async def trace_components(self) -> list[dict]:
        """Span-ring snapshots this backend contributes to the merged
        Perfetto export (utils/trace.export_perfetto component shape).
        Each entry's clock_offset_s must already be relative to THIS
        process's CLOCK_MONOTONIC (tpu_native applies its measured
        host-pipe offset before returning). Default: nothing to add."""
        return []


class BackendError(RuntimeError):
    pass


class BackendRestartingError(BackendError):
    """The engine host died (crash or wedge) and its supervisor is
    respawning it. RETRYABLE: the request itself is fine, the provider
    will be back — the provider relays this as a structured
    ``{"restarting": true}`` shed and clients fail over immediately
    (client.ProviderRestartingError joins the busy-shed backoff path)."""

    def __init__(self, message: str,
                 retry_after_s: float | None = None,
                 emitted: int | None = None) -> None:
        super().__init__(message)
        self.retry_after_s = retry_after_s
        # Journal-stamped emitted-token count for the dying stream (None
        # when nothing streamed / unknown): the provider folds it into
        # the structured shed so the client's resume knows its RNG lane
        # position even when its own per-chunk counting is incomplete.
        self.emitted = emitted


class BackendDeadlineError(BackendError):
    """The request's end-to-end deadline expired before it was served
    (scheduler admission shed). NOT retryable — by definition nobody is
    waiting for the answer anymore."""


def get_backend(config: Any, *, device: str = "cuda") -> InferenceBackend:
    """Instantiate the backend named by config.apiProvider. `device` is the
    torch device a tpu_native backend's engine runs on."""
    provider = config.api_provider
    if provider == "echo":
        from symmetry_tpu_torch.provider.backends.echo import EchoBackend

        return EchoBackend()
    if provider == "tpu_native":
        from symmetry_tpu_torch.provider.backends.tpu_native import TpuNativeBackend

        return TpuNativeBackend(config, device=device)
    from symmetry_tpu_torch.provider.backends.proxy import ProxyBackend

    return ProxyBackend(config)
