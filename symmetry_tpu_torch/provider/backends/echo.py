"""Echo backend: deterministic fake model for tests and protocol bring-up.

Streams the last user message back word-by-word as OpenAI-style SSE chunks —
the 'fake echo model' seam SURVEY §4 calls for, letting the full
client→server→provider path run with no TPU and no external server.

It participates in request tracing like a real engine would: each stream
records a backend span (with the request's trace id) into its own bounded
ring and contributes it to the provider's merged Perfetto export — so the
trace pipeline (client → provider → backend components, one reconciled
clock) is exercisable in CI with no TPU and no subprocess.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import AsyncIterator

from symmetry_tpu_torch.provider.backends.base import (
    InferenceBackend,
    InferenceRequest,
    StreamChunk,
)
from symmetry_tpu_torch.utils.trace import Tracer


class EchoBackend(InferenceBackend):
    name = "echo"
    # The echo is deterministic, so resumption is exact: the completion
    # IS the last user message, and a resume just skips the word-chunks
    # the client already holds — the protocol-level resume drill with no
    # TPU and no subprocess (chaos smoke, failover tests).
    supports_resume = True

    def __init__(self, delay_s: float = 0.0) -> None:
        self._delay = delay_s
        self.tracer = Tracer()

    async def trace_components(self) -> list[dict]:
        # Same process as the provider — offset 0 by construction.
        return [self.tracer.component("echo")]

    async def stream(self, request: InferenceRequest) -> AsyncIterator[StreamChunk]:
        t0 = time.monotonic()
        last_user = ""
        for m in reversed(request.messages):
            if m.get("role") == "user":
                last_user = m.get("content", "")
                break
        words = last_user.split(" ") or [""]
        # Resume: skip the chunks whose cumulative text the client
        # already received (one word ≈ one token here); yield only the
        # continuation. Skipping is by CHARACTER COUNT, trusting the
        # caller's resume_text to be the prefix it claims — a
        # wrong-content text of the same length yields the canonical
        # completion from that offset, not a splice onto the caller's
        # text (fine for the protocol drill this backend exists for).
        skip_chars = len(request.resume_text or "")
        emitted = 0
        n_words = 0
        for i, word in enumerate(words):
            token = word if i == 0 else " " + word
            if skip_chars >= len(token):
                skip_chars -= len(token)
                n_words += 1
                continue
            if skip_chars:
                # Resume boundary inside a chunk: yield only the unseen
                # tail — the client splices text, so replaying received
                # characters would duplicate them.
                token = token[skip_chars:]
                skip_chars = 0
            chunk = {
                "object": "chat.completion.chunk",
                "model": "echo",
                "choices": [{"index": 0, "delta": {"content": token}}],
            }
            yield StreamChunk(raw=f"data: {json.dumps(chunk)}", text=token,
                              tokens=1)
            emitted += 1
            if self._delay:
                await asyncio.sleep(self._delay)
        wall = time.monotonic() - t0
        self.tracer.record("echo_stream", t0, wall,
                           trace_id=request.trace_id, tokens=emitted,
                           resumed_from=n_words)
        # Minimal symledger costs block (source "estimated": no device
        # behind this backend — the stream wall stands in for decode
        # time) so the fleet wiring (costs on the final frame, provider
        # sym_request_* fold, goodput window) is exercisable without an
        # engine. Shape-compatible with engine/ledger.py costs().
        costs = {
            "device_s": {"decode": round(wall, 6)},
            "device_total_s": round(wall, 6),
            "queue_s": 0.0,
            "emit_s": 0.0,
            "wasted_s": {},
            "wasted_total_s": 0.0,
            "tokens": emitted,
            "source": "estimated",
            "finish": "stop",
        }
        yield StreamChunk(raw="data: [DONE]", text="", done=True,
                          costs=costs)
