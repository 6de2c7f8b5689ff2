"""symledger: per-request device-time attribution and waste accounting.

symprof (utils/devprof.py) prices device time per dispatch KIND; this
module prices it per REQUEST. The scheduler apportions every dispatch's
measured wall to the slots it served — prefill/chunk dispatches exactly
(each dispatch names its requests), decode/verify block syncs split by
active-slot occupancy — and each request accumulates:

  device_s{phase}   attributed device seconds per phase
                    (prefill / chunk / decode / verify / adopt)
  queue_s           scheduler queue wait (enqueue -> placement pick)
  emit_s            share of emit-path delivery wall (best effort: the
                    terminal flush itself lands after the entry closes)
  wasted_s{reason}  device seconds spent on output nobody consumed —
                    rejected speculative drafts (spec_rejected), tokens
                    a resume regenerated then deduped (resume_discarded),
                    deadline sheds (deadline_shed — zero device by
                    construction, booked so the class is visible),
                    killed-in-flight partial prefill (killed_prefill),
                    and a mid-decode cancel's final block share
                    (cancelled)
  saved_s           prefill seconds a radix hit avoided, priced at the
                    admitting dispatch's own per-token rate

Attribution source is flagged, never guessed: "probed" when symprof
sampling is armed (probe syncs make the dispatch walls device-true),
"blocked" otherwise (dispatch-thread block time — an upper bound that
includes host-side dispatch overhead). Echo backends stamp "estimated".

Threading: the engine thread opens/books/finishes entries, the emit
worker books emit shares, and the host pipe thread reads stats() — one
coarse lock, critical sections of a few dict ops. Disabled mode
(tpu.ledger=false) follows the METRICS/FAULTS overhead contract:
`track()` returns None, so every scheduler booking site is one
`is not None` branch and no entry is ever allocated.

Conservation is the correctness pin (tests/test_ledger.py): the sum of
per-request `device_s` plus the unattributed residue (blocks whose
every lane went stale before sync) equals the scheduler's own
admit/adopt/chunk/sync walls within 5% under mixed traffic.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any

PHASES = ("prefill", "chunk", "decode", "verify", "adopt")
WASTE_REASONS = ("spec_rejected", "resume_discarded", "deadline_shed",
                 "killed_prefill", "cancelled")


def _round_map(d: dict[str, float]) -> dict[str, float]:
    return {k: round(v, 6) for k, v in d.items() if v}


class LedgerEntry:
    """One request's open cost account. Handle protocol (the lifecycle
    checker's ledger-entry spec): acquired via `RequestLedger.track`,
    resolved by `finish()` (builds the wire costs block) or `release()`
    (folds into aggregates without one) — both idempotent, so every
    exit path may close unconditionally."""

    __slots__ = ("_ledger", "req_id", "device_s", "queue_s", "emit_s",
                 "wasted_s", "wasted_tokens", "saved_s", "saved_tokens",
                 "tokens", "closed")

    def __init__(self, ledger: "RequestLedger", req_id: str) -> None:
        self._ledger = ledger
        self.req_id = req_id
        self.device_s: dict[str, float] = {}
        self.queue_s = 0.0
        self.emit_s = 0.0
        self.wasted_s: dict[str, float] = {}
        self.wasted_tokens: dict[str, int] = {}
        self.saved_s = 0.0
        self.saved_tokens = 0
        self.tokens = 0
        self.closed = False

    # ------------------------------------------------------------- booking

    def book_queue(self, seconds: float) -> None:
        """Set (not add): a budget-deferred request re-picks and the
        latest pick is the true wait."""
        with self._ledger._lock:
            if not self.closed:
                self.queue_s = max(0.0, seconds)

    def book_device(self, phase: str, seconds: float,
                    tokens: int = 0) -> None:
        if seconds <= 0.0 and not tokens:
            return
        led = self._ledger
        with led._lock:
            if seconds > 0.0:
                led._total_device[phase] = (
                    led._total_device.get(phase, 0.0) + seconds)
            if not self.closed:
                if seconds > 0.0:
                    self.device_s[phase] = (
                        self.device_s.get(phase, 0.0) + seconds)
                self.tokens += tokens

    def book_saved_at_phase_rate(self, phase: str, suffix_tokens: int,
                                 reused_tokens: int) -> None:
        """Saved seconds priced at THIS entry's own per-token rate for
        `phase` — the chunked-prefill path, where the admitting rate is
        only known after the chunks have run."""
        led = self._ledger
        with led._lock:
            if self.closed or reused_tokens <= 0:
                return
            rate = self.device_s.get(phase, 0.0) / max(1, suffix_tokens)
            self.saved_s += rate * reused_tokens
            self.saved_tokens += reused_tokens

    def book_saved(self, seconds: float, tokens: int) -> None:
        with self._ledger._lock:
            if not self.closed:
                self.saved_s += max(0.0, seconds)
                self.saved_tokens += tokens

    def book_wasted(self, reason: str, seconds: float,
                    tokens: int = 0) -> None:
        with self._ledger._lock:
            if not self.closed:
                self.wasted_s[reason] = (
                    self.wasted_s.get(reason, 0.0) + max(0.0, seconds))
                self.wasted_tokens[reason] = (
                    self.wasted_tokens.get(reason, 0) + tokens)

    def waste_all_device(self, reason: str, tokens: int = 0) -> None:
        """Reclassify everything booked so far as waste (a cancel mid
        chunked-prefill: the whole prefix built so far served nobody)."""
        with self._ledger._lock:
            if not self.closed:
                spent = sum(self.device_s.values())
                self.wasted_s[reason] = (
                    self.wasted_s.get(reason, 0.0) + spent)
                self.wasted_tokens[reason] = (
                    self.wasted_tokens.get(reason, 0) + tokens)

    def book_emit(self, seconds: float) -> None:
        led = self._ledger
        with led._lock:
            led._total_emit += max(0.0, seconds)
            if not self.closed:
                self.emit_s += max(0.0, seconds)

    # ------------------------------------------------------------- closing

    def costs(self) -> dict[str, Any]:
        """The wire `costs` block (host event -> StreamChunk ->
        INFERENCE_ENDED). Caller holds no lock; values are snapshotted
        under it."""
        with self._ledger._lock:
            return self._costs_locked()

    def _costs_locked(self) -> dict[str, Any]:
        device = _round_map(self.device_s)
        out: dict[str, Any] = {
            "device_s": device,
            "device_total_s": round(sum(self.device_s.values()), 6),
            "queue_s": round(self.queue_s, 6),
            "emit_s": round(self.emit_s, 6),
            # No zero-filter: deadline_shed books 0.0 device seconds by
            # construction and the class must still reach the wire.
            "wasted_s": {k: round(v, 6) for k, v in self.wasted_s.items()},
            "wasted_total_s": round(sum(self.wasted_s.values()), 6),
            "tokens": self.tokens,
            "source": self._ledger.source,
        }
        if self.wasted_tokens:
            out["wasted_tokens"] = {
                k: v for k, v in self.wasted_tokens.items() if v}
        if self.saved_tokens or self.saved_s:
            out["saved_s"] = round(self.saved_s, 6)
            out["saved_tokens"] = self.saved_tokens
        return out

    def finish(self, reason: str, tokens: int | None = None
               ) -> dict[str, Any] | None:
        """Close the entry and return the costs block for the terminal
        event. Idempotent: a second close (any exit path racing another)
        returns None and books nothing twice."""
        led = self._ledger
        with led._lock:
            if self.closed:
                return None
            self.closed = True
            if tokens is not None:
                self.tokens = tokens
            block = self._costs_locked()
            block["finish"] = reason
            led._fold_locked(self, reason, block)
            return block

    def release(self, reason: str = "released") -> None:
        """Close without a terminal event (prefill-tier handoff: the
        decode tier owns the finish). Idempotent."""
        led = self._ledger
        with led._lock:
            if self.closed:
                return
            self.closed = True
            block = self._costs_locked()
            block["finish"] = reason
            led._fold_locked(self, reason, block)


class RequestLedger:
    """The scheduler's cost ledger: live entries while requests run, a
    bounded ring of finished cost blocks, and cumulative aggregates
    (per finish reason + per phase) for the host STATS rider."""

    def __init__(self, *, enabled: bool = True, ring: int = 128,
                 measured: bool = False) -> None:
        self.enabled = bool(enabled)
        self.source = "probed" if measured else "blocked"
        self._lock = threading.Lock()
        self._ring: deque[dict[str, Any]] = deque(maxlen=max(1, int(ring)))
        # Cumulative fleet totals: the conservation test's right-hand
        # side, and the aggregates the STATS rider ships. _total_device
        # includes an "unattributed" bucket for block syncs whose every
        # lane went stale before the sync landed.
        self._total_device: dict[str, float] = {}
        self._total_emit = 0.0
        self._total_wasted: dict[str, float] = {}
        self._total_wasted_tokens: dict[str, int] = {}
        self._total_saved_s = 0.0
        self._total_saved_tokens = 0
        self._total_tokens = 0
        self._live = 0
        self._finished = 0
        self._by_finish: dict[str, dict[str, float]] = {}

    # ------------------------------------------------------------- acquire

    def track(self, req_id: str) -> LedgerEntry | None:
        """Open a cost account; None while disabled (the one guarded
        branch every booking site then takes)."""
        if not self.enabled:
            return None
        entry = LedgerEntry(self, req_id)
        with self._lock:
            self._live += 1
        return entry

    def book_unattributed(self, seconds: float) -> None:
        """A block sync whose every snapshot lane was stale: real device
        wall, no live owner. Booked so conservation still closes."""
        if seconds <= 0.0:
            return
        with self._lock:
            self._total_device["unattributed"] = (
                self._total_device.get("unattributed", 0.0) + seconds)

    # -------------------------------------------------------------- folds

    def _fold_locked(self, entry: LedgerEntry, reason: str,
                     block: dict[str, Any]) -> None:
        self._live = max(0, self._live - 1)
        self._finished += 1
        for k, v in entry.wasted_s.items():
            self._total_wasted[k] = self._total_wasted.get(k, 0.0) + v
        for k, n in entry.wasted_tokens.items():
            self._total_wasted_tokens[k] = (
                self._total_wasted_tokens.get(k, 0) + n)
        self._total_saved_s += entry.saved_s
        self._total_saved_tokens += entry.saved_tokens
        self._total_tokens += entry.tokens
        agg = self._by_finish.setdefault(
            reason, {"requests": 0, "device_s": 0.0, "tokens": 0})
        agg["requests"] += 1
        agg["device_s"] += sum(entry.device_s.values())
        agg["tokens"] += entry.tokens
        if entry.req_id:
            block = dict(block)
            block["id"] = entry.req_id
        self._ring.append(block)

    # -------------------------------------------------------------- stats

    def device_total_s(self) -> float:
        with self._lock:
            return sum(self._total_device.values())

    def totals_brief(self) -> tuple[float, float]:
        """(attributed device seconds, wasted seconds), one lock hop —
        the scheduler's per-finish Perfetto counter stamps."""
        with self._lock:
            return (sum(self._total_device.values()),
                    sum(self._total_wasted.values()))

    def stats(self, ring_tail: int = 32) -> dict[str, Any]:
        """The host STATS `ledger` rider: bounded finished ring tail +
        cumulative aggregates. Never called on the hot loop."""
        with self._lock:
            total_dev = sum(self._total_device.values())
            total_waste = sum(self._total_wasted.values())
            out: dict[str, Any] = {
                "enabled": self.enabled,
                "source": self.source,
                "live": self._live,
                "finished": self._finished,
                "tokens": self._total_tokens,
                "device_s": _round_map(self._total_device),
                "device_total_s": round(total_dev, 6),
                "emit_s": round(self._total_emit, 6),
                # No zero-filter here: deadline_shed books 0.0 device
                # seconds by construction and the class must still show.
                "wasted_s": {k: round(v, 6)
                             for k, v in self._total_wasted.items()},
                "wasted_total_s": round(total_waste, 6),
                "wasted_tokens": dict(self._total_wasted_tokens),
                "wasted_share": (round(total_waste / total_dev, 4)
                                 if total_dev > 1e-12 else 0.0),
                "saved_s": round(self._total_saved_s, 6),
                "saved_tokens": self._total_saved_tokens,
                "by_finish": {
                    k: {"requests": int(v["requests"]),
                        "device_s": round(v["device_s"], 6),
                        "tokens": int(v["tokens"])}
                    for k, v in self._by_finish.items()},
                "ring": list(self._ring)[-max(0, int(ring_tail)):],
            }
            # Fleet goodput denominator precomputed for consumers that
            # only see the rider (symtop, bench): tokens per attributed
            # device second, all finish reasons included — the SLO cut
            # happens provider-side where attainment is known.
            if total_dev > 1e-12:
                out["tokens_per_device_s"] = round(
                    self._total_tokens / total_dev, 2)
            return out
