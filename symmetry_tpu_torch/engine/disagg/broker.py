"""Handoff broker: request-state migration between the two engine tiers.

The `tpu_native` backend in `tpu.role: disagg` mode runs TWO engine
hosts — a prefill host (admissions + chunked prefill only) and a decode
host (generation only). A request's life then spans three owners:

    provider submit ──▶ prefill host          (tokenize, build prefix KV)
                          │  {"op":"handoff"} (versioned frame, frames.py)
    broker ◀──────────────┘
      │  {"op":"adopt"}  (frame + the request state the decode
      ▼                   host needs: max_new, sampling, deadline …)
    decode host ──▶ token events ──▶ provider queues (unchanged path)

This module is the process-free middle: it remembers what was submitted
(so the adopt op can re-attach sampling/max_new/deadline to the frame
without the prefill host round-tripping them), rebases deadlines onto
the time already spent in the prefill tier, and accounts the handoff
itself (frames, bytes, prefix tokens shipped, per-request prefill-tier
latency) for the stats → provider stats → bench chain. The asyncio
plumbing — spawning the two hosts, pumping their pipes, supervising
their deaths — stays in the backend, which makes this class unit-
testable without a single subprocess.
"""

from __future__ import annotations

import copy
import time
from typing import Any

from symmetry_tpu_torch.protocol.keys import HostOp
from symmetry_tpu_torch.utils.metrics import METRICS, MetricName
from symmetry_tpu_torch.utils.trace import Histogram, Tracer

# The decode tier adopts handoff frames through its prefix store; a
# decode host configured without one could only ever full-prefill, which
# silently re-does the prefill tier's work. When the operator set no
# budget, the broker gives the decode tier this much (the working set is
# transient — entries churn through LRU the moment their request admits).
# This is only the config-level seed: the decode-role ENGINE raises its
# store budget to a geometry-derived floor (2 × largest-bucket entry
# bytes) at construction, so adoption of big-bucket prompts is never
# budget-rejected by a default too small for the model at hand.
DEFAULT_DECODE_PREFIX_MB = 64.0


def derive_role_config(base: dict[str, Any], role: str) -> dict[str, Any]:
    """The per-tier host config: the provider's config with `tpu.role`
    pinned to the tier and any `tpu.disagg.<role>` overrides applied.
    Override mapping keys land in the tpu section, except `faults`,
    which lands top-level (the host loads faults from there) — this is
    how a chaos test arms a seam in ONE tier of the pair."""
    if role not in ("prefill", "decode"):
        raise ValueError(f"derive_role_config: bad role {role!r}")
    cfg = copy.deepcopy(base)
    tpu = dict(cfg.get("tpu") or {})
    disagg = tpu.pop("disagg", None) or {}
    overrides = dict(disagg.get(role) or {})
    faults = overrides.pop("faults", None)
    tpu.update(overrides)
    tpu["role"] = role
    if role == "decode" and not tpu.get("prefix_cache_mb"):
        tpu["prefix_cache_mb"] = DEFAULT_DECODE_PREFIX_MB
    if role == "prefill" and not tpu.get("prefix_cache_mb"):
        # The prefill tier's radix cache is what session-affine pool
        # routing monetizes: turn N+1 of a conversation re-placed on
        # the member holding turn N's prefix KV skips that prefill
        # work entirely, and the cache summary it gossips is the
        # router's affinity signal. Same geometry constraints the
        # decode default already imposes (prefix_block divides every
        # bucket), so no config that ran disagg before can newly fail.
        tpu["prefix_cache_mb"] = DEFAULT_DECODE_PREFIX_MB
    if role == "prefill" and "pipeline_depth" not in overrides:
        # A prefill tier never decodes: there are no blocks to keep in
        # flight, so the emit worker would idle next to admission-only
        # traffic. Depth 1 keeps its emit path inline (override-able
        # per tier via tpu.disagg.prefill.pipeline_depth).
        tpu["pipeline_depth"] = 1
    cfg["tpu"] = tpu
    if faults:
        merged = dict(cfg.get("faults") or {})
        merged.update(faults)
        cfg["faults"] = merged
    return cfg


class HandoffBroker:
    """Pending-request state + handoff accounting for one host pair.

    Thread contract: all calls happen on the backend's event loop (the
    two pipe readers and stream() all live there), so no locking."""

    def __init__(self) -> None:
        # request id -> (submit fields the decode host will need,
        #               submit monotonic stamp,
        #               prefill member holding the migration — None for
        #               the pair, a pool member id in pool mode)
        self._pending: dict[str, tuple[dict[str, Any], float,
                                       str | None]] = {}
        # Per-DESTINATION ledger accounting (pool topology): blocks
        # covered / actually shipped per adopting member, so the smoke
        # and symtop can see that warm handoffs to a specific member
        # ship only tail blocks. Keyed by the member id adopt_op was
        # told; the fixed pair books under "decode".
        self.member_ledger: dict[str, dict[str, int]] = {}
        self.counters = {"submitted": 0, "handoff_frames": 0,
                         "handoff_bytes": 0, "prefix_tokens": 0,
                         "routing_only": 0, "dropped": 0,
                         # Block-manifest ledger (frames v2): blocks the
                         # manifests covered vs blocks whose payload
                         # actually rode the wire — manifest-only blocks
                         # were adopted by reference on the decode tier
                         # (the incremental-handoff savings).
                         "blocks": 0, "blocks_shipped": 0,
                         # Warm handoffs: frames that shipped strictly
                         # fewer blocks than their manifest covered —
                         # the destination already held the rest.
                         "warm_frames": 0,
                         # The WIRE leg of the handoff (serialize time
                         # lives host-side in handoff_stats): pipe hop
                         # for the local pair, chunked link transfer in
                         # network mode. Zero until a handoff carries a
                         # stamp or a precomputed wire_s.
                         "wire_frames": 0, "wire_bytes": 0,
                         "wire_s_total": 0.0}
        # Prefill-tier residence per request: provider submit → handoff
        # frame back at the broker. THE disagg latency number — what the
        # decode tier's TTFT no longer has to contain.
        self.prefill_tier_hist = Histogram()
        # Handoff wire latency per frame: emit stamp (prefill host pipe
        # write, or the link sender's transfer start) → frame back at
        # this broker. Emit stamps from the other tier's clock are
        # mapped through `prefill_clock_offset` — the host-pipe
        # handshake offset locally, the link handshake offset across
        # machines — so the split survives skewed clocks.
        self.wire_hist = Histogram()
        self.prefill_clock_offset = 0.0
        # The wire leg as SPANS too: one "handoff_wire" span per frame
        # (start = receipt − wire, stamps on this process's clock), so
        # the merged Perfetto timeline shows the handoff crossing the
        # pipe/link between the prefill tier's rows and the decode
        # tier's adopt_dispatch rows.
        self.tracer = Tracer()
        # Always-on registry series (utils/metrics.py, provider-process
        # registry): the handoff ledger as scrape-able families beside
        # the stats() snapshot.
        self._m_frames = METRICS.counter(
            MetricName.HANDOFF_FRAMES, "handoff frames migrated")
        self._m_bytes = METRICS.counter(
            MetricName.HANDOFF_BYTES, "handoff frame bytes migrated")
        self._m_pending = METRICS.gauge(
            MetricName.HANDOFF_PENDING,
            "requests submitted to the prefill tier, frame not yet back")
        self._m_wire = METRICS.histogram(
            MetricName.HANDOFF_WIRE, "handoff wire leg per frame")
        self._m_prefill_tier = METRICS.histogram(
            MetricName.HANDOFF_PREFILL_TIER,
            "prefill-tier residency per request (submit to frame back)")

    # ------------------------------------------------------------- state

    def note_submit(self, request_id: str,
                    submit: dict[str, Any]) -> None:
        """Remember the request state that must survive the migration.
        `submit` is the host-pipe submit op; only the decode-relevant
        fields are kept (messages stay behind — tokens ride the frame).
        The entry's member slot starts None (the fixed pair never sets
        it); the elastic pool writes it through reassign() once the
        placed submit is actually delivered."""
        keep = {k: submit[k] for k in
                ("max_new", "sampling", "speculative", "trace", "deadline_s",
                 "resume")
                if k in submit}
        self._pending[request_id] = (keep, time.monotonic(), None)
        self.counters["submitted"] += 1
        self._m_pending.set(len(self._pending))

    def reassign(self, request_id: str, member: str | None) -> None:
        """Re-placement: the migration moved to another member. The
        submit stamp is PRESERVED — deadline rebasing stays anchored to
        the provider submit, so churn never refunds a deadline."""
        entry = self._pending.get(request_id)
        if entry is not None:
            self._pending[request_id] = (entry[0], entry[1], member)

    def pending_on(self, member: str) -> list[str]:
        """Request ids whose migration is pending on ONE member
        (non-destructive — the re-placement path keeps the entries so
        the eventual handoff still finds its state). The member-down
        path unions this with the router's own view: the broker is
        authoritative for 'submitted but not yet adopted', so a
        migration the router lost track of still gets re-placed."""
        return [rid for rid, (_, _, m) in self._pending.items()
                if m == member]

    def forget(self, request_id: str) -> None:
        """The request ended on the prefill tier (tokenization error,
        admission error, deadline shed, cancel) — nothing to migrate."""
        if self._pending.pop(request_id, None) is not None:
            self.counters["dropped"] += 1
            self._m_pending.set(len(self._pending))

    def fail_all(self) -> None:
        """Host pair is going down: every pending migration is dead (the
        streams are failed by the backend's shed path)."""
        self.counters["dropped"] += len(self._pending)
        self._pending.clear()
        self._m_pending.set(0)

    def shed_pending(self) -> list[str]:
        """The handoff LINK died (network mode): every request whose
        migration was in flight is unrecoverable on this path — return
        their ids so the backend can shed each stream structured-
        retryable (the client fails over / retries through the
        reconnect window). Requests already adopted by the decode tier
        are untouched; they no longer need the prefill tier."""
        ids = list(self._pending)
        self.counters["dropped"] += len(ids)
        self._pending.clear()
        self._m_pending.set(0)
        return ids

    @property
    def pending(self) -> int:
        return len(self._pending)

    def is_pending(self, request_id: str) -> bool:
        """True while a submit awaits its handoff frame — lets callers
        route the adopting member BEFORE adopt_op pops the entry."""
        return request_id in self._pending

    # ------------------------------------------------------------ handoff

    def adopt_op(self, handoff: dict[str, Any],
                 member: str | None = None) -> dict[str, Any] | None:
        """One prefill-host `handoff` op → the decode-host `adopt` op,
        with the remembered request state re-attached and the deadline
        rebased by the prefill-tier time already spent. `member` is the
        adopting decode member (pool mode) — its per-member ledger
        books the blocks covered vs shipped. None when the request is
        unknown (already cancelled/failed — drop the frame, nobody is
        waiting)."""
        req_id = str(handoff.get("id", ""))
        entry = self._pending.pop(req_id, None)
        if entry is None:
            return None
        keep, t_submit, _member = entry
        now = time.monotonic()
        self.prefill_tier_hist.observe(now - t_submit)
        self._m_prefill_tier.observe(now - t_submit)
        self.counters["handoff_frames"] += 1
        nbytes = int(handoff.get("nbytes", 0))
        self.counters["handoff_bytes"] += nbytes
        self._m_frames.inc()
        self._m_bytes.inc(nbytes)
        self._m_pending.set(len(self._pending))
        # Wire-leg split: either precomputed by the link receiver
        # ("wire_s", network mode — it holds the measured link offset)
        # or derived here from the prefill host's emit stamp ("t")
        # mapped through the host-pipe clock offset (local pair).
        wire = handoff.get("wire_s")
        if wire is None and handoff.get("t") is not None:
            wire = max(now - (float(handoff["t"])
                              - self.prefill_clock_offset), 0.0)
        if wire is not None:
            wire = float(wire)
            self.wire_hist.observe(wire)
            self._m_wire.observe(wire)
            self.counters["wire_frames"] += 1
            self.counters["wire_bytes"] += nbytes
            self.counters["wire_s_total"] += wire
            if self.tracer.enabled:
                self.tracer.record("handoff_wire", now - wire, wire,
                                   request_id=req_id, bytes=nbytes)
        p = int(handoff.get("p", 0))
        self.counters["prefix_tokens"] += p
        blocks = int(handoff.get("blocks", 0))
        shipped = int(handoff.get("shipped", 0))
        self.counters["blocks"] += blocks
        self.counters["blocks_shipped"] += shipped
        if blocks and shipped < blocks:
            self.counters["warm_frames"] += 1
        led = self.member_ledger.setdefault(
            member or "decode",
            {"frames": 0, "bytes": 0, "blocks": 0, "blocks_shipped": 0,
             "warm_frames": 0})
        led["frames"] += 1
        led["bytes"] += nbytes
        led["blocks"] += blocks
        led["blocks_shipped"] += shipped
        if blocks and shipped < blocks:
            led["warm_frames"] += 1
        if p == 0:
            self.counters["routing_only"] += 1
        op: dict[str, Any] = {"op": HostOp.ADOPT, "id": req_id,
                              "frame": handoff.get("frame")}
        for k in ("max_new", "sampling", "speculative", "trace", "resume"):
            # "resume" rides through so the decode tier restores the
            # RNG lane and token budget of a resumed request (the
            # emitted tokens themselves already ride the frame — the
            # prefill tier appended them to the prompt).
            if k in keep:
                op[k] = keep[k]
        if "deadline_s" in keep:
            # The deadline was RELATIVE at provider submit; the prefill
            # tier consumed part of it. Rebase so the decode host's
            # admission shed still fires at the original wall deadline.
            op["deadline_s"] = float(keep["deadline_s"]) - (now - t_submit)
        return op

    # -------------------------------------------------------------- stats

    def stats(self) -> dict[str, Any]:
        out: dict[str, Any] = dict(self.counters)
        out["wire_s_total"] = round(out["wire_s_total"], 4)
        out["pending"] = len(self._pending)
        out["prefill_tier_s"] = self.prefill_tier_hist.to_dict()
        out["wire_s"] = self.wire_hist.to_dict()
        if self.member_ledger:
            out["per_member"] = {m: dict(v)
                                 for m, v in sorted(
                                     self.member_ledger.items())}
        return out
