"""Elastic disaggregated pools: M-prefill × N-decode membership + placement.

The local pair is ONE prefill × ONE decode host; a pair makes each tier a
single point of failure — one node death sheds every in-flight migration
and the whole unit respawns. DistServe and Splitwise (PAPERS.md) both
show the production win is phase-specific POOLS: independently sized
tiers where a dead node is a capacity event, not an outage. This module
is the membership/placement brain of that generalization:

    clients ──▶ tpu_native backend (provider process)
                    │ PoolRouter.place()            least-loaded healthy
                    ▼                               prefill member
    prefill-0  prefill-1 … prefill-M-1    (PrefillNode each, own machine
      │ handoff frames over per-member     or inline; per-member
      ▼ DecodeLinks                        DecodeLink + supervision)
    PoolRouter.route_decode()             decode member by queue-depth /
      │                                    burn-rate gauges
      ▼
    decode-0   decode-1 … decode-N-1      (local engine hosts, each its
                                           own supervision domain)

The router is deliberately PURE STATE — no asyncio, no sockets, no
subprocesses. The backend owns the plumbing (links, host pipes, respawn
loops) and drives the router through a narrow verb set, which is what
makes every membership/placement rule unit-testable in microseconds:

  add_member / mark_joining / mark_healthy    join + hot-join/rejoin
  drain(member) -> bool                       no NEW placements; in-flight
                                              finishes (deliberate drain).
                                              REFUSED for the last
                                              placeable member of a tier —
                                              nothing may scale a tier to 0
  retire(member) -> bool                      scaled-down member leaves the
                                              registry for good (the
                                              autoscaler's drain-before-
                                              kill terminal); refused while
                                              in-flight work remains;
                                              chip-seconds are banked
  on_lost(member) -> [request ids]            node death / link loss: the
                                              in-flight work to RE-PLACE
                                              on a survivor (never failed
                                              outright; only when no
                                              survivor exists does the
                                              caller shed retryable)
  place(request) / route_decode(request)      placement decisions
  update_gauges(member, queue_depth, …)       telemetry feed (the SLO
                                              gauges as the control
                                              signal)

Placement policy: cache-aware least-loaded — each member's base score
is its live in-flight count plus its last-reported queue-depth gauge,
MINUS the predicted radix-cache hit (in blocks) for this request on
that member, weighted by `tpu.pool_affinity_weight` and decayed by the
age of the member's last gossiped cache summary (SGLang's cache-aware
load balancing, PAPERS.md). Burn rate is the tie-break (scale AWAY
from the tier burning SLO budget), then lifetime placements
(round-robin among idle equals). The affinity term degrades, never
wedges: no request digests, no gossiped summary, a stale summary, or
gauges older than two heartbeat periods (a member that stopped
reporting) all collapse the score to pure load — exactly the pre-PR-17
policy. A pool of one degenerates exactly to the pair: the single
member takes every placement while healthy, and its loss leaves
nothing to re-place onto — the caller sheds structured-retryable, the
pair's behavior.

Membership states (one-way transitions except rejoin):

    joining ──▶ healthy ──▶ draining ──▶ lost
                   ▲  └──────────────────▶ lost
                   └── hot-(re)join ◀──────┘

All state changes land in the always-on metrics registry
(utils/metrics.py) so symtop and any Prometheus scrape see the pool:
member counts, per-node state, per-node placements, re-placements and
drains — churn is accounted, never silent.
"""

from __future__ import annotations

import time
from typing import Any

from symmetry_tpu_torch.utils.metrics import METRICS, MetricName

PREFILL = "prefill"
DECODE = "decode"


class MemberState:
    """Pool-membership lifecycle states (wire-visible in stats/symtop)."""

    JOINING = "joining"    # link up / spawn started, not yet serving
    HEALTHY = "healthy"    # taking placements
    DRAINING = "draining"  # no new placements; in-flight finishes
    LOST = "lost"          # node death / link loss / left — capacity gone


# Gauge encoding for sym_pool_member_state (symtop decodes it back).
STATE_CODES = {MemberState.JOINING: 0, MemberState.HEALTHY: 1,
               MemberState.DRAINING: 2, MemberState.LOST: 3}


class PoolConfig:
    """The `tpu.disagg.pool` mapping. Present ⇒ pool mode; absent ⇒ the
    backend keeps the pair semantics untouched.

    Keys:
      prefill     int M (inline/self-addressed members) or a list of
                  peer addresses to dial (one member per address)
      decode      int N — local decode engine hosts (default 1)
      heartbeat_s link keepalive period (ping/pong; 0 disables); also
                  the decode-member stats-probe/gauge-refresh period
    """

    def __init__(self, disagg: dict[str, Any] | None) -> None:
        d = (disagg or {}).get("pool") or {}
        self.enabled: bool = bool(d)
        prefill = d.get("prefill", 1)
        if isinstance(prefill, (list, tuple)):
            self.prefill_peers: list[str] | None = [str(p) for p in prefill]
            self.prefill_count: int = len(self.prefill_peers)
        else:
            self.prefill_peers = None
            self.prefill_count = max(int(prefill), 1)
        self.decode_count: int = max(int(d.get("decode", 1)), 1)
        self.heartbeat_s: float = float(d.get("heartbeat_s", 5.0))


class PoolMember:
    """One tier member's membership + load state (router-owned)."""

    __slots__ = ("member_id", "tier", "state", "in_flight", "placements",
                 "queue_depth", "burn_rate", "node_id", "joined_at",
                 "state_since", "losses", "restarts", "summary",
                 "summary_at", "gauges_at", "hit_blocks", "alive_since",
                 "chip_s")

    def __init__(self, member_id: str, tier: str) -> None:
        self.member_id = member_id
        self.tier = tier
        self.state = MemberState.JOINING
        self.in_flight: set[str] = set()   # request ids placed/adopted here
        self.placements = 0                # lifetime placements
        self.queue_depth = 0.0             # last gauge feed
        self.burn_rate = 0.0
        self.node_id: str | None = None    # peer-announced identity
        self.joined_at = time.monotonic()
        self.state_since = self.joined_at
        self.losses = 0                    # times this member went lost
        self.restarts = 0                  # per-member respawns (decode)
        # Cache-affinity state: the member's last gossiped radix-cache
        # summary (digest set), when it arrived, when the load gauges
        # last arrived (None = never — a member that stopped gossiping
        # must fall out of affinity scoring, not coast on stale data),
        # and the lifetime predicted-hit blocks banked by placements.
        self.summary: frozenset[str] | None = None
        self.summary_at: float | None = None
        self.gauges_at: float | None = None
        self.hit_blocks = 0
        # Chip-second accounting (the autoscaler's goodput denominator):
        # `chip_s` accumulates completed alive intervals; `alive_since`
        # is the open interval's start (router clock), None while lost.
        # The router stamps these — the member never reads a clock.
        self.alive_since: float | None = None
        self.chip_s = 0.0

    @property
    def placeable(self) -> bool:
        return self.state == MemberState.HEALTHY

    def score(self) -> tuple:
        """Lower places first: live load + reported backlog, SLO burn as
        the tie-break, lifetime placements as round-robin among idle
        equals, member id for determinism."""
        return (len(self.in_flight) + self.queue_depth, self.burn_rate,
                self.placements, self.member_id)

    def to_dict(self) -> dict[str, Any]:
        return {"tier": self.tier, "state": self.state,
                "node": self.node_id, "in_flight": len(self.in_flight),
                "placements": self.placements,
                "queue_depth": self.queue_depth,
                "burn_rate": round(self.burn_rate, 4),
                "losses": self.losses, "restarts": self.restarts,
                "hit_blocks": self.hit_blocks,
                "summary_digests": (len(self.summary)
                                    if self.summary is not None else 0),
                "state_age_s": round(
                    time.monotonic() - self.state_since, 3)}


class PoolRouter:
    """Membership registry + placement for one elastic disagg pool.

    Thread contract: all calls happen on the backend's event loop (the
    link callbacks, the readers, and stream() all live there) — same
    no-locking contract as the broker."""

    def __init__(self, *, heartbeat_s: float = 5.0,
                 affinity_weight: float = 1.0,
                 clock=time.monotonic) -> None:
        # Affinity knobs: heartbeat_s sets the staleness clock for the
        # gossiped summaries AND the gauge-age cutoff (2 periods);
        # affinity_weight scales predicted-hit blocks against load
        # (queue slots) — 0 turns cache-aware placement off entirely.
        # `clock` is injectable so staleness decay is test-drivable.
        self.heartbeat_s = max(float(heartbeat_s), 0.001)
        self.affinity_weight = max(float(affinity_weight), 0.0)
        self._clock = clock
        self._members: dict[str, PoolMember] = {}
        # request id -> member id, per tier (a request is assigned to at
        # most one prefill member pre-handoff, one decode member after).
        self._assigned: dict[str, str] = {}
        self._adopted: dict[str, str] = {}
        # request id -> decode member chosen AT SUBMIT TIME (so the
        # prefill tier can key its shipped-block ledger by the member
        # the handoff will actually reach); consumed by route_decode.
        self._planned: dict[str, str] = {}
        # Per-member ledger epoch: bumped every time the member goes
        # lost. The prefill tier tags ledger entries with the epoch it
        # was told at submit; a bumped epoch invalidates every entry
        # (the respawned member's cache is empty — skipping blocks it
        # no longer holds would corrupt adoption).
        self._ledger_epoch: dict[str, int] = {}
        self.counters = {"placements": 0, "re_placements": 0,
                         "drains": 0, "drain_refused": 0, "retires": 0,
                         "losses": 0, "joins": 0,
                         "rejoins": 0, "affinity_hit": 0,
                         "affinity_cold": 0, "affinity_load_only": 0}
        # Chip-seconds already banked by members retired out of the
        # registry (scale-down) — live members' alive time stays on the
        # member until then. chip_seconds() sums both.
        self._chip_s_retired = 0.0
        self._m_members = METRICS.gauge(
            MetricName.POOL_MEMBERS, "pool members known (any state)",
            labels=("tier",))
        self._m_healthy = METRICS.gauge(
            MetricName.POOL_HEALTHY, "pool members taking placements",
            labels=("tier",))
        self._m_state = METRICS.gauge(
            MetricName.POOL_MEMBER_STATE,
            "per-member state (0 joining, 1 healthy, 2 draining, 3 lost)",
            labels=("tier", "node"))
        self._m_placements = METRICS.counter(
            MetricName.POOL_PLACEMENTS, "requests placed on a member",
            labels=("tier", "node"))
        self._m_replacements = METRICS.counter(
            MetricName.POOL_REPLACEMENTS,
            "in-flight requests re-placed off a lost/drained member")
        self._m_drains = METRICS.counter(
            MetricName.POOL_DRAINS, "members drained (deliberate)")
        self._m_predicted_hit = METRICS.counter(
            MetricName.POOL_PREDICTED_HIT,
            "predicted radix-hit blocks banked by affinity placements",
            labels=("tier", "node"))
        self._m_affinity = METRICS.counter(
            MetricName.POOL_AFFINITY_PLACEMENTS,
            "placements by affinity outcome (hit/cold/load_only)",
            labels=("outcome",))
        self._m_gossip_age = METRICS.gauge(
            MetricName.POOL_GOSSIP_AGE,
            "age of a member's last gossiped cache summary",
            labels=("tier", "node"))

    # --------------------------------------------------------- membership

    def members(self, tier: str | None = None) -> list[PoolMember]:
        return [m for m in self._members.values()
                if tier is None or m.tier == tier]

    def get(self, member_id: str) -> PoolMember | None:
        return self._members.get(member_id)

    def add_member(self, member_id: str, tier: str,
                   node_id: str | None = None) -> PoolMember:
        if tier not in (PREFILL, DECODE):
            raise ValueError(f"pool member tier must be prefill|decode, "
                             f"got {tier!r}")
        m = self._members.get(member_id)
        if m is None:
            m = PoolMember(member_id, tier)
            m.alive_since = self._clock()
            self._members[member_id] = m
        if node_id:
            m.node_id = node_id
        self._refresh_gauges(m)
        return m

    def _set_state(self, m: PoolMember, state: str) -> None:
        if m.state != state:
            # Chip-seconds tick only while the member is not lost: close
            # the open alive interval on the way INTO lost, open a new
            # one on the way out (rejoin). Joining/draining still count —
            # a spawning or draining member occupies its chip.
            now = self._clock()
            if state == MemberState.LOST and m.alive_since is not None:
                m.chip_s += max(now - m.alive_since, 0.0)
                m.alive_since = None
            elif m.state == MemberState.LOST and m.alive_since is None:
                m.alive_since = now
            m.state = state
            m.state_since = time.monotonic()
        self._refresh_gauges(m)

    def mark_joining(self, member_id: str) -> None:
        m = self._members[member_id]
        self._set_state(m, MemberState.JOINING)

    def mark_healthy(self, member_id: str,
                     node_id: str | None = None) -> None:
        """Member is serving: first join, hot-join, or rejoin after a
        loss — churn in, not a special case."""
        m = self._members[member_id]
        if node_id:
            m.node_id = node_id
        if m.state == MemberState.LOST:
            self.counters["rejoins"] += 1
            # A rejoined member is a NEW process with an empty cache and
            # no load history. Pre-PR-17 the router kept trusting the
            # pre-loss gauges forever; now everything resets and the
            # member is load-only (gauges_at None) until its first fresh
            # heartbeat stamps it back into affinity scoring.
            m.queue_depth = 0.0
            m.burn_rate = 0.0
            m.gauges_at = None
            m.summary = None
            m.summary_at = None
        elif m.state == MemberState.JOINING:
            self.counters["joins"] += 1
        self._set_state(m, MemberState.HEALTHY)

    def drain(self, member_id: str) -> bool:
        """Deliberate drain: excluded from NEW placements immediately;
        whatever is in flight finishes (or is re-placed by on_lost if
        the node dies mid-drain). REFUSED (returns False) when this is
        the LAST placeable member of its tier — a drain there is a
        self-inflicted outage, and the autoscaler (or an operator) must
        never be able to scale a tier to zero; the caller retries after
        a replacement joins. Returns True when the member is draining
        (including when it already was)."""
        m = self._members[member_id]
        if m.state in (MemberState.DRAINING, MemberState.LOST):
            return True
        if m.placeable and self.healthy_count(m.tier) <= 1:
            self.counters["drain_refused"] += 1
            return False
        self.counters["drains"] += 1
        self._m_drains.inc()
        self._set_state(m, MemberState.DRAINING)
        return True

    def on_lost(self, member_id: str) -> list[str]:
        """Node death / link loss / leave: capacity is gone NOW. Returns
        the request ids that were in flight there — the caller re-places
        each on a survivor (or sheds structured-retryable when none
        exists). Idempotent: a second loss signal returns []."""
        m = self._members.get(member_id)
        if m is None:
            return []
        if m.state != MemberState.LOST:
            m.losses += 1
            self.counters["losses"] += 1
            # Its cache died with it: invalidate the gossiped summary
            # (no more affinity pulls toward a cold respawn) and bump
            # the ledger epoch so the prefill tier drops every
            # shipped-block entry keyed to this member.
            m.summary = None
            m.summary_at = None
            m.gauges_at = None
            self._ledger_epoch[member_id] = (
                self._ledger_epoch.get(member_id, 0) + 1)
        self._set_state(m, MemberState.LOST)
        ids = sorted(m.in_flight)
        m.in_flight.clear()
        for req_id in ids:
            if self._assigned.get(req_id) == member_id:
                self._assigned.pop(req_id, None)
            if self._adopted.get(req_id) == member_id:
                self._adopted.pop(req_id, None)
            if self._planned.get(req_id) == member_id:
                self._planned.pop(req_id, None)
        return ids

    def retire(self, member_id: str) -> bool:
        """Remove a scaled-down member from the registry for good —
        the terminal verb of a deliberate drain (the autoscaler's
        drain-before-kill path), NOT of a loss: a lost member stays
        registered so a rejoin finds its slot. Refused (False) while
        the member still has in-flight work — retire only after the
        drain ran dry. Banks the member's chip-seconds into the
        retired total so the goodput denominator never loses the time
        a scaled-away member burned."""
        m = self._members.get(member_id)
        if m is None:
            return True
        if m.in_flight:
            return False
        now = self._clock()
        self._chip_s_retired += m.chip_s + (
            max(now - m.alive_since, 0.0)
            if m.alive_since is not None else 0.0)
        self.counters["retires"] += 1
        del self._members[member_id]
        self._ledger_epoch.pop(member_id, None)
        # Drop the per-member state series (a gauge for a retired
        # member would export its last state forever) and recompute the
        # tier counts it was part of.
        self._m_state.remove(tier=m.tier, node=m.member_id)
        for tier in (PREFILL, DECODE):
            members = self.members(tier)
            self._m_members.set(len(members), tier=tier)
            self._m_healthy.set(
                sum(1 for x in members if x.placeable), tier=tier)
        return True

    def member_chip_s(self, m: PoolMember) -> float:
        """One member's chip-seconds so far: banked intervals plus the
        open alive interval (router clock)."""
        live = (max(self._clock() - m.alive_since, 0.0)
                if m.alive_since is not None else 0.0)
        return m.chip_s + live

    def chip_seconds(self) -> float:
        """Σ member-alive time across the pool's whole history —
        retired members included. The denominator of SLO-goodput
        (tokens per chip-second): scaling up buys capacity at the cost
        of a faster-growing denominator, which is exactly the trade the
        autoscaler is scored on."""
        return self._chip_s_retired + sum(
            self.member_chip_s(m) for m in self._members.values())

    def ledger_epoch(self, member_id: str) -> int:
        """Current shipped-block-ledger epoch for a member (0 until its
        first loss). Rides each submit so the prefill host can detect a
        member respawn and drop that member's ledger."""
        return self._ledger_epoch.get(member_id, 0)

    # --------------------------------------------------------- placement

    def predicted_hit(self, m: PoolMember,
                      digests: list[str] | None) -> int:
        """Predicted radix-cache hit depth (blocks) for a request with
        these causal block digests on this member: the longest
        CONTIGUOUS leading run of the request's digests present in the
        member's gossiped summary. Contiguous because the radix tree
        can only serve a prefix — digest k without digests 0..k-1 is
        unreachable KV. 0 whenever the signal is unusable: no digests,
        no summary, or gauges older than two heartbeat periods (the
        member stopped reporting; its summary describes a past life)."""
        if (not digests or m.summary is None
                or not self._gauges_fresh(m)):
            return 0
        hit = 0
        for d in digests:
            if d not in m.summary:
                break
            hit += 1
        return hit

    def _gauges_fresh(self, m: PoolMember) -> bool:
        return (m.gauges_at is not None
                and self._clock() - m.gauges_at
                <= 2.0 * self.heartbeat_s)

    def _summary_decay(self, m: PoolMember) -> float:
        """Staleness decay on the gossiped summary: halves every two
        heartbeat periods, so a member that keeps gossiping scores near
        full weight and one whose summary is aging fades smoothly out
        of affinity instead of flapping."""
        if m.summary_at is None:
            return 0.0
        age = max(self._clock() - m.summary_at, 0.0)
        return 0.5 ** (age / (2.0 * self.heartbeat_s))

    def _pick(self, tier: str,
              exclude: set[str] | frozenset = frozenset(),
              digests: list[str] | None = None
              ) -> tuple[PoolMember | None, int]:
        """Best placeable member of `tier` and its predicted-hit depth
        (blocks). Score = load − affinity_weight × decay × hit, so one
        decayed hit block outbids one queue slot at weight 1 — then the
        original burn/placements/id tie-break. With no usable affinity
        signal every hit term is 0 and this IS the pre-PR-17 policy."""
        live = [m for m in self._members.values()
                if m.tier == tier and m.placeable
                and m.member_id not in exclude]
        if not live:
            return None, 0
        use_affinity = bool(digests) and self.affinity_weight > 0.0
        # Outstanding decode plans are load the member WILL carry (the
        # handoff lands there) — without them every concurrent submit
        # would plan the same idle member by id tie-break.
        planned: dict[str, int] = {}
        for mid in self._planned.values():
            planned[mid] = planned.get(mid, 0) + 1
        best: PoolMember | None = None
        best_key: tuple | None = None
        best_hit = 0
        for m in live:
            hit = self.predicted_hit(m, digests) if use_affinity else 0
            key = (len(m.in_flight) + m.queue_depth
                   + planned.get(m.member_id, 0)
                   - self.affinity_weight * self._summary_decay(m) * hit,
                   m.burn_rate, m.placements, m.member_id)
            if best_key is None or key < best_key:
                best, best_key, best_hit = m, key, hit
        return best, best_hit

    def _book_affinity(self, m: PoolMember, tier: str, hit: int,
                       digests: list[str] | None) -> None:
        """Account one placement's affinity outcome: `hit` (the summary
        predicted cached blocks on the winner), `cold` (a signal
        existed but predicted nothing — e.g. turn 1, or the warm member
        died), `load_only` (no usable signal at all)."""
        if not digests or self.affinity_weight <= 0.0:
            outcome = "load_only"
        elif hit > 0:
            outcome = "hit"
            m.hit_blocks += hit
            self._m_predicted_hit.inc(hit, tier=tier, node=m.member_id)
        else:
            outcome = "cold"
        self.counters[f"affinity_{outcome}"] = (
            self.counters.get(f"affinity_{outcome}", 0) + 1)
        self._m_affinity.inc(outcome=outcome)

    def place(self, request_id: str, *,
              digests: list[str] | None = None,
              exclude: set[str] | frozenset = frozenset()) -> str | None:
        """Best healthy PREFILL member for one request — cache-affine
        when `digests` (the request's causal block digests) are given,
        least-loaded otherwise; None when no member is placeable
        (caller sheds retryable). ASSIGNS only — the caller confirms
        with record_placement() once the submit actually reached the
        member, so a refused send (walked past via `exclude` +
        release()) never inflates the ledger or skews the round-robin
        tie-break."""
        m, hit = self._pick(PREFILL, exclude, digests)
        if m is None:
            return None
        self._book_affinity(m, PREFILL, hit, digests)
        old = self._assigned.get(request_id)
        if old is not None and old != m.member_id:
            prev = self._members.get(old)
            if prev is not None:
                prev.in_flight.discard(request_id)
        self._assigned[request_id] = m.member_id
        m.in_flight.add(request_id)
        self._refresh_gauges(m)
        return m.member_id

    def plan_decode(self, request_id: str,
                    digests: list[str] | None = None) -> str | None:
        """Choose (but do not yet book) the decode member this request's
        handoff should land on — cache-affine against the DECODE tier's
        gossiped summaries. Called at submit time so the prefill host
        can key its shipped-block ledger by the actual destination;
        route_decode() consumes the plan when the handoff arrives (and
        re-picks if that member died in between). None when no decode
        member is placeable (single-decode pools always plan the one)."""
        m, _hit = self._pick(DECODE, frozenset(), digests)
        if m is None:
            self._planned.pop(request_id, None)
            return None
        self._planned[request_id] = m.member_id
        return m.member_id

    def planned_decode(self, request_id: str) -> str | None:
        return self._planned.get(request_id)

    def record_placement(self, request_id: str, *,
                         replacement: bool = False) -> None:
        """The placed submit reached its member: book the placement
        (and the re-placement, when this was churn recovery) in the
        counters, the per-node metric, and the tie-break state."""
        member_id = self._assigned.get(request_id)
        m = self._members.get(member_id) if member_id else None
        if m is None:
            return
        m.placements += 1
        self.counters["placements"] += 1
        self._m_placements.inc(tier=PREFILL, node=m.member_id)
        if replacement:
            self.counters["re_placements"] += 1
            self._m_replacements.inc()

    def route_decode(self, request_id: str, *,
                     prefer: str | None = None) -> str | None:
        """DECODE member for one handed-off request; releases the
        prefill assignment (the migration left that tier). Prefers the
        member planned at submit time (`prefer` or the stored plan) —
        the one the shipped-block ledger was keyed against — falling
        back to the gauge-scored pick when that member is no longer
        placeable. None when no decode member is placeable."""
        self._release_assigned(request_id)
        planned = self._planned.pop(request_id, None)
        prefer = prefer or planned
        m: PoolMember | None = None
        if prefer is not None:
            cand = self._members.get(prefer)
            if cand is not None and cand.tier == DECODE and cand.placeable:
                m = cand
        if m is None:
            m, _hit = self._pick(DECODE)
        if m is None:
            return None
        self._adopted[request_id] = m.member_id
        m.in_flight.add(request_id)
        m.placements += 1
        self.counters["placements"] += 1
        self._m_placements.inc(tier=DECODE, node=m.member_id)
        self._refresh_gauges(m)
        return m.member_id

    def assigned_to(self, request_id: str) -> str | None:
        return self._assigned.get(request_id)

    def adopted_on(self, request_id: str) -> str | None:
        return self._adopted.get(request_id)

    def release(self, request_id: str) -> None:
        """Undo a placement that never reached the member (send
        failed): the assignment is dropped without counting a loss."""
        self._release_assigned(request_id)

    def _release_assigned(self, request_id: str) -> None:
        member_id = self._assigned.pop(request_id, None)
        if member_id is not None:
            m = self._members.get(member_id)
            if m is not None:
                m.in_flight.discard(request_id)
                self._refresh_gauges(m)

    def note_done(self, request_id: str) -> None:
        """Request ended (any outcome): release whatever it held."""
        self._release_assigned(request_id)
        self._planned.pop(request_id, None)
        member_id = self._adopted.pop(request_id, None)
        if member_id is not None:
            m = self._members.get(member_id)
            if m is not None:
                m.in_flight.discard(request_id)
                self._refresh_gauges(m)

    # ---------------------------------------------------------- telemetry

    def update_gauges(self, member_id: str, *,
                      queue_depth: float | None = None,
                      burn_rate: float | None = None) -> None:
        """Feed one member's load gauges (scheduler queue depth off its
        stats probe; SLO burn rate from the provider's monitor) — the
        placement signal beyond the router's own in-flight counts.
        Stamps the gauge age: a member whose stamp falls more than two
        heartbeat periods behind drops out of affinity scoring (its
        summary describes a cache we can no longer see)."""
        m = self._members.get(member_id)
        if m is None:
            return
        if queue_depth is not None:
            m.queue_depth = max(float(queue_depth), 0.0)
        if burn_rate is not None:
            m.burn_rate = max(float(burn_rate), 0.0)
        m.gauges_at = self._clock()
        if m.summary_at is not None:
            self._m_gossip_age.set(
                round(max(self._clock() - m.summary_at, 0.0), 3),
                tier=m.tier, node=m.member_id)

    def update_summary(self, member_id: str,
                       summary: dict[str, Any] | None) -> None:
        """Feed one member's gossiped radix-cache summary (the stats
        rider harvested off its heartbeat probe). None means the member
        answered without a summary (cache disabled, empty, or an old
        binary) — keep the previous one aging out via decay rather than
        flapping the affinity signal on every empty beat."""
        m = self._members.get(member_id)
        if m is None or summary is None:
            return
        digests = summary.get("digests")
        if not isinstance(digests, (list, tuple)) or not digests:
            return
        m.summary = frozenset(str(d) for d in digests)
        m.summary_at = self._clock()
        self._m_gossip_age.set(0.0, tier=m.tier, node=m.member_id)

    def _refresh_gauges(self, m: PoolMember) -> None:
        self._m_state.set(STATE_CODES[m.state], tier=m.tier,
                          node=m.member_id)
        for tier in (PREFILL, DECODE):
            members = self.members(tier)
            self._m_members.set(len(members), tier=tier)
            self._m_healthy.set(
                sum(1 for x in members if x.placeable), tier=tier)

    # -------------------------------------------------------------- stats

    def healthy_count(self, tier: str) -> int:
        return sum(1 for m in self.members(tier) if m.placeable)

    def stats(self) -> dict[str, Any]:
        members = {}
        for mid, m in sorted(self._members.items()):
            d = m.to_dict()
            d["chip_s"] = round(self.member_chip_s(m), 3)
            members[mid] = d
        return {
            **self.counters,
            "members": members,
            "healthy": {PREFILL: self.healthy_count(PREFILL),
                        DECODE: self.healthy_count(DECODE)},
            "in_flight": {PREFILL: len(self._assigned),
                          DECODE: len(self._adopted)},
            "ledger_epochs": dict(sorted(self._ledger_epoch.items())),
            "chip_seconds": round(self.chip_seconds(), 3),
        }
