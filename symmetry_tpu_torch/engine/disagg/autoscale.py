"""symscale: the SLO-goodput autoscaler closing telemetry → topology.

Every piece existed before this module and nothing connected them: the
pools have their actuators (join / drain / leave, per-member
respawn), the SLO monitor its burn rates and queue gauges, devprof
symprof's measured device-seconds per tier — yet the M×N tier shape
stayed a hand-picked constant. This module is the controller in the
middle, shaped after DistServe's goodput objective and Splitwise's
phase-pool sizing (PAPERS.md): maximize SLO-attaining tokens per
chip-second, where chip-seconds = Σ member-alive time.

    SloMonitor.burn_rates() ──ttft──────────▶ prefill pressure
                            ──inter_chunk──▶ decode pressure
    PoolRouter gauges ──in-flight + queue_depth──▶ per-tier load
    symprof device_s_total ──per-tier busy deltas─▶ measured M:N ratio
                                │
                                ▼  PoolAutoscaler.tick()  (one per pool
                                │  heartbeat; pure state, injectable
                                │  clock — unit-testable in µs)
                                ▼
    {spawn prefill | spawn decode | drain idlest | rebalance | hold}
                                │
                                ▼  tpu_native member factory (real
                                   _DecodeMember / PrefillNode
                                   lifecycle events)

The controller is PURE STATE like PoolRouter: it never spawns, drains,
sleeps, or reads a wall clock it wasn't given. The backend feeds it one
sensor snapshot per pool heartbeat and applies whatever single decision
comes back. Stability is structural, not tuned:

  dwell     a minimum quiet period between topology changes — the
            system must settle before the sensors mean anything again
  cooldown  after churn (a member died and the supervisor respawned
            it), scaling pauses entirely: respawn turbulence looks
            exactly like a load spike, and reacting to it would flap.
            Churn respawns are NOT scaling decisions and never count
            as one.
  floor     1×1 — the drain path refuses the last placeable member of
            a tier (PoolRouter.drain refuses it independently: two
            locks on the same door)
  ceiling   `tpu.autoscale.max_members` per tier

Every tick books a structured decision record — action, reason, the
full input snapshot, and goodput-at-decision — into a bounded ring
(flight-recorder-visible through engine stats) and the
`sym_autoscale_*` metric families. Only real topology changes increment
the decision counter: symtop's SCALE column means "the shape moved",
not "the controller woke up".
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable

from symmetry_tpu_torch.engine.disagg.pool import (
    DECODE,
    PREFILL,
    MemberState,
    PoolRouter,
)
from symmetry_tpu_torch.utils.metrics import METRICS, MetricName

TIERS = (PREFILL, DECODE)

# Decision actions (wire-visible in the decision log / metrics labels).
SPAWN = "spawn"
DRAIN = "drain"
REBALANCE = "rebalance"
HOLD = "hold"


class AutoscaleConfig:
    """The `tpu.autoscale` mapping. Present ⇒ the pool heartbeat ticks
    a PoolAutoscaler; absent ⇒ the shape stays whatever `pool:` said.

    Keys (all optional; defaults are deliberately conservative — a
    controller that scales rarely beats one that flaps):
      enabled          master switch (default true when block present)
      max_members      per-tier ceiling (default 4)
      dwell_s          min seconds between topology decisions (30)
      churn_cooldown_s scaling pause after a churn respawn (60)
      spawn_burn       fast-window SLO burn that triggers a spawn (1.0
                       = error budget burning at exactly the
                       sustainable rate)
      spawn_queue      avg per-member load (in-flight + queue depth)
                       that triggers a spawn (2.0)
      spawn_queue_ticks consecutive over-threshold ticks before a
                       queue-driven spawn fires (3). Burn is already a
                       windowed rate; the load gauge is an instant
                       sample, and one arrival clump that drains within
                       a heartbeat must not buy a member boot
      drain_load       avg per-member load at-or-under which a tier
                       counts as idle (0.25)
      drain_ticks      consecutive idle ticks before the idlest member
                       drains (3)
      min_busy_s       per-tick device-busy signal (both tiers summed)
                       below which the measured-ratio rebalance stays
                       quiet — don't reshape on noise (0.05)
    """

    def __init__(self, raw: dict[str, Any] | None) -> None:
        d = dict(raw or {})
        self.enabled: bool = bool(d) and bool(d.get("enabled", True))
        self.max_members: int = max(int(d.get("max_members", 4)), 1)
        self.dwell_s: float = max(float(d.get("dwell_s", 30.0)), 0.0)
        self.churn_cooldown_s: float = max(
            float(d.get("churn_cooldown_s", 60.0)), 0.0)
        self.spawn_burn: float = max(float(d.get("spawn_burn", 1.0)), 1e-9)
        self.spawn_queue: float = max(
            float(d.get("spawn_queue", 2.0)), 1e-9)
        self.spawn_queue_ticks: int = max(
            int(d.get("spawn_queue_ticks", 3)), 1)
        self.drain_load: float = max(float(d.get("drain_load", 0.25)), 0.0)
        self.drain_ticks: int = max(int(d.get("drain_ticks", 3)), 1)
        self.min_busy_s: float = max(float(d.get("min_busy_s", 0.05)), 0.0)

    def to_dict(self) -> dict[str, Any]:
        return {"enabled": self.enabled, "max_members": self.max_members,
                "dwell_s": self.dwell_s,
                "churn_cooldown_s": self.churn_cooldown_s,
                "spawn_burn": self.spawn_burn,
                "spawn_queue": self.spawn_queue,
                "spawn_queue_ticks": self.spawn_queue_ticks,
                "drain_load": self.drain_load,
                "drain_ticks": self.drain_ticks,
                "min_busy_s": self.min_busy_s}


# Decision-record ring size: enough for hours at sane dwell settings,
# bounded so engine stats / flight dumps stay fixed-size.
DECISION_RING = 256

# Measured-ratio memory: per-tier busy deltas accumulate into a
# geometric window (delta + DECAY × previous) so the M:N signal tracks
# the recent minutes, not the whole run's history.
BUSY_DECAY = 0.8


class PoolAutoscaler:
    """One pool's scaling controller: sensors in, at most ONE topology
    op out per tick.

    Thread contract: same as PoolRouter — every call happens on the
    backend's event loop. `clock` is injectable; tests drive dwell,
    cooldown, and idle-streak logic deterministically in microseconds.

    `grow_prefill` gates the prefill tier's actuators: a pool dialing
    REMOTE prefill peers has no machine to spawn one on, so prefill
    stays fixed and only the decode tier scales.
    """

    def __init__(self, config: AutoscaleConfig, router: PoolRouter, *,
                 clock: Callable[[], float] = time.monotonic,
                 grow_prefill: bool = True) -> None:
        self.config = config
        self.router = router
        self._clock = clock
        self.grow_prefill = grow_prefill
        self._decisions: deque = deque(maxlen=DECISION_RING)
        self._last_action_t: float | None = None   # None → first action free
        self._cooldown_until = 0.0
        self._idle_ticks = {PREFILL: 0, DECODE: 0}
        self._press_ticks = {PREFILL: 0, DECODE: 0}
        self._prev_nonlost: dict[str, int] | None = None
        self._busy = {PREFILL: 0.0, DECODE: 0.0}   # decayed busy window
        self._target: dict[str, int] | None = None
        self.counters = {"ticks": 0, "holds": 0, "spawns": 0,
                         "drains": 0, "rebalances": 0, "dwell_holds": 0,
                         "cooldown_holds": 0, "churn_cooldowns": 0}
        self._m_decisions = METRICS.counter(
            MetricName.AUTOSCALE_DECISIONS,
            "autoscaler topology decisions (holds excluded)",
            labels=("action", "tier"))
        self._m_target = METRICS.gauge(
            MetricName.AUTOSCALE_TARGET,
            "autoscaler's desired member count per tier",
            labels=("tier",))
        self._m_chip = METRICS.gauge(
            MetricName.AUTOSCALE_CHIP_SECONDS,
            "pool chip-seconds (sum of member-alive time)")
        self._m_goodput = METRICS.gauge(
            MetricName.AUTOSCALE_GOODPUT,
            "SLO-attaining tokens per chip-second at last tick")
        self._m_tokens_raw = METRICS.gauge(
            MetricName.AUTOSCALE_TOKENS_RAW,
            "cumulative raw token count (pre-ledger goodput numerator, "
            "kept for series continuity)")

    # ----------------------------------------------------------- sensors

    def note_churn(self) -> None:
        """A member died and the supervisor is respawning it. This is
        capacity repair, not a scaling decision — no record is booked,
        no counter labeled `action` moves. It DOES open the cooldown:
        respawn turbulence (re-placements, a cold cache, a joining
        member) is indistinguishable from a load spike, and scaling on
        it would flap."""
        self._cooldown_until = self._clock() + self.config.churn_cooldown_s
        self.counters["churn_cooldowns"] += 1

    # -------------------------------------------------------------- tick

    def tick(self, *, burn: dict[str, float] | None = None,
             busy_delta_s: dict[str, float] | None = None,
             tokens_total: float | None = None,
             tokens_raw: float | None = None,
             applying: bool = False) -> dict[str, Any]:
        """One control step. Inputs: per-SLO fast-window burns
        (SloMonitor.burn_rates()), per-tier device-busy-second deltas
        since the last tick (symprof's measured ratio signal), the
        cumulative SLO-ATTAINING token count (the goodput numerator —
        the ledger's per-request attainment fold; ROADMAP item 5 and
        DistServe define goodput over tokens that met their SLO, not
        all tokens), the raw cumulative count (`tokens_raw`, kept as
        the sym_autoscale_tokens_raw continuity series — pre-ledger
        callers that still pass only tokens_total get the old
        behavior), and whether the previous decision is still being
        applied. Returns the decision record — every tick produces
        one, holds included; only non-hold records change the topology
        (and the decision counter)."""
        now = self._clock()
        cfg = self.config
        self.counters["ticks"] += 1
        burn = burn or {}
        for tier in TIERS:
            delta = max(float((busy_delta_s or {}).get(tier, 0.0)), 0.0)
            self._busy[tier] = self._busy[tier] * BUSY_DECAY + delta

        # --- sensor snapshot (this dict IS the decision record's input)
        placeable = {t: 0 for t in TIERS}
        nonlost = {t: 0 for t in TIERS}
        load = {t: 0.0 for t in TIERS}
        for m in self.router.members():
            if m.state != MemberState.LOST:
                nonlost[m.tier] += 1
            if m.placeable:
                placeable[m.tier] += 1
                load[m.tier] += len(m.in_flight) + m.queue_depth
        avg_load = {t: (load[t] / placeable[t] if placeable[t] else 0.0)
                    for t in TIERS}
        # SLO → tier mapping: TTFT is made in the prefill tier,
        # inter-chunk gaps in the decode tier; e2e implicates whichever
        # is already under more pressure, so it feeds both.
        e2e = float(burn.get("e2e", 0.0))
        tier_burn = {PREFILL: max(float(burn.get("ttft", 0.0)), e2e),
                     DECODE: max(float(burn.get("inter_chunk", 0.0)), e2e)}
        chip_s = self.router.chip_seconds()
        goodput = (round(float(tokens_total) / chip_s, 4)
                   if tokens_total is not None and chip_s > 1e-9 else None)
        inputs = {
            "burn": {t: round(tier_burn[t], 3) for t in TIERS},
            "avg_load": {t: round(avg_load[t], 3) for t in TIERS},
            "members": dict(placeable),
            "busy_s": {t: round(self._busy[t], 4) for t in TIERS},
            "tokens_total": tokens_total,
        }
        if tokens_raw is not None:
            inputs["tokens_raw"] = tokens_raw

        # Streaks advance every tick, decision or not. IDLE: a tier is
        # idle when its load sits under the drain floor AND its burn is
        # comfortably inside budget (draining a tier that is burning
        # would trade chips for an outage). PRESSURE: the queue-spawn
        # trigger — burn is already a windowed rate, but the load gauge
        # is an instant sample, so a spawn needs spawn_queue_ticks
        # consecutive over-threshold ticks (one arrival clump that
        # drains within a heartbeat must not buy a member boot). Two
        # freezes keep both streaks honest: while a previous decision
        # is still being applied the streaks hold (a member booting for
        # seconds would otherwise bank enough "idle" to be drained the
        # instant it joins — or enough "pressure" from its own boot
        # degradation to spawn again), and a tier whose membership just
        # changed restarts from zero — the new topology gets a full
        # observation window.
        for tier in TIERS:
            if (self._prev_nonlost is not None
                    and nonlost[tier] != self._prev_nonlost[tier]):
                self._idle_ticks[tier] = 0
                self._press_ticks[tier] = 0
            elif applying:
                pass
            else:
                if (avg_load[tier] <= cfg.drain_load
                        and tier_burn[tier] < cfg.spawn_burn / 2.0):
                    self._idle_ticks[tier] += 1
                else:
                    self._idle_ticks[tier] = 0
                if avg_load[tier] >= cfg.spawn_queue:
                    self._press_ticks[tier] += 1
                else:
                    self._press_ticks[tier] = 0
        self._prev_nonlost = dict(nonlost)

        if self._target is None:
            self._target = {t: max(nonlost[t], 1) for t in TIERS}

        action, reason, extra = self._decide(
            now, tier_burn, avg_load, placeable, nonlost, applying)

        record: dict[str, Any] = {
            "t": round(now, 4), "action": action, "reason": reason,
            "inputs": inputs, "chip_s": round(chip_s, 3),
            "goodput_tokens_per_chip_s": goodput, **extra}
        self._decisions.append(record)

        if action != HOLD:
            self._last_action_t = now
            if action == SPAWN:
                self.counters["spawns"] += 1
                tier = extra["tier"]
                self._target[tier] = min(
                    self._target[tier] + 1, cfg.max_members)
                self._idle_ticks[tier] = 0
                self._press_ticks[tier] = 0
                self._m_decisions.inc(action=SPAWN, tier=tier)
            elif action == DRAIN:
                self.counters["drains"] += 1
                tier = extra["tier"]
                self._target[tier] = max(self._target[tier] - 1, 1)
                self._idle_ticks[tier] = 0
                self._m_decisions.inc(action=DRAIN, tier=tier)
            elif action == REBALANCE:
                self.counters["rebalances"] += 1
                grow, shrink = extra["spawn_tier"], extra["drain_tier"]
                self._target[grow] = min(
                    self._target[grow] + 1, cfg.max_members)
                self._target[shrink] = max(self._target[shrink] - 1, 1)
                self._idle_ticks[grow] = 0
                self._idle_ticks[shrink] = 0
                self._press_ticks[grow] = 0
                self._press_ticks[shrink] = 0
                self._m_decisions.inc(action=REBALANCE, tier=grow)
        else:
            self.counters["holds"] += 1

        for tier in TIERS:
            self._m_target.set(self._target[tier], tier=tier)
        self._m_chip.set(round(chip_s, 3))
        if goodput is not None:
            self._m_goodput.set(goodput)
        if tokens_raw is not None:
            self._m_tokens_raw.set(round(float(tokens_raw), 1))
        return record

    # ----------------------------------------------------------- policy

    def _decide(self, now: float, tier_burn: dict[str, float],
                avg_load: dict[str, float], placeable: dict[str, int],
                nonlost: dict[str, int], applying: bool
                ) -> tuple[str, str, dict[str, Any]]:
        """The priority ladder: gates (applying / cooldown) → spawn
        (SLO protection first) → measured-ratio rebalance → idle drain
        → hold. One action per tick, dwell-gated."""
        cfg = self.config
        if not cfg.enabled:
            return HOLD, "disabled", {}
        if applying:
            return HOLD, "applying_previous_decision", {}
        if now < self._cooldown_until:
            self.counters["cooldown_holds"] += 1
            return HOLD, "churn_cooldown", {}
        dwell_blocked = (self._last_action_t is not None
                         and now - self._last_action_t < cfg.dwell_s)

        # --- spawn: a tier over its burn threshold, or over its queue
        # threshold for spawn_queue_ticks consecutive ticks; worst
        # normalized pressure wins; ceiling counts every non-lost
        # member (a joining spawn-in-progress occupies a slot).
        best_tier, best_pressure = None, 0.0
        for tier in TIERS:
            over = (tier_burn[tier] >= cfg.spawn_burn
                    or self._press_ticks[tier] >= cfg.spawn_queue_ticks)
            if not over:
                continue
            if tier == PREFILL and not self.grow_prefill:
                continue
            if nonlost[tier] >= cfg.max_members:
                continue
            pressure = (tier_burn[tier] / cfg.spawn_burn
                        + avg_load[tier] / cfg.spawn_queue)
            if pressure > best_pressure:
                best_tier, best_pressure = tier, pressure
        if best_tier is not None:
            if dwell_blocked:
                self.counters["dwell_holds"] += 1
                return HOLD, f"dwell({best_tier} spawn wanted)", {}
            return SPAWN, (
                f"{best_tier}: burn {tier_burn[best_tier]:.2f} "
                f"load {avg_load[best_tier]:.2f} over threshold"), {
                "tier": best_tier}

        # --- rebalance: symprof's measured per-tier device cost says
        # the M:N split is wrong. desired_prefill = total × share of
        # busy time the prefill tier actually consumed, clamped to
        # keep both tiers ≥ 1. Only moves when the shrinking tier is
        # idle (otherwise the spawn path already owns the problem) and
        # the busy signal is big enough to be meaning, not noise.
        total_busy = self._busy[PREFILL] + self._busy[DECODE]
        total = placeable[PREFILL] + placeable[DECODE]
        if total_busy >= cfg.min_busy_s and total >= 3:
            share = self._busy[PREFILL] / total_busy
            desired_prefill = min(max(round(total * share), 1), total - 1)
            diff = desired_prefill - placeable[PREFILL]
            if diff != 0:
                grow = PREFILL if diff > 0 else DECODE
                shrink = DECODE if diff > 0 else PREFILL
                ok = (avg_load[shrink] <= cfg.drain_load
                      and placeable[shrink] > 1
                      and nonlost[grow] < cfg.max_members
                      and (grow != PREFILL or self.grow_prefill))
                if ok:
                    if dwell_blocked:
                        self.counters["dwell_holds"] += 1
                        return HOLD, "dwell(rebalance wanted)", {}
                    member = self._idlest(shrink)
                    if member is not None:
                        return REBALANCE, (
                            f"measured ratio: prefill busy share "
                            f"{share:.2f} wants {desired_prefill}/"
                            f"{total} prefill"), {
                            "spawn_tier": grow, "drain_tier": shrink,
                            "member": member}

        # --- idle drain: a tier idle for drain_ticks consecutive ticks
        # gives back its idlest member. Floor: never the last one.
        for tier in TIERS:
            if (self._idle_ticks[tier] >= cfg.drain_ticks
                    and placeable[tier] > 1):
                if dwell_blocked:
                    self.counters["dwell_holds"] += 1
                    return HOLD, f"dwell({tier} drain wanted)", {}
                member = self._idlest(tier)
                if member is not None:
                    return DRAIN, (
                        f"{tier} idle {self._idle_ticks[tier]} ticks "
                        f"(load {avg_load[tier]:.2f})"), {
                        "tier": tier, "member": member}

        return HOLD, "steady", {}

    def _idlest(self, tier: str) -> str | None:
        """The drain victim: least loaded placeable member, lifetime
        placements then id as the deterministic tie-break."""
        live = [m for m in self.router.members(tier) if m.placeable]
        if not live:
            return None
        m = min(live, key=lambda m: (len(m.in_flight) + m.queue_depth,
                                     m.placements, m.member_id))
        return m.member_id

    # -------------------------------------------------------------- views

    @property
    def target(self) -> dict[str, int]:
        return dict(self._target or {})

    def decision_log(self) -> list[dict[str, Any]]:
        """The full bounded ring, oldest first (bench artifact)."""
        return list(self._decisions)

    def stats(self) -> dict[str, Any]:
        """Engine-stats / flight-recorder block: config, counters,
        convergence view, and the recent decision tail."""
        now = self._clock()
        return {
            "config": self.config.to_dict(),
            **self.counters,
            "target": dict(self._target or {}),
            "cooldown_remaining_s": round(
                max(self._cooldown_until - now, 0.0), 3),
            "idle_ticks": dict(self._idle_ticks),
            "press_ticks": dict(self._press_ticks),
            "decisions": [
                {k: v for k, v in d.items() if k != "inputs"}
                for d in list(self._decisions)[-16:]],
            # Non-hold records survive here even when a long applying
            # window floods the tick tail with holds (a member boot is
            # ~seconds of heartbeats).
            "actions": [
                {k: v for k, v in d.items() if k != "inputs"}
                for d in list(self._decisions)
                if d["action"] != HOLD][-16:],
        }
