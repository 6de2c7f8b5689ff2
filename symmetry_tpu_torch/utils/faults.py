"""Fault injection at named seams — deterministic failure testing.

Every recovery path in this codebase (supervisor respawn, client
failover, busy sheds, deadline sheds) exists because some process can
crash, wedge, or lose a frame at a seam. None of those failures can be
provoked deterministically from outside, so none of the paths were
testable end to end. This module gives each seam a name and lets a test
(or an operator running a chaos drill) arm a fault at it:

    SYMMETRY_FAULTS="host.pipe_write=crash@nth=10;provider.relay=error@p=0.01"

Instrumented seams (grep for `FAULTS.point` / `FAULTS.apoint`):

    host.pipe_write    engine host → provider pipe frame write
    host.pipe_read     engine host command-line read
    backend.dispatch   tpu_native request submit (host pipe or inproc)
    provider.relay     provider → client per-chunk relay
    scheduler.admit    scheduler request admission
    disagg.handoff     prefill-tier handoff frame emit (crash = the
                       prefill host dies with KV built but unshipped;
                       drop_frame = the request silently vanishes)
    disagg.net.send    handoff-link message egress (drop_frame = one
                       link message lost; error/hang = a flaky wire)
    disagg.net.recv    handoff-link message ingress (same actions,
                       receive side)
    disagg.net.drop_link  hit once per handoff transfer attempt, after
                       its first chunk; drop_frame = hard-cut the link
                       mid-handoff (a deterministic cable pull — the
                       decode tier must discard the partial frame,
                       shed in-flight migrations retryable, reconnect)

Actions:

    crash           os._exit(86) — the process dies as if SIGKILLed
                    (no cleanup, no flushed pipes)
    hang(seconds)   block the seam (default 3600 s) — a wedge, not a death
    delay(seconds)  block the seam briefly, then proceed
    error           raise InjectedFault at the seam
    drop_frame      the seam reports "drop this frame" to its caller

Triggers (one per rule; default fires on every hit):

    @once      first hit only
    @nth=N     exactly the Nth hit of that seam (1-based), once
    @every=N   every Nth hit
    @p=X       each hit independently with probability X

Configuration merges from the SYMMETRY_FAULTS environment variable (read
once at import — inherited by subprocesses, which is how a fault reaches
the engine host) and from a provider-config `faults:` mapping
(seam → spec string), loaded by the host and provider at startup.

Unconfigured, the injector is a no-op: every call site guards on
`FAULTS.enabled` (one attribute read), and `point()` itself returns
after one boolean check — CI asserts the overhead (tools/chaos_smoke.py).
"""

from __future__ import annotations

import os
import random
import re
import threading
import time
from dataclasses import dataclass, field


class InjectedFault(RuntimeError):
    """Raised by an `error` fault action at an instrumented seam."""


_ACTION_RE = re.compile(
    r"^(crash|hang|delay|error|drop_frame)(?:\(([^)]*)\))?$")

_DEFAULT_HANG_S = 3600.0


@dataclass
class FaultRule:
    """One armed fault: seam + action + trigger, with hit accounting."""

    seam: str
    kind: str                  # crash | hang | delay | error | drop_frame
    seconds: float = 0.0       # hang/delay duration
    message: str = ""          # error message override
    trigger: str = "always"    # always | once | nth | every | p
    n: int = 1                 # nth / every operand
    prob: float = 1.0          # p operand
    hits: int = field(default=0, compare=False)
    fired: int = field(default=0, compare=False)

    def should_fire(self) -> bool:
        """Record one hit; report whether the action fires on it.
        Caller holds the injector lock."""
        self.hits += 1
        if self.trigger == "once":
            ok = self.fired == 0
        elif self.trigger == "nth":
            ok = self.hits == self.n
        elif self.trigger == "every":
            ok = self.hits % self.n == 0
        elif self.trigger == "p":
            ok = random.random() < self.prob
        else:
            ok = True
        if ok:
            self.fired += 1
        return ok


def parse_rule(seam: str, spec: str) -> FaultRule:
    """One rule from its spec string, e.g. ``hang(30)@nth=4``."""
    seam = seam.strip()
    spec = spec.strip()
    if not seam:
        raise ValueError(f"fault rule missing seam name: {spec!r}")
    action, _, trig = spec.partition("@")
    m = _ACTION_RE.match(action.strip())
    if m is None:
        raise ValueError(
            f"bad fault action {action!r} for seam {seam!r} "
            f"(want crash|hang(s)|delay(s)|error(msg)|drop_frame)")
    kind, arg = m.group(1), m.group(2)
    rule = FaultRule(seam=seam, kind=kind)
    if kind in ("hang", "delay"):
        rule.seconds = float(arg) if arg else (
            _DEFAULT_HANG_S if kind == "hang" else 0.0)
        if kind == "delay" and not arg:
            raise ValueError(f"delay requires a duration: {spec!r}")
    elif kind == "error" and arg:
        rule.message = arg
    elif arg:
        raise ValueError(f"action {kind!r} takes no argument: {spec!r}")
    trig = trig.strip()
    if trig:
        if trig == "once":
            rule.trigger = "once"
        elif trig.startswith("nth="):
            rule.trigger, rule.n = "nth", int(trig[4:])
        elif trig.startswith("every="):
            rule.trigger, rule.n = "every", int(trig[6:])
        elif trig.startswith("p="):
            rule.trigger, rule.prob = "p", float(trig[2:])
        else:
            raise ValueError(
                f"bad fault trigger {trig!r} for seam {seam!r} "
                f"(want once | nth=N | every=N | p=X)")
        if rule.trigger in ("nth", "every") and rule.n < 1:
            raise ValueError(f"trigger operand must be >= 1: {spec!r}")
    return rule


class FaultInjector:
    """Process-global registry of armed faults, fired at named seams."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._rules: dict[str, list[FaultRule]] = {}
        # The hot-path guard: call sites read this one attribute before
        # paying for a method call. Only load()/clear() write it.
        self.enabled = False

    def load(self, spec) -> None:
        """Arm rules from a spec. Accepts the env-string form
        (``seam=action@trigger;seam=...``), a mapping of seam → spec
        string (or list of spec strings) — the provider-config `faults:`
        shape — or None/"" (no-op). Merges with existing rules."""
        if not spec:
            return
        rules: list[FaultRule] = []
        if isinstance(spec, str):
            for entry in spec.split(";"):
                entry = entry.strip()
                if not entry:
                    continue
                seam, sep, action = entry.partition("=")
                if not sep:
                    raise ValueError(f"bad fault entry {entry!r} "
                                     f"(want seam=action[@trigger])")
                rules.append(parse_rule(seam, action))
        elif isinstance(spec, dict):
            for seam, val in spec.items():
                for one in (val if isinstance(val, (list, tuple)) else [val]):
                    rules.append(parse_rule(str(seam), str(one)))
        else:
            raise ValueError(f"fault spec must be str or mapping, "
                             f"got {type(spec).__name__}")
        with self._lock:
            for rule in rules:
                self._rules.setdefault(rule.seam, []).append(rule)
            self.enabled = bool(self._rules)

    def clear(self) -> None:
        with self._lock:
            self._rules.clear()
            self.enabled = False

    def rules(self) -> list[FaultRule]:
        with self._lock:
            return [r for lst in self._rules.values() for r in lst]

    def counters(self) -> dict[str, dict[str, int]]:
        """Per-seam hit/fired accounting (ride-along for stats replies)."""
        with self._lock:
            return {seam: {"hits": sum(r.hits for r in lst),
                           "fired": sum(r.fired for r in lst)}
                    for seam, lst in self._rules.items()}

    def fire(self, seam: str) -> FaultRule | None:
        """Record a hit at `seam`; return the rule whose action fires,
        if any. First armed rule wins — later rules on the same seam
        still record the HIT, but their trigger budget (@once/@nth) is
        only consumed when they are actually selected, so `fired`
        counters report applied actions, nothing else."""
        if not self.enabled:
            return None
        with self._lock:
            fired = None
            for rule in self._rules.get(seam, ()):
                if fired is None:
                    if rule.should_fire():
                        fired = rule
                else:
                    rule.hits += 1
            return fired

    # ------------------------------------------------------------ seams

    def point(self, seam: str) -> bool:
        """Synchronous seam: perform the armed action, if any. Returns
        True when the caller should DROP the current frame/request
        (drop_frame action), False otherwise. crash exits the process;
        hang/delay block the calling thread; error raises InjectedFault."""
        if not self.enabled:
            return False
        rule = self.fire(seam)
        if rule is None:
            return False
        return self._apply(rule, time.sleep)

    async def apoint(self, seam: str) -> bool:
        """Async seam: like point(), but hang/delay await the event loop's
        clock instead of blocking the whole loop."""
        if not self.enabled:
            return False
        rule = self.fire(seam)
        if rule is None:
            return False
        if rule.kind in ("hang", "delay"):
            import asyncio

            await asyncio.sleep(rule.seconds)
            return False
        return self._apply(rule, time.sleep)

    def _apply(self, rule: FaultRule, sleep) -> bool:
        if rule.kind == "crash":
            # As close to a real crash as Python offers: no atexit, no
            # finally blocks, no flushed buffers.
            os._exit(86)
        if rule.kind in ("hang", "delay"):
            sleep(rule.seconds)
            return False
        if rule.kind == "error":
            raise InjectedFault(
                rule.message or f"injected fault at {rule.seam}")
        return True  # drop_frame


FAULTS = FaultInjector()
FAULTS.load(os.environ.get("SYMMETRY_FAULTS"))
