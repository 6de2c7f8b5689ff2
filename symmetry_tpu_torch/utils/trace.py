"""Tracing and serving metrics (SURVEY §5.1).

The reference ships no tracing of its own — its dependency stack embeds
hypertrace hooks it never enables, and the only counters are wire-level
byte counts on the peer object. Here the equivalents are first-class:

  - Span/Tracer: per-request spans (receive → first-token → end) with a
    bounded in-memory ring, cheap enough to leave on. Each component owns
    its Tracer (provider, host, scheduler). While a torch.profiler records
    on the calling thread, Tracer.span is also a profiler range named
    `<prefix>.<name>`, and device_range gives the model such a range
    with no ring record: the profiler then attributes each kernel to the
    innermost range that launched it.
  - Histogram: log-bucketed latency/throughput distributions with
    percentile estimates — p50/p99 TTFT is the BASELINE.json north-star
    metric, so it must be computable from a running provider, not from
    offline logs. Their owners observe them (the provider its TTFT and
    end-to-end times); recording a span observes none.
  - device_trace: on-demand torch.profiler capture for the CUDA engine (the
    "trace capture endpoint" of SURVEY §5.1); writes a Chrome/Perfetto
    trace file.

Request-scoped distributed tracing (PR 5) builds on the same rings:

  - Every span may carry a `trace_id` minted at the client (new_trace_id)
    and propagated client → provider → host → scheduler, so one request's
    spans correlate across four processes.
  - clock_handshake_offset reconciles the processes onto ONE clock: an
    NTP-style midpoint estimate from round-trip samples (min-RTT sample
    wins), replacing the old assume-zero-offset + clamp-negative-spans
    policy in the per-stage TTFT attribution.
  - Tracer.counter records bounded gauge tracks (queue depth, slot
    occupancy) beside the span ring.
  - export_perfetto merges many components' span/counter rings into one
    Chrome-trace-event JSON (one "process" row per component, one thread
    row per request) loadable in Perfetto / chrome://tracing.
  - FlightRecorder: always-on last-N-seconds dump — the rings are already
    bounded and always recording; a trigger (latency SLO breach, engine
    error, SIGUSR2) snapshots the merged recent timeline plus a stats()
    snapshot to a JSON file, so the LAST bad request is debuggable after
    the fact, not just the next one.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import math
import os
import random
import sys
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Iterator


def _log_buckets(lo: float, hi: float, per_decade: int = 5) -> list[float]:
    n = max(1, int(math.ceil(math.log10(hi / lo) * per_decade)))
    ratio = (hi / lo) ** (1.0 / n)
    return [lo * ratio**i for i in range(n + 1)]


class Histogram:
    """Log-bucketed histogram + bounded raw-sample reservoir.

    Fixed memory, O(log buckets) observe, thread-safe. Default span covers
    0.1 ms .. 100 s — every latency this framework measures.

    Percentiles come from the RESERVOIR, not the buckets: round 4 shipped
    bench captures where provider TTFT p50 == p99 because 5-buckets-per-
    decade (1.58x per bucket) collapsed the whole distribution into one
    bucket — percentiles quoted to milliseconds carried ±26% bucket error.
    Up to `reservoir` observations the percentile is EXACT (every sample
    retained); beyond that, uniform reservoir sampling (Vitter's R) keeps
    an unbiased sample so the estimate degrades gracefully instead of
    quantizing. The buckets stay (20/decade now, ±5.9%) as the bounded
    all-time record behind mean/min/max and cross-checks.
    """

    RESERVOIR = 4096

    def __init__(self, lo: float = 1e-4, hi: float = 100.0,
                 per_decade: int = 20, reservoir: int | None = None) -> None:
        self._edges = _log_buckets(lo, hi, per_decade)
        self._counts = [0] * (len(self._edges) + 1)
        self._lock = threading.Lock()
        self._cap = reservoir if reservoir is not None else self.RESERVOIR
        self._samples: list[float] = []
        # Seeded per-instance PRNG: reservoir eviction must not perturb
        # (or be perturbed by) the global `random` stream, and seeding
        # keeps test runs reproducible.
        self._rng = random.Random(0x5EED)
        self.count = 0
        self.total = 0.0
        self.min: float | None = None
        self.max: float | None = None

    def observe(self, value: float) -> None:
        idx = bisect.bisect_right(self._edges, value)
        with self._lock:
            self._counts[idx] += 1
            self.count += 1
            self.total += value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)
            if len(self._samples) < self._cap:
                self._samples.append(value)
            else:
                j = self._rng.randrange(self.count)
                if j < self._cap:
                    self._samples[j] = value

    @staticmethod
    def _rank(xs: list[float], p: float) -> float | None:
        if not xs:
            return None
        rank = min(len(xs) - 1, max(0, math.ceil(p / 100.0 * len(xs)) - 1))
        return xs[rank]

    def percentile(self, p: float) -> float | None:
        """p-th percentile (0-100); None when empty. Exact while the
        stream fits the reservoir, an unbiased estimate beyond."""
        with self._lock:
            xs = sorted(self._samples)
        return self._rank(xs, p)

    @property
    def mean(self) -> float | None:
        # count and total are read under the lock as ONE snapshot: a
        # concurrent observe() between the two reads would pair a new
        # total with a stale count (a mean no real prefix of the stream
        # ever had).
        with self._lock:
            return self.total / self.count if self.count else None

    def to_dict(self) -> dict[str, Any]:
        # One consistent snapshot under the lock: count/total/min/max and
        # the reservoir are mutated together by observe(), so reading
        # them piecemeal (the old property-per-field path) could return
        # e.g. count=N with the min of observation N+1.
        with self._lock:
            count, total = self.count, self.total
            mn, mx = self.min, self.max
            xs = sorted(self._samples)
        return {
            "count": count,
            "mean": total / count if count else None,
            "min": mn,
            "max": mx,
            "p50": self._rank(xs, 50),
            "p90": self._rank(xs, 90),
            "p99": self._rank(xs, 99),
        }


def new_trace_id() -> str:
    """Mint a request trace id (carried client → provider → host →
    scheduler so every component's spans correlate)."""
    return uuid.uuid4().hex[:16]


def clock_handshake_offset(
        samples: list[tuple[float, float, float]]) -> float:
    """Estimate a remote clock's offset from round-trip samples.

    Each sample is (t_send_local, t_remote, t_recv_local): the local
    stamps bracket the remote's clock read. The NTP midpoint estimate
    assumes the remote read happened halfway through the round trip, so
    its error is bounded by ±rtt/2 — the sample with the smallest RTT
    gives the tightest bound and wins.

    Returns `offset = remote_clock - local_clock`; map a remote stamp
    onto the local clock with `t_local = t_remote - offset`.
    """
    if not samples:
        return 0.0
    t0, tr, t1 = min(samples, key=lambda s: s[2] - s[0])
    return tr - (t0 + t1) / 2.0


@dataclass(slots=True)
class Span:
    """One completed timed section."""

    name: str
    start: float          # time.monotonic()
    duration_s: float
    request_id: str = ""
    trace_id: str = ""
    attrs: dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> dict[str, Any]:
        return {"name": self.name, "start": self.start,
                "duration_s": self.duration_s,
                "request_id": self.request_id,
                "trace_id": self.trace_id, **self.attrs}


class _NoRange:
    """The range device_range gives while no profiler records: nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: Any) -> bool:
        return False


_NO_RANGE = _NoRange()


def device_range(name: str) -> Any:
    """A context that is a torch.profiler range named `name` while a
    profiler records on this thread, and nothing otherwise: one check, no
    allocation. The profiler attributes each kernel launched inside to the
    range; nothing is written to any ring (the model's per-layer ranges
    would be ~1,000 records a decode block)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return _NO_RANGE
    return torch.autograd.profiler.record_function(name)


class Tracer:
    """Bounded ring of completed spans and gauge observations.

    Instantiate one per component; `prefix` names the component in the
    profiler ranges its spans open (`sched.decode_dispatch`). Hot-path
    cost when disabled is a single attribute check, and the ranges one
    check more.
    """

    def __init__(self, capacity: int = 4096, prefix: str = "") -> None:
        self.enabled = True
        self.prefix = prefix
        self._spans: deque[Span] = deque(maxlen=capacity)
        # Gauge tracks (queue depth, slot occupancy): (t, name, value)
        # triples in one bounded ring — same always-on cost model as the
        # span ring, exported as Perfetto counter tracks.
        self._counters: deque[tuple[float, str, float]] = deque(
            maxlen=capacity)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str, request_id: str = "", trace_id: str = "",
             **attrs: Any) -> Iterator[dict[str, Any]]:
        """Times the enclosed block. Yields the attrs dict so the block can
        annotate the span (e.g. token counts) before it closes. While a
        profiler records on this thread the block is also its range
        `<prefix>.<name>`, whether the ring is enabled or not."""
        with device_range(f"{self.prefix}.{name}" if self.prefix else name):
            if not self.enabled:
                yield attrs
                return
            t0 = time.monotonic()
            try:
                yield attrs
            finally:
                self.record(name, t0, time.monotonic() - t0,
                            request_id=request_id, trace_id=trace_id,
                            **attrs)

    def record(self, name: str, start: float, duration_s: float,
               request_id: str = "", trace_id: str = "",
               **attrs: Any) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._spans.append(Span(name=name, start=start,
                                    duration_s=duration_s,
                                    request_id=request_id,
                                    trace_id=trace_id, attrs=dict(attrs)))

    def counter(self, name: str, value: float,
                t: float | None = None) -> None:
        """Record one gauge observation (a point on a counter track)."""
        if not self.enabled:
            return
        with self._lock:
            self._counters.append(
                (time.monotonic() if t is None else t, name, value))

    def export(self, request_id: str | None = None) -> list[dict[str, Any]]:
        with self._lock:
            spans = list(self._spans)
        if request_id is not None:
            spans = [s for s in spans if s.request_id == request_id]
        return [s.to_dict() for s in spans]

    def export_counters(self) -> list[dict[str, Any]]:
        with self._lock:
            counters = list(self._counters)
        return [{"t": t, "name": name, "value": value}
                for t, name, value in counters]

    def component(self, name: str,
                  clock_offset_s: float = 0.0) -> dict[str, Any]:
        """This tracer's rings as one export_perfetto component entry.
        `clock_offset_s` = (this tracer's clock) - (the merge's reference
        clock); 0 when the caller IS the reference."""
        return {"name": name, "clock_offset_s": clock_offset_s,
                "spans": self.export(), "counters": self.export_counters()}

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counters.clear()


# --------------------------------------------------------------- perfetto

def export_perfetto(components: list[dict[str, Any]],
                    base: float | None = None) -> dict[str, Any]:
    """Merge components' span/counter rings into Chrome trace-event JSON.

    Each component entry is `{"name", "spans", "counters",
    "clock_offset_s"}` (the shape Tracer.component and the host-pipe
    `trace` op produce). `clock_offset_s` is that component's clock minus
    the merge's reference clock (as measured by clock_handshake_offset
    along the hop chain), so `start - clock_offset_s` lands every span on
    ONE reconciled timeline regardless of which process stamped it.

    Output: `{"traceEvents": [...], "displayTimeUnit": "ms"}` —
    loadable in Perfetto (ui.perfetto.dev) or chrome://tracing. One
    "process" row per component (pid = component index), one thread row
    per request within it (named by request id), complete-events ("X")
    for spans, counter events ("C") for gauge tracks. `args` carries
    request_id/trace_id and span attrs, so Perfetto's query/filter box
    isolates one request's end-to-end timeline across all components.
    """
    events: list[dict[str, Any]] = []
    # The reference instant (ts = 0): earliest reconciled stamp across
    # every ring, so all ts values are non-negative offsets from the
    # merge's own beginning.
    if base is None:
        starts = [s["start"] - comp.get("clock_offset_s", 0.0)
                  for comp in components for s in comp.get("spans", [])]
        starts += [c["t"] - comp.get("clock_offset_s", 0.0)
                   for comp in components for c in comp.get("counters", [])]
        base = min(starts) if starts else 0.0

    for pid, comp in enumerate(components, start=1):
        off = comp.get("clock_offset_s", 0.0)
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": comp.get("name", "?")}})
        tids: dict[str, int] = {}
        for span in comp.get("spans", []):
            rid = str(span.get("request_id") or "")
            if rid not in tids:
                tids[rid] = len(tids) + 1 if rid else 0
                if rid:
                    events.append({"ph": "M", "name": "thread_name",
                                   "pid": pid, "tid": tids[rid],
                                   "args": {"name": rid}})
            args = {k: v for k, v in span.items()
                    if k not in ("name", "start", "duration_s")
                    and v not in (None, "")}
            events.append({
                "ph": "X", "name": str(span.get("name", "?")), "cat": "span",
                "pid": pid, "tid": tids[rid],
                "ts": round((span["start"] - off - base) * 1e6, 3),
                "dur": round(max(span.get("duration_s", 0.0), 0.0) * 1e6, 3),
                "args": args})
        for c in comp.get("counters", []):
            events.append({
                "ph": "C", "name": str(c["name"]), "pid": pid, "tid": 0,
                "ts": round((c["t"] - off - base) * 1e6, 3),
                "args": {str(c["name"]): c["value"]}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


class FlightRecorder:
    """Always-on post-mortem capture over the bounded span rings.

    The rings record continuously (that is the "always-on" part — no
    sampling decision to regret); this class owns the TRIGGER: when a
    request breaches its latency SLO, the engine errors, or an operator
    sends SIGUSR2, the merged last-`window_s` timeline plus a stats()
    snapshot is dumped to one JSON file. Rate-limited so an error storm
    produces one dump per `min_interval_s`, not one per failure.

    The dump file: `{"reason", "written_at", "window_s", "stats",
    "trace": <Chrome trace-event JSON>}` — load `trace` straight into
    Perfetto, read `stats` beside it.
    """

    def __init__(self, out_dir: str, *, window_s: float = 30.0,
                 min_interval_s: float = 30.0,
                 slo_e2e_s: float | None = None) -> None:
        self.out_dir = os.path.expanduser(out_dir)
        self.window_s = window_s
        self.min_interval_s = min_interval_s
        self.slo_e2e_s = slo_e2e_s
        self._last_dump = -1e9
        self._lock = threading.Lock()

    def should_dump(self) -> bool:
        """Rate-limit gate; claims the slot when it grants one."""
        with self._lock:
            now = time.monotonic()
            if now - self._last_dump < self.min_interval_s:
                return False
            self._last_dump = now
            return True

    def dump(self, reason: str, components: list[dict[str, Any]],
             stats: dict[str, Any] | None = None,
             now: float | None = None) -> str:
        """Write one dump (no rate-limit check — pair with should_dump
        for triggered paths; SIGUSR2 calls this directly). Returns the
        file path."""
        now = time.monotonic() if now is None else now
        horizon = now - self.window_s
        recent = []
        for comp in components:
            off = comp.get("clock_offset_s", 0.0)
            spans = [s for s in comp.get("spans", [])
                     if s["start"] - off + s.get("duration_s", 0.0)
                     >= horizon]
            counters = [c for c in comp.get("counters", [])
                        if c["t"] - off >= horizon]
            recent.append({**comp, "spans": spans, "counters": counters})
        payload = {
            "reason": reason,
            "written_at": time.time(),
            "window_s": self.window_s,
            "stats": stats or {},
            "trace": export_perfetto(recent),
        }
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(
            self.out_dir, f"flight_{int(time.time())}_{reason}.json")
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(payload, fh)
        return path


def device_trace_activities() -> list:
    """What device_trace records: with a CUDA card the kernels it runs,
    which CUPTI records for every thread of the process; without one, the
    calling thread's PyTorch ops (the profiler records host ops of the
    thread that started it only)."""
    import torch
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CUDA if torch.cuda.is_available()
            else ProfilerActivity.CPU]


@contextlib.contextmanager
def device_trace(log_dir: str, gate: Any = None) -> Iterator[None]:
    """Capture a torch.profiler trace of the enclosed block into
    <log_dir>/trace.json (Chrome trace events, loadable in Perfetto or
    chrome://tracing): with a CUDA card every kernel it ran in the window,
    launched from any thread (device_trace_activities). `gate`, a lock,
    is held around the profiler's start and stop: a caller whose other
    threads launch CUDA work holds it there, since a stop that races a
    launch on another thread can crash the process (engine/host.py
    GatedEngine)."""
    from torch.profiler import profile

    gate = gate if gate is not None else contextlib.nullcontext()
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=device_trace_activities())
    with gate:
        prof.start()
    try:
        yield
    finally:
        with gate:
            prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
