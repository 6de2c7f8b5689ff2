"""Fleet telemetry: the always-on, label-aware metrics registry.

Everything this framework could report before PR 10 was a point-in-time
`stats()` snapshot pulled over the host pipe or the peer wire — no
standard scrape surface, no time series, no SLO evaluation. This module
is the missing layer:

  - `MetricsRegistry` (`METRICS`, process-global): Counter / Gauge /
    Histogram families with fixed label names, every mutation and every
    read under ONE lock so a snapshot is always consistent (the same
    contract Histogram.to_dict in utils/trace.py earned the hard way).
    Near-zero cost when disabled: one attribute load and a branch per
    call — asserted by a CI overhead guard, same discipline as the
    fault injector's no-op contract.
  - `MetricName`: the metric-name registry, protocol/keys.py-style. One
    place on purpose: the symlint metric-name checker (M101–M103,
    analysis/metric_names.py) fails CI on names emitted but not
    registered here, or registered but never emitted — a typo'd metric
    is a silently-empty dashboard panel, not an error.
  - Prometheus text exposition: `render_prometheus` merges one-or-many
    snapshots (provider process + engine host(s), each with extra
    labels like `tier="prefill"`) into the standard text format, and
    `MetricsServer` serves it on `metrics.port` with nothing but
    stdlib `http.server`. `parse_prometheus_text` is the inverse, for
    `tools/symtop.py` and the CI smoke.
  - `SloMonitor`: multiwindow burn-rate evaluation over the request
    stream (SRE-workbook shape: a breach requires BOTH the fast and
    the slow window to burn the error budget faster than the
    threshold, so a single slow request can't page and a sustained
    regression can't hide). Breaches are rate-limited, exported as
    registry metrics, and the caller (provider/provider.py) wires them
    to the flight recorder + a structured log event — SLO breach is a
    first-class, test-triggerable signal.

Histograms keep a bounded ring of recent (t, value) samples beside the
cumulative buckets — the time series a live `symtop` view or a windowed
percentile wants, at fixed memory.
"""

from __future__ import annotations

import bisect
import http.server
import threading
import time
from collections import deque
from typing import Any, Callable, Iterable


class MetricName:
    """The metric-name registry. Every name the codebase emits lives
    here (and only names the codebase emits — the symlint metric-name
    checker enforces both directions). Prometheus conventions: `_total`
    for counters, `_seconds` for latency histograms, base units."""

    # --- provider tier (provider/provider.py, one per provider process)
    PROVIDER_REQUESTS = "sym_provider_requests_total"
    PROVIDER_TOKENS_OUT = "sym_provider_tokens_out_total"
    PROVIDER_ERRORS = "sym_provider_errors_total"
    PROVIDER_SHEDS = "sym_provider_sheds_total"              # {reason}
    PROVIDER_IN_FLIGHT = "sym_provider_in_flight"
    PROVIDER_PENDING_FIRST_TOKEN = "sym_provider_pending_first_token"
    PROVIDER_CONNECTIONS = "sym_provider_connections"
    PROVIDER_UPTIME = "sym_provider_uptime_seconds"
    PROVIDER_TTFT = "sym_provider_ttft_seconds"
    PROVIDER_E2E = "sym_provider_e2e_seconds"
    PROVIDER_INTER_CHUNK = "sym_provider_inter_chunk_seconds"
    PROVIDER_BACKEND_RESTARTS = "sym_provider_backend_restarts_total"
    PROVIDER_FLIGHT_DUMPS = "sym_provider_flight_dumps_total"  # {reason}

    # --- SLO monitor (this module; wired by the provider)
    SLO_BURN_RATE = "sym_slo_burn_rate"                      # {slo,window}
    SLO_BREACHES = "sym_slo_breaches_total"                  # {slo}

    # --- stream resumption (provider relay + scheduler admission): the
    #     crash-surviving generation path. `resumed_tokens` = tokens a
    #     resume skipped regenerating (the saved work); `wasted_tokens` =
    #     overlap tokens the relay's offset dedup dropped (work the
    #     engine redid that the client already had); `resume_ttft` =
    #     interruption → first CONTINUATION token, the recovery-latency
    #     headline of the kill-under-load round.
    PROVIDER_RESUMES = "sym_resume_requests_total"
    RESUME_WASTED_TOKENS = "sym_resume_wasted_tokens_total"
    RESUME_TTFT = "sym_resume_ttft_seconds"
    SCHED_RESUMES = "sym_resume_admissions_total"
    SCHED_RESUMED_TOKENS = "sym_resume_resumed_tokens_total"
    SCHED_RESUME_REUSED = "sym_resume_reused_tokens_total"

    # --- relay / per-stage TTFT (provider/backends/tpu_native.py)
    TTFT_STAGE = "sym_ttft_stage_seconds"                    # {stage}
    RELAY_HOST_FRAMES = "sym_relay_host_frames_total"
    RELAY_HOST_EVENTS = "sym_relay_host_events_total"

    # --- scheduler (engine/scheduler.py; host process in process mode,
    #     tier-labeled through the HostOp.METRICS probe)
    SCHED_REQUESTS = "sym_sched_requests_total"
    SCHED_TOKENS = "sym_sched_tokens_total"
    SCHED_QUEUE_DEPTH = "sym_sched_queue_depth"
    SCHED_OCCUPANCY = "sym_sched_occupancy"
    SCHED_EVICTIONS = "sym_sched_evictions_total"
    SCHED_DEADLINE_SHEDS = "sym_sched_deadline_sheds_total"
    SCHED_HANDOFFS = "sym_sched_handoffs_total"
    SCHED_DISPATCH = "sym_sched_dispatch_seconds"            # {kind}
    SCHED_TTFT = "sym_sched_ttft_seconds"
    # Overlapped-pipeline split (tpu.pipeline_depth): wall the dispatch
    # thread spends per non-idle loop iteration vs wall the emit worker
    # spends delivering the offloaded per-block work, plus the live
    # in-flight block count between iterations. dispatch_thread -> ~the
    # bare dispatch cost is the CPU-verifiable proxy for
    # sym_dispatch_gap_share -> ~0 on the chip.
    SCHED_DISPATCH_THREAD = "sym_sched_dispatch_thread_s"
    SCHED_OFFLOADED = "sym_sched_offloaded_s"
    SCHED_PIPELINE_DEPTH = "sym_sched_pipeline_depth"

    # --- symprof device-time attribution (utils/devprof.py; lives in
    #     the host process beside the engine, tier-labeled through the
    #     HostOp.METRICS probe). Device durations come from sampling
    #     completion probes (`tpu.profile_sample`); the dispatch gap is
    #     host idle between a probed device completion and the next
    #     dispatch — the steady-wire suspect, measured on-device.
    DEVICE_DISPATCH = "sym_device_dispatch_seconds"          # {kind}
    DEVICE_PROBES = "sym_device_probes_total"                # {kind}
    DISPATCH_GAP = "sym_dispatch_gap_seconds"
    DISPATCH_GAP_SHARE = "sym_dispatch_gap_share"
    # On-demand jax.profiler captures (provider wire op / SIGUSR1 / SLO
    # burn hook → HostOp.PROFILE), booked by the provider per trigger.
    PROFILE_CAPTURES = "sym_profile_captures_total"          # {reason}

    # --- radix prefix cache (engine/prefix_cache.py; lives in the host
    #     process, tier-labeled through the HostOp.METRICS probe)
    PREFIX_BLOCKS_IN_USE = "sym_prefix_blocks_in_use"
    PREFIX_BLOCKS_EVICTED = "sym_prefix_blocks_evicted_total"
    PREFIX_HIT_DEPTH = "sym_prefix_radix_hit_depth_blocks"

    # --- fused-dequant degrade ledger (engine/engine.py): one count per
    #     int8 weight leaf that stays on the XLA mixed dot instead of
    #     the packed W8A16 kernel at load, labeled with the degrade
    #     reason (untileable | shard_indivisible | shard_untileable |
    #     expert_stack | stage_axis). Booked so a mesh build that quietly
    #     lost its fused leaves shows up in symtop, never as a silent
    #     bandwidth regression.
    QMM_FALLBACK = "sym_qmm_fallback_total"                  # {reason}

    # --- engine host pipe (engine/host.py)
    HOST_PIPE_WRITES = "sym_host_pipe_writes_total"
    HOST_PIPE_BYTES = "sym_host_pipe_bytes_total"
    HOST_PIPE_EVENTS = "sym_host_pipe_events_total"
    HOST_HANDOFF_FRAMES = "sym_host_handoff_frames_total"
    HOST_HANDOFF_BYTES = "sym_host_handoff_bytes_total"
    HOST_HANDOFF_SERIALIZE = "sym_host_handoff_serialize_seconds"
    HOST_ADOPT_FRAMES = "sym_host_adopt_frames_total"        # {outcome}
    HOST_ADOPT_DESERIALIZE = "sym_host_adopt_deserialize_seconds"

    # --- disagg broker, provider process (engine/disagg/broker.py)
    HANDOFF_FRAMES = "sym_handoff_frames_total"
    HANDOFF_BYTES = "sym_handoff_bytes_total"
    HANDOFF_PENDING = "sym_handoff_pending"
    HANDOFF_WIRE = "sym_handoff_wire_seconds"
    HANDOFF_PREFILL_TIER = "sym_handoff_prefill_tier_seconds"

    # --- handoff link (engine/disagg/net.py; decode side + inline node)
    LINK_CONNECTS = "sym_link_connects_total"
    LINK_DROPS = "sym_link_drops_total"
    LINK_CONNECTED = "sym_link_connected"
    LINK_WIRE_FRAMES = "sym_link_wire_frames_total"
    LINK_WIRE_BYTES = "sym_link_wire_bytes_total"
    LINK_RETRIES = "sym_link_retries_total"
    LINK_CREDIT_STALLS = "sym_link_credit_stalls_total"
    LINK_PARTIAL_DISCARDS = "sym_link_partial_discards_total"

    # --- elastic disagg pool (engine/disagg/pool.py, provider process)
    POOL_MEMBERS = "sym_pool_members"                        # {tier}
    POOL_HEALTHY = "sym_pool_healthy"                        # {tier}
    POOL_MEMBER_STATE = "sym_pool_member_state"              # {tier,node}
    POOL_PLACEMENTS = "sym_pool_placements_total"            # {tier,node}
    POOL_REPLACEMENTS = "sym_pool_replacements_total"
    POOL_DRAINS = "sym_pool_drains_total"
    # Cache-aware placement (gossiped radix summaries as the signal):
    # predicted hit depth actually banked per placement, placements
    # split by whether affinity changed the answer, and the age of each
    # member's last gossiped summary (the staleness-decay input).
    POOL_PREDICTED_HIT = "sym_pool_predicted_hit_blocks"     # {tier,node}
    POOL_AFFINITY_PLACEMENTS = (
        "sym_pool_affinity_placements_total")                # {outcome}
    POOL_GOSSIP_AGE = "sym_pool_gossip_age_seconds"          # {tier,node}

    # --- SLO-goodput autoscaler (engine/disagg/autoscale.py, provider
    #     process). Decisions count only real topology changes —
    #     hold/dwell/cooldown ticks stay out of the counter so
    #     decisions/min in symtop means "the shape moved". Target vs
    #     live membership is the convergence view; chip-seconds is
    #     Σ member-alive time (the goodput denominator, gauge because
    #     it is recomputed from the router's ledger each tick).
    AUTOSCALE_DECISIONS = "sym_autoscale_decisions_total"    # {action,tier}
    AUTOSCALE_TARGET = "sym_autoscale_target_members"        # {tier}
    AUTOSCALE_CHIP_SECONDS = "sym_autoscale_chip_seconds"
    AUTOSCALE_GOODPUT = "sym_autoscale_goodput_tokens_per_chip_s"
    # Pre-ledger continuity series: the raw cumulative token count the
    # goodput numerator used before symledger wired SLO attainment in
    # (PR 20) — dashboards comparing old and new goodput read both.
    AUTOSCALE_TOKENS_RAW = "sym_autoscale_tokens_raw"

    # --- symledger per-request cost attribution (engine/ledger.py →
    #     provider/provider.py, tpu.ledger). device_seconds is a
    #     histogram per phase (prefill/chunk/decode/verify/adopt);
    #     wasted_seconds counts device time spent on output nobody
    #     consumed, per reason (spec_rejected/resume_discarded/
    #     deadline_shed/killed_prefill/cancelled); goodput is the
    #     windowed SLO objective — SLO-attaining tokens over attributed
    #     device seconds (DistServe's goodput, per request).
    REQUEST_DEVICE_SECONDS = "sym_request_device_seconds"    # {phase}
    REQUEST_WASTED_SECONDS = "sym_request_wasted_seconds"    # {reason}
    GOODPUT_TOKENS_PER_DEVICE_S = "sym_goodput_tokens_per_device_second"

    # --- server registry (server/registry.py)
    SERVER_PROVIDERS_ONLINE = "sym_server_providers_online"
    SERVER_PROVIDER_QUEUED = "sym_server_provider_queued"    # {provider,model}


METRIC_NAMES = frozenset(
    v for k, v in vars(MetricName).items()
    if not k.startswith("_") and isinstance(v, str)
)

# Default latency buckets: log-ish spacing 1 ms .. 60 s — every latency
# this framework measures, 17 buckets (+Inf implied). Fixed tuple so two
# processes' histograms always merge bucket-for-bucket.
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 20.0, 30.0, 45.0, 60.0)

# Recent-sample ring per histogram series: the bounded time series a
# live view reads (fixed memory; ~16 B/sample).
RING_CAPACITY = 512


class _Family:
    __slots__ = ("name", "kind", "help", "label_names", "series",
                 "buckets")

    def __init__(self, name: str, kind: str, help_: str,
                 label_names: tuple[str, ...],
                 buckets: tuple[float, ...] | None = None) -> None:
        self.name = name
        self.kind = kind                      # counter | gauge | histogram
        self.help = help_
        self.label_names = label_names
        self.buckets = buckets
        # label-values tuple -> float (counter/gauge) or
        # [count, sum, min, max, bucket_counts list, ring deque]
        self.series: dict[tuple[str, ...], Any] = {}


class _Handle:
    """One family's mutation handle. Label values ride as kwargs and
    must name the family's declared label set (missing labels become
    ""); the branch on `enabled` is the whole disabled-mode cost."""

    __slots__ = ("_reg", "_fam")

    def __init__(self, reg: "MetricsRegistry", fam: _Family) -> None:
        self._reg = reg
        self._fam = fam

    def _key(self, labels: dict[str, Any]) -> tuple[str, ...]:
        return tuple(str(labels.get(n, "")) for n in self._fam.label_names)

    def remove(self, **labels: Any) -> None:
        """Drop one labeled series (e.g. a provider that left the
        fleet) — labeled series otherwise live forever, and a gauge for
        a dead label set keeps exporting its last value."""
        with self._reg._lock:
            self._fam.series.pop(self._key(labels), None)


class Counter(_Handle):
    def inc(self, n: float = 1.0, **labels: Any) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        key = self._key(labels)
        with reg._lock:
            self._fam.series[key] = self._fam.series.get(key, 0.0) + n

    def value(self, **labels: Any) -> float:
        with self._reg._lock:
            return float(self._fam.series.get(self._key(labels), 0.0))


class Gauge(_Handle):
    def set(self, value: float, **labels: Any) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        with reg._lock:
            self._fam.series[self._key(labels)] = float(value)

    def add(self, n: float = 1.0, **labels: Any) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        key = self._key(labels)
        with reg._lock:
            self._fam.series[key] = self._fam.series.get(key, 0.0) + n

    def value(self, **labels: Any) -> float:
        with self._reg._lock:
            return float(self._fam.series.get(self._key(labels), 0.0))


class HistogramMetric(_Handle):
    def observe(self, value: float, **labels: Any) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        value = float(value)
        key = self._key(labels)
        fam = self._fam
        with reg._lock:
            s = fam.series.get(key)
            if s is None:
                s = [0, 0.0, value, value,
                     [0] * (len(fam.buckets) + 1),
                     deque(maxlen=RING_CAPACITY)]
                fam.series[key] = s
            s[0] += 1
            s[1] += value
            s[2] = min(s[2], value)
            s[3] = max(s[3], value)
            s[4][bisect.bisect_left(fam.buckets, value)] += 1
            s[5].append((time.monotonic(), value))


class MetricsRegistry:
    """Process-global metric families behind one lock.

    One lock on purpose: every snapshot is then a consistent cut of
    every family at once (a fleet view comparing `requests_total`
    against `tokens_out_total` must never see one family mid-update),
    and multi-thread increments are exact by construction — the
    concurrency regression test pins this. The per-operation cost is a
    short critical section at block/dispatch granularity, never per
    token."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    # ------------------------------------------------------- registration

    def _family(self, name: str, kind: str, help_: str,
                labels: Iterable[str],
                buckets: tuple[float, ...] | None = None) -> _Family:
        label_names = tuple(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help_, label_names, buckets)
                if kind in ("counter", "gauge") and not label_names:
                    # Materialize the unlabeled series at registration:
                    # a scrape then shows the family at 0 from the first
                    # request on — an empty counter is a statement, a
                    # missing one is a question. (Labeled families and
                    # histograms appear on first emission, the standard
                    # Prometheus-client behavior.)
                    fam.series[()] = 0.0
                self._families[name] = fam
            elif (fam.kind != kind or fam.label_names != label_names
                  or (buckets is not None and fam.buckets != buckets)):
                raise ValueError(
                    f"metric {name!r} re-registered as {kind}"
                    f"{label_names} buckets={buckets} (was {fam.kind}"
                    f"{fam.label_names} buckets={fam.buckets})")
            return fam

    def counter(self, name: str, help_: str = "",
                labels: Iterable[str] = ()) -> Counter:
        return Counter(self, self._family(name, "counter", help_, labels))

    def gauge(self, name: str, help_: str = "",
              labels: Iterable[str] = ()) -> Gauge:
        return Gauge(self, self._family(name, "gauge", help_, labels))

    def histogram(self, name: str, help_: str = "",
                  labels: Iterable[str] = (),
                  buckets: tuple[float, ...] = LATENCY_BUCKETS
                  ) -> HistogramMetric:
        return HistogramMetric(
            self, self._family(name, "histogram", help_, labels, buckets))

    # ---------------------------------------------------------- snapshot

    def snapshot(self, compact: bool = False) -> dict[str, Any]:
        """Every family and series as one consistent JSON-able cut.
        `compact` drops the recent-sample rings (the wire/bench shape —
        rings are for the process-local live view)."""
        with self._lock:
            families: dict[str, Any] = {}
            for name, fam in self._families.items():
                series = []
                for key, s in fam.series.items():
                    labels = dict(zip(fam.label_names, key))
                    if fam.kind == "histogram":
                        entry: dict[str, Any] = {
                            "labels": labels, "count": s[0],
                            "sum": round(s[1], 6),
                            "min": s[2], "max": s[3],
                            "buckets": [
                                [le, c] for le, c in
                                zip(list(fam.buckets) + ["+Inf"],
                                    _cumulative(s[4]))],
                        }
                        if not compact:
                            entry["recent"] = [[round(t, 4), v]
                                               for t, v in s[5]]
                    else:
                        entry = {"labels": labels, "value": s}
                    series.append(entry)
                families[name] = {"kind": fam.kind, "help": fam.help,
                                  "labels": list(fam.label_names),
                                  "series": series}
            return {"t_mono": time.monotonic(), "enabled": self.enabled,
                    "families": families}

    def reset(self) -> None:
        """Drop every family (tests; a prod process never resets)."""
        with self._lock:
            self._families.clear()


def _cumulative(counts: list[int]) -> list[int]:
    out, acc = [], 0
    for c in counts:
        acc += c
        out.append(acc)
    return out


# The process-global registry: one per OS process (provider, engine
# host, prefill node each own theirs), merged at exposition time with
# per-process extra labels (tier=...).
METRICS = MetricsRegistry()


# ----------------------------------------------------------- exposition


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                     for k, v in sorted(labels.items()) if v != "")
    return "{" + inner + "}" if inner else ""


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def render_prometheus(snapshots: list[dict[str, Any]]) -> str:
    """Merge snapshots into Prometheus text exposition format.

    Each entry is `{"snapshot": <MetricsRegistry.snapshot()>,
    "labels": {...}}` — the extra labels (e.g. `tier="prefill"`) stamp
    every series of that snapshot, which is how one provider's endpoint
    exposes its own process plus its engine host(s) as one scrape."""
    # family name -> (kind, help, [(labels, entry)...])
    merged: dict[str, tuple[str, str, list]] = {}
    order: list[str] = []
    for item in snapshots:
        snap = item.get("snapshot") or {}
        extra = dict(item.get("labels") or {})
        for name, fam in (snap.get("families") or {}).items():
            if name not in merged:
                merged[name] = (fam.get("kind", "gauge"),
                                fam.get("help", ""), [])
                order.append(name)
            for s in fam.get("series") or []:
                labels = {**(s.get("labels") or {}), **extra}
                merged[name][2].append((labels, s))
    lines: list[str] = []
    for name in order:
        kind, help_, series = merged[name]
        if help_:
            lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {kind}")
        for labels, s in series:
            if kind == "histogram":
                for le, c in s.get("buckets") or []:
                    lines.append(
                        f"{name}_bucket"
                        f"{_label_str({**labels, 'le': str(le)})} {c}")
                lines.append(f"{name}_sum{_label_str(labels)} "
                             f"{_fmt(s.get('sum', 0.0))}")
                lines.append(f"{name}_count{_label_str(labels)} "
                             f"{s.get('count', 0)}")
            else:
                lines.append(
                    f"{name}{_label_str(labels)} "
                    f"{_fmt(s.get('value', 0.0))}")
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> dict[str, dict[str, Any]]:
    """The inverse of render_prometheus, enough for symtop and the CI
    smoke: `{family: {"kind", "series": [{"labels", "value"}]}}`.
    Histogram `_bucket`/`_sum`/`_count` sample lines fold back under
    their family name with the suffix recorded per sample."""
    fams: dict[str, dict[str, Any]] = {}
    types: dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) >= 4:
                types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        # name{labels} value   |   name value
        brace = line.find("{")
        labels: dict[str, str] = {}
        if brace >= 0:
            name = line[:brace]
            end = line.rfind("}")
            body, rest = line[brace + 1:end], line[end + 1:]
            for part in _split_labels(body):
                if "=" in part:
                    k, v = part.split("=", 1)
                    labels[k.strip()] = v.strip().strip('"')
        else:
            name, _, rest = line.partition(" ")
        try:
            value = float(rest.strip())
        except ValueError:
            continue
        base, suffix = name, ""
        for suf in ("_bucket", "_sum", "_count"):
            if name.endswith(suf) and name[:-len(suf)] in types:
                base, suffix = name[:-len(suf)], suf
                break
        fam = fams.setdefault(base, {"kind": types.get(base, "untyped"),
                                     "series": []})
        fam["series"].append({"labels": labels, "value": value,
                              "suffix": suffix})
    return fams


def _split_labels(body: str) -> list[str]:
    """Split a label body on commas outside quotes."""
    out, cur, quoted = [], [], False
    for ch in body:
        if ch == '"':
            quoted = not quoted
        if ch == "," and not quoted:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


def histogram_quantile(buckets: list[tuple[float, float]],
                       q: float) -> float | None:
    """Prometheus-style quantile estimate from cumulative (le, count)
    buckets (le may be the string "+Inf"). Linear interpolation within
    the winning bucket; None when empty."""
    if not buckets:
        return None
    total = buckets[-1][1]
    if total <= 0:
        return None
    rank = q * total
    prev_le, prev_c = 0.0, 0.0
    for le, c in buckets:
        bound = float("inf") if le in ("+Inf", float("inf")) else float(le)
        if c >= rank:
            if bound == float("inf"):
                return prev_le or None
            if c == prev_c:
                return bound
            return prev_le + (bound - prev_le) * (rank - prev_c) / (c - prev_c)
        prev_le, prev_c = (0.0 if bound == float("inf") else bound), c
    return prev_le or None


class MetricsServer:
    """Prometheus exposition endpoint on stdlib http.server.

    One daemon thread, GET /metrics → `render()` (a callable returning
    the exposition text — the provider's bridges into its event loop).
    Port 0 binds ephemeral; `.port` is the bound port either way."""

    def __init__(self, render: Callable[[], str],
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self._render = render
        self._host = host
        self._want_port = port
        self._httpd: http.server.ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        assert self._httpd is not None, "metrics server not started"
        return self._httpd.server_address[1]

    def start(self) -> None:
        render = self._render

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 — http.server API
                if self.path.split("?", 1)[0] != "/metrics":
                    self.send_error(404)
                    return
                try:
                    body = render().encode("utf-8")
                except Exception as exc:  # noqa: BLE001 — scrape must not die
                    self.send_error(500, str(exc)[:80])
                    return
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; "
                                 "charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args: Any) -> None:
                pass  # scrapes must not spam stderr

        self._httpd = http.server.ThreadingHTTPServer(
            (self._host, self._want_port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-http",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


# ---------------------------------------------------------- SLO monitor


class _BurnWindow:
    """One sliding window's good/bad tallies, O(1) amortized per event:
    counts move incrementally on append/evict instead of rescanning the
    deque — observe() sits on the per-chunk streaming hot path, and a
    full-window scan there would inflate the very inter-chunk gaps it
    measures."""

    __slots__ = ("window_s", "events", "good", "bad")

    MAX_EVENTS = 65536  # absolute cap (fixed memory)

    def __init__(self, window_s: float) -> None:
        self.window_s = window_s
        self.events: deque = deque()
        self.good = 0
        self.bad = 0

    def _evict_one(self) -> None:
        _, was_ok = self.events.popleft()
        if was_ok:
            self.good -= 1
        else:
            self.bad -= 1

    def add(self, t: float, ok: bool) -> None:
        if len(self.events) >= self.MAX_EVENTS:
            self._evict_one()
        self.events.append((t, ok))
        if ok:
            self.good += 1
        else:
            self.bad += 1

    def prune(self, now: float) -> None:
        horizon = now - self.window_s
        while self.events and self.events[0][0] < horizon:
            self._evict_one()

    def burn(self, budget: float) -> tuple[float, int]:
        total = self.good + self.bad
        if total == 0:
            return 0.0, 0
        return (self.bad / total) / budget, total


class SloMonitor:
    """Multiwindow burn-rate evaluation over good/bad request events.

    Config (the provider's `slo:` block; every key optional except at
    least one target):

        slo:
          ttft_s: 2.0            # TTFT target — over it, the event is bad
          inter_chunk_s: 1.0     # inter-chunk gap target
          objective: 0.99        # fraction of events that must be good
          fast_window_s: 300.0   # fast burn window
          slow_window_s: 3600.0  # slow burn window
          burn_threshold: 10.0   # breach when BOTH windows burn >= this
          min_samples: 12        # slow window needs this many events
          min_interval_s: 300.0  # rate limit between breach events

    Burn rate = (bad fraction in window) / (1 - objective): 1.0 means
    the error budget is being spent exactly at the sustainable rate,
    `burn_threshold` means that many times faster. Requiring both
    windows is the standard multiwindow guard: the fast window makes
    the signal responsive, the slow window keeps one bad burst from
    paging — and `min_samples` keeps the slow window honest while it is
    still cold (right after startup both windows hold the SAME few
    events, so without a floor one slow cold-start request would page a
    healthy fleet). `clock` is injectable so tests drive the windows
    deterministically."""

    def __init__(self, config: dict[str, Any] | None, *,
                 clock: Callable[[], float] = time.monotonic,
                 on_breach: Callable[[dict[str, Any]], None] | None = None
                 ) -> None:
        cfg = dict(config or {})
        self.objective = float(cfg.get("objective", 0.99))
        self.fast_window_s = float(cfg.get("fast_window_s", 300.0))
        self.slow_window_s = float(cfg.get("slow_window_s", 3600.0))
        self.burn_threshold = float(cfg.get("burn_threshold", 10.0))
        self.min_interval_s = float(cfg.get("min_interval_s", 300.0))
        self.min_samples = int(cfg.get("min_samples", 12))
        self.targets: dict[str, float] = {}
        for key, name in (("ttft_s", "ttft"),
                          ("inter_chunk_s", "inter_chunk"),
                          ("e2e_s", "e2e")):
            if cfg.get(key) is not None:
                self.targets[name] = float(cfg[key])
        self._clock = clock
        self._on_breach = on_breach
        self._lock = threading.Lock()
        self._windows: dict[str, tuple[_BurnWindow, _BurnWindow]] = {
            name: (_BurnWindow(self.fast_window_s),
                   _BurnWindow(self.slow_window_s))
            for name in self.targets}
        self._last_breach: dict[str, float] = {}
        self._burn_gauge = METRICS.gauge(
            MetricName.SLO_BURN_RATE,
            "error-budget burn rate per SLO and window",
            labels=("slo", "window"))
        self._breach_counter = METRICS.counter(
            MetricName.SLO_BREACHES,
            "SLO burn-rate breach events", labels=("slo",))

    @property
    def enabled(self) -> bool:
        return bool(self.targets)

    def observe(self, slo: str, value_s: float) -> dict[str, Any] | None:
        """Record one measurement and evaluate its rule. Returns the
        breach event when this observation tips (or keeps) both windows
        over the threshold and the rate limit allows one, else None."""
        target = self.targets.get(slo)
        if target is None:
            return None
        now = self._clock()
        ok = value_s <= target
        with self._lock:
            for w in self._windows[slo]:
                w.add(now, ok)
        return self._evaluate_one(slo, now)

    def _evaluate_one(self, slo: str, now: float) -> dict[str, Any] | None:
        budget = max(1.0 - self.objective, 1e-9)
        with self._lock:
            fast_w, slow_w = self._windows[slo]
            fast_w.prune(now)
            slow_w.prune(now)
            fast, n_fast = fast_w.burn(budget)
            slow, n_slow = slow_w.burn(budget)
        self._burn_gauge.set(round(fast, 3), slo=slo, window="fast")
        self._burn_gauge.set(round(slow, 3), slo=slo, window="slow")
        if (n_slow < self.min_samples
                or fast < self.burn_threshold
                or slow < self.burn_threshold):
            return None
        with self._lock:
            last = self._last_breach.get(slo, -1e18)
            if now - last < self.min_interval_s:
                return None
            self._last_breach[slo] = now
        self._breach_counter.inc(slo=slo)
        event = {"slo": slo, "target_s": self.targets[slo],
                 "objective": self.objective,
                 "burn_fast": round(fast, 3), "burn_slow": round(slow, 3),
                 "fast_window_s": self.fast_window_s,
                 "slow_window_s": self.slow_window_s,
                 "burn_threshold": self.burn_threshold,
                 "samples_fast": n_fast, "samples_slow": n_slow,
                 "t_mono": round(now, 4)}
        if self._on_breach is not None:
            self._on_breach(event)
        return event

    def burn_rate(self, now: float | None = None) -> float:
        """Current worst fast-window burn across every configured SLO,
        pruned live — the placement input the elastic disagg pool's
        router consumes (PoolRouter.update_gauges burn_rate): a tier
        that is burning error budget should stop winning placement
        ties. 0.0 when no SLO is configured or nothing has burned."""
        if not self.targets:
            return 0.0
        now = self._clock() if now is None else now
        budget = max(1.0 - self.objective, 1e-9)
        worst = 0.0
        with self._lock:
            for fast_w, _slow_w in self._windows.values():
                fast_w.prune(now)
                burn, _n = fast_w.burn(budget)
                worst = max(worst, burn)
        return worst

    def burn_rates(self, now: float | None = None) -> dict[str, float]:
        """Per-SLO fast-window burns, pruned live — the autoscaler's
        tier-pressure input: `ttft` burn implicates the prefill tier,
        `inter_chunk` the decode tier (burn_rate() collapses both into
        one worst-case number, which can place but cannot steer).
        Empty dict when no SLO is configured."""
        if not self.targets:
            return {}
        now = self._clock() if now is None else now
        budget = max(1.0 - self.objective, 1e-9)
        out: dict[str, float] = {}
        with self._lock:
            for slo, (fast_w, _slow_w) in self._windows.items():
                fast_w.prune(now)
                burn, _n = fast_w.burn(budget)
                out[slo] = burn
        return out

    def evaluate(self, now: float | None = None) -> list[dict[str, Any]]:
        """Evaluate every rule (periodic path — observe() already
        evaluates inline); returns the breach events triggered."""
        now = self._clock() if now is None else now
        out = []
        for slo in self.targets:
            ev = self._evaluate_one(slo, now)
            if ev is not None:
                out.append(ev)
        return out
