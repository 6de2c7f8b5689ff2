"""The provider node: the heart of the framework.

Re-creation of the reference's `SymmetryProvider` lifecycle
(src/provider.ts:21-323) — swarm presence, server registration with challenge
auth, per-peer inference streaming with backpressure, data collection — with
the deliberate upgrades SURVEY §§3-5 call for:

  - enforced mutual auth (reference's server verification is advisory,
    src/provider.ts:157-171)
  - session tokens verified offline against the trusted serverKey
  - accurate connection accounting reported to the server (the reference's
    `_providerConnections` counter is decremented but never incremented —
    latent bug, src/provider.ts:76-80)
  - reconnect-with-backoff to the server; the reference never reconnects
  - graceful drain on shutdown + explicit `leave` (the reference defines the
    key but never sends it, src/constants.ts:11)
  - backend health checks: a wedged engine deregisters the provider
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import time
from collections import deque
from typing import Any

from symmetry_tpu_torch.identity import Identity
from symmetry_tpu_torch.network.peer import Peer
from symmetry_tpu_torch.protocol.keys import MessageKey
from symmetry_tpu_torch.provider.backends.base import (
    BackendDeadlineError,
    BackendError,
    BackendRestartingError,
    InferenceBackend,
    InferenceRequest,
    get_backend,
)
from symmetry_tpu_torch.provider.collect import DataCollector
from symmetry_tpu_torch.provider.config import ConfigManager
from symmetry_tpu_torch.server import tokens as session_tokens
from symmetry_tpu_torch.transport.base import Connection, Listener, Transport
from symmetry_tpu_torch.utils.faults import FAULTS, InjectedFault
from symmetry_tpu_torch.utils.logging import log_context, logger
from symmetry_tpu_torch.utils.metrics import (
    METRICS,
    MetricName,
    MetricsServer,
    SloMonitor,
    render_prometheus,
)
from symmetry_tpu_torch.utils.trace import FlightRecorder, Histogram, Tracer

RECONNECT_BASE_S = 1.0
RECONNECT_MAX_S = 60.0
HEALTH_INTERVAL_S = 15.0


def _load_or_create_secret(path: str) -> bytes:
    """Per-node secret salting the name-derived identity seed.

    Keeps the reference's UX (stable identity from the configured name,
    src/provider.ts:41-43) without its guessable-identity flaw.
    """
    path = os.path.expanduser(path)
    if os.path.exists(path):
        with open(path, "rb") as fh:
            return fh.read()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    secret = os.urandom(32)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
    with os.fdopen(fd, "wb") as fh:
        fh.write(secret)
    return secret


class SymmetryProvider:
    def __init__(
        self,
        config: ConfigManager | str | None = None,
        *,
        transport: Transport | None = None,
        identity: Identity | None = None,
        backend: InferenceBackend | None = None,
        server_address: str | None = None,
    ) -> None:
        if isinstance(config, ConfigManager):
            self.config = config
        else:
            self.config = ConfigManager(config_path=config)
        if transport is None:
            from symmetry_tpu_torch.transport import transport_for

            # Scheme-select from the server address — constructor override
            # first, then config (udp:// engages the native udpstream
            # transport; default tcp).
            transport = transport_for(
                server_address or self.config.get("serverAddress") or "")
        self._transport = transport
        if identity is None:
            seed_hex = self.config.get("privateSeed")
            if seed_hex:
                identity = Identity.from_seed(bytes.fromhex(seed_hex))
            else:
                secret_path = self.config.get(
                    "secretPath",
                    os.path.join(self.config.get("path", "~/.config/symmetry"),
                                 "identity.secret"),
                )
                identity = Identity.from_name(
                    self.config.name, _load_or_create_secret(secret_path)
                )
        self.identity = identity
        self.backend = backend if backend is not None else get_backend(self.config)
        self.collector = DataCollector(
            self.config.get("path", "~/.config/symmetry"),
            self.config.data_collection_enabled,
        )
        self._server_address = server_address or self.config.get("serverAddress")
        self._listener: Listener | None = None
        self._server_peer: Peer | None = None
        self._dht: Any = None  # network/dht.py DHTNode when dht: configured
        self._client_peers: set[Peer] = set()
        self._conversation_index: dict[str, int] = {}
        # multiplexed inference: (peer, requestId) -> pump task, so an
        # inferenceCancel can abort exactly one stream
        self._inference_tasks: dict[tuple[int, str], asyncio.Task] = {}
        self._tasks: set[asyncio.Task] = set()
        self._draining = False
        self._in_flight = 0
        self._stopped = asyncio.Event()
        self._server_ready = asyncio.Event()
        # Metrics (SURVEY §5.5: tok/s, queue depth first-class). The TTFT
        # and end-to-end distributions stats() reports are observed where
        # their spans are recorded — p50/p99 TTFT is the BASELINE.json
        # headline metric. The registry's _m_ttft/_m_e2e below see the
        # same values but cannot stand in: they are process-wide (every
        # provider of the process, and off with the registry) and give
        # bucketed percentiles, where these are this provider's, exact up
        # to the reservoir.
        self._ttft_hist = Histogram()
        self._e2e_hist = Histogram()
        self.tracer = Tracer()
        self.metrics: dict[str, Any] = {
            "requests": 0, "tokens_out": 0, "errors": 0, "shed": 0,
        }
        self._last_load_report = -1e9  # throttles shed-triggered METRICS
        # Emit-path wire accounting: closed peers fold their transport
        # write counters in here; stats() adds the live peers on top, so
        # the totals survive disconnects (WriteCork, transport/base.py).
        self._wire_totals = {"writes": 0, "frames": 0,
                             "coalesced_frames": 0, "bytes": 0}
        # TTFT-bounded admission state: requests accepted but not yet
        # streaming, and recent first-token completion stamps (the
        # admission-rate signal the wait estimate divides by).
        self._unstarted = 0
        self._first_token_stamps: deque[float] = deque(maxlen=512)
        self._started_at = time.monotonic()
        # Always-on flight recorder (utils/trace.py): the span rings are
        # already recording; this owns the trigger — SLO breach, backend
        # error, or SIGUSR2 dumps the merged last-window timeline + a
        # stats snapshot to one JSON file, so the LAST bad request is
        # debuggable after the fact. Config (all optional):
        #   flightRecorder: {enabled, dir, windowS, minIntervalS, sloE2eS}
        fr_cfg = self.config.get("flightRecorder") or {}
        self.flight: FlightRecorder | None = None
        if fr_cfg.get("enabled", True):
            slo = fr_cfg.get("sloE2eS")
            self.flight = FlightRecorder(
                fr_cfg.get("dir") or os.path.join(
                    self.config.get("path", "~/.config/symmetry"),
                    "flight"),
                window_s=float(fr_cfg.get("windowS", 30.0)),
                min_interval_s=float(fr_cfg.get("minIntervalS", 30.0)),
                # Coerced at construction like its siblings: a quoted
                # YAML value must fail/convert HERE, not as a TypeError
                # in the per-request SLO comparison.
                slo_e2e_s=float(slo) if slo is not None else None)
        # Fault injection (utils/faults.py): a `faults:` mapping in
        # provider.yaml arms seams in THIS process (the host subprocess
        # loads the same mapping from its config copy; SYMMETRY_FAULTS
        # env reaches both at import). No-op when absent.
        FAULTS.load(self.config.get("faults"))
        # ---- always-on fleet telemetry (utils/metrics.py) ------------
        # The registry families this provider emits. Registered HERE so
        # the exposition endpoint shows every family from the first
        # scrape (an empty counter is a statement; a missing one is a
        # question). `metrics:` config block:
        #   metrics: {enabled: true, port: 9100, host: "127.0.0.1"}
        # port absent/None → no HTTP endpoint (the peer-wire metrics
        # reply still carries the snapshots); port 0 → ephemeral.
        m_cfg = self.config.get("metrics") or {}
        METRICS.enabled = bool(m_cfg.get("enabled", True))
        self._metrics_cfg = m_cfg
        self.metrics_server: MetricsServer | None = None
        self._m_requests = METRICS.counter(
            MetricName.PROVIDER_REQUESTS, "inference requests accepted")
        self._m_tokens_out = METRICS.counter(
            MetricName.PROVIDER_TOKENS_OUT, "tokens streamed to clients")
        self._m_errors = METRICS.counter(
            MetricName.PROVIDER_ERRORS, "inference requests failed")
        self._m_sheds = METRICS.counter(
            MetricName.PROVIDER_SHEDS,
            "requests shed before service", labels=("reason",))
        self._m_in_flight = METRICS.gauge(
            MetricName.PROVIDER_IN_FLIGHT, "requests currently in flight")
        self._m_pending_first = METRICS.gauge(
            MetricName.PROVIDER_PENDING_FIRST_TOKEN,
            "accepted requests not yet streaming")
        self._m_connections = METRICS.gauge(
            MetricName.PROVIDER_CONNECTIONS, "connected client peers")
        self._m_uptime = METRICS.gauge(
            MetricName.PROVIDER_UPTIME, "seconds since provider start")
        self._m_ttft = METRICS.histogram(
            MetricName.PROVIDER_TTFT, "time to first streamed token")
        self._m_e2e = METRICS.histogram(
            MetricName.PROVIDER_E2E, "end-to-end request latency")
        self._m_inter_chunk = METRICS.histogram(
            MetricName.PROVIDER_INTER_CHUNK,
            "gap between consecutive streamed chunks")
        self._m_backend_restarts = METRICS.counter(
            MetricName.PROVIDER_BACKEND_RESTARTS,
            "engine-host deaths handled by the supervisor")
        self._m_flight_dumps = METRICS.counter(
            MetricName.PROVIDER_FLIGHT_DUMPS,
            "flight-recorder dumps written", labels=("reason",))
        # On-demand device profiler (utils/devprof.py, HostOp.PROFILE):
        # a bounded jax.profiler capture on the serving engine,
        # triggered by the `profileCapture` wire op, SIGUSR1, or — when
        # profiler.onSloBreach is set — the SLO burn hook beside the
        # flight recorder. Config (all optional):
        #   profiler: {dir, durationS, onSloBreach}
        self._profiler_cfg = self.config.get("profiler") or {}
        self._profile_running = False
        self._m_profile_captures = METRICS.counter(
            MetricName.PROFILE_CAPTURES,
            "on-demand device profile captures", labels=("reason",))
        # Stream resumption: resumes served (accepted/refused) and the
        # recovery-latency headline — interruption to first CONTINUATION
        # token (the resume request's TTFT as this provider saw it).
        self._m_resumes = METRICS.counter(
            MetricName.PROVIDER_RESUMES,
            "resume requests handled", labels=("outcome",))
        self._m_resume_ttft = METRICS.histogram(
            MetricName.RESUME_TTFT,
            "time to first continuation token of a resume request")
        # symledger fold (`tpu.ledger` knob, on by default): engine
        # backends stamp a per-request cost block on their terminal
        # stream chunk; this side judges SLO attainment for the request
        # (EVERY configured slo: target met — ttft, e2e, worst
        # inter-chunk gap; no targets configured ⇒ trivially attained),
        # exports the per-request attribution families, and maintains
        # the goodput headline: SLO-attaining tokens per attributed
        # device second over the last `maxlen` finished requests. With
        # the knob off no cost blocks arrive and the fold is one dead
        # branch per request.
        self._ledger_on = bool(getattr(
            getattr(self.config, "tpu", None), "ledger", True))
        self._m_req_device_s = METRICS.histogram(
            MetricName.REQUEST_DEVICE_SECONDS,
            "attributed device seconds per finished request",
            labels=("phase",))
        self._m_req_wasted_s = METRICS.counter(
            MetricName.REQUEST_WASTED_SECONDS,
            "device seconds spent on work no client kept",
            labels=("reason",))
        self._m_goodput = METRICS.gauge(
            MetricName.GOODPUT_TOKENS_PER_DEVICE_S,
            "windowed SLO-attaining tokens per attributed device second")
        # (tokens, device_s, attained) per finished request — the
        # goodput gauge's window; the cost ring is the flight
        # recorder's per-request attribution tail.
        self._goodput_window: deque[tuple[int, float, bool]] = deque(
            maxlen=256)
        self._cost_ring: deque[dict] = deque(maxlen=64)
        # SLO burn-rate monitor (`slo:` config block, utils/metrics.py):
        # continuous evaluation over the request stream; a budget burn
        # triggers the flight recorder + a structured log event — SLO
        # breach as a first-class signal, not a bench-time observation.
        self.slo = SloMonitor(self.config.get("slo"),
                              on_breach=self._on_slo_breach)
        if hasattr(self.backend, "attach_slo_monitor"):
            # Live placement input (ROADMAP item 4 remainder): the
            # tpu_native pool heartbeat feeds this monitor's fast-window
            # burn rate into PoolRouter.update_gauges, so placement's
            # burn tie-break runs on the real request stream instead of
            # only queue depth.
            self.backend.attach_slo_monitor(self.slo)

    # ----- lifecycle (reference: init(), src/provider.ts:37-81) -----

    @property
    def address(self) -> str:
        assert self._listener is not None, "provider not started"
        return self._listener.address

    async def start(self, listen_address: str | None = None) -> None:
        await self.backend.start()
        if hasattr(self.backend, "on_host_restart"):
            # Supervised engine host (tpu_native process mode): every
            # crash/wedge the supervisor handles dumps the flight
            # recorder FIRST — the restart must not erase the evidence.
            self.backend.on_host_restart = self._on_backend_restart
        listen_address = listen_address or (
            f"{self._transport.scheme}://"
            f"{self.config.get('listenHost', '0.0.0.0')}"
            f":{self.config.get('listenPort', 0)}"
        )
        self._listener = await self._transport.listen(listen_address, self._on_peer)
        logger.info(
            f"provider {self.config.name!r} listening on {self.address} "
            f"key={self.identity.public_hex} model={self.config.model_name!r}"
        )
        if self.config.public:
            self._spawn(self._server_loop())
        self._spawn(self._health_loop())
        await self._join_dht()
        self._start_puncher()
        self._install_sigusr2()
        self._install_sigusr1()
        self._start_metrics_server()

    def _start_metrics_server(self) -> None:
        """Prometheus exposition endpoint (`metrics.port`): a stdlib
        http.server thread serving GET /metrics with this process's
        registry merged with the engine host(s)' tier-labeled
        snapshots. Best-effort: a bound-port failure must not take down
        an otherwise healthy provider."""
        port = self._metrics_cfg.get("port")
        if port is None or not METRICS.enabled:
            return
        loop = asyncio.get_running_loop()

        def render() -> str:
            # Scrape threads bridge into the event loop: the engine
            # host probe is async (pipe round-trip), and the loop owns
            # every waiter list.
            fut = asyncio.run_coroutine_threadsafe(
                self._metrics_exposition(), loop)
            return fut.result(timeout=10.0)

        try:
            server = MetricsServer(
                render, host=self._metrics_cfg.get("host", "127.0.0.1"),
                port=int(port))
            server.start()
        except OSError as exc:
            logger.error(f"metrics endpoint disabled: {exc}")
            return
        self.metrics_server = server
        logger.info(f"metrics: http://"
                    f"{self._metrics_cfg.get('host', '127.0.0.1')}:"
                    f"{server.port}/metrics")

    async def metrics_snapshots(self) -> list[dict]:
        """This process's registry snapshot plus the backend's
        tier-labeled engine-host snapshots — the payload of the
        peer-wire metrics reply and the HTTP exposition alike."""
        self._m_uptime.set(round(time.monotonic() - self._started_at, 1))
        snaps = [{"snapshot": METRICS.snapshot(compact=True),
                  "labels": {}}]
        fn = getattr(self.backend, "metrics_snapshots", None)
        if fn is not None:
            try:
                snaps.extend(await fn() or [])
            except Exception as exc:  # noqa: BLE001 — scrape is diagnostics
                logger.warning(f"backend metrics snapshot failed: {exc}")
        return snaps

    async def _metrics_exposition(self) -> str:
        return render_prometheus(await self.metrics_snapshots())

    def _on_slo_breach(self, event: dict) -> None:
        """SLO budget burn: one structured log event (JSON mode carries
        component="slo", t_mono, and the ambient trace_id of the
        request that tipped the budget) plus a flight-recorder dump —
        the window that contains the burn, captured while it is still
        in the rings."""
        with log_context(component="slo"):
            logger.error(
                f"SLO burn: {event['slo']} target "
                f"{event['target_s']}s objective {event['objective']} — "
                f"burn fast {event['burn_fast']}x / slow "
                f"{event['burn_slow']}x over threshold "
                f"{event['burn_threshold']}x "
                f"({event['samples_fast']} samples in "
                f"{event['fast_window_s']:.0f}s)")
        if self.flight is not None:
            self._spawn(self._flight_dump(f"slo_burn_{event['slo']}",
                                          force=True))
        if self._profiler_cfg.get("onSloBreach"):
            # Opt-in: a capture serializes sampled dispatches for its
            # whole window, so burning error budget has to be judged
            # worth the heavier evidence explicitly. The flight dump
            # above shows WHAT burned; this shows what the DEVICE was
            # doing while it burned.
            self._spawn(self._capture_profile(
                f"slo_burn_{event['slo']}"))

    def _install_sigusr2(self) -> None:
        """SIGUSR2 → flight-recorder dump (operator-triggered capture of
        the last N seconds, no restart, no client needed). Best-effort:
        unavailable off the main thread and on non-Unix loops."""
        self._sigusr2_installed = False
        if self.flight is None:
            return
        import signal

        try:
            asyncio.get_running_loop().add_signal_handler(
                signal.SIGUSR2,
                lambda: self._spawn(self._flight_dump("sigusr2",
                                                      force=True)))
            self._sigusr2_installed = True
        except (NotImplementedError, ValueError, RuntimeError):
            logger.debug("SIGUSR2 flight-recorder trigger unavailable "
                         "on this platform/thread")

    async def _capture_profile(self, reason: str,
                               duration_s: float | None = None) -> dict:
        """Run one on-demand device profile capture through the backend
        (HostOp.PROFILE underneath). Single-flight: a capture already
        in progress returns a structured error instead of queueing —
        jax.profiler refuses concurrent traces, and stacking windows
        behind an operator's trigger would measure the wrong moment."""
        fn = getattr(self.backend, "capture_profile", None)
        if fn is None:
            return {"error": "backend has no device profiler"}
        if self._profile_running:
            return {"error": "a profile capture is already running"}
        self._profile_running = True
        try:
            out = await fn(
                duration_s=float(
                    duration_s if duration_s is not None
                    else self._profiler_cfg.get("durationS", 2.0)),
                out_dir=self._profiler_cfg.get("dir"))
        except Exception as exc:  # noqa: BLE001 — diagnostics only
            out = {"error": str(exc)}
        finally:
            self._profile_running = False
        if out.get("path"):
            self._m_profile_captures.inc(reason=reason)
            logger.warning(f"device profile ({reason}) → {out['path']}")
        else:
            logger.warning(f"device profile ({reason}) failed: "
                           f"{out.get('error')}")
        return out

    def _install_sigusr1(self) -> None:
        """SIGUSR1 → on-demand device profile capture (the operator's
        'what is the chip doing RIGHT NOW' trigger, the jax.profiler
        analog of SIGUSR2's flight dump). Best-effort like SIGUSR2."""
        self._sigusr1_installed = False
        if getattr(self.backend, "capture_profile", None) is None:
            return
        import signal

        try:
            asyncio.get_running_loop().add_signal_handler(
                signal.SIGUSR1,
                lambda: self._spawn(self._capture_profile("sigusr1")))
            self._sigusr1_installed = True
        except (NotImplementedError, ValueError, RuntimeError):
            logger.debug("SIGUSR1 profile-capture trigger unavailable "
                         "on this platform/thread")

    def _on_backend_restart(self, reason: str) -> None:
        """Backend supervisor hook: an engine-host death/wedge is being
        handled. Leave the debuggable artifact (forced flight dump — the
        window still holds the death) and say so loudly."""
        logger.error(f"engine host {reason}; supervisor restarting it")
        self._m_backend_restarts.inc()
        if self.flight is not None:
            self._spawn(self._flight_dump(f"host_{reason}", force=True))

    def _start_puncher(self) -> None:
        """NAT hole punching (network/natpunch.py): keep this provider
        registered at a rendezvous and answer punch invites, so clients
        behind NATs can reach the UDP listener directly. Requires the
        native udp transport (the raw side channel rides its socket)."""
        self._puncher = None
        punch_cfg = self.config.get("natPunch")
        if not punch_cfg:
            return
        raw_factory = getattr(self._listener, "raw_channel", None)
        if raw_factory is None:
            logger.warning("natPunch configured but the transport has no "
                           "raw channel (udp:// required); punching disabled")
            return
        from symmetry_tpu_torch.network.dht import parse_host_port
        from symmetry_tpu_torch.network.natpunch import ProviderPuncher

        try:
            rdv = parse_host_port(punch_cfg["rendezvous"])
        except (KeyError, ValueError) as exc:
            logger.error(f"natPunch disabled: {exc}")
            return
        self._puncher = ProviderPuncher(raw_factory(), rdv, self.identity)
        self._puncher.start()

    async def _join_dht(self) -> None:
        """Announce on the Kademlia DHT (network/dht.py) so clients can
        discover this provider WITHOUT the central server — the reference's
        hyperswarm topic-announce (src/provider.ts:44-48), decentralized
        leg. Topic = discovery_key(our public key)."""
        dht_cfg = self.config.get("dht")
        if not dht_cfg:
            return
        from symmetry_tpu_torch.network.dht import DHTNode, parse_host_port

        # Discovery is an add-on: NO failure here (bad config, occupied
        # UDP port, unreachable bootstrap) may take down an otherwise
        # healthy provider.
        try:
            bootstrap = [parse_host_port(e)
                         for e in dht_cfg.get("bootstrap", [])]
            # The identity signs announce records: DHT nodes verify them
            # against our publicKey, so nobody can shadow or evict this
            # provider's discovery record (network/dht.py).
            self._dht = DHTNode(identity=self.identity)
            await self._dht.start(dht_cfg.get("host", "0.0.0.0"),
                                  int(dht_cfg.get("port", 0)),
                                  bootstrap=bootstrap)
            stored = await self._dht.announce(self.identity.discovery_key, {
                "address": self.address,
                "publicKey": self.identity.public_hex,
                "modelName": self.config.model_name,
            })
        except (ValueError, TypeError, OSError) as exc:
            logger.error(f"dht disabled: {exc}")
            if self._dht is not None:
                await self._dht.stop()
                self._dht = None
            return
        logger.info(f"dht: announced on {stored} node(s) "
                    f"(topic {self.identity.discovery_key.hex()[:12]}…)")

    async def wait_registered(self, timeout: float = 10.0) -> None:
        await asyncio.wait_for(self._server_ready.wait(), timeout)

    async def stop(self, drain_timeout_s: float = 30.0) -> None:
        """Graceful drain: stop accepting, finish in-flight, leave, close."""
        self._draining = True
        if self.metrics_server is not None:
            # First: a scrape against a draining provider should fail
            # fast, not hold the drain window open.
            await asyncio.to_thread(self.metrics_server.stop)
            self.metrics_server = None
        if getattr(self, "_sigusr2_installed", False):
            import signal

            with contextlib.suppress(Exception):
                asyncio.get_running_loop().remove_signal_handler(
                    signal.SIGUSR2)
            self._sigusr2_installed = False
        if getattr(self, "_puncher", None) is not None:
            await self._puncher.stop()
            self._puncher = None
        if self._dht is not None:
            with contextlib.suppress(Exception):
                await self._dht.unannounce(self.identity.discovery_key)
            await self._dht.stop()
            self._dht = None
        deadline = time.monotonic() + drain_timeout_s
        while self._in_flight > 0 and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
        if self._server_peer is not None and not self._server_peer.closed:
            with contextlib.suppress(ConnectionError, OSError):
                await self._server_peer.send(MessageKey.LEAVE)
            await self._server_peer.close()
        self._stopped.set()
        for task in list(self._tasks):
            task.cancel()
        for peer in list(self._client_peers):
            await peer.close()
        if self._listener is not None:
            await self._listener.close()
        await self.backend.stop()

    def _spawn(self, coro) -> asyncio.Task:
        task = asyncio.ensure_future(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    # ----- server registration (reference: joinServer(), src/provider.ts:83-131) -----

    async def _server_loop(self) -> None:
        """Maintain the server connection with exponential backoff."""
        backoff = RECONNECT_BASE_S
        while not self._stopped.is_set() and not self._draining:
            try:
                await self._join_server()
                backoff = RECONNECT_BASE_S  # reset after a successful session
            except asyncio.CancelledError:
                return
            except Exception as exc:
                if not (self._draining or self._stopped.is_set()):
                    logger.warning(f"server connection lost: {exc}")
            self._server_ready.clear()
            if self._stopped.is_set() or self._draining:
                return
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, RECONNECT_MAX_S)

    async def _join_server(self) -> None:
        if not self._server_address:
            raise RuntimeError("public provider requires serverAddress in config")
        conn = await self._transport.dial(self._server_address)
        # The handshake pins the serverKey from config — a MITM or imposter
        # server fails here and we disconnect (not advisory).
        peer = await Peer.connect(
            conn, self.identity, initiator=True,
            expected_remote_key=self.config.server_key,
        )
        self._server_peer = peer
        # Wire-parity challenge flow on top (reference src/provider.ts:95-101).
        challenge = os.urandom(32)
        await peer.send(MessageKey.CHALLENGE, {"challenge": challenge.hex()})
        await peer.send(
            MessageKey.JOIN,
            {
                # Sanitized config — never the apiKey (the reference leaks it,
                # src/provider.ts:103-108).
                "config": self.config.public_view(),
                "discoveryKey": self.identity.discovery_key.hex(),
                "address": self.address,
                "modelName": self.config.model_name,
            },
        )
        async for msg in peer:
            if msg.key == MessageKey.CHALLENGE_RESPONSE:
                sig = bytes.fromhex((msg.data or {}).get("signature", ""))
                if not Identity.verify(challenge, sig, self.config.server_key):
                    await peer.close()
                    raise ConnectionError("server failed challenge verification")
                logger.debug("server signature verified")
            elif msg.key == MessageKey.JOIN_ACK:
                logger.info("registered with server ✅")
                self._server_ready.set()
            elif msg.key == MessageKey.PING:
                await peer.send(MessageKey.PONG)
            elif msg.key == MessageKey.RELAY_OPEN:
                # NAT fallback (network/relay.py): a client that cannot
                # reach us directly asked the server to splice. Dial the
                # server back on a fresh connection and serve the client
                # through it — end-to-end encrypted, server sees only
                # ciphertext.
                relay_id = str((msg.data or {}).get("id", ""))
                if relay_id:
                    self._spawn(self._serve_relay(relay_id))
            else:
                logger.debug(f"provider: unhandled server key {msg.key!r}")
        raise ConnectionError("server closed connection")

    async def _serve_relay(self, relay_id: str) -> None:
        from symmetry_tpu_torch.network.relay import RelayedConnection, await_ready

        try:
            conn = await self._transport.dial(self._server_address)
            peer = await Peer.connect(
                conn, self.identity, initiator=True,
                expected_remote_key=self.config.server_key)
            await peer.send(MessageKey.RELAY_ACCEPT, {"id": relay_id})
            await await_ready(peer, relay_id)
        except (ConnectionError, OSError, asyncio.TimeoutError) as exc:
            logger.warning(f"relay {relay_id[:8]} setup failed: {exc}")
            return
        # From here the relayed channel is an ordinary inbound connection:
        # the client's Noise handshake (with OUR key pinned) runs through
        # it, maxConnections and session checks included.
        await self._on_peer(RelayedConnection(peer, relay_id))

    async def _report_connections(self) -> None:
        if self._server_peer is not None and not self._server_peer.closed:
            with contextlib.suppress(ConnectionError, OSError):
                await self._server_peer.send(
                    MessageKey.CONNECTION_SIZE, len(self._client_peers)
                )

    def _wire_stats(self) -> dict[str, int]:
        """Aggregate per-peer transport write counters: folded totals of
        closed peers + a live read of every open one."""
        out = dict(self._wire_totals)
        for peer in self._client_peers:
            ws = peer.write_stats
            if ws:
                for k in out:
                    out[k] += ws.get(k, 0)
        return out

    def _goodput_stats(self) -> dict[str, Any] | None:
        """Windowed goodput snapshot from the per-request cost folds:
        SLO-attaining tokens over attributed device seconds. None until
        the first cost block arrives (ledger off / nothing finished)."""
        if not self._goodput_window:
            return None
        window = list(self._goodput_window)
        good = sum(t for t, _d, a in window if a)
        total = sum(t for t, _d, _a in window)
        dev_s = sum(d for _t, d, _a in window)
        return {
            "window_requests": len(window),
            "attained_requests": sum(1 for _t, _d, a in window if a),
            "attained_tokens": good,
            "tokens": total,
            "device_s": round(dev_s, 6),
            **({"tokens_per_device_s": round(good / dev_s, 3)}
               if dev_s > 0 else {}),
        }

    def stats(self) -> dict[str, Any]:
        """Serving metrics snapshot: counters, tok/s, TTFT/e2e percentiles."""
        uptime = max(time.monotonic() - self._started_at, 1e-9)
        goodput = self._goodput_stats()
        slots = getattr(self.backend, "slots", None)
        return {
            "requests": self.metrics["requests"],
            "tokens_out": self.metrics["tokens_out"],
            "errors": self.metrics["errors"],
            "shed": self.metrics["shed"],
            "in_flight": self._in_flight,
            # Requests waiting beyond the engine's concurrent slots — the
            # router's steering signal (registry.select_provider prefers
            # providers with the smallest reported backlog).
            "queued": (max(0, self._in_flight - slots)
                       if slots is not None else 0),
            "pending_first_token": self._unstarted,
            **({"queue_limit": self.backend.queue_limit}
               if getattr(self.backend, "queue_limit", None) is not None
               else {}),
            "connections": len(self._client_peers),
            # Corked-wire emit path: writes < frames means same-tick
            # coalescing is collapsing the per-stream fan-out of batched
            # engine blocks into fewer syscalls (transport/base.WriteCork).
            "wire": self._wire_stats(),
            "uptime_s": round(uptime, 1),
            "tok_s": round(self.metrics["tokens_out"] / uptime, 2),
            "ttft_s": self._ttft_hist.to_dict(),
            "e2e_s": self._e2e_hist.to_dict(),
            # symledger headline: windowed SLO-goodput from the
            # per-request cost folds (absent until one arrives).
            **({"goodput": goodput} if goodput is not None else {}),
            # False when recent DHT announce rounds were fully rejected
            # (clock skew → silently undiscoverable; network/dht.py).
            **({"dht_discoverable": self._dht.is_discoverable}
               if self._dht is not None else {}),
            # Chaos-drill accounting: which armed fault seams fired in
            # this process (absent when no faults are configured).
            **({"faults": FAULTS.counters()} if FAULTS.enabled else {}),
        }

    async def gather_trace(self) -> dict[str, Any]:
        """Merged span-ring snapshot: this provider's tracer plus every
        component the backend contributes (tpu_native: host + scheduler,
        already reconciled onto this process's clock through the measured
        pipe offset). The `trace` wire op's reply payload; also what the
        flight recorder dumps."""
        comps = [self.tracer.component("provider")]
        fn = getattr(self.backend, "trace_components", None)
        if fn is not None:
            try:
                comps.extend(await fn() or [])
            except Exception as exc:  # noqa: BLE001 — diagnostics only
                logger.warning(f"backend trace snapshot failed: {exc}")
        return {"components": comps, "clock": time.monotonic()}

    async def _flight_dump(self, reason: str,
                           force: bool = False) -> str | None:
        """Trigger one flight-recorder dump (rate-limited unless forced)."""
        if self.flight is None:
            return None
        if not force and not self.flight.should_dump():
            return None
        payload = await self.gather_trace()
        stats = self.stats()
        engine_stats = getattr(self.backend, "engine_stats", None)
        if engine_stats is not None:
            with contextlib.suppress(Exception):
                stats["engine"] = await engine_stats()
        if self._cost_ring:
            # symledger tail: the last requests' attributed cost blocks
            # — the dump answers "what was the device doing" per
            # request, not just in aggregate.
            stats["ledger_tail"] = list(self._cost_ring)
        try:
            path = self.flight.dump(reason, payload["components"],
                                    stats=stats)
        except OSError as exc:
            logger.error(f"flight recorder write failed: {exc}")
            return None
        self._m_flight_dumps.inc(reason=reason)
        logger.warning(f"flight recorder: {reason} → {path}")
        return path

    async def _health_loop(self) -> None:
        """Backend health → presence (SURVEY §5.3: engine wedge must
        unregister the provider); piggybacks the load-metrics report the
        protocol reserves the `metrics` key for."""
        while not self._stopped.is_set():
            await asyncio.sleep(HEALTH_INTERVAL_S)
            try:
                ok = await self.backend.healthy()
            except Exception:
                ok = False
            if self._server_peer is not None and not self._server_peer.closed:
                if not ok:
                    logger.error("backend unhealthy; leaving server")
                    with contextlib.suppress(ConnectionError, OSError):
                        await self._server_peer.send(MessageKey.LEAVE)
                else:
                    with contextlib.suppress(ConnectionError, OSError):
                        await self._server_peer.send(MessageKey.METRICS,
                                                     self.stats())

    # ----- client peers (reference: listeners(), src/provider.ts:173-193) -----

    async def _refuse_peer(self, conn: Connection, reason: str,
                           draining: bool = False) -> None:
        """Refuse a new connection LOUDLY: complete the handshake, send a
        structured shed, close. The old silent close left the dialer
        hanging in its Noise handshake until some timeout — a refusing
        provider must cost a client milliseconds, not a timeout, before
        it fails over. `draining` marks the shed terminal for THIS
        provider (shutting down — never coming back), vs a busy/capacity
        shed that a backoff retry may legitimately revisit."""
        self.metrics["shed"] += 1
        self._m_sheds.inc(
            reason="draining" if draining else "connection_limit")
        try:
            # Short handshake hold on purpose: the refusal path runs
            # exactly when the provider is saturated (or leaving), and a
            # slow/hostile dialer must not pin refused connections open —
            # the handshake work per refusal is the price of a structured
            # shed, the hold time doesn't have to be.
            peer = await asyncio.wait_for(
                Peer.connect(conn, self.identity, initiator=False), 2.0)
            await peer.send(MessageKey.INFERENCE_ERROR,
                            {"error": reason, "busy": True,
                             **({"draining": True} if draining else {})})
            await peer.close()
        except (ConnectionError, OSError, asyncio.TimeoutError):
            with contextlib.suppress(Exception):
                await conn.close()

    async def _on_peer(self, conn: Connection) -> None:
        if self._draining:
            await self._refuse_peer(conn, "provider draining",
                                    draining=True)
            return
        if len(self._client_peers) >= self.config.max_connections:
            # maxConnections cap (src/provider.ts:38-40) — refused with
            # the same structured shed as draining (minus the terminal
            # flag): the dialer fails over in milliseconds instead of
            # timing out in its handshake against a silent close.
            await self._refuse_peer(conn, "provider at connection limit")
            return
        peer = await Peer.connect(conn, self.identity, initiator=False)
        self._client_peers.add(peer)
        self._m_connections.set(len(self._client_peers))
        await self._report_connections()
        peer_key = peer.remote_public_hex
        logger.debug(f"client peer connected: {peer_key[:12]}")
        try:
            async for msg in peer:
                if msg.key == MessageKey.NEW_CONVERSATION:
                    # src/provider.ts:181-183
                    self._conversation_index[peer_key] = (
                        self._conversation_index.get(peer_key, 0) + 1
                    )
                elif msg.key == MessageKey.INFERENCE:
                    data = msg.data or {}
                    req_id = data.get("requestId")
                    peer_load = sum(1 for (pid, _) in self._inference_tasks
                                    if pid == id(peer))
                    if req_id and (id(peer), str(req_id)) in                             self._inference_tasks:
                        # duplicate id: accepting it would overwrite the
                        # task entry (bypassing the cap below, orphaning
                        # the first task's cancel handle) and interleave
                        # two streams into one client queue
                        await peer.send(MessageKey.INFERENCE_ERROR, {
                            "error": "duplicate requestId",
                            "requestId": req_id})
                    elif req_id and peer_load >= self.config.get(
                            "maxConcurrentRequests", 32):
                        # multiplexing removed the implicit one-per-peer
                        # serialization; an explicit PER-PEER cap replaces
                        # it so one client's request flood cannot spawn
                        # unbounded tasks (other peers are unaffected —
                        # their aggregate is already bounded by
                        # maxConnections × this cap)
                        await peer.send(MessageKey.INFERENCE_ERROR, {
                            "error": "too many concurrent requests",
                            "requestId": req_id})
                    elif req_id:
                        # Multiplexed mode (round-2 verdict weak #8: the
                        # wire lacked request ids, forcing one in-flight
                        # chat per peer): each request pumps in its own
                        # task, stream messages echo the id, the client
                        # demultiplexes.
                        key = (id(peer), str(req_id))
                        task = self._spawn(
                            self._handle_inference(peer, data))
                        self._inference_tasks[key] = task
                        task.add_done_callback(
                            lambda _t, k=key:
                            self._inference_tasks.pop(k, None))
                    else:
                        # legacy: one at a time, in-order (reference
                        # parity, src/provider.ts:195)
                        await self._handle_inference(peer, data)
                elif msg.key == MessageKey.INFERENCE_CANCEL:
                    req_id = str((msg.data or {}).get("requestId", ""))
                    task = self._inference_tasks.get((id(peer), req_id))
                    if task is not None:
                        task.cancel()
                elif msg.key == MessageKey.PING:
                    await peer.send(MessageKey.PONG)
                elif msg.key == MessageKey.METRICS:
                    # Clients may query the serving snapshot (tok/s, TTFT
                    # percentiles) — same payload the server receives —
                    # plus the engine scheduler's own breakdown when the
                    # backend exposes one (tpu_native.engine_stats), so a
                    # wire-side stall can be attributed engine vs relay.
                    payload = self.stats()
                    engine_stats = getattr(self.backend, "engine_stats",
                                           None)
                    if engine_stats is not None:
                        with contextlib.suppress(Exception):
                            payload["engine"] = await engine_stats()
                    if METRICS.enabled:
                        # The registry snapshots (this process + the
                        # engine host(s), tier-labeled) ride the same
                        # reply — the swarm path's scrape surface, no
                        # open port required (symtop's wire mode,
                        # bench --metrics-out).
                        with contextlib.suppress(Exception):
                            payload["metrics"] = {
                                "snapshots":
                                    await self.metrics_snapshots()}
                    await peer.send(MessageKey.METRICS, payload)
                elif msg.key == MessageKey.TRACE:
                    # Merged span-ring snapshot (provider + backend/host/
                    # scheduler components) for the client-side Perfetto
                    # export — the request-tracing analog of METRICS.
                    await peer.send(MessageKey.TRACE,
                                    await self.gather_trace())
                elif msg.key == MessageKey.PROFILE:
                    # On-demand device profile: run one bounded
                    # jax.profiler capture on the engine and reply with
                    # the artifact path (or a structured error). SPAWNED
                    # like an inference — the capture (plus the
                    # process's first-capture cold init) spans tens of
                    # seconds, and awaiting it inline would stall THIS
                    # peer's whole message loop: submits unread, cancels
                    # undelivered, pings unanswered for the window. The
                    # window itself is clamped — durationS is
                    # client-supplied and must not pin the single-flight
                    # capture slot indefinitely.
                    d = (msg.data or {}).get("durationS")
                    try:
                        d = min(float(d), 120.0) if d is not None else None
                    except (TypeError, ValueError):
                        d = None

                    async def _profile_reply(peer=peer,
                                             duration_s=d) -> None:
                        out = await self._capture_profile(
                            "wire", duration_s=duration_s)
                        with contextlib.suppress(ConnectionError,
                                                 OSError):
                            await peer.send(MessageKey.PROFILE, out)

                    self._spawn(_profile_reply())
                elif msg.key == MessageKey.LEAVE:
                    break
        finally:
            self._client_peers.discard(peer)
            self._m_connections.set(len(self._client_peers))
            await peer.close()
            # Fold AFTER close: the cork's settle() may perform one last
            # write on the way down, and it must land in the totals.
            ws = peer.write_stats
            if ws:
                for k in self._wire_totals:
                    self._wire_totals[k] += ws.get(k, 0)
            await self._report_connections()

    # ----- the hot path (reference: handleInferenceRequest, src/provider.ts:195-275) -----

    def _check_session(self, peer: Peer, data: dict) -> str | None:
        """Validate the session token offline against the trusted serverKey.

        Private providers (public: false) accept direct unsessioned peers, as
        the reference's direct-connection mode does.
        """
        if not self.config.public or not self.config.get("requireSessions", True):
            return None
        payload = session_tokens.verify(
            data.get("sessionToken"),
            self.config.server_key,
            client_key=peer.remote_public_hex,
            model_name=self.config.model_name,
        )
        if payload is None:
            return "invalid or expired session token"
        return None

    def _estimated_first_token_wait_s(self) -> float | None:
        """Predicted first-token wait for a request admitted NOW: requests
        already accepted but not yet streaming, divided by the recent
        first-token rate. None = no recent rate signal — a burst from idle
        must not be shed on ignorance (the signal appears as soon as its
        first wave starts streaming)."""
        if self._unstarted <= 0:
            return 0.0
        now = time.monotonic()
        recent = [t for t in self._first_token_stamps if now - t < 10.0]
        if len(recent) < 4:
            return None
        span = max(now - recent[0], 0.25)
        return self._unstarted / (len(recent) / span)

    def _admission_shed_reason(self) -> dict | None:
        """The structured busy payload when a new request must be shed,
        else None. Two independent bounds:

        1. in-flight ≥ queue_limit — the backlog exceeds ~one extra slot
           rotation, so TTFT would grow with queue depth;
        2. estimated first-token wait > admission_ttft_bound_s — the
           sustained-arrival mode where decode slots may still be free but
           prefill dispatch rate is the limiter and the scheduler inbox
           holds seconds of wait (the in-flight bound can't see this).
        """
        limit = getattr(self.backend, "queue_limit", None)
        slots = getattr(self.backend, "slots", None) or 0
        if limit is not None and self._in_flight >= limit:
            return {"error": f"provider busy: {self._in_flight} requests "
                             f"in flight (limit {limit})",
                    "queueDepth": max(0, self._in_flight - slots),
                    "queueLimit": limit}
        bound = getattr(self.backend, "admission_ttft_bound_s", None)
        if bound is not None:
            est = self._estimated_first_token_wait_s()
            if est is not None and est > bound:
                return {"error": f"provider busy: estimated first-token "
                                 f"wait {est:.1f}s exceeds {bound:.1f}s",
                        "queueDepth": self._unstarted,
                        "estimatedWaitS": round(est, 2),
                        **({"queueLimit": limit}
                           if limit is not None else {})}
        return None

    async def _shed(self, peer: Peer, tag: dict, reason: dict) -> None:
        self.metrics["shed"] += 1
        self._m_sheds.inc(reason="busy")
        logger.debug(f"shedding request: {reason['error']}")
        await peer.send(MessageKey.INFERENCE_ERROR,
                        {**reason, "busy": True, **tag})
        # Push the load report NOW (throttled): the 15 s health-loop
        # cadence is too stale for the router to steer a burst away.
        now = time.monotonic()
        if (now - self._last_load_report > 2.0
                and self._server_peer is not None
                and not self._server_peer.closed):
            self._last_load_report = now
            with contextlib.suppress(ConnectionError, OSError):
                await self._server_peer.send(MessageKey.METRICS,
                                             self.stats())

    def _pending_gauges(self) -> None:
        self._m_in_flight.set(self._in_flight)
        self._m_pending_first.set(max(self._unstarted, 0))

    async def _handle_inference(self, peer: Peer, data: dict) -> None:
        start = time.monotonic()
        req_id = data.get("requestId")
        # echoed on every message of this stream so a multiplexing client
        # can route chunks; absent for legacy single-stream peers
        tag = {"requestId": req_id} if req_id else {}
        messages = data.get("messages")
        if not isinstance(messages, list):
            await peer.send(MessageKey.INFERENCE_ERROR,
                            {"error": "missing messages", **tag})
            return
        err = self._check_session(peer, data)
        if err is not None:
            await peer.send(MessageKey.INFERENCE_ERROR,
                            {"error": err, **tag})
            return
        # Bounded-latency admission: a request the provider cannot serve
        # within its latency bounds is shed NOW with a STRUCTURED busy
        # error — the client fails over (chat_failover excludes this
        # provider), and the router steers by the queue depth reported in
        # stats/METRICS. The reference had no equivalent (only the
        # maxConnections peer cap, src/provider.ts:38-40): every queued
        # client just waited, p99 growing with the backlog.
        shed_reason = self._admission_shed_reason()
        if shed_reason is not None:
            await self._shed(peer, tag, shed_reason)
            return
        deadline_s = data.get("deadline_s")
        if deadline_s is not None:
            try:
                deadline_s = float(deadline_s)
            except (TypeError, ValueError):
                await peer.send(MessageKey.INFERENCE_ERROR,
                                {"error": "invalid deadline_s", **tag})
                return
            if deadline_s <= 0:
                # Already expired on arrival: shed without touching the
                # backend. NOT retryable (no "busy") — by definition the
                # caller stopped waiting, so failover would only burn
                # another provider's admission slot.
                self.metrics["shed"] += 1
                self._m_sheds.inc(reason="expired")
                await peer.send(MessageKey.INFERENCE_ERROR,
                                {"error": "deadline_s already expired",
                                 "expired": True, **tag})
                return
        resume = data.get("resume")
        resume_text: str | None = None
        resume_tokens: int | None = None
        if isinstance(resume, dict) and resume.get("text"):
            # Stream resumption: the client holds a partial completion
            # from a provider that died mid-stream and asks THIS one to
            # continue from its end. A backend that would regenerate
            # from scratch is refused with a structured marker — the
            # client then falls back to a from-scratch restart instead
            # of splicing a duplicate completion onto its partial text.
            if not getattr(self.backend, "supports_resume", False):
                self._m_resumes.inc(outcome="refused")
                await peer.send(MessageKey.INFERENCE_ERROR,
                                {"error": "backend does not support "
                                          "stream resumption",
                                 "resumeUnsupported": True, **tag})
                return
            resume_text = str(resume.get("text"))
            rt = resume.get("tokens")
            if rt is not None:
                try:
                    resume_tokens = int(rt)
                except (TypeError, ValueError):
                    resume_tokens = -1
                if resume_tokens < 0:
                    # Rejected at ingress for EVERY backend shape: a
                    # negative claim would inflate the token budget
                    # past the client's own max_tokens downstream.
                    await peer.send(MessageKey.INFERENCE_ERROR,
                                    {"error": "invalid resume tokens",
                                     **tag})
                    return
            self._m_resumes.inc(outcome="accepted")
        spec = data.get("speculative")
        trace_id = str(data.get("traceId") or "")
        request = InferenceRequest(
            messages=messages,
            max_tokens=data.get("max_tokens"),
            temperature=data.get("temperature"),
            top_p=data.get("top_p"),
            top_k=data.get("top_k"),
            seed=data.get("seed"),
            speculative=spec if isinstance(spec, bool) else None,
            trace_id=trace_id,
            deadline_s=deadline_s,
            resume_text=resume_text,
            resume_tokens=resume_tokens,
        )
        self._in_flight += 1
        self._unstarted += 1
        self.metrics["requests"] += 1
        self._m_requests.inc()
        self._pending_gauges()
        request_id = f"{peer.remote_public_hex[:12]}:{self.metrics['requests']}"
        completion_parts: list[str] = []
        first_token_s: float | None = None
        # hoisted above the try: the cancel handler reports them, and a
        # cancellation can land before the stream loop assigns anything
        n_chunks = 0
        n_tokens = 0
        # symledger: the backend's cost block (terminal chunk rider) and
        # the worst inter-chunk stall — the gap input to this request's
        # SLO-attainment verdict.
        req_costs: dict | None = None
        max_gap_s = 0.0
        # Every log record of this request (including the backend's,
        # which runs inside this task) carries the trace/request ids —
        # logs and the Perfetto timeline then correlate by the same keys.
        ctx = log_context(trace_id=trace_id,
                          request_id=str(req_id or request_id))
        try:
            ctx.__enter__()
            # Stream-start marker (reference src/provider.ts:234-238).
            # tMono = our CLOCK_MONOTONIC at send: the client brackets it
            # with its own stamps — a piggybacked clock handshake, so its
            # spans land on our timeline without an extra round trip.
            await peer.send(
                MessageKey.INFERENCE,
                {"status": "start", "provider": self.backend.name,
                 "model": self.config.model_name,
                 "tMono": time.monotonic(), **tag},
            )
            last_chunk_at: float | None = None
            async for chunk in self.backend.stream(request):
                if peer.closed:
                    # Mid-stream client death tolerated (src/provider.ts:242,253-254).
                    logger.debug("client gone mid-stream; aborting pump")
                    break
                if FAULTS.enabled and await FAULTS.apoint("provider.relay"):
                    continue  # injected drop_frame: this chunk is lost
                if chunk.text:
                    completion_parts.append(chunk.text)
                    # Engine backends report exact per-chunk token counts
                    # (0 included — e.g. a finish flushing held-back
                    # bytes); proxies leave None and we fall back to the
                    # reference's one-chunk≈one-token accounting.
                    n_tokens += (chunk.tokens if chunk.tokens is not None
                                 else 1)
                    now_chunk = time.monotonic()
                    if first_token_s is None:
                        first_token_s = now_chunk - start
                        self.tracer.record("ttft", start, first_token_s,
                                           request_id=request_id,
                                           trace_id=trace_id)
                        self._ttft_hist.observe(first_token_s)
                        self._unstarted -= 1
                        self._pending_gauges()
                        self._first_token_stamps.append(now_chunk)
                        self._m_ttft.observe(first_token_s)
                        if resume_text is not None:
                            # The recovery-latency headline: request
                            # receipt → first CONTINUATION token.
                            self._m_resume_ttft.observe(first_token_s)
                        self.slo.observe("ttft", first_token_s)
                    else:
                        # Inter-chunk gap: the stall any live stream saw
                        # between deltas — the r05 tail metric, now an
                        # always-on series and an SLO input.
                        gap = now_chunk - last_chunk_at
                        self._m_inter_chunk.observe(gap)
                        self.slo.observe("inter_chunk", gap)
                        max_gap_s = max(max_gap_s, gap)
                    last_chunk_at = now_chunk
                if self._ledger_on and chunk.costs is not None:
                    req_costs = chunk.costs
                # Raw passthrough; Connection.send awaits drain = backpressure
                # (reference's write/drain discipline, src/provider.ts:248-252).
                await peer.send(MessageKey.TOKEN_CHUNK,
                                {"raw": chunk.raw, **tag})
                n_chunks += 1
            completion = "".join(completion_parts)
            if not peer.closed:
                await peer.send(
                    MessageKey.INFERENCE_ENDED,
                    # symledger: the attributed cost block rides the end
                    # frame so the CLIENT sees what its request cost —
                    # absent (not empty) while tpu.ledger is off.
                    {"chunks": n_chunks, "tokens": n_tokens,
                     **({"costs": req_costs} if req_costs is not None
                        else {}),
                     **tag},
                )
            self.metrics["tokens_out"] += n_tokens
            if n_tokens:
                self._m_tokens_out.inc(n_tokens)
            e2e_s = time.monotonic() - start
            self._m_e2e.observe(e2e_s)
            self.slo.observe("e2e", e2e_s)
            if req_costs is not None:
                self._fold_request_cost(
                    req_costs, n_tokens,
                    attained=self._slo_attained(first_token_s, e2e_s,
                                                max_gap_s),
                    request_id=str(req_id or request_id))
            self.tracer.record("inference", start, e2e_s,
                               request_id=request_id, trace_id=trace_id,
                               tokens=n_tokens, chunks=n_chunks)
            self._e2e_hist.observe(e2e_s)
            if (self.flight is not None and self.flight.slo_e2e_s
                    and e2e_s > self.flight.slo_e2e_s):
                # Latency-SLO breach: capture the window that CONTAINS
                # the slow request while it is still in the rings.
                logger.warning(f"request {request_id} breached e2e SLO "
                               f"({e2e_s:.2f}s > "
                               f"{self.flight.slo_e2e_s:.2f}s)")
                self._spawn(self._flight_dump("slo"))
            # Data collection (reference: saveCompletion, src/provider.ts:277-297).
            peer_key = peer.remote_public_hex
            await self.collector.save(
                peer_key=peer_key,
                conversation_index=self._conversation_index.get(peer_key, 0),
                messages=messages,
                completion=completion,
            )
            await self._report_completion(data, n_tokens)
        except BackendRestartingError as exc:
            # Engine host crash/wedge: the STRUCTURED retryable shed —
            # the client fails over immediately and (after a backoff
            # round) may return once the supervisor finishes the respawn.
            # No per-stream flight dump: the supervisor's restart hook
            # already captured the death once, and N in-flight streams
            # must not race N dumps of the same window.
            # Counted as an ERROR (matching the legacy stats counter) —
            # not also a shed: the registry and stats() surfaces must
            # agree, and double-booking every restarting request under
            # sheds_total too would make shed+error sums double-count.
            self.metrics["errors"] += 1
            self._m_errors.inc()
            logger.error(f"backend restarting: {exc}")
            if not peer.closed:
                with contextlib.suppress(ConnectionError, OSError):
                    await peer.send(MessageKey.INFERENCE_ERROR,
                                    {"error": str(exc), "busy": True,
                                     "restarting": True,
                                     # Exact relayed-token count for the
                                     # client's resume: everything sent
                                     # before this ordered error frame
                                     # was delivered, so n_tokens IS
                                     # what the client holds. The
                                     # backend's journal stamp may
                                     # exceed it when pipe frames died
                                     # with the host — those tokens are
                                     # lost work the resume regenerates;
                                     # the gap rides as emittedEngine
                                     # (wasted-work observability, the
                                     # chaos round's numerator).
                                     "emitted": n_tokens,
                                     **({"emittedEngine": exc.emitted}
                                        if getattr(exc, "emitted", None)
                                        is not None
                                        and exc.emitted > n_tokens
                                        else {}),
                                     **({"retryAfterS":
                                         round(exc.retry_after_s, 3)}
                                        if exc.retry_after_s is not None
                                        else {}),
                                     **tag})
        except BackendDeadlineError as exc:
            # Deadline expired before service (scheduler admission shed):
            # terminal for this request, not a provider failure.
            self.metrics["shed"] += 1
            self._m_sheds.inc(reason="expired")
            logger.debug(f"deadline shed: {exc}")
            if not peer.closed:
                with contextlib.suppress(ConnectionError, OSError):
                    await peer.send(MessageKey.INFERENCE_ERROR,
                                    {"error": str(exc), "expired": True,
                                     **tag})
        except BackendError as exc:
            self.metrics["errors"] += 1
            self._m_errors.inc()
            logger.error(f"backend error: {exc}")
            if self.flight is not None:
                self._spawn(self._flight_dump("backend_error"))
            if not peer.closed:
                with contextlib.suppress(ConnectionError, OSError):
                    await peer.send(MessageKey.INFERENCE_ERROR,
                                    {"error": str(exc), **tag})
        except InjectedFault as exc:
            # A fault armed at a provider-level seam fired: simulate the
            # crash it stands in for — drop the client cold (no error
            # frame), exactly what a dying provider process would do.
            self.metrics["errors"] += 1
            self._m_errors.inc()
            logger.error(f"injected fault: {exc}; dropping peer")
            await peer.close()
        except asyncio.CancelledError:
            # inferenceCancel (or shutdown): closing the generator frees
            # the engine slot; tell the client the stream is over
            if not peer.closed:
                with contextlib.suppress(ConnectionError, OSError):
                    await peer.send(MessageKey.INFERENCE_ENDED,
                                    {"cancelled": True, "chunks": n_chunks,
                                     "tokens": n_tokens, **tag})
            raise
        finally:
            ctx.__exit__(None, None, None)
            self._in_flight -= 1
            if first_token_s is None:
                # Never started streaming (error/cancel before the first
                # token) — still waiting from the estimator's view.
                self._unstarted -= 1
            self._pending_gauges()

    def _slo_attained(self, ttft_s: float | None, e2e_s: float,
                      max_gap_s: float) -> bool:
        """One request's SLO verdict: every configured `slo:` target
        met. This is the goodput numerator's gate — a completion that
        blew its latency target is device time spent, not goodput. No
        targets configured ⇒ trivially attained (goodput degenerates to
        plain tokens per device second). A request that never streamed
        a token (ttft None) fails any TTFT target by definition."""
        targets = self.slo.targets
        if not targets:
            return True
        t = targets.get("ttft")
        if t is not None and (ttft_s is None or ttft_s > t):
            return False
        t = targets.get("e2e")
        if t is not None and e2e_s > t:
            return False
        t = targets.get("inter_chunk")
        if t is not None and max_gap_s > t:
            return False
        return True

    def _fold_request_cost(self, costs: dict, tokens: int, *,
                           attained: bool, request_id: str) -> None:
        """Fold one finished request's ledger block into the always-on
        families, the goodput window, and the backend's autoscale
        accumulator. Runs once per request, only when a cost block
        arrived (tpu.ledger on + engine-shaped backend)."""
        device = costs.get("device_s")
        if isinstance(device, dict):
            for phase, seconds in device.items():
                self._m_req_device_s.observe(float(seconds),
                                             phase=str(phase))
        wasted = costs.get("wasted_s")
        if isinstance(wasted, dict):
            for reason, seconds in wasted.items():
                self._m_req_wasted_s.inc(float(seconds),
                                         reason=str(reason))
        try:
            device_total = float(costs.get("device_total_s") or 0.0)
        except (TypeError, ValueError):
            device_total = 0.0
        self._goodput_window.append((int(tokens), device_total, attained))
        good = sum(t for t, _d, a in self._goodput_window if a)
        dev_s = sum(d for _t, d, _a in self._goodput_window)
        if dev_s > 0:
            self._m_goodput.set(round(good / dev_s, 3))
        self._cost_ring.append(
            {"id": request_id, "attained": attained, "tokens": tokens,
             **costs})
        # Autoscale goodput numerator (tpu_native pool mode): only an
        # attained request's tokens count toward the scale signal.
        note = getattr(self.backend, "note_request_cost", None)
        if note is not None:
            note(tokens if attained else 0, tokens, device_total)

    async def _report_completion(self, data: dict, tokens: int) -> None:
        token = data.get("sessionToken") or {}
        session_id = (token.get("payload") or {}).get("sessionId") if isinstance(token, dict) else None
        if self._server_peer is not None and not self._server_peer.closed:
            with contextlib.suppress(ConnectionError, OSError):
                await self._server_peer.send(
                    MessageKey.REPORT_COMPLETION,
                    {"sessionId": session_id, "tokens": tokens},
                )
