"""tpu_native backend: the in-process JAX engine as an apiProvider.

The flagship of the rebuild (BASELINE.json north star): where the reference
could only proxy to an external GPU server (reference: src/provider.ts:
210-214), this backend hosts the model itself — HF weights pjit-sharded over
the provider's TPU slice, continuous batching across peers, tokens streamed
back as OpenAI-style chat.completion.chunk SSE lines so existing clients
can't tell the difference (same wire format the proxy backends forward).
"""

from __future__ import annotations

import asyncio
import json
import os
import threading
import time
import uuid
from typing import Any, AsyncIterator

from symmetry_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from symmetry_tpu_torch.engine.scheduler import AsyncSession, Scheduler
from symmetry_tpu_torch.protocol.keys import HostOp, LinkOp
from symmetry_tpu_torch.provider.backends.base import (
    BackendDeadlineError,
    BackendError,
    BackendRestartingError,
    InferenceBackend,
    InferenceRequest,
    ResumeJournal,
    StreamChunk,
)
from symmetry_tpu_torch.utils.faults import FAULTS
from symmetry_tpu_torch.utils.logging import logger as log

DEFAULT_MAX_NEW_TOKENS = 512


class _DecodeMember:
    """One decode-tier pool member: a local engine host with its own
    reader, probe waiters, clock offset, and supervision accounting —
    the per-member failure domain that replaces the pair's
    respawn-both-as-a-unit rule in pool mode."""

    __slots__ = ("id", "proc", "reader", "clock_offset", "waiters",
                 "down", "dead", "engine_alive", "spawned_at",
                 "respawn_failures", "circuit_open", "restarts",
                 "supervisor")

    def __init__(self, member_id: str) -> None:
        self.id = member_id
        self.proc: asyncio.subprocess.Process | None = None
        self.reader: asyncio.Task | None = None
        self.clock_offset = 0.0
        self.waiters: dict[str, list[asyncio.Future]] = {
            HostOp.STATS: [], HostOp.TRACE: [], HostOp.METRICS: [],
            HostOp.PROFILE: []}
        self.down = asyncio.Event()
        self.dead = False
        self.engine_alive = True
        self.spawned_at: float | None = None
        self.respawn_failures = 0
        self.circuit_open = False
        self.restarts = 0
        # This member's respawn-loop task: the autoscaler's retire path
        # must cancel exactly it (a supervisor left running would
        # respawn the member it just scaled away).
        self.supervisor: asyncio.Task | None = None

    @property
    def alive(self) -> bool:
        return (self.proc is not None and not self.dead
                and self.proc.returncode is None)


class TpuNativeBackend(InferenceBackend):
    """Two isolation modes (tpu.engine_isolation):

    "process" (default): the engine lives in a host subprocess behind a
    JSON-lines pipe (engine/host.py). Measured necessity, not taste: the
    in-process engine thread's GIL-held device syncs starved the
    provider's event loop so badly that every client's TTFT equalled the
    benchmark's wall time.

    "inproc": the engine thread shares this process (tests, debugging,
    and anything that needs direct engine access).

    Process mode is SUPERVISED (tpu.supervisor, on by default): a
    heartbeat watchdog piggybacked on the stats op detects host crashes
    and wedges with a tighter deadline than the 15 s provider health
    loop; detection fails every in-flight stream with a retryable
    BackendRestartingError (the structured {"restarting": true} shed
    clients fail over on) and auto-respawns the host — warm compile
    cache makes a config-identical respawn compile ~nothing — with
    exponential backoff. Only after max_respawns consecutive failed
    respawns does the circuit breaker open and healthy() go false, which
    is the pre-supervisor deregistration path.
    """

    name = "tpu_native"
    # Stream resumption: the host's resume admission continues generation
    # from the client's received text (radix-cache-seeded), so a resume
    # against this backend yields only the continuation.
    supports_resume = True

    def __init__(self, config: Any, *, device: str = "cuda") -> None:
        self._config = config
        self._model_name = config.model_name
        # The torch device of the engine: the in-process engine's, and the
        # engine hosts' (`--device`). Default the card; "cpu" runs the
        # kernels' plain versions.
        self._device = device
        # Held by every in-process engine call and by the inproc profile
        # capture's start and stop (engine/host.py GatedEngine).
        self._device_gate = threading.RLock()
        self._engine: InferenceEngine | None = None
        self._scheduler: Scheduler | None = None
        self._command_loop = None
        self._proc: asyncio.subprocess.Process | None = None
        self._cfg_path: str | None = None
        self._queues: dict[str, asyncio.Queue] = {}
        self._reader: asyncio.Task | None = None
        # --- disaggregated prefill/decode (tpu.role: disagg) ----------
        # The backend then runs a HOST PAIR: self._proc is the decode
        # host (primary: stats/trace/liveness target, serves the token
        # streams), self._prefill_proc the prefill host. Submits route
        # to the prefill tier; its `handoff` frames are forwarded to the
        # decode tier as `adopt` ops by the broker, which also carries
        # the request state across (engine/disagg/broker.py). The pair
        # is supervised as ONE unit — either process dying runs the
        # restarting-shed path and the respawn brings BOTH back.
        self._disagg = (getattr(config.tpu, "role", "unified")
                        or "unified") == "disagg"
        self._broker = None
        self._prefill_proc: asyncio.subprocess.Process | None = None
        self._prefill_reader: asyncio.Task | None = None
        self._prefill_cfg_path: str | None = None
        self._prefill_clock_offset: float = 0.0
        self._prefill_stats_waiters: list[asyncio.Future] = []
        self._prefill_trace_waiters: list[asyncio.Future] = []
        self._prefill_metrics_waiters: list[asyncio.Future] = []
        # --- cross-machine handoff link (tpu.disagg.peer) -------------
        # NETWORK mode: the prefill tier is NOT a local subprocess but a
        # PrefillNode (engine/disagg/node.py) reached over the handoff
        # link (engine/disagg/net.py) — this backend runs only the
        # decode host locally and dials the peer. `tpu.disagg.inline`
        # self-hosts the node in-process (full wire path, one process:
        # benches/smokes/tests). Link loss is a first-class failure:
        # in-flight migrations shed structured-retryable and the link
        # reconnects with backoff, independent of host supervision.
        self._link = None            # DecodeLink in network mode
        self._link_cfg = None
        self._inline_node = None     # in-process PrefillNode
        self._net_mode = False
        # --- elastic pool (tpu.disagg.pool) ---------------------------
        # POOL mode generalizes the pair into M prefill members × N
        # decode members (engine/disagg/pool.py): each prefill member is
        # a PrefillNode reached over its OWN DecodeLink (inline or
        # remote), each decode member a local engine host with its OWN
        # supervision domain. The PoolRouter places each request on the
        # least-loaded healthy prefill member and routes its KV handoff
        # to a decode member by queue-depth gauges; node death, link
        # loss, and deliberate drain are membership churn — in-flight
        # migrations on a lost member are RE-PLACED on a survivor (the
        # structured-retryable shed only fires when no survivor exists).
        self._pool_mode = False
        self._pool_cfg = None
        self._pool = None                  # PoolRouter
        self._plinks: dict[str, Any] = {}  # prefill member id -> DecodeLink
        self._inline_nodes: list[Any] = []
        self._pool_submits: dict[str, dict] = {}  # full submit ops for
                                                  # re-placement
        self._decode_members: dict[str, _DecodeMember] = {}
        self._pool_tasks: list[asyncio.Task] = []
        self._replace_tasks: set[asyncio.Task] = set()
        # --- SLO-goodput autoscaler (tpu.autoscale, pool mode only) ---
        # A PoolAutoscaler ticks inside the pool heartbeat and its
        # decisions become real member lifecycle events through the
        # member factory below: spawn = a fresh _DecodeMember /
        # inline PrefillNode, drain = drain-before-kill + retire.
        self._autoscaler = None
        self._member_seq: dict[str, int] = {}   # next member index/tier
        self._node_by_member: dict[str, Any] = {}  # prefill id -> node
        self._retiring: set[str] = set()  # fence: leave/down callbacks
                                          # of a deliberate retire are
                                          # not churn
        self._scale_task: asyncio.Task | None = None
        self._prev_busy: dict[str, float] = {}  # member -> device_s_total
        # Gates the pool's supervision/heartbeat tasks: set before the
        # first member spawns (they must not bail while start() is
        # still assembling the pool) and cleared first thing in stop().
        self._pool_active = False
        # Cache-affine routing signal: a provider-side ROUTING tokenizer
        # (same tokenizer files as the hosts', so it produces identical
        # prompt ids → identical causal block digests to the gossiped
        # cache summaries). Lazily built on the first pool placement;
        # False = construction failed once — permanent load-only
        # fallback, logged once, never retried per request.
        self._route_tok: Any = None
        # The provider's SLO burn-rate monitor (attached after
        # construction): the pool heartbeat reads its live fast-window
        # burn and feeds PoolRouter.update_gauges — the placement
        # tie-break input that was plumbed but never fed live.
        self._slo_monitor = None
        if self._disagg:
            from symmetry_tpu_torch.engine.disagg import (
                HandoffBroker, LinkConfig, PoolConfig)

            self._broker = HandoffBroker()
            self._broker.tracer.enabled = bool(
                getattr(config.tpu, "tracing", True))
            self._link_cfg = LinkConfig(
                getattr(config.tpu, "disagg", None))
            self._net_mode = self._link_cfg.network_mode
            self._pool_cfg = PoolConfig(
                getattr(config.tpu, "disagg", None))
            self._pool_mode = self._pool_cfg.enabled
        self._started = False
        self._host_dead = False
        self._engine_alive = True  # host-reported scheduler liveness
        self._stats_waiters: list[asyncio.Future] = []
        self._trace_waiters: list[asyncio.Future] = []
        self._metrics_waiters: list[asyncio.Future] = []
        self._profile_waiters: list[asyncio.Future] = []
        # --- engine-host supervision (process mode) -------------------
        sup = config.tpu.supervisor or {}
        self._sup_enabled = bool(sup.get("enabled", True))
        self._heartbeat_s = float(sup.get("heartbeat_s", 5.0))
        self._wedge_timeout_s = float(sup.get("wedge_timeout_s", 5.0))
        self._backoff_base_s = float(sup.get("backoff_base_s", 0.5))
        self._backoff_max_s = float(sup.get("backoff_max_s", 15.0))
        self._max_respawns = int(sup.get("max_respawns", 3))
        self._spawn_timeout_s = float(sup.get("spawn_timeout_s", 600.0))
        self._stop_grace_s = float(sup.get("stop_grace_s", 30.0))
        # A life must survive this long to count as a recovery: without
        # it, a crash-LOOP (respawn succeeds, host dies seconds later)
        # would reset the failure counter every cycle and flap forever
        # instead of tripping the breaker.
        self._min_stable_s = float(sup.get("min_stable_s", 5.0))
        self._spawned_at: float | None = None
        self._supervisor: asyncio.Task | None = None
        self._host_down: asyncio.Event | None = None  # set by reader EOF
        self._down_reason = "crash"
        self._restarting = False
        self._restarts = 0
        self._respawn_failures = 0
        self._circuit_open = False
        # Provider hook, called (reason) the moment a host death/wedge is
        # being handled — the provider wires its flight-recorder dump
        # here so every restart leaves a debuggable artifact.
        self.on_host_restart = None
        # Measured host-pipe clock offset (host monotonic − provider
        # monotonic), from the startup clock handshake. On Linux both
        # processes read one CLOCK_MONOTONIC so it lands near zero — but
        # it is MEASURED, not assumed: host stamps are reconciled through
        # it instead of clamping negative cross-process spans to zero.
        self._clock_offset: float = 0.0
        # Admission capacity for the provider's overload shedding: the
        # engine serves `slots` streams concurrently; beyond
        # slots + max_queue, new requests would wait more than ~one slot
        # rotation, so the provider rejects them with a busy error.
        tpu = config.tpu
        self.slots = tpu.max_batch_size
        extra = tpu.max_queue if tpu.max_queue is not None else self.slots
        self.queue_limit = self.slots + max(0, extra)
        self.admission_ttft_bound_s = tpu.max_ttft_s
        # Relay-side emit accounting: host frames read vs events carried.
        # frames << events means the batched `events` protocol is doing
        # its job (one pipe read fans out a whole decode block).
        self.relay_stats = {"host_frames": 0, "host_events": 0,
                            "host_batched_frames": 0}
        # symledger fold (provider-fed): per-request cost blocks ride
        # the done chunks; the provider judges SLO attainment against
        # its configured targets and calls note_request_cost() with the
        # verdict. The autoscaler's goodput numerator counts ONLY
        # attained tokens — the raw relayed-event count it used before
        # stays exported as sym_autoscale_tokens_raw for continuity.
        self.ledger_stats = {"attained_tokens": 0, "raw_tokens": 0,
                             "device_s": 0.0, "requests": 0}
        # Stream resumption: the per-request emitted-token journal (what
        # each live stream has relayed — the death paths stamp `emitted`
        # from it into their restarting sheds, so a seeded resume knows
        # its RNG lane position) plus the relay-side resume ledger. The
        # host's own journal (stats-heartbeat "journal" rider) is merged
        # in as a lower bound each heartbeat.
        self._journal = ResumeJournal()
        self.resume_stats = {"resumes": 0, "resumed_tokens": 0,
                             "reused_tokens": 0, "dedup_dropped": 0}
        # Per-stage TTFT attribution (round-4 task #3: the ~2 s
        # engine→provider hop): each first event carries the host's
        # monotonic stage stamps ("t" field), and this side closes the
        # chain with its own submit/receipt stamps. All CLOCK_MONOTONIC —
        # one clock across processes on Linux.
        #   submit   provider stream start → host-pipe submit written
        #   pipe_in  submit written → host read + tokenized + enqueued
        #   queue    enqueued → entered a placement group
        #   prefill  placement pick → first token sampled
        #   emit     first token → host pipe write (block-flush hold)
        #   relay    host pipe write → this process relays the event
        from symmetry_tpu_torch.utils.metrics import METRICS, MetricName
        from symmetry_tpu_torch.utils.trace import Histogram

        self.stage_hists = {name: Histogram() for name in
                            ("submit", "pipe_in", "queue", "prefill",
                             "emit", "relay")}
        # Registry twins of the per-stage TTFT and relay accounting
        # (always-on time series in THIS process; the host's own
        # families arrive via the HostOp.METRICS probe, tier-labeled).
        self._m_stage = METRICS.histogram(
            MetricName.TTFT_STAGE,
            "per-stage TTFT attribution (submit/pipe_in/queue/prefill/"
            "emit/relay)", labels=("stage",))
        self._m_host_frames = METRICS.counter(
            MetricName.RELAY_HOST_FRAMES, "host-pipe frames relayed")
        self._m_host_events = METRICS.counter(
            MetricName.RELAY_HOST_EVENTS, "token events relayed")
        self._m_resume_wasted = METRICS.counter(
            MetricName.RESUME_WASTED_TOKENS,
            "overlap tokens the relay's resume offset-dedup dropped")

    def attach_slo_monitor(self, monitor: Any) -> None:
        """Provider hook: hand this backend the live SLO burn-rate
        monitor so the pool heartbeat can feed PoolRouter.update_gauges
        with real burn instead of the 0.0 the router defaults to. Safe
        to call in any mode; only pool mode reads it."""
        self._slo_monitor = monitor

    @property
    def _process_mode(self) -> bool:
        return getattr(self._config.tpu, "engine_isolation",
                       "process") == "process"

    @property
    def _local_pair(self) -> bool:
        """Disagg with BOTH tiers as local subprocesses (the pair);
        network mode replaces the prefill side with the handoff link,
        pool mode replaces BOTH sides with member sets."""
        return self._disagg and not self._net_mode and not self._pool_mode

    async def start(self) -> None:
        """Load weights and start the engine (may take minutes for large
        checkpoints; nothing here blocks the event loop)."""
        if self._started:
            return
        tpu_cfg = self._config.tpu
        role = getattr(tpu_cfg, "role", "unified") or "unified"
        if role in ("prefill", "decode"):
            raise BackendError(
                f"tpu.role {role!r} is a per-host tier role the disagg "
                f"broker assigns; a provider backend runs role unified "
                f"or disagg")
        if self._disagg and not self._process_mode:
            raise BackendError(
                "tpu.role: disagg requires engine_isolation: process "
                "(the two tiers are separate engine hosts)")
        mh = tpu_cfg.multihost
        if mh and mh.get("num_processes", 1) > 1 and mh.get("process_id", 0) != 0:
            # Refuse BEFORE joining the distributed job / loading weights —
            # a wrong-rank provider would become a dead participant the
            # other ranks hang on.
            raise BackendError(
                "only rank 0 runs the provider; start other ranks with "
                "`python -m symmetry_tpu_torch.provider --worker`")
        if self._process_mode:
            await self._start_host_process()
        else:
            await self._start_inproc()
        self._started = True

    async def _start_inproc(self) -> None:
        from symmetry_tpu_torch.utils.compile_cache import enable_compile_cache

        tpu_cfg = self._config.tpu
        mh = tpu_cfg.multihost
        enable_compile_cache(tpu_cfg)

        def build() -> InferenceEngine:
            return InferenceEngine.from_tpu_config(tpu_cfg,
                                                   device=self._device)

        from symmetry_tpu_torch.engine.host import GatedEngine
        from symmetry_tpu_torch.utils.devprof import init_capture

        self._engine = await asyncio.to_thread(build)
        if self._engine.device.type == "cuda":
            # Kineto starts on this thread, so a later capture on an
            # executor thread records the card's kernels (devprof).
            init_capture()
        # The Scheduler's thread launches kernels through the gate, which
        # capture_profile holds around the profiler's start and stop: a
        # stop that races a launch crashes the process.
        sched_engine = GatedEngine(self._engine, self._device_gate)
        if mh and mh.get("num_processes", 1) > 1:
            # Rank 0 fronts the network; its scheduler drives all ranks in
            # lockstep through the command loop (parallel/multihost.py).
            from symmetry_tpu_torch.parallel.multihost import (
                CommandLoop, MultihostEngine)

            self._command_loop = CommandLoop(self._engine,
                                             is_coordinator=True,
                                             gate=self._device_gate)
            sched_engine = MultihostEngine(self._command_loop)
        # Compile the decode program before taking traffic: the first
        # request must never stall every stream on a fresh XLA compile.
        await asyncio.to_thread(sched_engine.warmup)
        self._scheduler = Scheduler(
            sched_engine,
            pipeline_depth=int(getattr(tpu_cfg, "pipeline_depth", 2)))
        self._scheduler.start()
        log.info(
            f"tpu_native engine up (inproc): model={self._model_name} "
            f"slots={self._engine.max_slots} seq={self._engine.max_seq_len}")

    def _host_argv(self, cfg_path: str) -> list[str]:
        """Command line for the engine-host subprocess. A seam on purpose:
        the chaos suite substitutes a protocol-faithful fake host here to
        exercise crash/wedge/respawn without a JAX build per life."""
        import sys

        argv = [sys.executable, "-m", "symmetry_tpu_torch.engine.host",
                cfg_path]
        return (argv if self._device == "cuda"
                else argv + ["--device", self._device])

    async def _start_host_process(self) -> None:
        import tempfile

        import yaml

        cfg = {k: v for k, v in self._config.get_all().items()
               if k != "apiKey"}

        def write_cfg(d: dict) -> str:
            with tempfile.NamedTemporaryFile("w", suffix=".yaml",
                                             delete=False) as fh:
                yaml.safe_dump(d, fh)
                return fh.name

        if self._disagg:
            from symmetry_tpu_torch.engine.disagg import derive_role_config

            # The decode tier is always the PRIMARY self._cfg_path
            # (stats/liveness target). The prefill config file exists
            # only for the local pair — in network mode the prefill
            # tier derives its own config on its own machine.
            self._cfg_path = write_cfg(derive_role_config(cfg, "decode"))
            if self._local_pair:
                self._prefill_cfg_path = write_cfg(
                    derive_role_config(cfg, "prefill"))
        else:
            self._cfg_path = write_cfg(cfg)
        self._host_down = asyncio.Event()
        if self._pool_mode:
            # Elastic pool: per-member readers and per-member
            # supervision replace the pair's single supervisor — a dead
            # member is a capacity event handled in its own domain.
            await self._start_pool()
            return
        await self._spawn_host()
        if self._net_mode:
            await self._start_link()
        if self._sup_enabled:
            self._supervisor = asyncio.get_running_loop().create_task(
                self._supervise())

    async def _spawn_one(self, cfg_path: str
                         ) -> asyncio.subprocess.Process:
        # readline() is bounded by the StreamReader limit (64 KiB
        # default) and raises past it, killing the reader task — which
        # the supervisor reads as a host death. 32 MiB fits the largest
        # non-disagg line (a full-ring {"op":"trace"} reply). A disagg
        # handoff frame is a single base64 line carrying a KV prefix —
        # ~128 KiB/token raw on an 8B model, so a 2048-token bucket
        # prefix is ~350 MB encoded; 1 GiB bounds that with headroom
        # (the limit is a cap, not an allocation).
        limit = (1 << 30) if self._disagg else 32 * 1024 * 1024
        return await asyncio.create_subprocess_exec(
            *self._host_argv(cfg_path),
            stdin=asyncio.subprocess.PIPE, stdout=asyncio.subprocess.PIPE,
            limit=limit)

    @staticmethod
    async def _await_ready(proc: asyncio.subprocess.Process,
                           what: str) -> None:
        """Read frames until the host's ready line (weight loading +
        warmup happen in the host before it appears)."""
        while True:
            line = await proc.stdout.readline()
            if not line:
                rc = await proc.wait()
                raise BackendError(f"{what} died during startup "
                                   f"(rc={rc})")
            try:
                msg = json.loads(line)
            except ValueError:
                continue
            if not isinstance(msg, dict):
                continue  # stray scalar on stdout (see _read_events)
            if msg.get("op") == HostOp.READY:
                return

    async def _spawn_host(self) -> None:
        """One host life: spawn, await ready, measure the clock offset,
        start the reader. Shared by first start and every respawn (the
        respawn reuses the same config file(s), so the persistent
        compile cache makes it a warm start). In disagg mode a "life"
        is the PAIR: both processes are created first so their engine
        builds overlap, then each is brought to ready."""
        self._host_dead = False
        self._engine_alive = True
        self._proc = await self._spawn_one(self._cfg_path)
        if self._local_pair:
            self._prefill_proc = await self._spawn_one(
                self._prefill_cfg_path)
        await self._await_ready(
            self._proc, "decode host" if self._disagg else "engine host")
        self._clock_offset = await self._clock_handshake(self._proc)
        self._reader = asyncio.get_running_loop().create_task(
            self._read_events())
        if self._local_pair:
            await self._await_ready(self._prefill_proc, "prefill host")
            self._prefill_clock_offset = await self._clock_handshake(
                self._prefill_proc)
            # The broker's wire-leg split maps the prefill host's
            # handoff emit stamps through this measured offset.
            self._broker.prefill_clock_offset = \
                self._prefill_clock_offset
            self._prefill_reader = asyncio.get_running_loop().create_task(
                self._read_prefill_events())
            log.info(
                f"tpu_native prefill host up "
                f"(pid {self._prefill_proc.pid}): clock_offset="
                f"{self._prefill_clock_offset * 1e6:+.0f}us")
        self._spawned_at = time.monotonic()
        log.info(f"tpu_native engine host up (pid {self._proc.pid}"
                 f"{', disagg pair' if self._disagg else ''}): "
                 f"model={self._model_name} "
                 f"clock_offset={self._clock_offset * 1e6:+.0f}us")

    # ------------------------------------------------- handoff link (net)

    async def _start_link(self) -> None:
        """Network-mode startup: optional inline PrefillNode, then the
        DecodeLink dial loop. A peer that is not up yet is NOT fatal —
        the link keeps reconnecting with backoff and submits shed
        retryable until it lands (static pairing means the operator
        brings the prefill machine up on its own schedule)."""
        from symmetry_tpu_torch.engine.disagg.net import DecodeLink, LinkError

        peer = self._link_cfg.peer
        if self._link_cfg.inline:
            from symmetry_tpu_torch.engine.disagg.node import PrefillNode

            self._inline_node = PrefillNode(self._config, listen=peer,
                                            device=self._device)
            await self._inline_node.start()
            # tcp://host:0 resolved to the real bound port.
            self._link_cfg.peer = self._inline_node.address
        self._link = DecodeLink(
            self._link_cfg,
            on_handoff=self._link_handoff,
            on_event=self._link_event,
            on_fail=self._link_fail,
            on_down=self._link_down)
        try:
            await self._link.start(
                wait_s=min(self._spawn_timeout_s, 120.0))
        except LinkError as exc:
            log.warning(f"{exc}; continuing — submits shed retryable "
                        f"until the link connects")

    async def _link_handoff(self, meta: dict, frame: bytes) -> None:
        """A complete, CRC-verified handoff frame off the link → the
        decode host's adopt path. Raising here naks the transfer (the
        sender retries); the ack only goes out after this returns, so
        the decode host's stdin write is inside the link's ack/credit
        backpressure loop."""
        import base64

        handoff = {"id": meta.get("id"), "p": int(meta.get("p", 0)),
                   "prompt_len": meta.get("prompt_len"),
                   "nbytes": len(frame),
                   "blocks": int(meta.get("blocks", 0)),
                   "shipped": int(meta.get("shipped", 0)),
                   "frame": base64.b64encode(frame).decode("ascii")}
        if "wire_s" in meta:
            handoff["wire_s"] = meta["wire_s"]
        adopt = self._broker.adopt_op(handoff, member="decode")
        if adopt is None:
            return  # request already cancelled/failed — drop the frame
        try:
            await self._host_send(adopt)
        except (ConnectionError, OSError):
            # The DECODE host's pipe failed (it is dying/respawning) —
            # a nak would make the sender retransmit the whole frame
            # at a problem that is local, and the retry would find the
            # broker entry already consumed and be ACKed as delivered
            # while adopting nothing. Ack the wire leg (it WAS
            # delivered intact) and shed the request retryable; the
            # host death path is about to shed every stream anyway.
            self._shed_request(
                str(meta.get("id", "")),
                "decode host unavailable for adoption")

    def _link_event(self, msg: dict) -> None:
        """Prefill-tier terminal events arriving over the link
        (tokenization/admission errors, deadline sheds) — same routing
        as the local pair's _read_prefill_events."""
        events = (msg.get("events")
                  if msg.get("op") == HostOp.EVENTS else [msg])
        if not isinstance(events, list):
            return
        for ev in events:
            if not isinstance(ev, dict):
                continue
            req_id = str(ev.get("id", ""))
            if ev.get("done"):
                self._broker.forget(req_id)
                if self._pool is not None:
                    self._pool.note_done(req_id)
                    self._pool_submits.pop(req_id, None)
            q = self._queues.get(req_id)
            if q is not None:
                q.put_nowait(ev)

    def _shed_request(self, req_id: str, error: str) -> None:
        """One in-flight request → the structured RETRYABLE restarting
        shed (clients fail over / retry; the link or tier that failed
        is already recovering). Stamped with the journal's emitted
        count, so pool re-placement and link-loss sheds carry the same
        resume anchor the supervisor's crash sheds do."""
        self._broker.forget(req_id)
        if self._pool is not None:
            self._pool.note_done(req_id)
            self._pool_submits.pop(req_id, None)
        q = self._queues.get(req_id)
        if q is not None:
            q.put_nowait({"op": HostOp.EVENT, "id": req_id, "text": "",
                          "done": True, "finish_reason": "error",
                          "restarting": True,
                          "emitted": self._journal.get(req_id),
                          "error": error})

    def _link_fail(self, req_id: str, reason: str) -> None:
        self._shed_request(
            req_id, f"handoff failed on the link: {reason or 'unknown'}")

    def _link_down(self, reason: str) -> None:
        """The handoff link died (cable pull, peer restart, injected
        drop): every migration still in flight is shed retryable —
        never hung — while already-adopted streams keep decoding and
        the DecodeLink reconnects with backoff."""
        for req_id in self._broker.shed_pending():
            self._shed_request(req_id, f"handoff link lost: {reason}")

    # ------------------------------------------------- elastic pool (M×N)

    def _node_factory(self, config: Any, listen: str):
        """Inline prefill-member constructor. A seam on purpose
        (mirrors _host_argv): tests substitute a PrefillNode subclass
        whose engine host is the protocol-faithful fake, so pool churn
        drills cost milliseconds instead of an engine build per node."""
        from symmetry_tpu_torch.engine.disagg.node import PrefillNode

        return PrefillNode(config, listen=listen, device=self._device)

    @staticmethod
    def _member_listen_addr(base: str, index: int, count: int) -> str:
        """Per-member listen address for inline nodes. mem:// gets a
        suffix per member; tcp:// with more than one member rebinds to
        port 0 (each node resolves its real port at start)."""
        if base.startswith("mem://"):
            return f"{base}-p{index}"
        if base.startswith("tcp://") and count > 1:
            host = base[len("tcp://"):].rsplit(":", 1)[0]
            return f"tcp://{host}:0"
        return base

    async def _start_pool(self) -> None:
        """Pool-mode startup: N local decode members (each its own
        reader + supervision task), then M prefill members — inline
        self-hosted PrefillNodes and/or remote peers — each behind its
        own DecodeLink. A member that is not up yet is NOT fatal: it
        joins when it connects (hot-join), and until at least one
        prefill member is healthy submits shed retryable."""
        from symmetry_tpu_torch.engine.disagg.autoscale import (
            AutoscaleConfig, PoolAutoscaler)
        from symmetry_tpu_torch.engine.disagg.pool import PoolRouter

        tpu = self._config.tpu
        self._pool = PoolRouter(
            heartbeat_s=(self._pool_cfg.heartbeat_s
                         if self._pool_cfg.heartbeat_s > 0
                         else self._heartbeat_s),
            affinity_weight=float(
                getattr(tpu, "pool_affinity_weight", 1.0)))
        asc_cfg = AutoscaleConfig(getattr(tpu, "autoscale", None))
        if asc_cfg.enabled:
            # Remote prefill peers are machines this backend cannot
            # conjure — the prefill tier then stays fixed and only the
            # decode tier scales.
            self._autoscaler = PoolAutoscaler(
                asc_cfg, self._pool,
                grow_prefill=self._pool_cfg.prefill_peers is None)
        self._member_seq = {"prefill": self._pool_cfg.prefill_count,
                            "decode": self._pool_cfg.decode_count}
        self._pool_active = True
        members = [_DecodeMember(f"decode-{i}")
                   for i in range(self._pool_cfg.decode_count)]
        for m in members:
            self._decode_members[m.id] = m
            self._pool.add_member(m.id, "decode")
        # All member engine builds OVERLAP (a real host's weight load +
        # warmup takes minutes; N of them back-to-back would multiply
        # start() wall-clock by the pool size).
        await asyncio.gather(*[self._spawn_decode_member(m)
                               for m in members])
        for m in members:
            self._pool.mark_healthy(m.id)
            m.supervisor = asyncio.get_running_loop().create_task(
                self._supervise_decode_member(m))
            self._pool_tasks.append(m.supervisor)
        peers = self._pool_cfg.prefill_peers
        if peers is None:
            base = self._link_cfg.peer or "mem://disagg-pool"
            self._inline_nodes = [
                self._node_factory(self._config, self._member_listen_addr(
                    base, i, self._pool_cfg.prefill_count))
                for i in range(self._pool_cfg.prefill_count)]
            await asyncio.gather(*[node.start()
                                   for node in self._inline_nodes])
            peers = [node.address for node in self._inline_nodes]
            for i, node in enumerate(self._inline_nodes):
                self._node_by_member[f"prefill-{i}"] = node
        for i, addr in enumerate(peers):
            member_id = f"prefill-{i}"
            self._pool.add_member(member_id, "prefill", node_id=addr)
            await self._attach_prefill_link(member_id, addr)
        deadline = time.monotonic() + min(self._spawn_timeout_s, 120.0)
        while (self._pool.healthy_count("prefill") == 0
               and time.monotonic() < deadline):
            await asyncio.sleep(0.05)
        if self._pool.healthy_count("prefill") == 0:
            log.warning("pool: no prefill member connected yet; submits "
                        "shed retryable until one joins")
        self._pool_tasks.append(
            asyncio.get_running_loop().create_task(
                self._pool_heartbeat()))
        log.info(f"tpu_native pool up: "
                 f"{len(peers)}×prefill {self._pool_cfg.decode_count}"
                 f"×decode (inline nodes: {len(self._inline_nodes)})")

    async def _attach_prefill_link(self, member_id: str,
                                   addr: str) -> None:
        """Create + start one prefill member's DecodeLink (startup and
        autoscale-spawn share this): handoffs, events, and membership
        callbacks all member-scoped."""
        import functools

        from symmetry_tpu_torch.engine.disagg.net import DecodeLink

        link = DecodeLink(
            self._link_cfg.for_peer(
                addr, heartbeat_s=self._pool_cfg.heartbeat_s),
            on_handoff=functools.partial(self._pool_handoff, member_id),
            on_event=self._link_event,
            on_fail=self._link_fail,
            on_down=functools.partial(self._pool_member_down, member_id),
            on_up=functools.partial(self._pool_member_up, member_id),
            on_drain=functools.partial(self._pool_member_drain,
                                       member_id),
            on_leave=functools.partial(self._pool_member_leave,
                                       member_id))
        self._plinks[member_id] = link
        await link.start()

    async def _spawn_decode_member(self, m: _DecodeMember) -> None:
        """One decode member life: spawn, ready, clock offset, reader —
        the member-scoped twin of _spawn_host."""
        m.dead = False
        m.engine_alive = True
        # Boot fence: spawned_at is None until READY lands, and the
        # heartbeat's wedge probe skips booting members — a host still
        # building/warming up cannot answer a stats probe, and killing
        # it for that turned every slow (loaded-machine) autoscale
        # spawn or respawn into a startup "wedge" (rc=-9).
        m.spawned_at = None
        m.proc = await self._spawn_one(self._cfg_path)
        await self._await_ready(m.proc, f"decode member {m.id}")
        m.clock_offset = await self._clock_handshake(m.proc)
        m.reader = asyncio.get_running_loop().create_task(
            self._read_member_events(m))
        m.spawned_at = time.monotonic()
        log.info(f"pool: decode member {m.id} up (pid {m.proc.pid}, "
                 f"clock_offset={m.clock_offset * 1e6:+.0f}us)")

    async def _read_member_events(self, m: _DecodeMember) -> None:
        """One decode member's pipe pump: same dispatch as _read_events
        but member-scoped — probe replies land in the MEMBER's waiters
        and EOF runs the MEMBER's death path, never the pool's."""
        proc = m.proc
        assert proc is not None and proc.stdout is not None
        while True:
            line = await proc.stdout.readline()
            if not line:
                break  # member host exited
            try:
                msg = json.loads(line)
            except ValueError:
                continue
            if not isinstance(msg, dict):
                continue
            op = msg.get("op")
            if op in (HostOp.STATS, HostOp.TRACE, HostOp.METRICS,
                      HostOp.PROFILE):
                if op == HostOp.STATS:
                    m.engine_alive = bool(msg.get("engine_alive", True))
                waiters, m.waiters[op] = m.waiters[op], []
                for w in waiters:
                    if not w.done():
                        w.set_result(msg)
                continue
            if op == HostOp.EVENTS:
                events = msg.get("events")
                if not isinstance(events, list):
                    continue
                self.relay_stats["host_frames"] += 1
                self.relay_stats["host_batched_frames"] += 1
                self.relay_stats["host_events"] += len(events)
                self._m_host_frames.inc()
                self._m_host_events.inc(len(events))
                for ev in events:
                    if not isinstance(ev, dict):
                        continue
                    q = self._queues.get(str(ev.get("id", "")))
                    if q is not None:
                        q.put_nowait(ev)
                continue
            if op != HostOp.EVENT:
                continue
            self.relay_stats["host_frames"] += 1
            self.relay_stats["host_events"] += 1
            self._m_host_frames.inc()
            self._m_host_events.inc()
            q = self._queues.get(str(msg.get("id", "")))
            if q is not None:
                q.put_nowait(msg)
        if not m.dead:  # natural EOF (a cancelled reader skips this)
            self._decode_member_lost(m, "decode member host exited")

    def _decode_member_lost(self, m: _DecodeMember, reason: str) -> None:
        """One decode member died: fail ONLY the streams adopted there
        (structured retryable — clients fail over while the member
        respawns), release its probe waiters, wake its supervisor. The
        other members keep serving untouched."""
        if m.dead:
            return
        m.dead = True
        if self._autoscaler is not None:
            # Churn, not a scaling decision: the autoscaler pauses
            # (cooldown) instead of mistaking respawn turbulence for
            # load and flapping the shape.
            self._autoscaler.note_churn()
        for req_id in self._pool.on_lost(m.id):
            self._shed_request(req_id, f"{reason} ({m.id})")
        for lst in m.waiters.values():
            for w in lst:
                if not w.done():
                    w.set_result(None)
            lst.clear()
        hook = self.on_host_restart
        if hook is not None:
            try:
                hook("crash")
            except Exception as exc:  # noqa: BLE001 — diagnostics only
                log.warning(f"on_host_restart hook failed: {exc}")
        m.down.set()

    async def _supervise_decode_member(self, m: _DecodeMember) -> None:
        """Per-member respawn loop: same backoff/stability/circuit
        rules as the pair supervisor, scoped to ONE member — its death
        never restarts a sibling."""
        import contextlib

        while self._pool_active and not m.circuit_open:
            await m.down.wait()
            m.down.clear()
            if not self._pool_active:
                return
            if (m.spawned_at is not None
                    and time.monotonic() - m.spawned_at
                    >= self._min_stable_s):
                m.respawn_failures = 0
            else:
                m.respawn_failures += 1
            if m.reader is not None:
                m.reader.cancel()
                m.reader = None
            if m.proc is not None:
                if m.proc.returncode is None:
                    with contextlib.suppress(ProcessLookupError):
                        m.proc.kill()
                with contextlib.suppress(Exception):
                    await m.proc.wait()
                m.proc = None
            while self._pool_active:
                if m.respawn_failures >= self._max_respawns:
                    m.circuit_open = True
                    log.error(f"pool: decode member {m.id} circuit "
                              f"breaker OPEN after "
                              f"{m.respawn_failures} consecutive "
                              f"failed lives")
                    return
                backoff = min(self._backoff_max_s,
                              self._backoff_base_s
                              * (2 ** min(m.respawn_failures, 8)))
                log.warning(f"pool: respawning decode member {m.id} in "
                            f"{backoff:.2f}s")
                await asyncio.sleep(backoff)
                if not self._pool_active:
                    return
                try:
                    await asyncio.wait_for(self._spawn_decode_member(m),
                                           self._spawn_timeout_s)
                except asyncio.CancelledError:
                    raise
                except Exception as exc:  # noqa: BLE001 — spawn failed
                    m.respawn_failures += 1
                    if m.proc is not None:
                        if m.proc.returncode is None:
                            with contextlib.suppress(ProcessLookupError):
                                m.proc.kill()
                        with contextlib.suppress(Exception):
                            await m.proc.wait()
                        m.proc = None
                    log.error(f"pool: decode member {m.id} respawn "
                              f"failed: {exc}")
                    continue
                m.restarts += 1
                pm = self._pool.get(m.id)
                if pm is not None:
                    pm.restarts = m.restarts
                self._pool.mark_healthy(m.id)
                log.warning(f"pool: decode member {m.id} respawned "
                            f"(restart #{m.restarts})")
                break

    async def _probe_member(self, m: _DecodeMember, op: str,
                            timeout: float = 10.0,
                            payload: dict | None = None) -> dict | None:
        if m.proc is None or m.dead:
            return None
        return await self._probe(op, m.waiters[op], m.proc, timeout,
                                 payload=payload)

    async def _pool_heartbeat(self) -> None:
        """Pool watchdog + gauge feed: probe each decode member's stats
        (wedge detection per member; queue-depth gauge for routing) and
        each connected prefill member's node stats (its host's queue
        depth as the placement signal). Link liveness itself is the
        DecodeLink ping/pong keepalive."""
        import contextlib

        period = (self._pool_cfg.heartbeat_s
                  if self._pool_cfg.heartbeat_s > 0 else self._heartbeat_s)
        while self._pool_active:
            await asyncio.sleep(period)
            if not self._pool_active:
                return
            # All probes CONCURRENT: one wedged member must not delay
            # the others' wedge detection (or stale their gauges) by a
            # full probe timeout each — per-member failure domains
            # apply to the watchdog too.
            decode = [m for m in self._decode_members.values()
                      if m.alive and m.spawned_at is not None]
            plinks = [(mid, link) for mid, link in self._plinks.items()
                      if link.connected]
            replies = await asyncio.gather(
                *[self._probe_member(m, HostOp.STATS,
                                     timeout=self._wedge_timeout_s)
                  for m in decode],
                *[link.probe(LinkOp.STATS,
                             timeout=self._wedge_timeout_s)
                  for _, link in plinks],
                return_exceptions=True)
            if not self._pool_active:
                return
            # Live SLO burn (provider monitor, fast window): the
            # members of this pool serve one provider, so the burn is a
            # provider-level signal — feeding it keeps the router's
            # tie-break (and symtop's per-member burn column) on real
            # request-stream data instead of a forever-0 placeholder,
            # and a multi-provider router comparing pools sees honest
            # numbers. None (no monitor attached / no SLO configured)
            # leaves the gauge untouched. The PER-SLO split feeds the
            # autoscaler (ttft → prefill tier, inter_chunk → decode).
            burns = (self._slo_monitor.burn_rates()
                     if self._slo_monitor is not None else None)
            burn = (max(burns.values(), default=0.0)
                    if burns is not None else None)
            # symprof's measured per-tier device cost: each member's
            # devprof.device_s_total rider, differenced per heartbeat —
            # the autoscaler's M:N ratio signal.
            busy = {"prefill": 0.0, "decode": 0.0}
            for m, msg in zip(decode, replies[:len(decode)]):
                if isinstance(msg, dict):
                    # Per-member journal rider: a member's death then
                    # stamps its streams' sheds with counts no staler
                    # than one pool heartbeat.
                    self._journal.merge(msg.get("journal"))
                    busy["decode"] += self._busy_delta(m.id, msg)
                if not isinstance(msg, dict) or not m.engine_alive:
                    if m.dead:
                        continue  # death path already ran
                    log.error(f"pool: decode member {m.id} wedged "
                              f"(no healthy stats reply); killing it")
                    if m.proc is not None and m.proc.returncode is None:
                        # Racing a self-exit between the check and the
                        # kill must not kill the WATCHDOG task.
                        with contextlib.suppress(ProcessLookupError):
                            m.proc.kill()  # reader EOF runs death path
                    continue
                # Gossip rider first: update_gauges stamps the gossip-
                # age gauge from the freshly-stored summary stamp.
                self._pool.update_summary(m.id, msg.get("prefix_summary"))
                self._pool.update_gauges(
                    m.id, queue_depth=msg.get("queue_depth"),
                    burn_rate=burn)
            for (member_id, _), reply in zip(plinks,
                                             replies[len(decode):]):
                host = (reply.get("host")
                        if isinstance(reply, dict) else None) or {}
                if isinstance(host, dict) \
                        and host.get("queue_depth") is not None:
                    busy["prefill"] += self._busy_delta(member_id, host)
                    self._pool.update_summary(
                        member_id, host.get("prefix_summary"))
                    self._pool.update_gauges(
                        member_id, queue_depth=host["queue_depth"],
                        burn_rate=burn)
            self._autoscale_tick(burns, busy)

    def _busy_delta(self, member_id: str, msg: dict) -> float:
        """One member's device-busy seconds since its last heartbeat,
        from the symprof stats rider (devprof.device_s_total, present
        when tpu.profile_sample > 0). A counter that went backwards is
        a host restart — the new life's total IS the delta."""
        dp = msg.get("devprof")
        if not isinstance(dp, dict):
            return 0.0
        try:
            total = float(dp.get("device_s_total") or 0.0)
        except (TypeError, ValueError):
            return 0.0
        prev = self._prev_busy.get(member_id)
        self._prev_busy[member_id] = total
        if prev is None:
            return max(total, 0.0)
        return total if total < prev else total - prev

    def note_request_cost(self, attained_tokens: int, raw_tokens: int,
                          device_s: float) -> None:
        """Provider fold hook: one finished request's SLO-attainment
        verdict plus its ledger-attributed device seconds. Feeds the
        autoscaler's goodput numerator — only tokens whose request met
        every configured SLO target count (a completion the client's
        deadline already discarded is cost, not goodput)."""
        ls = self.ledger_stats
        ls["attained_tokens"] += max(0, int(attained_tokens))
        ls["raw_tokens"] += max(0, int(raw_tokens))
        ls["device_s"] += max(0.0, float(device_s))
        ls["requests"] += 1

    def _autoscale_tick(self, burns: dict | None, busy: dict) -> None:
        """One controller step at the end of each pool heartbeat: feed
        the sensor snapshot, apply at most one decision as a background
        task (the heartbeat must keep probing while a spawn compiles),
        and book every non-hold decision where the flight recorder can
        see it."""
        if self._autoscaler is None or not self._pool_active:
            return
        applying = (self._scale_task is not None
                    and not self._scale_task.done())
        # Goodput numerator = SLO-attaining tokens from the provider's
        # per-request fold. The old numerator — raw relayed host events,
        # which counted deadline-missed and discarded tokens as goodput
        # — survives as the tokens_raw series so dashboards keep their
        # history while the headline switches to the honest count.
        # Until the first fold arrives (ledger off, or no request has
        # finished yet) fall back to the raw count rather than starving
        # the controller of a throughput signal.
        ls = self.ledger_stats
        raw = float(self.relay_stats["host_events"])
        attained = (float(ls["attained_tokens"]) if ls["requests"]
                    else raw)
        decision = self._autoscaler.tick(
            burn=burns, busy_delta_s=busy,
            tokens_total=attained,
            tokens_raw=raw,
            applying=applying)
        if decision["action"] == "hold":
            return
        log.info(f"autoscale: {decision['action']} — "
                 f"{decision['reason']} "
                 f"(goodput {decision['goodput_tokens_per_chip_s']} "
                 f"tok/chip-s at {decision['chip_s']} chip-s)")
        self._scale_task = asyncio.get_running_loop().create_task(
            self._apply_scale(decision))

    # --- autoscale actuators (member factory) -------------------------

    async def _apply_scale(self, decision: dict) -> None:
        """Turn one controller decision into member lifecycle events.
        Failures cool the controller down (note_churn) instead of
        retrying hot — the next tick re-evaluates from live sensors."""
        action = decision["action"]
        try:
            if action == "spawn":
                await self._scale_spawn(decision["tier"])
            elif action == "drain":
                await self._scale_drain(decision["tier"],
                                        decision["member"])
            elif action == "rebalance":
                # Grow first, shrink second: capacity never dips below
                # the pre-decision shape mid-rebalance.
                await self._scale_spawn(decision["spawn_tier"])
                await self._scale_drain(decision["drain_tier"],
                                        decision["member"])
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # noqa: BLE001 — scaling must not crash
            log.error(f"autoscale: applying {action} failed: {exc}")
            if self._autoscaler is not None:
                self._autoscaler.note_churn()

    async def _scale_spawn(self, tier: str) -> None:
        seq = self._member_seq.get(tier, 0)
        self._member_seq[tier] = seq + 1
        member_id = f"{tier}-{seq}"
        if tier == "decode":
            await self._grow_decode_member(member_id)
        else:
            await self._grow_prefill_member(member_id, seq)

    async def _grow_decode_member(self, member_id: str) -> None:
        """Autoscale spawn, decode tier: a fresh _DecodeMember with its
        own reader + supervision domain, exactly like a startup member."""
        import contextlib

        m = _DecodeMember(member_id)
        self._decode_members[member_id] = m
        self._pool.add_member(member_id, "decode")
        try:
            await asyncio.wait_for(self._spawn_decode_member(m),
                                   self._spawn_timeout_s)
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # noqa: BLE001 — spawn failed
            log.error(f"autoscale: spawn of {member_id} failed: {exc}")
            if m.proc is not None:
                if m.proc.returncode is None:
                    with contextlib.suppress(ProcessLookupError):
                        m.proc.kill()
                with contextlib.suppress(Exception):
                    await m.proc.wait()
                m.proc = None
            self._decode_members.pop(member_id, None)
            self._pool.on_lost(member_id)
            self._pool.retire(member_id)
            raise
        self._pool.mark_healthy(member_id)
        m.supervisor = asyncio.get_running_loop().create_task(
            self._supervise_decode_member(m))
        self._pool_tasks.append(m.supervisor)
        log.info(f"autoscale: decode member {member_id} joined")

    async def _grow_prefill_member(self, member_id: str,
                                   index: int) -> None:
        """Autoscale spawn, prefill tier (inline nodes only — remote
        peers gate grow_prefill off): a fresh PrefillNode through the
        node factory, behind its own DecodeLink. The member goes
        healthy when the link's hello lands (_pool_member_up), same as
        a hot-join."""
        base = self._link_cfg.peer or "mem://disagg-pool"
        # count ≥ 2 forces a unique per-member address (mem:// suffix /
        # tcp port 0) — the original member may own the base address.
        listen = self._member_listen_addr(base, index, max(index + 1, 2))
        node = self._node_factory(self._config, listen)
        self._pool.add_member(member_id, "prefill")
        try:
            await node.start()
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # noqa: BLE001 — spawn failed
            log.error(f"autoscale: prefill node {member_id} failed to "
                      f"start: {exc}")
            self._pool.on_lost(member_id)
            self._pool.retire(member_id)
            raise
        self._inline_nodes.append(node)
        self._node_by_member[member_id] = node
        await self._attach_prefill_link(member_id, node.address)
        log.info(f"autoscale: prefill member {member_id} spawned at "
                 f"{node.address}")

    async def _scale_drain(self, tier: str, member_id: str) -> None:
        """Drain-before-kill: the router stops NEW placements (refusing
        the last placeable member — the 1×1 floor holds even if the
        controller mis-decides), in-flight work runs dry under the stop
        grace, then the member retires out of the registry for good."""
        ok = self._pool.drain(member_id)
        if not ok:
            log.warning(f"autoscale: drain of {member_id} refused "
                        f"(last placeable member of {tier})")
            return
        if tier == "decode":
            await self._retire_decode_member(member_id)
        else:
            await self._retire_prefill_member(member_id)

    async def _wait_drained(self, member_id: str) -> None:
        deadline = time.monotonic() + self._stop_grace_s
        while time.monotonic() < deadline:
            pm = self._pool.get(member_id)
            if pm is None or not pm.in_flight:
                return
            await asyncio.sleep(0.05)

    async def _retire_decode_member(self, member_id: str) -> None:
        import contextlib

        await self._wait_drained(member_id)
        m = self._decode_members.pop(member_id, None)
        self._prev_busy.pop(member_id, None)
        if m is None:
            return
        m.dead = True  # fence the reader's death path: deliberate stop
        if m.supervisor is not None:
            m.supervisor.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await m.supervisor
            if m.supervisor in self._pool_tasks:
                self._pool_tasks.remove(m.supervisor)
            m.supervisor = None
        if m.reader is not None:
            m.reader.cancel()
            m.reader = None
        if m.proc is not None:
            with contextlib.suppress(ConnectionError, OSError):
                await self._host_send({"op": HostOp.SHUTDOWN},
                                      proc=m.proc)
            try:
                await asyncio.wait_for(m.proc.wait(), self._stop_grace_s)
            except asyncio.TimeoutError:
                m.proc.kill()
                await m.proc.wait()  # reap — no zombie
            m.proc = None
        if not self._pool.retire(member_id):
            # Grace expired with work still pinned there: shed it
            # structured-retryable (clients fail over) and retire.
            for req_id in self._pool.on_lost(member_id):
                self._shed_request(
                    req_id, f"decode member {member_id} scaled away")
            self._pool.retire(member_id)
        log.info(f"autoscale: decode member {member_id} retired")

    async def _retire_prefill_member(self, member_id: str) -> None:
        self._retiring.add(member_id)
        try:
            await self._wait_drained(member_id)
            link = self._plinks.pop(member_id, None)
            if link is not None:
                await link.stop()
            node = self._node_by_member.pop(member_id, None)
            if node is not None:
                await node.stop()
                if node in self._inline_nodes:
                    self._inline_nodes.remove(node)
            self._prev_busy.pop(member_id, None)
            if not self._pool.retire(member_id):
                ids = self._member_lost_ids(member_id)
                if ids:
                    self._spawn_replace(
                        ids, f"prefill member {member_id} scaled away")
                self._pool.retire(member_id)
            log.info(f"autoscale: prefill member {member_id} retired")
        finally:
            self._retiring.discard(member_id)

    # --- pool membership callbacks (link-driven) ----------------------

    def _pool_member_up(self, member_id: str) -> None:
        link = self._plinks.get(member_id)
        self._pool.mark_healthy(
            member_id,
            node_id=link.peer_node if link is not None else None)

    def _member_lost_ids(self, member_id: str) -> list[str]:
        """In-flight migrations on a lost member: the router's
        placement view unioned with the broker's pending-migration
        view (authoritative for submitted-but-not-adopted), so neither
        side's bookkeeping gap strands a request."""
        ids = set(self._pool.on_lost(member_id))
        ids.update(self._broker.pending_on(member_id))
        return sorted(ids)

    def _pool_member_down(self, member_id: str, reason: str) -> None:
        """Prefill member's link died (node death, cable pull, wedge):
        its in-flight migrations are RE-PLACED on a survivor — the shed
        only reaches the client when no survivor exists. The link keeps
        reconnecting; a successful reconnect is a rejoin."""
        if member_id in self._retiring:
            return  # deliberate retire tearing its own link down
        if self._autoscaler is not None:
            self._autoscaler.note_churn()
        ids = self._member_lost_ids(member_id)
        if ids:
            self._spawn_replace(ids, f"prefill member {member_id} lost: "
                                     f"{reason}")

    def _pool_member_drain(self, member_id: str, node: str) -> None:
        ok = self._pool.drain(member_id)
        if ok:
            log.info(f"pool: prefill member {member_id} "
                     f"({node or 'unnamed'}) draining")
        else:
            log.warning(f"pool: drain of prefill member {member_id} "
                        f"({node or 'unnamed'}) REFUSED — last placeable "
                        f"member of its tier")

    def _pool_member_leave(self, member_id: str, node: str) -> None:
        """Deliberate departure: account as churn; any straggler still
        in flight there is re-placed like a loss."""
        if member_id in self._retiring:
            return  # deliberate retire: the backend owns the teardown
        ids = self._member_lost_ids(member_id)
        log.info(f"pool: prefill member {member_id} "
                 f"({node or 'unnamed'}) left")
        if ids:
            self._spawn_replace(ids, f"prefill member {member_id} left")

    def _spawn_replace(self, ids: list[str], reason: str) -> None:
        task = asyncio.get_running_loop().create_task(
            self._pool_replace(ids, reason))
        self._replace_tasks.add(task)
        task.add_done_callback(self._replace_tasks.discard)

    async def _pool_replace(self, ids: list[str], reason: str) -> None:
        """Re-place lost in-flight migrations on survivors. Deadlines
        are NOT refunded (the broker keeps the original submit stamp);
        a request that cannot be re-placed sheds structured-retryable —
        the client fails over, nothing hangs, nothing fails outright."""
        for req_id in ids:
            if req_id not in self._queues:
                # Client already gone: just drop the migration state.
                self._pool_submits.pop(req_id, None)
                self._broker.forget(req_id)
                continue
            submit = self._pool_submits.get(req_id)
            placed = None
            if submit is not None:
                placed = await self._pool_send_submit(req_id, submit,
                                                      replacement=True)
            if placed is None:
                self._shed_request(req_id, reason)
            else:
                log.info(f"pool: re-placed {req_id} on {placed} "
                         f"after: {reason}")

    def _routing_digests(self, submit: dict) -> list[str] | None:
        """Causal block digests of a submit's prompt, computed
        provider-side with a routing tokenizer — the request half of
        the cache-affinity match (the member half is the gossiped
        summary). Tokenization here is deterministic and identical to
        the hosts' (same tokenizer files, pure chat template), so the
        digests are exactly the ones a member's radix tree gossips.
        None (load-only placement) on ANY failure: a routing hint must
        never take down a submit."""
        if self._route_tok is False:
            return None
        tpu = self._config.tpu
        if float(getattr(tpu, "pool_affinity_weight", 1.0)) <= 0.0:
            return None
        if self._route_tok is None:
            try:
                from symmetry_tpu_torch.engine.tokenizer import get_tokenizer

                self._route_tok = get_tokenizer(
                    getattr(tpu, "tokenizer_path", None))
            except Exception as exc:  # noqa: BLE001 — degrade, never wedge
                log.warning(f"pool: routing tokenizer unavailable "
                            f"({exc}); placement stays load-only")
                self._route_tok = False
                return None
        try:
            from symmetry_tpu_torch.engine.prefix_cache import block_digests

            ids = self._route_tok.apply_chat_template(
                submit.get("messages") or [])
            bs = int(getattr(tpu, "prefix_block_tokens", 16) or 16)
            # Same whole-block, suffix-keeps-one-token cap as the
            # engine's lookup: affinity should chase reachable KV.
            p = bs * ((len(ids) - 1) // bs)
            if p <= 0:
                return None
            return block_digests(ids, p, bs)
        except Exception:  # noqa: BLE001 — hint only
            return None

    async def _pool_send_submit(self, req_id: str, submit: dict,
                                *, replacement: bool = False
                                ) -> str | None:
        """Place + send one submit over a healthy member's link; walks
        the member set on send failure (each failed member excluded for
        this request — its own down path re-places the REST of its
        load). None when no healthy member accepted it. Placement is
        cache-affine (the request's block digests vs each member's
        gossiped summary), and the submit is stamped with the planned
        decode member + its ledger epoch so the prefill host keys its
        shipped-block ledger by the handoff's actual destination."""
        from symmetry_tpu_torch.engine.disagg.net import LinkError

        digests = self._routing_digests(submit)
        planned = self._pool.plan_decode(req_id, digests)
        if planned is not None:
            submit["ledger"] = {
                "member": planned,
                "epoch": self._pool.ledger_epoch(planned)}
        else:
            submit.pop("ledger", None)
        exclude: set[str] = set()
        while True:
            member_id = self._pool.place(req_id, digests=digests,
                                         exclude=exclude)
            if member_id is None:
                return None
            link = self._plinks.get(member_id)
            if link is None or not link.connected:
                exclude.add(member_id)
                self._pool.release(req_id)
                continue
            try:
                await link.submit(submit)
            except (LinkError, ConnectionError, OSError):
                exclude.add(member_id)
                self._pool.release(req_id)
                continue
            # Only a DELIVERED submit counts as a placement (refused
            # members above must not inflate the ledger).
            self._pool.record_placement(req_id, replacement=replacement)
            self._broker.reassign(req_id, member_id)
            return member_id

    async def _pool_handoff(self, member_id: str, meta: dict,
                            frame: bytes) -> None:
        """A verified handoff frame off ONE member's link → the decode
        member the router picks by queue depth. Same ack semantics as
        the pair's _link_handoff: a local adoption failure sheds the
        request rather than nak the wire."""
        import base64

        req_id = str(meta.get("id", ""))
        if not self._broker.is_pending(req_id):
            # No pending migration: cancelled/failed — or a STALE
            # duplicate from a member that kept prefilling through a
            # link blip while the request was re-placed (and possibly
            # already adopted elsewhere). Only release THIS member's
            # placement, never the request's live decode adoption.
            if self._pool.assigned_to(req_id) == member_id:
                self._pool.release(req_id)
            return
        # Route the decode member BEFORE adopting so the broker can
        # book the frame into that member's ledger; the event loop is
        # single-threaded between the is_pending check and adopt_op, so
        # the pending entry cannot vanish underneath us.
        self._pool_submits.pop(req_id, None)
        decode_id = self._pool.route_decode(req_id)
        m = self._decode_members.get(decode_id) if decode_id else None
        if m is None or not m.alive:
            self._shed_request(
                req_id, "no decode member available for adoption")
            return
        handoff = {"id": meta.get("id"), "p": int(meta.get("p", 0)),
                   "prompt_len": meta.get("prompt_len"),
                   "nbytes": len(frame),
                   "blocks": int(meta.get("blocks", 0)),
                   "shipped": int(meta.get("shipped", 0)),
                   "frame": base64.b64encode(frame).decode("ascii")}
        if "wire_s" in meta:
            handoff["wire_s"] = meta["wire_s"]
        adopt = self._broker.adopt_op(handoff, member=decode_id)
        if adopt is None:
            return
        try:
            await self._host_send(adopt, proc=m.proc)
        except (ConnectionError, OSError):
            self._shed_request(
                req_id, f"decode member {m.id} unavailable for adoption")

    def _pool_status(self) -> dict:
        """The pool block for engine_stats(): router membership +
        per-link wire state + per-decode-host supervision."""
        st = self._pool.stats()
        st["links"] = {
            member_id: {"connected": link.connected,
                        "node": link.peer_node,
                        "connects": link.stats["connects"],
                        "drops": link.stats["drops"],
                        "wire_frames": link.stats["wire_frames"],
                        "wire_bytes": link.stats["wire_bytes"],
                        "clock_offset_s": round(link.clock_offset, 6)}
            for member_id, link in sorted(self._plinks.items())}
        st["decode_hosts"] = {
            m.id: {"alive": m.alive, "restarts": m.restarts,
                   "circuit_open": m.circuit_open,
                   "clock_offset_s": round(m.clock_offset, 6)}
            for m in self._decode_members.values()}
        st["inline_nodes"] = len(self._inline_nodes)
        if self._autoscaler is not None:
            st["autoscale"] = self._autoscaler.stats()
        return st

    async def _clock_handshake(self, proc: asyncio.subprocess.Process,
                               rounds: int = 5) -> float:
        """Measure one host's monotonic-clock offset before any traffic.

        Each round brackets the host's clock read between two local
        stamps; the min-RTT sample's NTP midpoint wins (utils/trace.
        clock_handshake_offset). Runs before that host's reader task
        exists, so replies are read directly off the pipe — nothing
        else can be writing yet (no requests submitted, stats only on
        demand)."""
        from symmetry_tpu_torch.utils.trace import clock_handshake_offset

        samples: list[tuple[float, float, float]] = []
        for _ in range(rounds):
            t0 = time.monotonic()
            await self._host_send({"op": HostOp.CLOCK, "t0": t0}, proc=proc)
            while True:
                line = await proc.stdout.readline()
                if not line:
                    raise BackendError(
                        "engine host died during clock handshake")
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(msg, dict):
                    continue  # stray scalar on stdout (see _read_events)
                if msg.get("op") == HostOp.CLOCK and msg.get("t0") == t0:
                    samples.append((t0, float(msg["t"]), time.monotonic()))
                    break
        return clock_handshake_offset(samples)

    async def _read_events(self) -> None:
        proc = self._proc
        assert proc is not None and proc.stdout is not None
        while True:
            line = await proc.stdout.readline()
            if not line:
                break  # host exited
            try:
                msg = json.loads(line)
            except ValueError:
                continue
            if not isinstance(msg, dict):
                # Valid JSON but not a frame (a stray print of a number
                # or string on the host's stdout): ignoring it is cheap;
                # letting it raise would kill THIS reader task without
                # running the death path below — no stream would ever
                # be failed and no respawn would ever run.
                continue
            op = msg.get("op")
            if op == HostOp.STATS:
                # stats reply: liveness for the health loop + the full
                # scheduler breakdown for engine_stats() consumers
                self._engine_alive = bool(msg.get("engine_alive", True))
                waiters, self._stats_waiters = self._stats_waiters, []
                for w in waiters:
                    if not w.done():
                        w.set_result(msg)
                continue
            if op == HostOp.TRACE:
                waiters, self._trace_waiters = self._trace_waiters, []
                for w in waiters:
                    if not w.done():
                        w.set_result(msg)
                continue
            if op == HostOp.METRICS:
                waiters, self._metrics_waiters = self._metrics_waiters, []
                for w in waiters:
                    if not w.done():
                        w.set_result(msg)
                continue
            if op == HostOp.PROFILE:
                # Capture-finished reply (arrives duration_s after the
                # request — the host runs it off its serve loop).
                waiters, self._profile_waiters = self._profile_waiters, []
                for w in waiters:
                    if not w.done():
                        w.set_result(msg)
                continue
            if op == HostOp.EVENTS:
                # Batched frame: one pipe line carries every slot's delta
                # for a decode block. Fan out in frame order — per-request
                # (and cross-request) ordering is the list order.
                events = msg.get("events")
                if not isinstance(events, list):
                    continue
                self.relay_stats["host_frames"] += 1
                self.relay_stats["host_batched_frames"] += 1
                self.relay_stats["host_events"] += len(events)
                self._m_host_frames.inc()
                self._m_host_events.inc(len(events))
                for ev in events:
                    if not isinstance(ev, dict):
                        continue
                    q = self._queues.get(str(ev.get("id", "")))
                    if q is not None:
                        q.put_nowait(ev)
                continue
            if op != HostOp.EVENT:
                continue
            self.relay_stats["host_frames"] += 1
            self.relay_stats["host_events"] += 1
            self._m_host_frames.inc()
            self._m_host_events.inc()
            q = self._queues.get(str(msg.get("id", "")))
            if q is not None:
                q.put_nowait(msg)
        # Natural EOF only (a cancelled reader must NOT run this: during
        # a respawn the old task is cancelled, and firing the death path
        # then would fail streams served by the NEW host and re-trip the
        # supervisor against a healthy process).
        self._handle_host_exit("engine host exited")

    async def _read_prefill_events(self) -> None:
        """Prefill-host pipe pump (disagg only): forward handoff frames
        to the decode host as adopt ops, relay the prefill tier's OWN
        events (tokenization/admission errors, deadline sheds — terminal
        by construction, this tier never streams tokens), and feed its
        stats/trace probes. EOF runs the SAME death path as the decode
        host: the pair is one supervised unit."""
        proc = self._prefill_proc
        assert proc is not None and proc.stdout is not None
        while True:
            line = await proc.stdout.readline()
            if not line:
                break  # prefill host exited
            try:
                msg = json.loads(line)
            except ValueError:
                continue
            if not isinstance(msg, dict):
                continue
            op = msg.get("op")
            if op == HostOp.HANDOFF:
                adopt = self._broker.adopt_op(msg)
                if adopt is None:
                    continue  # request already cancelled/failed
                try:
                    await self._host_send(adopt)
                except (ConnectionError, OSError):
                    # Decode host dying mid-forward: its death path is
                    # about to shed every stream, this one included.
                    pass
                continue
            if op == HostOp.STATS:
                waiters, self._prefill_stats_waiters = (
                    self._prefill_stats_waiters, [])
                for w in waiters:
                    if not w.done():
                        w.set_result(msg)
                continue
            if op == HostOp.TRACE:
                waiters, self._prefill_trace_waiters = (
                    self._prefill_trace_waiters, [])
                for w in waiters:
                    if not w.done():
                        w.set_result(msg)
                continue
            if op == HostOp.METRICS:
                waiters, self._prefill_metrics_waiters = (
                    self._prefill_metrics_waiters, [])
                for w in waiters:
                    if not w.done():
                        w.set_result(msg)
                continue
            if op in (HostOp.EVENT, HostOp.EVENTS):
                events = (msg.get("events")
                          if op == HostOp.EVENTS else [msg])
                if not isinstance(events, list):
                    continue
                for ev in events:
                    if not isinstance(ev, dict):
                        continue
                    req_id = str(ev.get("id", ""))
                    if ev.get("done"):
                        # Terminal on the prefill tier: the migration
                        # will never happen — drop the pending state.
                        self._broker.forget(req_id)
                    q = self._queues.get(req_id)
                    if q is not None:
                        q.put_nowait(ev)
        self._handle_host_exit("prefill host exited")

    def _handle_host_exit(self, reason: str) -> None:
        """Shared reader-EOF death path. Idempotent per life: if the
        supervisor's heartbeat already handled this death (its
        returncode/dead-reader backstop runs _fail_streams and sets
        _host_down itself), a late EOF re-signaling the event would
        wake the supervisor a SECOND time after the respawn — counting
        a spurious stability failure and killing the healthy new host.
        In disagg mode EITHER host's EOF lands here; the respawn
        replaces the pair."""
        if self._host_dead:
            return
        # Fail every open stream — the host is gone — and wake the
        # supervisor. _host_dead also fences NEW streams (they would
        # otherwise register a queue nobody feeds and hang forever).
        self._host_dead = True
        self._fail_streams(reason)
        if self._host_down is not None:
            self._host_down.set()

    def _fail_streams(self, reason: str) -> None:
        """Terminal event into every open stream queue, and release any
        stats/trace probes awaiting a reply that will never come. With
        supervision on, the event is the structured RETRYABLE restarting
        shed (→ BackendRestartingError → provider {"restarting": true} →
        client ProviderRestartingError → failover); without it — or
        during a deliberate stop(), when no host is ever coming back —
        the old plain error."""
        restarting = (self._started and self._sup_enabled
                      and not self._circuit_open)
        for req_id, q in self._queues.items():
            q.put_nowait({"op": HostOp.EVENT, "done": True,
                          "finish_reason": "error",
                          "restarting": restarting,
                          # Journal-stamped emitted count: what this
                          # stream already relayed (host heartbeat
                          # journal merged in as a lower bound) — the
                          # resume's RNG-lane position rides the shed.
                          "emitted": self._journal.get(req_id),
                          "error": reason, "text": ""})
        for w in (self._stats_waiters + self._trace_waiters
                  + self._metrics_waiters + self._profile_waiters
                  + self._prefill_stats_waiters
                  + self._prefill_trace_waiters
                  + self._prefill_metrics_waiters):
            if not w.done():
                w.set_result(None)
        self._stats_waiters.clear()
        self._trace_waiters.clear()
        self._metrics_waiters.clear()
        # Profile waiters too: a capture in flight when the host dies
        # must fail fast like every other probe — its generous
        # duration+90s timeout would otherwise pin the provider's
        # single-flight capture slot for minutes after the host is gone.
        self._profile_waiters.clear()
        self._prefill_stats_waiters.clear()
        self._prefill_trace_waiters.clear()
        self._prefill_metrics_waiters.clear()
        if self._broker is not None:
            self._broker.fail_all()

    async def _host_send(self, obj: dict,
                         proc: asyncio.subprocess.Process | None = None
                         ) -> None:
        """Write one command line to a host's stdin (default: the
        primary/decode host)."""
        if proc is None:
            proc = self._proc
        if (proc is None or proc.stdin is None
                or getattr(proc.stdin, "is_closing", lambda: False)()):
            # Mid-respawn (or dead) host: surface as the connection error
            # every caller already suppresses/handles, never an assert.
            raise ConnectionError("engine host pipe unavailable")
        proc.stdin.write(
            (json.dumps(obj, separators=(",", ":")) + "\n").encode())
        await proc.stdin.drain()

    async def stop(self) -> None:
        import contextlib

        self._started = False
        if self._supervisor is not None:
            # Before touching the process: a mid-backoff supervisor must
            # not race this shutdown with a respawn.
            self._supervisor.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._supervisor
            self._supervisor = None
        self._restarting = False
        self._pool_active = False
        # Autoscale teardown first: a half-applied spawn/drain must not
        # race the member teardown below.
        if self._scale_task is not None:
            self._scale_task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await self._scale_task
            self._scale_task = None
        self._retiring.clear()
        self._node_by_member.clear()
        self._prev_busy.clear()
        # Pool teardown first: member supervision and replace tasks
        # must not race the shutdown, and no handoff may land on a
        # decode member that is draining away.
        for task in self._pool_tasks + list(self._replace_tasks):
            task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await task
        self._pool_tasks.clear()
        self._replace_tasks.clear()
        for link in self._plinks.values():
            await link.stop()
        self._plinks.clear()
        for node in self._inline_nodes:
            await node.stop()
        self._inline_nodes.clear()
        for m in self._decode_members.values():
            m.dead = True  # fence the reader's death path: this is a stop
            if m.reader is not None:
                m.reader.cancel()
                m.reader = None
            if m.proc is not None:
                with contextlib.suppress(ConnectionError, OSError):
                    await self._host_send({"op": HostOp.SHUTDOWN},
                                          proc=m.proc)
                try:
                    await asyncio.wait_for(m.proc.wait(),
                                           self._stop_grace_s)
                except asyncio.TimeoutError:
                    m.proc.kill()
                    await m.proc.wait()  # reap — no zombie
                m.proc = None
        self._decode_members.clear()
        # Handoff link first (network mode): no new handoff may land on
        # a decode host that is about to drain. The inline node owns
        # its own prefill host shutdown.
        if self._link is not None:
            await self._link.stop()
            self._link = None
        if self._inline_node is not None:
            await self._inline_node.stop()
            self._inline_node = None
        # Prefill host first (disagg): it holds no streams, and stopping
        # it before the decode host means no handoff can land on a
        # half-shut pipe.
        if self._prefill_proc is not None:
            with contextlib.suppress(ConnectionError, OSError):
                await self._host_send({"op": HostOp.SHUTDOWN},
                                      proc=self._prefill_proc)
            try:
                await asyncio.wait_for(self._prefill_proc.wait(),
                                       self._stop_grace_s)
            except asyncio.TimeoutError:
                self._prefill_proc.kill()
                await self._prefill_proc.wait()  # reap — no zombie
            self._prefill_proc = None
        if self._prefill_reader is not None:
            self._prefill_reader.cancel()
            self._prefill_reader = None
        if self._proc is not None:
            with contextlib.suppress(ConnectionError, OSError):
                await self._host_send({"op": HostOp.SHUTDOWN})
            try:
                await asyncio.wait_for(self._proc.wait(),
                                       self._stop_grace_s)
            except asyncio.TimeoutError:
                self._proc.kill()
                await self._proc.wait()  # reap — no zombie
            self._proc = None
        if self._reader is not None:
            self._reader.cancel()
            self._reader = None
        for attr in ("_cfg_path", "_prefill_cfg_path"):
            path = getattr(self, attr)
            if path:
                import os

                with contextlib.suppress(OSError):
                    os.unlink(path)
                setattr(self, attr, None)
        if self._scheduler is not None:
            await asyncio.to_thread(self._scheduler.stop)
            if self._command_loop is not None:
                self._command_loop.stop()  # release worker ranks
                self._command_loop = None
            self._scheduler = None
            self._engine = None

    # ---------------------------------------------------------- supervisor

    async def _supervise(self) -> None:
        """Watchdog + respawn loop. Two wake sources: the reader's EOF
        event (crash — immediate) and the heartbeat tick (wedge — a live
        process whose stats op stops answering within wedge_timeout_s, or
        whose engine thread died). Detection kills the host; the reader's
        EOF path then fails in-flight streams and lands back here for the
        respawn."""
        while self._started and not self._circuit_open:
            try:
                await asyncio.wait_for(self._host_down.wait(),
                                       self._heartbeat_s)
            except asyncio.TimeoutError:
                # Heartbeat: probe a host that is nominally alive.
                if not self._started:
                    return
                proc = self._proc
                if proc is None or self._host_dead:
                    continue  # death already detected; EOF wakes us
                silent_death = (proc.returncode is not None
                                or self._reader is None
                                or self._reader.done())
                if self._local_pair and not silent_death:
                    # The pair is one unit: a dead prefill host/reader
                    # is the same failure as a dead decode one. (In
                    # network mode the prefill tier is supervised on
                    # ITS machine; the link owns that failure domain.)
                    pp = self._prefill_proc
                    silent_death = (pp is None or pp.returncode is not None
                                    or self._prefill_reader is None
                                    or self._prefill_reader.done())
                if silent_death:
                    # A process died or a reader task crashed WITHOUT
                    # the EOF path running (e.g. the reader hit an
                    # unexpected exception): nobody failed the streams or
                    # set _host_down, so waiting for it would spin this
                    # loop forever while clients hang. Run the death
                    # path here.
                    log.error("supervisor: host/reader died without EOF "
                              "handling; recovering")
                    self._host_dead = True
                    self._fail_streams("engine host reader failed")
                    self._kill_host_procs()
                    self._host_down.set()
                    continue
                msg = await self._probe_host_stats(
                    timeout=self._wedge_timeout_s)
                if isinstance(msg, dict):
                    # Emitted-token journal rider: the host's per-stream
                    # pipe-write counts, merged as a lower bound so the
                    # NEXT death's sheds stamp counts no staler than one
                    # heartbeat.
                    self._journal.merge(msg.get("journal"))
                alive = msg is not None and self._engine_alive
                if alive and self._local_pair and self._started:
                    # Decode tier answered — the prefill tier must too,
                    # with a LIVE scheduler thread (a wedged or engine-
                    # dead prefill host means every new request queues
                    # forever while active streams look healthy). Its
                    # engine_alive rides the probe reply directly; the
                    # reader only tracks the decode host's.
                    pmsg = await self._probe_prefill_stats(
                        timeout=self._wedge_timeout_s)
                    if pmsg is None:
                        msg = None  # prefill wedge
                        alive = False
                    elif not pmsg.get("engine_alive", True):
                        alive = False
                if not self._started:
                    return
                if alive:
                    continue
                self._down_reason = ("wedge" if msg is None
                                     else "engine_dead")
                log.error(
                    f"supervisor: host {self._down_reason} "
                    f"(pid {proc.pid}, no healthy stats reply within "
                    f"{self._wedge_timeout_s:.1f}s); killing it")
                self._kill_host_procs()
                continue  # reader EOF fails streams and sets _host_down
            self._host_down.clear()
            if not self._started or self._circuit_open:
                return
            await self._respawn_loop()

    async def _respawn_loop(self) -> None:
        """Respawn the dead host with exponential backoff; open the
        circuit breaker after max_respawns consecutive failures. A
        failure is a respawn that never reached ready OR a life that
        died before min_stable_s — only a STABLE life resets the count,
        so a crash-loop (spawn ok, die seconds later) walks the same
        backoff ladder into the breaker instead of flapping forever."""
        self._restarting = True
        reason, self._down_reason = self._down_reason, "crash"
        if (self._spawned_at is not None
                and time.monotonic() - self._spawned_at
                >= self._min_stable_s):
            self._respawn_failures = 0  # previous life proved stable
        else:
            self._respawn_failures += 1
            if self._respawn_failures >= self._max_respawns:
                self._circuit_open = True
                self._restarting = False
                log.error(
                    f"supervisor: circuit breaker OPEN — host died within "
                    f"{self._min_stable_s:.1f}s of spawn "
                    f"{self._respawn_failures} consecutive times; "
                    f"provider will deregister")
                return
        hook = self.on_host_restart
        if hook is not None:
            # Flight-recorder dump (provider-wired): the death must stay
            # debuggable even though we are about to paper over it.
            try:
                hook(reason)
            except Exception as exc:  # noqa: BLE001 — diagnostics only
                log.warning(f"on_host_restart hook failed: {exc}")
        try:
            while self._started:
                # Same formula as the retry_after_s hint clients get
                # (_restart_eta_s) — they must not desynchronize.
                backoff = self._restart_eta_s()
                log.warning(
                    f"supervisor: respawning engine host in {backoff:.2f}s"
                    f" (after {reason}; attempt"
                    f" {self._respawn_failures + 1})")
                await asyncio.sleep(backoff)
                if not self._started:
                    return
                await self._reap_host()
                try:
                    await asyncio.wait_for(self._spawn_host(),
                                           self._spawn_timeout_s)
                except asyncio.CancelledError:
                    raise
                except Exception as exc:  # noqa: BLE001 — any spawn failure
                    self._respawn_failures += 1
                    await self._reap_host()
                    if self._respawn_failures >= self._max_respawns:
                        self._circuit_open = True
                        log.error(
                            f"supervisor: circuit breaker OPEN after "
                            f"{self._respawn_failures} consecutive failed "
                            f"respawns ({exc}); provider will deregister")
                        return
                    log.error(
                        f"supervisor: respawn failed "
                        f"({self._respawn_failures}/{self._max_respawns}):"
                        f" {exc}")
                    continue
                self._restarts += 1
                # NOT resetting _respawn_failures here: the new life must
                # survive min_stable_s first (the reset happens on the
                # NEXT death's stability check — or never needs to).
                log.warning(
                    f"supervisor: engine host respawned "
                    f"(pid {self._proc.pid}, restart #{self._restarts})")
                return
        finally:
            self._restarting = False

    def _kill_host_procs(self) -> None:
        """SIGKILL whatever of the host pair is still running (reaping
        happens in _reap_host / the readers' EOF paths)."""
        import contextlib

        for proc in (self._proc, self._prefill_proc):
            if proc is not None and proc.returncode is None:
                with contextlib.suppress(ProcessLookupError):
                    proc.kill()

    async def _reap_host(self) -> None:
        """Tear down the current host life (dead or partial) so a fresh
        spawn starts clean: cancel the readers, kill and reap the
        process(es) — in disagg mode the pair is replaced together."""
        import contextlib

        for attr in ("_reader", "_prefill_reader"):
            task = getattr(self, attr)
            if task is not None:
                task.cancel()
                setattr(self, attr, None)
        for attr in ("_proc", "_prefill_proc"):
            proc = getattr(self, attr)
            setattr(self, attr, None)
            if proc is not None:
                if proc.returncode is None:
                    with contextlib.suppress(ProcessLookupError):
                        proc.kill()
                with contextlib.suppress(Exception):
                    await proc.wait()

    def _supervisor_stats(self) -> dict | None:
        if not (self._process_mode and self._sup_enabled):
            return None
        return {"restarts": self._restarts,
                "respawn_failures": self._respawn_failures,
                "restarting": self._restarting,
                "circuit_open": self._circuit_open}

    async def _probe(self, op: str, waiters: list,
                     proc: asyncio.subprocess.Process | None,
                     timeout: float,
                     payload: dict | None = None) -> dict | None:
        """One fresh op round-trip to a host; None on timeout/failure
        (a fire-and-forget probe would return the PREVIOUS probe's answer,
        delaying wedge detection by a health-loop period). `payload`
        rides extra command fields (the profile op's duration/dir)."""
        import contextlib

        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        waiters.append(fut)
        try:
            with contextlib.suppress(ConnectionError, OSError):
                await self._host_send({"op": op, **(payload or {})},
                                      proc=proc)
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            return None
        finally:
            if fut in waiters:
                waiters.remove(fut)

    async def _probe_host_stats(self, timeout: float = 10.0) -> dict | None:
        return await self._probe(HostOp.STATS, self._stats_waiters, None,
                                 timeout)

    async def _probe_host_trace(self, timeout: float = 10.0) -> dict | None:
        return await self._probe(HostOp.TRACE, self._trace_waiters, None,
                                 timeout)

    async def _probe_host_metrics(self, timeout: float = 10.0
                                  ) -> dict | None:
        return await self._probe(HostOp.METRICS, self._metrics_waiters,
                                 None, timeout)

    async def _probe_prefill_stats(self, timeout: float = 10.0
                                   ) -> dict | None:
        if self._prefill_proc is None:
            return None
        return await self._probe(HostOp.STATS, self._prefill_stats_waiters,
                                 self._prefill_proc, timeout)

    async def _probe_prefill_metrics(self, timeout: float = 10.0
                                     ) -> dict | None:
        if self._prefill_proc is None:
            return None
        return await self._probe(HostOp.METRICS,
                                 self._prefill_metrics_waiters,
                                 self._prefill_proc, timeout)

    async def _probe_prefill_trace(self, timeout: float = 10.0
                                   ) -> dict | None:
        if self._prefill_proc is None:
            return None
        return await self._probe(HostOp.TRACE, self._prefill_trace_waiters,
                                 self._prefill_proc, timeout)

    async def trace_components(self) -> list[dict]:
        """Host + scheduler span rings, reconciled onto THIS process's
        clock: each component's clock_offset_s gains the measured
        host-pipe offset, so the provider's merge needs no knowledge of
        which process a span came from."""
        if self._process_mode and self._pool_mode:
            comps: list[dict] = []
            m0 = next((m for m in self._decode_members.values()
                       if m.alive), None)
            if m0 is not None:
                msg = await self._probe_member(m0, HostOp.TRACE)
                for comp in (msg or {}).get("components") or []:
                    if isinstance(comp, dict):
                        comps.append({
                            **comp, "clock_offset_s":
                                float(comp.get("clock_offset_s", 0.0))
                                + m0.clock_offset})
            comps.append(self._broker.tracer.component("handoff_link"))
            return comps
        if self._process_mode:
            if (self._proc is None or self._host_dead
                    or self._proc.returncode is not None):
                return []
            msg = await self._probe_host_trace()
            if msg is None:
                return []
            comps = []
            for comp in msg.get("components") or []:
                if isinstance(comp, dict):
                    comps.append({**comp, "clock_offset_s":
                                  float(comp.get("clock_offset_s", 0.0))
                                  + self._clock_offset})
            if self._disagg:
                # The prefill tier's rings too, on ITS measured offset,
                # with role-prefixed component names so the merged
                # timeline shows two distinct process rows (satellite
                # contract: per-role trace rows, not unified-mode ones).
                # In network mode the rings cross the LINK and the link
                # handshake offset reconciles the other MACHINE's clock.
                if self._net_mode:
                    link = self._link
                    pmsg = (await link.probe(LinkOp.TRACE)
                            if link is not None and link.connected
                            else None)
                    offset = link.clock_offset if link is not None else 0.0
                else:
                    pmsg = await self._probe_prefill_trace()
                    offset = self._prefill_clock_offset
                for comp in (pmsg or {}).get("components") or []:
                    if isinstance(comp, dict):
                        comps.append({
                            **comp,
                            "name": f"prefill_{comp.get('name', 'host')}",
                            "clock_offset_s":
                                float(comp.get("clock_offset_s", 0.0))
                                + offset})
                # The wire leg itself: one span per handoff frame,
                # already on THIS process's clock.
                comps.append(
                    self._broker.tracer.component("handoff_link"))
            return comps
        if self._scheduler is not None:
            trace_export = getattr(self._scheduler, "trace_export", None)
            if trace_export is not None:
                return [trace_export()]  # same process — offset 0
        return []

    async def capture_profile(self, duration_s: float = 2.0,
                              out_dir: str | None = None) -> dict:
        """On-demand jax.profiler capture on the serving engine
        (HostOp.PROFILE): process mode forwards to the primary host —
        the decode tier in disagg (where the steady-state decode loop
        lives), the first live member in pool mode — and awaits the
        capture-finished reply; inproc runs the capture in an executor
        thread against this process's devices. Returns {"path"} on
        success or {"error"} (capture already running, host down)."""
        payload = {"duration_s": float(duration_s),
                   **({"dir": out_dir} if out_dir else {})}
        # Generous beyond the window: the process's FIRST capture pays
        # the profiler's cold init (tens of seconds on a loaded host).
        timeout = float(duration_s) + 90.0
        if self._process_mode and self._pool_mode:
            m0 = next((m for m in self._decode_members.values()
                       if m.alive), None)
            if m0 is None:
                return {"error": "no live decode member"}
            msg = await self._probe_member(m0, HostOp.PROFILE,
                                           timeout=timeout,
                                           payload=payload)
            return ({k: v for k, v in msg.items() if k != "op"}
                    if msg is not None
                    else {"error": "profile probe failed (host down or timed out)"})
        if self._process_mode:
            if (self._proc is None or self._host_dead
                    or self._proc.returncode is not None):
                return {"error": "engine host is down"}
            msg = await self._probe(HostOp.PROFILE, self._profile_waiters,
                                    None, timeout, payload=payload)
            return ({k: v for k, v in msg.items() if k != "op"}
                    if msg is not None
                    else {"error": "profile probe failed (host down or timed out)"})
        # inproc: same process, same devices — capture right here, off
        # the event loop (the capture sleeps for its whole window).
        import tempfile

        from symmetry_tpu_torch.utils.devprof import capture_device_profile

        target = out_dir or os.path.join(tempfile.gettempdir(),
                                         "symmetry_tpu_profiles")
        try:
            path = await asyncio.get_running_loop().run_in_executor(
                None, capture_device_profile, target, float(duration_s),
                self._device_gate)
        except Exception as exc:  # noqa: BLE001 — reply, never raise
            return {"error": str(exc)}
        return {"path": path, "duration_s": float(duration_s)}

    async def metrics_snapshots(self) -> list[dict]:
        """The engine tier's metrics-registry snapshots, tier-labeled —
        merged by the provider into its Prometheus exposition and the
        peer-wire metrics reply (the per-tier labeling the disagg pair
        needs: symtop and a scrape can tell prefill from decode).

        inproc mode shares the provider's process registry, so the
        provider's own snapshot already covers the scheduler families —
        nothing extra to add. In network disagg mode the remote prefill
        node's registry lives on its machine (scrape it there); the
        link/broker families live in THIS process and ride the
        provider snapshot."""
        if not self._process_mode:
            return []
        if self._pool_mode:
            # Every live decode member, node-labeled — the per-member
            # series symtop's pool columns and a scrape read.
            members = [m for m in self._decode_members.values()
                       if m.alive]
            replies = await asyncio.gather(
                *[self._probe_member(m, HostOp.METRICS, timeout=5.0)
                  for m in members],
                return_exceptions=True)
            return [{"snapshot": {k: v for k, v in msg.items()
                                  if k not in ("op", "role")},
                     "labels": {"tier": "decode", "node": m.id}}
                    for m, msg in zip(members, replies)
                    if isinstance(msg, dict)]
        if (self._proc is None or self._host_dead
                or self._proc.returncode is not None):
            return []
        # Both tiers probed CONCURRENTLY with a short timeout: this
        # rides the stats wire reply, and stacking sequential 10 s probe
        # timeouts behind a wedged host would hold the peer loop far
        # longer than a scrape is worth.
        probes = [self._probe_host_metrics(timeout=5.0)]
        if self._local_pair:
            probes.append(self._probe_prefill_metrics(timeout=5.0))
        replies = await asyncio.gather(*probes, return_exceptions=True)
        out: list[dict] = []
        for i, msg in enumerate(replies):
            if not isinstance(msg, dict):
                continue
            role = str(msg.get("role")
                       or ("prefill" if i == 1 else "unified"))
            out.append({"snapshot": {k: v for k, v in msg.items()
                                     if k not in ("op", "role")},
                        "labels": {"tier": role}})
        return out

    async def engine_stats(self) -> dict | None:
        """The scheduler's serving breakdown (counters, engine-side TTFT,
        admission dispatch and block-interval percentiles) — surfaced
        through provider METRICS so a benchmark capture can attribute
        stalls to engine vs relay/wire (round-3 verdict #1/#3)."""
        if self._process_mode and self._pool_mode:
            return await self._pool_engine_stats()
        if self._process_mode:
            sup = self._supervisor_stats()
            if (self._proc is None or self._host_dead
                    or self._proc.returncode is not None):
                # Host down (mid-respawn or circuit open): the supervisor
                # block is the only engine-side truth there is.
                return {"supervisor": sup} if sup else None
            msg = await self._probe_host_stats()
            if msg is None:
                return {"supervisor": sup} if sup else None
            out = {k: v for k, v in msg.items() if k != "op"}
            out["relay"] = dict(self.relay_stats)
            out["resume"] = dict(self.resume_stats)
            if self.ledger_stats["requests"]:
                out["ledger_fold"] = dict(self.ledger_stats)
            out["clock_offset_s"] = round(self._clock_offset, 6)
            out["stages"] = {name: h.to_dict()
                             for name, h in self.stage_hists.items()
                             if h.count}
            if sup:
                out["supervisor"] = sup
            if self._disagg:
                # The handoff ledger (broker counters, prefill-tier
                # latency percentiles, the wire-leg split) and the
                # prefill host's own breakdown, nested so a capture can
                # attribute a slow TTFT to prefill-tier admission vs
                # handoff serialize vs WIRE vs decode-tier adoption —
                # the disagg analog of the stage hists.
                disagg: dict = self._broker.stats()
                if self._net_mode:
                    link = self._link
                    if link is not None:
                        reply = (await link.probe(LinkOp.STATS)
                                 if link.connected else None)
                        if reply:
                            host = reply.get("host")
                            if isinstance(host, dict):
                                disagg["prefill_host"] = {
                                    k: v for k, v in host.items()
                                    if k != "op"}
                            if isinstance(reply.get("node"), dict):
                                # Prefill-node-side link counters:
                                # sender retries, credit stalls/wall,
                                # handoffs pumped, host restarts.
                                disagg["node"] = reply["node"]
                        disagg["link"] = {
                            **link.stats,
                            "connected": link.connected,
                            "clock_offset_s": round(
                                link.clock_offset, 6),
                            **link.reassembly_stats}
                else:
                    pmsg = await self._probe_prefill_stats()
                    if pmsg is not None:
                        disagg["prefill_host"] = {
                            k: v for k, v in pmsg.items() if k != "op"}
                out["disagg"] = disagg
            return out
        if self._scheduler is None:
            return None
        stats = getattr(self._scheduler, "stats", None)
        out = (stats() if stats is not None
               else dict(self._scheduler.metrics))
        out["resume"] = dict(self.resume_stats)
        if self.ledger_stats["requests"]:
            out["ledger_fold"] = dict(self.ledger_stats)
        return out

    async def _pool_engine_stats(self) -> dict:
        """Pool-mode serving breakdown: the first live decode member's
        scheduler stats as the base (the familiar shape), the handoff
        ledger, and the pool block (membership, per-link wire state,
        per-member supervision) nested under disagg.pool."""
        members = list(self._decode_members.values())
        out: dict = {}
        m0 = next((m for m in members if m.alive), None)
        if m0 is not None:
            msg = await self._probe_member(m0, HostOp.STATS)
            if msg is not None:
                out = {k: v for k, v in msg.items() if k != "op"}
        out["relay"] = dict(self.relay_stats)
        out["resume"] = dict(self.resume_stats)
        if self.ledger_stats["requests"]:
            out["ledger_fold"] = dict(self.ledger_stats)
        out["stages"] = {name: h.to_dict()
                         for name, h in self.stage_hists.items()
                         if h.count}
        out["supervisor"] = {
            "restarts": sum(m.restarts for m in members),
            "respawn_failures": sum(m.respawn_failures for m in members),
            "restarting": any(not m.alive and not m.circuit_open
                              for m in members),
            "circuit_open": bool(members) and all(m.circuit_open
                                                  for m in members)}
        disagg: dict = self._broker.stats()
        disagg["pool"] = self._pool_status()
        out["disagg"] = disagg
        return out

    async def healthy(self) -> bool:
        """Engine liveness: a wedged decode loop must fail this (SURVEY §5.3
        — an engine wedge unregisters the provider). In SUPERVISED process
        mode, liveness authority moves to the watchdog: a crash or wedge
        mid-restart is a transient the supervisor is already handling, so
        this stays true and only the circuit breaker (max_respawns
        consecutive failed respawns) fails it — which is what deregisters
        the provider. Unsupervised process mode keeps the old semantics:
        a dead host, a dead engine thread, or a silent stats op all fail."""
        if self._process_mode:
            if self._pool_mode:
                # A pool is healthy while ANY decode member can still
                # come back: only every member's breaker opening (the
                # pool's capacity is permanently gone) deregisters.
                members = list(self._decode_members.values())
                return (self._started and bool(members)
                        and not all(m.circuit_open for m in members))
            if not self._started or self._circuit_open:
                return False
            if self._sup_enabled:
                return True
            if (self._proc is None or self._host_dead
                    or self._proc.returncode is not None):
                return False
            if self._local_pair and (
                    self._prefill_proc is None
                    or self._prefill_proc.returncode is not None):
                return False
            if await self._probe_host_stats() is None:
                return False
            return self._engine_alive
        if self._engine is None or self._scheduler is None:
            return False
        thread = self._scheduler._thread
        return thread is not None and thread.is_alive()

    def _chunk_line(self, request_id: str, created: int, delta: dict,
                    finish: str | None = None) -> str:
        payload = {
            "id": request_id,
            "object": "chat.completion.chunk",
            "created": created,
            "model": self._model_name,
            "choices": [{"index": 0, "delta": delta,
                         "finish_reason": finish}],
        }
        return f"data: {json.dumps(payload)}"

    async def stream(self, request: InferenceRequest) -> AsyncIterator[StreamChunk]:
        if not self._started:
            raise BackendError("tpu_native backend not started")
        max_new = (request.max_tokens if request.max_tokens is not None
                   else DEFAULT_MAX_NEW_TOKENS)
        if max_new < 1:
            raise BackendError(f"max_tokens must be >= 1, got {max_new}")
        request_id = f"chatcmpl-{uuid.uuid4().hex[:16]}"
        created = int(time.time())

        if self._process_mode:
            async for chunk in self._stream_host(request, request_id,
                                                 created, max_new):
                yield chunk
            return

        engine = self._engine
        try:
            prompt_ids = engine.tokenizer.apply_chat_template(request.messages)
        except Exception as exc:  # tokenizer/template failure
            raise BackendError(f"tokenization failed: {exc}") from exc
        sampling = SamplingParams.from_request(request)
        resume_offset = 0
        if request.resume_text is not None:
            # In-process resume: same semantics as the host's _submit
            # (resolve_resume — the shared implementation): condition on
            # prompt + the client's received text, offset the budget,
            # fast-forward the seeded RNG lane. Without this,
            # supports_resume=True would let the provider accept a
            # resume this branch then serves from token 0 — splicing a
            # duplicate completion onto the client's partial text.
            import dataclasses

            from symmetry_tpu_torch.engine.tokenizer import resolve_resume

            try:
                prompt_ids, max_new, resume_offset = resolve_resume(
                    engine.tokenizer,
                    {"text": request.resume_text,
                     **({"tokens": request.resume_tokens}
                        if request.resume_tokens is not None else {})},
                    prompt_ids, max_new)
            except Exception as exc:  # noqa: BLE001
                raise BackendError(f"resume failed: {exc}") from exc
            sampling = dataclasses.replace(sampling,
                                           rng_skip=resume_offset)
            self.resume_stats["resumes"] += 1
            self.resume_stats["resumed_tokens"] += resume_offset
            if max_new == 0:
                # Budget already spent by the interrupted stream — only
                # the finish frame was lost; complete without admitting.
                yield StreamChunk(
                    raw=self._chunk_line(request_id, created,
                                         {"role": "assistant"}), text="")
                yield StreamChunk(
                    raw=self._chunk_line(request_id, created, {},
                                         finish="length"), text="")
                yield StreamChunk(raw="data: [DONE]", text="", done=True)
                return

        if FAULTS.enabled and await FAULTS.apoint("backend.dispatch"):
            raise BackendError("injected frame drop at backend.dispatch")
        session = AsyncSession(self._scheduler,
                               loop=asyncio.get_running_loop())
        session.submit(prompt_ids, sampling,
                       max_new, request_id=request_id,
                       speculative=request.speculative,
                       trace_id=request.trace_id,
                       deadline_s=request.deadline_s,
                       resume_offset=resume_offset)

        def chunk_line(delta: dict, finish: str | None = None) -> str:
            return self._chunk_line(request_id, created, delta, finish)

        try:
            yield StreamChunk(raw=chunk_line({"role": "assistant"}), text="")
            reported = 0
            async for ev in session.events():
                if ev.finish_reason == "expired":
                    raise BackendDeadlineError(
                        ev.error or "request deadline expired")
                if ev.error is not None:
                    raise BackendError(ev.error)
                if ev.text:
                    # exact token accounting: tokens_emitted is the
                    # cumulative streamed-token count, a block chunk
                    # carries the delta (EOS and discarded post-finish
                    # tokens never appear in it)
                    n_new = max(ev.tokens_emitted - reported, 0)
                    reported = max(ev.tokens_emitted, reported)
                    yield StreamChunk(raw=chunk_line({"content": ev.text}),
                                      text=ev.text, tokens=n_new)
                if ev.done:
                    yield StreamChunk(
                        raw=chunk_line({}, finish=ev.finish_reason or "stop"),
                        text="")
                    # symledger: the scheduler's finish event carries the
                    # request's attributed cost block; ride it out on the
                    # terminal chunk so the provider folds per-request
                    # device time / waste / goodput. None while
                    # tpu.ledger is off.
                    yield StreamChunk(raw="data: [DONE]", text="",
                                      done=True, costs=ev.costs)
        finally:
            session.cancel()  # no-op if complete; frees the slot if client left

    def _observe_stages(self, t_recv: float, t_submit: float,
                        t: dict, clock_offset: float | None = None
                        ) -> None:
        """Fold one request's first-event stage stamps into the per-stage
        TTFT histograms.

        Host stamps are mapped onto THIS process's clock through the
        measured handshake offset (host − provider) before differencing —
        the old code assumed zero offset and clamped the resulting
        negative cross-process spans to zero, which silently zeroed the
        pipe_in/relay legs whenever clock reads interleaved. Spans are
        recorded as measured: residual sub-RTT jitter may still produce a
        microsecond-negative value, and hiding it would misstate the
        distribution the same way the clamp did."""
        now = time.monotonic()
        off = (self._clock_offset if clock_offset is None
               else clock_offset)
        recv = t["recv"] - off if "recv" in t else t_submit
        picked = t["picked"] - off if "picked" in t else recv
        first = t["first"] - off if "first" in t else picked
        out = t["out"] - off if "out" in t else first
        spans = {"submit": t_submit - t_recv,
                 "pipe_in": recv - t_submit,
                 "queue": picked - recv,
                 "prefill": first - picked,
                 "emit": out - first,
                 "relay": now - out}
        for name, span in spans.items():
            self.stage_hists[name].observe(span)
            self._m_stage.observe(span, stage=name)

    def _restart_eta_s(self) -> float:
        """Rough time until the host is back — the retry_after hint on
        restarting sheds (next respawn backoff; spawn time not included)."""
        return min(self._backoff_max_s,
                   self._backoff_base_s
                   * (2 ** min(self._respawn_failures, 8)))

    def _check_host_available(self) -> None:
        """Fence for new work against a down host: circuit-open is
        permanent (plain BackendError → provider error path), a
        supervised death/respawn window is the retryable restarting shed."""
        if self._pool_mode:
            members = list(self._decode_members.values())
            if members and all(m.circuit_open for m in members):
                raise BackendError(
                    "every decode pool member's circuit breaker is open")
            if not any(m.alive for m in members):
                raise BackendRestartingError(
                    "decode pool members restarting",
                    retry_after_s=self._restart_eta_s())
            # Prefill availability is a PLACEMENT decision — the submit
            # path sheds retryable when no member is placeable.
            return
        if self._circuit_open:
            raise BackendError(
                "engine host unavailable (circuit breaker open)")
        down = (self._restarting or self._host_dead or self._proc is None
                or self._proc.returncode is not None)
        if not down and self._local_pair:
            down = (self._prefill_proc is None
                    or self._prefill_proc.returncode is not None)
        if down:
            if self._sup_enabled:
                raise BackendRestartingError(
                    "engine host restarting",
                    retry_after_s=self._restart_eta_s())
            raise BackendError("engine host exited")
        if self._net_mode and (self._link is None
                               or not self._link.connected):
            # Link down is ALWAYS a retryable shed (the reconnect loop
            # is already running), independent of host supervision.
            raise BackendRestartingError(
                "handoff link down (reconnecting)",
                retry_after_s=self._link_cfg.reconnect_base_s * 2)

    async def _stream_host(self, request: InferenceRequest, request_id: str,
                           created: int, max_new: int
                           ) -> AsyncIterator[StreamChunk]:
        """Host-process path: submit over the pipe, relay its events."""
        self._check_host_available()
        if FAULTS.enabled and await FAULTS.apoint("backend.dispatch"):
            raise BackendError("injected frame drop at backend.dispatch")
        queue: asyncio.Queue = asyncio.Queue()
        self._queues[request_id] = queue
        completed = False
        t_recv = time.monotonic()
        # Journal entry for this stream (released on every exit path):
        # the death paths stamp their sheds' `emitted` counts from it.
        journal = self._journal.track(request_id)
        is_resume = request.resume_text is not None
        if is_resume:
            self.resume_stats["resumes"] += 1
            if request.resume_tokens:
                self.resume_stats["resumed_tokens"] += request.resume_tokens
        # Offset dedup (armed by the first event's resume_from): events
        # whose tokens the client already holds are dropped here at the
        # relay, so a resume never replays received tokens even when the
        # serving host floored its continuation below the client's count.
        drop_left: int | None = None
        dedup_dropped = 0  # tokens dropped here → resume_discarded waste
        try:
            try:
                submit = {
                    "op": HostOp.SUBMIT, "id": request_id,
                    "messages": request.messages, "max_new": max_new,
                    "sampling": {"temperature": request.temperature or 0.0,
                                 "top_p": (request.top_p
                                           if request.top_p is not None
                                           else 1.0),
                                 "top_k": getattr(request, "top_k", None)
                                 or 0,
                                 "seed": request.seed},
                    **({"speculative": request.speculative}
                       if request.speculative is not None else {}),
                    **({"trace": request.trace_id}
                       if request.trace_id else {}),
                    **({"deadline_s": request.deadline_s}
                       if request.deadline_s is not None else {}),
                    **({"resume": {
                            "text": request.resume_text,
                            **({"tokens": int(request.resume_tokens)}
                               if request.resume_tokens is not None
                               else {})}}
                       if is_resume else {})}
                if self._disagg:
                    # Disagg: new work enters through the PREFILL tier;
                    # the broker keeps the state the decode tier will
                    # need when the handoff frame comes back. Network
                    # mode sends the submit over the handoff link (a
                    # LinkError is a ConnectionError — the handler
                    # below turns it into the retryable shed). Pool
                    # mode PLACES it on the least-loaded healthy
                    # member and keeps the full op for re-placement.
                    self._broker.note_submit(request_id, submit)
                    if self._pool_mode:
                        self._pool_submits[request_id] = submit
                        member = await self._pool_send_submit(
                            request_id, submit)
                        if member is None:
                            self._pool_submits.pop(request_id, None)
                            self._broker.forget(request_id)
                            raise BackendRestartingError(
                                "no healthy prefill pool member",
                                retry_after_s=(
                                    self._link_cfg.reconnect_base_s * 2))
                    elif self._net_mode:
                        # Stamp the decode-side ledger epoch: a decode
                        # host respawn dropped its KV, so the prefill
                        # host must forget which blocks it shipped.
                        submit["ledger"] = {"member": "decode",
                                            "epoch": self._restarts}
                        await self._link.submit(submit)
                    else:
                        await self._host_send(submit,
                                              proc=self._prefill_proc)
                else:
                    await self._host_send(submit)
            except (ConnectionError, OSError):
                # The host died between the fence and the write (the
                # reader may not have processed the EOF yet, so the
                # re-check can still see a nominally-live host): same
                # contract as a mid-stream death — retryable whenever
                # the supervisor will bring the host back.
                self._check_host_available()
                if self._sup_enabled:
                    raise BackendRestartingError(
                        "engine host pipe write failed (host dying)",
                        retry_after_s=self._restart_eta_s()) from None
                raise BackendError("engine host pipe write failed") from None
            t_submit = time.monotonic()
            yield StreamChunk(
                raw=self._chunk_line(request_id, created,
                                     {"role": "assistant"}), text="")
            while True:
                # Generous ceiling: even a deep chunked prefill emits
                # within minutes; a host that is alive-but-wedged would
                # otherwise hang this stream forever (health checks
                # deregister the provider, but open streams must end too).
                try:
                    ev = await asyncio.wait_for(queue.get(), 600)
                except asyncio.TimeoutError:
                    raise BackendError(
                        "engine host produced no event for 600s") from None
                stamps = ev.get("t")
                if isinstance(stamps, dict):
                    off = None
                    if self._pool_mode:
                        # Host stamps came from whichever decode member
                        # adopted this request — reconcile through ITS
                        # measured clock offset.
                        dm = self._decode_members.get(
                            self._pool.adopted_on(request_id) or "")
                        if dm is not None:
                            off = dm.clock_offset
                    self._observe_stages(t_recv, t_submit, stamps,
                                         clock_offset=off)
                if "reused" in ev:
                    # First-event rider: radix tokens this admission
                    # reused (for a resume, the cheap-seeded-re-prefill
                    # contract the chaos round asserts on).
                    if is_resume:
                        self.resume_stats["reused_tokens"] += int(
                            ev.get("reused") or 0)
                        if request.resume_tokens is None:
                            # Hard-drop resumes carry no claimed count —
                            # the host derived it from the text and
                            # echoes it as resume_from; book it so the
                            # wasted-work headline counts this failure
                            # class too.
                            self.resume_stats["resumed_tokens"] += int(
                                ev.get("resume_from") or 0)
                    if is_resume and drop_left is None:
                        # Arm the offset dedup: the host continued from
                        # resume_from (its token numbering == the
                        # client's claimed count when one was sent);
                        # anything below the client's count is overlap.
                        server_from = ev.get("resume_from")
                        if (request.resume_tokens is not None
                                and isinstance(server_from, int)):
                            drop_left = max(
                                0, request.resume_tokens - server_from)
                err = ev.get("error")
                if ev.get("restarting"):
                    # Host crash/wedge mid-stream: the structured
                    # RETRYABLE shed (supervisor is respawning; the
                    # client should fail over now, not wait). Carries
                    # the journal-stamped emitted count — the resume's
                    # RNG-lane anchor.
                    emitted = ev.get("emitted")
                    raise BackendRestartingError(
                        err or "engine host restarting",
                        retry_after_s=self._restart_eta_s(),
                        emitted=(int(emitted)
                                 if isinstance(emitted, int) else None))
                if ev.get("finish_reason") == "expired":
                    raise BackendDeadlineError(
                        err or "request deadline expired")
                if err and ev.get("finish_reason") == "error":
                    raise BackendError(err)
                text = ev.get("text", "")
                n_new = int(ev.get("tokens_new", 0))
                if text and drop_left:
                    if n_new <= drop_left:
                        # Overlap: the client already has these tokens —
                        # drop the text (a resume never replays tokens
                        # the client received). A done=True event still
                        # delivers its finish below: swallowing it would
                        # hang the stream on a queue nobody feeds.
                        drop_left -= n_new
                        dedup_dropped += n_new
                        self.resume_stats["dedup_dropped"] += n_new
                        self._m_resume_wasted.inc(n_new)
                        if not ev.get("done"):
                            continue
                        text = ""
                    else:
                        # Straddling block event: token-to-text
                        # boundaries inside one event are not
                        # recoverable here, and relaying it whole would
                        # splice already-received characters into the
                        # client transcript — silent corruption. Fail
                        # the RESUME attempt cleanly instead: the
                        # client's fallback regenerates from scratch,
                        # which is slower but byte-correct.
                        raise BackendError(
                            f"resume overlap straddles a block event "
                            f"({n_new} tokens, {drop_left} left to "
                            f"drop) — cannot dedup at token "
                            f"granularity; restart the stream")
                if text:
                    journal.note(n_new)
                    yield StreamChunk(
                        raw=self._chunk_line(request_id, created,
                                             {"content": text}),
                        text=text, tokens=n_new)
                if ev.get("done"):
                    completed = True
                    yield StreamChunk(
                        raw=self._chunk_line(
                            request_id, created, {},
                            finish=ev.get("finish_reason") or "stop"),
                        text="")
                    costs = ev.get("costs")
                    if isinstance(costs, dict) and dedup_dropped:
                        # Relay-side dedup discarded tokens the device
                        # already paid for: price them at this request's
                        # own decode rate and book resume_discarded —
                        # the scheduler cannot see this class (the drop
                        # happens here), so the relay is its one true
                        # booking site. Mutating the relayed block is
                        # safe: it crossed the pipe, nothing else holds
                        # a reference.
                        dev = costs.get("device_s") or {}
                        toks = int(costs.get("tokens") or 0)
                        rate = (float(dev.get("decode", 0.0))
                                / toks if toks > 0 else 0.0)
                        wasted = costs.setdefault("wasted_s", {})
                        wasted["resume_discarded"] = round(
                            wasted.get("resume_discarded", 0.0)
                            + rate * dedup_dropped, 6)
                        costs["wasted_total_s"] = round(
                            sum(wasted.values()), 6)
                        costs["wasted_tokens"] = int(
                            costs.get("wasted_tokens") or 0) + dedup_dropped
                    yield StreamChunk(
                        raw="data: [DONE]", text="", done=True,
                        costs=costs if isinstance(costs, dict) else None)
                    return
        finally:
            # Journal release AFTER the stream settles: every death path
            # that stamps from it ran synchronously before this task
            # resumed, so the count was read while still tracked.
            journal.release()
            self._queues.pop(request_id, None)
            if self._pool_mode:
                placed = self._pool.assigned_to(request_id)
                adopted = self._pool.adopted_on(request_id)
                self._pool.note_done(request_id)
                self._pool_submits.pop(request_id, None)
                if not completed:
                    import contextlib

                    self._broker.forget(request_id)
                    # Cancel wherever the request may still live: the
                    # prefill member it was placed on (over its link)
                    # and the decode member that adopted it.
                    link = self._plinks.get(placed) if placed else None
                    if link is not None:
                        with contextlib.suppress(ConnectionError, OSError):
                            await link.cancel(
                                {"op": HostOp.CANCEL, "id": request_id})
                    dm = (self._decode_members.get(adopted)
                          if adopted else None)
                    if dm is not None and dm.alive:
                        with contextlib.suppress(ConnectionError, OSError):
                            await self._host_send(
                                {"op": HostOp.CANCEL, "id": request_id},
                                proc=dm.proc)
            elif not completed:
                # client abandoned the stream: free the slot host-side.
                # In disagg the request may be on EITHER tier (queued or
                # prefilling on one, decoding on the other) — cancel on
                # both; the hosts ignore ids they don't hold.
                import contextlib

                if self._broker is not None:
                    self._broker.forget(request_id)
                if self._net_mode and self._link is not None:
                    # The request may still be queued/prefilling on the
                    # REMOTE tier — cancel travels the link.
                    with contextlib.suppress(ConnectionError, OSError):
                        await self._link.cancel(
                            {"op": HostOp.CANCEL, "id": request_id})
                for proc in (self._proc, self._prefill_proc):
                    if proc is None or proc.returncode is not None:
                        continue
                    with contextlib.suppress(ConnectionError, OSError):
                        await self._host_send(
                            {"op": HostOp.CANCEL, "id": request_id}, proc=proc)
