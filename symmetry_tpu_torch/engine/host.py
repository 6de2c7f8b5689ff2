"""Engine host process: the PyTorch engine behind a pipe.

Port of symmetry_tpu/engine/host.py. The provider runs its engine in a
host process (tpu.engine_isolation: process, the default) and talks to it
in JSON lines; this host speaks the same protocol, so a provider can drive
the port by running this module in place of the JAX package's host. It
builds its engine with InferenceEngine.from_tpu_config from the same
provider config file.

Roles (tpu.role, engine/disagg/): "unified" (default) serves the full
request; "prefill" builds each prompt's KV and emits it as a versioned
handoff frame instead of decoding; "decode" accepts `adopt` commands
carrying those frames, seeds its prefix store from them, and generates. A
broker (the JAX provider's tpu_native backend with `tpu.role: disagg`)
runs a prefill + decode host pair and pipes handoff -> adopt between them.

Protocol: JSON lines, as in the JAX package's host.
  stdin  ← {"op": "submit", "id", "messages", "max_new", "sampling": {…},
            "trace"?, "deadline_s"?, "resume"?, "speculative"?, "ledger"?}
           {"op": "adopt", "id", "frame": base64 handoff frame, "max_new",
            "sampling", "speculative"?, "trace"?, "deadline_s"?,
            "resume"?}   (decode role: adopt a handed-off KV prefix and
            generate; the prompt tokens ride the frame)
           {"op": "cancel", "id"}
           {"op": "clock", "t0"}  {"op": "trace"}  {"op": "metrics"}
           {"op": "profile", "duration_s"?, "dir"?}   (a bounded
            torch.profiler capture on its own thread, utils/devprof.py)
           {"op": "stats"}  {"op": "shutdown"}
  stdout → {"op": "ready", "model", "role", "slots", "max_seq_len",
            "build_s", "warmup_s"}              (after warmup)
           {"op": "event", "id", "text", "done"?, "finish_reason"?,
            "error"?, "ttft_s"?, "tokens", "tokens_new", "t"?, "reused"?,
            "resume_from"?, "costs"?}           (a lone event)
           {"op": "events", "events": [{…event fields…}, …]}  (one frame
            per decode block: the scheduler's batched emit sink)
           {"op": "handoff", "id", "p", "prompt_len", "nbytes", "frame",
            "blocks", "shipped", "t"}   (prefill role: the prompt's
            whole-block KV prefix, serialized; p == 0 is routing-only)
           {"op": "clock", "t0", "t"}  {"op": "trace", "clock",
            "components"}   (host and scheduler rings, and the `device`
            probe track while tpu.profile_sample is on)
           {"op": "metrics", "role", "families"}
           {"op": "profile", "path", "duration_s"} | {"op": "profile",
            "error"}   (the capture's directory, holding trace.json)
           {"op": "stats", …}  (scheduler counters with the `emit`,
            `journal`, `engine_alive` and `prefix_summary` riders, and a
            `kernels` rider: each kernel wrapper's launch count in this
            process, and `decode_attention_append`, the decode launches
            that wrote the step's K/V row, so a caller can show the path
            ran on the kernels; the prefill role adds `handoff`, the
            decode role `adopt`, and probes a `devprof` block)

A mesh (`tpu.mesh` over any of the `model`, `data`, `context`, `expert`
and `stage` axes, parallel/): this host is rank 0 and its scheduler drives every rank
through the command loop
(parallel/multihost.py), as the JAX host does for a multihost job. With
`tpu.multihost`, the other ranks are started by the operator
(`python -m symmetry_tpu_torch.provider --worker`). Without it, the host
starts ranks 1..N-1 itself, as followers on this machine (a named
deviation: a JAX process drives a one-host mesh alone, a PyTorch rank is a
process): `python -m symmetry_tpu_torch.engine.host cfg --follow R
--coordinator ADDR --parent PID`. A follower dies with the host (the
kernel's parent-death signal), so a respawned host never finds an orphan
rank holding the card; `--device` names each rank's card, and ranks share
one only when it names the card exactly (e.g. cuda:0). A stage axis
beside another axis above 1 fails at start (in the JAX engine's words).
`tpu.compile_cache` names where the kernels are built
(utils/compile_cache.py); PyTorch runs eagerly.

Logs go to stderr; frames go to stdout, one line each. `main` moves the
process's file descriptor 1 onto stderr and keeps a private copy for the
frames, so a stray print (from any library or child process) cannot
corrupt the pipe. The kernels build in warmup, before `ready`.

Run: python -m symmetry_tpu_torch.engine.host <config.yaml> [--device cpu]
(the default device is the CUDA card).
"""

from __future__ import annotations

import argparse
import base64
import ctypes
import inspect
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from collections import OrderedDict
from typing import TYPE_CHECKING, Any, TextIO

from symmetry_tpu_torch.engine.disagg import (
    decode_kv_handoff,
    encode_kv_handoff,
)
from symmetry_tpu_torch.engine.engine import (
    HostFuture,
    InferenceEngine,
    SamplingParams,
    to_numpy_plane,
)
from symmetry_tpu_torch.engine.prefix_cache import block_digests
from symmetry_tpu_torch.engine.scheduler import GenRequest, Scheduler
from symmetry_tpu_torch.engine.tokenizer import resolve_resume
from symmetry_tpu_torch.ops.decode_attention import decode_attention
from symmetry_tpu_torch.ops.flash import flash_prefill
from symmetry_tpu_torch.ops.kv_append import kv_append
from symmetry_tpu_torch.ops.qmm import w8a8_matmul, w8a16_matmul
from symmetry_tpu_torch.parallel.mesh import MeshSpec
from symmetry_tpu_torch.parallel.multihost import (
    CommandLoop,
    MultihostEngine,
    init_distributed,
)
from symmetry_tpu_torch.protocol.keys import HostOp
from symmetry_tpu_torch.provider.config import ConfigManager
from symmetry_tpu_torch.utils.compile_cache import enable_compile_cache
from symmetry_tpu_torch.utils.devprof import (
    capture_device_profile,
    init_capture,
)
from symmetry_tpu_torch.utils.faults import FAULTS
from symmetry_tpu_torch.utils.logging import logger, set_component
from symmetry_tpu_torch.utils.metrics import METRICS, MetricName
from symmetry_tpu_torch.utils.trace import Tracer

if TYPE_CHECKING:
    from symmetry_tpu_torch.engine.scheduler import TokenEvent

KERNEL_WRAPPERS = (flash_prefill, decode_attention, kv_append, w8a16_matmul,
                   w8a8_matmul)

# Raw-KV byte bound for one handoff frame. The frame travels the broker's
# pipes as ONE base64 JSON line (~4/3 x raw), under the backend's 1 GiB line
# limit in disagg mode; an oversized prefix is capped to the largest
# whole-block length that fits (KV at position i depends only on tokens
# <= i, so a shorter prefix is sound: the decode tier prefills a longer
# suffix).
HANDOFF_MAX_KV_BYTES = 384 * 1024 * 1024


class GatedEngine:
    """The engine as the host and its Scheduler see it: every method call,
    and every host copy of a dispatch's result (HostFuture), holds `gate`
    (a reentrant lock), which the `profile` op's capture takes around
    torch.profiler's start and stop (utils/trace.py device_trace). So no
    CUDA call runs on the engine thread while the profiler sets up or tears
    down its CUDA tracing: captures that raced the engine thread's launches
    crashed engine hosts on the H100 (SIGSEGV inside the profiler's stop,
    the engine thread inside a kernel launch). All of the engine's device
    work runs inside its methods or a HostFuture copy; attributes pass
    through, and so do the host-state reads that the stats op makes on the
    pipe-reader thread (HOST_ONLY), which would otherwise wait behind a
    whole decode block."""

    HOST_ONLY = frozenset({"prefix_cache_stats", "prefix_cache_summary",
                           "weight_stream_bytes",
                           "weight_stream_bytes_per_device"})

    def __init__(self, engine: InferenceEngine, gate: Any) -> None:
        self._engine = engine
        self._gate = gate

    def __getattr__(self, name: str) -> Any:
        attr = getattr(self._engine, name)
        if not inspect.ismethod(attr) or name in self.HOST_ONLY:
            return attr
        gate = self._gate

        def call(*args, **kwargs):
            with gate:
                out = attr(*args, **kwargs)
            if isinstance(out, HostFuture):
                return _GatedFuture(out, gate)
            if isinstance(out, tuple) and out and all(
                    isinstance(o, HostFuture) for o in out):
                return tuple(_GatedFuture(o, gate) for o in out)
            return out

        return call


class _GatedFuture:
    """A HostFuture whose host copy (np.asarray) holds the gate."""

    __slots__ = ("_future", "_gate")

    def __init__(self, future: HostFuture, gate: Any) -> None:
        self._future = future
        self._gate = gate

    def __array__(self, dtype=None, copy=None):
        with self._gate:
            return self._future.__array__(dtype, copy)


class EngineHost:
    def __init__(self, config: ConfigManager | None, *,
                 device: str = "cuda", out: TextIO | None = None) -> None:
        self._config = config
        self._device = device
        # Frame stream: `main` passes a private copy of the real stdout;
        # None writes to whatever sys.stdout is at the time.
        self._out = out
        # Fault injection: env SYMMETRY_FAULTS (loaded at import) and a
        # provider-config `faults:` mapping (config is None in protocol
        # unit tests that never start()).
        if config is not None:
            FAULTS.load(config.get("faults"))
        self._engine: GatedEngine | None = None
        self._scheduler: Scheduler | None = None
        # A mesh: rank 0's command loop, and the follower ranks this host
        # started (a one-host mesh without tpu.multihost).
        self._command_loop = None
        self._followers: list[subprocess.Popen] = []
        self._wlock = threading.Lock()
        # Held by every engine call and the profile capture's start/stop
        # (GatedEngine).
        self._device_gate = threading.RLock()
        # Whether the profiler's CUDA tracing has been started once on the
        # main thread (the first `profile` op does it).
        self._capture_ready = False
        self._cancelled: set[str] = set()
        self._reported: dict[str, int] = {}  # id -> tokens already reported
        # The host's own trace ring (submit and flush spans); the
        # scheduler keeps its own, and the `trace` op ships both.
        self.tracer = Tracer()
        # Emit-path counters (under _wlock): every stdout line counts one
        # pipe_write; pipe_event_writes counts only lines carrying
        # TokenEvents (the O(1)-writes-per-block contract's numerator).
        self.emit_stats = {"pipe_writes": 0, "pipe_event_writes": 0,
                           "pipe_events": 0, "pipe_batched_frames": 0,
                           "pipe_bytes": 0}
        # Disaggregation (engine/disagg/): the host's tier role and its side
        # of the handoff accounting — serialize wall and frame bytes on the
        # prefill tier, adoption outcomes on the decode tier. Both ride the
        # stats op.
        self._role = (getattr(config.tpu, "role", "unified") or "unified"
                      if config is not None else "unified")
        self.handoff_stats = {"frames": 0, "bytes": 0, "prefix_tokens": 0,
                              "routing_only": 0, "serialize_s": 0.0,
                              # blocks covered by the manifests vs blocks
                              # whose payload shipped
                              "blocks": 0, "blocks_shipped": 0}
        # Digests of blocks already shipped from this prefill host, PER
        # DESTINATION MEMBER (LRU-bounded). A block in a member's ledger is
        # omitted from later frames to it: the member adopts it by
        # reference, or — if it evicted the block since — re-prefills a
        # longer suffix (correct either way; a bytes optimization). The
        # submit op's "ledger" field names the destination and its ledger
        # epoch (an advanced epoch drops the member's entries: its
        # respawned cache is empty). Submits without it book under one
        # default key. Gated by tpu.handoff_ledger.
        self._ledger_on = bool(getattr(config.tpu, "handoff_ledger",
                                       False)) if config is not None \
            else False
        self._shipped: dict[str, OrderedDict[str, None]] = {}
        self._shipped_cap = 65536          # digests kept per member
        self._ledger_epochs: dict[str, int] = {}
        self._ledger_dest: dict[str, str] = {}  # req id -> member key
        self.adopt_stats = {"frames": 0, "bytes": 0, "adopted": 0,
                            "rejected": 0, "errors": 0,
                            "deserialize_s": 0.0}
        self._m_pipe_writes = METRICS.counter(
            MetricName.HOST_PIPE_WRITES, "host stdout frames written")
        self._m_pipe_bytes = METRICS.counter(
            MetricName.HOST_PIPE_BYTES, "host stdout bytes written")
        self._m_pipe_events = METRICS.counter(
            MetricName.HOST_PIPE_EVENTS, "token events carried on the pipe")
        self._m_handoff_frames = METRICS.counter(
            MetricName.HOST_HANDOFF_FRAMES,
            "handoff frames emitted (prefill role)")
        self._m_handoff_bytes = METRICS.counter(
            MetricName.HOST_HANDOFF_BYTES, "handoff frame bytes emitted")
        self._m_handoff_serialize = METRICS.histogram(
            MetricName.HOST_HANDOFF_SERIALIZE,
            "handoff extract+serialize wall per frame")
        self._m_adopt_frames = METRICS.counter(
            MetricName.HOST_ADOPT_FRAMES,
            "handoff frames processed by the decode role",
            labels=("outcome",))
        self._m_adopt_deserialize = METRICS.histogram(
            MetricName.HOST_ADOPT_DESERIALIZE,
            "handoff decode+validate+insert wall per frame")

    # ---------------------------------------------------------------- wire

    def _write(self, obj: dict[str, Any], *, events: int = 0) -> None:
        if FAULTS.enabled and FAULTS.point("host.pipe_write"):
            return  # injected drop_frame: the frame is lost on the wire
        line = json.dumps(obj, separators=(",", ":"))
        t0 = time.monotonic()
        with self._wlock:
            self.emit_stats["pipe_writes"] += 1
            self.emit_stats["pipe_events"] += events
            self.emit_stats["pipe_bytes"] += len(line) + 1
            if events > 0:
                self.emit_stats["pipe_event_writes"] += 1
            if events > 1:
                self.emit_stats["pipe_batched_frames"] += 1
            out = self._out or sys.stdout
            out.write(line + "\n")
            out.flush()
        self._m_pipe_writes.inc()
        self._m_pipe_bytes.inc(len(line) + 1)
        if events:
            self._m_pipe_events.inc(events)
            self.tracer.record("pipe_flush", t0, time.monotonic() - t0,
                               events=events, bytes=len(line) + 1)

    def _event_dict(self, req_id: str, ev: "TokenEvent") -> dict[str, Any]:
        """One event's wire fields (shared by legacy and batched frames),
        with the per-request delta bookkeeping: tokens_new rides
        tokens_emitted (tokens that streamed as text), `tokens` keeps the
        EOS-counting convention."""
        prev = self._reported.get(req_id, 0)
        new = max(ev.tokens_emitted - prev, 0)
        self._reported[req_id] = max(ev.tokens_emitted, prev)
        out: dict[str, Any] = {"id": req_id, "text": ev.text,
                               "tokens": ev.tokens_generated,
                               "tokens_new": new}
        if ev.ttft_s is not None:
            out["ttft_s"] = round(ev.ttft_s, 4)
        if ev.stages:
            # First event: the scheduler's stage stamps plus the pipe-write
            # moment (CLOCK_MONOTONIC, one clock across processes).
            out["t"] = {k: round(v, 4) for k, v in ev.stages.items()
                        if v is not None}
            out["t"]["out"] = round(time.monotonic(), 4)
        if ev.tokens_reused is not None:
            out["reused"] = ev.tokens_reused  # radix tokens reused
        if ev.resumed_from is not None:
            out["resume_from"] = ev.resumed_from
        if ev.done:
            out["done"] = True
            out["finish_reason"] = ev.finish_reason
            if ev.error:
                out["error"] = ev.error
            if ev.costs is not None:
                out["costs"] = ev.costs  # symledger terminal rider
            self._reported.pop(req_id, None)
            self._cancelled.discard(req_id)
        return out

    def _emit_batch(self, batch: list[tuple[GenRequest, "TokenEvent"]]
                    ) -> None:
        """Scheduler block-boundary sink: the whole block's events leave as
        ONE pipe write; a lone event keeps the legacy `event` frame."""
        events = [self._event_dict(req.id, ev) for req, ev in batch]
        if len(events) == 1:
            self._write({"op": HostOp.EVENT, **events[0]}, events=1)
        else:
            self._write({"op": HostOp.EVENTS, "events": events},
                        events=len(events))

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        tpu = self._config.tpu
        # Before the first kernel build (the engine's warmup).
        cache_dir = enable_compile_cache(tpu)
        t0 = time.perf_counter()
        spec = MeshSpec.from_dict(dict(tpu.mesh or {}))
        try:
            if spec.size > 1 and not tpu.multihost:
                addr = self._start_followers(spec.size)
                init_distributed(addr, spec.size, 0, device=self._device)
            engine = InferenceEngine.from_tpu_config(tpu,
                                                     device=self._device)
        except BaseException:
            for proc in self._followers:
                proc.kill()
                proc.wait()
            raise
        if engine.mesh is None:
            self._engine = GatedEngine(engine, self._device_gate)
        else:
            # Rank 0's scheduler leads every rank; the loop executes through
            # the gate, as GatedEngine does.
            self._command_loop = CommandLoop(engine, is_coordinator=True,
                                             gate=self._device_gate)
            self._engine = MultihostEngine(self._command_loop)
        t_build = time.perf_counter() - t0
        t1 = time.perf_counter()
        self._engine.warmup()  # the kernels build here, before `ready`
        t_warmup = time.perf_counter() - t1
        self._scheduler = Scheduler(
            self._engine, emit_batch=self._emit_batch,
            pipeline_depth=int(getattr(tpu, "pipeline_depth", 2)),
            handoff=(self._handoff_sink if self._role == "prefill"
                     else None),
            ledger_enabled=bool(getattr(tpu, "ledger", True)))
        tracing = bool(getattr(tpu, "tracing", True))
        self.tracer.enabled = tracing
        self._scheduler.tracer.enabled = tracing
        mcfg = self._config.get("metrics") or {}
        METRICS.enabled = bool(mcfg.get("enabled", True))
        set_component("host")
        self._scheduler.start()
        self._write({"op": HostOp.READY,
                     "model": self._config.model_name,
                     "role": self._role,
                     "slots": self._engine.max_slots,
                     "max_seq_len": self._engine.max_seq_len,
                     "build_s": round(t_build, 1),
                     "warmup_s": round(t_warmup, 1)})
        mem = ""
        if self._engine.device.type == "cuda":
            import torch

            mem = (f" max_memory_allocated="
                   f"{torch.cuda.max_memory_allocated() / 2**30:.3f}GiB")
        logger.info(f"engine host ready: model={self._config.model_name} "
                    f"role={self._role} device={self._engine.device} "
                    f"slots={self._engine.max_slots} build={t_build:.1f}s "
                    f"warmup={t_warmup:.1f}s compile_cache={cache_dir}{mem}")

    def serve_forever(self, stdin: TextIO | None = None) -> int:
        self.start()
        for line in (stdin or sys.stdin):
            line = line.strip()
            if not line:
                continue
            if FAULTS.enabled and FAULTS.point("host.pipe_read"):
                continue  # injected drop_frame: the command is lost
            try:
                msg = json.loads(line)
            except ValueError:
                logger.warning(f"host: bad command line {line[:80]!r}")
                continue
            op = msg.get("op")
            if op == HostOp.SUBMIT:
                self._submit(msg)
            elif op == HostOp.ADOPT:
                self._handle_adopt(msg)
            elif op == HostOp.CANCEL:
                req_id = str(msg.get("id", ""))
                if req_id in self._reported:  # only live requests
                    self._cancelled.add(req_id)
            elif op == HostOp.CLOCK:
                self._write({"op": HostOp.CLOCK, "t0": msg.get("t0"),
                             "t": time.monotonic()})
            elif op == HostOp.TRACE:
                self._handle_trace()
            elif op == HostOp.STATS:
                self._write(self._stats())
            elif op == HostOp.METRICS:
                self._write({"op": HostOp.METRICS, "role": self._role,
                             **METRICS.snapshot(compact=True)})
            elif op == HostOp.PROFILE:
                self._handle_profile(msg)
            elif op == HostOp.SHUTDOWN:
                break
        self._scheduler.stop()
        self._stop_ranks()
        if self._engine.device.type == "cuda":
            import torch

            logger.info(f"engine host stopped: max_memory_allocated="
                        f"{torch.cuda.max_memory_allocated() / 2**30:.3f}GiB")
        return 0

    def _start_followers(self, world: int) -> str:
        """Start ranks 1..world-1 of a one-host mesh as follower processes
        of this host; returns the coordinator address rank 0 serves."""
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            addr = f"127.0.0.1:{sock.getsockname()[1]}"
        fd, cfg_path = tempfile.mkstemp(prefix="symmetry_mesh_",
                                        suffix=".json")
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            json.dump(self._config.get_all(), fh)
        for rank in range(1, world):
            self._followers.append(subprocess.Popen(
                [sys.executable, "-m", "symmetry_tpu_torch.engine.host",
                 cfg_path, "--device", self._device, "--follow", str(rank),
                 "--coordinator", addr, "--parent", str(os.getpid())],
                stdin=subprocess.DEVNULL, stdout=sys.stderr.fileno()))
        logger.info(f"mesh of {world} ranks: started followers "
                    f"{[p.pid for p in self._followers]} (coordinator "
                    f"{addr})")
        return addr

    def _stop_ranks(self) -> None:
        """Release the other ranks (the loop's stop command) and reap the
        followers this host started."""
        if self._command_loop is not None:
            self._command_loop.stop()
        for proc in self._followers:
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()

    def _handle_trace(self) -> None:
        """Span-ring snapshot: the host and scheduler rings, plus the
        probes' `device` track (probed dispatch spans and dispatch gaps)
        while tpu.profile_sample is on."""
        comps = [self.tracer.component("host"),
                 self._scheduler.trace_export()]
        devprof = self._engine.devprof
        if devprof.enabled:
            comps.append(devprof.component("device"))
        self._write({"op": HostOp.TRACE, "clock": time.monotonic(),
                     "components": comps})

    def _handle_profile(self, msg: dict) -> None:
        """On-demand torch.profiler capture (utils/devprof.py): the capture
        sleeps for its whole window, so it runs on its OWN daemon thread —
        the serve loop keeps reading commands and the engine keeps
        dispatching. The reply is written when the capture finishes; a
        capture that cannot run (one already in progress, an unwritable
        directory) replies with its error."""
        # `is None`, not `or`: an explicit duration_s of 0 means the
        # minimal instant capture, not the 2 s default.
        raw = msg.get("duration_s")
        duration_s = 2.0 if raw is None else float(raw)
        out_dir = str(msg.get("dir") or "") or os.path.join(
            tempfile.gettempdir(), "symmetry_torch_profiles")
        if (self._engine is not None and self._engine.device.type == "cuda"
                and not self._capture_ready):
            # The first capture starts the profiler's CUDA tracing here,
            # on the main thread, with the engine held: a few seconds
            # (~9 on an H100 host) that every host start paid before.
            try:
                with self._device_gate:
                    init_capture()
            except Exception as exc:  # noqa: BLE001 — reply, never crash
                self._write({"op": HostOp.PROFILE,
                             "error": f"torch.profiler did not start: {exc}"})
                return
            self._capture_ready = True

        def run() -> None:
            try:
                path = capture_device_profile(out_dir, duration_s,
                                              self._device_gate)
            except Exception as exc:  # noqa: BLE001 — reply, never crash
                self._write({"op": HostOp.PROFILE, "error": str(exc)})
                return
            logger.info(f"device profile captured -> {path} "
                        f"({duration_s:.1f}s window)")
            self._write({"op": HostOp.PROFILE, "path": path,
                         "duration_s": duration_s})

        threading.Thread(target=run, name="torch-profile",
                         daemon=True).start()

    def _stats(self) -> dict[str, Any]:
        m = self._scheduler.stats()
        m["op"] = HostOp.STATS
        # liveness of the engine thread: the provider's wedge signal
        thread = self._scheduler._thread
        m["engine_alive"] = bool(thread is not None and thread.is_alive())
        m["emit"] = dict(self.emit_stats)
        m["role"] = self._role
        # tokens each live stream has had written to the pipe (keys listed
        # first: the engine thread mutates _reported concurrently)
        m["journal"] = {k: self._reported.get(k, 0)
                        for k in list(self._reported)}
        m["kernels"] = {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}
        # of the decode launches, those that also wrote the step's K/V row
        m["kernels"]["decode_attention_append"] = (
            decode_attention.launches_append)
        # of the W8A16 launches, each regime's (ops/qmm.py w8a16_regime)
        for regime in ("gemv", "gemv_f32", "tc"):
            m["kernels"][f"w8a16_matmul_{regime}"] = getattr(
                w8a16_matmul, f"launches_{regime}")
        summary = self._engine.prefix_cache_summary()
        if summary is not None:
            m["prefix_summary"] = summary  # pool-gossip rider
        if self._engine.mesh is not None:
            m["mesh"] = self._engine.mesh.describe()
        # Under _wlock: the engine thread's sink and adopt thunk and the
        # pipe reader's fast path write these.
        with self._wlock:
            if self._role == "prefill":
                m["handoff"] = {**self.handoff_stats, "serialize_s": round(
                    self.handoff_stats["serialize_s"], 4)}
            elif self._role == "decode":
                m["adopt"] = {**self.adopt_stats, "deserialize_s": round(
                    self.adopt_stats["deserialize_s"], 4)}
        if FAULTS.enabled:
            m["faults"] = FAULTS.counters()
        return m

    # --------------------------------------------------------------- submit

    def _submit(self, msg: dict) -> None:
        t_recv = time.monotonic()
        req_id = str(msg.get("id", ""))
        trace_id = str(msg.get("trace") or "")
        s = msg.get("sampling") or {}
        resume = msg.get("resume") if isinstance(msg.get("resume"), dict) \
            else None
        max_new = int(msg.get("max_new", 512))
        try:
            prompt_ids = self._engine.tokenizer.apply_chat_template(
                msg.get("messages") or [])
            # Stream resumption: condition on prompt + the text the client
            # already holds and generate only the continuation.
            prompt_ids, max_new, resume_offset = resolve_resume(
                self._engine.tokenizer, resume, prompt_ids, max_new)
        except Exception as exc:  # noqa: BLE001 — tokenizer failure → event
            self._write({"op": HostOp.EVENT, "id": req_id, "text": "",
                         "done": True, "finish_reason": "error",
                         "error": f"tokenization failed: {exc}"}, events=1)
            return
        if resume is not None and max_new == 0:
            # The interrupted stream had spent the whole budget; only its
            # finish frame was lost.
            self._write({"op": HostOp.EVENT, "id": req_id, "text": "",
                         "done": True, "finish_reason": "length",
                         "tokens": resume_offset, "tokens_new": 0,
                         "resume_from": resume_offset}, events=1)
            return
        sampling = SamplingParams(
            temperature=float(s.get("temperature", 0.0)),
            top_p=float(s.get("top_p", 1.0)),
            top_k=int(s.get("top_k", 0)),
            seed=s.get("seed"),
            rng_skip=resume_offset,
        )
        led = msg.get("ledger")
        if self._role == "prefill" and isinstance(led, dict):
            # Pool routing names the decode member this request's handoff
            # is planned for and that member's ledger epoch. An advanced
            # epoch means the member respawned since we last shipped to it:
            # drop its ledger before this handoff skips blocks an empty
            # cache cannot adopt by reference.
            member = str(led.get("member") or "decode")
            epoch = int(led.get("epoch") or 0)
            with self._wlock:
                if epoch > self._ledger_epochs.get(member, 0):
                    self._ledger_epochs[member] = epoch
                    self._shipped.pop(member, None)
                self._ledger_dest[req_id] = member
                while len(self._ledger_dest) > self._shipped_cap:
                    # Requests that end without a handoff (cancel, deadline
                    # shed) leave their entry behind; bound it.
                    self._ledger_dest.pop(next(iter(self._ledger_dest)))
        if self._role == "prefill":
            pb = self._engine.prefix_block or 0
            if pb and (len(prompt_ids) - 1) // pb == 0:
                # Short-prompt fast path: no whole-block prefix can be
                # handed off, so a prefill HERE would only duplicate the
                # decode tier's. Route the tokens through as a
                # routing-only frame; the decode host prefills the prompt.
                self._emit_handoff(req_id, prompt_ids, 0, None)
                return
        self._reported[req_id] = 0

        def emit(ev, req_id=req_id) -> None:
            # Only if batching is ever off: the scheduler delivers through
            # the emit_batch sink.
            self._write({"op": HostOp.EVENT, **self._event_dict(req_id, ev)},
                        events=1)

        spec = msg.get("speculative")
        deadline = msg.get("deadline_s")
        self._scheduler.submit(GenRequest(
            prompt_ids=prompt_ids, sampling=sampling,
            max_new_tokens=max_new, emit=emit,
            cancelled=lambda: req_id in self._cancelled,
            id=req_id,
            speculative=spec if isinstance(spec, bool) else None,
            trace_id=trace_id,
            resume_offset=resume_offset,
            # deadline_s is relative; anchor it to this process's clock
            deadline_at=(t_recv + float(deadline)
                         if deadline is not None else None)))
        self.tracer.record("host_submit", t_recv,
                           time.monotonic() - t_recv,
                           request_id=req_id, trace_id=trace_id,
                           prompt_len=len(prompt_ids))

    # -------------------------------------------------------------- disagg

    def _handoff_sink(self, slot: int, req: Any, first: int) -> None:
        """Prefill-role scheduler terminal (runs on the engine thread):
        snapshot the slot lane's KV through the whole-block prefix length,
        copy it to the host, serialize it blockwise and emit the handoff
        frame. The host copy waits for the lane's KV, so by return the
        lane is free for the scheduler to reuse."""
        t0 = time.monotonic()
        n = len(req.prompt_ids)
        pb = self._engine.prefix_block or 0
        p = pb * ((n - 1) // pb) if pb else 0
        if p > 0:
            # Pipe-transport bound (HANDOFF_MAX_KV_BYTES): the largest
            # whole-block prefix whose frame fits the broker's line limit.
            max_p = pb * (HANDOFF_MAX_KV_BYTES
                          // self._engine.kv_bytes_per_token() // pb)
            p = min(p, max_p)
        arrays = None
        if p > 0:
            # The host copies are device work: under the gate, as engine
            # calls are.
            with self._device_gate:
                cache = self._engine.extract_slot_kv(slot, p)
                # Only the p positions the decode tier adopts cross to the
                # host and the wire, not the lane's bucket.
                arrays = {"k": to_numpy_plane(cache.k[:, :, :p]),
                          "v": to_numpy_plane(cache.v[:, :, :p])}
                if self._engine.kv_quant:
                    arrays["k_scale"] = to_numpy_plane(
                        cache.k_scale[..., :p])
                    arrays["v_scale"] = to_numpy_plane(
                        cache.v_scale[..., :p])
        self._emit_handoff(req.id, req.prompt_ids, p, arrays, t0=t0)

    def _emit_handoff(self, req_id: str, prompt_ids: list[int], p: int,
                      arrays: Any, t0: float | None = None) -> None:
        if t0 is None:
            t0 = time.monotonic()
        # disagg.handoff seam: crash = the prefill host dies with the
        # request's KV built but unshipped; drop_frame = the frame is lost.
        if FAULTS.enabled and FAULTS.point("disagg.handoff"):
            return
        pb = self._engine.prefix_block or 0
        skip: list[int] = []
        digests: list[str] = []
        with self._wlock:
            # _submit's pipe-reader thread writes this map; this method
            # runs on the engine thread too.
            member = self._ledger_dest.pop(req_id, "decode")
        if p > 0 and pb and self._ledger_on:
            # Incremental handoff: blocks whose digest this host already
            # shipped TO THIS DESTINATION are omitted from the payload
            # (manifest only).
            digests = block_digests(prompt_ids, p, pb)
            with self._wlock:
                ledger = self._shipped.get(member)
                if ledger is not None:
                    skip = [j for j, d in enumerate(digests) if d in ledger]
        frame = encode_kv_handoff(req_id, prompt_ids, p, arrays,
                                  kv_quant=self._engine.kv_quant,
                                  block_size=pb, skip=skip,
                                  digests=digests if digests else None)
        b64 = base64.b64encode(frame).decode("ascii")
        dt = time.monotonic() - t0
        n_blocks = p // pb if (p and pb) else 0
        # Under _wlock: this method runs on the engine thread (the sink)
        # AND on the pipe-reader thread (the short-prompt fast path).
        with self._wlock:
            self.handoff_stats["frames"] += 1
            self.handoff_stats["bytes"] += len(frame)
            self.handoff_stats["prefix_tokens"] += p
            self.handoff_stats["blocks"] += n_blocks
            self.handoff_stats["blocks_shipped"] += n_blocks - len(skip)
            if p == 0:
                self.handoff_stats["routing_only"] += 1
            self.handoff_stats["serialize_s"] += dt
            if digests:
                ledger = self._shipped.setdefault(member, OrderedDict())
                for d in digests:
                    ledger.pop(d, None)
                    ledger[d] = None  # most-recently-shipped last
                while len(ledger) > self._shipped_cap:
                    ledger.popitem(last=False)
        self._m_handoff_frames.inc()
        self._m_handoff_bytes.inc(len(frame))
        self._m_handoff_serialize.observe(dt)
        # This host's bookkeeping for the request ends here: token events
        # (and any cancel) now belong to the decode tier.
        self._reported.pop(req_id, None)
        self._cancelled.discard(req_id)
        self.tracer.record("handoff_emit", t0, dt, request_id=req_id,
                           p=p, bytes=len(frame))
        # "t": emit stamp on this clock; the broker subtracts it from its
        # receipt time (through the measured clock offset).
        self._write({"op": HostOp.HANDOFF, "id": req_id, "p": p,
                     "prompt_len": len(prompt_ids),
                     "nbytes": len(frame), "frame": b64,
                     "blocks": n_blocks, "shipped": n_blocks - len(skip),
                     "t": round(time.monotonic(), 4)})

    def _handle_adopt(self, msg: dict) -> None:
        """Decode-role command: submit the migrated request with an
        adoption thunk the SCHEDULER runs at admission pick. Everything
        frame-heavy — base64 decode, crc, structural checks, the
        host-to-device copy, the pool insert — runs in the thunk, on the
        engine thread: the prefix store is engine-thread-only, and large
        frames parsed on this serial command loop would delay stats
        replies and every queued cancel or submit. The request is
        submitted with an EMPTY prompt; the thunk fills prompt_ids from
        the frame's tokens. A frame that fails ANY check (truncated,
        corrupt, wrong version, wrong geometry) fails this one request with
        an error event through the scheduler's admission error path."""
        t_recv = time.monotonic()
        req_id = str(msg.get("id", ""))
        frame_b64 = msg.get("frame")
        if not isinstance(frame_b64, str) or not frame_b64:
            with self._wlock:
                self.adopt_stats["errors"] += 1
            self._m_adopt_frames.inc(outcome="error")
            self._write({"op": HostOp.EVENT, "id": req_id, "text": "",
                         "done": True, "finish_reason": "error",
                         "error": "handoff adoption failed: adopt op "
                                  "carries no frame"}, events=1)
            return

        def adopt(req, frame_b64=frame_b64, req_id=req_id) -> None:
            t0 = time.monotonic()
            try:
                raw = base64.b64decode(frame_b64, validate=True)
                handoff = decode_kv_handoff(raw)
                if handoff.request_id != req_id:
                    raise ValueError(
                        f"frame carries id {handoff.request_id!r}, "
                        f"command says {req_id!r}")
                req.prompt_ids = list(handoff.tokens)
                ok = (self._engine.adopt_prefix(handoff)
                      if handoff.p else False)
            except Exception as exc:  # noqa: BLE001 — fail one request
                with self._wlock:
                    self.adopt_stats["errors"] += 1
                self._m_adopt_frames.inc(outcome="error")
                raise RuntimeError(
                    f"handoff adoption failed: {exc}") from exc
            dt = time.monotonic() - t0
            with self._wlock:
                self.adopt_stats["frames"] += 1
                self.adopt_stats["bytes"] += len(raw)
                self.adopt_stats["deserialize_s"] += dt
                if handoff.p:
                    # rejected: the pool had no room; the request prefills
                    # in full (slower, still token-identical for greedy)
                    self.adopt_stats["adopted" if ok else "rejected"] += 1
            self._m_adopt_deserialize.observe(dt)
            self._m_adopt_frames.inc(
                outcome=("routing_only" if not handoff.p
                         else "adopted" if ok else "rejected"))

        s = msg.get("sampling") or {}
        resume = msg.get("resume") if isinstance(msg.get("resume"), dict) \
            else None
        max_new = int(msg.get("max_new", 512))
        resume_offset = 0
        if resume is not None:
            try:
                # A resumed migration: the emitted tokens already ride the
                # frame (the prefill tier appended them to the prompt), so
                # only the RNG lane position and the remaining budget are
                # restored here.
                _, max_new, resume_offset = resolve_resume(
                    self._engine.tokenizer, resume, [], max_new)
            except Exception as exc:  # noqa: BLE001 — bad resume → event
                with self._wlock:
                    self.adopt_stats["errors"] += 1
                self._m_adopt_frames.inc(outcome="error")
                self._write({"op": HostOp.EVENT, "id": req_id,
                             "text": "", "done": True,
                             "finish_reason": "error",
                             "error": f"handoff adoption failed: {exc}"},
                            events=1)
                return
            if max_new == 0:
                # The interrupted stream had spent the whole budget; only
                # its finish frame was lost.
                self._write({"op": HostOp.EVENT, "id": req_id,
                             "text": "", "done": True,
                             "finish_reason": "length",
                             "tokens": resume_offset, "tokens_new": 0,
                             "resume_from": resume_offset}, events=1)
                return
        sampling = SamplingParams(
            temperature=float(s.get("temperature", 0.0)),
            top_p=float(s.get("top_p", 1.0)),
            top_k=int(s.get("top_k", 0)),
            seed=s.get("seed"),
            rng_skip=resume_offset,
        )
        self._reported[req_id] = 0

        def emit(ev, req_id=req_id) -> None:
            self._write({"op": HostOp.EVENT, **self._event_dict(req_id, ev)},
                        events=1)

        spec = msg.get("speculative")
        deadline = msg.get("deadline_s")
        trace_id = str(msg.get("trace") or "")
        self._scheduler.submit(GenRequest(
            # Filled by the adopt thunk from the frame's tokens at
            # admission pick.
            prompt_ids=[], sampling=sampling,
            max_new_tokens=max_new, emit=emit,
            cancelled=lambda: req_id in self._cancelled,
            id=req_id,
            speculative=spec if isinstance(spec, bool) else None,
            trace_id=trace_id,
            resume_offset=resume_offset,
            adopt=adopt,
            # Rebased by the broker for prefill-tier time already spent;
            # may arrive negative — the scheduler then sheds "expired".
            deadline_at=(t_recv + float(deadline)
                         if deadline is not None else None)))
        self.tracer.record("host_adopt", t_recv,
                           time.monotonic() - t_recv, request_id=req_id,
                           trace_id=trace_id, frame_b64_len=len(frame_b64))


def _die_with_parent(parent: int) -> None:
    """Have the kernel kill this process when its parent exits (Linux
    PR_SET_PDEATHSIG), and exit now if the parent is already gone."""
    pr_set_pdeathsig = 1
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(pr_set_pdeathsig, signal.SIGKILL, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG)")
    if os.getppid() != parent:
        sys.exit("follower: the host that started it has exited")


def follow(config_path: str, device: str, rank: int, coordinator: str,
           parent: int) -> int:
    """Rank `rank` of a one-host mesh, started by its host: the same engine
    on this rank's blocks, mirroring the host's engine calls until it
    stops them or exits."""
    _die_with_parent(parent)
    config = ConfigManager(config_path=config_path)
    tpu = config.tpu
    set_component(f"rank{rank}")
    enable_compile_cache(tpu)
    init_distributed(coordinator, MeshSpec.from_dict(dict(tpu.mesh)).size,
                     rank, device=device)
    engine = InferenceEngine.from_tpu_config(tpu, device=device)
    logger.info(f"rank {rank} following the host ({engine.mesh.describe()})")
    CommandLoop(engine, is_coordinator=False).follow_forever()
    logger.info(f"rank {rank} stopped")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m symmetry_tpu_torch.engine.host",
        description="Serve the PyTorch engine over the JSON-lines host pipe.")
    parser.add_argument("config", help="provider config file (YAML)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the engine (default: cuda; "
                             "cpu runs the kernels' plain versions)")
    parser.add_argument("--follow", type=int, metavar="RANK",
                        help="run as follower rank RANK of the host that "
                             "started this process (a one-host mesh)")
    parser.add_argument("--coordinator", help="with --follow: rank 0's "
                        "host:port")
    parser.add_argument("--parent", type=int, help="with --follow: the "
                        "host's pid")
    args = parser.parse_args(argv)
    if args.follow is not None:
        return follow(args.config, args.device, args.follow,
                      args.coordinator, args.parent)
    # Frames get a private copy of fd 1; fd 1 itself (and sys.stdout) go to
    # stderr, so nothing else can write into the pipe.
    sys.stdout.flush()
    out = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    host = EngineHost(ConfigManager(config_path=args.config),
                      device=args.device, out=out)
    return host.serve_forever()


if __name__ == "__main__":
    sys.exit(main())
