"""Engine host process: the PyTorch engine behind a pipe.

Port of symmetry_tpu/engine/host.py, unified role. The provider runs its
engine in a host process (tpu.engine_isolation: process, the default) and
talks to it in JSON lines; this host speaks the same protocol, so a
provider can drive the port by running this module in place of the JAX
package's host. It builds its engine with InferenceEngine.from_tpu_config
from the same provider config file.

Protocol: JSON lines, as in the JAX package's host.
  stdin  ← {"op": "submit", "id", "messages", "max_new", "sampling": {…},
            "trace"?, "deadline_s"?, "resume"?, "speculative"?}
           {"op": "cancel", "id"}
           {"op": "clock", "t0"}  {"op": "trace"}  {"op": "metrics"}
           {"op": "stats"}  {"op": "shutdown"}
  stdout → {"op": "ready", "model", "role", "slots", "max_seq_len",
            "build_s", "warmup_s"}              (after warmup)
           {"op": "event", "id", "text", "done"?, "finish_reason"?,
            "error"?, "ttft_s"?, "tokens", "tokens_new", "t"?, "reused"?,
            "resume_from"?, "costs"?}           (a lone event)
           {"op": "events", "events": [{…event fields…}, …]}  (one frame
            per decode block: the scheduler's batched emit sink)
           {"op": "clock", "t0", "t"}  {"op": "trace", "clock",
            "components"}  {"op": "metrics", "role", "families"}
           {"op": "stats", …}  (scheduler counters with the `emit`,
            `journal`, `engine_alive` and `prefix_summary` riders, and a
            `kernels` rider: each kernel wrapper's launch count in this
            process, and `decode_attention_append`, the decode launches
            that wrote the step's K/V row, so a caller can show the path
            ran on the kernels)

Refused, in the JAX package's own reply shapes: `profile` answers
{"op": "profile", "error"} (device profiling, ROADMAP Queue 1 item 12);
`adopt` answers a terminal error event for its request (disaggregated
handoff, item 11). A config with a tier role or `multihost` fails at
start (from_tpu_config names items 11 and 14). There is no compile cache:
the kernels build once into build/torch_kernels/ and PyTorch runs eagerly.

Logs go to stderr; frames go to stdout, one line each. `main` moves the
process's file descriptor 1 onto stderr and keeps a private copy for the
frames, so a stray print (from any library or child process) cannot
corrupt the pipe. The kernels build in warmup, before `ready`.

Run: python -m symmetry_tpu_torch.engine.host <config.yaml> [--device cpu]
(the default device is the CUDA card).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
from typing import TYPE_CHECKING, Any, TextIO

from symmetry_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from symmetry_tpu_torch.engine.scheduler import GenRequest, Scheduler
from symmetry_tpu_torch.engine.tokenizer import resolve_resume
from symmetry_tpu_torch.ops.decode_attention import decode_attention
from symmetry_tpu_torch.ops.flash import flash_prefill
from symmetry_tpu_torch.ops.kv_append import kv_append
from symmetry_tpu_torch.ops.qmm import w8a8_matmul, w8a16_matmul
from symmetry_tpu_torch.protocol.keys import HostOp
from symmetry_tpu_torch.provider.config import ConfigManager
from symmetry_tpu_torch.utils.faults import FAULTS
from symmetry_tpu_torch.utils.logging import logger, set_component
from symmetry_tpu_torch.utils.metrics import METRICS, MetricName
from symmetry_tpu_torch.utils.trace import Tracer

if TYPE_CHECKING:
    from symmetry_tpu_torch.engine.scheduler import TokenEvent

KERNEL_WRAPPERS = (flash_prefill, decode_attention, kv_append, w8a16_matmul,
                   w8a8_matmul)
PROFILE_REFUSED = ("device profiling is not ported to the PyTorch engine "
                   "host yet (ROADMAP Queue 1 item 12)")
ADOPT_REFUSED = ("handoff adoption failed: disaggregated prefill/decode "
                 "is not ported to the PyTorch engine host yet (ROADMAP "
                 "Queue 1 item 11)")


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
        self._engine: InferenceEngine | None = None
        self._scheduler: Scheduler | None = None
        self._wlock = threading.Lock()
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
        self._role = "unified"
        self._m_pipe_writes = METRICS.counter(
            MetricName.HOST_PIPE_WRITES, "host stdout frames written")
        self._m_pipe_bytes = METRICS.counter(
            MetricName.HOST_PIPE_BYTES, "host stdout bytes written")
        self._m_pipe_events = METRICS.counter(
            MetricName.HOST_PIPE_EVENTS, "token events carried on the pipe")

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
        t0 = time.perf_counter()
        self._engine = InferenceEngine.from_tpu_config(tpu,
                                                       device=self._device)
        t_build = time.perf_counter() - t0
        t1 = time.perf_counter()
        self._engine.warmup()  # the kernels build here, before `ready`
        t_warmup = time.perf_counter() - t1
        self._scheduler = Scheduler(
            self._engine, emit_batch=self._emit_batch,
            pipeline_depth=int(getattr(tpu, "pipeline_depth", 2)),
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
                    f"device={self._engine.device} "
                    f"slots={self._engine.max_slots} build={t_build:.1f}s "
                    f"warmup={t_warmup:.1f}s{mem}")

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
                self._write({"op": HostOp.EVENT, "id": str(msg.get("id", "")),
                             "text": "", "done": True,
                             "finish_reason": "error",
                             "error": ADOPT_REFUSED}, events=1)
            elif op == HostOp.CANCEL:
                req_id = str(msg.get("id", ""))
                if req_id in self._reported:  # only live requests
                    self._cancelled.add(req_id)
            elif op == HostOp.CLOCK:
                self._write({"op": HostOp.CLOCK, "t0": msg.get("t0"),
                             "t": time.monotonic()})
            elif op == HostOp.TRACE:
                self._write({"op": HostOp.TRACE, "clock": time.monotonic(),
                             "components": [
                                 self.tracer.component("host"),
                                 self._scheduler.trace_export()]})
            elif op == HostOp.STATS:
                self._write(self._stats())
            elif op == HostOp.METRICS:
                self._write({"op": HostOp.METRICS, "role": self._role,
                             **METRICS.snapshot(compact=True)})
            elif op == HostOp.PROFILE:
                self._write({"op": HostOp.PROFILE, "error": PROFILE_REFUSED})
            elif op == HostOp.SHUTDOWN:
                break
        self._scheduler.stop()
        if self._engine.device.type == "cuda":
            import torch

            logger.info(f"engine host stopped: max_memory_allocated="
                        f"{torch.cuda.max_memory_allocated() / 2**30:.3f}GiB")
        return 0

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
        summary = self._engine.prefix_cache_summary()
        if summary is not None:
            m["prefix_summary"] = summary  # pool-gossip rider
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


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m symmetry_tpu_torch.engine.host",
        description="Serve the PyTorch engine over the JSON-lines host pipe.")
    parser.add_argument("config", help="provider config file (YAML)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the engine (default: cuda; "
                             "cpu runs the kernels' plain versions)")
    args = parser.parse_args(argv)
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
