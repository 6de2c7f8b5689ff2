"""The system under test, driven in-process: the port's InferenceEngine under
its Scheduler, fed by closed-loop clients, as the engine host drives them.

This is the one module of the benchmark that imports the program. It builds
the engine from a configuration file's `deployment` (the provider's `tpu:`
keys), hands it the seeded weights, and submits token-id prompts through
`Scheduler.submit` with greedy sampling. Every streamed event is stamped on
the host clock in the scheduler's emit sink (the host installs the same
kind of sink), and carries exact token ids: the tokenizer here renders one
character per id.

Spans of the benchmark's own wrap the engine calls that the scheduler
makes: the decode block, the coalesced prefill, the cached-prefix
admission, the chunked prefill's start and each chunk. The profiler of a
traced run is started and stopped inside these wrappers, on the engine's
thread, since torch.profiler records the host operators of the thread that
starts it; while it runs, each call is also a `record_function` range named
`portbench.<kind>#<n>`, so device work can be attributed to it.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field, replace

import torch

from portbench.lib import weights as W
from symmetry_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from symmetry_tpu_torch.engine.scheduler import GenRequest, Scheduler
from symmetry_tpu_torch.engine.tokenizer import Tokenizer
from symmetry_tpu_torch.models.llama import config_from_hf
from symmetry_tpu_torch.ops.quant import QuantizedTensor
from symmetry_tpu_torch.provider.config import TpuConfig

ID_BASE = 0x4E00
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


class IdTokenizer(Tokenizer):
    """One character per token id, and no end-of-sequence id: every request
    runs to its token budget, and the stream gives back its ids exactly."""

    def __init__(self, vocab_size: int) -> None:
        if ID_BASE + vocab_size > 0xD800:
            raise ValueError(f"vocab {vocab_size} does not fit below the "
                             f"surrogate range from {ID_BASE:#x}")
        self.vocab_size = vocab_size
        self.bos_id = 0
        self.eos_ids = frozenset()

    def encode(self, text: str, *, bos: bool = True) -> list[int]:
        return [ord(c) - ID_BASE for c in text]

    def decode(self, ids: list[int]) -> str:
        return "".join(chr(ID_BASE + i) for i in ids)

    def apply_chat_template(self, messages: list[dict[str, str]]
                            ) -> list[int]:
        return self.encode("".join(m["content"] for m in messages))


@dataclass
class Record:
    """One request as the client saw it."""

    client: int
    index: int
    prompt: list[int]
    max_new: int
    sent: float = 0.0
    first: float | None = None
    events: list[tuple[float, int]] = field(default_factory=list)
    tokens: list[int] = field(default_factory=list)
    done_at: float | None = None
    reason: str | None = None
    error: str | None = None
    cancel: bool = False


@dataclass
class Call:
    """One engine call the scheduler made, on the host clock."""

    kind: str
    index: int
    start: float
    end: float
    meta: dict


# Deployment keys that set the model's config, not the provider's `tpu:`.
MODEL_SETTINGS = ("moe_capacity_factor",)


def _tpu_config(deployment: dict) -> TpuConfig:
    """The provider's `tpu:` settings of a deployment (its model settings
    aside: see build_engine)."""
    return TpuConfig.from_dict({k: v for k, v in deployment.items()
                                if k not in MODEL_SETTINGS})


def build_engine(cfg_file: dict, seed: int, device: str) -> InferenceEngine:
    """The port's engine for a configuration file, with the seed's weights."""
    dev = torch.device(device)
    dep = cfg_file["deployment"]
    tpu = _tpu_config(dep)
    hf = cfg_file["model"]
    config = replace(config_from_hf(hf), **{
        k: dep[k] for k in MODEL_SETTINGS if k in dep})
    quant = tpu.quantization == "int8"
    dtype = DTYPES[tpu.dtype]
    params = W.program_params(W.Dims.from_hf(hf), seed, quant=quant,
                              dtype=dtype, device=dev,
                              quantized_type=QuantizedTensor)
    engine = InferenceEngine(
        config, params, IdTokenizer(config.vocab_size),
        max_slots=tpu.max_batch_size, max_seq_len=tpu.max_seq_len,
        prefill_buckets=tuple(tpu.prefill_buckets), cache_dtype=dtype,
        decode_block=tpu.decode_block,
        kv_quant=tpu.kv_quantization == "int8",
        prefill_chunk=tpu.prefill_chunk,
        prefill_token_budget=tpu.prefill_token_budget,
        prefix_cache_bytes=int((tpu.prefix_cache_mb or 0) * 2**20),
        prefix_block_tokens=tpu.prefix_block_tokens,
        fused_dequant=tpu.fused_dequant, device=dev)
    return engine


def build_scheduler(engine: InferenceEngine, cfg_file: dict, sink
                    ) -> Scheduler:
    tpu = _tpu_config(cfg_file["deployment"])
    sched = Scheduler(engine, emit_batch=sink,
                      pipeline_depth=tpu.pipeline_depth,
                      ledger_enabled=tpu.ledger)
    sched.tracer.enabled = tpu.tracing
    return sched


class CallLog:
    """Wraps the engine calls the scheduler makes (instance attributes, so
    the engine's class is untouched) and logs each one on the host clock.

    With `trace_span` = (from, until) set, the first call at or after
    `from` starts torch.profiler (host operators and device) and opens the
    `portbench.window` range, and the first call at or after `until` closes
    both; calls in between are profiler ranges."""

    WRAPPED = {"decode_steps_dispatch": "decode",
               "prefill_and_insert_many": "prefill",
               "prefill_and_insert_cached": "cached",
               "start_chunked_prefill": "chunk_start",
               "advance_chunked_prefill": "chunk"}

    def __init__(self, engine: InferenceEngine) -> None:
        self.engine = engine
        self.calls: list[Call] = []
        self.ranges = False
        self.lengths: dict[int, torch.Tensor] = {}
        self.trace_span: tuple[float, float] | None = None
        self.prof = None
        self.traced: tuple[float, float] | None = None
        self._window = None
        self._t_trace = 0.0
        self._depth = 0
        for name, kind in self.WRAPPED.items():
            setattr(engine, name, self._wrap(getattr(engine, name), kind))

    def _meta(self, kind: str, args: tuple) -> dict:
        eng = self.engine
        if kind in ("prefill", "cached"):
            meta = {"lens": [len(ids) for _, ids, _ in args[0]]}
            if kind == "cached":
                meta["prefix"] = args[1].length
            return meta
        if kind == "chunk":
            job = args[0]
            c0 = job.done_chunks * eng.prefill_chunk
            return {"start": job.start_pos + c0,
                    "tokens": min(eng.prefill_chunk, job.suffix_len - c0),
                    "last": job.done_chunks == job.n_chunks - 1}
        if kind == "chunk_start":
            hit = args[3] if len(args) > 3 else None
            return {"len": len(args[1]),
                    "prefix": hit.length if hit is not None else 0}
        return {"steps": eng.decode_block, "slots": eng.max_slots}

    def _trace_step(self, now: float) -> None:
        if self.trace_span is None or self.traced is not None:
            return
        if self.prof is None and now >= self.trace_span[0]:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self._window = torch.profiler.record_function("portbench.window")
            self._window.__enter__()
            self._t_trace = time.perf_counter()
            self.ranges = True
        elif self.prof is not None and now >= self.trace_span[1]:
            self.stop_trace()

    def stop_trace(self) -> None:
        """Close the window range and stop the profiler (the engine thread
        does this; the harness only where no call came after `until`)."""
        if self.prof is None or self.traced is not None:
            return
        self.ranges = False
        self._window.__exit__(None, None, None)
        self.traced = (self._t_trace, time.perf_counter())
        self.prof.stop()

    def _wrap(self, fn, kind: str):
        def call(*args, **kwargs):
            if self._depth:
                # A call the engine makes of itself (a group split into
                # several prefills): the outer call logs the whole.
                return fn(*args, **kwargs)
            self._trace_step(time.perf_counter())
            index = len(self.calls)
            meta = self._meta(kind, args + tuple(kwargs.values()))
            if kind == "decode" and self.ranges:
                # The lanes' lengths before the block, for the decode
                # attention's work: a device copy, read after the trace.
                self.lengths[index] = self.engine.state.cache.lengths.clone()
            self._depth += 1
            t0 = time.perf_counter()
            try:
                if self.ranges:
                    with torch.profiler.record_function(
                            f"portbench.{kind}#{index}"):
                        out = fn(*args, **kwargs)
                else:
                    out = fn(*args, **kwargs)
            finally:
                self._depth -= 1
            self.calls.append(Call(kind, index, t0, time.perf_counter(),
                                   meta))
            return out
        return call


class ClosedLoop:
    """N clients, each sending its next request when its last one ends.

    `plan[c]` is client c's list of (prompt, max_new) makers, in order. The
    sink runs on the scheduler's emit thread: it stamps events, and on a
    finish submits that client's next request unless the load is closed."""

    def __init__(self, sched: Scheduler, plan: list, clock=time.perf_counter
                 ) -> None:
        self.sched = sched
        self.plan = plan
        self.clock = clock
        self.records: list[Record] = []
        self.by_id: dict[str, Record] = {}
        self.closed = False
        self.next_index = [0] * len(plan)
        self.cond = threading.Condition()

    def start(self) -> None:
        for c in range(len(self.plan)):
            self._send(c)

    def _send(self, client: int) -> None:
        i = self.next_index[client]
        if i >= len(self.plan[client]):
            raise RuntimeError(f"client {client} ran out of requests at "
                               f"{i}: the traffic plan is too short")
        self.next_index[client] = i + 1
        prompt, max_new = self.plan[client][i]()
        rec = Record(client=client, index=i, prompt=prompt, max_new=max_new)
        rid = f"{client}.{i}"
        with self.cond:
            self.records.append(rec)
            self.by_id[rid] = rec
        rec.sent = self.clock()
        self.sched.submit(GenRequest(
            prompt_ids=prompt, sampling=SamplingParams(),
            max_new_tokens=max_new, emit=lambda ev: None,
            cancelled=lambda: rec.cancel, id=rid))

    def sink(self, batch) -> None:
        t = self.clock()
        follow = []
        with self.cond:
            for req, ev in batch:
                rec = self.by_id.get(req.id)
                if rec is None:
                    continue
                if ev.text:
                    ids = [ord(ch) - ID_BASE for ch in ev.text]
                    rec.tokens.extend(ids)
                    rec.events.append((t, len(ids)))
                    if rec.first is None:
                        rec.first = t
                if ev.done:
                    rec.done_at = t
                    rec.reason = ev.finish_reason
                    rec.error = ev.error
                    if not self.closed and not rec.cancel:
                        follow.append(rec.client)
            self.cond.notify_all()
        for client in follow:
            self._send(client)

    def wait(self, predicate, timeout: float) -> bool:
        with self.cond:
            return self.cond.wait_for(predicate, timeout)

    def close(self) -> None:
        with self.cond:
            self.closed = True

    def cancel_all(self) -> None:
        with self.cond:
            for rec in self.records:
                if rec.done_at is None:
                    rec.cancel = True
