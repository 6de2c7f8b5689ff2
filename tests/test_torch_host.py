"""The PyTorch port's engine host (symmetry_tpu_torch/engine/host.py) on the
CPU.

(a) The JAX package's EngineHost and the port's, both in-process, read the
    same command lines over the same weights (each package's
    from_tpu_config replaced by an engine over tiny's JAX weights, the
    port's converted with params_from_numpy), with chunked prefill and the
    prefix cache on: identical streamed text, `tokens`, `finish_reason` and
    `reused`, request by request. Requests go one at a time, so admission
    grouping (and with it every prefix hit) is the same in both.
(b) The emit-batch contract (tests/test_host_protocol.py): one pipe write
    per scheduler block, a lone event as the legacy `event` frame.
(c) client -> server -> the JAX package's provider, whose tpu_native backend
    runs `python -m symmetry_tpu_torch.engine.host <cfg> --device cpu` as
    its engine host (the `_host_argv` seam, tests/test_supervisor.py): the
    streamed text equals the port's in-process run of the same config.
"""

import asyncio
import json
import os
import queue
import sys
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_tpu.engine.engine import InferenceEngine as JaxEngine
from symmetry_tpu.engine.host import EngineHost as JaxHost
from symmetry_tpu.engine.tokenizer import get_tokenizer as jax_get_tokenizer
from symmetry_tpu.models import init_params as jax_init_params
from symmetry_tpu.models import preset as jax_preset
from symmetry_tpu.provider.backends.tpu_native import TpuNativeBackend
from symmetry_tpu.provider.config import ConfigManager as JaxConfigManager
from symmetry_tpu_torch.convert import params_from_numpy
from symmetry_tpu_torch.engine.engine import InferenceEngine, SamplingParams
from symmetry_tpu_torch.engine.host import EngineHost
from symmetry_tpu_torch.engine.scheduler import GenRequest, Scheduler
from symmetry_tpu_torch.engine.scheduler import TokenEvent
from symmetry_tpu_torch.engine.tokenizer import get_tokenizer
from symmetry_tpu_torch.models.llama import preset
from symmetry_tpu_torch.provider.config import ConfigManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TPU = {"model_preset": "tiny", "dtype": "float32", "max_batch_size": 2,
       "max_seq_len": 256, "prefill_buckets": [32, 64, 128, 256],
       "prefill_chunk": 32, "prefix_cache_mb": 1, "decode_block": 4,
       "compile_cache": False}


def provider_config(tpu=None, cls=ConfigManager):
    return cls(config={
        "name": "port-host", "public": False, "serverKey": "00" * 32,
        "modelName": "tiny:test", "apiProvider": "tpu_native",
        "dataCollectionEnabled": False, "tpu": {**TPU, **(tpu or {})}})


class Stdin:
    """A command pipe the test feeds line by line."""

    def __init__(self):
        self._q = queue.Queue()

    def send(self, obj):
        self._q.put(json.dumps(obj) + "\n")

    def close(self):
        self._q.put(None)

    def __iter__(self):
        while (line := self._q.get()) is not None:
            yield line


class Stdout:
    """Collects the frames a host writes; waits for one that matches."""

    def __init__(self):
        self.frames = []
        self._buf = ""
        self._cv = threading.Condition()

    def write(self, s):
        with self._cv:
            self._buf += s
            *lines, self._buf = self._buf.split("\n")
            self.frames += [json.loads(line) for line in lines if line]
            self._cv.notify_all()

    def flush(self):
        pass

    def wait_for(self, pred, timeout=120):
        with self._cv:
            assert self._cv.wait_for(
                lambda: any(pred(f) for f in self.frames), timeout), \
                f"no matching frame in {self.frames[-3:]}"
            return next(f for f in self.frames if pred(f))


def events_of(frames, req_id):
    """The request's events, from legacy and batched frames alike."""
    out = []
    for f in frames:
        if f.get("op") == "event" and f.get("id") == req_id:
            out.append(f)
        elif f.get("op") == "events":
            out += [e for e in f["events"] if e["id"] == req_id]
    return out


def summary(events):
    return {"text": "".join(e["text"] for e in events),
            "tokens": events[-1]["tokens"],
            "finish_reason": events[-1]["finish_reason"],
            "reused": events[0].get("reused")}


MESSAGES = [
    [{"role": "user", "content": "hello"}],
    [{"role": "user", "content": "please summarize this rather long message "
      "so that its prompt spans several prefill chunks of the engine"}],
    # the same long prompt again: a prefix-cache hit
    [{"role": "user", "content": "please summarize this rather long message "
      "so that its prompt spans several prefill chunks of the engine"}],
    # a second turn re-sending the first as history: a partial hit
    [{"role": "user", "content": "please summarize this rather long message "
      "so that its prompt spans several prefill chunks of the engine"},
     {"role": "assistant", "content": "ok"},
     {"role": "user", "content": "and now in one short line"}],
]


def drive(serve, frames: Stdout, stdin: Stdin):
    """Run a host's serve loop on a thread; submit MESSAGES one at a time,
    then stats and shutdown. Returns (per-request summaries, stats)."""
    t = threading.Thread(target=serve, daemon=True)
    t.start()
    frames.wait_for(lambda f: f.get("op") == "ready")
    out = []
    for i, messages in enumerate(MESSAGES):
        stdin.send({"op": "submit", "id": f"r{i}", "messages": messages,
                    "max_new": 12, "sampling": {"temperature": 0.0}})
        frames.wait_for(lambda f, i=i: any(
            e.get("done") for e in events_of([f], f"r{i}")))
        out.append(summary(events_of(frames.frames, f"r{i}")))
    stdin.send({"op": "stats"})
    stats = frames.wait_for(lambda f: f.get("op") == "stats")
    stdin.send({"op": "shutdown"})
    t.join(60)
    assert not t.is_alive()
    return out, stats


class TestHostParity:
    def test_streams_identical_to_jax_host(self, monkeypatch):
        jparams = jax_init_params(jax_preset("tiny"), jax.random.key(0),
                                  jnp.float32)
        params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                   device="cpu")
        geometry = dict(max_slots=2, max_seq_len=256,
                        prefill_buckets=(32, 64, 128, 256),
                        prefill_chunk=32, prefix_cache_bytes=2**20,
                        decode_block=4)

        def jax_build(cls, tpu_cfg, **kw):
            return JaxEngine(jax_preset("tiny"), jparams,
                             jax_get_tokenizer(None, vocab_size=512),
                             cache_dtype=jnp.float32, **geometry)

        def port_build(cls, tpu_cfg, *, device="cuda"):
            assert device == "cpu"
            return InferenceEngine(preset("tiny"), params,
                                   get_tokenizer(None, vocab_size=512),
                                   cache_dtype=torch.float32, device=device,
                                   **geometry)

        monkeypatch.setattr(JaxEngine, "from_tpu_config",
                            classmethod(jax_build))
        monkeypatch.setattr(InferenceEngine, "from_tpu_config",
                            classmethod(port_build))

        jin, jout = Stdin(), Stdout()
        jhost = JaxHost(provider_config(cls=JaxConfigManager))
        monkeypatch.setattr(sys, "stdout", jout)
        monkeypatch.setattr(sys, "stdin", jin)
        want, jstats = drive(lambda: jhost.serve_forever(), jout, jin)
        monkeypatch.undo()
        monkeypatch.setattr(InferenceEngine, "from_tpu_config",
                            classmethod(port_build))

        pin, pout = Stdin(), Stdout()
        host = EngineHost(provider_config(), device="cpu", out=pout)
        got, stats = drive(lambda: host.serve_forever(stdin=pin), pout, pin)

        assert got == want
        assert [r["reused"] for r in got][1:] == [0, want[2]["reused"],
                                                 want[3]["reused"]]
        assert got[2]["reused"] > 0 and got[3]["reused"] > 0
        for s in (stats, jstats):
            assert s["engine_alive"] is True and s["journal"] == {}
            assert s["prefix_cache"]["hits"] == 2
            assert "prefix_summary" in s
            assert s["chunk_dispatches"] > 0
        assert stats["emit"]["pipe_event_writes"] <= stats["emit"][
            "pipe_events"]

    def test_refusals_on_the_wire(self, tmp_path):
        """A unified host: `profile` (once refused as item 12) captures and
        replies with a path, a second capture while one runs is refused
        with an error reply; an `adopt` whose frame is not a frame (once
        refused as item 11) fails its own request with an error event, as
        the JAX host's does; clock, trace (two components with the probes
        off) and metrics answer."""
        stdin, frames = Stdin(), Stdout()
        host = EngineHost(provider_config({"model_preset": "tiny",
                                           "prefix_cache_mb": None}),
                          device="cpu", out=frames)
        t = threading.Thread(target=host.serve_forever, args=(stdin,),
                             daemon=True)
        t.start()
        frames.wait_for(lambda f: f.get("op") == "ready")
        stdin.send({"op": "profile", "duration_s": 0.5, "dir": str(tmp_path)})
        stdin.send({"op": "profile", "duration_s": 0.1, "dir": str(tmp_path)})
        refused = frames.wait_for(lambda f: f.get("op") == "profile")
        assert "already running" in refused["error"]
        done = frames.wait_for(lambda f: f.get("op") == "profile"
                               and "path" in f)
        assert done["duration_s"] == 0.5
        assert os.path.isfile(os.path.join(done["path"], "trace.json"))
        stdin.send({"op": "adopt", "id": "x", "frame": "AAAA"})
        ev = frames.wait_for(lambda f: f.get("id") == "x")
        assert ev["done"] and ev["finish_reason"] == "error"
        assert ev["error"].startswith("handoff adoption failed")
        stdin.send({"op": "clock", "t0": 1.5})
        clock = frames.wait_for(lambda f: f.get("op") == "clock")
        assert clock["t0"] == 1.5 and clock["t"] > 0
        stdin.send({"op": "trace"})
        trace = frames.wait_for(lambda f: f.get("op") == "trace")
        assert len(trace["components"]) == 2
        stdin.send({"op": "metrics"})
        assert frames.wait_for(
            lambda f: f.get("op") == "metrics")["role"] == "unified"
        stdin.send({"op": "shutdown"})
        t.join(30)
        assert not t.is_alive()

    @pytest.mark.parametrize("tpu,item", [
        ({"role": "disagg"}, "unknown engine role"),
        ({"role": "decode", "prefix_cache_mb": None}, "prefix cache"),
        ({"multihost": {"coordinator": "localhost:1", "num_processes": 2,
                        "dcn_data": 2}}, "item 14"),
        ({"compile_cache": "/proc/no-such-dir"}, "/proc/no-such-dir"),
    ])
    def test_out_of_slice_config_fails_at_start(self, tpu, item):
        """A config the engine cannot serve fails the host at start: a
        data axis across hosts (item 14), a role that is no tier, a decode tier
        without its prefix store, and a kernel build directory that cannot
        be written (named, never replaced in silence)."""
        host = EngineHost(provider_config(tpu), device="cpu", out=Stdout())
        with pytest.raises(Exception, match=item):
            host.start()


class TestGatedEngine:
    def test_calls_and_host_copies_hold_the_gate(self):
        """The host's engine (GatedEngine): each method call, and the host
        copy of each HostFuture it returns, runs holding the gate, so the
        profile capture's start and stop never overlap them; attributes
        pass through."""
        from symmetry_tpu_torch.engine.engine import HostFuture
        from symmetry_tpu_torch.engine.host import GatedEngine

        gate = threading.RLock()

        def free_elsewhere():
            out = []
            t = threading.Thread(target=lambda: out.append(
                gate.acquire(blocking=False) and (gate.release() or True)))
            t.start()
            t.join(5)
            return out[0]

        class Future(HostFuture):
            def __array__(self, dtype=None, copy=None):
                assert not free_elsewhere()
                return super().__array__(dtype, copy)

        class Engine:
            max_slots = 3

            def dispatch(self):
                assert not free_elsewhere()
                return Future(torch.arange(4))

            def pair(self):
                return Future(torch.ones(2)), Future(torch.zeros(2))

            def prefix_cache_stats(self):
                return {}

        engine = GatedEngine(Engine(), gate)
        assert engine.max_slots == 3
        fut = engine.dispatch()
        assert free_elsewhere()
        assert np.asarray(fut).tolist() == [0, 1, 2, 3]
        a, b = engine.pair()
        assert np.asarray(a).tolist() == [1, 1] and np.asarray(b).sum() == 0
        # A stats read (pipe-reader thread) does not wait for a dispatch
        # that holds the gate on the engine thread.
        held, release = threading.Event(), threading.Event()

        def dispatching():
            with gate:
                held.set()
                release.wait(10)

        t = threading.Thread(target=dispatching)
        t.start()
        assert held.wait(5)
        try:
            out = []
            reader = threading.Thread(
                target=lambda: out.append(engine.prefix_cache_stats()))
            reader.start()
            reader.join(2)
            assert out == [{}]
        finally:
            release.set()
            t.join(5)
        with pytest.raises(AttributeError):
            engine.idle_tick


# ---------------------------------------------------------------------------
# (b) the emit-batch contract


def make_req(rid):
    return GenRequest(prompt_ids=[1], sampling=SamplingParams(),
                      max_new_tokens=16, emit=lambda ev: None, id=rid)


class TestHostEmitBatch:
    def test_block_batch_is_one_pipe_write(self, capsys):
        host = EngineHost(config=None)  # config untouched before start()
        host._reported = {"r1": 0, "r2": 0, "r3": 0}
        host._emit_batch([
            (make_req("r1"), TokenEvent(text="ab", token_id=98,
                                        tokens_generated=9,
                                        tokens_emitted=9)),
            (make_req("r2"), TokenEvent(text="c", token_id=99,
                                        tokens_generated=4,
                                        tokens_emitted=3, done=True,
                                        finish_reason="stop")),
            (make_req("r3"), TokenEvent(text="", token_id=None,
                                        tokens_generated=2,
                                        tokens_emitted=1, done=True,
                                        finish_reason="error",
                                        error="boom")),
        ])
        assert host.emit_stats["pipe_writes"] == 1  # O(1) per block
        assert host.emit_stats["pipe_event_writes"] == 1
        assert host.emit_stats["pipe_events"] == 3
        assert host.emit_stats["pipe_batched_frames"] == 1
        lines = capsys.readouterr().out.strip().splitlines()
        assert len(lines) == 1
        frame = json.loads(lines[0])
        assert frame["op"] == "events"
        e1, e2, e3 = frame["events"]
        assert e1 == {"id": "r1", "text": "ab", "tokens": 9,
                      "tokens_new": 9}
        assert e2["done"] and e2["finish_reason"] == "stop"
        assert e2["tokens"] == 4 and e2["tokens_new"] == 3
        assert e3["finish_reason"] == "error" and e3["error"] == "boom"
        assert host._reported == {"r1": 9}

    def test_single_event_keeps_legacy_frame(self, capsys):
        host = EngineHost(config=None)
        host._reported = {"r1": 3}
        host._emit_batch([(make_req("r1"), TokenEvent(
            text="d", token_id=100, tokens_generated=5, tokens_emitted=5,
            tokens_reused=32))])
        frame = json.loads(capsys.readouterr().out)
        assert frame == {"op": "event", "id": "r1", "text": "d", "tokens": 5,
                         "tokens_new": 2, "reused": 32}
        assert host.emit_stats["pipe_batched_frames"] == 0

    def test_private_stream(self):
        out = Stdout()
        host = EngineHost(config=None, out=out)
        host._write({"op": "stats"})
        assert out.frames == [{"op": "stats"}]


# ---------------------------------------------------------------------------
# (c) client -> server -> JAX provider -> the port's host subprocess


class PortHostBackend(TpuNativeBackend):
    """tpu_native in process mode with the port's engine host."""

    def _host_argv(self, cfg_path):
        return [sys.executable, "-m", "symmetry_tpu_torch.engine.host",
                cfg_path, "--device", "cpu"]


def test_provider_flow_through_port_host(monkeypatch):
    from symmetry_tpu.client.client import SymmetryClient
    from symmetry_tpu.identity import Identity
    from symmetry_tpu.provider.provider import SymmetryProvider
    from symmetry_tpu.server.broker import SymmetryServer
    from symmetry_tpu.transport.memory import MemoryTransport

    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    tpu = {"engine_isolation": "process", "prefix_cache_mb": None}
    messages = [{"role": "user", "content": "hello over the wire"}]

    async def main():
        hub = MemoryTransport()
        server_ident = Identity.from_name("port-e2e-server")
        server = SymmetryServer(server_ident, hub, ping_interval_s=30.0)
        await server.start("mem://server")
        cfg = JaxConfigManager(config={
            **provider_config(tpu).get_all(),
            "public": True, "serverKey": server_ident.public_hex})
        provider = SymmetryProvider(
            cfg, transport=hub, identity=Identity.from_name("port-prov"),
            backend=PortHostBackend(cfg), server_address="mem://server")
        await provider.start("mem://port-prov")
        await provider.wait_registered()
        client = SymmetryClient(Identity.from_name("port-cli"), hub)
        details = await client.request_provider(
            "mem://server", server_ident.public_key, "tiny:test")
        session = await client.connect(details)
        try:
            return "".join([d async for d in session.chat(messages,
                                                         max_tokens=10)])
        finally:
            await session.close()
            await provider.stop()
            await server.stop()

    got = asyncio.new_event_loop().run_until_complete(
        asyncio.wait_for(main(), 240))

    engine = InferenceEngine.from_tpu_config(
        provider_config(tpu).tpu, device="cpu")
    events, done = [], threading.Event()

    def emit(ev):
        events.append(ev)
        if ev.done:
            done.set()

    sched = Scheduler(engine)
    sched.submit(GenRequest(
        prompt_ids=engine.tokenizer.apply_chat_template(messages),
        sampling=SamplingParams(), max_new_tokens=10, emit=emit, id="ref"))
    sched.start()
    try:
        assert done.wait(120)
    finally:
        sched.stop()
    want = "".join(ev.text for ev in events)
    assert got == want and len(want) > 0
