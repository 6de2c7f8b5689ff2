"""Batched host pipe protocol: one frame per block, both shapes parse.

Copied from tests/test_host_protocol.py onto the port's EngineHost and
TpuNativeBackend.

Two halves of the pipe, each tested against the wire contract in
engine/host.py's docstring:

  - EngineHost._emit_batch (producer): a scheduler block flush becomes
    ONE stdout write — the `events` frame — with per-event delta
    bookkeeping (tokens_new) and done/finish_reason fidelity; a lone
    event keeps the legacy `event` frame. Asserted via the emit-path
    counters (pipe_writes), the O(1)-writes-per-block acceptance gate.

  - TpuNativeBackend._read_events (consumer): a mixed stream of batched
    `events` frames and legacy single-event frames fans out to the right
    per-request queues, preserving per-stream ordering; abandoning a
    stream mid-block cancels it host-side.
"""

import asyncio
import json
from types import SimpleNamespace

from symmetry_tpu_torch.engine.engine import SamplingParams
from symmetry_tpu_torch.engine.host import EngineHost
from symmetry_tpu_torch.engine.scheduler import GenRequest, TokenEvent
from symmetry_tpu_torch.provider.backends.base import InferenceRequest
from symmetry_tpu_torch.provider.backends.tpu_native import TpuNativeBackend
from symmetry_tpu_torch.provider.config import ConfigManager


def make_req(rid: str) -> GenRequest:
    return GenRequest(prompt_ids=[1], sampling=SamplingParams(),
                      max_new_tokens=16, emit=lambda ev: None, id=rid)


class TestHostEmitBatch:
    def test_block_batch_is_one_pipe_write(self, capsys):
        host = EngineHost(config=None)  # config untouched before start()
        host._reported = {"r1": 0, "r2": 0, "r3": 0}
        batch = [
            (make_req("r1"), TokenEvent(text="ab", token_id=98,
                                        tokens_generated=9,
                                        tokens_emitted=9)),
            # r2 stops on EOS: generated counts it, emitted does not —
            # tokens_new must ride the emitted count.
            (make_req("r2"), TokenEvent(text="c", token_id=99,
                                        tokens_generated=4,
                                        tokens_emitted=3, done=True,
                                        finish_reason="stop")),
            (make_req("r3"), TokenEvent(text="", token_id=None,
                                        tokens_generated=2,
                                        tokens_emitted=1, done=True,
                                        finish_reason="error",
                                        error="boom")),
        ]
        host._emit_batch(batch)
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
        assert e2["tokens"] == 4       # generated keeps the EOS…
        assert e2["tokens_new"] == 3   # …streamed-token deltas do not
        assert e3["finish_reason"] == "error" and e3["error"] == "boom"
        # done events retire their delta bookkeeping
        assert host._reported == {"r1": 9}

    def test_single_event_keeps_legacy_frame(self, capsys):
        host = EngineHost(config=None)
        host._reported = {"r1": 3}
        host._emit_batch([(make_req("r1"), TokenEvent(
            text="d", token_id=100, tokens_generated=5,
            tokens_emitted=5))])
        frame = json.loads(capsys.readouterr().out)
        assert frame["op"] == "event"  # wire-compatible with old readers
        assert frame["tokens_new"] == 2  # cumulative 5 - reported 3
        assert host.emit_stats["pipe_writes"] == 1
        assert host.emit_stats["pipe_batched_frames"] == 0


def backend_fixture():
    cfg = ConfigManager(config={
        "name": "t", "public": False, "serverKey": "00" * 32,
        "modelName": "tiny-test", "apiProvider": "tpu_native",
        "tpu": {"model_preset": "tiny", "dtype": "float32",
                "max_batch_size": 2, "max_seq_len": 64,
                "prefill_buckets": [16, 32]},
    })
    backend = TpuNativeBackend(cfg, device="cpu")

    class FakeStdin:
        def __init__(self):
            self.lines: list[bytes] = []

        def write(self, data: bytes) -> None:
            self.lines.append(data)

        async def drain(self) -> None:
            pass

    reader = asyncio.StreamReader()
    stdin = FakeStdin()
    backend._proc = SimpleNamespace(stdout=reader, stdin=stdin,
                                    returncode=None, pid=1)
    backend._started = True
    return backend, reader, stdin


def feed(reader: asyncio.StreamReader, obj: dict) -> None:
    reader.feed_data((json.dumps(obj) + "\n").encode())


async def wait_registered(backend, *ids, timeout=5.0):
    async def poll():
        while not all(i in backend._queues for i in ids):
            await asyncio.sleep(0.001)
    await asyncio.wait_for(poll(), timeout)


REQ = InferenceRequest(messages=[{"role": "user", "content": "hi"}])


class TestTpuNativeMixedFrames:
    def test_mixed_batched_and_legacy_frames_round_trip(self):
        async def main():
            backend, reader, _stdin = backend_fixture()
            reader_task = asyncio.ensure_future(backend._read_events())

            async def collect(req_id):
                out = []
                async for ch in backend._stream_host(REQ, req_id, 0, 16):
                    out.append(ch)
                return out

            t1 = asyncio.ensure_future(collect("r1"))
            t2 = asyncio.ensure_future(collect("r2"))
            await wait_registered(backend, "r1", "r2")

            # legacy single-event frame …
            feed(reader, {"op": "event", "id": "r1", "text": "Hel",
                          "tokens": 3, "tokens_new": 3})
            # … a batched frame interleaving both streams …
            feed(reader, {"op": "events", "events": [
                {"id": "r1", "text": "lo", "tokens": 5, "tokens_new": 2},
                {"id": "r2", "text": "wor", "tokens": 3, "tokens_new": 3},
            ]})
            # … and a batched frame carrying both finishes.
            feed(reader, {"op": "events", "events": [
                {"id": "r1", "text": "", "done": True,
                 "finish_reason": "stop", "tokens": 5, "tokens_new": 0},
                {"id": "r2", "text": "ld", "done": True,
                 "finish_reason": "length", "tokens": 5, "tokens_new": 2},
            ]})
            c1, c2 = await asyncio.gather(t1, t2)

            # Per-stream ordering and content survive the mixed shapes.
            assert "".join(ch.text for ch in c1) == "Hello"
            assert "".join(ch.text for ch in c2) == "world"
            # done/finish_reason fidelity: finish chunk then [DONE]
            fin1 = json.loads(c1[-2].raw[len("data: "):])
            assert fin1["choices"][0]["finish_reason"] == "stop"
            fin2 = json.loads(c2[-2].raw[len("data: "):])
            assert fin2["choices"][0]["finish_reason"] == "length"
            assert c1[-1].done and c2[-1].done
            assert sum(ch.tokens or 0 for ch in c2) == 5

            assert backend.relay_stats == {"host_frames": 3,
                                           "host_events": 5,
                                           "host_batched_frames": 2}
            reader_task.cancel()

        asyncio.new_event_loop().run_until_complete(
            asyncio.wait_for(main(), 30))

    def test_abandoned_stream_cancels_mid_block(self):
        async def main():
            backend, reader, stdin = backend_fixture()
            reader_task = asyncio.ensure_future(backend._read_events())

            agen = backend._stream_host(REQ, "r3", 0, 16)
            got = []
            # advance until the first content chunk, then abandon
            consume = asyncio.ensure_future(agen.__anext__())
            await wait_registered(backend, "r3")
            got.append(await consume)  # role chunk
            feed(reader, {"op": "events", "events": [
                {"id": "r3", "text": "par", "tokens": 3, "tokens_new": 3}]})
            got.append(await agen.__anext__())
            assert got[-1].text == "par"
            await agen.aclose()  # client walks away mid-block

            sent = [json.loads(line) for line in
                    b"".join(stdin.lines).decode().strip().splitlines()]
            assert {"op": "cancel", "id": "r3"} in sent
            assert "r3" not in backend._queues
            reader_task.cancel()

        asyncio.new_event_loop().run_until_complete(
            asyncio.wait_for(main(), 30))

    def test_malformed_and_unknown_events_ignored(self):
        async def main():
            backend, reader, _stdin = backend_fixture()
            reader_task = asyncio.ensure_future(backend._read_events())

            async def collect(req_id):
                out = []
                async for ch in backend._stream_host(REQ, req_id, 0, 16):
                    out.append(ch)
                return out

            t = asyncio.ensure_future(collect("r4"))
            await wait_registered(backend, "r4")
            feed(reader, {"op": "events", "events": "garbage"})
            feed(reader, {"op": "events", "events": [
                "junk",
                {"id": "nobody-home", "text": "zzz"},
                {"id": "r4", "text": "ok", "tokens": 2, "tokens_new": 2},
            ]})
            feed(reader, {"op": "event", "id": "r4", "text": "", "done": True,
                          "finish_reason": "stop", "tokens": 2,
                          "tokens_new": 0})
            chunks = await t
            assert "".join(ch.text for ch in chunks) == "ok"
            reader_task.cancel()

        asyncio.new_event_loop().run_until_complete(
            asyncio.wait_for(main(), 30))


class TestHostProfileOp:
    """HostOp.PROFILE round-trip (PR-15): the capture runs on its own
    thread (the serve loop must keep flowing for its whole window) and
    the reply carries the artifact path — or a structured error when a
    capture is already holding the single-flight window."""

    def _wait_reply(self, capsys, timeout=120.0):
        # Generous: the process's FIRST profiler capture pays a
        # cold-init cost of tens of seconds on a loaded box.
        import time as _time

        deadline = _time.monotonic() + timeout
        while _time.monotonic() < deadline:
            out = capsys.readouterr().out
            if out.strip():
                return [json.loads(line)
                        for line in out.strip().splitlines()]
            _time.sleep(0.05)
        raise AssertionError("no profile reply on the pipe")

    def test_profile_op_replies_with_artifact_path(self, capsys,
                                                   tmp_path):
        import os

        host = EngineHost(config=None)
        host._handle_profile({"op": "profile", "duration_s": 0.05,
                              "dir": str(tmp_path)})
        (reply,) = self._wait_reply(capsys)
        assert reply["op"] == "profile"
        assert reply.get("error") is None, reply
        assert os.path.isdir(reply["path"])
        assert str(tmp_path) in reply["path"]

    def test_concurrent_capture_refused_as_error_reply(self, capsys,
                                                       tmp_path):
        import threading
        import time as _time

        from symmetry_tpu_torch.utils.devprof import capture_device_profile

        host = EngineHost(config=None)
        hold = threading.Thread(target=capture_device_profile,
                                args=(str(tmp_path),),
                                kwargs={"duration_s": 0.8})
        hold.start()
        _time.sleep(0.2)
        host._handle_profile({"op": "profile", "duration_s": 0.05,
                              "dir": str(tmp_path)})
        try:
            (reply,) = self._wait_reply(capsys)
        finally:
            hold.join()
        assert reply["op"] == "profile"
        assert "already running" in (reply.get("error") or "")
