"""Engine-host supervision chaos suite.

Proves the recovery machinery with REAL injected faults at the real
seams (utils/faults.py), no TPU and no network:

  - host crash mid-stream (SYMMETRY_FAULTS-style `host.pipe_write=crash`)
    → in-flight streams get the retryable restarting shed, the
    supervisor respawns the host, and the next request serves normally;
  - host wedge (`host.pipe_read=hang`) → the watchdog's stats-probe
    deadline detects it far inside the 15 s health-loop window, kills
    the process, and the same restart path runs;
  - persistently failing respawns → the circuit breaker opens after
    max_respawns consecutive failures and healthy() goes false (the
    pre-supervisor deregistration path);
  - scheduler admission seams: injected admit errors fail exactly one
    request, injected drops lose it silently (what the watchdog exists
    to catch), and expired deadlines are shed at admission without a
    prefill dispatch.

The host subprocess is tests/fake_host.py — protocol-faithful, JAX-free,
instrumented with the same FAULTS seams as engine/host.py — so a
crash/respawn life costs milliseconds instead of an engine build.
Scheduler-level tests use the port's real tiny engine on the CPU (copied
from tests/test_supervisor.py with the engine moved onto the port).
"""

import asyncio
import os
import sys
import threading
import time

import pytest

from symmetry_tpu_torch.provider.backends.base import (
    BackendDeadlineError,
    BackendError,
    BackendRestartingError,
    InferenceRequest,
)
from symmetry_tpu_torch.provider.backends.tpu_native import TpuNativeBackend
from symmetry_tpu_torch.provider.config import ConfigManager
from symmetry_tpu_torch.utils.faults import FAULTS, InjectedFault

FAKE_HOST = os.path.join(os.path.dirname(__file__), "fake_host.py")


@pytest.fixture(autouse=True)
def clean_global_faults():
    FAULTS.clear()
    yield
    FAULTS.clear()


def run(coro):
    return asyncio.new_event_loop().run_until_complete(
        asyncio.wait_for(coro, 60))


class FakeHostBackend(TpuNativeBackend):
    """tpu_native process mode against the protocol-faithful fake host."""

    def _host_argv(self, cfg_path):
        return [sys.executable, FAKE_HOST, cfg_path]


def fake_cfg(faults=None, sup=None, fake_host=None):
    supervisor = {"heartbeat_s": 30.0, "wedge_timeout_s": 1.0,
                  "backoff_base_s": 0.05, "backoff_max_s": 0.2,
                  "max_respawns": 2, "spawn_timeout_s": 15.0,
                  "stop_grace_s": 0.5, **(sup or {})}
    return ConfigManager(config={
        "name": "chaos-prov", "public": False, "serverKey": "00" * 32,
        "modelName": "fake:chaos", "apiProvider": "tpu_native",
        "dataCollectionEnabled": False,
        "tpu": {"engine_isolation": "process", "max_batch_size": 4,
                "supervisor": supervisor},
        **({"faults": faults} if faults else {}),
        **({"fakeHost": fake_host} if fake_host else {}),
    })


async def collect_stream(backend, max_tokens, content="chaos"):
    text = []
    async for chunk in backend.stream(InferenceRequest(
            messages=[{"role": "user", "content": content}],
            max_tokens=max_tokens)):
        if chunk.text:
            text.append(chunk.text)
    return "".join(text)


async def wait_for(predicate, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        await asyncio.sleep(interval)
    return False


class TestSupervisor:
    def test_crash_midstream_sheds_and_respawns(self):
        """The flagship path: SYMMETRY_FAULTS-shaped crash mid-stream →
        the in-flight stream gets the structured RETRYABLE restarting
        error, the supervisor respawns the host, the next request
        completes, and engine_stats records the restart.

        Write arithmetic (fake host, per life): ready=1 + clock×5 = 6
        startup writes, so `nth=20` crashes life 1 on its 14th stream
        event (mid-stream, ~0.3 s in) while life 2 — startup + a
        3-token chat + one stats reply = 10 writes — never reaches it."""
        # The seam spec is exactly what SYMMETRY_FAULTS would carry; the
        # config mapping reaches the host subprocess via its config copy.
        cfg = fake_cfg(faults={"host.pipe_write": "crash@nth=20"})
        restarts_seen = []

        async def main():
            backend = FakeHostBackend(cfg)
            await backend.start()
            backend.on_host_restart = restarts_seen.append
            try:
                with pytest.raises(BackendRestartingError) as exc_info:
                    await collect_stream(backend, max_tokens=40)
                # the shed carries the retry hint the provider forwards
                assert exc_info.value.retry_after_s is not None
                assert await wait_for(
                    lambda: backend._restarts >= 1
                    and not backend._restarting), "no respawn"
                assert restarts_seen == ["crash"]
                # the respawned host serves normally
                text = await collect_stream(backend, max_tokens=3)
                assert text == "t0 t1 "
                stats = await backend.engine_stats()
                assert stats["supervisor"]["restarts"] == 1
                assert stats["supervisor"]["circuit_open"] is False
                assert await backend.healthy()
            finally:
                await backend.stop()

        run(main())

    def test_new_stream_during_restart_gets_restarting_shed(self):
        """A request arriving while the host is down must be shed with
        the retryable restarting error, not hang on a dead pipe."""
        # Long backoff so the restart window is reliably open when the
        # second stream arrives.
        cfg = fake_cfg(faults={"host.pipe_write": "crash@nth=8"},
                       sup={"backoff_base_s": 1.0, "backoff_max_s": 1.0})

        async def main():
            backend = FakeHostBackend(cfg)
            await backend.start()
            try:
                with pytest.raises(BackendRestartingError):
                    await collect_stream(backend, max_tokens=40)
                # inside the backoff window: host is down, not yet back
                with pytest.raises(BackendRestartingError):
                    await collect_stream(backend, max_tokens=2)
                # supervised death is a transient, not a health failure
                assert await backend.healthy()
            finally:
                await backend.stop()

        run(main())

    def test_wedge_detected_by_watchdog_and_restarted(self):
        """A host that is alive but not answering (hung read loop) must
        be detected by the stats-probe watchdog within its own deadline
        — far tighter than the 15 s health loop — then killed and
        respawned, failing the wedged in-flight stream as restarting.

        Read arithmetic (fake host, per life): clock×5 = reads 1–5, so
        `nth=6` hangs the FIRST post-handshake command — the submit (or
        the first watchdog probe, whichever lands first); either way the
        stream stalls and only the watchdog can notice."""
        cfg = fake_cfg(faults={"host.pipe_read": "hang(120)@nth=6"},
                       sup={"heartbeat_s": 0.15, "wedge_timeout_s": 0.4})

        async def main():
            backend = FakeHostBackend(cfg)
            await backend.start()
            t0 = time.monotonic()
            try:
                with pytest.raises(BackendRestartingError):
                    await collect_stream(backend, max_tokens=40)
                # detection + shed must beat the 15 s health-loop floor
                assert time.monotonic() - t0 < 10.0
                assert await wait_for(lambda: backend._restarts >= 1)
            finally:
                await backend.stop()

        run(main())

    def test_circuit_breaker_opens_after_consecutive_respawn_failures(
            self, tmp_path):
        """Respawns that keep dying (failFile arms the fake host to exit
        before ready) must trip the breaker after max_respawns=2
        consecutive failures: healthy() false (→ the provider health
        loop deregisters), new streams get a terminal error, and the
        supervisor stops burning respawns."""
        fail_file = tmp_path / "respawn.fail"
        cfg = fake_cfg(fake_host={"failFile": str(fail_file)})

        async def main():
            backend = FakeHostBackend(cfg)
            await backend.start()
            try:
                assert await backend.healthy()
                fail_file.write_text("die")       # every next life fails
                backend._proc.kill()              # the initial crash
                assert await wait_for(lambda: backend._circuit_open), \
                    "circuit breaker never opened"
                assert backend._respawn_failures == 2
                assert not await backend.healthy()
                # circuit-open is terminal, not retryable
                with pytest.raises(BackendError) as exc_info:
                    await collect_stream(backend, max_tokens=2)
                assert not isinstance(exc_info.value,
                                      BackendRestartingError)
                stats = await backend.engine_stats()
                assert stats["supervisor"]["circuit_open"] is True
            finally:
                await backend.stop()

        run(main())

    def test_reader_death_without_eof_is_recovered_by_heartbeat(self):
        """If the reader task dies WITHOUT running its EOF path (an
        unexpected exception), nobody fails streams or wakes the
        supervisor — the heartbeat must notice the dead reader and run
        the death path itself instead of spinning forever against a
        zombie backend."""
        cfg = fake_cfg(sup={"heartbeat_s": 0.1})

        async def main():
            backend = FakeHostBackend(cfg)
            await backend.start()
            try:
                # Simulate the reader dying ungracefully: cancel it so
                # its EOF path never runs (the cancelled path skips it
                # by design).
                backend._reader.cancel()
                assert await wait_for(
                    lambda: backend._restarts >= 1
                    and not backend._restarting), \
                    "heartbeat never recovered the dead reader"
                text = await collect_stream(backend, max_tokens=3)
                assert text == "t0 t1 "
            finally:
                await backend.stop()

        run(main())

    def test_reader_eof_idempotent_after_manual_death_handling(self):
        """When the heartbeat's backstop already handled a death (set
        _host_dead, failed streams, signaled the supervisor), a LATE
        reader EOF for the same life must be a no-op — re-signaling
        _host_down would wake the supervisor a second time after the
        respawn and kill the healthy new host as a spurious stability
        failure."""
        cfg = fake_cfg()  # heartbeat 30s: the real backstop stays quiet

        async def main():
            backend = FakeHostBackend(cfg)
            await backend.start()
            try:
                # Simulate the backstop having handled this death first.
                backend._host_dead = True
                backend._proc.kill()  # reader EOF arrives late
                await asyncio.sleep(0.5)
                assert not backend._host_down.is_set(), \
                    "late EOF re-signaled an already-handled death"
                assert backend._restarts == 0
            finally:
                await backend.stop()

        run(main())

    def test_crash_loop_trips_breaker_despite_successful_spawns(self):
        """Every spawn SUCCEEDS but every life dies young (dieAfterS):
        only a life that survives min_stable_s resets the failure count,
        so the crash-loop walks the backoff ladder into the breaker
        instead of flapping forever on reset-by-spawn-success."""
        cfg = fake_cfg(fake_host={"dieAfterS": 0.1},
                       sup={"max_respawns": 3, "min_stable_s": 5.0})

        async def main():
            backend = FakeHostBackend(cfg)
            await backend.start()
            try:
                assert await wait_for(lambda: backend._circuit_open,
                                      timeout=20), \
                    "crash loop never tripped the breaker"
                # deaths counted: initial + each short-lived respawn
                assert backend._respawn_failures == 3
                assert backend._restarts >= 1  # spawns DID succeed
                assert not await backend.healthy()
            finally:
                await backend.stop()

        run(main())

    def test_unsupervised_death_keeps_legacy_behavior(self):
        """supervisor.enabled=false restores the pre-supervisor contract:
        a dead host fails healthy() and streams get a plain terminal
        BackendError (no restarting shed, no respawn)."""
        cfg = fake_cfg(sup={"enabled": False})

        async def main():
            backend = FakeHostBackend(cfg)
            await backend.start()
            try:
                backend._proc.kill()
                assert await wait_for(lambda: backend._host_dead)
                assert not await backend.healthy()
                with pytest.raises(BackendError) as exc_info:
                    await collect_stream(backend, max_tokens=2)
                assert not isinstance(exc_info.value,
                                      BackendRestartingError)
                assert backend._restarts == 0
            finally:
                await backend.stop()

        run(main())


# --------------------------------------------------------------------------
# Scheduler-level chaos: admission seams + deadline sheds (real tiny engine)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_engine_factory():
    import torch

    from symmetry_tpu_torch.engine.engine import InferenceEngine
    from symmetry_tpu_torch.engine.tokenizer import ByteTokenizer
    from symmetry_tpu_torch.models import init_params, preset

    cfg = preset("tiny")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32)

    def build():
        return InferenceEngine(cfg, params, ByteTokenizer(), max_slots=2,
                               max_seq_len=64, prefill_buckets=(16, 32),
                               cache_dtype=torch.float32, decode_block=1,
                               device="cpu")

    return build


def drive_scheduler(sched, requests, timeout=60):
    """Submit GenRequests; wait for each listed done-event (or timeout).
    Returns {idx: [events]} and a {idx: completed} map."""
    from symmetry_tpu_torch.engine.scheduler import GenRequest
    from symmetry_tpu_torch.engine.engine import SamplingParams

    results = {i: [] for i in range(len(requests))}
    done = {i: threading.Event() for i in range(len(requests))}
    for i, kw in enumerate(requests):
        def emit(ev, i=i):
            results[i].append(ev)
            if ev.done:
                done[i].set()
        sched.submit(GenRequest(prompt_ids=list(b"req %d" % i),
                                sampling=SamplingParams(), emit=emit,
                                id=f"r{i}", **kw))
    completed = {i: done[i].wait(timeout) for i in range(len(requests))}
    return results, completed


class TestSchedulerChaos:
    def test_expired_deadline_shed_at_admission(self, tiny_engine_factory):
        """An already-expired request is shed at admission — finish
        "expired", deadline_shed counted, and NO prefill dispatch spent
        on it — while a live request admits normally."""
        from symmetry_tpu_torch.engine.scheduler import Scheduler

        sched = Scheduler(tiny_engine_factory())
        sched.start()
        try:
            results, completed = drive_scheduler(sched, [
                {"max_new_tokens": 4,
                 "deadline_at": time.monotonic() - 1.0},
                {"max_new_tokens": 4,
                 "deadline_at": time.monotonic() + 300.0},
            ])
            assert completed[0] and completed[1]
            expired = results[0][-1]
            assert expired.finish_reason == "expired"
            assert "deadline expired" in expired.error
            assert results[1][-1].finish_reason in ("stop", "length")
            stats = sched.stats()
            assert stats["deadline_shed"] == 1
            # the shed request never reached a device dispatch
            assert stats["admit_dispatches"] == 1
        finally:
            sched.stop()

    def test_admit_seam_error_fails_one_request(self, tiny_engine_factory):
        """`scheduler.admit=error@once`: exactly the first request dies
        with the injected error event; the next admits and streams."""
        from symmetry_tpu_torch.engine.scheduler import Scheduler

        FAULTS.load({"scheduler.admit": "error(injected-admit)@once"})
        sched = Scheduler(tiny_engine_factory())
        sched.start()
        try:
            results, completed = drive_scheduler(sched, [
                {"max_new_tokens": 4}, {"max_new_tokens": 4}])
            assert completed[0] and completed[1]
            assert results[0][-1].finish_reason == "error"
            assert "injected-admit" in results[0][-1].error
            assert results[1][-1].finish_reason in ("stop", "length")
        finally:
            sched.stop()

    def test_admit_seam_drop_loses_request_silently(self,
                                                    tiny_engine_factory):
        """`scheduler.admit=drop_frame@once`: the request vanishes with
        no terminal event — the lost-work mode the supervisor's watchdog
        (and stream timeouts) exist to catch — without disturbing its
        neighbors."""
        from symmetry_tpu_torch.engine.scheduler import Scheduler

        from symmetry_tpu_torch.engine.engine import SamplingParams
        from symmetry_tpu_torch.engine.scheduler import GenRequest

        FAULTS.load({"scheduler.admit": "drop_frame@once"})
        sched = Scheduler(tiny_engine_factory())
        sched.start()
        try:
            results = {0: [], 1: []}
            done = {0: threading.Event(), 1: threading.Event()}
            for i in range(2):
                def emit(ev, i=i):
                    results[i].append(ev)
                    if ev.done:
                        done[i].set()
                sched.submit(GenRequest(
                    prompt_ids=list(b"req %d" % i),
                    sampling=SamplingParams(), max_new_tokens=4,
                    emit=emit, id=f"r{i}"))
            # The survivor completing proves the scheduler processed the
            # whole inbox — THEN the dropped request getting nothing in
            # its wake is conclusive, not a racing still-queued read.
            assert done[1].wait(60)
            assert results[1][-1].finish_reason in ("stop", "length")
            assert not done[0].wait(0.5)
            assert results[0] == []
        finally:
            sched.stop()


class TestInprocChaos:
    """The inproc tpu_native path under injected faults (satellite:
    echo + inproc harness must exercise the fault layer without a TPU)."""

    def _inproc_cfg(self):
        # Mirrors tests/test_e2e_tpu_native.py exactly so the compiled
        # tiny-engine programs come from the shared compile cache.
        return ConfigManager(config={
            "name": "inproc-chaos", "public": False,
            "serverKey": "00" * 32, "modelName": "tiny:chaos",
            "apiProvider": "tpu_native", "dataCollectionEnabled": False,
            "tpu": {"model_preset": "tiny", "dtype": "float32",
                    "max_batch_size": 4, "max_seq_len": 128,
                    "prefill_buckets": [32, 64],
                    "engine_isolation": "inproc"},
        })

    def test_dispatch_fault_and_deadline_inproc(self):
        async def main():
            backend = TpuNativeBackend(self._inproc_cfg(), device="cpu")
            await backend.start()
            try:
                # A clean stream first (the engine works).
                text = await collect_stream(backend, max_tokens=4)
                assert isinstance(text, str)
                # backend.dispatch error: surfaces as InjectedFault from
                # the backend seam (the provider maps it to a dropped
                # peer — its own test lives with the network suite).
                FAULTS.load({"backend.dispatch": "error(injected)@once"})
                with pytest.raises(InjectedFault):
                    await collect_stream(backend, max_tokens=4)
                # An effectively-zero deadline is shed at admission and
                # surfaces as the terminal deadline error.
                with pytest.raises(BackendDeadlineError):
                    async for _chunk in backend.stream(InferenceRequest(
                            messages=[{"role": "user", "content": "x"}],
                            max_tokens=4, deadline_s=1e-9)):
                        pass
                # the engine is unharmed
                text = await collect_stream(backend, max_tokens=4)
                assert isinstance(text, str)
            finally:
                await backend.stop()

        run(main())
