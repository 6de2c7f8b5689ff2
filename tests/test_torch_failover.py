"""Failover: provider dies mid-stream → session requeue + client retry.

Round-2 verdict gap: the server marked dead providers offline but their
in-flight sessions just died and clients had no recovery. Now the server
expires a dead provider's sessions (registry.invalidate_sessions_for) and
SymmetryClient.chat_failover re-requests a provider with the dead one
excluded, completing the chat on the survivor (SURVEY §5.3).
"""

import asyncio
import time

import pytest

from symmetry_tpu_torch.client.client import (
    ChatRestart,
    ChatResume,
    ClientError,
    DeadlineExceededError,
    ProviderBusyError,
    ProviderDiedMidStreamError,
    ProviderGoneError,
    ProviderRestartingError,
    SymmetryClient,
    busy_retry_backoff,
)
from symmetry_tpu_torch.identity import Identity
from symmetry_tpu_torch.provider.backends.base import (
    BackendRestartingError,
    InferenceBackend,
    StreamChunk,
)
from symmetry_tpu_torch.provider.config import ConfigManager
from symmetry_tpu_torch.provider.provider import SymmetryProvider
from symmetry_tpu_torch.server.broker import SymmetryServer
from symmetry_tpu_torch.transport.memory import MemoryTransport


def run(coro):
    return asyncio.new_event_loop().run_until_complete(
        asyncio.wait_for(coro, 60))


class SlowBackend(InferenceBackend):
    """Streams one word per tick forever-ish — guarantees the kill lands
    mid-stream."""

    name = "slow"

    def __init__(self, config=None, delay=0.05, n=100) -> None:
        self._delay = delay
        self._n = n

    async def start(self) -> None: ...

    async def stop(self) -> None: ...

    async def healthy(self) -> bool:
        return True

    async def stream(self, request):
        for i in range(self._n):
            await asyncio.sleep(self._delay)
            yield StreamChunk(raw=f"data: {{\"choices\": [{{\"delta\": "
                                  f"{{\"content\": \"w{i} \"}}}}]}}",
                              text=f"w{i} ")


def provider_config(server_key_hex, name):
    return ConfigManager(config={
        "name": name, "public": True, "serverKey": server_key_hex,
        "modelName": "tiny:fo", "apiProvider": "echo",
        "dataCollectionEnabled": False,
    })


async def start_network(hub, server_ident, slow_first=True):
    server = SymmetryServer(server_ident, hub, ping_interval_s=30.0)
    await server.start("mem://server")
    p1 = SymmetryProvider(
        provider_config(server_ident.public_hex, "fo-p1"), transport=hub,
        identity=Identity.from_name("fo-p1"),
        backend=SlowBackend() if slow_first else None,
        server_address="mem://server")
    await p1.start("mem://fo-p1")
    await p1.wait_registered()
    p2 = SymmetryProvider(
        provider_config(server_ident.public_hex, "fo-p2"), transport=hub,
        identity=Identity.from_name("fo-p2"),
        server_address="mem://server")
    await p2.start("mem://fo-p2")
    await p2.wait_registered()
    return server, p1, p2


class TestFailover:
    def test_mid_stream_provider_death_completes_on_second(self):
        async def main():
            hub = MemoryTransport()
            ident = Identity.from_name("fo-server")
            server, p1, p2 = await start_network(hub, ident)
            client = SymmetryClient(Identity.from_name("fo-cli"), hub)

            # The broker prefers the least-loaded provider; make p1 the
            # guaranteed first pick by marking p2 busier.
            server.registry.set_connections(
                p2.identity.public_hex, 5)

            events = []

            async def chat():
                # resume=False pins the LEGACY discard-and-restart mode
                # (the resume path has its own suite below): p1's
                # SlowBackend text is not a prefix of p2's echo, so a
                # splice would be wrong here by construction.
                async for item in client.chat_failover(
                        "mem://server", ident.public_key, "tiny:fo",
                        [{"role": "user", "content": "failover!"}],
                        resume=False):
                    events.append(item)

            async def killer():
                # wait until p1 is actually streaming, then hard-kill it
                while not p1._in_flight:
                    await asyncio.sleep(0.01)
                await asyncio.sleep(0.15)
                for peer in list(p1._client_peers):
                    await peer.close()
                await p1.stop(drain_timeout_s=0)

            await asyncio.gather(chat(), killer())

            restarts = [e for e in events if isinstance(e, ChatRestart)]
            assert len(restarts) == 1
            assert restarts[0].provider_key == p2.identity.public_hex
            # deltas after the restart come from p2's echo backend
            after = events[events.index(restarts[0]) + 1:]
            assert after and all(isinstance(d, str) for d in after)
            # p1's session is dead server-side
            assert server.registry.select_provider(
                "tiny:fo").peer_key == p2.identity.public_hex
            await p2.stop(drain_timeout_s=1)
            await server.stop()

        run(main())

    def test_session_invalidated_when_provider_dies(self):
        async def main():
            hub = MemoryTransport()
            ident = Identity.from_name("fo-server2")
            server, p1, p2 = await start_network(hub, ident,
                                                 slow_first=False)
            client = SymmetryClient(Identity.from_name("fo-cli2"), hub)
            server.registry.set_connections(p2.identity.public_hex, 5)

            details = await client.request_provider(
                "mem://server", ident.public_key, "tiny:fo")
            assert details.peer_key == p1.identity.public_hex
            assert server.registry.session_valid(details.session_id)

            await p1.stop(drain_timeout_s=0)
            await asyncio.sleep(0.1)  # server sees the disconnect
            assert not server.registry.session_valid(details.session_id)

            # re-request with the dead provider excluded → p2
            details2 = await client.request_provider(
                "mem://server", ident.public_key, "tiny:fo",
                exclude=[details.peer_key])
            assert details2.peer_key == p2.identity.public_hex
            await p2.stop(drain_timeout_s=1)
            await server.stop()

        run(main())

    def test_busy_shed_fails_over_to_second_provider(self):
        """Bounded-latency admission: a provider over its queue_limit
        rejects with a structured busy error instead of queueing
        unboundedly, and chat_failover completes on another provider."""
        async def main():
            hub = MemoryTransport()
            ident = Identity.from_name("fo-server4")
            server, p1, p2 = await start_network(hub, ident,
                                                 slow_first=False)
            # p1 sheds everything: zero slots, zero queue.
            p1.backend.slots = 0
            p1.backend.queue_limit = 0
            client = SymmetryClient(Identity.from_name("fo-cli4"), hub)
            server.registry.set_connections(p2.identity.public_hex, 5)

            events = []
            async for item in client.chat_failover(
                    "mem://server", ident.public_key, "tiny:fo",
                    [{"role": "user", "content": "busy path"}]):
                events.append(item)

            restarts = [e for e in events if isinstance(e, ChatRestart)]
            assert len(restarts) == 1
            assert restarts[0].provider_key == p2.identity.public_hex
            assert "".join(e for e in events
                           if isinstance(e, str)) == "busy path"
            assert p1.metrics["shed"] == 1
            assert p1.stats()["shed"] == 1
            await p1.stop(drain_timeout_s=1)
            await p2.stop(drain_timeout_s=1)
            await server.stop()

        run(main())

    def test_busy_raises_structured_error_direct(self):
        """A non-failover client sees ProviderBusyError carrying the
        provider's queue depth/limit, not a generic failure."""
        async def main():
            hub = MemoryTransport()
            ident = Identity.from_name("fo-server5")
            server, p1, p2 = await start_network(hub, ident,
                                                 slow_first=False)
            p1.backend.slots = 0
            p1.backend.queue_limit = 0
            client = SymmetryClient(Identity.from_name("fo-cli5"), hub)
            server.registry.set_connections(p2.identity.public_hex, 5)

            details = await client.request_provider(
                "mem://server", ident.public_key, "tiny:fo")
            assert details.peer_key == p1.identity.public_hex
            session = await client.connect(details)
            try:
                with pytest.raises(ProviderBusyError) as exc_info:
                    async for _ in session.chat(
                            [{"role": "user", "content": "x"}]):
                        pass
                assert exc_info.value.queue_limit == 0
            finally:
                await session.close()
            await p1.stop(drain_timeout_s=1)
            await p2.stop(drain_timeout_s=1)
            await server.stop()

        run(main())

    def test_ttft_bound_estimator_and_shed_reasons(self):
        """The two admission bounds, exercised directly: the in-flight
        queue_limit and the rate-based estimated first-token wait."""
        import time as _t

        prov = SymmetryProvider(
            provider_config("00" * 32, "est-p"), transport=MemoryTransport(),
            identity=Identity.from_name("est-p"), server_address="mem://x")

        # Nothing waiting → zero wait, no shed.
        assert prov._estimated_first_token_wait_s() == 0.0
        assert prov._admission_shed_reason() is None

        # Backlog but NO recent rate signal (burst from idle): the
        # estimator must return None and the bound must not shed.
        prov.backend.admission_ttft_bound_s = 1.0
        prov._unstarted = 50
        assert prov._estimated_first_token_wait_s() is None
        assert prov._admission_shed_reason() is None

        # Recent first tokens at ~1/s with 50 waiting → ~50 s estimated
        # wait → over the 1 s bound → structured shed reason.
        now = _t.monotonic()
        prov._first_token_stamps.extend(now - 5 + i for i in range(5))
        est = prov._estimated_first_token_wait_s()
        assert est is not None and 25 <= est <= 100
        reason = prov._admission_shed_reason()
        assert reason is not None
        assert reason["estimatedWaitS"] == round(est, 2)
        assert reason["queueDepth"] == 50

        # The in-flight bound fires first when both trip.
        prov.backend.queue_limit = 4
        prov.backend.slots = 2
        prov._in_flight = 4
        reason = prov._admission_shed_reason()
        assert reason is not None and reason["queueLimit"] == 4
        assert reason["queueDepth"] == 2  # 4 in flight - 2 slots

    def test_restarting_shed_fails_over_to_second_provider(self):
        """An engine-host restart mid-service is the structured
        {"restarting": true} shed: chat_failover treats it like a busy
        shed (fail over NOW, provider not excluded as dead) and the
        request completes on the survivor."""
        class RestartingBackend(InferenceBackend):
            name = "restarting"

            async def stream(self, request):
                raise BackendRestartingError("engine host restarting",
                                             retry_after_s=0.25)
                yield  # pragma: no cover — makes this an async generator

        async def main():
            hub = MemoryTransport()
            ident = Identity.from_name("fo-server6")
            server, p1, p2 = await start_network(hub, ident,
                                                 slow_first=False)
            p1.backend = RestartingBackend()
            client = SymmetryClient(Identity.from_name("fo-cli6"), hub)
            server.registry.set_connections(p2.identity.public_hex, 5)

            events = []
            async for item in client.chat_failover(
                    "mem://server", ident.public_key, "tiny:fo",
                    [{"role": "user", "content": "restart path"}]):
                events.append(item)

            restarts = [e for e in events if isinstance(e, ChatRestart)]
            assert len(restarts) == 1
            assert restarts[0].provider_key == p2.identity.public_hex
            assert "".join(e for e in events
                           if isinstance(e, str)) == "restart path"
            assert p1.metrics["errors"] == 1
            await p1.stop(drain_timeout_s=1)
            await p2.stop(drain_timeout_s=1)
            await server.stop()

        run(main())

    def test_restarting_raises_structured_error_direct(self):
        """A non-failover client sees ProviderRestartingError (a
        ProviderBusyError subclass — same backoff machinery) carrying
        the provider's retry_after hint."""
        class RestartingBackend(InferenceBackend):
            name = "restarting"

            async def stream(self, request):
                raise BackendRestartingError("engine host restarting",
                                             retry_after_s=1.5)
                yield  # pragma: no cover

        async def main():
            hub = MemoryTransport()
            ident = Identity.from_name("fo-server7")
            server, p1, p2 = await start_network(hub, ident,
                                                 slow_first=False)
            p1.backend = RestartingBackend()
            client = SymmetryClient(Identity.from_name("fo-cli7"), hub)
            server.registry.set_connections(p2.identity.public_hex, 5)

            details = await client.request_provider(
                "mem://server", ident.public_key, "tiny:fo")
            assert details.peer_key == p1.identity.public_hex
            session = await client.connect(details)
            try:
                with pytest.raises(ProviderRestartingError) as exc_info:
                    async for _ in session.chat(
                            [{"role": "user", "content": "x"}]):
                        pass
                assert exc_info.value.retry_after_s == 1.5
                assert isinstance(exc_info.value, ProviderBusyError)
            finally:
                await session.close()
            await p1.stop(drain_timeout_s=1)
            await p2.stop(drain_timeout_s=1)
            await server.stop()

        run(main())

    def test_draining_provider_sheds_structurally_and_fails_over(self):
        """provider.py used to refuse new connections while draining by
        silently closing them — the dialer hung in its handshake until a
        timeout. Now the refusal is a structured busy/draining shed after
        a completed handshake: a direct client fails FAST with a
        retryable error, and chat_failover completes on the survivor."""
        async def main():
            hub = MemoryTransport()
            ident = Identity.from_name("fo-server8")
            server, p1, p2 = await start_network(hub, ident,
                                                 slow_first=False)
            client = SymmetryClient(Identity.from_name("fo-cli8"), hub)
            server.registry.set_connections(p2.identity.public_hex, 5)

            p1._draining = True  # drain began; in-flight would continue

            # Direct: the refusal must arrive fast and be retryable —
            # the structured busy/draining error, or (if the close
            # outraces the client's send) a gone/connection error; never
            # a silent multi-second hang.
            t0 = time.monotonic()
            details = await client.request_provider(
                "mem://server", ident.public_key, "tiny:fo")
            assert details.peer_key == p1.identity.public_hex
            with pytest.raises((ProviderBusyError, ProviderGoneError,
                                ConnectionError, OSError)):
                session = await client.connect(details)
                try:
                    async for _ in session.chat(
                            [{"role": "user", "content": "x"}]):
                        pass
                finally:
                    await session.close()
            assert time.monotonic() - t0 < 5.0
            assert p1.metrics["shed"] >= 1

            # Failover: the draining provider costs one fast attempt.
            events = []
            async for item in client.chat_failover(
                    "mem://server", ident.public_key, "tiny:fo",
                    [{"role": "user", "content": "drain path"}]):
                events.append(item)
            assert "".join(e for e in events
                           if isinstance(e, str)) == "drain path"
            await p1.stop(drain_timeout_s=1)
            await p2.stop(drain_timeout_s=1)
            await server.stop()

        run(main())

    def test_expired_deadline_shed_is_terminal_not_retried(self):
        """deadline_s <= 0 on arrival: the provider sheds with the
        structured expired error, the client raises the non-retryable
        DeadlineExceededError, and failover does NOT burn the second
        provider on an answer nobody awaits."""
        async def main():
            hub = MemoryTransport()
            ident = Identity.from_name("fo-server9")
            server, p1, p2 = await start_network(hub, ident,
                                                 slow_first=False)
            client = SymmetryClient(Identity.from_name("fo-cli9"), hub)
            server.registry.set_connections(p2.identity.public_hex, 5)

            details = await client.request_provider(
                "mem://server", ident.public_key, "tiny:fo")
            session = await client.connect(details)
            try:
                with pytest.raises(DeadlineExceededError):
                    async for _ in session.chat(
                            [{"role": "user", "content": "x"}],
                            deadline_s=0):
                        pass
            finally:
                await session.close()
            assert p1.metrics["shed"] == 1

            with pytest.raises(DeadlineExceededError):
                async for _ in client.chat_failover(
                        "mem://server", ident.public_key, "tiny:fo",
                        [{"role": "user", "content": "x"}], deadline_s=0):
                    pass
            assert p2.metrics["requests"] == 0  # never failed over
            await p1.stop(drain_timeout_s=1)
            await p2.stop(drain_timeout_s=1)
            await server.stop()

        run(main())

    def test_busy_retry_rounds_zero_disables_retry(self):
        """The retry-round cap: busy_retry_rounds=0 fails a fully-shed
        pool after ONE round (2 sheds), where the default would come
        back for a second."""
        async def main():
            hub = MemoryTransport()
            ident = Identity.from_name("fo-server10")
            server, p1, p2 = await start_network(hub, ident,
                                                 slow_first=False)
            for prov in (p1, p2):
                prov.backend.slots = 0
                prov.backend.queue_limit = 0
            client = SymmetryClient(Identity.from_name("fo-cli10"), hub)

            with pytest.raises(ClientError, match="chat failed"):
                async for _ in client.chat_failover(
                        "mem://server", ident.public_key, "tiny:fo",
                        [{"role": "user", "content": "x"}],
                        busy_retry_rounds=0):
                    pass
            assert p1.metrics["shed"] + p2.metrics["shed"] == 2

            with pytest.raises(ClientError, match="chat failed"):
                async for _ in client.chat_failover(
                        "mem://server", ident.public_key, "tiny:fo",
                        [{"role": "user", "content": "x"}]):
                    pass
            # default: one jittered retry round re-tried both providers
            assert p1.metrics["shed"] + p2.metrics["shed"] == 4
            await p1.stop(drain_timeout_s=1)
            await p2.stop(drain_timeout_s=1)
            await server.stop()

        run(main())

    def test_failover_exhaustion_raises(self):
        async def main():
            hub = MemoryTransport()
            ident = Identity.from_name("fo-server3")
            server = SymmetryServer(ident, hub, ping_interval_s=30.0)
            await server.start("mem://server")
            client = SymmetryClient(Identity.from_name("fo-cli3"), hub)
            with pytest.raises(ClientError, match="chat failed"):
                async for _ in client.chat_failover(
                        "mem://server", ident.public_key, "tiny:none",
                        [{"role": "user", "content": "x"}]):
                    pass
            await server.stop()

        run(main())


class TestBusyRetryBackoff:
    """The jittered backoff formula (client.busy_retry_backoff): herd
    desynchronization is load-bearing for recovering providers, so the
    bounds are pinned."""

    def test_jitter_bounds(self):
        lo = busy_retry_backoff(4, 4, rand=lambda: 0.0)
        hi = busy_retry_backoff(4, 4, rand=lambda: 1.0)
        assert lo == pytest.approx(0.25)   # 0.5 × base 0.5
        assert hi == pytest.approx(0.75)   # 1.5 × base 0.5
        # jitter actually varies across calls with the real RNG
        vals = {round(busy_retry_backoff(4, 4), 6) for _ in range(16)}
        assert len(vals) > 1

    def test_round_escalation_doubles_base_with_ceiling(self):
        r0 = busy_retry_backoff(4, 4, round_idx=0, rand=lambda: 0.5)
        r1 = busy_retry_backoff(4, 4, round_idx=1, rand=lambda: 0.5)
        assert r1 == pytest.approx(2 * r0)
        # escalation is capped: many-round persistence must not become
        # quarter-hour sleeps
        r9 = busy_retry_backoff(4, 4, round_idx=9, rand=lambda: 0.5)
        assert r9 == pytest.approx(
            busy_retry_backoff(4, 4, round_idx=4, rand=lambda: 0.5))
        assert r9 <= 32.0

    def test_retry_after_hint_is_a_hard_floor(self):
        # The hint is ADDED under the jittered wait — even minimal
        # jitter can never schedule the retry before the provider's own
        # respawn ETA (that retry would be shed with certainty).
        v = busy_retry_backoff(0, 4, retry_after_s=3.0, rand=lambda: 0.0)
        assert v >= 3.0
        assert v == pytest.approx(3.125)  # 3.0 + 0.5 × base 0.25

    def test_depth_scales_and_caps(self):
        shallow = busy_retry_backoff(0, 8, rand=lambda: 0.5)
        deep = busy_retry_backoff(800, 8, rand=lambda: 0.5)
        assert shallow < deep <= 2.0  # capped base, never a self-stall

    def test_retry_after_hint_clamps_round_doubling(self):
        """Resume rounds must honor a restarting provider's hint, not
        amplify it: with retryAfterS present the per-round doubling is
        clamped to the round-0 base — the wait at round 3 equals the
        wait at round 0 plus the hint, instead of 8x the base on top."""
        r0 = busy_retry_backoff(4, 4, round_idx=0, retry_after_s=2.0,
                                rand=lambda: 0.5)
        r3 = busy_retry_backoff(4, 4, round_idx=3, retry_after_s=2.0,
                                rand=lambda: 0.5)
        assert r3 == pytest.approx(r0)
        assert r3 == pytest.approx(2.0 + 0.5)  # hint + un-doubled base
        # without the hint the same round still doubles (depth is the
        # only signal there)
        assert busy_retry_backoff(4, 4, round_idx=3, rand=lambda: 0.5) \
            == pytest.approx(8 * 0.5)


class PartialEchoBackend(InferenceBackend):
    """Echo that dies mid-stream: streams the first `die_after` words of
    the prompt, then raises the restarting shed — the mid-stream failure
    whose emitted text IS a prefix of a healthy echo's completion, so a
    resume on a survivor must splice byte-identically. With die_after
    beyond the prompt it is just a slow resumable echo (the hard-drop
    tests kill the connection from outside instead)."""

    name = "partial-echo"
    supports_resume = True

    def __init__(self, die_after=3, delay=0.01) -> None:
        self._die_after = die_after
        self._delay = delay

    async def start(self) -> None: ...

    async def stop(self) -> None: ...

    async def healthy(self) -> bool:
        return True

    async def stream(self, request):
        last_user = ""
        for m in reversed(request.messages):
            if m.get("role") == "user":
                last_user = m.get("content", "")
                break
        words = last_user.split(" ")
        skip_chars = len(request.resume_text or "")
        for i, word in enumerate(words):
            if i >= self._die_after:
                raise BackendRestartingError(
                    "engine host restarting", retry_after_s=0.01)
            token = word if i == 0 else " " + word
            if skip_chars >= len(token):
                skip_chars -= len(token)
                continue
            await asyncio.sleep(self._delay)
            yield StreamChunk(
                raw=f"data: {{\"choices\": [{{\"delta\": "
                    f"{{\"content\": \"{token}\"}}}}]}}",
                text=token, tokens=1)


class NoResumeEchoBackend(InferenceBackend):
    """Healthy echo that does NOT support resumption (the proxy-backend
    shape): the provider must REFUSE a resume against it and the client
    must fall back to a from-scratch restart."""

    name = "no-resume-echo"
    supports_resume = False

    async def start(self) -> None: ...

    async def stop(self) -> None: ...

    async def healthy(self) -> bool:
        return True

    async def stream(self, request):
        last_user = ""
        for m in reversed(request.messages):
            if m.get("role") == "user":
                last_user = m.get("content", "")
                break
        for i, word in enumerate(last_user.split(" ")):
            token = word if i == 0 else " " + word
            yield StreamChunk(
                raw=f"data: {{\"choices\": [{{\"delta\": "
                    f"{{\"content\": \"{token}\"}}}}]}}",
                text=token, tokens=1)


class TestResumeFailover:
    """The tentpole: a mid-stream retryable failure CONTINUES on the
    next provider from the last received token — ChatResume, spliced
    byte-identical, never a discarded partial."""

    PROMPT = "resumable streams splice the continuation byte exact"

    async def _network(self, hub, ident, p1_backend, p2_backend=None):
        server = SymmetryServer(ident, hub, ping_interval_s=30.0)
        await server.start("mem://server")
        p1 = SymmetryProvider(
            provider_config(ident.public_hex, "re-p1"), transport=hub,
            identity=Identity.from_name("re-p1"), backend=p1_backend,
            server_address="mem://server")
        await p1.start("mem://re-p1")
        await p1.wait_registered()
        p2 = SymmetryProvider(
            provider_config(ident.public_hex, "re-p2"), transport=hub,
            identity=Identity.from_name("re-p2"), backend=p2_backend,
            server_address="mem://server")
        await p2.start("mem://re-p2")
        await p2.wait_registered()
        server.registry.set_connections(p2.identity.public_hex, 5)
        return server, p1, p2

    def test_restarting_mid_stream_resumes_on_other_peer(self):
        """Mid-stream restarting shed → resume lands on the OTHER peer
        (the dying one is excluded from the immediate round), carries
        the provider's stamped emitted count, and the spliced transcript
        equals the uninterrupted completion byte for byte."""
        async def main():
            hub = MemoryTransport()
            ident = Identity.from_name("re-server1")
            server, p1, p2 = await self._network(
                hub, ident, PartialEchoBackend(die_after=3))
            client = SymmetryClient(Identity.from_name("re-cli1"), hub)

            events = []
            async for item in client.chat_failover(
                    "mem://server", ident.public_key, "tiny:fo",
                    [{"role": "user", "content": self.PROMPT}]):
                events.append(item)

            resumes = [e for e in events if isinstance(e, ChatResume)]
            assert len(resumes) == 1, events
            assert not any(isinstance(e, ChatRestart) for e in events)
            # satellite: the resume landed on a DIFFERENT peer
            assert resumes[0].provider_key == p2.identity.public_hex
            # the shed's journal-stamped count rode through: 3 words
            assert resumes[0].resumed_tokens == 3
            final = "".join(e for e in events if isinstance(e, str))
            assert final == self.PROMPT, final
            # and the splice duplicated nothing: pre-cut + post-cut
            cut = events.index(resumes[0])
            pre = "".join(e for e in events[:cut] if isinstance(e, str))
            post = "".join(e for e in events[cut:] if isinstance(e, str))
            assert pre + post == self.PROMPT
            assert pre  # the failure really was mid-stream
            await p1.stop(drain_timeout_s=1)
            await p2.stop(drain_timeout_s=1)
            await server.stop()

        run(main())

    def test_hard_death_mid_stream_resumes(self):
        """A hard connection drop (no error frame, no token stamp):
        ProviderDiedMidStreamError carries the text, the token count is
        re-derived server-side, and the splice is still byte-identical."""
        async def main():
            hub = MemoryTransport()
            ident = Identity.from_name("re-server2")
            server, p1, p2 = await self._network(
                hub, ident, SlowBackend(delay=0.02, n=100))
            # p1 streams w0 w1 … — NOT a prefix of p2's echo, so for
            # this test p1 must echo too: replace its backend.
            p1.backend = PartialEchoBackend(die_after=100, delay=0.02)
            client = SymmetryClient(Identity.from_name("re-cli2"), hub)

            events = []

            async def chat():
                async for item in client.chat_failover(
                        "mem://server", ident.public_key, "tiny:fo",
                        [{"role": "user", "content": self.PROMPT}]):
                    events.append(item)

            async def killer():
                while not p1._in_flight:
                    await asyncio.sleep(0.01)
                await asyncio.sleep(0.08)
                for peer in list(p1._client_peers):
                    await peer.close()
                await p1.stop(drain_timeout_s=0)

            await asyncio.gather(chat(), killer())

            resumes = [e for e in events if isinstance(e, ChatResume)]
            assert len(resumes) == 1, events
            assert resumes[0].provider_key == p2.identity.public_hex
            final = "".join(e for e in events if isinstance(e, str))
            assert final == self.PROMPT, final
            await p2.stop(drain_timeout_s=1)
            await server.stop()

        run(main())

    def test_resume_refused_falls_back_to_restart(self):
        """A survivor whose backend cannot resume (proxy shape) refuses
        the resume with a structured marker; the client falls back ONCE
        to a from-scratch restart and still completes correctly."""
        async def main():
            hub = MemoryTransport()
            ident = Identity.from_name("re-server3")
            server, p1, p2 = await self._network(
                hub, ident, PartialEchoBackend(die_after=3),
                p2_backend=NoResumeEchoBackend())
            client = SymmetryClient(Identity.from_name("re-cli3"), hub)

            events = []
            async for item in client.chat_failover(
                    "mem://server", ident.public_key, "tiny:fo",
                    [{"role": "user", "content": self.PROMPT}]):
                events.append(item)

            # one resume ATTEMPT was made and refused; the fallback
            # restart voids the partial text and regenerates whole
            restarts = [e for e in events if isinstance(e, ChatRestart)]
            assert len(restarts) == 1, events
            final = "".join(
                e for e in events[events.index(restarts[-1]) + 1:]
                if isinstance(e, str))
            assert final == self.PROMPT, final
            await p1.stop(drain_timeout_s=1)
            await p2.stop(drain_timeout_s=1)
            await server.stop()

        run(main())

    def test_resume_false_restores_legacy_restart(self):
        async def main():
            hub = MemoryTransport()
            ident = Identity.from_name("re-server4")
            server, p1, p2 = await self._network(
                hub, ident, PartialEchoBackend(die_after=3))
            client = SymmetryClient(Identity.from_name("re-cli4"), hub)

            events = []
            async for item in client.chat_failover(
                    "mem://server", ident.public_key, "tiny:fo",
                    [{"role": "user", "content": self.PROMPT}],
                    resume=False):
                events.append(item)

            assert any(isinstance(e, ChatRestart) for e in events)
            assert not any(isinstance(e, ChatResume) for e in events)
            restarts = [e for e in events if isinstance(e, ChatRestart)]
            final = "".join(
                e for e in events[events.index(restarts[-1]) + 1:]
                if isinstance(e, str))
            assert final == self.PROMPT
            await p1.stop(drain_timeout_s=1)
            await p2.stop(drain_timeout_s=1)
            await server.stop()

        run(main())

    def test_text_failover_splices_resume(self):
        """chat_text_failover keeps parts across a ChatResume (and the
        result equals the uninterrupted completion)."""
        async def main():
            hub = MemoryTransport()
            ident = Identity.from_name("re-server5")
            server, p1, p2 = await self._network(
                hub, ident, PartialEchoBackend(die_after=4))
            client = SymmetryClient(Identity.from_name("re-cli5"), hub)
            text = await client.chat_text_failover(
                "mem://server", ident.public_key, "tiny:fo",
                [{"role": "user", "content": self.PROMPT}])
            assert text == self.PROMPT
            await p1.stop(drain_timeout_s=1)
            await p2.stop(drain_timeout_s=1)
            await server.stop()

        run(main())

    def test_mid_stream_errors_carry_emitted_state(self):
        """Direct-session contract: ProviderRestartingError mid-stream
        carries the emitted text + the provider's stamped token count;
        ProviderDiedMidStreamError (hard drop) carries the text with
        tokens None."""
        async def main():
            hub = MemoryTransport()
            ident = Identity.from_name("re-server6")
            server, p1, p2 = await self._network(
                hub, ident, PartialEchoBackend(die_after=2))
            client = SymmetryClient(Identity.from_name("re-cli6"), hub)
            details = await client.request_provider(
                "mem://server", ident.public_key, "tiny:fo",
                exclude=[p2.identity.public_hex])
            assert details.peer_key == p1.identity.public_hex
            session = await client.connect(details)
            got = []
            with pytest.raises(ProviderRestartingError) as exc_info:
                async for d in session.chat(
                        [{"role": "user", "content": self.PROMPT}]):
                    got.append(d)
            await session.close()
            exc = exc_info.value
            assert exc.emitted_text == "".join(got)
            assert exc.emitted_tokens == 2
            assert exc.emitted_text == "resumable streams"
            await p1.stop(drain_timeout_s=1)
            await p2.stop(drain_timeout_s=1)
            await server.stop()

        run(main())

    def test_hard_drop_direct_session_raises_died_mid_stream(self):
        """A connection that just dies mid-stream (no error frame at
        all) surfaces as ProviderDiedMidStreamError with the received
        text and tokens None (nothing stamped it)."""
        async def main():
            hub = MemoryTransport()
            ident = Identity.from_name("re-server7")
            server, p1, p2 = await self._network(
                hub, ident, PartialEchoBackend(die_after=100, delay=0.03))
            client = SymmetryClient(Identity.from_name("re-cli7"), hub)
            details = await client.request_provider(
                "mem://server", ident.public_key, "tiny:fo",
                exclude=[p2.identity.public_hex])
            session = await client.connect(details)
            got = []

            async def chat():
                with pytest.raises(ProviderDiedMidStreamError) as ei:
                    async for d in session.chat(
                            [{"role": "user", "content": self.PROMPT}]):
                        got.append(d)
                assert ei.value.emitted_text == "".join(got)
                assert ei.value.emitted_tokens is None
                assert got, "drop landed before anything streamed"

            async def killer():
                while len(got) < 2:
                    await asyncio.sleep(0.01)
                for peer in list(p1._client_peers):
                    await peer.close()

            await asyncio.gather(chat(), killer())
            await session.close()
            await p1.stop(drain_timeout_s=1)
            await p2.stop(drain_timeout_s=1)
            await server.stop()

        run(main())
