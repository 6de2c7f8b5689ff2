"""symscale controller suite: the SLO-goodput autoscaler.

Two layers, mirroring the pool's own tests:

  - PoolAutoscaler UNIT suite against a pure-state PoolRouter with an
    injectable clock — every policy rule (burn spawn, queue spawn,
    dwell, churn cooldown, measured-ratio rebalance, floor/ceiling,
    idle drain) drives in microseconds with no sleeps.
  - Chip-second accounting on the router (the goodput denominator).
  - A fake-host pool E2E: a real TpuNativeBackend in pool mode over
    protocol-faithful fake engine hosts, where an SLO burn spike makes
    the autoscaler SPAWN a real prefill member mid-traffic with zero
    in-flight sheds — the telemetry → topology loop closed end to end.
"""

import asyncio
import os
import sys
import time
import uuid

from symmetry_tpu_torch.engine.disagg.autoscale import (
    AutoscaleConfig,
    PoolAutoscaler,
)
from symmetry_tpu_torch.engine.disagg.pool import MemberState, PoolRouter
from symmetry_tpu_torch.utils.metrics import SloMonitor

FAKE_HOST = os.path.join(os.path.dirname(__file__), "fake_host.py")


def run_async(coro, timeout=60):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, timeout))
    finally:
        loop.close()


def _pool(t, m_prefill=1, n_decode=1):
    """Healthy pool on an injectable clock (`t` is a one-element list)."""
    r = PoolRouter(clock=lambda: t[0])
    for i in range(m_prefill):
        r.add_member(f"p{i}", "prefill")
        r.mark_healthy(f"p{i}")
    for i in range(n_decode):
        r.add_member(f"d{i}", "decode")
        r.mark_healthy(f"d{i}")
    return r


def _asc(t, router, **overrides):
    cfg = {"dwell_s": 10.0, "churn_cooldown_s": 60.0, "max_members": 4,
           "drain_ticks": 3, **overrides}
    return PoolAutoscaler(AutoscaleConfig(cfg), router,
                          clock=lambda: t[0])


class TestAutoscalerSpawn:
    def test_ttft_burn_spawns_prefill(self):
        t = [0.0]
        asc = _asc(t, _pool(t))
        d = asc.tick(burn={"ttft": 5.0})
        assert d["action"] == "spawn" and d["tier"] == "prefill"
        assert asc.counters["spawns"] == 1
        assert asc.target == {"prefill": 2, "decode": 1}

    def test_inter_chunk_burn_spawns_decode(self):
        t = [0.0]
        asc = _asc(t, _pool(t))
        d = asc.tick(burn={"inter_chunk": 3.0})
        assert d["action"] == "spawn" and d["tier"] == "decode"

    def test_worse_pressure_wins(self):
        t = [0.0]
        asc = _asc(t, _pool(t))
        d = asc.tick(burn={"ttft": 2.0, "inter_chunk": 8.0})
        assert d["tier"] == "decode"

    def test_queue_load_spawns_without_burn(self):
        # The load gauge is an instant sample (burn is already a
        # windowed rate): a queue spawn needs spawn_queue_ticks
        # consecutive over-threshold ticks, not one spike.
        t = [0.0]
        r = _pool(t)
        r.update_gauges("p0", queue_depth=5.0)
        asc = _asc(t, r)
        for _ in range(2):
            assert asc.tick()["action"] == "hold"
            t[0] += 0.5
        d = asc.tick()
        assert d["action"] == "spawn" and d["tier"] == "prefill"
        assert d["inputs"]["avg_load"]["prefill"] == 5.0

    def test_transient_queue_spike_never_spawns(self):
        # A clump that drains within a heartbeat resets the pressure
        # streak — no member boot for a queue that already vanished.
        t = [0.0]
        r = _pool(t)
        asc = _asc(t, r)
        for _ in range(6):
            r.update_gauges("p0", queue_depth=5.0)
            assert asc.tick()["action"] == "hold"
            t[0] += 0.5
            r.update_gauges("p0", queue_depth=0.0)
            assert asc.tick()["action"] == "hold"
            t[0] += 0.5
        assert asc.counters["spawns"] == 0
        assert asc.stats()["press_ticks"]["prefill"] == 0

    def test_ceiling_blocks_spawn(self):
        t = [0.0]
        asc = _asc(t, _pool(t), max_members=1)
        d = asc.tick(burn={"ttft": 9.0})
        assert d["action"] == "hold"
        assert asc.counters["spawns"] == 0

    def test_remote_peers_never_grow_prefill(self):
        t = [0.0]
        asc = PoolAutoscaler(AutoscaleConfig({"dwell_s": 0.0}),
                             _pool(t), clock=lambda: t[0],
                             grow_prefill=False)
        d = asc.tick(burn={"ttft": 9.0})
        assert d["action"] == "hold"
        # decode pressure still actuates
        d = asc.tick(burn={"inter_chunk": 9.0})
        assert d["action"] == "spawn" and d["tier"] == "decode"


class TestAutoscalerHysteresis:
    def test_dwell_gates_consecutive_actions(self):
        t = [0.0]
        asc = _asc(t, _pool(t), dwell_s=10.0)
        assert asc.tick(burn={"ttft": 5.0})["action"] == "spawn"
        t[0] = 1.0
        d = asc.tick(burn={"ttft": 5.0})
        assert d["action"] == "hold" and "dwell" in d["reason"]
        assert asc.counters["dwell_holds"] == 1
        t[0] = 11.0
        assert asc.tick(burn={"ttft": 5.0})["action"] == "spawn"
        assert asc.counters["spawns"] == 2

    def test_churn_cooldown_pauses_scaling(self):
        t = [0.0]
        asc = _asc(t, _pool(t), churn_cooldown_s=60.0)
        asc.note_churn()
        t[0] = 1.0
        d = asc.tick(burn={"ttft": 9.0})
        assert d["action"] == "hold" and d["reason"] == "churn_cooldown"
        assert asc.counters["cooldown_holds"] == 1
        t[0] = 61.0
        assert asc.tick(burn={"ttft": 9.0})["action"] == "spawn"

    def test_churn_is_not_a_scaling_decision(self):
        """A supervisor respawn must never inflate the decision
        counter — symtop's SCALE column means 'the shape moved'."""
        t = [0.0]
        asc = _asc(t, _pool(t))
        asc.note_churn()
        asc.note_churn()
        assert asc.counters["churn_cooldowns"] == 2
        assert asc.counters["spawns"] == 0
        assert asc.counters["drains"] == 0
        assert asc.decision_log() == []  # records come from ticks only

    def test_applying_holds(self):
        t = [0.0]
        asc = _asc(t, _pool(t))
        d = asc.tick(burn={"ttft": 9.0}, applying=True)
        assert d["action"] == "hold"
        assert d["reason"] == "applying_previous_decision"


class TestAutoscalerDrain:
    def test_idle_tier_drains_idlest_member(self):
        t = [0.0]
        r = _pool(t, m_prefill=2)
        r.update_gauges("p0", queue_depth=1.0)  # p1 is the idlest
        asc = _asc(t, r, drain_ticks=3, drain_load=1.0)
        for i in range(2):
            t[0] = float(i)
            assert asc.tick()["action"] == "hold"
        t[0] = 2.0
        d = asc.tick()
        assert d["action"] == "drain"
        assert d["tier"] == "prefill" and d["member"] == "p1"
        assert asc.target["prefill"] == 1

    def test_floor_never_drains_last_member(self):
        t = [0.0]
        asc = _asc(t, _pool(t), drain_ticks=2)
        for i in range(8):
            t[0] = float(i)
            assert asc.tick()["action"] == "hold"
        assert asc.counters["drains"] == 0

    def test_applying_freezes_idle_streak(self):
        # A member boot takes seconds of heartbeats; the tier must not
        # bank idleness credit while the spawn is still in flight, or
        # the new member is drained the instant it joins.
        t = [0.0]
        asc = _asc(t, _pool(t, m_prefill=2), drain_ticks=3)
        for i in range(10):
            t[0] = float(i)
            assert asc.tick(applying=True)["action"] == "hold"
        assert asc.counters["drains"] == 0
        for i in range(3):
            t[0] = 20.0 + i
            d = asc.tick()
        assert d["action"] == "drain"

    def test_membership_change_resets_idle_streak(self):
        # A tier whose membership just changed restarts observation:
        # the fresh topology earns a full drain_ticks window before the
        # idlest member can be given back.
        t = [0.0]
        r = _pool(t, m_prefill=2)
        asc = _asc(t, r, drain_ticks=3)
        for i in range(2):
            t[0] = float(i)
            asc.tick()
        r.add_member("p9", "prefill")
        r.mark_healthy("p9")
        t[0] = 20.0
        assert asc.tick()["action"] == "hold"  # streak reset on join
        for i in range(3):
            t[0] = 21.0 + i
            d = asc.tick()
        assert d["action"] == "drain"
        assert asc.counters["drains"] == 1

    def test_burning_tier_is_not_idle(self):
        t = [0.0]
        asc = _asc(t, _pool(t, m_prefill=2), drain_ticks=2,
                   max_members=2)
        for i in range(6):
            t[0] = float(i)
            # burn below spawn threshold but above the idle cutoff
            # (spawn_burn/2): the streak must never start
            d = asc.tick(burn={"ttft": 0.8})
        assert d["action"] == "hold"
        assert asc.counters["drains"] == 0


class TestAutoscalerRebalance:
    def test_measured_ratio_moves_a_member(self):
        t = [0.0]
        asc = _asc(t, _pool(t, m_prefill=2, n_decode=2))
        d = asc.tick(busy_delta_s={"prefill": 0.9, "decode": 0.1})
        assert d["action"] == "rebalance"
        assert d["spawn_tier"] == "prefill"
        assert d["drain_tier"] == "decode"
        assert d["member"] in ("d0", "d1")
        assert asc.counters["rebalances"] == 1
        assert asc.target == {"prefill": 3, "decode": 1}

    def test_balanced_ratio_holds(self):
        t = [0.0]
        asc = _asc(t, _pool(t, m_prefill=2, n_decode=2))
        d = asc.tick(busy_delta_s={"prefill": 0.5, "decode": 0.5})
        assert d["action"] == "hold"

    def test_noise_floor_gates_rebalance(self):
        t = [0.0]
        asc = _asc(t, _pool(t, m_prefill=2, n_decode=2),
                   min_busy_s=0.5)
        d = asc.tick(busy_delta_s={"prefill": 0.01, "decode": 0.001})
        assert d["action"] == "hold"

    def test_loaded_shrink_tier_blocks_rebalance(self):
        t = [0.0]
        r = _pool(t, m_prefill=2, n_decode=2)
        r.update_gauges("d0", queue_depth=1.0)
        r.update_gauges("d1", queue_depth=1.0)  # decode busy: avg 1.0
        asc = _asc(t, r)
        d = asc.tick(busy_delta_s={"prefill": 0.9, "decode": 0.1})
        assert d["action"] == "hold"


class TestDecisionRecords:
    def test_every_tick_books_a_record(self):
        t = [0.0]
        asc = _asc(t, _pool(t))
        asc.tick()
        asc.tick(burn={"ttft": 9.0})
        log = asc.decision_log()
        assert [d["action"] for d in log] == ["hold", "spawn"]
        for d in log:
            assert {"t", "action", "reason", "inputs",
                    "chip_s", "goodput_tokens_per_chip_s"} <= set(d)
        assert log[1]["inputs"]["burn"]["prefill"] == 9.0

    def test_goodput_at_decision(self):
        t = [0.0]
        r = _pool(t)
        t[0] = 10.0  # 2 members alive 10 s → 20 chip-seconds
        asc = _asc(t, r)
        d = asc.tick(tokens_total=100.0)
        assert d["chip_s"] == 20.0
        assert d["goodput_tokens_per_chip_s"] == 5.0

    def test_stats_shape(self):
        t = [0.0]
        asc = _asc(t, _pool(t))
        asc.tick()
        st = asc.stats()
        assert st["ticks"] == 1 and st["holds"] == 1
        assert st["target"] == {"prefill": 1, "decode": 1}
        assert st["config"]["max_members"] == 4
        assert len(st["decisions"]) == 1
        assert "inputs" not in st["decisions"][0]  # stats tail is slim
        assert st["actions"] == []  # holds never make the action tail


class TestChipSeconds:
    def test_alive_time_accumulates_and_loss_pauses(self):
        t = [0.0]
        r = PoolRouter(clock=lambda: t[0])
        r.add_member("p0", "prefill")
        r.mark_healthy("p0")
        t[0] = 10.0
        assert r.chip_seconds() == 10.0
        r.on_lost("p0")
        t[0] = 15.0
        assert r.chip_seconds() == 10.0  # lost members burn no chip
        r.mark_healthy("p0")  # rejoin reopens the interval
        t[0] = 18.0
        assert r.chip_seconds() == 13.0

    def test_retire_banks_chip_seconds(self):
        t = [0.0]
        r = _pool(t)
        t[0] = 5.0
        assert r.retire("d0") is True
        assert r.get("d0") is None
        t[0] = 50.0
        # retired member's 5 s stay banked; p0 keeps accumulating
        assert r.chip_seconds() == 55.0
        assert r.counters["retires"] == 1
        st = r.stats()
        assert st["chip_seconds"] == 55.0
        assert set(st["members"]) == {"p0"}

    def test_retire_refused_while_in_flight(self):
        t = [0.0]
        r = _pool(t)
        r.place("r1")
        assert r.retire("p0") is False
        r.note_done("r1")
        assert r.retire("p0") is True


# ---------------------------------------------------------------------
# E2E: the loop closed through the real backend against fake hosts — an
# SLO burn spike spawns a REAL prefill member (node + link + membership)
# mid-traffic, with zero in-flight sheds.


def _autoscale_backend(pool, autoscale, *, token_delay_s=0.05):
    from symmetry_tpu_torch.engine.disagg.node import PrefillNode
    from symmetry_tpu_torch.provider.backends.tpu_native import TpuNativeBackend
    from symmetry_tpu_torch.provider.config import ConfigManager

    class FakePoolBackend(TpuNativeBackend):
        def _host_argv(self, cfg_path):
            return [sys.executable, FAKE_HOST, cfg_path]

        def _node_factory(self, config, listen):
            node = PrefillNode(config, listen=listen)
            node._host_argv = lambda p: [sys.executable, FAKE_HOST, p]
            return node

    cfg = ConfigManager(config={
        "name": "scale-fake", "public": False, "serverKey": "00" * 32,
        "modelName": "fake:scale", "apiProvider": "tpu_native",
        "dataCollectionEnabled": False,
        "fakeHost": {"tokenDelayS": token_delay_s},
        "tpu": {"engine_isolation": "process", "max_batch_size": 4,
                "role": "disagg",
                "autoscale": autoscale,
                "supervisor": {"heartbeat_s": 30.0, "wedge_timeout_s": 5.0,
                               "backoff_base_s": 0.05, "backoff_max_s": 0.2,
                               "max_respawns": 2, "spawn_timeout_s": 15.0,
                               "stop_grace_s": 0.5, "min_stable_s": 0.2},
                "disagg": {"peer": f"mem://scale-{uuid.uuid4().hex[:8]}",
                           "reconnect_base_s": 0.05,
                           "pool": pool}},
    })
    return FakePoolBackend(cfg)


async def _collect_stream(backend, content, max_tokens=4):
    from symmetry_tpu_torch.provider.backends.base import InferenceRequest

    text = []
    async for chunk in backend.stream(InferenceRequest(
            messages=[{"role": "user", "content": content}],
            max_tokens=max_tokens, temperature=0.0)):
        if chunk.text:
            text.append(chunk.text)
    return "".join(text)


class TestAutoscaleBackendFake:
    def test_burn_spike_spawns_member_with_zero_sheds(self):
        async def main():
            backend = _autoscale_backend(
                {"prefill": 1, "decode": 1, "heartbeat_s": 0.15},
                {"max_members": 2, "dwell_s": 0.2,
                 "churn_cooldown_s": 10.0, "drain_ticks": 10_000})
            await backend.start()
            try:
                # The provider's SLO monitor, exactly as provider.py
                # attaches it; a burst of over-target TTFTs lights the
                # fast-window burn the heartbeat feeds the controller.
                monitor = SloMonitor({"ttft_s": 0.005, "objective": 0.9,
                                      "fast_window_s": 5.0})
                backend.attach_slo_monitor(monitor)
                for _ in range(12):
                    monitor.observe("ttft", 0.5)
                tasks = [asyncio.ensure_future(
                    _collect_stream(backend, f"req {i}"))
                    for i in range(3)]
                deadline = time.monotonic() + 15
                while time.monotonic() < deadline:
                    if backend._pool.healthy_count("prefill") == 2:
                        break
                    await asyncio.sleep(0.05)
                assert backend._pool.healthy_count("prefill") == 2, \
                    backend._pool.stats()
                done = await asyncio.gather(*tasks,
                                            return_exceptions=True)
                errs = [d for d in done if isinstance(d, Exception)]
                assert not errs, f"client-visible failures: {errs}"
                assert all(done)
                stats = await backend.engine_stats()
                pool = stats["disagg"]["pool"]
                asc = pool["autoscale"]
                assert asc["spawns"] >= 1
                assert asc["target"]["prefill"] == 2
                assert any(d["action"] == "spawn"
                           for d in asc["actions"])
                # zero sheds: nothing was re-placed or lost scaling UP
                assert pool["re_placements"] == 0
                assert pool["losses"] == 0
                assert pool["chip_seconds"] > 0
            finally:
                await backend.stop()

        run_async(main())
