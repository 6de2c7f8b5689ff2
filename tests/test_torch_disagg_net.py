"""The disaggregated tiers' network half in the port, copied from
tests/test_disagg.py with imports rewritten: the broker (per-role config
derivation, request-state migration), the cross-machine handoff link
(engine/disagg/net.py: envelope reassembly over a fragmenting transport,
nak -> retransmit, mid-transfer disconnect, credit-window backpressure,
ack-timeout exhaustion, clock reconciliation, fault seams), the pool
router and its cache affinity, the pool config, and the elastic pool
through the real backend plumbing against tests/fake_host.py. The frame
codec, tier roles and engine identity are in tests/test_torch_disagg.py.
"""

import asyncio
import random
import struct
import time

import numpy as np
import pytest

from symmetry_tpu_torch.engine.disagg import (
    DEFAULT_DECODE_PREFIX_MB,
    HandoffBroker,
    decode_kv_handoff,
    derive_role_config,
    encode_kv_handoff,
)


def gqa_arrays(L=3, K=2, D=8, p=16, dtype=np.float32):
    """kv_heads != heads — the GQA shape the frames must round-trip."""
    rng = np.random.default_rng(0)
    return {
        "k": rng.standard_normal((L, 1, p, K, D)).astype(dtype),
        "v": rng.standard_normal((L, 1, p, K, D)).astype(dtype),
    }


BASE_CFG = {
    "name": "p", "public": True, "serverKey": "00" * 32,
    "modelName": "tiny:test", "apiProvider": "tpu_native",
    "tpu": {"role": "disagg", "model_preset": "tiny",
            "max_batch_size": 4,
            "disagg": {"prefill": {"faults": {"disagg.handoff": "crash"}},
                       "decode": {"max_batch_size": 8}}},
}


class TestBroker:
    def test_derive_role_configs(self):
        pre = derive_role_config(BASE_CFG, "prefill")
        dec = derive_role_config(BASE_CFG, "decode")
        assert pre["tpu"]["role"] == "prefill"
        assert dec["tpu"]["role"] == "decode"
        # per-tier overrides land in the tier's tpu section only
        assert pre["tpu"]["max_batch_size"] == 4
        assert dec["tpu"]["max_batch_size"] == 8
        # tier faults land TOP-LEVEL on that host only
        assert pre["faults"] == {"disagg.handoff": "crash"}
        assert "faults" not in dec
        # BOTH tiers get a prefix-cache budget by default: decode for
        # adopt-by-reference, prefill so its radix tree has something
        # to gossip for cache-affine pool routing
        assert dec["tpu"]["prefix_cache_mb"] == DEFAULT_DECODE_PREFIX_MB
        assert pre["tpu"]["prefix_cache_mb"] == DEFAULT_DECODE_PREFIX_MB
        # neither derived config keeps the disagg mapping (a tier host
        # must not recurse)
        assert "disagg" not in pre["tpu"] and "disagg" not in dec["tpu"]
        # the source mapping is untouched
        assert BASE_CFG["tpu"]["role"] == "disagg"

    def test_adopt_op_migrates_state_and_rebases_deadline(self):
        broker = HandoffBroker()
        broker.note_submit("r1", {
            "op": "submit", "id": "r1", "messages": [{"role": "user"}],
            "max_new": 32, "sampling": {"temperature": 0.5, "seed": 7},
            "trace": "t-1", "deadline_s": 10.0})
        time.sleep(0.05)
        op = broker.adopt_op({"id": "r1", "p": 16, "nbytes": 1234,
                              "frame": "QUJD"})
        assert op["op"] == "adopt" and op["id"] == "r1"
        assert op["frame"] == "QUJD"
        assert op["max_new"] == 32
        assert op["sampling"] == {"temperature": 0.5, "seed": 7}
        assert op["trace"] == "t-1"
        assert "messages" not in op  # tokens ride the frame
        assert 9.0 < op["deadline_s"] < 10.0  # rebased, not reset
        assert broker.counters["handoff_frames"] == 1
        assert broker.counters["handoff_bytes"] == 1234
        assert broker.counters["prefix_tokens"] == 16
        assert broker.pending == 0
        assert broker.prefill_tier_hist.count == 1

    def test_unknown_or_forgotten_id_drops_frame(self):
        broker = HandoffBroker()
        assert broker.adopt_op({"id": "ghost", "p": 0}) is None
        broker.note_submit("r2", {"max_new": 8})
        broker.forget("r2")  # cancelled before the handoff came back
        assert broker.adopt_op({"id": "r2", "p": 0}) is None
        assert broker.counters["dropped"] == 1
        stats = broker.stats()
        assert stats["submitted"] == 1 and stats["pending"] == 0

    def test_fail_all_clears_pending(self):
        broker = HandoffBroker()
        broker.note_submit("a", {})
        broker.note_submit("b", {})
        broker.fail_all()
        assert broker.pending == 0
        assert broker.counters["dropped"] == 2


# ---------------------------------------------------------------------
# Engine roles + the token-identity contract




# ---------------------------------------------------------------------
# Cross-machine handoff link (engine/disagg/net.py)


from symmetry_tpu_torch.engine.disagg.net import (  # noqa: E402
    CreditGate,
    HandoffLink,
    LinkConfig,
    LinkDecoder,
    LinkError,
    PrefillLink,
    Reassembler,
    encode_link_msg,
    link_clock_handshake,
)
from symmetry_tpu_torch.protocol.keys import HOST_OPS, LINK_OPS, LinkOp  # noqa: E402
from symmetry_tpu_torch.transport.base import Connection  # noqa: E402
from symmetry_tpu_torch.transport.memory import memory_pair  # noqa: E402
from symmetry_tpu_torch.utils.faults import FAULTS  # noqa: E402


def run_async(coro, timeout=60):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, timeout))
    finally:
        loop.close()


class _RechunkConnection(Connection):
    """Proxy that deliberately violates every frame boundary: inbound
    bytes are re-sliced at seeded-random offsets (fragmenting AND
    coalescing), which is exactly what the link's streaming envelope
    decoder must survive."""

    def __init__(self, inner, seed=0):
        self._inner = inner
        self._rng = random.Random(seed)
        self._buf = bytearray()
        self._eof = False

    async def send(self, frame):
        await self._inner.send(frame)

    async def recv(self):
        while not self._buf:
            if self._eof:
                return None
            f = await self._inner.recv()
            if f is None:
                self._eof = True
                break
            self._buf += f
        if not self._buf:
            return None
        n = self._rng.randint(1, min(len(self._buf), 97))
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    async def close(self):
        await self._inner.close()

    @property
    def closed(self):
        return self._inner.closed


class _ManglingConnection(Connection):
    """Proxy that flips the LAST byte of the Nth outbound frame — for a
    link `chunk` message that byte is frame payload, so the transfer's
    CRC check must catch it and nak."""

    def __init__(self, inner, mangle_frame):
        self._inner = inner
        self._mangle_frame = mangle_frame
        self._n = 0

    async def send(self, frame):
        self._n += 1
        if self._n == self._mangle_frame:
            frame = frame[:-1] + bytes([frame[-1] ^ 0xFF])
        await self._inner.send(frame)

    async def recv(self):
        return await self._inner.recv()

    async def close(self):
        await self._inner.close()

    @property
    def closed(self):
        return self._inner.closed


class TestLinkEnvelope:
    def test_roundtrip_under_arbitrary_fragmentation(self):
        rng = random.Random(11)
        msgs = [({"op": "chunk", "seq": i},
                 rng.randbytes(rng.randint(0, 4096)))
                for i in range(32)]
        blob = b"".join(encode_link_msg(h, p) for h, p in msgs)
        for seed in range(3):
            r = random.Random(seed)
            dec = LinkDecoder()
            out = []
            i = 0
            while i < len(blob):
                n = r.randint(1, 513)
                out.extend(dec.feed(blob[i:i + n]))
                i += n
            assert [(h["seq"], p) for h, p in out] \
                == [(h["seq"], p) for h, p in msgs]

    def test_bad_magic_rejected(self):
        dec = LinkDecoder()
        with pytest.raises(LinkError, match="magic"):
            list(dec.feed(b"XXXX" + b"\x00" * 12))

    def test_oversized_header_rejected(self):
        bad = struct.pack("<4sII", b"SYLK", 1 << 24, 0)
        with pytest.raises(LinkError, match="too large"):
            list(LinkDecoder().feed(bad))

    def test_registry_pins_link_ops(self):
        # Every wire op the link protocol speaks is registered — the
        # wire-contract checker pivots on this set (no raw literals
        # outside tests), and the deliberate HostOp value reuse (a link
        # `submit` forwards a host `submit`) is pinned as intentional.
        # ping/pong/drain/leave are the pool-membership extensions
        # (keepalive + deliberate-churn announces).
        assert LINK_OPS == {"hello", "clock", "submit", "cancel",
                            "stats", "trace", "credit", "ack", "nak",
                            "begin", "chunk", "end", "fail", "event",
                            "ping", "pong", "drain", "leave"}
        assert LINK_OPS & HOST_OPS == {"clock", "submit", "cancel",
                                       "stats", "trace", "event"}


class _MiniDecodePump:
    """The decode side of the bulk path, driven manually: the REAL
    DecodeLink pump internals (Reassembler + credit grants + ack/nak)
    without the dial loop, so each test controls the link lifetime."""

    def __init__(self, conn, *, ack=True):
        self.link = HandoffLink(conn)
        self.reasm = Reassembler()
        self.got = []
        self.fails = []
        self.ack = ack

    async def run(self):
        while True:
            msg = await self.link.recv()
            if msg is None:
                return
            header, payload = msg
            op = header.get("op")
            try:
                if op == LinkOp.CHUNK:
                    await self.link.send({"op": LinkOp.CREDIT,
                                          "n": len(payload)})
                    self.reasm.chunk(header, payload)
                elif op == LinkOp.BEGIN:
                    self.reasm.begin(header)
                elif op == LinkOp.END:
                    meta, frame = self.reasm.end(header)
                    if self.ack:
                        self.got.append((meta, frame))
                        await self.link.send(
                            {"op": LinkOp.ACK,
                             "xfer": header.get("xfer")})
                elif op == LinkOp.FAIL:
                    self.fails.append(header)
            except LinkError as exc:
                if self.link.closed or "send failed" in str(exc):
                    return  # peer reset the link mid-message
                await self.link.send({"op": LinkOp.NAK,
                                      "xfer": header.get("xfer")})


def _plink(conn, **cfg_overrides):
    cfg = LinkConfig({"chunk_kb": 1, **cfg_overrides})
    return PrefillLink(HandoffLink(conn), cfg,
                       on_command=lambda line: None,
                       on_probe=lambda op: None)


class TestLinkTransfer:
    FRAME = encode_kv_handoff("w1", list(range(40)), 32,
                              gqa_arrays(p=32))

    def test_multi_chunk_reassembly_over_fragmenting_transport(self):
        async def main():
            a, b = memory_pair()
            pump = _MiniDecodePump(_RechunkConnection(a, seed=3))
            plink = _plink(b)
            t1 = asyncio.ensure_future(pump.run())
            t2 = asyncio.ensure_future(plink.serve())
            ok = await plink.send_handoff(
                {"id": "w1", "p": 32, "nbytes": len(self.FRAME)},
                self.FRAME)
            assert ok
            assert len(pump.got) == 1
            meta, frame = pump.got[0]
            assert frame == self.FRAME  # byte-identical after rechunking
            assert meta["id"] == "w1" and meta["len"] == len(self.FRAME)
            # ...and the reassembled bytes still parse as a valid KV
            # frame (the corruption suite's contract, now on the wire).
            h = decode_kv_handoff(frame)
            assert h.p == 32 and h.request_id == "w1"
            assert len(self.FRAME) > 1024  # genuinely multi-chunk
            t1.cancel()
            t2.cancel()

        run_async(main())

    def test_corrupt_chunk_naks_then_retransmit_succeeds(self):
        async def main():
            a, b = memory_pair()
            pump = _MiniDecodePump(a)
            # Frame #2 on the wire is attempt 1's first chunk (after
            # begin); its last byte is chunk payload → CRC mismatch at
            # end → nak → attempt 2 retransmits clean.
            plink = _plink(_ManglingConnection(b, mangle_frame=2))
            t1 = asyncio.ensure_future(pump.run())
            t2 = asyncio.ensure_future(plink.serve())
            ok = await plink.send_handoff(
                {"id": "w2", "p": 32, "nbytes": len(self.FRAME)},
                self.FRAME)
            assert ok
            assert plink.sender.stats["retries"] == 1
            assert len(pump.got) == 1 and pump.got[0][1] == self.FRAME
            # the corrupt attempt was discarded whole, never surfaced
            assert pump.reasm.stats["partial_discards"] == 1
            t1.cancel()
            t2.cancel()

        run_async(main())

    def test_mid_transfer_disconnect_discards_partial(self):
        async def main():
            FAULTS.load({"disagg.net.drop_link": "drop_frame@once"})
            try:
                a, b = memory_pair()
                pump = _MiniDecodePump(a)
                plink = _plink(b)
                t1 = asyncio.ensure_future(pump.run())
                t2 = asyncio.ensure_future(plink.serve())
                ok = await plink.send_handoff(
                    {"id": "w3", "p": 32, "nbytes": len(self.FRAME)},
                    self.FRAME)
                assert not ok  # the cable was pulled mid-transfer
                await asyncio.wait_for(t1, 5)  # pump sees EOF and exits
                # ZERO partial adoptions: nothing reached the handoff
                # callback, and the partial buffer is discarded whole.
                assert pump.got == []
                assert pump.reasm.active == 1
                assert pump.reasm.abort_all() == 1
                assert pump.reasm.active == 0
                t2.cancel()
            finally:
                FAULTS.clear()

        run_async(main())

    def test_credit_window_backpressures_sender(self):
        async def main():
            a, b = memory_pair()
            pump = _MiniDecodePump(a)
            # Window of ~one chunk: every subsequent chunk must wait
            # for the receiver's credit grant — the stall that, in the
            # real topology, propagates into prefill admissions.
            plink = _plink(b, credit_mb=1024 / 2**20)
            t1 = asyncio.ensure_future(pump.run())
            t2 = asyncio.ensure_future(plink.serve())
            ok = await plink.send_handoff(
                {"id": "w4", "p": 32, "nbytes": len(self.FRAME)},
                self.FRAME)
            assert ok
            stats = plink.stats()
            assert stats["credit_stalls"] > 0
            assert stats["credit_stall_s"] >= 0
            t1.cancel()
            t2.cancel()

        run_async(main())

    def test_ack_timeout_retries_then_fails(self):
        async def main():
            a, b = memory_pair()
            pump = _MiniDecodePump(a, ack=False)  # reassembles, never acks
            plink = _plink(b, ack_timeout_s=0.2, max_retries=1)
            t1 = asyncio.ensure_future(pump.run())
            t2 = asyncio.ensure_future(plink.serve())
            ok = await plink.send_handoff(
                {"id": "w5", "p": 32, "nbytes": len(self.FRAME)},
                self.FRAME)
            assert not ok
            assert plink.sender.stats["retries"] == 1
            assert plink.sender.stats["failed"] == 1
            await asyncio.sleep(0.05)
            assert pump.fails and pump.fails[0]["id"] == "w5"
            t1.cancel()
            t2.cancel()

        run_async(main())

    def test_clock_handshake_measures_skew(self):
        async def main():
            a, b = memory_pair()
            dialer = HandoffLink(a)
            responder = HandoffLink(b)

            async def echo_skewed():
                while True:
                    msg = await responder.recv()
                    if msg is None:
                        return
                    h, _ = msg
                    if h.get("op") == LinkOp.CLOCK:
                        await responder.send(
                            {"op": LinkOp.CLOCK, "t0": h.get("t0"),
                             "t": time.monotonic() + 5.0})

            t = asyncio.ensure_future(echo_skewed())
            offset = await link_clock_handshake(dialer)
            assert 4.9 < offset < 5.1  # the deliberate +5s skew, found
            t.cancel()

        run_async(main())

    def test_send_recv_fault_seams(self):
        async def main():
            a, b = memory_pair()
            tx = HandoffLink(b)
            rx = HandoffLink(a)
            # egress drop: the armed message vanishes on the wire
            FAULTS.load({"disagg.net.send": "drop_frame@once"})
            try:
                await tx.send({"op": LinkOp.CREDIT, "n": 1})  # dropped
                await tx.send({"op": LinkOp.CREDIT, "n": 2})
                h, _ = await rx.recv()
                assert h["n"] == 2
            finally:
                FAULTS.clear()
            # ingress drop: delivered bytes, message discarded on recv
            FAULTS.load({"disagg.net.recv": "drop_frame@once"})
            try:
                await tx.send({"op": LinkOp.CREDIT, "n": 3})  # discarded
                await tx.send({"op": LinkOp.CREDIT, "n": 4})
                h, _ = await rx.recv()
                assert h["n"] == 4
            finally:
                FAULTS.clear()

        run_async(main())


# ---------------------------------------------------------------------
# Elastic pool: router unit suite (pure state — no sockets, no procs)


from symmetry_tpu_torch.engine.disagg.pool import (  # noqa: E402
    MemberState,
    PoolConfig,
    PoolRouter,
)


def healthy_pool(m_prefill=2, n_decode=2):
    r = PoolRouter()
    for i in range(m_prefill):
        r.add_member(f"p{i}", "prefill")
        r.mark_healthy(f"p{i}")
    for i in range(n_decode):
        r.add_member(f"d{i}", "decode")
        r.mark_healthy(f"d{i}")
    return r


class TestPoolRouter:
    def test_least_loaded_placement(self):
        r = healthy_pool()
        a = r.place("r1")
        b = r.place("r2")
        assert {a, b} == {"p0", "p1"}  # spread, not pile-up
        # p0 and p1 each hold one; a third goes wherever load frees
        r.note_done("r1")
        assert r.place("r3") == a  # the emptied member wins

    def test_queue_depth_gauge_steers_placement(self):
        r = healthy_pool()
        r.update_gauges("p0", queue_depth=5)
        assert r.place("r1") == "p1"
        r.update_gauges("p1", queue_depth=9)
        assert r.place("r2") == "p0"  # 5+0 beats 9+1

    def test_burn_rate_breaks_ties(self):
        r = healthy_pool()
        r.update_gauges("p0", burn_rate=2.0)
        assert r.place("r1") == "p1"  # equal load, p0 burning budget

    def test_route_decode_releases_prefill_and_balances(self):
        r = healthy_pool()
        p = r.place("r1")
        d1 = r.route_decode("r1")
        assert r.assigned_to("r1") is None  # migration left the tier
        assert r.get(p).in_flight == set()
        r.place("r2")
        d2 = r.route_decode("r2")
        assert {d1, d2} == {"d0", "d1"}

    def test_drain_excludes_new_but_keeps_in_flight(self):
        r = healthy_pool()
        first = r.place("r1")
        r.drain(first)
        assert r.get(first).state == MemberState.DRAINING
        # in-flight work stays on the draining member...
        assert "r1" in r.get(first).in_flight
        # ...but every new placement avoids it
        for i in range(4):
            assert r.place(f"n{i}") != first
        assert r.counters["drains"] == 1
        # completion drains it naturally
        r.note_done("r1")
        assert r.get(first).in_flight == set()

    def test_dead_node_re_placement(self):
        r = healthy_pool()
        victim = r.place("r1")
        r.place("r2")  # lands on the other member
        ids = r.on_lost(victim)
        assert ids == ["r1"]
        assert r.get(victim).state == MemberState.LOST
        survivor = r.place("r1")
        assert survivor is not None and survivor != victim
        r.record_placement("r1", replacement=True)
        assert r.counters["re_placements"] == 1
        assert r.counters["losses"] == 1
        # second loss signal is idempotent — no double-shed
        assert r.on_lost(victim) == []

    def test_hot_join_and_rejoin(self):
        r = healthy_pool(m_prefill=1)
        lost = r.place("r1")
        r.on_lost(lost)
        assert r.place("r2") is None  # no survivor: caller sheds
        # hot-join: a brand-new member becomes placeable immediately
        r.add_member("p9", "prefill")
        r.mark_healthy("p9")
        assert r.place("r2") == "p9"
        # rejoin: the lost member reconnects and serves again
        r.mark_healthy(lost, node_id="node-a")
        assert r.counters["rejoins"] == 1
        assert r.get(lost).node_id == "node-a"
        assert r.place("r3") == lost  # least-loaded again

    def test_pool_of_one_degenerates_to_pair_semantics(self):
        r = healthy_pool(m_prefill=1, n_decode=1)
        # the single member takes every placement while healthy
        assert [r.place(f"r{i}") for i in range(3)] == ["p0"] * 3
        assert all(r.route_decode(f"r{i}") == "d0" for i in range(3))
        # its loss leaves nothing to re-place onto — the caller sheds
        # structured-retryable, exactly the pair's link-down behavior
        ids = r.on_lost("d0")
        assert sorted(ids) == ["r0", "r1", "r2"]
        assert r.place("r9") == "p0"  # prefill tier untouched
        assert r.route_decode("r9") is None

    def test_drain_refuses_last_healthy_member_of_tier(self):
        """Draining the LAST healthy member of a tier would leave it
        empty with no fault in sight — the router refuses and the
        caller (autoscaler, operator) must grow first."""
        r = healthy_pool(m_prefill=2, n_decode=1)
        assert r.drain("d0") is False  # sole decode member: refused
        assert r.get("d0").state is MemberState.HEALTHY
        assert r.counters["drain_refused"] == 1
        assert r.drain("p0") is True  # prefill has a survivor
        assert r.drain("p0") is True  # idempotent on a draining member
        assert r.drain("p1") is False  # p0 draining → p1 is now last
        r.add_member("p9", "prefill")
        r.mark_healthy("p9")
        assert r.drain("p1") is True  # replacement arrived: allowed

    def test_exclude_walks_past_refusing_members(self):
        r = healthy_pool(m_prefill=3)
        got = set()
        exclude = set()
        for _ in range(3):
            m = r.place("r1", exclude=exclude)
            got.add(m)
            r.release("r1")
            exclude.add(m)
        assert got == {"p0", "p1", "p2"}
        assert r.place("r1", exclude=exclude) is None

    def test_release_undoes_unsent_placement(self):
        r = healthy_pool(m_prefill=1)
        r.place("r1")
        r.release("r1")
        assert r.get("p0").in_flight == set()
        assert r.assigned_to("r1") is None
        # an unconfirmed placement never reaches the ledger — refused
        # sends must not inflate SHARE or skew the round-robin
        assert r.get("p0").placements == 0
        assert r.counters["placements"] == 0
        r.place("r1")
        r.record_placement("r1")
        assert r.get("p0").placements == 1
        assert r.counters["placements"] == 1

    def test_joining_and_lost_members_never_placed(self):
        r = PoolRouter()
        r.add_member("p0", "prefill")  # joining — not yet serving
        assert r.place("r1") is None
        r.mark_healthy("p0")
        assert r.place("r1") == "p0"

    def test_stats_shape(self):
        r = healthy_pool()
        r.place("r1")
        st = r.stats()
        assert st["healthy"] == {"prefill": 2, "decode": 2}
        assert st["in_flight"] == {"prefill": 1, "decode": 0}
        assert set(st["members"]) == {"p0", "p1", "d0", "d1"}
        m = st["members"]["p0"]
        assert {"tier", "state", "in_flight", "placements",
                "queue_depth"} <= set(m)


def _affinity_router(t, *, m_prefill=2, n_decode=2, heartbeat_s=1.0,
                     weight=1.0):
    """healthy_pool with an injectable clock (`t` is a one-element
    list) so staleness decay and gauge-age tests control time."""
    r = PoolRouter(heartbeat_s=heartbeat_s, affinity_weight=weight,
                   clock=lambda: t[0])
    for i in range(m_prefill):
        r.add_member(f"p{i}", "prefill")
        r.mark_healthy(f"p{i}")
    for i in range(n_decode):
        r.add_member(f"d{i}", "decode")
        r.mark_healthy(f"d{i}")
    return r


def _blocks(n, bs=16, base=0):
    from symmetry_tpu_torch.engine.prefix_cache import block_digests

    return block_digests([base + i for i in range(n * bs)], n * bs, bs)


class TestPoolAffinity:
    def test_predicted_hit_outbids_load(self):
        t = [0.0]
        r = _affinity_router(t)
        digests = _blocks(4)
        r.update_gauges("p0", queue_depth=0.0)
        r.update_gauges("p1", queue_depth=3.0)
        r.update_summary("p1", {"block_tokens": 16, "digests": digests})
        # p1 carries 3 queue slots but a fresh 4-block predicted hit —
        # at weight 1 the warm member wins.
        assert r.place("s1", digests=digests) == "p1"
        assert r.counters["affinity_hit"] == 1
        assert r.get("p1").hit_blocks == 4
        # no digests → pure load (p0 is empty)
        assert r.place("s2") == "p0"
        assert r.counters["affinity_load_only"] == 1

    def test_weight_zero_restores_load_only(self):
        t = [0.0]
        r = _affinity_router(t, weight=0.0)
        digests = _blocks(4)
        r.update_gauges("p1", queue_depth=3.0)
        r.update_summary("p1", {"block_tokens": 16, "digests": digests})
        assert r.place("s1", digests=digests) == "p0"
        assert r.counters["affinity_load_only"] == 1
        assert r.counters["affinity_hit"] == 0

    def test_hit_must_be_contiguous_from_block_zero(self):
        t = [0.0]
        r = _affinity_router(t)
        digests = _blocks(4)
        r.update_gauges("p1", queue_depth=0.0)
        # p1 holds only the TAIL blocks: digest 0 is missing, so the
        # radix tree can serve none of it — predicted hit 0, cold.
        r.update_summary("p1", {"block_tokens": 16,
                                "digests": digests[1:]})
        assert r.predicted_hit(r.get("p1"), digests) == 0
        r.place("s1", digests=digests)
        assert r.counters["affinity_cold"] == 1

    def test_summary_staleness_decays_to_load_only(self):
        t = [0.0]
        r = _affinity_router(t, heartbeat_s=1.0)
        digests = _blocks(2)
        r.update_gauges("p0", queue_depth=1.0)
        r.update_summary("p0", {"block_tokens": 16, "digests": digests})
        r.update_gauges("p1", queue_depth=0.0)
        # fresh: p0's 2-block hit (decay 1.0) outbids one queue slot
        assert r.place("s1", digests=digests) == "p0"
        r.note_done("s1")
        # summary ages 10 heartbeats (gauges kept fresh): decay
        # 0.5^(10/2) ≈ 0.03 → hit term ~0.06 < 1 queue slot → p1 wins.
        t[0] = 10.0
        r.update_gauges("p0", queue_depth=1.0)
        r.update_gauges("p1", queue_depth=0.0)
        assert r.place("s2", digests=digests) == "p1"

    def test_stale_gauges_exclude_member_from_affinity(self):
        """Satellite-fix pin: a member that stops heartbeating keeps
        its last summary, but once its gauges are older than two
        heartbeat periods the summary describes a cache we can no
        longer see — affinity scoring must ignore it."""
        t = [0.0]
        r = _affinity_router(t, heartbeat_s=1.0)
        digests = _blocks(3)
        r.update_gauges("p0", queue_depth=0.0)
        r.update_summary("p0", {"block_tokens": 16, "digests": digests})
        assert r.predicted_hit(r.get("p0"), digests) == 3
        t[0] = 2.5  # > 2 × heartbeat since the last gauge stamp
        assert r.predicted_hit(r.get("p0"), digests) == 0
        r.place("s1", digests=digests)
        assert r.counters["affinity_hit"] == 0
        assert r.counters["affinity_cold"] == 1

    def test_rejoin_resets_gauges_and_summary(self):
        """Satellite-fix pin: a rejoined member is a NEW process — the
        pre-loss gauges and summary must not be trusted forever. Until
        its first fresh heartbeat it scores load-only."""
        t = [0.0]
        r = _affinity_router(t)
        digests = _blocks(2)
        r.update_gauges("p0", queue_depth=9.0)
        r.update_summary("p0", {"block_tokens": 16, "digests": digests})
        r.on_lost("p0")
        r.mark_healthy("p0")
        m = r.get("p0")
        assert m.summary is None and m.summary_at is None
        assert m.gauges_at is None and m.queue_depth == 0.0
        assert r.predicted_hit(m, digests) == 0

    def test_member_loss_bumps_ledger_epoch_and_drops_summary(self):
        t = [0.0]
        r = _affinity_router(t)
        digests = _blocks(2)
        r.update_gauges("d0", queue_depth=0.0)
        r.update_summary("d0", {"block_tokens": 16, "digests": digests})
        assert r.ledger_epoch("d0") == 0
        r.on_lost("d0")
        assert r.ledger_epoch("d0") == 1
        assert r.get("d0").summary is None
        # idempotent loss: no double bump
        r.on_lost("d0")
        assert r.ledger_epoch("d0") == 1
        # rejoin serves again but the epoch stays advanced — the
        # prefill tier must drop every pre-loss ledger entry.
        r.mark_healthy("d0")
        assert r.ledger_epoch("d0") == 1

    def test_gossip_rider_round_trip(self):
        """RadixIndex.summary() → update_summary → predicted_hit: the
        digests a member's real radix tree gossips are exactly the ones
        a grown session's routing digests match against."""
        from symmetry_tpu_torch.engine.prefix_cache import (
            BlockPool, RadixIndex, block_digests)

        pool = BlockPool(64, 16, 256)
        idx = RadixIndex(pool)
        session = list(range(48))  # 3 whole blocks
        plan = idx.plan_insert(session)
        assert plan is not None
        plan.commit()
        s = idx.summary(64)
        assert s is not None and s["block_tokens"] == 16
        t = [0.0]
        r = _affinity_router(t, m_prefill=2)
        r.update_gauges("p0", queue_depth=0.0)
        r.update_summary("p0", s)
        # the session grown by another turn still matches its cached
        # whole blocks contiguously
        grown = session + list(range(100, 120))
        bs = s["block_tokens"]
        p = (len(grown) // bs) * bs
        req = block_digests(grown, p, bs)
        assert r.predicted_hit(r.get("p0"), req) == 3
        # an unrelated session shares nothing
        other = block_digests(list(range(500, 548)), 48, bs)
        assert r.predicted_hit(r.get("p0"), other) == 0

    def test_summary_cap_and_empty_walks(self):
        from symmetry_tpu_torch.engine.prefix_cache import BlockPool, RadixIndex

        pool = BlockPool(64, 16, 256)
        idx = RadixIndex(pool)
        assert idx.summary(64) is None  # empty tree gossips nothing
        plan = idx.plan_insert(list(range(64)))
        plan.commit()
        assert idx.summary(0) is None  # rider disabled
        s = idx.summary(2)
        assert len(s["digests"]) == 2  # bounded payload

    def test_planned_decode_consumed_and_survives_loss(self):
        t = [0.0]
        r = _affinity_router(t)
        planned = r.plan_decode("s1")
        assert planned in ("d0", "d1")
        assert r.planned_decode("s1") == planned
        r.place("s1")
        # the handoff routes to the member the ledger was keyed for
        assert r.route_decode("s1") == planned
        assert r.planned_decode("s1") is None  # plan consumed
        # a plan whose member dies re-picks the survivor
        planned2 = r.plan_decode("s2")
        r.place("s2")
        r.on_lost(planned2)
        got = r.route_decode("s2")
        assert got is not None and got != planned2

    def test_outstanding_plans_count_as_load(self):
        """Concurrent submits must spread: a plan books load the
        member WILL carry, or every burst would pile onto one member
        by id tie-break."""
        t = [0.0]
        r = _affinity_router(t)
        a = r.plan_decode("s1")
        b = r.plan_decode("s2")
        assert {a, b} == {"d0", "d1"}

    def test_empty_gossip_beat_keeps_old_summary_aging(self):
        t = [0.0]
        r = _affinity_router(t)
        digests = _blocks(2)
        r.update_gauges("p0", queue_depth=0.0)
        r.update_summary("p0", {"block_tokens": 16, "digests": digests})
        # a beat with no rider (old binary / cache empty) must not
        # flap the signal off — the stored summary keeps aging instead
        r.update_summary("p0", None)
        r.update_summary("p0", {"block_tokens": 16, "digests": []})
        assert r.get("p0").summary is not None
        assert r.predicted_hit(r.get("p0"), digests) == 2

    def test_pool_of_one_affinity_is_pair_semantics(self):
        t = [0.0]
        r = _affinity_router(t, m_prefill=1, n_decode=1)
        digests = _blocks(2)
        # no summary yet: placement still works (cold), ledger epoch 0
        assert r.place("s1", digests=digests) == "p0"
        assert r.plan_decode("s2", digests) == "d0"
        assert r.ledger_epoch("d0") == 0
        assert r.counters["affinity_cold"] == 1


class TestPoolConfig:
    def test_absent_means_pair_mode(self):
        assert not PoolConfig(None).enabled
        assert not PoolConfig({}).enabled
        assert not PoolConfig({"peer": "tcp://x:1"}).enabled

    def test_counts(self):
        cfg = PoolConfig({"pool": {"prefill": 3, "decode": 2,
                                   "heartbeat_s": 1.5}})
        assert cfg.enabled and cfg.prefill_count == 3
        assert cfg.decode_count == 2 and cfg.heartbeat_s == 1.5
        assert cfg.prefill_peers is None

    def test_peer_list(self):
        cfg = PoolConfig({"pool": {"prefill": ["tcp://a:1", "tcp://b:2"]}})
        assert cfg.prefill_peers == ["tcp://a:1", "tcp://b:2"]
        assert cfg.prefill_count == 2 and cfg.decode_count == 1

    def test_link_config_for_peer(self):
        base = LinkConfig({"peer": "tcp://x:1", "chunk_kb": 8,
                           "node_id": "me"})
        per = base.for_peer("tcp://y:2", heartbeat_s=2.0)
        assert per.peer == "tcp://y:2"
        assert per.chunk_bytes == base.chunk_bytes
        assert per.heartbeat_s == 2.0 and base.heartbeat_s == 0.0

    def test_member_listen_addr(self):
        from symmetry_tpu_torch.provider.backends.tpu_native import (
            TpuNativeBackend)

        f = TpuNativeBackend._member_listen_addr
        assert f("mem://pool", 1, 3) == "mem://pool-p1"
        assert f("tcp://127.0.0.1:0", 2, 3) == "tcp://127.0.0.1:0"
        assert f("tcp://10.0.0.1:4631", 0, 2) == "tcp://10.0.0.1:0"
        assert f("tcp://10.0.0.1:4631", 0, 1) == "tcp://10.0.0.1:4631"


# ---------------------------------------------------------------------
# Elastic pool through the real backend plumbing, against fake hosts:
# the full placement → link → node → handoff → adopt → stream path plus
# churn drills, in milliseconds (no JAX engine per member).


import os  # noqa: E402
import sys  # noqa: E402
import uuid  # noqa: E402

FAKE_HOST = os.path.join(os.path.dirname(__file__), "fake_host.py")


def _fake_pool_backend(pool, *, peer=None, link_extra=None,
                       token_delay_s=0.15):
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
        "name": "pool-fake", "public": False, "serverKey": "00" * 32,
        "modelName": "fake:pool", "apiProvider": "tpu_native",
        "dataCollectionEnabled": False,
        "fakeHost": {"tokenDelayS": token_delay_s},
        "tpu": {"engine_isolation": "process", "max_batch_size": 4,
                "role": "disagg",
                "supervisor": {"heartbeat_s": 30.0, "wedge_timeout_s": 5.0,
                               "backoff_base_s": 0.05, "backoff_max_s": 0.2,
                               "max_respawns": 2, "spawn_timeout_s": 15.0,
                               "stop_grace_s": 0.5, "min_stable_s": 0.2},
                "disagg": {"peer": peer or f"mem://pool-{uuid.uuid4().hex[:8]}",
                           "reconnect_base_s": 0.05,
                           "pool": pool,
                           **(link_extra or {})}},
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


class TestPoolBackendFake:
    def test_2x2_serves_and_spreads_placements(self):
        async def main():
            backend = _fake_pool_backend({"prefill": 2, "decode": 2})
            await backend.start()
            try:
                texts = await asyncio.gather(
                    *[_collect_stream(backend, f"req {i}")
                      for i in range(4)])
                assert all(texts)
                stats = await backend.engine_stats()
                pool = stats["disagg"]["pool"]
                assert pool["healthy"] == {"prefill": 2, "decode": 2}
                assert pool["re_placements"] == 0
                # placements spread: every member served at least once
                # (4 concurrent requests, least-loaded placement)
                per_node = {mid: m["placements"]
                            for mid, m in pool["members"].items()}
                assert all(per_node[f"prefill-{i}"] >= 1
                           for i in range(2)), per_node
                assert all(per_node[f"decode-{i}"] >= 1
                           for i in range(2)), per_node
                # handoff ledger rode the member links
                assert stats["disagg"]["handoff_frames"] == 4
                links = pool["links"]
                assert all(l["connected"] for l in links.values())
                assert sum(l["wire_frames"]
                           for l in links.values()) == 4
            finally:
                await backend.stop()

        run_async(main())

    def test_node_death_re_places_in_flight_on_survivor(self):
        """THE churn contract: killing one prefill member of a 2×1 pool
        mid-traffic completes every in-flight request via re-placement
        — zero failed client outcomes, zero decode-host restarts."""
        async def main():
            backend = _fake_pool_backend({"prefill": 2, "decode": 1})
            await backend.start()
            try:
                tasks = [asyncio.ensure_future(
                    _collect_stream(backend, f"req {i}"))
                    for i in range(4)]
                await asyncio.sleep(0.05)  # inside the prefill window
                await backend._inline_nodes[0].kill()  # crash, no leave
                done = await asyncio.gather(*tasks,
                                            return_exceptions=True)
                errs = [d for d in done if isinstance(d, Exception)]
                assert not errs, f"client-visible failures: {errs}"
                assert all(done)
                stats = await backend.engine_stats()
                pool = stats["disagg"]["pool"]
                states = {mid: m["state"]
                          for mid, m in pool["members"].items()}
                assert states["prefill-0"] == "lost"
                assert states["prefill-1"] == "healthy"
                assert states["decode-0"] == "healthy"
                assert pool["re_placements"] >= 1
                assert stats["supervisor"]["restarts"] == 0
            finally:
                await backend.stop()

        run_async(main())

    def test_link_cut_sheds_then_hot_rejoins(self):
        """A cable pull (link drop, node alive) re-places in-flight
        work; the reconnect loop re-establishes the link and the member
        REJOINS the placement set."""
        async def main():
            backend = _fake_pool_backend({"prefill": 2, "decode": 1})
            await backend.start()
            try:
                t = asyncio.ensure_future(
                    _collect_stream(backend, "req"))
                await asyncio.sleep(0.05)
                # hard-cut the LOADED member's link mid-flight (the
                # node survives — this is a cable pull, not a death)
                held = next(iter(backend._pool._assigned.values()),
                            "prefill-0")
                await backend._plinks[held]._link.drop("test cable pull")
                text = await asyncio.wait_for(t, 30)
                assert text  # completed through re-place or reconnect
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline:
                    if backend._pool.healthy_count("prefill") == 2:
                        break
                    await asyncio.sleep(0.05)
                stats = await backend.engine_stats()
                pool = stats["disagg"]["pool"]
                assert pool["healthy"]["prefill"] == 2, pool["members"]
                assert pool["rejoins"] >= 1
            finally:
                await backend.stop()

        run_async(main())

    def test_drain_excludes_node_and_finishes_in_flight(self):
        async def main():
            backend = _fake_pool_backend({"prefill": 2, "decode": 1})
            await backend.start()
            try:
                # one request in flight on whichever member won it
                t = asyncio.ensure_future(
                    _collect_stream(backend, "inflight"))
                await asyncio.sleep(0.05)
                held = next(iter(backend._pool._assigned.values()), None)
                idx = 0 if held == "prefill-0" else 1
                await backend._inline_nodes[idx].drain()
                deadline = time.monotonic() + 5
                while time.monotonic() < deadline:
                    m = backend._pool.get(f"prefill-{idx}")
                    if m.state == "draining":
                        break
                    await asyncio.sleep(0.02)
                assert backend._pool.get(
                    f"prefill-{idx}").state == "draining"
                # the in-flight request still completes on the drainer
                assert await asyncio.wait_for(t, 30)
                # every NEW request avoids the draining member
                texts = await asyncio.gather(
                    *[_collect_stream(backend, f"post {i}")
                      for i in range(3)])
                assert all(texts)
                stats = await backend.engine_stats()
                pool = stats["disagg"]["pool"]
                drained = pool["members"][f"prefill-{idx}"]
                other = pool["members"][f"prefill-{1 - idx}"]
                assert drained["state"] == "draining"
                assert other["placements"] >= 3
                assert pool["drains"] == 1
            finally:
                await backend.stop()

        run_async(main())

    def test_pool_of_1x1_serves_and_total_loss_sheds_retryable(self):
        """Degenerate pool: one member per tier serves like the pair;
        losing the ONLY prefill member has no survivor, so the shed is
        the structured retryable — the pair's link-down behavior."""
        from symmetry_tpu_torch.provider.backends.base import (
            BackendRestartingError)

        async def main():
            backend = _fake_pool_backend({"prefill": 1, "decode": 1})
            await backend.start()
            try:
                assert await _collect_stream(backend, "warm")
                t = asyncio.ensure_future(
                    _collect_stream(backend, "doomed"))
                await asyncio.sleep(0.05)
                await backend._inline_nodes[0].stop()
                with pytest.raises(BackendRestartingError):
                    await asyncio.wait_for(t, 30)
                # new submits shed retryable too (no healthy member)
                with pytest.raises(BackendRestartingError):
                    await _collect_stream(backend, "after")
                stats = await backend.engine_stats()
                pool = stats["disagg"]["pool"]
                assert pool["members"]["prefill-0"]["state"] == "lost"
                assert pool["healthy"]["prefill"] == 0
            finally:
                await backend.stop()

        run_async(main())

    def test_decode_member_death_sheds_only_its_streams(self):
        """Per-member supervision: a decode member's death fails only
        the streams adopted THERE (retryable), and the member respawns
        alone — its sibling keeps serving throughout."""
        async def main():
            backend = _fake_pool_backend({"prefill": 1, "decode": 2},
                                         token_delay_s=0.3)
            await backend.start()
            try:
                tasks = [asyncio.ensure_future(
                    _collect_stream(backend, f"req {i}", max_tokens=8))
                    for i in range(2)]
                # wait until both are adopted (one per decode member)
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline:
                    if len(backend._pool._adopted) == 2:
                        break
                    await asyncio.sleep(0.02)
                adopted = dict(backend._pool._adopted)
                assert set(adopted.values()) == {"decode-0", "decode-1"}
                victim = backend._decode_members["decode-0"]
                victim.proc.kill()
                done = await asyncio.gather(*tasks,
                                            return_exceptions=True)
                from symmetry_tpu_torch.provider.backends.base import (
                    BackendRestartingError)

                sheds = [d for d in done
                         if isinstance(d, BackendRestartingError)]
                texts = [d for d in done if isinstance(d, str)]
                assert len(sheds) == 1, done  # only the victim's stream
                assert len(texts) == 1 and texts[0]
                # the victim respawns alone
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline:
                    if victim.alive and victim.restarts >= 1:
                        break
                    await asyncio.sleep(0.05)
                assert victim.restarts == 1
                sibling = backend._decode_members["decode-1"]
                assert sibling.restarts == 0 and sibling.alive
                assert await _collect_stream(backend, "after")
            finally:
                await backend.stop()

        run_async(main())


class TestCreditGate:
    def test_acquire_blocks_until_grant(self):
        async def main():
            gate = CreditGate(10)
            await gate.acquire(10)  # window exhausted
            acquired = asyncio.Event()

            async def taker():
                await gate.acquire(5)
                acquired.set()

            t = asyncio.ensure_future(taker())
            await asyncio.sleep(0.02)
            assert not acquired.is_set()
            gate.grant(3)  # not enough yet
            await asyncio.sleep(0.02)
            assert not acquired.is_set()
            gate.grant(3)
            await asyncio.wait_for(acquired.wait(), 2)
            assert gate.stats["credit_stalls"] == 1
            assert gate.available == 1
            t.cancel()

        run_async(main())


